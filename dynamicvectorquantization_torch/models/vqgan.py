"""The fixed-length stage-1 baselines: VQGAN, multi-VQ VQGAN and RQ-VAE
(counterpart of `dynamicvectorquantization_tpu/models/vqgan.py`).

  encode(x, train)  -> (quant, emb_loss, (None, None, code), None, None, None)
  decode(q, train, return_pre_out) -> image (and the last conv's input)
  forward(x, train, return_pre_out) -> (dec, diff, code, None, None)
  get_code_emb_with_depth(code) -> codebook embeddings

The surface of `models/dqvae.py`, so `train/stage1.py` trains them
unchanged: encoder -> 1x1 `quant_conv` -> `quantize` -> 1x1
`post_quant_conv` -> decoder (`nn/vqgan_codec.py`), under taming's names
(`encoder.*`, `quant_conv`, `quantize.embedding.weight`, `post_quant_conv`,
`decoder.*`, `loss.*`), so a taming VQGAN `.ckpt` loads with
`load_state_dict`. As in the JAX package, `forward` returns the code indices
in the grain-indices slot and no gate: the trainers log `*_fine_ratio` as
the share of codes above 0 (ROADMAP §3, reference quirks).

`vqconfig` is any quantizer of `ops/quantizers.py` or
`ops/quantize_lucidrains.py` (or `ops/vq.py`'s `VectorQuantizeEMA`); by
default taming's gradient-trained `VectorQuantizer(n_embed, embed_dim)`.
`init_weights(generator)` draws every conv and linear as flax's defaults
(`nn/init.py`), GroupNorm as the identity, the loss's nets by their own
`init_weights` and the codebook as its JAX module does; `init_from_batch`
then runs what flax's init runs on the sample batch (a `MaskVectorQuantize`
codebook's kmeans). Images and latents are NHWC in the public functions.
"""
from __future__ import annotations

import inspect

import torch
from torch import nn

from ..nn.blocks import Conv2d, training_masks
from ..nn.init import flax_default_
from ..nn.vqgan_codec import VQGANDecoder, VQGANEncoder
from ..utils.instantiate import instantiate_from_config

_DEFAULT_VQ = "dynamicvectorquantization_torch.ops.quantizers.VectorQuantizer"
_DEFAULT_RQ = "dynamicvectorquantization_torch.ops.quantizers.RQBottleneck"


def _fields(cls, config):
    """The keys of `config` that `cls` takes (a reference ddconfig carries
    decoder-only keys beside the shared ones)."""
    names = set(inspect.signature(cls).parameters)
    return {k: v for k, v in config.items() if k in names}


class VQModel(nn.Module):
    """Fixed-length VQGAN (reference `models/stage1/vqgan.py`)."""

    has_grains = False  # image logs carry no grain map

    def __init__(self, ddconfig, lossconfig, vqconfig=None, n_embed=None, embed_dim=None,
                 ckpt_path=None, ignore_keys=(), image_key="image", monitor=None, warmup_epochs=0,
                 loss_with_epoch=True, scheduler_type="linear-warmup_cosine-decay", **kwargs):
        super().__init__()
        if vqconfig is None:
            vqconfig = {"target": _DEFAULT_VQ,
                        "params": {"n_e": n_embed or 1024, "e_dim": embed_dim or 256}}
        embed_dim = embed_dim or (vqconfig.get("params") or {}).get("e_dim",
                                                                     ddconfig["z_channels"])
        dd = {k: v for k, v in ddconfig.items() if k != "double_z"}
        self.encoder = VQGANEncoder(**_fields(VQGANEncoder, dd))
        self.decoder = VQGANDecoder(**_fields(VQGANDecoder, dd))
        self.quantize = instantiate_from_config(vqconfig)
        self.quant_conv = Conv2d(dd["z_channels"], embed_dim, 1)
        self.post_quant_conv = Conv2d(embed_dim, dd["z_channels"], 1)
        self.loss = instantiate_from_config(lossconfig) if lossconfig else None
        self.image_key = image_key
        self.monitor = monitor
        self.warmup_epochs = warmup_epochs
        self.loss_with_epoch = loss_with_epoch
        self.scheduler_type = scheduler_type
        self.ckpt_path = ckpt_path
        self.ignore_keys = tuple(ignore_keys)
        self.image_size = dd.get("resolution", 256)
        self.compute_dtype = None

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        """Seeded init as the JAX package draws it (see the module docstring)."""
        own = set(self.loss.modules()) if isinstance(self.loss, nn.Module) else set()
        for mod in self.modules():
            if mod in own:
                continue
            if isinstance(mod, (nn.Conv2d, nn.Linear)):
                flax_default_(mod, generator)
            elif isinstance(mod, nn.GroupNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
        if isinstance(self.loss, nn.Module):
            for mod in self.loss.modules():
                if mod is not self.loss and hasattr(mod, "init_weights"):
                    mod.init_weights(generator)
        if hasattr(self.quantize, "init_codebook"):
            self.quantize.init_codebook(generator)

    @torch.no_grad()
    def init_from_batch(self, x, generator: torch.Generator):
        """What flax's init runs on the sample batch x (B, H, W, 3): the
        kmeans init of a `MaskVectorQuantize` codebook."""
        if hasattr(self.quantize, "init_from_features"):
            h = self.quant_conv(self.encoder(x.permute(0, 3, 1, 2).contiguous()))
            self.quantize.init_from_features(h.permute(0, 2, 3, 1), generator)

    def dropout_masks(self, train, generator=None, dropout=None):
        """The `DropoutMasks` a training forward's towers share, or None."""
        rate = max(self.encoder.dropout, self.decoder.dropout)
        return training_masks(dropout, rate, train, generator)

    def gumbel_shape(self, batch: int):
        """None: a quantizer's draws come from the step's generator."""
        return None

    def encode(self, x, train=False, generator=None, commit=True, gumbel_noise=None,
               dropout=None, remat=False):
        """(B, H, W, 3) NHWC images in [-1, 1] -> (quant (B, h, w, D),
        emb_loss, (None, None, code), None, None, None)."""
        h = self.encoder(x.permute(0, 3, 1, 2).contiguous(), train=train,
                         dropout=self.dropout_masks(train, generator, dropout), remat=remat)
        quant, emb_loss, info = self.quantize(self.quant_conv(h).permute(0, 2, 3, 1),
                                              train=train, generator=generator, commit=commit,
                                              noise=gumbel_noise)
        return quant, emb_loss, info, None, None, None

    def decode(self, quant, train=False, return_pre_out=False, dropout=None, remat=False):
        """(B, h, w, D) NHWC latents -> (B, H, W, 3) NHWC image; with
        `return_pre_out` also the NCHW input of the decoder's `conv_out`."""
        h = self.post_quant_conv(quant.permute(0, 3, 1, 2))
        out = self.decoder(h, train=train, return_pre_out=return_pre_out, dropout=dropout,
                           remat=remat)
        if return_pre_out and not self.decoder.give_pre_end:
            return out[0].permute(0, 2, 3, 1), out[1]
        return out.permute(0, 2, 3, 1)

    def forward(self, x, train=False, return_pre_out=False, generator=None, commit=True,
                gumbel_noise=None, dropout=None, remat=False):
        """(dec, diff, code, None, None); `dec` is (image, pre_out) with
        `return_pre_out`."""
        dropout = self.dropout_masks(train, generator, dropout)
        quant, diff, info, *_ = self.encode(x, train=train, generator=generator, commit=commit,
                                            gumbel_noise=gumbel_noise, dropout=dropout,
                                            remat=remat)
        dec = self.decode(quant, train=train, return_pre_out=return_pre_out, dropout=dropout,
                          remat=remat)
        return dec, diff, info[2], None, None

    def get_code_emb_with_depth(self, code):
        return self.quantize.get_codebook_entry(code)


class MultiVQModel(VQModel):
    """Multi-VQ VQGAN (reference `models/stage1/vqgan_multivq.py`): the
    single-grain codec built from `encoderconfig`'s params (the JAX package
    ignores `decoderconfig` and `quant_before_dim` as well), the quantizer of
    `vqconfig`, `quant_after_dim` its width."""

    def __init__(self, encoderconfig, decoderconfig, lossconfig, vqconfig, quant_before_dim,
                 quant_after_dim, **kwargs):
        super().__init__(dict(encoderconfig.get("params") or {}), lossconfig, vqconfig=vqconfig,
                         embed_dim=quant_after_dim, **kwargs)


class RQModel(VQModel):
    """RQ-VAE (reference `models/stage1/rqvae.py`): the codec over an
    `RQBottleneck`; codes (B, h, w, depth)."""

    def __init__(self, ddconfig, lossconfig, rqconfig=None, **kwargs):
        kwargs.pop("vqconfig", None)
        super().__init__(ddconfig, lossconfig,
                         vqconfig=rqconfig or {"target": _DEFAULT_RQ, "params": {}}, **kwargs)
