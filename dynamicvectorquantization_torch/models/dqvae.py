"""Stage-1 DQ-VAE (counterpart of
`dynamicvectorquantization_tpu/models/dqvae.py` `DualGrainVQModel` and
`TripleGrainVQModel`).

  encode(x, train)  -> (quant, emb_loss, (None, None, code), grain_indices, gate, x_entropy)
  decode(q, train, return_pre_out) -> image (and the last conv's input)
  forward(x, train, return_pre_out) -> (dec, diff, grain_indices, gate, x_entropy)
  get_code_emb_with_depth(code) -> codebook embeddings

Holds `encoder` (DualGrainEncoder, or TripleGrainEncoder in
`TripleGrainVQModel`), `quant_conv`, `quantize` (the codebook),
`post_quant_conv` and `decoder` (PositionalDecoder) under the reference
state_dict names; the encoder's merged map is read under the class's
`feature_key` (`h_dual`, `h_triple`). Patch entropy is computed when the
encoder's router is a fixed-entropy one (`use_entropy`), as the JAX package
decides it from the router target. Public layouts follow the JAX package:
images and latents are NHWC. `loss` is the GAN objective built from
`lossconfig` (None, or the `DummyLoss` placeholder inside a stage-2 model).

`compute_dtype` ("bfloat16", as `DQVAENet.compute_dtype` in the JAX
package) makes the encoder's and decoder's towers and the two 1x1 quant
convs compute in bf16 while the parameters stay f32: every conv, GroupNorm
(statistics in f32, QUIRKS #23), AttnBlock and Up/Downsample casts at use;
the VQ searches f32 casts; the decoder's last norm and conv stay f32. A model
whose parameters were cast to bf16 (`.to(torch.bfloat16)`, as the stage-2
trainer casts its frozen first stage) computes in bf16 throughout, by the
dtype promotion of `nn/blocks.py`. Other dtypes raise.

The functions are differentiable; inference callers wrap them in
`torch.no_grad()`. `train=True` makes the quantizer return the EMA
statistics and update its buffers in place (`commit=False`: search and
statistics without the update; `generator` draws the restart candidates),
the step `train/stage1.py` drives. A training forward of a Gumbel-gated
encoder takes its noise as `gumbel_noise` (shape
`encoder.gumbel_shape(batch)`), or draws it from `generator`; a training
forward of towers with ResnetBlock dropout takes one `DropoutMasks` for
both (`dropout`), or draws its seed from `generator`. `remat` checkpoints
the towers' blocks (`nn/blocks.py` `segment`); the patch entropy, the
router and the quantizer, whose EMA update and restart draw must run once,
stay outside every segment. The patch entropy carries no gradient.
"""
from __future__ import annotations

import torch
from torch import nn

from ..config.registry import resolve_target
from ..nn.blocks import Conv2d, as_dtype, training_masks
from ..nn.init import flax_default_
from ..ops.entropy import patch_entropy
from ..utils.instantiate import instantiate_from_config


def is_entropy_router(encoderconfig) -> bool:
    router = (encoderconfig.get("params") or {}).get("router_config") or {}
    return "FixedEntropyRouter" in resolve_target(router.get("target", ""))


def _with_dtype(cfg, dtype):
    """The tower's config with the compute dtype among its params."""
    if dtype is None:
        return cfg
    return {**cfg, "params": {**(cfg.get("params") or {}), "dtype": dtype}}


class DualGrainVQModel(nn.Module):
    feature_key = "h_dual"

    def __init__(self, encoderconfig, decoderconfig, lossconfig, vqconfig, quant_before_dim,
                 quant_after_dim, quant_sample_temperature=0.0, ckpt_path=None, ignore_keys=(),
                 image_key="image", monitor=None, warmup_epochs=0, loss_with_epoch=True,
                 scheduler_type="linear-warmup_cosine-decay", entropy_patch_size=16,
                 image_size=256, compute_dtype=None):
        super().__init__()
        self.compute_dtype = dtype = as_dtype(compute_dtype)
        self.ckpt_path = ckpt_path
        self.image_key = image_key
        self.monitor = monitor
        self.warmup_epochs = warmup_epochs
        self.loss_with_epoch = loss_with_epoch
        self.scheduler_type = scheduler_type
        self.image_size = image_size
        self.entropy_patch_size = entropy_patch_size
        self.quant_sample_temperature = quant_sample_temperature
        self.use_entropy = is_entropy_router(encoderconfig)
        self.encoder = instantiate_from_config(_with_dtype(encoderconfig, dtype))
        self.decoder = instantiate_from_config(_with_dtype(decoderconfig, dtype))
        self.quantize = instantiate_from_config(vqconfig)
        self.quant_conv = Conv2d(quant_before_dim, quant_after_dim, 1, compute_dtype=dtype)
        # applied to codebook entries (codebook_dim == quant_after_dim)
        self.post_quant_conv = Conv2d(quant_after_dim, quant_before_dim, 1,
                                      compute_dtype=dtype)
        self.loss = instantiate_from_config(lossconfig)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        """Seeded random init (explicit generator), drawn as the JAX package
        draws it, since that package is the reference the port is held to:
        every conv and linear (routers' gates included) with flax's defaults,
        a lecun-normal kernel and a zero bias (`nn/init.py`); GroupNorm as
        the identity; the Fourier features, position tables and codebook by
        their own `init_weights`, as the JAX modules initialise them."""
        own = set(self.loss.modules()) if isinstance(self.loss, nn.Module) else set()
        for mod in self.modules():
            if mod in own:
                continue  # LPIPS and the discriminator initialise themselves below
            if isinstance(mod, (nn.Conv2d, nn.Linear)):
                flax_default_(mod, generator)
            elif isinstance(mod, nn.GroupNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
        for mod in self.modules():
            if mod is not self and hasattr(mod, "init_weights"):
                mod.init_weights(generator)
        self.quantize.init_codebook(generator)

    def dropout_masks(self, train, generator=None, dropout=None):
        """The `DropoutMasks` a training forward's towers share, or None."""
        rate = max(self.encoder.dropout, self.decoder.dropout)
        return training_masks(dropout, rate, train, generator)

    def gumbel_shape(self, batch: int):
        """The shape of the Gumbel noise a training forward takes, or None."""
        return self.encoder.gumbel_shape(batch)

    def encode(self, x, train=False, generator=None, commit=True, gumbel_noise=None,
               dropout=None, remat=False):
        """(B, H, W, 3) NHWC images in [-1, 1] -> (quant (B, Hf, Wf, D),
        emb_loss, (None, None, code (B, Hf, Wf)), grain_indices (B, Hc, Wc),
        gate (B, Hc, Wc, n), x_entropy (B, Hc, Wc) or None)."""
        x_entropy = None
        if self.use_entropy:
            x_entropy = patch_entropy(x.detach(), self.entropy_patch_size)
        # contiguous NCHW: a permuted NHWC tensor would make the convs return
        # channels-last tensors, which the Downsample kernel does not take
        h = self.encoder(x.permute(0, 3, 1, 2).contiguous(), x_entropy, train=train,
                         gumbel_noise=gumbel_noise, generator=generator,
                         dropout=self.dropout_masks(train, generator, dropout), remat=remat)
        quant, emb_loss, info = self.quantize(
            self.quant_conv(h[self.feature_key]).permute(0, 2, 3, 1),
            codebook_mask=h["codebook_mask"], temp=self.quant_sample_temperature,
            train=train, generator=generator, commit=commit)
        return quant, emb_loss, info, h["indices"], h["gate"], x_entropy

    def get_code_emb_with_depth(self, code):
        """Codebook lookup, (B, H, W) codes -> (B, H, W, D) NHWC latents."""
        return self.quantize.get_codebook_entry(code)

    def decode(self, quant, train=False, return_pre_out=False, dropout=None, remat=False):
        """(B, H, W, D) NHWC latents -> (B, H', W', 3) NHWC image; with
        `return_pre_out` also the NCHW activation that feeds the decoder's
        `conv_out`. `dropout`: the training forward's `DropoutMasks` where
        the decoder has dropout."""
        h = self.post_quant_conv(quant.permute(0, 3, 1, 2))
        out = self.decoder(h, train=train, return_pre_out=return_pre_out, dropout=dropout,
                           remat=remat)
        if self.decoder.give_pre_end:
            return out.permute(0, 2, 3, 1)
        if return_pre_out:
            return out[0].permute(0, 2, 3, 1), out[1]
        return out.permute(0, 2, 3, 1)

    def forward(self, x, train=False, return_pre_out=False, generator=None, commit=True,
                gumbel_noise=None, dropout=None, remat=False):
        """Reconstruction: (dec, diff, grain_indices, gate, x_entropy); `dec`
        is (image, pre_out) with `return_pre_out`. `dropout`: the
        `DropoutMasks` of a training forward with dropout (else drawn from
        `generator`); `remat`: checkpoint the towers' blocks."""
        dropout = self.dropout_masks(train, generator, dropout)
        quant, diff, _, grain_indices, gate, x_entropy = self.encode(
            x, train=train, generator=generator, commit=commit, gumbel_noise=gumbel_noise,
            dropout=dropout, remat=remat)
        dec = self.decode(quant, train=train, return_pre_out=return_pre_out, dropout=dropout,
                          remat=remat)
        return dec, diff, grain_indices, gate, x_entropy


class TripleGrainVQModel(DualGrainVQModel):
    """The triple-grain DQ-VAE (reference `dqvae_triple_feat.py`): the same
    model over a `TripleGrainEncoder`."""

    feature_key = "h_triple"
