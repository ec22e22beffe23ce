"""Stage-1 DQ-VAE, inference (counterpart of
`dynamicvectorquantization_tpu/models/dqvae.py` `DualGrainVQModel`).

  encode(x)  -> (quant, emb_loss, (None, None, code), grain_indices, gate, x_entropy)
  decode(q)  -> image
  forward(x) -> (dec, diff, grain_indices, gate, x_entropy)
  get_code_emb_with_depth(code) -> codebook embeddings

Holds `encoder` (DualGrainEncoder), `quant_conv`, `quantize` (the codebook),
`post_quant_conv` and `decoder` (PositionalDecoder) under the reference
state_dict names. Patch entropy is computed when the encoder's router is the
fixed-entropy one (`use_entropy`), as the JAX package decides it from the
router target. Public layouts follow the JAX package: images and latents are
NHWC. Inference only: training comes with the stage-1 training slice.
"""
from __future__ import annotations

import torch
from torch import nn

from ..config.registry import resolve_target
from ..ops.entropy import patch_entropy
from ..utils.instantiate import instantiate_from_config


def is_entropy_router(encoderconfig) -> bool:
    router = (encoderconfig.get("params") or {}).get("router_config") or {}
    return "FixedEntropyRouter" in resolve_target(router.get("target", ""))


class DualGrainVQModel(nn.Module):
    def __init__(self, encoderconfig, decoderconfig, lossconfig, vqconfig, quant_before_dim,
                 quant_after_dim, quant_sample_temperature=0.0, ckpt_path=None, ignore_keys=(),
                 image_key="image", monitor=None, warmup_epochs=0, loss_with_epoch=True,
                 scheduler_type="linear-warmup_cosine-decay", entropy_patch_size=16,
                 image_size=256, compute_dtype=None):
        super().__init__()
        if compute_dtype:
            raise NotImplementedError("compute_dtype for the DQ-VAE is not ported")
        self.lossconfig = lossconfig
        self.ckpt_path = ckpt_path
        self.image_size = image_size
        self.entropy_patch_size = entropy_patch_size
        self.quant_sample_temperature = quant_sample_temperature
        self.use_entropy = is_entropy_router(encoderconfig)
        self.encoder = instantiate_from_config(encoderconfig)
        self.decoder = instantiate_from_config(decoderconfig)
        self.quantize = instantiate_from_config(vqconfig)
        self.quant_conv = nn.Conv2d(quant_before_dim, quant_after_dim, 1)
        # applied to codebook entries (codebook_dim == quant_after_dim)
        self.post_quant_conv = nn.Conv2d(quant_after_dim, quant_before_dim, 1)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        """Seeded random init (explicit generator): convs, linears and
        GroupNorms as torch's defaults would draw them, position tables and
        the codebook as the reference initialises them."""
        for mod in self.modules():
            if isinstance(mod, (nn.Conv2d, nn.Linear)):
                fan_in = mod.weight[0].numel()
                bound = fan_in ** -0.5
                mod.weight.uniform_(-bound, bound, generator=generator)
                mod.bias.uniform_(-bound, bound, generator=generator)
            elif isinstance(mod, nn.GroupNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
        for mod in self.modules():
            if mod is not self and hasattr(mod, "init_weights"):
                mod.init_weights(generator)
        self.quantize.init_codebook(generator)

    @torch.no_grad()
    def encode(self, x):
        """(B, H, W, 3) NHWC images in [-1, 1] -> (quant (B, Hf, Wf, D),
        emb_loss, (None, None, code (B, Hf, Wf)), grain_indices (B, Hc, Wc),
        gate (B, Hc, Wc, 2), x_entropy (B, Hc, Wc) or None)."""
        x_entropy = patch_entropy(x, self.entropy_patch_size) if self.use_entropy else None
        # contiguous NCHW: a permuted NHWC tensor would make the convs return
        # channels-last tensors, which the Downsample kernel does not take
        h = self.encoder(x.permute(0, 3, 1, 2).contiguous(), x_entropy)
        quant, emb_loss, info = self.quantize(
            self.quant_conv(h["h_dual"]).permute(0, 2, 3, 1),
            codebook_mask=h["codebook_mask"], temp=self.quant_sample_temperature)
        return quant, emb_loss, info, h["indices"], h["gate"], x_entropy

    def get_code_emb_with_depth(self, code):
        """Codebook lookup, (B, H, W) codes -> (B, H, W, D) NHWC latents."""
        return self.quantize.get_codebook_entry(code)

    def decode(self, quant):
        """(B, H, W, D) NHWC latents -> (B, H', W', 3) NHWC image."""
        h = self.post_quant_conv(quant.permute(0, 3, 1, 2))
        return self.decoder(h).permute(0, 2, 3, 1)

    @torch.no_grad()
    def forward(self, x):
        """Reconstruction: (dec, diff, grain_indices, gate, x_entropy)."""
        quant, diff, _, grain_indices, gate, x_entropy = self.encode(x)
        return self.decode(quant), diff, grain_indices, gate, x_entropy
