"""Stage-1 DQ-VAE, decode half (counterpart of
`dynamicvectorquantization_tpu/models/dqvae.py` `DualGrainVQModel`).

Holds `decoder` (PositionalDecoder), `post_quant_conv` and `quantize`
(the codebook), under the reference state_dict names. The encoder config is
stored, not built: `encode` comes with the stage-1 encode slice.
Public layouts follow the JAX package: latents and images are NHWC.
"""
from __future__ import annotations

import torch
from torch import nn

from ..utils.instantiate import instantiate_from_config


class DualGrainVQModel(nn.Module):
    def __init__(self, encoderconfig, decoderconfig, lossconfig, vqconfig, quant_before_dim,
                 quant_after_dim, quant_sample_temperature=0.0, ckpt_path=None, ignore_keys=(),
                 image_key="image", monitor=None, warmup_epochs=0, loss_with_epoch=True,
                 scheduler_type="linear-warmup_cosine-decay", entropy_patch_size=16,
                 image_size=256, compute_dtype=None):
        super().__init__()
        if compute_dtype:
            raise NotImplementedError("compute_dtype for the DQ-VAE is not ported")
        self.encoderconfig = encoderconfig
        self.lossconfig = lossconfig
        self.ckpt_path = ckpt_path
        self.image_size = image_size
        self.decoder = instantiate_from_config(decoderconfig)
        self.quantize = instantiate_from_config(vqconfig)
        # applied to codebook entries (codebook_dim == quant_after_dim)
        self.post_quant_conv = nn.Conv2d(quant_after_dim, quant_before_dim, 1)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        """Seeded random init (explicit generator): convs and GroupNorms as
        torch's defaults would draw them, position tables and the codebook as
        the reference initialises them."""
        for mod in self.modules():
            if isinstance(mod, nn.Conv2d):
                fan_in = mod.in_channels * mod.kernel_size[0] * mod.kernel_size[1]
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

    def encode(self, x):
        raise NotImplementedError(
            "DQ-VAE encode (entropy -> router -> DualGrainEncoder -> VQ nearest-code "
            "kernel) comes with the stage-1 encode slice (ROADMAP.md)")

    def get_code_emb_with_depth(self, code):
        """Codebook lookup, (B, H, W) codes -> (B, H, W, D) NHWC latents."""
        return self.quantize.get_codebook_entry(code)

    def decode(self, quant):
        """(B, H, W, D) NHWC latents -> (B, H', W', 3) NHWC image."""
        h = self.post_quant_conv(quant.permute(0, 3, 1, 2))
        return self.decoder(h).permute(0, 2, 3, 1)
