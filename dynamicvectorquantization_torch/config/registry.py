"""Reference `target:` strings -> this package's torch classes.

Counterpart of `dynamicvectorquantization_tpu/config/registry.py`, holding
only the targets the ported slices (unconditional stage-2 sampling, the
DQ-VAE's dual-grain encode and decode) instantiate. Paths inside this
package pass through; any other target raises, so a config that needs an
unported module fails loudly instead of silently picking something else.
"""
from __future__ import annotations

_PKG = "dynamicvectorquantization_torch"

TARGET_ALIASES = {
    "models.stage2_dynamic.dqtransformer_uncond_entropy.Dualformer": f"{_PKG}.models.dqtransformer.Dualformer",
    "models.stage1_dynamic.dqvae_dual_entropy.DualGrainVQModel": f"{_PKG}.models.dqvae.DualGrainVQModel",
    "models.stage1_dynamic.dqvae_dual_feat.DualGrainVQModel": f"{_PKG}.models.dqvae.DualGrainVQModel",
    "modules.dynamic_modules.stackgpt.StackGPT": f"{_PKG}.nn.stackgpt.StackGPT",
    "modules.dynamic_modules.EncoderDual.DualGrainEncoder": f"{_PKG}.nn.encoder_dual.DualGrainEncoder",
    "modules.dynamic_modules.RouterDual.DualGrainFixedEntropyRouter": f"{_PKG}.nn.routers.DualGrainFixedEntropyRouter",
    "modules.dynamic_modules.RouterDual.DualGrainFeatureRouter": f"{_PKG}.nn.routers.DualGrainFeatureRouter",
    "modules.dynamic_modules.DecoderPositional.Decoder": f"{_PKG}.nn.decoder_positional.PositionalDecoder",
    "modules.dynamic_modules.Decoder.Decoder": f"{_PKG}.nn.decoder_positional.PositionalDecoder",
    "modules.dynamic_modules.permuter.DualGrainSeperatePermuter": f"{_PKG}.models.permuter.DualGrainSeparatePermuter",
    "modules.dynamic_modules.label_provider.PositionAwareSOSProvider": f"{_PKG}.models.label_providers.PositionAwareSOSProvider",
    "modules.vector_quantization.quantize2_mask.VectorQuantize2": f"{_PKG}.ops.vq.VectorQuantizeEMA",
    "modules.vector_quantization.quantize2.VectorQuantize2": f"{_PKG}.ops.vq.VectorQuantizeEMA",
}


def resolve_target(target: str) -> str:
    if target in TARGET_ALIASES:
        return TARGET_ALIASES[target]
    if target.startswith(_PKG + "."):
        return target
    raise KeyError(
        f"target {target!r} is not ported to {_PKG} yet (see ROADMAP.md, "
        "'Modules to port')"
    )
