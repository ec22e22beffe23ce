"""Reference `target:` strings -> this package's torch classes.

Counterpart of `dynamicvectorquantization_tpu/config/registry.py`, holding
every reference target of the JAX package's table: the unconditional,
class-conditional and text-to-image stage-2 models (`Dualformer`,
`ClassCondDualformer`, `T2IDualformer`) with their label providers, text
encoders, CLIP text tower and tokenizer, the dual- and triple-grain DQ-VAEs with their routers,
budget losses and GAN loss, the fixed-length stage-1 baselines (VQGAN,
multi-VQ, RQ-VAE) with taming's codec, the legacy quantizers and the two
StyleGAN discriminators, the fixed-length stage-2 baselines (minGPT and its
class- and text-conditional models, the RQ-Transformer) with their
permuters and conditioners, the stacked / position-aware GPTs, the ViT
codec, the attention decoder and the DDPM UNets, the data
module with the ImageNet, face (FFHQ, CelebA-HQ, FacesHQ, LMDB FFHQ) and
synthetic datasets, and the reference launcher's callback and logger
entries (`SetupCallback`, `CaptionImageLogger` as `ImageLogger`,
`LightningShim`: the trainer does their work itself). Paths inside this
package pass through. A data target written as
`<package>.data.datasets.<Name>`, `<package>.data.synthetic.<Name>` or
`<package>.data.ffhq_lmdb.<Name>` for ANY top-level package (the smoke
configs name the JAX package's) resolves by its tail to this package's
class of that name. Any other target raises, so a config that needs an
unported module fails loudly instead of silently picking something else;
a dotted path into another package (the JAX package's own spellings) is
refused too, naming this package's path of the same module to use.
"""
from __future__ import annotations

import importlib

_PKG = "dynamicvectorquantization_torch"

TARGET_ALIASES = {
    "models.stage2_dynamic.dqtransformer_uncond_entropy.Dualformer": f"{_PKG}.models.dqtransformer.Dualformer",
    "models.stage2_dynamic.dqtransformer_class2_entropy.Dualformer": f"{_PKG}.models.dqtransformer.ClassCondDualformer",
    "models.stage2_dynamic.dqtransformer_class.Dualformer": f"{_PKG}.models.dqtransformer.ClassCondDualformer",
    "models.stage2_dynamic.dqtransformer_t2i.Dualformer": f"{_PKG}.models.dqtransformer.T2IDualformer",
    # text encoders and the CLIP text tower + tokenizer (text-to-image); the
    # reference imports its vendored CLIP under two spellings, both resolve
    "modules.text_encoders.clip_text_encoder.CLIPTextEncoder": f"{_PKG}.nn.text_encoders.CLIPTextEncoder",
    "modules.text_encoders.bert_text_encoder.BERTTextEncoder": f"{_PKG}.nn.text_encoders.BERTTextEncoder",
    **{f"{root}.clip_text_embedding.CLIPTextEmbedding": f"{_PKG}.nn.clip_text.CLIPTextEmbedding"
       for root in ("modules.text_encoders.clip_text_encoder", "modules.clip_text_encoder")},
    **{f"{root}.my_tokenizer.my_tokenize.Tokenize": f"{_PKG}.utils.clip_bpe.Tokenize"
       for root in ("modules.text_encoders.clip_text_encoder", "modules.clip_text_encoder")},
    **{f"{root}.clip.simple_tokenizer.SimpleTokenizer": f"{_PKG}.utils.clip_bpe.ClipBPETokenizer"
       for root in ("modules.text_encoders.clip_text_encoder", "modules.clip_text_encoder")},
    "models.stage1_dynamic.dqvae_dual_entropy.DualGrainVQModel": f"{_PKG}.models.dqvae.DualGrainVQModel",
    "models.stage1_dynamic.dqvae_dual_feat.DualGrainVQModel": f"{_PKG}.models.dqvae.DualGrainVQModel",
    "models.stage1_dynamic.dqvae_triple_feat.TripleGrainVQModel": f"{_PKG}.models.dqvae.TripleGrainVQModel",
    "modules.dynamic_modules.stackgpt.StackGPT": f"{_PKG}.nn.stackgpt.StackGPT",
    "modules.dynamic_modules.EncoderDual.DualGrainEncoder": f"{_PKG}.nn.encoder_dual.DualGrainEncoder",
    "modules.dynamic_modules.EncoderTriple.TripleGrainEncoder": f"{_PKG}.nn.encoder_triple.TripleGrainEncoder",
    "modules.dynamic_modules.RouterDual.DualGrainFixedEntropyRouter": f"{_PKG}.nn.routers.DualGrainFixedEntropyRouter",
    "modules.dynamic_modules.RouterDual.DualGrainFeatureRouter": f"{_PKG}.nn.routers.DualGrainFeatureRouter",
    "modules.dynamic_modules.RouterTriple.TripleGrainFeatureRouter": f"{_PKG}.nn.routers.TripleGrainFeatureRouter",
    "modules.dynamic_modules.RouterTriple.TripleGrainFixedEntropyRouter": f"{_PKG}.nn.routers.TripleGrainFixedEntropyRouter",
    "modules.dynamic_modules.DecoderPositional.Decoder": f"{_PKG}.nn.decoder_positional.PositionalDecoder",
    "modules.dynamic_modules.Decoder.Decoder": f"{_PKG}.nn.decoder_positional.PositionalDecoder",
    "modules.dynamic_modules.permuter.DualGrainSeperatePermuter": f"{_PKG}.models.permuter.DualGrainSeparatePermuter",
    "modules.dynamic_modules.label_provider.PositionAwareSOSProvider": f"{_PKG}.models.label_providers.PositionAwareSOSProvider",
    "modules.dynamic_modules.label_provider.ClassAwareSOSProvider": f"{_PKG}.models.label_providers.ClassAwareSOSProvider",
    "modules.dynamic_modules.label_provider.ClassForContentOnlyPositionAwareSOSProvider": f"{_PKG}.models.label_providers.ClassForContentOnlyPositionAwareSOSProvider",
    "modules.vector_quantization.quantize2_mask.VectorQuantize2": f"{_PKG}.ops.vq.VectorQuantizeEMA",
    "modules.vector_quantization.quantize2.VectorQuantize2": f"{_PKG}.ops.vq.VectorQuantizeEMA",
    "modules.dynamic_modules.budget.BudgetConstraint_RatioMSE_DualGrain": f"{_PKG}.models.budget.BudgetConstraintRatioMSEDualGrain",
    "modules.dynamic_modules.budget.BudgetConstraint_NormedSeperateRatioMSE_TripleGrain": f"{_PKG}.models.budget.BudgetConstraintNormedSeparateRatioMSETripleGrain",
    "modules.losses.vqperceptual_multidisc.VQLPIPSWithDiscriminator": f"{_PKG}.losses.vqperceptual.VQLPIPSWithDiscriminator",
    "modules.losses.vqperceptual.VQLPIPSWithDiscriminator": f"{_PKG}.losses.vqperceptual.VQLPIPSWithDiscriminator",
    "modules.losses.vqperceptual.DummyLoss": f"{_PKG}.losses.vqperceptual.DummyLoss",
    "modules.discriminator.model.NLayerDiscriminator": f"{_PKG}.nn.discriminator.NLayerDiscriminator",
    "modules.discriminator.stylegan.Discriminator": f"{_PKG}.nn.stylegan_discriminator.StyleGAN2Discriminator",
    "modules.discriminator.stylegan_lucidrains.Discriminator": f"{_PKG}.nn.stylegan_discriminator.LucidrainsDiscriminator",
    # the fixed-length stage-1 baselines and the legacy quantizers
    "models.stage1.vqgan.VQModel": f"{_PKG}.models.vqgan.VQModel",
    "models.stage1.vqgan_multivq.VQModel": f"{_PKG}.models.vqgan.MultiVQModel",
    "models.stage1.rqvae.RQModel": f"{_PKG}.models.vqgan.RQModel",
    "models.stage1.rqvae.VQModel": f"{_PKG}.models.vqgan.RQModel",
    "modules.diffusionmodules.model.Encoder": f"{_PKG}.nn.vqgan_codec.VQGANEncoder",
    "modules.diffusionmodules.model.Decoder": f"{_PKG}.nn.vqgan_codec.VQGANDecoder",
    "modules.vector_quantization.quantize2_list.VectorQuantize2": f"{_PKG}.ops.vq.VectorQuantizeEMA",
    "modules.vqvae.quantize2.VectorQuantize2": f"{_PKG}.ops.vq.VectorQuantizeEMA",
    "modules.vector_quantization.quantize_codebook_mask.MaskVectorQuantize": f"{_PKG}.ops.quantizers.MaskVectorQuantize",
    "modules.vector_quantization.quantize_vqgan.VectorQuantizer": f"{_PKG}.ops.quantizers.VectorQuantizer",
    "modules.vector_quantization.quantize_vqgan.VectorQuantizer2": f"{_PKG}.ops.quantizers.VectorQuantizer2",
    "modules.vector_quantization.quantize.VectorQuantizer": f"{_PKG}.ops.quantizers.VectorQuantizer",
    "modules.vector_quantization.quantize_vqgan.GumbelQuantize": f"{_PKG}.ops.quantizers.GumbelQuantize",
    "modules.vector_quantization.quantize_vqgan.EMAVectorQuantizer": f"{_PKG}.ops.quantizers.EMAVectorQuantizer",
    "modules.vector_quantization.quantize_rqvae.RQBottleneck": f"{_PKG}.ops.quantizers.RQBottleneck",
    "modules.vector_quantization.quantize_lucidrains.VectorQuantize": f"{_PKG}.ops.quantize_lucidrains.LucidrainsVectorQuantize",
    # the fixed-length stage-2 baselines, their permuters and conditioners,
    # and the legacy experimental modules
    "modules.transformer.mingpt.GPT": f"{_PKG}.nn.mingpt.GPT",
    "modules.transformer.mingpt_t2i.T2IGPT": f"{_PKG}.nn.mingpt.GPT",
    "modules.transformer.stacked_mingpt.StackedPositionGPT": f"{_PKG}.nn.stacked_mingpt.StackedPositionGPT",
    "modules.transformer.position_aware_mingpt.PositionAwareGPT": f"{_PKG}.nn.vit.PositionAwareGPT",
    "modules.transformer.vit.VisionTransformerEncoder": f"{_PKG}.nn.vit.VisionTransformerEncoder",
    "modules.transformer.vit.VisionTransformerDecoder": f"{_PKG}.nn.vit.VisionTransformerDecoder",
    "models.stage2.uncond_transformer.UncondTransformer": f"{_PKG}.models.legacy_transformer.UncondTransformer",
    "models.stage2.uncond_transformer.Net2NetTransformer": f"{_PKG}.models.legacy_transformer.UncondTransformer",
    "models.stage2.class_transformer.ClassTransformer": f"{_PKG}.models.legacy_transformer.ClassTransformer",
    "models.stage2.class_transformer.Net2NetTransformer": f"{_PKG}.models.legacy_transformer.ClassTransformer",
    "models.stage2.text2image_transformer.Text2ImageTransformer": f"{_PKG}.models.legacy_transformer.Text2ImageTransformer",
    "models.stage2.text2image_transformer2.Text2ImageTransformer": f"{_PKG}.models.legacy_transformer.Text2ImageTransformer2",
    "models.stage2.uncond_rqtransformer.RQTransformerTrainer": f"{_PKG}.models.legacy_transformer.RQTransformerTrainer",
    **{f"modules.transformer.permuter.{name}": f"{_PKG}.models.sequence_permuters.{name}"
       for name in ("Identity", "Subsample", "ZCurve", "SpiralOut", "SpiralIn", "Random",
                    "AlternateParsing")},
    "utils.utils.SOSProvider": f"{_PKG}.models.legacy_transformer.SOSProvider",
    "utils.utils.Labelator": f"{_PKG}.models.legacy_transformer.Labelator",
    "modules.diffusionmodules.attn_model.AttnDecoder": f"{_PKG}.nn.attn_decoder.AttnDecoder",
    "modules.diffusionmodules.attn_model.TokenReconstruction": f"{_PKG}.nn.attn_decoder.TokenReconstruction",
    "modules.diffusionmodules.attn_model.SelfAttnBlock": f"{_PKG}.nn.attn_decoder.MaskedSelfAttnBlock",
    "modules.diffusionmodules.attn_model.BiasedSelfAttnBlock": f"{_PKG}.nn.attn_decoder.MaskedSelfAttnBlock",
    "modules.diffusionmodules.attn_model.ResnetBlock_kernel_1": f"{_PKG}.nn.attn_decoder.ResnetBlockK1",
    **{f"modules.diffusionmodules.model.{name}": f"{_PKG}.nn.ddpm_unet.{port}"
       for name, port in (("Model", "DDPMUNet"), ("VUNet", "VUNet"),
                          ("SimpleDecoder", "SimpleDecoder"),
                          ("UpsampleDecoder", "UpsampleDecoder"))},
    "data.build.DataModuleFromConfig": f"{_PKG}.data.datasets.DataModuleFromConfig",
    "data.imagenet.ImageNetTrain": f"{_PKG}.data.datasets.ImageNetTrain",
    "data.imagenet.ImageNetValidation": f"{_PKG}.data.datasets.ImageNetValidation",
    "data.synthetic.SyntheticImages": f"{_PKG}.data.synthetic.SyntheticImages",
    **{f"data.faceshq.{name}": f"{_PKG}.data.datasets.{name}"
       for name in ("FFHQTrain", "FFHQValidation", "CelebAHQTrain", "CelebAHQValidation",
                    "FacesHQTrain", "FacesHQValidation")},
    "data.ffhq_lmdb.FFHQ_LMDB": f"{_PKG}.data.ffhq_lmdb.FFHQ_LMDB",
    # the reference launcher's callbacks and loggers: the trainer does their work
    "utils.logger.SetupCallback": f"{_PKG}.utils.logging.SetupCallback",
    "utils.logger.CaptionImageLogger": f"{_PKG}.utils.logging.ImageLogger",
    **{f"pytorch_lightning.{name}": f"{_PKG}.utils.logging.LightningShim"
       for name in ("callbacks.ModelCheckpoint", "callbacks.LearningRateMonitor",
                    "callbacks.RichModelSummary", "loggers.TensorBoardLogger",
                    "loggers.WandbLogger")},
}
# the top-level names of the reference repository's targets
_REFERENCE_ROOTS = ("models", "modules", "utils", "data", "pytorch_lightning")
# `<any package>.data.<module>.<Name>` -> this package's class, for these names
_DATA_TAILS = {
    "data.datasets": ("DataModuleFromConfig", "ImageNetTrain", "ImageNetValidation",
                      "SyntheticDataset", "FileListDataset", "FFHQTrain", "FFHQValidation",
                      "CelebAHQTrain", "CelebAHQValidation", "FacesHQTrain",
                      "FacesHQValidation"),
    "data.synthetic": ("SyntheticImages",),
    "data.ffhq_lmdb": ("FFHQ_LMDB",),
}


def resolve_target(target: str) -> str:
    if target in TARGET_ALIASES:
        return TARGET_ALIASES[target]
    if target.startswith(_PKG + "."):
        return target
    parts = target.split(".")
    if len(parts) == 4 and parts[3] in _DATA_TAILS.get(".".join(parts[1:3]), ()):
        return ".".join([_PKG, *parts[1:]])
    if parts[0] not in _REFERENCE_ROOTS and len(parts) > 2:
        raise KeyError(_foreign_path_message(target, parts))
    raise KeyError(
        f"target {target!r} is not ported to {_PKG} (see ROADMAP.md, "
        "'Slices to port, in order')"
    )


def _foreign_path_message(target, parts) -> str:
    """The refusal of another package's own dotted path (the JAX package's
    spellings): which reference target or path of this package names the
    same module, where one does."""
    here = ".".join([_PKG, *parts[1:]])
    module, name = here.rsplit(".", 1)
    try:
        found = hasattr(importlib.import_module(module), name)
    except ImportError:
        found = False
    refs = sorted(k for k, v in TARGET_ALIASES.items() if v == here)
    use = (f"use the reference target {refs[0]!r} or this package's path {here!r}" if refs
           else f"use this package's path {here!r}" if found
           else "this package has no class of that path")
    return (f"target {target!r} is a path into another package ({parts[0]!r}), which "
            f"{_PKG} does not import: {use} (see ROADMAP.md, 'Slices to port, in order', "
            "for what is not ported)")
