"""The legacy fixed-length stage-2 transformers over minGPT and the
RQ-Transformer (counterpart of
`dynamicvectorquantization_tpu/models/legacy_transformer.py`).

Pipeline: the frozen stage-1 model encodes (B, H, W, 3) NHWC images to
codes, which are flattened and put in the permuter's order; a condition
prefix (`SOSProvider`'s constant token, `Labelator`'s shifted class label,
or a pre-tokenised caption) goes before them; the GPT takes the sequence
without its last token and a cross entropy covers the code part. Sampling
is `nn/mingpt.py` `sample_with_past`, and `decode_to_img` undoes the
permuter, embeds the codes and decodes them.

The models are `nn.Module`s under the reference's names (`transformer.*`,
`first_stage_model.*`, `permuter.*`), so a taming `Net2NetTransformer`
checkpoint loads with `load_state_dict` (the condition providers hold no
parameters). The JAX legacy models have no `loss()`, so its stage-2
trainer cannot train them, and the port adds no trainer for them: forward,
loss, gradients, sampling and decoding are their surface.

Draws: the T2I models' `pkeep` token corruption takes the JAX draw as
`pkeep_mask=` (keep) and `pkeep_tokens=` (the replacements) where a caller
has one, else draws from the forward's `generator`; sampling draws from the
caller's generator. Reference quirks kept (ROADMAP §3): `Labelator` adds
`threshold` to the labels; `Text2ImageTransformer.sample` clips the codes
at 0; `RQTransformer` ignores `model_aux`.
"""
from __future__ import annotations

import torch
from torch import nn

from ..nn.stackgpt import cross_entropy_ignore
from ..utils.instantiate import instantiate_from_config


class SOSProvider:
    """A constant start-of-sequence token."""

    def __init__(self, sos_token, quantize_interface=True):
        self.sos_token = sos_token

    def encode(self, x):
        c = torch.full((x.shape[0], 1), self.sos_token, dtype=torch.long, device=x.device)
        return c, None, [None, None, c]


class Labelator:
    """The class label plus `threshold` as the condition token."""

    def __init__(self, n_classes, quantize_interface=True, threshold=None):
        self.n_classes = n_classes
        self.threshold = threshold if threshold is not None else 0

    def encode(self, labels):
        c = torch.as_tensor(labels).long().reshape(-1, 1) + self.threshold
        return c, None, [None, None, c]


def _first_stage(config):
    model = instantiate_from_config(config)
    model.requires_grad_(False)
    return model.eval()


class UncondTransformer(nn.Module):
    """Fixed-length AR model over a frozen stage-1 codebook."""

    cond_is_class = False

    def __init__(self, transformer_config, first_stage_config, cond_stage_config=None,
                 permuter_config=None, sos_token=0, downsample_cond_size=-1, pkeep=1.0,
                 monitor=None, warmup_epochs=0, weight_decay=0.01, ckpt_path=None,
                 ignore_keys=(), first_stage_key="image", cond_stage_key="image"):
        super().__init__()
        self.transformer = instantiate_from_config(transformer_config)
        self.first_stage_model = _first_stage(first_stage_config)
        if permuter_config is None:
            from .sequence_permuters import Identity

            self.permuter = Identity()
        else:
            self.permuter = instantiate_from_config(permuter_config)
        if cond_stage_config in (None, "__is_unconditional__"):
            self.cond_stage_model = SOSProvider(sos_token)
        else:
            self.cond_stage_model = instantiate_from_config(cond_stage_config)
        self.pkeep = pkeep
        self.monitor = monitor
        self.warmup_epochs = warmup_epochs
        self.weight_decay = weight_decay
        self.ckpt_path = ckpt_path
        self.ignore_keys = tuple(ignore_keys)
        self.first_stage_key = first_stage_key
        self.cond_stage_key = cond_stage_key

    def train(self, mode: bool = True):
        super().train(mode)
        self.first_stage_model.eval()  # frozen
        return self

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        """Seeded weights as the JAX models draw them: the transformer's own
        init, the first stage's `init_weights`."""
        self.transformer.init_weights(generator)
        self.first_stage_model.init_weights(generator)

    @torch.no_grad()
    def encode_to_z(self, x):
        """(quant, codes in the permuter's order (B, L))."""
        quant, _, info, *_ = self.first_stage_model.encode(x)
        return quant, self.permuter(info[2].reshape(x.shape[0], -1))

    def encode_to_c(self, c):
        _, _, (_, _, idx) = self.cond_stage_model.encode(c)
        return idx.reshape(idx.shape[0], -1)

    def forward(self, x, c, train=False, generator=None, seed=None):
        """(logits over the code part, cross entropy); the condition prefix
        is not a target."""
        _, z_indices = self.encode_to_z(x)
        c_indices = self.encode_to_c(c).to(z_indices.device)
        cz = torch.cat([c_indices, z_indices], dim=1)
        logits, _ = self.transformer(cz[:, :-1], train=train, generator=generator, seed=seed)
        logits = logits[:, c_indices.shape[1] - 1:]
        return logits, cross_entropy_ignore(logits, z_indices, -100)

    def sample(self, c_indices, steps, generator=None, temperature=1.0, top_k=None, top_p=None,
               sample=True):
        from ..nn.mingpt import sample_with_past

        return sample_with_past(self.transformer, c_indices, steps, generator, temperature,
                                sample, top_k, top_p)

    @torch.no_grad()
    def decode_to_img(self, index, zshape):
        """Codes in the permuter's order (B, L) -> (B, H, W, 3) images;
        `zshape` the codes' (B, h, w)."""
        codes = self.permuter(index, reverse=True).reshape(zshape)
        quant = self.first_stage_model.get_code_emb_with_depth(codes)
        return self.first_stage_model.decode(quant)


class ClassTransformer(UncondTransformer):
    """Class-conditional variant: the condition is `Labelator`'s token."""

    cond_is_class = True

    def __init__(self, *args, cond_stage_key="class_label", **kwargs):
        super().__init__(*args, cond_stage_key=cond_stage_key, **kwargs)


class Text2ImageTransformer(UncondTransformer):
    """Fixed-length text-to-image AR model: the condition is a
    pre-tokenised caption (B, Lc); image codes are shifted by
    `text_vocab_size` into the joint vocabulary; the cross entropy covers
    the image span, plus the text span weighted by `text_loss_radio` (the
    reference's spelling). `use_segment` (the `Text2ImageTransformer2`
    variant): a 0 / 1 text / image segment embedding."""

    use_segment = False

    def __init__(self, transformer_config, first_stage_config, permuter_config=None,
                 ckpt_path=None, ignore_keys=(), first_stage_key="image",
                 cond_stage_key="caption", pkeep=1.0, monitor=None, weight_decay=0.01,
                 warmup_epochs=0, text_loss_radio=0, text_vocab_size=0, image_vocab_size=0):
        super().__init__(transformer_config, first_stage_config, cond_stage_config=None,
                         permuter_config=permuter_config, pkeep=pkeep, monitor=monitor,
                         warmup_epochs=warmup_epochs, weight_decay=weight_decay,
                         ckpt_path=ckpt_path, ignore_keys=ignore_keys,
                         first_stage_key=first_stage_key, cond_stage_key=cond_stage_key)
        self.text_loss_radio = text_loss_radio
        self.calculate_text_loss = text_loss_radio > 0
        self.image_loss_radio = 1 - text_loss_radio
        self.text_vocab_size = text_vocab_size
        self.image_vocab_size = image_vocab_size

    def encode_to_c(self, c):
        return torch.as_tensor(c).long()

    def forward(self, x, c, train=False, generator=None, seed=None, pkeep_mask=None,
                pkeep_tokens=None):
        """(total loss, image loss, text loss). In training with `pkeep` < 1
        each image code is kept with probability `pkeep`, else replaced by a
        uniform token of the GPT's vocabulary: `pkeep_mask` / `pkeep_tokens`
        when given, else drawn from `generator`."""
        _, z_indices = self.encode_to_z(x)
        z_indices = z_indices + self.text_vocab_size
        c_indices = self.encode_to_c(c).to(z_indices.device)
        a_indices = z_indices
        if train and self.pkeep < 1.0:
            if pkeep_mask is None:
                pkeep_mask = torch.rand(z_indices.shape, generator=generator,
                                        device=z_indices.device) < self.pkeep
            if pkeep_tokens is None:
                pkeep_tokens = torch.randint(0, self.transformer.vocab_size, z_indices.shape,
                                             generator=generator, device=z_indices.device)
            a_indices = torch.where(torch.as_tensor(pkeep_mask, device=z_indices.device),
                                    z_indices, torch.as_tensor(pkeep_tokens).to(z_indices))
        cz = torch.cat([c_indices, a_indices], dim=1)
        n_cond = c_indices.shape[1]
        segment = None
        if self.use_segment:
            segment = torch.cat([torch.zeros_like(c_indices),
                                 torch.ones_like(a_indices[:, 1:])], dim=1)
        logits, _ = self.transformer(cz[:, :-1], segment=segment, train=train,
                                     generator=generator, seed=seed)
        image_loss = cross_entropy_ignore(logits[:, n_cond - 1:], z_indices, -100)
        if self.calculate_text_loss:
            text_loss = cross_entropy_ignore(logits[:, :n_cond - 1], c_indices[:, 1:], -100)
            total = self.text_loss_radio * text_loss + self.image_loss_radio * image_loss
            return total, image_loss, text_loss
        return image_loss, image_loss, torch.zeros((), device=image_loss.device)

    def sample(self, c_indices, steps, generator=None, temperature=1.0, top_k=None, top_p=None,
               sample=True):
        """Image codes (B, steps): the joint-vocabulary tokens less
        `text_vocab_size`, clipped at 0 (a reference quirk)."""
        from ..nn.mingpt import sample_with_past

        out = sample_with_past(self.transformer, c_indices, steps, generator, temperature,
                               sample, top_k, top_p, use_segments=self.use_segment)
        return (out - self.text_vocab_size).clamp(min=0)


class Text2ImageTransformer2(Text2ImageTransformer):
    """The segment-embedding T2I variant (pair with a `segment_size=2` GPT)."""

    use_segment = True


class RQTransformerTrainer(nn.Module):
    """The RQ-VAE's stage 2: an unconditional `nn/rq_transformer.py`
    `RQTransformer` over a frozen RQ first stage (`models/vqgan.py`
    `RQModel`), through the reference interface `transformer(idx, c_idx,
    model_aux, return_loss=True)` and `sample_rq`."""

    cond_is_class = False

    def __init__(self, transformer_config, first_stage_config, ckpt_path=None, ignore_keys=(),
                 monitor=None, weight_decay=0.01, warmup_epochs=0):
        super().__init__()
        self.transformer = instantiate_from_config(transformer_config)
        self.first_stage_model = _first_stage(first_stage_config)
        self.cond_stage_model = SOSProvider(0)
        self.first_stage_key = "image"
        self.cond_stage_key = "image"
        self.monitor = monitor
        self.weight_decay = weight_decay
        self.warmup_epochs = warmup_epochs
        self.ckpt_path = ckpt_path
        self.ignore_keys = tuple(ignore_keys)
        self.pkeep = 1.0

    def train(self, mode: bool = True):
        super().train(mode)
        self.first_stage_model.eval()
        return self

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        self.transformer.init_weights(generator)
        self.first_stage_model.init_weights(generator)

    @torch.no_grad()
    def encode_to_z(self, x):
        """(B, h, w, depth) codes."""
        _, _, info, *_ = self.first_stage_model.encode(x)
        return info[2]

    def encode_to_c(self, c):
        _, _, (_, _, idx) = self.cond_stage_model.encode(c)
        return idx

    def forward(self, x, c, train=False, generator=None, seed=None):
        codes = self.encode_to_z(x)
        return self.transformer(codes, self.encode_to_c(c).to(codes.device), return_loss=True,
                                train=train, generator=generator, seed=seed)

    @torch.no_grad()
    def decode_to_img(self, codes):
        quant = self.first_stage_model.get_code_emb_with_depth(codes)
        return self.first_stage_model.decode(quant)

    def sample(self, shape, c, generator=None, temperature=1.0, top_k=300, top_p=0.95):
        """Codes of `shape` (B, h, w, depth); `c` images (a condition of
        SOS tokens is made from them) or (B, Lc) condition tokens."""
        from ..nn.rq_transformer import sample_rq

        c_idx = self.encode_to_c(c) if c.dim() > 2 else torch.as_tensor(c).long()
        return sample_rq(self.transformer, shape, c_idx, generator, temperature, top_k, top_p)

    @torch.no_grad()
    def log_images(self, x, generator=None, temperature=1.0, top_k=300, top_p=0.95):
        """{"inputs", "reconstructions", "sample"} of the first four images."""
        x = x[:4]
        codes = self.encode_to_z(x)
        sampled = self.sample(codes.shape, x, generator, temperature, top_k, top_p)
        return {"inputs": x, "reconstructions": self.decode_to_img(codes),
                "sample": self.decode_to_img(sampled)}

