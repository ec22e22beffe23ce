"""Dualformer — image encode to code streams, the stage-2 training forward
and loss, KV-cached sampling, and decode (counterpart of
`dynamicvectorquantization_tpu/models/dqtransformer.py`); and
`ClassCondDualformer`, its class-conditional subclass.

The condition `c` of `encode_to_c` is the batch size for an unconditional
model; for a class model (B,) / (B, 1) integer labels, or a batch size
meaning label 0 for every row (the JAX sampler, server and scripts condition
on zeros). `forward`, `forward_tokens` and `log_images` take a class model's
labels as `c` (None: the batch size). The label providers turn it into the
six stream prefixes.

Training: `forward` encodes images with the frozen first stage and hands the
streams to `forward_tokens`, which prefixes them with the condition tokens,
builds the shifted targets and runs `StackGPT.forward`; `loss` weighs the
content and position losses. A cached-codes pipeline encodes once
(`Stage2Trainer.encode_dataset`) and calls `forward_tokens` directly.

Sampling generates coarse (position, content) pairs until every row has
emitted the coarse EOS, then fine pairs, each AR step feeding ONE token
through each stack against its KV cache. The JAX package's
`lax.while_loop`s become Python loops that stop when every row is done or at
capacity. Ban masks, as in the reference:

  * coarse position: already sampled, pad, and every index >= hw1^2 - 1 are
    banned (the bottom-right coarse position can never be sampled — a
    replicated reference quirk, QUIRKS #12); EOS stays allowed;
  * fine position: already sampled or covered by a coarse region, pad, sos;
  * content: pad / eos / sos; rows that are done are forced to pad.

At the fine-phase entry the last coarse token is fed to both caches, with
`content_step(..., is_fine=True)` on the fine SOS position (training
semantics, QUIRKS #11). The KV-cache dtype follows the transformer's param
dtype unless the transformer asks for int8 caches.

State_dict names follow the reference: `transformer.*`, `first_stage_model.*`.
"""
from __future__ import annotations

import torch
from torch import nn

from ..utils.instantiate import instantiate_from_config
from .permuter import pack_masked
from .sampling import sample_from_logits

NEG_INF = -1e9


class Dualformer(nn.Module):
    cond_is_class = False

    def __init__(self, transformer_config, first_stage_config, uncond_stage_config=None,
                 cond_stage_config=None, class_cond_stage_config=None, permuter_config=None,
                 content_loss_weight=1.0, position_loss_weight=1.0,
                 activate_sos_for_fine_sequence=True,
                 weight_decay=0.01, warmup_epochs=0, monitor=None, ckpt_path=None,
                 ignore_keys=(), compute_dtype=None, dropout_prng_impl="rbg"):
        super().__init__()
        if not activate_sos_for_fine_sequence:
            raise NotImplementedError(
                "sample_from_scratch requires activate_sos_for_fine_sequence=True")
        cond_cfg = uncond_stage_config or cond_stage_config or class_cond_stage_config
        self.transformer = instantiate_from_config(transformer_config)
        self.first_stage_model = instantiate_from_config(first_stage_config)
        self.permuter = instantiate_from_config(permuter_config)
        self.cond_stage_model = instantiate_from_config(cond_cfg)
        self.content_loss_weight = content_loss_weight
        self.position_loss_weight = position_loss_weight
        self.weight_decay = weight_decay
        self.warmup_epochs = warmup_epochs
        self.monitor = monitor
        self.compute_dtype = compute_dtype
        self.first_stage_key = "image"
        self.cond_stage_key = "class_label" if self.cond_is_class else "image"

        tparams = transformer_config["params"]
        pparams = permuter_config["params"]
        cparams = cond_cfg["params"]
        self.activate_segment = tparams.get("segment_size", 0) > 0
        self.content_pad_code = pparams["content_pad_code"]
        self.content_eos_code = pparams["content_eos_code"]
        self.content_sos_code = cparams.get("coarse_sos", cparams.get("threshold_content"))
        self.coarse_position_pad_code = pparams["coarse_position_pad_code"]
        self.coarse_position_eos_code = pparams["coarse_position_eos_code"]
        self.fine_position_pad_code = pparams["fine_position_pad_code"]
        self.fine_position_eos_code = pparams["fine_position_eos_code"]
        self.fine_position_sos_code = cparams.get("fine_pos_sos",
                                                  cparams.get("threshold_fine_position"))
        self.hw1 = pparams["coarse_hw"]
        self.fine_hw = pparams["fine_hw"]
        self.hw2 = self.fine_hw // self.hw1
        self.fine_position_order = pparams.get("fine_position_order", "region-first")
        self.max_coarse_position_idx = self.hw1 * self.hw1 - 1  # QUIRKS #12
        self.fine_position_size = tparams["fine_position_size"]
        self.vocab_size = tparams["vocab_size"]

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        self.transformer.init_weights(generator)
        self.first_stage_model.init_weights(generator)

    @torch.no_grad()
    def encode_to_z(self, x, first_stage=None):
        """Frozen stage-1 encode + permuter pack: (B, H, W, 3) NHWC images ->
        (quant, the permuter's dict of six (B, L) streams). `first_stage`
        (the model's own when None) encodes, in its parameters' dtype: the
        images are cast to it, so a first stage cast to bf16 (the stage-2
        trainer's, under `compute_dtype: bfloat16`) encodes bf16 images, as
        the JAX trainer casts both."""
        fs = self.first_stage_model if first_stage is None else first_stage
        x = x.to(fs.quant_conv.weight.dtype)
        quant, _, info, grain_indices, _, _ = fs.encode(x)
        return quant, self.permuter.forward(info[2], grain_indices)

    def encode_to_c(self, c, device=None):
        """The six (B, 1) stream prefixes of the condition `c` (see the
        module note) on `device` (`c`'s own when it is a tensor)."""
        return self.cond_stage_model.encode(c, device)

    @torch.no_grad()
    def decode_to_img(self, coarse_content, fine_content, coarse_position, fine_position):
        """Token streams -> (B, H, W, 3) NHWC images."""
        indices = self.permuter.forward_back(
            coarse_content, fine_content, coarse_position, fine_position)
        quant = self.first_stage_model.get_code_emb_with_depth(indices)
        return self.first_stage_model.decode(quant)

    # ---------------------------------------------------------- training
    def forward(self, x, c=None, train=False, generator=None, seed=None, first_stage=None):
        """Images (B, H, W, 3) and their condition `c` -> the training losses
        (frozen encode by `first_stage`, as `encode_to_z`, then
        `forward_tokens`)."""
        _, z = self.encode_to_z(x, first_stage)
        return self.forward_tokens(z, c, train=train, generator=generator, seed=seed)

    def forward_tokens(self, z, c=None, train=False, generator=None, seed=None):
        """The training losses from PRE-ENCODED permuter streams `z` (the dict
        `encode_to_z` returns, (B, L) integer tensors on the model's device)
        and the condition `c` (None: the batch size). `generator` and the
        integer `seed` feed the dropouts when `train`."""
        z = {k: v.long() for k, v in z.items()}
        ref = z["coarse_content"]
        c_coarse, c_fine, c_pos_coarse, c_pos_fine, c_seg_coarse, c_seg_fine = \
            self.encode_to_c(ref.shape[0] if c is None else c, ref.device)

        def prefixed(c, key):
            return torch.cat([c, z[key]], dim=1)

        coarse_content = prefixed(c_coarse, "coarse_content")
        coarse_position = prefixed(c_pos_coarse, "coarse_position")
        fine_content = prefixed(c_fine, "fine_content")
        fine_position = prefixed(c_pos_fine, "fine_position")
        seg = self.activate_segment
        return self.transformer(
            coarse_content, fine_content, coarse_position, fine_position,
            coarse_seg=prefixed(c_seg_coarse, "coarse_segment") if seg else None,
            fine_seg=prefixed(c_seg_fine, "fine_segment") if seg else None,
            content_target=torch.cat([coarse_content, fine_content], dim=1)[:, 1:],
            coarse_position_target=coarse_position[:, 1:],
            fine_position_target=fine_position,
            train=train, generator=generator, seed=seed)

    def loss(self, output):
        return (self.content_loss_weight * output["content_loss"]
                + self.position_loss_weight * output["position_loss"])

    @torch.no_grad()
    def log_images(self, x, c=None, generator=None, temperature=1.0, top_k=300, top_p=1.0,
                   top_k_pos=100, top_p_pos=1.0):
        """The training loop's image grids from up to 4 images `x` (B, H, W,
        3) and their condition `c` (a class model's labels): samples with the
        fine positions fixed to the schedule, free samples, the inputs and
        their reconstructions through the stage-2 path (encode, pack, unpack,
        decode). numpy arrays in [-1, 1]."""
        x = x[:4].float()
        c = self.encode_to_c(x.shape[0] if c is None else c[:4], x.device)
        knobs = dict(generator=generator, temperature=temperature, top_k=top_k, top_p=top_p,
                     top_k_pos=top_k_pos, top_p_pos=top_p_pos)
        log = {}
        for name, fixed in (("samples_fixed_fine_position", True),
                            ("samples_from_scratch", False)):
            toks = self.sample_from_scratch(*c, fix_fine_position=fixed, **knobs)
            log[name] = self.decode_to_img(*toks)
        z = self.encode_to_z(x)[1]
        log["inputs"] = x
        log["reconstructions"] = self.decode_to_img(
            z["coarse_content"], z["fine_content"], z["coarse_position"], z["fine_position"])
        return {k: v.float().cpu().numpy() for k, v in log.items()}

    # ------------------------------------------------------------- masks
    def _content_mask(self, logits, done):
        banned = torch.zeros(logits.shape[-1], dtype=torch.bool, device=logits.device)
        banned[self.content_pad_code] = True
        banned[self.content_eos_code] = True
        if self.content_sos_code is not None:
            banned[self.content_sos_code] = True
        live = torch.where(banned, NEG_INF, logits)
        return torch.where(done[:, None], self._pad_only(logits, self.content_pad_code), live)

    def _coarse_position_mask(self, logits, pos_ban, done):
        idx = torch.arange(logits.shape[-1], device=logits.device)
        banned = pos_ban | (idx >= self.max_coarse_position_idx)
        banned[:, self.coarse_position_pad_code] = True
        banned[:, self.coarse_position_eos_code] = False  # keep eos
        live = torch.where(banned, NEG_INF, logits)
        return torch.where(done[:, None],
                           self._pad_only(logits, self.coarse_position_pad_code), live)

    def _fine_position_mask(self, logits, pos_ban, done):
        banned = pos_ban.clone()
        banned[:, self.fine_position_pad_code] = True
        banned[:, self.fine_position_eos_code] = False
        if self.fine_position_sos_code is not None:
            banned[:, self.fine_position_sos_code] = True
        live = torch.where(banned, NEG_INF, logits)
        return torch.where(done[:, None],
                           self._pad_only(logits, self.fine_position_pad_code), live)

    @staticmethod
    def _pad_only(logits, pad_code):
        out = torch.full_like(logits, NEG_INF)
        out[:, pad_code] = logits[:, pad_code]
        return out

    def _coarse_covered_to_fine_positions(self, coarse_mask):
        """(B, hw1^2) bool -> (B, fine_hw^2) bool of the fine positions those
        coarse regions cover (raster order)."""
        b = coarse_mask.shape[0]
        grid = coarse_mask.reshape(b, self.hw1, self.hw1)
        rep = grid.repeat_interleave(self.hw2, 1).repeat_interleave(self.hw2, 2)
        return rep.reshape(b, self.fine_hw * self.fine_hw)

    def _remaining_fine_position_sequence(self, coarse_mask):
        """Fine-position schedule for fix_fine_position mode: the positions no
        coarse region covers, in permuter order, then eos, then pad."""
        b = coarse_mask.shape[0]
        n_fine = self.fine_hw * self.fine_hw
        dev = coarse_mask.device
        region_free = ~coarse_mask
        if self.fine_position_order == "region-first":
            values = self.permuter.position_sequence_fine.reshape(1, -1).to(dev).expand(b, -1)
            mask = region_free.repeat_interleave(self.hw2 * self.hw2, dim=-1)
        else:
            values = torch.arange(n_fine, device=dev).expand(b, -1)
            mask = self._coarse_covered_to_fine_positions(region_free)
        order = torch.arange(n_fine, device=dev).expand(b, -1)
        return pack_masked(values, order, mask, self.permuter.fine_max_len,
                           self.fine_position_eos_code, self.fine_position_pad_code)

    # ------------------------------------------------------------ sampling
    @torch.no_grad()
    def sample_from_scratch(self, c_coarse, c_fine, c_pos_coarse, c_pos_fine, c_seg_coarse,
                            c_seg_fine, generator=None, temperature=1.0, sample=True,
                            top_k=None, top_p=None, top_k_pos=None, top_p_pos=None,
                            fix_fine_position=False):
        """Coarse-to-fine AR generation with KV caches and static buffers.

        Inputs are the (B, 1) condition prefixes of `encode_to_c`. Returns
        (coarse_content, fine_content, coarse_position, fine_position) without
        the prefix, shapes (B, coarse_max_len) / (B, fine_max_len)."""
        tf = self.transformer
        dev = c_coarse.device
        b = c_coarse.shape[0]
        nc, nf = self.permuter.coarse_max_len, self.permuter.fine_max_len
        lc, lf = nc + 1, nf + 1
        p = self.fine_position_size
        param_dtype = next(tf.parameters()).dtype
        pos_cache, content_cache = tf.make_caches(b, lc + lf, param_dtype, dev)
        ar = torch.arange(p, device=dev)

        def draw(logits, k, top_p_):
            return sample_from_logits(generator, logits, 1.0, k, top_p_, sample)

        coarse_content = torch.full((b, lc), self.content_pad_code, dtype=torch.long, device=dev)
        coarse_position = torch.full((b, lc), self.coarse_position_pad_code, dtype=torch.long,
                                     device=dev)
        coarse_content[:, 0] = c_coarse[:, 0]
        coarse_position[:, 0] = c_pos_coarse[:, 0]
        seg0 = c_seg_coarse[:, 0] if self.activate_segment else None
        seg1 = c_seg_fine[:, 0] if self.activate_segment else None

        # ---- coarse phase ----
        pos_ban = ar[None, :] == c_pos_coarse[:, :1]
        done = torch.zeros(b, dtype=torch.bool, device=dev)
        i = 0
        while i < nc and not bool(done.all()):
            x = tf.embed_input_token(coarse_content[:, i], coarse_position[:, i], seg0, i, False)
            hidden, pos_logits = tf.position_step(x, pos_cache, i)
            pos_logits = self._coarse_position_mask(pos_logits / temperature, pos_ban, done)
            new_pos = draw(pos_logits, top_k_pos, top_p_pos)
            content_logits = tf.content_step(hidden, new_pos, False, content_cache, i)
            done = done | (new_pos == self.coarse_position_eos_code)
            content_logits = self._content_mask(content_logits / temperature, done)
            new_content = draw(content_logits, top_k, top_p)
            coarse_content[:, i + 1] = new_content
            coarse_position[:, i + 1] = new_pos
            pos_ban = pos_ban | (ar[None, :] == new_pos[:, None])
            i += 1
        coarse_len = i + 1
        coarse_region_mask = pos_ban[:, : self.hw1 * self.hw1]

        # ---- fine-phase entry: the last coarse token feeds both caches ----
        fine_content = torch.full((b, lf), self.content_pad_code, dtype=torch.long, device=dev)
        fine_position = torch.full((b, lf), self.fine_position_pad_code, dtype=torch.long,
                                   device=dev)
        fine_content[:, 0] = c_fine[:, 0]
        fine_position[:, 0] = c_pos_fine[:, 0]
        last = coarse_len - 1
        x = tf.embed_input_token(coarse_content[:, last], coarse_position[:, last], seg0,
                                 last, False)
        hidden, _ = tf.position_step(x, pos_cache, last)
        # logits unused: the fine sos is part of the conditioning prefix
        tf.content_step(hidden, fine_position[:, 0], True, content_cache, last)

        fine_schedule = (self._remaining_fine_position_sequence(coarse_region_mask)
                         if fix_fine_position else None)
        pos_ban = torch.zeros((b, p), dtype=torch.bool, device=dev)
        pos_ban[:, : self.fine_hw * self.fine_hw] = \
            self._coarse_covered_to_fine_positions(coarse_region_mask)
        pos_ban = pos_ban | (ar[None, :] == c_pos_fine[:, :1])

        # ---- fine phase ----
        done = torch.zeros(b, dtype=torch.bool, device=dev)
        j = 0
        while j < nf and not bool(done.all()):
            g = coarse_len + j  # global token index
            x = tf.embed_input_token(fine_content[:, j], fine_position[:, j], seg1, g, True)
            hidden, pos_logits = tf.position_step(x, pos_cache, g)
            if fix_fine_position:
                new_pos = fine_schedule[:, j]
            else:
                pos_logits = self._fine_position_mask(pos_logits / temperature, pos_ban, done)
                new_pos = draw(pos_logits, top_k_pos, top_p_pos)
            content_logits = tf.content_step(hidden, new_pos, True, content_cache, g)
            done = done | (new_pos == self.fine_position_eos_code)
            content_logits = self._content_mask(content_logits / temperature, done)
            new_content = draw(content_logits, top_k, top_p)
            fine_content[:, j + 1] = new_content
            fine_position[:, j + 1] = new_pos
            pos_ban = pos_ban | (ar[None, :] == new_pos[:, None])
            j += 1
        self.last_ar_steps = coarse_len + j  # AR steps of the last call, incl. the entry step

        return (coarse_content[:, 1:], fine_content[:, 1:],
                coarse_position[:, 1:], fine_position[:, 1:])


class ClassCondDualformer(Dualformer):
    """Class-conditional Dualformer (JAX `ClassCondDualformer`): the class
    tokens (label + threshold, the top range of each vocabulary) replace the
    SOS prefixes, and sampling bans the class ranges:

      * content: pad and every index >= content_eos_code (eos and classes);
      * fine position: already sampled, pad, and every index >
        fine_position_eos_code (classes); eos stays allowed.
    """

    cond_is_class = True

    def _content_mask(self, logits, done):
        idx = torch.arange(logits.shape[-1], device=logits.device)
        banned = idx >= self.content_eos_code
        banned[self.content_pad_code] = True
        live = torch.where(banned, NEG_INF, logits)
        return torch.where(done[:, None], self._pad_only(logits, self.content_pad_code), live)

    def _fine_position_mask(self, logits, pos_ban, done):
        idx = torch.arange(logits.shape[-1], device=logits.device)
        banned = pos_ban | (idx > self.fine_position_eos_code)
        banned[:, self.fine_position_pad_code] = True
        banned[:, self.fine_position_eos_code] = False
        live = torch.where(banned, NEG_INF, logits)
        return torch.where(done[:, None],
                           self._pad_only(logits, self.fine_position_pad_code), live)
