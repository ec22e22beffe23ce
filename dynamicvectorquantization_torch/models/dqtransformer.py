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
content and position losses. With `activate_sos_for_fine_sequence=False`
the fine streams go in without their prefix token, as in the JAX model, and
`sample_from_scratch` raises, as the JAX sampler does. A cached-codes
pipeline encodes once (`Stage2Trainer.encode_dataset`) and calls
`forward_tokens` directly.

Sampling generates coarse (position, content) pairs until every row has
emitted the coarse EOS, then fine pairs, each AR step feeding ONE token
through each stack against its KV cache. Each of the JAX package's two
`lax.while_loop(cond, body)`s becomes a loop of MASKED steps over static
state (preallocated device tensors: the loop index, `done`, the ban mask,
the token buffers, the caches): a step computes `body` and commits it only
where `cond = (i < n_max) & ~all(done)` holds, so a step past the end
changes no result (it still draws from the generator). The host runs
`STEPS_PER_READ` steps, then reads `cond` once; the loop index reaches the
caches and kernel #8 as a device int32. On a CUDA device each block of
`STEPS_PER_READ` steps is a replay of a captured CUDA graph
(`models/graphs.py`); on the CPU the same steps run eagerly. The one other
host read of a call is the coarse length, where the fine phase starts. Ban
masks, as in the reference:

  * coarse position: already sampled, pad, and every index >= hw1^2 - 1 are
    banned (the bottom-right coarse position can never be sampled — a
    replicated reference quirk, QUIRKS #12); EOS stays allowed;
  * fine position: already sampled or covered by a coarse region, pad, sos;
  * content: pad / eos / sos; rows that are done are forced to pad.

At the fine-phase entry the last coarse token is fed to both caches, with
`content_step(..., is_fine=True)` on the fine SOS position (training
semantics, QUIRKS #11). The KV-cache dtype follows the transformer's param
dtype unless the transformer asks for int8 caches.

`T2IDualformer`, the text-to-image subclass, takes a list of captions as
`c`: its text encoder's features are computed and dropped (the reference),
or consumed by the content transformer's cross-attention
(`use_text_conditioning`); it samples without captions, as the JAX model.

State_dict names follow the reference: `transformer.*`, `first_stage_model.*`.
"""
from __future__ import annotations

import contextlib

import torch
from torch import nn

from ..ops.kv_int8 import CHUNK
from ..utils.instantiate import instantiate_from_config
from . import graphs
from .permuter import pack_masked
from .sampling import sample_from_logits

NEG_INF = -1e9
# AR steps per host read of the loop condition (K): one CUDA graph replays K masked
# steps. A phase runs up to K - 1 steps past its end (each about an AR step's device
# time); a read costs a device-to-host round trip and a drained queue. On the H100 a
# served batch took the same time at K = 4, 8, 16 and 32 within its spread, and its
# first batch (the captures) least at 4 (PERF.md, `utils/sample_wall.py`).
STEPS_PER_READ = 4


class Dualformer(nn.Module):
    cond_is_class = False

    def __init__(self, transformer_config, first_stage_config, uncond_stage_config=None,
                 cond_stage_config=None, class_cond_stage_config=None, permuter_config=None,
                 content_loss_weight=1.0, position_loss_weight=1.0,
                 activate_sos_for_fine_sequence=True,
                 weight_decay=0.01, warmup_epochs=0, monitor=None, ckpt_path=None,
                 ignore_keys=(), compute_dtype=None, dropout_prng_impl="rbg"):
        super().__init__()
        cond_cfg = uncond_stage_config or cond_stage_config or class_cond_stage_config
        self.transformer = instantiate_from_config(transformer_config)
        self.transformer_train_forward = None  # a model axis's training forward, or None
        self.first_stage_model = instantiate_from_config(first_stage_config)
        self.permuter = instantiate_from_config(permuter_config)
        self.cond_stage_model = instantiate_from_config(cond_cfg)
        self.content_loss_weight = content_loss_weight
        self.position_loss_weight = position_loss_weight
        self.activate_sos_for_fine_sequence = activate_sos_for_fine_sequence
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

    def forward_tokens(self, z, c=None, train=False, generator=None, seed=None,
                       text_memory=None, text_mask=None):
        """The training losses from PRE-ENCODED permuter streams `z` (the dict
        `encode_to_z` returns, (B, L) integer tensors on the model's device)
        and the condition `c` (None: the batch size). `generator` and the
        integer `seed` feed the dropouts when `train`. `text_memory`,
        `text_mask`: caption features for a transformer that cross-attends
        (`T2IDualformer`'s consuming variant)."""
        z = {k: v.long() for k, v in z.items()}
        ref = z["coarse_content"]
        c_coarse, c_fine, c_pos_coarse, c_pos_fine, c_seg_coarse, c_seg_fine = \
            self.encode_to_c(ref.shape[0] if c is None else c, ref.device)

        def prefixed(c, key, fine=False):
            if fine and not self.activate_sos_for_fine_sequence:
                return z[key]  # the fine sequence without its prefix token, as JAX builds it
            return torch.cat([c, z[key]], dim=1)

        coarse_content = prefixed(c_coarse, "coarse_content")
        coarse_position = prefixed(c_pos_coarse, "coarse_position")
        fine_content = prefixed(c_fine, "fine_content", True)
        fine_position = prefixed(c_pos_fine, "fine_position", True)
        seg = self.activate_segment
        # the training forward of a model axis (`train/stage2.py`), else the
        # StackGPT's own
        forward = self.transformer_train_forward if train else None
        text = ({} if text_memory is None
                else {"text_memory": text_memory, "text_mask": text_mask})
        return (forward or self.transformer)(
            coarse_content, fine_content, coarse_position, fine_position,
            coarse_seg=prefixed(c_seg_coarse, "coarse_segment") if seg else None,
            fine_seg=prefixed(c_seg_fine, "fine_segment", True) if seg else None,
            content_target=torch.cat([coarse_content, fine_content], dim=1)[:, 1:],
            coarse_position_target=coarse_position[:, 1:],
            fine_position_target=fine_position,
            train=train, generator=generator, seed=seed, **text)

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
    # Bans are comparisons with the vocabulary index, never element writes of a
    # Python scalar: a CUDA graph cannot capture a host-to-device copy.
    def _content_mask(self, logits, done):
        idx = torch.arange(logits.shape[-1], device=logits.device)
        banned = (idx == self.content_pad_code) | (idx == self.content_eos_code)
        if self.content_sos_code is not None:
            banned = banned | (idx == self.content_sos_code)
        live = torch.where(banned, NEG_INF, logits)
        return torch.where(done[:, None], self._pad_only(logits, self.content_pad_code), live)

    def _coarse_position_mask(self, logits, pos_ban, done):
        idx = torch.arange(logits.shape[-1], device=logits.device)
        banned = ((pos_ban | (idx >= self.max_coarse_position_idx)
                   | (idx == self.coarse_position_pad_code))
                  & (idx != self.coarse_position_eos_code))  # keep eos
        live = torch.where(banned, NEG_INF, logits)
        return torch.where(done[:, None],
                           self._pad_only(logits, self.coarse_position_pad_code), live)

    def _fine_position_mask(self, logits, pos_ban, done):
        idx = torch.arange(logits.shape[-1], device=logits.device)
        banned = (pos_ban | (idx == self.fine_position_pad_code)) & (
            idx != self.fine_position_eos_code)
        if self.fine_position_sos_code is not None:
            banned = banned | (idx == self.fine_position_sos_code)
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
                            fix_fine_position=False, eager=False):
        """Coarse-to-fine AR generation with KV caches and static buffers.

        Inputs are the (B, 1) condition prefixes of `encode_to_c`. Returns
        (coarse_content, fine_content, coarse_position, fine_position) without
        the prefix, shapes (B, coarse_max_len) / (B, fine_max_len), on the
        prefixes' device; `last_ar_steps` then reads the call's AR steps.

        On a CUDA device the masked steps run as CUDA graph replays drawing
        from the graphs' generator, which carries `generator`'s state (the
        default generator's when None) through the call. `eager=True` runs
        them eagerly there instead: only the control that `chip_smoke.py` and
        the `cuda` tests hold the graphs against; no entry point passes it."""
        if not self.activate_sos_for_fine_sequence:
            # the static buffers reserve slot 0 of the fine streams for the prefix token
            raise NotImplementedError(
                "sample_from_scratch requires activate_sos_for_fine_sequence=True")
        tf = self.transformer
        dev = c_coarse.device
        b = c_coarse.shape[0]
        nc, nf = self.permuter.coarse_max_len, self.permuter.fine_max_len
        param_dtype = next(tf.parameters()).dtype
        cache_kind = "int8" if tf.kv_cache_dtype == "int8" else param_dtype
        runner = None if dev.type != "cuda" or eager else graphs.runner_for(self, dev)
        if runner is None:
            st = _SamplerState(self, b, param_dtype, dev)
        else:  # the graphs' static state, one per shape, used by one call at a time
            st = runner.state.get((b, cache_kind))
            if st is None:
                st = runner.state[(b, cache_kind)] = _SamplerState(self, b, param_dtype, dev)
        knobs = (temperature, sample, top_k, top_p, top_k_pos, top_p_pos)
        k = STEPS_PER_READ
        key = (b, cache_kind, knobs, fix_fine_position, k, graphs.parameter_storage(tf))
        chunks = st.pos_cache.layers[0][0].shape[2] // CHUNK

        def run_phase(gen, fine, offset):
            """Blocks of `k` masked steps until `cond` reads False.
            `offset`: the phase's first cache index (a host int)."""
            n_max = nf if fine else nc
            done_steps = 0
            while True:
                # float caches read the chunks up to the block's last possible index
                last = offset + min(done_steps + k - 1, n_max)
                n_chunks = None if cache_kind == "int8" else min(chunks, last // CHUNK + 1)

                def block():
                    for _ in range(k):
                        self._masked_step(st, fine, n_chunks, gen, knobs, fix_fine_position)
                    st.update_cond(fine, n_max)

                if runner is None:
                    block()
                else:
                    runner.run(key + (fine, n_chunks), block)
                done_steps += k
                if not bool(st.cond):
                    return

        with (contextlib.nullcontext(generator) if runner is None
              else runner.carry_generator(generator)) as gen:
            st.reset(self, c_coarse, c_fine, c_pos_coarse, c_pos_fine, c_seg_coarse, c_seg_fine)
            run_phase(gen, False, 0)
            coarse_len = int(st.i) + 1
            self._enter_fine_phase(st, coarse_len, fix_fine_position)
            run_phase(gen, True, coarse_len)
        self._ar_steps = st.i + 1 + st.j  # AR steps incl. the entry step, read when asked
        return (st.coarse_content[:, 1:].clone(), st.fine_content[:, 1:].clone(),
                st.coarse_position[:, 1:].clone(), st.fine_position[:, 1:].clone())

    @property
    def last_ar_steps(self) -> int:
        """AR steps of the last `sample_from_scratch` call, the fine-phase
        entry step included (a host read of its device counters)."""
        return int(self._ar_steps)

    def _masked_step(self, st, fine, n_chunks, generator, knobs, fix_fine_position):
        """One iteration of the JAX sampler's `coarse_step` / `fine_step`,
        committed only where `cond` holds (a frozen step rewrites its cache
        row and the column past the last, with what they hold)."""
        temperature, sample, top_k, top_p, top_k_pos, top_p_pos = knobs
        tf = self.transformer
        if fine:
            i, n_max, content, position, seg = st.j, st.nf, st.fine_content, st.fine_position, st.seg1
            index = st.coarse_len + st.j  # global token index
        else:
            i, n_max, content, position, seg = st.i, st.nc, st.coarse_content, st.coarse_position, st.seg0
            index = st.i
        col = i.reshape(1)
        x = tf.embed_input_token(content.index_select(1, col)[:, 0],
                                 position.index_select(1, col)[:, 0], seg, index, fine)
        hidden, pos_logits = tf.position_step(x, st.pos_cache, index, n_chunks)
        if fine and fix_fine_position:
            new_pos = st.fine_schedule.index_select(1, col.clamp(max=n_max - 1))[:, 0]
        else:
            mask = self._fine_position_mask if fine else self._coarse_position_mask
            pos_logits = mask(pos_logits / temperature, st.pos_ban, st.done)
            new_pos = sample_from_logits(generator, pos_logits, 1.0, top_k_pos, top_p_pos, sample)
        content_logits = tf.content_step(hidden, new_pos, fine, st.content_cache, index, n_chunks)
        eos = self.fine_position_eos_code if fine else self.coarse_position_eos_code
        done_after = st.done | (new_pos == eos)
        content_logits = self._content_mask(content_logits / temperature, done_after)
        new_content = sample_from_logits(generator, content_logits, 1.0, top_k, top_p, sample)

        active = (i < n_max) & ~st.done.all()
        out = (i + 1).clamp(max=n_max).reshape(1).long()  # in bounds when frozen at n_max
        for buf, new in ((content, new_content), (position, new_pos)):
            buf.index_copy_(1, out, torch.where(active, new, buf.index_select(1, out)[:, 0])[:, None])
        st.pos_ban.copy_(torch.where(active, st.pos_ban | (st.ar[None, :] == new_pos[:, None]),
                                     st.pos_ban))
        st.done.copy_(torch.where(active, done_after, st.done))
        i.add_(active.to(i.dtype))

    def _enter_fine_phase(self, st, coarse_len, fix_fine_position):
        """The fine-phase entry, outside any graph: the last coarse token feeds
        both caches (its content step on the fine sos position; the logits
        are unused, the fine sos is part of the conditioning prefix), then the
        fine ban mask and, with `fix_fine_position`, the schedule."""
        tf = self.transformer
        last = coarse_len - 1
        x = tf.embed_input_token(st.coarse_content[:, last], st.coarse_position[:, last],
                                 st.seg0, st.i, False)
        n_chunks = last // CHUNK + 1  # read by float caches
        hidden, _ = tf.position_step(x, st.pos_cache, st.i, n_chunks)
        tf.content_step(hidden, st.fine_position[:, 0], True, st.content_cache, st.i, n_chunks)
        coarse_region_mask = st.pos_ban[:, : self.hw1 * self.hw1]
        if fix_fine_position:
            st.fine_schedule.copy_(self._remaining_fine_position_sequence(coarse_region_mask))
        covered = self._coarse_covered_to_fine_positions(coarse_region_mask)
        st.pos_ban.zero_()
        st.pos_ban[:, : self.fine_hw * self.fine_hw] = covered
        st.pos_ban |= st.ar[None, :] == st.c_pos_fine[:, None]
        st.done.zero_()
        st.coarse_len.copy_(st.i + 1)


class _SamplerState:
    """The sampler's loop state in preallocated tensors on one device: what
    the masked steps (and the CUDA graphs of them) read and write in place.
    `reset` refills it for a call, outside any graph."""

    def __init__(self, model, b, param_dtype, dev):
        tf = model.transformer
        self.nc, self.nf = model.permuter.coarse_max_len, model.permuter.fine_max_len
        self.pos_cache, self.content_cache = tf.make_caches(b, self.nc + self.nf + 2, param_dtype,
                                                            dev)

        def tokens(n):
            return torch.empty((b, n), dtype=torch.long, device=dev)

        self.coarse_content, self.coarse_position = tokens(self.nc + 1), tokens(self.nc + 1)
        self.fine_content, self.fine_position = tokens(self.nf + 1), tokens(self.nf + 1)
        self.fine_schedule = tokens(self.nf)

        def counter():
            return torch.zeros((), dtype=torch.int32, device=dev)

        self.i, self.j, self.coarse_len = counter(), counter(), counter()  # coarse, fine index
        self.cond = torch.zeros((), dtype=torch.bool, device=dev)
        self.done = torch.zeros(b, dtype=torch.bool, device=dev)
        self.ar = torch.arange(model.fine_position_size, device=dev)
        self.pos_ban = torch.zeros((b, model.fine_position_size), dtype=torch.bool, device=dev)
        self.c_pos_fine = torch.zeros(b, dtype=torch.long, device=dev)
        self.seg0 = self.seg1 = None
        if model.activate_segment:
            self.seg0 = torch.zeros(b, dtype=torch.long, device=dev)
            self.seg1 = torch.zeros(b, dtype=torch.long, device=dev)

    def reset(self, model, c_coarse, c_fine, c_pos_coarse, c_pos_fine, c_seg_coarse,
              c_seg_fine):
        for layer in self.pos_cache.layers + self.content_cache.layers:
            for t in layer[:2]:  # K, V
                t.zero_()
            for t in layer[2:]:  # int8 scales start at one, as the reference's
                t.fill_(1.0)
        for buf, pad, first in (
                (self.coarse_content, model.content_pad_code, c_coarse),
                (self.coarse_position, model.coarse_position_pad_code, c_pos_coarse),
                (self.fine_content, model.content_pad_code, c_fine),
                (self.fine_position, model.fine_position_pad_code, c_pos_fine)):
            buf.fill_(pad)
            buf[:, 0] = first[:, 0]
        self.pos_ban.copy_(self.ar[None, :] == c_pos_coarse[:, :1])
        self.c_pos_fine.copy_(c_pos_fine[:, 0])
        if self.seg0 is not None:
            self.seg0.copy_(c_seg_coarse[:, 0])
            self.seg1.copy_(c_seg_fine[:, 0])
        for t in (self.i, self.j, self.coarse_len, self.done):
            t.zero_()

    def update_cond(self, fine, n_max):
        """cond of the running phase's `while_loop`, on the device."""
        i = self.j if fine else self.i
        self.cond.copy_((i < n_max) & ~self.done.all())


class T2IDualformer(Dualformer):
    """Text-to-image variant (the JAX package's `T2IDualformer`, reference
    `dqtransformer_t2i.py`); its condition `c` is a list of B captions.

    Default (`use_text_conditioning=False`), the shipped reference: the text
    encoder computes each caption's features and they are dropped (the
    reference's StackGPT swallows them), so the model trains as the
    unconditional one while paying for the text encode. With
    `use_text_conditioning=True` the content transformer cross-attends to
    the projected features (`cross_attend_content`, masked over caption
    padding; `text_feature_dim` defaults to the encoder's `embed_dim`, 512
    where it has none), so captions shift the logits. The extra parameters
    exist only then: the default model's state_dict is the plain
    `Dualformer`'s. The text encoder (`text_encoder_config`, else
    `HashTextEncoder`) is not a submodule: it is frozen, holds no trained
    state, and runs on the images' device.

    Sampling is the inherited unconditional sampler, without captions, as
    the JAX package samples this model; `StackGPT.content_step` takes
    `text_memory` for a caller's own decode loop."""

    def __init__(self, text_encoder_config=None, use_text_conditioning=False, **kwargs):
        if text_encoder_config is None:
            from ..nn.text_encoders import HashTextEncoder

            text_encoder = HashTextEncoder()
        else:
            text_encoder = instantiate_from_config(text_encoder_config)
        use_text_conditioning = bool(use_text_conditioning)
        if use_text_conditioning:
            tcfg = kwargs["transformer_config"]
            tparams = {"text_feature_dim": getattr(text_encoder, "embed_dim", 512),
                       **tcfg.get("params", {}), "cross_attend_content": True}
            kwargs["transformer_config"] = {**tcfg, "params": tparams}
        super().__init__(**kwargs)
        self.use_text_conditioning = use_text_conditioning
        self.cond_stage_key = "caption"
        self.cond_stage_mask_key = "mask"
        self.text_encoder = text_encoder

    def encode_text(self, captions, device):
        """(features (B, S, D), mask (B, S)) of the captions on `device`."""
        return self.text_encoder.encode_text(list(captions), device=device)

    def forward(self, x, c=None, train=False, generator=None, seed=None, first_stage=None):
        """Images (B, H, W, 3) and their captions `c` -> the training losses;
        the captions are encoded either way, and consumed under
        `use_text_conditioning`."""
        if c is None:
            raise ValueError("T2IDualformer.forward needs the batch's captions")
        text_memory, text_mask = self.encode_text(c, x.device)
        if not self.use_text_conditioning:
            del text_memory, text_mask  # computed and dropped, as the reference
            return super().forward(x, None, train, generator, seed, first_stage)
        _, z = self.encode_to_z(x, first_stage)
        return self.forward_tokens(z, None, train=train, generator=generator, seed=seed,
                                   text_memory=text_memory, text_mask=text_mask)

    @torch.no_grad()
    def log_images(self, x, c=None, generator=None, **knobs):
        """As the unconditional model's: the samples take no caption."""
        return super().log_images(x, None, generator, **knobs)


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
        banned = (idx >= self.content_eos_code) | (idx == self.content_pad_code)
        live = torch.where(banned, NEG_INF, logits)
        return torch.where(done[:, None], self._pad_only(logits, self.content_pad_code), live)

    def _fine_position_mask(self, logits, pos_ban, done):
        idx = torch.arange(logits.shape[-1], device=logits.device)
        banned = ((pos_ban | (idx > self.fine_position_eos_code)
                   | (idx == self.fine_position_pad_code))
                  & (idx != self.fine_position_eos_code))
        live = torch.where(banned, NEG_INF, logits)
        return torch.where(done[:, None],
                           self._pad_only(logits, self.fine_position_pad_code), live)
