"""Stage-1 (DQ-VAE + GAN) training step (counterpart of
`dynamicvectorquantization_tpu/train/stage1.py` `Stage1Trainer`).

Two alternating optimizers, as the reference's Lightning module runs them:

  * optimizer 0 (autoencoder): Adam(0.5, 0.9) over every parameter of the
    DQ-VAE outside its loss; total = L1 + LPIPS + d_weight * disc_factor *
    generator loss + codebook_weight * commitment loss (+ budget loss);
  * optimizer 1 (discriminator): Adam(0.5, 0.9) over the discriminator; the
    hinge / vanilla / bce loss on a *fresh* training forward of the just
    updated autoencoder, detached, whose own EMA update is discarded;
  * the VQ codebook updates by EMA inside the autoencoder forward: a batch is
    quantized with the codebook from before its own update;
  * adaptive d_weight = |d nll / dW| / (|d g / dW| + 1e-4) for the decoder's
    last conv kernel W, through `conv(pre_out.detach(), W)`, with the
    discriminator on its running BatchNorm statistics from before this
    batch; clipped to [0, 1e4], times `disc_weight`, at most
    `disc_weight_max`.

Where the JAX trainer is a pure function of a `Stage1State`, this one owns
its state and updates it in place: the model's parameters and buffers (EMA
codebook, BatchNorm statistics), the two optimizers' moments `ae_m`, `ae_v`,
`disc_m`, `disc_v` keyed by parameter name, their counts, `step` and `epoch`;
`state_dict()` / `load_state_dict()` carry all of it and the state of the
trainer's own generator (which draws the codebook's restart candidates when
the caller passes none), so a resumed run continues the same stream.
Adam is plain PyTorch (`torch._foreach_*`), with optax's arithmetic; the JAX
trainer's `optax.adam` also runs outside any kernel. Logs keep the JAX
names and come back as 0-d tensors on the device.

A Gumbel-gated encoder (the feature router with `update_router`, every
triple-grain encoder) takes one noise tensor per microbatch, drawn on the
images' device from the step's generator before the autoencoder pass and fed
to it and to the discriminator pass's fresh forward alike (the JAX trainer
reuses one key for both). The noise is thus a function of the generator's
state at the step, which `state_dict()` carries, so a resumed run draws the
same noise; it follows torch's generator, not JAX's PRNG. Triple-grain
models log `train_fine_ratio` as the share of fine cells (grain 2) and
`train_median_ratio` beside it, as the JAX trainer does.

ResnetBlock dropout (a tower's `dropout` > 0) takes one `DropoutMasks` per
microbatch, whose seed is drawn from the step's generator after that
microbatch's Gumbel noise, and is given to the autoencoder pass and the
discriminator pass's fresh forward alike, as the JAX trainer reuses its
"dropout" key; remat's recompute redraws the same masks from that seed. A
model without dropout draws nothing more, so its streams are unchanged.

`remat` (the JAX trainer's option): the autoencoder pass keeps only the
input of each ResnetBlock, AttnBlock and Upsample (and of the decoder's last
norm and swish) and runs them again in the backward (`nn/blocks.py`
`segment`, non-reentrant `torch.utils.checkpoint`), as JAX's
`dots_with_no_batch_dims_saveable` policy keeps no conv activation. One
segment per block, not per level, because the recompute's own peak already
dominates: on one H100 (`utils/stage1_memory.py`, the dual-grain entropy yml
at batch 30 in f32) the autoencoder's backward starts from 16.9 GB kept
(69.0 GB without `remat`) and rises 12.2 GB above it while it runs, as the
recomputed forwards' convolutions allocate; a level's segment would rebuild
all its blocks' activations at once on top of that. The Downsamples stay out
(their kernel keeps only its input, which the segment before keeps already).
The patch entropy, the router (its Gumbel noise fed in), the quantizer (its
EMA update and restart draw), the decoder's last conv and the adaptive
weight's head stay outside every segment, so the recompute updates no
buffer, draws nothing from the generator and searches no codebook; a step
with `remat` equals one without it. `remat=None` turns it on where the
trainer's device is CUDA (the JAX trainer's rule for its accelerator) and
off on the CPU. On the H100 it trades time for memory: batch 30 in f32 takes
29.1 GB and 3.06 s a step with it, 71.8 GB and 2.18 s without; with bf16
towers 19.4 GB and 0.92 s against 54.3 GB and 0.84 s.

The discriminator pass's fresh forward draws from a copy of the step's
generator in the state the autoencoder pass of its microbatch started from,
so a quantizer that draws inside the forward (a codebook restart, Gumbel
noise, a remap fill) draws what the autoencoder pass drew, as the JAX
trainer gives both passes one key; the generator itself goes on from where
the autoencoder passes left it. A DQ-VAE's discriminator pass draws nothing.
An `RQBottleneck`'s depths update its codebook in sequence in that pass too,
on buffers it puts back (`ops/quantizers.py`).

Fixed-length models (`models/vqgan.py`) train through the same step: no
gate, so no budget loss and no grain ratios beyond the JAX trainer's
`train_fine_ratio` of their codes; a gradient-trained codebook is a
parameter of the autoencoder's optimizer. `init_state` runs a model's
`init_from_batch` on the sample batch after a seeded init (a
`MaskVectorQuantize` codebook's kmeans, which flax's init runs).

A `use_actnorm` discriminator's ActNorm layers are set from data in
`init_state`: the `sample_batch` given (the loop passes the first training
batch's first image, as the JAX loop does), else one zero image, which is
what the JAX trainer initialises them from; their `initialized` flag and
`loc` / `scale` are in the state dict. The epoch loop, checkpoints and data
loading live in `train/loop.py`.

Over several ranks (`world`), each rank takes its rows of the global batch
and the step follows the JAX step under GSPMD, which sees the global batch:
both passes run inside `parallel.dist.global_stats` (the EMA sums and the
restart pool, the discriminator's BatchNorm statistics, the budget loss's
ratio are the global batch's); the adaptive weight takes the norms of the
rank-averaged `conv_out` gradients; each optimizer steps on gradients and
logs averaged over the ranks in flat buckets (`parallel/shard.py`), with
`shard="zero1"` / `"fsdp"` on each rank's slices of the large leaves (the
parameters are the f32 masters here, so the two are one scheme: moments
sharded, parameters gathered after the update). The restart draw comes from
the trainer's generator, identical on every rank; the Gumbel noise and the
dropout seeds are drawn per rank from a generator seeded by (seed, step,
rank), so each rank's draws are its own and a resume at the same world size
repeats them.
"""
from __future__ import annotations

import os

import torch
import torch.nn.functional as F

from ..nn.encoder_dual import draw_gumbel
from ..ops.attention import mix_seed
from ..ops.fused_adamw import adamw_scalars
from ..parallel.dist import global_stats
from ..parallel.shard import SHARD_MIN_ELEMENTS, GradBuckets
from ..utils.device import resolve_device
from .schedules import make_schedule

B1, B2, EPS = 0.5, 0.9, 1e-8
# logs each pass reduces with its gradients: at most the autoencoder's 11
# (a triple-grain model's ratios) and the discriminator's 3
_N_LOGS = {"ae": 11, "disc": 3}


@torch.no_grad()
def adam_update(params, grads, m, v, lr, c1, c2):
    """One Adam update of the lists `params`, `m`, `v` in place:
    m' = b1 m + (1 - b1) g, v' = b2 v + (1 - b2) g^2,
    p' = p - lr (m' c1) / (sqrt(v' c2) + eps)."""
    torch._foreach_mul_(m, B1)
    torch._foreach_add_(m, grads, alpha=1.0 - B1)
    torch._foreach_mul_(v, B2)
    torch._foreach_addcmul_(v, grads, grads, value=1.0 - B2)
    denom = torch._foreach_mul(v, c2)
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, EPS)
    torch._foreach_addcdiv_(params, m, denom, value=-lr * c1)


class _Adam:
    """Adam(0.5, 0.9) state over named parameters; with `buckets` (several
    ranks) the gradients are averaged over the ranks before the step, and
    the moments of sharded leaves are this rank's slices."""

    def __init__(self, params: dict, schedule, buckets: GradBuckets = None):
        self.params = params
        self.schedule = schedule
        self.buckets = buckets
        self.m = {k: torch.zeros(self._shape(k), device=p.device) for k, p in params.items()}
        self.v = {k: torch.zeros(self._shape(k), device=p.device) for k, p in params.items()}
        self.count = 0

    def _sharded(self, k) -> bool:
        return self.buckets is not None and k in self.buckets.own

    def _shape(self, k):
        return (self.buckets.own_len(k),) if self._sharded(k) else self.params[k].shape

    def _own(self, k, full):
        return self.buckets.own_slice(full, k) if self._sharded(k) else full

    def reset(self):
        for k in self.params:
            self.m[k].zero_()
            self.v[k].zero_()
        self.count = 0

    def state_dict(self):
        """Count and moments, sharded leaves gathered whole (every rank calls it)."""
        out = {"count": self.count, "m": dict(self.m), "v": dict(self.v)}
        if self.buckets is not None and self.buckets.sharded:
            for key in ("m", "v"):
                out[key].update(self.buckets.gathered({k: out[key][k]
                                                       for k in self.buckets.sharded}))
        return out

    def load(self, count, m, v):
        if set(m) != set(self.params) or set(v) != set(self.params):
            raise KeyError("optimizer state does not match the parameters")
        for k in self.params:
            self.m[k].copy_(self._own(k, m[k].to(self.m[k].device)))
            self.v[k].copy_(self._own(k, v[k].to(self.v[k].device)))
        self.count = int(count)

    def reduce(self, grads, logs=None):
        """(gradients, logs) averaged over the ranks; as given on one process."""
        return (grads, logs) if self.buckets is None else self.buckets.reduce(grads, logs)

    def step(self, grads):
        """One update from `reduce`d gradients; sharded leaves update their
        slice, then every rank's slices are gathered into the parameters."""
        lr, c1, c2 = adamw_scalars(self.count, self.schedule, B1, B2)
        names = [k for k in self.params if self.m[k].numel()]
        adam_update([self._own(k, self.params[k].data) for k in names], [grads[k] for k in names],
                    [self.m[k] for k in names], [self.v[k] for k in names], lr, c1, c2)
        if self.buckets is not None and self.buckets.sharded:
            full = {k: self.params[k].data for k in self.buckets.sharded}
            self.buckets.gather(full, {k: self._own(k, full[k]) for k in full})
        self.count += 1


def grain_ratios(grain_indices, gate, split):
    """`<split>_fine_ratio` (and `<split>_median_ratio` with three grains);
    for a fixed-length model (no gate) the share of code indices above 0,
    as the JAX trainer logs it; none without indices."""
    g = grain_indices
    if g is None:
        return {}
    if gate is not None and gate.shape[-1] == 3:
        return {f"{split}_fine_ratio": (g == 2).float().mean(),
                f"{split}_median_ratio": (g == 1).float().mean()}
    return {f"{split}_fine_ratio": (g > 0).float().mean()}


def _mean_of(dicts):
    """Per-key mean of a list of dicts of tensors."""
    if len(dicts) == 1:
        return dicts[0]
    inv = 1.0 / len(dicts)
    return {k: sum(d[k] for d in dicts) * inv for k in dicts[0]}


def resolve_remat(remat, device: torch.device) -> bool:
    """`remat`, or where it is None: on for a CUDA device, off elsewhere."""
    return device.type == "cuda" if remat is None else bool(remat)


class Stage1Trainer:
    def __init__(self, model, learning_rate, min_learning_rate=0.0, warmup_steps=0,
                 max_steps=1_000_000, scheduler_type=None, remat=None, accum=1, device=None,
                 seed=0, world=None, shard=None, shard_min_elements=SHARD_MIN_ELEMENTS):
        if model.loss is None or not hasattr(model.loss, "discriminator"):
            raise ValueError("Stage1Trainer needs a model built with a GAN lossconfig")
        if shard is not None and world is None:
            raise ValueError("sharding the optimizer state needs a world of ranks")
        self.world, self.shard = world, shard
        self.device = resolve_device(device if world is None else world.device)
        self.remat = resolve_remat(remat, self.device)
        self.model = model.to(self.device).float()
        self.model.eval()  # train / eval behaviour is chosen per call, not by module mode
        self.loss = model.loss
        self.accum = int(accum)
        if self.accum < 1:
            raise ValueError("accum must be at least 1")
        sched_type = scheduler_type or model.scheduler_type

        def schedule():
            return make_schedule(sched_type, learning_rate, warmup_steps, max_steps,
                                 min_learning_rate)

        self.loss_with_epoch = getattr(model, "loss_with_epoch", True)
        self.ae_params = {k: p for k, p in model.named_parameters() if not k.startswith("loss.")}
        self.disc_params = dict(self.loss.discriminator.named_parameters())
        for p in (*self.ae_params.values(), *self.disc_params.values()):
            p.requires_grad_(True)
        self.loss.perceptual_loss.requires_grad_(False)
        buckets = {}
        if world is not None:
            for key, params in (("ae", self.ae_params), ("disc", self.disc_params)):
                buckets[key] = GradBuckets({k: p.shape for k, p in params.items()}, world, shard,
                                           shard_min_elements, self.device, _N_LOGS[key])
        self.ae_opt = _Adam(self.ae_params, schedule(), buckets.get("ae"))
        self.disc_opt = _Adam(self.disc_params, schedule(), buckets.get("disc"))
        self.step = 0
        self.epoch = 0
        self.seed = int(seed)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(self.seed)
        self._rank_generator = torch.Generator(device=self.device)

    # ------------------------------------------------------------- state
    def state_dict(self):
        """The whole training state: the model's parameters and buffers (EMA
        codebook, BatchNorm statistics, the frozen LPIPS), both optimizers,
        the step, the epoch and the trainer's generator state."""
        return {"model": self.model.state_dict(), "ae_opt": self.ae_opt.state_dict(),
                "disc_opt": self.disc_opt.state_dict(), "step": self.step, "epoch": self.epoch,
                "generator": self.generator.get_state()}

    def load_state_dict(self, state):
        self.model.load_state_dict(state["model"])
        for opt, key in ((self.ae_opt, "ae_opt"), (self.disc_opt, "disc_opt")):
            opt.load(state[key]["count"], state[key]["m"], state[key]["v"])
        self.step = int(state["step"])
        self.epoch = int(state["epoch"])
        if "generator" in state:  # a step-0 state written elsewhere keeps the seeded one
            self.generator.set_state(state["generator"].cpu())

    def init_state(self, generator: torch.Generator = None, sample_batch=None,
                   lpips_vgg_path=None, lpips_lin_path=None):
        """A fresh training state: with a generator, seeded random weights
        (`model.init_weights`: the LPIPS backbone random, its lin heads the
        bundled ones); in any case zero moments, step 0, epoch 0. Without a
        generator the model keeps the weights it was given. A discriminator's
        ActNorm layers are set from `sample_batch` ((B, H, W, 3) NHWC images,
        else one zero image) with fresh weights, or where they were never
        set. The LPIPS VGG16 backbone (a torchvision `vgg16` state dict) and
        lin heads are read from `lpips_vgg_path` / `lpips_lin_path`, or else
        from the files that `DQVQ_LPIPS_VGG` / `DQVQ_LPIPS_LIN` name, as the
        JAX trainer reads them."""
        if generator is not None:
            self.model.init_weights(generator)
        disc = self.loss.discriminator
        size = self.model.image_size
        x = (torch.zeros((1, size, size, 3), device=self.device) if sample_batch is None
             else self._images(sample_batch))
        if generator is not None and hasattr(self.model, "init_from_batch"):
            self.model.init_from_batch(x, generator)
        if getattr(disc, "use_actnorm", False) and (generator is not None
                                                    or not disc.actnorm_initialized()):
            disc.init_actnorm(x.permute(0, 3, 1, 2).contiguous())
        self.loss.perceptual_loss.load_weights(
            lpips_vgg_path or os.environ.get("DQVQ_LPIPS_VGG"),
            lpips_lin_path or os.environ.get("DQVQ_LPIPS_LIN"))
        self.ae_opt.reset()
        self.disc_opt.reset()
        self.step = 0
        self.epoch = 0
        return self

    def load_optimizer_state(self, ae, disc):
        """Continue from two `(count, m, v)` states keyed by parameter name
        (`utils.weights.adam_state_from_optax` of a JAX training state)."""
        self.ae_opt.load(*ae)
        self.disc_opt.load(*disc)

    # -------------------------------------------------------------- steps
    def _images(self, x):
        return torch.as_tensor(x).to(self.device).float()

    def _microbatches(self, x):
        if self.accum == 1:
            return [x]
        if len(x) != self.accum:
            raise ValueError(f"expected {self.accum} microbatches, got {len(x)}")
        return list(x)

    def _d_weight(self, x, pre_out):
        """The adaptive discriminator weight (see the module docstring)."""
        if not self.loss.disc_adaptive_loss:
            return pre_out.new_tensor(self.loss.disc_weight_max)
        conv_out = self.model.decoder.conv_out
        xr = F.conv2d(pre_out.detach(), conv_out.weight, conv_out.bias.detach(), padding=1)
        nll, g = self.loss.nll_and_g(x, xr.permute(0, 2, 3, 1))
        (g_nll,) = torch.autograd.grad(nll, conv_out.weight, retain_graph=True)
        (g_g,) = torch.autograd.grad(g, conv_out.weight)
        if self.world is not None:  # the global batch's gradients, one collective
            both = self.world.mean_(torch.stack([g_nll, g_g]))
            g_nll, g_g = both[0], both[1]
        d_weight = (g_nll.norm() / (g_g.norm() + 1e-4)).clamp(0.0, 1e4) * self.loss.disc_weight
        if self.loss.disc_weight_max is not None:
            d_weight = d_weight.clamp(max=self.loss.disc_weight_max)
        return d_weight.detach()

    def _gumbel_noise(self, x, generator):
        """The Gumbel noise of one microbatch's training forwards, or None."""
        shape = self.model.gumbel_shape(x.shape[0])
        return None if shape is None else draw_gumbel(shape, generator, x.device)

    def _ae_grads(self, x, gate_step, generator, noise, masks):
        """(logs, gradients of the autoencoder total by parameter name) of one
        microbatch; updates the EMA buffers and the BatchNorm statistics."""
        loss = self.loss
        (xrec, pre_out), qloss, grain_indices, gate, _ = self.model(
            x, train=True, return_pre_out=True, generator=generator, gumbel_noise=noise,
            dropout=masks, remat=self.remat)
        # before g_loss(train=True) moves the BatchNorm statistics this head reads
        d_weight = self._d_weight(x, pre_out)
        nll_loss, rec_loss, p_loss = loss.nll(x, xrec)
        g_loss = loss.g_loss(xrec, train=True)
        disc_factor = 0.0 if gate_step < loss.disc_start else loss.disc_factor
        budget = loss.budget(gate)
        total = (nll_loss + d_weight * disc_factor * g_loss + loss.codebook_weight * qloss
                 + budget)
        names = list(self.ae_params)
        grads = torch.autograd.grad(total, [self.ae_params[k] for k in names], allow_unused=True)
        grads = {k: (torch.zeros_like(self.ae_params[k]) if g is None else g)
                 for k, g in zip(names, grads)}
        logs = {**grain_ratios(grain_indices, gate, "train"),
                "train_aeloss": total, "train_rec_loss": rec_loss, "train_nll_loss": nll_loss,
                "train_p_loss": p_loss, "train_quant_loss": qloss, "train_g_loss": g_loss,
                "train_d_weight": d_weight, "train_disc_factor": x.new_tensor(disc_factor),
                "train_budget_loss": budget}
        return {k: v.detach().float() for k, v in logs.items()}, grads

    def _disc_grads(self, x, gate_step, generator, noise, masks):
        """(logs, discriminator gradients) of one microbatch, on a fresh
        training forward of the updated autoencoder (with the autoencoder
        pass's Gumbel noise and dropout masks) that leaves the EMA buffers
        alone."""
        with torch.no_grad():
            xrec = self.model(x, train=True, generator=generator, commit=False,
                              gumbel_noise=noise, dropout=masks)[0]
        d, dlog = self.loss.d_loss(x, xrec, gate_step, train=True)
        names = list(self.disc_params)
        grads = torch.autograd.grad(d, [self.disc_params[k] for k in names])
        return ({f"train_{k}": v.detach().float() for k, v in dlog.items()},
                dict(zip(names, grads)))

    def train_step(self, x, generator=None):
        """One autoencoder update and one discriminator update. x: (B, H, W,
        3) NHWC images in [-1, 1], or (accum, B, H, W, 3) with `accum > 1`:
        gradients and logs are averaged over the microbatches, the EMA and
        BatchNorm statistics evolve per microbatch, each optimizer steps
        once. `generator` draws the Gumbel noise, the dropout seeds and the
        codebook's restart candidates (the trainer's own when none is
        passed). Returns the logs."""
        if generator is None:
            generator = self.generator
        micro = self._microbatches(self._images(x))
        draw = generator
        if self.world is not None and self.world.size > 1:  # per-rank draws
            draw = self._rank_generator
            draw.manual_seed(mix_seed(self.seed, self.step, self.world.rank) >> 1)
        draws = [(self._gumbel_noise(xi, draw), self.model.dropout_masks(True, draw))
                 for xi in micro]
        gate_step = self.epoch if self.loss_with_epoch else self.step
        logs = {}
        starts = []  # the generator's state at each microbatch's autoencoder pass
        for opt, fn in ((self.ae_opt, self._ae_grads), (self.disc_opt, self._disc_grads)):
            results = []
            with global_stats(self.world):
                for i, (xi, d) in enumerate(zip(micro, draws)):
                    if fn == self._ae_grads:
                        starts.append(generator.get_state())
                        gen = generator
                    else:  # the draws of the pass it repeats (see the module docstring)
                        gen = torch.Generator(device=generator.device)
                        gen.set_state(starts[i])
                    results.append(fn(xi, gate_step, gen, *d))
            mean_logs = _mean_of([r[0] for r in results])
            names = sorted(mean_logs)
            grads, stacked = opt.reduce(_mean_of([r[1] for r in results]),
                                        None if self.world is None
                                        else torch.stack([mean_logs[k] for k in names]))
            if stacked is not None:
                mean_logs = dict(zip(names, stacked.clone().unbind()))
            logs.update(mean_logs)
            opt.step(grads)
        self.step += 1
        return logs

    def train_steps(self, xs, generator=None):
        """K full steps over xs with a leading (K,) axis; the logs stacked
        per step."""
        steps = [self.train_step(x, generator) for x in self._images(xs)]
        return {k: torch.stack([s[k] for s in steps]) for k in steps[0]}

    @torch.no_grad()
    def eval_step(self, x):
        x = self._images(x)
        xrec, qloss, grain_indices, gate, _ = self.model(x)
        nll_loss, rec_loss, p_loss = self.loss.nll(x, xrec)
        return {"val_rec_loss": rec_loss, "val_nll_loss": nll_loss, "val_p_loss": p_loss,
                "val_quant_loss": qloss, **grain_ratios(grain_indices, gate, "val")}
