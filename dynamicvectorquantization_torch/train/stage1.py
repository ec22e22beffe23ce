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

Not ported (each raises where reached): `remat=True`, the Gumbel router gate
(`update_router`), `disc_conditional`, ActNorm. The epoch loop, checkpoints
and data loading live in `train/loop.py`.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.fused_adamw import adamw_scalars
from ..utils.device import resolve_device
from .schedules import make_schedule

B1, B2, EPS = 0.5, 0.9, 1e-8


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
    """Adam(0.5, 0.9) state over named parameters."""

    def __init__(self, params: dict, schedule):
        self.params = params
        self.schedule = schedule
        self.m = {k: torch.zeros_like(p) for k, p in params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in params.items()}
        self.count = 0

    def reset(self):
        for k in self.params:
            self.m[k].zero_()
            self.v[k].zero_()
        self.count = 0

    def state_dict(self):
        return {"count": self.count, "m": dict(self.m), "v": dict(self.v)}

    def load(self, count, m, v):
        if set(m) != set(self.params) or set(v) != set(self.params):
            raise KeyError("optimizer state does not match the parameters")
        for k in self.params:
            self.m[k].copy_(m[k])
            self.v[k].copy_(v[k])
        self.count = int(count)

    def step(self, grads):
        lr, c1, c2 = adamw_scalars(self.count, self.schedule, B1, B2)
        names = list(self.params)
        adam_update([self.params[k].data for k in names], [grads[k] for k in names],
                    [self.m[k] for k in names], [self.v[k] for k in names], lr, c1, c2)
        self.count += 1


def _mean_of(dicts):
    """Per-key mean of a list of dicts of tensors."""
    if len(dicts) == 1:
        return dicts[0]
    inv = 1.0 / len(dicts)
    return {k: sum(d[k] for d in dicts) * inv for k in dicts[0]}


class Stage1Trainer:
    def __init__(self, model, learning_rate, min_learning_rate=0.0, warmup_steps=0,
                 max_steps=1_000_000, scheduler_type=None, remat=False, accum=1, device=None,
                 seed=0):
        if remat:
            raise NotImplementedError(
                "remat (activation checkpointing around a forward that updates the EMA "
                "buffers) is not ported (ROADMAP.md)")
        if model.loss is None or not hasattr(model.loss, "discriminator"):
            raise ValueError("Stage1Trainer needs a model built with a GAN lossconfig")
        self.device = resolve_device(device)
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
        self.ae_opt = _Adam(self.ae_params, schedule())
        self.disc_opt = _Adam(self.disc_params, schedule())
        self.step = 0
        self.epoch = 0
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(int(seed))

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
        self.generator.set_state(state["generator"].cpu())

    def init_state(self, generator: torch.Generator = None):
        """A fresh training state: with a generator, seeded random weights
        (`model.init_weights`: the LPIPS backbone random, its lin heads the
        bundled ones); in any case zero moments, step 0, epoch 0. Without a
        generator the model keeps the weights it was given."""
        if generator is not None:
            self.model.init_weights(generator)
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
        d_weight = (g_nll.norm() / (g_g.norm() + 1e-4)).clamp(0.0, 1e4) * self.loss.disc_weight
        if self.loss.disc_weight_max is not None:
            d_weight = d_weight.clamp(max=self.loss.disc_weight_max)
        return d_weight.detach()

    def _ae_grads(self, x, gate_step, generator):
        """(logs, gradients of the autoencoder total by parameter name) of one
        microbatch; updates the EMA buffers and the BatchNorm statistics."""
        loss = self.loss
        (xrec, pre_out), qloss, grain_indices, gate, _ = self.model(
            x, train=True, return_pre_out=True, generator=generator)
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
        logs = {"train_fine_ratio": (grain_indices > 0).float().mean(),
                "train_aeloss": total, "train_rec_loss": rec_loss, "train_nll_loss": nll_loss,
                "train_p_loss": p_loss, "train_quant_loss": qloss, "train_g_loss": g_loss,
                "train_d_weight": d_weight, "train_disc_factor": x.new_tensor(disc_factor),
                "train_budget_loss": budget}
        return {k: v.detach().float() for k, v in logs.items()}, grads

    def _disc_grads(self, x, gate_step, generator):
        """(logs, discriminator gradients) of one microbatch, on a fresh
        training forward of the updated autoencoder that leaves the EMA
        buffers alone."""
        with torch.no_grad():
            xrec = self.model(x, train=True, generator=generator, commit=False)[0]
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
        once. `generator` draws the codebook's restart candidates (the
        trainer's own when none is passed). Returns the logs."""
        if generator is None:
            generator = self.generator
        micro = self._microbatches(self._images(x))
        gate_step = self.epoch if self.loss_with_epoch else self.step
        logs = {}
        for opt, fn in ((self.ae_opt, self._ae_grads), (self.disc_opt, self._disc_grads)):
            results = [fn(xi, gate_step, generator) for xi in micro]
            logs.update(_mean_of([r[0] for r in results]))
            opt.step(_mean_of([r[1] for r in results]))
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
        xrec, qloss, grain_indices, _, _ = self.model(x)
        nll_loss, rec_loss, p_loss = self.loss.nll(x, xrec)
        return {"val_rec_loss": rec_loss, "val_nll_loss": nll_loss, "val_p_loss": p_loss,
                "val_quant_loss": qloss, "val_fine_ratio": (grain_indices > 0).float().mean()}
