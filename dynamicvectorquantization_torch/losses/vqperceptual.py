"""VQ-GAN objective: L1 + LPIPS, a hinge / vanilla / bce GAN term with the
adaptive discriminator weight, the codebook loss and an optional budget loss
(counterpart of `dynamicvectorquantization_tpu/losses/vqperceptual.py`).

The module owns the LPIPS net and the discriminator under the reference's
names (`perceptual_loss`, `discriminator`); the discriminator is optimised
separately. The pieces (`nll`, `g_loss`, `nll_and_g`, `d_loss`, `budget`) are
composed by `train/stage1.py`, which also forms the adaptive weight
|d nll / dW| / (|d g / dW| + 1e-4) for the decoder's last conv kernel W.

Images come in NHWC, the layout of the model's public functions, and are
moved to NCHW for the two conv nets. A conditional discriminator
(`disc_conditional`, its `input_nc` counting the condition's channels) takes
`cond` (B, H, W, c) concatenated after the image's channels in `g_loss`,
`nll_and_g` and `d_loss`, as the JAX module does; the stage-1 trainer, like
the JAX one, passes none.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.lpips import LPIPS
from ..utils.instantiate import instantiate_from_config


def adopt_weight(weight, global_step, threshold=0, value=0.0):
    return value if global_step < threshold else weight


def hinge_d_loss(logits_real, logits_fake):
    return 0.5 * (F.relu(1.0 - logits_real).mean() + F.relu(1.0 + logits_fake).mean())


def hinge_g_loss(logits_fake):
    return -logits_fake.mean()


def vanilla_d_loss(logits_real, logits_fake):
    return 0.5 * (F.softplus(-logits_real).mean() + F.softplus(logits_fake).mean())


def _log(t, eps=1e-10):
    return torch.log(t + eps)


def bce_d_loss(logits_real, logits_fake):
    return (-_log(1 - torch.sigmoid(logits_fake)) - _log(torch.sigmoid(logits_real))).mean()


def bce_g_loss(logits_fake):
    return -_log(torch.sigmoid(logits_fake)).mean()


_D_LOSSES = {"hinge": hinge_d_loss, "vanilla": vanilla_d_loss, "bce": bce_d_loss}
_G_LOSSES = {"hinge": hinge_g_loss, "vanilla": hinge_g_loss, "bce": bce_g_loss}


class DummyLoss:
    """No-op placeholder where stage 2 holds a frozen DQ-VAE."""

    def __init__(self, *args, **kwargs):
        pass


def _nchw(x):
    return x.permute(0, 3, 1, 2).contiguous()


class VQLPIPSWithDiscriminator(nn.Module):
    def __init__(self, disc_start=0, disc_config=None, disc_init=True, codebook_weight=1.0,
                 pixelloss_weight=1.0, disc_factor=1.0, disc_weight=1.0, perceptual_weight=1.0,
                 disc_conditional=False, disc_adaptive_loss=True, disc_loss="hinge",
                 disc_weight_max=None, budget_loss_config=None):
        super().__init__()
        if disc_loss not in _D_LOSSES:
            raise ValueError(f"disc_loss must be one of {sorted(_D_LOSSES)}, got {disc_loss!r}")
        self.disc_conditional = disc_conditional
        self.disc_start = disc_start
        self.codebook_weight = codebook_weight
        self.disc_factor = disc_factor
        self.disc_weight = disc_weight
        self.perceptual_weight = perceptual_weight
        self.disc_adaptive_loss = disc_adaptive_loss
        self.disc_weight_max = disc_weight_max
        self.perceptual_loss = LPIPS()
        self.discriminator = instantiate_from_config(disc_config)
        self.budget_loss = instantiate_from_config(budget_loss_config)
        self._d_loss = _D_LOSSES[disc_loss]
        self._g_loss = _G_LOSSES[disc_loss]

    def nll(self, inputs, reconstructions):
        """L1 + perceptual: (the mean, the same mean again as the JAX package
        logs it, the perceptual mean)."""
        rec = (inputs - reconstructions).abs()
        if self.perceptual_weight > 0:
            p = self.perceptual_loss(_nchw(inputs), _nchw(reconstructions))  # (B, 1, 1, 1)
            rec = rec + self.perceptual_weight * p
            p_mean = p.mean()
        else:
            p_mean = rec.new_zeros(())
        rec_mean = rec.mean()
        return rec_mean, rec_mean, p_mean

    def _logits(self, images, cond, train):
        if cond is not None:
            images = torch.cat([images, cond], dim=-1)
        return self.discriminator(_nchw(images), train=train)

    def g_loss(self, reconstructions, cond=None, train: bool = False):
        return self._g_loss(self._logits(reconstructions, cond, train))

    def nll_and_g(self, inputs, reconstructions, cond=None, train: bool = False):
        """Both targets of the adaptive weight from one reconstruction."""
        return (self.nll(inputs, reconstructions)[0],
                self.g_loss(reconstructions, cond, train=train))

    def d_loss(self, inputs, reconstructions, global_step, cond=None, train: bool = False):
        """The discriminator objective on detached images: real first, then
        fake, which is the order the BatchNorm statistics see."""
        logits_real = self._logits(inputs.detach(), cond, train)
        logits_fake = self._logits(reconstructions.detach(), cond, train)
        factor = adopt_weight(self.disc_factor, global_step, threshold=self.disc_start)
        d = factor * self._d_loss(logits_real, logits_fake)
        return d, {"disc_loss": d, "logits_real": logits_real.mean(),
                   "logits_fake": logits_fake.mean()}

    def budget(self, gate):
        """The budget loss of the gate; 0 without a budget (or a gate: the
        fixed-length models)."""
        if self.budget_loss is None or gate is None:
            return next(self.perceptual_loss.buffers()).new_zeros((), dtype=torch.float32)
        return self.budget_loss(gate)
