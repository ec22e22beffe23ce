"""PatchGAN discriminator (pix2pix NLayerDiscriminator), NCHW (counterpart of
`dynamicvectorquantization_tpu/nn/discriminator.py`).

4x4 convs with pad 1, stride 2 for the first `n_layers`, BatchNorm (or
ActNorm) and LeakyReLU(0.2), a final 1-channel map; convs that feed a
BatchNorm have no bias, convs that feed an ActNorm have one. Module names
follow the reference's `main` Sequential (`main.{0,2,3,5,6,...}`), so
`loss.discriminator.*` of a reference checkpoint loads. `weights_init`:
convs normal(0, 0.02) with zero bias, BatchNorm scale one and bias zero, as
the JAX package initialises them.

`train` is an argument of `forward`, as in the JAX package, not the module's
mode: one training step runs the discriminator both ways.

BatchNorm is held to the JAX package (flax `nn.BatchNorm`, momentum 0.9, eps
1e-5): the running variance is updated with the *biased* batch variance,
where `torch.nn.BatchNorm2d` uses the unbiased one (its momentum 0.1 is the
same update). Normalisation itself is identical. Inside a
`parallel.dist.global_stats` scope the training statistics are the global
batch's (every rank's rows: mean and biased variance by two sums over the
ranks, with their gradients), for the normalisation and the running
statistics alike, as flax's BatchNorm sees the global batch under GSPMD.

`ActNorm` (`use_actnorm: true`, in no shipped config) is the JAX module's
per-channel affine (x + loc) * scale with its `reverse` and `logdet` paths.
Its `loc` / `scale` are set from data by `NLayerDiscriminator.init_actnorm`
(each layer from its own input on one pass, as flax's init sets them), which
the stage-1 trainer's `init_state` runs; afterwards they are ordinary
parameters. They keep the reference's (1, C, 1, 1) shapes and its
`initialized` buffer, which the state dict carries, so a resumed run needs
no data.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.dist import active, global_sum


class BatchNorm2d(nn.BatchNorm2d):
    """`nn.BatchNorm2d` whose running variance takes the biased batch
    variance (see the module docstring); `forward(x, train)`."""

    def forward(self, x, train: bool = False):
        if not train:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                                False, 0.0, self.eps)
        world = active()
        if world is not None:
            return self._global_batch(x, world)
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
            self.running_mean.mul_(1 - self.momentum).add_(mean, alpha=self.momentum)
            self.running_var.mul_(1 - self.momentum).add_(var, alpha=self.momentum)
            self.num_batches_tracked += 1
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)

    def _global_batch(self, x, world):
        """Training BatchNorm over every rank's rows (two-pass statistics)."""
        n = x.shape[0] * x.shape[2] * x.shape[3] * world.size
        mean = global_sum(x.sum(dim=(0, 2, 3))) / n
        xc = x - mean[None, :, None, None]
        var = global_sum((xc * xc).sum(dim=(0, 2, 3))) / n
        with torch.no_grad():
            self.running_mean.mul_(1 - self.momentum).add_(mean, alpha=self.momentum)
            self.running_var.mul_(1 - self.momentum).add_(var, alpha=self.momentum)
            self.num_batches_tracked += 1
        scale = torch.rsqrt(var + self.eps) * self.weight
        return xc * scale[None, :, None, None] + self.bias[None, :, None, None]


class ActNorm(nn.Module):
    """y = (x + loc) * scale per channel (see the module docstring)."""

    def __init__(self, num_features: int, logdet: bool = False):
        super().__init__()
        self.logdet = logdet
        self.loc = nn.Parameter(torch.zeros(1, num_features, 1, 1))
        self.scale = nn.Parameter(torch.ones(1, num_features, 1, 1))
        self.register_buffer("initialized", torch.tensor(0, dtype=torch.uint8))

    @torch.no_grad()
    def initialize(self, x):
        """loc = -mean, scale = 1 / (std + 1e-6) of x's channels (the
        Bessel-corrected std, as torch's `.std()` and the JAX module take it);
        inside a `global_stats` scope of every rank's rows of x."""
        flat = x.transpose(0, 1).reshape(x.shape[1], -1)
        world = active()
        if world is None:
            mean = flat.mean(dim=1)
            std = flat.std(dim=1, unbiased=flat.shape[1] > 1)
        else:
            n = flat.shape[1] * world.size
            mean = world.sum_(flat.sum(dim=1)) / n
            ss = world.sum_(((flat - mean[:, None]) ** 2).sum(dim=1))
            std = (ss / max(n - 1, 1)).sqrt()
        self.loc.copy_(-mean.view_as(self.loc))
        self.scale.copy_((1.0 / (std + 1e-6)).view_as(self.scale))
        self.initialized.fill_(1)

    def forward(self, x, reverse: bool = False):
        if reverse:
            return x / self.scale - self.loc
        h = (x + self.loc) * self.scale
        if self.logdet:
            log_abs = torch.log(self.scale.abs()).sum()
            return h, x.shape[2] * x.shape[3] * log_abs * x.new_ones(x.shape[0])
        return h


class NLayerDiscriminator(nn.Module):
    def __init__(self, input_nc=3, ndf=64, n_layers=3, use_actnorm=False):
        super().__init__()
        self.use_actnorm = use_actnorm
        layers = [nn.Conv2d(input_nc, ndf, 4, 2, 1), nn.LeakyReLU(0.2)]
        nf = 1
        for n in range(1, n_layers + 1):
            nf_prev, nf = nf, min(2 ** n, 8)
            stride = 2 if n < n_layers else 1
            norm = (ActNorm(ndf * nf) if use_actnorm
                    else BatchNorm2d(ndf * nf, eps=1e-5, momentum=0.1))
            layers += [nn.Conv2d(ndf * nf_prev, ndf * nf, 4, stride, 1, bias=use_actnorm),
                       norm, nn.LeakyReLU(0.2)]
        layers.append(nn.Conv2d(ndf * nf, 1, 4, 1, 1))
        self.main = nn.Sequential(*layers)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        for mod in self.main:
            if isinstance(mod, nn.Conv2d):
                mod.weight.normal_(0.0, 0.02, generator=generator)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, BatchNorm2d):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
                mod.running_mean.zero_()
                mod.running_var.fill_(1.0)
            elif isinstance(mod, ActNorm):
                mod.initialized.zero_()

    def actnorm_initialized(self) -> bool:
        return all(bool(m.initialized) for m in self.main if isinstance(m, ActNorm))

    @torch.no_grad()
    def init_actnorm(self, x):
        """Set every ActNorm from its input on one forward of x (B, C, H, W)."""
        for mod in self.main:
            if isinstance(mod, ActNorm):
                mod.initialize(x)
            x = mod(x, False) if isinstance(mod, BatchNorm2d) else mod(x)

    def forward(self, x, train: bool = False):
        """(B, C, H, W) -> (B, 1, h, w) patch logits."""
        for mod in self.main:
            x = mod(x, train) if isinstance(mod, BatchNorm2d) else mod(x)
        return x
