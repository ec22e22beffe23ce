"""PatchGAN discriminator (pix2pix NLayerDiscriminator), NCHW (counterpart of
`dynamicvectorquantization_tpu/nn/discriminator.py`).

4x4 convs with pad 1, stride 2 for the first `n_layers`, BatchNorm and
LeakyReLU(0.2), a final 1-channel map; convs that feed a BatchNorm have no
bias. Module names follow the reference's `main` Sequential
(`main.{0,2,3,5,6,...}`), so `loss.discriminator.*` of a reference checkpoint
loads. `weights_init`: convs normal(0, 0.02) with zero bias, BatchNorm scale
one and bias zero, as the JAX package initialises them.

`train` is an argument of `forward`, as in the JAX package, not the module's
mode: one training step runs the discriminator both ways.

BatchNorm is held to the JAX package (flax `nn.BatchNorm`, momentum 0.9, eps
1e-5): the running variance is updated with the *biased* batch variance,
where `torch.nn.BatchNorm2d` uses the unbiased one (its momentum 0.1 is the
same update). Normalisation itself is identical. `ActNorm`
(`use_actnorm: true`, in no shipped config) is not ported and raises.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class BatchNorm2d(nn.BatchNorm2d):
    """`nn.BatchNorm2d` whose running variance takes the biased batch
    variance (see the module docstring); `forward(x, train)`."""

    def forward(self, x, train: bool = False):
        if not train:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                                False, 0.0, self.eps)
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
            self.running_mean.mul_(1 - self.momentum).add_(mean, alpha=self.momentum)
            self.running_var.mul_(1 - self.momentum).add_(var, alpha=self.momentum)
            self.num_batches_tracked += 1
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)


class NLayerDiscriminator(nn.Module):
    def __init__(self, input_nc=3, ndf=64, n_layers=3, use_actnorm=False):
        super().__init__()
        if use_actnorm:
            raise NotImplementedError("ActNorm is not ported (ROADMAP.md); every shipped "
                                      "config sets use_actnorm: false")
        layers = [nn.Conv2d(input_nc, ndf, 4, 2, 1), nn.LeakyReLU(0.2)]
        nf = 1
        for n in range(1, n_layers + 1):
            nf_prev, nf = nf, min(2 ** n, 8)
            stride = 2 if n < n_layers else 1
            layers += [nn.Conv2d(ndf * nf_prev, ndf * nf, 4, stride, 1, bias=False),
                       BatchNorm2d(ndf * nf, eps=1e-5, momentum=0.1), nn.LeakyReLU(0.2)]
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

    def forward(self, x, train: bool = False):
        """(B, C, H, W) -> (B, 1, h, w) patch logits."""
        for mod in self.main:
            x = mod(x, train) if isinstance(mod, BatchNorm2d) else mod(x)
        return x
