"""LPIPS perceptual loss: frozen VGG16 features and learned 1x1 lin heads,
NCHW (counterpart of `dynamicvectorquantization_tpu/nn/lpips.py`).

Each of the five VGG16 relu taps (relu1_2, 2_2, 3_3, 4_3, 5_3) is normalised
over its channels, the squared difference of the two images' taps goes
through a bias-free 1x1 lin head, is averaged over space and summed over the
taps. Inputs lie in [-1, 1] and are shifted and scaled by fixed constants.

Weights: the lin heads ship with this package (`assets/lpips/vgg_lin.npz`,
HWIO, converted to OIHW at load). The pretrained torchvision VGG16 backbone
is not in the repository: `load_weights` reads it (and, if wanted, other lin
heads) from a file the user gives, which `Stage1Trainer.init_state` takes as
`lpips_vgg_path` / `lpips_lin_path` or from `DQVQ_LPIPS_VGG` /
`DQVQ_LPIPS_LIN`, as the JAX trainer does. Without it the backbone holds
seeded random features, as in the JAX package: a usable training gradient,
not the published metric. Module names follow the reference's LPIPS
(`net.slice{1..5}.{torchvision feature index}`, `lin{i}.model.1`,
`scaling_layer.{shift,scale}`), so a reference checkpoint's
`loss.perceptual_loss.*` entries load. The module is frozen: no optimizer
sees it, but gradients flow through it to the reconstruction.
"""
from __future__ import annotations

import os

import numpy as np
import torch
from torch import nn

from .init import flax_default_

# VGG16 feature config up to relu5_3; "M" = 2x2 maxpool
VGG16_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M", 512, 512, 512)
TAP_CHANNELS = (64, 128, 256, 512, 512)
LIN_HEADS_PATH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                              "assets", "lpips", "vgg_lin.npz")


class VGG16Features(nn.Module):
    """The five slices of torchvision's `vgg16().features` up to relu5_3;
    conv `i` of the JAX package's `conv_0..conv_12` is `convs()[i]`."""

    def __init__(self):
        super().__init__()
        slices, current, in_ch, index = [], nn.Sequential(), 3, 0
        for v in VGG16_CFG:
            if v == "M":  # a pool opens the next slice
                slices.append(current)
                current = nn.Sequential()
                current.add_module(str(index), nn.MaxPool2d(2, 2))
                index += 1
            else:
                current.add_module(str(index), nn.Conv2d(in_ch, v, 3, padding=1))
                current.add_module(str(index + 1), nn.ReLU())
                in_ch = v
                index += 2
        slices.append(current)
        for i, s in enumerate(slices):
            self.add_module(f"slice{i + 1}", s)

    def convs(self):
        return [m for m in self.modules() if isinstance(m, nn.Conv2d)]

    def forward(self, x):
        taps = []
        for s in self.children():
            x = s(x)
            taps.append(x)
        return taps


class _ScalingLayer(nn.Module):
    def __init__(self):
        super().__init__()
        self.register_buffer("shift", torch.tensor([-0.030, -0.088, -0.188]).view(1, 3, 1, 1))
        self.register_buffer("scale", torch.tensor([0.458, 0.448, 0.450]).view(1, 3, 1, 1))

    def forward(self, x):
        return (x - self.shift) / self.scale


class _LinHead(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        # the reference's Dropout at index 0 is inert at evaluation, where LPIPS always runs
        self.model = nn.Sequential(nn.Identity(), nn.Conv2d(channels, 1, 1, bias=False))

    def forward(self, x):
        return self.model(x)


def _normalize_tensor(x, eps=1e-10):
    return x / (x.pow(2).sum(dim=1, keepdim=True).sqrt() + eps)


class LPIPS(nn.Module):
    def __init__(self, use_dropout: bool = True):
        super().__init__()
        self.scaling_layer = _ScalingLayer()
        self.net = VGG16Features()
        for i, c in enumerate(TAP_CHANNELS):
            self.add_module(f"lin{i}", _LinHead(c))
        self.requires_grad_(False)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator, vgg_path=None, lin_path=None):
        """Seeded random backbone, each conv as the JAX package's flax
        `nn.Conv` draws it (`nn/init.py` `flax_default_`: lecun-normal kernel,
        zero bias), and the bundled lin heads; then, where given, the
        backbone and the lin heads read from files (`load_weights`)."""
        for conv in self.net.convs():
            flax_default_(conv, generator)
        self.load_state_dict(load_bundled_lin_heads(), strict=False)
        self.load_weights(vgg_path, lin_path)

    @torch.no_grad()
    def load_weights(self, vgg_path=None, lin_path=None):
        """The VGG16 backbone from a torchvision `vgg16` state dict file
        (`features.{i}.weight` / `.bias`; the classifier is ignored) and the
        lin heads from the reference's LPIPS file (`lin{i}.model.1.weight`).
        Either may be None; every tensor the module takes must be in a given
        file."""
        from ..utils.model_loading import load_torch_state_dict

        if vgg_path:
            sd = load_torch_state_dict(vgg_path)
            picked = {}
            for slice_name, sl in self.net.named_children():
                for idx, mod in sl.named_children():
                    if isinstance(mod, nn.Conv2d):
                        for leaf in ("weight", "bias"):
                            picked[f"net.{slice_name}.{idx}.{leaf}"] = sd.get(
                                f"features.{idx}.{leaf}")
            missing = sorted(k for k, v in picked.items() if v is None)
            if missing:
                raise KeyError(f"{vgg_path!r} is not a torchvision vgg16 state dict: it lacks "
                               f"{len(missing)} conv tensors, e.g. {missing[:3]}")
            self.load_state_dict(picked, strict=False)
        if lin_path:
            sd = load_torch_state_dict(lin_path)
            want = [f"lin{i}.model.1.weight" for i in range(len(TAP_CHANNELS))]
            missing = [k for k in want if k not in sd]
            if missing:
                raise KeyError(f"{lin_path!r} lacks the LPIPS lin heads {missing}")
            self.load_state_dict({k: sd[k] for k in want}, strict=False)

    def forward(self, input, target):
        """(B, 3, H, W) images in [-1, 1] -> (B, 1, 1, 1)."""
        taps0 = self.net(self.scaling_layer(input))
        taps1 = self.net(self.scaling_layer(target))
        val = 0.0
        for i, (f0, f1) in enumerate(zip(taps0, taps1)):
            d = (_normalize_tensor(f0) - _normalize_tensor(f1)) ** 2
            val = val + getattr(self, f"lin{i}")(d).mean(dim=(2, 3), keepdim=True)
        return val


def load_bundled_lin_heads() -> dict:
    """The reference's learned lin-head weights (5 tensors, 1472 floats) as
    `{"lin{i}.model.1.weight": (1, C, 1, 1) tensor}`."""
    data = np.load(LIN_HEADS_PATH)
    return {f"{k}.model.1.weight": torch.from_numpy(np.transpose(data[k], (3, 2, 0, 1)).copy())
            for k in data.files}
