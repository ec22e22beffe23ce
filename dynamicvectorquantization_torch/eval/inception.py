"""InceptionV3 pool3 features in PyTorch, loading a torchvision `inception_v3`
state_dict (the port's own copy of
`dynamicvectorquantization_tpu/eval/inception_torch.py`).

FID needs InceptionV3's pool3 (2048-d) features. torchvision is not a
dependency of the port, so this module re-implements torchvision's
`inception_v3` topology (BasicConv2d, InceptionA-E, the auxiliary head) with
exactly torchvision's module and parameter names: a torchvision state_dict
(`Inception_V3_Weights.IMAGENET1K_V1`, or the pytorch-fid FID-Inception
weights re-keyed to torchvision names) loads with `load_state_dict`. Kernel
sizes, strides, paddings and widths are part of that contract: a wrong layer
fails the key or shape check, so a real weights file verifies the copy.

The forward is torchvision's, not pytorch-fid's (whose InceptionA/C/E pool
with `count_include_pad=False`, among other differences): FID computed here
is comparable to numbers of this extractor (`eval/fid.py`
`INCEPTION_VARIANT`), not to published pytorch-fid / TF-Inception numbers.

`load_inception` reads the file with `torch.load(weights_only=True)` and
raises on any unexpected key and on any missing one but the optional
BatchNorm `num_batches_tracked` counters. `seeded_state_dict` makes stand-in
weights for checks without the real file: He-normal convolutions, so the
pool3 features still depend on the input after 94 layers (with PyTorch's
default init they shrink to ~1e-7 and every FID comes out 0).
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


class BasicConv2d(nn.Module):
    def __init__(self, in_ch, out_ch, **kwargs):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, bias=False, **kwargs)
        self.bn = nn.BatchNorm2d(out_ch, eps=0.001)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)), inplace=True)


class InceptionA(nn.Module):
    def __init__(self, in_ch, pool_features):
        super().__init__()
        self.branch1x1 = BasicConv2d(in_ch, 64, kernel_size=1)
        self.branch5x5_1 = BasicConv2d(in_ch, 48, kernel_size=1)
        self.branch5x5_2 = BasicConv2d(48, 64, kernel_size=5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(in_ch, 64, kernel_size=1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, kernel_size=3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, kernel_size=3, padding=1)
        self.branch_pool = BasicConv2d(in_ch, pool_features, kernel_size=1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(F.avg_pool2d(x, kernel_size=3, stride=1, padding=1))
        return torch.cat([b1, b5, b3, bp], 1)


class InceptionB(nn.Module):
    def __init__(self, in_ch):
        super().__init__()
        self.branch3x3 = BasicConv2d(in_ch, 384, kernel_size=3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(in_ch, 64, kernel_size=1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, kernel_size=3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, kernel_size=3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3(x)
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = F.max_pool2d(x, kernel_size=3, stride=2)
        return torch.cat([b3, bd, bp], 1)


class InceptionC(nn.Module):
    def __init__(self, in_ch, channels_7x7):
        super().__init__()
        c7 = channels_7x7
        self.branch1x1 = BasicConv2d(in_ch, 192, kernel_size=1)
        self.branch7x7_1 = BasicConv2d(in_ch, c7, kernel_size=1)
        self.branch7x7_2 = BasicConv2d(c7, c7, kernel_size=(1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, kernel_size=(7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(in_ch, c7, kernel_size=1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, kernel_size=(7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, kernel_size=(1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, kernel_size=(7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, kernel_size=(1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(in_ch, 192, kernel_size=1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_5(
            self.branch7x7dbl_4(
                self.branch7x7dbl_3(self.branch7x7dbl_2(self.branch7x7dbl_1(x)))
            )
        )
        bp = self.branch_pool(F.avg_pool2d(x, kernel_size=3, stride=1, padding=1))
        return torch.cat([b1, b7, bd, bp], 1)


class InceptionD(nn.Module):
    def __init__(self, in_ch):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(in_ch, 192, kernel_size=1)
        self.branch3x3_2 = BasicConv2d(192, 320, kernel_size=3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(in_ch, 192, kernel_size=1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, kernel_size=(1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, kernel_size=(7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, kernel_size=3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = self.branch7x7x3_4(
            self.branch7x7x3_3(self.branch7x7x3_2(self.branch7x7x3_1(x)))
        )
        bp = F.max_pool2d(x, kernel_size=3, stride=2)
        return torch.cat([b3, b7, bp], 1)


class InceptionE(nn.Module):
    def __init__(self, in_ch):
        super().__init__()
        self.branch1x1 = BasicConv2d(in_ch, 320, kernel_size=1)
        self.branch3x3_1 = BasicConv2d(in_ch, 384, kernel_size=1)
        self.branch3x3_2a = BasicConv2d(384, 384, kernel_size=(1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, kernel_size=(3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(in_ch, 448, kernel_size=1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, kernel_size=3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, kernel_size=(1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, kernel_size=(3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(in_ch, 192, kernel_size=1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], 1)
        bp = self.branch_pool(F.avg_pool2d(x, kernel_size=3, stride=1, padding=1))
        return torch.cat([b1, b3, bd, bp], 1)


class InceptionAux(nn.Module):
    """Present only so aux-carrying torchvision state_dicts load cleanly."""

    def __init__(self, in_ch, num_classes):
        super().__init__()
        self.conv0 = BasicConv2d(in_ch, 128, kernel_size=1)
        self.conv1 = BasicConv2d(128, 768, kernel_size=5)
        self.fc = nn.Linear(768, num_classes)

    def forward(self, x):
        x = F.avg_pool2d(x, kernel_size=5, stride=3)
        x = self.conv1(self.conv0(x))
        x = F.adaptive_avg_pool2d(x, (1, 1)).flatten(1)
        return self.fc(x)


class InceptionV3(nn.Module):
    """torchvision-`inception_v3`-compatible trunk; `forward` returns pool3
    (2048-d) features — exactly what FID consumes. `fc` exists only for
    state_dict compatibility."""

    def __init__(self, num_classes: int = 1000, aux_logits: bool = True):
        super().__init__()
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, kernel_size=3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, kernel_size=3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, kernel_size=3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, kernel_size=1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, kernel_size=3)
        self.Mixed_5b = InceptionA(192, pool_features=32)
        self.Mixed_5c = InceptionA(256, pool_features=64)
        self.Mixed_5d = InceptionA(288, pool_features=64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, channels_7x7=128)
        self.Mixed_6c = InceptionC(768, channels_7x7=160)
        self.Mixed_6d = InceptionC(768, channels_7x7=160)
        self.Mixed_6e = InceptionC(768, channels_7x7=192)
        self.AuxLogits = InceptionAux(768, num_classes) if aux_logits else None
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280)
        self.Mixed_7c = InceptionE(2048)
        self.fc = nn.Linear(2048, num_classes)

    def forward(self, x):
        x = self.Conv2d_1a_3x3(x)          # 299 -> 149
        x = self.Conv2d_2a_3x3(x)          # -> 147
        x = self.Conv2d_2b_3x3(x)
        x = F.max_pool2d(x, kernel_size=3, stride=2)  # -> 73
        x = self.Conv2d_3b_1x1(x)
        x = self.Conv2d_4a_3x3(x)          # -> 71
        x = F.max_pool2d(x, kernel_size=3, stride=2)  # -> 35
        x = self.Mixed_5b(x)
        x = self.Mixed_5c(x)
        x = self.Mixed_5d(x)
        x = self.Mixed_6a(x)               # -> 17
        x = self.Mixed_6b(x)
        x = self.Mixed_6c(x)
        x = self.Mixed_6d(x)
        x = self.Mixed_6e(x)
        x = self.Mixed_7a(x)               # -> 8
        x = self.Mixed_7b(x)
        x = self.Mixed_7c(x)
        x = F.adaptive_avg_pool2d(x, (1, 1)).flatten(1)  # pool3: (B, 2048)
        return x


def load_inception(weights_path: str, num_classes: int = 1000) -> InceptionV3:
    """The trunk with a torchvision `inception_v3` state_dict (or a
    `{"state_dict": ...}` holding one) loaded, in eval mode, on the CPU."""
    model = InceptionV3(num_classes=num_classes)
    sd = torch.load(weights_path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    missing, unexpected = model.load_state_dict(sd, strict=False)
    if unexpected:
        raise ValueError(
            f"state_dict does not match torchvision inception_v3: unexpected keys "
            f"{unexpected[:5]}{'...' if len(unexpected) > 5 else ''}")
    missing = [k for k in missing if not k.endswith("num_batches_tracked")]
    if missing:
        raise ValueError(
            f"state_dict is missing inception_v3 parameters: "
            f"{missing[:5]}{'...' if len(missing) > 5 else ''}")
    model.eval()
    return model


def seeded_state_dict(seed: int = 0) -> dict:
    """A torchvision-format state_dict of seeded stand-in weights (see the
    module docstring); not a model of anything."""
    generator = torch.Generator().manual_seed(int(seed))
    model = InceptionV3()
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, nn.Conv2d):
                std = (2.0 / mod.weight[0].numel()) ** 0.5
                mod.weight.normal_(0.0, std, generator=generator)
    return model.state_dict()
