"""StyleGAN-family discriminators, NCHW (counterpart of
`dynamicvectorquantization_tpu/nn/stylegan_discriminator.py`): the legacy
alternatives to the PatchGAN, selected by the GAN loss's `disc_config`.

* `StyleGAN2Discriminator` (reference `modules/discriminator/stylegan.py`):
  residual down-blocks (1x1 strided skip; two 3x3 convs; blur and a strided
  3x3 down; the sum over sqrt(2)), optional linear-attention + conv
  feed-forward stages after chosen blocks, a final 3x3 conv and a linear
  head over the 2x2 tail, flattened (c, h, w) as torch does.
* `LucidrainsDiscriminator` (reference
  `modules/discriminator/stylegan_lucidrains.py`): a cross-embedding stem
  (parallel 3 / 7 / 15 convs), strided 4x4 stages with LeakyReLU(0.1),
  GroupNorm and a ResnetBlock, a 1x1 then 4x4 VALID logit head (patch
  logits (B, 1, h, w)).

Reference state_dict names (`blocks.{i}.{conv_res,net.{0,2},downsample.{0.f,1}}`,
`attn_blocks.{i}.{0,1}.fn.{norm,fn}.*`, `final_conv`, `to_logit`;
`layers.0.0.convs.{j}`, `layers.{i}.{0,2,3.block.{groupnorm,project}}`,
`to_logits.{0,2}`), the ones the JAX package's `utils/torch_ckpt.py`
converters read. Neither has batch statistics: `train` changes nothing,
and `use_actnorm` is False. `init_weights` draws every conv and linear as
flax's defaults (lecun-normal, zero bias) and sets the norms to the
identity, as the JAX modules initialise.

The defaults of `LucidrainsDiscriminator` (dim 256, 6 layers) reach 8,192
channels at 4x4: its last stage's 4x4 conv and 3x3 project hold 0.54 G and
0.60 G parameters.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .activations import gelu
from .init import flax_default_


class _FlaxInit:
    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        for mod in self.modules():
            if isinstance(mod, (nn.Conv2d, nn.Linear)):
                flax_default_(mod, generator)
            elif isinstance(mod, nn.GroupNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
            elif isinstance(mod, ChanNorm):
                mod.g.fill_(1.0)
                mod.b.zero_()


def blur_3x3(x, f=None):
    """kornia's `filter2d` with the normalised outer product of `f` ([1, 2,
    1]): reflect pad 1, depthwise."""
    f = torch.tensor([1.0, 2.0, 1.0], device=x.device) if f is None else f
    k = f[:, None] * f[None, :]
    k = (k / k.sum()).to(x.dtype)
    c = x.shape[1]
    return F.conv2d(F.pad(x, (1, 1, 1, 1), mode="reflect"), k.expand(c, 1, 3, 3), groups=c)


class Blur(nn.Module):
    """`blur_3x3` with the reference's filter buffer `f`."""

    def __init__(self):
        super().__init__()
        self.register_buffer("f", torch.tensor([1.0, 2.0, 1.0]))

    def forward(self, x):
        return blur_3x3(x, self.f)


class ChanNorm(nn.Module):
    """Per-pixel channel norm, biased variance; `g`, `b` of shape (1, C, 1, 1)."""

    def __init__(self, dim, eps=1e-5):
        super().__init__()
        self.eps = eps
        self.g = nn.Parameter(torch.ones(1, dim, 1, 1))
        self.b = nn.Parameter(torch.zeros(1, dim, 1, 1))

    def forward(self, x):
        var, mean = torch.var_mean(x, dim=1, unbiased=False, keepdim=True)
        return (x - mean) / torch.sqrt(var + self.eps) * self.g + self.b


class _DepthWiseConv(nn.Module):
    def __init__(self, dim_in, dim_out):
        super().__init__()
        self.net = nn.Sequential(nn.Conv2d(dim_in, dim_in, 3, padding=1, groups=dim_in,
                                           bias=False),
                                 nn.Conv2d(dim_in, dim_out, 1, bias=False))

    def forward(self, x):
        return self.net(x)


class LinearAttention(nn.Module):
    """Softmax-kernel linear attention over the map: 1x1 q, depthwise-3x3 +
    1x1 kv, a d x e context per head, exact GELU, 1x1 out."""

    def __init__(self, dim, dim_head=64, heads=8):
        super().__init__()
        self.dim_head, self.heads = dim_head, heads
        inner = dim_head * heads
        self.to_q = nn.Conv2d(dim, inner, 1, bias=False)
        self.to_kv = _DepthWiseConv(dim, inner * 2)
        self.to_out = nn.Conv2d(inner, dim, 1)

    def forward(self, x):
        b, _, hh, ww = x.shape
        q = self.to_q(x)
        k, v = self.to_kv(x).chunk(2, dim=1)

        def heads_first(t):  # (b, heads*d, h, w) -> (b, heads, n, d)
            return t.reshape(b, self.heads, self.dim_head, hh * ww).transpose(2, 3)

        q, k, v = map(heads_first, (q, k, v))
        q = q.softmax(dim=-1) * self.dim_head ** -0.5
        k = k.softmax(dim=-2)
        context = torch.einsum("bhnd,bhne->bhde", k, v)
        out = torch.einsum("bhnd,bhde->bhne", q, context)
        out = out.transpose(2, 3).reshape(b, self.heads * self.dim_head, hh, ww)
        return self.to_out(gelu(out))


class _Residual(nn.Module):
    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, x):
        return x + self.fn(x)


class _PreNorm(nn.Module):
    def __init__(self, dim, fn):
        super().__init__()
        self.norm = ChanNorm(dim)
        self.fn = fn

    def forward(self, x):
        return self.fn(self.norm(x))


def attn_and_ff(dim):
    """Residual(PreNorm(attention)) then Residual(PreNorm(1x1 -> 2x ->
    LeakyReLU(0.2) -> 1x1))."""
    ff = nn.Sequential(nn.Conv2d(dim, dim * 2, 1), nn.LeakyReLU(0.2), nn.Conv2d(dim * 2, dim, 1))
    return nn.Sequential(_Residual(_PreNorm(dim, LinearAttention(dim))),
                         _Residual(_PreNorm(dim, ff)))


class DiscriminatorBlock(nn.Module):
    def __init__(self, input_channels, filters, downsample=True):
        super().__init__()
        self.conv_res = nn.Conv2d(input_channels, filters, 1, stride=2 if downsample else 1)
        self.net = nn.Sequential(nn.Conv2d(input_channels, filters, 3, padding=1),
                                 nn.LeakyReLU(0.2),
                                 nn.Conv2d(filters, filters, 3, padding=1), nn.LeakyReLU(0.2))
        self.downsample = (nn.Sequential(Blur(), nn.Conv2d(filters, filters, 3, padding=1,
                                                           stride=2))
                           if downsample else None)

    def forward(self, x):
        res = self.conv_res(x)
        x = self.net(x)
        if self.downsample is not None:
            x = self.downsample(x)
        return (x + res) * (1.0 / math.sqrt(2.0))


class StyleGAN2Discriminator(_FlaxInit, nn.Module):
    use_actnorm = False

    def __init__(self, image_size=256, network_capacity=16, attn_layers=(), transparent=False,
                 fmap_max=512):
        super().__init__()
        num_layers = int(math.log2(image_size) - 1)
        filters = [4 if transparent else 3] + [min(network_capacity * 4 * 2 ** i, fmap_max)
                                                for i in range(num_layers + 1)]
        pairs = list(zip(filters[:-1], filters[1:]))
        self.blocks = nn.ModuleList(DiscriminatorBlock(a, b, downsample=i != len(pairs) - 1)
                                    for i, (a, b) in enumerate(pairs))
        self.attn_blocks = nn.ModuleList(attn_and_ff(b) if i + 1 in tuple(attn_layers) else None
                                         for i, (_, b) in enumerate(pairs))
        self.final_conv = nn.Conv2d(filters[-1], filters[-1], 3, padding=1)
        self.to_logit = nn.Linear(2 * 2 * filters[-1], 1)

    def forward(self, x, train: bool = False):
        """(B, C, H, W) -> (B,) logits."""
        for block, attn in zip(self.blocks, self.attn_blocks):
            x = block(x)
            if attn is not None:
                x = attn(x)
        x = self.final_conv(x)
        return self.to_logit(x.flatten(1)).squeeze(-1)


class CrossEmbedLayer(nn.Module):
    """Parallel odd-kernel convs whose widths halve per scale, concatenated."""

    def __init__(self, dim_in, dim_out, kernel_sizes=(3, 7, 15), stride=1):
        super().__init__()
        ks = sorted(kernel_sizes)
        scales = [dim_out // 2 ** i for i in range(1, len(ks))]
        scales = scales + [dim_out - sum(scales)]
        self.convs = nn.ModuleList(nn.Conv2d(dim_in, d, k, stride=stride,
                                             padding=(k - stride) // 2)
                                   for k, d in zip(ks, scales))

    def forward(self, x):
        return torch.cat([conv(x) for conv in self.convs], dim=1)


class _Block(nn.Module):
    def __init__(self, dim, dim_out, groups=8):
        super().__init__()
        self.groupnorm = nn.GroupNorm(groups, dim, eps=1e-5)
        self.activation = nn.LeakyReLU(0.1)
        self.project = nn.Conv2d(dim, dim_out, 3, padding=1)

    def forward(self, x):
        return self.project(self.activation(self.groupnorm(x)))


class _ResnetBlock(nn.Module):
    def __init__(self, dim, groups=8):
        super().__init__()
        self.block = _Block(dim, dim, groups)

    def forward(self, x):
        return x + self.block(x)


class LucidrainsDiscriminator(_FlaxInit, nn.Module):
    use_actnorm = False

    def __init__(self, dim=256, discr_layers=6, channels=3, groups=8,
                 cross_embed_kernel_sizes=(3, 7, 15)):
        super().__init__()
        dims = [dim] + [dim * 2 ** t for t in range(discr_layers)]
        layers = [nn.Sequential(CrossEmbedLayer(channels, dim, cross_embed_kernel_sizes),
                                nn.LeakyReLU(0.1))]
        for d_in, d_out in zip(dims[:-1], dims[1:]):
            layers.append(nn.Sequential(nn.Conv2d(d_in, d_out, 4, stride=2, padding=1),
                                        nn.LeakyReLU(0.1), nn.GroupNorm(groups, d_out, eps=1e-5),
                                        _ResnetBlock(d_out, groups)))
        self.layers = nn.ModuleList(layers)
        self.to_logits = nn.Sequential(nn.Conv2d(dims[-1], dims[-1], 1), nn.LeakyReLU(0.1),
                                       nn.Conv2d(dims[-1], 1, 4))

    def forward(self, x, train: bool = False):
        """(B, C, H, W) -> (B, 1, h, w) patch logits."""
        for layer in self.layers:
            x = layer(x)
        return self.to_logits(x)
