"""Dual-grain encoder, NCHW (counterpart of
`dynamicvectorquantization_tpu/nn/encoder_dual.py` `DualGrainEncoder`).

A shared conv-ResNet down-stack (`down_stack`, the JAX package's
`DownStack`) taps the fine features after the blocks of level
`len(ch_mult) - 2`, before its downsample, and the coarse features at the
last level; each goes through its own mid Res-Attn-Res, GroupNorm, swish and
3x3 out conv (`grain_features`, the JAX package's `GrainHead`s). The router's gate
picks a grain per coarse cell (`indices = argmax(gate)`, 0 coarse / 1 fine);
the coarse features are repeated 2x2 and merged with the fine ones at the
fine resolution, and the commitment weight is 0.25 on coarse and 1.0 on fine
positions.

Reference state_dict names: `conv_in`, `down.{i}.{block|attn}.{j}`,
`down.{i}.downsample.conv`, `mid_{coarse|fine}.{block_1,attn_1,block_2}`,
`norm_out_{coarse|fine}`, `conv_out_{coarse|fine}`, `router.*`.

`dtype` (None, or bf16 for the DQ-VAE's compute dtype) goes to every conv,
norm, ResnetBlock, AttnBlock and Downsample of the stack and of both grain
heads, `conv_out` included; the router has none (see `nn/blocks.py` for the
dtype rules).

Differentiable end to end. `train=True` with `update_router` (the shipped
feature-router config) gates through the straight-through Gumbel softmax
(`gumbel_softmax_st`, QUIRKS #7): the hard one-hot of softmax(gate + g)
forward, the soft gradient backward, and the merged map scaled by the gate's
max so the router receives gradients. The noise g is `gumbel_noise` where
the caller gives it (the stage-1 trainer draws it once per microbatch and
feeds the same tensor to its autoencoder and discriminator passes, as the
JAX trainer reuses one key), else drawn here from `generator` on the
images' device. It follows torch's generator, not JAX's PRNG. ResnetBlock
dropout in training takes the caller's `dropout` masks (`nn/blocks.py`
`DropoutMasks`), else masks drawn from `generator`. `remat` makes each
ResnetBlock and AttnBlock of the stack and the heads one checkpointed
segment (`nn/blocks.py` `segment`); the Downsamples, whose kernel keeps only
its input (the segment before it keeps that already), and the router run
once.

`GrainEncoder` holds what the dual- and triple-grain encoders share: the
down-stack, the grain heads and the gate; `nn/encoder_triple.py` builds the
triple one from it.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.instantiate import instantiate_from_config
from .blocks import (AttnBlock, Conv2d, Downsample, Normalize, ResnetBlock, as_dtype,
                     key_dropout_blocks, nonlinearity, segment, training_masks)


def repeat2d(x, factor: int, h_dim: int, w_dim: int):
    """Nearest-neighbour repeat of the two spatial dims."""
    return x.repeat_interleave(factor, dim=h_dim).repeat_interleave(factor, dim=w_dim)


def draw_gumbel(shape, generator=None, device=None):
    """Standard Gumbel noise -log(-log(u)), u uniform in [tiny, 1), in f32, as
    `jax.random.gumbel` draws it."""
    u = torch.rand(shape, generator=generator, device=device, dtype=torch.float32)
    return -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))


def gumbel_softmax_st(logits, noise, tau: float = 1.0):
    """Straight-through hard Gumbel softmax over the last dim: the one-hot of
    the argmax forward, softmax((logits + noise) / tau)'s gradient backward."""
    y_soft = torch.softmax((logits + noise) / tau, dim=-1)
    y_hard = F.one_hot(y_soft.argmax(dim=-1), logits.shape[-1]).to(logits.dtype)
    return y_hard + y_soft - y_soft.detach()


def _mid(block_in: int, dropout: float, dtype=None) -> nn.Module:
    mid = nn.Module()
    mid.block_1 = ResnetBlock(block_in, dropout=dropout, compute_dtype=dtype)
    mid.attn_1 = AttnBlock(block_in, compute_dtype=dtype)
    mid.block_2 = ResnetBlock(block_in, dropout=dropout, compute_dtype=dtype)
    return mid


class GrainEncoder(nn.Module):
    """The shared down-stack (`conv_in`, `down.{i}`), one head per grain
    (`mid_<grain>`, `norm_out_<grain>`, `conv_out_<grain>`, heads added in
    `grains` order: coarsest first) and the router. The head of grain i
    (0 the coarsest) reads the down-stack's tap at level
    `len(ch_mult) - 1 - i` ("final" for the coarsest)."""

    grains = ()

    def __init__(self, ch, ch_mult, num_res_blocks, attn_resolutions, dropout, resamp_with_conv,
                 in_channels, resolution, z_channels, router_config, dtype=None):
        super().__init__()
        dtype = as_dtype(dtype)
        self.resolution = resolution
        self.dropout = dropout
        self.num_resolutions = len(ch_mult)
        in_ch_mult = (1,) + tuple(ch_mult)
        self.conv_in = Conv2d(in_channels, ch, 3, padding=1, compute_dtype=dtype)
        curr_res = resolution
        levels = []
        for i_level in range(self.num_resolutions):
            level = nn.Module()
            level.block = nn.ModuleList()
            level.attn = nn.ModuleList()
            block_in = ch * in_ch_mult[i_level]
            block_out = ch * ch_mult[i_level]
            for _ in range(num_res_blocks):
                level.block.append(ResnetBlock(block_in, block_out, dropout=dropout,
                                               compute_dtype=dtype))
                block_in = block_out
                if curr_res in attn_resolutions:
                    level.attn.append(AttnBlock(block_in, compute_dtype=dtype))
            if i_level != self.num_resolutions - 1:
                level.downsample = Downsample(block_in, resamp_with_conv, compute_dtype=dtype)
                curr_res //= 2
            levels.append(level)
        self.down = nn.ModuleList(levels)
        for i, grain in enumerate(self.grains):
            block_in = ch * ch_mult[-1 - i]
            setattr(self, f"mid_{grain}", _mid(block_in, dropout, dtype))
            setattr(self, f"norm_out_{grain}", Normalize(block_in, dtype))
            setattr(self, f"conv_out_{grain}",
                    Conv2d(block_in, z_channels, 3, padding=1, compute_dtype=dtype))
        self.router = instantiate_from_config(router_config)
        key_dropout_blocks(self)

    @property
    def coarse_resolution(self) -> int:
        return self.resolution // 2 ** (self.num_resolutions - 1)

    def gumbel_in_training(self) -> bool:
        raise NotImplementedError

    def gumbel_shape(self, batch: int):
        """The shape of the Gumbel noise a training forward of `batch` images
        takes, or None where training does not gate through it."""
        if not self.gumbel_in_training():
            return None
        r = self.coarse_resolution
        return (batch, r, r, len(self.grains))

    def down_stack(self, x, masks=None, remat=False):
        """The shared down-stack: {level: features after its blocks, before
        its downsample} and "final"."""
        h = self.conv_in(x)
        taps = {}
        for i_level, level in enumerate(self.down):
            for i_block, block in enumerate(level.block):
                h = segment(remat, block, h, masks)
                if len(level.attn):
                    h = segment(remat, level.attn[i_block], h)
            taps[i_level] = h
            if hasattr(level, "downsample"):
                h = level.downsample(h)
        taps["final"] = h
        return taps

    def grain_features(self, x, train, masks=None, generator=None, remat=False):
        """{grain: its head's output (B, z, H_g, W_g)}."""
        if x.shape[2] != self.resolution or x.shape[3] != self.resolution:
            raise ValueError(f"{type(self).__name__}: {self.resolution}^2 input expected, "
                             f"got {tuple(x.shape)}")
        masks = training_masks(masks, self.dropout, train, generator)
        taps = self.down_stack(x, masks, remat)
        out = {}
        for i, grain in enumerate(self.grains):
            h = taps["final" if i == 0 else self.num_resolutions - 1 - i]
            mid = getattr(self, f"mid_{grain}")
            h = segment(remat, mid.block_1, h, masks)
            h = segment(remat, mid.attn_1, h)
            h = segment(remat, mid.block_2, h, masks)
            out[grain] = getattr(self, f"conv_out_{grain}")(
                nonlinearity(getattr(self, f"norm_out_{grain}")(h)))
        return out

    def gate(self, feats, x_entropy, train, gumbel_noise, generator):
        """The router's gate (B, Hc, Wc, n), through the Gumbel gate in a
        training forward that takes it; and whether it did."""
        gate = self.router(**{f"h_{g}": feats[g] for g in self.grains}, entropy=x_entropy)
        gumbel = train and self.gumbel_in_training()
        if gumbel:
            if gumbel_noise is None:
                gumbel_noise = draw_gumbel(gate.shape, generator, gate.device)
            gate = gumbel_softmax_st(gate.float(), gumbel_noise)
        return gate, gumbel


class DualGrainEncoder(GrainEncoder):
    grains = ("coarse", "fine")

    def __init__(self, ch=128, ch_mult=(1, 1, 2, 2, 4), num_res_blocks=2,
                 attn_resolutions=(16, 32), dropout=0.0, resamp_with_conv=True, in_channels=3,
                 resolution=256, z_channels=256, router_config=None, update_router=True,
                 coarse_commit_weight=0.25, fine_commit_weight=1.0, dtype=None):
        super().__init__(ch, ch_mult, num_res_blocks, attn_resolutions, dropout,
                         resamp_with_conv, in_channels, resolution, z_channels, router_config,
                         dtype)
        self.update_router = update_router
        self.coarse_commit_weight = coarse_commit_weight
        self.fine_commit_weight = fine_commit_weight

    def gumbel_in_training(self) -> bool:
        return bool(self.update_router)

    def forward(self, x, x_entropy=None, train=False, gumbel_noise=None, generator=None,
                dropout=None, remat=False):
        """x: (B, C, H, W) with H = W = resolution; x_entropy: (B, Hc, Wc) for
        the entropy router; `gumbel_noise` (B, Hc, Wc, 2) f32 or `generator`
        for the Gumbel gate; `dropout` masks (or `generator`) for ResnetBlock
        dropout in training; `remat` checkpoints the blocks. Returns `h_dual`
        (B, z, Hf, Wf), `indices` (B, Hc, Wc), `codebook_mask` (B, Hf, Wf, 1)
        and `gate` (B, Hc, Wc, 2)."""
        feats = self.grain_features(x, train, dropout, generator, remat)
        gate, gumbel = self.gate(feats, x_entropy, train, gumbel_noise, generator)
        indices = torch.argmax(gate, dim=-1)  # (B, Hc, Wc)
        coarse_rep = repeat2d(indices == 0, 2, 1, 2)  # (B, Hf, Wf)
        h_dual = torch.where(coarse_rep[:, None], repeat2d(feats["coarse"], 2, 2, 3),
                             feats["fine"])
        if gumbel:  # the gate's gradient path
            h_dual = h_dual * repeat2d(gate.amax(dim=-1), 2, 1, 2)[:, None]
        codebook_mask = torch.where(coarse_rep, self.coarse_commit_weight,
                                    self.fine_commit_weight).to(h_dual.dtype)[..., None]
        return {"h_dual": h_dual, "indices": indices, "codebook_mask": codebook_mask,
                "gate": gate}
