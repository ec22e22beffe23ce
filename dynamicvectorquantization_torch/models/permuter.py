"""Dual-grain code packing and unpacking with static padded shapes
(counterpart of `dynamicvectorquantization_tpu/models/permuter.py`
`DualGrainSeparatePermuter`).

`forward` packs a dense (B, fine_hw, fine_hw) code map and a (B, hw1, hw1)
grain map into six (B, L) streams: the top-left code of each coarse region
(raster order) then EOS, padded; all four codes of each fine region in
`row-first` (raster at the fine resolution) or `region-first` (2x2 blocks per
region) order then EOS, padded; and the positions alike. `forward_back`
scatters the coarse codes onto the coarse grid, upsamples 2x2, then
overwrites with fine codes at fine positions; pad/eos entries (positions past
the grid) land in an overflow slot that is dropped. `pack_masked` is the
static-shape select-append-pad both use.
"""
from __future__ import annotations

import torch


def pack_masked(values, positions, mask, max_len: int, eos_code: int, pad_code: int):
    """Per row: values[mask] in ascending `positions` order, then EOS, then
    pad, to `max_len` (>= N + 1). values/positions/mask: (B, N) -> (B, max_len)."""
    n = values.shape[-1]
    key = torch.where(mask, positions, n + positions)  # selected first, stable
    order = torch.argsort(key, dim=-1, stable=True)
    sel = torch.gather(values, -1, order)
    count = mask.sum(dim=-1, keepdim=True)
    idx = torch.arange(max_len, device=values.device)
    gathered = sel[:, idx.clamp(max=n - 1)]
    return torch.where(idx < count, gathered,
                       torch.where(idx == count, eos_code, pad_code)).long()


class DualGrainSeparatePermuter:
    def __init__(self, coarse_hw=16, fine_hw=32, content_pad_code=1024, content_eos_code=1025,
                 coarse_position_pad_code=256, coarse_position_eos_code=257,
                 fine_position_pad_code=1024, fine_position_eos_code=1025,
                 fine_position_order="region-first", coarse_max_len=None, fine_max_len=None):
        if fine_position_order not in ("row-first", "region-first"):
            raise ValueError(f"unknown fine_position_order {fine_position_order!r}")
        self.hw1 = coarse_hw
        self.hw2 = fine_hw // coarse_hw
        self.fine_hw = fine_hw
        self.hw2_square = self.hw2 * self.hw2
        self.content_pad_code = content_pad_code
        self.content_eos_code = content_eos_code
        self.coarse_position_pad_code = coarse_position_pad_code
        self.coarse_position_eos_code = coarse_position_eos_code
        self.fine_position_pad_code = fine_position_pad_code
        self.fine_position_eos_code = fine_position_eos_code
        self.fine_position_order = fine_position_order
        self.coarse_max_len = coarse_max_len or coarse_hw * coarse_hw + 1
        self.fine_max_len = fine_max_len or fine_hw * fine_hw + 1
        pos_fine = torch.arange(fine_hw * fine_hw).reshape(fine_hw, fine_hw)
        if fine_position_order == "region-first":
            # (h1 h2, w1 w2) -> (h1, w1, h2*w2)
            pos_fine = (pos_fine.reshape(self.hw1, self.hw2, self.hw1, self.hw2)
                        .permute(0, 2, 1, 3).reshape(self.hw1, self.hw1, self.hw2_square))
        self.position_sequence_fine = pos_fine

    def forward(self, indices, grain_indices):
        """indices: (B, fine_hw, fine_hw) codes; grain_indices: (B, hw1, hw1),
        0 coarse (one code per region) / 1 fine (four). Returns a dict of six
        (B, L) int64 streams with static L."""
        hw1, hw2, fine_hw = self.hw1, self.hw2, self.fine_hw
        b = indices.shape[0]
        dev = indices.device
        # (B, hw1, hw1, hw2*hw2) region view; [..., 0] is the coarse code
        region_codes = (indices.reshape(b, hw1, hw2, hw1, hw2).permute(0, 1, 3, 2, 4)
                        .reshape(b, hw1, hw1, self.hw2_square))
        coarse_codes = region_codes[..., 0].reshape(b, hw1 * hw1)
        coarse_mask = (grain_indices == 0).reshape(b, hw1 * hw1)
        order = torch.arange(hw1 * hw1, device=dev).expand(b, -1)
        coarse_content = pack_masked(coarse_codes, order, coarse_mask, self.coarse_max_len,
                                     self.content_eos_code, self.content_pad_code)
        coarse_position = pack_masked(order, order, coarse_mask, self.coarse_max_len,
                                      self.coarse_position_eos_code,
                                      self.coarse_position_pad_code)

        n_fine = fine_hw * fine_hw
        if self.fine_position_order == "region-first":
            fine_codes = region_codes.reshape(b, n_fine)
            fine_positions = self.position_sequence_fine.reshape(1, -1).to(dev).expand(b, -1)
            fine_mask = (grain_indices == 1).reshape(b, hw1 * hw1).repeat_interleave(
                self.hw2_square, dim=-1)
        else:  # row-first: raster order at the fine resolution
            fine_codes = indices.reshape(b, n_fine)
            fine_positions = torch.arange(n_fine, device=dev).expand(b, -1)
            fine_grain = grain_indices.repeat_interleave(hw2, -1).repeat_interleave(hw2, -2)
            fine_mask = (fine_grain == 1).reshape(b, n_fine)
        order_f = torch.arange(n_fine, device=dev).expand(b, -1)
        fine_content = pack_masked(fine_codes, order_f, fine_mask, self.fine_max_len,
                                   self.content_eos_code, self.content_pad_code)
        fine_position = pack_masked(fine_positions, order_f, fine_mask, self.fine_max_len,
                                    self.fine_position_eos_code, self.fine_position_pad_code)
        return {
            "coarse_content": coarse_content,
            "fine_content": fine_content,
            "coarse_position": coarse_position,
            "fine_position": fine_position,
            "coarse_segment": torch.zeros_like(coarse_content),
            "fine_segment": torch.ones_like(fine_content),
        }

    def forward_back(self, coarse_content, fine_content, coarse_position, fine_position):
        """Six padded (B, L) sequences -> dense (B, fine_hw, fine_hw) code map."""
        b = coarse_content.shape[0]
        n_coarse = self.hw1 * self.hw1
        n_fine = self.fine_hw * self.fine_hw
        dev = coarse_content.device
        grid = torch.zeros((b, n_coarse + 1), dtype=torch.long, device=dev)
        tgt_c = torch.where(coarse_position < n_coarse, coarse_position, n_coarse).long()
        grid.scatter_(1, tgt_c, coarse_content.long())
        up = grid[:, :n_coarse].reshape(b, self.hw1, self.hw1)
        up = up.repeat_interleave(self.hw2, 1).repeat_interleave(self.hw2, 2)
        flat = torch.cat([up.reshape(b, n_fine),
                          torch.zeros((b, 1), dtype=torch.long, device=dev)], dim=1)
        tgt_f = torch.where(fine_position < n_fine, fine_position, n_fine).long()
        flat.scatter_(1, tgt_f, fine_content.long())
        return flat[:, :n_fine].reshape(b, self.fine_hw, self.fine_hw)
