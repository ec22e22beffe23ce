"""Budget-constraint loss steering a learned router's fine-grain ratio
(counterpart of `dynamicvectorquantization_tpu/models/budget.py`).

The dual-grain loss takes the expected code count from the gate (1 per
coarse cell, 4 per fine cell), normalises it to a ratio and penalises its
squared distance to the target.

Reference quirk (QUIRKS #1): with `calculate_all=True` the reference returns
`loss_budget_last + loss_budget_last`, dropping the direct-ratio term.
Replicated by default; `fix_reference_bug=True` gives `loss_budget +
loss_budget_last`.

The triple-grain loss penalises two ratios separately: the median one (4
codes a median cell, 1 otherwise, over the median grid's budget) and the
fine one (16 codes a fine cell, 1 otherwise, over the fine grid's), the
latter weighted by `gamma`.

The expected code count is a mean over the batch: inside a
`parallel.dist.global_stats` scope over the global batch (every rank's
rows), as the JAX loss sees the global batch.
"""
from __future__ import annotations

from ..parallel.dist import global_mean


class BudgetConstraintRatioMSEDualGrain:
    def __init__(self, target_ratio=0.0, gamma=1.0, min_grain_size=8, max_grain_size=16,
                 calculate_all=True, fix_reference_bug=False):
        self.target_ratio = target_ratio
        self.gamma = gamma
        self.calculate_all = calculate_all
        self.fix_reference_bug = fix_reference_bug
        self.const = min_grain_size * min_grain_size
        self.max_const = max_grain_size * max_grain_size - self.const

    def __call__(self, gate):
        """gate: (B, Hc, Wc, 2) NHWC, grain 0 coarse (1 code), 1 fine (4 codes)."""
        gate = gate.float()
        beta = global_mean((1.0 * gate[..., 0] + 4.0 * gate[..., 1]).sum() / gate.shape[0]) \
            - self.const
        budget_ratio = beta / self.max_const
        loss_budget = self.gamma * (budget_ratio - self.target_ratio) ** 2
        if self.calculate_all:
            loss_last = self.gamma * ((1 - budget_ratio) - (1 - self.target_ratio)) ** 2
            if self.fix_reference_bug:
                return loss_budget + loss_last
            return loss_last + loss_last  # reference behaviour
        return loss_budget


class BudgetConstraintNormedSeparateRatioMSETripleGrain:
    def __init__(self, target_fine_ratio=0.0, target_median_ratio=0.0, gamma=1.0,
                 min_grain_size=8, median_grain_size=16, max_grain_size=32):
        if target_fine_ratio + target_median_ratio > 1.0:
            raise ValueError("target_fine_ratio + target_median_ratio exceeds 1")
        self.target_fine_ratio = target_fine_ratio
        self.target_median_ratio = target_median_ratio
        self.gamma = gamma
        self.min_const = min_grain_size * min_grain_size
        self.median_const = median_grain_size * median_grain_size - self.min_const
        self.max_const = max_grain_size * max_grain_size - self.min_const

    def __call__(self, gate):
        """gate: (B, Hc, Wc, 3) NHWC, grain 0 coarse, 1 median, 2 fine."""
        gate = gate.float()
        g0, g1, g2 = gate[..., 0], gate[..., 1], gate[..., 2]
        beta_median = global_mean((1.0 * g0 + 4.0 * g1 + 1.0 * g2).sum() / gate.shape[0]) \
            - self.min_const
        loss_median = (beta_median / self.median_const - self.target_median_ratio) ** 2
        beta_fine = global_mean((1.0 * g0 + 16.0 * g2 + 1.0 * g1).sum() / gate.shape[0]) \
            - self.min_const
        loss_fine = self.gamma * (beta_fine / self.max_const - self.target_fine_ratio) ** 2
        return loss_fine + loss_median
