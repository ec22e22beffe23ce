"""Budget-constraint loss steering a learned router's fine-grain ratio
(counterpart of `dynamicvectorquantization_tpu/models/budget.py`).

The dual-grain loss takes the expected code count from the gate (1 per
coarse cell, 4 per fine cell), normalises it to a ratio and penalises its
squared distance to the target.

Reference quirk (QUIRKS #1): with `calculate_all=True` the reference returns
`loss_budget_last + loss_budget_last`, dropping the direct-ratio term.
Replicated by default; `fix_reference_bug=True` gives `loss_budget +
loss_budget_last`. The triple-grain loss comes with the triple-grain encoder.
"""
from __future__ import annotations


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
        beta = (1.0 * gate[..., 0] + 4.0 * gate[..., 1]).sum() / gate.shape[0] - self.const
        budget_ratio = beta / self.max_const
        loss_budget = self.gamma * (budget_ratio - self.target_ratio) ** 2
        if self.calculate_all:
            loss_last = self.gamma * ((1 - budget_ratio) - (1 - self.target_ratio)) ** 2
            if self.fix_reference_bug:
                return loss_budget + loss_last
            return loss_last + loss_last  # reference behaviour
        return loss_budget
