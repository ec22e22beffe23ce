"""Sampling entry points: `python -m dynamicvectorquantization_torch.sample.val`
(pickled batches and grids, for FID) and `...sample.images` (one PNG per
image)."""
