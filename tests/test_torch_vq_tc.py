"""The pieces of the tensor-core nearest-code search that run without a card,
and the measurement helper of `chip_smoke.py`:

- `utils/device_time.py` `busy_union_ms`: a trace's busy time as the union of
  its intervals (disjoint, nested, overlapping, touching, unsorted, empty);
- a plain mirror, here only, of `csrc/vq_nearest_tc.cu`'s 3xTF32 split (TF32
  rounding, nearest with ties away from zero, through an int32 view) and of
  its rule for listing a row for the exact rescore: hi + lo rebuilds each
  value to 2^-22 of it, every (row, code) fast score lies within the row's
  bound e_r of its FMA-order score, and on the adversarial sets every row
  whose fast winner is not the FMA search's is listed. The mirror's fast
  score sums each 8-deep step's three products exactly and rounds once (the
  card's tensor cores round otherwise; `chip_smoke.py` measures their
  distance from the bound there).
"""
import numpy as np
import pytest
import torch

from dynamicvectorquantization_torch.utils.device_time import busy_union_ms, window_ms


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("intervals,busy,window", [
    ([(0.0, 1.0), (2.0, 3.5)], 2.5, 3.5),                 # disjoint
    ([(0.0, 10.0), (2.0, 3.0), (4.0, 9.0)], 10.0, 10.0),  # nested
    ([(0.0, 2.0), (1.0, 3.0), (2.5, 4.0)], 4.0, 4.0),     # overlapping
    ([(0.0, 1.0), (1.0, 2.0), (2.0, 2.5)], 2.5, 2.5),     # touching
    ([(5.0, 6.0), (0.0, 1.0), (0.5, 2.0)], 3.0, 6.0),     # unsorted
    ([], 0.0, 0.0),                                       # an empty trace
])
def test_busy_union(intervals, busy, window):
    assert busy_union_ms(intervals) == pytest.approx(busy)
    assert window_ms(intervals) == pytest.approx(window)
    assert busy_union_ms(intervals) <= window_ms(intervals)
    # the plain sum counts overlaps twice
    assert sum(e - s for s, e in intervals) >= busy_union_ms(intervals) - 1e-12


U = 2.0 ** -24


def _tf32(x):
    """f32 -> TF32 (10 explicit mantissa bits), nearest, ties away from zero,
    as `cvt.rna.tf32.f32`: add half of the 13 dropped bits to the magnitude,
    then clear them."""
    bits = np.ascontiguousarray(x, dtype=np.float32).view(np.int32)
    mag = (bits & 0x7FFFFFFF) + 0x1000
    return ((bits & np.int32(-0x80000000)) | (mag & ~np.int32(0x1FFF))).view(np.float32)


def _split(x):
    hi = _tf32(x)
    lo = _tf32((x - hi).astype(np.float32))
    return hi, lo


def _fmaf(a, b, c):
    """f32 fmaf, correctly rounded: a b is exact in f64, a b + c is rounded
    there once more, and the one case where that double rounding could land
    on an f32 halfway point is moved off it towards the exact sum."""
    p = a.astype(np.float64) * b.astype(np.float64)
    c = c.astype(np.float64)
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)  # p + c = s + err exactly (TwoSum)
    half = (s.view(np.int64) & ((1 << 29) - 1)) == (1 << 28)
    fix = half & (err != 0)
    s[fix] = np.nextafter(s[fix], np.where(err[fix] > 0, np.inf, -np.inf))
    return s.astype(np.float32)


def _fma_scores(x, cb, nc):
    """The FMA search's scores: fmaf over d ascending from 0, then |c|^2 - 2 acc."""
    acc = np.zeros((x.shape[0], cb.shape[0]), np.float32)
    for dd in range(x.shape[1]):
        acc = _fmaf(np.broadcast_to(x[:, dd:dd + 1], acc.shape),
                    np.broadcast_to(cb[None, :, dd], acc.shape), acc)
    return (nc[None, :] - np.float32(2) * acc).astype(np.float32)


def _fast_scores(x, cb, nc):
    """The split's scores: per 8-deep step hi.hi + hi.lo + lo.hi (exact, then
    rounded once), added to an f32 accumulator, then |c|^2 - 2 acc."""
    d = x.shape[1]
    dp = -(-d // 8) * 8
    pad = ((0, 0), (0, dp - d))
    (xh, xl), (ch, cl) = (_split(np.pad(v, pad)) for v in (x, cb))
    acc = np.zeros((x.shape[0], cb.shape[0]), np.float32)
    for s in range(0, dp, 8):
        sl = slice(s, s + 8)
        step = (xh[:, sl].astype(np.float64) @ cl[:, sl].T.astype(np.float64)
                + xl[:, sl].astype(np.float64) @ ch[:, sl].T.astype(np.float64)
                + xh[:, sl].astype(np.float64) @ ch[:, sl].T.astype(np.float64))
        acc = (acc + step.astype(np.float32)).astype(np.float32)
    return (nc[None, :] - np.float32(2) * acc).astype(np.float32)


def _margin(x, nc):
    """e_r of `csrc/vq_nearest_tc.cu` (its note derives it)."""
    d = x.shape[1]
    steps = -(-d // 8)
    err_dot = d * U / (1 - d * U) + 3.01 * 2.0 ** -22 + 1.01 * 2.0 ** -19 + 1.02 * steps * U
    xc = np.sqrt((x.astype(np.float64) ** 2).sum(1)) * np.sqrt(nc.max())
    return (2 * err_dot * xc + 2 * U * (nc.max() + 2 * xc)) * 1.001 + d * 1e-36


def _argmin_low(s):
    """argmin with ties to the lowest index (both searches' rule)."""
    return np.argmin(s, axis=1)


def _sets(n=64, k=32, d=36, seed=0):
    r = np.random.default_rng(seed)
    cb = r.normal(size=(k, d)).astype(np.float32)
    x = r.normal(size=(n, d)).astype(np.float32)
    dup = cb.copy()
    dup[1::2] = dup[0::2]
    ulp = cb.copy()
    ulp[1::2] = np.nextafter(ulp[0::2], np.float32(np.inf))
    pair = r.integers(0, k // 2, n) * 2
    mid = (np.float32(0.5) * (cb[pair] + cb[pair + 1])).astype(np.float32)
    init = ((r.uniform(size=(k, d)) * 2 - 1) / k).astype(np.float32)
    owner = (cb[3:4] + 0.01 * r.normal(size=(n, d))).astype(np.float32)
    return {"duplicate_codes": (x, dup), "codes_one_ulp_apart": (x, ulp),
            "rows_equidistant_from_two_codes": (mid, cb), "init_codebook": (x, init),
            "one_code_owns_every_row": (owner, cb), "normal": (x, cb)}


@pytest.mark.parametrize("scale", [1.0, 1e-3, 7.5e4, 1e-30])
def test_tf32_split_rebuilds_each_value(scale):
    r = np.random.default_rng(1)
    x = (r.normal(size=4096) * scale).astype(np.float32)
    hi, lo = _split(x)
    for part in (hi, lo):
        assert not (part.view(np.int32) & 0x1FFF).any()  # TF32: low 13 bits clear
    rest = x.astype(np.float64) - hi.astype(np.float64) - lo.astype(np.float64)
    assert np.all(np.abs(rest) <= 2.0 ** -22 * np.abs(x.astype(np.float64)))
    assert np.all(np.abs(x.astype(np.float64) - hi) <= 2.0 ** -11 * np.abs(x))


def test_tf32_rounds_ties_away_from_zero():
    one_and_half_ulp = np.float32(1 + 2.0 ** -11)  # halfway between TF32 1 and 1 + 2^-10
    assert _tf32(np.array([one_and_half_ulp]))[0] == np.float32(1 + 2.0 ** -10)
    assert _tf32(np.array([-one_and_half_ulp]))[0] == np.float32(-(1 + 2.0 ** -10))


def test_fmaf_mirror_is_correctly_rounded():
    from fractions import Fraction

    r = np.random.default_rng(2)
    a, b, c = (r.normal(size=200).astype(np.float32) for _ in range(3))
    got = _fmaf(a, b, c)
    for ai, bi, ci, gi in zip(a, b, c, got):
        exact = Fraction(float(ai)) * Fraction(float(bi)) + Fraction(float(ci))
        lo, hi = np.nextafter(gi, np.float32(-np.inf)), np.nextafter(gi, np.float32(np.inf))
        err = abs(Fraction(float(gi)) - exact)
        assert err <= abs(Fraction(float(lo)) - exact) and err <= abs(Fraction(float(hi)) - exact)


@pytest.mark.parametrize("d", [32, 36])
@pytest.mark.parametrize("name", ["duplicate_codes", "codes_one_ulp_apart",
                                  "rows_equidistant_from_two_codes", "init_codebook",
                                  "one_code_owns_every_row", "normal"])
def test_flag_rule_lists_every_row_the_split_would_misrank(name, d):
    x, cb = _sets(d=d)[name]
    nc = (torch.from_numpy(cb) * torch.from_numpy(cb)).sum(1).numpy()  # as the wrapper's
    exact, fast = _fma_scores(x, cb, nc), _fast_scores(x, cb, nc)
    margin = _margin(x, nc)
    assert np.all(np.abs(fast.astype(np.float64) - exact) <= margin[:, None])
    order = np.sort(fast, axis=1)
    listed = ~(order[:, 1].astype(np.float64) - order[:, 0] > 2 * margin)
    misranked = _argmin_low(fast) != _argmin_low(exact)
    assert not np.any(misranked & ~listed)
    if name in ("duplicate_codes", "rows_equidistant_from_two_codes"):
        assert listed.mean() > 0.5  # ties and near-ties go to the exact rescore
    if name == "normal":
        assert listed.mean() < 0.05
