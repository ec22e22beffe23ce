#!/usr/bin/env python3
"""Drive the PyTorch port (`dynamicvectorquantization_torch`) on one NVIDIA
GPU and check it end to end. Needs one CUDA card and the CUDA toolkit (nvcc);
builds the kernels from `dynamicvectorquantization_torch/csrc/` at first use.

    python3 chip_smoke.py

Phases, each printed as one JSON line (any failure exits non-zero):
  1. card      name and power limit (nvidia-smi), TF32 off for f32 phases
  2. kernels   each CUDA kernel against its plain-PyTorch version at the
               shapes of the encode, serving and training paths: error vs the stated
               tolerance, kernel / plain / library times (device time from a
               profiler trace, and wall time from CUDA events; inputs rotated
               through more than the 50 MB L2 cache), and the bound from bytes
               or operations at the H100's peak rates
  3. encode    full-width p6c18 first stage (f32), batch 8 of seeded 256^2
               images (half smooth, half noisy): `encode_to_z` and `forward`
               through the kernels and through the plain versions (streams,
               grain cells, codes and reconstructions compared), the round trip
               through `decode_to_img`, timing with the device's busy share,
               and launch counters zeroed just before one `encode_to_z` and read
               just after (patch entropy 1, strided conv 4, attention 6, VQ 1)
  4. decode    full-width p6c18 StackGPT with int8 KV caches, seeded random
               weights, bf16, batch 8: 64 teacher-forced steps through the
               kernel path vs the plain path, max logit difference; then a
               torch.profiler trace of 16 steps for the device's busy time
  5. serve     BatchingSampler (p6c18, int8 caches, max_batch 8) answers 3
               concurrent requests of 1, 2 and 4 images; launch counters are
               zeroed just before and read just after
  6. train     full-width, full-depth p6c18 StackGPT (the shipped config, its
               attn_pdrop 0.1 included, with the training campaign's stream
               caps, T = 805),
               bf16 over f32 masters, batch 8: 16 seeded images encoded by
               `Stage2Trainer.encode_dataset`; one `train_step` through the
               kernels against one through the plain versions from the same
               state and the same dropout masks (losses, gradients,
               parameters); then timed steps with all three shipped dropouts
               (and, for comparison, with attn_pdrop 0), launch counters per
               step, a torch.profiler trace of one step, peak memory
  7. train1    full-width, full-depth DQ-VAE + GAN of the shipped
               `dqvae-entropy-dual-r05_imagenet.yml` (f32, TF32 off, seeded random
               weights, random VGG16 backbone with the bundled LPIPS lin heads),
               batch 8 of the encode phase's images: one `Stage1Trainer.train_step`
               through the kernels against one through the plain versions from
               the same state and generator seed (logs, EMA codebook, watched
               gradients); then timed steps, launch counters per step, a
               torch.profiler trace of one step, peak memory, one `eval_step`
  8. fit       the port's training command line (`train/cli.py` `main`), called
               in-process on the shipped p6c18 config at full width and depth
               with only data and run-length overrides (synthetic 256^2 images,
               batch 8, 2 epochs of 4 steps, the train phase's stream caps): one
               run of both epochs with an image grid, then epoch 1 alone and a
               `--resume` for epoch 2; metric rows, falling loss, checkpoint
               files, the resumed run equal to the uninterrupted one bit for bit
               (final val_loss, a hash of the f32 masters), launch counters,
               seconds per epoch by `loop_buckets.json`
  9. fit1      the same for stage 1 (`dqvae-entropy-dual-r05_imagenet.yml`, batch
               8, two epochs of one step, resume)
 10. kernels   one line listing every ported kernel, its launches on the
               encode, serving, training and fit runs and its measured numbers
The last line is {"ok": true, "device": {...}}. Imports nothing of JAX.
"""
import contextlib
import json
import math
import os
import subprocess
import sys
import time

P6C18 = "configs/stage2/uncond_imagenet_p6c18.yml"
STAGE1 = "configs/stage1/dqvae-entropy-dual-r05_imagenet.yml"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, data sheet
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}  # f32 without tensor cores; bf16 dense
L2_BYTES = 50 * 2 ** 20
# the training campaign's stream caps at fine ratio 0.5 (160 coarse + 644 fine
# tokens and the two SOS prefixes, less the shifted-off last token)
TRAIN_CAPS = {"coarse_max_len": 160, "fine_max_len": 644}
TRAIN_T = 160 + 1 + 644 + 1 - 1
BF16_RTOL = 2.0 ** -7  # one bf16 ulp of the reference value
DROPOUT_RATES = (0.1, 0.5)  # checked against the plain versions; timed at the first
DROPOUT_SEED = 0x5EED5EED5EED


def emit(obj):
    print(json.dumps(obj), flush=True)


def require(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def bound(n_bytes, n_flops, dtype):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def spread(values):
    """Repeat count and spread (min / median / max) of repeated measurements."""
    v = sorted(values)
    mid = len(v) // 2
    median = v[mid] if len(v) % 2 else (v[mid - 1] + v[mid]) / 2
    return {"n": len(v), "min": v[0], "median": median, "max": v[-1]}


def time_ms(torch, fn, arg_sets, iters=20, only=None):
    """Per-call (device ms, wall ms) over `iters` calls cycling through
    `arg_sets` (together larger than L2, so each call finds its inputs
    cold), each as the spread of the calls (`spread`). Device ms: the summed
    durations of the CUDA kernels a call launched (only those whose name
    contains `only`, when given), from a torch.profiler (CUPTI) trace whose
    kernels are split into the calls in launch order (when every call
    launches as many kernels; else the mean alone, n = 1). Wall ms: CUDA
    events round each of the back-to-back calls, which include the host's
    launch overhead when that exceeds the kernels' time, and every op the
    call launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn(*arg_sets[0])
    torch.cuda.synchronize()
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(iters + 1)]
    marks[0].record()
    for i in range(iters):
        fn(*arg_sets[i % len(arg_sets)])
        marks[i + 1].record()
    marks[-1].synchronize()
    wall = spread([a.elapsed_time(b) for a, b in zip(marks, marks[1:])])
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            fn(*arg_sets[i % len(arg_sets)])
        torch.cuda.synchronize()
    kernels = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                     key=lambda e: e.time_range.start)
    if not any(only is None or only in e.name for e in kernels):
        return None, wall  # the trace held no (matching) device time
    per = len(kernels) // iters
    if per * iters == len(kernels):
        device = spread([sum(e.time_range.elapsed_us() for e in kernels[i * per:(i + 1) * per]
                             if only is None or only in e.name) / 1e3 for i in range(iters)])
    else:
        device = spread([sum(e.time_range.elapsed_us() for e in kernels
                             if only is None or only in e.name) / 1e3 / iters])
    return device, wall


def time_into(case, key, torch, fn, arg_sets, iters=20, only=None):
    """`time_ms` into `case`: `<key>_ms` and `<key>_wall_ms` the medians,
    `<key>_ms_spread` and `<key>_wall_ms_spread` the repeat counts and
    spreads."""
    device, wall = time_ms(torch, fn, arg_sets, iters, only)
    case[f"{key}_ms"] = device and device["median"]
    case[f"{key}_ms_spread"] = device
    case[f"{key}_wall_ms"] = wall["median"]
    case[f"{key}_wall_ms_spread"] = wall


def n_sets(bytes_per_set):
    return max(2, -(-2 * L2_BYTES // bytes_per_set))


def check_decode_attention(torch, dev):
    from dynamicvectorquantization_torch.ops.kv_int8 import (
        decode_attention_int8, decode_attention_int8_plain, quantize_kv)

    b, h, t, hd = 8, 8, 1536, 128  # p6c18: batch 8, 8 heads, 1284 -> 1536 positions
    tol = 1e-2  # bf16 output: one rounding of values |y| < 1 (ulp <= 2^-8)
    g = torch.Generator(device=dev).manual_seed(0)
    set_bytes = 2 * b * h * t * (hd + 4)
    sets = []
    for _ in range(n_sets(set_bytes)):
        q = torch.randn((b, h, 1, hd), generator=g, device=dev).to(torch.bfloat16)
        kq, ks = quantize_kv(torch.randn((b, h, t, hd), generator=g, device=dev) * 2)
        vq, vs = quantize_kv(torch.randn((b, h, t, hd), generator=g, device=dev))
        sets.append((q, kq, vq, ks, vs))
    cases = []
    for idx in (0, 255, 256, 1283):
        out = decode_attention_int8(*sets[0], idx)
        ref = decode_attention_int8_plain(*sets[0], idx)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        n = idx + 1
        bms, by = bound(2 * b * h * hd * 2 + 2 * b * h * n * (hd + 4), 4 * b * h * n * hd,
                        "float32")
        case = dict(phase="kernels", kernel="decode_attention_int8", shape=[b, h, t, hd],
                    dtype="bfloat16", cache_index=idx, max_abs_err=err, tol=tol,
                    library_ms=None, bound_ms=bms, bound_by=by)
        time_into(case, "kernel", torch, lambda *a: decode_attention_int8(*a, idx), sets)
        time_into(case, "plain", torch, lambda *a: decode_attention_int8_plain(*a, idx), sets)
        emit(case)
        require(err <= tol, f"decode_attention_int8 disagrees at cache_index {idx}: {err}")
        cases.append(case)
    return cases


def fma_forward(torch, q, k, v, n_head, scale, causal, rate=0.0, return_lse=False, seed=0):
    """The FMA family's forward entry called directly, at shapes the wrapper
    sends to the tensor cores (bf16, hd 64 / 128): the time before this
    family was replaced there, for comparison in the same call. Launches
    are not counted."""
    from dynamicvectorquantization_torch.ops import cuda_lib

    b, t, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, n_head, t), dtype=torch.float32, device=q.device) if return_lse else None
    err = cuda_lib.lib().dqvq_fused_attention_forward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr() if return_lse else None, b, t, d, n_head, float(scale), int(causal),
        1 if q.dtype == torch.bfloat16 else 0, float(rate), int(seed) if rate else 0,
        torch.cuda.current_stream().cuda_stream)
    cuda_lib.check(err, "fma_forward")
    return (out, lse) if return_lse else out


def fma_backward(torch, q, k, v, y, lse, dy, n_head, scale, causal, rate=0.0, seed=0):
    """The FMA family's backward entry called directly (see `fma_forward`)."""
    from dynamicvectorquantization_torch.ops import cuda_lib

    b, t, d = q.shape
    dq, dk, dv = torch.empty_like(q), torch.empty_like(q), torch.empty_like(q)
    delta = torch.empty_like(lse)
    err = cuda_lib.lib().dqvq_fused_attention_backward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), y.data_ptr(), dy.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, t, d, n_head,
        float(scale), int(causal), 1 if q.dtype == torch.bfloat16 else 0, float(rate),
        int(seed) if rate else 0, torch.cuda.current_stream().cuda_stream)
    cuda_lib.check(err, "fma_backward")
    return dq, dk, dv


def tensor_core_shape(torch, dtype, hd):
    """Whether the attention wrappers send this dtype and head dim to the
    tensor-core family."""
    from dynamicvectorquantization_torch.ops.attention import _TC_HEAD_DIMS

    return dtype == torch.bfloat16 and hd in _TC_HEAD_DIMS


def check_fused_attention(torch, dev):
    import torch.nn.functional as F

    from dynamicvectorquantization_torch.ops.attention import (
        fused_attention_forward, fused_attention_forward_plain)

    cases, dropout_cases = [], []
    # DQ-VAE AttnBlock at 32x32 (decoder and encoder; f32, one head), a
    # StackGPT-like causal bf16 shape (808 tokens, 8 heads: the tensor-core
    # family, with the FMA family's time beside it), the encoder's AttnBlock
    # at 16x16 (one head of 512 channels), and the first shape in bf16 (the
    # FMA family's bf16 instantiation at hd 256)
    for (b, t, d), n_head, causal, dtype, tol in (
            ((8, 1024, 256), 1, False, torch.float32, 1e-4),
            ((8, 808, 1024), 8, True, torch.bfloat16, 2e-2),
            ((8, 256, 512), 1, False, torch.float32, 1e-4),
            ((8, 1024, 256), 1, False, torch.bfloat16, 2e-2)):
        hd = d // n_head
        scale = hd ** -0.5
        g = torch.Generator(device=dev).manual_seed(1)
        elem = torch.finfo(dtype).bits // 8
        sets = [tuple(torch.randn((b, t, d), generator=g, device=dev).to(dtype)
                      for _ in range(3)) for _ in range(n_sets(4 * b * t * d * elem))]

        def heads(z):
            return z.view(b, t, n_head, hd).transpose(1, 2)

        def lib(q, k, v):
            return F.scaled_dot_product_attention(heads(q), heads(k), heads(v),
                                                  is_causal=causal, scale=scale)

        tc = tensor_core_shape(torch, dtype, hd)
        before = fused_attention_forward.tc_launches
        out = fused_attention_forward(*sets[0], n_head, scale, causal)
        ref = fused_attention_forward_plain(*sets[0], n_head, scale, causal)
        torch.cuda.synchronize()
        require(fused_attention_forward.tc_launches - before == int(tc),
                f"fused_attention_forward took the wrong family at {dtype} hd {hd}")
        err = (out.float() - ref.float()).abs().max().item()
        pairs = t * (t + 1) // 2 if causal else t * t
        dname = str(dtype).split(".")[-1]
        bms, by = bound(4 * b * t * d * elem, 4 * b * n_head * pairs * hd, dname)
        case = dict(phase="kernels", kernel="fused_attention_forward", shape=[b, t, d],
                    n_head=n_head, causal=causal, dtype=dname,
                    family="tensor cores" if tc else "FMA", max_abs_err=err, tol=tol,
                    bound_ms=bms, bound_by=by)
        if tc:  # the FMA family at the same shape: the time before the tensor cores took it
            case["fma_max_abs_err"] = (fma_forward(torch, *sets[0], n_head, scale, causal).float()
                                       - ref.float()).abs().max().item()
            time_into(case, "fma_kernel", torch,
                      lambda *a: fma_forward(torch, *a, n_head, scale, causal), sets)
        time_into(case, "kernel", torch,
                  lambda *a: fused_attention_forward(*a, n_head, scale, causal), sets)
        time_into(case, "plain", torch,
                  lambda *a: fused_attention_forward_plain(*a, n_head, scale, causal), sets)
        time_into(case, "library", torch, lib, sets)
        emit(case)
        require(err <= tol, f"fused_attention_forward disagrees at {case['shape']}: {err}")
        cases.append(case)

        # the same shape with dropout on the probabilities: the same tolerance;
        # times at rate 0.1, the library call being SDPA with dropout_p
        q, k, v = sets[0]
        drop = dict(case, dropout_err={})
        for rate in DROPOUT_RATES:
            out = fused_attention_forward(q, k, v, n_head, scale, causal, rate, seed=DROPOUT_SEED)
            ref = fused_attention_forward_plain(q, k, v, n_head, scale, causal, False, rate,
                                                DROPOUT_SEED)
            torch.cuda.synchronize()
            drop["dropout_err"][str(rate)] = (out.float() - ref.float()).abs().max().item()
            del out, ref
        rate = DROPOUT_RATES[0]
        drop.update(rate=rate, max_abs_err=max(drop["dropout_err"].values()))
        time_into(drop, "kernel", torch,
                  lambda *a: fused_attention_forward(
                      *a, n_head, scale, causal, rate, seed=DROPOUT_SEED), sets)
        time_into(drop, "plain", torch,
                  lambda *a: fused_attention_forward_plain(
                      *a, n_head, scale, causal, False, rate, DROPOUT_SEED), sets, iters=5)
        time_into(drop, "library", torch,
                  lambda q, k, v: F.scaled_dot_product_attention(
                      heads(q), heads(k), heads(v), dropout_p=rate, is_causal=causal, scale=scale),
                  sets)
        if tc:
            time_into(drop, "fma_kernel", torch,
                      lambda *a: fma_forward(
                          torch, *a, n_head, scale, causal, rate, seed=DROPOUT_SEED), sets)
        emit(drop)
        require(drop["max_abs_err"] <= tol,
                f"fused_attention_forward with dropout disagrees at {case['shape']}: "
                f"{drop['dropout_err']}")
        dropout_cases.append(drop)
    return cases, dropout_cases


def check_attention_dropout(torch, dev):
    """What the dropout masks are, apart from agreeing with the plain version:
    per tile family of the forward and backward kernels (FMA family in f32:
    hd 64 / 128: 64-row tiles; hd 256: 64- and 32-row; hd 512: 32- and
    16-row; tensor-core family in bf16 at hd 64 / 128, where unit vectors and
    uniform probabilities are exact) the mask recovered
    from the kernel equals `dropout_keep_mask` bit for bit (uniform
    probabilities, V rows that are unit vectors: output column c of row r is
    nonzero iff probability (r, c) was kept; dV likewise for the backward's
    D), the kept share lies within 3 sigma of 1 - rate, one seed twice gives
    identical outputs, two seeds differ, and rate 0 with a seed equals the
    call without one."""
    from dynamicvectorquantization_torch.ops.attention import (
        dropout_keep_mask, fused_attention_backward, fused_attention_forward)

    b, n_head = 2, 2
    families = []
    tc_before = (fused_attention_forward.tc_launches, fused_attention_backward.tc_launches)
    for hd, t, dtype in ((64, 300, torch.float32), (128, 805, torch.float32),
                         (256, 300, torch.float32), (512, 300, torch.float32),
                         (64, 300, torch.bfloat16), (128, 805, torch.bfloat16)):
        for rate in DROPOUT_RATES:
            seed = DROPOUT_SEED + hd
            mask = dropout_keep_mask(seed, b, n_head, t, rate, dev)
            q = torch.zeros((b, t, n_head * hd), device=dev, dtype=dtype)
            fwd_equal = bwd_equal = True
            for c0 in range(0, t, hd):  # hd columns of the mask per probe
                n = min(hd, t - c0)
                v = torch.zeros((b, t, n_head, hd), device=dev, dtype=dtype)
                v[:, c0 + torch.arange(n), :, torch.arange(n)] = 1.0
                v = v.reshape(b, t, -1).contiguous()
                y, lse = fused_attention_forward(q, q, v, n_head, None, False, rate, True, seed)
                got = y.view(b, t, n_head, hd).transpose(1, 2)[..., :n] > 0
                fwd_equal &= bool(torch.equal(got, mask[..., c0:c0 + n]))
                # dV[key c] = sum_r D[r, c] dY[r]: with dY = V's unit vectors of rows
                # c0.., dV[c, j] > 0 iff D[c0 + j, c] > 0, the mask transposed
                _, _, dv = fused_attention_backward(q, q, v, y, lse, v, n_head, None, False,
                                                    rate, seed)
                got = dv.view(b, t, n_head, hd).transpose(1, 2)[..., :n] > 0
                bwd_equal &= bool(torch.equal(got, mask[..., c0:c0 + n, :].transpose(-1, -2)))
            kept = mask.float().mean().item()
            sigma = (rate * (1 - rate) / mask.numel()) ** 0.5
            families.append(dict(hd=hd, t=t, rate=rate, dtype=str(dtype).split(".")[-1],
                                 family="tensor cores" if tensor_core_shape(torch, dtype, hd)
                                 else "FMA", forward_mask_equal=fwd_equal,
                                 backward_mask_equal=bwd_equal, kept_share=kept,
                                 kept_share_sigmas=abs(kept - (1 - rate)) / sigma))
    tc_probes = (fused_attention_forward.tc_launches - tc_before[0],
                 fused_attention_backward.tc_launches - tc_before[1])
    g = torch.Generator(device=dev).manual_seed(14)
    q, k, v = (torch.randn((2, TRAIN_T, 1024), generator=g, device=dev).to(torch.bfloat16)
               for _ in range(3))
    def run(seed, rate=0.1):
        return fused_attention_forward(q, k, v, 8, None, True, rate, seed=seed)

    res = dict(phase="kernels", kernel="attention_dropout_mask", families=families,
               tensor_core_probe_launches=tc_probes,
               same_seed_bit_identical=bool(torch.equal(run(5), run(5))),
               seeds_differ=not torch.equal(run(5), run(6)),
               rate0_ignores_seed=bool(torch.equal(run(5, 0.0), fused_attention_forward(
                   q, k, v, 8, None, True))))
    emit(res)
    require(all(f["forward_mask_equal"] and f["backward_mask_equal"] for f in families),
            f"a kernel's dropout mask differs from dropout_keep_mask: {families}")
    probes = 2 * sum(-(-t // hd) for hd, t in ((64, 300), (128, 805)))  # two rates
    require(tc_probes == (probes, probes),
            f"the bf16 probes did not all run on the tensor cores: {tc_probes}, expected "
            f"{(probes, probes)}")
    require(all(f["kept_share_sigmas"] <= 3.0 for f in families),
            f"kept share off 1 - rate by more than 3 sigma: {families}")
    require(res["same_seed_bit_identical"] and res["seeds_differ"] and res["rate0_ignores_seed"],
            f"dropout seeds: {res}")
    return res


def near_tie_bound(x_norm, c_norm_a, c_norm_b, d):
    """Largest score gap |c|^2 - 2 x.c between two codes that f32 rounding can
    reverse: each D-long dot errs by at most D u |x| |c| (u = 2^-24,
    Cauchy-Schwarz) and |c|^2 by D u |c|^2, on both sides of the comparison."""
    u = 2.0 ** -24
    return 2 * d * u * (2 * x_norm * (c_norm_a + c_norm_b) + c_norm_a ** 2 + c_norm_b ** 2)


def check_vq_nearest(torch, dev):
    from dynamicvectorquantization_torch.ops.vq import nearest_codes, nearest_codes_plain

    n, k, d = 8 * 32 * 32, 1024, 256  # the encoder's 32x32 latents at batch 8
    g = torch.Generator(device=dev).manual_seed(3)
    set_bytes = 4 * (n * d + k * d)
    # N(0, 1) codebook, not the 1/K init, so that near-ties are rare
    sets = [(torch.randn((n, d), generator=g, device=dev),
             torch.randn((k, d), generator=g, device=dev)) for _ in range(n_sets(set_bytes))]
    x, cb = sets[0]
    idx, xq = nearest_codes(x, cb)
    ref, _ = nearest_codes_plain(x, cb)
    torch.cuda.synchronize()
    scores = (cb * cb).sum(1)[None] - 2.0 * (x @ cb.t())
    rows = torch.arange(n, device=dev)
    gap = (scores[rows, idx] - scores[rows, ref]).abs()
    cn = cb.norm(dim=1)
    tol = near_tie_bound(x.norm(dim=1), cn[idx], cn[ref], d)
    differ = idx != ref
    near_ties = int(differ.sum())
    case = dict(phase="kernels", kernel="vq_nearest", shape=[n, k, d], dtype="float32",
                mismatched_rows=near_ties, mismatches_within_near_tie_bound=bool(
                    (gap[differ] <= tol[differ]).all()),
                max_abs_err=float(gap[differ].max()) if near_ties else 0.0,
                tol="score gap <= 2 D 2^-24 (2|x|(|ca|+|cb|) + |ca|^2 + |cb|^2) per row",
                xq_is_codebook_row=bool(torch.equal(xq, cb[idx])))
    bms, by = bound(4 * (n * d + k * d + k + n), 2 * n * k * d, "float32")
    case.update(bound_ms=bms, bound_by=by)

    def lib(x, cb, cb_norm):  # two PyTorch calls: the score product and its argmin
        return torch.addmm(cb_norm, x, cb.t(), alpha=-2).argmin(1)

    time_into(case, "kernel", torch, nearest_codes, sets, only="vq_nearest")
    time_into(case, "plain", torch, nearest_codes_plain, sets)
    time_into(case, "library", torch, lib, [(x, cb, (cb * cb).sum(1)) for x, cb in sets])
    emit(case)
    require(case["mismatches_within_near_tie_bound"] and case["xq_is_codebook_row"],
            f"vq_nearest disagrees beyond f32 near-ties: {case}")
    return case


def check_vq_train(torch, dev):
    from dynamicvectorquantization_torch.ops.vq import (
        nearest_codes_with_stats, nearest_codes_with_stats_plain)

    k, d = 1024, 256
    sum_tol = 1e-4  # relative to the largest sum: f32 additions of up to ~1,000 rows in another order
    g = torch.Generator(device=dev).manual_seed(12)

    def clustered(n):
        """Rows scattered round 700 of the 1,024 codes with skewed weights, so
        clusters are uneven and some stay empty, as on the encode path."""
        cb = torch.randn((k, d), generator=g, device=dev)
        weights = 1.0 / torch.arange(1, 701, device=dev, dtype=torch.float32)
        assign = torch.multinomial(weights, n, replacement=True, generator=g)
        return cb[assign] + 0.3 * torch.randn((n, d), generator=g, device=dev), cb

    def compare(x, cb):
        idx, xq, esum, csize = nearest_codes_with_stats(x, cb)
        again = nearest_codes_with_stats(x, cb)
        ref_idx = nearest_codes_with_stats_plain(x, cb)[0]
        torch.cuda.synchronize()
        scores = (cb * cb).sum(1)[None] - 2.0 * (x @ cb.t())
        rows = torch.arange(x.shape[0], device=dev)
        gap = (scores[rows, idx] - scores[rows, ref_idx]).abs()
        cn = cb.norm(dim=1)
        differ = idx != ref_idx
        within = bool((gap[differ] <= near_tie_bound(x.norm(dim=1), cn[idx], cn[ref_idx],
                                                     x.shape[1])[differ]).all())
        # the plain sums over the kernel's own codes (equal to the plain codes outside near-ties)
        ref_sum = torch.zeros_like(cb).index_add_(0, idx, x)
        ref_size = torch.bincount(idx, minlength=cb.shape[0]).float()
        return dict(shape=[x.shape[0], cb.shape[0], x.shape[1]], mismatched_rows=int(differ.sum()),
                    mismatches_within_near_tie_bound=within,
                    xq_is_codebook_row=bool(torch.equal(xq, cb[idx])),
                    embed_sum_rel_err=float((esum - ref_sum).abs().max() / ref_sum.abs().max()),
                    cluster_size_exact=bool(torch.equal(csize, ref_size)),
                    largest_cluster=int(csize.max()), empty_clusters=int((csize == 0).sum()),
                    bit_reproducible=all(torch.equal(a_, b_)
                                         for a_, b_ in zip((idx, xq, esum, csize), again)))

    n = 8 * 32 * 32  # the encoder's 32x32 latents at batch 8
    sets = [clustered(n) for _ in range(n_sets(4 * (2 * n * d + 2 * k * d)))]
    case = dict(phase="kernels", kernel="vq_nearest_train", dtype="float32", **compare(*sets[0]),
                tol=f"codes: f32 near-tie bound; xq, cluster_size exact; embed_sum {sum_tol} "
                    "of the largest sum")
    case["max_abs_err"] = case["embed_sum_rel_err"]
    x_small = torch.randn((100, d), generator=g, device=dev)  # fewer rows than codes
    x_odd, cb_odd = (torch.randn((1237, 36), generator=g, device=dev),
                     torch.randn((300, 36), generator=g, device=dev))
    case["other_shapes"] = [compare(x_small, sets[0][1]), compare(x_odd, cb_odd)]
    # each input read once (x, codebook, |c|^2), each output written once
    # (idx, xq, embed_sum, cluster_size); the search's 2 N K D and the N D adds
    case["bound_ms"], case["bound_by"] = bound(
        4 * (2 * n * d + 2 * k * d + 2 * k + n), 2 * n * k * d + n * d, "float32")

    def lib(x, cb, cb_norm):  # six PyTorch calls: scores, argmin, gather, zeros + index_add_, bincount
        idx = torch.addmm(cb_norm, x, cb.t(), alpha=-2).argmin(1)
        return (idx, cb.index_select(0, idx), torch.zeros_like(cb).index_add_(0, idx, x),
                torch.bincount(idx, minlength=cb.shape[0]))

    time_into(case, "kernel", torch, nearest_codes_with_stats, sets, only="vq_")
    time_into(case, "stats_kernel", torch, nearest_codes_with_stats, sets, only="vq_stats")
    time_into(case, "plain", torch, nearest_codes_with_stats_plain, sets)
    time_into(case, "library", torch, lib, [(x, cb, (cb * cb).sum(1)) for x, cb in sets])
    emit(case)
    for c in (case, *case["other_shapes"]):
        require(c["mismatches_within_near_tie_bound"] and c["xq_is_codebook_row"]
                and c["cluster_size_exact"] and c["embed_sum_rel_err"] <= sum_tol
                and c["bit_reproducible"], f"vq_nearest_train disagrees: {c}")
    require(case["empty_clusters"] > 0 and case["largest_cluster"] > 10 * n // k,
            "the check's clusters should be uneven, with some empty")
    return case


def smooth_and_noisy_images(torch, dev, g, b=8, size=256):
    """Seeded NHWC images in [-1, 1]: the left half a smooth gradient with a
    little noise (low patch entropy), the right half uniform noise (high)."""
    x = torch.rand((b, size, size, 3), generator=g, device=dev) * 2 - 1
    half = size // 2
    ramp = torch.linspace(-0.5, 0.5, size, device=dev).view(1, 1, size, 1)
    x[:, :, :half] = ramp[:, :, :half] + 0.005 * x[:, :, :half]
    return x.contiguous()


def check_patch_entropy(torch, dev):
    from dynamicvectorquantization_torch.ops.entropy import patch_entropy, patch_entropy_plain

    b, size, p, nb = 8, 256, 16, 32
    tol = 1e-5  # f32 sums of 256 kernel values and 32 p log p terms in another order
    g = torch.Generator(device=dev).manual_seed(4)
    sets = [(smooth_and_noisy_images(torch, dev, g),) for _ in range(n_sets(b * size * size * 12))]
    out = patch_entropy(*sets[0])
    ref = patch_entropy_plain(*sets[0])
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    n_exp = b * size * size * nb
    # each kernel value: subtract, multiply, two multiplies, exp, add (6 f32 ops)
    bms, by = bound(b * size * size * 12 + b * (size // p) ** 2 * 4, 6 * n_exp, "float32")
    case = dict(phase="kernels", kernel="patch_entropy", shape=[b, size, size, 3], patch=p,
                bins=nb, dtype="float32", max_abs_err=err, tol=tol, bound_ms=bms, bound_by=by,
                exponentials=n_exp, library_ms=None)
    time_into(case, "kernel", torch, patch_entropy, sets, only="patch_entropy")
    time_into(case, "plain", torch, patch_entropy_plain, sets)
    emit(case)
    require(err <= tol, f"patch_entropy disagrees: {err}")
    return case


def check_strided_conv(torch, dev):
    import torch.nn.functional as F

    from dynamicvectorquantization_torch.ops.downsample import (
        strided_conv3x3_down, strided_conv3x3_down_plain)

    tol = 1e-4  # f32 sums of 9 C <= 2304 products (|y| < ~5) in another order
    g = torch.Generator(device=dev).manual_seed(5)
    cases = []
    # the encoder's four Downsample convs at batch 8, 256^2 input
    for b, c, hw in ((8, 128, 256), (8, 128, 128), (8, 256, 64), (8, 256, 32)):
        w = (torch.rand((c, c, 3, 3), generator=g, device=dev) * 2 - 1) / (9 * c) ** 0.5
        bias = (torch.rand((c,), generator=g, device=dev) * 2 - 1) / (9 * c) ** 0.5
        sets = [(torch.randn((b, c, hw, hw), generator=g, device=dev), w, bias)
                for _ in range(n_sets(4 * b * c * hw * hw))]
        out = strided_conv3x3_down(*sets[0])
        ref = strided_conv3x3_down_plain(*sets[0])
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        ho = hw // 2
        bms, by = bound(4 * (b * c * hw * hw + c * c * 9 + c + b * c * ho * ho),
                        2 * 9 * c * c * ho * ho * b, "float32")
        case = dict(phase="kernels", kernel="strided_conv3x3_down", shape=[b, c, hw, hw],
                    out_channels=c, dtype="float32", max_abs_err=err, tol=tol, bound_ms=bms,
                    bound_by=by)
        time_into(case, "kernel", torch, strided_conv3x3_down, sets, iters=10,
                  only="strided_conv_down")
        time_into(case, "plain", torch, strided_conv3x3_down_plain, sets, iters=10)
        padded = [(F.pad(x, (0, 1, 0, 1)), w_, b_) for x, w_, b_ in sets]
        del sets
        time_into(case, "library", torch, lambda x, w_, b_: F.conv2d(x, w_, b_, stride=2), padded,
                  iters=10)
        del padded
        emit(case)
        require(err <= tol, f"strided_conv3x3_down disagrees at {case['shape']}: {err}")
        cases.append(case)
    return cases


def close(out, ref, atol, rtol=0.0):
    """(max abs error, whether |out - ref| <= atol + rtol |ref| everywhere), in f32."""
    out, ref = out.float(), ref.float()
    diff = (out - ref).abs()
    return diff.max().item(), bool((diff <= atol + rtol * ref.abs()).all())


def tolerances(dtype_name, atol_f32, atol_bf16=2e-2):
    """bf16 outputs: one ulp of the reference value (a rounding that falls the
    other way) on top of an absolute slack; f32: the absolute tolerance alone."""
    return (atol_bf16, BF16_RTOL) if dtype_name == "bfloat16" else (atol_f32, 0.0)


def check_layernorm(torch, dev):
    import torch.nn.functional as F

    from dynamicvectorquantization_torch.ops.layernorm import (
        fused_layernorm_plain, layernorm_backward, layernorm_backward_plain, layernorm_forward)

    b, t, d, eps = 8, TRAIN_T, 1024, 1e-5
    rows = b * t
    fwd_cases, bwd_cases = [], []
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[-1]
        elem = torch.finfo(dtype).bits // 8
        atol, rtol = tolerances(dname, 1e-5)
        g = torch.Generator(device=dev).manual_seed(7)
        gamma = (1 + 0.1 * torch.randn(d, generator=g, device=dev)).to(dtype)
        beta = (0.1 * torch.randn(d, generator=g, device=dev)).to(dtype)
        sets = [((torch.randn((b, t, d), generator=g, device=dev) * 1.5 + 0.3).to(dtype),
                 torch.randn((b, t, d), generator=g, device=dev).to(dtype))
                for _ in range(n_sets(2 * rows * d * elem))]
        x, dy = sets[0]
        y = layernorm_forward(x, gamma, beta, eps)
        dx, dg, db = layernorm_backward(x, gamma, dy, eps)
        y_ref = fused_layernorm_plain(x, gamma, beta, eps)
        dx_ref, dg_ref, db_ref = layernorm_backward_plain(x, gamma, dy, eps)
        dx2, dg2, db2 = layernorm_backward(x, gamma, dy, eps)
        torch.cuda.synchronize()
        err_y, ok_y = close(y, y_ref, atol, rtol)
        err_dx, ok_dx = close(dx, dx_ref, atol, rtol)
        # f32 sums of 6,440 terms |dy xhat| < ~20 in another order, values up to ~300
        sum_tol = 2e-3
        err_dg, ok_dg = close(dg, dg_ref, sum_tol)
        err_db, ok_db = close(db, db_ref, sum_tol)
        reproducible = bool(torch.equal(dx, dx2) and torch.equal(dg, dg2) and torch.equal(db, db2))

        fb, fby = bound(2 * rows * d * elem + 2 * d * elem, 8 * rows * d, "float32")
        fwd = dict(phase="kernels", kernel="layernorm_forward", shape=[b, t, d], dtype=dname,
                   max_abs_err=err_y, tol=f"{atol} + {rtol} |ref|", bound_ms=fb, bound_by=fby)
        time_into(fwd, "kernel", torch, lambda x_, dy_: layernorm_forward(x_, gamma, beta, eps),
                  sets)
        time_into(fwd, "plain", torch, lambda x_, dy_: fused_layernorm_plain(x_, gamma, beta, eps),
                  sets)
        time_into(fwd, "library", torch, lambda x_, dy_: F.layer_norm(x_, (d,), gamma, beta, eps),
                  sets)
        emit(fwd)

        bb, bby = bound(3 * rows * d * elem + d * elem + 8 * d, 16 * rows * d, "float32")
        bwd = dict(phase="kernels", kernel="layernorm_backward", shape=[b, t, d], dtype=dname,
                   max_abs_err=max(err_dx, err_dg, err_db), dx_err=err_dx, dgamma_err=err_dg,
                   dbeta_err=err_db, tol=f"dx {atol} + {rtol} |ref|; dgamma, dbeta {sum_tol}",
                   bit_reproducible=reproducible, bound_ms=bb, bound_by=bby)
        time_into(bwd, "kernel", torch, lambda x_, dy_: layernorm_backward(x_, gamma, dy_, eps),
                  sets)
        time_into(bwd, "plain", torch,
                  lambda x_, dy_: layernorm_backward_plain(x_, gamma, dy_, eps), sets)
        gl, bl = gamma.clone().requires_grad_(), beta.clone().requires_grad_()
        lib_sets = []
        for x_, dy_ in sets:
            xl = x_.clone().requires_grad_()
            lib_sets.append((F.layer_norm(xl, (d,), gl, bl, eps), xl, dy_))
        time_into(bwd, "library", torch,
                  lambda y_, xl, dy_: torch.autograd.grad(y_, (xl, gl, bl), dy_, retain_graph=True),
                  lib_sets)
        del lib_sets
        emit(bwd)
        require(ok_y, f"layernorm_forward disagrees ({dname}): {err_y}")
        require(ok_dx and ok_dg and ok_db,
                f"layernorm_backward disagrees ({dname}): dx {err_dx} dgamma {err_dg} dbeta {err_db}")
        require(reproducible, "layernorm_backward is not bit-reproducible")
        fwd_cases.append(fwd)
        bwd_cases.append(bwd)
    return fwd_cases, bwd_cases


def check_attention_backward(torch, dev):
    import torch.nn.functional as F

    from dynamicvectorquantization_torch.ops.attention import (
        fused_attention_backward, fused_attention_backward_plain, fused_attention_forward,
        fused_attention_forward_plain)

    fwd_cases, bwd_cases, drop_fwd_cases, drop_bwd_cases = [], [], [], []
    # the stage-2 training shape in bf16; the same in f32 at batch 2; one non-causal head,
    # ragged tiles; the DQ-VAE's conv AttnBlocks in stage-1 training: one non-causal f32
    # head of 256 channels over 32 x 32 positions, and of 512 over 16 x 16
    # (the first on the tensor cores, with the FMA family's times beside it; the FMA
    # family's bf16 instantiation at hd 256 last)
    for (b, t, d), n_head, causal, dtype in (
            ((8, TRAIN_T, 1024), 8, True, torch.bfloat16),
            ((2, TRAIN_T, 1024), 8, True, torch.float32),
            ((2, 300, 64), 1, False, torch.float32),
            ((8, 1024, 256), 1, False, torch.float32),
            ((8, 256, 512), 1, False, torch.float32),
            ((8, 1024, 256), 1, False, torch.bfloat16)):
        hd = d // n_head
        scale = hd ** -0.5
        dname = str(dtype).split(".")[-1]
        elem = torch.finfo(dtype).bits // 8
        atol, rtol = tolerances(dname, 1e-4)
        g = torch.Generator(device=dev).manual_seed(8)
        sets = []
        for _ in range(n_sets(8 * b * t * d * elem)):
            q, k, v, dy = (torch.randn((b, t, d), generator=g, device=dev).to(dtype)
                           for _ in range(4))
            y, lse = fused_attention_forward(q, k, v, n_head, scale, causal, return_lse=True)
            sets.append((q, k, v, y, lse, dy))
        q, k, v, y, lse, dy = sets[0]
        tc = tensor_core_shape(torch, dtype, hd)
        family = "tensor cores" if tc else "FMA"
        before = fused_attention_backward.tc_launches
        y_ref, lse_ref = fused_attention_forward_plain(q, k, v, n_head, scale, causal, True)
        out = fused_attention_backward(q, k, v, y, lse, dy, n_head, scale, causal)
        again = fused_attention_backward(q, k, v, y, lse, dy, n_head, scale, causal)
        ref = fused_attention_backward_plain(q, k, v, y_ref, lse_ref, dy, n_head, scale, causal)
        torch.cuda.synchronize()
        require(fused_attention_backward.tc_launches - before == 2 * int(tc),
                f"fused_attention_backward took the wrong family at {dtype} hd {hd}")
        err_y, ok_y = close(y, y_ref, atol, rtol)
        err_lse, ok_lse = close(lse, lse_ref, 1e-4)  # f32 log of an f32 sum of T terms
        errs, oks = zip(*(close(o, r, atol, rtol) for o, r in zip(out, ref)))
        reproducible = all(torch.equal(a_, b_) for a_, b_ in zip(out, again))
        pairs = t * (t + 1) // 2 if causal else t * t
        fwd = dict(phase="kernels", kernel="fused_attention_forward", shape=[b, t, d],
                   n_head=n_head, causal=causal, dtype=dname, family=family, with_lse=True,
                   max_abs_err=err_y, lse_err=err_lse, tol=f"{atol} + {rtol} |ref|; lse 1e-4")
        fwd["bound_ms"], fwd["bound_by"] = bound(
            4 * b * t * d * elem + 4 * b * n_head * t, 4 * b * n_head * pairs * hd, dname)
        time_into(fwd, "kernel", torch,
                  lambda q_, k_, v_, *_: fused_attention_forward(
                      q_, k_, v_, n_head, scale, causal, return_lse=True), sets)
        time_into(fwd, "plain", torch,
                  lambda q_, k_, v_, *_: fused_attention_forward_plain(
                      q_, k_, v_, n_head, scale, causal, True), sets, iters=10)

        def heads(z):
            return z.view(b, t, n_head, hd).transpose(1, 2)

        time_into(fwd, "library", torch,
                  lambda q_, k_, v_, *_: F.scaled_dot_product_attention(
                      heads(q_), heads(k_), heads(v_), is_causal=causal, scale=scale), sets)
        if tc:
            time_into(fwd, "fma_kernel", torch,
                      lambda q_, k_, v_, *_: fma_forward(
                          torch, q_, k_, v_, n_head, scale, causal, return_lse=True), sets)
        emit(fwd)
        # five T x T x hd products over the unmasked pairs; the bound at the
        # rate of the input type (bf16: tensor cores), and beside it at the
        # f32 FMA rate the FMA family runs on
        flops = 10 * b * n_head * pairs * hd
        n_bytes = 8 * b * t * d * elem + 4 * b * n_head * t
        bwd = dict(phase="kernels", kernel="fused_attention_backward", shape=[b, t, d],
                   n_head=n_head, causal=causal, dtype=dname, family=family, max_abs_err=max(errs),
                   dq_err=errs[0], dk_err=errs[1], dv_err=errs[2], tol=f"{atol} + {rtol} |ref|",
                   bit_reproducible=reproducible, gflop=flops / 1e9,
                   bound_ms_f32_fma=bound(n_bytes, flops, "float32")[0])
        bwd["bound_ms"], bwd["bound_by"] = bound(n_bytes, flops, dname)
        time_into(bwd, "kernel", torch,
                  lambda *a: fused_attention_backward(*a, n_head, scale, causal), sets, iters=10)
        time_into(bwd, "plain", torch,
                  lambda *a: fused_attention_backward_plain(*a, n_head, scale, causal), sets,
                  iters=10)
        lib_sets = []
        for q_, k_, v_, _, _, dy_ in sets:
            leaves = tuple(heads(z).detach().requires_grad_() for z in (q_, k_, v_))
            lib_sets.append((F.scaled_dot_product_attention(*leaves, is_causal=causal,
                                                            scale=scale), leaves, heads(dy_)))
        time_into(bwd, "library", torch,
                  lambda y_, leaves, dy_: torch.autograd.grad(y_, leaves, dy_, retain_graph=True),
                  lib_sets, iters=10)
        if tc:
            time_into(bwd, "fma_kernel", torch,
                      lambda *a: fma_backward(torch, *a, n_head, scale, causal), sets, iters=10)
        del lib_sets
        emit(bwd)
        require(ok_y and ok_lse, f"fused_attention_forward with lse disagrees at "
                                 f"{fwd['shape']}: y {err_y} lse {err_lse}")
        require(all(oks), f"fused_attention_backward disagrees at {bwd['shape']} {dname}: {errs}")
        require(reproducible, "fused_attention_backward is not bit-reproducible")
        fwd_cases.append(fwd)
        bwd_cases.append(bwd)

        # the same shape with dropout: forward (with lse) and backward against the plain
        # versions at the same tolerances, the backward twice; times at rate 0.1 beside
        # SDPA's with dropout_p (forward, and backward through autograd)
        dfwd, dbwd = dict(fwd, dropout_err={}), dict(bwd, dropout_err={})
        ok_all, repro_all = True, True
        for rate in DROPOUT_RATES:
            yd, lsed = fused_attention_forward(q, k, v, n_head, scale, causal, rate, True,
                                               DROPOUT_SEED)
            yd_ref, lsed_ref = fused_attention_forward_plain(q, k, v, n_head, scale, causal, True,
                                                             rate, DROPOUT_SEED)
            out = fused_attention_backward(q, k, v, yd, lsed, dy, n_head, scale, causal, rate,
                                           DROPOUT_SEED)
            again = fused_attention_backward(q, k, v, yd, lsed, dy, n_head, scale, causal, rate,
                                             DROPOUT_SEED)
            ref = fused_attention_backward_plain(q, k, v, yd_ref, lsed_ref, dy, n_head, scale,
                                                 causal, rate, DROPOUT_SEED)
            torch.cuda.synchronize()
            e_y, o_y = close(yd, yd_ref, atol, rtol)
            e_l, o_l = close(lsed, lsed_ref, 1e-4)
            e_g, o_g = zip(*(close(o, r, atol, rtol) for o, r in zip(out, ref)))
            ok_all &= o_y and o_l and all(o_g) and bool(torch.equal(lsed, lse))
            repro_all &= all(torch.equal(a_, b_) for a_, b_ in zip(out, again))
            dfwd["dropout_err"][str(rate)] = max(e_y, e_l)
            dbwd["dropout_err"][str(rate)] = max(e_g)
            del yd, lsed, yd_ref, lsed_ref, out, again, ref
        rate = DROPOUT_RATES[0]
        dsets = []
        for q_, k_, v_, _, _, dy_ in sets:
            y_, lse_ = fused_attention_forward(q_, k_, v_, n_head, scale, causal, rate, True,
                                               DROPOUT_SEED)
            dsets.append((q_, k_, v_, y_, lse_, dy_))
        del sets
        dfwd.update(rate=rate, max_abs_err=max(dfwd["dropout_err"].values()))
        dbwd.update(rate=rate, max_abs_err=max(dbwd["dropout_err"].values()),
                    bit_reproducible=repro_all)
        time_into(dfwd, "kernel", torch,
                  lambda q_, k_, v_, *_: fused_attention_forward(
                      q_, k_, v_, n_head, scale, causal, rate, True, DROPOUT_SEED), dsets)
        time_into(dfwd, "plain", torch,
                  lambda q_, k_, v_, *_: fused_attention_forward_plain(
                      q_, k_, v_, n_head, scale, causal, True, rate, DROPOUT_SEED), dsets, iters=5)
        time_into(dfwd, "library", torch,
                  lambda q_, k_, v_, *_: F.scaled_dot_product_attention(
                      heads(q_), heads(k_), heads(v_), dropout_p=rate, is_causal=causal,
                      scale=scale), dsets)
        time_into(dbwd, "kernel", torch,
                  lambda *a: fused_attention_backward(
                      *a, n_head, scale, causal, rate, DROPOUT_SEED), dsets, iters=10)
        time_into(dbwd, "plain", torch,
                  lambda *a: fused_attention_backward_plain(
                      *a, n_head, scale, causal, rate, DROPOUT_SEED), dsets, iters=5)
        lib_sets = []
        for q_, k_, v_, _, _, dy_ in dsets:
            leaves = tuple(heads(z).detach().requires_grad_() for z in (q_, k_, v_))
            lib_sets.append((F.scaled_dot_product_attention(
                *leaves, dropout_p=rate, is_causal=causal, scale=scale), leaves, heads(dy_)))
        time_into(dbwd, "library", torch,
                  lambda y_, leaves, dy_: torch.autograd.grad(y_, leaves, dy_, retain_graph=True),
                  lib_sets, iters=10)
        if tc:
            time_into(dfwd, "fma_kernel", torch,
                      lambda q_, k_, v_, *_: fma_forward(
                          torch, q_, k_, v_, n_head, scale, causal, rate, True, DROPOUT_SEED),
                      dsets)
            time_into(dbwd, "fma_kernel", torch,
                      lambda *a: fma_backward(torch, *a, n_head, scale, causal, rate, DROPOUT_SEED),
                      dsets, iters=10)
        del lib_sets, dsets
        emit(dfwd)
        emit(dbwd)
        require(ok_all, f"attention with dropout disagrees with its plain version at "
                        f"{bwd['shape']} {dname}: forward {dfwd['dropout_err']} backward "
                        f"{dbwd['dropout_err']}")
        require(repro_all, "fused_attention_backward with dropout is not bit-reproducible")
        drop_fwd_cases.append(dfwd)
        drop_bwd_cases.append(dbwd)
    return fwd_cases, bwd_cases, drop_fwd_cases, drop_bwd_cases


def check_fused_adamw(torch, dev):
    from dynamicvectorquantization_torch.ops.fused_adamw import (
        adamw_scalars, fused_adamw_step, fused_adamw_step_plain)

    tol = 1e-6  # f32 p, m, v after two updates; FMA contraction moves the last bit
    lr = 5e-4
    g = torch.Generator(device=dev).manual_seed(9)
    cases = []
    # an MLP weight of the p6c18 blocks, and an odd-length 1-D leaf (scalar tail)
    for shape in ((4096, 1024), (1027,)):
        for gdtype in (torch.bfloat16, torch.float32):
            for wd in (0.0, 0.01):
                p0 = 0.02 * torch.randn(shape, generator=g, device=dev)
                state = [[p0.clone(), torch.zeros_like(p0), torch.zeros_like(p0),
                          torch.empty_like(p0, dtype=torch.bfloat16)] for _ in range(2)]
                errs, copy_equal = [], True
                for count in range(2):
                    grad = (1e-3 * torch.randn(shape, generator=g, device=dev)).to(gdtype)
                    scal = adamw_scalars(count, lr)
                    for (p, m, v, c), fn in zip(state, (fused_adamw_step, fused_adamw_step_plain)):
                        fn(grad, p, m, v, *scal, wd=wd, copy=c)
                    torch.cuda.synchronize()
                    errs += [close(a_, b_, tol)[0] for a_, b_ in zip(state[0][:3], state[1][:3])]
                    copy_equal &= bool(torch.equal(state[0][3], state[0][0].to(torch.bfloat16)))
                case = dict(phase="kernels", kernel="fused_adamw", shape=list(shape),
                            grad_dtype=str(gdtype).split(".")[-1], weight_decay=wd, steps=2,
                            max_abs_err=max(errs), tol=tol, copy_bit_equal=copy_equal)
                cases.append(case)
                require(max(errs) <= tol and copy_equal, f"fused_adamw disagrees: {case}")
    emit(dict(phase="kernels", kernel="fused_adamw", cases=cases))

    # time the big leaf with a bf16 gradient and the bf16 copy, as a mixed-precision step runs it
    shape = (4096, 1024)
    n = shape[0] * shape[1]
    n_bytes = n * (2 + 12 + 12 + 2)
    sets = []
    for _ in range(n_sets(n_bytes)):
        p = 0.02 * torch.randn(shape, generator=g, device=dev)
        sets.append(((1e-3 * torch.randn(shape, generator=g, device=dev)).to(torch.bfloat16), p,
                     torch.zeros_like(p), torch.zeros_like(p),
                     torch.empty_like(p, dtype=torch.bfloat16)))
    scal = adamw_scalars(0, lr)
    timed = dict(phase="kernels", kernel="fused_adamw", shape=list(shape), grad_dtype="bfloat16",
                 weight_decay=0.01, with_bf16_copy=True, bytes=n_bytes,
                 max_abs_err=max(c["max_abs_err"] for c in cases), tol=tol)
    timed["bound_ms"], timed["bound_by"] = bound(n_bytes, 15 * n, "float32")
    time_into(timed, "kernel", torch,
              lambda g_, p, m, v, c: fused_adamw_step(g_, p, m, v, *scal, wd=0.01, copy=c), sets)
    time_into(timed, "plain", torch,
              lambda g_, p, m, v, c: fused_adamw_step_plain(g_, p, m, v, *scal, wd=0.01, copy=c),
              sets)
    # the library's fused AdamW takes f32 gradients and writes no bf16 copy
    opts = []
    for g_, p, _, _, _ in sets:
        param = torch.nn.Parameter(p.clone())
        param.grad = g_.float()
        opts.append((torch.optim.AdamW([param], lr=lr, betas=(0.9, 0.95), eps=1e-8,
                                       weight_decay=0.01, fused=True),))
    time_into(timed, "library", torch, lambda o: o.step(), opts)
    del opts, sets
    emit(timed)
    return timed


def teacher_forced_decode(torch, model, dev, steps=64, batch=8):
    """Kernel path vs plain path on the same full-width bf16 model."""
    import dynamicvectorquantization_torch.nn.transformer as tfm
    from dynamicvectorquantization_torch.ops.kv_int8 import decode_attention_int8_plain

    gpt = model.transformer
    tol = 0.1  # bf16 activations: ~2^-8 relative per op over 24 layers; logit std ~0.6
    g = torch.Generator(device=dev).manual_seed(2)
    tokens = torch.randint(0, 1024, (3, batch, steps + 1), generator=g, device=dev)

    def run(n):
        pos_cache, content_cache = gpt.make_caches(batch, 1284, torch.bfloat16, dev)
        logits = []
        for i in range(n):
            seg = torch.zeros(batch, dtype=torch.long, device=dev)
            x = gpt.embed_input_token(tokens[0, :, i], tokens[1, :, i] % 256, seg, i, False)
            hidden, pl = gpt.position_step(x, pos_cache, i)
            cl = gpt.content_step(hidden, tokens[2, :, i + 1] % 256, False, content_cache, i)
            logits.append(torch.cat([pl, cl], dim=-1).float())
        return torch.stack(logits)

    with torch.inference_mode():
        t0 = time.perf_counter()
        kernel = run(steps)
        torch.cuda.synchronize()
        kernel_s = time.perf_counter() - t0
        saved = tfm.decode_attention_int8
        tfm.decode_attention_int8 = decode_attention_int8_plain
        try:
            plain = run(steps)
        finally:
            tfm.decode_attention_int8 = saved
        windows = []
        for _ in range(4):  # host-clock step time over windows of 16 steps
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run(16)
            torch.cuda.synchronize()
            windows.append((time.perf_counter() - t0) / 16 * 1e3)
        prof = profile_device_time(torch, lambda: run(16))
    diff = (kernel - plain).abs()
    step_ms = spread(windows)["median"]
    busy_ms = prof["device_busy_ms"] and prof["device_busy_ms"] / 16
    res = dict(phase="decode", config=P6C18, kv_cache_dtype="int8", dtype="bfloat16",
               batch=batch, steps=steps, max_logit_diff=diff.max().item(),
               mean_logit_diff=diff.mean().item(), logit_std=plain.std().item(), tol=tol,
               kernel_path_s=kernel_s, step_ms=step_ms,
               step_ms_spread=dict(spread(windows), steps_per_window=16),
               device_busy_ms_per_step=busy_ms,
               device_idle_share=busy_ms and 1.0 - busy_ms / step_ms,
               device_ops_per_step=prof["device_ops"] / 16, top_kernels=prof["top"])
    emit(res)
    require(bool(torch.isfinite(kernel).all()), "non-finite logits on the kernel path")
    require(res["max_logit_diff"] <= tol, f"kernel vs plain decode: {res['max_logit_diff']}")
    return res


def profile_device_time(torch, fn, n_top=8, groups=None):
    """Device busy time of one call of `fn` from a torch.profiler trace, and
    the `n_top` kernels that take most of it (ms summed over the call); with
    `groups` ({label: part of a kernel name}) also the ms of each group."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()  # warm-up outside the trace
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name = {}
    launches = 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
            launches += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:n_top]
    busy = sum(by_name.values())
    grouped = {label: sum(ms for name, ms in by_name.items() if part in name)
               for label, part in (groups or {}).items()}
    return {"device_busy_ms": busy if busy > 0 else None,  # None: the trace held no device time
            "device_ops": launches, "top": [[name[:80], ms] for name, ms in top],
            "groups": grouped}


def wrappers():
    """name -> the wrapper whose `.launches` counts that kernel's launches."""
    from dynamicvectorquantization_torch.ops.attention import (
        fused_attention_backward, fused_attention_forward)
    from dynamicvectorquantization_torch.ops.downsample import strided_conv3x3_down
    from dynamicvectorquantization_torch.ops.entropy import patch_entropy
    from dynamicvectorquantization_torch.ops.fused_adamw import fused_adamw_step
    from dynamicvectorquantization_torch.ops.kv_int8 import decode_attention_int8
    from dynamicvectorquantization_torch.ops.layernorm import layernorm_backward, layernorm_forward
    from dynamicvectorquantization_torch.ops.vq import nearest_codes, nearest_codes_with_stats

    return {"vq_nearest_train": nearest_codes_with_stats,
            "decode_attention_int8": decode_attention_int8,
            "fused_attention_forward": fused_attention_forward,
            "fused_attention_backward": fused_attention_backward,
            "layernorm_forward": layernorm_forward, "layernorm_backward": layernorm_backward,
            "fused_adamw": fused_adamw_step,
            "vq_nearest": nearest_codes, "patch_entropy": patch_entropy,
            "strided_conv3x3_down": strided_conv3x3_down}


ATTENTION = ("fused_attention_forward", "fused_attention_backward")


def reset_launches():
    for fn in wrappers().values():
        for attr in ("launches", "tc_launches", "fma_launches", "dropout_launches"):
            if hasattr(fn, attr):
                setattr(fn, attr, 0)


def read_launches():
    """Launches per kernel since `reset_launches`. The attention wrappers
    have two kernel families: `<name>` counts the FMA family's launches,
    `<name>_tc` the tensor-core family's, and `<name>_dropout` those of
    both that drew a dropout mask."""
    counts = {name: fn.launches for name, fn in wrappers().items()}
    for name in ATTENTION:
        fn = wrappers()[name]
        counts[name] = fn.fma_launches
        counts[f"{name}_tc"] = fn.tc_launches
        counts[f"{name}_dropout"] = fn.dropout_launches
    return counts


@contextlib.contextmanager
def plain_encode_path():
    """The DQ-VAE's kernel wrappers (entropy, downsample, attention, both
    nearest-code searches) swapped for their plain versions, which autograd
    differentiates, so the same model encodes and trains without the kernels
    on the card."""
    import dynamicvectorquantization_torch.models.dqvae as dqvae
    import dynamicvectorquantization_torch.nn.blocks as blocks
    import dynamicvectorquantization_torch.ops.vq as vq
    from dynamicvectorquantization_torch.ops.attention import fused_attention_forward_plain
    from dynamicvectorquantization_torch.ops.downsample import strided_conv3x3_down_plain
    from dynamicvectorquantization_torch.ops.entropy import patch_entropy_plain

    saved = (dqvae.patch_entropy, blocks.strided_conv3x3_down, blocks.fused_causal_attention,
             vq.nearest_codes, vq.nearest_codes_with_stats)
    dqvae.patch_entropy = patch_entropy_plain
    blocks.strided_conv3x3_down = strided_conv3x3_down_plain
    blocks.fused_causal_attention = lambda q, k, v, n_head, scale=None, causal=True: \
        fused_attention_forward_plain(q, k, v, n_head, scale, causal)
    vq.nearest_codes = lambda x, cb, use_pallas=None: vq.nearest_codes_plain(x, cb)
    vq.nearest_codes_with_stats = lambda x, cb, use_pallas=None: \
        vq.nearest_codes_with_stats_plain(x, cb)
    try:
        yield
    finally:
        (dqvae.patch_entropy, blocks.strided_conv3x3_down, blocks.fused_causal_attention,
         vq.nearest_codes, vq.nearest_codes_with_stats) = saved


def encode(torch, model, dev, card, batch=8, reps=5):
    """Full-width p6c18 first stage (f32) on a seeded batch: `encode_to_z`
    and `forward` through the kernels and through the plain versions."""
    fs = model.first_stage_model
    ent_tol, rec_tol = 1e-5, 1e-3  # f32 entropy sums; f32 decoder outputs |y| < ~10
    g = torch.Generator(device=dev).manual_seed(6)
    x = smooth_and_noisy_images(torch, dev, g, b=batch, size=fs.encoder.resolution)
    feats = {}
    hook = fs.quant_conv.register_forward_hook(lambda m, i, o: feats.__setitem__("h", o))
    with torch.inference_mode():
        torch.cuda.synchronize()
        reset_launches()
        quant, streams = model.encode_to_z(x)
        torch.cuda.synchronize()
        launches = read_launches()
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            model.encode_to_z(x)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        encode_s = spread(times)["median"]
        prof = profile_device_time(torch, lambda: model.encode_to_z(x))

        _, _, info, grain, _, ent = fs.encode(x)
        h_k = feats["h"]
        dec, _, _, _, _ = fs(x)
        back = model.decode_to_img(streams["coarse_content"], streams["fine_content"],
                                   streams["coarse_position"], streams["fine_position"])
        with plain_encode_path():
            _, streams_p = model.encode_to_z(x)
            _, _, info_p, grain_p, _, ent_p = fs.encode(x)
            h_p = feats["h"]
            dec_p, _, _, _, _ = fs(x)
    hook.remove()

    # grain cells may differ only where the plain entropy sits at the threshold
    threshold = fs.encoder.router.threshold
    grain_diff = grain != grain_p
    grain_ok = bool(((ent_p - threshold).abs()[grain_diff] <= ent_tol).all())
    # codes may differ (in cells of one grain) only at f32 near-ties, widened
    # by what the two paths' feature difference can move a score gap
    same_grain = grain.eq(grain_p).repeat_interleave(2, 1).repeat_interleave(2, 2)
    code, code_p = info[2], info_p[2]
    code_diff = (code != code_p) & same_grain
    cb = fs.quantize.codebook.weight[:-1].double()
    xk = h_k.permute(0, 2, 3, 1)[code_diff].double()
    xp = h_p.permute(0, 2, 3, 1)[code_diff].double()
    ca, cbb = cb[code[code_diff]], cb[code_p[code_diff]]
    gap = ((ca * ca).sum(1) - 2 * (xp * ca).sum(1)) - ((cbb * cbb).sum(1) - 2 * (xp * cbb).sum(1))
    allowed = (near_tie_bound(xp.norm(dim=1), ca.norm(dim=1), cbb.norm(dim=1), cb.shape[1])
               + 2 * (xk - xp).norm(dim=1) * (ca - cbb).norm(dim=1))
    codes_ok = bool((gap.abs() <= allowed).all())
    streams_equal = all(torch.equal(streams[k], streams_p[k]) for k in streams)
    rec_diff = (dec - dec_p).abs().max().item()
    round_trip = (back - dec).abs().max().item()
    busy_ms = prof["device_busy_ms"]
    encode_ms = encode_s * 1e3
    res = dict(phase="encode", config=P6C18, dtype="float32", batch=batch,
               image=list(x.shape[1:]), fine_share=grain.float().mean().item(),
               entropy_threshold=threshold, entropy_max_abs_diff=(ent - ent_p).abs().max().item(),
               streams_equal=streams_equal, grain_cells_differ=int(grain_diff.sum()),
               grain_diffs_at_threshold=grain_ok, codes_differ=int(code_diff.sum()),
               code_diffs_near_ties=codes_ok, rec_max_abs_diff=rec_diff, rec_tol=rec_tol,
               round_trip_max_abs_diff=round_trip, stream_lengths={
                   k: int((v != model.permuter.content_pad_code).sum()) for k, v in streams.items()
                   if k.endswith("content")},
               launches=launches, encode_s=encode_s, encode_s_spread=spread(times),
               images_per_s=batch / encode_s,
               device_busy_ms=busy_ms, device_idle_share=busy_ms and 1.0 - busy_ms / encode_ms,
               device_ops=prof["device_ops"], top_kernels=prof["top"], card=card)
    emit(res)
    hw = model.permuter.fine_hw
    require(quant.shape == (batch, hw, hw, fs.quantize.codebook_dim)
            and bool(torch.isfinite(dec).all()),
            "encode output of the wrong shape or not finite")
    require(0.0 < res["fine_share"] < 1.0, "the batch should hold both grains")
    require(res["entropy_max_abs_diff"] <= ent_tol, "entropy kernel vs plain on the encode path")
    require(grain_ok, "a grain cell differs away from the entropy threshold")
    require(codes_ok, "a code differs beyond the f32 near-tie bound")
    require(rec_diff <= rec_tol or not streams_equal,
            f"reconstruction kernel vs plain with equal streams: {rec_diff}")
    require(round_trip <= rec_tol, f"decode_to_img(encode_to_z) vs forward: {round_trip}")
    for name, want in (("vq_nearest", 1), ("patch_entropy", 1), ("strided_conv3x3_down", 4),
                       ("fused_attention_forward", 6)):
        require(launches[name] == want,
                f"{name} launched {launches[name]} times per encode, expected {want}")
    return res


@contextlib.contextmanager
def plain_train_path():
    """The training path's kernel wrappers swapped for their plain versions
    (differentiated by autograd), so the same step runs without the kernels."""
    import dynamicvectorquantization_torch.nn.norm as norm
    import dynamicvectorquantization_torch.nn.transformer as tfm
    import dynamicvectorquantization_torch.train.stage2 as stage2
    from dynamicvectorquantization_torch.ops.attention import fused_attention_forward_plain
    from dynamicvectorquantization_torch.ops.fused_adamw import fused_adamw_step_plain

    saved = (norm.fused_layernorm, tfm.fused_causal_attention, stage2.fused_adamw_step)
    norm.fused_layernorm = norm.fused_layernorm_plain
    tfm.fused_causal_attention = lambda q, k, v, n_head, causal=True, rate=0.0, seed=None: \
        fused_attention_forward_plain(q, k, v, n_head, None, causal, False, rate, seed)
    stage2.fused_adamw_step = fused_adamw_step_plain
    try:
        yield
    finally:
        norm.fused_layernorm, tfm.fused_causal_attention, stage2.fused_adamw_step = saved


def set_dropout(gpt, embd, resid, attn=None):
    gpt.embd_pdrop = embd
    for mod in gpt.modules():
        if hasattr(mod, "resid_pdrop"):
            mod.resid_pdrop = resid
        if attn is not None and hasattr(mod, "attn_pdrop"):
            mod.attn_pdrop = attn


def train(torch, dev, card, batch=8, n_images=16, timed_steps=4):
    """Stage-2 training at full p6c18 width and depth on cached codes."""
    from dynamicvectorquantization_torch.config.yaml_config import load_config
    from dynamicvectorquantization_torch.train.stage2 import Stage2Trainer
    from dynamicvectorquantization_torch.utils.instantiate import instantiate_from_config

    config = load_config([P6C18])
    params = config["model"]["params"]
    tparams = params["transformer_config"]["params"]
    params["permuter_config"]["params"].update(TRAIN_CAPS)
    embd_pdrop, resid_pdrop = tparams["embd_pdrop"], tparams["resid_pdrop"]
    attn_pdrop = tparams["attn_pdrop"]  # as shipped: 0.1, drawn inside the attention kernels
    require(attn_pdrop > 0, "the shipped config trains with attention dropout")
    lr = config["model"]["learning_rate"]
    t0 = time.perf_counter()
    with torch.device(dev):
        model = instantiate_from_config(config["model"])
    model.init_weights(torch.Generator(device=dev).manual_seed(0))
    model.eval()
    trainer = Stage2Trainer(model, lr, warmup_steps=0, max_steps=10_000,
                            compute_dtype="bfloat16", device=dev)
    gpt = model.transformer
    load_s = time.perf_counter() - t0

    g = torch.Generator(device=dev).manual_seed(6)
    size = model.first_stage_model.encoder.resolution
    images = torch.cat([smooth_and_noisy_images(torch, dev, g, b=batch, size=size)
                        for _ in range(n_images // batch)])
    t0 = time.perf_counter()
    reset_launches()
    streams = trainer.encode_dataset(images.cpu().numpy(), batch=batch)
    encode_s = time.perf_counter() - t0
    encode_launches = read_launches()
    del images
    batches = [{k: v[i:i + batch] for k, v in streams.items()}
               for i in range(0, n_images, batch)]
    t_len = streams["coarse_content"].shape[1] + streams["fine_content"].shape[1] + 1
    require(t_len == TRAIN_T, f"training sequence length {t_len}, expected {TRAIN_T}")
    pad = model.permuter.content_pad_code
    tokens = int((streams["coarse_content"] != pad).sum() + (streams["fine_content"] != pad).sum())

    # (a) one step through the kernels against one through the plain versions, with the
    # shipped attention dropout: both paths derive the same seeds from (base seed, step 0,
    # microbatch 0, layer) and so draw the same masks
    def snapshot():
        return ({k: v.clone() for k, v in trainer.masters.items()},
                {k: p.detach().clone() for k, p in trainer.params.items()})

    def restore(state):
        masters, working = state
        for k in trainer.masters:
            trainer.masters[k].copy_(masters[k])
            trainer.params[k].data.copy_(working[k])
            trainer.m[k].zero_()
            trainer.v[k].zero_()
        trainer.count = 0

    set_dropout(gpt, 0.0, 0.0)
    start = snapshot()
    watched = ["content_emb.weight", "position_transformer.0.attn.query.weight",
               "position_transformer.0.ln1.weight",
               f"content_transformer.{gpt.content_layer - 1}.mlp.2.weight",
               f"content_transformer.{gpt.content_layer // 2}.ln2.bias", "content_head.1.weight"]
    results = {}
    for path, ctx in (("kernel", contextlib.nullcontext()), ("plain", plain_train_path())):
        restore(start)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with ctx:
            logs, grads = trainer.compute_grads(batches[0])
            kept = {k: grads[k].float() for k in watched}
            trainer.apply_update(grads)
            del grads
        torch.cuda.synchronize()
        results[path] = dict(logs={k: float(v) for k, v in logs.items()}, grads=kept,
                             after={k: v.clone() for k, v in trainer.masters.items()},
                             peak_gb=torch.cuda.max_memory_allocated() / 2 ** 30)
    kr, pr = results["kernel"], results["plain"]
    loss_rel = max(abs(kr["logs"][k] - pr["logs"][k]) / abs(pr["logs"][k]) for k in pr["logs"])
    grad_rel = {k: ((kr["grads"][k] - pr["grads"][k]).norm() / pr["grads"][k].norm()).item()
                for k in watched}
    n_params = sum(v.numel() for v in trainer.masters.values())
    delta_max = max((kr["after"][k] - pr["after"][k]).abs().max().item() for k in kr["after"])
    delta_mean = sum((kr["after"][k] - pr["after"][k]).abs().sum().item()
                     for k in kr["after"]) / n_params
    moved = max((kr["after"][k] - start[0][k]).abs().max().item() for k in kr["after"])
    pad_rows_frozen = all(torch.equal(kr["after"][k][row], start[0][k][row])
                          for k, row in trainer.pad_rows.items())
    # bf16 activations differ by ~2^-8 relative per op between the two paths and
    # 24 layers compound it; Adam's first update is lr * g / |g|, so a parameter
    # differs by at most 2 lr (+ decay), and only where the noise flips g's sign
    loss_tol, grad_tol, delta_max_tol, delta_mean_tol = 2e-2, 0.1, 2.02 * lr, 0.1 * lr
    compare = dict(phase="train", step="kernel_vs_plain", config=P6C18, attn_pdrop=attn_pdrop,
                   dropout="attention only (embedding and residual off)",
                   dtype="bfloat16 over f32 masters", batch=batch, seq_len=t_len,
                   lr=lr, params=n_params, losses_kernel=kr["logs"], losses_plain=pr["logs"],
                   loss_max_rel_diff=loss_rel, loss_tol=loss_tol, grad_rel_l2_diff=grad_rel,
                   grad_tol=grad_tol, param_max_abs_diff=delta_max,
                   param_max_tol=delta_max_tol, param_mean_abs_diff=delta_mean,
                   param_mean_tol=delta_mean_tol, param_max_abs_update=moved,
                   pad_rows_frozen=pad_rows_frozen, peak_memory_gb_kernel=kr["peak_gb"],
                   peak_memory_gb_plain=pr["peak_gb"], card=card)
    emit(compare)
    require(all(math.isfinite(v) for v in kr["logs"].values()), "non-finite training loss")
    require(loss_rel <= loss_tol, f"training losses kernel vs plain: {loss_rel}")
    require(max(grad_rel.values()) <= grad_tol, f"gradients kernel vs plain: {grad_rel}")
    require(delta_max <= delta_max_tol and delta_mean <= delta_mean_tol,
            f"parameters after one step, kernel vs plain: max {delta_max} mean {delta_mean}")
    require(moved > 0 and pad_rows_frozen, "parameters did not move, or a pad row did")
    del results, kr, pr

    # (b) timed steps on the kernel path with all three shipped dropouts, the elementwise
    # ones from the trainer's own generator (re-seeded per step, as the loop runs it);
    # before them the same steps with attn_pdrop 0, the configuration timed before
    # in-kernel dropout existed, from the same state
    def timed(n, windows=3):
        """Host-clock ms per step over `windows` windows of `n` steps (the
        host runs ahead inside a window, as in training), and the losses."""
        per_step, losses_ = [], []
        for _ in range(windows):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pending = [trainer.train_step(batches[i % len(batches)])["train_loss"]
                       for i in range(n)]
            torch.cuda.synchronize()
            per_step.append((time.perf_counter() - t0) / n * 1e3)
            losses_ += [float(v) for v in pending]
        return dict(spread(per_step), steps_per_window=n), losses_

    restore(start)
    set_dropout(gpt, embd_pdrop, resid_pdrop, 0.0)
    trainer.train_step(batches[0])  # warm-up step
    step_rate0, _ = timed(timed_steps)
    prof0 = profile_device_time(torch, lambda: trainer.train_step(batches[0]), n_top=4)

    restore(start)
    del start
    set_dropout(gpt, embd_pdrop, resid_pdrop, attn_pdrop)
    losses = [float(trainer.train_step(batches[0])["train_loss"])]  # warm-up step
    torch.cuda.synchronize()
    reset_launches()
    losses.append(float(trainer.train_step(batches[1])["train_loss"]))
    step_launches = read_launches()
    torch.cuda.reset_peak_memory_stats()
    step, more = timed(timed_steps)
    losses += more
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    prof = profile_device_time(
        torch, lambda: trainer.train_step(batches[0]), n_top=12)
    layers = gpt.position_layer + gpt.content_layer
    # bf16 at hd 128: every attention launch on the tensor-core family
    expected = {"fused_attention_forward_tc": layers, "fused_attention_backward_tc": layers,
                "fused_attention_forward_dropout": layers,
                "fused_attention_backward_dropout": layers,
                "fused_attention_forward": 0, "fused_attention_backward": 0,
                "layernorm_forward": 2 * layers + 2, "layernorm_backward": 2 * layers + 2,
                "fused_adamw": len(trainer.params)}
    step_ms = step["median"]
    busy_ms = prof["device_busy_ms"]
    res = dict(phase="train", step="timed", config=P6C18, attn_pdrop=attn_pdrop,
               step_ms_attn_pdrop_0=step_rate0["median"], step_ms_spread_attn_pdrop_0=step_rate0,
               device_busy_ms_attn_pdrop_0=prof0["device_busy_ms"], embd_pdrop=embd_pdrop,
               resid_pdrop=resid_pdrop, dtype="bfloat16 over f32 masters", batch=batch,
               seq_len=t_len, stream_caps=TRAIN_CAPS, images=n_images, real_tokens=tokens,
               layers=layers, params=n_params, parameter_leaves=len(trainer.params), lr=lr,
               load_s=spread([load_s]), encode_dataset_s=spread([encode_s]),
               encode_launches=encode_launches,
               losses=losses, launches_per_step=step_launches, expected_launches=expected,
               timed_steps=timed_steps, step_ms=step_ms, step_ms_spread=step,
               images_per_s=batch / step_ms * 1e3,
               device_busy_ms=busy_ms, device_idle_share=busy_ms and 1.0 - busy_ms / step_ms,
               device_ops=prof["device_ops"], top_kernels=prof["top"],
               peak_memory_gb=peak_gb, card=card)
    emit(res)
    require(all(math.isfinite(v) for v in losses), f"non-finite training loss: {losses}")
    require(losses[-1] < losses[0], f"the training loss did not fall: {losses}")
    for name, want in expected.items():
        require(step_launches[name] == want,
                f"{name} launched {step_launches[name]} times per train step, expected {want}")
    return res


def train1(torch, dev, card, batch=8, timed_steps=3):
    """Stage-1 (DQ-VAE + GAN) training of the shipped dual-grain config at
    full width and depth, f32."""
    from dynamicvectorquantization_torch.config.yaml_config import load_config
    from dynamicvectorquantization_torch.nn.blocks import AttnBlock
    from dynamicvectorquantization_torch.train.stage1 import B1, Stage1Trainer
    from dynamicvectorquantization_torch.utils.instantiate import instantiate_from_config

    config = load_config([STAGE1])["model"]
    lr = config["base_learning_rate"] * batch  # the reference's base_learning_rate x batch
    t0 = time.perf_counter()
    with torch.device(dev):
        model = instantiate_from_config(config)
    trainer = Stage1Trainer(model, lr, warmup_steps=0, max_steps=10_000, device=dev)
    trainer.init_state(torch.Generator(device=dev).manual_seed(0))
    load_s = time.perf_counter() - t0
    loss = model.loss
    n_attn = sum(isinstance(m, AttnBlock) for m in (*model.encoder.modules(),
                                                     *model.decoder.modules()))
    g = torch.Generator(device=dev).manual_seed(6)
    x = smooth_and_noisy_images(torch, dev, g, b=batch, size=model.encoder.resolution)
    ema_names = ("weight", "cluster_size_ema", "embed_ema")

    start = {k: v.clone() for k, v in model.state_dict().items()}

    def restore():
        model.load_state_dict(start)
        trainer.init_state()

    # (a) one step through the kernels against one through the plain versions
    watched = ["encoder.conv_in.weight", "encoder.down.3.attn.0.q.weight", "quant_conv.weight",
               "decoder.conv_out.weight"]
    results = {}
    for path, ctx in (("kernel", contextlib.nullcontext()), ("again", contextlib.nullcontext()),
                      ("plain", plain_encode_path())):
        restore()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with ctx:
            logs = trainer.train_step(x, torch.Generator(device=dev).manual_seed(11))
        torch.cuda.synchronize()
        # the optimizers started from zero moments: m = (1 - b1) g
        grads = {k: trainer.ae_opt.m[k] / (1.0 - B1) for k in watched}
        grads["loss.discriminator.main.0.weight"] = trainer.disc_opt.m["main.0.weight"] / (1.0 - B1)
        results[path] = dict(
            logs={k: float(v) for k, v in logs.items()},
            grads={k: v.clone() for k, v in grads.items()},
            ema={k: getattr(model.quantize.codebook, k).clone() for k in ema_names},
            peak_gb=torch.cuda.max_memory_allocated() / 2 ** 30)
    kr, pr = results["kernel"], results["plain"]
    log_rel = {k: abs(kr["logs"][k] - v) / max(abs(v), 1e-6) for k, v in pr["logs"].items()}
    grad_rel = {k: ((kr["grads"][k] - v).norm() / v.norm()).item() for k, v in pr["grads"].items()}
    # the kernel path against itself: what cuDNN's own run-to-run differences come to
    grad_noise = {k: ((results["again"]["grads"][k] - v).norm() / v.norm()).item()
                  for k, v in kr["grads"].items()}
    restarted = [r["ema"]["cluster_size_ema"] == 1.0 for r in (kr, pr)]
    restart_differs = int((restarted[0] != restarted[1]).sum())
    ema_err = {k: ((kr["ema"][k] - pr["ema"][k]).abs().max() / pr["ema"][k].abs().max()).item()
               for k in ema_names}
    # f32 throughout. The two paths differ in summation order inside four kernels, at
    # 1e-6; the VGG16 max-pools, the ReLU / LeakyReLU kinks and the hinge turn that into
    # discrete changes of the gradient's route, and the discriminator's gradient is taken
    # after an Adam step that moves every autoencoder parameter by +-lr whatever its
    # gradient's size, so a sign decided by noise moves the reconstruction it sees
    log_tol, grad_tol, ema_tol = 1e-3, 5e-2, 1e-3
    compare = dict(phase="train1", step="kernel_vs_plain", config=STAGE1, dtype="float32",
                   batch=batch, lr=lr, logs_kernel=kr["logs"], logs_plain=pr["logs"],
                   log_max_rel_diff=max(log_rel.values()), log_tol=log_tol,
                   grad_rel_l2_diff=grad_rel, grad_tol=grad_tol,
                   grad_rel_l2_diff_kernel_path_twice=grad_noise, ema_max_rel_diff=ema_err,
                   ema_tol=ema_tol, codes_restarted=int(restarted[0].sum()),
                   restart_decisions_differ=restart_differs,
                   peak_memory_gb_kernel=kr["peak_gb"], peak_memory_gb_plain=pr["peak_gb"],
                   card=card)
    emit(compare)
    require(all(math.isfinite(v) for v in kr["logs"].values()), "non-finite stage-1 log")
    require(max(log_rel.values()) <= log_tol, f"stage-1 logs kernel vs plain: {log_rel}")
    require(max(grad_rel.values()) <= grad_tol, f"stage-1 gradients kernel vs plain: {grad_rel}")
    require(restart_differs == 0 and max(ema_err.values()) <= ema_tol,
            f"EMA codebook kernel vs plain: {ema_err}, {restart_differs} restart decisions differ")
    del results, kr, pr

    # (b) timed steps on the kernel path, (c) launches per step, (d) what moved
    restore()
    updates = []
    ema_update = model.quantize._ema_update
    model.quantize._ema_update = lambda *a, **k: (updates.append(1), ema_update(*a, **k))[1]
    gen = torch.Generator(device=dev).manual_seed(13)
    all_logs = [trainer.train_step(x, gen)]  # warm-up step
    torch.cuda.synchronize()
    reset_launches()
    del updates[:]
    all_logs.append(trainer.train_step(x, gen))
    torch.cuda.synchronize()
    step_launches, ema_updates_per_step = read_launches(), len(updates)
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(timed_steps):  # a stage-1 step is device-bound: a sync per step costs little
        t0 = time.perf_counter()
        all_logs.append(trainer.train_step(x, gen))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    step_s = spread(times)["median"]
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    prof = profile_device_time(
        torch, lambda: trainer.train_step(x, gen), n_top=14,
        groups={"fused_attention_forward": "fused_attention_fwd_kernel",
                "fused_attention_backward": "attention_bwd_", "attention_delta": "attention_delta",
                "strided_conv3x3_down": "strided_conv_down", "vq_nearest_train": "vq_",
                "patch_entropy": "patch_entropy", "fft_convolutions": "fft",
                "implicit_gemm_convolutions": "implicit_gemm", "xmma_gemm": "xmma_gemm",
                "elementwise": "elementwise_kernel"})
    steps_run = trainer.step
    del updates[:]
    reset_launches()
    val = {k: float(v) for k, v in trainer.eval_step(x).items()}
    eval_launches = read_launches()
    model.quantize._ema_update = ema_update
    after = model.state_dict()
    moved = {name: max((after[k] - start[k]).abs().max().item() for k in after
                       if k.startswith(prefix) and after[k].is_floating_point())
             for name, prefix in (("autoencoder", ("encoder.", "decoder.", "quant_conv.",
                                                   "post_quant_conv.")),
                                  ("discriminator", "loss.discriminator."),
                                  ("codebook", "quantize.codebook."))}
    lpips_frozen = all(torch.equal(after[k], start[k]) for k in after
                       if k.startswith("loss.perceptual_loss."))
    logs = [{k: float(v) for k, v in step.items()} for step in all_logs]
    expected = {"vq_nearest_train": 2, "vq_nearest": 0, "patch_entropy": 2,
                "strided_conv3x3_down": 8, "fused_attention_forward": 2 * n_attn,
                "fused_attention_backward": n_attn}
    step_ms = step_s * 1e3
    busy_ms = prof["device_busy_ms"]
    res = dict(phase="train1", step="timed", config=STAGE1, dtype="float32", batch=batch, lr=lr,
               image=list(x.shape[1:]), attn_blocks=n_attn,
               params_autoencoder=sum(p.numel() for p in trainer.ae_params.values()),
               params_discriminator=sum(p.numel() for p in trainer.disc_params.values()),
               params_lpips=sum(p.numel() for p in loss.perceptual_loss.parameters()),
               load_s=spread([load_s]), steps_run=steps_run, logs_first=logs[0],
               logs_last=logs[-1],
               aeloss=[step["train_aeloss"] for step in logs],
               d_weight=[step["train_d_weight"] for step in logs],
               launches_per_step=step_launches, expected_launches=expected,
               ema_updates_per_step=ema_updates_per_step, eval_step=val,
               eval_launches={k: v for k, v in eval_launches.items() if v},
               max_abs_update=moved, lpips_frozen=lpips_frozen, timed_steps=timed_steps,
               step_ms=step_ms, step_ms_spread=spread([t * 1e3 for t in times]),
               images_per_s=batch / step_s, device_busy_ms=busy_ms,
               device_idle_share=busy_ms and 1.0 - busy_ms / step_ms,
               device_ops=prof["device_ops"], top_kernels=prof["top"],
               device_ms_by_kernel_group=prof["groups"], peak_memory_gb=peak_gb, card=card)

    # the loss side alone, forward and backward on this batch (CUDA events, 3 calls each):
    # LPIPS to the reconstruction; the discriminator's own objective to its parameters
    def event_ms(fn, n=3):
        fn()
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(n + 1)]
        marks[0].record()
        for m in marks[1:]:
            fn()
            m.record()
        marks[-1].synchronize()
        return spread([a.elapsed_time(b) for a, b in zip(marks, marks[1:])])

    xr = (0.9 * x).requires_grad_()
    disc_leaves = list(trainer.disc_params.values())
    res["lpips_forward_backward_ms"] = event_ms(
        lambda: torch.autograd.grad(loss.nll(x, xr)[0], xr))
    res["d_loss_forward_backward_ms"] = event_ms(
        lambda: torch.autograd.grad(loss.d_loss(x, xr, 0, train=True)[0], disc_leaves))
    emit(res)
    require(all(math.isfinite(v) for step in logs for v in step.values())
            and all(math.isfinite(v) for v in val.values()), "non-finite stage-1 log")
    require(all(step["train_d_weight"] <= loss.disc_weight_max + 1e-6 for step in logs),
            "train_d_weight above disc_weight_max")
    require(all(v > 0 for v in moved.values()) and lpips_frozen,
            f"after training: largest updates {moved}, LPIPS frozen {lpips_frozen}")
    require(ema_updates_per_step == 1,
            f"the EMA codebook was updated {ema_updates_per_step} times in one step")
    for name, want in expected.items():
        require(step_launches[name] == want,
                f"{name} launched {step_launches[name]} times per stage-1 step, expected {want}")
    require(eval_launches["vq_nearest"] == 1 and eval_launches["vq_nearest_train"] == 0
            and not updates, "eval_step should search without statistics or an EMA update")
    return res


def _rows(logdir):
    with open(os.path.join(logdir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _only_dir(root, prefix):
    (name,) = [n for n in os.listdir(root) if n.startswith(prefix)]
    return os.path.join(root, name)


def _sha256(torch, tensors):
    """One hash over the bytes of every tensor of a name -> tensor dict."""
    import hashlib

    h = hashlib.sha256()
    for name in sorted(tensors):
        h.update(name.encode())
        flat = tensors[name].detach().contiguous().cpu().reshape(-1)
        h.update(flat.view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def fit_through_cli(torch, card, phase, config, overrides, steps_per_epoch, state_of, val_key,
                    expect_launched, gb_needed, grids):
    """Three runs of the port's training command line on `config` at full
    width and depth, in-process: (A) two epochs in one run, logging image
    grids; (B) the same stopped after epoch 1; (C) `--resume` of B for epoch
    2. C must end where A ended, bit for bit."""
    import shutil

    from dynamicvectorquantization_torch.train import cli

    root = os.path.join("build", phase)
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    free_gb = shutil.disk_usage(root).free / 2 ** 30
    require(free_gb >= gb_needed,
            f"the {phase} phase writes up to {gb_needed} GB of checkpoints under {root}; only "
            f"{free_gb:.1f} GB are free there")
    common = ["--max_epochs", "2", "--max_steps_per_epoch", str(steps_per_epoch), "--save_n", "1",
              "--log_every", "1", "--seed", "23"]
    base = ["--base", config, "--logdir", root, *common, *overrides]
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        whole = cli.main([*base, "--name", "whole", "--image_log_every", "1000000"])
        torch.cuda.synchronize()
        whole_s = time.perf_counter() - t0
        launches = read_launches()
        peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
        whole_dir = _only_dir(root, "whole-")
        whole_hash = _sha256(torch, state_of(whole))
        del whole
        rows = _rows(whole_dir)
        with open(os.path.join(whole_dir, "loop_buckets.json")) as f:
            buckets = json.load(f)
        ckpt_dir = os.path.join(whole_dir, "checkpoints")
        ckpts = sorted(n for n in os.listdir(ckpt_dir) if n.endswith(".pt"))
        ckpt_gb = max(os.path.getsize(os.path.join(ckpt_dir, n)) for n in ckpts) / 2 ** 30
        image_dir = os.path.join(whole_dir, "images", "train")
        images = sorted(os.listdir(image_dir)) if os.path.isdir(image_dir) else []
        shutil.rmtree(ckpt_dir)  # room for the second pair of runs
        torch.cuda.empty_cache()

        first = cli.main([*base, "--name", "parts", "--stop_epoch", "1", "--image_log_every", "0"])
        first_steps = [first.epoch, getattr(first, "count", getattr(first, "step", None))]
        del first
        torch.cuda.empty_cache()
        parts_dir = _only_dir(root, "parts-")
        t0 = time.perf_counter()
        resumed = cli.main(["--resume", parts_dir, *common, "--image_log_every", "0"])
        torch.cuda.synchronize()
        resume_s = time.perf_counter() - t0
        resumed_hash = _sha256(torch, state_of(resumed))
        del resumed
        torch.cuda.empty_cache()
        parts_rows = _rows(parts_dir)
    finally:
        shutil.rmtree(root, ignore_errors=True)

    train_rows = [r for r in rows if r["split"] == "train"]
    val_rows = [r for r in rows if r["split"] == "val"]
    loss_key = "train_loss" if "train_loss" in train_rows[0] else "train_aeloss"
    losses = [r[loss_key] for r in train_rows]
    same = lambda a, b: {k: v for k, v in a.items() if k.endswith("loss")} == {  # noqa: E731
        k: v for k, v in b.items() if k.endswith("loss")}
    rows_equal = len(rows) == len(parts_rows) and all(same(a, b) for a, b in zip(rows, parts_rows))
    n = 2 * steps_per_epoch
    res = dict(phase=phase, config=config, overrides=overrides, epochs=2,
               steps_per_epoch=steps_per_epoch, rows=[(r["step"], r["split"]) for r in rows],
               train_loss=losses, val=[{k: v for k, v in r.items() if k.startswith("val_")}
                                       for r in val_rows],
               lr=[r["lr"] for r in train_rows], checkpoints_kept=ckpts, checkpoint_gb=ckpt_gb,
               image_grids=images, launches=launches, whole_run_s=spread([whole_s]),
               # one run: each bucket is one sum over its two epochs (n = 1)
               seconds_per_epoch={k: spread([v / 2]) for k, v in buckets["buckets"].items()},
               loop_wall_s=spread([buckets["wall_seconds"]]),
               device_wait_s=spread([buckets["device_wait_seconds"]]),
               encode_share=buckets["buckets"].get("encode", 0.0) / buckets["wall_seconds"],
               checkpoint_s_per_save=spread([buckets["buckets"]["checkpoint"] / 2]),
               peak_memory_gb=peak_gb, stopped_after_epoch_1_at=first_steps,
               resume_run_s=spread([resume_s]),
               final_val_whole=val_rows[-1][val_key],
               final_val_resumed=parts_rows[-1].get(val_key), state_sha256_whole=whole_hash,
               state_sha256_resumed=resumed_hash, resumed_rows_equal=rows_equal, card=card)
    emit(res)
    want_rows = [(i, "train") for i in range(1, steps_per_epoch + 1)] + [(steps_per_epoch, "val")] \
        + [(i, "train") for i in range(steps_per_epoch + 1, n + 1)] + [(n, "val")]
    require(res["rows"] == want_rows, f"{phase}: metric rows {res['rows']}, expected {want_rows}")
    require(all(math.isfinite(v) for r in rows for k, v in r.items() if k.endswith("loss")),
            f"{phase}: a logged loss is not finite")
    require(losses[-1] < losses[0], f"{phase}: {loss_key} did not fall: {losses}")
    require(1 <= len(ckpts) <= 2 and f"step_{n}.pt" in ckpts,
            f"{phase}: checkpoints kept {ckpts}: expected the newest and at most the best")
    require(len(images) == grids, f"{phase}: image grids {images}")
    require(first_steps == [1, steps_per_epoch], f"{phase}: the stopped run ended at {first_steps}")
    require(res["final_val_whole"] == res["final_val_resumed"] and whole_hash == resumed_hash
            and rows_equal, f"{phase}: the resumed run differs from the uninterrupted run: "
                            f"{res['final_val_whole']} vs {res['final_val_resumed']}")
    for name in expect_launched:
        require(launches[name] > 0, f"{phase}: {name} was not launched")
    return res


def fit(torch, card):
    """Stage 2: the shipped p6c18 config, `attn_pdrop` 0.1 untouched."""
    data = "data.params"
    synthetic = "dynamicvectorquantization_torch.data.datasets.SyntheticDataset"
    overrides = [f"{data}.batch_size=8", f"{data}.num_workers=4"]
    for split in ("train", "validation"):
        overrides += [f"{data}.{split}.target={synthetic}", f"{data}.{split}.params.size=256",
                      f"{data}.{split}.params.length=32"]
    overrides += [f"model.params.permuter_config.params.{k}={v}" for k, v in TRAIN_CAPS.items()]
    # two sampled grids (fixed and free fine positions), inputs, reconstructions: at
    # the first step of each epoch of the whole run
    return fit_through_cli(
        torch, card, "fit", P6C18, overrides, 4, lambda t: t.masters, "val_loss",
        ("vq_nearest", "patch_entropy", "fused_attention_forward", "fused_attention_forward_tc",
         "fused_attention_backward_tc", "layernorm_forward", "layernorm_backward", "fused_adamw",
         "strided_conv3x3_down"),
        gb_needed=12, grids=8)


def fit1(torch, card):
    """Stage 1: the shipped dual-grain DQ-VAE + GAN config. cuDNN picks
    deterministic convolution algorithms here, so that the resumed run can be
    held to the uninterrupted one bit for bit."""
    data = "data.params"
    synthetic = "dynamicvectorquantization_torch.data.synthetic.SyntheticImages"
    overrides = [f"{data}.batch_size=8", f"{data}.num_workers=4"]
    for split, n in (("train", 32), ("validation", 16)):
        overrides += [f"{data}.{split}.target={synthetic}", f"{data}.{split}.params.n={n}"]
    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        return fit_through_cli(
            torch, card, "fit1", STAGE1, overrides, 2, lambda t: t.model.state_dict(),
            "val_rec_loss", ("vq_nearest_train", "vq_nearest", "patch_entropy",
                             "strided_conv3x3_down", "fused_attention_forward",
                             "fused_attention_backward"),
            gb_needed=4, grids=8)
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved


def serve(torch, model, card):
    import numpy as np

    from dynamicvectorquantization_torch.serve import BatchingSampler

    requests = [(1, 101), (2, 102), (4, 103)]
    walls = []
    with BatchingSampler(model, max_batch=8, max_wait_ms=200.0) as engine:
        for round_ in range(2):  # the same requests twice: a repeat count for the wall time
            torch.cuda.synchronize()
            if round_ == 0:
                reset_launches()
            t0 = time.perf_counter()
            futures = [engine.submit(n, seed=s) for n, s in requests]
            images = [f.result(timeout=900) for f in futures]
            walls.append(time.perf_counter() - t0)
            if round_ == 0:
                launches = read_launches()
                batches = engine.batches_run
        stats = list(engine.batch_stats)
    n_images = sum(n for n, _ in requests)
    wall = spread(walls)["median"]
    res = dict(phase="serve", config=P6C18, kv_cache_dtype="int8", max_batch=8,
               requests=[n for n, _ in requests], shapes=[list(x.shape) for x in images],
               batches=batches, batch_stats=stats, launches=launches, wall_s=wall,
               wall_s_spread=spread(walls), s_per_batch=wall / batches,
               images_per_s=n_images / wall, card=card)
    emit(res)
    for (n, _), img in zip(requests, images):
        require(img.shape == (n, 256, 256, 3), f"image shape {img.shape} for {n} images")
        require(bool(np.isfinite(img).all()), "non-finite image values")
    layers = model.transformer.position_layer + model.transformer.content_layer
    require(launches["decode_attention_int8"] >= layers * sum(
        st["ar_steps"] for st in stats[:batches]),
            "decode_attention_int8 was not launched on every decode step")
    # the decoder's four AttnBlocks (f32: the FMA family); the StackGPT decodes one
    # token at a time through decode_attention_int8, so no tensor-core launch
    require(launches["fused_attention_forward"] == 4 * batches
            and launches["fused_attention_forward_tc"] == 0,
            "fused_attention_forward was not launched by every decoder AttnBlock")
    return res


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    os.chdir(os.path.dirname(os.path.abspath(__file__)))
    from dynamicvectorquantization_torch.ops import cuda_lib
    from dynamicvectorquantization_torch.utils.model_loading import load_model_and_variables

    card = card_line()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    emit(dict(phase="card", nvidia_smi=card, device=torch.cuda.get_device_name(0),
              count=torch.cuda.device_count(), torch=torch.__version__,
              cuda=torch.version.cuda, tf32_matmul=False, tf32_cudnn=False))

    t0 = time.perf_counter()
    cuda_lib.lib()
    emit(dict(phase="build", seconds=spread([time.perf_counter() - t0]),
              nvcc_flags=cuda_lib.NVCC_FLAGS))

    decode_cases = check_decode_attention(torch, dev)
    attn_cases, attn_drop_cases = check_fused_attention(torch, dev)
    check_attention_dropout(torch, dev)
    vq_case = check_vq_nearest(torch, dev)
    vq_train_case = check_vq_train(torch, dev)
    entropy_case = check_patch_entropy(torch, dev)
    conv_cases = check_strided_conv(torch, dev)
    ln_fwd_cases, ln_bwd_cases = check_layernorm(torch, dev)
    attn_train_cases, attn_bwd_cases, attn_train_drop_cases, attn_bwd_drop_cases = \
        check_attention_backward(torch, dev)
    adamw_case = check_fused_adamw(torch, dev)

    t0 = time.perf_counter()
    model, _ = load_model_and_variables(P6C18, seed=0, kv_cache_dtype="int8", device=dev)
    model.transformer.to(torch.bfloat16)
    emit(dict(phase="load", config=P6C18, seed=0, seconds=spread([time.perf_counter() - t0]),
              params=sum(p.numel() for p in model.parameters())))
    encoded = encode(torch, model, dev, card)
    teacher_forced_decode(torch, model, dev)
    served = serve(torch, model, card)
    del model
    torch.cuda.empty_cache()
    trained = train(torch, dev, card)
    per_step = trained["launches_per_step"]
    torch.cuda.empty_cache()
    per_step1 = train1(torch, dev, card)["launches_per_step"]
    torch.cuda.empty_cache()
    fitted = fit(torch, card)["launches"]
    torch.cuda.empty_cache()
    fitted1 = fit1(torch, card)["launches"]

    # the downsample line sums the encoder's four levels (one encode batch)
    conv = dict(conv_cases[0], shape=[c["shape"] for c in conv_cases],
                max_abs_err=max(c["max_abs_err"] for c in conv_cases),
                bound_by="/".join(sorted({c["bound_by"] for c in conv_cases})),
                kernel_ms_spread=[c["kernel_ms_spread"] for c in conv_cases],
                **{key: sum(c[key] for c in conv_cases)
                   for key in ("kernel_ms", "plain_ms", "bound_ms", "library_ms")})
    paths = {"serve": served["launches"], "encode": encoded["launches"], "train_step": per_step,
             "train1_step": per_step1, "fit": fitted, "fit1": fitted1}

    def launched(name):
        """Launches of a row on each driven path (for the attention rows: of
        that kernel family, every rate)."""
        return {path: counts[name] for path, counts in paths.items() if counts[name]}

    def pick(case, *keys):
        return {k: case[k] for k in keys if k in case}

    timed_keys = ("shape", "dtype", "causal", "family", "rate", "max_abs_err", "dropout_err",
                  "tol", "kernel_ms", "kernel_ms_spread", "plain_ms", "library_ms", "bound_ms",
                  "bound_by", "fma_kernel_ms", "fma_kernel_ms_spread", "bit_reproducible",
                  "gflop")
    attn_src = "dynamicvectorquantization_tpu/ops/attention_pallas.py"
    # the attention cases: forward (a) f32 hd 256, t808 bf16 (tensor cores), (b) f32 hd 512,
    # (a) in bf16; with lse (c) bf16 (tensor cores), f32 batch 2, hd 64, hd 256, hd 512,
    # hd 256 bf16; each also at rate 0.1 (the `_drop` lists)
    fwd_a, fwd_t808, fwd_b, fwd_a16 = attn_cases
    dfwd_a, dfwd_t808, dfwd_b, dfwd_a16 = attn_drop_cases
    fwd_c, fwd_c32, fwd_64, fwd_256, fwd_512, fwd_256b = attn_train_cases
    dfwd_c = attn_train_drop_cases[0]
    bwd_c, bwd_c32, bwd_64, bwd_256, bwd_512, bwd_256b = attn_bwd_cases
    dbwd_c, dbwd_c32, dbwd_64, dbwd_256, dbwd_512, dbwd_256b = attn_bwd_drop_cases
    kernels = []
    for name, src, replaces, main, extra in (
            ("decode_attention_int8", "decode_attention_int8.cu",
             "dynamicvectorquantization_tpu/ops/kv_int8.py:92", decode_cases[-1], {}),
            # the FMA family: f32 at every head dim (the DQ-VAE's AttnBlocks), bf16 at
            # hd 16, 32, 256, 512; main: the decoder's 32x32 AttnBlock
            ("fused_attention_forward", "fused_attention.cu", f"{attn_src}:82", fwd_a,
             {"family": "FMA", "extra": {n_: pick(c, *timed_keys) for n_, c in (
                 ("a_rate0.1", dfwd_a), ("b_hd512_f32", fwd_b), ("b_hd512_f32_rate0.1", dfwd_b),
                 ("a_bf16_hd256", fwd_a16), ("a_bf16_hd256_rate0.1", dfwd_a16),
                 ("c_f32_b2_with_lse", fwd_c32))}}),
            # the tensor-core family: bf16 at hd 64 / 128; main: the stage-2 training
            # shape (c) at the shipped rate 0.1, with lse
            ("fused_attention_forward_tc", "fused_attention_tc.cu", f"{attn_src}:82", dfwd_c,
             {"family": "tensor cores", "rate": dfwd_c["rate"],
              "dropout_err": dfwd_c["dropout_err"], "fma_kernel_ms": dfwd_c["fma_kernel_ms"],
              "extra": {n_: pick(c, *timed_keys) for n_, c in (
                  ("c_rate0", fwd_c), ("t808_no_lse", fwd_t808),
                  ("t808_no_lse_rate0.1", dfwd_t808))}}),
            ("fused_attention_backward", "fused_attention_bwd.cu", f"{attn_src}:108", bwd_256,
             {"family": "FMA", "bit_reproducible": bwd_256["bit_reproducible"],
              "extra": {n_: pick(c, *timed_keys) for n_, c in (
                  ("a_hd256_rate0.1", dbwd_256), ("b_hd512", bwd_512),
                  ("b_hd512_rate0.1", dbwd_512), ("hd256_bf16", bwd_256b),
                  ("hd256_bf16_rate0.1", dbwd_256b), ("c_f32_b2", bwd_c32),
                  ("c_f32_b2_rate0.1", dbwd_c32), ("hd64_t300", bwd_64),
                  ("hd64_t300_rate0.1", dbwd_64))}}),
            ("fused_attention_backward_tc", "fused_attention_bwd_tc.cu", f"{attn_src}:108",
             dbwd_c,
             {"family": "tensor cores", "rate": dbwd_c["rate"],
              "dropout_err": dbwd_c["dropout_err"],
              "bit_reproducible": dbwd_c["bit_reproducible"],
              "fma_kernel_ms": dbwd_c["fma_kernel_ms"],
              "bound_ms_f32_fma": dbwd_c["bound_ms_f32_fma"],
              "extra": {"c_rate0": pick(bwd_c, *timed_keys)}}),
        ("layernorm_forward", "layernorm.cu",
             "dynamicvectorquantization_tpu/ops/layernorm_pallas.py:46", ln_fwd_cases[0], {}),
            ("layernorm_backward", "layernorm.cu",
             "dynamicvectorquantization_tpu/ops/layernorm_pallas.py:56", ln_bwd_cases[0],
             {"bit_reproducible": ln_bwd_cases[0]["bit_reproducible"]}),
            ("fused_adamw", "fused_adamw.cu",
             "dynamicvectorquantization_tpu/ops/fused_adamw.py:39", adamw_case, {}),
            ("vq_nearest", "vq_nearest.cu", "dynamicvectorquantization_tpu/ops/vq_pallas.py:42",
             vq_case, {"mismatched_rows": vq_case["mismatched_rows"]}),
            ("vq_nearest_train", "vq_nearest.cu",
             "dynamicvectorquantization_tpu/ops/vq_pallas.py:57", vq_train_case,
             {k: vq_train_case[k] for k in ("mismatched_rows", "bit_reproducible",
                                            "stats_kernel_ms", "largest_cluster",
                                            "empty_clusters")}),
            ("patch_entropy", "patch_entropy.cu",
             "dynamicvectorquantization_tpu/ops/entropy.py:118", entropy_case, {}),
            ("strided_conv3x3_down", "strided_conv_down.cu",
             "dynamicvectorquantization_tpu/ops/downsample_pallas.py:45", conv, {})):
        launches = launched(name)
        kernels.append(dict(
            name=name, route="cuda", source=f"dynamicvectorquantization_torch/csrc/{src}",
            replaces=replaces, launches=sum(launches.values()), launches_by_path=launches,
            max_abs_err=main["max_abs_err"], tol=main["tol"], ms=main["kernel_ms"],
            ms_spread=main["kernel_ms_spread"], plain_ms=main["plain_ms"],
            bound_ms=main["bound_ms"], bound_by=main["bound_by"],
            library_ms=main.get("library_ms"), shape=main["shape"], card=card, **extra))
        require(kernels[-1]["launches"] > 0, f"{name} was launched on no driven path")
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
