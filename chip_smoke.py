#!/usr/bin/env python3
"""Drive the PyTorch port (`dynamicvectorquantization_torch`) on one NVIDIA
GPU and check it end to end. Needs one CUDA card and the CUDA toolkit (nvcc);
builds the kernels from `dynamicvectorquantization_torch/csrc/` at first use.

    python3 chip_smoke.py

Phases, each printed as one JSON line (any failure exits non-zero):
  1. card      name and power limit (nvidia-smi), TF32 off for f32 phases;
               device busy time in every phase is the union of the profiler
               trace's intervals, the idle share that of the traced window
     build     the kernels, with ptxas's registers and spills for each
  2. kernels   each CUDA kernel against its plain-PyTorch version at the
               shapes of the encode, serving and training paths: error vs the stated
               tolerance, kernel / plain / library times (device time from a
               profiler trace, and wall time from CUDA events; inputs rotated
               through more than the 50 MB L2 cache), and the bound from bytes
               or operations at the H100's peak rates; the downsample and the
               patch entropy in f32 and in bf16 (the f32 downsample on the
               blocked f32 kernel, equal to the FMA kernel bit for bit, with
               its time beside it; the bf16 downsample on the
               tensor cores: every output within one bf16 ulp of the plain
               version's, at most 1 % differing, the share of outputs summed
               again in the plain order and the FMA kernel's time beside it),
               the tensor-core
               attention family in bf16 (hd 128 causal,
               hd 256 / 512) held to the plain version's roundings (the share of
               differing outputs, beside that of the unrounded math), with the
               FMA family's bf16 time beside it, the f32 forward and backward
               at hd 256 / 512 (register-blocked) with the square-tile kernels'
               times beside them, the f32 forward and backward at hd 64 / 128
               (3xTF32 on the tensor cores; stage-2 validation's shape, 8 x 805
               x 1024 causal, for the forward, and with lse at batch 2 and 8,
               the f32 stage-2 step's shape, for both) with the square tiles'
               and SDPA's times beside them (the square-tile backward also held
               to the plain version), the square tiles' own route at two f32
               heads of 32, the patch entropy's windowed kernel with the
               replaced one-block-per-patch kernel's time beside it and a
               bound from the kernel values that are not +0 on its images, and
               both nearest-code searches (3xTF32 on the
               tensor cores) with codes equal to the FMA search's bit for bit,
               the rows they rescored, the fast scores' distance from their
               bound, the FMA search's time beside them, and adversarial sets
               (duplicate codes, codes one ulp apart, rows midway between two
               codes, the 1/K init codebook, one code owning every row); the
               int8 decode attention at four cache indices and, kernel only,
               every 128 positions to 1283 (two calls equal, the device-index
               entry equal to the host-index one at each); the LayerNorm
               backward's share of its bytes bound, launches and ptxas report
  3. encode    full-width p6c18 first stage (f32), batch 8 of seeded 256^2
               images (half smooth, half noisy): `encode_to_z` and `forward`
               through the kernels and through the plain versions (streams,
               grain cells, codes and reconstructions compared), the round trip
               through `decode_to_img`, timing with the device's busy share,
               and launch counters zeroed just before one `encode_to_z` and read
               just after (patch entropy 1, strided conv 4 on the blocked f32
               kernel, attention 6 on the register-blocked f32 kernel, VQ 1);
               then the same batch through the first stage cast to bf16 as the
               stage-2 trainer casts it (time, busy share, launches: entropy 1,
               strided conv 4, attention 6 on the tensor cores, VQ 1, all in bf16
               but the VQ's f32 search; grain cells and codes equal to the f32
               encode's, printed)
  4. decode    full-width p6c18 StackGPT with int8 KV caches, seeded random
               weights, bf16, batch 8: 64 teacher-forced steps through the
               kernel path vs the plain path, max logit difference; then a
               torch.profiler trace of 16 steps for the device's busy time
  5. serve     BatchingSampler (p6c18, int8 caches, max_batch 8) answers 3
               concurrent requests of 1, 2 and 4 images; launch counters are
               zeroed just before and read just after; the decode kernel's
               time over the indices the batch visited, estimated from the
               sweep (and from the replaced kernel's recorded times)
  6. train     full-width, full-depth p6c18 StackGPT (the shipped config, its
               attn_pdrop 0.1 included, with the training campaign's stream
               caps, T = 805),
               bf16 over f32 masters, batch 8: 16 seeded images encoded by
               `Stage2Trainer.encode_dataset` (its bf16 first stage: the bf16
               downsample and entropy launches and its attention on the tensor
               cores asserted); one `train_step` through the
               kernels against one through the plain versions from the same
               state and the same dropout masks (losses, gradients,
               parameters); then timed steps with all three shipped dropouts
               (and, for comparison, with attn_pdrop 0), launch counters per
               step, a torch.profiler trace of one step, peak memory; then all
               of it again in f32 (`compute_dtype` None, the JAX trainer's
               default: f32 weights and activations, TF32 off) on the same
               cached codes, with f32 limits that two controls of lower
               precision (cuBLAS's TF32; a TF32 attention forward) must each
               exceed, every attention launch on the 3xTF32 forward and
               backward (24 + 24 a step), none on the square tiles
  7. train1    full-width, full-depth DQ-VAE + GAN of the shipped
               `dqvae-entropy-dual-r05_imagenet.yml` (f32, TF32 off, seeded random
               weights, random VGG16 backbone with the bundled LPIPS lin heads),
               batch 8 of the encode phase's images: one `Stage1Trainer.train_step`
               through the kernels against one through the plain versions from
               the same state and generator seed (logs, EMA codebook, watched
               gradients); then timed steps, launch counters per step, a
               torch.profiler trace of one step, peak memory, one `eval_step`;
               then all of it again with `compute_dtype=bfloat16` (bf16 towers
               over f32 parameters, the bf16 downsample launched, the AttnBlocks
               on the tensor-core family)
  8. fit       the port's training command line (`train/cli.py` `main`), called
               in-process on the shipped p6c18 config at full width and depth
               with only data and run-length overrides (synthetic 256^2 images,
               batch 8, 2 epochs of 4 steps, the train phase's stream caps): one
               run of both epochs with an image grid, then epoch 1 alone and a
               `--resume` for epoch 2; metric rows, falling loss, checkpoint
               files, the resumed run equal to the uninterrupted one bit for bit
               (final val_loss, a hash of the f32 masters), launch counters (the
               pre-encode in bf16, validation in f32 on the 3xTF32 forward, none
               on the square tiles),
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
# f32 without tensor cores; bf16 and TF32 dense on the tensor cores
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12, "tf32": 495e12}
L2_BYTES = 50 * 2 ** 20
# the training campaign's stream caps at fine ratio 0.5 (160 coarse + 644 fine
# tokens and the two SOS prefixes, less the shifted-off last token)
TRAIN_CAPS = {"coarse_max_len": 160, "fine_max_len": 644}
TRAIN_T = 160 + 1 + 644 + 1 - 1
BF16_RTOL = 2.0 ** -7  # one bf16 ulp of the reference value
DROPOUT_RATES = (0.1, 0.5)  # checked against the plain versions; timed at the first
DROPOUT_SEED = 0x5EED5EED5EED
# both attention families in bf16 round P (relative to the row's final max), D and dS
# where the plain version does: outputs may differ from its in summation order only,
# while the same math without those roundings differs in about 40 % of them (F9, F10)
F9_MISMATCH_SHARE = 0.05


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
    launches as many kernels; else the mean alone, n = 1); a trace that
    holds none of the calls' kernels is taken again, up to three traces in
    all (`traces_taken` in the spread when more than one). Wall ms: CUDA
    events round each of the back-to-back calls, which include the host's
    launch overhead when that exceeds the kernels' time, and every op the
    call launches. The device spread also carries the kernels each call
    launched (`kernels_per_call`) where the trace split into the calls."""
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
    for attempt in range(1, 4):  # a trace that lost every kernel of the calls is taken again
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for i in range(iters):
                fn(*arg_sets[i % len(arg_sets)])
            torch.cuda.synchronize()
        kernels = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                         key=lambda e: e.time_range.start)
        if any(only is None or only in e.name for e in kernels):
            break
    else:
        return None, wall  # no trace held (matching) device time
    per = len(kernels) // iters
    if per * iters == len(kernels):
        device = spread([sum(e.time_range.elapsed_us() for e in kernels[i * per:(i + 1) * per]
                             if only is None or only in e.name) / 1e3 for i in range(iters)])
        device["kernels_per_call"] = per
    else:
        device = spread([sum(e.time_range.elapsed_us() for e in kernels
                             if only is None or only in e.name) / 1e3 / iters])
    if attempt > 1:
        device["traces_taken"] = attempt
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


def interpolated_sum(points, indices):
    """The sum over `indices` of the piecewise-linear interpolation of
    {index: ms} (held flat past its ends)."""
    xs = sorted(points)
    total = 0.0
    for i in indices:
        if i <= xs[0]:
            total += points[xs[0]]
        elif i >= xs[-1]:
            total += points[xs[-1]]
        else:
            hi = next(k for k, x in enumerate(xs) if x >= i)
            x0, x1 = xs[hi - 1], xs[hi]
            total += points[x0] + (points[x1] - points[x0]) * (i - x0) / (x1 - x0)
    return total


def check_decode_attention(torch, dev):
    """The four recorded indices against the plain version (errors, kernel /
    plain times, the device-index entry equal to the by-value one, two calls
    equal), then a kernel-only sweep of cache_index every 128 positions (and
    1283) with the same two equalities at each."""
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

    def equalities(idx):
        out = decode_attention_int8(*sets[0], idx)
        again = decode_attention_int8(*sets[0], idx)
        on_device = decode_attention_int8(
            *sets[0], torch.tensor(idx, dtype=torch.int32, device=dev))
        torch.cuda.synchronize()
        return out, bool(torch.equal(out, again)), bool(torch.equal(out, on_device))

    def bound_at(idx):
        n = idx + 1
        return bound(2 * b * h * hd * 2 + 2 * b * h * n * (hd + 4), 4 * b * h * n * hd, "float32")

    cases = []
    for idx in (0, 255, 256, 1283):
        out, reproducible, device_equal = equalities(idx)
        ref = decode_attention_int8_plain(*sets[0], idx)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        bms, by = bound_at(idx)
        case = dict(phase="kernels", kernel="decode_attention_int8", shape=[b, h, t, hd],
                    dtype="bfloat16", cache_index=idx, max_abs_err=err, tol=tol,
                    bit_reproducible=reproducible, device_index_equal=device_equal,
                    library_ms=None, bound_ms=bms, bound_by=by)
        time_into(case, "kernel", torch, lambda *a: decode_attention_int8(*a, idx), sets)
        time_into(case, "plain", torch, lambda *a: decode_attention_int8_plain(*a, idx), sets)
        case["bound_share"] = case["kernel_ms"] and bms / case["kernel_ms"]
        emit(case)
        require(err <= tol, f"decode_attention_int8 disagrees at cache_index {idx}: {err}")
        require(reproducible and device_equal,
                f"decode_attention_int8 at cache_index {idx}: two calls equal {reproducible}, "
                f"device index equal to the host index {device_equal}")
        cases.append(case)
    sweep = []
    for idx in list(range(0, 1284, 128)) + [1283]:
        _, reproducible, device_equal = equalities(idx)
        point = dict(cache_index=idx, bit_reproducible=reproducible,
                     device_index_equal=device_equal, bound_ms=bound_at(idx)[0])
        time_into(point, "kernel", torch, lambda *a: decode_attention_int8(*a, idx), sets)
        require(reproducible and device_equal,
                f"decode_attention_int8 sweep at cache_index {idx}: two calls equal "
                f"{reproducible}, device index equal to the host index {device_equal}")
        sweep.append(point)
    emit(dict(phase="kernels", kernel="decode_attention_int8_sweep", shape=[b, h, t, hd],
              dtype="bfloat16", sweep=sweep))
    return cases, sweep


def fma_forward(torch, q, k, v, n_head, scale, causal, rate=0.0, return_lse=False, seed=0):
    """The FMA family's square-tile forward entry (`csrc/fused_attention.cu`)
    called directly, at shapes the wrapper sends to the tensor cores (bf16, hd
    64 / 128 / 256 / 512) or to the register-blocked f32 kernel (f32, hd 256 /
    512): the time before those replaced it there, for comparison in the same
    call. Launches are not counted."""
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
    """The FMA family's backward entry called directly (see `fma_forward`): its
    square-tile kernels at every head dim, at hd 256 / 512 in f32 the route
    that the register-blocked kernel replaced."""
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


def rounded_forward_f64(torch, q, k, v, n_head, scale, causal):
    """The bf16 plain version's math (P rounded to bf16 against the row's
    final max) with every product and sum in f64: the yardstick for how far
    each family's and the plain version's summation moves the bf16 output."""
    b, t, d = q.shape
    hd = d // n_head
    qh, kh, vh = (z.double().view(b, t, n_head, hd).transpose(1, 2) for z in (q, k, v))
    s = qh @ kh.transpose(-1, -2) * scale
    if causal:
        keep = torch.ones((t, t), dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, float("-inf"))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    y = (p.to(torch.bfloat16).double() @ vh) / p.sum(-1, keepdim=True)
    return y.transpose(1, 2).reshape(b, t, d).to(q.dtype)


def tensor_core_shape(torch, dtype, hd):
    """Whether the attention wrappers send this dtype and head dim to the
    tensor-core family."""
    from dynamicvectorquantization_torch.ops.attention import _TC_HEAD_DIMS

    return dtype == torch.bfloat16 and hd in _TC_HEAD_DIMS


def f32_tc_shape(torch, dtype, hd):
    """Whether the forward wrapper runs the 3xTF32 kernel
    (`csrc/fused_attention_f32_tc.cu`) at this dtype and head dim."""
    from dynamicvectorquantization_torch.ops.attention import _F32_TC_HEAD_DIMS

    return dtype == torch.float32 and hd in _F32_TC_HEAD_DIMS


def attention_bounds(torch, n_bytes, flops, dtype, f32tc):
    """(bound ms, bound by, f32 FMA bound ms) of a forward: at the rate of the
    input type (bf16: the tensor cores; f32: the FMA units), or, for the
    3xTF32 kernel (`f32tc`), three TF32 products a product on the tensor
    cores; and beside it at the f32 FMA rate."""
    fma = bound(n_bytes, flops, "float32")[0]
    if f32tc:
        return (*bound(n_bytes, 3 * flops, "tf32"), fma)
    return (*bound(n_bytes, flops, str(dtype).split(".")[-1]), fma)


def wide_f32_shape(torch, dtype, hd):
    """Whether the wrappers run the register-blocked f32 kernels
    (`csrc/fused_attention_wide.cu`, `csrc/fused_attention_bwd_wide.cu`) at
    this dtype and head dim."""
    from dynamicvectorquantization_torch.ops.attention import _WIDE_F32_HEAD_DIMS

    return dtype == torch.float32 and hd in _WIDE_F32_HEAD_DIMS


def check_fused_attention(torch, dev):
    import torch.nn.functional as F

    from dynamicvectorquantization_torch.ops.attention import (
        fused_attention_forward, fused_attention_forward_plain)

    cases, dropout_cases = [], []
    # DQ-VAE AttnBlock at 32x32 (decoder and encoder; f32, one head), a
    # StackGPT-like causal bf16 shape (808 tokens, 8 heads), the encoder's
    # AttnBlock at 16x16 (one head of 512 channels), the first and third
    # shapes in bf16 (the bf16 DQ-VAE's AttnBlocks), and stage-2 validation on
    # the f32 masters (805 tokens, 8 heads of 128, no lse: the 3xTF32 kernel);
    # every bf16 shape on the tensor-core family, with the FMA family's time
    # beside it, every f32 one with the square tiles' time beside it
    for (b, t, d), n_head, causal, dtype, tol in (
            ((8, 1024, 256), 1, False, torch.float32, 1e-4),
            ((8, 808, 1024), 8, True, torch.bfloat16, 2e-2),
            ((8, 256, 512), 1, False, torch.float32, 1e-4),
            ((8, 1024, 256), 1, False, torch.bfloat16, 2e-2),
            ((8, 256, 512), 1, False, torch.bfloat16, 2e-2),
            ((8, TRAIN_T, 1024), 8, True, torch.float32, 1e-4)):
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
        wide = wide_f32_shape(torch, dtype, hd)
        f32tc = f32_tc_shape(torch, dtype, hd)
        before = (fused_attention_forward.tc_launches, fused_attention_forward.wide_f32_launches,
                  fused_attention_forward.f32_tc_launches)
        out = fused_attention_forward(*sets[0], n_head, scale, causal)
        again = fused_attention_forward(*sets[0], n_head, scale, causal)
        ref = fused_attention_forward_plain(*sets[0], n_head, scale, causal)
        torch.cuda.synchronize()
        require((fused_attention_forward.tc_launches - before[0],
                 fused_attention_forward.wide_f32_launches - before[1],
                 fused_attention_forward.f32_tc_launches - before[2])
                == (2 * int(tc), 2 * int(wide), 2 * int(f32tc)),
                f"fused_attention_forward took the wrong kernel at {dtype} hd {hd}")
        err = (out.float() - ref.float()).abs().max().item()
        pairs = t * (t + 1) // 2 if causal else t * t
        dname = str(dtype).split(".")[-1]
        flops = 4 * b * n_head * pairs * hd
        bms, by, bms_fma = attention_bounds(torch, 4 * b * t * d * elem, flops, dtype, f32tc)
        route = ("wide f32" if wide else "tensor cores" if tc else "f32 tensor cores" if f32tc
                 else "square tiles")
        case = dict(phase="kernels", kernel="fused_attention_forward", shape=[b, t, d],
                    n_head=n_head, causal=causal, dtype=dname,
                    family="tensor cores" if tc or f32tc else "FMA", route=route,
                    max_abs_err=err, tol=tol, bit_reproducible=bool(torch.equal(out, again)),
                    gflop=flops / 1e9, bound_ms=bms, bound_by=by, bound_ms_f32_fma=bms_fma)
        del again
        if dtype == torch.bfloat16:  # F9, F10: rounded where the plain version rounds
            unrounded = fused_attention_forward_plain(*(z.float() for z in sets[0]), n_head,
                                                      scale, causal).to(dtype)
            case.update(mismatch_share=mismatch_share(out, ref),
                        unrounded_mismatch_share=mismatch_share(unrounded, ref),
                        mismatch_tol=F9_MISMATCH_SHARE)
            del unrounded
        if tc:  # the FMA family at the same shape: the time before the tensor cores took it
            fma_out = fma_forward(torch, *sets[0], n_head, scale, causal)
            case["fma_max_abs_err"] = (fma_out.float() - ref.float()).abs().max().item()
            # each against the same roundings summed in f64 (printed, not held)
            exact = rounded_forward_f64(torch, *sets[0], n_head, scale, causal)
            case["f64_mismatch_share"] = {"kernel": mismatch_share(out, exact),
                                          "fma_kernel": mismatch_share(fma_out, exact),
                                          "plain": mismatch_share(ref, exact)}
            del fma_out, exact
            time_into(case, "fma_kernel", torch,
                      lambda *a: fma_forward(torch, *a, n_head, scale, causal), sets)
        if wide or f32tc:  # the square-tile kernel it replaced, at the same shape
            sq_out = fma_forward(torch, *sets[0], n_head, scale, causal)
            case["square_tiles_max_abs_err"] = (sq_out - ref).abs().max().item()
            del sq_out
            time_into(case, "square_tiles", torch,
                      lambda *a: fma_forward(torch, *a, n_head, scale, causal), sets)
        time_into(case, "kernel", torch,
                  lambda *a: fused_attention_forward(*a, n_head, scale, causal), sets)
        time_into(case, "plain", torch,
                  lambda *a: fused_attention_forward_plain(*a, n_head, scale, causal), sets)
        time_into(case, "library", torch, lib, sets)
        emit(case)
        require(err <= tol, f"fused_attention_forward disagrees at {case['shape']}: {err}")
        require(case["bit_reproducible"], f"fused_attention_forward is not bit-reproducible at "
                                          f"{case['shape']} {dname}")
        require(case.get("mismatch_share", 0.0) <= F9_MISMATCH_SHARE
                < case.get("unrounded_mismatch_share", 1.0),
                f"the bf16 forward does not round as the plain version: {case}")
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
        if wide or f32tc:
            time_into(drop, "square_tiles", torch,
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
    per tile family of the forward and backward kernels (f32 at hd 32: the
    square tiles; f32 at hd 64 / 128: the 3xTF32 forward's and backward's
    tiles in their own key and query order; hd 256: 64- and 32-row; hd 512:
    32- and 16-row;
    tensor-core family in bf16 at hd 64 / 128 / 256 / 512, where unit
    vectors and uniform probabilities are exact) the mask recovered
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
    wide_before = (fused_attention_forward.wide_f32_launches,
                   fused_attention_backward.wide_f32_launches)
    f32_tc_before = (fused_attention_forward.f32_tc_launches,
                     fused_attention_backward.f32_tc_launches)
    square_before = tuple(fn.fma_launches - fn.wide_f32_launches
                          for fn in (fused_attention_forward, fused_attention_backward))
    for hd, t, dtype in ((32, 300, torch.float32), (64, 300, torch.float32),
                         (128, 805, torch.float32),
                         (256, 300, torch.float32), (512, 300, torch.float32),
                         (64, 300, torch.bfloat16), (128, 805, torch.bfloat16),
                         (256, 300, torch.bfloat16), (512, 300, torch.bfloat16)):
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
                                 else "FMA", route="f32 tensor cores"
                                 if f32_tc_shape(torch, dtype, hd) else "square tiles"
                                 if hd < 64 else None,
                                 forward_mask_equal=fwd_equal,
                                 backward_mask_equal=bwd_equal, kept_share=kept,
                                 kept_share_sigmas=abs(kept - (1 - rate)) / sigma))
    tc_probes = (fused_attention_forward.tc_launches - tc_before[0],
                 fused_attention_backward.tc_launches - tc_before[1])
    wide_probes = (fused_attention_forward.wide_f32_launches - wide_before[0],
                   fused_attention_backward.wide_f32_launches - wide_before[1])
    f32_tc_probes = (fused_attention_forward.f32_tc_launches - f32_tc_before[0],
                     fused_attention_backward.f32_tc_launches - f32_tc_before[1])
    square_probes = tuple(fn.fma_launches - fn.wide_f32_launches - b_ for fn, b_ in zip(
        (fused_attention_forward, fused_attention_backward), square_before))
    g = torch.Generator(device=dev).manual_seed(14)
    q, k, v = (torch.randn((2, TRAIN_T, 1024), generator=g, device=dev).to(torch.bfloat16)
               for _ in range(3))
    def run(seed, rate=0.1):
        return fused_attention_forward(q, k, v, 8, None, True, rate, seed=seed)

    res = dict(phase="kernels", kernel="attention_dropout_mask", families=families,
               tensor_core_probe_launches=tc_probes, wide_f32_probe_launches=wide_probes,
               f32_tc_probe_launches=f32_tc_probes, square_tile_probe_launches=square_probes,
               same_seed_bit_identical=bool(torch.equal(run(5), run(5))),
               seeds_differ=not torch.equal(run(5), run(6)),
               rate0_ignores_seed=bool(torch.equal(run(5, 0.0), fused_attention_forward(
                   q, k, v, 8, None, True))))
    emit(res)
    require(all(f["forward_mask_equal"] and f["backward_mask_equal"] for f in families),
            f"a kernel's dropout mask differs from dropout_keep_mask: {families}")
    probes = 2 * sum(-(-t // hd) for hd, t in ((64, 300), (128, 805), (256, 300), (512, 300)))
    require(tc_probes == (probes, probes),
            f"the bf16 probes did not all run on the tensor cores: {tc_probes}, expected "
            f"{(probes, probes)}")
    wide = 2 * sum(-(-t // hd) for hd, t in ((256, 300), (512, 300)))
    require(wide_probes == (wide, wide),
            f"the f32 probes at hd 256 / 512 did not all run the register-blocked kernels: "
            f"{wide_probes}, expected {(wide, wide)}")
    f32_tc = 2 * sum(-(-t // hd) for hd, t in ((64, 300), (128, 805)))
    require(f32_tc_probes == (f32_tc, f32_tc),
            f"the f32 probes at hd 64 / 128 did not all run the 3xTF32 kernels: "
            f"{f32_tc_probes}, expected {(f32_tc, f32_tc)}")
    square = 2 * -(-300 // 32)
    require(square_probes == (square, square),
            f"the f32 probes at hd 32 did not all run the square tiles: {square_probes}, "
            f"expected {(square, square)}")
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


def fma_nearest(torch, x, cb, scores=False):
    """The FMA search's entry (`csrc/vq_nearest.cu`), the exact order the
    tensor-core search rescores in, called directly: its codes (int32) and,
    with `scores`, every (row, code) score. Launches are not counted."""
    from dynamicvectorquantization_torch.ops import cuda_lib

    n, d = x.shape
    k = cb.shape[0]
    idx = torch.empty(n, dtype=torch.int32, device=x.device)
    out = torch.empty((n, k), device=x.device) if scores else None
    err = cuda_lib.lib().dqvq_vq_nearest_fma(
        x.data_ptr(), cb.data_ptr(), (cb * cb).sum(1).data_ptr(), idx.data_ptr(),
        out.data_ptr() if scores else None, n, k, d, torch.cuda.current_stream().cuda_stream)
    cuda_lib.check(err, "fma_nearest")
    return idx, out


def margin_use(torch, x, cb):
    """The largest |fast - FMA-order| score over every (row, code) pair,
    divided by the row's error bound e_r, from the search kernel's test entry
    (`dqvq_vq_nearest_tc_scores`): <= 1 where the bound holds."""
    from dynamicvectorquantization_torch.ops import cuda_lib

    n, d = x.shape
    k = cb.shape[0]
    idx = torch.empty(n, dtype=torch.int32, device=x.device)
    fast = torch.empty((n, k), device=x.device)
    margin = torch.empty(n, device=x.device)
    ws = torch.empty(cuda_lib.lib().dqvq_vq_workspace_bytes(n, k, d, 0), dtype=torch.uint8,
                     device=x.device)
    err = cuda_lib.lib().dqvq_vq_nearest_tc_scores(
        x.data_ptr(), cb.data_ptr(), (cb * cb).sum(1).data_ptr(), idx.data_ptr(),
        fast.data_ptr(), margin.data_ptr(), ws.data_ptr(), n, k, d,
        torch.cuda.current_stream().cuda_stream)
    cuda_lib.check(err, "margin_use")
    exact = fma_nearest(torch, x, cb, scores=True)[1]
    return float(((fast - exact).abs() / margin[:, None]).max())


def vq_bound(n, k, d, extra_adds=0):
    """The least time for the search: the smaller of the products at the f32
    FMA rate and as three TF32 products at the dense TF32 rate (the larger of
    that and the bytes), with `extra_adds` f32 adds on top."""
    n_bytes = 4 * (n * d + k * d + k + n)
    ops_ms = min(2 * n * k * d / PEAK_FLOPS["float32"], 3 * 2 * n * k * d / PEAK_FLOPS["tf32"])
    ops_ms = (ops_ms + extra_adds / PEAK_FLOPS["float32"]) * 1e3
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations, 3xTF32")


def vq_sets(torch, dev, n, k, d, g):
    """The adversarial sets of the nearest-code checks: {name: (x, codebook)}."""
    cb = torch.randn((k, d), generator=g, device=dev)
    x = torch.randn((n, d), generator=g, device=dev)
    dup = cb.clone()
    dup[1::2] = dup[0::2][: k // 2]  # every odd code repeats the even one before it
    ulp = cb.clone()  # every odd code one f32 ulp above the even one in every element
    ulp[1::2] = torch.nextafter(ulp[0::2][: k // 2], torch.full_like(ulp[0::2][: k // 2], 1e30))
    pair = torch.randint(0, k // 2, (n,), generator=g, device=dev) * 2
    mid = 0.5 * (cb[pair] + cb[pair + 1])  # each row midway between two codes
    init = (torch.rand((k, d), generator=g, device=dev) * 2 - 1) / k  # the shipped init
    owner = cb[3:4] + 0.01 * torch.randn((n, d), generator=g, device=dev)
    return {"duplicate_codes": (x, dup), "codes_one_ulp_apart": (x, ulp),
            "rows_equidistant_from_two_codes": (mid, cb),
            "init_codebook_uniform_1_over_k": (x, init), "one_code_owns_every_row": (owner, cb)}


def check_vq_adversarial(torch, dev, sum_tol):
    """Both searches on the adversarial sets at the encoder's shape and at a
    small one: codes equal to the FMA search's bit for bit, the fast scores
    within their bound, the statistics exact (counts) or within `sum_tol` of
    the largest sum, every output bit-reproducible."""
    from dynamicvectorquantization_torch.ops.vq import nearest_codes, nearest_codes_with_stats

    g = torch.Generator(device=dev).manual_seed(21)
    cases = []
    for n, k, d in ((8 * 32 * 32, 1024, 256), (300, 100, 36)):
        for name, (x, cb) in vq_sets(torch, dev, n, k, d, g).items():
            ref = fma_nearest(torch, x, cb)[0].long()
            idx, xq = nearest_codes(x, cb)
            rescored = int(nearest_codes.last_rescored)
            idx2, xq2, esum, csize = nearest_codes_with_stats(x, cb)
            again = nearest_codes_with_stats(x, cb)
            ref_sum = torch.zeros_like(cb).index_add_(0, ref, x)
            case = dict(set=name, shape=[n, k, d], rescored_rows=rescored,
                        equal_to_fma_kernel=bool(torch.equal(idx, ref) and torch.equal(idx2, ref)),
                        xq_is_codebook_row=bool(torch.equal(xq, cb[idx])
                                                and torch.equal(xq2, cb[idx2])),
                        cluster_size_exact=bool(torch.equal(
                            csize, torch.bincount(ref, minlength=k).float())),
                        embed_sum_rel_err=float((esum - ref_sum).abs().max()
                                                / ref_sum.abs().max()),
                        bit_reproducible=bool(torch.equal(idx, nearest_codes(x, cb)[0])) and all(
                            torch.equal(a_, b_) for a_, b_ in zip((idx2, xq2, esum, csize), again)),
                        margin_use=margin_use(torch, x, cb))
            cases.append(case)
            require(case["equal_to_fma_kernel"] and case["xq_is_codebook_row"]
                    and case["cluster_size_exact"] and case["embed_sum_rel_err"] <= sum_tol
                    and case["bit_reproducible"] and case["margin_use"] <= 1.0,
                    f"nearest-code search on an adversarial set: {case}")
    emit(dict(phase="kernels", kernel="vq_nearest (adversarial sets)", cases=cases))
    return cases


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
    rescored = int(nearest_codes.last_rescored)
    ref, _ = nearest_codes_plain(x, cb)
    fma = fma_nearest(torch, x, cb)[0].long()
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
                tol="score gap <= 2 D 2^-24 (2|x|(|ca|+|cb|) + |ca|^2 + |cb|^2) per row; "
                    "codes equal to the FMA search's",
                xq_is_codebook_row=bool(torch.equal(xq, cb[idx])),
                equal_to_fma_kernel=bool(torch.equal(idx, fma)),
                rescored_rows={"rows": rescored, "share": rescored / n},
                margin_use=margin_use(torch, x, cb))
    case["bound_ms"], case["bound_by"] = vq_bound(n, k, d)
    case["bound_ms_f32_fma"] = 2 * n * k * d / PEAK_FLOPS["float32"] * 1e3

    def lib(x, cb, cb_norm):  # two PyTorch calls: the score product and its argmin
        return torch.addmm(cb_norm, x, cb.t(), alpha=-2).argmin(1)

    time_into(case, "kernel", torch, nearest_codes, sets, only="vq_nearest")
    time_into(case, "fma_kernel", torch, lambda x, cb: fma_nearest(torch, x, cb), sets,
              only="vq_nearest")
    time_into(case, "plain", torch, nearest_codes_plain, sets)
    time_into(case, "library", torch, lib, [(x, cb, (cb * cb).sum(1)) for x, cb in sets])
    emit(case)
    require(case["mismatches_within_near_tie_bound"] and case["xq_is_codebook_row"]
            and case["equal_to_fma_kernel"] and case["margin_use"] <= 1.0,
            f"vq_nearest disagrees beyond f32 near-ties or with the FMA search: {case}")
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
        rescored = int(nearest_codes_with_stats.last_rescored)
        again = nearest_codes_with_stats(x, cb)
        ref_idx = nearest_codes_with_stats_plain(x, cb)[0]
        fma = fma_nearest(torch, x, cb)[0].long()
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
                    equal_to_fma_kernel=bool(torch.equal(idx, fma)),
                    rescored_rows={"rows": rescored, "share": rescored / x.shape[0]},
                    xq_is_codebook_row=bool(torch.equal(xq, cb[idx])),
                    embed_sum_rel_err=float((esum - ref_sum).abs().max() / ref_sum.abs().max()),
                    cluster_size_exact=bool(torch.equal(csize, ref_size)),
                    largest_cluster=int(csize.max()), empty_clusters=int((csize == 0).sum()),
                    bit_reproducible=all(torch.equal(a_, b_)
                                         for a_, b_ in zip((idx, xq, esum, csize), again)))

    n = 8 * 32 * 32  # the encoder's 32x32 latents at batch 8
    sets = [clustered(n) for _ in range(n_sets(4 * (2 * n * d + 2 * k * d)))]
    case = dict(phase="kernels", kernel="vq_nearest_train", dtype="float32", **compare(*sets[0]),
                tol=f"codes: f32 near-tie bound and equal to the FMA search's; xq, cluster_size "
                    f"exact; embed_sum {sum_tol} of the largest sum")
    case["max_abs_err"] = case["embed_sum_rel_err"]
    x_small = torch.randn((100, d), generator=g, device=dev)  # fewer rows than codes
    x_odd, cb_odd = (torch.randn((1237, 36), generator=g, device=dev),
                     torch.randn((300, 36), generator=g, device=dev))
    case["other_shapes"] = [compare(x_small, sets[0][1]), compare(x_odd, cb_odd)]
    # each input read once (x, codebook, |c|^2), each output written once
    # (idx, xq, embed_sum, cluster_size); the search's 2 N K D and the N D adds
    n_bytes = 4 * (2 * n * d + 2 * k * d + 2 * k + n)
    ops_ms, _ = vq_bound(n, k, d, extra_adds=n * d)
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    case["bound_ms"], case["bound_by"] = ((bytes_ms, "bytes") if bytes_ms >= ops_ms
                                          else (ops_ms, "operations, 3xTF32"))

    # PyTorch calls: scores, argmin, gather, zeros + index_add_ for the sums and for the
    # counts (not bincount, which waits on the host for its length: the trace of the
    # calls could then not be split per call)
    def lib(x, cb, cb_norm):
        idx = torch.addmm(cb_norm, x, cb.t(), alpha=-2).argmin(1)
        return (idx, cb.index_select(0, idx), torch.zeros_like(cb).index_add_(0, idx, x),
                torch.zeros(cb.shape[0], dtype=x.dtype, device=x.device).index_add_(
                    0, idx, torch.ones_like(idx, dtype=x.dtype)))

    time_into(case, "kernel", torch, nearest_codes_with_stats, sets, only="vq_")
    time_into(case, "stats_kernel", torch, nearest_codes_with_stats, sets, only="vq_stats")
    # the FMA search alone (the statistics kernel it ran with is gone)
    time_into(case, "fma_kernel", torch, lambda x, cb: fma_nearest(torch, x, cb), sets,
              only="vq_nearest")
    time_into(case, "plain", torch, nearest_codes_with_stats_plain, sets)
    time_into(case, "library", torch, lib, [(x, cb, (cb * cb).sum(1)) for x, cb in sets])
    case["adversarial"] = check_vq_adversarial(torch, dev, sum_tol)
    emit({key: v for key, v in case.items() if key != "adversarial"})
    for c in (case, *case["other_shapes"]):
        require(c["mismatches_within_near_tie_bound"] and c["xq_is_codebook_row"]
                and c["cluster_size_exact"] and c["embed_sum_rel_err"] <= sum_tol
                and c["bit_reproducible"] and c["equal_to_fma_kernel"],
                f"vq_nearest_train disagrees: {c}")
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


def block_patch_entropy(torch, images, p=16, nb=32, sigma=0.01, bin_range=(-1.0, 1.0)):
    """The replaced one-block-per-patch entropy kernel (`csrc/patch_entropy.cu`
    `dqvq_patch_entropy_block`, a lane per bin over every pixel) called
    directly: the time before the windowed kernel, for comparison in the same
    call. Launches are not counted."""
    from dynamicvectorquantization_torch.ops import cuda_lib

    b, h, w, _ = images.shape
    out = torch.empty((b, h // p, w // p), dtype=torch.float32, device=images.device)
    err = cuda_lib.lib().dqvq_patch_entropy_block(
        images.data_ptr(), out.data_ptr(), b, h, w, p, nb, float(bin_range[0]),
        float(bin_range[1]), 1.0 / (nb - 1), 1.0 / sigma,
        1 if images.dtype == torch.bfloat16 else 0, torch.cuda.current_stream().cuda_stream)
    cuda_lib.check(err, "block_patch_entropy")
    return out


def kernel_value_counts(torch, images, nb=32, sigma=0.01, bin_range=(-1.0, 1.0)):
    """(values not +0 in f32, values the windowed kernel evaluates, nonzero
    values outside the kernel's windows) over every pixel and bin, with the
    plain version's arithmetic (`patch_entropy_plain`) and the kernel's window
    (`window_of`)."""
    from dynamicvectorquantization_torch.ops.entropy import (
        bin_centres, gray_image, window_half_width, window_of)

    gray = gray_image(images).reshape(-1)
    bins = bin_centres(nb, float(bin_range[0]), float(bin_range[1]), images.device)
    j = torch.arange(nb, device=images.device, dtype=torch.float32)
    half = window_half_width(nb, sigma, bin_range)
    nonzero = evaluated = outside = 0
    for chunk in gray.split(1 << 18):
        r = (chunk[:, None] - bins) * (1.0 / sigma)
        live = torch.exp(-0.5 * r * r) > 0
        first, last = window_of(chunk, nb, bin_range, half)
        inside = (j >= first[:, None]) & (j <= last[:, None])
        nonzero += int(live.sum())
        evaluated += int(inside.sum())
        outside += int((live & ~inside).sum())
    return nonzero, evaluated, outside


def check_patch_entropy(torch, dev):
    """Kernel #3 on f32 images and on bf16 images (the first stage in bf16,
    whose gray image the kernel rounds as the JAX package does); returns the
    two cases. The bound counts the bytes (image read once, map written once)
    and six f32 operations for each kernel value that is not +0 in f32 on
    these images (the only ones the work needs); the replaced one-block-per-
    patch kernel is timed beside it (`before_ms`)."""
    from dynamicvectorquantization_torch.ops.entropy import (
        patch_entropy, patch_entropy_plain, window_half_width)

    b, size, p, nb = 8, 256, 16, 32
    tol = 1e-5  # f32 sums of 256 kernel values and 32 p log p terms in another order
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        elem = torch.finfo(dtype).bits // 8
        g = torch.Generator(device=dev).manual_seed(4)
        sets = [(smooth_and_noisy_images(torch, dev, g).to(dtype),)
                for _ in range(n_sets(b * size * size * 3 * elem))]
        out = patch_entropy(*sets[0])
        again = patch_entropy(*sets[0])
        ref = patch_entropy_plain(*sets[0])
        before = block_patch_entropy(torch, *sets[0])
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        nonzero, evaluated, outside = kernel_value_counts(torch, *sets[0])
        n_exp = b * size * size * nb
        # each nonzero kernel value: subtract, multiply, two multiplies, exp, add (6 f32 ops)
        n_bytes = b * size * size * 3 * elem + b * (size // p) ** 2 * 4
        bms, by = bound(n_bytes, 6 * nonzero, "float32")
        case = dict(phase="kernels", kernel="patch_entropy", shape=[b, size, size, 3], patch=p,
                    bins=nb, dtype=str(dtype).split(".")[-1], max_abs_err=err, tol=tol,
                    bit_reproducible=bool(torch.equal(out, again)),
                    before_max_abs_err=(before - ref).abs().max().item(),
                    bound_ms=bms, bound_by=by, bytes_bound_ms=bound(n_bytes, 0, "float32")[0],
                    exponentials=n_exp, nonzero_kernel_values=nonzero,
                    evaluated_kernel_values=evaluated, nonzero_outside_window=outside,
                    window_half_width=window_half_width(nb, 0.01, (-1.0, 1.0)),
                    all_values_bound_ms=bound(n_bytes, 6 * n_exp, "float32")[0],
                    library_ms=None)
        time_into(case, "kernel", torch, patch_entropy, sets, only="patch_entropy")
        time_into(case, "before", torch, lambda x: block_patch_entropy(torch, x), sets,
                  only="patch_entropy")
        time_into(case, "plain", torch, patch_entropy_plain, sets)
        case["bound_share"] = case["bound_ms"] / case["kernel_ms"]
        emit(case)
        require(err <= tol, f"patch_entropy disagrees in {dtype}: {err}")
        require(case["before_max_abs_err"] <= tol,
                f"the replaced entropy kernel disagrees in {dtype}: {case['before_max_abs_err']}")
        require(case["bit_reproducible"], f"patch_entropy is not bit-reproducible in {dtype}")
        require(outside == 0, f"the window skips nonzero kernel values: {case}")
        cases.append(case)
    return cases


def fma_strided_conv(torch, x, w, bias):
    """The FMA kernel's entry (`csrc/strided_conv_down.cu`) called directly on
    inputs the wrapper sends to the tensor cores (bf16) or to the blocked f32
    kernel (f32): the time before those replaced it, for comparison in the
    same call. Launches are not counted."""
    from dynamicvectorquantization_torch.ops import cuda_lib

    b, c, h, w_ = x.shape
    k = w.shape[0]
    out = torch.empty((b, k, (h - 2) // 2 + 1, (w_ - 2) // 2 + 1), dtype=x.dtype, device=x.device)
    err = cuda_lib.lib().dqvq_strided_conv_down(
        x.data_ptr(), w.data_ptr(), bias.data_ptr(), out.data_ptr(), b, c, h, w_, k,
        1 if x.dtype == torch.bfloat16 else 0, torch.cuda.current_stream().cuda_stream)
    cuda_lib.check(err, "fma_strided_conv")
    return out


def tc_strided_conv_without_second_pass(torch, x, w, bias):
    """The tensor-core kernel's entry (`csrc/strided_conv_down_tc.cu`) called
    directly with a cancellation threshold of 0, so it lists nothing and sums
    no output again: what the one-ulp rule's second pass costs, for
    comparison in the same call. Launches are not counted."""
    from dynamicvectorquantization_torch.ops import cuda_lib
    from dynamicvectorquantization_torch.ops.downsample import pack_weight

    b, c, h, w_ = x.shape
    k = w.shape[0]
    packed, sq = pack_weight(w)
    out = torch.empty((b, k, (h - 2) // 2 + 1, (w_ - 2) // 2 + 1), dtype=x.dtype, device=x.device)
    err = cuda_lib.lib().dqvq_strided_conv_down_tc(
        x.data_ptr(), packed.data_ptr(), sq.data_ptr(), bias.data_ptr(), out.data_ptr(), b, c, h,
        w_, k, 0.0, torch.cuda.current_stream().cuda_stream)
    cuda_lib.check(err, "tc_strided_conv_without_second_pass")
    return out


def one_rounding(torch, out, ref):
    """How far a bf16 downsample `out` lies from the plain version's `ref`, in
    bf16 ulps of the larger magnitude (`max_ulps`, `beyond_one_ulp` outputs);
    `ok` when every output is within one ulp."""
    out, ref = out.float(), ref.float()
    big = torch.maximum(out.abs(), ref.abs())
    ulp = torch.ldexp(torch.ones_like(big), torch.frexp(big)[1] - 8)
    ulps = (out - ref).abs() / ulp
    return dict(max_ulps=ulps.max().item(), beyond_one_ulp=int((ulps > 1).sum()),
                ok=bool((ulps <= 1).all()))


def cancelling_share(torch, x, w, out):
    """The share of outputs that the tensor-core kernel sums again in the
    plain version's order: |y| < CANCELLATION * ||w_k|| ||x window||."""
    import torch.nn.functional as F

    from dynamicvectorquantization_torch.ops.downsample import CANCELLATION, pack_weight_plain

    window = F.conv2d(F.pad(x.float() ** 2, (0, 1, 0, 1)),
                      torch.ones((1, x.shape[1], 3, 3), device=x.device), stride=2)
    sq = pack_weight_plain(w)[1]
    return (out.float().abs() < CANCELLATION * (sq[None, :, None, None] * window).sqrt()
            ).float().mean().item()


def check_strided_conv(torch, dev):
    """Kernel #10 at the encoder's four Downsample convs (batch 8, 256^2
    input) in f32 (the blocked f32 kernel, held to 1e-4 and equal to the FMA
    kernel bit for bit) and in bf16 (the TPU kernel's own
    dtype: f32 sums of the bf16 products and the bf16 bias, one rounding; the
    tensor-core kernel, held to the plain version's rounding: every output
    within one bf16 ulp, at most 1 % of them differing at all, with the FMA
    kernel's time beside it); returns the f32 and the bf16 cases."""
    import torch.nn.functional as F

    from dynamicvectorquantization_torch.ops.downsample import (
        strided_conv3x3_down, strided_conv3x3_down_plain)

    by_dtype = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        bf16 = dtype == torch.bfloat16
        elem = torch.finfo(dtype).bits // 8
        g = torch.Generator(device=dev).manual_seed(5)
        cases = []
        for b, c, hw in ((8, 128, 256), (8, 128, 128), (8, 256, 64), (8, 256, 32)):
            w = ((torch.rand((c, c, 3, 3), generator=g, device=dev) * 2 - 1)
                 / (9 * c) ** 0.5).to(dtype)
            bias = ((torch.rand((c,), generator=g, device=dev) * 2 - 1) / (9 * c) ** 0.5).to(dtype)
            sets = [(torch.randn((b, c, hw, hw), generator=g, device=dev).to(dtype), w, bias)
                    for _ in range(n_sets(elem * b * c * hw * hw))]
            before = (strided_conv3x3_down.tc_launches, strided_conv3x3_down.f32_blocked_launches)
            out = strided_conv3x3_down(*sets[0])
            again = strided_conv3x3_down(*sets[0])
            ref = strided_conv3x3_down_plain(*sets[0])
            torch.cuda.synchronize()
            tc = (strided_conv3x3_down.tc_launches - before[0]) // 2
            blocked = (strided_conv3x3_down.f32_blocked_launches - before[1]) // 2
            ho = hw // 2
            bms, by = bound(elem * (b * c * hw * hw + c * c * 9 + c + b * c * ho * ho),
                            2 * 9 * c * c * ho * ho * b, dname)
            case = dict(phase="kernels", kernel="strided_conv3x3_down", shape=[b, c, hw, hw],
                        out_channels=c, dtype=dname,
                        route="tensor cores" if tc else "blocked f32" if blocked else "FMA",
                        bit_reproducible=bool(torch.equal(out, again)),
                        max_abs_err=(out.float() - ref.float()).abs().max().item(),
                        mismatch_share=mismatch_share(out, ref), bound_ms=bms, bound_by=by)
            if bf16:
                # both sum in f32 and round once: equal, or a rounding that falls the other
                # way; cuDNN's bf16 convolution and the FMA kernel measured the same way
                # beside it, and the share of outputs summed again in the plain order
                rounding = one_rounding(torch, out, ref)
                library = one_rounding(torch, F.conv2d(F.pad(sets[0][0], (0, 1, 0, 1)), w, bias,
                                                       stride=2), ref)
                fma = one_rounding(torch, fma_strided_conv(torch, *sets[0]), ref)
                case.update({k: v for k, v in rounding.items() if k != "ok"},
                            library_rounding=library, fma_rounding=fma,
                            cancelling_share=cancelling_share(torch, sets[0][0], w, out),
                            mismatch_tol=0.01, tol="1 bf16 ulp; mismatch_share <= 0.01")
                ok = rounding["ok"] and case["mismatch_share"] <= 0.01 and tc == 1
            else:
                # f32 sums of 9 C <= 2304 products (|y| < ~5) in another order; the blocked
                # kernel sums in the FMA kernel's order, so their outputs are equal
                case.update(tol=1e-4, equal_to_fma_kernel=bool(torch.equal(
                    out, fma_strided_conv(torch, *sets[0]))))
                ok = (case["max_abs_err"] <= 1e-4 and tc == 0 and blocked == 1
                      and case["equal_to_fma_kernel"])
            ok = ok and case["bit_reproducible"]
            del again
            # everything a call launches: in bf16 also the weight pack (`pack_weight`)
            time_into(case, "kernel", torch, strided_conv3x3_down, sets, iters=10)
            time_into(case, "plain", torch, strided_conv3x3_down_plain, sets, iters=10)
            # the FMA kernel at the same shapes: the kernel both routes replaced
            time_into(case, "fma_kernel", torch, lambda *a: fma_strided_conv(torch, *a), sets,
                      iters=10)
            if bf16:
                time_into(case, "no_second_pass", torch,
                          lambda *a: tc_strided_conv_without_second_pass(torch, *a), sets, iters=10)
            padded = [(F.pad(x, (0, 1, 0, 1)), w_, b_) for x, w_, b_ in sets]
            del sets
            # cuDNN's convolution in the same dtype (bf16: on the tensor cores)
            time_into(case, "library", torch, lambda x, w_, b_: F.conv2d(x, w_, b_, stride=2),
                      padded, iters=10)
            del padded
            emit(case)
            require(ok, f"strided_conv3x3_down disagrees at {case['shape']} {dname}: {case}")
            cases.append(case)
        by_dtype[dname] = cases
    return by_dtype["float32"], by_dtype["bfloat16"]


def close(out, ref, atol, rtol=0.0):
    """(max abs error, whether |out - ref| <= atol + rtol |ref| everywhere), in f32."""
    out, ref = out.float(), ref.float()
    diff = (out - ref).abs()
    return diff.max().item(), bool((diff <= atol + rtol * ref.abs()).all())


def mismatch_share(out, ref):
    """The share of elements that differ at all."""
    return (out.float() != ref.float()).float().mean().item()


def tolerances(dtype_name, atol_f32, atol_bf16=2e-2):
    """bf16 outputs: one ulp of the reference value (a rounding that falls the
    other way) on top of an absolute slack; f32: the absolute tolerance alone."""
    return (atol_bf16, BF16_RTOL) if dtype_name == "bfloat16" else (atol_f32, 0.0)


def check_layernorm(torch, dev):
    import torch.nn.functional as F

    from dynamicvectorquantization_torch.ops import cuda_lib
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
        before = layernorm_backward.launches
        layernorm_backward(x, gamma, dy, eps)
        launches_per_call = layernorm_backward.launches - before
        bwd = dict(phase="kernels", kernel="layernorm_backward", shape=[b, t, d], dtype=dname,
                   max_abs_err=max(err_dx, err_dg, err_db), dx_err=err_dx, dgamma_err=err_dg,
                   dbeta_err=err_db, tol=f"dx {atol} + {rtol} |ref|; dgamma, dbeta {sum_tol}",
                   bit_reproducible=reproducible, bound_ms=bb, bound_by=bby)
        time_into(bwd, "kernel", torch, lambda x_, dy_: layernorm_backward(x_, gamma, dy_, eps),
                  sets)
        # the share of the bytes bound reached; the wrapper's launches per call (its
        # rows kernel and the reduction of the blocks' partial rows, `kernels_per_call`)
        bwd["bound_share"] = bwd["kernel_ms"] and bb / bwd["kernel_ms"]
        bwd["launches_per_call"] = launches_per_call
        bwd["kernels_per_call"] = (bwd["kernel_ms_spread"] or {}).get("kernels_per_call")
        bwd["ptxas"] = {name: use for name, use in cuda_lib.resource_usage().items()
                        if "layernorm_bwd" in name}
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
    # the stage-2 training shape in bf16; the same in f32 at batch 2 and at batch 8 (the
    # f32 stage-2 step's); one non-causal head of 64, ragged tiles; two non-causal f32
    # heads of 32 (the square tiles' route); the DQ-VAE's conv AttnBlocks in stage-1
    # training: one non-causal f32 head of 256 channels over 32 x 32 positions, and of 512
    # over 16 x 16, in f32 and in bf16 (every bf16 shape on the tensor cores, with the FMA
    # family's times beside it; f32 at hd 64 / 128 on the 3xTF32 forward and backward, the
    # square tiles held to the same tolerance and timed beside them)
    for (b, t, d), n_head, causal, dtype in (
            ((8, TRAIN_T, 1024), 8, True, torch.bfloat16),
            ((2, TRAIN_T, 1024), 8, True, torch.float32),
            ((8, TRAIN_T, 1024), 8, True, torch.float32),
            ((2, 300, 64), 1, False, torch.float32),
            ((2, 300, 64), 2, False, torch.float32),
            ((8, 1024, 256), 1, False, torch.float32),
            ((8, 256, 512), 1, False, torch.float32),
            ((8, 1024, 256), 1, False, torch.bfloat16),
            ((8, 256, 512), 1, False, torch.bfloat16)):
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
        wide = wide_f32_shape(torch, dtype, hd)
        f32tc = f32_tc_shape(torch, dtype, hd)
        square = not (tc or wide or f32tc)
        family = "tensor cores" if tc or f32tc else "FMA"
        before = (fused_attention_backward.tc_launches, fused_attention_backward.wide_f32_launches,
                  fused_attention_backward.f32_tc_launches, fused_attention_backward.fma_launches)
        y_ref, lse_ref = fused_attention_forward_plain(q, k, v, n_head, scale, causal, True)
        out = fused_attention_backward(q, k, v, y, lse, dy, n_head, scale, causal)
        again = fused_attention_backward(q, k, v, y, lse, dy, n_head, scale, causal)
        ref = fused_attention_backward_plain(q, k, v, y_ref, lse_ref, dy, n_head, scale, causal)
        torch.cuda.synchronize()
        require((fused_attention_backward.tc_launches - before[0],
                 fused_attention_backward.wide_f32_launches - before[1],
                 fused_attention_backward.f32_tc_launches - before[2],
                 fused_attention_backward.fma_launches - before[3] - 2 * int(wide))
                == (2 * int(tc), 2 * int(wide), 2 * int(f32tc), 2 * int(square)),
                f"fused_attention_backward took the wrong kernel at {dtype} hd {hd}")
        err_y, ok_y = close(y, y_ref, atol, rtol)
        err_lse, ok_lse = close(lse, lse_ref, 1e-4)  # f32 log of an f32 sum of T terms
        errs, oks = zip(*(close(o, r, atol, rtol) for o, r in zip(out, ref)))
        reproducible = all(torch.equal(a_, b_) for a_, b_ in zip(out, again))
        sq = {}
        if f32tc:  # the square tiles the 3xTF32 backward replaced, on the same inputs
            sq_out = fma_backward(torch, q, k, v, y, lse, dy, n_head, scale, causal)
            sq_again = fma_backward(torch, q, k, v, y, lse, dy, n_head, scale, causal)
            torch.cuda.synchronize()
            sq = dict(square_tiles_max_abs_err=max(close(o, r, atol, rtol)[0]
                                                   for o, r in zip(sq_out, ref)),
                      square_tiles_bit_reproducible=all(
                          torch.equal(a_, b_) for a_, b_ in zip(sq_out, sq_again)))
            del sq_out, sq_again
        f9 = {}
        if dtype == torch.bfloat16:  # F9, F10: P, D and dS rounded as the plain version
            qf, kf, vf, dyf = (z.float() for z in (q, k, v, dy))
            yf, lsef = fused_attention_forward_plain(qf, kf, vf, n_head, scale, causal, True)
            unrounded = fused_attention_backward_plain(qf, kf, vf, yf, lsef, dyf, n_head, scale,
                                                       causal)
            f9 = dict(mismatch_share=max(mismatch_share(o, r) for o, r in zip(out, ref)),
                      unrounded_mismatch_share=min(mismatch_share(u.to(dtype), r)
                                                   for u, r in zip(unrounded, ref)),
                      forward_mismatch_share=mismatch_share(y, y_ref),
                      mismatch_tol=F9_MISMATCH_SHARE)
            del qf, kf, vf, dyf, yf, lsef, unrounded
        pairs = t * (t + 1) // 2 if causal else t * t
        route = ("wide f32" if wide else "tensor cores" if tc else "f32 tensor cores"
                 if f32tc else "square tiles")
        fwd = dict(phase="kernels", kernel="fused_attention_forward", shape=[b, t, d],
                   n_head=n_head, causal=causal, dtype=dname,
                   family=family, route=route, with_lse=True,
                   max_abs_err=err_y, lse_err=err_lse, tol=f"{atol} + {rtol} |ref|; lse 1e-4")
        fwd["bound_ms"], fwd["bound_by"], fwd["bound_ms_f32_fma"] = attention_bounds(
            torch, 4 * b * t * d * elem + 4 * b * n_head * t, 4 * b * n_head * pairs * hd, dtype,
            f32tc)
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
        if wide or f32tc:  # the square-tile forward the register-blocked / 3xTF32 one replaced
            time_into(fwd, "square_tiles", torch,
                      lambda q_, k_, v_, *_: fma_forward(
                          torch, q_, k_, v_, n_head, scale, causal, return_lse=True), sets)
        emit(fwd)
        # five T x T x hd products over the unmasked pairs; the bound at the
        # rate of the input type (bf16: tensor cores; the 3xTF32 kernel: three
        # TF32 products a product), and beside it at the f32 FMA rate the FMA
        # family runs on
        flops = 10 * b * n_head * pairs * hd
        n_bytes = 8 * b * t * d * elem + 4 * b * n_head * t
        bwd = dict(phase="kernels", kernel="fused_attention_backward", shape=[b, t, d],
                   n_head=n_head, causal=causal, dtype=dname, family=family, route=route,
                   max_abs_err=max(errs),
                   dq_err=errs[0], dk_err=errs[1], dv_err=errs[2], tol=f"{atol} + {rtol} |ref|",
                   bit_reproducible=reproducible, gflop=flops / 1e9, **f9, **sq)
        bwd["bound_ms"], bwd["bound_by"], bwd["bound_ms_f32_fma"] = attention_bounds(
            torch, n_bytes, flops, dtype, f32tc)
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
        if wide:  # the square-tile kernel it replaced
            time_into(bwd, "before", torch,
                      lambda *a: fma_backward(torch, *a, n_head, scale, causal),
                      sets, iters=10)
        if f32tc:  # the square tiles the 3xTF32 backward replaced
            time_into(bwd, "square_tiles", torch,
                      lambda *a: fma_backward(torch, *a, n_head, scale, causal),
                      sets, iters=10)
        del lib_sets
        emit(bwd)
        require(ok_y and ok_lse, f"fused_attention_forward with lse disagrees at "
                                 f"{fwd['shape']}: y {err_y} lse {err_lse}")
        require(all(oks), f"fused_attention_backward disagrees at {bwd['shape']} {dname}: {errs}")
        require(reproducible, "fused_attention_backward is not bit-reproducible")
        require(not sq or (sq["square_tiles_max_abs_err"] <= atol
                           and sq["square_tiles_bit_reproducible"]),
                f"the square-tile backward disagrees or is not bit-reproducible at "
                f"{bwd['shape']}: {sq}")
        require(not f9 or max(f9["mismatch_share"], f9["forward_mismatch_share"])
                <= F9_MISMATCH_SHARE < f9["unrounded_mismatch_share"],
                f"the bf16 backward does not round as the plain version: {f9}")
        fwd_cases.append(fwd)
        bwd_cases.append(bwd)

        # the same shape with dropout: forward (with lse) and backward against the plain
        # versions at the same tolerances, the backward twice; times at rate 0.1 beside
        # SDPA's with dropout_p (forward, and backward through autograd)
        dfwd, dbwd = dict(fwd, dropout_err={}), dict(bwd, dropout_err={})
        if f32tc:
            dbwd.update(square_tiles_dropout_err={}, square_tiles_bit_reproducible=True)
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
            if f32tc:  # the square tiles on the same inputs, masks and tolerance
                sq_out = fma_backward(torch, q, k, v, yd, lsed, dy, n_head, scale, causal, rate,
                                      DROPOUT_SEED)
                sq_again = fma_backward(torch, q, k, v, yd, lsed, dy, n_head, scale, causal,
                                        rate, DROPOUT_SEED)
                torch.cuda.synchronize()
                e_sq, o_sq = zip(*(close(o, r, atol, rtol) for o, r in zip(sq_out, ref)))
                dbwd["square_tiles_dropout_err"][str(rate)] = max(e_sq)
                ok_all &= all(o_sq)
                dbwd["square_tiles_bit_reproducible"] &= all(
                    torch.equal(a_, b_) for a_, b_ in zip(sq_out, sq_again))
                del sq_out, sq_again
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
        if f32tc:
            dbwd["square_tiles_max_abs_err"] = max(dbwd["square_tiles_dropout_err"].values())
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
        if wide or f32tc:
            time_into(dfwd, "square_tiles", torch,
                      lambda q_, k_, v_, *_: fma_forward(
                          torch, q_, k_, v_, n_head, scale, causal, rate, True, DROPOUT_SEED),
                      dsets)
        if wide:
            time_into(dbwd, "before", torch,
                      lambda *a: fma_backward(torch, *a, n_head, scale, causal, rate, DROPOUT_SEED),
                      dsets, iters=10)
        if f32tc:
            time_into(dbwd, "square_tiles", torch,
                      lambda *a: fma_backward(torch, *a, n_head, scale, causal, rate, DROPOUT_SEED),
                      dsets, iters=10)
        del lib_sets, dsets
        emit(dfwd)
        emit(dbwd)
        require(ok_all, f"attention with dropout disagrees with its plain version at "
                        f"{bwd['shape']} {dname}: forward {dfwd['dropout_err']} backward "
                        f"{dbwd['dropout_err']}, square tiles "
                        f"{dbwd.get('square_tiles_dropout_err')}")
        require(repro_all and dbwd.get("square_tiles_bit_reproducible", True),
                "fused_attention_backward or the square tiles with dropout are not "
                "bit-reproducible")
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
               device_idle_share=prof["device_idle_share"],
               device_idle_share_vs_step_ms=busy_ms and 1.0 - busy_ms / step_ms,
               device_time_summed_ms_per_step=prof["device_time_summed_ms"] / 16,
               device_window_ms_per_step=prof["device_window_ms"] / 16,
               device_ops_per_step=prof["device_ops"] / 16, top_kernels=prof["top"])
    emit(res)
    require(bool(torch.isfinite(kernel).all()), "non-finite logits on the kernel path")
    require(res["max_logit_diff"] <= tol, f"kernel vs plain decode: {res['max_logit_diff']}")
    return res


def profile_device_time(torch, fn, n_top=8, groups=None):
    """Device busy time of one call of `fn` from a torch.profiler trace: the
    union of the device's intervals (`device_busy_ms`, overlapping kernels
    and copies counted once), their plain sum beside it
    (`device_time_summed_ms`), the traced window from the first interval's
    start to the last one's end (`device_window_ms`), the share of that
    window the device was idle (`device_idle_share`: busy and window from the
    same traced call, since every traced kernel runs a little longer than an
    untraced one), and the `n_top` kernels that take most of the summed time
    (ms summed per name over the call); with `groups` ({label: part of a
    kernel name}) also the summed ms of each group."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from dynamicvectorquantization_torch.utils.device_time import busy_union_ms, window_ms

    fn()  # warm-up outside the trace
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name = {}
    intervals = []
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
            intervals.append((e.time_range.start / 1e3, e.time_range.end / 1e3))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:n_top]
    busy, window = busy_union_ms(intervals), window_ms(intervals)
    require(busy <= window + 1e-9, f"busy {busy} ms outside the traced window {window} ms")
    grouped = {label: sum(ms for name, ms in by_name.items() if part in name)
               for label, part in (groups or {}).items()}
    return {"device_busy_ms": busy if busy > 0 else None,  # None: the trace held no device time
            "device_time_summed_ms": sum(by_name.values()), "device_window_ms": window,
            "device_idle_share": 1.0 - busy / window if busy > 0 else None,
            "device_ops": len(intervals), "top": [[name[:80], ms] for name, ms in top],
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
BF16_SPLIT = ("strided_conv3x3_down", "patch_entropy")


def reset_launches():
    for fn in wrappers().values():
        for attr in ("launches", "tc_launches", "fma_launches", "wide_f32_launches",
                     "f32_tc_launches", "dropout_launches", "bf16_launches",
                     "f32_blocked_launches"):
            if hasattr(fn, attr):
                setattr(fn, attr, 0)


def read_launches():
    """Launches per kernel since `reset_launches`. The attention wrappers
    have two kernel families: `<name>` counts the FMA family's launches,
    `<name>_wide_f32` those of them on the register-blocked f32 kernel (hd 256
    / 512), `<name>_square_tiles` the rest of them, `<name>_tc` the bf16
    tensor-core family's, and `<name>_dropout` those of every kernel that
    drew a dropout mask; `<name>_f32_tc` counts the 3xTF32 kernel's (f32 at
    hd 64 / 128, in neither family). The downsample and entropy wrappers have
    two instantiations: `<name>` counts the f32 launches, `<name>_bf16` the
    bf16 ones; `strided_conv3x3_down_tc` counts those of the bf16 launches
    that ran the tensor-core kernel, `strided_conv3x3_down_f32_blocked` those
    of the f32 launches that ran the blocked f32 kernel."""
    counts = {name: fn.launches for name, fn in wrappers().items()}
    for name in ATTENTION:
        fn = wrappers()[name]
        counts[name] = fn.fma_launches
        counts[f"{name}_wide_f32"] = fn.wide_f32_launches
        counts[f"{name}_square_tiles"] = fn.fma_launches - fn.wide_f32_launches
        counts[f"{name}_tc"] = fn.tc_launches
        counts[f"{name}_dropout"] = fn.dropout_launches
        counts[f"{name}_f32_tc"] = fn.f32_tc_launches
    for name in BF16_SPLIT:
        fn = wrappers()[name]
        counts[name] = fn.launches - fn.bf16_launches
        counts[f"{name}_bf16"] = fn.bf16_launches
    conv = wrappers()["strided_conv3x3_down"]
    counts["strided_conv3x3_down_tc"] = conv.tc_launches
    counts["strided_conv3x3_down_f32_blocked"] = conv.f32_blocked_launches
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


def rescored_share(quant):
    """Rows the last `nearest_codes` call rescored in the FMA order, and
    their share of its rows (those of `quant`, (B, H, W, D))."""
    from dynamicvectorquantization_torch.ops.vq import nearest_codes

    rows = quant.numel() // quant.shape[-1]
    rescored = int(nearest_codes.last_rescored)
    return {"rows": rescored, "share": rescored / rows}


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
        rescored = rescored_share(quant)
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
               launches=launches, vq_rescored_rows=rescored, encode_s=encode_s,
               encode_s_spread=spread(times), images_per_s=batch / encode_s,
               device_busy_ms=busy_ms, device_idle_share=prof["device_idle_share"],
               device_idle_share_vs_step_ms=busy_ms and 1.0 - busy_ms / encode_ms,
               device_time_summed_ms=prof["device_time_summed_ms"],
               device_window_ms=prof["device_window_ms"],
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
                       ("strided_conv3x3_down_f32_blocked", 4), ("strided_conv3x3_down_tc", 0),
                       ("fused_attention_forward", 6), ("fused_attention_forward_wide_f32", 6)):
        require(launches[name] == want,
                f"{name} launched {launches[name]} times per encode, expected {want}")
    return res, x, grain, code


def encode_bf16(torch, model, dev, card, x, grain32, code32, reps=5):
    """The same batch through the first stage cast to bf16 as the stage-2
    trainer casts it under `compute_dtype: bfloat16` (`cast_copy`: every
    floating parameter and buffer), the images cast with it: time, busy
    share, launches, and how many grain cells and codes equal the f32
    encode's (printed, not held to anything: bf16 moves features near a
    tie or an entropy near the threshold)."""
    from dynamicvectorquantization_torch.train.stage2 import cast_copy

    fs16 = cast_copy(model.first_stage_model)
    batch = x.shape[0]
    with torch.inference_mode():
        torch.cuda.synchronize()
        reset_launches()
        quant, streams = model.encode_to_z(x, fs16)
        torch.cuda.synchronize()
        launches = read_launches()
        rescored = rescored_share(quant)
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            model.encode_to_z(x, fs16)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        encode_s = spread(times)["median"]
        prof = profile_device_time(
            torch, lambda: model.encode_to_z(x, fs16), n_top=10,
            groups={"fused_attention_forward_tc": "fused_attention_fwd_tc",
                    "strided_conv3x3_down_bf16": "strided_conv_down"})
        _, _, info, grain, _, ent = fs16.encode(x.to(torch.bfloat16))
    same_grain = grain == grain32
    cells = same_grain.repeat_interleave(2, 1).repeat_interleave(2, 2)
    busy_ms = prof["device_busy_ms"]
    res = dict(phase="encode", config=P6C18, dtype="bfloat16 (first stage cast as the stage-2 "
               "trainer casts it)", batch=batch, fine_share=grain.float().mean().item(),
               grain_cells_equal_f32=same_grain.float().mean().item(),
               codes_equal_f32_in_equal_grain_cells=(info[2] == code32)[cells].float().mean()
               .item(), quant_dtype=str(quant.dtype), launches=launches,
               vq_rescored_rows=rescored, encode_s=encode_s, encode_s_spread=spread(times),
               images_per_s=batch / encode_s, device_busy_ms=busy_ms,
               device_idle_share=prof["device_idle_share"],
               device_idle_share_vs_step_ms=busy_ms and 1.0 - busy_ms / (encode_s * 1e3),
               device_time_summed_ms=prof["device_time_summed_ms"],
               device_window_ms=prof["device_window_ms"],
               device_ops=prof["device_ops"], top_kernels=prof["top"],
               device_ms_by_kernel_group=prof["groups"], card=card)
    emit(res)
    require(quant.shape[0] == batch and bool(torch.isfinite(quant).all())
            and all(int(v.shape[0]) == batch for v in streams.values()),
            "bf16 encode output of the wrong shape or not finite")
    for name, want in (("vq_nearest", 1), ("patch_entropy_bf16", 1), ("patch_entropy", 0),
                       ("strided_conv3x3_down_bf16", 4), ("strided_conv3x3_down_tc", 4),
                       ("strided_conv3x3_down", 0), ("fused_attention_forward_tc", 6),
                       ("fused_attention_forward", 0)):
        require(launches[name] == want,
                f"{name} launched {launches[name]} times per bf16 encode, expected {want}")
    return res


@contextlib.contextmanager
def tf32_matmuls(torch):
    """cuBLAS's and cuDNN's TF32 on inside the block (the script runs with it off)."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


@contextlib.contextmanager
def plain_train_path(tf32_attention=False):
    """The training path's kernel wrappers swapped for their plain versions
    (differentiated by autograd), so the same step runs without the kernels;
    with `tf32_attention` the attention forward's products run on cuBLAS's
    TF32 (one TF32 product a product, the backward in f32), a control of
    lower precision than f32."""
    import dynamicvectorquantization_torch.nn.norm as norm
    import dynamicvectorquantization_torch.nn.transformer as tfm
    import dynamicvectorquantization_torch.train.stage2 as stage2
    import torch
    from dynamicvectorquantization_torch.ops.attention import fused_attention_forward_plain
    from dynamicvectorquantization_torch.ops.fused_adamw import fused_adamw_step_plain

    saved = (norm.fused_layernorm, tfm.fused_causal_attention, stage2.fused_adamw_step)
    norm.fused_layernorm = norm.fused_layernorm_plain

    def attention(q, k, v, n_head, causal=True, rate=0.0, seed=None):
        with tf32_matmuls(torch) if tf32_attention else contextlib.nullcontext():
            return fused_attention_forward_plain(q, k, v, n_head, None, causal, False, rate, seed)

    tfm.fused_causal_attention = attention
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


def train(torch, dev, card, batch=8, n_images=16, timed_steps=4, compute_dtype="bfloat16",
          streams=None):
    """Stage-2 training at full p6c18 width and depth on cached codes: bf16
    over f32 masters (the shipped yml's `compute_dtype`), or with
    `compute_dtype` None, the JAX trainer's default, f32 throughout (f32
    weights and activations, TF32 off, attention on the 3xTF32 kernels) on the
    `streams` a bf16 run cached. Returns (the timed line, the cached streams)."""
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
                            compute_dtype=compute_dtype, device=dev)
    bf16 = compute_dtype == "bfloat16"
    dname = "bfloat16 over f32 masters" if bf16 else "float32"
    gpt = model.transformer
    load_s = time.perf_counter() - t0

    encode_s = encode_launches = None
    if streams is None:
        g = torch.Generator(device=dev).manual_seed(6)
        size = model.first_stage_model.encoder.resolution
        images = torch.cat([smooth_and_noisy_images(torch, dev, g, b=batch, size=size)
                            for _ in range(n_images // batch)])
        t0 = time.perf_counter()
        reset_launches()
        streams = trainer.encode_dataset(images.cpu().numpy(), batch=batch)
        encode_s = spread([time.perf_counter() - t0])
        encode_launches = read_launches()
        n_batches = n_images // batch
        # the cached-codes pre-encode runs the bf16 copy of the first stage (F4), its six
        # AttnBlocks on the tensor cores
        require(bf16, "the f32 run trains on the codes a bf16 run cached")
        for name, want in (("strided_conv3x3_down_bf16", 4 * n_batches),
                           ("strided_conv3x3_down_tc", 4 * n_batches),
                           ("strided_conv3x3_down", 0), ("patch_entropy_bf16", n_batches),
                           ("patch_entropy", 0), ("fused_attention_forward_tc", 6 * n_batches),
                           ("fused_attention_forward", 0)):
            require(encode_launches[name] == want, f"{name} launched {encode_launches[name]} "
                                                   f"times by encode_dataset, expected {want}")
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
    paths = [("kernel", contextlib.nullcontext()), ("plain", plain_train_path())]
    if not bf16:  # controls, each a step of lower precision than f32 (see the limits below)
        paths += [("control_tf32_matmuls", tf32_matmuls(torch)),
                  ("control_tf32_attention", plain_train_path(tf32_attention=True))]
    for path, ctx in paths:
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
    pr = results["plain"]
    n_params = sum(v.numel() for v in trainer.masters.values())

    def gaps(r):
        """(loss max rel, {leaf: gradient rel-L2}, parameter max abs, parameter
        mean abs) of a step's result against the plain step's."""
        return (max(abs(r["logs"][k] - pr["logs"][k]) / abs(pr["logs"][k]) for k in pr["logs"]),
                {k: ((r["grads"][k] - pr["grads"][k]).norm() / pr["grads"][k].norm()).item()
                 for k in watched},
                max((r["after"][k] - pr["after"][k]).abs().max().item() for k in r["after"]),
                sum((r["after"][k] - pr["after"][k]).abs().sum().item()
                    for k in r["after"]) / n_params)

    kr = results["kernel"]
    loss_rel, grad_rel, delta_max, delta_mean = gaps(kr)
    moved = max((kr["after"][k] - start[0][k]).abs().max().item() for k in kr["after"])
    pad_rows_frozen = all(torch.equal(kr["after"][k][row], start[0][k][row])
                          for k, row in trainer.pad_rows.items())
    # Adam's first update is lr * g / |g|, so a parameter differs by at most 2 lr
    # (+ decay), and only where the noise flips g's sign. bf16 activations differ by
    # ~2^-8 relative per op between the two paths and 24 layers compound it. In f32 the
    # paths differ in summation order alone (the 3xTF32 attention keeps f32 accuracy;
    # the LayerNorm and AdamW kernels sum in f32). The f32 limits sit between the
    # kernel step's readings on the H100 (loss 6.7e-8 rel, gradients 1.1e-6 rel-L2,
    # parameters max 0.32 lr / mean 1.9e-6 lr) and those of the closer of two controls,
    # the plain step whose attention forward runs one TF32 product (7.9e-7, 9.9e-5,
    # 1.97 lr / 8.4e-5 lr); the other, the kernel step with cuBLAS's TF32 on, lies
    # further out. Each control must exceed one of them (PERF.md §6)
    if bf16:
        loss_tol, grad_tol, delta_max_tol, delta_mean_tol = 2e-2, 0.1, 2.02 * lr, 0.1 * lr
    else:
        loss_tol, grad_tol, delta_max_tol, delta_mean_tol = 3e-7, 1e-5, 1.0 * lr, 1e-5 * lr
    controls = {}
    for name in (k for k in results if k.startswith("control")):
        c_loss, c_grad, c_max, c_mean = gaps(results[name])
        controls[name] = dict(loss_max_rel_diff=c_loss, grad_rel_l2_diff=c_grad,
                              param_max_abs_diff=c_max, param_mean_abs_diff=c_mean,
                              exceeds_a_limit=c_loss > loss_tol or max(c_grad.values()) > grad_tol
                              or c_max > delta_max_tol or c_mean > delta_mean_tol)
    compare = dict(phase="train", step="kernel_vs_plain", config=P6C18, attn_pdrop=attn_pdrop,
                   dropout="attention only (embedding and residual off)",
                   dtype=dname, batch=batch, seq_len=t_len,
                   lr=lr, params=n_params, losses_kernel=kr["logs"], losses_plain=pr["logs"],
                   loss_max_rel_diff=loss_rel, loss_tol=loss_tol, grad_rel_l2_diff=grad_rel,
                   grad_tol=grad_tol, param_max_abs_diff=delta_max,
                   param_max_tol=delta_max_tol, param_mean_abs_diff=delta_mean,
                   param_mean_tol=delta_mean_tol, param_max_abs_update=moved,
                   pad_rows_frozen=pad_rows_frozen, controls=controls,
                   peak_memory_gb_kernel=kr["peak_gb"], peak_memory_gb_plain=pr["peak_gb"],
                   card=card)
    emit(compare)
    require(all(math.isfinite(v) for v in kr["logs"].values()), "non-finite training loss")
    require(loss_rel <= loss_tol, f"training losses kernel vs plain: {loss_rel}")
    require(max(grad_rel.values()) <= grad_tol, f"gradients kernel vs plain: {grad_rel}")
    require(delta_max <= delta_max_tol and delta_mean <= delta_mean_tol,
            f"parameters after one step, kernel vs plain: max {delta_max} mean {delta_mean}")
    require(moved > 0 and pad_rows_frozen, "parameters did not move, or a pad row did")
    require(all(c["exceeds_a_limit"] for c in controls.values()),
            f"a control of lower precision than f32 passes the {dname} limits: {controls}")
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
    # hd 128: every attention launch on the tensor-core family in bf16, on the 3xTF32
    # kernels in f32; none on the square tiles
    family, other = ("tc", "f32_tc") if bf16 else ("f32_tc", "tc")
    expected = {f"fused_attention_forward_{family}": layers,
                f"fused_attention_backward_{family}": layers,
                f"fused_attention_forward_{other}": 0, f"fused_attention_backward_{other}": 0,
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
               resid_pdrop=resid_pdrop, dtype=dname, batch=batch,
               seq_len=t_len, stream_caps=TRAIN_CAPS, images=n_images, real_tokens=tokens,
               layers=layers, params=n_params, parameter_leaves=len(trainer.params), lr=lr,
               load_s=spread([load_s]), encode_dataset_s=encode_s,
               encode_launches=encode_launches,
               losses=losses, launches_per_step=step_launches, expected_launches=expected,
               timed_steps=timed_steps, step_ms=step_ms, step_ms_spread=step,
               images_per_s=batch / step_ms * 1e3,
               device_busy_ms=busy_ms, device_idle_share=prof["device_idle_share"],
               device_idle_share_vs_step_ms=busy_ms and 1.0 - busy_ms / step_ms,
               device_time_summed_ms=prof["device_time_summed_ms"],
               device_window_ms=prof["device_window_ms"],
               device_ops=prof["device_ops"], top_kernels=prof["top"],
               peak_memory_gb=peak_gb, card=card)
    emit(res)
    require(all(math.isfinite(v) for v in losses), f"non-finite training loss: {losses}")
    require(losses[-1] < losses[0], f"the training loss did not fall: {losses}")
    for name, want in expected.items():
        require(step_launches[name] == want,
                f"{name} launched {step_launches[name]} times per {dname} train step, "
                f"expected {want}")
    return res, streams


def train1(torch, dev, card, batch=8, timed_steps=3, compute_dtype=None):
    """Stage-1 (DQ-VAE + GAN) training of the shipped dual-grain config at
    full width and depth, f32, or with `compute_dtype` "bfloat16" (the
    DQ-VAE's bf16 compute mode, `model.params.compute_dtype=bfloat16` on the
    command line: bf16 towers over f32 parameters)."""
    from dynamicvectorquantization_torch.config.yaml_config import load_config
    from dynamicvectorquantization_torch.nn.blocks import AttnBlock
    from dynamicvectorquantization_torch.train.stage1 import B1, Stage1Trainer
    from dynamicvectorquantization_torch.utils.instantiate import instantiate_from_config

    bf16 = compute_dtype == "bfloat16"
    dname = "bfloat16 towers over f32 parameters" if bf16 else "float32"
    overrides = ["model.params.compute_dtype=bfloat16"] if bf16 else []
    config = load_config([STAGE1], overrides)["model"]
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

    # (0) one inference forward through each path, from the same state: where the two
    # paths part (the step below compares what follows from it)
    feats = {}
    hook = model.quant_conv.register_forward_hook(lambda m, i, o: feats.__setitem__("h", o))
    fwd = {}
    for path, ctx in (("kernel", contextlib.nullcontext()), ("plain", plain_encode_path())):
        with torch.no_grad(), ctx:
            quant, _, info, grain, _, _ = model.encode(x)
            fwd[path] = (model.decode(quant), grain, info[2], feats["h"].float())
    hook.remove()
    (dec_k, grain_k, code_k, h_k), (dec_p, grain_p, code_p, h_p) = fwd["kernel"], fwd["plain"]
    forward_diff = dict(
        grain_cells_differ=int((grain_k != grain_p).sum()),
        codes_differ=int((code_k != code_p).sum()), codes=code_k.numel(),
        feature_rel_l2_diff=((h_k - h_p).norm() / h_p.norm()).item(),
        feature_max_abs_diff=(h_k - h_p).abs().max().item(),
        rec_max_abs_diff=(dec_k - dec_p).abs().max().item(),
        rec_rel_l2_diff=((dec_k - dec_p).norm() / dec_p.norm()).item())
    del fwd, dec_k, dec_p, h_k, h_p

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
    agree = restarted[0] == restarted[1]
    restart_differs = int((~agree).sum())
    # over the codes whose restart decisions agree (a code that restarted on one path
    # only takes another row altogether); the padding row of `weight` agrees always
    rows = {k: torch.cat([agree, agree.new_ones(kr["ema"][k].shape[0] - agree.shape[0])])
            for k in ema_names}
    ema_err = {k: ((kr["ema"][k] - pr["ema"][k])[rows[k]].abs().max()
                   / pr["ema"][k][rows[k]].abs().max()).item() for k in ema_names}
    ema_rel_l2 = {k: ((kr["ema"][k] - pr["ema"][k])[rows[k]].norm()
                      / pr["ema"][k][rows[k]].norm()).item() for k in ema_names}
    # f32 throughout. The two paths differ in summation order inside four kernels, at
    # 1e-6; the VGG16 max-pools, the ReLU / LeakyReLU kinks and the hinge turn that into
    # discrete changes of the gradient's route, and the discriminator's gradient is taken
    # after an Adam step that moves every autoencoder parameter by +-lr whatever its
    # gradient's size, so a sign decided by noise moves the reconstruction it sees.
    # bf16 towers: the two paths' sums in another order round a few bf16 values the other
    # way (2^-8 of them; the attention kernel 1e-5 of its outputs), each conv spreads such
    # a flip over its outputs, and some of those round the other way too, so after a few
    # layers the paths differ by bf16's own noise: features 0.7 % (relative L2), 1 % of the
    # codes at near ties, 2.3 % of the reconstruction (measured on one H100). The
    # gradients see that through LPIPS and the hinge as the f32 ones see their 1e-6; the
    # EMA codebook by relative L2 (a code that took other rows moves a whole row)
    log_tol, grad_tol, ema_tol = (2e-2, 0.6, 0.1) if bf16 else (1e-3, 5e-2, 1e-3)
    fwd_tol = (dict(feature_rel_l2_diff=2e-2, codes_differ_share=3e-2, rec_rel_l2_diff=5e-2)
               if bf16 else dict(feature_rel_l2_diff=1e-4, codes_differ_share=1e-3,
                                 rec_rel_l2_diff=1e-4))
    forward_diff["codes_differ_share"] = forward_diff["codes_differ"] / forward_diff["codes"]
    compare = dict(phase="train1", step="kernel_vs_plain", config=STAGE1, dtype=dname,
                   batch=batch, lr=lr, logs_kernel=kr["logs"], logs_plain=pr["logs"],
                   log_max_rel_diff=max(log_rel.values()), log_tol=log_tol,
                   grad_rel_l2_diff=grad_rel, grad_tol=grad_tol,
                   grad_rel_l2_diff_kernel_path_twice=grad_noise, ema_max_rel_diff=ema_err,
                   ema_rel_l2_diff=ema_rel_l2, ema_tol=ema_tol,
                   forward_kernel_vs_plain=forward_diff, forward_tol=fwd_tol,
                   codes_restarted=int(restarted[0].sum()),
                   restart_decisions_differ=restart_differs,
                   peak_memory_gb_kernel=kr["peak_gb"], peak_memory_gb_plain=pr["peak_gb"],
                   card=card)
    emit(compare)
    require(all(math.isfinite(v) for v in kr["logs"].values()), "non-finite stage-1 log")
    require(all(forward_diff[k] <= tol for k, tol in fwd_tol.items()),
            f"stage-1 forward kernel vs plain: {forward_diff}")
    require(max(log_rel.values()) <= log_tol, f"stage-1 logs kernel vs plain: {log_rel}")
    require(max(grad_rel.values()) <= grad_tol, f"stage-1 gradients kernel vs plain: {grad_rel}")
    # f32: every decision equal; bf16: a code whose count sits at the restart line may
    # fall on either side
    ema_held = ema_rel_l2 if bf16 else ema_err
    require(restart_differs <= (4 if bf16 else 0) and max(ema_held.values()) <= ema_tol,
            f"EMA codebook kernel vs plain: {ema_err}, {restart_differs} restart decisions differ")
    del results, kr, pr

    # (b) timed steps on the kernel path, (c) launches per step, (d) what moved
    restore()
    updates = []
    ema_update = model.quantize._ema_update
    model.quantize._ema_update = lambda *a, **k: (updates.append(1), ema_update(*a, **k))[1]
    gen = torch.Generator(device=dev).manual_seed(13)
    # the warm-up step records the rows each of its two searches rescored
    import dynamicvectorquantization_torch.ops.vq as vq
    quantize, searched = model.quantize.forward, []

    def recording(h, *args, **kwargs):
        out = quantize(h, *args, **kwargs)
        searched.append((vq.nearest_codes_with_stats.last_rescored, h.numel() // h.shape[-1]))
        return out

    model.quantize.forward = recording
    try:
        all_logs = [trainer.train_step(x, gen)]  # warm-up step
    finally:
        del model.quantize.forward
    vq_rescored = [{"rows": int(r), "share": int(r) / rows} for r, rows in searched]
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
        groups={"fused_attention_forward": "fused_attention_fwd_",
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
    eval_rescored = int(vq.nearest_codes.last_rescored)
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
    # entropy on the f32 images either way; the Downsample convs in the towers' dtype;
    # the AttnBlocks (hd 256 / 512) on the FMA family in f32, on the tensor cores in bf16;
    # the bf16 Downsample convs on the tensor-core kernel
    conv = "strided_conv3x3_down_bf16" if bf16 else "strided_conv3x3_down"
    family, other = ("_tc", "") if bf16 else ("", "_tc")
    # the f32 ones on the blocked f32 downsample and the register-blocked attention kernels
    expected = {"vq_nearest_train": 2, "vq_nearest": 0, "patch_entropy": 2,
                "patch_entropy_bf16": 0, conv: 8, "strided_conv3x3_down_tc": 8 if bf16 else 0,
                "strided_conv3x3_down_f32_blocked": 0 if bf16 else 8,
                f"fused_attention_forward{family}": 2 * n_attn,
                f"fused_attention_backward{family}": n_attn, f"fused_attention_forward{other}": 0,
                f"fused_attention_backward{other}": 0,
                "fused_attention_forward_wide_f32": 0 if bf16 else 2 * n_attn,
                "fused_attention_backward_wide_f32": 0 if bf16 else n_attn}
    step_ms = step_s * 1e3
    busy_ms = prof["device_busy_ms"]
    res = dict(phase="train1", step="timed", config=STAGE1, dtype=dname, batch=batch, lr=lr,
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
               vq_rescored_rows_per_call=vq_rescored, eval_vq_rescored_rows=eval_rescored,
               max_abs_update=moved, lpips_frozen=lpips_frozen, timed_steps=timed_steps,
               step_ms=step_ms, step_ms_spread=spread([t * 1e3 for t in times]),
               images_per_s=batch / step_s, device_busy_ms=busy_ms,
               device_idle_share=prof["device_idle_share"],
               device_idle_share_vs_step_ms=busy_ms and 1.0 - busy_ms / step_ms,
               device_time_summed_ms=prof["device_time_summed_ms"],
               device_window_ms=prof["device_window_ms"],
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
                    expect_launched, gb_needed, grids, expect_not_launched=()):
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
    for name in expect_not_launched:
        require(launches[name] == 0, f"{phase}: {name} was launched {launches[name]} times")
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
         "strided_conv3x3_down", "strided_conv3x3_down_bf16", "strided_conv3x3_down_tc",
         "patch_entropy_bf16", "fused_attention_forward_wide_f32",
         "strided_conv3x3_down_f32_blocked", "fused_attention_forward_f32_tc"),
        gb_needed=12, grids=8, expect_not_launched=("fused_attention_forward_square_tiles",))


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
                             "strided_conv3x3_down", "strided_conv3x3_down_f32_blocked",
                             "fused_attention_forward", "fused_attention_backward",
                             "fused_attention_forward_wide_f32",
                             "fused_attention_backward_wide_f32"),
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
    layers = model.transformer.position_layer + model.transformer.content_layer
    res = dict(phase="serve", config=P6C18, kv_cache_dtype="int8", max_batch=8, layers=layers,
               requests=[n for n, _ in requests], shapes=[list(x.shape) for x in images],
               batches=batches, batch_stats=stats, launches=launches, wall_s=wall,
               wall_s_spread=spread(walls), s_per_batch=wall / batches,
               images_per_s=n_images / wall, card=card)
    emit(res)
    for (n, _), img in zip(requests, images):
        require(img.shape == (n, 256, 256, 3), f"image shape {img.shape} for {n} images")
        require(bool(np.isfinite(img).all()), "non-finite image values")
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
    ptxas = cuda_lib.resource_usage()
    emit(dict(phase="build", seconds=spread([time.perf_counter() - t0]),
              nvcc_flags=cuda_lib.NVCC_FLAGS, ptxas=ptxas))
    # the register-blocked kernels (and the tensor-core nearest-code search, the LayerNorm
    # backward's rows, the int8 decode attention) hold their blocks in registers: none may spill
    keys = ("attention_fwd_wide", "attention_bwd_wide", "strided_conv_down_f32",
            "vq_nearest_tc", "layernorm_bwd_rows", "decode_attention_int8",
            "attention_fwd_f32_tc")
    blocked = {name: use for name, use in ptxas.items() if any(key in name for key in keys)}
    require(len(blocked) >= 10 and all(any(key in name for name in blocked) for key in keys)
            and all(not use.get("spill_stores") and not use.get("spill_loads")
                    for use in blocked.values()),
            f"a register-blocked kernel spills or is missing from ptxas's report: {blocked}")

    decode_cases, decode_sweep = check_decode_attention(torch, dev)
    attn_cases, attn_drop_cases = check_fused_attention(torch, dev)
    check_attention_dropout(torch, dev)
    vq_case = check_vq_nearest(torch, dev)
    vq_train_case = check_vq_train(torch, dev)
    entropy_case, entropy16_case = check_patch_entropy(torch, dev)
    conv_cases, conv16_cases = check_strided_conv(torch, dev)
    ln_fwd_cases, ln_bwd_cases = check_layernorm(torch, dev)
    attn_train_cases, attn_bwd_cases, attn_train_drop_cases, attn_bwd_drop_cases = \
        check_attention_backward(torch, dev)
    adamw_case = check_fused_adamw(torch, dev)

    t0 = time.perf_counter()
    model, _ = load_model_and_variables(P6C18, seed=0, kv_cache_dtype="int8", device=dev)
    model.transformer.to(torch.bfloat16)
    emit(dict(phase="load", config=P6C18, seed=0, seconds=spread([time.perf_counter() - t0]),
              params=sum(p.numel() for p in model.parameters())))
    encoded, x, grain32, code32 = encode(torch, model, dev, card)
    encoded16 = encode_bf16(torch, model, dev, card, x, grain32, code32)
    del x, grain32, code32
    teacher_forced_decode(torch, model, dev)
    served = serve(torch, model, card)
    del model
    torch.cuda.empty_cache()
    trained, streams = train(torch, dev, card)
    per_step = trained["launches_per_step"]
    torch.cuda.empty_cache()
    # the JAX trainer's default compute dtype: f32 throughout, on the same cached codes
    per_step_f32 = train(torch, dev, card, compute_dtype=None,
                         streams=streams)[0]["launches_per_step"]
    del streams
    torch.cuda.empty_cache()
    per_step1 = train1(torch, dev, card)["launches_per_step"]
    torch.cuda.empty_cache()
    per_step1_bf16 = train1(torch, dev, card, compute_dtype="bfloat16")["launches_per_step"]
    torch.cuda.empty_cache()
    fitted = fit(torch, card)["launches"]
    torch.cuda.empty_cache()
    fitted1 = fit1(torch, card)["launches"]

    # the downsample lines sum the encoder's four levels (one encode batch)
    def levels(cases):
        timed = [key for key in ("kernel_ms", "plain_ms", "bound_ms", "library_ms",
                                 "fma_kernel_ms", "no_second_pass_ms") if key in cases[0]]
        return dict(cases[0], shape=[c["shape"] for c in cases],
                    max_abs_err=max(c["max_abs_err"] for c in cases),
                    mismatch_share=max(c["mismatch_share"] for c in cases),
                    bound_by="/".join(sorted({c["bound_by"] for c in cases})),
                    kernel_ms_spread=[c["kernel_ms_spread"] for c in cases],
                    per_level={str(c["shape"]): {k: c[k] for k in (
                        "route", "equal_to_fma_kernel", "max_ulps", "beyond_one_ulp",
                        "cancelling_share",
                        "library_rounding", "fma_rounding", "mismatch_share", "kernel_ms",
                        "plain_ms", "library_ms", "fma_kernel_ms", "no_second_pass_ms",
                        "bound_ms") if k in c}
                               for c in cases},
                    **{key: sum(c[key] for c in cases) for key in timed})

    conv, conv16 = levels(conv_cases), levels(conv16_cases)
    # #8 over the cache indices the served batch visited (its AR steps 0 .. ar_steps - 1:
    # the coarse steps, the fine-phase entry, the fine steps), interpolated from the sweep
    # and the four checked indices, times the layers: an estimate, not a measurement, so
    # it has a line of its own and stays out of the kernels line
    require(all(c["kernel_ms"] is not None for c in decode_cases + decode_sweep),
            "decode_attention_int8: a timed index has no trace")
    points = {c["cache_index"]: c["kernel_ms"] for c in decode_cases + decode_sweep}
    visited = range(served["batch_stats"][0]["ar_steps"])
    emit(dict(phase="serve_decode_estimate",
              served_batch_est_ms=served["layers"] * interpolated_sum(points, visited),
              served_batch_ar_steps=len(visited), layers=served["layers"]))
    paths = {"serve": served["launches"], "encode": encoded["launches"],
             "encode_bf16": encoded16["launches"], "train_step": per_step,
             "train_step_f32": per_step_f32, "train1_step": per_step1,
             "train1_step_bf16": per_step1_bf16, "fit": fitted, "fit1": fitted1}

    def launched(name):
        """Launches of a row on each driven path (for the attention rows: of
        that kernel family, every rate)."""
        return {path: counts[name] for path, counts in paths.items() if counts[name]}

    def pick(case, *keys):
        return {k: case[k] for k in keys if k in case}

    timed_keys = ("shape", "dtype", "causal", "family", "rate", "max_abs_err", "dropout_err",
                  "tol", "kernel_ms", "kernel_ms_spread", "plain_ms", "library_ms", "bound_ms",
                  "bound_by", "fma_kernel_ms", "fma_kernel_ms_spread", "bit_reproducible",
                  "gflop", "mismatch_share", "unrounded_mismatch_share", "mismatch_tol",
                  "forward_mismatch_share", "fma_max_abs_err", "f64_mismatch_share",
                  "before_ms", "before_ms_spread", "route", "square_tiles_ms",
                  "square_tiles_ms_spread", "square_tiles_max_abs_err", "square_tiles_dropout_err",
                  "lse_err", "bound_ms_f32_fma", "with_lse")
    entropy_keys = ("before_ms", "before_ms_spread", "bound_share", "bytes_bound_ms",
                    "all_values_bound_ms", "exponentials", "nonzero_kernel_values",
                    "evaluated_kernel_values", "window_half_width", "bit_reproducible")
    attn_src = "dynamicvectorquantization_tpu/ops/attention_pallas.py"
    src_dir = "dynamicvectorquantization_torch/csrc"
    # the attention cases: forward (a) f32 hd 256, t808 bf16 (tensor cores), (b) f32 hd 512,
    # (a) and (b) in bf16, stage-2 validation in f32 (3xTF32); with lse (c) bf16 (tensor
    # cores), f32 at batch 2 and at batch 8 (3xTF32), hd 64 (3xTF32), hd 32 (square tiles),
    # hd 256, hd 512, hd 256 and hd 512 bf16; each also at rate 0.1 (the `_drop` lists)
    fwd_a, fwd_t808, fwd_b, fwd_a16, fwd_b16, fwd_val = attn_cases
    dfwd_a, dfwd_t808, dfwd_b, dfwd_a16, dfwd_b16, dfwd_val = attn_drop_cases
    (fwd_c, fwd_c32, fwd_c32b8, fwd_64, fwd_32, fwd_256, fwd_512, fwd_256b,
     fwd_512b) = attn_train_cases
    dfwd_c, dfwd_c32, dfwd_c32b8, dfwd_64, dfwd_32, _, dfwd_512, _, _ = attn_train_drop_cases
    (bwd_c, bwd_c32, bwd_c32b8, bwd_64, bwd_32, bwd_256, bwd_512, bwd_256b,
     bwd_512b) = attn_bwd_cases
    (dbwd_c, dbwd_c32, dbwd_c32b8, dbwd_64, dbwd_32, dbwd_256, dbwd_512, dbwd_256b,
     dbwd_512b) = attn_bwd_drop_cases
    kernels = []
    for name, src, replaces, main, extra in (
            # main: cache_index 1283; the other checked indices and the sweep (every 128
            # positions) beside it
            ("decode_attention_int8", "decode_attention_int8.cu",
             "dynamicvectorquantization_tpu/ops/kv_int8.py:92", decode_cases[-1],
             {"cache_index": decode_cases[-1]["cache_index"],
              "bit_reproducible": all(c["bit_reproducible"] for c in decode_cases + decode_sweep),
              "device_index_equal": all(c["device_index_equal"]
                                        for c in decode_cases + decode_sweep),
              "bound_share": decode_cases[-1]["bound_share"],
              "by_index": {str(c["cache_index"]): pick(c, "kernel_ms", "plain_ms", "bound_ms",
                                                       "max_abs_err")
                           for c in decode_cases},
              "sweep_ms": {str(c["cache_index"]): c["kernel_ms"] for c in decode_sweep},
              "ptxas": {name: use for name, use in ptxas.items()
                        if "decode_attention_int8" in name}}),
            # the FMA family: f32 at every head dim (the DQ-VAE's AttnBlocks), bf16 at
            # hd 16, 32; main: the decoder's 32x32 AttnBlock, f32 at hd 256 / 512 on the
            # register-blocked kernel of fused_attention_wide.cu (the other shapes on the
            # square tiles of fused_attention.cu, whose time at the main shapes is
            # square_tiles_ms)
            ("fused_attention_forward", "fused_attention_wide.cu", f"{attn_src}:82", fwd_a,
             {"family": "FMA", "kernel_route": fwd_a["route"],
              "square_tiles_source": f"{src_dir}/fused_attention.cu",
              "square_tiles_ms": fwd_a["square_tiles_ms"],
              "square_tiles_ms_spread": fwd_a["square_tiles_ms_spread"],
              "bit_reproducible": fwd_a["bit_reproducible"],
              "wide_f32_launches": launched("fused_attention_forward_wide_f32"),
              "extra": {n_: pick(c, *timed_keys) for n_, c in (
                 ("a_rate0.1", dfwd_a), ("b_hd512_f32", fwd_b), ("b_hd512_f32_rate0.1", dfwd_b),
                 ("a_hd256_with_lse", fwd_256), ("b_hd512_with_lse", fwd_512),
                 ("b_hd512_with_lse_rate0.1", dfwd_512), ("hd32_t300_with_lse", fwd_32),
                 ("hd32_t300_with_lse_rate0.1", dfwd_32))}}),
            # f32 at hd 64 / 128 (the StackGPT's f32 masters: every stage-2 validation
            # batch; f32 stage-2 training), 3xTF32 on the tensor cores; main: the validation
            # shape; the square tiles of fused_attention.cu it replaced timed beside each case
            ("fused_attention_forward_f32_tc", "fused_attention_f32_tc.cu", f"{attn_src}:82",
             fwd_val,
             {"family": "tensor cores", "kernel_route": fwd_val["route"],
              "square_tiles_source": f"{src_dir}/fused_attention.cu",
              "square_tiles_ms": fwd_val["square_tiles_ms"],
              "square_tiles_ms_spread": fwd_val["square_tiles_ms_spread"],
              "bound_ms_f32_fma": fwd_val["bound_ms_f32_fma"], "gflop": fwd_val["gflop"],
              "bit_reproducible": fwd_val["bit_reproducible"],
              "library_ms_spread": fwd_val["library_ms_spread"],
              "extra": {n_: pick(c, *timed_keys) for n_, c in (
                  ("validation_rate0.1", dfwd_val), ("c_f32_b2_with_lse", fwd_c32),
                  ("c_f32_b2_with_lse_rate0.1", dfwd_c32), ("c_f32_b8_with_lse", fwd_c32b8),
                  ("c_f32_b8_with_lse_rate0.1", dfwd_c32b8), ("hd64_t300_with_lse", fwd_64),
                  ("hd64_t300_with_lse_rate0.1", dfwd_64))}}),
            # the tensor-core family: bf16 at hd 64 / 128 (this file) and 256 / 512
            # (fused_attention_tc_wide.cu, through this file's entry point); main: the
            # stage-2 training shape (c) at the shipped rate 0.1, with lse; the FMA
            # family's bf16 time beside each case (fma_kernel_ms)
            ("fused_attention_forward_tc", "fused_attention_tc.cu", f"{attn_src}:82", dfwd_c,
             {"family": "tensor cores", "rate": dfwd_c["rate"],
              "wide_source": f"{src_dir}/fused_attention_tc_wide.cu",
              "dropout_err": dfwd_c["dropout_err"], "fma_kernel_ms": dfwd_c["fma_kernel_ms"],
              "extra": {n_: pick(c, *timed_keys) for n_, c in (
                  ("c_rate0", fwd_c), ("t808_no_lse", fwd_t808),
                  ("t808_no_lse_rate0.1", dfwd_t808),
                  ("a_bf16_hd256", fwd_a16), ("a_bf16_hd256_rate0.1", dfwd_a16),
                  ("b_bf16_hd512", fwd_b16), ("b_bf16_hd512_rate0.1", dfwd_b16),
                  ("a_bf16_hd256_with_lse", fwd_256b), ("b_bf16_hd512_with_lse", fwd_512b))}}),
            # f32 at hd 256 / 512 (main: (a)) runs the register-blocked kernel of
            # fused_attention_bwd_wide.cu, f32 and bf16 at hd 16 / 32 the square tiles of
            # fused_attention_bwd.cu; before_ms: the square tiles at the main shapes
            ("fused_attention_backward", "fused_attention_bwd_wide.cu", f"{attn_src}:108",
             bwd_256,
             {"family": "FMA", "bit_reproducible": bwd_256["bit_reproducible"],
              "square_tiles_source": f"{src_dir}/fused_attention_bwd.cu",
              "wide_f32_launches": launched("fused_attention_backward_wide_f32"),
              "before_ms": bwd_256["before_ms"], "before_ms_spread": bwd_256["before_ms_spread"],
              "extra": {n_: pick(c, *timed_keys) for n_, c in (
                  ("a_hd256_rate0.1", dbwd_256), ("b_hd512", bwd_512),
                  ("b_hd512_rate0.1", dbwd_512), ("hd32_t300", bwd_32),
                  ("hd32_t300_rate0.1", dbwd_32))}}),
            # f32 at hd 64 / 128 (the StackGPT's f32 masters: f32 stage-2 training), 3xTF32
            # on the tensor cores; main: the f32 stage-2 step's shape at the shipped rate
            # 0.1; the square tiles of fused_attention_bwd.cu it replaced held to the same
            # tolerance and timed beside each case (square_tiles_max_abs_err, _ms)
            ("fused_attention_backward_f32_tc", "fused_attention_bwd_f32_tc.cu",
             f"{attn_src}:108", dbwd_c32b8,
             {"family": "tensor cores", "kernel_route": dbwd_c32b8["route"],
              "rate": dbwd_c32b8["rate"], "dropout_err": dbwd_c32b8["dropout_err"],
              "square_tiles_source": f"{src_dir}/fused_attention_bwd.cu",
              "square_tiles_ms": dbwd_c32b8["square_tiles_ms"],
              "square_tiles_ms_spread": dbwd_c32b8["square_tiles_ms_spread"],
              "square_tiles_max_abs_err": dbwd_c32b8["square_tiles_max_abs_err"],
              "square_tiles_bit_reproducible": all(
                  c["square_tiles_bit_reproducible"] for c in (
                      bwd_c32b8, dbwd_c32b8, bwd_c32, dbwd_c32, bwd_64, dbwd_64)),
              "bound_ms_f32_fma": dbwd_c32b8["bound_ms_f32_fma"], "gflop": dbwd_c32b8["gflop"],
              "bit_reproducible": dbwd_c32b8["bit_reproducible"],
              "library_ms_spread": dbwd_c32b8["library_ms_spread"],
              "ptxas": {name: use for name, use in ptxas.items()
                        if "attention_bwd_f32_tc" in name},
              "extra": {n_: pick(c, *timed_keys) for n_, c in (
                  ("c_f32_b8_rate0", bwd_c32b8), ("c_f32_b2", bwd_c32),
                  ("c_f32_b2_rate0.1", dbwd_c32), ("hd64_t300", bwd_64),
                  ("hd64_t300_rate0.1", dbwd_64))}}),
            ("fused_attention_backward_tc", "fused_attention_bwd_tc.cu", f"{attn_src}:108",
             dbwd_c,
             {"family": "tensor cores", "rate": dbwd_c["rate"],
              "wide_source": f"{src_dir}/fused_attention_bwd_tc_wide.cu",
              "dropout_err": dbwd_c["dropout_err"],
              "bit_reproducible": dbwd_c["bit_reproducible"],
              "fma_kernel_ms": dbwd_c["fma_kernel_ms"],
              "bound_ms_f32_fma": dbwd_c["bound_ms_f32_fma"],
              "extra": {n_: pick(c, *timed_keys) for n_, c in (
                  ("c_rate0", bwd_c), ("a_bf16_hd256", bwd_256b),
                  ("a_bf16_hd256_rate0.1", dbwd_256b), ("b_bf16_hd512", bwd_512b),
                  ("b_bf16_hd512_rate0.1", dbwd_512b))}}),
        ("layernorm_forward", "layernorm.cu",
             "dynamicvectorquantization_tpu/ops/layernorm_pallas.py:46", ln_fwd_cases[0], {}),
            # main: bf16, the stage-2 trainer's dtype; f32 beside it
            ("layernorm_backward", "layernorm_bwd.cu",
             "dynamicvectorquantization_tpu/ops/layernorm_pallas.py:56", ln_bwd_cases[0],
             {k: ln_bwd_cases[0][k] for k in ("bit_reproducible", "bound_share",
                                              "launches_per_call", "kernels_per_call", "ptxas")}
             | {"f32": pick(ln_bwd_cases[1], "kernel_ms", "kernel_ms_spread", "plain_ms",
                            "library_ms", "bound_ms", "bound_share", "max_abs_err",
                            "bit_reproducible")}),
            ("fused_adamw", "fused_adamw.cu",
             "dynamicvectorquantization_tpu/ops/fused_adamw.py:39", adamw_case, {}),
            # 3xTF32 on the tensor cores, near-tie rows rescored in the FMA search's order
            # (`fma_source`, timed at the same shapes: `fma_kernel_ms`), so the codes
            # equal its own; the adversarial sets' results under vq_nearest_train
            ("vq_nearest", "vq_nearest_tc.cu",
             "dynamicvectorquantization_tpu/ops/vq_pallas.py:42", vq_case,
             {k: vq_case[k] for k in ("mismatched_rows", "equal_to_fma_kernel", "rescored_rows",
                                      "margin_use", "fma_kernel_ms", "fma_kernel_ms_spread",
                                      "bound_ms_f32_fma")}
             | {"fma_source": f"{src_dir}/vq_nearest.cu"}),
            ("vq_nearest_train", "vq_nearest_tc.cu",
             "dynamicvectorquantization_tpu/ops/vq_pallas.py:57", vq_train_case,
             {k: vq_train_case[k] for k in ("mismatched_rows", "equal_to_fma_kernel",
                                            "rescored_rows", "bit_reproducible",
                                            "stats_kernel_ms", "fma_kernel_ms",
                                            "fma_kernel_ms_spread", "largest_cluster",
                                            "empty_clusters", "adversarial")}
             | {"stats_source": f"{src_dir}/vq_stats.cu",
                "fma_source": f"{src_dir}/vq_nearest.cu"}),
            # a warp per patch over windows of bins; before_ms: the replaced one-block-per-
            # patch design at the same inputs; the bound counts the nonzero kernel values
            ("patch_entropy", "patch_entropy.cu",
             "dynamicvectorquantization_tpu/ops/entropy.py:118", entropy_case,
             pick(entropy_case, *entropy_keys)),
            # bf16 images: the gray image rounded as the JAX package rounds it
            ("patch_entropy_bf16", "patch_entropy.cu",
             "dynamicvectorquantization_tpu/ops/entropy.py:118", entropy16_case,
             pick(entropy16_case, *entropy_keys) | {"dtype": "bfloat16"}),
            # f32 with C % 4 == 0 (every f32 Downsample): the blocked f32 kernel, weight
            # pack included; other C: the FMA kernel (`fma_source`), timed at the same
            # shapes (`fma_kernel_ms`) and equal to it bit for bit
            ("strided_conv3x3_down", "strided_conv_down_f32.cu",
             "dynamicvectorquantization_tpu/ops/downsample_pallas.py:45", conv,
             {"fma_source": f"{src_dir}/strided_conv_down.cu",
              "fma_kernel_ms": conv["fma_kernel_ms"],
              "equal_to_fma_kernel": all(c["equal_to_fma_kernel"] for c in conv_cases),
              "bit_reproducible": all(c["bit_reproducible"] for c in conv_cases),
              "f32_blocked_launches": launched("strided_conv3x3_down_f32_blocked"),
              "per_level": conv["per_level"]}),
            # the TPU kernel's own dtype: bf16 in, f32 sums, one rounding, on the tensor
            # cores (C a multiple of 8; other C: the FMA kernel, `fma_source`, whose time
            # at the same shapes is `fma_kernel_ms`)
            ("strided_conv3x3_down_bf16", "strided_conv_down_tc.cu",
             "dynamicvectorquantization_tpu/ops/downsample_pallas.py:45", conv16,
             {"dtype": "bfloat16", "mismatch_share": conv16["mismatch_share"],
              "max_ulps": max(c["max_ulps"] for c in conv16_cases),
              "beyond_one_ulp": sum(c["beyond_one_ulp"] for c in conv16_cases),
              "fma_source": f"{src_dir}/strided_conv_down.cu",
              "fma_kernel_ms": conv16["fma_kernel_ms"],
              # the same kernel with nothing summed again: the one-ulp rule's cost
              "no_second_pass_ms": conv16["no_second_pass_ms"],
              "tc_launches": sum(launched("strided_conv3x3_down_tc").values()),
              "per_level": conv16["per_level"]})):
        launches = launched(name)
        kernels.append(dict(
            name=name, route="cuda", source=f"{src_dir}/{src}",
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
