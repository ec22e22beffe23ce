#!/usr/bin/env python3
"""Drive the PyTorch port (`dynamicvectorquantization_torch`) on one NVIDIA
GPU and check it end to end. Needs one CUDA card and the CUDA toolkit (nvcc);
builds the kernels from `dynamicvectorquantization_torch/csrc/` at first use.

    python3 chip_smoke.py

Phases, each printed as one JSON line (any failure exits non-zero):
  1. card      name and power limit (nvidia-smi), TF32 off for f32 phases
  2. kernels   each CUDA kernel against its plain-PyTorch version at the
               serving path's shapes: error vs the stated tolerance, kernel /
               plain / library times (device time from a profiler trace, and
               wall time from CUDA events; inputs rotated through more than
               the 50 MB L2 cache), and the bound from bytes or operations at
               the H100's peak rates
  3. decode    full-width p6c18 StackGPT with int8 KV caches, seeded random
               weights, bf16, batch 8: 64 teacher-forced steps through the
               kernel path vs the plain path, max logit difference; then a
               torch.profiler trace of 16 steps for the device's busy time
  4. serve     BatchingSampler (p6c18, int8 caches, max_batch 8) answers 3
               concurrent requests of 1, 2 and 4 images; launch counters are
               zeroed just before and read just after
  5. kernels   one line listing every ported kernel, its launches on the
               serving run and its measured numbers
The last line is {"ok": true, "device": {...}}. Imports nothing of JAX.
"""
import json
import os
import subprocess
import sys
import time

P6C18 = "configs/stage2/uncond_imagenet_p6c18.yml"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, data sheet
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}  # f32 without tensor cores; bf16 dense
L2_BYTES = 50 * 2 ** 20


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


def time_ms(torch, fn, arg_sets, iters=20):
    """(device ms, wall ms) per call over `iters` calls cycling through
    `arg_sets` (together larger than L2, so each call finds its inputs
    cold). Device ms: the summed durations of the CUDA kernels the calls
    launched, from a torch.profiler (CUPTI) trace. Wall ms: CUDA events around
    the back-to-back calls, which include the host's launch overhead when
    that exceeds the kernels' time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn(*arg_sets[0])
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*arg_sets[i % len(arg_sets)])
    end.record()
    end.synchronize()
    wall = start.elapsed_time(end) / iters
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            fn(*arg_sets[i % len(arg_sets)])
        torch.cuda.synchronize()
    device_us = sum(e.time_range.elapsed_us() for e in prof.events()
                    if e.device_type == DeviceType.CUDA)
    return (device_us / 1e3 / iters if device_us > 0 else None), wall


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
        case["kernel_ms"], case["kernel_wall_ms"] = time_ms(
            torch, lambda *a: decode_attention_int8(*a, idx), sets)
        case["plain_ms"], case["plain_wall_ms"] = time_ms(
            torch, lambda *a: decode_attention_int8_plain(*a, idx), sets)
        emit(case)
        require(err <= tol, f"decode_attention_int8 disagrees at cache_index {idx}: {err}")
        cases.append(case)
    return cases


def check_fused_attention(torch, dev):
    import torch.nn.functional as F

    from dynamicvectorquantization_torch.ops.attention import (
        fused_attention_forward, fused_attention_forward_plain)

    cases = []
    # DQ-VAE decoder AttnBlock at 32x32 (f32, one head) and a StackGPT-like
    # causal bf16 shape (808 tokens, 8 heads)
    for (b, t, d), n_head, causal, dtype, tol in (
            ((8, 1024, 256), 1, False, torch.float32, 1e-4),
            ((8, 808, 1024), 8, True, torch.bfloat16, 2e-2)):
        hd = d // n_head
        scale = hd ** -0.5
        g = torch.Generator(device=dev).manual_seed(1)
        elem = torch.finfo(dtype).bits // 8
        sets = [tuple(torch.randn((b, t, d), generator=g, device=dev).to(dtype)
                      for _ in range(3)) for _ in range(n_sets(4 * b * t * d * elem))]

        def lib(q, k, v):
            def heads(z):
                return z.view(b, t, n_head, hd).transpose(1, 2)
            return F.scaled_dot_product_attention(heads(q), heads(k), heads(v),
                                                  is_causal=causal, scale=scale)

        out = fused_attention_forward(*sets[0], n_head, scale, causal)
        ref = fused_attention_forward_plain(*sets[0], n_head, scale, causal)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        pairs = t * (t + 1) // 2 if causal else t * t
        dname = str(dtype).split(".")[-1]
        bms, by = bound(4 * b * t * d * elem, 4 * b * n_head * pairs * hd, dname)
        case = dict(phase="kernels", kernel="fused_attention_forward", shape=[b, t, d],
                    n_head=n_head, causal=causal, dtype=dname, max_abs_err=err, tol=tol,
                    bound_ms=bms, bound_by=by)
        case["kernel_ms"], case["kernel_wall_ms"] = time_ms(
            torch, lambda *a: fused_attention_forward(*a, n_head, scale, causal), sets)
        case["plain_ms"], case["plain_wall_ms"] = time_ms(
            torch, lambda *a: fused_attention_forward_plain(*a, n_head, scale, causal), sets)
        case["library_ms"], case["library_wall_ms"] = time_ms(torch, lib, sets)
        emit(case)
        require(err <= tol, f"fused_attention_forward disagrees at {case['shape']}: {err}")
        cases.append(case)
    return cases


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
        prof = profile_device_time(torch, lambda: run(16))
    diff = (kernel - plain).abs()
    step_ms = kernel_s / steps * 1e3
    busy_ms = prof["device_busy_ms"] and prof["device_busy_ms"] / 16
    res = dict(phase="decode", config=P6C18, kv_cache_dtype="int8", dtype="bfloat16",
               batch=batch, steps=steps, max_logit_diff=diff.max().item(),
               mean_logit_diff=diff.mean().item(), logit_std=plain.std().item(), tol=tol,
               kernel_path_s=kernel_s, step_ms=step_ms, device_busy_ms_per_step=busy_ms,
               device_idle_share=busy_ms and 1.0 - busy_ms / step_ms,
               device_ops_per_step=prof["device_ops"] / 16, top_kernels=prof["top"])
    emit(res)
    require(bool(torch.isfinite(kernel).all()), "non-finite logits on the kernel path")
    require(res["max_logit_diff"] <= tol, f"kernel vs plain decode: {res['max_logit_diff']}")
    return res


def profile_device_time(torch, fn):
    """Device busy time of one call of `fn` from a torch.profiler trace, and
    the kernels that take most of it (ms summed over the call)."""
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
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    busy = sum(by_name.values())
    return {"device_busy_ms": busy if busy > 0 else None,  # None: the trace held no device time
            "device_ops": launches, "top": [[name[:80], ms] for name, ms in top]}


def serve(torch, model, card):
    import numpy as np

    from dynamicvectorquantization_torch.ops.attention import fused_attention_forward
    from dynamicvectorquantization_torch.ops.kv_int8 import decode_attention_int8
    from dynamicvectorquantization_torch.serve import BatchingSampler

    requests = [(1, 101), (2, 102), (4, 103)]
    with BatchingSampler(model, max_batch=8, max_wait_ms=200.0) as engine:
        torch.cuda.synchronize()
        decode_attention_int8.launches = 0
        fused_attention_forward.launches = 0
        t0 = time.perf_counter()
        futures = [engine.submit(n, seed=s) for n, s in requests]
        images = [f.result(timeout=900) for f in futures]
        wall = time.perf_counter() - t0
        launches = {"decode_attention_int8": decode_attention_int8.launches,
                    "fused_attention_forward": fused_attention_forward.launches}
        batches, stats = engine.batches_run, list(engine.batch_stats)
    n_images = sum(n for n, _ in requests)
    res = dict(phase="serve", config=P6C18, kv_cache_dtype="int8", max_batch=8,
               requests=[n for n, _ in requests], shapes=[list(x.shape) for x in images],
               batches=batches, batch_stats=stats, launches=launches, wall_s=wall,
               s_per_batch=wall / batches, images_per_s=n_images / wall, card=card)
    emit(res)
    for (n, _), img in zip(requests, images):
        require(img.shape == (n, 256, 256, 3), f"image shape {img.shape} for {n} images")
        require(bool(np.isfinite(img).all()), "non-finite image values")
    layers = model.transformer.position_layer + model.transformer.content_layer
    require(launches["decode_attention_int8"] >= layers * sum(st["ar_steps"] for st in stats),
            "decode_attention_int8 was not launched on every decode step")
    require(launches["fused_attention_forward"] == 4 * batches,
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
    emit(dict(phase="build", seconds=time.perf_counter() - t0, nvcc_flags=cuda_lib.NVCC_FLAGS))

    decode_cases = check_decode_attention(torch, dev)
    attn_cases = check_fused_attention(torch, dev)

    t0 = time.perf_counter()
    model, _ = load_model_and_variables(P6C18, seed=0, kv_cache_dtype="int8", device=dev)
    model.transformer.to(torch.bfloat16)
    emit(dict(phase="load", config=P6C18, seed=0, seconds=time.perf_counter() - t0,
              params=sum(p.numel() for p in model.parameters())))
    teacher_forced_decode(torch, model, dev)
    served = serve(torch, model, card)

    main_decode = decode_cases[-1]  # cache_index 1283, the longest prefix served
    main_attn = attn_cases[0]  # the decoder's (8, 1024, 256) f32 AttnBlock
    kernels = []
    for name, src, replaces, main in (
            ("decode_attention_int8", "decode_attention_int8.cu",
             "dynamicvectorquantization_tpu/ops/kv_int8.py:92", main_decode),
            ("fused_attention_forward", "fused_attention.cu",
             "dynamicvectorquantization_tpu/ops/attention_pallas.py:82", main_attn)):
        kernels.append(dict(
            name=name, route="cuda", source=f"dynamicvectorquantization_torch/csrc/{src}",
            replaces=replaces, launches=served["launches"][name],
            max_abs_err=main["max_abs_err"], tol=main["tol"], ms=main["kernel_ms"],
            plain_ms=main["plain_ms"], bound_ms=main["bound_ms"], bound_by=main["bound_by"],
            library_ms=main["library_ms"], shape=main["shape"], card=card))
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
