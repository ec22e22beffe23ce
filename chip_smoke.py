#!/usr/bin/env python3
"""Drive the PyTorch port (`dynamicvectorquantization_torch`) on one NVIDIA
GPU and check it end to end. Needs one CUDA card and the CUDA toolkit (nvcc);
builds the kernels from `dynamicvectorquantization_torch/csrc/` at first use.

    python3 chip_smoke.py

Phases, each printed as one JSON line (any failure exits non-zero):
  1. card      name and power limit (nvidia-smi), TF32 off for f32 phases
  2. kernels   each CUDA kernel against its plain-PyTorch version at the
               shapes of the encode and serving paths: error vs the stated
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
  6. kernels   one line listing every ported kernel, its launches on the
               encode and serving runs and its measured numbers
The last line is {"ok": true, "device": {...}}. Imports nothing of JAX.
"""
import contextlib
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


def time_ms(torch, fn, arg_sets, iters=20, only=None):
    """(device ms, wall ms) per call over `iters` calls cycling through
    `arg_sets` (together larger than L2, so each call finds its inputs
    cold). Device ms: the summed durations of the CUDA kernels the calls
    launched (only those whose name contains `only`, when given), from a
    torch.profiler (CUPTI) trace. Wall ms: CUDA events around the
    back-to-back calls, which include the host's launch overhead when that
    exceeds the kernels' time, and every op the call launches."""
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
                    if e.device_type == DeviceType.CUDA and (only is None or only in e.name))
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
    # DQ-VAE AttnBlock at 32x32 (decoder and encoder; f32, one head), a
    # StackGPT-like causal bf16 shape (808 tokens, 8 heads), and the encoder's
    # AttnBlock at 16x16 (one head of 512 channels)
    for (b, t, d), n_head, causal, dtype, tol in (
            ((8, 1024, 256), 1, False, torch.float32, 1e-4),
            ((8, 808, 1024), 8, True, torch.bfloat16, 2e-2),
            ((8, 256, 512), 1, False, torch.float32, 1e-4)):
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

    case["kernel_ms"], case["kernel_wall_ms"] = time_ms(torch, nearest_codes, sets,
                                                        only="vq_nearest")
    case["plain_ms"], case["plain_wall_ms"] = time_ms(torch, nearest_codes_plain, sets)
    case["library_ms"], case["library_wall_ms"] = time_ms(
        torch, lib, [(x, cb, (cb * cb).sum(1)) for x, cb in sets])
    emit(case)
    require(case["mismatches_within_near_tie_bound"] and case["xq_is_codebook_row"],
            f"vq_nearest disagrees beyond f32 near-ties: {case}")
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
    case["kernel_ms"], case["kernel_wall_ms"] = time_ms(torch, patch_entropy, sets,
                                                        only="patch_entropy")
    case["plain_ms"], case["plain_wall_ms"] = time_ms(torch, patch_entropy_plain, sets)
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
        case["kernel_ms"], case["kernel_wall_ms"] = time_ms(
            torch, strided_conv3x3_down, sets, iters=10, only="strided_conv_down")
        case["plain_ms"], case["plain_wall_ms"] = time_ms(
            torch, strided_conv3x3_down_plain, sets, iters=10)
        padded = [(F.pad(x, (0, 1, 0, 1)), w_, b_) for x, w_, b_ in sets]
        del sets
        case["library_ms"], case["library_wall_ms"] = time_ms(
            torch, lambda x, w_, b_: F.conv2d(x, w_, b_, stride=2), padded, iters=10)
        del padded
        emit(case)
        require(err <= tol, f"strided_conv3x3_down disagrees at {case['shape']}: {err}")
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


def wrappers():
    """name -> the wrapper whose `.launches` counts that kernel's launches."""
    from dynamicvectorquantization_torch.ops.attention import fused_attention_forward
    from dynamicvectorquantization_torch.ops.downsample import strided_conv3x3_down
    from dynamicvectorquantization_torch.ops.entropy import patch_entropy
    from dynamicvectorquantization_torch.ops.kv_int8 import decode_attention_int8
    from dynamicvectorquantization_torch.ops.vq import nearest_codes

    return {"decode_attention_int8": decode_attention_int8,
            "fused_attention_forward": fused_attention_forward,
            "vq_nearest": nearest_codes, "patch_entropy": patch_entropy,
            "strided_conv3x3_down": strided_conv3x3_down}


def reset_launches():
    for fn in wrappers().values():
        fn.launches = 0


def read_launches():
    return {name: fn.launches for name, fn in wrappers().items()}


@contextlib.contextmanager
def plain_encode_path():
    """The encode path's four kernel wrappers swapped for their plain
    versions, so the same model runs without the kernels on the card."""
    import dynamicvectorquantization_torch.models.dqvae as dqvae
    import dynamicvectorquantization_torch.nn.blocks as blocks
    import dynamicvectorquantization_torch.ops.vq as vq
    from dynamicvectorquantization_torch.ops.attention import fused_attention_forward_plain
    from dynamicvectorquantization_torch.ops.downsample import strided_conv3x3_down_plain
    from dynamicvectorquantization_torch.ops.entropy import patch_entropy_plain

    saved = (dqvae.patch_entropy, blocks.strided_conv3x3_down, blocks.fused_attention_forward,
             vq.nearest_codes)
    dqvae.patch_entropy = patch_entropy_plain
    blocks.strided_conv3x3_down = strided_conv3x3_down_plain
    blocks.fused_attention_forward = fused_attention_forward_plain
    vq.nearest_codes = lambda x, cb, use_pallas=None: vq.nearest_codes_plain(x, cb)
    try:
        yield
    finally:
        (dqvae.patch_entropy, blocks.strided_conv3x3_down, blocks.fused_attention_forward,
         vq.nearest_codes) = saved


def encode(torch, model, dev, card, batch=8, reps=3):
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
        t0 = time.perf_counter()
        for _ in range(reps):
            model.encode_to_z(x)
        torch.cuda.synchronize()
        encode_s = (time.perf_counter() - t0) / reps
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
               launches=launches, encode_s=encode_s, images_per_s=batch / encode_s,
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


def serve(torch, model, card):
    import numpy as np

    from dynamicvectorquantization_torch.serve import BatchingSampler

    requests = [(1, 101), (2, 102), (4, 103)]
    with BatchingSampler(model, max_batch=8, max_wait_ms=200.0) as engine:
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        futures = [engine.submit(n, seed=s) for n, s in requests]
        images = [f.result(timeout=900) for f in futures]
        wall = time.perf_counter() - t0
        launches = read_launches()
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
    vq_case = check_vq_nearest(torch, dev)
    entropy_case = check_patch_entropy(torch, dev)
    conv_cases = check_strided_conv(torch, dev)

    t0 = time.perf_counter()
    model, _ = load_model_and_variables(P6C18, seed=0, kv_cache_dtype="int8", device=dev)
    model.transformer.to(torch.bfloat16)
    emit(dict(phase="load", config=P6C18, seed=0, seconds=time.perf_counter() - t0,
              params=sum(p.numel() for p in model.parameters())))
    encoded = encode(torch, model, dev, card)
    teacher_forced_decode(torch, model, dev)
    served = serve(torch, model, card)

    # the downsample line sums the encoder's four levels (one encode batch)
    conv = dict(conv_cases[0], shape=[c["shape"] for c in conv_cases],
                max_abs_err=max(c["max_abs_err"] for c in conv_cases),
                bound_by="/".join(sorted({c["bound_by"] for c in conv_cases})),
                **{key: sum(c[key] for c in conv_cases)
                   for key in ("kernel_ms", "plain_ms", "bound_ms", "library_ms")})
    attn_hd512 = {k: attn_cases[2][k] for k in ("shape", "max_abs_err", "kernel_ms", "plain_ms",
                                                "bound_ms", "library_ms")}
    kernels = []
    for name, src, replaces, main, launches, extra in (
            ("decode_attention_int8", "decode_attention_int8.cu",
             "dynamicvectorquantization_tpu/ops/kv_int8.py:92", decode_cases[-1],
             {"serve": served["launches"]["decode_attention_int8"]}, {}),
            ("fused_attention_forward", "fused_attention.cu",
             "dynamicvectorquantization_tpu/ops/attention_pallas.py:82", attn_cases[0],
             {"serve": served["launches"]["fused_attention_forward"],
              "encode": encoded["launches"]["fused_attention_forward"]},
             {"encoder_hd512": attn_hd512}),
            ("vq_nearest", "vq_nearest.cu", "dynamicvectorquantization_tpu/ops/vq_pallas.py:42",
             vq_case, {"encode": encoded["launches"]["vq_nearest"]},
             {"mismatched_rows": vq_case["mismatched_rows"]}),
            ("patch_entropy", "patch_entropy.cu",
             "dynamicvectorquantization_tpu/ops/entropy.py:118", entropy_case,
             {"encode": encoded["launches"]["patch_entropy"]}, {}),
            ("strided_conv3x3_down", "strided_conv_down.cu",
             "dynamicvectorquantization_tpu/ops/downsample_pallas.py:45", conv,
             {"encode": encoded["launches"]["strided_conv3x3_down"]}, {})):
        kernels.append(dict(
            name=name, route="cuda", source=f"dynamicvectorquantization_torch/csrc/{src}",
            replaces=replaces, launches=sum(launches.values()), launches_by_path=launches,
            max_abs_err=main["max_abs_err"], tol=main["tol"], ms=main["kernel_ms"],
            plain_ms=main["plain_ms"], bound_ms=main["bound_ms"], bound_by=main["bound_by"],
            library_ms=main["library_ms"], shape=main["shape"], card=card, **extra))
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
