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
               int8 decode attention at four cache indices with bf16 and with f32
               queries and, kernel only, every 128 positions to 1283 (two calls
               equal, the device-index entry equal to the host-index one at
               each); the LayerNorm
               backward's share of its bytes bound, launches and ptxas report; the
               triple-grain config's new shapes: the patch entropy at 32^2 patches,
               the f32 downsample at 16^2 x 512 -> 8^2 (with the tiling the
               kernel reports it launched),
               the f32 attention forward and backward at (8, 64, 512); every
               attention family's entries with a head offset (a tensor-parallel
               rank's heads: `head0`, `n_head_total`), forward with lse and
               backward at rate 0.1, seed by value and on the device, bit-equal
               to the slice of the call over every head; the sp ring's tick,
               the 3xTF32 family without the causal mask at hd 128 with lse
               (8, 161, 1024), against its plain version with its bounds; #4 /
               #5 at hd 104 (taming's faces transformer, (4, 256, 1664), 16
               heads) zero-padded to the 3xTF32 kernels' 128, and #4 at the
               CLIP text tower's (8, 77, 512), against the plain versions with
               SDPA's time and the real head dim's bound
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
               torch.profiler trace of 16 steps for the device's busy time;
               then the same 64 steps as replays of a CUDA graph of
               `STEPS_PER_READ` masked steps with a device index (logits equal
               to the eager device-index run's bit for bit; step ms, busy,
               idle share, capture seconds, graph pool bytes)
  5. serve     BatchingSampler (p6c18, int8 caches, max_batch 8) answers 3
               concurrent requests of 1, 2 and 4 images, 4 times: the first
               batch captures the sampler's CUDA graphs, 3 are timed (no traced
               batch: `utils/sample_wall.py` traces one); launch counters
               (counted through graph replays) are zeroed just before and read
               just after the first and the second batch; the decode kernel's
               time over the indices the batch visited, estimated from the
               sweep (and from the replaced kernel's recorded times)
     http      the HTTP front end (`serve/http.py`, `python -m
               dynamicvectorquantization_torch.serve`) in-process over the same
               model on 127.0.0.1, port 0, max_batch 2: the warm-up image
               (which captures the graphs before the server listens), then 3
               timed POSTs of 2 images (PNGs decoded by a zlib reader here; no
               traced request: `serve` traces this sampler) and GET /healthz;
               launches of the first POST
     graph_vs_eager  the sampler's graphs against its eager loop (`eager=True`,
               reached by no entry point) on the same model at 4 rows with int8
               and with float caches: greedy tokens, and with int8 caches
               seeded sampled (top-k 300 / 100) ones, AR steps and the
               generator's offset identical
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
               backward (24 + 24 a step), none on the square tiles; then all of
               the bf16 run again for the class-conditional
               `configs/stage2/class_imagenet_p6c18.yml` (phase `class_train`:
               vocabulary 2026, position tables 1258 / 2026) on the same cached
               codes with 16 seeded labels in [0, 1000)
     class_sample  one of that model's `log_images` grids (the loop's free
               `samples_from_scratch`) for 4 labels on its f32 masters with int8
               caches (f32 queries through the decode kernel), 5 times (first:
               captures, 3 timed, the last traced): wall time and AR steps,
               every sampled token inside the class model's code / position
               ranges, every grid equal to the first; then `graph_vs_eager`
               (greedy) on the masters
     ddp       the distributed path (`parallel/`) on the one card: a
               process group of one rank over NCCL; the bf16 p6c18 cached-codes
               step (batch 8, dropout 0, graph replays) one-process, DDP with
               the collectives captured in the step's graph, ZeRO-1 and FSDP,
               each after a capture step taking 4 steps whose logs, masters and
               moments must equal the one-process steps' bit for bit, then 3
               timed windows of 4 steps and one traced (busy, idle share, NCCL
               kernels' ms, launches); the stage-1 yml at batch 8 in f32 (cuDNN
               deterministic) one-process, DDP, ZeRO-1, FSDP: one step whose
               logs, parameters, buffers, moments and generator must equal bit
               for bit the one-process step's with the distributed BatchNorm
               formula (two sums), itself held to the plain step by
               `BN_FORMULA_TOL`, 2 timed steps; then two gloo ranks sharing the card
               (`--ddp-rank` subprocesses, f32 p6c18, two steps on their halves
               of global batches of 8) held to one process over the global
               batches (`DDP_GLOO_TOL`), or a line saying gloo refused CUDA
               tensors. No run on two cards: the machine has one
     model_parallel  `--tp 2`, `--pp 2` (2 microbatches, 9 content layers a
               stage) and `--sp 5` (161 rows a rank) at p6c18 full width and
               depth over the train phase's cached codes, two steps on global
               batches of 8, as gloo ranks sharing the card (`--mp-rank`
               subprocesses), each held to one process on the same batches
               (`MP_TOL`), in f32 with TF32 off as `ddp`'s gloo ranks: tp with
               the three dropouts at 0.1 (the head offset
               gives it the one-process masks), pp and sp at 0 (their blocks
               draw per rank); each rank's step seconds, peak memory, launches
               of #4 / #5 / #6 / #7 / #9 a step and the bytes its collectives
               were handed
  7. train1    full-width, full-depth DQ-VAE + GAN of the shipped
               `dqvae-entropy-dual-r05_imagenet.yml` (f32, TF32 off, seeded random
               weights, random VGG16 backbone with the bundled LPIPS lin heads),
               batch 8 of the encode phase's images: one `Stage1Trainer.train_step`
               through the kernels against one through the plain versions from
               the same state and generator seed (logs, EMA codebook, watched
               gradients); then 2 timed steps, launch counters per step, a
               torch.profiler trace of one step, peak memory, one `eval_step`;
               then all of it again with `compute_dtype=bfloat16` (bf16 towers
               over f32 parameters, the bf16 downsample launched, the AttnBlocks
               on the tensor-core family); then, as `train1_dual_feat` and
               `train1_triple`, the two other shipped stage-1 ymls
               (`dqvae-dual-r-05_imagenet.yml`: the feature router's Gumbel gate;
               `dqvae-triple-r-03-03_imagenet.yml`: triple grain) in f32 without
               the plain-path step: timed steps, launches, the fine / median
               ratios and budget loss, and one step taken twice from one state
               (`load_state_dict` of a copy), bit-equal; all of these without
               `remat`, as before it was ported
     train1_remat  the first yml, f32, batch 8, cuDNN deterministic: one
               step with `remat` against one without from one state and
               generator seed, without and with ResnetBlock dropout 0.1 (a yml
               override): bit-equal, else the largest difference per group
               within `REMAT_TOL`; the remat step's launches (AttnBlock
               forwards three a step: the recompute's); timed steps and peak
               allocated / reserved memory with and without `remat`
     train1_b30  the first yml at its own batch 30 with `remat` at its
               default (on), f32 and bf16 towers: as `train1` without the
               plain-path step (warm-up, launches asserted, 2 timed steps, a
               traced step with each hand-written kernel's device ms a launch,
               peak allocated / reserved memory)
     encode_triple  the triple-grain yml's DQ-VAE at full width, f32, on the
               encode batch: seconds, images/s, coarse / median / fine shares,
               launches, grains and codes against the plain path
  8. sample_cli  `python -m dynamicvectorquantization_torch.sample.val`
               (with grids) and `...sample.images` as subprocesses (this script
               in `--launches-of` mode round each, to count their launches and
               time their sampling calls) on the p6c18 yml with seeded f32
               weights, int8 caches: `sample.val` 5 batches of 8 (the first pays
               the process's captures, 4 timed; none traced),
               `sample.images` one; the pickles, the grid and the eight PNGs
               read back, seconds a batch
     eval      the evaluation entry points in one process (`evaluate`): FID of
               `sample.val`'s 40 images against 40 seeded images (seeded
               InceptionV3 weights; and the proxy features), the first stage's
               rFID, and its rFID over the image fixtures (JPEG, PNG, CMYK,
               grey files through the port's reader), `codebook_usage`,
               `codebook_pca`, `parity_report` on
               stand-ins with its `sample_fid` leg; seconds, values, variant,
               the InceptionV3 forward's images/s, launches
  9. fit       the port's training command line (`train/cli.py` `main`), called
               in-process on the shipped p6c18 config at full width and depth
               with only data and run-length overrides (synthetic 256^2 images,
               batch 8, 2 epochs of 4 steps, the train phase's stream caps): one
               run of both epochs with an image grid, then epoch 1 alone and a
               `--resume` for epoch 2; metric rows, falling loss, checkpoint
               files, the resumed run equal to the uninterrupted one bit for bit
               (final val_loss, a hash of the f32 masters), launch counters (the
               pre-encode in bf16, validation in f32 on the 3xTF32 forward, none
               on the square tiles),
               seconds per epoch by `loop_buckets.json`; the `checkpoint`
               bucket a save with the writer thread (the whole run) and
               with the save on the training thread (the stopped run), and the
               wait for the last write at the end of the fit
  10. fit1     the same for stage 1 (`dqvae-entropy-dual-r05_imagenet.yml`, batch
               8, two epochs of two steps, resume), with `remat`, the trainer's
               default on the card
     legacy_stage1  the fixed-length baselines (`legacy_stage1`): #1 / #2 at
               the VQGAN's and the RQ-VAE's shapes (K 1,024 and 16,384) against
               the plain version; VQGAN f16-1024 through the command line over
               16 + 16 committed JPEGs with `disc_start` 0 (resume bit-equal),
               then in-process (step ms, peak memory, busy / idle, launches
               per step, codes -> decode against `forward`); one step for each
               legacy quantizer; RQ-VAE 8x8x4 x 16,384, three steps (#2 8 a
               step); each StyleGAN discriminator, one step at 256^2
     legacy_stage2  the fixed-length stage-2 baselines (`legacy_stage2`): #4 /
               #5 and #6 / #7 at the cin transformer's shapes, #1 at its
               first stage's K 16,384, against the plain versions; taming's
               class-conditional ImageNet transformer (48 x 1,536, 24 heads,
               16,384 codes) from its yml with seeded weights over 4 committed
               JPEGs: encode, forward + loss + backward against the plain
               step, greedy sampling held to the teacher-forced argmax, a
               top-k draw and decode; the RQ-Transformer: a step, one
               sampled image, decode
     t2i       text-to-image at full width: the p6c18 transformer with its first
               stage as `T2IDualformer` over the CLIP ViT-B/32 text tower
               (seeded, byte-level vocabulary), bf16 over f32 masters, batch 8
               of seeded 256^2 images with 8 captions, both variants (captions
               encoded and dropped; consumed by cross-attention): the text
               tower's ms, one inline-encode step through the kernels against
               the plain step (`T2I_TOL`), then counted steps (ms, peak memory,
               launches a step asserted: #4 / #5 on the tensor cores, #4 3xTF32
               in the tower, #6 / #7 with `ln_x`, #9 a leaf, #1 / #3 / #10 in
               the encode), a traced step; `mask_pad_attention` on the cached
               codes of the same images, three graph-replayed steps against
               three eager ones, bit for bit (its masked route launches no #4 /
               #5), a traced eager step, and one layer's masked route by parts
               (the Philox keep mask, rate 0.1 and 0) beside #4 + #5
     data_real  real image files, PIL blocked: the host libraries' build and
               the JPEG decoder in use (libjpeg where it builds, else the port's
               own), the committed fixtures (`tests/fixtures/images/`) read and
               transformed by the port against `expected.json` (the JAX
               package's arrays, bit for bit), four of them cut at 0.3, 0.6 and
               0.95 of their length at every denominator against
               `expected_cut.json` (PIL's libjpeg-turbo), one image's decode /
               resize ms,
               `PrefetchLoader` images/s at 1 and 8 workers over an
               ImageNet tree of 512 JPEG files and an FFHQ tree of 64 PNGs of
               1024^2; the shipped stage-1 yml trained from the JPEG tree by the
               command line at its batch 30 with 8 workers (f32, `remat`; 4
               steps, each between two synchronises, the `pull` bucket against
               the step, launches a step as `train1_b30`'s; validation on 2
               batches); `calculate_entropy_thresholds` over the tree against
               the plain entropy on the same batches (#3's launches), and
               `visualize_dual_grain` of 16 files (its PNG read back by the
               port)
     campaign  the two campaign tools: the thresholds tool over the whole
               committed train tree (`artifacts/campaign_r05/data`, 3,072
               JPEGs) against the committed table (1e-6 + 1e-4 |ref|);
               `tools.campaign_product --skip_data` at full width over 32 + 8
               of its files, one epoch a stage, 8 samples, every leg a
               process counted by `--launches-of`; `tools.convergence_campaign`
               stage1 / stage2 / finalize, 4 steps each; each leg's kernels
               asserted (`CAMPAIGN_KERNELS`), checkpoints deleted
 11. script    the script's seconds
     kernels   one line listing every ported kernel, its launches on each
               driven path (counted through graph replays) and its measured
               numbers
The last line is {"ok": true, "device": {...}}. Imports nothing of JAX.
"""
import contextlib
import gc
import json
import math
import os
import shutil
import subprocess
import sys
import time

P6C18 = "configs/stage2/uncond_imagenet_p6c18.yml"
CLASS_P6C18 = "configs/stage2/class_imagenet_p6c18.yml"
STAGE1 = "configs/stage1/dqvae-entropy-dual-r05_imagenet.yml"
DUAL_FEAT = "configs/stage1/dqvae-dual-r-05_imagenet.yml"
TRIPLE = "configs/stage1/dqvae-triple-r-03-03_imagenet.yml"
EVAL_DUMP = os.path.abspath(os.path.join("build", "eval_dump"))  # sample_cli's pickles, for eval
# image files made from seeded arrays, with the JAX package's arrays in expected.json
FIXTURES = os.path.join("tests", "fixtures", "images")
FIXTURE_JPEGS = ("n01_rgb420_q90.JPEG", "rgb444_q85.jpg", "gray_q90.jpg", "progressive_q80.jpeg",
                 "large_q75.jpg")
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


# the committed campaign data (3,072 + 256 JPEGs) and the JAX campaign's thresholds over it
CAMPAIGN_DATA = os.path.join("artifacts", "campaign_r05", "data")
CAMPAIGN_THRESHOLDS = os.path.join("artifacts", "campaign_r05", "thresholds",
                                   "entropy_thresholds_imagenet_train_patch-16.json")
LAUNCHES_FILE_ENV = "CHIP_SMOKE_LAUNCHES_FILE"
# the kernels each campaign leg must launch: #3 in the tool, #2 / #4 / #5 / #10 in stage 1,
# #4 / #5 / #6 / #7 / #9 in stage 2 (attention: any family)
CAMPAIGN_KERNELS = {
    "thresholds": ("patch_entropy",),
    "stage1": ("vq_nearest_train", "fused_attention_forward", "fused_attention_backward",
               "strided_conv3x3_down"),
    "stage2": ("fused_attention_forward", "fused_attention_backward", "layernorm_forward",
               "layernorm_backward", "fused_adamw")}


_T0 = time.perf_counter()


def emit(obj):
    """One JSON line; a phase's line also carries the script's seconds so far."""
    if "phase" in obj:
        obj = {**obj, "elapsed_s": time.perf_counter() - _T0}
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


def pick_keys(case, *keys):
    """The entries of `case` under `keys` that it has."""
    return {k: case[k] for k in keys if k in case}


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
    equal), with bf16 queries (the bf16 transformer of the served model) and
    with f32 queries (the f32 parameters of the sampling entry points and the
    loop's image grids); then, bf16 only, a kernel-only sweep of cache_index
    every 128 positions (and 1283) with the same two equalities at each.
    Returns (the bf16 cases, the sweep, the f32 cases)."""
    from dynamicvectorquantization_torch.ops.kv_int8 import (
        decode_attention_int8, decode_attention_int8_plain, quantize_kv)

    b, h, t, hd = 8, 8, 1536, 128  # p6c18: batch 8, 8 heads, 1284 -> 1536 positions
    # bf16 output: one rounding of values |y| < 1 (ulp <= 2^-8); f32: summation order
    # only, as tests/test_torch_kv_int8.py
    tols = {"bfloat16": 1e-2, "float32": 1e-5}
    g = torch.Generator(device=dev).manual_seed(0)
    set_bytes = 2 * b * h * t * (hd + 4)
    sets = []
    for _ in range(n_sets(set_bytes)):
        q = torch.randn((b, h, 1, hd), generator=g, device=dev).to(torch.bfloat16)
        kq, ks = quantize_kv(torch.randn((b, h, t, hd), generator=g, device=dev) * 2)
        vq, vs = quantize_kv(torch.randn((b, h, t, hd), generator=g, device=dev))
        sets.append((q, kq, vq, ks, vs))

    sets_by_dtype = {"bfloat16": sets, "float32": [(s[0].float(),) + s[1:] for s in sets]}

    def equalities(idx, sets=sets):
        out = decode_attention_int8(*sets[0], idx)
        again = decode_attention_int8(*sets[0], idx)
        on_device = decode_attention_int8(
            *sets[0], torch.tensor(idx, dtype=torch.int32, device=dev))
        torch.cuda.synchronize()
        return out, bool(torch.equal(out, again)), bool(torch.equal(out, on_device))

    def bound_at(idx, q_bytes=2):
        """q read and the output written in the queries' dtype, the filled
        prefix of both int8 caches and their f32 scales read once."""
        n = idx + 1
        return bound(2 * b * h * hd * q_bytes + 2 * b * h * n * (hd + 4), 4 * b * h * n * hd,
                     "float32")

    cases = {}
    for dtype, dsets in sets_by_dtype.items():
        tol, cases[dtype] = tols[dtype], []
        for idx in (0, 255, 256, 1283):
            out, reproducible, device_equal = equalities(idx, dsets)
            ref = decode_attention_int8_plain(*dsets[0], idx)
            torch.cuda.synchronize()
            require(out.dtype == getattr(torch, dtype), f"decode_attention_int8 gave {out.dtype}")
            err = (out.float() - ref.float()).abs().max().item()
            bms, by = bound_at(idx, dsets[0][0].element_size())
            case = dict(phase="kernels", kernel="decode_attention_int8", shape=[b, h, t, hd],
                        dtype=dtype, cache_index=idx, max_abs_err=err, tol=tol,
                        bit_reproducible=reproducible, device_index_equal=device_equal,
                        library_ms=None, bound_ms=bms, bound_by=by)
            time_into(case, "kernel", torch, lambda *a: decode_attention_int8(*a, idx), dsets)
            time_into(case, "plain", torch, lambda *a: decode_attention_int8_plain(*a, idx),
                      dsets)
            case["bound_share"] = case["kernel_ms"] and bms / case["kernel_ms"]
            emit(case)
            require(err <= tol, f"decode_attention_int8 ({dtype} queries) disagrees at "
                                f"cache_index {idx}: {err}")
            require(reproducible and device_equal,
                    f"decode_attention_int8 ({dtype} queries) at cache_index {idx}: two calls "
                    f"equal {reproducible}, device index equal to the host index {device_equal}")
            cases[dtype].append(case)
    del sets_by_dtype
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
    return cases["bfloat16"], sweep, cases["float32"]


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
        1 if q.dtype == torch.bfloat16 else 0, float(rate), int(seed) if rate else 0, n_head, 0,
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
        int(seed) if rate else 0, n_head, 0, torch.cuda.current_stream().cuda_stream)
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


def check_vq_nearest(torch, dev, n=8 * 32 * 32, k=1024, label=None, path="legacy_stage1"):
    """#1 against the plain version on N(0, 1) rows and codes, D 256; by
    default at the encoder's 32x32 latents at batch 8, with `label` at a
    fixed-length baseline's shape (phase `path`)."""
    from dynamicvectorquantization_torch.ops.vq import nearest_codes, nearest_codes_plain

    d = 256
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
                **({} if label is None else dict(path=path, label=label)),
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


def check_vq_train(torch, dev, n=8 * 32 * 32, k=1024, label=None):
    """#2 against the plain version on rows round uneven clusters, D 256; by
    default at the encoder's 32x32 latents at batch 8 with two other shapes
    and the adversarial sets, with `label` at a fixed-length baseline's shape
    alone (`legacy_stage1`)."""
    from dynamicvectorquantization_torch.ops.vq import (
        nearest_codes_with_stats, nearest_codes_with_stats_plain)

    d = 256
    sum_tol = 1e-4  # relative to the largest sum: f32 additions of up to ~1,000 rows in another order
    g = torch.Generator(device=dev).manual_seed(12)

    def clustered(n):
        """Rows scattered round 700 of the K codes with skewed weights, so
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

    sets = [clustered(n) for _ in range(n_sets(4 * (2 * n * d + 2 * k * d)))]
    case = dict(phase="kernels", kernel="vq_nearest_train", dtype="float32",
                **({} if label is None else dict(path="legacy_stage1", label=label)),
                **compare(*sets[0]),
                tol=f"codes: f32 near-tie bound and equal to the FMA search's; xq, cluster_size "
                    f"exact; embed_sum {sum_tol} of the largest sum")
    case["max_abs_err"] = case["embed_sum_rel_err"]
    case["other_shapes"] = []
    if label is None:
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
    if label is None:
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
    whose gray image the kernel rounds as the JAX package does) at 16^2
    patches, and on f32 images at 32^2 patches (1,024 pixels a patch over the
    same two warps: `TripleGrainFixedEntropyRouter`'s patches on a 256^2
    triple-grain model); returns the three cases. The bound counts the bytes
    (image read once, map written once) and six f32 operations for each
    kernel value that is not +0 in f32 on these images (the only ones the work
    needs); the replaced one-block-per-patch kernel is timed beside it
    (`before_ms`)."""
    from dynamicvectorquantization_torch.ops.entropy import (
        patch_entropy, patch_entropy_plain, window_half_width)

    b, size, nb = 8, 256, 32
    # f32 sums of 256 (1,024) kernel values and 32 p log p terms in another order
    tol = 1e-5
    cases = []
    for dtype, p in ((torch.float32, 16), (torch.bfloat16, 16), (torch.float32, 32)):
        elem = torch.finfo(dtype).bits // 8
        g = torch.Generator(device=dev).manual_seed(4)
        sets = [(smooth_and_noisy_images(torch, dev, g).to(dtype),)
                for _ in range(n_sets(b * size * size * 3 * elem))]
        out = patch_entropy(*sets[0], p)
        again = patch_entropy(*sets[0], p)
        ref = patch_entropy_plain(*sets[0], p)
        before = block_patch_entropy(torch, *sets[0], p)
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
        time_into(case, "kernel", torch, lambda x: patch_entropy(x, p), sets,
                  only="patch_entropy")
        time_into(case, "before", torch, lambda x: block_patch_entropy(torch, x, p), sets,
                  only="patch_entropy")
        time_into(case, "plain", torch, lambda x: patch_entropy_plain(x, p), sets)
        case["bound_share"] = case["bound_ms"] / case["kernel_ms"]
        emit(case)
        require(err <= tol, f"patch_entropy disagrees in {dtype} at {p}^2: {err}")
        require(case["before_max_abs_err"] <= tol,
                f"the replaced entropy kernel disagrees in {dtype} at {p}^2: "
                f"{case['before_max_abs_err']}")
        require(case["bit_reproducible"],
                f"patch_entropy is not bit-reproducible in {dtype} at {p}^2")
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
    kernel's time beside it); then in f32 at the triple-grain encoder's fifth
    level, 16^2 x 512 -> 8^2, with the tiling the kernel reports it took
    (`last_f32_tiling`). Returns the f32 and
    the bf16 cases of the four levels, and the triple-grain case."""
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
        for b, c, hw in ((8, 128, 256), (8, 128, 128), (8, 256, 64), (8, 256, 32),
                         *(() if bf16 else ((8, 512, 16),))):
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
                    out, fma_strided_conv(torch, *sets[0]))),
                    **strided_conv3x3_down.last_f32_tiling)
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
    return by_dtype["float32"][:4], by_dtype["bfloat16"], by_dtype["float32"][4]


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
    # square tiles held to the same tolerance and timed beside them); last, the triple-grain
    # encoder's coarse head: one f32 head of 512 over 8 x 8 positions (T below a row tile)
    for (b, t, d), n_head, causal, dtype in (
            ((8, TRAIN_T, 1024), 8, True, torch.bfloat16),
            ((2, TRAIN_T, 1024), 8, True, torch.float32),
            ((8, TRAIN_T, 1024), 8, True, torch.float32),
            ((2, 300, 64), 1, False, torch.float32),
            ((2, 300, 64), 2, False, torch.float32),
            ((8, 1024, 256), 1, False, torch.float32),
            ((8, 256, 512), 1, False, torch.float32),
            ((8, 1024, 256), 1, False, torch.bfloat16),
            ((8, 256, 512), 1, False, torch.bfloat16),
            ((8, 64, 512), 1, False, torch.float32)):
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
                # the by-value entry, the plain version, the entry that reads lr, c1, c2
                # from a device tensor (a captured step's)
                state = [[p0.clone(), torch.zeros_like(p0), torch.zeros_like(p0),
                          torch.empty_like(p0, dtype=torch.bfloat16)] for _ in range(3)]
                errs, copy_equal, device_equal = [], True, True
                for count in range(2):
                    grad = (1e-3 * torch.randn(shape, generator=g, device=dev)).to(gdtype)
                    scal = adamw_scalars(count, lr)
                    on_device = (torch.tensor(scal, device=dev), None, None)
                    for (p, m, v, c), fn, args in zip(
                            state, (fused_adamw_step, fused_adamw_step_plain, fused_adamw_step),
                            (scal, scal, on_device)):
                        fn(grad, p, m, v, *args, wd=wd, copy=c)
                    torch.cuda.synchronize()
                    errs += [close(a_, b_, tol)[0] for a_, b_ in zip(state[0][:3], state[1][:3])]
                    copy_equal &= bool(torch.equal(state[0][3], state[0][0].to(torch.bfloat16)))
                    device_equal &= all(torch.equal(a_, b_) for a_, b_ in zip(state[0], state[2]))
                case = dict(phase="kernels", kernel="fused_adamw", shape=list(shape),
                            grad_dtype=str(gdtype).split(".")[-1], weight_decay=wd, steps=2,
                            max_abs_err=max(errs), tol=tol, copy_bit_equal=copy_equal,
                            device_scalars_equal=device_equal)
                cases.append(case)
                require(max(errs) <= tol and copy_equal and device_equal,
                        f"fused_adamw disagrees: {case}")
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
                 max_abs_err=max(c["max_abs_err"] for c in cases), tol=tol,
                 device_scalars_equal=all(c["device_scalars_equal"] for c in cases))
    timed["bound_ms"], timed["bound_by"] = bound(n_bytes, 15 * n, "float32")
    time_into(timed, "kernel", torch,
              lambda g_, p, m, v, c: fused_adamw_step(g_, p, m, v, *scal, wd=0.01, copy=c), sets)
    time_into(timed, "plain", torch,
              lambda g_, p, m, v, c: fused_adamw_step_plain(g_, p, m, v, *scal, wd=0.01, copy=c),
              sets)
    on_device = torch.tensor(scal, device=dev)
    time_into(timed, "device_scalars", torch,
              lambda g_, p, m, v, c: fused_adamw_step(g_, p, m, v, on_device, wd=0.01, copy=c),
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


def check_device_seeds(torch, dev):
    """Each attention family's `_device_seed` C entries (the seed read from a
    device int64, as a captured training step reads its seed table) against
    its by-value entries, forward with lse and backward at rate 0.1, bit for
    bit, at a shape of the path each family runs; the kept set of the
    forward against `dropout_keep_mask`. Returns {family: equal}."""
    from dynamicvectorquantization_torch.ops import attention as att

    seed, rate = 2 ** 63 + 1717, 0.1
    table = torch.tensor([seed - 2 ** 64], dtype=torch.int64, device=dev)
    g = torch.Generator(device=dev).manual_seed(17)
    # (family, dtype, (B, T, D), heads): stage 2's two hd-128 families at the step's shape,
    # the DQ-VAE's hd 256 in both dtypes, the square tiles at two heads of 32
    shapes = (("tensor cores", torch.bfloat16, (8, 805, 1024), 8),
              ("f32 tensor cores", torch.float32, (8, 805, 1024), 8),
              ("tensor cores wide", torch.bfloat16, (8, 1024, 256), 1),
              ("wide f32", torch.float32, (8, 1024, 256), 1),
              ("square tiles", torch.float32, (2, 300, 64), 2),
              ("square tiles bf16", torch.bfloat16, (2, 300, 64), 2))
    results = {}
    for family, dtype, shape, n_head in shapes:
        q, k, v, dy = (torch.randn(shape, generator=g, device=dev).to(dtype) for _ in range(4))
        outs = []
        for s_ in (seed, table[0]):
            y, lse = att.fused_attention_forward(q, k, v, n_head, None, True, rate, True, s_)
            outs.append((y, lse, *att.fused_attention_backward(q, k, v, y, lse, dy, n_head,
                                                               rate=rate, seed=s_)))
        torch.cuda.synchronize()
        equal = all(torch.equal(a, b) for a, b in zip(*outs))
        # the kept set: zero scores (uniform probabilities), V rows unit vectors
        b, t, d = shape
        hd = d // n_head
        n = min(hd, t)
        unit = torch.zeros((b, t, n_head, hd), device=dev)
        unit[:, torch.arange(n), :, torch.arange(n)] = 1.0
        zero = torch.zeros_like(q)
        y = att.fused_attention_forward(zero, zero, unit.reshape(shape).to(dtype).contiguous(),
                                        n_head, None, False, rate, seed=table[0])
        kept = y.view(b, t, n_head, hd).transpose(1, 2)[..., :n] > 0
        mask_equal = bool(torch.equal(
            kept, att.dropout_keep_mask(seed, b, n_head, t, rate, dev)[..., :n]))
        results[family] = dict(shape=list(shape), dtype=str(dtype).split(".")[-1],
                               n_head=n_head, route=att._route((q, k, v), n_head, "check"),
                               device_seed_equal=equal, mask_equal=mask_equal)
        del q, k, v, dy, outs, unit, zero, y
    emit(dict(phase="kernels", kernel="attention_device_seed", rate=rate, cases=results))
    require(all(r["device_seed_equal"] and r["mask_equal"] for r in results.values()),
            f"an attention family's device-seed entry differs from its by-value entry: {results}")
    return results


def teacher_forced_decode(torch, model, dev, steps=64, batch=8):
    """Kernel path vs plain path on the same full-width bf16 model (eager,
    host indices); then the same steps as replays of a CUDA graph of
    `STEPS_PER_READ` masked steps with a device index, whose logits must
    equal the same steps run eagerly with the device index bit for bit
    (`utils/sample_wall.py` `graph_decode`), timed beside the eager step."""
    import dynamicvectorquantization_torch.nn.transformer as tfm
    from dynamicvectorquantization_torch.models.dqtransformer import STEPS_PER_READ
    from dynamicvectorquantization_torch.ops.kv_int8 import decode_attention_int8_plain
    from dynamicvectorquantization_torch.utils import sample_wall as sw

    gpt = model.transformer
    tol = 0.1  # bf16 activations: ~2^-8 relative per op over 24 layers; logit std ~0.6
    tokens = sw.teacher_forced_tokens(torch, dev, batch, steps)

    def run(n):
        return sw.teacher_forced_eager(torch, gpt, tokens, n)

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
        graph = sw.graph_decode(torch, gpt, tokens, STEPS_PER_READ, kernel)[0]
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
               device_ops_per_step=prof["device_ops"] / 16, top_kernels=prof["top"],
               graph_replay=graph)
    emit(res)
    require(bool(torch.isfinite(kernel).all()), "non-finite logits on the kernel path")
    require(res["max_logit_diff"] <= tol, f"kernel vs plain decode: {res['max_logit_diff']}")
    require(graph["equal_to_eager_device_index"],
            "the graph's logits differ from the eager device-index run's")
    return res


def profile_device_time(torch, fn, n_top=8, groups=None):
    """Device busy time of one call of `fn` from a torch.profiler trace: the
    union of the device's intervals (`device_busy_ms`, overlapping kernels
    and copies counted once), their plain sum beside it
    (`device_time_summed_ms`), the traced window from the first interval's
    start to the last one's end (`device_window_ms`), the share of that
    window the device was idle (`device_idle_share`: busy and window from the
    same traced call, since every traced kernel runs a little longer than an
    untraced one), the stream's time from before the call to after it by
    CUDA events (`device_stream_ms`: a window much shorter than it means the
    trace lost intervals), and the `n_top` kernels that take most of the summed time
    (ms summed per name over the call); with `groups` ({label: part of a
    kernel name}) also the summed ms of each group."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from dynamicvectorquantization_torch.utils.device_time import busy_union_ms, window_ms

    fn()  # warm-up outside the trace
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
    # the raw kineto events, as `utils/step_wall.py` reads them: `prof.events()` builds
    # the profiler's tree of every host op first, which took most of a phase's time
    # over a traced batch-30 f32 stage-1 step (~117,000 device ops)
    by_name = {}
    intervals = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            t0, t1 = e.start_ns() / 1e6, e.end_ns() / 1e6
            by_name[e.name()] = by_name.get(e.name(), 0.0) + (t1 - t0)
            intervals.append((t0, t1))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:n_top]
    busy, window = busy_union_ms(intervals), window_ms(intervals)
    require(busy <= window + 1e-9, f"busy {busy} ms outside the traced window {window} ms")
    grouped = {label: sum(ms for name, ms in by_name.items() if part in name)
               for label, part in (groups or {}).items()}
    return {"device_busy_ms": busy if busy > 0 else None,  # None: the trace held no device time
            "device_time_summed_ms": sum(by_name.values()), "device_window_ms": window,
            "device_stream_ms": start.elapsed_time(end),
            "device_idle_share": 1.0 - busy / window if busy > 0 else None,
            "device_ops": len(intervals), "top": [[name[:80], ms] for name, ms in top],
            "groups": grouped}


T2I_TARGET = "models.stage2_dynamic.dqtransformer_t2i.Dualformer"
T2I_TEXT_ENCODER = {"target": "dynamicvectorquantization_torch.nn.text_encoders.NativeCLIPTextEncoder",
                    "params": {"clip_name": "ViT-B/32", "seed": 26}}
T2I_CAPTIONS = ("a photo of a red fox standing in fresh snow", "two dogs playing on a beach",
                "a bowl of ramen with an egg", "an old stone bridge over a river at dawn",
                "a close-up of a monarch butterfly", "city skyline at night, long exposure",
                "a wooden sailboat", "three green apples on a white table")
# the kernel step against the plain one on the same state, images and captions: bf16 over
# f32 masters as the `train` phase (its losses 2e-2 rel, gradients 0.1 rel-L2)
T2I_TOL = {"loss_rel": 2e-2, "grad_rel_l2": 0.1}
# kernel-name parts summed in the `t2i` phase's traces (a kernel may fall in several):
# "int64" the integer elementwise ops, which on the masked route are its Philox draw
T2I_TRACE_GROUPS = {"int64": "long", "elementwise": "elementwise_kernel",
                    "reduce": "reduce_kernel", "softmax": "softmax", "gemm": "gemm",
                    "nvjet": "nvjet", "attention": "attention", "layernorm": "layernorm"}
FACES_SHAPE = (4, 256, 1664, 16)  # taming's faces transformer: 1,664 over 16 heads (hd 104)
CLIP_SHAPE = (8, 77, 512, 8)  # the CLIP ViT-B/32 text tower: 8 captions, 8 heads of 64


def check_t2i_kernels(torch, dev):
    """#4 / #5 at hd 104 (zero-padded per head to the 3xTF32 kernels' 128,
    f32, causal, with lse) and #4 at the CLIP text tower's shape (f32, hd 64,
    causal, no lse: the tower runs without gradient) against their plain
    versions on N(0, 1) inputs; kernel (the wrapper's call, padding and cut
    included), plain and SDPA times; bounds of the real head dim's work, as
    the `kernels` phase counts them (the padded kernel moves and multiplies
    128 / 104 of it). Tolerance: the f32 attention's 1e-4."""
    import torch.nn.functional as F

    from dynamicvectorquantization_torch.ops.attention import (
        fused_attention_backward, fused_attention_backward_plain, fused_attention_forward,
        fused_attention_forward_plain)

    out = {}
    g = torch.Generator(device=dev).manual_seed(26)
    for label, (b, t, d, n_head), backward in (("hd104_padded", FACES_SHAPE, True),
                                               ("clip_text", CLIP_SHAPE, False)):
        hd = d // n_head
        scale = hd ** -0.5
        sets = []
        for _ in range(n_sets(8 * b * t * d * 4)):
            q, k, v, dy = (torch.randn((b, t, d), generator=g, device=dev) for _ in range(4))
            y, lse = fused_attention_forward(q, k, v, n_head, scale, True, return_lse=True)
            sets.append((q, k, v, y, lse, dy))
        q, k, v, y, lse, dy = sets[0]
        padded = fused_attention_forward.padded_launches
        y_ref, lse_ref = fused_attention_forward_plain(q, k, v, n_head, scale, True, True)
        err_y, ok = close(y, y_ref, 1e-4)
        err_lse, ok_lse = close(lse, lse_ref, 1e-4)
        pairs = t * (t + 1) // 2
        shape = dict(shape=[b, t, d], n_head=n_head, head_dim=hd, causal=True, dtype="float32",
                     route="f32 tensor cores", path="t2i" if label == "clip_text" else "legacy_stage2")
        fwd = dict(phase="kernels", kernel="fused_attention_forward", case=label, **shape,
                   with_lse=backward, max_abs_err=err_y, lse_err=err_lse,
                   tol="1e-4; lse 1e-4", padded_to=128 if hd == 104 else None)
        fwd["bound_ms"], fwd["bound_by"], fwd["bound_ms_f32_fma"] = attention_bounds(
            torch, 16 * b * t * d + 4 * b * n_head * t * backward, 4 * b * n_head * pairs * hd,
            torch.float32, True)

        def heads(z):
            return z.view(b, t, n_head, hd).transpose(1, 2)

        time_into(fwd, "kernel", torch, lambda q_, k_, v_, *_: fused_attention_forward(
            q_, k_, v_, n_head, scale, True, return_lse=backward), sets)
        time_into(fwd, "plain", torch, lambda q_, k_, v_, *_: fused_attention_forward_plain(
            q_, k_, v_, n_head, scale, True, backward), sets, iters=10)
        time_into(fwd, "library", torch, lambda q_, k_, v_, *_: F.scaled_dot_product_attention(
            heads(q_), heads(k_), heads(v_), is_causal=True, scale=scale), sets)
        fwd["padded_launches"] = fused_attention_forward.padded_launches - padded
        emit(fwd)
        out[f"fused_attention_forward_f32_tc:{label}"] = fwd
        require(ok and ok_lse, f"{label} attention forward disagrees: {err_y} {err_lse}")
        require((fwd["padded_launches"] > 0) == (hd == 104), f"{label}: padding {fwd}")
        if not backward:
            del sets
            continue
        grads = fused_attention_backward(q, k, v, y, lse, dy, n_head, scale, True)
        ref = fused_attention_backward_plain(q, k, v, y_ref, lse_ref, dy, n_head, scale, True)
        errs, oks = zip(*(close(o, r, 1e-4) for o, r in zip(grads, ref)))
        bwd = dict(phase="kernels", kernel="fused_attention_backward", case=label, **shape,
                   max_abs_err=max(errs), dq_err=errs[0], dk_err=errs[1], dv_err=errs[2],
                   tol="1e-4", padded_to=128)
        bwd["bound_ms"], bwd["bound_by"], bwd["bound_ms_f32_fma"] = attention_bounds(
            torch, 32 * b * t * d + 4 * b * n_head * t, 10 * b * n_head * pairs * hd,
            torch.float32, True)
        time_into(bwd, "kernel", torch,
                  lambda *a: fused_attention_backward(*a, n_head, scale, True), sets, iters=10)
        time_into(bwd, "plain", torch,
                  lambda *a: fused_attention_backward_plain(*a, n_head, scale, True), sets,
                  iters=10)
        lib_sets = []
        for q_, k_, v_, _, _, dy_ in sets:
            leaves = tuple(heads(z).detach().requires_grad_() for z in (q_, k_, v_))
            lib_sets.append((F.scaled_dot_product_attention(*leaves, is_causal=True,
                                                            scale=scale), leaves, heads(dy_)))
        time_into(bwd, "library", torch,
                  lambda y_, leaves, dy_: torch.autograd.grad(y_, leaves, dy_,
                                                              retain_graph=True),
                  lib_sets, iters=10)
        del lib_sets, sets
        emit(bwd)
        out[f"fused_attention_backward_f32_tc:{label}"] = bwd
        require(all(oks), f"{label} attention backward disagrees: {errs}")
    return out


@contextlib.contextmanager
def plain_text_tower():
    """The CLIP text tower's attention swapped for its plain version."""
    import dynamicvectorquantization_torch.nn.clip_text as clip_text
    from dynamicvectorquantization_torch.ops.attention import fused_attention_forward_plain

    saved = clip_text.fused_causal_attention
    clip_text.fused_causal_attention = lambda q, k, v, n_head, causal=True: \
        fused_attention_forward_plain(q, k, v, n_head, None, causal)
    try:
        yield
    finally:
        clip_text.fused_causal_attention = saved


def _t2i_config(on, mask_pad=False):
    """The shipped p6c18 yml with the train phase's stream caps: the T2I model
    over it (`on`: the consuming variant; None: the plain Dualformer), with
    `mask_pad_attention` as given."""
    from dynamicvectorquantization_torch.config.yaml_config import load_config

    config = load_config([P6C18])["model"]
    params = config["params"]
    params["permuter_config"]["params"].update(TRAIN_CAPS)
    params["transformer_config"]["params"]["mask_pad_attention"] = mask_pad
    if on is not None:
        config["target"] = T2I_TARGET
        params["text_encoder_config"] = T2I_TEXT_ENCODER
        params["use_text_conditioning"] = on
    return config


def t2i(torch, dev, card, checks, batch=8, timed=2):
    """Text-to-image at full width (the shipped p6c18 transformer, 6 + 18
    layers x 1,024, with the train phase's stream caps, T = 805, and its first
    stage; the CLIP ViT-B/32 text tower, 512 wide, 12 layers, 8 heads, 77
    tokens, with the byte-level vocabulary; seeded weights), bf16 over f32
    masters as shipped, batch 8 of seeded 256^2 images with 8 captions, in
    both variants (captions encoded and dropped; consumed by cross-attention
    in the 18 content blocks). Each: the text tower's ms for the 8 captions;
    one inline-encode step (encode, forward, loss, backward) through the
    kernels against the same step through the plain versions from one state
    (`T2I_TOL`; elementwise dropouts 0, the attention dropout 0.1 drawn alike
    on both paths); then the main path, counted: 1 + `timed` optimizer steps
    (step ms, peak memory, launches a step by kernel), and one more traced
    (`profile_device_time`, `T2I_TRACE_GROUPS`). Then `mask_pad_attention`
    on the plain Dualformer over the same images' cached codes with the
    shipped dropouts: three graph-replayed steps against three eager ones
    from one state, logs and masters bit for bit; one eager step traced and
    one layer's route by parts (`masked_route_parts`)."""
    from dynamicvectorquantization_torch.models.graphs import runners_of
    from dynamicvectorquantization_torch.ops.attention import masked_causal_attention
    from dynamicvectorquantization_torch.train.stage2 import Stage2Trainer
    from dynamicvectorquantization_torch.utils.instantiate import instantiate_from_config

    t_phase = time.perf_counter()
    x = smooth_and_noisy_images(torch, dev, torch.Generator(device=dev).manual_seed(27),
                                b=batch)
    captions = list(T2I_CAPTIONS[:batch])
    lr = 4.5e-4

    def build(config):
        with torch.device(dev):
            model = instantiate_from_config(config)
        model.init_weights(torch.Generator(device=dev).manual_seed(0))
        return model.eval(), Stage2Trainer(model.eval(), lr, warmup_steps=0, max_steps=10_000,
                                           compute_dtype="bfloat16", device=dev)

    def snapshot(trainer):
        return {k: v.clone() for k, v in trainer.masters.items()}

    def restore(trainer, masters):
        for k in trainer.masters:
            trainer.masters[k].copy_(masters[k])
            trainer.params[k].data.copy_(masters[k])
            trainer.m[k].zero_()
            trainer.v[k].zero_()
        trainer.count = 0

    variants = {}
    for name, on in (("dropped", False), ("consumed", True)):
        t0 = time.perf_counter()
        model, trainer = build(_t2i_config(on))
        gpt = model.transformer
        build_s = time.perf_counter() - t0
        # the text tower alone: 8 captions, tokenizer included
        text_s = []
        for _ in range(4):
            before = read_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            feats, mask = model.encode_text(captions, dev)
            torch.cuda.synchronize()
            text_s.append(time.perf_counter() - t0)
            tower = {k: v - before[k] for k, v in read_launches().items() if v > before[k]}
        require(tuple(feats.shape) == (batch, 77, 512) and bool(torch.isfinite(feats).all())
                and tower == {"fused_attention_forward_f32_tc": 12},
                f"t2i text tower: {tuple(feats.shape)}, launches {tower}")

        set_dropout(gpt, 0.0, 0.0)  # the attention dropout stays, drawn alike on both paths
        start = snapshot(trainer)
        watched = ["content_emb.weight", "position_transformer.0.attn.query.weight",
                   f"content_transformer.{gpt.content_layer - 1}.mlp.2.weight",
                   "content_head.1.weight"]
        if on:
            watched += ["text_proj.weight", "content_transformer.0.xattn.key.weight",
                        f"content_transformer.{gpt.content_layer - 1}.ln_x.weight"]
        results = {}
        for path in ("kernel", "plain"):
            restore(trainer, start)
            with contextlib.ExitStack() as stack:
                if path == "plain":
                    for ctx in (plain_train_path(), plain_encode_path(), plain_text_tower()):
                        stack.enter_context(ctx)
                logs, grads = trainer.compute_grads(x, c=captions)
                results[path] = ({k: float(v) for k, v in logs.items()},
                                 {k: grads[k].float() for k in watched})
                del grads
        (klogs, kgrads), (plogs, pgrads) = results["kernel"], results["plain"]
        loss_rel = max(abs(klogs[k] - plogs[k]) / abs(plogs[k]) for k in plogs)
        grad_rel = {k: float((kgrads[k] - pgrads[k]).norm() / pgrads[k].norm()) for k in watched}
        del results, kgrads, pgrads
        restore(trainer, start)
        del start
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()  # the main path from here
        step_s = []
        for _ in range(1 + timed):
            before = read_launches()
            t0 = time.perf_counter()
            logs = trainer.train_step(x, c=captions)
            loss = float(logs["train_loss"])
            step_s.append(time.perf_counter() - t0)
            after = read_launches()
            per_step = {k: after[k] - before[k] for k in after}
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        blocks = gpt.position_layer + gpt.content_layer
        want = {"fused_attention_forward_tc": blocks + 6,  # StackGPT, the bf16 encode's six
                "fused_attention_backward_tc": blocks,
                "fused_attention_forward_f32_tc": 12,  # the text tower
                "layernorm_forward": 2 * blocks + 2 + on * gpt.content_layer,  # with ln_x
                "layernorm_backward": 2 * blocks + 2 + on * gpt.content_layer,
                "fused_adamw": len(trainer.params), "vq_nearest": 1, "patch_entropy_bf16": 1,
                "strided_conv3x3_down_bf16": 4}
        variants[name] = dict(
            use_text_conditioning=on, build_s=build_s,
            params=sum(p.numel() for p in trainer.params.values()), leaves=len(trainer.params),
            text_tower_ms=spread([1e3 * s for s in text_s[1:]]), text_tower_launches=tower,
            kernel_logs=klogs, plain_logs=plogs, loss_rel=loss_rel, grad_rel_l2=grad_rel,
            tol=T2I_TOL, step_ms=spread([1e3 * s for s in step_s[1:]]),
            first_step_s=step_s[0], last_loss=loss, peak_memory_gb=peak,
            launches_per_step={k: v for k, v in per_step.items() if v})
        require(math.isfinite(loss) and loss_rel <= T2I_TOL["loss_rel"]
                and max(grad_rel.values()) <= T2I_TOL["grad_rel_l2"],
                f"t2i {name}: the kernel step differs from the plain step: {loss_rel} {grad_rel}")
        require(all(per_step.get(k) == v for k, v in want.items()),
                f"t2i {name} launches a step: {per_step}, expected {want}")
        variants[name]["launches"] = per_step
        # where a step's time goes: two more steps, one of them traced
        variants[name]["trace"] = profile_device_time(
            torch, lambda: trainer.train_step(x, c=captions), n_top=10, groups=T2I_TRACE_GROUPS)
        del model, trainer, gpt, feats, mask
        gc.collect()
        torch.cuda.empty_cache()

    # mask_pad_attention: the captured step against the eager one
    t0 = time.perf_counter()
    model, trainer = build(_t2i_config(None, mask_pad=True))
    z = trainer.encode_dataset(x.cpu().numpy(), batch=batch)
    pad = model.transformer.content_pad_code
    pads = int((z["fine_content"] == pad).sum() + (z["coarse_content"] == pad).sum())
    start = snapshot(trainer)

    def three(eager):
        restore(trainer, start)
        calls = masked_causal_attention.calls
        before = read_launches()
        s, logs = [], []
        for _ in range(3):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            logs.append({k: v.cpu() for k, v in trainer.train_step(z, eager=eager).items()})
            s.append(time.perf_counter() - t1)
        after = read_launches()
        return (logs, {k: v.cpu() for k, v in trainer.masters.items()}, s,
                masked_causal_attention.calls - calls, {k: after[k] - before[k] for k in after})

    glogs, gstate, gs, gcalls, glaunch = three(False)
    (runner,) = runners_of(trainer).values()
    graph = dict(captures=runner.captures, replays=runner.replays,
                 pool_bytes=runner.pool_bytes())
    del runner
    runners_of(trainer).clear()
    gc.collect()
    torch.cuda.empty_cache()
    elogs, estate, es, ecalls, elaunch = three(True)
    # where the masked step's time goes: one eager step traced, and one layer's route
    masked_trace = profile_device_time(torch, lambda: trainer.train_step(z, eager=True),
                                       n_top=10, groups=T2I_TRACE_GROUPS)
    masked_layer = masked_route_parts(torch, dev, batch, model.transformer, pads // batch)
    logs_equal = all(torch.equal(a[k], b[k]) for a, b in zip(glogs, elogs) for k in a)
    unequal = sorted(k for k in estate if not torch.equal(estate[k], gstate[k]))
    blocks = model.transformer.position_layer + model.transformer.content_layer
    mask_pad = dict(pad_tokens=pads, graph_step_ms=spread([1e3 * s for s in gs[1:]]),
                    first_graph_step_s=gs[0], eager_step_ms=spread([1e3 * s for s in es[1:]]),
                    masked_route_calls=[gcalls, ecalls],
                    launches={k: v for k, v in glaunch.items() if v},
                    eager_launches={k: v for k, v in elaunch.items() if v}, graph=graph, logs_equal=logs_equal,
                    unequal_masters=unequal[:5], losses=[float(lg["train_loss"]) for lg in glogs],
                    eager_trace=masked_trace, one_layer=masked_layer,
                    seconds=time.perf_counter() - t0)
    del model, trainer, z, start, gstate, estate
    gc.collect()
    torch.cuda.empty_cache()
    res = dict(phase="t2i", card=card, config=P6C18, text_encoder=T2I_TEXT_ENCODER,
               kernel_checks={k: pick_keys(c_, "shape", "n_head", "max_abs_err", "tol",
                                           "kernel_ms", "plain_ms", "library_ms", "bound_ms",
                                           "bound_by") for k, c_ in checks.items()},
               batch=batch, dtype="bfloat16 over f32 masters", variants={
                   k: {kk: vv for kk, vv in v.items() if kk != "launches"}
                   for k, v in variants.items()},
               mask_pad_attention=mask_pad, seconds=time.perf_counter() - t_phase)
    emit(res)
    require(logs_equal and not unequal and gcalls == ecalls == 3 * blocks,
            f"mask_pad_attention: the graph step differs from the eager one: {mask_pad}")
    require(glaunch.get("fused_attention_forward_tc", 0) == 0
            and glaunch.get("layernorm_forward") == 3 * (2 * blocks + 2)
            and glaunch.get("fused_adamw") == 3 * 395,
            f"mask_pad_attention launches: {glaunch}")
    return dict(res, launches={**{name: v["launches"] for name, v in variants.items()},
                               "mask_pad_attention": glaunch}, checks=checks)


def masked_route_parts(torch, dev, batch, gpt, n_pad):
    """One layer of the `mask_pad_attention` step's masked route at its shape
    (bf16 (B, T, 1,024) projections, T = 805, 8 heads of 128, a pad bias on
    the last `n_pad` keys of every row, a device seed), by CUDA events over 5 calls: the
    Philox keep mask alone (`dropout_keep_mask`), the route's forward and
    backward at the shipped rate and at rate 0, and the kernels #4 + #5 at
    the same shape and rate without the bias."""
    from dynamicvectorquantization_torch.ops.attention import (
        dropout_keep_mask, fused_attention_backward, fused_attention_forward,
        masked_causal_attention)

    t = 1 + TRAIN_CAPS["coarse_max_len"] + TRAIN_CAPS["fine_max_len"]
    d, n_head = gpt.n_embd, gpt.n_head
    rate = float(gpt.content_transformer[0].attn.attn_pdrop)
    g = torch.Generator(device=dev).manual_seed(26)
    q, k, v, dy = (torch.randn((batch, t, d), generator=g, device=dev).to(torch.bfloat16)
                   for _ in range(4))
    bias = torch.zeros((batch, 1, 1, t), device=dev)
    bias[..., t - n_pad:] = -1e9
    seed = torch.tensor([26], dtype=torch.int64, device=dev)

    def route(r):
        qq, kk, vv = (a.detach().requires_grad_() for a in (q, k, v))
        masked_causal_attention(qq, kk, vv, n_head, bias, rate=r, seed=seed).backward(dy)

    def kernels():
        y, lse = fused_attention_forward(q, k, v, n_head, None, True, rate, True, seed)
        fused_attention_backward(q, k, v, y, lse, dy, n_head, rate=rate, seed=seed)

    def event_ms(fn, n=5):
        fn()
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(n + 1)]
        marks[0].record()
        for i in range(n):
            fn()
            marks[i + 1].record()
        marks[-1].synchronize()
        return spread([a.elapsed_time(b) for a, b in zip(marks, marks[1:])])

    calls = masked_causal_attention.calls
    out = dict(shape=[batch, t, d], n_head=n_head, rate=rate,
               keep_mask_ms=event_ms(lambda: dropout_keep_mask(seed, batch, n_head, t, rate,
                                                                dev)),
               route_fwd_bwd_ms=event_ms(lambda: route(rate)),
               route_fwd_bwd_rate0_ms=event_ms(lambda: route(0.0)),
               kernels_fwd_bwd_ms=event_ms(kernels))
    masked_causal_attention.calls = calls  # a measurement, not the path
    return out


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
                     "f32_blocked_launches", "device_seed_launches",
                     "device_scalar_launches"):
            if hasattr(fn, attr):
                setattr(fn, attr, 0)
        if hasattr(fn, "f32_tiling_launches"):
            fn.f32_tiling_launches = dict.fromkeys(fn.f32_tiling_launches, 0)


def read_launches():
    """Launches per kernel since `reset_launches`. The attention wrappers
    have two kernel families: `<name>` counts the FMA family's launches,
    `<name>_wide_f32` those of them on the register-blocked f32 kernel (hd 256
    / 512), `<name>_square_tiles` the rest of them, `<name>_tc` the bf16
    tensor-core family's, and `<name>_dropout` those of every kernel that
    drew a dropout mask; `<name>_f32_tc` counts the 3xTF32 kernel's (f32 at
    hd 64 / 128, in neither family), `<name>_device_seed` those of any family
    that read their seed on the device (`fused_adamw_device_scalars`: the
    AdamW launches that read lr, c1, c2 there). The downsample and entropy wrappers have
    two instantiations: `<name>` counts the f32 launches, `<name>_bf16` the
    bf16 ones; `strided_conv3x3_down_tc` counts those of the bf16 launches
    that ran the tensor-core kernel, `strided_conv3x3_down_f32_blocked` those
    of the f32 launches that ran the blocked f32 kernel, and
    `strided_conv3x3_down_f32_{large,mid,small}` those of them by the tiling
    the kernel reported."""
    counts = {name: fn.launches for name, fn in wrappers().items()}
    for name in ATTENTION:
        fn = wrappers()[name]
        counts[name] = fn.fma_launches
        counts[f"{name}_wide_f32"] = fn.wide_f32_launches
        counts[f"{name}_square_tiles"] = fn.fma_launches - fn.wide_f32_launches
        counts[f"{name}_tc"] = fn.tc_launches
        counts[f"{name}_dropout"] = fn.dropout_launches
        counts[f"{name}_f32_tc"] = fn.f32_tc_launches
        counts[f"{name}_device_seed"] = fn.device_seed_launches
    counts["fused_adamw_device_scalars"] = wrappers()["fused_adamw"].device_scalar_launches
    for name in BF16_SPLIT:
        fn = wrappers()[name]
        counts[name] = fn.launches - fn.bf16_launches
        counts[f"{name}_bf16"] = fn.bf16_launches
    conv = wrappers()["strided_conv3x3_down"]
    counts["strided_conv3x3_down_tc"] = conv.tc_launches
    counts["strided_conv3x3_down_f32_blocked"] = conv.f32_blocked_launches
    for tiling, n in conv.f32_tiling_launches.items():
        counts[f"strided_conv3x3_down_f32_{tiling.lower()}"] = n
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
    vq.nearest_codes = vq.nearest_codes_plain
    vq.nearest_codes_with_stats = vq.nearest_codes_with_stats_plain
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
          streams=None, config_path=P6C18, labels=None, kv_cache_dtype=None, compare=True,
          rate0=True, phase=None):
    """Stage-2 training at full p6c18 width and depth on cached codes: bf16
    over f32 masters (the shipped yml's `compute_dtype`), or with
    `compute_dtype` None, the JAX trainer's default, f32 throughout (f32
    weights and activations, TF32 off, attention on the 3xTF32 kernels) on the
    `streams` a bf16 run cached. With `labels` (one class label an image) the
    class-conditional model of `config_path` trains on them beside the
    streams (phase `class_train`); `kv_cache_dtype` is the model's sampling
    caches'. Each timed step replays the trainer's CUDA graph of the step;
    the same steps op by op (`eager=True`) are timed as the control, and the
    masters, moments and logs after three graph steps must equal the
    control's bit for bit. `compare` False leaves out (a), the step against
    the plain versions (whose attention holds (B, H, T, T) f32 tensors);
    `rate0` False the timing at attn_pdrop 0. Returns (the timed line, the
    cached streams, the trainer)."""
    from dynamicvectorquantization_torch.config.yaml_config import load_config
    from dynamicvectorquantization_torch.train.stage2 import Stage2Trainer
    from dynamicvectorquantization_torch.utils.instantiate import instantiate_from_config

    from dynamicvectorquantization_torch.models.graphs import runners_of

    phase = phase or ("train" if labels is None else "class_train")
    config = load_config([config_path])
    params = config["model"]["params"]
    tparams = params["transformer_config"]["params"]
    params["permuter_config"]["params"].update(TRAIN_CAPS)
    if kv_cache_dtype:
        tparams["kv_cache_dtype"] = kv_cache_dtype
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
    batches = [({k: v[i:i + batch] for k, v in streams.items()},
                None if labels is None else labels[i:i + batch])
               for i in range(0, n_images, batch)]

    def train_step(i, eager=False):
        z, c = batches[i % len(batches)]
        return trainer.train_step(z, c=c, eager=eager)
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
    n_params = sum(v.numel() for v in trainer.masters.values())

    def compare_with_plain():
        watched = ["content_emb.weight", "position_transformer.0.attn.query.weight",
                   "position_transformer.0.ln1.weight",
                   f"content_transformer.{gpt.content_layer - 1}.mlp.2.weight",
                   f"content_transformer.{gpt.content_layer // 2}.ln2.bias",
                   "content_head.1.weight"]
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
                logs, grads = trainer.compute_grads(batches[0][0], c=batches[0][1])
                kept = {k: grads[k].float() for k in watched}
                trainer.apply_update(grads)
                del grads
            torch.cuda.synchronize()
            results[path] = dict(logs={k: float(v) for k, v in logs.items()}, grads=kept,
                                 after={k: v.clone() for k, v in trainer.masters.items()},
                                 peak_gb=torch.cuda.max_memory_allocated() / 2 ** 30)
        pr = results["plain"]

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
                                  exceeds_a_limit=c_loss > loss_tol
                                  or max(c_grad.values()) > grad_tol
                                  or c_max > delta_max_tol or c_mean > delta_mean_tol)
        line = dict(phase=phase, step="kernel_vs_plain", config=config_path,
                    attn_pdrop=attn_pdrop,
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
        emit(line)
        require(all(math.isfinite(v) for v in kr["logs"].values()), "non-finite training loss")
        require(loss_rel <= loss_tol, f"training losses kernel vs plain: {loss_rel}")
        require(max(grad_rel.values()) <= grad_tol, f"gradients kernel vs plain: {grad_rel}")
        require(delta_max <= delta_max_tol and delta_mean <= delta_mean_tol,
                f"parameters after one step, kernel vs plain: max {delta_max} mean {delta_mean}")
        require(moved > 0 and pad_rows_frozen, "parameters did not move, or a pad row did")
        require(all(c["exceeds_a_limit"] for c in controls.values()),
                f"a control of lower precision than f32 passes the {dname} limits: {controls}")
        del results, kr, pr

    if compare:
        compare_with_plain()

    # (b) timed steps on the kernel path with all three shipped dropouts, the elementwise
    # ones from the trainer's own generator (re-seeded per step, as the loop runs it);
    # before them the same steps with attn_pdrop 0, the configuration timed before
    # in-kernel dropout existed, from the same state
    def timed(n, windows=3, eager=False):
        """Host-clock ms per step over `windows` windows of `n` steps (the
        host runs ahead inside a window, as in training), and the losses."""
        per_step, losses_ = [], []
        for _ in range(windows):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pending = [train_step(i, eager)["train_loss"] for i in range(n)]
            torch.cuda.synchronize()
            per_step.append((time.perf_counter() - t0) / n * 1e3)
            losses_ += [float(v) for v in pending]
        return dict(spread(per_step), steps_per_window=n), losses_

    step_rate0, prof0 = {"median": None}, {"device_busy_ms": None}
    if rate0:
        restore(start)
        set_dropout(gpt, embd_pdrop, resid_pdrop, 0.0)
        train_step(0)  # warm-up step (captures this configuration's graph)
        step_rate0, _ = timed(timed_steps)
        prof0 = profile_device_time(torch, lambda: train_step(0), n_top=4)

    restore(start)
    set_dropout(gpt, embd_pdrop, resid_pdrop, attn_pdrop)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    losses = [float(train_step(0)["train_loss"])]  # warm-up step: eager on a side stream, capture
    first_step_s = time.perf_counter() - t0
    first_step_peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    torch.cuda.synchronize()
    reset_launches()
    losses.append(float(train_step(1)["train_loss"]))
    step_launches = read_launches()
    torch.cuda.reset_peak_memory_stats()
    step, more = timed(timed_steps)
    losses += more
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    reserved_gb = torch.cuda.max_memory_reserved() / 2 ** 30
    prof = profile_device_time(torch, lambda: train_step(0), n_top=12)
    (runner,) = runners_of(trainer).values()
    graph = dict(captures=runner.captures, capture_s=runner.capture_s, replays=runner.replays,
                 pool_bytes=runner.pool_bytes(), first_step_s=spread([first_step_s]),
                 first_step_peak_memory_gb=first_step_peak_gb)
    del runner

    # (c) the graph against the eager control: three steps from the same state with the
    # shipped dropouts, then masters, moments and logs compared bit for bit (the graph
    # run's state held on the host meanwhile)
    def three_steps(eager):
        restore(start)
        logs = [train_step(i, eager) for i in range(3)]
        return ([{k: v.cpu() for k, v in lg.items()} for lg in logs],
                {f"{part}.{k}": t.cpu() for part in ("masters", "m", "v")
                 for k, t in getattr(trainer, part).items()})

    graph_logs, graph_state = three_steps(False)
    # the graphs and their pool go before the control runs (f32 at batch 30 cannot hold both)
    runners_of(trainer).clear()
    gc.collect()
    torch.cuda.empty_cache()
    reserved_without_graph_gb = torch.cuda.memory_reserved() / 2 ** 30
    eager_logs, eager_state = three_steps(True)
    unequal = sorted(k for k, t in eager_state.items() if not torch.equal(t, graph_state[k]))
    logs_equal = all(torch.equal(a[k], b[k]) for a, b in zip(graph_logs, eager_logs) for k in a)
    del graph_state, eager_state

    # (d) the eager control's own numbers (every op dispatched from Python, as before the
    # graph)
    restore(start)
    del start
    train_step(0, True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    eager_step, _ = timed(timed_steps, eager=True)
    eager_peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    eager_prof = profile_device_time(torch, lambda: train_step(0, True), n_top=4)
    eager = dict(step_ms=eager_step["median"], step_ms_spread=eager_step,
                 device_busy_ms=eager_prof["device_busy_ms"],
                 device_idle_share=eager_prof["device_idle_share"],
                 device_idle_share_vs_step_ms=1.0 - eager_prof["device_busy_ms"]
                 / eager_step["median"],
                 device_window_ms=eager_prof["device_window_ms"],
                 device_ops=eager_prof["device_ops"], peak_memory_gb=eager_peak_gb,
                 reserved_before_gb=reserved_without_graph_gb,
                 masters_moments_equal_to_graph=not unequal, logs_equal_to_graph=logs_equal,
                 unequal_leaves=unequal[:8])

    layers = gpt.position_layer + gpt.content_layer
    leaves = len(trainer.params)
    # hd 128: every attention launch on the tensor-core family in bf16, on the 3xTF32
    # kernels in f32; none on the square tiles; every seed and every AdamW triple read on
    # the device
    family, other = ("tc", "f32_tc") if bf16 else ("f32_tc", "tc")
    expected = {f"fused_attention_forward_{family}": layers,
                f"fused_attention_backward_{family}": layers,
                f"fused_attention_forward_{other}": 0, f"fused_attention_backward_{other}": 0,
                "fused_attention_forward_dropout": layers,
                "fused_attention_backward_dropout": layers,
                "fused_attention_forward_device_seed": layers,
                "fused_attention_backward_device_seed": layers,
                "fused_attention_forward": 0, "fused_attention_backward": 0,
                "layernorm_forward": 2 * layers + 2, "layernorm_backward": 2 * layers + 2,
                "fused_adamw": leaves, "fused_adamw_device_scalars": leaves}
    step_ms = step["median"]
    busy_ms = prof["device_busy_ms"]
    res = dict(phase=phase, step="timed", config=config_path, attn_pdrop=attn_pdrop,
               execution="CUDA graph replay of the whole step",
               step_ms_attn_pdrop_0=step_rate0["median"], step_ms_spread_attn_pdrop_0=step_rate0,
               device_busy_ms_attn_pdrop_0=prof0["device_busy_ms"], embd_pdrop=embd_pdrop,
               resid_pdrop=resid_pdrop, dtype=dname, batch=batch,
               seq_len=t_len, stream_caps=TRAIN_CAPS, images=n_images, real_tokens=tokens,
               labels=None if labels is None else labels.tolist(),
               vocab_size=model.vocab_size, cond_stage_key=model.cond_stage_key,
               layers=layers, params=n_params, parameter_leaves=leaves, lr=lr,
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
               peak_memory_gb=peak_gb, peak_reserved_gb=reserved_gb, graph=graph,
               eager_control=eager, card=card)
    emit(res)
    require(all(math.isfinite(v) for v in losses), f"non-finite training loss: {losses}")
    require(losses[-1] < losses[0], f"the training loss did not fall: {losses}")
    for name, want in expected.items():
        require(step_launches[name] == want,
                f"{name} launched {step_launches[name]} times per {dname} {phase} step, "
                f"expected {want}")
    require(not unequal and logs_equal,
            f"{phase}: three graph steps differ from three eager steps: leaves {unequal[:8]}, "
            f"logs equal {logs_equal}")
    require(graph["replays"] > 0 and graph["captures"] == 1 + rate0,
            f"{phase}: expected a captured graph for each dropout configuration: {graph}")
    return res, streams, trainer


def kernel_vs_plain_step(torch, dev, card, model, trainer, x, restore, config_path, phase,
                         dname, batch, lr, bf16):
    """`train1`'s comparison: one inference forward and one training step
    through the kernels (twice) and through the plain versions, from the same
    state and generator seed."""
    from dynamicvectorquantization_torch.train.stage1 import B1

    ema_names = ("weight", "cluster_size_ema", "embed_ema")
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
    compare = dict(phase=phase, step="kernel_vs_plain", config=config_path, dtype=dname,
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



def train1(torch, dev, card, batch=8, timed_steps=2, compute_dtype=None, config_path=STAGE1,
           phase="train1", compare=True, resume=False, remat=False):
    """Stage-1 (DQ-VAE + GAN) training of a shipped stage-1 config (the
    dual-grain entropy one unless `config_path` names another) at full width
    and depth, f32, or with `compute_dtype` "bfloat16" (the DQ-VAE's bf16
    compute mode, `model.params.compute_dtype=bfloat16` on the command line:
    bf16 towers over f32 parameters). `remat`: the trainer's option (False
    here unless given; None is its default, on for the card). `compare`:
    first one step through the kernels against one through the plain
    versions; `resume`: last, one step taken twice from the same state (the
    second after `load_state_dict` of a copy taken before the first), with
    cuDNN's deterministic algorithms, which must agree bit for bit (logs,
    every parameter and buffer, the generator)."""
    from dynamicvectorquantization_torch.config.yaml_config import load_config
    from dynamicvectorquantization_torch.nn.blocks import AttnBlock, Downsample
    from dynamicvectorquantization_torch.train.stage1 import Stage1Trainer
    from dynamicvectorquantization_torch.utils.instantiate import instantiate_from_config

    bf16 = compute_dtype == "bfloat16"
    dname = "bfloat16 towers over f32 parameters" if bf16 else "float32"
    overrides = ["model.params.compute_dtype=bfloat16"] if bf16 else []
    config = load_config([config_path], overrides)["model"]
    lr = config["base_learning_rate"] * batch  # the reference's base_learning_rate x batch
    t0 = time.perf_counter()
    with torch.device(dev):
        model = instantiate_from_config(config)
    trainer = Stage1Trainer(model, lr, warmup_steps=0, max_steps=10_000, device=dev, remat=remat)
    trainer.init_state(torch.Generator(device=dev).manual_seed(0))
    load_s = time.perf_counter() - t0
    loss = model.loss
    n_attn = sum(isinstance(m, AttnBlock) for m in (*model.encoder.modules(),
                                                     *model.decoder.modules()))
    n_down = sum(isinstance(m, Downsample) and m.with_conv for m in model.encoder.modules())
    g = torch.Generator(device=dev).manual_seed(6)
    x = smooth_and_noisy_images(torch, dev, g, b=batch, size=model.encoder.resolution)
    ema_names = ("weight", "cluster_size_ema", "embed_ema")

    start = {k: v.clone() for k, v in model.state_dict().items()}

    def restore():
        model.load_state_dict(start)
        trainer.init_state()

    if compare:
        kernel_vs_plain_step(torch, dev, card, model, trainer, x, restore, config_path, phase,
                             dname, batch, lr, bf16)

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
    reserved_gb = torch.cuda.max_memory_reserved() / 2 ** 30
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
    # (the entropy router's configs only; two forwards a step, each through every
    # Downsample: 4 levels dual-grain, 5 triple-grain). Under remat the AttnBlocks run a
    # third time, in the recompute; the Downsamples, the entropy and the search stay
    # outside the checkpointed segments
    fwd = 3 if trainer.remat else 2
    expected = {"vq_nearest_train": 2, "vq_nearest": 0,
                "patch_entropy": 2 if model.use_entropy else 0, "patch_entropy_bf16": 0,
                conv: 2 * n_down, "strided_conv3x3_down_tc": 2 * n_down if bf16 else 0,
                "strided_conv3x3_down_f32_blocked": 0 if bf16 else 2 * n_down,
                f"fused_attention_forward{family}": fwd * n_attn,
                f"fused_attention_backward{family}": n_attn, f"fused_attention_forward{other}": 0,
                f"fused_attention_backward{other}": 0,
                "fused_attention_forward_wide_f32": 0 if bf16 else fwd * n_attn,
                "fused_attention_backward_wide_f32": 0 if bf16 else n_attn}
    # device ms a launch of the five kernels of the step, from the traced step
    groups = prof["groups"]
    kernel_ms = {"vq_nearest_train": (groups["vq_nearest_train"], "vq_nearest_train"),
                 "patch_entropy": (groups["patch_entropy"], "patch_entropy"),
                 "fused_attention_forward": (groups["fused_attention_forward"],
                                             f"fused_attention_forward{family}"),
                 "fused_attention_backward": (groups["fused_attention_backward"]
                                              + groups["attention_delta"],
                                              f"fused_attention_backward{family}"),
                 "strided_conv3x3_down": (groups["strided_conv3x3_down"], conv)}
    kernel_ms_per_launch = {name: ms / step_launches[key] if step_launches[key] else None
                            for name, (ms, key) in kernel_ms.items()}
    step_ms = step_s * 1e3
    busy_ms = prof["device_busy_ms"]
    resumed = resume_one_step(torch, trainer, x) if resume else None
    res = dict(phase=phase, step="timed", config=config_path, dtype=dname, batch=batch, lr=lr,
               image=list(x.shape[1:]), attn_blocks=n_attn, downsamples=n_down,
               grains=model.encoder.grains, remat=trainer.remat,
               gumbel_gate=model.encoder.gumbel_shape(batch) is not None,
               fine_ratio=[step["train_fine_ratio"] for step in logs],
               median_ratio=[step["train_median_ratio"] for step in logs
                             if "train_median_ratio" in step],
               budget_loss=[step["train_budget_loss"] for step in logs],
               resume_one_step=resumed,
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
               device_ms_by_kernel_group=prof["groups"],
               kernel_device_ms_per_launch=kernel_ms_per_launch, peak_memory_gb=peak_gb,
               peak_reserved_gb=reserved_gb, card=card)

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
    require(not resume or resumed["bit_equal"], f"{phase}: the resumed step differs: {resumed}")
    return res


def resume_one_step(torch, trainer, x):
    """One step taken twice from the same state, the second after
    `load_state_dict` of a copy of the state taken before the first, with
    cuDNN's deterministic algorithms: whether logs, parameters, buffers,
    both optimizers' moments and the generator agree bit for bit."""
    import copy

    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        state = copy.deepcopy(trainer.state_dict())
        runs = []
        for _ in range(2):
            logs = trainer.train_step(x)
            after = copy.deepcopy(trainer.state_dict())
            runs.append(({k: v.clone() for k, v in logs.items()}, after))
            trainer.load_state_dict(copy.deepcopy(state))
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved
    (la, sa), (lb, sb) = runs
    differ = [k for k in la if not torch.equal(la[k], lb[k])]
    differ += [f"model.{k}" for k in sa["model"] if not torch.equal(sa["model"][k],
                                                                    sb["model"][k])]
    for opt in ("ae_opt", "disc_opt"):
        differ += [f"{opt}.{part}.{k}" for part in ("m", "v") for k in sa[opt][part]
                   if not torch.equal(sa[opt][part][k], sb[opt][part][k])]
    differ += ["generator"] * (not torch.equal(sa["generator"], sb["generator"]))
    return {"bit_equal": not differ, "differ": differ[:10], "step": sa["step"],
            "compared": len(la) + len(sa["model"]) + 2 * sum(len(sa[o]["m"])
                                                             for o in ("ae_opt", "disc_opt"))}


# remat against no remat on the card, where they are not bit-equal: logs relative, parameters
# absolute in units of lr (Adam's first update is +-lr on every entry, so a gradient entry
# whose sign differs moves its parameter by 2 lr), the rest relative to the largest entry
REMAT_TOL = {"logs": 1e-5, "autoencoder": 2.02, "discriminator": 2.02, "codebook": 1e-5,
             "batchnorm": 1e-5, "ae_opt": 1e-4, "disc_opt": 1e-4}


def remat_differences(torch, a, b, lr):
    """The largest difference per group between two (logs, trainer state,
    generator state) of a step taken with and without remat."""
    (la, sa, ga), (lb, sb, gb) = a, b

    def rel(x, y):
        return ((x.float() - y.float()).abs().max() / y.float().abs().max().clamp_min(1e-30)).item()

    groups = {"logs": max(abs(float(la[k]) - float(lb[k])) / max(abs(float(lb[k])), 1e-6)
                          for k in lb)}
    ma, mb = sa["model"], sb["model"]
    for name, keys in (
            ("autoencoder", [k for k in mb if k.startswith(("encoder.", "decoder.", "quant_conv.",
                                                           "post_quant_conv."))]),
            ("discriminator", [k for k in mb if k.startswith("loss.discriminator.")
                               and "running" not in k and mb[k].is_floating_point()]),
            ("codebook", [k for k in mb if k.startswith("quantize.")]),
            ("batchnorm", [k for k in mb if "running" in k])):
        if name in ("autoencoder", "discriminator"):  # in units of lr
            groups[name] = max((ma[k] - mb[k]).abs().max().item() for k in keys) / lr
        else:
            groups[name] = max(rel(ma[k], mb[k]) for k in keys)
    for opt in ("ae_opt", "disc_opt"):
        groups[opt] = max(rel(sa[opt][part][k], sb[opt][part][k])
                          for part in ("m", "v") for k in sb[opt][part])
    bit_equal = (all(torch.equal(la[k], lb[k]) for k in lb)
                 and all(torch.equal(ma[k], mb[k]) for k in mb)
                 and all(torch.equal(sa[o][p][k], sb[o][p][k]) for o in ("ae_opt", "disc_opt")
                         for p in ("m", "v") for k in sb[o][p])
                 and torch.equal(ga, gb))
    return bit_equal, groups, torch.equal(ga, gb)


def train1_remat(torch, dev, card, batch=8, timed_steps=2):
    """`remat` against no `remat` on the shipped stage-1 yml (f32, batch 8,
    cuDNN's deterministic algorithms): one step each way from one state and
    one generator seed, without and with ResnetBlock dropout 0.1 (a yml
    override), compared bit for bit, else per group against `REMAT_TOL`, the
    launches of the remat step asserted; then timed steps each way with peak
    allocated and reserved memory."""
    import copy

    from dynamicvectorquantization_torch.config.yaml_config import load_config
    from dynamicvectorquantization_torch.nn.blocks import AttnBlock, Downsample
    from dynamicvectorquantization_torch.train.stage1 import Stage1Trainer
    from dynamicvectorquantization_torch.utils.instantiate import instantiate_from_config

    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    pairs, timed = {}, {}
    try:
        for dropout in (0.0, 0.1):
            overrides = [f"model.params.{tower}.params.dropout={dropout}"
                         for tower in ("encoderconfig", "decoderconfig")] if dropout else []
            config = load_config([STAGE1], overrides)["model"]
            lr = config["base_learning_rate"] * batch
            with torch.device(dev):
                model = instantiate_from_config(config)
            trainer = Stage1Trainer(model, lr, warmup_steps=0, max_steps=10_000, device=dev,
                                    remat=False)
            trainer.init_state(torch.Generator(device=dev).manual_seed(0))
            n_attn = sum(isinstance(m, AttnBlock) for m in (*model.encoder.modules(),
                                                             *model.decoder.modules()))
            n_down = sum(isinstance(m, Downsample) and m.with_conv
                         for m in model.encoder.modules())
            x = smooth_and_noisy_images(torch, dev, torch.Generator(device=dev).manual_seed(6),
                                        b=batch, size=model.encoder.resolution)
            start = copy.deepcopy(trainer.state_dict())
            runs, memory = {}, {}
            for remat in (False, True):
                trainer.load_state_dict(copy.deepcopy(start))
                trainer.remat = remat
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                reset_launches()
                gen = torch.Generator(device=dev).manual_seed(11)
                logs = trainer.train_step(x, gen)
                torch.cuda.synchronize()
                launches = read_launches()
                runs[remat] = ({k: v.clone() for k, v in logs.items()},
                               copy.deepcopy(trainer.state_dict()), gen.get_state())
                memory[remat] = dict(peak_gb=torch.cuda.max_memory_allocated() / 2 ** 30,
                                     reserved_gb=torch.cuda.max_memory_reserved() / 2 ** 30)
            bit_equal, diffs, gen_equal = remat_differences(torch, runs[True], runs[False], lr)
            expected = {"vq_nearest_train": 2, "patch_entropy": 2,
                        "strided_conv3x3_down_f32_blocked": 2 * n_down,
                        "fused_attention_forward_wide_f32": 3 * n_attn,
                        "fused_attention_backward_wide_f32": n_attn}
            pairs[str(dropout)] = dict(bit_equal=bit_equal, generator_equal=gen_equal,
                                       largest_difference=diffs, tol=REMAT_TOL,
                                       first_step_memory=memory,
                                       launches_remat_step=launches,
                                       expected_launches=expected,
                                       aeloss=float(runs[True][0]["train_aeloss"]))
            require(gen_equal and (bit_equal or all(diffs[k] <= t for k, t in REMAT_TOL.items())),
                    f"train1_remat dropout {dropout}: remat step vs step without it: {diffs}")
            for name, want in expected.items():
                require(launches[name] == want, f"train1_remat: {name} launched "
                        f"{launches[name]} times in a remat step, expected {want}")
            if dropout:
                require(pairs["0.1"]["aeloss"] != pairs["0.0"]["aeloss"],
                        "train1_remat: dropout 0.1 left the loss as it was")
                continue
            for remat in (True, False):  # timed, each after a step of its own
                trainer.remat = remat
                trainer.train_step(x)
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                times = []
                for _ in range(timed_steps):
                    t0 = time.perf_counter()
                    trainer.train_step(x)
                    torch.cuda.synchronize()
                    times.append((time.perf_counter() - t0) * 1e3)
                timed["remat" if remat else "no_remat"] = dict(
                    step_ms=spread(times)["median"], step_ms_spread=spread(times),
                    peak_memory_gb=torch.cuda.max_memory_allocated() / 2 ** 30,
                    peak_reserved_gb=torch.cuda.max_memory_reserved() / 2 ** 30)
            del trainer, model, start, runs
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved
    res = dict(phase="train1_remat", config=STAGE1, dtype="float32", batch=batch,
               cudnn_deterministic=True, pairs=pairs, timed=timed,
               remat_over_no_remat_step=timed["remat"]["step_ms"] / timed["no_remat"]["step_ms"],
               card=card)
    emit(res)
    return res


def encode_triple(torch, dev, card, batch=8, reps=5):
    """The shipped triple-grain yml's DQ-VAE (`TripleGrainEncoder`, F = 32 /
    16 / 8, the feature router) at full width, f32, seeded weights, on the
    encode cell's seeded batch: encode seconds and images/s, the coarse,
    median and fine shares, the launches of one encode, a traced call; the
    grain cells and codes against the plain path's."""
    from dynamicvectorquantization_torch.nn.blocks import AttnBlock, Downsample
    from dynamicvectorquantization_torch.utils.model_loading import load_first_stage_model

    t0 = time.perf_counter()
    model = load_first_stage_model(TRIPLE, device=dev)
    load_s = time.perf_counter() - t0
    n_attn = sum(isinstance(m, AttnBlock) for m in model.encoder.modules())
    n_down = sum(isinstance(m, Downsample) and m.with_conv for m in model.encoder.modules())
    g = torch.Generator(device=dev).manual_seed(6)
    x = smooth_and_noisy_images(torch, dev, g, b=batch, size=model.encoder.resolution)
    feats = {}
    hook = model.quant_conv.register_forward_hook(lambda m, i, o: feats.__setitem__("h", o))
    with torch.inference_mode():
        model.encode(x)  # warm-up
        torch.cuda.synchronize()
        reset_launches()
        quant, _, info, grain, gate, _ = model.encode(x)
        torch.cuda.synchronize()
        launches = read_launches()
        h_k = feats["h"]
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            model.encode(x)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        prof = profile_device_time(torch, lambda: model.encode(x))
        dec = model.decode(quant)
        with plain_encode_path():
            _, _, info_p, grain_p, _, _ = model.encode(x)
            h_p = feats["h"]
    hook.remove()
    encode_s = spread(times)["median"]
    same = grain.eq(grain_p).repeat_interleave(4, 1).repeat_interleave(4, 2)
    codes_differ = int(((info[2] != info_p[2]) & same).sum())
    shares = {name: (grain == i).float().mean().item()
              for i, name in enumerate(("coarse", "median", "fine"))}
    busy_ms = prof["device_busy_ms"]
    res = dict(phase="encode_triple", config=TRIPLE, dtype="float32", batch=batch,
               image=list(x.shape[1:]), load_s=spread([load_s]), grain_shares=shares,
               codes_per_image=int(quant.shape[1] * quant.shape[2]), attn_blocks=n_attn,
               downsamples=n_down, gate_shape=list(gate.shape),
               grain_cells_differ=int((grain != grain_p).sum()), codes_differ=codes_differ,
               codes=info[2].numel(),
               feature_rel_l2_diff=((h_k - h_p).norm() / h_p.norm()).item(),
               launches=launches, encode_s=encode_s, encode_s_spread=spread(times),
               images_per_s=batch / encode_s, device_busy_ms=busy_ms,
               device_idle_share=prof["device_idle_share"],
               device_idle_share_vs_step_ms=busy_ms and 1.0 - busy_ms / (encode_s * 1e3),
               device_time_summed_ms=prof["device_time_summed_ms"],
               device_window_ms=prof["device_window_ms"],
               device_stream_ms=prof["device_stream_ms"], device_ops=prof["device_ops"],
               top_kernels=prof["top"], card=card)
    emit(res)
    require(quant.shape == (batch, 32, 32, model.quantize.codebook_dim)
            and bool(torch.isfinite(dec).all()) and dec.shape == x.shape,
            "triple-grain encode of the wrong shape or not finite")
    require(abs(sum(shares.values()) - 1.0) < 1e-6, f"grain shares {shares}")
    require(res["feature_rel_l2_diff"] <= 1e-4 and res["grain_cells_differ"] <= 1
            and codes_differ <= 1e-3 * res["codes"], f"triple encode kernel vs plain: {res}")
    for name, want in (("vq_nearest", 1), ("patch_entropy", 0), ("strided_conv3x3_down", n_down),
                       ("strided_conv3x3_down_f32_blocked", n_down),
                       ("fused_attention_forward", n_attn),
                       ("fused_attention_forward_wide_f32", n_attn)):
        require(launches[name] == want,
                f"{name} launched {launches[name]} times per triple encode, expected {want}")
    return res


def evaluate(torch, dev, card, n_images=40):
    """The evaluation entry points as `python -m
    dynamicvectorquantization_torch.eval.<name>` runs them, one after another
    in one process (this script's `--launches-of ... --then ...`, which
    counts each one's launches and seconds). Stand-ins: 40 seeded 256^2
    images written as `.npy` files; seeded InceptionV3 weights in a file
    (`DQVQ_INCEPTION_WEIGHTS`; `eval/inception.py` `seeded_state_dict`,
    He-normal convolutions, so the features depend on the input); the p6c18
    model of `sample_cli` (seed 0) written as a stage-2 checkpoint, and its
    first stage as a reference-named `.ckpt`. Runs: FID between
    `sample_cli`'s `sample.val` dump (`EVAL_DUMP`) and the images, with InceptionV3
    and with the proxy features; the first stage's rFID over the images;
    `codebook_usage` and `codebook_pca`; `parity_report` on the stand-ins
    (`recon_tolerance` skipped: no reference repository; `sample_fid`
    through a `sample.val` process of 8 images; the 1 % verdict off, as the
    weights are random). Seconds, values, the extractor's variant, the
    InceptionV3 forward's images/s, launches."""
    import numpy as np

    from dynamicvectorquantization_torch.data.synthetic import build_pool
    from dynamicvectorquantization_torch.eval.inception import seeded_state_dict
    from dynamicvectorquantization_torch.utils.model_loading import load_model_and_variables

    root = os.path.abspath(os.path.join("build", "eval"))
    shutil.rmtree(root, ignore_errors=True)
    images = os.path.join(root, "images")
    os.makedirs(images)
    pool = build_pool(n_images, 256, seed=18)
    for i in range(0, n_images, 8):
        np.save(os.path.join(images, f"val_{i // 8:02d}.npy"), pool[i:i + 8])
    inception = os.path.join(root, "inception_v3_seeded.pth")
    torch.save(seeded_state_dict(0), inception)
    t0 = time.perf_counter()
    model, sd = load_model_and_variables(P6C18, seed=0, device=dev)
    stage2, first_stage = os.path.join(root, "stage2.pt"), os.path.join(root, "first_stage.ckpt")
    torch.save(sd, stage2)
    torch.save({"state_dict": model.first_stage_model.state_dict()}, first_stage)
    del model, sd
    torch.cuda.empty_cache()
    setup_s = time.perf_counter() - t0
    env = dict(os.environ, DQVQ_INCEPTION_WEIGHTS=inception)
    stage1_args = ("--yaml_path", STAGE1, "--model_path", first_stage)
    png = os.path.join(root, "codebook_pca.png")
    report_path = os.path.join(root, "parity_report.json")
    plan = [
        ("fid", "compute_fid", ("--a", EVAL_DUMP, "--b", images, "--batch_size", "40")),
        ("proxy_fid", "compute_fid", ("--a", EVAL_DUMP, "--b", images, "--proxy_features")),
        ("rfid", "compute_fid", ("--rfid", *stage1_args, "--b", images, "--batch_size", "8")),
        # image files (JPEG, arithmetic-coded JPEG, PNG, CMYK, grey) through the port's
        # reader, no PIL
        ("rfid_files", "compute_fid", ("--rfid", *stage1_args, "--b", FIXTURES,
                                       "--batch_size", "8")),
        ("codebook_usage", "codebook_usage", (*stage1_args, "--batch_size", "8",
                                              "--max_batches", "5")),
        ("codebook_pca", "codebook_pca", (*stage1_args, "--out", png)),
        ("parity_report", "parity_report", (
            "--yaml_path", STAGE1, "--ref_ckpt", first_stage, "--images", images,
            "--stage2_yaml", P6C18, "--stage2_ckpt", stage2, "--sample_num", "8",
            "--batch_size", "8", "--sample_dir", os.path.join(root, "samples"),
            "--rfid_rel_tol", "1e9", "--out", report_path))]
    # one process runs the seven entry points in turn (each as `python -m` runs it)
    cmd = [sys.executable, os.path.abspath(__file__), "--launches-of"]
    for i, (_, module, args) in enumerate(plan):
        cmd += [THEN] * bool(i) + [f"dynamicvectorquantization_torch.eval.{module}", *args]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900, env=env)
    process_s = time.perf_counter() - t0
    lines = proc.stdout.strip().splitlines()
    marks = [i for i, line in enumerate(lines) if line.startswith('{"module": ')]
    require(proc.returncode == 0 and len(marks) == len(plan),
            f"eval exited {proc.returncode} after {len(marks)} entry points: "
            f"{proc.stderr[-3000:]}")
    runs = {}
    for (name, _, _), i in zip(plan, marks):
        counted = json.loads(lines[i])
        runs[name] = dict(module_s=counted["seconds"], result=json.loads(lines[i - 1]),
                          launches={k: v for k, v in counted["launches"].items() if v})
    fid, proxy, rfid, rfid_files, usage, pca = (runs[name]["result"] for name, _, _ in plan[:6])
    with open(report_path) as f:
        report = json.load(f)
    with open(png, "rb") as f:
        scatter = read_png(f.read())
    res = dict(phase="eval", images=n_images, dump=EVAL_DUMP, setup_s=setup_s, runs=runs,
               fid=fid["value_unrounded"], proxy_fid=proxy["value_unrounded"],
               rfid=rfid["value_unrounded"], rfid_files=rfid_files["value_unrounded"],
               rfid_files_images=rfid_files["images"], variant=fid["variant"],
               inception_images_per_s={k: r["result"]["feature_images_per_s"]
                                       for k, r in runs.items()
                                       if "feature_images_per_s" in r["result"]},
               codebook_usage_percent=usage["usage_percent"],
               code_entropy_nats=usage["entropy_nats"],
               pca_explained_variance=pca["explained_variance_2"],
               parity={k: report[k] for k in ("verdict", "legs_ran", "legs_skipped", "variant")},
               parity_legs={leg: {k: v for k, v in report[leg].items() if k != "ckpt"}
                            for leg in ("ckpt_import", "rfid", "sample_fid")},
               process_s=process_s, seconds=process_s + setup_s, card=card)
    emit(res)
    shutil.rmtree(root, ignore_errors=True)
    require(all(math.isfinite(v) and v >= 0 for v in (res["fid"], res["proxy_fid"], res["rfid"])),
            f"FID values {res['fid']}, {res['proxy_fid']}, {res['rfid']}")
    require(fid["images"] == [n_images, n_images] and rfid["images"] == n_images,
            f"FID over {fid['images']} / rFID over {rfid['images']} images")
    require(rfid_files["images"] == 11 and math.isfinite(rfid_files["value_unrounded"])
            and runs["rfid_files"]["launches"].get("vq_nearest") == 2,  # batches of 8 and 3
            f"rFID over the fixture files: {rfid_files}, {runs['rfid_files']['launches']}")
    require(0 < usage["usage_percent"] <= 100 and 0 < pca["explained_variance_2"] <= 1
            and scatter.shape == (512, 512, 3), f"codebook tools: {usage}, {pca}")
    require(report["verdict"] == "INCOMPLETE"
            and report["legs_ran"] == ["ckpt_import", "rfid", "sample_fid"]
            and list(report["legs_skipped"]) == ["recon_tolerance"]
            and report["sample_fid"]["samples"] == 8, f"parity report: {res['parity']}")
    for name in ("rfid", "codebook_usage"):  # the first stage's encode on the card
        got = runs[name]["launches"]
        require(all(got.get(k, 0) >= 5 for k in ("vq_nearest", "patch_entropy",
                                                  "strided_conv3x3_down",
                                                  "fused_attention_forward")),
                f"eval.{name} launched {got}")
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


def synchronous_save_s(torch, ckpt_dir):
    """Seconds of one save as the loop made it before saves left the training
    thread: the newest checkpoint under `ckpt_dir`, loaded onto the card, by
    `torch.save` to a temporary name and a rename (the state's assembly, which
    the loop's `checkpoint` bucket also holds, not counted)."""
    name = max((n for n in os.listdir(ckpt_dir) if n.endswith(".pt")),
               key=lambda n: int(n[len("step_"):-len(".pt")]))
    state = torch.load(os.path.join(ckpt_dir, name), map_location="cuda", weights_only=True)
    torch.cuda.synchronize()
    final = os.path.join(ckpt_dir, "synchronous.pt")
    t0 = time.perf_counter()
    torch.save(state, final + ".tmp")
    os.replace(final + ".tmp", final)
    secs = time.perf_counter() - t0
    os.remove(final)
    del state
    torch.cuda.empty_cache()
    return secs


def fit_through_cli(torch, card, phase, config, overrides, steps_per_epoch, state_of, val_key,
                    expect_launched, gb_needed, grids, expect_not_launched=(), k=1):
    """Three runs of the port's training command line on `config` at full
    width and depth, in-process: (A) two epochs in one run, logging image
    grids; (B) the same stopped after epoch 1; (C) `--resume` of B for epoch
    2. C must end where A ended, bit for bit. `k`: the steps a dispatch the
    command line's default (`--steps_per_dispatch` unset) gives, so the rows
    fall at every k-th step."""
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
        remat = getattr(whole, "remat", None)
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

        first = cli.main([*base, "--name", "parts", "--stop_epoch", "1",
                          "--image_log_every", "0"])
        first_steps = [first.epoch, getattr(first, "count", getattr(first, "step", None))]
        del first
        torch.cuda.empty_cache()
        parts_dir = _only_dir(root, "parts-")
        sync_save_s = synchronous_save_s(torch, os.path.join(parts_dir, "checkpoints"))
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
               seconds_per_epoch={b: spread([v / 2]) for b, v in buckets["buckets"].items()},
               steps_per_dispatch=k,
               dispatch_s_per_epoch=spread([buckets["buckets"]["dispatch"] / 2]),
               loop_wall_s=spread([buckets["wall_seconds"]]),
               device_wait_s=spread([buckets["device_wait_seconds"]]),
               encode_share=buckets["buckets"].get("encode", 0.0) / buckets["wall_seconds"],
               # saves off the training thread (two in the whole run; the first pays the
               # pinned buffers' allocation), the wait for the last write at the fit's end,
               # and one save of the stopped run's state on the training thread (before 10.1)
               checkpoint_s_per_save=spread([buckets["buckets"]["checkpoint"] / 2]),
               checkpoint_wait_s=spread([buckets["buckets"].get("checkpoint_wait", 0.0)]),
               checkpoint_s_synchronous_save=spread([sync_save_s]),
               peak_memory_gb=peak_gb, stopped_after_epoch_1_at=first_steps,
               resume_run_s=spread([resume_s]),
               final_val_whole=val_rows[-1][val_key],
               final_val_resumed=parts_rows[-1].get(val_key), state_sha256_whole=whole_hash,
               remat=remat,
               state_sha256_resumed=resumed_hash, resumed_rows_equal=rows_equal, card=card)
    emit(res)
    want_rows = [(i, "train") for i in range(k, steps_per_epoch + 1, k)] \
        + [(steps_per_epoch, "val")] \
        + [(i, "train") for i in range(steps_per_epoch + k, n + 1, k)] + [(n, "val")]
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
    """Stage 2: the shipped p6c18 config, `attn_pdrop` 0.1 untouched; the
    steps a dispatch the command line's default, the JAX loop's auto rule:
    min(8, 4 steps an epoch) = 4 on cached codes, each step a graph
    replay."""
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
         "strided_conv3x3_down_f32_blocked", "fused_attention_forward_f32_tc",
         "fused_attention_forward_device_seed", "fused_attention_backward_device_seed",
         "fused_adamw_device_scalars"),
        gb_needed=12, grids=8, expect_not_launched=("fused_attention_forward_square_tiles",),
        k=4)


def fit1(torch, card):
    """Stage 1: the shipped dual-grain DQ-VAE + GAN config, with `remat` (the
    trainer's default on the card). cuDNN picks deterministic convolution
    algorithms here, so that the resumed run can be held to the uninterrupted
    one bit for bit."""
    data = "data.params"
    synthetic = "dynamicvectorquantization_torch.data.synthetic.SyntheticImages"
    overrides = [f"{data}.batch_size=8", f"{data}.num_workers=4"]
    for split, n in (("train", 32), ("validation", 16)):
        overrides += [f"{data}.{split}.target={synthetic}", f"{data}.{split}.params.n={n}"]
    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        res = fit_through_cli(
            torch, card, "fit1", STAGE1, overrides, 2, lambda t: t.model.state_dict(),
            "val_rec_loss", ("vq_nearest_train", "vq_nearest", "patch_entropy",
                             "strided_conv3x3_down", "strided_conv3x3_down_f32_blocked",
                             "fused_attention_forward", "fused_attention_backward",
                             "fused_attention_forward_wide_f32",
                             "fused_attention_backward_wide_f32"),
            gb_needed=4, grids=8)
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved
    require(res["remat"] is True, "fit1: the command line's stage-1 trainer ran without remat")
    return res


def runner_numbers(torch, model):
    """The model's graph runner: captures, host seconds capturing, replays,
    and the bytes of its memory pool."""
    from dynamicvectorquantization_torch.utils.sample_wall import runner_stats

    numbers = runner_stats(torch, model)
    require(numbers is not None, "the model sampled without a graph runner")
    return numbers


def sampling_numbers(calls, first, timed, traced):
    """`SamplerCalls.summary` without the per-call rows."""
    out = calls.summary(first, timed, traced)
    out.pop("calls")
    return out


def serve(torch, model, card, reps=3):
    """`BatchingSampler` (p6c18, int8 caches, bf16, max_batch 8) answers
    requests of 1, 2 and 4 images (one batch) `reps + 1` times: the first
    batch captures the sampler's graphs, `reps` are timed (no traced call:
    `utils/sample_wall.py` traces one). Launches are counted over the first
    batch and over the second (replays only)."""
    import numpy as np

    from dynamicvectorquantization_torch.serve import BatchingSampler
    from dynamicvectorquantization_torch.utils.sample_wall import SamplerCalls

    requests = [(1, 101), (2, 102), (4, 103)]
    walls, launches = [], []
    with SamplerCalls(torch) as calls, BatchingSampler(model, max_batch=8,
                                                       max_wait_ms=200.0) as engine:
        for _ in range(reps + 1):
            torch.cuda.synchronize()
            reset_launches()
            t0 = time.perf_counter()
            futures = [engine.submit(n, seed=s) for n, s in requests]
            images = [f.result(timeout=900) for f in futures]
            walls.append(time.perf_counter() - t0)
            launches.append(read_launches())
        stats = list(engine.batch_stats)
        batches = engine.batches_run
        sampling = sampling_numbers(calls, 0, range(1, reps + 1), None)
    n_images = sum(n for n, _ in requests)
    timed = walls[1:reps + 1]
    wall = spread(timed)["median"]
    layers = model.transformer.position_layer + model.transformer.content_layer
    res = dict(phase="serve", config=P6C18, kv_cache_dtype="int8", max_batch=8, layers=layers,
               requests=[n for n, _ in requests], shapes=[list(x.shape) for x in images],
               batches=batches, batch_stats=stats, launches=launches[0],
               launches_replayed_batch=launches[1], wall_s=wall, wall_s_spread=spread(timed),
               first_batch_s=walls[0], s_per_batch=wall,
               images_per_s=n_images / wall, sampling=sampling,
               graphs=runner_numbers(torch, model), card=card)
    emit(res)
    for (n, _), img in zip(requests, images):
        require(img.shape == (n, 256, 256, 3), f"image shape {img.shape} for {n} images")
        require(bool(np.isfinite(img).all()), "non-finite image values")
    require(batches == reps + 1, f"{batches} batches for {reps + 1} rounds of requests")
    for i in (0, 1):  # the first batch (its eager first blocks, replays) and a replayed one
        require(launches[i]["decode_attention_int8"] >= layers * stats[i]["ar_steps"],
                "decode_attention_int8 was not launched on every decode step")
        # the decoder's four AttnBlocks (f32: the FMA family); the StackGPT decodes one
        # token at a time through decode_attention_int8, so no tensor-core launch
        require(launches[i]["fused_attention_forward"] == 4
                and launches[i]["fused_attention_forward_tc"] == 0,
                "fused_attention_forward was not launched by every decoder AttnBlock")
    return res


def graph_vs_eager(torch, model, c, name, seed=31, modes=("greedy", "sampled")):
    """The sampler's graphs against its eager loop on the card (`eager=True`,
    the control no entry point reaches): the same seed and knobs, greedy and
    sampled (top-k 300 / 100), or the `modes` given; tokens, AR steps and
    the generator's offset afterwards must be identical."""
    dev = c[0].device

    def run(eager, **knobs):
        g = torch.Generator(device=dev).manual_seed(seed)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks = model.sample_from_scratch(*c, generator=g, eager=eager, **knobs)
        toks = [t.cpu() for t in toks]
        return dict(tokens=toks, ar_steps=model.last_ar_steps, offset=g.get_offset(),
                    s=time.perf_counter() - t0)

    res = dict(phase="graph_vs_eager", model=name, rows=int(c[0].shape[0]), seed=seed,
               kv_cache_dtype=model.transformer.kv_cache_dtype or "float",
               dtype=str(next(model.transformer.parameters()).dtype))
    with torch.inference_mode():
        for mode, knobs in (("greedy", dict(sample=False)),
                            ("sampled", dict(top_k=300, top_p=1.0, top_k_pos=100,
                                             top_p_pos=1.0))):
            if mode not in modes:
                continue
            graph, eager = run(False, **knobs), run(True, **knobs)
            res[mode] = dict(
                tokens_equal=all(torch.equal(a, b)
                                 for a, b in zip(graph["tokens"], eager["tokens"])),
                ar_steps=[graph["ar_steps"], eager["ar_steps"]],
                generator_offset=[graph["offset"], eager["offset"]],
                graph_s=graph["s"], eager_s=eager["s"])
    res["graphs"] = runner_numbers(torch, model)
    emit(res)
    for mode in modes:
        r = res[mode]
        require(r["tokens_equal"] and r["ar_steps"][0] == r["ar_steps"][1]
                and r["generator_offset"][0] == r["generator_offset"][1],
                f"{name} {mode}: graph and eager sampling differ: {r}")
    return res


def class_sample(torch, trainer, card, labels, reps=3):
    """One of the class model's `log_images` grids (the training loop's
    `samples_from_scratch`: free positions, top-k 300 / 100) for 4 `labels`,
    on its f32 masters with int8 caches, `reps + 2` times with the same seed:
    the first call captures the sampler's graphs (under the masters' storage:
    new graphs beside the bf16 working copy's), `reps` are timed, the last is
    traced. The sampled streams are held to the class model's vocabulary and
    every call's to the first's; launches of the first and second grids. (The
    second grid, fixed fine positions, runs the same kernels; it is left out
    for the script's time.) Then graph vs eager on the same masters."""
    import numpy as np

    from dynamicvectorquantization_torch.utils.sample_wall import SamplerCalls

    model, dev = trainer.model, trainer.device
    walls, launches, streams = [], [], []
    with trainer.master_weights(), torch.inference_mode():
        query_dtype = str(next(model.transformer.parameters()).dtype)
        c = model.encode_to_c(labels.to(dev))
        with SamplerCalls(torch) as calls:
            for i in range(reps + 2):
                if i == reps + 1:
                    calls.trace_next()
                torch.cuda.synchronize()
                reset_launches()
                t0 = time.perf_counter()
                toks = model.sample_from_scratch(
                    *c, generator=torch.Generator(device=dev).manual_seed(17), top_k=300,
                    top_p=1.0, top_k_pos=100, top_p_pos=1.0, fix_fine_position=False)
                images = model.decode_to_img(*toks).float().cpu().numpy()
                walls.append(time.perf_counter() - t0)
                launches.append(read_launches())
                streams.append([t.cpu() for t in toks])
            sampling = sampling_numbers(calls, 0, range(1, reps + 1), reps + 1)
        graphs = runner_numbers(torch, model)
        # the sampled mode's draws are held on the int8 serving model (a shared sampler)
        versus = graph_vs_eager(torch, model, c, "class p6c18, f32 masters", modes=("greedy",))
    cc, fc, cp, fp = streams[0]
    checks = dict(
        content_in_codes_or_pad=all(bool((t <= model.content_pad_code).all()) for t in (cc, fc)),
        fine_positions_at_most_eos=bool((fp <= model.fine_position_eos_code).all()),
        coarse_positions_valid=bool(((cp < model.max_coarse_position_idx)
                                     | (cp == model.coarse_position_eos_code)
                                     | (cp == model.coarse_position_pad_code)).all()),
        every_grid_equal=all(torch.equal(a, b) for s_ in streams[1:]
                             for a, b in zip(s_, streams[0])))
    layers = model.transformer.position_layer + model.transformer.content_layer
    ar_steps = sampling["first_call"]["ar_steps"]
    timed = walls[1:reps + 1]
    res = dict(phase="class_sample", config=CLASS_P6C18, labels=labels.tolist(),
               kv_cache_dtype="int8", weights="f32 masters", query_dtype=query_dtype,
               grid="samples_from_scratch", top_k=300, top_k_pos=100,
               wall_s=spread(timed)["median"], wall_s_spread=spread(timed),
               first_grid_s=walls[0], traced_grid_s=walls[-1], ar_steps=ar_steps,
               coarse_tokens=int((cp < model.max_coarse_position_idx).sum()),
               fine_tokens=int((fp < model.fine_position_pad_code).sum()), **checks,
               launches=launches[0], launches_replayed_grid=launches[1], sampling=sampling,
               graphs=graphs, shape=list(images.shape), card=card)
    emit(res)
    require(query_dtype == "torch.float32", f"sampled with {query_dtype} weights")
    require(all(checks.values()), f"a sampled token outside its range, or grids differ: {checks}")
    require(images.shape == (4, 256, 256, 3) and bool(np.isfinite(images).all()),
            f"sampled images: shape {images.shape}, or non-finite values")
    for i in (0, 1):
        require(launches[i]["decode_attention_int8"] >= layers * ar_steps,
                f"decode_attention_int8 launched {launches[i]['decode_attention_int8']} times "
                f"over {ar_steps} AR steps of {layers} layers")
        # the decoder's four AttnBlocks (f32: the FMA family)
        require(launches[i]["fused_attention_forward"] >= 4,
                "fused_attention_forward was not launched by the decoder")
    return res, versus


def read_png(data):
    """(H, W, C) uint8 from the bytes of an 8-bit grey or RGB PNG whose rows
    all use filter 0 (what `encode_png` writes), by the standard library."""
    import struct
    import zlib

    import numpy as np

    require(data[:8] == b"\x89PNG\r\n\x1a\n", "not a PNG")
    pos, idat, header = 8, b"", None
    while pos < len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        require(struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])[0] == zlib.crc32(tag + body),
                f"PNG chunk {tag!r}: bad CRC")
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat += body
        elif tag == b"IEND":
            break
        pos += 12 + n
    w, h, depth, color, _, _, interlace = header
    require(depth == 8 and color in (0, 2) and interlace == 0, f"PNG header {header}")
    c = 3 if color == 2 else 1
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + w * c)
    require(not rows[:, 0].any(), "a PNG row filter other than 0")
    return rows[:, 1:].reshape(h, w, c)


THEN = "--then"  # separates the modules of one `--launches-of` process


def run_counting(argv):
    """`chip_smoke.py --launches-of <module> <its arguments> [--then <module>
    <its arguments> ...]`: run each module in turn in this one process as
    `python -m <module>` does, and after each print as one JSON line its
    kernels' launches, its seconds and each `sample_from_scratch` call's
    seconds, AR steps and the process's graph captures so far (how
    `sample_cli`, `eval` and `campaign` read their subprocesses). A module
    that exits with another code than 0 ends the process with that code."""
    import runpy

    import torch

    from dynamicvectorquantization_torch.utils.sample_wall import SamplerCalls

    groups, group = [], []
    for arg in argv:
        if arg == THEN:
            groups.append(group)
            group = []
        else:
            group.append(arg)
    groups.append(group)
    code = 0
    for module, *args in groups:
        sys.argv = [module, *args]
        reset_launches()
        t0 = time.perf_counter()
        with SamplerCalls(torch) as calls:
            try:
                runpy.run_module(module, run_name="__main__", alter_sys=True)
            except SystemExit as e:
                code = e.code or 0
        gc.collect()
        torch.cuda.empty_cache()
        line = {"module": module, "seconds": time.perf_counter() - t0,
                "launches": read_launches(), "sampling_calls": calls.calls}
        if os.environ.get(LAUNCHES_FILE_ENV):  # the campaign phase's legs: one line a process
            with open(os.environ[LAUNCHES_FILE_ENV], "a") as f:
                f.write(json.dumps({"argv": args, **line}) + "\n")
        print(json.dumps(line), flush=True)
        if code:
            break
    return code


def sample_cli(torch, card, reps=4):
    """Both file entry points, `python -m dynamicvectorquantization_torch.
    sample.val` (with grids) and `...sample.images`, as subprocesses on the
    unconditional p6c18 yml with seeded weights (f32), int8 caches, batches
    of 8: `sample.val` runs `reps + 1` batches (the first pays the process's
    graph captures, `reps` are timed; none is traced: `serve` traces the
    sampler, and a traced call here took ~50 s to process), `sample.images` one (a process's first batch). Their files, each batch's
    seconds and AR steps, and their launches. `sample.val`'s pickles are
    moved to `EVAL_DUMP` for the `eval` phase."""
    import pickle
    import shutil

    import numpy as np

    root = os.path.join("build", "sample_cli")
    shutil.rmtree(root, ignore_errors=True)
    runs = {}
    n_val = reps + 1
    for module, n, extra in (("val", n_val, ["--save_grids"]), ("images", 1, [])):
        cmd = [sys.executable, os.path.abspath(__file__), "--launches-of",
               f"dynamicvectorquantization_torch.sample.{module}", "--yaml_path", P6C18,
               "--save_path", os.path.join(root, module), "--batch_size", "8", "--sample_num",
               str(8 * n), "--kv_cache_dtype", "int8", *extra]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
        wall = time.perf_counter() - t0
        lines = proc.stdout.strip().splitlines()
        require(proc.returncode == 0 and len(lines) >= 2,
                f"sample.{module} exited {proc.returncode}: {proc.stderr[-3000:]}")
        summary, counted = json.loads(lines[-2]), json.loads(lines[-1])
        calls = counted["sampling_calls"]
        require(len(calls) == n and summary["batches"] == n,
                f"sample.{module}: {len(calls)} sampling calls, {summary['batches']} batches")
        seconds = summary["batch_seconds"]
        runs[module] = dict(rc=proc.returncode, process_s=spread([wall]),
                            first_batch_s=seconds[0], first_call=calls[0],
                            ar_steps=[c["ar_steps"] for c in calls],
                            images=summary["images"], launches=counted["launches"])
        if module == "val":
            step_ms = [c["s"] / c["ar_steps"] * 1e3 for c in calls[1:]]
            runs[module].update(batch_s=spread(seconds[1:]), ar_step_ms=spread(step_ms)["median"],
                                ar_step_ms_spread=spread(step_ms))
    numpys = os.path.join(root, "val", "numpys")
    pickles = [f"batch_{i:05d}.pkl" for i in range(n_val)]
    require(sorted(os.listdir(numpys)) == pickles, f"val wrote {os.listdir(numpys)}")
    with open(os.path.join(numpys, pickles[0]), "rb") as f:
        batch = pickle.load(f)
    with open(os.path.join(root, "val", "grid_00000.png"), "rb") as f:
        grid = read_png(f.read())
    names = sorted(os.listdir(os.path.join(root, "images")))
    pngs = []
    for name in names:
        with open(os.path.join(root, "images", name), "rb") as f:
            pngs.append(read_png(f.read()))
    layers = 24
    res = dict(phase="sample_cli", config=P6C18, kv_cache_dtype="int8", weights="seeded, f32",
               batch_size=8, sample_num={"val": 8 * n_val, "images": 8}, runs=runs,
               pickle=[list(batch.shape), str(batch.dtype)], grid_shape=list(grid.shape),
               pngs=names, png_shapes=[list(p.shape) for p in pngs], card=card)
    emit(res)
    shutil.rmtree(EVAL_DUMP, ignore_errors=True)
    shutil.move(numpys, EVAL_DUMP)
    shutil.rmtree(root, ignore_errors=True)
    require(batch.dtype == np.uint8 and batch.shape == (8, 256, 256, 3),
            f"val pickled {batch.dtype} {batch.shape}")
    require(grid.shape == (2 * 258 - 2, 4 * 258 - 2, 3), f"grid PNG {grid.shape}")
    require(names == [f"{i:06d}.png" for i in range(8)]
            and all(p.shape == (256, 256, 3) for p in pngs), f"images wrote {names}")
    for module, run in runs.items():
        n = run["launches"]["decode_attention_int8"]
        require(n >= layers * sum(run["ar_steps"]) and n % layers == 0,
                f"sample.{module}: decode_attention_int8 launched {n} times")
        require(run["launches"]["fused_attention_forward"] >= 4,
                f"sample.{module}: the decoder's fused_attention_forward was not launched")
    return res


def http(torch, model, card, reps=3):
    """`python -m dynamicvectorquantization_torch.serve`'s server
    (`serve/http.py` `make_server`) in-process over the loaded model, on
    127.0.0.1 at a free port: the warm-up image (which captures the
    sampler's graphs, before the server listens, as the entry point does),
    then `reps` POSTs of 2 images and `GET /healthz`; launches of the first
    POST. No request is traced: `serve` traces the same sampler."""
    import base64
    import threading
    import urllib.request

    from dynamicvectorquantization_torch.serve import BatchingSampler
    from dynamicvectorquantization_torch.serve.http import make_server
    from dynamicvectorquantization_torch.utils.sample_wall import SamplerCalls

    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))  # loopback only
    captured_before = runner_numbers(torch, model)
    walls = []
    with SamplerCalls(torch) as calls, BatchingSampler(model, max_batch=2,
                                                       max_wait_ms=50.0) as engine:
        t0 = time.perf_counter()
        engine.generate(1, seed=0)  # the warm-up the entry point runs before it listens
        warmup_s = time.perf_counter() - t0
        graphs = runner_numbers(torch, model)
        served = engine.images_served
        server = make_server(engine, "127.0.0.1", 0)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        url = f"http://127.0.0.1:{server.server_address[1]}"
        try:
            for i in range(reps):
                torch.cuda.synchronize()
                if i == 0:
                    reset_launches()
                t0 = time.perf_counter()
                req = urllib.request.Request(
                    url + "/generate", data=json.dumps({"num_images": 2, "seed": 7 + i}).encode(),
                    headers={"Content-Type": "application/json"})
                with opener.open(req, timeout=900) as r:
                    status, body = r.status, json.loads(r.read())
                walls.append(time.perf_counter() - t0)
                require(status == 200, f"POST /generate: HTTP status {status}")
                if i == 0:
                    launches = read_launches()
                    images = [read_png(base64.b64decode(b)) for b in body.get("images", [])]
            with opener.open(url + "/healthz", timeout=60) as r:
                health_status, health = r.status, json.loads(r.read())
        finally:
            server.shutdown()
            server.server_close()
            thread.join()
        stats = list(engine.batch_stats)
        sampling = sampling_numbers(calls, 0, range(1, reps + 1), None)
    layers = model.transformer.position_layer + model.transformer.content_layer
    timed = walls
    res = dict(phase="http", config=P6C18, kv_cache_dtype="int8", max_batch=2,
               request={"num_images": 2, "seeds": [7 + i for i in range(reps)]},
               status=status, healthz=health, healthz_status=health_status,
               warmup_s=spread([warmup_s]), request_s=spread(timed)["median"],
               request_s_spread=spread(timed),
               images_served_before=served, batch_stats=stats, launches=launches,
               shapes=[list(i.shape) for i in images], sampling=sampling,
               warmup_captures=graphs["captures"] - captured_before["captures"],
               warmup_capture_s=graphs["capture_s"] - captured_before["capture_s"],
               captures_while_serving=runner_numbers(torch, model)["captures"]
               - graphs["captures"], card=card)
    emit(res)
    require(health_status == 200 and health["ok"], f"GET /healthz: status {health_status}")
    require(len(images) == 2 and all(i.shape == (256, 256, 3) for i in images),
            f"POST /generate gave {[i.shape for i in images]}")
    require(served == 1 and health["images_served"] == served + 2 * reps,
            f"images_served {served} after the warm-up, {health['images_served']} after")
    require(launches["decode_attention_int8"] >= layers * stats[1]["ar_steps"],
            "decode_attention_int8 was not launched on every decode step of the request")
    require(res["captures_while_serving"] == 0, "the server captured graphs while it listened")
    return res


def _digest(arr):
    """sha256 and per-channel sums (float64) of an array, as
    `tests/fixtures/images/make_fixtures.py` records them."""
    import hashlib

    import numpy as np

    arr = np.ascontiguousarray(arr)
    return (hashlib.sha256(arr.tobytes()).hexdigest(),
            arr.reshape(-1, arr.shape[-1]).sum(0, dtype=np.float64).tolist())


def check_fixtures():
    """The port's decode and transforms of every committed fixture against
    `expected.json` (the JAX package's arrays, made where PIL, libjpeg and
    the JAX package are installed): equal hashes, else the largest
    per-channel sum difference. Any mismatch fails: libjpeg and the port's
    own decoder both give libjpeg's pixels."""
    import numpy as np

    from dynamicvectorquantization_torch.data import transforms as T
    from dynamicvectorquantization_torch.data.image_io import read_image

    with open(os.path.join(FIXTURES, "expected.json")) as f:
        expected = json.load(f)
    checked, mismatched, worst = 0, [], 0.0
    for name, entry in sorted(expected["files"].items()):
        for size in expected["sizes"]:
            arr, mode = read_image(os.path.join(FIXTURES, name), min_side=size)
            outs = {f"decoded_{size}": arr}
            for t in expected["transforms"]:
                outs[f"{t}_{size}"] = getattr(T, t)((arr, mode), size,
                                                    np.random.default_rng(expected["seed"]))
            for key, out in outs.items():
                sha, sums = _digest(out)
                want = entry[key]
                checked += 1
                if sha != want["sha256"] or (key.startswith("decoded") and mode != want["mode"]):
                    diff = max(abs(a - b) for a, b in zip(sums, want["channel_sums"]))
                    worst = max(worst, diff)
                    mismatched.append(dict(file=name, key=key, mode=mode,
                                           channel_sum_diff=diff))
    return dict(files=len(expected["files"]), checked=checked, mismatched=mismatched,
                largest_channel_sum_diff=worst, tolerance="equal sha256 (bit for bit)")


def check_cut_fixtures():
    """F13: four committed JPEGs (baseline and progressive, Huffman and
    arithmetic) cut short at 0.3, 0.6 and 0.95 of their length
    (`make_fixtures.py` `CUT_FILES`, `CUT_FRACTIONS`), decoded at every
    DCT-domain denominator, against `expected_cut.json` (the libjpeg-turbo
    PIL bundles, through a memory source): equal digests, or refused by both."""
    import importlib.util

    from dynamicvectorquantization_torch import native

    spec = importlib.util.spec_from_file_location("make_fixtures",
                                                  os.path.join(FIXTURES, "make_fixtures.py"))
    mf = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mf)
    with open(os.path.join(FIXTURES, "expected_cut.json")) as f:
        doc = json.load(f)

    def decode(data, d):
        header = native.jpeg_header(data)
        if isinstance(header, str):
            return None
        h, w, _ = header
        return native._decode(data, d, 0, 3, (-(-h // d), -(-w // d)))[0]

    got = mf.expected_cut_entries(decode)
    entries = [(k, d, v) for k, e in doc["files"].items() for d, v in e.items()]
    return dict(files=len(mf.CUT_FILES), fractions=doc["fractions"], checked=len(entries),
                refused=sum(v == "refused" for _, _, v in entries),
                mismatched=[f"{k} 1/{d}" for k, d, v in entries if got[k][d] != v],
                reference=f"libjpeg-turbo {doc['libjpeg_turbo']} (PIL's), memory source",
                decoder=native.decoder_name())


def image_trees(root, n_train=512, n_val=64, n_ffhq=64, ffhq_side=1024):
    """An ImageNet-layout tree of fixture copies (train: 4 synsets, `n_train`
    files, the five RGB / grey JPEGs round robin with one CMYK JPEG and one
    PNG named .JPEG in every 128; val: `n_val`) and an FFHQ-layout tree of
    `n_ffhq` RGB PNGs of `ffhq_side`^2 written by `encode_png` from seeded
    smooth images (8^2 noise, Pillow-bicubic upscaled)."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from dynamicvectorquantization_torch import native
    from dynamicvectorquantization_torch.utils.logging import encode_png

    def source(i):
        if i % 128 == 0:
            return "cmyk_q90.jpg"
        if i % 128 == 1:
            return "png_named.JPEG"
        return FIXTURE_JPEGS[i % len(FIXTURE_JPEGS)]

    for split, n in (("train", n_train), ("val", n_val)):
        for i in range(n):
            d = os.path.join(root, "imagenet", split, f"n0{i % 4}")
            os.makedirs(d, exist_ok=True)
            shutil.copy(os.path.join(FIXTURES, source(i)), os.path.join(d, f"{split}_{i:05d}.JPEG"))
    ffhq = os.path.join(root, "ffhq", "images")
    os.makedirs(ffhq)

    def write(i):
        low = np.random.default_rng(i).integers(0, 256, size=(8, 8, 3), dtype=np.uint8)
        with open(os.path.join(ffhq, f"{i:05d}.png"), "wb") as f:
            f.write(encode_png(native.resample(low, ffhq_side, ffhq_side, native.BICUBIC)))

    with ThreadPoolExecutor(8) as pool:
        list(pool.map(write, range(n_ffhq)))
    return os.path.join(root, "imagenet"), os.path.join(root, "ffhq")


def loader_rates(dataset, workers=(1, 8), epochs=1, batch=32):
    """Images/s through `PrefetchLoader` over whole epochs, per worker count."""
    from dynamicvectorquantization_torch.data.pipeline import PrefetchLoader

    out = {}
    for w in workers:
        loader = PrefetchLoader(dataset, batch_size=batch, shuffle=True, num_workers=w, seed=0)
        rates = []
        for e in range(epochs):
            t0 = time.perf_counter()
            n = sum(len(b["image"]) for b in loader.epoch(e))
            rates.append(n / (time.perf_counter() - t0))
        out[str(w)] = spread(rates)
    return out


def _ms(fn, reps=30):
    """Host milliseconds a call: the spread of `reps` calls after one."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return spread(times)


@contextlib.contextmanager
def timed_stage1_steps(torch, steps):
    """Each `Stage1Trainer.train_step` between two synchronises: its wall
    seconds and the kernel launches it made, appended to `steps`."""
    from dynamicvectorquantization_torch.train.stage1 import Stage1Trainer

    original = Stage1Trainer.train_step

    def timed(self, *args, **kwargs):
        torch.cuda.synchronize()
        before = read_launches()
        t0 = time.perf_counter()
        out = original(self, *args, **kwargs)
        torch.cuda.synchronize()
        after = read_launches()
        steps.append(dict(s=time.perf_counter() - t0,
                          launches={k: after[k] - before[k] for k in after if after[k] - before[k]}))
        return out

    Stage1Trainer.train_step = timed
    try:
        yield
    finally:
        Stage1Trainer.train_step = original


def data_real(torch, dev, card):
    """Real image files on the card, without PIL: the host libraries' build,
    the fixtures against `expected.json`, loader images/s over an ImageNet
    tree of JPEGs and an FFHQ tree of 1024^2 PNGs at 1 and 8 workers,
    the shipped stage-1 yml trained from the JPEG tree by the training
    command line (`train/cli.py` `main` in-process, as `fit1`; the yml's
    batch 30 and 8 workers, f32, `remat` by default; one epoch of 4 steps,
    validation on 2 batches), and the entropy-threshold and grain-map tools
    over the tree; with PIL blocked after the build line, whether or not the
    machine has it."""
    from dynamicvectorquantization_torch import native

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    native.lib("image_core")
    decoder = native.decoder_name()  # libjpeg where it builds, else the port's own decoder
    try:
        libjpeg = native.jpeg_version()
    except RuntimeError as e:
        libjpeg = {"unavailable": str(e)[:600]}
    try:
        import PIL  # noqa: F401
        pil = True
    except ImportError:
        pil = False
    build = dict(seconds=time.perf_counter() - t0, build_seconds=dict(native.build_seconds),
                 decoder=decoder, backend=native.jpeg_backend(), libjpeg=libjpeg,
                 cpu_count=os.cpu_count(), cpus_usable=len(os.sched_getaffinity(0)),
                 pil_imports=pil, pil_blocked_in_phase=True, cxxflags=native.CXXFLAGS)
    # the rest of the phase runs as on a machine without PIL: an import of it fails
    saved_pil = {name: mod for name, mod in sys.modules.items() if name.split(".")[0] == "PIL"}
    sys.modules["PIL"] = None
    try:
        return _data_real(torch, dev, card, t_phase, build)
    finally:
        del sys.modules["PIL"]
        sys.modules.update(saved_pil)


def _data_real(torch, dev, card, t_phase, build):
    """`data_real` after the build line, PIL blocked."""
    import tempfile

    from dynamicvectorquantization_torch.data import datasets
    from dynamicvectorquantization_torch.data import transforms as T
    from dynamicvectorquantization_torch.data.image_io import read_image
    from dynamicvectorquantization_torch.data.pipeline import PrefetchLoader
    from dynamicvectorquantization_torch.ops.entropy import patch_entropy_plain
    from dynamicvectorquantization_torch.tools import (
        calculate_entropy_thresholds as thresholds_tool,
    )
    from dynamicvectorquantization_torch.tools import visualize_dual_grain
    from dynamicvectorquantization_torch.train import cli

    t0 = time.perf_counter()
    fixtures = check_fixtures()
    fixtures["seconds"] = time.perf_counter() - t0
    require(not fixtures["mismatched"],
            f"data_real: the port's arrays differ from expected.json: {fixtures['mismatched']}")
    # the arithmetic-coded fixtures (SOF9; SOF10 with restarts) are among them
    with open(os.path.join(FIXTURES, "expected.json")) as f:
        arith = sorted(n for n in json.load(f)["files"] if n.startswith("arith"))
    require(len(arith) == 2, f"data_real: arithmetic fixtures {arith}")
    fixtures["arithmetic_files"] = arith
    t0 = time.perf_counter()
    fixtures["cut"] = check_cut_fixtures()
    fixtures["cut"]["seconds"] = time.perf_counter() - t0
    require(not fixtures["cut"]["mismatched"],
            f"data_real: cut JPEGs differ from expected_cut.json: {fixtures['cut']}")

    res = dict(phase="data_real", build=build, fixtures=fixtures, card=card)
    with tempfile.TemporaryDirectory(prefix="dqvq_data_real_") as root:
        t0 = time.perf_counter()
        imagenet, ffhq = image_trees(root)
        res["trees"] = dict(seconds=time.perf_counter() - t0, imagenet_train=512,
                            imagenet_val=64, ffhq_png_1024=64,
                            ffhq_png_mb=sum(os.path.getsize(os.path.join(ffhq, "images", n))
                                            for n in os.listdir(os.path.join(ffhq, "images")))
                            / 2 ** 20)
        # one core, one image: a 500x375 q 90 JPEG at ImageNet's size 256 (decoded at full
        # size: 375 // 2 < 256), its resize to a 256 short side, a 1024^2 PNG of the FFHQ tree
        jpeg_path = os.path.join(FIXTURES, FIXTURE_JPEGS[0])
        png_path = os.path.join(ffhq, "images", "00000.png")
        arr, mode = read_image(jpeg_path, min_side=256)
        res["one_image_ms"] = {
            "jpeg_500x375_decode": _ms(lambda: read_image(jpeg_path, min_side=256)),
            "resize_375x500_to_256x341": _ms(lambda: T.resize((arr, mode), (341, 256))),
            "png_1024_decode": _ms(lambda: read_image(png_path), reps=10)}
        t0 = time.perf_counter()
        res["loader_images_per_s"] = {
            "imagenet_train_256": loader_rates(datasets.ImageNetTrain({"size": 256},
                                                                      root=imagenet)),
            "ffhq_train_256": loader_rates(datasets.FFHQTrain(size=256, root=ffhq))}
        res["loader_seconds"] = time.perf_counter() - t0

        # the shipped stage-1 yml from the JPEG tree through the command line
        logdir = os.path.join(root, "logs")
        steps = []
        saved = os.environ.get("DQVQ_IMAGENET_ROOT")
        os.environ["DQVQ_IMAGENET_ROOT"] = imagenet
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        try:
            with timed_stage1_steps(torch, steps):
                trainer = cli.main(["--base", STAGE1, "--logdir", logdir, "--name", "files",
                                    "--max_epochs", "1", "--max_steps_per_epoch", "4",
                                    "--log_every", "1", "--image_log_every", "0",
                                    "--save_n", "1"])
        finally:
            if saved is None:
                os.environ.pop("DQVQ_IMAGENET_ROOT")
            else:
                os.environ["DQVQ_IMAGENET_ROOT"] = saved
        run_s = time.perf_counter() - t0
        launches = read_launches()
        remat = getattr(trainer, "remat", None)
        del trainer
        torch.cuda.empty_cache()
        run_dir = _only_dir(logdir, "files-")
        with open(os.path.join(run_dir, "loop_buckets.json")) as f:
            buckets = json.load(f)
        rows = _rows(run_dir)
        step_s = [s["s"] for s in steps]
        pull_s = buckets["buckets"].get("pull", 0.0)
        res["stage1_files"] = dict(
            config=STAGE1, batch=30, num_workers=8, dtype="float32", remat=remat,
            steps=len(steps), first_step_ms=step_s[0] * 1e3,
            step_ms=spread([s * 1e3 for s in step_s[1:]]),
            images_per_s=30 / spread(step_s[1:])["median"],
            pull_ms_per_step=pull_s / len(steps) * 1e3,
            pull_share_of_step=pull_s / sum(step_s),
            buckets_s=buckets["buckets"], run_s=run_s,
            launches_per_step=steps[-1]["launches"],
            launches_equal_every_step=all(s["launches"] == steps[0]["launches"] for s in steps),
            launches=launches, val_rows=[r for r in rows if r["split"] == "val"],
            train_losses=[r.get("train_aeloss", r.get("train_loss")) for r in rows
                          if r["split"] == "train"],
            peak_gb=torch.cuda.max_memory_allocated() / 2 ** 30)

        # the tools over the tree: thresholds through the kernel, against the plain version
        out_dir = os.path.join(root, "thresholds")
        reset_launches()
        t0 = time.perf_counter()
        os.environ["DQVQ_IMAGENET_ROOT"] = imagenet
        try:
            thresholds_tool.main(["--dataset", "imagenet", "--out_dir", out_dir])
            tool_launches = read_launches()["patch_entropy"]
            tool_s = time.perf_counter() - t0
            with open(os.path.join(out_dir, "entropy_thresholds_imagenet_train_patch-16.json")) as f:
                table = json.load(f)
            ds = thresholds_tool.dataset_of("imagenet", "train", 256)
            loader = PrefetchLoader(ds, batch_size=64, shuffle=False, num_workers=8)
            plain = thresholds_tool.percentiles(thresholds_tool.entropy_values(
                loader.epoch(0), 16, (-1.0, 1.0), dev, entropy_fn=patch_entropy_plain))
            reset_launches()
            t0 = time.perf_counter()
            vis_dir = os.path.join(root, "grain_vis")
            visualize_dual_grain.main(["--yaml_path", STAGE1, "--dataset", "imagenet",
                                       "--num_images", "16", "--save_path", vis_dir])
            vis_s = time.perf_counter() - t0
            vis_launches = {k: v for k, v in read_launches().items() if v}
            grid, grid_mode = read_image(os.path.join(vis_dir, "grain_overlay.png"))
        finally:
            os.environ.pop("DQVQ_IMAGENET_ROOT")
        diffs = [abs(table[k] - plain[k]) for k in table]
        res["tools"] = dict(
            entropy_thresholds=dict(seconds=tool_s, images=512, batches=8,
                                    patch_entropy_launches=tool_launches,
                                    max_abs_diff_to_plain=max(diffs), tol=1e-5,
                                    percentiles={k: table[k] for k in ("1", "25", "50", "75",
                                                                       "99")}),
            visualize_dual_grain=dict(seconds=vis_s, images=16, launches=vis_launches,
                                      png_shape=list(grid.shape), png_mode=grid_mode))
    res["seconds"] = time.perf_counter() - t_phase
    emit(res)
    run = res["stage1_files"]
    require(run["steps"] == 4 and len(run["val_rows"]) == 1
            and all(math.isfinite(v) for v in run["train_losses"]),
            f"data_real: the stage-1 run from files: {run['steps']} steps, {run['val_rows']}")
    want = {"vq_nearest_train": 2, "patch_entropy": 2, "strided_conv3x3_down": 8,
            "fused_attention_forward": 30, "fused_attention_backward": 10}
    require(run["launches_equal_every_step"] and run["remat"] is True
            and all(run["launches_per_step"].get(k) == v for k, v in want.items()),
            f"data_real: launches a step {run['launches_per_step']}, expected {want} (remat)")
    tools = res["tools"]
    require(tools["entropy_thresholds"]["patch_entropy_launches"] == 8
            and tools["entropy_thresholds"]["max_abs_diff_to_plain"] <= 1e-5,
            f"data_real: entropy thresholds {tools['entropy_thresholds']}")
    require(tools["visualize_dual_grain"]["png_shape"] == [4 * 258 - 2, 4 * 258 - 2, 3]
            and tools["visualize_dual_grain"]["launches"].get("vq_nearest") == 1,
            f"data_real: visualize_dual_grain {tools['visualize_dual_grain']}")
    return res


def all_families(counts, name):
    """A wrapper's launches in every kernel family (the attention rows count
    the FMA family under `name`, the others beside it; downsample and entropy
    their bf16 launches beside)."""
    return sum(counts.get(f"{name}{suffix}", 0) for suffix in ("", "_tc", "_f32_tc", "_bf16"))


def leg_of(line):
    """The campaign leg a `--launches-of` line belongs to."""
    if line["module"].endswith("calculate_entropy_thresholds"):
        return "thresholds"
    if line["module"].endswith(".train"):
        return "stage1" if "s1" in line["argv"] else "stage2"
    return line["module"].rsplit(".", 1)[-1]


def check_leg(leg, counts):
    missing = [k for k in CAMPAIGN_KERNELS.get(leg, ()) if not all_families(counts, k)]
    require(not missing, f"campaign {leg}: no launch of {missing}")


def campaign(torch, card):
    """The two campaign tools on the card (the long campaign is a process of
    its own, `tools.campaign_product` over the whole committed tree):

      * the thresholds tool over the full committed train tree (3,072 JPEGs)
        against the JAX campaign's committed table, every percentile within
        1e-6 + 1e-4 |ref|;
      * `tools.campaign_product --skip_data` at full width over a 32 + 8
        file subtree, one epoch a stage, `--sample_num 8`, the thresholds
        table of the whole tree reused, every other leg a process run
        through `--launches-of` (the FID leg as it is): the summary's keys,
        finite curves, the best val step retained;
      * `tools.convergence_campaign` stage1 / stage2 / finalize in-process at
        full width, 4 steps each over pools of 64 + 16;

    each leg's kernel launches asserted (`CAMPAIGN_KERNELS`), the
    checkpoints deleted after."""
    import numpy as np

    from dynamicvectorquantization_torch.tools import campaign_product as cp
    from dynamicvectorquantization_torch.tools import convergence_campaign as cc

    t_phase = time.perf_counter()
    root = os.path.abspath(os.path.join("build", "campaign"))
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    launches_file = os.path.join(root, "launches.jsonl")
    counting = [sys.executable, os.path.abspath(__file__), "--launches-of"]
    env = {**os.environ, LAUNCHES_FILE_ENV: launches_file}

    # 1. the thresholds tool over the whole committed train tree
    t0 = time.perf_counter()
    thresholds_tool = "dynamicvectorquantization_torch.tools.calculate_entropy_thresholds"
    r = subprocess.run(counting + [thresholds_tool, "--dataset", "imagenet", "--split", "train",
                                   "--out_dir", os.path.join(root, "thresholds")],
                       env={**env, "DQVQ_IMAGENET_ROOT": os.path.abspath(CAMPAIGN_DATA)},
                       capture_output=True, text=True)
    require(r.returncode == 0, f"thresholds tool failed: {r.stderr[-2000:]}")
    with open(os.path.join(root, "thresholds", os.path.basename(CAMPAIGN_THRESHOLDS))) as f:
        got = json.load(f)
    with open(CAMPAIGN_THRESHOLDS) as f:
        ref = json.load(f)
    excess = max(abs(got[k] - ref[k]) - (1e-6 + 1e-4 * abs(ref[k])) for k in ref)
    worst = max(abs(got[k] - ref[k]) for k in ref)
    require(got.keys() == ref.keys() and excess <= 0,
            f"thresholds over the committed tree: largest |diff| {worst} beyond 1e-6 + 1e-4 |ref|")
    tool = dict(seconds=time.perf_counter() - t0, files=json.loads(r.stdout.splitlines()[-2])
                .get("images"), max_abs_diff=worst, tol="1e-6 + 1e-4 |ref|",
                equal=all(got[k] == ref[k] for k in ref))
    with open(launches_file) as f:
        check_leg("thresholds", json.loads(f.readline())["launches"])
    os.remove(launches_file)

    # 2. campaign_product over a 32 + 8 file subtree (four steps a stage), every leg counted
    sub = os.path.join(root, "data")
    for split, n in (("train", 32), ("val", 8)):
        classes = sorted(os.listdir(os.path.join(CAMPAIGN_DATA, split)))
        for i in range(n):
            cls = classes[i % len(classes)]
            name = sorted(os.listdir(os.path.join(CAMPAIGN_DATA, split, cls)))[i // len(classes)]
            os.makedirs(os.path.join(sub, split, cls), exist_ok=True)
            os.symlink(os.path.abspath(os.path.join(CAMPAIGN_DATA, split, cls, name)),
                       os.path.join(sub, split, cls, name))
    out = os.path.join(root, "product")
    # the product's thresholds leg reuses the table of the whole tree made above (the
    # tool's run and launches are checked there), as a re-run of a campaign reuses its own
    os.makedirs(os.path.join(out, "thresholds"))
    shutil.copy(os.path.join(root, "thresholds", os.path.basename(CAMPAIGN_THRESHOLDS)),
                os.path.join(out, "thresholds", cp.THRESHOLDS_NAME))
    saved_module, saved_env = cp._module, os.environ.get(LAUNCHES_FILE_ENV)
    cp._module = lambda name: (saved_module(name) if name == "eval.compute_fid"
                               else counting + [f"dynamicvectorquantization_torch.{name}"])
    os.environ[LAUNCHES_FILE_ENV] = launches_file
    t0 = time.perf_counter()
    try:
        require(cp.main(["--out", out, "--skip_data", "--data_root", sub, "--s1_epochs", "1",
                         "--s2_epochs", "1", "--sample_num", "8"]) == 0, "campaign_product")
    finally:
        cp._module = saved_module
        if saved_env is None:
            os.environ.pop(LAUNCHES_FILE_ENV)
        else:
            os.environ[LAUNCHES_FILE_ENV] = saved_env
    product_s = time.perf_counter() - t0
    with open(os.path.join(out, "summary.json")) as f:
        summary = json.load(f)
    require(set(cp.SUMMARY_KEYS) <= set(summary), "campaign_product: summary keys")
    curves = [r["val_rec_loss"] for r in summary["s1_val"]] + [
        r["val_loss"] for r in summary["s2_val"]] + [
        r["proxy_fid"] for r in summary["s2_sample_proxy_fid"]]
    require(curves and all(np.isfinite(v) for v in curves) and summary["s2_best_val_retained"],
            f"campaign_product: curves {curves}, retained {summary['s2_best_val_retained']}")
    legs = {}
    with open(launches_file) as f:
        for line in map(json.loads, f):
            leg = leg_of(line)
            counts = legs.setdefault(leg, dict.fromkeys(line["launches"], 0))
            for k, v in line["launches"].items():
                counts[k] += v
    for leg, counts in legs.items():
        check_leg(leg, counts)
    require({"stage1", "stage2", "val"} <= set(legs), f"campaign legs {list(legs)}")
    shutil.rmtree(os.path.join(out, "logs"))  # GB of checkpoints

    # 3. convergence_campaign, in-process
    conv = os.path.join(root, "convergence")
    # validation, grid and samples once, at the end (a cadence of 4 would repeat them there)
    common = ["--steps", "4", "--dispatch", "4", "--pool", "64", "--val", "16", "--batch", "8",
              "--log-every", "4", "--eval-every", "1000", "--grid-every", "1000", "--out", conv]
    conv_legs = {}
    for cmd, extra in (("stage1", []), ("stage2", ["--cached-codes", "--sample-every", "0"])):
        reset_launches()
        t0 = time.perf_counter()
        require(cc.main([cmd, *common, *extra]) == 0, f"convergence {cmd}")
        torch.cuda.synchronize()
        counts = read_launches()
        check_leg(cmd, counts)
        conv_legs[cmd] = dict(seconds=time.perf_counter() - t0,
                              launches={k: v for k, v in counts.items() if v})
        torch.cuda.empty_cache()
    bench = cc.finalize(conv)
    rows = {k: v for k, v in bench["curves"].items() if v is not None}
    require(len(rows) == 6 and all(np.isfinite(list(v.values())).all() for v in rows.values()),
            f"convergence finalize: {bench['curves']}")
    for png in ("stage1_grid_000004.png", "stage2_samples_000004.png"):
        with open(os.path.join(conv, png), "rb") as f:
            require(read_png(f.read()).ndim == 3, png)
    os.remove(os.path.join(conv, "stage1_state.pt"))
    total = {}
    for counts in [*legs.values(), *(leg["launches"] for leg in conv_legs.values())]:
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
    res = dict(phase="campaign", card=card, thresholds=tool,
               product=dict(seconds=product_s, leg_seconds=summary["leg_seconds"],
                            s1_val=summary["s1_val"], s2_val=summary["s2_val"],
                            proxy_fid=summary["s2_sample_proxy_fid"],
                            s1_remat=summary.get("s1_remat"), curves=summary["curves"],
                            launches={leg: {k: v for k, v in c.items() if v}
                                      for leg, c in legs.items()}),
               convergence=dict(conv_legs, curves=bench["curves"], plots=bench["plots"]),
               seconds=time.perf_counter() - t_phase)
    emit(res)
    shutil.rmtree(root, ignore_errors=True)
    return dict(res, launches=total)


# the distributed path at world size 1 against the one-process path, both stages bit for bit:
# a sum over one rank is its value, a bf16 gradient's f32 copy is exact, a slice of a leaf
# updates as the leaf, and stage 1's BatchNorm takes one formula (two sums) either way
DDP_VARIANTS = (("plain", False, None), ("ddp", True, None), ("zero1", True, "zero1"),
                ("fsdp", True, "fsdp"))
# two gloo ranks sharing the card against one process over the global batch, f32, TF32 off:
# losses relative; parameters after two Adam steps in units of lr (a gradient entry whose sign
# the summation order flips moves its parameter by up to 2 lr a step), and on the mean
DDP_GLOO_TOL = {"loss_rel": 1e-5, "param_max_lr": 4.04, "param_mean_lr": 1e-3}
DDP_RANK = "--ddp-rank"


def _p6c18_for_ddp(torch, dev):
    """p6c18 at full width and depth with the training caps, seeded, dropout 0."""
    from dynamicvectorquantization_torch.config.yaml_config import load_config
    from dynamicvectorquantization_torch.utils.instantiate import instantiate_from_config

    config = load_config([P6C18])
    config["model"]["params"]["permuter_config"]["params"].update(TRAIN_CAPS)
    with torch.device(dev):
        model = instantiate_from_config(config["model"])
    model.init_weights(torch.Generator(device=dev).manual_seed(0))
    set_dropout(model.transformer, 0.0, 0.0, 0.0)
    return model.eval(), config["model"]["learning_rate"]


def ddp_stage2(torch, dev, world, streams, batch=8, steps=4, windows=3):
    """The bf16 cached-codes p6c18 step (graph replays) on the one-process
    path and through the distributed path at world size 1 (DDP with the
    collectives captured in the step's graph, ZeRO-1, FSDP): after a capture step, `steps` steps
    (launches counted), their logs and the whole state (masters, moments)
    compared with the one-process path's bit for bit; then `windows` timed
    windows of `steps` steps and one traced window (busy, idle share, NCCL
    kernels' time)."""
    from dynamicvectorquantization_torch.train.stage2 import Stage2Trainer

    model, lr = _p6c18_for_ddp(torch, dev)
    start = {k: v.detach().clone() for k, v in model.transformer.state_dict().items()}
    n = streams["coarse_content"].shape[0]
    batches = [{k: v[i:i + batch] for k, v in streams.items()} for i in range(0, n, batch)]
    out, ref = {}, None
    for name, distributed, shard in DDP_VARIANTS:
        model.transformer.float()
        model.transformer.load_state_dict(start)
        trainer = Stage2Trainer(model, lr, warmup_steps=0, max_steps=10_000,
                                compute_dtype="bfloat16", device=dev,
                                world=world if distributed else None, shard=shard)

        def window(first):
            return [trainer.train_step(batches[(first + i) % len(batches)]) for i in range(steps)]

        trainer.train_step(batches[0])  # warm-up and capture
        torch.cuda.synchronize()
        reset_launches()
        logs = window(1)
        torch.cuda.synchronize()
        launches = read_launches()
        state = trainer.state_dict()
        got = dict(logs=[{k: float(v) for k, v in step.items()} for step in logs],
                   state={part: {k: v.clone() for k, v in state[part].items()}
                          for part in ("masters", "m", "v")})
        del state
        times = []
        for _ in range(windows):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            window(1)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3 / steps)
        prof = profile_device_time(torch, lambda: window(1), n_top=6,
                                   groups={"nccl": "nccl", "fused_adamw": "adamw"})
        line = dict(step_ms=spread(times), launches_per_step={
                        k: v // steps for k, v in launches.items()},
                    device_busy_ms_per_step=(prof["device_busy_ms"] or 0.0) / steps,
                    device_idle_share=prof["device_idle_share"],
                    collective_ms_per_step=prof["groups"]["nccl"] / steps,
                    adamw_ms_per_step=prof["groups"]["fused_adamw"] / steps,
                    top=prof["top"], sharded_leaves=(len(trainer.buckets.sharded)
                                                     if trainer.buckets else 0))
        require(launches["fused_attention_forward_tc"] == 24 * steps
                and launches["fused_attention_backward_tc"] == 24 * steps
                and launches["fused_adamw"] == len(trainer.params) * steps,
                f"ddp {name}: launches {launches}")
        if ref is None:
            ref = got
            line["held_to"] = "itself"
        else:
            differ = [k for part in ("masters", "m", "v") for k in ref["state"][part]
                      if not torch.equal(got["state"][part][k], ref["state"][part][k])]
            line.update(bit_equal_to_plain=not differ and got["logs"] == ref["logs"],
                        differ=differ[:5], logs_equal=got["logs"] == ref["logs"],
                        max_param_diff=max(float((got["state"]["masters"][k]
                                                  - ref["state"]["masters"][k]).abs().max())
                                           for k in ref["state"]["masters"]))
            require(line["bit_equal_to_plain"],
                    f"ddp {name}: the world-1 step differs from the one-process step: {line}")
            del got
        out[name] = line
        runner_free(trainer)
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
    del model, ref
    gc.collect()
    torch.cuda.empty_cache()
    return out


def runner_free(trainer):
    """Drop a trainer's captured graphs (and their pool) before the next one."""
    from dynamicvectorquantization_torch.models.graphs import runners_of

    for runner in list(runners_of(trainer).values()):
        runner.graphs.clear()


@contextlib.contextmanager
def _two_sum_batch_norm():
    """Inside: the one-process BatchNorm takes the distributed path's formula
    (`BatchNorm2d._global_batch`: two sums, which outside a `global_stats`
    scope run over this process's rows) in place of `F.batch_norm`'s."""
    import types

    from dynamicvectorquantization_torch.nn.discriminator import BatchNorm2d

    one_rank, batch_norm = types.SimpleNamespace(size=1), BatchNorm2d.forward

    def forward(self, x, train=False):
        return self._global_batch(x, one_rank) if train else batch_norm(self, x, train)

    BatchNorm2d.forward = forward
    try:
        yield
    finally:
        BatchNorm2d.forward = batch_norm


# stage 1's one-process step (cuDNN's BatchNorm) against the same step with the distributed
# path's two-sum BatchNorm: the formulas' f32 rounding alone, held on the losses and on the
# statistics the step updates (relative to each buffer's largest entry); the parameters and
# moments are reported (one Adam step moves an entry by up to 2 lr wherever rounding flips the
# sign of a near-zero gradient), the formula itself held in f64 by
# tests/test_torch_distributed.py::test_global_batchnorm_equals_batch_norm
BN_FORMULA_TOL = {"logs": 1e-5, "codebook": 1e-5, "batchnorm": 1e-5}
# (name, distributed, shard, two-sum BatchNorm in one process)
STAGE1_VARIANTS = (("plain", False, None, False), ("plain_two_sums", False, None, True),
                   ("ddp", True, None, False), ("zero1", True, "zero1", False),
                   ("fsdp", True, "fsdp", False))


def ddp_stage1(torch, dev, world, batch=8, timed_steps=2):
    """The shipped stage-1 yml, f32, batch 8, `remat` off: one step from one
    state (cuDNN's deterministic algorithms) on the one-process path, on the
    one-process path with the distributed path's BatchNorm formula, and
    through the distributed path at world size 1 (DDP, ZeRO-1, FSDP). Each
    distributed step must equal the one-process step with the same formula
    bit for bit, and that step the plain one within `BN_FORMULA_TOL`; then
    timed steps (not of the formula's control)."""
    from dynamicvectorquantization_torch.config.yaml_config import load_config
    from dynamicvectorquantization_torch.train.stage1 import Stage1Trainer
    from dynamicvectorquantization_torch.utils.instantiate import instantiate_from_config

    config = load_config([STAGE1])["model"]
    lr = config["base_learning_rate"] * batch
    with torch.device(dev):
        model = instantiate_from_config(config)
    g = torch.Generator(device=dev).manual_seed(6)
    x = smooth_and_noisy_images(torch, dev, g, b=batch, size=model.encoder.resolution)
    start = None
    out, got_of = {}, {}
    for name, distributed, shard, two_sums in STAGE1_VARIANTS:
        trainer = Stage1Trainer(model, lr, warmup_steps=0, max_steps=10_000, device=dev,
                                remat=False, world=world if distributed else None, shard=shard)
        if start is None:
            trainer.init_state(torch.Generator(device=dev).manual_seed(0))
            start = {k: v.clone() for k, v in model.state_dict().items()}
        else:
            model.load_state_dict(start)
            trainer.init_state()
        reset_launches()
        # cuDNN's deterministic algorithms: a convolution's backward sums in one order each time
        saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
        try:
            with _two_sum_batch_norm() if two_sums else contextlib.nullcontext():
                logs = trainer.train_step(x, torch.Generator(device=dev).manual_seed(13))
            torch.cuda.synchronize()
        finally:
            torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved
        launches = read_launches()
        state = trainer.state_dict()
        got_of[name] = ({k: v.clone() for k, v in logs.items()},
                        {"model": {k: v.clone() for k, v in state["model"].items()},
                         **{o: {p: {k: v.clone() for k, v in state[o][p].items()}
                                for p in ("m", "v")} for o in ("ae_opt", "disc_opt")}},
                        trainer.generator.get_state())
        del state
        require(launches["vq_nearest_train"] == 2 and launches["strided_conv3x3_down"] == 8,
                f"ddp stage 1 {name}: launches {launches}")
        line = dict(launches_per_step=launches)
        if two_sums:  # the formulas' rounding: held on logs and statistics, the rest reported
            _, groups, _ = remat_differences(torch, got_of[name], got_of["plain"], lr)
            line.update(held_to="plain", differences=groups, tol=BN_FORMULA_TOL)
            require(all(groups[k] <= BN_FORMULA_TOL[k] for k in BN_FORMULA_TOL),
                    f"ddp stage 1: the two BatchNorm formulas differ beyond {BN_FORMULA_TOL}: "
                    f"{groups}")
        elif distributed:
            bit_equal, groups, _ = remat_differences(torch, got_of[name],
                                                     got_of["plain_two_sums"], lr)
            line.update(held_to="plain_two_sums", bit_equal=bit_equal, differences=groups)
            require(bit_equal, f"ddp stage 1 {name}: the world-1 step differs from the "
                               f"one-process step with the same BatchNorm formula: {groups}")
        if not two_sums:
            times = []
            trainer.train_step(x)  # warm-up: cuDNN's own algorithms again
            for _ in range(timed_steps):
                t0 = time.perf_counter()
                trainer.train_step(x)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            line.update(step_ms=spread(times))
        if name in ("plain", "ddp"):  # one traced step each: busy, idle share, collectives
            prof = profile_device_time(torch, lambda: trainer.train_step(x), n_top=4,
                                       groups={"nccl": "nccl"})
            line.update(device_busy_ms=prof["device_busy_ms"],
                        device_idle_share=prof["device_idle_share"],
                        collective_ms=prof["groups"]["nccl"])
        out[name] = line
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
    del model, got_of
    torch.cuda.empty_cache()
    return out


def ddp_rank(argv):
    """`chip_smoke.py --ddp-rank <rank> <size> <init> <streams file> <out file>`:
    one gloo rank on the card (two share it): p6c18 f32 (TF32 off, dropout 0)
    takes two cached-codes steps on its rows of each global batch; rank 0
    saves the logs and masters."""
    import torch

    from dynamicvectorquantization_torch.parallel import dist as pdist
    from dynamicvectorquantization_torch.train.stage2 import Stage2Trainer

    rank, size, init, streams_file, out_file = int(argv[0]), int(argv[1]), *argv[2:5]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    world = pdist.init_world("cuda", rank, size, init, backend="gloo")
    try:
        model, lr = _p6c18_for_ddp(torch, world.device)
        trainer = Stage2Trainer(model, lr, warmup_steps=0, max_steps=10_000, device=world.device,
                                world=world)
        batches = torch.load(streams_file, weights_only=False)
        t0 = time.perf_counter()
        logs = [{k: float(v) for k, v in trainer.train_step(
            {k: v[world.rows(len(v))] for k, v in b.items()}).items()} for b in batches]
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        if world.is_main:
            torch.save({"logs": logs, "masters": {k: v.cpu() for k, v in trainer.masters.items()},
                        "seconds": secs}, out_file)
    finally:
        pdist.shutdown()
    return 0


def ddp_two_processes(torch, dev, streams, batch=8):
    """(b): two gloo ranks sharing the card (`--ddp-rank` subprocesses) take
    two f32 cached-codes steps at dropout 0; held to one process's steps over
    the same global batches (`DDP_GLOO_TOL`)."""
    from dynamicvectorquantization_torch.parallel import dist as pdist
    from dynamicvectorquantization_torch.train.stage2 import Stage2Trainer

    root = os.path.abspath(os.path.join("build", "ddp"))
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    batches = [{k: v[i:i + batch] for k, v in streams.items()} for i in (0, batch)]
    streams_file, out_file = os.path.join(root, "streams.pt"), os.path.join(root, "rank0.pt")
    torch.save(batches, streams_file)
    init = f"tcp://127.0.0.1:{pdist.free_port()}"
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), DDP_RANK, str(r), "2",
                               init, streams_file, out_file],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    try:
        model, lr = _p6c18_for_ddp(torch, dev)
        one = Stage2Trainer(model, lr, warmup_steps=0, max_steps=10_000, device=dev)
        one_logs = [{k: float(v) for k, v in one.train_step(b).items()} for b in batches]
        one_masters = {k: v.clone() for k, v in one.masters.items()}
        del one, model
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        outs = [p.communicate(timeout=600)[0] for p in procs]
    ranks_s = time.perf_counter() - t0
    codes = [p.returncode for p in procs]
    tail = [o[-2000:] for o in outs]
    if codes != [0, 0]:
        text = " ".join(tail)
        if "gloo" in text.lower() and ("cuda" in text.lower() or "device" in text.lower()):
            # gloo refused CUDA tensors: a line says so, and the phase goes on
            res = dict(gloo_takes_cuda_tensors=False, exit_codes=codes, output_tail=tail)
            shutil.rmtree(root, ignore_errors=True)
            return res
        require(False, f"ddp: the two gloo ranks failed: {codes} {tail}")
    got = torch.load(out_file, weights_only=False)
    shutil.rmtree(root, ignore_errors=True)
    loss_rel = max(abs(a[k] - b[k]) / abs(b[k]) for a, b in zip(got["logs"], one_logs) for k in b)
    diffs = [(got["masters"][k].to(dev) - v).abs() for k, v in one_masters.items()]
    n_params = sum(d.numel() for d in diffs)
    param_max_lr = max(float(d.max()) for d in diffs) / lr
    param_mean_lr = sum(float(d.sum()) for d in diffs) / n_params / lr
    res = dict(gloo_takes_cuda_tensors=True, ranks=2, devices=1, global_batch=batch,
               steps=len(batches), loss_max_rel_diff=loss_rel, param_max_diff_lr=param_max_lr,
               param_mean_diff_lr=param_mean_lr, tol=DDP_GLOO_TOL, logs=got["logs"],
               one_process_logs=one_logs, rank0_steps_s=got["seconds"], ranks_wall_s=ranks_s)
    require(loss_rel <= DDP_GLOO_TOL["loss_rel"] and param_max_lr <= DDP_GLOO_TOL["param_max_lr"]
            and param_mean_lr <= DDP_GLOO_TOL["param_mean_lr"],
            f"ddp: two gloo ranks differ from one process beyond {DDP_GLOO_TOL}: {res}")
    return res


def ddp(torch, dev, card, streams):
    """World size 1 over NCCL (stage 2 and stage 1, each variant held to
    the one-process path), then two gloo ranks sharing the card."""
    from dynamicvectorquantization_torch.parallel import dist as pdist

    t_phase = time.perf_counter()
    world = pdist.init_world("cuda", 0, 1, f"tcp://127.0.0.1:{pdist.free_port()}")
    try:
        s2 = ddp_stage2(torch, dev, world, streams)
        s1 = ddp_stage1(torch, dev, world)
    finally:
        pdist.shutdown()
    two = ddp_two_processes(torch, dev, streams)
    line = dict(phase="ddp", world_size=1, backend="nccl", stage2_bf16_batch8=s2,
                stage1_f32_batch8=s1, two_gloo_ranks_one_card=two,
                two_card_run="none: the machine has one card",
                seconds=spread([time.perf_counter() - t_phase]), card=card)
    emit(line)
    return line


# ------------------------------------------------------------ model parallelism
def check_head_offset(torch, dev):
    """Each attention family's entries with a head offset (a tensor-parallel
    rank's heads: `head0`, `n_head_total`), forward with lse and backward at
    rate 0.1, the seed by value and on the device: bit-equal to the slice of
    the call over every head; without the offset the same slice draws other
    masks. Returns {family: result}."""
    from dynamicvectorquantization_torch.ops import attention as att

    seed, rate = 2 ** 62 + 99, 0.1
    table = torch.tensor([seed], dtype=torch.int64, device=dev)
    g = torch.Generator(device=dev).manual_seed(23)
    # (family, dtype, (B, T, D), heads, first local head, local heads): stage 2's hd 128 at
    # the step's shape as tp 2's second rank runs it; two heads of the DQ-VAE's hd 256 and
    # of 32 (the square tiles), one of them local
    shapes = (("tensor cores", torch.bfloat16, (8, TRAIN_T, 1024), 8, 4, 4),
              ("f32 tensor cores", torch.float32, (8, TRAIN_T, 1024), 8, 4, 4),
              ("tensor cores wide", torch.bfloat16, (4, 1024, 512), 2, 1, 1),
              ("wide f32", torch.float32, (4, 1024, 512), 2, 1, 1),
              ("square tiles", torch.float32, (2, 300, 64), 2, 1, 1),
              ("square tiles bf16", torch.bfloat16, (2, 300, 64), 2, 1, 1))
    results = {}
    for family, dtype, shape, n_head, head0, n in shapes:
        q, k, v, dy = (torch.randn(shape, generator=g, device=dev).to(dtype) for _ in range(4))
        cols = slice(head0 * shape[2] // n_head, (head0 + n) * shape[2] // n_head)
        part = [z[..., cols].contiguous() for z in (q, k, v, dy)]
        equal = {}
        for kind, s_ in (("by_value", seed), ("device_seed", table[0])):
            y, lse = att.fused_attention_forward(q, k, v, n_head, None, True, rate, True, s_)
            grads = att.fused_attention_backward(q, k, v, y, lse, dy, n_head, rate=rate, seed=s_)
            y_p, lse_p = att.fused_attention_forward(*part[:3], n, None, True, rate, True, s_,
                                                     head0=head0, n_head_total=n_head)
            g_p = att.fused_attention_backward(*part[:3], y_p, lse_p, part[3], n, rate=rate,
                                               seed=s_, head0=head0, n_head_total=n_head)
            torch.cuda.synchronize()
            equal[kind] = bool(torch.equal(y_p, y[..., cols])
                               and torch.equal(lse_p, lse[:, head0:head0 + n])
                               and all(torch.equal(a, b[..., cols]) for a, b in zip(g_p, grads)))
            del y, lse, grads, g_p
        unshifted = att.fused_attention_forward(*part[:3], n, None, True, rate, seed=seed)
        results[family] = dict(shape=list(shape), dtype=str(dtype).split(".")[-1],
                               n_head=n_head, head0=head0, local_heads=n,
                               route=att._route((q, k, v), n_head, "check"), **equal,
                               offset_changes_masks=not torch.equal(unshifted, y_p))
        del q, k, v, dy, part, y_p, lse_p, unshifted
    emit(dict(phase="kernels", kernel="attention_head_offset", rate=rate, cases=results))
    require(all(r["by_value"] and r["device_seed"] and r["offset_changes_masks"]
                for r in results.values()),
            f"an attention family's head-offset entries differ from the full call: {results}")
    return results


def check_ring_ticks(torch, dev, sp=5):
    """The sp ring's tick: the 3xTF32 family at hd 128 WITHOUT the causal
    mask, with lse (an earlier rank's block; `parallel/ring_attention.py`),
    at sp 5's rows of the p6c18 step (8, 161, 1024) in f32, forward and
    backward against the plain versions, timed with their bounds and the one
    PyTorch call (SDPA, f32)."""
    import torch.nn.functional as F

    from dynamicvectorquantization_torch.ops.attention import (
        fused_attention_backward, fused_attention_backward_plain, fused_attention_forward,
        fused_attention_forward_plain)

    b, t, d, n_head, causal, dtype = 8, TRAIN_T // sp, 1024, 8, False, torch.float32
    hd, elem = d // n_head, 4
    scale = hd ** -0.5
    g = torch.Generator(device=dev).manual_seed(29)
    sets = []
    for _ in range(n_sets(8 * b * t * d * elem)):
        q, k, v, dy = (torch.randn((b, t, d), generator=g, device=dev) for _ in range(4))
        y, lse = fused_attention_forward(q, k, v, n_head, scale, causal, return_lse=True)
        sets.append((q, k, v, y, lse, dy))
    q, k, v, y, lse, dy = sets[0]
    before = (fused_attention_forward.f32_tc_launches, fused_attention_backward.f32_tc_launches)
    y2, lse2 = fused_attention_forward(q, k, v, n_head, scale, causal, return_lse=True)
    out = fused_attention_backward(q, k, v, y, lse, dy, n_head, scale, causal)
    again = fused_attention_backward(q, k, v, y, lse, dy, n_head, scale, causal)
    y_ref, lse_ref = fused_attention_forward_plain(q, k, v, n_head, scale, causal, True)
    ref = fused_attention_backward_plain(q, k, v, y_ref, lse_ref, dy, n_head, scale, causal)
    torch.cuda.synchronize()
    require((fused_attention_forward.f32_tc_launches - before[0],
             fused_attention_backward.f32_tc_launches - before[1]) == (1, 2),
            "the ring tick did not run the 3xTF32 kernels")
    pairs = t * t

    def heads(z):
        return z.view(b, t, n_head, hd).transpose(1, 2)

    fwd = dict(phase="kernels", kernel="fused_attention_forward", shape=[b, t, d],
               n_head=n_head, causal=causal, dtype="float32", family="tensor cores",
               route="f32 tensor cores", with_lse=True, use="sp ring tick (earlier block)",
               max_abs_err=(y - y_ref).abs().max().item(),
               lse_err=(lse - lse_ref).abs().max().item(), tol="1e-4; lse 1e-4",
               bit_reproducible=bool(torch.equal(y, y2) and torch.equal(lse, lse2)))
    fwd["bound_ms"], fwd["bound_by"], fwd["bound_ms_f32_fma"] = attention_bounds(
        torch, 4 * b * t * d * elem + 4 * b * n_head * t, 4 * b * n_head * pairs * hd, dtype,
        True)
    time_into(fwd, "kernel", torch, lambda q_, k_, v_, *_: fused_attention_forward(
        q_, k_, v_, n_head, scale, causal, return_lse=True), sets)
    time_into(fwd, "plain", torch, lambda q_, k_, v_, *_: fused_attention_forward_plain(
        q_, k_, v_, n_head, scale, causal, True), sets, iters=10)
    time_into(fwd, "library", torch, lambda q_, k_, v_, *_: F.scaled_dot_product_attention(
        heads(q_), heads(k_), heads(v_), is_causal=causal, scale=scale), sets)
    emit(fwd)
    flops = 10 * b * n_head * pairs * hd
    errs = [(o - r).abs().max().item() for o, r in zip(out, ref)]
    bwd = dict(phase="kernels", kernel="fused_attention_backward", shape=[b, t, d],
               n_head=n_head, causal=causal, dtype="float32", family="tensor cores",
               route="f32 tensor cores", use="sp ring tick (earlier block)",
               max_abs_err=max(errs), dq_err=errs[0], dk_err=errs[1], dv_err=errs[2],
               tol="1e-4", bit_reproducible=all(torch.equal(a, b_) for a, b_ in zip(out, again)),
               gflop=flops / 1e9)
    bwd["bound_ms"], bwd["bound_by"], bwd["bound_ms_f32_fma"] = attention_bounds(
        torch, 8 * b * t * d * elem + 4 * b * n_head * t, flops, dtype, True)
    time_into(bwd, "kernel", torch,
              lambda *a: fused_attention_backward(*a, n_head, scale, causal), sets, iters=10)
    time_into(bwd, "plain", torch,
              lambda *a: fused_attention_backward_plain(*a, n_head, scale, causal), sets,
              iters=10)
    lib_sets = []
    for q_, k_, v_, _, _, dy_ in sets:
        leaves = tuple(heads(z).detach().requires_grad_() for z in (q_, k_, v_))
        lib_sets.append((F.scaled_dot_product_attention(*leaves, is_causal=causal, scale=scale),
                         leaves, heads(dy_)))
    time_into(bwd, "library", torch,
              lambda y_, leaves, dy_: torch.autograd.grad(y_, leaves, dy_, retain_graph=True),
              lib_sets, iters=10)
    emit(bwd)
    del sets, lib_sets, out, again, ref
    require(fwd["max_abs_err"] <= 1e-4 and fwd["lse_err"] <= 1e-4 and bwd["max_abs_err"] <= 1e-4,
            f"the non-causal 3xTF32 tick disagrees with the plain version: {fwd}, {bwd}")
    require(fwd["bit_reproducible"] and bwd["bit_reproducible"],
            "the non-causal 3xTF32 tick is not bit-reproducible")
    return fwd, bwd


MP_RANK = "--mp-rank"
P2P_RANK = "--p2p-rank"
# (axis, ranks sharing the card, trainer keywords, dropout, compute dtype): tp 2 with
# the shipped dropouts (the head offset and the dp-rank streams give it the one-process
# masks); pp 2 and sp 5 at dropout 0 (their blocks draw per rank, so with dropout they are
# not the one-process step; sp also refuses attn_pdrop > 0). Held to one process in f32 with
# TF32 off, as `ddp`'s two gloo ranks, whose `DDP_GLOO_TOL` is `MP_TOL`. Not in bf16: there a
# tp rank rounds its row-split partial products to bf16 before the sum and sp's ring computes
# attention in f32, which the one-process step does not, so a bf16 run stays outside that
# tolerance by construction
MP_CASES = (("tp", 2, {"tp": 2}, 0.1, "float32"),
            ("pp", 2, {"pp": 2, "pp_microbatches": 2}, 0.0, "float32"),
            ("sp", 5, {"sp": 5}, 0.0, "float32"))
MP_TOL = DDP_GLOO_TOL
MP_KERNELS = ("fused_attention_forward_tc", "fused_attention_backward_tc",
              "fused_attention_forward_f32_tc", "fused_attention_backward_f32_tc",
              "layernorm_forward", "layernorm_backward", "fused_adamw")


def p2p_rank(argv):
    """`chip_smoke.py --p2p-rank <rank> <size> <init>`: one ring hop of a small
    CUDA tensor over gloo's own send / recv (no staging), printed as a JSON
    line: whether this build of gloo takes CUDA tensors there."""
    import torch
    import torch.distributed as tdist

    from dynamicvectorquantization_torch.parallel import dist as pdist

    rank, size, init = int(argv[0]), int(argv[1]), argv[2]
    world = pdist.init_world("cuda", rank, size, init, backend="gloo")
    try:
        t = torch.full((4,), float(rank), device=world.device)
        out = torch.empty_like(t)
        try:
            for req in tdist.batch_isend_irecv([
                    tdist.P2POp(tdist.isend, t, (rank + 1) % size),
                    tdist.P2POp(tdist.irecv, out, (rank - 1) % size)]):
                req.wait()
            res = {"takes_cuda_tensors": bool(out[0].item() == (rank - 1) % size)}
        except RuntimeError as e:  # the answer to the question, printed
            res = {"takes_cuda_tensors": False, "error": f"{type(e).__name__}: {str(e)[:300]}"}
        print(json.dumps(res), flush=True)
    finally:
        pdist.shutdown()
    return 0


def gloo_p2p_check(log_dir, timeout=60):
    """Two `--p2p-rank` processes: does gloo send / receive CUDA tensors
    itself? (The port stages its hops through pinned host memory either
    way, `World.transport`.) A pair that does not finish in `timeout` s is
    killed and reported as hanging."""
    from dynamicvectorquantization_torch.parallel import dist as pdist

    init = f"tcp://127.0.0.1:{pdist.free_port()}"
    _, outs, ended = _run_ranks([[P2P_RANK, str(r), "2", init] for r in range(2)], log_dir,
                                timeout)
    if not ended:
        return {"takes_cuda_tensors": False, "error": f"hung: killed after {timeout} s"}
    ranks = []
    for out in outs:
        lines = [ln for ln in out.strip().splitlines() if ln.startswith("{")]
        ranks.append(json.loads(lines[-1]) if lines else {"takes_cuda_tensors": False,
                                                          "error": out[-300:]})
    return {"takes_cuda_tensors": all(r["takes_cuda_tensors"] for r in ranks), "ranks": ranks}


def _run_ranks(argvs, log_dir, timeout):
    """Start one process per argv, its output to `<log_dir>/out<i>.log`;
    (every process's output, whether all ended within `timeout` s). The ones
    still running then are killed."""
    paths = [os.path.join(log_dir, f"out{i}.log") for i in range(len(argvs))]
    procs = []
    for argv, path in zip(argvs, paths):
        with open(path, "w") as f:
            procs.append(subprocess.Popen([sys.executable, os.path.abspath(__file__), *argv],
                                          stdout=f, stderr=subprocess.STDOUT))
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1))
        ended = True
    except subprocess.TimeoutExpired:
        ended = False
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
    outs = []
    for path in paths:
        with open(path) as f:
            outs.append(f.read())
    return procs, outs, ended


def mp_rank(argv):
    """`chip_smoke.py --mp-rank <rank> <size> <init> <axis> <dropout> <compute dtype>
    <streams file> <out dir>`: one gloo rank on the card (all share it): p6c18
    takes the cached-codes steps of the `axis` run of `MP_CASES`; every rank
    writes its step seconds, launches a step, peak memory and the bytes its
    collectives were handed, rank 0 the logs and the whole masters."""
    import torch

    from dynamicvectorquantization_torch.parallel import dist as pdist
    from dynamicvectorquantization_torch.train.stage2 import Stage2Trainer

    rank, size, init, axis = int(argv[0]), int(argv[1]), argv[2], argv[3]
    dropout, dtype, streams_file, out_dir = float(argv[4]), argv[5], argv[6], argv[7]
    kw = next(c[2] for c in MP_CASES if c[0] == axis)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    world = pdist.init_world("cuda", rank, size, init, backend="gloo")
    print(f"rank {rank}: joined", flush=True)
    try:
        model, lr = _p6c18_for_ddp(torch, world.device)
        set_dropout(model.transformer, dropout, dropout, dropout)
        trainer = Stage2Trainer(model, lr, warmup_steps=0, max_steps=10_000, device=world.device,
                                world=world, compute_dtype=None if dtype == "float32" else dtype,
                                **kw)
        batches = torch.load(streams_file, weights_only=False)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        logs, secs = [], []
        for b in batches:
            t0 = time.perf_counter()
            out = trainer.train_step({k: v[trainer.dp_world.rows(len(v))] for k, v in b.items()},
                                     eager=True)
            logs.append({k: float(v) for k, v in out.items()})  # reads the step's end
            secs.append(time.perf_counter() - t0)
            print(f"rank {rank}: step {len(secs)} {secs[-1]:.3f} s", flush=True)
        counts = read_launches()
        peak = torch.cuda.max_memory_allocated()
        moved = {"model_axis": dict(trainer.axis_world.moved),
                 "dp": dict(trainer.dp_world.moved)}
        masters = trainer.state_dict()["masters"]
        info = dict(rank=rank, step_s=secs, peak_allocated_bytes=peak,
                    launches_per_step={k: counts[k] / len(batches) for k in MP_KERNELS},
                    moved_bytes_per_step={g: {op: n / len(batches) for op, n in m.items()}
                                          for g, m in moved.items()},
                    transport=trainer.axis_world.transport, tp_split_leaves=len(trainer.tp_dims))
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(info, f)
        if world.is_main:
            torch.save({"logs": logs, "masters": {k: v.cpu() for k, v in masters.items()},
                        "launches": counts}, os.path.join(out_dir, "rank0.pt"))
    finally:
        pdist.shutdown()
    return 0


def model_parallel(torch, dev, card, streams, batch=8):
    """`--tp 2`, `--pp 2` (2 microbatches, 9 content layers a stage) and
    `--sp 5` (161 rows a rank) at p6c18 full width and depth (`MP_CASES`),
    two cached-codes steps over global batches of 8: gloo ranks sharing the
    card (`--mp-rank` subprocesses), each run held to one process's steps on
    the same batches (`MP_TOL`, the `ddp` phase's `DDP_GLOO_TOL`); first, whether gloo
    sends CUDA tensors itself (`gloo_p2p_check`)."""
    from dynamicvectorquantization_torch.parallel import dist as pdist
    from dynamicvectorquantization_torch.train.stage2 import Stage2Trainer

    t_phase = time.perf_counter()
    root = os.path.abspath(os.path.join("build", "model_parallel"))
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    batches = [{k: v[i:i + batch] for k, v in streams.items()} for i in (0, batch)]
    streams_file = os.path.join(root, "streams.pt")
    torch.save(batches, streams_file)
    p2p = gloo_p2p_check(root)
    refs = {}
    for dropout, dtype in sorted({c[3:] for c in MP_CASES}):
        model, lr = _p6c18_for_ddp(torch, dev)
        set_dropout(model.transformer, dropout, dropout, dropout)
        one = Stage2Trainer(model, lr, warmup_steps=0, max_steps=10_000, device=dev,
                            compute_dtype=None if dtype == "float32" else dtype)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        secs, logs = [], []
        for b in batches:
            t0 = time.perf_counter()
            logs.append({k: float(v) for k, v in one.train_step(b, eager=True).items()})
            secs.append(time.perf_counter() - t0)
        refs[dropout, dtype] = (logs, {k: v.clone() for k, v in one.masters.items()}, secs, lr,
                                torch.cuda.max_memory_allocated())
        del one, model
        gc.collect()
        torch.cuda.empty_cache()
    runs = {}
    for axis, n, kw, dropout, dtype in MP_CASES:
        out_dir = os.path.join(root, f"{axis}_{dtype}")
        os.makedirs(out_dir)
        init = f"tcp://127.0.0.1:{pdist.free_port()}"
        t0 = time.perf_counter()
        procs, outs, ended = _run_ranks(
            [[MP_RANK, str(r), str(n), init, axis, str(dropout), dtype, streams_file, out_dir]
             for r in range(n)], out_dir, 300)
        require(ended, f"model_parallel {axis} {dtype}: the ranks did not end in 300 s: "
                       f"{[o[-1500:] for o in outs]}")
        codes = [p.returncode for p in procs]
        require(codes == [0] * n, f"model_parallel {axis}: ranks failed {codes} "
                                  f"{[o[-1500:] for o in outs]}")
        got = torch.load(os.path.join(out_dir, "rank0.pt"), weights_only=False)
        ranks = []
        for r in range(n):
            with open(os.path.join(out_dir, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        logs, masters, one_secs, lr, one_peak = refs[dropout, dtype]
        loss_rel = max(abs(a[k] - b[k]) / abs(b[k]) for a, b in zip(got["logs"], logs) for k in b)
        diffs = [(got["masters"][k].to(dev) - v).abs() for k, v in masters.items()]
        n_params = sum(d_.numel() for d_ in diffs)
        res = dict(ranks=n, devices=1, backend="gloo", **{k: v for k, v in kw.items()},
                   dropout=dropout, compute_dtype=dtype, global_batch=batch, steps=len(batches),
                   loss_max_rel_diff=loss_rel,
                   param_max_diff_lr=max(float(d_.max()) for d_ in diffs) / lr,
                   param_mean_diff_lr=sum(float(d_.sum()) for d_ in diffs) / n_params / lr,
                   tol=MP_TOL, logs=got["logs"], one_process_logs=logs,
                   one_process_step_s=one_secs, one_process_peak_bytes=one_peak,
                   ranks_wall_s=time.perf_counter() - t0,
                   step_s={r["rank"]: r["step_s"] for r in ranks},
                   peak_allocated_bytes={r["rank"]: r["peak_allocated_bytes"] for r in ranks},
                   launches_per_step={r["rank"]: r["launches_per_step"] for r in ranks},
                   moved_bytes_per_step={r["rank"]: r["moved_bytes_per_step"] for r in ranks},
                   transport=ranks[0]["transport"],
                   tp_split_leaves=ranks[0]["tp_split_leaves"], launches=got["launches"])
        runs[f"{axis}_{dtype}"] = res
        del diffs, got
        require(loss_rel <= MP_TOL["loss_rel"] and res["param_max_diff_lr"] <= MP_TOL[
            "param_max_lr"] and res["param_mean_diff_lr"] <= MP_TOL["param_mean_lr"],
                f"model_parallel {axis}: differs from one process beyond {MP_TOL}: "
                f"{ {k: v for k, v in res.items() if k != 'launches'} }")
    shutil.rmtree(root, ignore_errors=True)
    line = dict(phase="model_parallel", config=P6C18, gloo_p2p=p2p,
                runs={a: {k: v for k, v in r.items() if k != "launches"} for a, r in runs.items()},
                two_card_run="none: the machine has one card",
                seconds=spread([time.perf_counter() - t_phase]), card=card)
    emit(line)
    return runs


# the fixed-length stage-1 baselines (ROADMAP 11.2, 11.4): the two full-width ymls inside the
# port, and one full-width step for each legacy quantizer as the VQGAN's vqconfig
VQGAN_YML = "dynamicvectorquantization_torch/configs/stage1/vqgan_imagenet_f16_1024.yml"
RQVAE_YML = "dynamicvectorquantization_torch/configs/stage1/rqvae_imagenet_8x8x4.yml"
_VQ = "modules.vector_quantization"
LEGACY_QUANTIZERS = {
    "VectorQuantizer2": (f"{_VQ}.quantize_vqgan.VectorQuantizer2",
                         {"n_e": 1024, "e_dim": 256, "legacy": True, "unknown_index": "random",
                          "sane_index_shape": True}),
    "GumbelQuantize": (f"{_VQ}.quantize_vqgan.GumbelQuantize",
                       {"num_hiddens": 256, "embedding_dim": 256, "n_embed": 1024}),
    "EMAVectorQuantizer": (f"{_VQ}.quantize_vqgan.EMAVectorQuantizer",
                           {"n_embed": 1024, "embedding_dim": 256}),
    "MaskVectorQuantize": (f"{_VQ}.quantize_codebook_mask.MaskVectorQuantize",
                           {"codebook_size": 1024, "codebook_dim": 256, "kmeans_init": True,
                            "orthogonal_reg_weight": 1e-4}),
    "LucidrainsVectorQuantize": (f"{_VQ}.quantize_lucidrains.VectorQuantize",
                                 {"codebook_size": 1024, "dim": 256}),
}
# the StyleGAN discriminators as the VQGAN's disc_config, at their defaults for 256^2
LEGACY_DISCS = {"StyleGAN2Discriminator": ("modules.discriminator.stylegan.Discriminator",
                                           {"image_size": 256}),
                "LucidrainsDiscriminator": ("modules.discriminator.stylegan_lucidrains."
                                            "Discriminator", {})}
LEGACY_SEARCH = ("vq_nearest", "vq_nearest_train")


def _legacy_model(torch, dev, path, overrides=(), vq=None, disc=None):
    """A fixed-length stage-1 model of `path` at full width on `dev`, its
    vqconfig / disc_config replaced where given."""
    from dynamicvectorquantization_torch.config.yaml_config import load_config
    from dynamicvectorquantization_torch.utils.instantiate import instantiate_from_config

    config = load_config([path], list(overrides))["model"]
    params = dict(config["params"])
    if vq is not None:
        params["vqconfig"] = {"target": vq[0], "params": vq[1]}
    if disc is not None:
        loss = params["lossconfig"]
        params["lossconfig"] = {**loss, "params": {**loss["params"], "disc_config": {
            "target": disc[0], "params": disc[1]}}}
    with torch.device(dev):
        model = instantiate_from_config({**config, "params": params})
    # the reference's rule at batch 8, or the yml's fixed rate
    lr = (config["base_learning_rate"] * 8 if "base_learning_rate" in config
          else config["learning_rate"])
    return model, lr


def _legacy_steps(torch, dev, model, lr, x, steps, sample=None):
    """`steps` f32 stage-1 steps of `model` from a seeded init (remat off):
    per step seconds (after a synchronise) and launches; the peak memory."""
    from dynamicvectorquantization_torch.train.stage1 import Stage1Trainer

    trainer = Stage1Trainer(model, lr, warmup_steps=0, max_steps=10_000, device=dev, remat=False)
    trainer.init_state(torch.Generator(device=dev).manual_seed(0),
                       sample_batch=x[:1] if sample is None else sample)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = []
    for _ in range(steps):
        before = read_launches()
        t0 = time.perf_counter()
        logs = trainer.train_step(x)
        torch.cuda.synchronize()
        after = read_launches()
        out.append(dict(s=time.perf_counter() - t0,
                        launches={k: after[k] - before[k] for k in after if after[k] > before[k]},
                        logs={k: float(v) for k, v in logs.items()}))
    require(all(math.isfinite(v) for s in out for v in s["logs"].values()),
            "a legacy stage-1 step logged a value that is not finite")
    return trainer, out, torch.cuda.max_memory_allocated() / 2 ** 30


def legacy_stage1(torch, dev, card):
    """The fixed-length stage-1 baselines (`models/vqgan.py`) at full width,
    f32, batch 8, TF32 off:

      * #1 / #2 at their new shapes against the plain version: #1 at the
        VQGAN's (N 2,048, K 1,024), #2 there and at the RQ-VAE's (N 512,
        K 16,384 = the statistics kernel's `MAX_CODES_WITH_STATS`), D 256
        (`check_vq_nearest` / `check_vq_train`); #4 / #5 at 16^2 x 512 and
        8^2 x 512 and #10 at the VQGAN's four levels and the RQ-VAE's fifth
        are the `kernels` phase's DQ-VAE cases, the same shapes;
      * VQGAN f16-1024 (`vqgan_imagenet_f16_1024.yml`, `disc_start` 0 so
        the discriminator path runs) through `train/cli.py` over 16 + 16 of
        the committed campaign JPEGs: two epochs of two steps, then stopped
        after one and resumed, bit-equal to the uninterrupted run
        (`fit_through_cli`, cuDNN deterministic);
      * in-process on the same yml: three timed steps (launches per step by
        name, peak memory) and one traced (busy / idle); encode -> codes ->
        `get_code_emb_with_depth` -> decode against `forward`'s
        reconstruction;
      * one step for each legacy quantizer as the VQGAN's vqconfig
        (`LEGACY_QUANTIZERS`; VectorQuantizer2 with a remap file), #1 / #2
        launched in each but GumbelQuantize's (no nearest-code search, in JAX
        either: its code is the argmax of its logits);
      * RQ-VAE 8x8x4 x 16,384 (`rqvae_imagenet_8x8x4.yml`): three steps, #2
        launched 8 times a step (4 depths, the autoencoder and the
        discriminator pass);
      * one step for each StyleGAN discriminator at 256^2 as the VQGAN's
        disc_config, at the discriminators' defaults, with its parameter count
        and the step's peak memory.

    Launch counters: zeroed before the command-line runs and after them, read
    after the whole uninterrupted run and at the end; the kernel checks run
    before, outside the counts."""
    import numpy as np

    t_phase = time.perf_counter()
    vq_cases = {f"{c['kernel']}:{c['label']}": c for c in (
        check_vq_nearest(torch, dev, 2048, 1024, "vqgan_n2048_k1024"),
        check_vq_train(torch, dev, 2048, 1024, "vqgan_n2048_k1024"),
        check_vq_train(torch, dev, 512, 16384, "rqvae_n512_k16384"))}
    torch.cuda.empty_cache()
    root = os.path.abspath(os.path.join("build", "legacy_stage1"))
    shutil.rmtree(root, ignore_errors=True)
    # a 16 + 16 file subtree of the committed JPEGs (two train batches an epoch)
    sub = os.path.join(root, "data")
    for split, n in (("train", 16), ("val", 16)):
        classes = sorted(os.listdir(os.path.join(CAMPAIGN_DATA, split)))
        for i in range(n):
            cls = classes[i % len(classes)]
            name = sorted(os.listdir(os.path.join(CAMPAIGN_DATA, split, cls)))[i // len(classes)]
            os.makedirs(os.path.join(sub, split, cls), exist_ok=True)
            os.symlink(os.path.abspath(os.path.join(CAMPAIGN_DATA, split, cls, name)),
                       os.path.join(sub, split, cls, name))
    saved_root = os.environ.get("DQVQ_IMAGENET_ROOT")
    os.environ["DQVQ_IMAGENET_ROOT"] = sub
    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    t0 = time.perf_counter()
    try:
        fitted = fit_through_cli(
            torch, card, "legacy_vqgan_fit", VQGAN_YML,
            ["model.params.lossconfig.params.disc_start=0", "data.params.batch_size=8",
             "data.params.num_workers=2"], 2, lambda t: t.model.state_dict(), "val_rec_loss",
            ("vq_nearest", "strided_conv3x3_down", "strided_conv3x3_down_f32_blocked",
             "fused_attention_forward_wide_f32", "fused_attention_backward_wide_f32"),
            gb_needed=5, grids=4, expect_not_launched=("patch_entropy", "vq_nearest_train"))
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved
        if saved_root is None:
            os.environ.pop("DQVQ_IMAGENET_ROOT")
        else:
            os.environ["DQVQ_IMAGENET_ROOT"] = saved_root
    cli_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    reset_launches()

    # the VQGAN in-process: timed steps, a traced step, codes -> decode
    g = torch.Generator(device=dev).manual_seed(24)
    x = smooth_and_noisy_images(torch, dev, g, b=8)
    model, lr = _legacy_model(torch, dev, VQGAN_YML,
                              ["model.params.lossconfig.params.disc_start=0"])
    trainer, steps, peak = _legacy_steps(torch, dev, model, lr, x, 4)
    traced = profile_device_time(torch, lambda: trainer.train_step(x), groups={
        "attention": "fused_attention", "downsample": "strided_conv", "vq": "vq_nearest"})
    with torch.no_grad():
        dec, _, codes, gate, _ = model(x)
        emb = model.get_code_emb_with_depth(codes)
        rec = model.decode(emb)
        roundtrip_err = float((rec - dec).abs().max())
    vqgan = dict(params=sum(p.numel() for k, p in model.named_parameters()
                            if not k.startswith("loss.")),
                 disc_params=sum(p.numel() for p in model.loss.discriminator.parameters()),
                 codes_shape=list(codes.shape), gate=gate,
                 step_ms=spread([1e3 * s["s"] for s in steps[1:]]), first_step_s=steps[0]["s"],
                 launches_per_step=steps[-1]["launches"], peak_memory_gb=peak,
                 traced_step=traced, roundtrip_max_abs_err=roundtrip_err, roundtrip_tol=1e-4,
                 fine_ratio_of_codes=steps[-1]["logs"].get("train_fine_ratio"),
                 images_per_s=8 / (np.median([s["s"] for s in steps[1:]])))
    require(codes.shape == (8, 16, 16) and roundtrip_err <= 1e-4,
            f"VQGAN: codes -> decode differs from forward by {roundtrip_err}")
    require(all(steps[-1]["launches"].get(k, 0) > 0 for k in (
        "vq_nearest", "strided_conv3x3_down", "fused_attention_forward",
        "fused_attention_backward")), f"VQGAN step launches: {steps[-1]['launches']}")
    del trainer, model, dec, emb, rec
    torch.cuda.empty_cache()

    # one full-width step for each legacy quantizer
    used = os.path.join(root, "used.npy")
    np.save(used, np.sort(np.random.default_rng(24).choice(1024, 768, replace=False)))
    quantizers = {}
    for name, (target, params) in LEGACY_QUANTIZERS.items():
        if name == "VectorQuantizer2":
            params = dict(params, remap=used)
        model, lr = _legacy_model(torch, dev, VQGAN_YML,
                                  ["model.params.lossconfig.params.disc_start=0"],
                                  vq=(target, params))
        trainer, steps, peak = _legacy_steps(torch, dev, model, lr, x, 1, sample=x)
        counts = steps[0]["launches"]
        quantizers[name] = dict(step_s=steps[0]["s"], peak_memory_gb=peak, launches=counts,
                                logs=steps[0]["logs"])
        searched = sum(counts.get(k, 0) for k in LEGACY_SEARCH)
        require(searched > 0 or name == "GumbelQuantize",
                f"{name}: no nearest-code search launched in its step: {counts}")
        del trainer, model
        torch.cuda.empty_cache()

    # RQ-VAE 8x8x4 x 16,384: three steps
    model, lr = _legacy_model(torch, dev, RQVAE_YML)
    trainer, steps, peak = _legacy_steps(torch, dev, model, lr, x, 3)
    rqvae = dict(params=sum(p.numel() for k, p in model.named_parameters()
                            if not k.startswith("loss.")),
                 step_ms=spread([1e3 * s["s"] for s in steps[1:]]), first_step_s=steps[0]["s"],
                 launches_per_step=steps[-1]["launches"], peak_memory_gb=peak, lr=lr,
                 logs=steps[-1]["logs"])
    require(all(s["launches"].get("vq_nearest_train", 0) == 8 for s in steps),
            f"RQ-VAE: #2 launches per step {[s['launches'] for s in steps]}, expected 4 + 4")
    del trainer, model
    torch.cuda.empty_cache()

    # each StyleGAN discriminator as the VQGAN's disc_config, one step at 256^2
    discs = {}
    for name, disc in LEGACY_DISCS.items():
        model, lr = _legacy_model(torch, dev, VQGAN_YML,
                                  ["model.params.lossconfig.params.disc_start=0"], disc=disc)
        trainer, steps, peak = _legacy_steps(torch, dev, model, lr, x, 1)
        d = model.loss.discriminator
        require(type(d).__name__ == name, f"disc_config built {type(d).__name__}")
        discs[name] = dict(params=sum(p.numel() for p in d.parameters()), config=disc[1],
                           step_s=steps[0]["s"], peak_memory_gb=peak,
                           logs=steps[0]["logs"], launches=steps[0]["launches"])
        del trainer, model, d
        torch.cuda.empty_cache()
    launches = read_launches()
    total = {k: v + fitted["launches"].get(k, 0) for k, v in launches.items()}
    shutil.rmtree(root, ignore_errors=True)
    res = dict(phase="legacy_stage1", card=card, dtype="float32", batch=8,
               vqgan_cli=dict(seconds=cli_s, rows=fitted["rows"], val=fitted["val"],
                              resumed_equal=fitted["final_val_whole"] == fitted["final_val_resumed"]
                              and fitted["state_sha256_whole"] == fitted["state_sha256_resumed"],
                              dispatch_s_per_epoch=fitted["dispatch_s_per_epoch"],
                              peak_memory_gb=fitted["peak_memory_gb"],
                              checkpoint_gb=fitted["checkpoint_gb"]),
               vqgan=vqgan, quantizers=quantizers, rqvae=rqvae, stylegan_discs=discs,
               kernel_checks={k: pick_keys(c, "shape", "max_abs_err", "kernel_ms", "plain_ms",
                                           "library_ms", "bound_ms", "bound_by",
                                           "equal_to_fma_kernel", "rescored_rows")
                              for k, c in vq_cases.items()},
               launches={k: v for k, v in total.items() if v},
               seconds=time.perf_counter() - t_phase)
    emit(res)
    return dict(res, launches=total, vq_cases=vq_cases)

# the fixed-length stage-2 baselines (ROADMAP 11.3): taming's class-conditional ImageNet
# transformer at full width over the VQGAN f16-16384, and the RQ-Transformer over the RQ-VAE
CIN_YML = "dynamicvectorquantization_torch/configs/stage2/vqgan_cin_transformer_f16_16384.yml"
# the kernel step against the plain one on the same weights and codes: f32 throughout, the
# attention on 3xTF32 against f32 products (TF32 off), 48 layers
CIN_TOL = {"loss_rel": 1e-5, "grad_rel_l2": 1e-4}


def check_cin_kernels(torch, dev, b=4, t=256, d=1536, n_head=24):
    """#4 / #5 (f32 at hd 64: the 3xTF32 kernels) and #6 / #7 (f32) at the
    cin transformer's shapes, (4, 256, 1536) with 24 heads, causal, against
    their plain versions on N(0, 1) inputs; kernel, plain and library times
    (SDPA; `F.layer_norm`), bounds as the `kernels` phase counts them.
    Tolerances: the `kernels` phase's f32 ones (attention 1e-4, lse 1e-4;
    LayerNorm 1e-5, dgamma / dbeta 2e-3)."""
    import torch.nn.functional as F

    from dynamicvectorquantization_torch.ops.attention import (
        fused_attention_backward, fused_attention_backward_plain, fused_attention_forward,
        fused_attention_forward_plain)
    from dynamicvectorquantization_torch.ops.layernorm import (
        fused_layernorm_plain, layernorm_backward, layernorm_backward_plain, layernorm_forward)

    hd, eps = d // n_head, 1e-5
    scale = hd ** -0.5
    g = torch.Generator(device=dev).manual_seed(25)
    sets = []
    for _ in range(n_sets(8 * b * t * d * 4)):
        q, k, v, dy = (torch.randn((b, t, d), generator=g, device=dev) for _ in range(4))
        y, lse = fused_attention_forward(q, k, v, n_head, scale, True, return_lse=True)
        sets.append((q, k, v, y, lse, dy))
    q, k, v, y, lse, dy = sets[0]
    before = fused_attention_backward.f32_tc_launches
    grads = fused_attention_backward(q, k, v, y, lse, dy, n_head, scale, True)
    require(fused_attention_backward.f32_tc_launches == before + 1,
            "cin attention: the backward did not take the 3xTF32 kernel")
    y_ref, lse_ref = fused_attention_forward_plain(q, k, v, n_head, scale, True, True)
    ref = fused_attention_backward_plain(q, k, v, y_ref, lse_ref, dy, n_head, scale, True)
    torch.cuda.synchronize()
    err_y, ok_y = close(y, y_ref, 1e-4)
    err_lse, ok_lse = close(lse, lse_ref, 1e-4)
    errs, oks = zip(*(close(o, r, 1e-4) for o, r in zip(grads, ref)))
    pairs = t * (t + 1) // 2
    shape = dict(shape=[b, t, d], n_head=n_head, causal=True, dtype="float32",
                 route="f32 tensor cores", path="legacy_stage2")
    fwd = dict(phase="kernels", kernel="fused_attention_forward", **shape, with_lse=True,
               max_abs_err=err_y, lse_err=err_lse, tol="1e-4; lse 1e-4")
    fwd["bound_ms"], fwd["bound_by"], fwd["bound_ms_f32_fma"] = attention_bounds(
        torch, 16 * b * t * d + 4 * b * n_head * t, 4 * b * n_head * pairs * hd,
        torch.float32, True)

    def heads(z):
        return z.view(b, t, n_head, hd).transpose(1, 2)

    time_into(fwd, "kernel", torch, lambda q_, k_, v_, *_: fused_attention_forward(
        q_, k_, v_, n_head, scale, True, return_lse=True), sets)
    time_into(fwd, "plain", torch, lambda q_, k_, v_, *_: fused_attention_forward_plain(
        q_, k_, v_, n_head, scale, True, True), sets, iters=10)
    time_into(fwd, "library", torch, lambda q_, k_, v_, *_: F.scaled_dot_product_attention(
        heads(q_), heads(k_), heads(v_), is_causal=True, scale=scale), sets)
    emit(fwd)
    bwd = dict(phase="kernels", kernel="fused_attention_backward", **shape,
               max_abs_err=max(errs), dq_err=errs[0], dk_err=errs[1], dv_err=errs[2], tol="1e-4")
    bwd["bound_ms"], bwd["bound_by"], bwd["bound_ms_f32_fma"] = attention_bounds(
        torch, 32 * b * t * d + 4 * b * n_head * t, 10 * b * n_head * pairs * hd,
        torch.float32, True)
    time_into(bwd, "kernel", torch,
              lambda *a: fused_attention_backward(*a, n_head, scale, True), sets, iters=10)
    time_into(bwd, "plain", torch,
              lambda *a: fused_attention_backward_plain(*a, n_head, scale, True), sets, iters=10)
    lib_sets = []
    for q_, k_, v_, _, _, dy_ in sets:
        leaves = tuple(heads(z).detach().requires_grad_() for z in (q_, k_, v_))
        lib_sets.append((F.scaled_dot_product_attention(*leaves, is_causal=True, scale=scale),
                         leaves, heads(dy_)))
    time_into(bwd, "library", torch,
              lambda y_, leaves, dy_: torch.autograd.grad(y_, leaves, dy_, retain_graph=True),
              lib_sets, iters=10)
    del lib_sets, sets
    emit(bwd)
    require(ok_y and ok_lse and all(oks),
            f"cin attention disagrees with its plain version: {err_y} {err_lse} {errs}")

    rows = b * t
    gamma = 1 + 0.1 * torch.randn(d, generator=g, device=dev)
    beta = 0.1 * torch.randn(d, generator=g, device=dev)
    ln_sets = [(torch.randn((b, t, d), generator=g, device=dev) * 1.5 + 0.3,
                torch.randn((b, t, d), generator=g, device=dev))
               for _ in range(n_sets(8 * rows * d))]
    x, dy = ln_sets[0]
    err_ln, ok_ln = close(layernorm_forward(x, gamma, beta, eps),
                          fused_layernorm_plain(x, gamma, beta, eps), 1e-5)
    ln_errs, ln_oks = zip(*(close(o, r, tol) for o, r, tol in zip(
        layernorm_backward(x, gamma, dy, eps), layernorm_backward_plain(x, gamma, dy, eps),
        (1e-5, 2e-3, 2e-3))))
    shape = dict(shape=[b, t, d], dtype="float32", path="legacy_stage2")
    lf = dict(phase="kernels", kernel="layernorm_forward", **shape, max_abs_err=err_ln,
              tol="1e-5")
    lf["bound_ms"], lf["bound_by"] = bound(8 * rows * d + 8 * d, 8 * rows * d, "float32")
    time_into(lf, "kernel", torch, lambda x_, dy_: layernorm_forward(x_, gamma, beta, eps),
              ln_sets)
    time_into(lf, "plain", torch, lambda x_, dy_: fused_layernorm_plain(x_, gamma, beta, eps),
              ln_sets)
    time_into(lf, "library", torch, lambda x_, dy_: F.layer_norm(x_, (d,), gamma, beta, eps),
              ln_sets)
    emit(lf)
    lb = dict(phase="kernels", kernel="layernorm_backward", **shape, max_abs_err=max(ln_errs),
              dx_err=ln_errs[0], dgamma_err=ln_errs[1], dbeta_err=ln_errs[2],
              tol="dx 1e-5; dgamma, dbeta 2e-3")
    lb["bound_ms"], lb["bound_by"] = bound(12 * rows * d + 12 * d, 16 * rows * d, "float32")
    time_into(lb, "kernel", torch, lambda x_, dy_: layernorm_backward(x_, gamma, dy_, eps),
              ln_sets)
    time_into(lb, "plain", torch, lambda x_, dy_: layernorm_backward_plain(x_, gamma, dy_, eps),
              ln_sets)
    gl, bl = gamma.clone().requires_grad_(), beta.clone().requires_grad_()
    lib_sets = []
    for x_, dy_ in ln_sets:
        xl = x_.clone().requires_grad_()
        lib_sets.append((F.layer_norm(xl, (d,), gl, bl, eps), xl, dy_))
    time_into(lb, "library", torch,
              lambda y_, xl, dy_: torch.autograd.grad(y_, (xl, gl, bl), dy_, retain_graph=True),
              lib_sets)
    del lib_sets, ln_sets
    emit(lb)
    require(ok_ln and all(ln_oks), f"cin LayerNorm disagrees: {err_ln} {ln_errs}")
    return {"fused_attention_forward_f32_tc": fwd, "fused_attention_backward_f32_tc": bwd,
            "layernorm_forward": lf, "layernorm_backward": lb}


def _campaign_images(torch, dev, n):
    """`n` committed campaign validation JPEGs (one a class) at 256^2, NHWC in
    [-1, 1], and their class indices."""
    import numpy as np

    from dynamicvectorquantization_torch.data.image_io import read_image
    from dynamicvectorquantization_torch.data.transforms import imagenet_val_transform

    root = os.path.join(CAMPAIGN_DATA, "val")
    classes = sorted(os.listdir(root))[:n]
    arrays = []
    for cls in classes:
        name = sorted(os.listdir(os.path.join(root, cls)))[0]
        img = read_image(os.path.join(root, cls, name))
        arrays.append(imagenet_val_transform(img, 256))  # NHWC f32 in [-1, 1]
    x = torch.from_numpy(np.stack(arrays)).to(dev)
    return x, torch.tensor([int(c.split("_")[-1]) for c in classes], device=dev)


def _grad_rel_l2(grads, ref):
    num = sum(float(((grads[k] - ref[k]).double() ** 2).sum()) for k in ref)
    den = sum(float((ref[k].double() ** 2).sum()) for k in ref)
    return (num / den) ** 0.5


def legacy_stage2(torch, dev, card, batch=4, timed=3):
    """The fixed-length stage-2 baselines on the card, f32, TF32 off:

      * #4 / #5 and #6 / #7 at the cin transformer's shapes (`check_cin_kernels`)
        and #1 at its first stage's encode, N 1,024 (4 x 16^2), K 16,384, D 256
        (`check_vq_nearest`), against the plain versions, outside the counts;
      * taming's class-conditional ImageNet transformer (`CIN_YML`: 48 layers x
        1,536, 24 heads, 16,384 codes, ~1.41 G parameters) from its yml with
        seeded weights; 4 committed campaign JPEGs at 256^2 and their class
        indices as labels; one forward + loss + backward through the plain
        versions (`plain_train_path`), before the counts;
      * the main path, counted: encode (#1, the VQGAN encoder's AttnBlock #4
        and Downsamples #10), then forward + loss + backward through the
        kernels 1 + `timed` times (loss and gradients held to the plain
        step's, `CIN_TOL`), greedy sampling of 256 codes, each step a CUDA
        graph replay (the tokens equal the argmax of a teacher-forced forward
        over the sampled sequence, the JAX package's own check, and the eager
        control's over 16 tokens), then `timed` greedy calls of 64 tokens
        (ms an AR step; the eager control's beside it), one top-k draw of
        256 codes (images/s) and `decode_to_img`;
      * the RQ-Transformer trainer (the JAX class's defaults, 16,384 codes)
        over the RQ-VAE yml's first stage (its GAN loss replaced by
        `DummyLoss`): forward + loss + backward at batch 4, `sample_rq` of one
        image (top-k 300, top-p 0.95), decode."""
    from dynamicvectorquantization_torch.config.yaml_config import load_config
    from dynamicvectorquantization_torch.nn.mingpt import sample_with_past
    from dynamicvectorquantization_torch.utils.instantiate import instantiate_from_config

    t_phase = time.perf_counter()
    checks = check_cin_kernels(torch, dev)
    vq_case = check_vq_nearest(torch, dev, batch * 256, 16384, "cin_n1024_k16384",
                               path="legacy_stage2")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    config = load_config([CIN_YML])["model"]
    with torch.device(dev):
        model = instantiate_from_config(config)
    model.init_weights(torch.Generator(device=dev).manual_seed(25))
    gpt = model.transformer
    build_s = time.perf_counter() - t0
    x, labels = _campaign_images(torch, dev, batch)
    params = list(gpt.parameters())

    def step():
        for p in params:
            p.grad = None
        logits, loss = model(x, labels)
        loss.backward()
        return logits, loss

    with plain_train_path():
        _, plain_loss = step()
    plain_loss = float(plain_loss)
    plain_grads = {k: p.grad for k, p in gpt.named_parameters()}
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    reset_launches()  # the main path from here
    t0 = time.perf_counter()
    _, codes = model.encode_to_z(x)
    torch.cuda.synchronize()
    encode_s = time.perf_counter() - t0
    encode_launches = {k: v for k, v in read_launches().items() if v}
    step_s, step_launches = [], None
    for i in range(1 + timed):
        before = read_launches()
        t0 = time.perf_counter()
        logits, loss = step()
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        after = read_launches()
        step_launches = {k: after[k] - before[k] for k in after if after[k] > before[k]}
    step_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    loss_rel = abs(float(loss) - plain_loss) / abs(plain_loss)
    grad_rel_l2 = _grad_rel_l2({k: p.grad for k, p in gpt.named_parameters()}, plain_grads)
    del plain_grads, logits
    for p in params:
        p.grad = None
    torch.cuda.empty_cache()

    c = model.encode_to_c(labels)
    sample_s = []
    with torch.no_grad():
        t0 = time.perf_counter()  # the first call captures the step's graph
        tokens = sample_with_past(gpt, c, 256, sample_logits=False)
        torch.cuda.synchronize()
        first_sample_s = time.perf_counter() - t0
        for i in range(timed):  # AR steps timed over the first 64 tokens
            t0 = time.perf_counter()
            got = sample_with_past(gpt, c, 64, sample_logits=False)
            torch.cuda.synchronize()
            sample_s.append(time.perf_counter() - t0)
            require(torch.equal(got, tokens[:, :64]),
                    "cin greedy sampling differs between two calls")
        forced, _ = gpt(torch.cat([c, tokens], dim=1)[:, :-1])
        argmax = forced.argmax(-1)
        mismatched = int((argmax != tokens).sum())
        # the eager control over the first 16 tokens: its ms an AR step, and the same tokens
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eager = sample_with_past(gpt, c, 16, sample_logits=False, eager=True)
        torch.cuda.synchronize()
        eager_ms = 1e3 * (time.perf_counter() - t0) / 16
        t0 = time.perf_counter()
        drawn = sample_with_past(gpt, c, 256, torch.Generator(device=dev).manual_seed(5),
                                 top_k=100)
        torch.cuda.synchronize()
        draw_s = time.perf_counter() - t0
        images = model.decode_to_img(drawn, (batch, 16, 16))
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0 - draw_s
    require(torch.equal(eager, tokens[:, :16]),
            "cin greedy tokens: the graph replays differ from the eager control")
    require(mismatched == 0, f"cin greedy tokens differ from the teacher-forced argmax at "
                             f"{mismatched} of {tokens.numel()} positions")
    require(images.shape == (batch, 256, 256, 3) and bool(torch.isfinite(images).all()),
            f"cin decode_to_img: {tuple(images.shape)}, finite {bool(torch.isfinite(images).all())}")
    sample_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    cin = dict(params=sum(p.numel() for p in params), build_s=build_s, batch=batch,
               codes_shape=list(codes.shape), labels=labels.tolist(), encode_s=encode_s,
               encode_launches=encode_launches, loss=float(loss), plain_loss=plain_loss,
               loss_rel=loss_rel, grad_rel_l2=grad_rel_l2, tol=CIN_TOL,
               forward_backward_ms=spread([1e3 * s for s in step_s[1:]]),
               first_forward_backward_s=step_s[0], launches_per_step=step_launches,
               peak_memory_gb=step_peak,
               greedy_ms_per_ar_step=spread([1e3 * s / 64 for s in sample_s]),
               first_sample_s=first_sample_s, eager_ms_per_ar_step=eager_ms,
               topk_draw_s=draw_s, images_per_s=batch / draw_s, decode_s=decode_s,
               teacher_forced_mismatches=mismatched,
               sample_peak_memory_gb=sample_peak)
    require(loss_rel <= CIN_TOL["loss_rel"] and grad_rel_l2 <= CIN_TOL["grad_rel_l2"],
            f"cin kernel step differs from the plain step: loss {loss_rel}, grads {grad_rel_l2}")
    require(step_launches.get("fused_attention_forward_f32_tc") == 48
            and step_launches.get("fused_attention_backward_f32_tc") == 48
            and step_launches.get("layernorm_forward") == 97
            and step_launches.get("layernorm_backward") == 97
            and step_launches.get("vq_nearest") == 1,
            f"cin step launches: {step_launches}")
    del model, gpt, params, images, forced
    torch.cuda.empty_cache()

    # the RQ-Transformer over the RQ-VAE's codes
    t0 = time.perf_counter()
    first = load_config([RQVAE_YML])["model"]
    first = {**first, "params": {**first["params"], "lossconfig": {
        "target": "modules.losses.vqperceptual.DummyLoss"}}}
    with torch.device(dev):
        rq = instantiate_from_config({
            "target": "models.stage2.uncond_rqtransformer.RQTransformerTrainer",
            "params": {"transformer_config": {
                "target": "dynamicvectorquantization_torch.nn.rq_transformer.RQTransformer",
                "params": {"vocab_size": 16384}}, "first_stage_config": first}})
    rq.init_weights(torch.Generator(device=dev).manual_seed(26))
    torch.cuda.reset_peak_memory_stats()
    rq_s = []
    for i in range(1 + timed):
        before = read_launches()
        t1 = time.perf_counter()
        for p in rq.transformer.parameters():
            p.grad = None
        rq_loss = rq(x, x)
        rq_loss.backward()
        torch.cuda.synchronize()
        rq_s.append(time.perf_counter() - t1)
        after = read_launches()
        rq_launches = {k: after[k] - before[k] for k in after if after[k] > before[k]}
    t1 = time.perf_counter()
    with torch.no_grad():
        rq_codes = rq.sample((1, 8, 8, 4), x[:1], torch.Generator(device=dev).manual_seed(6))
        rq_images = rq.decode_to_img(rq_codes)
    torch.cuda.synchronize()
    rq_line = dict(params=sum(p.numel() for p in rq.transformer.parameters()),
                   loss=float(rq_loss), forward_backward_ms=spread([1e3 * s for s in rq_s[1:]]),
                   first_forward_backward_s=rq_s[0], launches_per_step=rq_launches,
                   sample_and_decode_s=time.perf_counter() - t1, sampled_shape=list(rq_codes.shape),
                   peak_memory_gb=torch.cuda.max_memory_allocated() / 2 ** 30,
                   seconds=time.perf_counter() - t0)
    require(math.isfinite(float(rq_loss)) and bool(torch.isfinite(rq_images).all())
            and rq_images.shape == (1, 256, 256, 3) and int(rq_codes.max()) < 16384,
            f"RQ-Transformer: loss {float(rq_loss)}, images {tuple(rq_images.shape)}")
    require(rq_launches.get("vq_nearest", 0) == 4 and rq_launches.get("layernorm_forward", 0) > 0,
            f"RQ-Transformer step launches: {rq_launches}")
    del rq, rq_images
    torch.cuda.empty_cache()
    launches = read_launches()
    res = dict(phase="legacy_stage2", card=card, dtype="float32", config=CIN_YML, cin=cin,
               rq_transformer=rq_line, launches={k: v for k, v in launches.items() if v},
               kernel_checks={k: pick_keys(c_, "shape", "max_abs_err", "tol", "kernel_ms",
                                           "plain_ms", "library_ms", "bound_ms", "bound_by")
                              for k, c_ in {**checks, "vq_nearest": vq_case}.items()},
               seconds=time.perf_counter() - t_phase)
    emit(res)
    require(all(launches.get(k, 0) > 0 for k in (
        "vq_nearest", "fused_attention_forward_f32_tc", "fused_attention_backward_f32_tc",
        "layernorm_forward", "layernorm_backward", "strided_conv3x3_down")),
        f"legacy_stage2: a kernel of the path was not launched: {launches}")
    return dict(res, launches=launches, checks={**checks, "vq_nearest": vq_case})


def main():
    if sys.argv[1:2] == ["--launches-of"]:
        return run_counting(sys.argv[2:])
    if sys.argv[1:2] == [DDP_RANK]:
        return ddp_rank(sys.argv[2:])
    if sys.argv[1:2] == [MP_RANK]:
        return mp_rank(sys.argv[2:])
    if sys.argv[1:2] == [P2P_RANK]:
        return p2p_rank(sys.argv[2:])
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    t_script = time.perf_counter()
    os.chdir(os.path.dirname(os.path.abspath(__file__)))
    from dynamicvectorquantization_torch.ops import cuda_lib
    from dynamicvectorquantization_torch.utils.model_loading import load_model_and_variables

    card = card_line()
    print(card, flush=True)
    # PyTorch's own defaults, which the entry points keep (the campaign's training legs)
    tf32_defaults = dict(matmul=torch.backends.cuda.matmul.allow_tf32,
                         cudnn=torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    emit(dict(phase="card", nvidia_smi=card, device=torch.cuda.get_device_name(0),
              count=torch.cuda.device_count(), torch=torch.__version__,
              cuda=torch.version.cuda, tf32_matmul=False, tf32_cudnn=False,
              tf32_defaults=tf32_defaults))

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

    decode_cases, decode_sweep, decode_f32_cases = check_decode_attention(torch, dev)
    attn_cases, attn_drop_cases = check_fused_attention(torch, dev)
    check_attention_dropout(torch, dev)
    vq_case = check_vq_nearest(torch, dev)
    vq_train_case = check_vq_train(torch, dev)
    entropy_case, entropy16_case, entropy32_case = check_patch_entropy(torch, dev)
    conv_cases, conv16_cases, conv_triple = check_strided_conv(torch, dev)
    ln_fwd_cases, ln_bwd_cases = check_layernorm(torch, dev)
    attn_train_cases, attn_bwd_cases, attn_train_drop_cases, attn_bwd_drop_cases = \
        check_attention_backward(torch, dev)
    adamw_case = check_fused_adamw(torch, dev)
    device_seeds = check_device_seeds(torch, dev)
    head_offset = check_head_offset(torch, dev)
    ring_fwd, ring_bwd = check_ring_ticks(torch, dev)
    t2i_checks = check_t2i_kernels(torch, dev)

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
    http_res = http(torch, model, card)
    # the sampler's graphs against its eager loop: the served bf16 model with its int8
    # caches, then with float (bf16) caches
    c4 = model.encode_to_c(4, dev)
    graph_vs_eager(torch, model, c4, "p6c18, bf16, int8 caches")
    model.transformer.kv_cache_dtype = None
    graph_vs_eager(torch, model, c4, "p6c18, bf16, float caches", modes=("greedy",))
    model.transformer.kv_cache_dtype = "int8"
    del model, c4
    torch.cuda.empty_cache()
    trained, streams = train(torch, dev, card)[:2]
    per_step = trained["launches_per_step"]
    torch.cuda.empty_cache()
    ddp_line = ddp(torch, dev, card, streams)
    torch.cuda.empty_cache()
    mp_runs = model_parallel(torch, dev, card, streams)
    torch.cuda.empty_cache()
    # the JAX trainer's default compute dtype: f32 throughout, on the same cached codes
    per_step_f32 = train(torch, dev, card, compute_dtype=None,
                         streams=streams)[0]["launches_per_step"]
    torch.cuda.empty_cache()
    # the class-conditional model on the same cached codes, with seeded labels beside them
    labels = torch.randint(0, 1000, (len(streams["coarse_content"]),),
                           generator=torch.Generator().manual_seed(15), dtype=torch.int32)
    class_trained, _, class_trainer = train(torch, dev, card, streams=streams,
                                            config_path=CLASS_P6C18, labels=labels,
                                            kv_cache_dtype="int8")
    del _
    per_step_class = class_trained["launches_per_step"]
    sampled = class_sample(torch, class_trainer, card, labels[:4])[0]
    del streams, class_trainer
    torch.cuda.empty_cache()
    # the shipped ymls' batch 30: bf16 on 30 images of its own, then f32 on their codes; no
    # plain-path comparison, no attn_pdrop 0 timing
    b30 = dict(batch=30, n_images=30, compare=False, rate0=False, timed_steps=2)
    trained_b30, streams30 = train(torch, dev, card, phase="train_b30", **b30)[:2]
    per_step_b30 = trained_b30["launches_per_step"]
    torch.cuda.empty_cache()
    per_step_f32_b30 = train(torch, dev, card, compute_dtype=None, streams=streams30,
                             phase="train_f32_b30", **b30)[0]["launches_per_step"]
    del streams30
    torch.cuda.empty_cache()
    per_step1 = train1(torch, dev, card)["launches_per_step"]
    torch.cuda.empty_cache()
    per_step1_bf16 = train1(torch, dev, card, compute_dtype="bfloat16")["launches_per_step"]
    torch.cuda.empty_cache()
    remat8 = train1_remat(torch, dev, card)
    per_step1_remat = remat8["pairs"]["0.0"]["launches_remat_step"]
    torch.cuda.empty_cache()
    # the shipped ymls' own batch 30, remat at its default (on for the card)
    per_step1_b30 = train1(torch, dev, card, batch=30, phase="train1_b30", compare=False,
                           remat=None)["launches_per_step"]
    torch.cuda.empty_cache()
    per_step1_b30_bf16 = train1(torch, dev, card, batch=30, phase="train1_b30",
                                compute_dtype="bfloat16", compare=False,
                                remat=None)["launches_per_step"]
    torch.cuda.empty_cache()
    # the two other shipped stage-1 ymls: the Gumbel-gated feature router, triple grain
    per_step1_dual_feat = train1(torch, dev, card, config_path=DUAL_FEAT,
                                 phase="train1_dual_feat", compare=False,
                                 resume=True)["launches_per_step"]
    torch.cuda.empty_cache()
    per_step1_triple = train1(torch, dev, card, config_path=TRIPLE, phase="train1_triple",
                              compare=False, resume=True)["launches_per_step"]
    torch.cuda.empty_cache()
    encoded_triple = encode_triple(torch, dev, card)["launches"]
    torch.cuda.empty_cache()
    sampled_cli = sample_cli(torch, card)
    torch.cuda.empty_cache()
    evaluated = evaluate(torch, dev, card)
    shutil.rmtree(EVAL_DUMP, ignore_errors=True)
    torch.cuda.empty_cache()
    fitted = fit(torch, card)["launches"]
    torch.cuda.empty_cache()
    fitted1 = fit1(torch, card)["launches"]
    torch.cuda.empty_cache()
    legacy = legacy_stage1(torch, dev, card)
    torch.cuda.empty_cache()
    legacy2 = legacy_stage2(torch, dev, card)
    torch.cuda.empty_cache()
    t2i_res = t2i(torch, dev, card, t2i_checks)
    torch.cuda.empty_cache()
    real = data_real(torch, dev, card)
    torch.cuda.empty_cache()
    campaigned = campaign(torch, card)["launches"]

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
    require(all(c["kernel_ms"] is not None
                for c in decode_cases + decode_sweep + decode_f32_cases),
            "decode_attention_int8: a timed index has no trace")
    points = {c["cache_index"]: c["kernel_ms"] for c in decode_cases + decode_sweep}
    visited = range(served["batch_stats"][0]["ar_steps"])
    emit(dict(phase="serve_decode_estimate",
              served_batch_est_ms=served["layers"] * interpolated_sum(points, visited),
              served_batch_ar_steps=len(visited), layers=served["layers"]))
    paths = {"serve": served["launches"], "encode": encoded["launches"],
             "encode_bf16": encoded16["launches"], "train_step": per_step,
             "train_step_f32": per_step_f32, "class_train_step": per_step_class,
             "train_step_b30": per_step_b30, "train_step_f32_b30": per_step_f32_b30,
             "class_sample": sampled["launches"], "http": http_res["launches"],
             "sample_cli": {name: sum(run["launches"][name]
                                      for run in sampled_cli["runs"].values())
                            for name in per_step},
             "train1_step": per_step1,
             "train1_step_bf16": per_step1_bf16, "train1_dual_feat_step": per_step1_dual_feat,
             "train1_triple_step": per_step1_triple, "encode_triple": encoded_triple,
             "train1_remat_step": per_step1_remat,
             "train1_b30_step": per_step1_b30, "train1_b30_bf16_step": per_step1_b30_bf16,
             "eval": {name: sum(run["launches"].get(name, 0)
                                for run in evaluated["runs"].values()) for name in per_step},
             "fit": fitted, "fit1": fitted1,
             # the fixed-length baselines: the VQGAN's command-line run, its steps, each
             # legacy quantizer's step, the RQ-VAE's, the StyleGAN discriminators'
             "legacy_stage1": legacy["launches"],
             # the cin transformer's encode, steps, sampling and decode; the RQ-Transformer's
             "legacy_stage2": legacy2["launches"],
             # text-to-image, a step of each variant (inline encode, the text tower), and
             # StackGPT's mask_pad_attention over three steps (its masked route: no #4 / #5)
             **{f"t2i_{name}_step": counts for name, counts in t2i_res["launches"].items()
                if name != "mask_pad_attention"},
             "mask_pad_attention_steps": t2i_res["launches"]["mask_pad_attention"],
             # the distributed path at world size 1: the p6c18 bf16 step (DDP), stage 1 (DDP)
             "ddp_train_step": ddp_line["stage2_bf16_batch8"]["ddp"]["launches_per_step"],
             "ddp_train1_step": ddp_line["stage1_f32_batch8"]["ddp"]["launches_per_step"],
             # the model axes' two steps on rank 0 (gloo ranks sharing the card)
             **{f"model_parallel_{name}": run["launches"] for name, run in mp_runs.items()},
             # the stage-1 command line from JPEG files (4 steps, validation), then the tools
             "data_real": {name: real["stage1_files"]["launches"][name]
                           + (real["tools"]["entropy_thresholds"]["patch_entropy_launches"]
                              if name == "patch_entropy" else 0)
                           + real["tools"]["visualize_dual_grain"]["launches"].get(name, 0)
                           for name in per_step},
             # the two campaign tools' legs: thresholds, both stages, sampling, convergence
             "campaign": {name: campaigned.get(name, 0) for name in per_step}}

    def launched(name):
        """Launches of a row on each driven path (for the attention rows: of
        that kernel family, every rate)."""
        return {path: counts[name] for path, counts in paths.items() if counts[name]}


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
     fwd_512b, fwd_t8) = attn_train_cases
    (dfwd_c, dfwd_c32, dfwd_c32b8, dfwd_64, dfwd_32, _, dfwd_512, _, _,
     dfwd_t8) = attn_train_drop_cases
    (bwd_c, bwd_c32, bwd_c32b8, bwd_64, bwd_32, bwd_256, bwd_512, bwd_256b,
     bwd_512b, bwd_t8) = attn_bwd_cases
    (dbwd_c, dbwd_c32, dbwd_c32b8, dbwd_64, dbwd_32, dbwd_256, dbwd_512, dbwd_256b,
     dbwd_512b, dbwd_t8) = attn_bwd_drop_cases
    # each row's device-seed entries against its by-value entries (`check_device_seeds`)
    seeds_equal = {row: all(device_seeds[f]["device_seed_equal"] for f in families)
                   for row, families in (
                       ("fused_attention_forward", ("wide f32", "square tiles",
                                                    "square tiles bf16")),
                       ("fused_attention_forward_f32_tc", ("f32 tensor cores",)),
                       ("fused_attention_forward_tc", ("tensor cores", "tensor cores wide")))}
    for row in list(seeds_equal):
        seeds_equal[row.replace("forward", "backward")] = seeds_equal[row]
    # each row's entries with a head offset against the slice of the full call
    offset_equal = {row: all(head_offset[f]["by_value"] and head_offset[f]["device_seed"]
                             for f in families)
                    for row, families in (
                        ("fused_attention_forward", ("wide f32", "square tiles",
                                                     "square tiles bf16")),
                        ("fused_attention_forward_f32_tc", ("f32 tensor cores",)),
                        ("fused_attention_forward_tc", ("tensor cores", "tensor cores wide")))}
    for row in list(offset_equal):
        offset_equal[row.replace("forward", "backward")] = offset_equal[row]
    ring_ticks = {"fused_attention_forward_f32_tc": ring_fwd,
                  "fused_attention_backward_f32_tc": ring_bwd}
    kernels = []
    for name, src, replaces, main, extra in (
            # main: cache_index 1283; the other checked indices and the sweep (every 128
            # positions) beside it
            ("decode_attention_int8", "decode_attention_int8.cu",
             "dynamicvectorquantization_tpu/ops/kv_int8.py:92", decode_cases[-1],
             {"cache_index": decode_cases[-1]["cache_index"],
              "bit_reproducible": all(c["bit_reproducible"]
                                      for c in decode_cases + decode_sweep + decode_f32_cases),
              "device_index_equal": all(c["device_index_equal"]
                                        for c in decode_cases + decode_sweep + decode_f32_cases),
              "bound_share": decode_cases[-1]["bound_share"],
              "by_index": {str(c["cache_index"]): pick_keys(c, "kernel_ms", "plain_ms", "bound_ms",
                                                       "max_abs_err")
                           for c in decode_cases},
              "sweep_ms": {str(c["cache_index"]): c["kernel_ms"] for c in decode_sweep},
              # f32 queries (the f32 parameters of the sampling entry points and of the
              # loop's image grids); main: cache_index 1283
              "f32": pick_keys(decode_f32_cases[-1], "kernel_ms", "kernel_ms_spread", "plain_ms",
                          "bound_ms", "bound_by", "bound_share", "max_abs_err", "tol")
              | {"by_index": {str(c["cache_index"]): pick_keys(c, "kernel_ms", "plain_ms",
                                                          "bound_ms", "max_abs_err")
                              for c in decode_f32_cases}},
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
              "extra": {n_: pick_keys(c, *timed_keys) for n_, c in (
                 ("a_rate0.1", dfwd_a), ("b_hd512_f32", fwd_b), ("b_hd512_f32_rate0.1", dfwd_b),
                 ("a_hd256_with_lse", fwd_256), ("b_hd512_with_lse", fwd_512),
                 ("b_hd512_with_lse_rate0.1", dfwd_512), ("hd32_t300_with_lse", fwd_32),
                 ("hd32_t300_with_lse_rate0.1", dfwd_32),
                 # the triple-grain coarse head's AttnBlock: (8, 64, 512), T below a row tile
                 ("triple_coarse_t64_hd512_with_lse", fwd_t8),
                 ("triple_coarse_t64_hd512_with_lse_rate0.1", dfwd_t8))}}),
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
              "extra": {n_: pick_keys(c, *timed_keys) for n_, c in (
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
              "extra": {n_: pick_keys(c, *timed_keys) for n_, c in (
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
              "extra": {n_: pick_keys(c, *timed_keys) for n_, c in (
                  ("a_hd256_rate0.1", dbwd_256), ("b_hd512", bwd_512),
                  ("b_hd512_rate0.1", dbwd_512), ("hd32_t300", bwd_32),
                  ("hd32_t300_rate0.1", dbwd_32), ("triple_coarse_t64_hd512", bwd_t8),
                  ("triple_coarse_t64_hd512_rate0.1", dbwd_t8))}}),
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
              "extra": {n_: pick_keys(c, *timed_keys) for n_, c in (
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
              "extra": {n_: pick_keys(c, *timed_keys) for n_, c in (
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
             | {"f32": pick_keys(ln_bwd_cases[1], "kernel_ms", "kernel_ms_spread", "plain_ms",
                            "library_ms", "bound_ms", "bound_share", "max_abs_err",
                            "bit_reproducible")}),
            # lr, c1, c2 by value, or read from a device triple (a captured step's)
            ("fused_adamw", "fused_adamw.cu",
             "dynamicvectorquantization_tpu/ops/fused_adamw.py:39", adamw_case,
             pick_keys(adamw_case, "device_scalars_equal", "device_scalars_ms",
                  "device_scalars_ms_spread")
             | {"device_scalar_launches": launched("fused_adamw_device_scalars")}),
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
             pick_keys(entropy_case, *entropy_keys)
             # 32^2 patches (TripleGrainFixedEntropyRouter on a 256^2 triple-grain model)
             | {"patch32": pick_keys(entropy32_case, "shape", "patch", "kernel_ms",
                                "kernel_ms_spread", "plain_ms", "bound_ms", "bound_by",
                                "bound_share", "max_abs_err", "tol", *entropy_keys)}),
            # bf16 images: the gray image rounded as the JAX package rounds it
            ("patch_entropy_bf16", "patch_entropy.cu",
             "dynamicvectorquantization_tpu/ops/entropy.py:118", entropy16_case,
             pick_keys(entropy16_case, *entropy_keys) | {"dtype": "bfloat16"}),
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
              # by the tiling the kernel reported it launched
              "f32_tiling_launches": {t: launched(f"strided_conv3x3_down_f32_{t}")
                                      for t in ("large", "mid", "small")},
              "per_level": conv["per_level"],
              # the triple-grain encoder's fifth level, 16^2 x 512 -> 8^2, and the tiling
              # the kernel reported (tile: output rows x columns x channels)
              "triple_level": pick_keys(conv_triple, "shape", "route", "tiling", "tile", "blocks",
                                   "max_abs_err", "tol",
                                   "equal_to_fma_kernel", "bit_reproducible", "kernel_ms",
                                   "kernel_ms_spread", "plain_ms", "library_ms", "fma_kernel_ms",
                                   "bound_ms", "bound_by")}),
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
        if name in seeds_equal:  # the attention rows: the device-seed entries, rate 0.1
            wrapper = name.split("_tc")[0].split("_f32")[0]  # every family of the wrapper
            extra = dict(extra, device_seed_equal=seeds_equal[name],
                         wrapper_device_seed_launches=launched(f"{wrapper}_device_seed"),
                         head_offset_equal=offset_equal[name])
        if name in ring_ticks:  # sp's ring tick: non-causal at hd 128 with lse
            extra = dict(extra, sp_ring_tick_noncausal=pick_keys(ring_ticks[name], *timed_keys))
        kernels.append(dict(
            name=name, route="cuda", source=f"{src_dir}/{src}",
            replaces=replaces, launches=sum(launches.values()), launches_by_path=launches,
            max_abs_err=main["max_abs_err"], tol=main["tol"], ms=main["kernel_ms"],
            ms_spread=main["kernel_ms_spread"], plain_ms=main["plain_ms"],
            bound_ms=main["bound_ms"], bound_by=main["bound_by"],
            library_ms=main.get("library_ms"), shape=main["shape"], card=card, **extra))
        if name in ("vq_nearest", "vq_nearest_train"):  # the fixed-length baselines' shapes
            kernels[-1]["legacy_stage1_shapes"] = {
                label: pick_keys(c, "shape", "max_abs_err", "tol", "kernel_ms",
                                 "kernel_ms_spread", "plain_ms", "library_ms", "bound_ms",
                                 "bound_by", "equal_to_fma_kernel", "rescored_rows",
                                 "fma_kernel_ms", "empty_clusters", "bit_reproducible")
                for label, c in legacy["vq_cases"].items() if label.startswith(name + ":")}
        if name in legacy2["checks"]:  # the fixed-length stage-2 baselines' shapes
            kernels[-1]["legacy_stage2_shape"] = pick_keys(
                legacy2["checks"][name], "shape", "n_head", "route", "max_abs_err", "tol",
                "kernel_ms", "kernel_ms_spread", "plain_ms", "library_ms", "bound_ms",
                "bound_by", "bound_ms_f32_fma", "equal_to_fma_kernel", "rescored_rows",
                "fma_kernel_ms")
        for key, case in t2i_res["checks"].items():  # hd 104 padded; the CLIP text tower
            row, label = key.split(":")
            if row == name:
                kernels[-1].setdefault("t2i_slice_shapes", {})[label] = pick_keys(
                    case, "shape", "n_head", "head_dim", "padded_to", "padded_launches",
                    "route", "max_abs_err", "tol", "kernel_ms", "kernel_ms_spread", "plain_ms",
                    "library_ms", "bound_ms", "bound_by", "bound_ms_f32_fma")
        require(kernels[-1]["launches"] > 0, f"{name} was launched on no driven path")
    emit(dict(phase="script", seconds=time.perf_counter() - t_script))
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
