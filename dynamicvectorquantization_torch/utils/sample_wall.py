"""AR-step time of the port's sampling paths on the card, for comparing two
trees of the repository in one run (parent, change, change, parent):

    python dynamicvectorquantization_torch/utils/sample_wall.py --root <tree> --label <name> \\
        [--paths decode,serve,class_sample,sample_cli,http] [--reps 3] [--steps_per_read 4,8,16]

The package is imported from `--root`, so the same script times another
tree (one whose sampler has no CUDA graphs runs its host loop). Seeded random
weights, the shipped p6c18 ymls, int8 KV caches throughout:

  decode        64 teacher-forced AR steps of the bf16 StackGPT at batch 8,
                eagerly with host indices (every tree), and, where the tree
                has `models/graphs.py`, as replays of a CUDA graph of
                `STEPS_PER_READ` masked steps with a device index: windows of
                16 steps, one traced window
  serve         `BatchingSampler` (bf16, max_batch 8), requests of 1, 2 and 4
                images (one batch of 7 rows)
  class_sample  the class p6c18's free `log_images` grid call (f32, labels 1,
                2, 3, 4, top-k 300 / 100)
  sample_cli    `sample.val`'s `main` in-process (f32, batch 8, its knobs)
  http          `serve/http.py`'s server in-process (bf16, max_batch 2), POST
                /generate of 2 images

Each sampling path: its first call (which captures the graphs in a tree that
has them: `first_call`), `--reps` timed calls, and (unless `--trace 0`) one
call under torch.profiler (CUDA activity only). `sample_from_scratch` is wrapped to time each call on
the host clock between synchronizes and read its AR steps; the traced call's
device busy time is the union of its kernels' intervals, read from the raw
trace (a call launches about a million kernels). `--steps_per_read` times
`serve` again at other read intervals (a tree with `STEPS_PER_READ` only).
Prints one JSON line.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time

P6C18 = "configs/stage2/uncond_imagenet_p6c18.yml"
CLASS_P6C18 = "configs/stage2/class_imagenet_p6c18.yml"
TEACHER_FORCED_STEPS = 64
WINDOW = 16


def spread(values):
    """Repeat count and spread (min / median / max) of repeated measurements."""
    v = sorted(values)
    mid = len(v) // 2
    median = v[mid] if len(v) % 2 else (v[mid - 1] + v[mid]) / 2
    return {"n": len(v), "min": v[0], "median": median, "max": v[-1]}


def trace_device(torch, fn):
    """(fn's result, device busy ms, traced window ms, device ops) of one
    call of `fn` under torch.profiler: the union of the device intervals and
    the span from the first interval's start to the last one's end, read
    from the raw trace without building the profiler's event objects."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from dynamicvectorquantization_torch.utils.device_time import busy_union_ms, window_ms

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    intervals = [(e.start_ns() / 1e6, e.end_ns() / 1e6)
                 for e in prof.profiler.kineto_results.events()
                 if e.device_type() == DeviceType.CUDA]
    return out, busy_union_ms(intervals), window_ms(intervals), len(intervals)


class SamplerCalls:
    """Wraps `Dualformer.sample_from_scratch` (the class model inherits it)
    until `close()`: each call's host seconds between synchronizes and AR
    steps are recorded, and the call after `trace_next()` (or the
    `trace_at`-th call, counted from 1) runs under the profiler."""

    def __init__(self, torch, trace_at=None):
        from dynamicvectorquantization_torch.models import dqtransformer as dq

        self.torch, self.calls, self._trace, self.trace_at = torch, [], False, trace_at
        self._lock = threading.Lock()
        self._class = dq.Dualformer
        self._original = original = dq.Dualformer.sample_from_scratch

        def recorded(model, *args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with self._lock:
                traced = self._trace or len(self.calls) + 1 == self.trace_at
                self._trace = False
            row = {}
            if traced:
                out, busy, window, ops = trace_device(
                    torch, lambda: original(model, *args, **kwargs))
                row.update(busy_ms=busy, window_ms=window, device_ops=ops)
            else:
                out = original(model, *args, **kwargs)
                torch.cuda.synchronize()
            row.update(s=time.perf_counter() - t0, ar_steps=int(model.last_ar_steps),
                       **captures_of(model))
            self.calls.append(row)
            return out

        dq.Dualformer.sample_from_scratch = recorded

    def close(self):
        self._class.sample_from_scratch = self._original

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def trace_next(self):
        with self._lock:
            self._trace = True

    def mark(self):
        return len(self.calls)

    def summary(self, first, timed, traced=None):
        """The path's numbers from the call indices it made: `first` (one
        call), `timed` (a range), `traced` (one call, or None)."""
        rows = [self.calls[i] for i in timed]
        step_ms = [r["s"] / r["ar_steps"] * 1e3 for r in rows]
        out = dict(first_call=self.calls[first], calls=rows,
                   ar_step_ms=spread(step_ms)["median"], ar_step_ms_spread=spread(step_ms))
        if traced is not None:
            t = self.calls[traced]
            busy = t["busy_ms"] / t["ar_steps"]
            out.update(traced_call=t, busy_ms_per_ar_step=busy,
                       device_idle_share=1.0 - t["busy_ms"] / t["window_ms"],
                       device_idle_share_vs_step_ms=1.0 - busy / out["ar_step_ms"])
        return out


def captures_of(model):
    """The captures and capture seconds of the model's graph runners so far
    (empty in a tree without graphs)."""
    try:
        from dynamicvectorquantization_torch.models import graphs
    except ImportError:
        return {}
    runners = graphs.runners_of(model).values()
    return dict(captures_so_far=sum(r.captures for r in runners),
                capture_s_so_far=sum(r.capture_s for r in runners))


def runner_stats(torch, model):
    """Captures, capture seconds, replays and graph-pool bytes of the model's
    runner (a tree with graphs), else None."""
    try:
        from dynamicvectorquantization_torch.models import graphs
    except ImportError:
        return None
    runner = graphs.runners_of(model).get(next(model.parameters()).device)
    if runner is None:
        return None
    return dict(captures=runner.captures, capture_s=runner.capture_s, replays=runner.replays,
                pool_bytes=runner.pool_bytes())


# ----------------------------------------------------------- teacher-forced decode
def teacher_forced_tokens(torch, dev, batch=8, steps=TEACHER_FORCED_STEPS):
    g = torch.Generator(device=dev).manual_seed(2)
    return torch.randint(0, 1024, (3, batch, steps + 1), generator=g, device=dev)


def teacher_forced_eager(torch, gpt, tokens, n):
    """`n` teacher-forced AR steps with host indices; (n, B, P + V) logits."""
    batch = tokens.shape[1]
    dev = tokens.device
    pos_cache, content_cache = gpt.make_caches(batch, 1284, torch.bfloat16, dev)
    seg = torch.zeros(batch, dtype=torch.long, device=dev)
    logits = []
    for i in range(n):
        x = gpt.embed_input_token(tokens[0, :, i], tokens[1, :, i] % 256, seg, i, False)
        hidden, pl = gpt.position_step(x, pos_cache, i)
        cl = gpt.content_step(hidden, tokens[2, :, i + 1] % 256, False, content_cache, i)
        logits.append(torch.cat([pl, cl], dim=-1).float())
    return torch.stack(logits)


class TeacherForcedSteps:
    """The same steps as masked device steps over static state: the index a
    0-d int32 tensor read on the device, each step's logits written to row
    `index` of a static buffer. `block(k)` runs k steps; `reset()` restarts
    at index 0 (outside any graph)."""

    def __init__(self, torch, gpt, tokens):
        self.torch, self.gpt, self.tokens = torch, gpt, tokens
        batch, dev = tokens.shape[1], tokens.device
        self.caches = gpt.make_caches(batch, 1284, torch.bfloat16, dev)
        self.index = torch.zeros((), dtype=torch.int32, device=dev)
        self.seg = torch.zeros(batch, dtype=torch.long, device=dev)
        width = gpt.position_head[1].out_features + gpt.content_head[1].out_features
        self.logits = torch.zeros((tokens.shape[2] - 1, batch, width), device=dev)

    def reset(self):
        for cache in self.caches:
            for layer in cache.layers:
                for t in layer[:2]:
                    t.zero_()
                for t in layer[2:]:
                    t.fill_(1.0)
        self.index.zero_()
        self.logits.zero_()

    def step(self):
        torch, gpt = self.torch, self.gpt
        col = self.index.reshape(1)
        tok = self.tokens.index_select(2, col)[..., 0]
        nxt = self.tokens.index_select(2, col + 1)[2, :, 0]
        x = gpt.embed_input_token(tok[0], tok[1] % 256, self.seg, self.index, False)
        hidden, pl = gpt.position_step(x, self.caches[0], self.index)
        cl = gpt.content_step(hidden, nxt % 256, False, self.caches[1], self.index)
        self.logits.index_copy_(0, col.long(), torch.cat([pl, cl], dim=-1).float()[None])
        self.index.add_(1)

    def block(self, k):
        for _ in range(k):
            self.step()


def step_windows(torch, run, steps):
    """Host ms per step of `run` (which runs `steps` AR steps) over 4 timed
    windows, then device busy ms per step, idle share of the traced window
    and device ops per step from one traced window."""
    out = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) / steps * 1e3)
    _, busy, window, ops = trace_device(torch, run)
    median = spread(out)["median"]
    return dict(step_ms=median, step_ms_spread=dict(spread(out), steps_per_window=steps),
                busy_ms_per_step=busy / steps, device_idle_share=1.0 - busy / window,
                device_idle_share_vs_step_ms=1.0 - busy / steps / median,
                device_ops_per_step=ops / steps)


def graph_decode(torch, gpt, tokens, k, host_logits):
    """The teacher-forced steps as replays of one CUDA graph of `k` masked
    device-index steps: (numbers, graph logits). The logits of 64 replayed
    steps are held against the same steps run eagerly with the device index
    (bit for bit) and with host indices (`host_logits`)."""
    from dynamicvectorquantization_torch.models.graphs import GraphRunner

    steps = TeacherForcedSteps(torch, gpt, tokens)
    steps.reset()
    steps.block(TEACHER_FORCED_STEPS)
    device_eager = steps.logits.clone()
    runner = GraphRunner(tokens.device)
    steps.reset()
    t0 = time.perf_counter()
    for _ in range(TEACHER_FORCED_STEPS // k):  # the first block runs eagerly and captures
        runner.run(("decode", k), lambda: steps.block(k))
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    steps.reset()
    for _ in range(TEACHER_FORCED_STEPS // k):
        runner.replay(("decode", k))
    graph = steps.logits.clone()
    per_window = max(1, WINDOW // k)

    def replayed():
        steps.reset()
        for _ in range(per_window):
            runner.replay(("decode", k))

    res = dict(step_windows(torch, replayed, per_window * k), steps_per_graph=k,
               first_64_steps_s=first_s, capture_s=runner.capture_s,
               pool_bytes=runner.pool_bytes(),
               equal_to_eager_device_index=bool(torch.equal(graph, device_eager)),
               eager_device_index_equal_to_host_index=bool(torch.equal(device_eager,
                                                                       host_logits)),
               max_logit_diff_to_host_index=(graph - host_logits).abs().max().item())
    return res, graph


def decode(torch, model, dev, k):
    """Eager host-index steps, and (a tree with graphs) `graph_decode`."""
    gpt = model.transformer
    tokens = teacher_forced_tokens(torch, dev)
    with torch.inference_mode():
        host = teacher_forced_eager(torch, gpt, tokens, TEACHER_FORCED_STEPS)
        res = {"eager_host_index": step_windows(
            torch, lambda: teacher_forced_eager(torch, gpt, tokens, WINDOW), WINDOW)}
        try:
            import dynamicvectorquantization_torch.models.graphs  # noqa: F401
        except ImportError:
            return res
        res["graph_device_index"] = graph_decode(torch, gpt, tokens, k, host)[0]
    return res


# ------------------------------------------------------------------ the sampling paths
def serve(torch, model, calls, reps, trace):
    from dynamicvectorquantization_torch.serve import BatchingSampler

    requests = [(1, 101), (2, 102), (4, 103)]
    walls = []
    rounds = reps + 1 + trace  # the first captures; the last is traced
    with BatchingSampler(model, max_batch=8, max_wait_ms=200.0) as engine:
        start = calls.mark()
        for round_ in range(rounds):
            if trace and round_ == rounds - 1:
                calls.trace_next()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            futures = [engine.submit(n, seed=s) for n, s in requests]
            for f in futures:
                f.result(timeout=1800)
            walls.append(time.perf_counter() - t0)
        batches = engine.batches_run
    require(batches == rounds, f"serve ran {batches} batches for {rounds} rounds")
    return dict(calls.summary(start, range(start + 1, start + reps + 1),
                              start + rounds - 1 if trace else None),
                batch_s=spread(walls[1:reps + 1]), first_batch_s=walls[0])


def class_sample(torch, dev, calls, reps, trace):
    from dynamicvectorquantization_torch.utils.model_loading import load_model_and_variables

    model, _ = load_model_and_variables(CLASS_P6C18, seed=0, kv_cache_dtype="int8", device=dev)
    labels = torch.tensor([1, 2, 3, 4], device=dev)
    start = calls.mark()
    with torch.inference_mode():
        for i in range(reps + 1 + trace):
            if i == reps + 1:
                calls.trace_next()
            model.sample_from_scratch(
                *model.encode_to_c(labels), generator=torch.Generator(device=dev).manual_seed(17),
                top_k=300, top_p=1.0, top_k_pos=100, top_p_pos=1.0, fix_fine_position=False)
    out = calls.summary(start, range(start + 1, start + reps + 1),
                        start + reps + 1 if trace else None)
    out["graphs"] = runner_stats(torch, model)
    return out


def sample_cli(torch, calls, reps, trace):
    """`sample.val` `main` once, batches of 8: the first captures, `reps` are
    timed, and with `trace` one more is traced."""
    import io
    import shutil
    from contextlib import redirect_stdout

    from dynamicvectorquantization_torch.sample import val

    root = os.path.join("build", "sample_wall_val")
    shutil.rmtree(root, ignore_errors=True)
    start = calls.mark()
    n = reps + 1 + trace

    original = val.sample_batches

    def batches(model, opt, seconds=None):
        for i, batch in enumerate(original(model, opt, seconds)):
            if trace and i == n - 2:  # the profiler on the last batch's sampling call
                calls.trace_next()
            yield batch

    val.sample_batches = batches
    out = io.StringIO()
    try:
        with redirect_stdout(out):
            val.main(["--yaml_path", P6C18, "--save_path", root, "--batch_size", "8",
                      "--sample_num", str(8 * n), "--kv_cache_dtype", "int8"])
    finally:
        val.sample_batches = original
        shutil.rmtree(root, ignore_errors=True)
    summary = json.loads(out.getvalue().strip().splitlines()[-1])
    seconds = summary["batch_seconds"]
    return dict(calls.summary(start, range(start + 1, start + reps + 1),
                              start + n - 1 if trace else None),
                batch_s=spread(seconds[1:reps + 1]), first_batch_s=seconds[0])


def http(torch, model, calls, reps, trace):
    import urllib.request

    from dynamicvectorquantization_torch.serve import BatchingSampler
    from dynamicvectorquantization_torch.serve.http import make_server

    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))  # loopback only
    walls = []
    with BatchingSampler(model, max_batch=2, max_wait_ms=50.0) as engine:
        start = calls.mark()
        t0 = time.perf_counter()
        engine.generate(1, seed=0)  # the entry point's warm-up, before it listens
        warmup_s = time.perf_counter() - t0
        server = make_server(engine, "127.0.0.1", 0)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        url = f"http://127.0.0.1:{server.server_address[1]}/generate"
        try:
            for i in range(reps + trace):
                if i == reps:
                    calls.trace_next()
                req = urllib.request.Request(
                    url, data=json.dumps({"num_images": 2, "seed": 7 + i}).encode(),
                    headers={"Content-Type": "application/json"})
                t0 = time.perf_counter()
                with opener.open(req, timeout=1800) as r:
                    require(r.status == 200, f"POST /generate: {r.status}")
                    r.read()
                walls.append(time.perf_counter() - t0)
        finally:
            server.shutdown()
            server.server_close()
            thread.join()
    return dict(calls.summary(start, range(start + 1, start + reps + 1),
                              start + reps + 1 if trace else None),
                request_s=spread(walls[:reps]), warmup_s=warmup_s)


def require(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=".", help="repository tree to import the port from")
    ap.add_argument("--label", default="")
    ap.add_argument("--paths", default="decode,serve,class_sample,sample_cli,http")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--trace", type=int, default=1, choices=(0, 1),
                    help="0: no traced call (timing only; device time does not follow the host)")
    ap.add_argument("--steps_per_read", default="",
                    help="comma-separated read intervals to time `serve` at as well")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    # run as a script, sys.path[0] is this file's directory, whose logging.py
    # would shadow the standard library's: import from the tree instead
    sys.path[0] = root
    os.chdir(root)

    import torch

    from dynamicvectorquantization_torch.models import dqtransformer as dq
    from dynamicvectorquantization_torch.utils.model_loading import load_model_and_variables

    if not torch.cuda.is_available():
        print("sample_wall: no CUDA device", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    paths = args.paths.split(",")
    k = getattr(dq, "STEPS_PER_READ", None)
    calls = SamplerCalls(torch)
    res = dict(label=args.label, root=root, device=torch.cuda.get_device_name(0),
               steps_per_read=k)
    model, _ = load_model_and_variables(P6C18, seed=0, kv_cache_dtype="int8", device=dev)
    model.transformer.to(torch.bfloat16)
    if "decode" in paths:
        res["decode"] = decode(torch, model, dev, k or 8)
    if "serve" in paths:
        res["serve"] = serve(torch, model, calls, args.reps, args.trace)
        res["serve"]["graphs"] = runner_stats(torch, model)
    for value in filter(None, args.steps_per_read.split(",")):
        require(k is not None, "--steps_per_read: this tree's sampler has no read interval")
        dq.STEPS_PER_READ = int(value)
        res.setdefault("serve_by_steps_per_read", {})[value] = serve(torch, model, calls,
                                                                     args.reps, 0)
        dq.STEPS_PER_READ = k
    if "http" in paths:
        res["http"] = http(torch, model, calls, args.reps, args.trace)
    del model
    torch.cuda.empty_cache()
    if "class_sample" in paths:
        res["class_sample"] = class_sample(torch, dev, calls, args.reps, args.trace)
        torch.cuda.empty_cache()
    if "sample_cli" in paths:
        res["sample_cli"] = sample_cli(torch, calls, args.reps, args.trace)
    res["seconds"] = time.perf_counter() - t_start
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
