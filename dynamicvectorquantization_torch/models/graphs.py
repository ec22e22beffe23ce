"""CUDA graphs of work that the host would otherwise dispatch op by op: the
port's form of a compiled JAX loop body.

`GraphRunner` keeps captured graphs under keys that hold everything a
capture bakes in (shapes, dtypes, Python-float knobs, and the storage of
every parameter the work reads: `parameter_storage`), all in one memory
pool, and replays them on the caller's stream. Work whose key has no graph
yet runs eagerly on the runner's side stream (the capture's warm-up: the
kernel library, cuBLAS handles and the allocator's blocks exist before the
capture) and is then captured for the next time. The captured work must read
and write only tensors allocated outside the graph (static state), and take
every value that changes between replays from those tensors.

Random draws: every graph draws from the runner's own `generator`
(registered with each graph by `CUDAGraph.register_generator_state`), and a
replay draws what the same work would draw eagerly from the same generator
state. Callers copy their generator's state in before and back out after
(`carry_generator`), so a caller's generator advances as if the work had
drawn from it directly. A PyTorch without that registration raises.

Launch counts: a kernel wrapper counts a Python call, and a graph is captured
once and replayed many times. The runner takes the counts a capture added
back out, keeps them as the graph's launches per replay, and adds them to the
wrappers' counters at every replay (`chip_smoke.py` reads the counters).

Capture safety: captures run with `capture_error_mode="thread_local"`, so an
unsafe call of the capturing thread fails the capture (and raises) while
other threads run on. A device-wide synchronize from another thread during a
capture still invalidates it (seen on an H100): the port's own threads (the
HTTP handlers of `serve/http.py`) launch no CUDA work. A capture or replay
that fails raises; nothing falls back to eager work.
"""
from __future__ import annotations

import contextlib
import threading
import time
import weakref

import torch

_RUNNERS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def launch_counters():
    """(wrapper, attribute) of every kernel launch counter of the port's ops,
    and of the masked attention route's call counter."""
    from ..ops import attention, downsample, entropy, fused_adamw, kv_int8, layernorm, vq

    fns = (kv_int8.decode_attention_int8, attention.fused_attention_forward,
           attention.fused_attention_backward, layernorm.layernorm_forward,
           layernorm.layernorm_backward, fused_adamw.fused_adamw_step, vq.nearest_codes,
           vq.nearest_codes_with_stats, entropy.patch_entropy, downsample.strided_conv3x3_down)
    # and the calls of the masked attention route (torch ops, no kernel of its own)
    return [(fn, name) for fn in fns for name, value in vars(fn).items()
            if name.endswith("launches") and isinstance(value, int)] + [
        (attention.masked_causal_attention, "calls")]


def parameter_storage(module):
    """The storage of every parameter of `module` (data pointer and dtype): a
    graph captured on one storage reads that memory at every replay, so a
    swap of `p.data` (`Stage2Trainer.master_weights`) must change the key."""
    return tuple((p.data_ptr(), p.dtype) for p in module.parameters())


def runners_of(owner) -> dict:
    """{device: runner} of `owner` (empty when it has captured nothing)."""
    return _RUNNERS.get(owner, {})


def runner_for(owner, device) -> "GraphRunner":
    """The graph runner of `owner` (e.g. a model) on `device`, made at first
    use and dropped with its owner."""
    runners = _RUNNERS.setdefault(owner, {})
    device = torch.device(device)
    if device.index is None:  # "cuda" is the current device: key by its index
        device = torch.device(device.type, torch.cuda.current_device())
    if device not in runners:
        runners[device] = GraphRunner(device)
    return runners[device]


class GraphRunner:
    """Captured CUDA graphs on one device, keyed, sharing one memory pool."""

    def __init__(self, device):
        if not hasattr(torch.cuda.CUDAGraph, "register_generator_state"):
            raise RuntimeError(
                f"PyTorch {torch.__version__} cannot register a generator with a CUDA graph "
                "(CUDAGraph.register_generator_state): the sampler's graphs could not replay "
                "their random draws")
        self.device = torch.device(device)
        self.pool = torch.cuda.graph_pool_handle()
        self.stream = torch.cuda.Stream(self.device)
        self.generator = torch.Generator(device=self.device)
        self.graphs = {}  # key -> (CUDAGraph, {(wrapper, counter): launches per replay})
        self.state = {}  # static state of the callers, by their own keys
        self.captures = 0
        self.capture_s = 0.0  # host seconds spent capturing (warm-up runs excluded)
        self.replays = 0
        self.lock = threading.Lock()

    def run(self, key, fn, release_cache=False):
        """Replay the graph of `key`; without one, run `fn` eagerly on the
        side stream (ordered after and before the caller's stream) and
        capture it. `release_cache`: empty the caching allocator's free blocks
        (`torch.cuda.empty_cache`) between the warm-up and the capture, so that
        the graph's pool can take the memory the warm-up's intermediates held
        (a training step's activations: without it they would be held twice)."""
        if key in self.graphs:
            self.replay(key)
            return
        caller = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(caller)
        with torch.cuda.stream(self.stream):
            fn()
        caller.wait_stream(self.stream)
        if release_cache:
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()
        self.capture(key, fn)

    def capture(self, key, fn):
        counters = launch_counters()
        before = [getattr(fn_, name) for fn_, name in counters]
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self.generator)
        try:
            with torch.cuda.graph(graph, pool=self.pool, stream=self.stream,
                                  capture_error_mode="thread_local"):
                fn()
        finally:  # a capture launches nothing: its counts come back out
            per_replay = {}
            for (fn_, name), n in zip(counters, before):
                if getattr(fn_, name) != n:
                    per_replay[(fn_, name)] = getattr(fn_, name) - n
                setattr(fn_, name, n)
        self.graphs[key] = (graph, per_replay)
        self.captures += 1
        self.capture_s += time.perf_counter() - t0

    def replay(self, key):
        graph, per_replay = self.graphs[key]
        graph.replay()
        for (fn_, name), n in per_replay.items():
            setattr(fn_, name, getattr(fn_, name) + n)
        self.replays += 1

    @contextlib.contextmanager
    def carry_generator(self, generator):
        """For its duration the runner's generator holds the state of
        `generator` (the device's default generator when None), and the
        runner serves this thread alone (its static state has one user at a
        time); the state goes back to `generator` at the end."""
        source = generator
        if source is None:
            source = torch.cuda.default_generators[self.device.index or 0]
        with self.lock:
            self.generator.set_state(source.get_state())
            try:
                yield self.generator
            finally:
                source.set_state(self.generator.get_state())

    def pool_bytes(self) -> int:
        """Bytes the caching allocator holds in this runner's graph pool."""
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg.get("segment_pool_id", ())) == tuple(self.pool))
