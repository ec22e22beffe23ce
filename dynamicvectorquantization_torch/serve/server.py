"""Dynamic-batching sampler (counterpart of
`dynamicvectorquantization_tpu/serve/server.py` `BatchingSampler`).

A background worker coalesces concurrent `submit()` calls into batches of up
to `max_batch` rows (a request that does not fit waits at the head of the
next batch), runs `sample_from_scratch` + `decode_to_img` once per batch at
a fixed batch size (the tail is padded), and resolves each request's future
with its (n, H, W, 3) float numpy images in [-1, 1]-ish NHWC.

Randomness: one `torch.Generator` per engine, seeded before each batch from
the first request's seed (or the batch counter when it has none) mixed with
the seeds of the later requests, so a repeated request sequence gives the
same images on the same device. It does not reproduce the JAX package's
random bits. On CUDA the sampler's graphs carry its state through each batch
(`models/graphs.py`); the first batch of each shape captures them.

On CUDA the transformer runs in bf16 by default (as the JAX server does on
the TPU); this converts the caller's model in place.
"""
from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field

import torch

_SEED_MASK = (1 << 63) - 1


@dataclass
class _Request:
    n: int
    seed: int
    future: Future = field(default_factory=Future)


def batch_seed(seeds, batches_run: int) -> int:
    """The generator seed of a batch whose requests carry `seeds` (-1 = none)."""
    seed = seeds[0] if seeds[0] >= 0 else batches_run
    for s in seeds[1:]:
        if s >= 0:
            seed = (seed * 1_000_003 + s + 1) & _SEED_MASK
    return seed


class BatchingSampler:
    def __init__(self, model, max_batch: int = 16, max_wait_ms: float = 20.0,
                 temperature: float = 1.0, top_k: int = 300, top_k_pos: int = 1024,
                 top_p: float = 1.0, top_p_pos: float = 1.0, fix_fine_position: bool = False,
                 bf16=None):
        self.model = model
        self.device = next(model.parameters()).device
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_ms) / 1e3
        if bf16 is None:
            bf16 = self.device.type == "cuda"
        if bf16:
            model.transformer.to(torch.bfloat16)
        self._knobs = dict(temperature=temperature, top_k=top_k, top_p=top_p,
                           top_k_pos=top_k_pos, top_p_pos=top_p_pos,
                           fix_fine_position=fix_fine_position)
        self._queue: "queue.Queue[_Request | None]" = queue.Queue()
        self._pending = None  # displaced head-of-line request (worker-local)
        self._closed = False
        self.batches_run = 0
        self.images_served = 0
        # per batch run: AR steps, and host seconds of sampling and of decoding
        # (the sampler reads its loop condition every few steps and the decode
        # ends in a copy to the host, so these split the batch's device time too)
        self.batch_stats = []
        self._generator = torch.Generator(device=self.device)
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    # ------------------------------------------------------------------ API
    def submit(self, n: int = 1, seed=None) -> Future:
        """Queue a request for `n` images; resolves to (n, H, W, 3) float."""
        if self._closed:
            raise RuntimeError("BatchingSampler is closed")
        if not 1 <= n <= self.max_batch:
            raise ValueError(f"n must be in [1, {self.max_batch}], got {n}")
        req = _Request(n=n, seed=-1 if seed is None else int(seed))
        self._queue.put(req)
        return req.future

    def generate(self, n: int = 1, seed=None, timeout=None):
        return self.submit(n, seed).result(timeout=timeout)

    def close(self):
        if self._closed:
            return
        self._closed = True
        self._queue.put(None)
        self._worker.join()
        leftovers = [self._pending] if self._pending is not None else []
        self._pending = None
        while True:
            try:
                leftovers.append(self._queue.get_nowait())
            except queue.Empty:
                break
        for req in leftovers:
            if req is not None and not req.future.done():
                req.future.set_exception(RuntimeError("BatchingSampler closed"))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # --------------------------------------------------------------- worker
    def _collect(self):
        """One request, then whatever arrives within max_wait_s, up to a full
        batch."""
        if self._pending is not None:
            first, self._pending = self._pending, None
        else:
            first = self._queue.get()
        if first is None:
            return None
        batch, rows = [first], first.n
        t_end = time.monotonic() + self.max_wait_s
        while rows < self.max_batch:
            remaining = t_end - time.monotonic()
            if remaining <= 0:
                break
            try:
                req = self._queue.get(timeout=remaining)
            except queue.Empty:
                break
            if req is None:
                self._queue.put(None)  # shut down after this batch
                break
            if rows + req.n > self.max_batch:
                self._pending = req  # first member of the next batch
                break
            batch.append(req)
            rows += req.n
        return batch

    def _sample(self, generator):
        model = self.model
        t0 = time.perf_counter()
        c = model.encode_to_c(self.max_batch, self.device)
        toks = model.sample_from_scratch(*c, generator=generator, **self._knobs)
        t1 = time.perf_counter()
        imgs = model.decode_to_img(*toks).float().cpu().numpy()
        self.batch_stats.append(dict(ar_steps=model.last_ar_steps, sample_s=t1 - t0,
                                     decode_s=time.perf_counter() - t1))
        return imgs

    def _run(self):
        while True:
            batch = self._collect()
            if batch is None:
                return
            try:
                self._generator.manual_seed(batch_seed([r.seed for r in batch],
                                                       self.batches_run))
                with torch.inference_mode():
                    imgs = self._sample(self._generator)
                self.batches_run += 1
                row = 0
                for r in batch:
                    r.future.set_result(imgs[row: row + r.n])
                    row += r.n
                    self.images_served += r.n
            except Exception as e:  # worker boundary: report to every caller
                for r in batch:
                    if not r.future.done():
                        r.future.set_exception(e)
