"""Prefetching host input pipeline (counterpart of
`dynamicvectorquantization_tpu/data/pipeline.py`).

`PrefetchLoader`: a thread pool decodes / augments ahead of the card, in the
JAX package's index order and with its per-example generators
(`default_rng((seed, epoch, batch index, example index))`), so both packages
see the same batches. Over several ranks `epoch(epoch, part=(rank, size))`
keeps the global order and yields each global batch's rows of that rank
only (contiguous, rank 0 first), each decoded with the generator it has in
the global batch, so a rank reads and decodes its own share and no more.
`device_prefetch` moves batches to the device ahead of
their use: pinned host memory and non-blocking copies on a CUDA device, so
the copy of batch N + 1 overlaps step N.
"""
from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch


def _stack(examples):
    batch = {}
    for k in examples[0]:
        vals = [e[k] for e in examples]
        batch[k] = vals if isinstance(vals[0], str) else np.stack(vals)
    return batch


class PrefetchLoader:
    """Iterable over stacked numpy batches with background workers."""

    def __init__(self, dataset, batch_size, shuffle=False, num_workers=2, seed=0,
                 drop_last=True, prefetch=2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.seed = seed
        self.drop_last = drop_last
        self.prefetch = prefetch

    def __len__(self):
        n = len(self.dataset) // self.batch_size
        if not self.drop_last and len(self.dataset) % self.batch_size:
            n += 1
        return n

    def _index_order(self, epoch):
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + epoch).shuffle(idx)
        return idx

    def epoch(self, epoch=0, part=None):
        """The batches of `epoch`; with `part` = (rank, size) that rank's
        rows of each global batch (a batch `size` does not divide raises)."""
        order = self._index_order(epoch)
        last = len(order) - (self.batch_size - 1 if self.drop_last else 0)
        batches = [order[i:i + self.batch_size] for i in range(0, last, self.batch_size)]
        if part is not None:
            rank, size = part
            for b in batches:
                if len(b) % size:
                    raise ValueError(f"a global batch of {len(b)} rows does not divide over "
                                     f"{size} ranks")
            batches = [b[rank * (len(b) // size):(rank + 1) * (len(b) // size)]
                       for b in batches]
        out_q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item):
            # a consumer that left early must not leave this thread blocked
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.1)
                    return
                except queue.Full:
                    pass

        def produce():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for bi, idxs in enumerate(batches):
                        if stop.is_set():
                            return
                        rngs = [np.random.default_rng((self.seed, epoch, bi, int(i)))
                                for i in idxs]
                        examples = list(pool.map(
                            lambda a: self.dataset.__getitem__(int(a[0]), rng=a[1]),
                            zip(idxs, rngs)))
                        put(_stack(examples))
                put(None)
            except BaseException as e:  # hand the failure to the consumer
                put(e)

        thread = threading.Thread(target=produce, daemon=True)
        thread.start()
        try:
            while True:
                item = out_q.get()
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            thread.join()

    def __iter__(self):
        return self.epoch(0)


def to_device(batch, device):
    """numpy leaves of a batch (a dict, a tuple or an array) -> tensors on
    `device`; on CUDA through pinned memory with a non-blocking copy. Other
    leaves (lists of strings) pass through."""
    if isinstance(batch, dict):
        return {k: to_device(v, device) for k, v in batch.items()}
    if isinstance(batch, tuple):
        return tuple(to_device(v, device) for v in batch)
    if not isinstance(batch, np.ndarray):
        return batch
    t = torch.from_numpy(np.ascontiguousarray(batch))
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def device_prefetch(iterator, device, depth=2, timings=None):
    """Move batches to the device `depth` ahead of their consumption.
    `timings`: optional dict accumulating the host seconds spent issuing the
    copies under "transfer"."""
    def put(b):
        t0 = time.perf_counter()
        out = to_device(b, device)
        if timings is not None:
            timings["transfer"] = timings.get("transfer", 0.0) + time.perf_counter() - t0
        return out

    it = iter(iterator)
    buf = []
    try:
        for _ in range(depth):
            buf.append(put(next(it)))
    except StopIteration:
        pass
    for nxt in it:
        out = buf.pop(0)
        buf.append(put(nxt))
        yield out
    yield from buf
