"""Batching and prefetching loader (counterpart of `lav_tpu/data/loader.py`).

The numpy batcher is lav_tpu's: `collate` stacks the samples, the shuffle
order is drawn each epoch from one `np.random.default_rng(seed)`, and
batches that are not full are dropped.  A background thread builds the
next batches and puts them on the device while the current train step
runs; an exception in that thread reaches the consumer.

On the card each batch is copied into pinned memory and then to the
device with `non_blocking=True`, on a stream of the loader's own, which
the thread waits on before it hands the batch over; the consumer's
stream then owns the tensors (`record_stream`).

The dtypes are those lav_tpu's steps get from `jax.device_put` with x64
off, which turns float64 into float32 and int64 into int32 (and uint64
into uint32); `torch.from_numpy` would keep them.  `wait_ms` holds, for
each batch handed over, the ms the consumer waited for it.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Dict, Iterator

import numpy as np
import torch

# jax.device_put's dtypes with x64 off
_NARROW = {np.dtype(np.float64): np.float32, np.dtype(np.int64): np.int32,
           np.dtype(np.uint64): np.uint32}


def collate(samples) -> Dict[str, np.ndarray]:
    out = {}
    for k in samples[0]:
        out[k] = np.stack([s[k] for s in samples])
    return out


def device_dtype(dtype) -> np.dtype:
    """The numpy dtype an array of `dtype` takes on the device."""
    dtype = np.dtype(dtype)
    return np.dtype(_NARROW.get(dtype, dtype))


def to_device(batch: Dict[str, np.ndarray], device,
              stream=None) -> Dict[str, torch.Tensor]:
    """A numpy batch as tensors on `device`, each in `device_dtype`.  On a
    CUDA device through pinned memory, copied with non_blocking on
    `stream` (default the current one)."""
    dev = torch.device(device)
    host = {k: torch.from_numpy(np.ascontiguousarray(
        v, dtype=device_dtype(v.dtype))) for k, v in batch.items()}
    if dev.type != "cuda":
        return {k: v.to(dev) for k, v in host.items()}
    with torch.cuda.stream(stream or torch.cuda.current_stream(dev)):
        return {k: v.pin_memory().to(dev, non_blocking=True)
                for k, v in host.items()}


class DataLoader:
    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 drop_last: bool = True, seed: int = 2021, device="cpu",
                 prefetch: int = 2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.rng = np.random.default_rng(seed)
        self.device = torch.device(device)
        self.prefetch = prefetch
        self.wait_ms: list = []

    def __len__(self):
        n = len(self.dataset) // self.batch_size
        if not self.drop_last and len(self.dataset) % self.batch_size:
            n += 1
        return n

    def _host_batches(self) -> Iterator[Dict[str, np.ndarray]]:
        idxs = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(idxs)
        for start in range(0, len(idxs), self.batch_size):
            chunk = idxs[start:start + self.batch_size]
            if self.drop_last and len(chunk) < self.batch_size:
                return
            yield collate([self.dataset[int(i)] for i in chunk])

    def __iter__(self):
        dev = self.device
        cuda = dev.type == "cuda"
        copy_stream = torch.cuda.Stream(dev) if cuda else None
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = object()

        def producer():
            # exceptions reach the consumer: a bare stop sentinel would
            # end the epoch silently when a batch fails to build
            try:
                for b in self._host_batches():
                    b = to_device(b, dev, copy_stream)
                    if cuda:
                        copy_stream.synchronize()
                    q.put(b)
                q.put(stop)
            except BaseException as e:  # noqa: BLE001 — re-raised below
                q.put(e)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while True:
            t0 = time.perf_counter()
            b = q.get()
            if b is stop:
                return
            if isinstance(b, BaseException):
                raise RuntimeError("DataLoader producer thread failed") from b
            self.wait_ms.append((time.perf_counter() - t0) * 1e3)
            if cuda:
                current = torch.cuda.current_stream(dev)
                for v in b.values():
                    v.record_stream(current)
            yield b
