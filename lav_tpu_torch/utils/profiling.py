"""Step timing and device traces (counterpart of
`lav_tpu/utils/profiling.py`), and what the measurement tools share.

`StepTimer` measures what a closed-loop user waits for: the host's wall
clock from `start` to the moment a step's result is ready, host work
included.  `stop(result)` synchronizes the CUDA devices that hold the
result's tensors, as `jax.block_until_ready` waits for lav_tpu's.
"""

from __future__ import annotations

import contextlib
import subprocess
import time
from typing import Dict, List, Optional

import torch


def synchronize() -> None:
    """Wait for the card's queued work, where the process uses a card."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def timeit(fn, *args, iters: int = 10, warmup: int = 2) -> float:
    """ms a call of `fn(*args)`: `warmup` calls, then the host clock over
    `iters` calls ending in a synchronize (lav_tpu's `timeit`, which ends
    in `block_until_ready`)."""
    for _ in range(warmup):
        fn(*args)
    synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    synchronize()
    return (time.perf_counter() - t0) / iters * 1000


def card_line(device=None) -> str:
    """What a measurement ran on: the card's name and power limit as
    `nvidia-smi --query-gpu=name,power.limit` gives them, or `cpu`."""
    dev = torch.device("cuda" if device is None and torch.cuda.is_available()
                       and torch.cuda.is_initialized() else device or "cpu")
    if dev.type != "cuda":
        return "cpu"
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60).stdout.splitlines()
    except (OSError, subprocess.TimeoutExpired):
        smi = []
    idx = dev.index or 0
    return (smi[idx].strip() if len(smi) > idx else
            f"{torch.cuda.get_device_name(idx)}, power limit not read")


@contextlib.contextmanager
def trace(path: str):
    """Profile the block with `torch.profiler` (the CPU, and the card when
    there is one) and write its Chrome trace to `path`."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(path)


def _cuda_devices(tree, found: set) -> set:
    if isinstance(tree, torch.Tensor):
        if tree.is_cuda:
            found.add(tree.device)
    elif isinstance(tree, dict):
        for v in tree.values():
            _cuda_devices(v, found)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _cuda_devices(v, found)
    return found


class StepTimer:
    """Wall-clock step statistics, waiting for the result's device at
    each stop; the first `warmup` steps are not kept."""

    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self.samples: List[float] = []
        self._n = 0
        self._t: Optional[float] = None

    def start(self):
        self._t = time.perf_counter()

    def stop(self, result=None):
        for dev in _cuda_devices(result, set()):
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - self._t
        self._n += 1
        if self._n > self.warmup:
            self.samples.append(dt)
        return dt

    def stats(self) -> Dict[str, float]:
        if not self.samples:
            return {}
        s = sorted(self.samples)
        n = len(s)
        return {
            "mean_s": sum(s) / n,
            "p50_s": s[n // 2],
            "p90_s": s[min(n - 1, int(n * 0.9))],
            "steps_per_sec": n / sum(s),
        }
