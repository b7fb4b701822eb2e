"""Roofline accounting on the card: device time by op class, FLOPs, and
achieved against peak (counterpart of `lav_tpu/utils/roofline.py`,
rebuilt on `torch.profiler`).

    from lav_tpu_torch.utils.roofline import roofline_summary
    summary = roofline_summary(fn, args, iters=4)

Device time comes from a `torch.profiler` run: the kernel events of its
Chrome trace, summed by kernel name (`parse_trace`).  On a run that
profiled no card the CPU is the device and its operators' self times
stand in; a card run whose trace holds no kernel (the profiler now and
then records none) is run again (`profile_device`), then raises.
`classify_op` buckets a kernel name: the port's own kernels
(`csrc/*.cu`, named exactly by C entry or top-level `__global__` name:
hand_crop, hand_scatter, hand_conv_int8, hand_gather) first, then the
library's scatters, cuDNN and CUTLASS convs, cuBLAS GEMMs, sorts,
gathers, copies, reductions and elementwise kernels.  FLOPs are counted by
`torch.utils.flop_counter.FlopCounterMode`, which sees the operators of
PyTorch but not the port's kernels (`ctypes` launches): their device ms
is listed by name with FLOPs None, never 0.  No analysis of PyTorch
counts bytes, so bytes are None.

The peaks are NVIDIA's data sheet for the H100 SXM at its 700 W limit
(dense rates): a card set below 700 W runs slower.  lav_tpu's HLO fusion
analysis (`fusion_kinds_from_hlo`) has no counterpart: CUDA kernels are
not XLA fusions.
"""

from __future__ import annotations

import collections
import functools
import json
import os
import re
import tempfile
from typing import Callable, Dict, Optional, Tuple

import torch

from lav_tpu_torch.utils.profiling import card_line, synchronize

PEAK_CARD = "NVIDIA H100 SXM, 700 W"
H100_PEAK_BF16_FLOPS = 989e12
H100_PEAK_INT8_OPS = 1979e12
H100_PEAK_F32_FLOPS = 67e12
H100_PEAK_HBM_BYTES = 3.35e12

# each csrc source's kernels fall in one class, apart from the library's
HAND_CLASSES = {"crop_shared": "hand_crop", "crop_shared_bwd": "hand_crop",
                "pillar_scatter_max": "hand_scatter",
                "pillar_scatter": "hand_scatter",
                "conv2d_int8": "hand_conv_int8",
                "take_along_rows": "hand_gather"}
CSRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "csrc")

# the library's kernels (and lav_tpu's XLA op names, which its classes
# bucket alike), tested in order; first match wins
_CLASSES = (
    # arange's and linspace's fill
    ("elementwise", re.compile(r"elementwise_kernel_with_index")),
    ("scatter", re.compile(r"scatter", re.I)),
    ("conv", re.compile(r"conv|fprop|dgrad|wgrad|winograd|fft", re.I)),
    ("matmul", re.compile(r"gemm|gemv|splitKreduce|cublas|cutlass|matmul"
                          r"|::(?:add|b)?mm\b|\bdot\b|dot_general|einsum",
                          re.I)),
    ("sort", re.compile(r"sort|radix|topk", re.I)),
    ("gather", re.compile(r"gather|index|take|dynamic-slice|dynamic_slice",
                          re.I)),
    ("copy", re.compile(r"copy|transpose|permute|nchwToNhwc|nhwcToNchw"
                        r"|memcpy|memset|CatArray|bitcast|reshape|broadcast",
                        re.I)),
    ("reduce", re.compile(r"reduce|softmax|norm|pool|argm", re.I)),
    ("elementwise", re.compile(r"elementwise|Functor|fusion|add|multiply"
                               r"|select|compare", re.I)),
)
# a kernel's name at the top level of an anonymous namespace (as the
# port's `__global__` functions are), or a C entry's
_HAND = re.compile(r"^(?:void )?(?:\(anonymous namespace\)::)?"
                   r"(\w+)(?=<|\(|$)")
_GLOBAL = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\s*\("
                     r"(?:[^()]|\([^()]*\))*\)\s*)?(\w+)\s*\(")


@functools.lru_cache(maxsize=None)
def hand_kernels() -> Dict[str, str]:
    """{C entry or `__global__` function name: class} of the port's
    kernels, read from `native.ENTRIES` and the `csrc/` sources."""
    from lav_tpu_torch.utils import native

    out = {sym: HAND_CLASSES[e.source] for sym, e in native.ENTRIES.items()}
    for source, cls in HAND_CLASSES.items():
        with open(os.path.join(CSRC, f"{source}.cu")) as f:
            out.update((name, cls) for name in _GLOBAL.findall(f.read()))
    return out


def hand_class(name: str) -> Optional[str]:
    """The class of a kernel of the port, by its name as the profiler
    shows it (namespace, template and arguments stripped, then matched
    exactly); None for any other kernel."""
    m = _HAND.match(name)
    return hand_kernels().get(m.group(1)) if m else None


def classify_op(name: str) -> str:
    hand = hand_class(name)
    if hand is not None:
        return hand
    for cls, pat in _CLASSES:
        if pat.search(name):
            return cls
    return "other"


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# what only a trace that profiled a card holds
CUDA_CATS = DEVICE_CATS + ("cuda_runtime", "gpu_user_annotation")


class NoDeviceEvents(RuntimeError):
    """A card was profiled but the trace holds no kernel, copy or fill."""


def _trace(source) -> dict:
    """The Chrome trace of a `torch.profiler` run (its profile object, or
    the path of the trace it wrote).  A profile exports its trace once,
    so the trace is kept on it."""
    if isinstance(source, (str, os.PathLike)):
        with open(source) as f:
            return json.load(f)
    trace = getattr(source, "_lav_trace", None)
    if trace is None:
        fd, path = tempfile.mkstemp(suffix=".json", prefix="lav_trace_")
        os.close(fd)
        try:
            source.export_chrome_trace(path)
            trace = _trace(path)
        finally:
            os.remove(path)
        source._lav_trace = trace
    return trace


def _events(source) -> list:
    return _trace(source).get("traceEvents", [])


def profiled_a_card(source) -> bool:
    """Whether the run profiled a card: its profile asked for CUDA
    activity, or its trace holds the card's properties or CUDA events."""
    acts = getattr(source, "activities", None)
    if acts is not None:
        return torch.profiler.ProfilerActivity.CUDA in acts
    trace = _trace(source)
    return bool(trace.get("deviceProperties")) or any(
        ev.get("cat") in CUDA_CATS for ev in trace.get("traceEvents", []))


def _cpu_self_us(events) -> Dict[str, float]:
    """Self time (us) of each CPU operator, by name: its duration less the
    operators nested in it on its thread."""
    by_thread = collections.defaultdict(list)
    for ev in events:
        if ev.get("ph") == "X" and ev.get("cat") == "cpu_op":
            by_thread[(ev.get("pid"), ev.get("tid"))].append(ev)
    out: Dict[str, float] = collections.defaultdict(float)
    for evs in by_thread.values():
        evs.sort(key=lambda e: (e["ts"], -e.get("dur", 0.0)))
        stack = []   # [end, name, self]
        for ev in evs:
            start, dur = ev["ts"], ev.get("dur", 0.0)
            while stack and stack[-1][0] <= start:
                _, n, s = stack.pop()
                out[n] += s
            if stack:
                stack[-1][2] -= dur
            stack.append([start + dur, ev["name"], dur])
        for _, n, s in stack:
            out[n] += s
    return dict(out)


def parse_trace(source) -> Dict[str, float]:
    """{kernel name: summed device us} of a `torch.profiler` run (profile
    object or Chrome trace path): its kernel, memcpy and memset events.
    A run that profiled no card gives each CPU operator's self time; one
    that profiled a card and holds no such event raises NoDeviceEvents."""
    events = _events(source)
    durs: Dict[str, float] = collections.defaultdict(float)
    for ev in events:
        if ev.get("ph") == "X" and ev.get("cat") in DEVICE_CATS:
            durs[ev.get("name", "?")] += ev.get("dur", 0.0)
    if not durs and profiled_a_card(source):
        raise NoDeviceEvents("the profiler recorded no device activity of "
                             "the card")
    if not durs:
        durs = _cpu_self_us(events)
    if not durs:
        raise RuntimeError("no device or operator events in the trace")
    return dict(durs)


def profile_device(fn: Callable, iters: int, device, tries: int = 3):
    """(profile, `parse_trace` of it) of `iters` calls of fn() ending in a
    synchronize, the card's activity recorded when `device` is one; a card
    run with no device events in the trace is run again, up to `tries`
    times, then raises NoDeviceEvents."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    for attempt in range(tries):
        synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(iters):
                fn()
            synchronize()
        try:
            return prof, parse_trace(prof)
        except NoDeviceEvents:
            if attempt == tries - 1:
                raise


def parse_trace_by_stage(source, prefix: str = "agent/"
                         ) -> Dict[Tuple[str, str], float]:
    """{(kernel name, stage): summed device us} of a `torch.profiler` run
    on a card, the stage being the innermost `record_function` label that
    starts with `prefix` around the kernel's launch ('' outside any); a
    launch is matched to its kernel by correlation id."""
    events = _events(source)
    spans = collections.defaultdict(list)   # thread -> [(start, end, name)]
    launches = {}                           # correlation -> (thread, ts)
    for ev in events:
        if ev.get("ph") != "X":
            continue
        thread = (ev.get("pid"), ev.get("tid"))
        if ev.get("cat") == "user_annotation" and \
                ev.get("name", "").startswith(prefix):
            spans[thread].append((ev["ts"], ev["ts"] + ev.get("dur", 0.0),
                                  ev["name"]))
        elif ev.get("cat") == "cuda_runtime":
            corr = ev.get("args", {}).get("correlation")
            if corr is not None:
                launches[corr] = (thread, ev["ts"])
    out: Dict[Tuple[str, str], float] = collections.defaultdict(float)
    for ev in events:
        if ev.get("ph") != "X" or ev.get("cat") not in DEVICE_CATS:
            continue
        thread, ts = launches.get(ev.get("args", {}).get("correlation"),
                                  (None, None))
        inside = [s for s in spans.get(thread, ()) if s[0] <= ts <= s[1]]
        stage = max(inside, key=lambda s: s[0])[2] if inside else ""
        out[(ev["name"], stage)] += ev.get("dur", 0.0)
    return dict(out)


def per_class_ms(durs_us: Dict[str, float], iters: int = 1,
                 fusion_kinds: Optional[Dict[str, str]] = None
                 ) -> Dict[str, float]:
    """Device ms an iteration by `classify_op` class, largest first.
    `fusion_kinds` is lav_tpu's argument, accepted and ignored."""
    out: Dict[str, float] = collections.defaultdict(float)
    for name, us in durs_us.items():
        out[classify_op(name)] += us / 1000.0 / iters
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def count_flops(fn: Callable, *args) -> int:
    """FLOPs of one call of `fn(*args)` as FlopCounterMode counts them
    (PyTorch's operators only)."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*args)
    return counter.get_total_flops()


def roofline_summary(fn: Callable, args=(), iters: int = 4,
                     peak_flops: float = H100_PEAK_BF16_FLOPS,
                     peak_bytes: float = H100_PEAK_HBM_BYTES,
                     device=None) -> Dict:
    """Profile `iters` calls of `fn(*args)` on `device` (default the card
    where there is one) after one warm call, count one call's FLOPs, and
    put them together (lav_tpu's `roofline_summary`):
      classes_ms: device ms an iteration by op class
      device_ms: their sum
      hand_kernels: {name: {"ms", "flops": None}} of the port's kernels
      flops, gflops: a call's FLOPs outside the port's kernels; gbytes
        None
      achieved_tflops: those FLOPs over the device ms outside the port's
        kernels; mfu against `peak_flops`; hbm_gbs, hbm_util None
      device: where it ran; peak_card: whose peaks."""
    dev = torch.device(device if device is not None else
                       "cuda" if torch.cuda.is_available() else "cpu")
    fn(*args)
    synchronize()
    flops = count_flops(fn, *args)
    _, durs = profile_device(lambda: fn(*args), iters, dev)
    classes = per_class_ms(durs, iters)
    hand = {name: {"ms": round(us / 1000.0 / iters, 4), "flops": None}
            for name, us in sorted(durs.items(), key=lambda kv: -kv[1])
            if hand_class(name) is not None}
    device_ms = sum(classes.values())
    lib_s = (device_ms - sum(h["ms"] for h in hand.values())) / 1000.0
    achieved = flops / lib_s / 1e12 if lib_s > 0 else 0.0
    return {
        "classes_ms": {k: round(v, 3) for k, v in classes.items()},
        "device_ms": round(device_ms, 3),
        "hand_kernels": hand,
        "flops": flops,
        "gflops": round(flops / 1e9, 3),
        "gbytes": None,
        "achieved_tflops": round(achieved, 2),
        "hbm_gbs": None,
        "mfu": round(achieved * 1e12 / peak_flops, 4),
        "hbm_util": None,
        "device": card_line(dev),
        "peak_card": PEAK_CARD,
    }
