"""Reduce a `torch.profiler` trace of the card to what the per-layer
readers need.  `classify_op`, `HAND_CLASSES` and the stage attribution are
frozen copies of the port's `utils/roofline.py` (`classify_op`,
`parse_trace`, `parse_trace_by_stage`); the program contributes only its
kernel names (the C entries of `utils/native.py` and the `__global__`
functions of its `csrc/` sources)."""

from __future__ import annotations

import collections
import functools
import json
import os
import re
import tempfile
from pathlib import Path

# each csrc source's kernels fall in one class, apart from the library's
HAND_CLASSES = {"crop_shared": "hand_crop", "crop_shared_bwd": "hand_crop",
                "pillar_scatter_max": "hand_scatter",
                "pillar_scatter": "hand_scatter",
                "conv2d_int8": "hand_conv_int8",
                "take_along_rows": "hand_gather"}

# the library's kernels, tested in order; first match wins
_CLASSES = (
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
_HAND = re.compile(r"^(?:void )?(?:\(anonymous namespace\)::)?"
                   r"(\w+)(?=<|\(|$)")
_GLOBAL = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\s*\("
                     r"(?:[^()]|\([^()]*\))*\)\s*)?(\w+)\s*\(")

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@functools.lru_cache(maxsize=None)
def hand_sources() -> dict:
    """{C entry or `__global__` function name: csrc source} of the
    program's kernels."""
    from lav_tpu_torch.utils import native

    out = {sym: e.source for sym, e in native.ENTRIES.items()}
    for src in Path(native.CSRC_DIR).glob("*.cu"):
        out.update((name, src.stem) for name in _GLOBAL.findall(
            src.read_text()))
    return out


def hand_source(name: str):
    """The csrc source of a kernel of the program, by its name as the
    profiler shows it; None for any other kernel."""
    m = _HAND.match(name)
    return hand_sources().get(m.group(1)) if m else None


def classify_op(name: str) -> str:
    src = hand_source(name)
    if src is not None:
        return HAND_CLASSES.get(src, "hand_other")
    for cls, pat in _CLASSES:
        if pat.search(name):
            return cls
    return "other"


def chrome_trace(prof) -> dict:
    """The Chrome trace of a finished profile, through a file in TMPDIR."""
    fd, path = tempfile.mkstemp(suffix=".json", prefix="lavbench_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)
    finally:
        os.remove(path)


def _union(intervals):
    """Merged [start, end) intervals, sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def summarize(trace: dict, window_us: float, units: int,
              prefix: str = "agent/") -> dict:
    """What the readers take from a trace of `units` ticks or steps that
    lasted `window_us` on the host clock:
      device: [(name, class, source, stage, us)] one per device event,
        the stage the innermost `record_function` label starting with
        `prefix` around its launch ('' outside any)
      busy_us: the union of the device events' intervals
      window_us, units
      idle_gaps: {host operation: us} of the device's idle time inside
        the trace's span of device activity, by the innermost host
        operation running at each gap's middle."""
    events = [ev for ev in trace.get("traceEvents", [])
              if ev.get("ph") == "X"]
    spans = collections.defaultdict(list)
    host_ops = []
    launches = {}
    for ev in events:
        thread = (ev.get("pid"), ev.get("tid"))
        cat = ev.get("cat")
        if cat == "user_annotation" and ev.get("name", "").startswith(prefix):
            spans[thread].append((ev["ts"], ev["ts"] + ev.get("dur", 0.0),
                                  ev["name"]))
        if cat == "cuda_runtime":
            corr = ev.get("args", {}).get("correlation")
            if corr is not None:
                launches[corr] = (thread, ev["ts"])
        if cat in ("cpu_op", "user_annotation", "python_function"):
            host_ops.append((thread, ev["ts"], ev["ts"] + ev.get("dur", 0.0),
                             ev.get("name", "?")))
    device, intervals = [], []
    for ev in events:
        if ev.get("cat") not in DEVICE_CATS:
            continue
        name, dur = ev.get("name", "?"), ev.get("dur", 0.0)
        thread, ts = launches.get(ev.get("args", {}).get("correlation"),
                                  (None, None))
        inside = [s for s in spans.get(thread, ()) if ts is not None
                  and s[0] <= ts <= s[1]]
        stage = max(inside, key=lambda s: s[0])[2] if inside else ""
        device.append((name, classify_op(name), hand_source(name), stage,
                       dur))
        intervals.append((ev["ts"], ev["ts"] + dur))
    merged = _union(intervals)
    busy = sum(e - s for s, e in merged)
    gaps = collections.defaultdict(float)
    mids = [((a + b) / 2.0, b - a) for (_, a), (b, _) in
            zip(merged, merged[1:])]
    for (mid, gap), label in zip(mids, _innermost(host_ops, mids)):
        gaps[label] += gap
    return dict(device=device, busy_us=busy, window_us=window_us,
                units=units, idle_gaps=dict(gaps))


def _innermost(host_ops, mids):
    """For each (time, _) of `mids`, in order, the name of the shortest
    host operation running at that time on any thread (the forward's
    thread and autograd's); the operations of one thread nest."""
    by_thread = collections.defaultdict(list)
    for thread, s, e, name in host_ops:
        by_thread[thread].append((s, -e, name))
    best = [(float("inf"), "(no host operation)")] * len(mids)
    for ops in by_thread.values():
        ops.sort()
        stack, i = [], 0
        for k, (t, _) in enumerate(mids):
            while i < len(ops) and ops[i][0] <= t:
                s, neg_e, name = ops[i]
                while stack and stack[-1][0] <= s:
                    stack.pop()
                stack.append((-neg_e, name, s))
                i += 1
            while stack and stack[-1][0] < t:
                stack.pop()
            if stack and stack[-1][0] - stack[-1][2] < best[k][0]:
                best[k] = (stack[-1][0] - stack[-1][2], stack[-1][1])
    return [name for _, name in best]


def breakdown(summary: dict) -> dict:
    """The result line's `breakdown`: the ten device operations that took
    most time and the ten largest idle-gap labels, in seconds."""
    ops = collections.defaultdict(float)
    for name, *_, us in summary["device"]:
        ops[name] += us
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(summary["idle_gaps"].items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n, us / 1e6] for n, us in top],
            "idle_gaps": [[n, us / 1e6] for n, us in gaps]}


def roofline_pct(ctx, source: str, least_key: str):
    """A function's least time a unit (`ctx["least"][least_key]`) over the
    device time a unit of the kernels of csrc source `source`, in %; None
    where the trace holds no such kernel or nothing was counted."""
    s, least = ctx["summary"], ctx["least"]
    us = sum(d[-1] for d in s["device"] if d[2] == source) if s else 0
    if not us or not least or not least[least_key]:
        return None
    return 100.0 * least[least_key] / (us / 1e6 / s["units"])
