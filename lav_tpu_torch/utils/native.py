"""Build, load and launch the port's CUDA kernels.

Each `csrc/<name>.cu` has a plain C interface and is compiled by `nvcc`
into `_build/lib<name>.so` inside the package (listed in `.gitignore`) the
first time a wrapper needs it, then loaded with `ctypes`.  `build_all`
starts one `nvcc` per source, all at once.  A library is rebuilt when its
source is newer.

Every C entry is declared once, in `ENTRIES`, with its argument types:
`c_void_p` for pointers and the stream (64 bits; a bare Python int would
pass as a 32-bit C int and cut the pointer), `c_longlong` / `c_int` for
sizes.  Every entry returns its `cudaError_t` and takes the stream last.
`SOURCES` and `KERNELS` are read off `ENTRIES`, so a new entry is one line.
When a library loads, each of its entries is resolved into a `ctypes`
callable with those types set, kept on the `Entry`.  `launch` is the one
path from a wrapper to the card: it passes PyTorch's current stream of the
tensors' device (entering that device only when it is not the current
one), raises with the kernel's name on a launch error, and counts the
launch.

`LAUNCHES` counts, per kernel, the wrapper calls that launched it on the
card; `reset_launches` sets every count to 0.

`torch.export` traces with fake tensors, which have no `data_ptr()`, so
each forward kernel of the agent tick is also a `torch.library` custom op
in the `lav_tpu_torch` namespace (`custom_op`), whose implementation is
the wrapper's own launch (the plain version on CPU tensors) and whose
fake gives the output's shape and dtype.  A wrapper calls its op only
while `exporting()` is on (agent/export.py turns it on around the trace),
so the exported program calls the ops, and eager ticks keep the direct
call, which costs the host less.  A source may hold several
kernels (`pillar_scatter_max.cu` holds the NEG-init and the zero-init
canvas max and their gradients), and a kernel's forms are counted apart
where a path must show which one ran (`crop_shared_q8_s2d`,
`pillar_scatter_max_bf16`, and the bf16 backward kernels
`crop_shared_bwd_bf16`, `pillar_scatter_max_bwd_bf16`).
"""

from __future__ import annotations

import contextlib
import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


class Entry:
    """C entry `symbol` of lib<source>.so, counted as kernel `kernel`;
    `argtypes` are its arguments before the stream.  `fn` is the `ctypes`
    callable, set when the library loads."""

    __slots__ = ("source", "symbol", "kernel", "argtypes", "fn")

    def __init__(self, source: str, symbol: str, kernel: str, argtypes):
        self.source, self.symbol, self.kernel = source, symbol, kernel
        self.argtypes = tuple(argtypes)
        self.fn = None


_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# feat, pid, out, n_points, C, segments, a scratch buffer and its bytes
_CANVAS = (_P, _P, _P, _LL, _I, _LL, _P, _LL)
ENTRIES = {e.symbol: e for e in (
    # src, grid, out, B, H, W, C, K, Ho, Wo, vec; the q8 forms take inv_s
    # after out
    *(Entry("crop_shared", f"crop_shared_{dt}", "crop_shared",
            (_P,) * 3 + (_I,) * 8) for dt in ("f32", "bf16")),
    *(Entry("crop_shared", f"{k}_{dt}", k, (_P,) * 4 + (_I,) * 8)
      for k in ("crop_shared_q8", "crop_shared_q8_s2d")
      for dt in ("f32", "bf16")),
    Entry("pillar_scatter_max", "pillar_scatter_max_f32",
          "pillar_scatter_max", _CANVAS),
    Entry("pillar_scatter_max", "pillar_scatter_max_bf16",
          "pillar_scatter_max_bf16", _CANVAS),
    Entry("pillar_scatter_max", "scatter_max_bf16", "scatter_max", _CANVAS),
    Entry("pillar_scatter_max", "scatter_max_f32", "scatter_max", _CANVAS),
    Entry("pillar_scatter", "scatter_add_f32", "scatter_add", _CANVAS),
    # g, grid, d_src, map (8 floats a crop), B, H, W, C, K, Ho, Wo, vec
    *(Entry("crop_shared_bwd", f"crop_shared_bwd_{dt}", k,
            (_P,) * 4 + (_I,) * 8)
      for dt, k in (("f32", "crop_shared_bwd"),
                    ("bf16", "crop_shared_bwd_bf16"))),
    # g, feat, pid, canvas, d_feat, n_points, C, segments, the canvas max's
    # scratch and its bytes, whether it holds the forward's sort; the
    # NEG-init canvas' gradient, then the zero-init one's
    *(Entry("pillar_scatter_max", f"pillar_scatter_max_bwd_{dt}", k,
            (_P,) * 5 + (_LL, _I, _LL, _P, _LL, _I))
      for dt, k in (("f32", "pillar_scatter_max_bwd"),
                    ("bf16", "pillar_scatter_max_bwd_bf16"))),
    *(Entry("pillar_scatter_max", f"scatter_max_bwd_{dt}", "scatter_max_bwd",
            (_P,) * 5 + (_LL, _I, _LL, _P, _LL, _I)) for dt in ("f32", "bf16")),
    # x, w, w_scale, x_scale, bias (or NULL), out, plan (int[591])
    *(Entry("conv2d_int8", f"conv2d_int8_{dt}", "conv2d_int8", (_P,) * 7)
      for dt in ("bf16", "f32")),
    # x, idx, out, S, M, L
    *(Entry("take_along_rows", f"take_along_rows_{b}", "take_along_rows",
            (_P,) * 3 + (_LL,) * 3) for b in ("b32", "b16")),
)}
# the sources and the counted kernels, in the order of their first entry
SOURCES = tuple(dict.fromkeys(e.source for e in ENTRIES.values()))
KERNELS = tuple(dict.fromkeys(e.kernel for e in ENTRIES.values()))
LAUNCHES = {name: 0 for name in KERNELS}


_libs: dict = {}
_lock = threading.Lock()
_open = ctypes.CDLL


EXPORTING = False


@contextlib.contextmanager
def exporting():
    """Route the kernel wrappers through their custom ops meanwhile."""
    global EXPORTING
    prev, EXPORTING = EXPORTING, True
    try:
        yield
    finally:
        EXPORTING = prev


def custom_op(name: str, impl, fake):
    """`impl` registered as torch.ops.lav_tpu_torch.<name>, returning new
    tensors (no input is mutated), with `fake` as its fake implementation;
    impl's annotations give the schema."""
    op = torch.library.custom_op(f"lav_tpu_torch::{name}", impl,
                                 mutates_args=())
    op.register_fake(fake)
    return op


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    lib = _lib_path(name)
    src = CSRC_DIR / f"{name}.cu"
    return not lib.exists() or lib.stat().st_mtime < src.stat().st_mtime


def build_all(names=SOURCES) -> dict:
    """Compile every stale kernel in parallel; returns {name: ptxas log}.
    Raises with the compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in names:
        if not _stale(name):
            continue
        tmp = BUILD_DIR / f"lib{name}.{os.getpid()}.so"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs, failed = {}, []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        logs[name] = out
        (BUILD_DIR / f"{name}.log").write_text(out)
        if proc.returncode != 0:
            failed.append(f"{name}:\n{out}")
        else:
            tmp.replace(_lib_path(name))
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def load(name: str):
    """The loaded library of source `name`, built first if needed; its
    entries are resolved with their argument types as it loads."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            if _stale(name):
                build_all((name,))
            lib = _open(str(_lib_path(name)))
            for entry in ENTRIES.values():
                if entry.source == name:
                    fn = getattr(lib, entry.symbol)
                    fn.argtypes = [*entry.argtypes, _P]
                    fn.restype = ctypes.c_int
                    entry.fn = fn
            _libs[name] = lib
        return lib


def launch(entry: Entry, device: int, *args) -> None:
    """Launch `entry` with `args` (pointers as ints, sizes) on PyTorch's
    current stream of CUDA device index `device`.  Raises with the kernel's
    name if the launch returns an error; counts it otherwise."""
    fn = entry.fn
    if fn is None:
        load(entry.source)
        fn = entry.fn
    # the cheapest public reads: the current device, then that device's
    # current stream (chip_smoke.py phase `gather` times the options)
    if device == torch.cuda.current_device():
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    else:
        with torch.cuda.device(device):
            err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err:
        raise RuntimeError(f"{entry.kernel} ({entry.symbol}): CUDA launch "
                           f"failed with cudaError {err}")
    LAUNCHES[entry.kernel] += 1
