"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` has a plain C interface and is compiled by `nvcc`
into `_build/lib<name>.so` inside the package (listed in `.gitignore`) the
first time a wrapper needs it, then loaded with `ctypes`.  `build_all`
starts one `nvcc` per source, all at once.  A library is rebuilt when its
source is newer.

`LAUNCHES` counts, per kernel, the wrapper calls that launched it on the
card; `reset_launches` sets every count to 0.  A source may hold several
kernels (`pillar_scatter.cu` holds the zero-init max and the add), and a
kernel's forms are counted apart where a path must show which one ran
(`crop_shared_q8_s2d`, `pillar_scatter_max_bf16`).
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

SOURCES = ("crop_shared", "pillar_scatter_max", "pillar_scatter",
           "conv2d_int8", "take_along_rows")
KERNELS = (
    "crop_shared", "crop_shared_q8", "crop_shared_q8_s2d",  # crop_shared.cu
    "pillar_scatter_max", "pillar_scatter_max_bf16",  # pillar_scatter_max.cu
    "scatter_max", "scatter_add",                     # pillar_scatter.cu
    "conv2d_int8",                                    # conv2d_int8.cu
    "take_along_rows",                                # take_along_rows.cu
)
LAUNCHES = {name: 0 for name in KERNELS}

_libs: dict = {}
_lock = threading.Lock()


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


def load(name: str) -> ctypes.CDLL:
    """The loaded library of source `name`, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            if _stale(name):
                build_all((name,))
            lib = ctypes.CDLL(str(_lib_path(name)))
            _libs[name] = lib
        return lib


def check(err: int, what: str) -> None:
    """Raise if a launch returned a non-zero cudaError_t."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")
