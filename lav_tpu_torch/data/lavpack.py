"""ctypes bindings for the native lavstore (.lavpack) episode format
(counterpart of `lav_tpu/data/lavpack.py`).

The C++ store (`native/lavstore.cpp`) replaces LAV's LMDB dependency:
write-once episode packs, mmap'd zero-copy reads, O(log n) key lookup.
`LavPackStore` plugs into `data.store.Episode` like any other byte store,
and `convert_episode` re-packs an existing episode (LMDB or synthetic)
into the native format.

The shared library is built at first use from the repository's
`native/lavstore.cpp` with `native/Makefile`'s flags (g++ only; a plain C
ABI through ctypes) into the gitignored `lav_tpu_torch/_build/`, as the
CUDA sources are; `native/` itself is only read.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading
from typing import Optional

_REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
SOURCE = os.path.join(_REPO, "native", "lavstore.cpp")
BUILD_DIR = os.path.join(_REPO, "lav_tpu_torch", "_build")
LIB_PATH = os.path.join(BUILD_DIR, "liblavstore.so")
CXXFLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-shared")

_lib = None
_lock = threading.Lock()


def build() -> str:
    """Compile `native/lavstore.cpp` into LIB_PATH (to a temporary name,
    then renamed, so that a concurrent loader never maps half a file)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(["g++", *CXXFLAGS, "-o", tmp, SOURCE], check=True,
                       capture_output=True, text=True)
        os.replace(tmp, LIB_PATH)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return LIB_PATH


def _load_lib():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if (not os.path.exists(LIB_PATH)
                or os.path.getmtime(LIB_PATH) < os.path.getmtime(SOURCE)):
            build()
        lib = ctypes.CDLL(LIB_PATH)
        vp, cp, u64 = ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64
        for name, res, args in (
                ("lavstore_open", vp, [cp]),
                ("lavstore_get", ctypes.c_int,
                 [vp, cp, ctypes.POINTER(vp), ctypes.POINTER(u64)]),
                ("lavstore_count", u64, [vp]),
                ("lavstore_key_at", ctypes.c_int,
                 [vp, u64, ctypes.POINTER(cp)]),
                ("lavstore_close", None, [vp]),
                ("lavwriter_open", vp, [cp]),
                ("lavwriter_put", ctypes.c_int, [vp, cp, cp, u64]),
                ("lavwriter_finish", ctypes.c_int, [vp])):
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = res, args
        _lib = lib
        return lib


class LavPackStore:
    """Read-only mmap'd store with the byte-store get() interface."""

    def __init__(self, path: str):
        self._lib = _load_lib()
        self._h = self._lib.lavstore_open(path.encode())
        if not self._h:
            raise IOError(f"cannot open lavpack: {path}")

    def get(self, key: bytes) -> Optional[bytes]:
        data = ctypes.c_void_p()
        size = ctypes.c_uint64()
        rc = self._lib.lavstore_get(
            self._h, key, ctypes.byref(data), ctypes.byref(size))
        if rc != 0:
            return None
        return ctypes.string_at(data, size.value)

    def keys(self):
        n = self._lib.lavstore_count(self._h)
        out = []
        key = ctypes.c_char_p()
        for i in range(n):
            self._lib.lavstore_key_at(self._h, i, ctypes.byref(key))
            out.append(key.value)
        return out

    def close(self):
        if self._h:
            self._lib.lavstore_close(self._h)
            self._h = None

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass


class LavPackWriter:
    def __init__(self, path: str):
        self._lib = _load_lib()
        self._h = self._lib.lavwriter_open(path.encode())
        if not self._h:
            raise IOError(f"cannot create lavpack: {path}")

    def put(self, key: bytes, value: bytes):
        rc = self._lib.lavwriter_put(self._h, key, value, len(value))
        if rc != 0:
            raise IOError("lavpack write failed")

    def finish(self):
        rc = self._lib.lavwriter_finish(self._h)
        self._h = None
        if rc != 0:
            raise IOError("lavpack finalize failed")


def convert_episode(episode, out_path: str, keys=None):
    """Re-pack an Episode's store into .lavpack.  For DictStore episodes all
    keys are taken; for LMDB pass an explicit key list."""
    w = LavPackWriter(out_path)
    if keys is None:
        keys = sorted(episode.store._d.keys())  # DictStore
    for k in keys:
        v = episode.store.get(k)
        if v is not None:
            w.put(k, v)
    w.finish()
    return out_path
