"""The port's one launch path (lav_tpu_torch/utils/native.py), on the CPU.

No nvcc and no card are needed: the C entries' signatures are read from
the sources in csrc/ and held against the declared argument types; a stub
library of Python callbacks stands in for a built one, so that loading,
argument passing (a pointer above 2^32 must arrive whole), the stream,
the launch count and the error check can be exercised.
"""

import ctypes
import re
import types

import pytest
import torch

from lav_tpu_torch.utils import device as device_mod
from lav_tpu_torch.utils import native

_C_TYPES = {"long long": ctypes.c_longlong, "int": ctypes.c_int}


def _c_signatures():
    """{symbol: [ctypes type per parameter]} of every extern "C" entry in
    csrc/*.cu: a pointer of any type is c_void_p."""
    sigs = {}
    for src in native.CSRC_DIR.glob("*.cu"):
        for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)',
                                       src.read_text()):
            sigs[name] = [ctypes.c_void_p if "*" in p else
                          _C_TYPES[" ".join(p.split()[:-1])]
                          for p in params.split(",")]
    return sigs


def test_entries_match_the_c_sources():
    sigs = _c_signatures()
    assert set(sigs) == set(native.ENTRIES)
    for symbol, entry in native.ENTRIES.items():
        assert entry.source in native.SOURCES and entry.kernel in \
            native.LAUNCHES
        assert (native.CSRC_DIR / f"{entry.source}.cu").read_text().count(
            f'extern "C" int {symbol}(') == 1
        # every entry takes the stream last, as a pointer
        assert [*entry.argtypes, ctypes.c_void_p] == sigs[symbol], symbol


def test_the_backward_entries_are_declared_as_their_sources_define_them():
    """The distillation step's two backward kernels: crop_shared_bwd_f32
    (g, grid, d_src, map, B, H, W, C, K, Ho, Wo, vec) in its own source,
    and pillar_scatter_max_bwd_f32 (g, feat, pid, canvas, d_feat, n_points,
    C, segments, scratch, scratch_bytes, sorted) beside the canvas max it
    differentiates."""
    sigs = _c_signatures()
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    crop = native.ENTRIES["crop_shared_bwd_f32"]
    canvas = native.ENTRIES["pillar_scatter_max_bwd_f32"]
    assert (crop.source, crop.kernel) == ("crop_shared_bwd", "crop_shared_bwd")
    assert (canvas.source, canvas.kernel) == ("pillar_scatter_max",
                                              "pillar_scatter_max_bwd")
    assert sigs["crop_shared_bwd_f32"] == [P] * 4 + [I] * 8 + [P]
    assert sigs["pillar_scatter_max_bwd_f32"] == [P] * 5 + [LL, I, LL, P, LL,
                                                            I, P]



def test_the_bf16_backward_entries_are_declared_beside_the_f32_ones():
    """The bf16 forms of the two backward kernels take the f32 forms'
    arguments, live in the same sources and are counted apart, so that a
    bf16 step shows it ran them."""
    sigs = _c_signatures()
    for kernel in ("crop_shared_bwd", "pillar_scatter_max_bwd"):
        f32 = native.ENTRIES[f"{kernel}_f32"]
        bf16 = native.ENTRIES[f"{kernel}_bf16"]
        assert bf16.source == f32.source and bf16.argtypes == f32.argtypes
        assert (f32.kernel, bf16.kernel) == (kernel, f"{kernel}_bf16")
        assert sigs[f"{kernel}_bf16"] == sigs[f"{kernel}_f32"]

def test_the_zero_init_backward_entries_take_the_neg_init_ones_arguments():
    """scatter_max_bwd_{f32,bf16}, the gradient of the zero-init canvas
    max (the production eval route), live beside pillar_scatter_max_bwd in
    the canvas max's source, take its arguments (the sort of
    scatter_max's own scratch among them) and are counted as one kernel,
    as scatter_max's two forms are."""
    sigs = _c_signatures()
    neg = native.ENTRIES["pillar_scatter_max_bwd_f32"]
    for dt in ("f32", "bf16"):
        e = native.ENTRIES[f"scatter_max_bwd_{dt}"]
        assert (e.source, e.kernel) == ("pillar_scatter_max",
                                        "scatter_max_bwd")
        assert e.argtypes == neg.argtypes
        assert sigs[f"scatter_max_bwd_{dt}"] == sigs[
            "pillar_scatter_max_bwd_f32"]
    assert native.ENTRIES["scatter_max_f32"].kernel == "scatter_max"
    assert "scatter_max_bwd" in native.LAUNCHES


class _StubLib:
    """Stands in for a loaded kernel library: each symbol is a C function
    pointer to a Python callback that reads every argument as a 64-bit
    integer (pointers, long longs and the stream; an int is checked in its
    low 32 bits) and returns `self.err`."""

    def __init__(self, path):
        self.path, self.calls, self.err, self._keep = path, [], 0, []

    def __getattr__(self, symbol):
        if symbol.startswith("_"):
            raise AttributeError(symbol)
        n = len(native.ENTRIES[symbol].argtypes) + 1
        proto = ctypes.CFUNCTYPE(ctypes.c_int, *[ctypes.c_uint64] * n)

        def body(*args):
            self.calls.append((symbol, args))
            return self.err

        cb = proto(body)
        self._keep.append(cb)
        fn = ctypes.CFUNCTYPE(ctypes.c_int)(
            ctypes.cast(cb, ctypes.c_void_p).value)
        setattr(self, symbol, fn)   # CDLL caches its function pointers too
        return fn


@pytest.fixture
def stub(monkeypatch):
    """native with every library replaced by a _StubLib; the entries and
    counts are restored afterwards."""
    saved = {s: e.fn for s, e in native.ENTRIES.items()}
    libs = {}

    def open_stub(path):
        libs[path] = _StubLib(path)
        return libs[path]

    monkeypatch.setattr(native, "_open", open_stub)
    monkeypatch.setattr(native, "_stale", lambda name: False)
    monkeypatch.setattr(native, "_libs", {})
    monkeypatch.setattr(native, "LAUNCHES", dict.fromkeys(native.KERNELS, 0))
    for e in native.ENTRIES.values():
        e.fn = None
    yield libs
    for s, e in native.ENTRIES.items():
        e.fn = saved[s]


def test_load_resolves_each_entry_once_with_64_bit_pointers(stub):
    for source in native.SOURCES:
        lib = native.load(source)
        assert native.load(source) is lib             # loaded once
    assert len(stub) == len(native.SOURCES)
    for symbol, entry in native.ENTRIES.items():
        fn = entry.fn
        assert fn is not None, symbol
        assert fn.argtypes == [*entry.argtypes, ctypes.c_void_p], symbol
        assert fn.restype is ctypes.c_int
        for t, want in zip(fn.argtypes, _c_signatures()[symbol]):
            assert t is want
            assert ctypes.sizeof(t) == (4 if t is ctypes.c_int else 8)


def _fake_stream(monkeypatch, index=0, handle=0x7F00DEADBEEF):
    """Device `index` is current; every device's current stream is
    `handle`."""
    monkeypatch.setattr(torch.cuda, "current_device", lambda: index)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d=None:
                        types.SimpleNamespace(device_index=d,
                                              cuda_stream=handle))


def test_launch_passes_pointers_whole_and_counts(stub, monkeypatch):
    _fake_stream(monkeypatch)
    entry = native.ENTRIES["take_along_rows_b32"]
    ptrs = (0x7F12_3456_7890, 0x5_0000_0010, 0xFFFF_FFFF_FFF0)
    native.launch(entry, 0, *ptrs, 25600, 25600, 128)
    (symbol, args), = next(iter(stub.values())).calls
    assert symbol == "take_along_rows_b32"
    assert args == (*ptrs, 25600, 25600, 128, 0x7F00DEADBEEF)
    assert native.LAUNCHES["take_along_rows"] == 1
    # an int argument (C of the scatters) in its low 32 bits
    scatter = native.ENTRIES["scatter_add_f32"]
    native.launch(scatter, 0, 0x7F00_0000_1000, 0x7F00_0000_2000,
                  0x7F00_0000_3000, 960000, 4, 16 * 102400 + 1,
                  0x7F00_0000_4000, 1 << 34)
    lib = stub[str(native._lib_path("pillar_scatter"))]
    args = lib.calls[-1][1]
    assert args[:4] == (0x7F00_0000_1000, 0x7F00_0000_2000,
                        0x7F00_0000_3000, 960000)
    assert args[4] & 0xFFFFFFFF == 4 and args[5:] == (
        16 * 102400 + 1, 0x7F00_0000_4000, 1 << 34, 0x7F00DEADBEEF)
    assert native.LAUNCHES["scatter_add"] == 1
    native.reset_launches()
    assert not any(native.LAUNCHES.values())


def test_launch_raises_with_the_kernel_name_and_does_not_count(stub,
                                                               monkeypatch):
    _fake_stream(monkeypatch)
    entry = native.ENTRIES["conv2d_int8_bf16"]
    native.load(entry.source).err = 700    # cudaErrorIllegalAddress
    with pytest.raises(RuntimeError, match=r"conv2d_int8 .*cudaError 700"):
        native.launch(entry, 0, *[1 << 40] * 6, None)
    assert native.LAUNCHES["conv2d_int8"] == 0


def test_launch_enters_another_device_only_when_it_differs(stub,
                                                           monkeypatch):
    _fake_stream(monkeypatch, index=0)
    entered = []

    class Guard:
        def __init__(self, d):
            self.d = d

        def __enter__(self):
            entered.append(self.d)

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.cuda, "device", Guard)
    entry = native.ENTRIES["crop_shared_f32"]
    native.launch(entry, 0, 1, 2, 3, *[8] * 8)
    assert entered == []
    native.launch(entry, 1, 1, 2, 3, *[8] * 8)
    assert entered == [1]
    assert native.LAUNCHES["crop_shared"] == 2


def test_cuda_request_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for asked in ("cuda", None):
        with pytest.raises(RuntimeError, match="CUDA"):
            device_mod.resolve_device(asked)
    assert device_mod.resolve_device("cpu").type == "cpu"


def test_launch_without_a_card_raises(stub):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the launch would run")
    with pytest.raises((RuntimeError, AssertionError)):
        native.launch(native.ENTRIES["take_along_rows_b16"], 0, 1, 2, 3, 8,
                      8, 128)
    assert not any(native.LAUNCHES.values())


def _layout_total(n, rows, row_bytes):
    """csrc/pillar_scatter_max.cu's `Layout` total and constants
    (`_layout_scope`)."""
    scope, consts = _layout_scope(n, rows, row_bytes)
    return scope["total"], consts


def _layout_scope(n, rows, row_bytes):
    """csrc/pillar_scatter_max.cu's `Layout` constructor, read from the
    source and run in Python (integer arithmetic, every operand >= 0) ->
    (every field it sets, the source's constants)."""
    src = (native.CSRC_DIR / "pillar_scatter_max.cu").read_text()
    consts = {k: int(v) for k, v in re.findall(
        r"constexpr (?:int|size_t) (k\w+) = (\d+);", src)}
    body = src[src.index("  Layout(long long n"):]
    body = body[body.index("{") + 1:body.index("\n  }")]
    scope = dict(consts, n=n, rows=rows, row_bytes=row_bytes, at=0)

    def take(nbytes):
        start = scope["at"]
        scope["at"] = -(-(start + nbytes) // consts["kAlign"]) * \
            consts["kAlign"]
        return start

    scope["take"] = take
    for code in re.sub(r"//[^\n]*", "", body).split(";"):
        code = code.strip()
        if not code:
            continue
        code = re.sub(r"\((?:int|size_t)\)", "", code)
        code = re.sub(r"(\d+)ull", r"\1", code).replace("/", "//")
        exec(code, {}, scope)
    return scope, consts


@pytest.mark.parametrize("n,C,rows,elem", [
    (960000, 64, 16 * 102400, 2),       # the production canvas, bf16
    (196608, 64, 4 * 102401, 4),        # the f32 agent's, per-item slots
    (0, 64, 10000, 2),                  # no point
    (20000, 2, 10000, 4),
    (20000, 66, 10000, 2),
])
def test_canvas_scratch_bytes_covers_the_kernel_layout(n, C, rows, elem):
    from lav_tpu_torch.ops import pillar as P

    total, consts = _layout_total(n, rows, C * elem)
    assert (consts["kTile"], consts["kHot"], consts["kGroupPoints"],
            consts["kAlign"]) == (P.CANVAS_TILE, P.CANVAS_HOT,
                                  P.CANVAS_GROUP_POINTS, P.CANVAS_ALIGN)
    assert P.canvas_scratch_bytes(n, C, rows, elem) == total
