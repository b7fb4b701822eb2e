"""Two trees' builds of one kernel source, bit for bit and in turns.

    python3 -m lav_tpu_torch.utils.turns crop --parent DIR [--diagnose]
    python3 -m lav_tpu_torch.utils.turns conv --parent DIR
    python3 -m lav_tpu_torch.utils.turns scatter --parent DIR [--diagnose]
        [--variants]
    python3 -m lav_tpu_torch.utils.turns train --parent DIR [--variants]
    python3 -m lav_tpu_torch.utils.turns add --parent DIR

Run on a machine with a card, from the root of a checkout; DIR is another
checkout (for instance the parent commit unpacked with `git archive`).
Each source is built by `nvcc` into a library of its own under the
package's `_build/turns/` and its entries are called through `ctypes`
with the argument types of `native.ENTRIES`, so both builds run in one
process on one card.  The outputs of every build must equal the first build's
(`torch.equal`); then each build is timed in turns (first, ..., last,
last, ..., first), host-paced and device-only, as `chip_smoke.py` times.

crop: `csrc/crop_shared.cu`'s int8 entries at the production inputs (16
egos, bf16) and at the f32 agent's (4 egos, f32 source), and its plain
entries at their four shape families: the f32 agent's crops (4 egos,
160x160x384, 16 crops of 96x96) in f32 and in bf16, the BEV trainer's (64
x 320x320x9 f32, 5 crops of 192x192) and the distillation step's two C = 9
calls (4 x 320x320x9, 4 + 1 crops of 192x192) in f32 and in bf16, each
launched with the wrapper's `vec` (16 bytes of channels where C and the
pointers allow, else 1).  `--diagnose` adds a build of this tree's
source in which each piece of the plain forms' kernel (`crop_tiled`)
computes its pixel's setup again (`PLAIN_DIAGNOSE`); `--variants` builds
with one of its sizes changed (`PLAIN_VARIANTS`: the tile, blocks an
SM).  Every build's outputs must equal the parent's.

conv: `csrc/conv2d_int8.cu` on the variant routes' transposed convs and
two production shapes, each build launched with the plan of its own
tree's `nn/quant.py` (`_plan_ints`).

scatter: the canvas max, the parent's per-(point, channel pair) atomic
kernels (`scatter_max_bf16` in its `csrc/pillar_scatter.cu`, launched
into a zeroed canvas as its wrapper did; `pillar_scatter_max_{bf16,f32}`
in its `csrc/pillar_scatter_max.cu`, fill and finalize inside) against
this tree's `csrc/pillar_scatter_max.cu` with its scratch buffer: on
chip_smoke.py's phase ids (a fifth of the points in an in-range dump
row), on the ids the production agent hands `scatter_max` at tick 1 and
at the first full-ring tick (captured as chip_smoke.py's phase `scatter`
does; the parent also with the dump row in range, as its route had it),
and on one pillar of 5,000 points among the phase's others.
`--diagnose` adds builds of the parent's sources without their fill
(K3: the canvas not zeroed), without K2's finalize, and with a plain store
in place of the compare-and-swap loop or atomic; their outputs differ, and
are not compared.  `--variants` adds builds of this tree's source with one
of its choices undone (`SCATTER_VARIANTS`); their outputs must equal.

add: `scatter_add_f32` (`csrc/pillar_scatter.cu`), the parent's atomic
kernel (6 arguments, into a zeroed output, as its wrapper launched it)
against this tree's sorted one with its scratch buffer, on chip_smoke.py's
phase ids, its runs of 16 and the agent's ids at tick 1 and at the first
full-ring tick.  This tree's build must equal `scatter_add_plain` on the
CPU and itself on a second launch, bit for bit; the parent's sums differ
from run to run and are held to chip_smoke.py's rtol of the pillar's sum
of magnitudes.  On the same ids it reads the canvas max's counting sort
(`scatter_max`, keep_sort) from two launches: of the rows that hold 2
points or more, how many it lists out of index order and how many the two
launches list in different orders, which is whether that sort could serve
the in-order sums.

train: the distillation step's two backward kernels, in f32 and bf16,
each build launched with the arguments of `native.ENTRIES` (the contracts
are the parent's).  `crop_shared_bwd_{f32,bf16}` on the student's two
crop calls of a step (chip_smoke.py's `_student_crop_grids`, timed as a
pair) at the step's batch (4) and at lav_tpu's default (32); every build
adds each cell's terms in one fixed order, so all must be `torch.equal`.
`pillar_scatter_max_bwd_{f32,bf16}` on the inputs one step hands it
(chip_smoke.py's `_canvas_bwd_inputs`), on those repeated over 32 items,
and on a hot row of 5,000 points; `scatter_max_bwd_{bf16,f32}` on the
production tick's canvas (`_agent_scatter_inputs`); each on the forward's
sort and sorting itself, exact (NaN positions equal).  Each canvas input's
rows are counted, and each build's time is split by kernel
(`chip_smoke.device_split`).  `--variants` adds builds of this tree's
sources with one choice changed (`TRAIN_VARIANTS`), held to the same
equality.  Each build prints its kernels' registers and spills.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

import chip_smoke as cs
from lav_tpu_torch.utils import native

OUT = native.BUILD_DIR / "turns"

# crop_tiled (the plain forms) with each piece reading its pixel's grid
# point and computing its setup again, as the parent's threads did
# (`--diagnose`)
_READ = "    const int2 q = pq[pix];\n    if (q.y >= 0) {\n"
PLAIN_DIAGNOSE = {"setup per piece": [(_READ, """    int2 q = make_int2(0, -1);
    {
      const int y = ty0 + pix / TX, x = tx0 + pix % TX;
      float4 wv;
      if (y < Ho && x < Wo) {
        pixel_setup<T>(g, (reinterpret_cast<uintptr_t>(grid) & 7) == 0,
                       y * Wo + x, H, W, C, wv, q.x);
        q.y = wv.x < 0.0f ? -1 : (y * Wo + x) * C;
      }
    }
    if (q.y >= 0) {
""")]}
# crop_tiled with one of its sizes changed (`--variants`)
_SIZES = "constexpr int kTileX = 32, kNarrowTy = 8;"
_ROWS = "TY = V == 1 ? kNarrowTy : 1"
PLAIN_VARIANTS = {
    "16-pixel-wide tiles": [(_SIZES, _SIZES.replace("32", "16"))],
    "narrow: 4 rows": [(_SIZES, _SIZES.replace("8;", "4;"))],
    "vector: 8 rows": [(_ROWS + ",", _ROWS.replace(": 1", ": 8") + ","),
                       (_ROWS + ";", _ROWS.replace(": 1", ": 8") + ";")],
    "8 blocks an SM": [("kPlainBlocks = 4;", "kPlainBlocks = 8;")],
}


def build(name: str, src: Path, subs=()):
    """nvcc `src` with the text changes `subs` into OUT/lib<name>.so."""
    text = src.read_text()
    for old, new in subs:
        if old not in text:
            raise ValueError(f"{name}: {old!r} is not in {src}")
        text = text.replace(old, new)
    OUT.mkdir(parents=True, exist_ok=True)
    tag = re.sub(r"\W", "_", name)   # nvcc passes it on in key=value lists
    cu, so = OUT / f"{tag}.cu", OUT / f"lib{tag}.so"
    cu.write_text(text)
    proc = subprocess.run([native._nvcc(), *native.NVCC_FLAGS, "-o", str(so),
                           str(cu)], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stdout}"
                           f"{proc.stderr}")
    # ptxas -v: each kernel's registers and spills
    for m in re.finditer(r"Function properties for (\w+)\n(.*)\n.*?Used "
                         r"(\d+) registers", proc.stdout + proc.stderr):
        print(f"[build {name}] {m.group(1)[:90]}: {m.group(3)} registers, "
              f"{m.group(2).strip()}", flush=True)
    return ctypes.CDLL(str(so))


def entry(lib, symbol, argtypes):
    fn = getattr(lib, symbol)
    fn.argtypes, fn.restype = [*argtypes, ctypes.c_void_p], ctypes.c_int
    return fn


def in_turns(runs: dict, label: str, compare=None,
             agree=torch.equal) -> dict:
    """Check each run's output against the first's with `agree` (for the
    names in `compare`), then time the runs in turns; prints and returns
    {name: [(device-only ms, host-paced ms), ...]}."""
    outs = {name: run() for name, run in runs.items()}
    torch.cuda.synchronize()
    first = next(iter(outs))
    for name in compare or outs:
        same = agree(outs[name], outs[first])
        print(f"[{label}] {name}: output agrees with {first}'s {same}",
              flush=True)
        if not same:
            raise AssertionError(f"{label}: {name} differs from {first}")
    times = {name: [] for name in runs}
    for name in list(runs) + list(reversed(list(runs))):
        times[name].append((cs.device_ms(torch, runs[name]),
                            cs.cuda_ms(torch, runs[name], iters=20)))
    for name, t in times.items():
        print(f"[{label}] {name}: device-only " + " / ".join(
            f"{d:.4f}" for d, _ in t) + " ms, host-paced " + " / ".join(
            f"{h:.4f}" for _, h in t) + " ms", flush=True)
    return times


def _crop_families(dev):
    """The plain forms' shape families: {label: [(src, grid), ...]}, the
    calls timed together."""
    src = torch.randn((cs.NUM_EGO_TRAIN, 320, 320, 9),
                      generator=torch.Generator().manual_seed(11))
    step = cs._student_crop_grids(torch, dev, H=320, ppm=4.0, crop=192)
    return {
        "agent f32, 4 egos": [cs._agent_crop_inputs(torch, dev,
                                                    torch.float32)],
        "agent bf16, 4 egos": [cs._agent_crop_inputs(torch, dev,
                                                     torch.bfloat16)],
        "BEV trainer, 64 x 320x320x9 f32": [cs._bev_crop_inputs(torch, dev)],
        "the step's C = 9 calls, f32": [(src.to(dev), g) for g in step],
        "the step's C = 9 calls, bf16": [(src.to(dev, torch.bfloat16), g)
                                         for g in step]}


def _plain_run(lib, calls):
    """A run of `lib`'s plain entry on each (src, grid) of `calls`, with
    the wrapper's vec rule, into outputs of its own."""
    dev = calls[0][0].device
    launches = []
    for src, grid in calls:
        B, H, W, C = src.shape
        _, K, Ho, Wo, _ = grid.shape
        symbol = "crop_shared_" + ("bf16" if src.dtype == torch.bfloat16
                                   else "f32")
        fn = entry(lib, symbol, native.ENTRIES[symbol].argtypes)
        out = torch.empty((B, K, Ho, Wo, C), device=dev, dtype=src.dtype)
        vmax = 16 // src.element_size()
        vec = vmax if (C % vmax == 0 and src.data_ptr() % 16 == 0
                       and out.data_ptr() % 16 == 0) else 1
        launches.append((fn, out, (src.data_ptr(), grid.data_ptr(),
                                   out.data_ptr(), B, H, W, C, K, Ho, Wo,
                                   vec)))

    def run():
        for fn, out, args in launches:
            err = fn(*args, torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"crop_shared: cudaError {err}")
        return [out for _, out, _ in launches]
    return run


def crop(parent: Path, diagnose: bool, with_variants: bool) -> dict:
    libs = {"parent": build("parent crop", parent / "lav_tpu_torch" /
                            "csrc" / "crop_shared.cu"),
            "this tree": build("this crop", native.CSRC_DIR /
                               "crop_shared.cu")}
    variants = {}
    for name, subs in {**(PLAIN_DIAGNOSE if diagnose else {}),
                       **(PLAIN_VARIANTS if with_variants else {})}.items():
        variants[f"this tree, {name}"] = build(
            f"this {name}", native.CSRC_DIR / "crop_shared.cu", subs)
    dev = torch.device("cuda")
    res = {}
    for dtype, E in ((torch.bfloat16, cs.NUM_EGO_PROD),
                     (torch.float32, cs.NUM_EGO)):
        src, grid = cs._agent_crop_inputs(torch, dev, dtype, E=E)
        inv = (127.0 / src.float().abs().max()).reshape(1)
        B, H, W, C = src.shape
        _, K, Ho, Wo, _ = grid.shape
        dt = "bf16" if dtype == torch.bfloat16 else "f32"
        for form in ("q8", "q8_s2d"):
            symbol = f"crop_shared_{form}_{dt}"
            shape = ((B, K, Ho // 2, Wo // 2, 4 * C) if form == "q8_s2d"
                     else (B, K, Ho, Wo, C))
            runs = {}
            for name, lib in libs.items():
                fn = entry(lib, symbol, native.ENTRIES[symbol].argtypes)
                out = torch.empty(shape, device=dev, dtype=torch.int8)
                ptrs = [src.data_ptr(), grid.data_ptr(), out.data_ptr(),
                        inv.data_ptr()]

                def run(fn=fn, out=out, ptrs=ptrs):
                    err = fn(*ptrs, B, H, W, C, K, Ho, Wo,
                             16 // src.element_size(),
                             torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"{symbol}: cudaError {err}")
                    return out
                runs[name] = run
            label = f"crop {symbol}, {E} egos"
            res[label] = in_turns(runs, label)
        del src, grid
        torch.cuda.empty_cache()
    for label, calls in _crop_families(dev).items():
        runs = {name: _plain_run(lib, calls)
                for name, lib in {**libs, **variants}.items()}
        label = f"crop_shared {label}"
        res[label] = in_turns(runs, label, agree=lambda a, b: all(
            torch.equal(x, y) for x, y in zip(a, b)))
        del calls, runs
        torch.cuda.empty_cache()
    return res


def conv(parent: Path) -> dict:
    from lav_tpu_torch.nn import quant

    spec = importlib.util.spec_from_file_location(
        "parent_quant", parent / "lav_tpu_torch" / "nn" / "quant.py")
    parent_quant = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(parent_quant)
    trees = {"parent": (build("parent conv", parent / "lav_tpu_torch" /
                              "csrc" / "conv2d_int8.cu"),
                        parent_quant._plan_ints),
             "this tree": (build("this conv", native.CSRC_DIR /
                                 "conv2d_int8.cu"), quant._plan_ints)}
    shapes = [(name, N, H, W, C, O, k, (1, 1), pads, (lhs, lhs))
              for name, N, H, W, C, O, k, pads, lhs, _, t
              in cs._variant_conv_shapes() if t is not None]
    shapes += [(name, N, H, W, C, O, k, (st, st), ((p, p), (p, p)), (1, 1))
               for name, N, H, W, C, O, k, st, p, _
               in cs._conv_int8_shapes()
               if name in ("planner.layer4.3x3", "lidar.heads")]
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(5)
    res = {}
    for name, N, H, W, C, O, k, stride, pads, lhs in shapes:
        xq = torch.randint(-127, 128, (N, H, W, C), generator=g,
                           dtype=torch.int8, device=dev)
        w = torch.randint(-127, 128, (O, k, k, C), generator=g,
                          dtype=torch.int8, device=dev)
        w_scale = torch.rand((O,), generator=g, device=dev) * 1e-3 + 1e-4
        s_x = torch.tensor([0.02], device=dev)
        runs = {}
        for tree, (lib, plan_ints) in trees.items():
            fn = entry(lib, "conv2d_int8_bf16",
                       native.ENTRIES["conv2d_int8_bf16"].argtypes)
            OH, OW, plan = plan_ints(N, H, W, C, O, k, k, stride, pads,
                                     (1, 1), lhs, 132)
            out = torch.empty((N, OH, OW, O), dtype=torch.bfloat16,
                              device=dev)

            def run(fn=fn, out=out, plan=plan):
                err = fn(xq.data_ptr(), w.data_ptr(), w_scale.data_ptr(),
                         s_x.data_ptr(), None, out.data_ptr(),
                         ctypes.cast(plan, ctypes.c_void_p),
                         torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"conv2d_int8: cudaError {err}")
                return out
            runs[tree] = run
        res[name] = in_turns(runs, f"conv {name}")
    return res


_CAS = "    atomic_max_bf16x2(out + s * half + c, v);"
_FILLS = ["  fill_kernel<<<blocks_for(n_out), kThreads, 0, st>>>(o, n_out);",
          "  fill_bf16x2_kernel<<<blocks_for(n_out), kThreads, 0, st>>>(o, "
          "n_out);"]
_FINALIZES = [f.replace("fill", "finalize") for f in _FILLS]
# per diagnostic build: the text changes of the parent's two sources
SCATTER_DIAGNOSE = {
    "no fill": {"pillar_scatter": [], "pillar_scatter_max": [
        (f, "") for f in _FILLS]},
    "no finalize": {"pillar_scatter_max": [(f, "") for f in _FINALIZES]},
    "no atomics": {
        "pillar_scatter": [(_CAS, "    out[s * half + c] = v;")],
        "pillar_scatter_max": [
            (_CAS, "    out[s * half + c] = v;"),
            ("    atomic_max_float(out + s * C + c, v);",
             "    out[s * C + c] = v;")]},
}
_LOOP4 = "  for (; k + 3 * step < end; k += 4 * step) {"
_PEERS = ("  const unsigned peers = __match_any_sync(active, s);\n"
          "  const int lane = threadIdx.x & 31, leader = __ffs(peers) - 1;")
# this tree's canvas max with one choice changed: the histogram's warp
# aggregation (only the warp's least and greatest ids grouped, or none),
# the rows kernel's register cap (6 blocks an SM, not 8), four loads in
# flight (eight), a hot chunk's 32 points a group (64), and the hot
# threshold of 64 points (32, 128)
SCATTER_VARIANTS = {
    "least and greatest ids grouped": [(_PEERS, """  const int lane = threadIdx.x & 31;
  const int lo = (int)__reduce_min_sync(active, (unsigned)s);
  const int hi = (int)__reduce_max_sync(active, (unsigned)s);
  const unsigned at_lo = __ballot_sync(active, s == lo);
  const unsigned at_hi = __ballot_sync(active, s == hi);
  const unsigned peers = s == lo ? at_lo : s == hi ? at_hi : 1u << lane;
  const int leader = __ffs(peers) - 1;"""), (
        "  base = __shfl_sync(peers, base, leader);",
        "  base = __shfl_sync(active, base, leader);")],
    "no ids grouped": [(_PEERS, "  const int lane = threadIdx.x & 31;\n"
                        "  const unsigned peers = 1u << lane;\n"
                        "  const int leader = lane;")],
    "6 blocks an SM": [("__launch_bounds__(kThreads, 8) rows_kernel",
                        "__launch_bounds__(kThreads) rows_kernel")],
    "8 loads in flight": [(_LOOP4, """  for (; k + 7 * step < end; k += 8 * step) {
    int q[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) q[i] = __ldg(a.idx + k + i * step);
    Piece<W> v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = load<W, false>(f + q[i] * rb);
#pragma unroll
    for (int i = 0; i < 8; ++i) acc.add(v[i]);
  }
""" + _LOOP4)],
    "64 points a group": [("constexpr int kGroupPoints = 32;",
                           "constexpr int kGroupPoints = 64;")],
    "hot above 32": [("constexpr int kHot = 64;", "constexpr int kHot = 32;")],
    "hot above 128": [("constexpr int kHot = 64;",
                       "constexpr int kHot = 128;")],
}
# this tree's backward kernels with one choice changed: the crop
# gradient's tile (4 x 4 cells a block), its hits in flight (2 in f32, 1 in
# bf16), the early ask for a hit's g row, the bf16 products' rounding in
# pairs and the map pass's 1024 threads; the canvas gradient's rows kernel
# (f32: a row's first sorted position walks the row; bf16: each sorted
# position its own point), the bf16 rows' register cap (4 blocks an SM:
# 64) and a bf16 row's loads in flight (2)
_TILE = "constexpr int kTileX = 4, kTileY = 4;"
_WALK = "static constexpr bool kWalkRows = "
TRAIN_VARIANTS = {
    "2 x 2 cells a block": ("crop_shared_bwd", [(
        _TILE, "constexpr int kTileX = 2, kTileY = 2;")]),
    "8 x 4 cells a block": ("crop_shared_bwd", [(
        _TILE, "constexpr int kTileX = 8, kTileY = 4;")]),
    "two hits in flight": ("crop_shared_bwd", [(
        "constexpr int kHitsInFlight[2] = {2, 1};",
        "constexpr int kHitsInFlight[2] = {2, 2};")]),
    "no early ask for g rows": ("crop_shared_bwd", [(
        "prefetch_l1(row + o);", "continue;")]),
    "one rounding a product": ("crop_shared_bwd", [(
        "if constexpr (V::kBf16 && V::kN % 2 == 0)",
        "if constexpr (false)")]),
    "map: 256 threads": ("crop_shared_bwd", [(
        "constexpr int kMapThreads = 1024;",
        "constexpr int kMapThreads = 256;")]),
    "f32: each sorted position its point": ("pillar_scatter_max", [(
        _WALK + "true;", _WALK + "false;")]),
    "bf16: a row's first position walks it": ("pillar_scatter_max", [(
        _WALK + "false;", _WALK + "true;")]),
    "bf16: rows held to 8 blocks an SM": ("pillar_scatter_max", [(
        "__launch_bounds__(kThreads, 4) max_bwd_points",
        "__launch_bounds__(kThreads, 8) max_bwd_points")]),
    "bf16 row: 4 loads in flight": ("pillar_scatter_max", [(
        "kHotInFlight = 4, kRowInFlight = 2;",
        "kHotInFlight = 4, kRowInFlight = 4;")]),
}
# the parent's scatter entries without a scratch buffer: feat, pid, out,
# n_points, C, segments
_PARENT_SCATTER = (ctypes.c_void_p,) * 3 + (ctypes.c_longlong, ctypes.c_int,
                                            ctypes.c_longlong)
# the parent's source of each canvas-max entry
_PARENT_SOURCE = {"scatter_max_bf16": "pillar_scatter",
                  "pillar_scatter_max_bf16": "pillar_scatter_max",
                  "pillar_scatter_max_f32": "pillar_scatter_max"}


def _scatter_inputs(dev):
    """{label: (feat, pid, S, the parent's S, entries)} of the canvas max:
    chip_smoke.py's phase ids of `scatter` (K3-max and K2-bf16 on the
    same post-ReLU payloads) and of `pillar` (K2-bf16, K2 f32), the
    5,000-point pillar, and the agent's ids."""
    from lav_tpu_torch.ops.pillar import NEG

    both = ("scatter_max_bf16", "pillar_scatter_max_bf16")
    E, P, G = cs.NUM_EGO_PROD, 2 * cs.MAX_POINTS_PROD * 3, 320 * 320
    g = torch.Generator(device="cpu").manual_seed(4)
    local = torch.randint(0, G // 8, (E, P), generator=g)
    invalid = torch.rand((E, P), generator=g) < 0.2
    pid = torch.where(invalid, torch.full_like(local, E * G),
                      local + torch.arange(E)[:, None] * G).reshape(-1)
    feat = torch.relu(torch.randn((E * P, 64), generator=g))
    hot = pid.clone()
    hot[100000:105000] = 17
    ins = {"phase ids": (feat, pid, E * G + 1),
           "one pillar of 5000 points": (feat, hot, E * G + 1)}
    ins = {k: (f.to(dev, torch.bfloat16), p.to(dev, torch.int32), s, s,
               both) for k, (f, p, s) in ins.items()}
    for label, (f, p, s) in cs._agent_scatter_inputs(
            torch, {"device": "cuda"})["max"].items():
        ins[f"agent {label}"] = (f, p, s, s, both)
        ins[f"agent {label}, dump row in range"] = (f, p, s + 1, s + 1, both)
    # phase pillar's: masked points at NEG in the per-item dump slots
    for name, E, P, seed, spread, dtype in (
            ("pillar_scatter_max_bf16", cs.NUM_EGO_PROD,
             2 * cs.MAX_POINTS_PROD * 3, 6, 8, torch.bfloat16),
            ("pillar_scatter_max_f32", cs.NUM_EGO, 2 * cs.MAX_POINTS * 3, 2,
             4, torch.float32)):
        S = G + 1
        g = torch.Generator(device="cpu").manual_seed(seed)
        f = torch.randn((E, P, 64), generator=g)
        local = torch.randint(0, G // spread, (E, P), generator=g)
        invalid = torch.rand((E, P), generator=g) < 0.2
        local[invalid] = G
        f[invalid] = NEG
        p = (local + torch.arange(E)[:, None] * S).reshape(-1)
        ins[f"pillar phase ids, {E} egos"] = (
            f.reshape(-1, 64).to(dev, dtype), p.to(dev, torch.int32), E * S,
            E * S, (name,))
    return ins


def scatter(parent: Path, diagnose: bool, variants: bool) -> dict:
    from lav_tpu_torch.ops.pillar import canvas_scratch_bytes

    psrc = parent / "lav_tpu_torch" / "csrc"
    here = native.CSRC_DIR / "pillar_scatter_max.cu"
    trees = {"parent": {s: build(f"parent {s}", psrc / f"{s}.cu")
                        for s in ("pillar_scatter", "pillar_scatter_max")},
             "this tree": build("this canvas max", here)}
    if diagnose:
        for name, subs in SCATTER_DIAGNOSE.items():
            trees[f"parent, {name}"] = {
                s: build(f"parent {name} {s}", psrc / f"{s}.cu", sub)
                for s, sub in subs.items()}
    same = ["parent", "this tree"]
    if variants:
        for name, subs in SCATTER_VARIANTS.items():
            trees[f"this tree, {name}"] = build(f"this {name}", here, subs)
            same.append(f"this tree, {name}")
    dev = torch.device("cuda")
    res = {}
    for label, (feat, pid, S, parent_S, symbols) in _scatter_inputs(
            dev).items():
        N, C = feat.shape
        for symbol in symbols:
            runs = {}
            for name, lib in trees.items():
                if name.startswith("this tree"):
                    fn = entry(lib, symbol, native.ENTRIES[symbol].argtypes)
                    out = torch.empty((S, C), dtype=feat.dtype, device=dev)
                    # twice this tree's layout: a variant's may be larger
                    scratch = torch.empty(2 * canvas_scratch_bytes(
                        N, C, S, feat.element_size()), dtype=torch.uint8,
                        device=dev)
                    args = (N, C, S, scratch.data_ptr(), scratch.numel())
                    zero = False
                else:
                    source = _PARENT_SOURCE[symbol]
                    if source not in lib:
                        continue
                    fn = entry(lib[source], symbol, _PARENT_SCATTER)
                    out = torch.empty((parent_S, C), dtype=feat.dtype,
                                      device=dev)
                    args = (N, C, parent_S)
                    zero = (source == "pillar_scatter"
                            and name != "parent, no fill")

                def run(fn=fn, out=out, args=args, zero=zero):
                    if zero:
                        out.zero_()
                    err = fn(feat.data_ptr(), pid.data_ptr(), out.data_ptr(),
                             *args, torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"{symbol}: cudaError {err}")
                    return out[:S]
                runs[name] = run
            key = f"{symbol}, {label}"
            res[key] = in_turns(runs, key, same)
        del feat, pid
        torch.cuda.empty_cache()
    return res


def _add_inputs(dev):
    """{label: (feat, pid, S)} of `scatter_add`: chip_smoke.py's phase ids
    (xyz of the valid points and a count lane, a fifth in the dump row),
    its runs of 16 and the agent's ids."""
    E, P, G = cs.NUM_EGO_PROD, 2 * cs.MAX_POINTS_PROD * 3, 320 * 320
    g = torch.Generator(device="cpu").manual_seed(4)
    local = torch.randint(0, G // 8, (E, P), generator=g)
    invalid = torch.rand((E, P), generator=g) < 0.2
    pid = torch.where(invalid, torch.full_like(local, E * G),
                      local + torch.arange(E)[:, None] * G)
    run = torch.arange(E * P).reshape(E, P) // 16
    hot = (run % 10 < 3) & ~invalid
    runs = torch.where(hot, (run % 64) * 97 + torch.arange(E)[:, None] * G,
                       pid)
    xyz = torch.rand((E * P, 3), generator=g) * 60.0 - 20.0
    keep = ~invalid.reshape(-1, 1)
    feat = torch.cat([torch.where(keep, xyz, 0.0), keep.float()], dim=-1)
    ins = {label: (feat.to(dev), p.reshape(-1).to(dev, torch.int32),
                   E * G + 1)
           for label, p in (("phase ids", pid), ("runs of 16", runs))}
    for label, args in cs._agent_scatter_inputs(
            torch, {"device": "cuda"})["add"].items():
        ins[f"agent {label}"] = args
    return ins


def scatter_add(parent: Path) -> dict:
    from lav_tpu_torch.ops.pillar import (
        scatter_add_plain, scatter_add_scratch_bytes,
    )

    libs = {"this tree": build("this pillar_scatter",
                               native.CSRC_DIR / "pillar_scatter.cu"),
            "parent": build("parent pillar_scatter", parent / "lav_tpu_torch"
                            / "csrc" / "pillar_scatter.cu")}
    dev = torch.device("cuda")
    res = {}
    for label, (feat, pid, S) in _add_inputs(dev).items():
        N, C = feat.shape
        runs = {}
        for name, lib in libs.items():
            mine = name == "this tree"
            fn = entry(lib, "scatter_add_f32", native.ENTRIES[
                "scatter_add_f32"].argtypes if mine else _PARENT_SCATTER)
            out = torch.empty((S, C), device=dev)
            scratch = torch.empty(scatter_add_scratch_bytes(N, S),
                                  dtype=torch.uint8, device=dev)
            extra = (scratch.data_ptr(), scratch.numel()) if mine else ()

            def go(fn=fn, out=out, extra=extra):
                out.zero_()   # both wrappers zero the output
                err = fn(feat.data_ptr(), pid.data_ptr(), out.data_ptr(), N,
                         C, S, *extra, torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"scatter_add_f32: cudaError {err}")
                return out
            runs[name] = go
        ref = scatter_add_plain(feat.cpu(), pid.cpu(), S)
        mag = scatter_add_plain(feat.cpu().abs(), pid.cpu(), S)
        first = runs["this tree"]().clone()
        again = runs["this tree"]().cpu()
        old = runs["parent"]().cpu()
        n_max = int(ref[:, 3].max())
        rtol = max(cs.SCATTER_ADD_RTOL, 2 * (n_max - 1) * 2.0 ** -24)
        excess = ((old - ref).abs() - rtol * mag).max().item()
        print(f"[add, {label}] this tree equals the plain version "
              f"{torch.equal(first.cpu(), ref)}, itself on a second launch "
              f"{torch.equal(first.cpu(), again)}; the parent's worst excess "
              f"over {rtol:.2e} x sum|v| {excess:.3e}", flush=True)
        if not (torch.equal(first.cpu(), ref) and torch.equal(
                first.cpu(), again)) or excess > 0:
            raise AssertionError(f"scatter_add {label}: outputs disagree")
        # checked above: the parent's sums are not bit-reproducible
        res[label] = in_turns(runs, f"add, {label}", compare=("this tree",))
        order = _canvas_order(feat, pid, S)
        print(f"[add, {label}] the canvas max's counting sort on these ids: "
              f"{order}", flush=True)
        res[label]["canvas_sort"] = order
        del feat, pid, first
        torch.cuda.empty_cache()
    return res


def _canvas_order(feat, pid, S: int) -> dict:
    """The canvas max's sort of (feat, pid) from two launches of
    `scatter_max(..., keep_sort=True)`: the rows holding 2 points or more,
    those it lists out of index order, and those the two launches list in
    different orders."""
    from lav_tpu_torch.ops.pillar import read_canvas_sort, scatter_max

    N, C = feat.shape
    lists = [read_canvas_sort(scatter_max(feat, pid, S, keep_sort=True)[1],
                              N, C, S, feat.element_size())
             for _ in range(2)]
    (off, a), (_, b) = [(o.cpu(), i.cpu()) for o, i in lists]
    cnt = off[1:] - off[:-1]
    row = torch.repeat_interleave(torch.arange(S), cnt)
    down = (row[1:] == row[:-1]) & (a[1:] < a[:-1])
    return dict(rows_2_or_more=int((cnt >= 2).sum()),
                out_of_index_order=int(torch.unique(row[1:][down]).numel()),
                differ_between_launches=int(
                    torch.unique(row[a != b]).numel()))


def build_many(specs: dict) -> dict:
    """`build` of each {name: (src, subs)}, one `nvcc` each, all at once."""
    with ThreadPoolExecutor(max_workers=len(specs) or 1) as pool:
        futures = {name: pool.submit(build, name, src, subs)
                   for name, (src, subs) in specs.items()}
        return {name: f.result() for name, f in futures.items()}


def _crop_bwd_run(lib, symbol, calls, H, W):
    """A run of `lib`'s crop_shared_bwd entry on each (g, grid) of `calls`,
    with its map scratch, into outputs of its own."""
    fn = entry(lib, symbol, native.ENTRIES[symbol].argtypes)
    launches = []
    for g, grid in calls:
        B, K, Ho, Wo, C = g.shape
        out = torch.empty((B, H, W, C), device=g.device, dtype=g.dtype)
        cmap = torch.empty((B * K, 8), device=g.device)
        launches.append((out, cmap, (g.data_ptr(), grid.data_ptr(),
                                     out.data_ptr(), cmap.data_ptr(), B, H,
                                     W, C, K, Ho, Wo,
                                     16 // g.element_size())))

    def run():
        for _, _, args in launches:
            err = fn(*args, torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"{symbol}: cudaError {err}")
        return [out for out, _, _ in launches]
    return run


def _canvas_bwd_run(lib, symbol, g, feat, pid, canvas, sort):
    """A run of `lib`'s canvas-max backward entry: on the forward's sort
    where `sort` is given, else sorting itself in a scratch of its own."""
    from lav_tpu_torch.ops.pillar import canvas_scratch_bytes

    (N, C), S = feat.shape, canvas.shape[0]
    fn = entry(lib, symbol, native.ENTRIES[symbol].argtypes)
    buf = sort if sort is not None else torch.empty(
        canvas_scratch_bytes(N, C, S, feat.element_size()),
        dtype=torch.uint8, device=feat.device)
    out = torch.empty_like(feat)

    def run():
        err = fn(g.data_ptr(), feat.data_ptr(), pid.data_ptr(),
                 canvas.data_ptr(), out.data_ptr(), N, C, S, buf.data_ptr(),
                 buf.numel(), int(sort is not None),
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{symbol}: cudaError {err}")
        return out
    return run


def _split(runs: dict, label: str) -> None:
    """Each run's device-only ms by kernel (`chip_smoke.device_split`)."""
    for name, run in runs.items():
        split = cs.device_split(torch, run)
        print(f"[{label}] {name}: by kernel " + ", ".join(
            f"{re.split(r'[<(]', k.replace('(anonymous namespace)::', '').replace('void ', ''))[0]} {v:.4f}"
            for k, v in sorted(split.items(), key=lambda kv: -kv[1]))
            + " ms", flush=True)


def _exact(a, b) -> bool:
    """Equal, NaN positions included (`torch.equal` is False on NaN)."""
    try:
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)
    except AssertionError:
        return False
    return True


def _tiled_canvas(args, n: int):
    """The step's canvas inputs (g, feat, pid, canvas, sort) repeated over
    n batches of items (B x n): each copy's ids moved past the last's
    rows, dropped ids kept dropped; g drawn anew, the canvas and its sort
    from this tree's forward."""
    from lav_tpu_torch.ops.pillar import pillar_scatter_max

    _, feat, pid, canvas, _ = args
    S = canvas.shape[0]
    p = pid.long()
    ok = (p >= 0) & (p < S)
    pid_n = torch.cat([torch.where(ok, p + i * S, n * S)
                       for i in range(n)]).to(torch.int32)
    feat_n = feat.repeat(n, 1)
    canvas_n, sort_n = pillar_scatter_max(feat_n, pid_n, n * S,
                                          keep_sort=True)
    gen = torch.Generator(device=feat.device).manual_seed(14)
    g = torch.randn(canvas_n.shape, generator=gen, device=feat.device).to(
        feat.dtype)
    return g, feat_n, pid_n, canvas_n, sort_n


def _canvas_stats(label, feat, pid, S) -> None:
    """Rows and points of a canvas input: what the backward walks."""
    p = pid.long()
    ok = (p >= 0) & (p < S)
    n = torch.bincount(p[ok], minlength=S)
    n = n[n > 0]
    hist = {f"{lo}-{hi}": int(((n >= lo) & (n <= hi)).sum())
            for lo, hi in ((1, 1), (2, 4), (5, 16), (17, 64), (65, 1 << 30))}
    print(f"[{label}] {feat.shape[0]} points, {int((~ok).sum())} dropped, "
          f"{n.numel()} touched rows of {S}, most points a row "
          f"{int(n.max())}, rows by points {hist}, points in rows above "
          f"64: {int(n[n > 64].sum())}", flush=True)


def train(parent: Path, variants: bool) -> dict:
    from lav_tpu_torch.ops.pillar import scatter_max

    psrc = parent / "lav_tpu_torch" / "csrc"
    dev = torch.device("cuda")
    here = {src: native.CSRC_DIR / f"{src}.cu"
            for src in ("crop_shared_bwd", "pillar_scatter_max")}
    specs = {"parent crop bwd": (psrc / "crop_shared_bwd.cu", ()),
             "this crop bwd": (here["crop_shared_bwd"], ()),
             "parent canvas max": (psrc / "pillar_scatter_max.cu", ()),
             "this canvas max": (here["pillar_scatter_max"], ())}
    for name, (src, subs) in TRAIN_VARIANTS.items() if variants else ():
        specs[f"this {name}"] = (here[src], subs)
    built = build_many(specs)
    crop_libs = {"parent": built["parent crop bwd"],
                 "this tree": built["this crop bwd"]}
    canvas_libs = {"parent": built["parent canvas max"],
                   "this tree": built["this canvas max"]}
    for name, (src, _) in TRAIN_VARIANTS.items() if variants else ():
        libs = crop_libs if src == "crop_shared_bwd" else canvas_libs
        libs[f"this tree, {name}"] = built[f"this {name}"]
    res = {}

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(a, b))

    # the crop's source gradient, a step's two calls (K_TRAIN crops, then
    # the ego's), at the step's batch and at lav_tpu's default
    H = W = 160
    gen = torch.Generator(device=dev).manual_seed(8)
    for B in (cs.NUM_EGO_TRAIN, cs.B_REF):
        grids = cs._student_crop_grids(torch, dev, B=B)
        gs = [torch.randn(tuple(gr.shape[:4]) + (384,), generator=gen,
                          device=dev) for gr in grids]
        for dt, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            calls = [(g.to(dtype), gr) for g, gr in zip(gs, grids)]
            symbol = f"crop_shared_bwd_{dt}"
            runs = {name: _crop_bwd_run(lib, symbol, calls, H, W)
                    for name, lib in crop_libs.items()}
            label = f"{symbol}, a step's two calls at B = {B}"
            res[label] = in_turns(runs, label, agree=same)
            _split({k: v for k, v in runs.items()
                    if not k.startswith("this tree, ")}, label)
            del calls, runs
            torch.cuda.empty_cache()
        del gs, grids
        torch.cuda.empty_cache()

    # the canvas max's gradient: the inputs one step hands it (f32, bf16),
    # the same at B_REF, a hot row, and the production eval canvas
    # (scatter_max_bwd, zero-init)
    cases = []
    for dt, dtype in (("f32", None), ("bf16", torch.bfloat16)):
        step = cs._canvas_bwd_inputs(torch, {"device": "cuda"}, dtype)
        e = "pillar_scatter_max_bwd_" + dt
        cases.append((e, f"the step's, B = {cs.NUM_EGO_TRAIN}", step))
        cases.append((e, f"the step's x {cs.B_REF // cs.NUM_EGO_TRAIN}, "
                      f"B = {cs.B_REF}",
                      _tiled_canvas(step, cs.B_REF // cs.NUM_EGO_TRAIN)))
        hot = [c for c in cs._canvas_bwd_cases(torch, dev, dtype)
               if c[0] == "a hot row of 5000 points"][0]
        cases.append((e, hot[0], hot[1:]))
    agent = cs._agent_scatter_inputs(torch, {"device": "cuda"})["max"]
    tick, (feat, pid, S) = [(k, v) for k, v in agent.items()
                            if k != "tick 1"][0]
    for dt, f in (("bf16", feat), ("f32", feat.float())):
        canvas, sort = scatter_max(f, pid, S, keep_sort=True)
        g = torch.randn((S, f.shape[1]), generator=gen, device=dev).to(
            f.dtype)
        cases.append((f"scatter_max_bwd_{dt}", f"production {tick}",
                      (g, f, pid, canvas, sort)))
    del agent, feat, pid
    for symbol, label, (g, feat, pid, canvas, sort) in cases:
        key = f"{symbol}, {label}"
        _canvas_stats(key, feat, pid, canvas.shape[0])
        runs = {}
        for name, lib in canvas_libs.items():
            runs[f"{name}, on the forward's sort"] = _canvas_bwd_run(
                lib, symbol, g, feat, pid, canvas, sort)
            runs[f"{name}, standalone"] = _canvas_bwd_run(
                lib, symbol, g, feat, pid, canvas, None)
        res[key] = in_turns(runs, key, agree=_exact)
        _split({k: v for k, v in runs.items() if k.endswith("sort")}, key)
        del runs
        torch.cuda.empty_cache()
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("kernel", choices=("crop", "conv", "scatter", "train",
                                       "add"))
    ap.add_argument("--parent", required=True, type=Path,
                    help="the other checkout's root")
    ap.add_argument("--diagnose", action="store_true",
                    help="crop: add this tree's plain crop with one "
                    "choice undone; scatter: the parent kernel's "
                    "diagnostic builds")
    ap.add_argument("--variants", action="store_true",
                    help="crop, scatter, train: add this tree's kernels "
                    "with one choice changed in each build")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("turns: no card", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    res = (crop(args.parent, args.diagnose, args.variants)
           if args.kernel == "crop"
           else scatter(args.parent, args.diagnose, args.variants)
           if args.kernel == "scatter" else train(args.parent, args.variants)
           if args.kernel == "train" else scatter_add(args.parent)
           if args.kernel == "add" else conv(args.parent))
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
