"""Two trees' builds of one kernel source, bit for bit and in turns.

    python3 -m lav_tpu_torch.utils.turns crop --parent DIR [--diagnose]
    python3 -m lav_tpu_torch.utils.turns conv --parent DIR

Run on a machine with a card, from the root of a checkout; DIR is another
checkout (for instance the parent commit unpacked with `git archive`).
Each source is built by `nvcc` into a library of its own under the
package's `_build/turns/` and its entries are called through `ctypes`
with the argument types of `native.ENTRIES`, so both builds run in one
process on one card.  The outputs of every build must equal the first build's
(`torch.equal`); then each build is timed in turns (first, ..., last,
last, ..., first), host-paced and device-only, as `chip_smoke.py` times.

crop: `csrc/crop_shared.cu`'s int8 and plain entries at the production
inputs (16 egos, bf16) and at the f32 agent's (4 egos, f32 source).
`--diagnose` adds three builds of DIR's source with a text change each
(the crop kernel as it was before the tiled int8 kernel): its stores kept
behind a test that never holds, one tap read instead of four, every tap
read from one address.  Their outputs differ, and are not compared.

conv: `csrc/conv2d_int8.cu` on the variant routes' transposed convs and
two production shapes, each build launched with the plan of its own
tree's `nn/quant.py` (`_plan_ints`).
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import torch

import chip_smoke as cs
from lav_tpu_torch.utils import native

OUT = native.BUILD_DIR / "turns"

# the crop kernel before the tiled int8 kernel (crop_shared_kernel's loop)
_STORE = "      reinterpret_cast<Vec<OutT, V>*>(op)[c] = r;"
_TAPS = ["    const T* r01 = r00 + C;",
         "    const T* r10 = r00 + (size_t)W * C;",
         "    const T* r11 = r10 + C;"]
DIAGNOSE = {
    "no stores": [(_STORE, """      if constexpr (kQ8) {
        int chk = 0;
        for (int i = 0; i < V; ++i) chk += (int)r.v[i];
        if (chk == H * 100003) reinterpret_cast<Vec<OutT, V>*>(op)[c] = r;
      } else {
        reinterpret_cast<Vec<OutT, V>*>(op)[c] = r;
      }""")],
    "one tap": [(t, t.split("=")[0] + "= r00;") for t in _TAPS],
    "fixed tap": [(t, t.split("=")[0] + "= r00;") for t in _TAPS] + [(
        "    const T* r00 = s + ((size_t)((int)y0f) * W + (int)x0f) * C;",
        "    const T* r00 = s;")],
}


def build(name: str, src: Path, subs=()):
    """nvcc `src` with the text changes `subs` into OUT/lib<name>.so."""
    text = src.read_text()
    for old, new in subs:
        if old not in text:
            raise ValueError(f"{name}: {old!r} is not in {src}")
        text = text.replace(old, new)
    OUT.mkdir(parents=True, exist_ok=True)
    tag = name.replace(" ", "_")
    cu, so = OUT / f"{tag}.cu", OUT / f"lib{tag}.so"
    cu.write_text(text)
    proc = subprocess.run([native._nvcc(), *native.NVCC_FLAGS, "-o", str(so),
                           str(cu)], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stdout}"
                           f"{proc.stderr}")
    return ctypes.CDLL(str(so))


def entry(lib, symbol, argtypes):
    fn = getattr(lib, symbol)
    fn.argtypes, fn.restype = [*argtypes, ctypes.c_void_p], ctypes.c_int
    return fn


def in_turns(runs: dict, label: str, compare=None) -> dict:
    """Check each run's output against the first's (for the names in
    `compare`), then time the runs in turns; prints and returns {name:
    [(device-only ms, host-paced ms), ...]}."""
    outs = {name: run() for name, run in runs.items()}
    torch.cuda.synchronize()
    first = next(iter(outs))
    for name in compare or outs:
        same = torch.equal(outs[name], outs[first])
        print(f"[{label}] {name}: output equal to {first}'s {same}",
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


def crop(parent: Path, diagnose: bool) -> dict:
    libs = {"parent": build("parent crop", parent / "lav_tpu_torch" /
                            "csrc" / "crop_shared.cu"),
            "this tree": build("this crop", native.CSRC_DIR /
                               "crop_shared.cu")}
    if diagnose:
        for name, subs in DIAGNOSE.items():
            libs[f"parent, {name}"] = build(
                f"parent {name}", parent / "lav_tpu_torch" / "csrc" /
                "crop_shared.cu", subs)
    dev = torch.device("cuda")
    res = {}
    for dtype, E in ((torch.bfloat16, cs.NUM_EGO_PROD),
                     (torch.float32, cs.NUM_EGO)):
        src, grid = cs._agent_crop_inputs(torch, dev, dtype, E=E)
        inv = (127.0 / src.float().abs().max()).reshape(1)
        B, H, W, C = src.shape
        _, K, Ho, Wo, _ = grid.shape
        dt = "bf16" if dtype == torch.bfloat16 else "f32"
        for form in ("q8", "q8_s2d", "plain"):
            symbol = f"crop_shared_{dt}" if form == "plain" else \
                f"crop_shared_{form}_{dt}"
            shape = ((B, K, Ho // 2, Wo // 2, 4 * C) if form == "q8_s2d"
                     else (B, K, Ho, Wo, C))
            runs = {}
            for name, lib in libs.items():
                if form == "plain" and name.startswith("parent, "):
                    continue
                fn = entry(lib, symbol, native.ENTRIES[symbol].argtypes)
                out = torch.empty(shape, device=dev, dtype=src.dtype
                                  if form == "plain" else torch.int8)
                ptrs = [src.data_ptr(), grid.data_ptr(), out.data_ptr()]
                if form != "plain":
                    ptrs.append(inv.data_ptr())

                def run(fn=fn, out=out, ptrs=ptrs):
                    err = fn(*ptrs, B, H, W, C, K, Ho, Wo,
                             16 // src.element_size(),
                             torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"{symbol}: cudaError {err}")
                    return out
                runs[name] = run
            label = f"crop {symbol}, {E} egos"
            res[label] = in_turns(runs, label, ["parent", "this tree"])
        del src, grid
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("kernel", choices=("crop", "conv"))
    ap.add_argument("--parent", required=True, type=Path,
                    help="the other checkout's root")
    ap.add_argument("--diagnose", action="store_true",
                    help="crop: add the old kernel's diagnostic builds")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("turns: no card", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    res = (crop(args.parent, args.diagnose) if args.kernel == "crop"
           else conv(args.parent))
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
