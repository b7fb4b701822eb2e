#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (lav_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py                     # every phase, one card
    python3 chip_smoke.py --phases build,crop # a subset, for bring-up

Phases, each printing its own line and raising on failure:
  build   the card's name and power limit; nvcc builds every kernel
  crop    kernel crop_shared against its plain version at the agent's
          shapes (4 egos, 160x160x384 source, 16 crops of 96x96), f32 and
          bf16, with crops straddling the border and wholly outside
  pillar  kernel pillar_scatter_max against its plain version at the
          agent's shapes (4 x 49152 points, 64 channels, 4 x 102401
          pillars) with masked points, duplicate ids, empty pillars and
          negative values; must be exact
  agent   the full-width v2 agent (3 cameras 288x256, telephoto 192x480,
          8192 points per sweep) for 4 egos and 3 ticks on the card: both
          kernels launched, controls finite and in range, ticks 1-2 of
          ego 0 equal to the port's CPU run within the stated tolerance
  profile (only when asked for) one warm tick of that agent under
          torch.profiler: device time per agent stage, the device's busy
          share of the tick, and the kernels that take the most time

TF32 is off for every phase (cuDNN and matmul), so f32 means f32.  The
next-to-last line is {"kernels": [...]}; the last is
{"ok": true, "device": {...}}.  Without a card, or outside a checkout of
the repository, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import time

ALL_PHASES = ("build", "crop", "pillar", "agent")
EXTRA_PHASES = ("profile",)
NUM_EGO = 4
MAX_POINTS = 8192
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA data sheet
F32_FLOPS = 67e12           # H100 SXM non-tensor f32

# tolerances, each with its reason
CROP_F32_ATOL = 1e-5        # same f32 arithmetic; FMA contraction only
CROP_BF16_ULPS = 1.0        # both round one f32 sum; FMA may flip 1 ulp
AGENT_ATOL = 1e-3           # cuDNN vs CPU conv summation order, f32
AGENT_RTOL = 1e-3


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def cuda_ms(torch, fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean device time of fn() in ms, from CUDA events around `iters` runs."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, flops: float = 0.0):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_build(ctx):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    ctx["smi"] = smi.stdout.strip().splitlines()[0] if smi.stdout else "?"
    print(ctx["smi"], flush=True)
    from lav_tpu_torch.utils import native

    t0 = time.perf_counter()
    logs = native.build_all()
    for name, out in logs.items():
        regs = [ln.strip() for ln in out.splitlines() if "registers" in ln]
        log("build", f"{name}: {'; '.join(regs) or 'built'}")
    log("build", f"nvcc built {sorted(logs) or 'nothing (up to date)'} in "
        f"{time.perf_counter() - t0:.1f} s")


def _agent_crop_inputs(torch, dev, dtype):
    """Source maps and grids as the agent builds them: K detections plus
    the ego crop per ego, some straddling the border, one far outside."""
    from lav_tpu_torch.core.warp import affine_grid, crop_theta

    g = torch.Generator(device="cpu").manual_seed(1)
    E, H, C, K1, crop = NUM_EGO, 160, 384, 16, 96
    src = torch.randn((E, H, H, C), generator=g).to(dev, dtype)
    locs = (torch.rand((E, K1, 2), generator=g) * 2 - 1) * 15.0
    locs[:, 0] = torch.tensor([38.0, -39.0])   # straddles the border
    locs[:, 1] = torch.tensor([1e3, -1e3])     # wholly outside
    locs[:, -1] = 0.0                          # the ego crop
    oris = (torch.rand((E, K1), generator=g) * 2 - 1) * math.pi
    oris[:, -1] = 0.0
    theta = crop_theta(locs.reshape(-1, 2), oris.reshape(-1), H, H, 2.0,
                       crop, 0.0, 0.75)
    grid = affine_grid(theta, crop, crop).reshape(E, K1, crop, crop, 2)
    return src, grid.to(dev).contiguous()


def phase_crop(ctx):
    import torch
    import torch.nn.functional as F

    from lav_tpu_torch.core.warp import (
        affine_grid, crop_shared, crop_theta, grid_sample_shared,
    )

    dev = torch.device(ctx["device"])
    res = {}
    for dtype in (torch.float32, torch.bfloat16):
        src, grid = _agent_crop_inputs(torch, dev, dtype)
        out = crop_shared(src, grid)
        ref = grid_sample_shared(src, grid)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        scale = ref.float().abs().max().item()
        if dtype == torch.float32:
            tol = CROP_F32_ATOL
        else:
            tol = CROP_BF16_ULPS * 2.0 ** -7 * 2.0 ** math.ceil(
                math.log2(max(scale, 1e-30)))
        far = out[:, 1].float().abs().max().item()
        name = str(dtype).replace("torch.", "")
        log("crop", f"{name}: max_abs_err {err:.3e} (tol {tol:.3e}), "
            f"max |ref| {scale:.3f}, far crop max |out| {far}")
        if not (err <= tol and far == 0.0 and torch.isfinite(out).all()):
            raise AssertionError(f"crop_shared {name} disagrees with plain")
        B, H, W, C = src.shape
        _, K, Ho, Wo, _ = grid.shape
        ms = cuda_ms(torch, lambda: crop_shared(src, grid))
        plain_ms = cuda_ms(torch, lambda: grid_sample_shared(src, grid),
                           iters=3, warmup=1)
        # library yardstick, timed only and in f32 only: F.grid_sample per
        # ego on the source expanded over its K crops (a stride-0 batch,
        # native kernel, NCHW output)
        lib_ms = None
        if dtype == torch.float32:
            nchw = src.permute(0, 3, 1, 2)
            with torch.backends.cudnn.flags(enabled=False):
                lib_ms = cuda_ms(torch, lambda: [
                    F.grid_sample(nchw[b:b + 1].expand(K, C, H, W), grid[b],
                                  mode="bilinear", padding_mode="zeros",
                                  align_corners=True) for b in range(B)])
        esz = src.element_size()
        nbytes = (src.numel() * esz + grid.numel() * 4
                  + B * K * Ho * Wo * C * esz)
        flops = B * K * Ho * Wo * (8 * C + 24)
        bms, by = bound_ms(nbytes, flops)
        res[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         library_ms=lib_ms, bound_ms=bms, bound_by=by)
        log("crop", f"{name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"F.grid_sample {lib_ms} ms, bound {bms:.4f} ms ({by}, "
            f"{nbytes / 1e6:.1f} MB) on {ctx.get('smi', '?')}")
        del src, grid, out, ref
        torch.cuda.empty_cache()
    # the scalar path: a narrow source whose rows are not 16-byte vectors
    # (the 5-channel teacher BEV map's shape family)
    g = torch.Generator(device="cpu").manual_seed(3)
    src = torch.randn((2, 64, 64, 5), generator=g).to(dev)
    theta = crop_theta((torch.rand((6, 2), generator=g) * 2 - 1) * 12.0,
                       torch.rand((6,), generator=g) * 6.0, 64, 64, 2.0, 48,
                       0.0, 0.75)
    grid = affine_grid(theta, 48, 48).reshape(2, 3, 48, 48, 2).to(dev)
    err = (crop_shared(src, grid.contiguous())
           - grid_sample_shared(src, grid)).abs().max().item()
    log("crop", f"narrow C=5 source: max_abs_err {err:.3e} "
        f"(tol {CROP_F32_ATOL:.0e})")
    if not err <= CROP_F32_ATOL:
        raise AssertionError("crop_shared (scalar path) disagrees with plain")
    ctx["crop"] = res


def phase_pillar(ctx):
    import torch

    from lav_tpu_torch.ops.pillar import (
        NEG, pillar_scatter_max, pillar_scatter_max_plain,
    )

    dev = torch.device(ctx["device"])
    g = torch.Generator(device="cpu").manual_seed(2)
    E, P, C = NUM_EGO, 2 * MAX_POINTS * 3, 64
    G = 320 * 320
    S = G + 1
    feat = torch.randn((E, P, C), generator=g)           # negatives too
    local = torch.randint(0, G // 4, (E, P), generator=g)  # duplicates,
    invalid = torch.rand((E, P), generator=g) < 0.2        # empty pillars
    local[invalid] = G                                     # the dump slot
    feat[invalid] = NEG
    pid = (local + torch.arange(E)[:, None] * S).reshape(-1)
    feat = feat.reshape(-1, C).to(dev)
    pid = pid.to(torch.int32).to(dev)
    out = pillar_scatter_max(feat, pid, E * S)
    ref = pillar_scatter_max_plain(feat, pid, E * S)
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    empty = (ref == 0).all(dim=1).float().mean().item()
    neg = (ref < 0).float().mean().item()
    log("pillar", f"max_abs_err {err} (must be 0), empty pillars "
        f"{empty:.3f}, negative maxima {neg:.3f}")
    if err != 0.0 or not torch.equal(out, ref):
        raise AssertionError("pillar_scatter_max disagrees with plain")
    ms = cuda_ms(torch, lambda: pillar_scatter_max(feat, pid, E * S))
    plain_ms = cuda_ms(torch, lambda: pillar_scatter_max_plain(
        feat, pid, E * S))
    canvas = torch.full((E * S, C), NEG, device=dev)
    idx = pid.long()[:, None].expand(-1, C)
    lib_ms = cuda_ms(torch, lambda: canvas.scatter_reduce_(
        0, idx, feat, "amax", include_self=True))
    nbytes = feat.numel() * 4 + pid.numel() * 4 + E * S * C * 4
    bms, by = bound_ms(nbytes, feat.numel())
    ctx["pillar"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         library_ms=lib_ms, bound_ms=bms, bound_by=by)
    log("pillar", f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"scatter_reduce_ {lib_ms:.4f} ms, bound {bms:.4f} ms ({by}, "
        f"{nbytes / 1e6:.1f} MB) on {ctx.get('smi', '?')}")


def _run_ticks(step, models, state, obs, n):
    out = []
    for _ in range(n):
        ctrl, state, aux = step(models, state, obs)
        out.append((ctrl, aux))
    return out


def phase_agent(ctx):
    import numpy as np
    import torch

    from lav_tpu_torch.agent.setup import v2_agent_setup
    from lav_tpu_torch.utils import native

    step, models, state, obs, _ = v2_agent_setup(
        max_points=MAX_POINTS, num_ego=NUM_EGO, device=ctx["device"], seed=0)
    native.reset_launches()
    tick_ms, outs = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ctrl, state, aux = step(models, state, obs)
        torch.cuda.synchronize()
        tick_ms.append((time.perf_counter() - t0) * 1e3)
        outs.append((ctrl, aux))
    launches = dict(native.LAUNCHES)
    ctx["launches"] = launches
    log("agent", f"{NUM_EGO} egos x 3 ticks, launches {launches}, tick ms "
        f"{[round(t, 3) for t in tick_ms]}, p50 "
        f"{statistics.median(tick_ms):.3f} ms on {ctx.get('smi', '?')}")
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel of the path never launched: "
                             f"{launches}")
    for t, (ctrl, _) in enumerate(outs):
        s, th, b = (x.cpu() for x in ctrl)
        ok = (torch.isfinite(torch.stack([s, th, b])).all()
              and (s.abs() <= 1).all() and ((th >= 0) & (th <= 1)).all()
              and ((b >= 0) & (b <= 1)).all())
        if not ok:
            raise AssertionError(f"tick {t + 1}: controls out of range "
                                 f"{s}, {th}, {b}")

    # the same params and observations through the port on the CPU
    cstep, cmodels, cstate, cobs, _ = v2_agent_setup(
        max_points=MAX_POINTS, num_ego=1, device="cpu", seed=0)
    worst = 0.0
    for t, (ctrl_c, aux_c) in enumerate(_run_ticks(cstep, cmodels, cstate,
                                                   cobs, 2)):
        ctrl_g, aux_g = outs[t]
        got = np.concatenate([np.stack([x[0].cpu().numpy() for x in ctrl_g]),
                              aux_g["plan_locs"][0].cpu().numpy().ravel()])
        want = np.concatenate([np.stack([x[0].numpy() for x in ctrl_c]),
                               aux_c["plan_locs"][0].numpy().ravel()])
        err = float(np.abs(got - want).max())
        worst = max(worst, err)
        np.testing.assert_allclose(got, want, atol=AGENT_ATOL,
                                   rtol=AGENT_RTOL,
                                   err_msg=f"tick {t + 1} ego 0 GPU vs CPU")
    log("agent", f"ticks 1-2 of ego 0 match the CPU port: max_abs_err "
        f"{worst:.3e} (atol {AGENT_ATOL}, rtol {AGENT_RTOL})")


def phase_profile(ctx):
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from lav_tpu_torch.agent.setup import v2_agent_setup

    step, models, state, obs, _ = v2_agent_setup(
        max_points=MAX_POINTS, num_ego=NUM_EGO, device=ctx["device"], seed=0)
    for _ in range(2):
        _, state, _ = step(models, state, obs)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, state, _ = step(models, state, obs)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    if ctx.get("trace"):
        prof.export_chrome_trace(ctx["trace"])
    avgs = prof.key_averages()
    # each label has a host row (its host time and the device time of the
    # kernels it launched) and a device row (its span on the device)
    stages = {}
    for e in avgs:
        if e.key.startswith("agent/"):
            row = stages.setdefault(e.key, {})
            if e.device_type == DeviceType.CUDA:
                row["span"] = e.device_time_total / 1e3
            else:
                row["host"] = e.cpu_time_total / 1e3
                row["kernels"] = e.device_time_total / 1e3
    for key in sorted(stages, key=lambda k: -stages[k].get("kernels", 0)):
        r = stages[key]
        log("profile", f"{key}: kernels {r.get('kernels', 0):.3f} ms, "
            f"device span {r.get('span', 0):.3f} ms, host "
            f"{r.get('host', 0):.3f} ms")
    kernels = [e for e in avgs if e.device_type == DeviceType.CUDA
               and not e.key.startswith("agent/")]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    launches = sum(e.count for e in kernels)
    log("profile", f"{NUM_EGO} egos, one tick: wall {wall_ms:.3f} ms, "
        f"device busy {busy_ms:.3f} ms ({busy_ms / wall_ms:.1%}), "
        f"{launches} kernel launches on {ctx.get('smi', '?')}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        log("profile", f"  {e.self_device_time_total / 1e3:8.3f} ms "
            f"x{e.count:<5d} {e.key[:90]}")
    if busy_ms <= 0:
        raise AssertionError("the profiler saw no device time")


def kernels_line(ctx):
    launches = ctx.get("launches", {})
    rows = []
    specs = (
        ("crop_shared", ctx.get("crop", {}).get("float32"),
         "lav_tpu_torch/csrc/crop_shared.cu",
         "lav_tpu/core/warp_pallas.py:108"),
        ("pillar_scatter_max", ctx.get("pillar"),
         "lav_tpu_torch/csrc/pillar_scatter_max.cu",
         "lav_tpu/ops/pillar_pallas.py:36"),
    )
    for name, r, source, replaces in specs:
        if r is None:
            continue
        rows.append(dict(name=name, route="cuda", source=source,
                         replaces=replaces, launches=launches.get(name, 0),
                         **{k: r[k] for k in ("max_abs_err", "ms", "plain_ms",
                                              "bound_ms", "bound_by",
                                              "library_ms")}))
    return {"kernels": rows}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(ALL_PHASES),
                    help="comma-separated subset of "
                    + ",".join(ALL_PHASES + EXTRA_PHASES))
    ap.add_argument("--trace", default=None,
                    help="write the profile phase's chrome trace here")
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    bad = [p for p in phases if p not in ALL_PHASES + EXTRA_PHASES]
    if bad:
        ap.error(f"unknown phases {bad}")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    try:
        import lav_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: run from the root of a checkout ({e})",
              file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; TF32 off "
          "for cuDNN and matmul", flush=True)

    ctx = {"device": "cuda", "trace": args.trace}
    for name in ALL_PHASES + EXTRA_PHASES:
        if name in phases or name == "build":
            t0 = time.perf_counter()
            globals()[f"phase_{name}"](ctx)
            log(name, f"ok in {time.perf_counter() - t0:.1f} s")
    print(json.dumps(kernels_line(ctx)), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
