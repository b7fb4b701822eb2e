#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (lav_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py                     # every phase, one card
    python3 chip_smoke.py --phases build,crop # a subset, for bring-up
    python3 chip_smoke.py --phases build,crop,scatter,conv_int8,production

Phases, each printing its own line and raising on failure:
  build   the card's name and power limit; nvcc builds every kernel
  crop    kernel crop_shared against its plain version at the agent's
          shapes (4 egos, 160x160x384 source, 16 crops of 96x96), f32 and
          bf16, with crops straddling the border and wholly outside; and
          kernel crop_shared_q8 (int8 epilogue) on an f32 source there and
          on a bf16 source at the production shapes (16 egos)
  pillar  kernel pillar_scatter_max against its plain version at the
          agent's shapes (4 x 49152 points, 64 channels, 4 x 102401
          pillars) with masked points, duplicate ids, empty pillars and
          negative values; must be exact
  scatter kernels scatter_max (bf16 and f32, exact) and scatter_add (f32)
          against their plain versions at the production shapes (16 x
          60000 points into 16 x 102400 + 1 rows) with duplicate ids,
          empty pillars and dump-row points
  conv_int8  kernel conv2d_int8 against its plain version at every int8
          conv shape of the production tick (16 egos), f32 output with a
          bias and bf16 output without; must be exact; cuDNN's bf16 conv
          at the same shape is timed beside it
  agent   the full-width v2 agent (3 cameras 288x256, telephoto 192x480,
          8192 points per sweep) in f32 on the use_pallas route for 4
          egos and 3 ticks on the card: its kernels launched, controls
          finite and in range, ticks 1-2 of ego 0 equal to the port's CPU
          run within the stated tolerance
  production  bench.py's configuration: v2_agent_setup(quant="mxu",
          compute_dtype=bf16) with 16 egos and 10000 points per sweep for
          3 ticks (then 5 more, timed): crop_shared_q8, scatter_max,
          scatter_add and conv2d_int8 launched every tick, controls finite
          and in range, ticks 1-2 of ego 0 equal to the port's CPU run on
          the same weights and scales; the p50 tick
  profile (only when asked for) one warm tick of the agent under
          torch.profiler (--config f32, production or both): device time
          per agent stage, the device's busy share of the tick, and the
          kernels that take the most time

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

AGENT_KERNELS = ("crop_shared", "pillar_scatter_max", "scatter_add")
PROD_KERNELS = ("crop_shared_q8", "scatter_max", "scatter_add",
                "conv2d_int8")
ALL_PHASES = ("build", "crop", "pillar", "scatter", "conv_int8", "agent",
              "production")
EXTRA_PHASES = ("profile",)
NUM_EGO = 4
MAX_POINTS = 8192
NUM_EGO_PROD = 16           # bench.py:31
MAX_POINTS_PROD = 10000     # bench.py:40
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA data sheet
F32_FLOPS = 67e12           # H100 SXM non-tensor f32
INT8_OPS = 1979e12          # H100 SXM dense int8 tensor cores

# tolerances, each with its reason
CROP_F32_ATOL = 1e-5        # same f32 arithmetic; FMA contraction only
CROP_BF16_ULPS = 1.0        # both round one f32 sum; FMA may flip 1 ulp
CROP_Q8_STEPS = 1           # an FMA-rounded f32 sum may cross a rounding
CROP_Q8_FRACTION = 0.01     # boundary: 1 step, on at most 1% of values
SCATTER_ADD_RTOL = 1e-6     # of the pillar's sum of |v|: atomics add in
                            # another order (see phase_scatter)
AGENT_ATOL = 1e-3           # cuDNN vs CPU conv summation order, f32
AGENT_RTOL = 1e-3
PROD_ATOL = 3e-2            # the int8 golden's (test_golden_production.py)
PROD_RTOL = 3e-2


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


def bound_ms(nbytes: float, flops: float = 0.0, peak: float = F32_FLOPS):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
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


def _agent_crop_inputs(torch, dev, dtype, E=NUM_EGO):
    """Source maps and grids as the agent builds them: K detections plus
    the ego crop per ego, some straddling the border, one far outside."""
    from lav_tpu_torch.core.warp import affine_grid, crop_theta

    g = torch.Generator(device="cpu").manual_seed(1)
    H, C, K1, crop = 160, 384, 16, 96
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
    del src, grid
    res["q8"] = _crop_q8(torch, ctx, dev)
    ctx["crop"] = res


def _crop_q8(torch, ctx, dev):
    """crop_shared_q8: an f32 source at the f32 agent's shapes (the f32 +
    int8 configuration), then a bf16 source at the production shapes,
    timed; x_scale = absmax / 127 so that the int8 range is used."""
    from lav_tpu_torch.core.warp import (
        crop_shared, grid_sample_shared_q8, inverse_scale,
    )

    for dtype, E in ((torch.float32, NUM_EGO),
                     (torch.bfloat16, NUM_EGO_PROD)):
        src, grid = _agent_crop_inputs(torch, dev, dtype, E=E)
        x_scale = (src.float().abs().max() / 127.0).reshape(())
        out = crop_shared(src, grid, q8_x_scale=x_scale)
        ref = grid_sample_shared_q8(src, grid, inverse_scale(x_scale))
        torch.cuda.synchronize()
        diff = (out.int() - ref.int()).abs()
        err = int(diff.max())
        frac = float((diff > 0).float().mean())
        far = int(out[:, 1].abs().max())
        name = str(dtype).replace("torch.", "")
        log("crop", f"q8 ({name} source, {E} egos): max step diff {err} "
            f"(tol {CROP_Q8_STEPS}), values off {frac:.2e} (tol "
            f"{CROP_Q8_FRACTION}), far crop max |out| {far}")
        if out.dtype != torch.int8 or err > CROP_Q8_STEPS or \
                frac > CROP_Q8_FRACTION or far != 0:
            raise AssertionError(f"crop_shared_q8 {name} disagrees with "
                                 "plain")
    ms = cuda_ms(torch, lambda: crop_shared(src, grid, q8_x_scale=x_scale))
    inv = inverse_scale(x_scale)
    plain_ms = cuda_ms(torch, lambda: grid_sample_shared_q8(src, grid, inv),
                       iters=2, warmup=1)
    B, H, W, C = src.shape
    _, K, Ho, Wo, _ = grid.shape
    nbytes = src.numel() * 2 + grid.numel() * 4 + B * K * Ho * Wo * C
    flops = B * K * Ho * Wo * (10 * C + 24)
    bms, by = bound_ms(nbytes, flops)
    log("crop", f"q8: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, no "
        f"library call, bound {bms:.4f} ms ({by}, {nbytes / 1e6:.1f} MB) on "
        f"{ctx.get('smi', '?')}")
    del src, grid, out, ref
    torch.cuda.empty_cache()
    return dict(max_abs_err=float(err), ms=ms, plain_ms=plain_ms,
                library_ms=None, bound_ms=bms, bound_by=by)


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


def phase_scatter(ctx):
    import torch

    from lav_tpu_torch.ops.pillar import (
        scatter_add, scatter_add_plain, scatter_max, scatter_max_plain,
    )

    dev = torch.device(ctx["device"])
    g = torch.Generator(device="cpu").manual_seed(4)
    E, P = NUM_EGO_PROD, 2 * MAX_POINTS_PROD * 3
    G = 320 * 320
    S = E * G + 1                                        # one dump row
    local = torch.randint(0, G // 8, (E, P), generator=g)  # duplicates,
    invalid = torch.rand((E, P), generator=g) < 0.2        # empty pillars
    pid = torch.where(invalid, torch.full_like(local, E * G),
                      local + torch.arange(E)[:, None] * G).reshape(-1)
    pid = pid.to(torch.int32).to(dev)
    res = {}
    # max: post-ReLU payloads (zeros and ties included)
    for dtype, C in ((torch.bfloat16, 64), (torch.float32, 64)):
        feat = torch.relu(torch.randn((E * P, C), generator=g)).to(dev,
                                                                   dtype)
        out = scatter_max(feat, pid, S)
        ref = scatter_max_plain(feat, pid, S)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        empty = (ref[:-1] == 0).all(dim=1).float().mean().item()
        name = str(dtype).replace("torch.", "")
        log("scatter", f"max {name}: max_abs_err {err} (must be 0), empty "
            f"pillars {empty:.3f}")
        if err != 0.0 or not torch.equal(out, ref):
            raise AssertionError(f"scatter_max {name} disagrees with plain")
        if dtype == torch.bfloat16:
            ms = cuda_ms(torch, lambda: scatter_max(feat, pid, S))
            plain_ms = cuda_ms(torch, lambda: scatter_max_plain(feat, pid, S))
            canvas = torch.zeros((S, C), dtype=dtype, device=dev)
            idx = pid.long()[:, None].expand(-1, C)
            lib_ms = cuda_ms(torch, lambda: canvas.scatter_reduce_(
                0, idx, feat, "amax", include_self=True))
            nbytes = feat.numel() * 2 + pid.numel() * 4 + S * C * 2
            bms, by = bound_ms(nbytes, feat.numel())
            res["max"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                              library_ms=lib_ms, bound_ms=bms, bound_by=by)
            log("scatter", f"max bf16: kernel {ms:.4f} ms, plain "
                f"{plain_ms:.4f} ms, scatter_reduce_ {lib_ms:.4f} ms, bound "
                f"{bms:.4f} ms ({by}, {nbytes / 1e6:.1f} MB) on "
                f"{ctx.get('smi', '?')}")
        del feat, out, ref
    # add: the decoration sums, xyz of the valid points and a count lane
    xyz = (torch.rand((E * P, 3), generator=g) * 60.0 - 20.0)
    keep = ~invalid.reshape(-1, 1)
    feat = torch.cat([torch.where(keep, xyz, 0.0), keep.float()],
                     dim=-1).to(dev)
    out = scatter_add(feat, pid, S)
    ref = scatter_add_plain(feat, pid, S)
    mag = scatter_add_plain(feat.abs(), pid, S)
    torch.cuda.synchronize()
    n_max = int(ref[:, 3].max())
    # two summation orders of n terms differ by at most 2(n-1) units of
    # rounding of the sum of magnitudes; 1e-6 of it is the stated floor
    rtol = max(SCATTER_ADD_RTOL, 2 * (n_max - 1) * 2.0 ** -24)
    diff = (out[:, :3] - ref[:, :3]).abs()
    excess = (diff - rtol * mag[:, :3]).max()
    rel = (diff / mag[:, :3].clamp(min=1e-30)).max().item()
    err = (out - ref).abs().max().item()
    count_ok = torch.equal(out[:, 3], ref[:, 3])
    log("scatter", f"add f32: max_abs_err {err:.3e}, max |diff| / sum|v| "
        f"{rel:.3e}, worst excess over rtol {rtol:.2e} x sum|v| "
        f"{excess.item():.3e} (must be <= 0), count lane exact {count_ok}, "
        f"most points in a pillar {n_max}")
    if excess.item() > 0 or not count_ok:
        raise AssertionError("scatter_add disagrees with plain")
    ms = cuda_ms(torch, lambda: scatter_add(feat, pid, S))
    plain_ms = cuda_ms(torch, lambda: scatter_add_plain(feat, pid, S))
    acc = torch.zeros((S, 4), device=dev)
    idx = pid.long()
    lib_ms = cuda_ms(torch, lambda: acc.index_add_(0, idx, feat))
    nbytes = feat.numel() * 4 + pid.numel() * 4 + S * 4 * 4
    bms, by = bound_ms(nbytes, feat.numel())
    res["add"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                      library_ms=lib_ms, bound_ms=bms, bound_by=by)
    log("scatter", f"add f32: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"index_add_ {lib_ms:.4f} ms, bound {bms:.4f} ms ({by}, "
        f"{nbytes / 1e6:.1f} MB) on {ctx.get('smi', '?')}")
    ctx["scatter"] = res


def _conv_int8_shapes():
    """Every int8 conv of one production tick at NUM_EGO_PROD egos: (name,
    batch, H, W, C, O, k, stride, padding, convs per tick)."""
    E = NUM_EGO_PROD
    crops = E * 16                         # max_det detections + the ego
    rows = [("planner.conv1", crops, 96, 96, 384, 64, 7, 2, 3, 1)]
    h, c = 24, 64                          # after conv1 and the max pool
    for stage, cout in enumerate((64, 128, 256, 512)):
        if stage:
            rows += [(f"planner.layer{stage + 1}_0.conv1", crops, h, h, c,
                      cout, 3, 2, 1, 1),
                     (f"planner.layer{stage + 1}_0.down_conv", crops, h, h,
                      c, cout, 1, 2, 0, 1)]
            h //= 2
        rows.append((f"planner.layer{stage + 1}.3x3", crops, h, h, cout,
                     cout, 3, 1, 1, 4 if stage == 0 else 3))
        c = cout
    rows += [("lidar.conv1_x", E, 160, 160, 64, 64, 3, 1, 1, 3),
             ("lidar.conv2_0", E, 160, 160, 64, 128, 3, 2, 1, 1),
             ("lidar.conv2_x", E, 80, 80, 128, 128, 3, 1, 1, 5),
             ("lidar.conv3_0", E, 80, 80, 128, 128, 3, 2, 1, 1),
             ("lidar.conv3_x", E, 40, 40, 128, 128, 3, 1, 1, 5),
             ("lidar.heads", E, 160, 160, 384, 64, 3, 1, 1, 4)]
    return rows


INT8_CONVS_PER_TICK = 39   # the committed calibration JSON's keys


def phase_conv_int8(ctx):
    import torch
    import torch.nn.functional as F

    from lav_tpu_torch.nn.quant import conv2d_int8_nhwc, conv2d_int8_plain

    dev = torch.device(ctx["device"])
    g = torch.Generator(device=dev).manual_seed(5)
    shapes = _conv_int8_shapes()
    assert sum(r[-1] for r in shapes) == INT8_CONVS_PER_TICK
    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
               ops=0.0, nbytes=0.0)
    worst = 0.0
    for name, N, H, W, C, O, k, st, pad, count in shapes:
        xq = torch.randint(-127, 128, (N, H, W, C), generator=g,
                           dtype=torch.int8, device=dev)
        w = torch.randint(-127, 128, (O, k, k, C), generator=g,
                          dtype=torch.int8, device=dev)
        w_scale = torch.rand((O,), generator=g, device=dev) * 1e-3 + 1e-4
        s_x = torch.tensor(0.02, device=dev)
        bias = torch.randn((O,), generator=g, device=dev)
        # f32 output with a bias (the calibration run's dtype), then bf16
        # without (the tick's convs), which is timed
        for out_dtype, b in ((torch.float32, bias), (torch.bfloat16, None)):
            args = (xq, w, w_scale, s_x, b, (st, st), (pad, pad), (1, 1),
                    out_dtype)
            out = conv2d_int8_nhwc(*args)
            ref = conv2d_int8_plain(*args)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            worst = max(worst, err)
            if not torch.equal(out, ref):
                raise AssertionError(f"conv2d_int8 {name} {out_dtype} "
                                     f"disagrees with plain: max_abs_err "
                                     f"{err}")
        ms = cuda_ms(torch, lambda: conv2d_int8_nhwc(*args), iters=5)
        plain_ms = cuda_ms(torch, lambda: conv2d_int8_plain(*args), iters=1,
                           warmup=1)
        xb = xq.permute(0, 3, 1, 2).to(torch.bfloat16)
        wb = w.permute(0, 3, 1, 2).to(torch.bfloat16)
        lib_ms = cuda_ms(torch, lambda: F.conv2d(xb, wb, None, st, pad),
                         iters=5)
        OH, OW = out.shape[1:3]
        ops = 2.0 * N * OH * OW * O * k * k * C
        nbytes = xq.numel() + w.numel() + O * 4 + out.numel() * 2
        bms, by = bound_ms(nbytes, ops, INT8_OPS)
        log("conv_int8", f"{name} x{count}: {N}x{H}x{W}x{C} -> {O} k{k} "
            f"s{st}: exact, kernel {ms:.4f} ms ({ops / ms / 1e9:.1f} TOPS), "
            f"plain {plain_ms:.3f} ms, cuDNN bf16 conv (another function) "
            f"{lib_ms:.4f} ms, bound {bms:.4f} ms ({by})")
        for key, val in (("ms", ms), ("plain_ms", plain_ms),
                         ("library_ms", lib_ms), ("bound_ms", bms),
                         ("ops", ops), ("nbytes", nbytes)):
            tot[key] += count * val
        del xq, w, out, ref, xb, wb
        torch.cuda.empty_cache()
    by = ("operations" if tot["ops"] / INT8_OPS
          >= tot["nbytes"] / HBM_BYTES_PER_S else "bytes")
    # no PyTorch call computes an int8 convolution on CUDA: library_ms is
    # null; cuDNN's bf16 conv (another function) is kept beside it
    ctx["conv_int8"] = dict(max_abs_err=worst, ms=tot["ms"],
                            plain_ms=tot["plain_ms"], library_ms=None,
                            bound_ms=tot["bound_ms"], bound_by=by,
                            cudnn_bf16_conv_ms=tot["library_ms"])
    log("conv_int8", f"one production tick ({INT8_CONVS_PER_TICK} convs): "
        f"kernel {tot['ms']:.3f} ms, plain {tot['plain_ms']:.3f} ms, cuDNN "
        f"bf16 {tot['library_ms']:.3f} ms, bound {tot['bound_ms']:.4f} ms "
        f"({by}) on {ctx.get('smi', '?')}")


def _check_controls(torch, outs):
    for t, (ctrl, _) in enumerate(outs):
        s, th, b = (x.float().cpu() for x in ctrl)
        ok = (torch.isfinite(torch.stack([s, th, b])).all()
              and (s.abs() <= 1).all() and ((th >= 0) & (th <= 1)).all()
              and ((b >= 0) & (b <= 1)).all())
        if not ok:
            raise AssertionError(f"tick {t + 1}: controls out of range "
                                 f"{s}, {th}, {b}")


def _ego0(ctrl, aux):
    """Ego 0's controls and plan, flattened, on the host."""
    import numpy as np

    return np.concatenate([
        np.stack([x[0].float().cpu().numpy() for x in ctrl]),
        aux["plan_locs"][0].float().cpu().numpy().ravel()])


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
        max_points=MAX_POINTS, num_ego=NUM_EGO, device=ctx["device"], seed=0,
        use_pallas=True)
    native.reset_launches()
    tick_ms, outs = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ctrl, state, aux = step(models, state, obs)
        torch.cuda.synchronize()
        tick_ms.append((time.perf_counter() - t0) * 1e3)
        outs.append((ctrl, aux))
    launches = {k: native.LAUNCHES[k] for k in AGENT_KERNELS}
    ctx["launches_agent"] = launches
    log("agent", f"{NUM_EGO} egos x 3 ticks, launches {launches}, tick ms "
        f"{[round(t, 3) for t in tick_ms]}, p50 "
        f"{statistics.median(tick_ms):.3f} ms on {ctx.get('smi', '?')}")
    if min(launches.values()) < 3:
        raise AssertionError(f"a kernel of the path missed a tick: "
                             f"{launches}")
    _check_controls(torch, outs)

    # the same params and observations through the port on the CPU
    cstep, cmodels, cstate, cobs, _ = v2_agent_setup(
        max_points=MAX_POINTS, num_ego=1, device="cpu", seed=0,
        use_pallas=True)
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


def phase_production(ctx):
    import copy

    import numpy as np
    import torch

    from lav_tpu_torch.agent.agent import build_agent
    from lav_tpu_torch.agent.setup import make_obs, v2_agent_setup
    from lav_tpu_torch.nn.quant import int8_convs
    from lav_tpu_torch.utils import native

    t0 = time.perf_counter()
    step, models, state, obs, cfg = v2_agent_setup(
        max_points=MAX_POINTS_PROD, num_ego=NUM_EGO_PROD,
        device=ctx["device"], seed=0, quant="mxu",
        compute_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    convs = list(int8_convs(models))
    calibrated = sum(c.x_scale is not None for _, c in convs)
    log("production", f"setup (seeded weights, int8 mxu, calibrated on the "
        f"card) {time.perf_counter() - t0:.1f} s: {len(convs)} int8 convs, "
        f"{calibrated} with static scales")
    if len(convs) != INT8_CONVS_PER_TICK or calibrated != len(convs):
        raise AssertionError("the mxu configuration has the wrong int8 convs")
    cpu_models = copy.deepcopy(models).to("cpu")  # same weights and scales

    native.reset_launches()
    tick_ms, outs, per_tick = [], [], []
    prev = dict(native.LAUNCHES)
    for t in range(8):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ctrl, state, aux = step(models, state, obs)
        torch.cuda.synchronize()
        tick_ms.append((time.perf_counter() - t0) * 1e3)
        if t < 3:
            outs.append((ctrl, aux))
            now = dict(native.LAUNCHES)
            per_tick.append({k: now[k] - prev[k] for k in PROD_KERNELS})
            prev = now
            if t == 2:
                launches = {k: now[k] for k in PROD_KERNELS}
    ctx["launches_prod"] = launches
    log("production", f"{NUM_EGO_PROD} egos, launches per tick {per_tick}")
    for t, counts in enumerate(per_tick):
        if min(counts.values()) < 1 or \
                counts["conv2d_int8"] != INT8_CONVS_PER_TICK:
            raise AssertionError(f"tick {t + 1}: a kernel of the path did "
                                 f"not launch as it should: {counts}")
    _check_controls(torch, outs)
    p50 = statistics.median(tick_ms[1:])
    ctx["prod_p50_ms"] = p50
    log("production", f"tick ms {[round(t, 3) for t in tick_ms]}; p50 of "
        f"ticks 2-8 {p50:.3f} ms ({NUM_EGO_PROD} egos, "
        f"{MAX_POINTS_PROD} points per sweep) on {ctx.get('smi', '?')}")

    # ego 0 through the port on the CPU, same weights, scales and inputs
    cinit, cstep = build_agent(cfg, max_points=MAX_POINTS_PROD,
                               compute_dtype=torch.bfloat16, device="cpu")
    cobs = make_obs(1, MAX_POINTS_PROD, seed=0, device="cpu")
    worst = 0.0
    for t, (ctrl_c, aux_c) in enumerate(_run_ticks(cstep, cpu_models,
                                                   cinit(), cobs, 2)):
        ctrl_g, aux_g = outs[t]
        dg = {k: v[0].cpu() for k, v in aux_g["dets"].items()}
        dc = {k: v[0] for k, v in aux_c["dets"].items()}
        same = torch.equal(dg["valid"], dc["valid"])
        v = dc["valid"]
        xy = max([(dg[f][v].float() - dc[f][v].float()).abs().max().item()
                  for f in ("x", "y")] + [0.0]) if same and v.any() else None
        log("production", f"tick {t + 1} ego 0 detections: {int(v.sum())} "
            f"on the CPU, {int(dg['valid'].sum())} on the card, valid masks "
            f"agree {same}, max |xy| diff {xy}")
        got, want = _ego0(ctrl_g, aux_g), _ego0(ctrl_c, aux_c)
        err = float(np.abs(got - want).max())
        worst = max(worst, err)
        np.testing.assert_allclose(got, want, atol=PROD_ATOL, rtol=PROD_RTOL,
                                   err_msg=f"tick {t + 1} ego 0 GPU vs CPU")
    log("production", f"ticks 1-2 of ego 0 match the CPU port: max_abs_err "
        f"{worst:.3e} (atol {PROD_ATOL}, rtol {PROD_RTOL})")


def phase_profile(ctx):
    import torch

    setups = {
        "f32": dict(max_points=MAX_POINTS, num_ego=NUM_EGO, use_pallas=True),
        "production": dict(max_points=MAX_POINTS_PROD, num_ego=NUM_EGO_PROD,
                           quant="mxu", compute_dtype=torch.bfloat16),
    }
    names = list(setups) if ctx["config"] == "both" else [ctx["config"]]
    for name in names:
        _profile_one(ctx, name, setups[name])


def _profile_one(ctx, config, setup):
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from lav_tpu_torch.agent.setup import v2_agent_setup

    step, models, state, obs, _ = v2_agent_setup(device=ctx["device"], seed=0,
                                                 **setup)
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
        prof.export_chrome_trace(ctx["trace"].replace(".json",
                                                      f"_{config}.json"))
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
        log("profile", f"{config} {key}: kernels "
            f"{r.get('kernels', 0):.3f} ms, "
            f"device span {r.get('span', 0):.3f} ms, host "
            f"{r.get('host', 0):.3f} ms")
    kernels = [e for e in avgs if e.device_type == DeviceType.CUDA
               and not e.key.startswith("agent/")]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    launches = sum(e.count for e in kernels)
    log("profile", f"{config}, {setup['num_ego']} egos, one tick: wall "
        f"{wall_ms:.3f} ms, "
        f"device busy {busy_ms:.3f} ms ({busy_ms / wall_ms:.1%}), "
        f"{launches} kernel launches on {ctx.get('smi', '?')}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        log("profile", f"  {e.self_device_time_total / 1e3:8.3f} ms "
            f"x{e.count:<5d} {e.key[:90]}")
    if busy_ms <= 0:
        raise AssertionError("the profiler saw no device time")


def kernels_line(ctx):
    """Every kernel with its numbers; `launches` counts the main path that
    runs it: the f32 agent for crop_shared and pillar_scatter_max, the
    production tick for the rest."""
    launches = {**ctx.get("launches_agent", {}),
                **ctx.get("launches_prod", {})}
    rows = []
    crop, scatter = ctx.get("crop", {}), ctx.get("scatter", {})
    specs = (
        ("crop_shared", crop.get("float32"),
         "lav_tpu_torch/csrc/crop_shared.cu",
         "lav_tpu/core/warp_pallas.py:108"),
        ("crop_shared_q8", crop.get("q8"),
         "lav_tpu_torch/csrc/crop_shared.cu",
         "lav_tpu/core/warp_pallas.py:164"),
        ("pillar_scatter_max", ctx.get("pillar"),
         "lav_tpu_torch/csrc/pillar_scatter_max.cu",
         "lav_tpu/ops/pillar_pallas.py:36"),
        ("scatter_max", scatter.get("max"),
         "lav_tpu_torch/csrc/pillar_scatter.cu",
         "lav_tpu/ops/pillar_pallas2.py:84"),
        ("scatter_add", scatter.get("add"),
         "lav_tpu_torch/csrc/pillar_scatter.cu",
         "lav_tpu/ops/pillar_pallas2.py:84"),
        ("conv2d_int8", ctx.get("conv_int8"),
         "lav_tpu_torch/csrc/conv2d_int8.cu",
         "lav_tpu/nn/quant.py:246"),
    )
    for name, r, source, replaces in specs:
        if r is None:
            continue
        rows.append(dict(name=name, route="cuda", source=source,
                         replaces=replaces, launches=launches.get(name, 0),
                         **r))
    return {"kernels": rows}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(ALL_PHASES),
                    help="comma-separated subset of "
                    + ",".join(ALL_PHASES + EXTRA_PHASES))
    ap.add_argument("--config", default="both",
                    choices=("f32", "production", "both"),
                    help="the agent configuration(s) the profile phase runs")
    ap.add_argument("--trace", default=None,
                    help="write the profile phase's chrome traces here "
                    "(one file per configuration, named after it)")
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

    ctx = {"device": "cuda", "trace": args.trace, "config": args.config}
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
