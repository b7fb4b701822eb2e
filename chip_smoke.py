#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (lav_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py                     # every phase, one card
    python3 chip_smoke.py --phases build,crop # a subset, for bring-up
    python3 chip_smoke.py --phases build,crop,scatter,conv_int8,production
    python3 chip_smoke.py --phases build,pillar,crop,conv_int8,gather,variants
    python3 chip_smoke.py --phases build,train_kernels,train
    python3 chip_smoke.py --phases build,crop,privileged
    python3 chip_smoke.py --phases build,cli
    python3 chip_smoke.py --phases build,eval
    python3 chip_smoke.py --phases build,export,parallel,diag
    python3 chip_smoke.py --phases build,agent,production,export,tools

Phases, each printing its own line and raising on failure:
  build   the card's name and power limit; nvcc builds every kernel
  crop    kernel crop_shared against its plain version at the agent's
          shapes (4 egos, 160x160x384 source, 16 crops of 96x96), f32 and
          bf16, with crops straddling the border and wholly outside; and
          kernel crop_shared_q8 (int8 epilogue) on an f32 source there and
          on a bf16 source at the production shapes (16 egos); and kernel
          crop_shared_q8_s2d (space-to-depth int8 crops) at the production
          shapes, equal to crop_shared_q8's crops reshuffled; both int8
          forms also on zoom-out crops (2 source pixels an output pixel,
          45 degrees and others) and on 90x90 crops (partial 16x16
          tiles); host-paced and device-only times and host us per call
          of the int8 forms; crop_shared f32 at the BEV trainer's shapes
          (64 sources of 320x320x9, 5 crops of 192x192 each); and
          crop_shared's narrow route, f32 and bf16: C = 1, 3 and 9 with
          the source, and through the C entry the output too, one
          element off a 16-byte boundary, and C = 5; every plain case
          timed host-paced and device-only beside F.grid_sample; and
          core.warp.grid_sample (one crop an item) on the f32 agent's
          sources: crop_shared launched once, equal to the CPU within
          CROP_F32_ATOL
  pillar  kernel pillar_scatter_max against its plain version at the
          agent's shapes (4 x 49152 points, 64 channels, 4 x 102401
          pillars) with masked points at NEG in the in-range dump slots,
          duplicate ids, empty pillars and negative values, and its bf16
          form at the production shapes (16 x 60000 points, 16 x 102401
          pillars); must be exact; host-paced and device-only times and
          host us per call beside scatter_reduce_'s; then the four
          canvas-max entries (scatter_max and pillar_scatter_max, bf16 and
          f32) on crafted cases, exact with NaN positions equal: NaN,
          -0.0, -inf and NEG lanes, one pillar of 5,000 points, every id
          out of range, no point, C = 2 and C = 66, a feat 4 bytes into
          its storage
  scatter kernels scatter_max (bf16 and f32, exact) and scatter_add (f32,
          which sums each pillar in point order: equal bit for bit to
          the plain version on the CPU, and to itself on a second
          launch) against their plain versions at the production shapes
          (16 x 60000 points into 16 x 102400 + 1 rows) with duplicate
          ids, empty pillars and dump-row points (a fifth, in range);
          scatter_add also on a contention case (runs of 16 equal ids);
          both on the ids and payloads the production agent hands them at
          tick 1 and once its ring buffer is full (scatter_max held exact,
          NaN positions equal); host-paced and device-only times and host
          us per call beside index_add_'s and scatter_reduce_'s; then
          kernel scatter_max_bwd (the production eval canvas' gradient)
          against its plain version, exact with NaN positions equal, on
          the forward's sort and sorting itself: on the full-ring tick's
          canvas (bf16, and its payload in f32), on the f32 agent's canvas
          shapes and on rows of 255-1,000 tied points (at 0, where the
          zero counts one more, and at 3.0) with NaN in the payload and
          NaN and inf in g; host-paced and device-only times and host us
          per call beside autograd through scatter_reduce "amax"
  conv_int8  kernel conv2d_int8 against its plain version at every int8
          conv shape of the production tick (16 egos), and at the variant
          routes' shapes (the s2d conv1 and the three int8 upconvs as
          transposed convs), f32 output with a bias and bf16 output
          without; must be exact; per shape the device-only and
          host-paced ms, host us per call, useful TOPS and share of the
          int8 peak, and the work walked over the useful work; beside it
          torch._int_mm for a 1x1 conv (the same int32 sums), else cuDNN's
          bf16 conv (F.conv_transpose2d for the upconvs); then two convs
          on no path, exact: C = 24 (padded to 32 by the wrapper) and a
          9x9 kernel (9 taps a phase and axis); then every conv the
          camera nets run under quant="all" at 16 egos (ERFNet's 3x1 /
          1x3 convs with dilation up to 16 and its transposed convs, the
          brake net's ResNet on both images), each distinct call exact
          against the plain version on its own inputs, and timed
  gather  kernel take_along_rows (the gather probe, scripts/exp_gather.py)
          at the probe's six (S, L, dtype) cases: bit for bit the plain
          version with the rows random and in order; lav_tpu's contract
          at out-of-range indices (-1 and -S wrap, -S - 1, S, 2^20 and
          -2^20 give NaN), f32 and bf16; host-paced and device-only times
          and host us per call beside torch.gather's, and the
          rows-in-order device-only times;
          native.launch's private device and stream reads against the
          public ones (default and side stream), and what the pieces of a
          launch cost the host
  agent   the full-width v2 agent (3 cameras 288x256, telephoto 192x480,
          8192 points per sweep) in f32 on the use_pallas route for 4
          egos: 12 ticks twice from one state, with no deterministic flag
          set for the process, equal bit for bit in every output leaf
          (ROADMAP C10); then 3 ticks on the card: its kernels launched,
          controls
          finite and in range, ticks 1-2 of ego 0 equal to the port's CPU
          run within the stated tolerance; then a heatmap with more tied
          peaks than max_det (40 a map) decoded on the card equal to the
          CPU slot by slot, and the cost per tick of its top-k (a stable
          sort) against torch.topk's and a top-k over an int64 key that
          breaks ties by index
  production  bench.py's configuration: v2_agent_setup(quant="mxu",
          compute_dtype=bf16) with 16 egos and 10000 points per sweep:
          12 ticks twice from one state, equal bit for bit with no
          deterministic flag (as phase agent); then 3 ticks (then 5 more,
          timed): crop_shared_q8, scatter_max,
          scatter_add and conv2d_int8 launched every tick, controls finite
          and in range, ticks 1-2 of ego 0 equal to the port's CPU run on
          the same weights and scales; the p50 tick
  variants  bench.py's three variant routes at once (BENCH_PALLAS=1,
          LAV_S2D_CROPS=1, LAV_INT8_UPCONV=1): the production setup with
          use_pallas=True, s2d_crops=True, int8_upconv=True; the bf16
          pillar_scatter_max, crop_shared_q8_s2d, scatter_add and 42
          conv2d_int8 launches every tick, crop_shared_q8 and scatter_max
          none; controls, CPU parity and the p50 tick as in production;
          then quant="all" (every stack int8, lav_tpu's whole-tree scope)
          the same way: its conv2d_int8 count and device ms a tick
          beside "mxu"'s, ego 0 against the CPU at the int8 golden's 3e-2
  train_kernels  the distillation step's two backward kernels against
          their plain versions, in f32 and in bf16 (crop_shared_bwd_bf16,
          pillar_scatter_max_bwd_bf16): crop_shared_bwd on the student's
          crops of a step (4 items, 4 other-car crops and the ego's, 96x96
          from a 160x160x384 map; one straddling the border, one wholly
          outside), per cell within CROP_BWD_RTOL of its sum of |g w| (and
          in bf16 CROP_BWD_BF16_ULPS bf16 ulp beyond it), two calls equal
          bit for bit, a crop outside adding nothing, and on crops turned
          by 0, pi/4, pi/2, 3pi/4, pi and -3pi/4, crop 64 from 160, crops
          straddling each border, a 157x163 source and C = 6;
          pillar_scatter_max_bwd on the inputs one step (4 x 16384
          points; the bf16 step's for bf16) hands it (the forward's sort
          among them, read as the backward reads it) and on crafted ties
          (2, 3 and 40 equal maxima, ties at 0; hot rows of 255, 256, 257,
          300 and 1000 ties, which bf16 counts up to 256), dropped ids,
          empty rows and a hot row of 5,000 points, exact, on the
          forward's sort and sorting itself; both refuse f16 on the card;
          host-paced and device-only ms and host us per call beside the
          library's gradient (F.grid_sample's input gradient by autograd;
          autograd through scatter_reduce "amax", which splits ties too)
  train   the v2 distillation step (lav_tpu.train.distill,
          make_full_train_step(v2_config(), Adam(3e-4), v2=True,
          mode="full")) at full width: step 1 at B = 2 on the card
          against the port on the CPU (the same weights from seed 0, batch
          and noise) in loss, grad_norm and four gradient leaves in f32;
          in loss and grad_norm in bf16 (compute_dtype=bfloat16, lav_tpu's
          --dtype), and the same four leaves and a lidar backbone leaf of
          one bf16 forward and backward with BatchNorm on its running
          statistics (the lidar model's eval route: the point MLP's
          gradient through kernel scatter_max_bwd, counted); then,
          with 16384 points an item, 3 steps with launch counts and 4
          more timed (p50 over steps 2-7, samples/s, peak memory, one
          profiled step) of: f32 at B = 4 (crop_shared, crop_shared_bwd
          exactly the student's two calls, pillar_scatter_max,
          pillar_scatter_max_bwd once, scatter_add), bf16 at B = 4 (the
          same with crop_shared_bwd_bf16, pillar_scatter_max_bf16 and
          pillar_scatter_max_bwd_bf16, and no f32 backward), and f32 at
          lav_tpu's default batch, B = 32, with remat=True (the scoped
          student-crop checkpoint inside it; the recomputes launch the
          forward kernels again, the backward kernels run as often)
  privileged  the stage-1 trainers (lav_tpu.train.privileged) in f32 at
          full width: step 1 of each at B = 2 on the card against the port
          on the CPU (the same weights from seed 0, batch, noise and
          dropout masks) in loss, grad_norm and four gradient leaves; then
          the BEV planner step (v2_config(), v2 losses, B = 64: crop_shared
          twice a step, crop_shared_bwd never), the seg step (ERFNet with
          dropout, 288x256, B = 32) and the brake step (v2, 288x768 wide
          and 192x480 telephoto, its seg head, B = 8; both launch no
          kernel of the port), each 3 steps with launch counts and 4
          more: the p50 step over steps 2-7, samples/s, peak memory and
          one profiled step's device busy time, launches, host syncs, top
          kernels and top host ops
  cli     the staged training CLI (lav_tpu.train.cli, bev -> seg -> bra ->
          paint -> full) through cli.main on synthetic data dirs at full
          width, built in a temporary directory (configs/v2.yaml, and
          configs/v1.yaml for seg; 320x320 BEV maps, 288x256 cameras,
          40,000-point sweeps): bev --v2 B = 32 (crop_shared twice a
          step), seg B = 32 and bra --v2 B = 8 (no kernel of the port),
          the paint pass on the in-memory episode with the seg stage's
          checkpoint, then full --v2 B = 4 on 120,000-point samples in f32
          (TRAIN_KERNELS every step) with the bev stage's checkpoint as
          bev_model_dir (its teacher equal to it), in bf16
          (TRAIN_BF16_KERNELS), and resumed from the f32 run's epoch-1
          checkpoint (params, optimizer state and schedule count equal to
          the snapshot's; then its second epoch); 2 epochs of 2 steps each
          stage: launches, finite metrics, checkpoints, batch dtypes
          (lav_tpu's after device_put), step p50 over steps 2+, samples/s,
          loader wait a step, peak memory, seconds to build the data, and
          the host's ms to build a sample with its top functions
  eval    the agent's evaluation and deployment entry points, v2_config()
          in f32 with build_params(seed=0, eval_priors=True), 8192 points a
          sweep, TF32 off: (1) the 4-ego agent with det_override=True on
          the route replay's scripted scene (two parked cars, the crossing
          one; each ego's scene shifted sideways), ticks 1-2 of ego 0
          against the port on the CPU (controls, plan, other_valid with at
          least 2 vehicles, their casts; EVAL_ATOL / EVAL_RTOL); (2) two
          ticks with each skip stage (skip lidar launches no scatter_*,
          skip planner no crop_shared); (3) evaluate.main: 2 episodes of
          40 ticks with --video (results.json, 40 AVI frames each, p50 and
          steps/s), (4) --num-ego 16 --ticks 20 (p50, ego-ticks/s), (5)
          --routes on a route file the phase writes (a 90 degree turn, a
          lane change, and their reversed legs), 120 ticks (plan_progress,
          cmd_hist, collides, collide_releases, p50); (6) LAVAgentCore on
          40,000-point sweeps cut to 8192, 10 ticks, ticks 1-2 against the
          CPU, then LAVAgent through stub carla / leaderboard modules with
          checkpoints saved by train/checkpoints.py, 3 run_steps;
          crop_shared, scatter_max and scatter_add every tick
  export  agent/export.py: the f32 agent (4 egos) and lav_tpu's serving
          configuration (16 egos, bf16, "mxu" int8 with dynamic scales)
          exported on the card, loaded from the bytes, 6 ticks each
          beside the eager tick, no deterministic flag set for the
          process: every tick equal (torch.equal, NaN positions equal),
          the same launch counts, the p50 of both; then a custom op's
          host cost per call against the direct launch
  parallel  parallel/: the distillation step (B = 4, f32) and the v2 BEV
          step (B = 8) at full width, 2 steps, without a process group,
          as 1 rank over NCCL (equal bit for bit) and as 2 ranks over
          gloo sharing the card (PARALLEL_RTOL, BatchNorm's running
          statistics included), each run in processes of its own with
          deterministic algorithms; every rank launches each kernel as
          often as the one process does
  diag    train/diagnostics.py: the lidar probe (distillation models,
          16384 points) and the BEV probe on the card against the CPU,
          detections slot by slot, plans at AGENT_ATOL / AGENT_RTOL
  tools   lav_tpu's measurement tools (lav_tpu_torch/utils/): point_budget,
          bench_skip (7 variants), bench_ablate, bench_chain,
          bench_profile --quant mxu --trace and bench_train (full v2
          B = 4, bev v2 B = 64, seg B = 32, bra v2 B = 8), each through
          its main in this process at v2_config() full width with few
          iterations, their JSON lines printed; lav_tpu's keys, finite
          times, the port's kernels among the profiled classes; then
          roofline_summary of bench_chain's whole chain
  profile (only when asked for) one warm tick of the agent under
          torch.profiler (--config f32, production, variants, both = the
          first two, or all): device time
          per agent stage, the device's busy share of the tick, and the
          kernels that take the most time

TF32 is off for every phase (cuDNN and matmul), so f32 means f32.  The
next-to-last line is {"kernels": [...]}; the last is
{"ok": true, "device": {...}}.  Without a card, or outside a checkout of
the repository, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import re
import statistics
import subprocess
import sys
import time

AGENT_KERNELS = ("crop_shared", "pillar_scatter_max", "scatter_add")
VARIANT_ABSENT = ("crop_shared_q8", "scatter_max", "pillar_scatter_max")
ALL_PHASES = ("build", "crop", "pillar", "scatter", "conv_int8", "gather",
              "agent", "production", "variants", "train_kernels", "train",
              "privileged", "cli", "eval", "export", "parallel", "diag",
              "tools")
EXTRA_PHASES = ("profile",)
NUM_EGO = 4
MAX_POINTS = 8192
NUM_EGO_PROD = 16           # bench.py:31
MAX_POINTS_PROD = 10000     # bench.py:40
NUM_EGO_TRAIN = 4           # the distillation step's batch
MAX_POINTS_TRAIN = 16384    # lav_tpu/utils/bench_train.py --max-points
K_TRAIN = 4                 # v2_config().max_num_cars_student
TRAIN_KERNELS = ("crop_shared", "crop_shared_bwd", "pillar_scatter_max",
                 "pillar_scatter_max_bwd", "scatter_add")
TRAIN_BF16_KERNELS = ("crop_shared", "crop_shared_bwd_bf16",
                      "pillar_scatter_max_bf16",
                      "pillar_scatter_max_bwd_bf16", "scatter_add")
B_REF = 32                  # lav_tpu/train/cli.py:239, the full stage's
                            # default batch
TRAIN_LEAVES = ("lidar_model.point_pillar.linear_0.w",
                "lidar_model.backbone.conv2_0.conv.w",
                "uniplanner.lidar_conv_emb.conv1.w",
                "uniplanner.cast_grus.w_ih")
B_BEV = 64                  # bench_train.py's default --batch-size
B_SEG = 32                  # the stage-1 trainers' batches, cut from the
B_BRA = 8                   # reference's 256 / 256 / 52 (PERF.md section 4)
PRIV_LEAVES = {
    "bev": ("bev_conv_emb.conv1.w", "bev_conv_emb.layer4_1.conv2.w",
            "plan_gru.w_ih", "cast_grus.w_ih"),
    "seg": ("erfnet.initial.conv.w", "erfnet.enc_7.conv3x1_2.w",
            "erfnet.dec_1.conv1x3_1.w", "erfnet.output_conv.w"),
    "bra": ("conv_backbone.conv1.w", "conv_backbone.layer4_1.conv2.w",
            "seg_head.up1.w", "classifier.w"),
}
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA data sheet
F32_FLOPS = 67e12           # H100 SXM non-tensor f32
INT8_OPS = 1979e12          # H100 SXM dense int8 tensor cores

# tolerances, each with its reason
CROP_F32_ATOL = 1e-5        # same f32 arithmetic; FMA contraction only
CROP_BF16_ULPS = 1.0        # both round one f32 sum; FMA may flip 1 ulp
CROP_Q8_STEPS = 1           # an FMA-rounded f32 sum may cross a rounding
CROP_Q8_FRACTION = 0.01     # boundary: 1 step, on at most 1% of values
SCATTER_ADD_RTOL = 1e-6     # of the pillar's sum of |v|: the floor a
                            # sum in another order is held to (the parent's
                            # atomic scatter_add, utils/turns.py add)
CROP_BWD_RTOL = 4e-6        # of a cell's sum of |g w|: up to ~60 terms
                            # added in any order, (n - 1) 2^-24 each
CROP_BWD_BF16_ULPS = 1.0    # bf16: each side rounds its f32 sum once
TRAIN_LOSS_RTOL = 1e-4      # card vs CPU step: cuDNN's and the CPU's conv
TRAIN_GNORM_RTOL = 1e-2     # sums and crop_shared_bwd's order, amplified
TRAIN_LEAF_L2 = 5e-2        # by train-mode BN
# the stage-1 trainers' step 1, card vs CPU (loss rtol, grad_norm rtol,
# leaf L2): the BEV step as the distillation step; the camera steps' own
# gradients move by 0.2% (brake) and 2-5% (seg, its dropout masks fixed)
# when the images are scaled by 1 + 1e-6 (tests/test_torch_rgb_train.py)
# the bf16 step's step 1, card vs CPU: loss rtol, grad_norm rtol (measured
# on an H100 80GB HBM3 at 700 W: 1.6e-3, 8.6e-3).  Its gradient leaves are
# not compared: train-mode BN turns bf16 rounding at other places in
# cuDNN's and the CPU's convs into leaves that lie about their own size
# apart (0.86-0.97 in L2 there; tests/test_torch_train_bf16.py).  They are
# held in one bf16 forward and backward of the step's loss with BN on its
# running statistics (models in eval mode): loss rtol, grad_norm rtol,
# leaf L2, which a zeroed (1.0) or sign-flipped (2.0) leaf fails
# (measured there: 4.7e-6, 2.4e-6, 2.0e-3-5.1e-2, without the point
# MLP's leaf, whose eval gradient goes through kernel scatter_max_bwd)
TRAIN_BF16_TOLS = (1e-2, 5e-2)
TRAIN_BF16_EVAL_TOLS = (1e-4, 1e-3, 0.15)
EVAL_LEAF = ("lidar_model.backbone.conv1_0.conv.w",)
PRIV_TOLS = {"bev": (TRAIN_LOSS_RTOL, TRAIN_GNORM_RTOL, TRAIN_LEAF_L2),
             "seg": (1e-4, 2e-2, 1e-1),
             "bra": (1e-4, 1e-2, 5e-2)}
AGENT_ATOL = 1e-3           # cuDNN vs CPU conv summation order, f32
AGENT_RTOL = 1e-3
PROD_ATOL = 3e-2            # the int8 golden's (test_golden_production.py)
PROD_RTOL = 3e-2


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def cuda_ms(torch, fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean time of fn() in ms, from CUDA events around `iters` runs back to
    back: the host-paced time, which is the host's cost per call where
    that exceeds the device's work."""
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


def profiled(torch, fn, iters: int = 20, warmup: int = 2):
    """torch.profiler's key_averages() over `iters` runs of fn() and
    {kernel or fill: its mean device-only ms per call}; the split is {}
    when the profiler recorded no device activity in three runs (it now
    and then records none)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        avgs = prof.key_averages()
        split = {e.key: e.self_device_time_total / iters / 1e3
                 for e in avgs if e.device_type == DeviceType.CUDA}
        if sum(split.values()) > 0:
            return avgs, split
    return avgs, {}


def device_split(torch, fn, iters: int = 20, warmup: int = 2) -> dict:
    """{kernel or fill: its mean device-only ms per fn() call}
    (`profiled`)."""
    return profiled(torch, fn, iters, warmup)[1]


def device_ms(torch, fn, iters: int = 20, warmup: int = 2) -> float:
    """Mean device-only time of fn() in ms: the summed durations of the
    kernels and fills it runs (`device_split`); the host's time between
    launches is left out.  When the profiler records nothing, the time is
    taken with CUDA events around single calls, each after a synchronize
    (the median), and the log says so."""
    split = device_split(torch, fn, iters, warmup)
    if split:
        return sum(split.values())
    log("timing", "the profiler saw no device time in three runs: CUDA "
        "events around single calls instead")
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(iters):
        torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_us(torch, fn, n: int = 200) -> float:
    """Host cost of one fn() call in us: the best of three loops of n calls
    on the host clock, with no synchronize inside a loop, less the same
    loop of an empty call."""
    def loop(f):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            f()
        t = time.perf_counter() - t0
        torch.cuda.synchronize()
        return t

    fn()
    spent = min(loop(fn) for _ in range(3))
    empty = min(loop(lambda: None) for _ in range(3))
    return (spent - empty) / n * 1e6


def bound_ms(nbytes: float, flops: float = 0.0, peak: float = F32_FLOPS):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def crop_bytes(torch, src, grid, out_elem: int) -> int:
    """The bytes a crop of src (B, H, W, C) on grid (B, K, Ho, Wo, 2) must
    move: the source pixels its taps read, each once (the four taps of
    every output pixel, the origin clamped as the kernels clamp it,
    counted per item: a crop reads its window, not the whole source), the
    grid, and the output at `out_elem` bytes an element."""
    B, H, W, C = src.shape
    g = torch.nan_to_num(grid.float())
    x0 = torch.clamp(torch.floor((g[..., 0] + 1.0) * 0.5 * (W - 1)), 0,
                     W - 2).long()
    y0 = torch.clamp(torch.floor((g[..., 1] + 1.0) * 0.5 * (H - 1)), 0,
                     H - 2).long()
    base = (y0 * W + x0).reshape(B, -1)
    pixels = sum(torch.unique(torch.cat([t, t + 1, t + W, t + W + 1]))
                 .numel() for t in base)
    return (pixels * C * src.element_size() + grid.numel() * 4
            + grid[..., 0].numel() * C * out_elem)


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
        regs = [ln.strip() for ln in out.splitlines()
                if any(w in ln for w in ("registers", "spill", "arning"))]
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

    from lav_tpu_torch.core.warp import crop_shared, grid_sample_shared

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
        dev_ms = device_ms(torch, lambda: crop_shared(src, grid))
        plain_ms = cuda_ms(torch, lambda: grid_sample_shared(src, grid),
                           iters=3, warmup=1)
        # library yardstick, timed only: F.grid_sample per ego on the
        # source expanded over its K crops (a stride-0 batch, native
        # kernel, NCHW output), in the source's dtype, which F.grid_sample
        # wants the grid in too (on the CPU in f32 only: bf16 with a
        # stride-0 source crashed there)
        lib_ms = None
        if dtype == torch.float32 or dev.type == "cuda":
            nchw = src.permute(0, 3, 1, 2)
            lib_grid = grid.to(dtype)
            with torch.backends.cudnn.flags(enabled=False):
                lib_ms = cuda_ms(torch, lambda: [
                    F.grid_sample(nchw[b:b + 1].expand(K, C, H, W),
                                  lib_grid[b], mode="bilinear",
                                  padding_mode="zeros", align_corners=True)
                    for b in range(B)])
        nbytes = crop_bytes(torch, src, grid, src.element_size())
        flops = B * K * Ho * Wo * (8 * C + 24)
        bms, by = bound_ms(nbytes, flops)
        res[name] = dict(max_abs_err=err, ms=ms, device_ms=dev_ms,
                         plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bms,
                         bound_by=by)
        log("crop", f"{name}: kernel {ms:.4f} ms host-paced, {dev_ms:.4f} "
            f"ms device-only, plain {plain_ms:.4f} ms, F.grid_sample "
            f"{lib_ms} ms, bound {bms:.4f} ms ({by}, {nbytes / 1e6:.1f} MB): "
            f"device-only {bms / dev_ms:.0%} of the bound on "
            f"{ctx.get('smi', '?')}")
        del src, grid, out, ref
        torch.cuda.empty_cache()
    res["narrow"] = _crop_narrow(torch, ctx, dev)
    _crop_grid_sample(torch, ctx, dev)
    bev = _crop_bev(torch, ctx, dev)
    q8 = _crop_q8(torch, ctx, dev)
    res["q8"], res["q8_s2d"] = q8["q8"], q8["s2d"]
    res["float32"].update({f"bf16_{k}": v for k, v in res["bfloat16"].items()
                           if k != "bound_by"})
    res["float32"].update({f"bev_{k}": v for k, v in bev.items()})
    res["float32"]["narrow"] = res.pop("narrow")
    ctx["crop"] = res


def _crop_grid_sample(torch, ctx, dev):
    """core.warp.grid_sample (lav_tpu's per-item sampler, one crop an
    item) on the card: crop_shared launched once, counted, and its output
    against the CPU's on the same inputs (the f32 agent's sources, each
    ego's ego-centred 96x96 crop)."""
    from lav_tpu_torch.core.warp import grid_sample
    from lav_tpu_torch.utils import native

    src, grid = _agent_crop_inputs(torch, dev, torch.float32)
    grid = grid[:, -1].contiguous()        # (B, Ho, Wo, 2)
    native.reset_launches()
    out = grid_sample(src, grid)
    torch.cuda.synchronize()
    ctx["launches_grid_sample"] = {"crop_shared": native.LAUNCHES[
        "crop_shared"]}
    ref = grid_sample(src.cpu(), grid.cpu())
    err = (out.cpu() - ref).abs().max().item()
    log("crop", f"grid_sample f32 {tuple(src.shape)} at {tuple(grid.shape)}"
        f": crop_shared launched {ctx['launches_grid_sample']} time(s), "
        f"card vs CPU max_abs_err {err:.3e} (tol {CROP_F32_ATOL:.0e})")
    if ctx["launches_grid_sample"]["crop_shared"] != 1 or not (
            err <= CROP_F32_ATOL and out.shape == ref.shape):
        raise AssertionError("grid_sample on the card: no crop_shared "
                             "launch, or it disagrees with the CPU")


def _crop_narrow(torch, ctx, dev):
    """crop_shared's narrow route (rows that are no 16-byte vectors, or
    pointers off 16-byte boundaries): C in {1, 3, 9} with the source one
    element off a 16-byte boundary (the wrapper sends it to vec = 1), and
    through the C entry with the output one element off too, in f32 and
    bf16; and C = 5 aligned (the 5-channel teacher BEV's shape family).
    Each against its plain version (f32 to CROP_F32_ATOL, bf16 to
    CROP_BF16_ULPS of the largest value) and timed host-paced and
    device-only beside F.grid_sample.  8 sources of 160x160, 5 crops of
    96x96 each, one straddling the border, one wholly outside."""
    import torch.nn.functional as F

    from lav_tpu_torch.core.warp import (
        affine_grid, crop_shared, crop_theta, grid_sample_shared,
    )
    from lav_tpu_torch.utils import native

    g = torch.Generator(device="cpu").manual_seed(3)
    B, H, K, crop = 8, 160, 5, 96
    locs = (torch.rand((B, K, 2), generator=g) * 2 - 1) * 15.0
    locs[0, 0], locs[0, 1] = torch.tensor([38.0, -39.0]), torch.tensor(
        [1e3, -1e3])
    theta = crop_theta(locs.reshape(-1, 2),
                       torch.rand((B * K,), generator=g) * 6.0, H, H, 2.0,
                       crop, 0.0, 0.75)
    grid = affine_grid(theta, crop, crop).reshape(B, K, crop, crop, 2).to(
        dev).contiguous()
    res = {}
    for dtype in (torch.float32, torch.bfloat16):
        dt = "f32" if dtype == torch.float32 else "bf16"
        for C, off in ((1, 1), (3, 1), (9, 1), (5, 0)):
            n = B * H * H * C
            base = torch.randn((n + 8,), generator=g).to(dev, dtype)
            src = base[off:off + n].view(B, H, H, C)
            ref = grid_sample_shared(src, grid)
            outs = {"wrapper": crop_shared(src, grid)}
            if off:   # the output off its boundary too, through the entry
                buf = torch.empty(ref.numel() + 8, dtype=dtype, device=dev)
                moved = buf[off:off + ref.numel()].view(ref.shape)
                native.launch(native.ENTRIES[f"crop_shared_{dt}"],
                              src.get_device(), src.data_ptr(),
                              grid.data_ptr(), moved.data_ptr(), B, H, H, C,
                              K, crop, crop, 1)
                outs["output off 16 bytes"] = moved
            torch.cuda.synchronize()
            scale = ref.float().abs().max().item()
            tol = CROP_F32_ATOL if dtype == torch.float32 else (
                CROP_BF16_ULPS * 2.0 ** -7 * 2.0 ** math.ceil(
                    math.log2(max(scale, 1e-30))))
            errs = {k: (v.float() - ref.float()).abs().max().item()
                    for k, v in outs.items()}
            far = outs["wrapper"][0, 1].float().abs().max().item()
            if not (max(errs.values()) <= tol and far == 0.0
                    and all(torch.isfinite(v).all() for v in outs.values())):
                raise AssertionError(f"crop_shared {dt} C={C} (narrow) "
                                     f"disagrees with plain: {errs} > {tol}")
            nchw, lib_grid = src.permute(0, 3, 1, 2), grid.to(dtype)

            def lib():
                with torch.backends.cudnn.flags(enabled=False):
                    return [F.grid_sample(
                        nchw[b:b + 1].expand(K, C, H, H), lib_grid[b],
                        mode="bilinear", padding_mode="zeros",
                        align_corners=True) for b in range(B)]

            nbytes = crop_bytes(torch, src, grid, src.element_size())
            bms, by = bound_ms(nbytes, B * K * crop * crop * (8 * C + 24))
            r = dict(max_abs_err=max(errs.values()),
                     ms=cuda_ms(torch, lambda: crop_shared(src, grid),
                                iters=20),
                     device_ms=device_ms(torch,
                                         lambda: crop_shared(src, grid)),
                     library_ms=cuda_ms(torch, lib, iters=5),
                     library_device_ms=device_ms(torch, lib, iters=5),
                     bound_ms=bms, bound_by=by)
            res[f"{dt}_C{C}"] = r
            log("crop", f"narrow {dt} C={C}, source {off * src.element_size()}"
                f" bytes off 16: max_abs_err {errs} (tol {tol:.3e}); kernel "
                f"{r['ms']:.4f} ms host-paced, {r['device_ms']:.4f} "
                f"device-only, F.grid_sample {r['library_ms']:.4f} / "
                f"{r['library_device_ms']:.4f}, bound {bms:.4f} ms ({by}, "
                f"{nbytes / 1e6:.1f} MB) on {ctx.get('smi', '?')}")
            del base, src, ref, outs
    return res


def _bev_crop_inputs(torch, dev):
    """The BEV trainer's crop_shared inputs: B_BEV sources of the v2 BEV
    (320x320x9 f32), K = max_num_cars = 5 rotated crops of 192x192 each
    (ppm 4, offset_y as the trainer's), item 0's first straddling the
    border and its second wholly outside."""
    from lav_tpu_torch.config import v2_config
    from lav_tpu_torch.core.warp import affine_grid, crop_theta

    cfg = v2_config()
    B, K, crop = B_BEV, cfg.max_num_cars, cfg.crop_size * 2
    H, W, C = cfg.ny, cfg.nx, cfg.bev_input_channels
    g = torch.Generator(device="cpu").manual_seed(2)
    src = torch.rand((B, H, W, C), generator=g).to(dev)
    locs = torch.randn((B, K, 2), generator=g) * 8.0
    oris = (torch.rand((B, K), generator=g) * 2 - 1) * math.pi
    locs[0, 0] = torch.tensor([38.0, -39.0])
    locs[0, 1] = torch.tensor([1e3, -1e3])
    theta = crop_theta(locs.reshape(-1, 2), oris.reshape(-1), H, W,
                       float(cfg.pixels_per_meter), crop, 0.0, cfg.y_offset)
    grid = affine_grid(theta, crop, crop).reshape(B, K, crop, crop, 2).to(
        dev).contiguous()
    return src, grid


def _crop_bev(torch, ctx, dev):
    """crop_shared at the BEV trainer's shapes (phase privileged,
    `_bev_crop_inputs`) against its plain version, timed beside it and
    F.grid_sample."""
    import torch.nn.functional as F

    from lav_tpu_torch.core.warp import crop_shared, grid_sample_shared

    src, grid = _bev_crop_inputs(torch, dev)
    B, H, W, C = src.shape
    _, K, crop, _, _ = grid.shape
    out = crop_shared(src, grid)
    ref = grid_sample_shared(src, grid)
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    far = out[0, 1].abs().max().item()
    log("crop", f"BEV B={B} {H}x{W}x{C}, K={K} crops of {crop}: max_abs_err "
        f"{err:.3e} (tol {CROP_F32_ATOL:.0e}), far crop max |out| {far}")
    if not (err <= CROP_F32_ATOL and far == 0.0):
        raise AssertionError("crop_shared disagrees with plain at the BEV "
                             "trainer's shapes")
    del ref
    nchw = src.permute(0, 3, 1, 2)
    with torch.backends.cudnn.flags(enabled=False):
        lib_ms = cuda_ms(torch, lambda: [
            F.grid_sample(nchw[b:b + 1].expand(K, C, H, W), grid[b],
                          mode="bilinear", padding_mode="zeros",
                          align_corners=True) for b in range(B)], iters=5)
    nbytes = crop_bytes(torch, src, grid, 4)
    bms, by = bound_ms(nbytes, B * K * crop * crop * (8 * C + 24))
    r = dict(max_abs_err=err, ms=cuda_ms(torch, lambda: crop_shared(src, grid)),
             device_ms=device_ms(torch, lambda: crop_shared(src, grid)),
             plain_ms=cuda_ms(torch, lambda: grid_sample_shared(src, grid),
                              iters=3, warmup=1),
             library_ms=lib_ms, bound_ms=bms, bound_by=by)
    log("crop", f"BEV: kernel {r['ms']:.4f} ms host-paced, "
        f"{r['device_ms']:.4f} ms device-only ({bms / r['device_ms']:.0%} of "
        f"the bound), plain {r['plain_ms']:.4f} ms, F.grid_sample "
        f"{lib_ms:.4f} ms, bound {bms:.4f} ms ({by}, {nbytes / 1e6:.1f} MB) "
        f"on {ctx.get('smi', '?')}")
    del src, grid, out
    torch.cuda.empty_cache()
    return r


def _q8_check(torch, label, out, ref, far=None):
    """An int8 crop against its plain version: at most CROP_Q8_STEPS on at
    most CROP_Q8_FRACTION of the values, and the crop wholly outside
    (index `far` of dim 1) exactly 0; returns the largest step."""
    diff = (out.int() - ref.int()).abs()
    err = int(diff.max())
    frac = float((diff > 0).float().mean())
    far_max = 0 if far is None else int(out[:, far].abs().max())
    log("crop", f"{label}: {tuple(out.shape)}, max step diff {err} (tol "
        f"{CROP_Q8_STEPS}), values off {frac:.2e} (tol {CROP_Q8_FRACTION})"
        + ("" if far is None else f", far crop max |out| {far_max}"))
    if out.dtype != torch.int8 or err > CROP_Q8_STEPS or \
            frac > CROP_Q8_FRACTION or far_max != 0:
        raise AssertionError(f"{label} disagrees with plain")
    return err


def _crop_q8(torch, ctx, dev):
    """crop_shared_q8: an f32 source at the f32 agent's shapes (the f32 +
    int8 configuration), then a bf16 source at the production shapes,
    where crop_shared_q8_s2d is checked too; host-paced in turns,
    device-only and host us per call.  Then both int8 forms on a zoom-out
    crop and on 90x90 crops.  x_scale = absmax / 127 so that the int8
    range is used."""
    from lav_tpu_torch.core.warp import (
        crop_shared, grid_sample_shared_q8, inverse_scale, space_to_depth,
    )

    f32 = {}
    for dtype, E in ((torch.float32, NUM_EGO),
                     (torch.bfloat16, NUM_EGO_PROD)):
        src, grid = _agent_crop_inputs(torch, dev, dtype, E=E)
        x_scale = (src.float().abs().max() / 127.0).reshape(())
        out = crop_shared(src, grid, q8_x_scale=x_scale)
        ref = grid_sample_shared_q8(src, grid, inverse_scale(x_scale))
        torch.cuda.synchronize()
        name = str(dtype).replace("torch.", "")
        err = _q8_check(torch, f"q8 ({name} source, {E} egos)", out, ref,
                        far=1)
        if dtype == torch.float32:
            def run():
                crop_shared(src, grid, q8_x_scale=x_scale)
            f32 = dict(f32_max_abs_err=float(err), f32_ms=cuda_ms(torch, run),
                       f32_device_ms=device_ms(torch, run),
                       f32_bound_ms=bound_ms(src.numel() * 4 + grid.numel()
                                             * 4 + out.numel())[0])
            log("crop", f"q8 ({name} source, {E} egos): kernel "
                f"{f32['f32_ms']:.4f} ms host-paced, "
                f"{f32['f32_device_ms']:.4f} ms device-only, bound "
                f"{f32['f32_bound_ms']:.4f} ms (bytes)")
            del src, grid, out, ref
    # the space-to-depth form (LAV_S2D_CROPS=1) on the same production
    # inputs: the same sums and rounding, only the store moves, so it must
    # equal the q8 kernel's crops reshuffled exactly
    s2d = crop_shared(src, grid, q8_x_scale=x_scale, s2d=True)
    torch.cuda.synchronize()
    same = torch.equal(s2d, space_to_depth(out))
    log("crop", f"q8 s2d ({NUM_EGO_PROD} egos): equal to crop_shared_q8 "
        f"reshuffled {same}")
    err_s2d = _q8_check(torch, f"q8 s2d ({NUM_EGO_PROD} egos)", s2d,
                        space_to_depth(ref))
    if not same:
        raise AssertionError("crop_shared_q8_s2d disagrees")
    del ref
    inv = inverse_scale(x_scale)
    B, H, W, C = src.shape
    _, K, Ho, Wo, _ = grid.shape
    nbytes = crop_bytes(torch, src, grid, 1)
    flops = B * K * Ho * Wo * (10 * C + 24)
    bms, by = bound_ms(nbytes, flops)
    res = {}
    run = {form: (lambda form=form: crop_shared(
        src, grid, q8_x_scale=x_scale, s2d=form == "s2d"))
        for form in ("q8", "s2d")}
    # in turns, q8 then s2d then s2d then q8, so that both see one card
    t = {"q8": [], "s2d": []}
    for form in ("q8", "s2d", "s2d", "q8"):
        t[form].append((cuda_ms(torch, run[form]),
                        device_ms(torch, run[form])))
    plain = {"q8": lambda: grid_sample_shared_q8(src, grid, inv),
             "s2d": lambda: space_to_depth(grid_sample_shared_q8(src, grid,
                                                                 inv))}
    for form, e in (("q8", err), ("s2d", err_s2d)):
        ms = statistics.mean(h for h, _ in t[form])
        dev_ms = statistics.mean(d for _, d in t[form])
        hus = host_us(torch, run[form], n=50)
        plain_ms = cuda_ms(torch, plain[form], iters=1, warmup=1)
        log("crop", f"{form}: kernel host-paced {ms:.4f} ms ("
            f"{t[form][0][0]:.4f}, {t[form][1][0]:.4f}), device-only "
            f"{dev_ms:.4f} ms ({t[form][0][1]:.4f}, {t[form][1][1]:.4f}), "
            f"host {hus:.1f} us a call, plain {plain_ms:.4f} ms, no library "
            f"call (none crops and quantizes), bound {bms:.4f} ms ({by}, "
            f"{nbytes / 1e6:.1f} MB) on {ctx.get('smi', '?')}")
        res[form] = dict(max_abs_err=float(e), ms=ms, device_ms=dev_ms,
                         host_us=hus, plain_ms=plain_ms, library_ms=None,
                         bound_ms=bms, bound_by=by)
    res["q8"].update(f32)
    del src, grid, out, s2d
    torch.cuda.empty_cache()
    _crop_q8_shapes(torch, dev)
    return res


def _crop_q8_shapes(torch, dev):
    """Both int8 forms off the agent's shapes, bf16 source 160x160x384:
    zoom-out crops (crop_size 192 sampled at 96x96, 2 source pixels an
    output pixel, at 45 degrees and others: a tile's taps spread over
    four times the agent's source window) and 90x90 crops (Ho, Wo not a
    multiple of the kernel's 16x16 tile: partial tiles; even, for s2d)."""
    from lav_tpu_torch.core.warp import (
        affine_grid, crop_shared, crop_theta, grid_sample_shared_q8,
        inverse_scale, space_to_depth,
    )

    g = torch.Generator(device="cpu").manual_seed(11)
    src = torch.randn((2, 160, 160, 384), generator=g).to(dev,
                                                          torch.bfloat16)
    x_scale = (src.float().abs().max() / 127.0).reshape(())
    oris = torch.tensor([[math.pi / 4, 0.3, -2.0, math.pi / 2],
                         [math.pi / 4, 1.2, 3.0, 0.0]])
    locs = torch.tensor([[[0.0, 0.0], [5.0, -3.0], [38.0, -39.0],
                          [1e3, -1e3]],
                         [[2.0, 1.0], [-6.0, 4.0], [0.0, 10.0],
                          [-20.0, 0.0]]])
    for label, crop, size in (("zoom-out", 192, 96), ("90x90", 90, 90)):
        theta = crop_theta(locs.reshape(-1, 2), oris.reshape(-1), 160, 160,
                           2.0, crop, 0.0, 0.75)
        grid = affine_grid(theta, size, size).reshape(2, 4, size, size, 2)
        grid = grid.to(dev).contiguous()
        out = crop_shared(src, grid, q8_x_scale=x_scale)
        ref = grid_sample_shared_q8(src, grid, inverse_scale(x_scale))
        s2d = crop_shared(src, grid, q8_x_scale=x_scale, s2d=True)
        torch.cuda.synchronize()
        _q8_check(torch, f"q8 {label}", out, ref)
        _q8_check(torch, f"q8 s2d {label}", s2d, space_to_depth(ref))
        same = torch.equal(s2d, space_to_depth(out))
        log("crop", f"q8 s2d {label}: equal to q8 reshuffled {same}")
        if not same:
            raise AssertionError(f"crop_shared_q8_s2d {label} disagrees")
        del grid, out, ref, s2d
    del src
    torch.cuda.empty_cache()


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
    canvas = torch.full((E * S, C), NEG, device=dev)
    ctx["pillar"] = dict(max_abs_err=err, **_time_canvas(
        torch, ctx, "pillar", "f32", pillar_scatter_max,
        pillar_scatter_max_plain, canvas, feat, pid, E * S))
    del feat, pid, out, ref, canvas
    ctx["pillar_bf16"] = _pillar_bf16(torch, ctx, dev)
    _canvas_cases(torch, dev)


def _pillar_bf16(torch, ctx, dev):
    """The bf16 form (BENCH_PALLAS=1 under bf16) at the production shapes:
    16 x 60000 points, 64 channels, 16 x (102400 + 1) pillars, masked
    points at NEG in the in-range dump slots, duplicates, empty pillars
    and negative values."""
    from lav_tpu_torch.ops.pillar import (
        NEG, pillar_scatter_max, pillar_scatter_max_plain,
    )

    g = torch.Generator(device="cpu").manual_seed(6)
    E, P, C = NUM_EGO_PROD, 2 * MAX_POINTS_PROD * 3, 64
    G = 320 * 320
    S = G + 1
    feat = torch.randn((E, P, C), generator=g)
    local = torch.randint(0, G // 8, (E, P), generator=g)
    invalid = torch.rand((E, P), generator=g) < 0.2
    local[invalid] = G
    feat[invalid] = NEG
    pid = (local + torch.arange(E)[:, None] * S).reshape(-1)
    feat = feat.reshape(-1, C).to(dev, torch.bfloat16)
    pid = pid.to(torch.int32).to(dev)
    out = pillar_scatter_max(feat, pid, E * S)
    ref = pillar_scatter_max_plain(feat, pid, E * S)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    empty = (ref == 0).all(dim=1).float().mean().item()
    dump_zero = bool((ref.reshape(E, S, C)[:, G] == 0).all())
    log("pillar", f"bf16 ({E} egos): max_abs_err {err} (must be 0), empty "
        f"pillars {empty:.3f}, dump slots 0 {dump_zero}")
    if err != 0.0 or not torch.equal(out, ref) or not dump_zero:
        raise AssertionError("pillar_scatter_max bf16 disagrees with plain")
    canvas = torch.full((E * S, C), NEG, dtype=torch.bfloat16, device=dev)
    res = dict(max_abs_err=err, **_time_canvas(
        torch, ctx, "pillar", "bf16", pillar_scatter_max,
        pillar_scatter_max_plain, canvas, feat, pid, E * S))
    del feat, pid, out, ref, canvas
    torch.cuda.empty_cache()
    return res


def _time_canvas(torch, ctx, phase, label, kernel, plain, canvas, feat, pid,
                 S, with_plain=True):
    """A canvas max on (feat, pid, S): host-paced (`ms`) and device-only
    ms and host us per call, beside scatter_reduce_ "amax" into `canvas`
    (the same function given a filled canvas; it may hold rows past S for
    the ids the kernel drops) and the plain version; the bound counts
    payload, ids and the S-row canvas once."""
    idx = pid.long()[:, None].expand(-1, feat.shape[1])

    def lib():
        canvas.scatter_reduce_(0, idx, feat, "amax", include_self=True)

    split = device_split(torch, lambda: kernel(feat, pid, S))
    log(phase, f"{label}: device-only ms by kernel: " + ", ".join(
        f"{re.sub(r'[(]anonymous namespace[)]::|^void ', '', k).split('(')[0]} "
        f"{v:.4f}" for k, v in sorted(split.items(), key=lambda kv: -kv[1])))
    r = dict(ms=cuda_ms(torch, lambda: kernel(feat, pid, S), iters=20),
             device_ms=device_ms(torch, lambda: kernel(feat, pid, S)),
             host_us=host_us(torch, lambda: kernel(feat, pid, S)),
             plain_ms=(cuda_ms(torch, lambda: plain(feat, pid, S))
                       if with_plain else None),
             library_ms=cuda_ms(torch, lib, iters=20),
             library_device_ms=device_ms(torch, lib),
             library_host_us=host_us(torch, lib))
    nbytes = (feat.numel() * feat.element_size() + pid.numel() * 4
              + S * feat.shape[1] * feat.element_size())
    r["bound_ms"], r["bound_by"] = bound_ms(nbytes, feat.numel())
    log(phase, f"{label}: kernel {r['ms']:.4f} ms host-paced, "
        f"{r['device_ms']:.4f} ms device-only, {r['host_us']:.1f} us host "
        f"per call; plain {r['plain_ms']} ms; scatter_reduce_ "
        f"{r['library_ms']:.4f} / {r['library_device_ms']:.4f} ms, "
        f"{r['library_host_us']:.1f} us; bound "
        f"{r['bound_ms']:.4f} ms ({r['bound_by']}, {nbytes / 1e6:.1f} MB): "
        f"device-only {r['device_ms'] / r['bound_ms']:.2f}x the bound on "
        f"{ctx.get('smi', '?')}")
    del idx
    return r


def _canvas_cases(torch, dev):
    """The four canvas-max entries (scatter_max and pillar_scatter_max, bf16
    and f32) on crafted cases, each exact against its plain version with
    NaN positions equal: NaN, -0.0, -inf and NEG lanes among negative
    values with ids out of range on both sides; one pillar of 5,000 points
    with a NaN lane among them; every id out of range; no point; C = 2 and
    C = 66; a feat that starts 4 bytes into its storage."""
    from lav_tpu_torch.ops.pillar import (
        NEG, pillar_scatter_max, pillar_scatter_max_plain, scatter_max,
        scatter_max_plain,
    )

    g = torch.Generator(device="cpu").manual_seed(7)
    N, S = 20000, 10000

    def lanes(C):
        f = torch.randn((N, C), generator=g)
        r = torch.rand((N, C), generator=g)
        f[r < 0.01] = float("nan")
        f[(r >= 0.01) & (r < 0.03)] = -0.0
        f[(r >= 0.03) & (r < 0.04)] = NEG
        f[(r >= 0.04) & (r < 0.045)] = float("-inf")
        return f

    ids = torch.randint(0, S, (N,), generator=g)
    ids[:300], ids[300:600] = -1 - torch.arange(300), S + torch.arange(300)
    hot = ids.clone()
    hot[1000:6000] = 17
    hot_feat = torch.randn((N, 64), generator=g)
    hot_feat[4321, 5] = float("nan")
    cases = {
        "NaN, -0.0, -inf, NEG lanes; ids outside": (lanes(64), ids),
        "one pillar of 5000 points, a NaN lane": (hot_feat, hot),
        "every id outside": (lanes(64), torch.where(
            torch.arange(N) % 2 == 0, S + torch.arange(N) % 7,
            -1 - torch.arange(N) % 5)),
        "no point": (torch.zeros((0, 64)), torch.zeros((0,))),
        "C = 2": (lanes(2), ids),
        "C = 66": (lanes(66), ids),
    }
    kernels = (("scatter_max", scatter_max, scatter_max_plain),
               ("pillar_scatter_max", pillar_scatter_max,
                pillar_scatter_max_plain))
    for dtype in (torch.bfloat16, torch.float32):
        items = [(k, f.to(dev, dtype), p.to(dev, torch.int32))
                 for k, (f, p) in cases.items()]
        # 4 bytes into its storage: 16-byte pieces are not aligned
        base = torch.empty(N * 64 * 2 + 16, dtype=dtype, device=dev)
        shift = 4 // base.element_size()
        moved = base[shift:shift + N * 64].view(N, 64)
        moved.copy_(items[0][1])
        items.append(("feat 4 bytes into its storage", moved, items[0][2]))
        for label, f, p in items:
            for name, kernel, plain in kernels:
                out = kernel(f, p, S)
                ref = plain(f, p, S)
                torch.cuda.synchronize()
                try:
                    torch.testing.assert_close(out, ref, rtol=0, atol=0,
                                               equal_nan=True)
                except AssertionError as e:
                    raise AssertionError(
                        f"{name} {dtype} on '{label}' disagrees with its "
                        f"plain version: {e}") from None
        nans = [torch.isnan(k(items[0][1], items[0][2], S)).sum().item()
                for _, k, _ in kernels]
        log("pillar", f"canvas max {str(dtype)[6:]}: {len(items)} crafted "
            f"cases exact for scatter_max and pillar_scatter_max (NaN "
            f"positions equal; NaN cells in the first case: {nans[0]} and "
            f"{nans[1]})")


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
    # a contention case, no recorded traffic: 30% of the valid points
    # come in runs of 16 equal ids onto 64 pillars per ego
    run = torch.arange(E * P).reshape(E, P) // 16
    hot = (run % 10 < 3) & ~invalid
    runs_pid = torch.where(hot, (run % 64) * 97 + torch.arange(E)[:, None] * G,
                           pid.reshape(E, P)).reshape(-1)
    pid = pid.to(torch.int32).to(dev)
    runs_pid = runs_pid.to(torch.int32).to(dev)
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
            canvas = torch.zeros((S, C), dtype=dtype, device=dev)
            res["max"] = dict(max_abs_err=err, **_time_canvas(
                torch, ctx, "scatter", "max bf16", scatter_max,
                scatter_max_plain, canvas, feat, pid, S))
            del canvas
        del feat, out, ref
    # add: the decoration sums, xyz of the valid points and a count lane
    xyz = (torch.rand((E * P, 3), generator=g) * 60.0 - 20.0)
    keep = ~invalid.reshape(-1, 1)
    feat = torch.cat([torch.where(keep, xyz, 0.0), keep.float()],
                     dim=-1).to(dev)
    res["add"] = _scatter_add_case(torch, ctx, "phase ids", feat, pid, S,
                                   plain=True)
    res["add"]["runs_of_16"] = _scatter_add_case(torch, ctx, "runs of 16",
                                                 feat, runs_pid, S)
    del feat, pid, runs_pid, xyz
    # the ids and payloads the agent itself hands the kernels
    agent = _agent_scatter_inputs(torch, ctx)
    res["add"]["real_ids"] = {
        label: _scatter_add_case(torch, ctx, f"agent {label}", *args)
        for label, args in agent["add"].items()}
    res["max"]["real_ids"] = {
        label: _scatter_max_agent(torch, ctx, label, *args)
        for label, args in agent["max"].items()}
    ctx["scatter"] = res
    ctx["scatter_bwd"] = _scatter_max_bwd_cases(torch, ctx, dev,
                                                agent["max"])


def _scatter_max_bwd_cases(torch, ctx, dev, agent_max):
    """Kernel scatter_max_bwd (the production eval canvas' gradient)
    against its plain version, exact with NaN positions equal, on the
    forward's sort and sorting itself: on the canvas of the production
    tick whose ring buffer is full (16 egos, bf16, and its payload in
    f32), on the f32 agent's canvas shapes (4 x 49152 points, 64
    channels, 4 x 102400 rows; post-ReLU payload, a fifth invalid), and
    on crafted rows of 255, 256, 257, 300 and 1,000 points tied at 0 and
    at 3.0, with a NaN payload lane and a NaN and an inf in g, f32 and
    bf16.  The first two are timed: host-paced and device-only ms and host
    us per call, beside the plain version and autograd through
    scatter_reduce "amax" into a zero canvas (include_self, which splits
    ties among the points and the zero too)."""
    label, (feat, pid, S) = [(k, v) for k, v in agent_max.items()
                             if k != "tick 1"][0]
    g = torch.Generator(device="cpu").manual_seed(12)
    E, P, G = NUM_EGO, 2 * MAX_POINTS * 3, 320 * 320
    local = torch.randint(0, G // 4, (E, P), generator=g)
    invalid = torch.rand((E, P), generator=g) < 0.2
    agent_pid = torch.where(invalid, torch.full_like(local, E * G),
                            local + torch.arange(E)[:, None] * G)
    sizes = (255, 256, 257, 300, 1000)
    tie_feat = torch.rand((sum(sizes) + 100, 64), generator=g)
    tie_pid = torch.randint(len(sizes), 20, (tie_feat.shape[0],),
                            generator=g)
    at = 0
    for row, n in enumerate(sizes):     # ties at 0 in channel 0, at 3.0
        tie_pid[at:at + n] = row        # in the others
        tie_feat[at:at + n] = 3.0
        tie_feat[at:at + n, 0] = 0.0
        at += n
    tie_feat[7, 5] = float("nan")
    cases = [
        (f"production {label}", feat, pid, S, True),
        (f"production {label}, f32", feat.float(), pid, S, True),
        ("f32 agent's canvas", torch.relu(torch.randn(
            (E * P, 64), generator=g)).to(dev), agent_pid.reshape(-1).to(
                torch.int32).to(dev), E * G, True),
        ("rows of 255-1000 tied points, f32", tie_feat.to(dev),
         tie_pid.to(torch.int32).to(dev), 20, False),
        ("rows of 255-1000 tied points, bf16", tie_feat.to(
            dev, torch.bfloat16), tie_pid.to(torch.int32).to(dev), 20,
         False)]
    res = {}
    for name, f, pid_, S_, timed in cases:
        res[name] = _scatter_max_bwd_case(torch, ctx, name, f, pid_, S_,
                                          timed, crafted=not timed)
    return res


def _scatter_max_bwd_case(torch, ctx, label, feat, pid, S, timed, crafted):
    from lav_tpu_torch.ops.pillar import (
        scatter_max, scatter_max_bwd, scatter_max_bwd_plain,
    )

    canvas, sort = scatter_max(feat, pid, S, keep_sort=True)
    C = feat.shape[1]
    g = torch.randn((S, C), generator=torch.Generator(device="cpu")
                    .manual_seed(13)).to(feat.device, feat.dtype)
    if crafted:
        g[0, 0], g[3, 4] = float("nan"), float("inf")
    ref = scatter_max_bwd_plain(g, feat, pid, canvas)
    routes = {"sorted": scatter_max_bwd(g, feat, pid, canvas, sort),
              "standalone": scatter_max_bwd(g, feat, pid, canvas)}
    torch.cuda.synchronize()
    for k, v in routes.items():
        try:
            torch.testing.assert_close(v, ref, rtol=0, atol=0,
                                       equal_nan=True)
        except AssertionError as e:
            raise AssertionError(f"scatter_max_bwd ({label}, {k}) disagrees "
                                 f"with its plain version: {e}") from None
    ok = (pid >= 0) & (pid < S)
    rows = torch.unique(pid[ok]).numel()
    zero_ties = int(((feat == 0) & ok[:, None]).sum())
    log("scatter", f"max_bwd {label}: {feat.shape[0]} points x {C}, {S} "
        f"rows, {rows} touched, {zero_ties} payloads tied at 0 (the zero "
        f"counts one more), NaN in the result {int(ref.isnan().sum())}; "
        "exact on the forward's sort and sorting itself")
    if not timed:
        return dict(max_abs_err=0.0)
    idx = pid.long()[ok][:, None].expand(-1, C)
    fvalid = feat[ok].detach().clone().requires_grad_(True)
    lib_canvas = feat.new_zeros((S, C)).scatter_reduce(
        0, idx, fvalid, "amax", include_self=True)

    def lib():
        return torch.autograd.grad(lib_canvas, fvalid, g, retain_graph=True)

    def kernel():
        return scatter_max_bwd(g, feat, pid, canvas, sort)

    r = dict(max_abs_err=0.0, ms=cuda_ms(torch, kernel, iters=20),
             device_ms=device_ms(torch, kernel),
             host_us=host_us(torch, kernel, n=50),
             plain_ms=cuda_ms(torch, lambda: scatter_max_bwd_plain(
                 g, feat, pid, canvas), iters=3, warmup=1),
             library_ms=cuda_ms(torch, lib, iters=10),
             library_device_ms=device_ms(torch, lib, iters=10))
    e = feat.element_size()
    nbytes = 2 * feat.numel() * e + pid.numel() * 4 + 2 * rows * C * e
    r["bound_ms"], r["bound_by"] = bound_ms(nbytes, feat.numel())
    log("scatter", f"max_bwd {label}: kernel {r['ms']:.4f} ms host-paced, "
        f"{r['device_ms']:.4f} ms device-only, {r['host_us']:.1f} us host "
        f"per call; plain {r['plain_ms']:.4f} ms; scatter_reduce autograd "
        f"{r['library_ms']:.4f} / {r['library_device_ms']:.4f} ms; bound "
        f"{r['bound_ms']:.4f} ms ({r['bound_by']}, {nbytes / 1e6:.1f} MB): "
        f"device-only {r['device_ms'] / r['bound_ms']:.2f}x the bound on "
        f"{ctx.get('smi', '?')}")
    del lib_canvas, fvalid, idx
    return r


def _scatter_max_agent(torch, ctx, label, feat, pid, S):
    """scatter_max on the (feat, pid, S) the production tick hands it:
    exact against its plain version (NaN positions equal), then timed; the
    dropped ids (S, the invalid points) land in an extra row of
    scatter_reduce_'s canvas."""
    from lav_tpu_torch.ops.pillar import scatter_max, scatter_max_plain

    out = scatter_max(feat, pid, S)
    ref = scatter_max_plain(feat, pid, S)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, rtol=0, atol=0, equal_nan=True)
    dropped = ((pid < 0) | (pid >= S)).float().mean().item()
    counts = torch.bincount(pid[(pid >= 0) & (pid < S)].long(),
                            minlength=S)
    log("scatter", f"max agent {label}: {pid.numel()} points into {S} "
        f"rows, {dropped:.3f} dropped, {(counts > 0).sum().item()} rows "
        f"reached, most points in a row {counts.max().item()}; exact")
    canvas = torch.zeros((S + 1, feat.shape[1]), dtype=feat.dtype,
                         device=feat.device)
    r = _time_canvas(torch, ctx, "scatter", f"max agent {label}",
                     scatter_max, scatter_max_plain, canvas, feat, pid, S,
                     with_plain=False)
    del out, ref, counts, canvas
    torch.cuda.empty_cache()
    return r


def _scatter_add_case(torch, ctx, label, feat, pid, S, plain=False):
    """scatter_add on (feat, pid, S) against its plain version on the CPU
    (index_add_, the points in order), bit for bit, and against itself on
    a second launch; then timed host-paced and device-only beside
    index_add_ on the same ids, and its host cost per call."""
    from lav_tpu_torch.ops.pillar import scatter_add, scatter_add_plain

    out = scatter_add(feat, pid, S)
    again = scatter_add(feat, pid, S)
    ref = scatter_add_plain(feat.cpu(), pid.cpu(), S)
    torch.cuda.synchronize()
    n_max = int(ref[:, 3].max())
    err = (out.cpu() - ref).abs().max().item()
    exact = torch.equal(out.cpu(), ref)
    same = torch.equal(out, again)
    in_range = (pid >= 0) & (pid < S)
    zero = (feat == 0).all(dim=1)
    log("scatter", f"add f32 {label}: {pid.numel()} points, "
        f"{zero.float().mean().item():.3f} with an all-zero payload, "
        f"{(in_range & ~zero).sum().item()} to add; max_abs_err {err:.3e} "
        f"against the CPU's index_add_, equal bit for bit {exact} (must "
        f"be), two launches equal {same} (must be), most points in a "
        f"pillar (dump row included) {n_max}")
    if not (exact and same):
        raise AssertionError(f"scatter_add ({label}) disagrees with plain")
    del out, again, ref
    ms = cuda_ms(torch, lambda: scatter_add(feat, pid, S), iters=20)
    dev_ms = device_ms(torch, lambda: scatter_add(feat, pid, S))
    us = host_us(torch, lambda: scatter_add(feat, pid, S))
    plain_ms = (cuda_ms(torch, lambda: scatter_add_plain(feat, pid, S))
                if plain else None)
    acc = torch.zeros((S, 4), device=feat.device)
    idx = pid.long()
    lib_ms = cuda_ms(torch, lambda: acc.index_add_(0, idx, feat), iters=20)
    lib_dev_ms = device_ms(torch, lambda: acc.index_add_(0, idx, feat))
    lib_us = host_us(torch, lambda: acc.index_add_(0, idx, feat))
    nbytes = feat.numel() * 4 + pid.numel() * 4 + S * 4 * 4
    bms, by = bound_ms(nbytes, feat.numel())
    log("scatter", f"add f32 {label}: kernel {ms:.4f} ms host-paced, "
        f"{dev_ms:.4f} ms device-only, {us:.1f} us host per call; "
        f"index_add_ {lib_ms:.4f} / {lib_dev_ms:.4f} ms, {lib_us:.1f} us; "
        f"plain {plain_ms} ms; bound {bms:.4f} ms ({by}, "
        f"{nbytes / 1e6:.1f} MB): device-only {dev_ms / bms:.2f}x the bound, "
        f"{dev_ms / lib_dev_ms:.2f}x index_add_ on {ctx.get('smi', '?')}")
    del acc, idx
    torch.cuda.empty_cache()
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=bms, bound_by=by, device_ms=dev_ms, host_us=us,
                library_device_ms=lib_dev_ms, library_host_us=lib_us)


def _agent_scatter_inputs(torch, ctx):
    """The (feat, pid, S) that bench.py's production tick (16 egos, 10000
    points per sweep) hands kernels scatter_add (segment_mean_gather's
    sums) and scatter_max (the canvas), taken by wrapping the wrappers: at
    tick 1, before the first sweep enters the ring buffer (every point is
    invalid: a zero payload into the sums' dump row, an id outside the
    canvas), and at the first tick whose ring buffer holds more than 10
    sweeps, where all three stacked sweeps are filled.  -> {"add": {label:
    args}, "max": {label: args}}."""
    from lav_tpu_torch.agent.setup import v2_agent_setup
    from lav_tpu_torch.ops import pillar

    step, models, state, obs, _ = v2_agent_setup(
        max_points=MAX_POINTS_PROD, num_ego=NUM_EGO_PROD,
        device=ctx["device"], seed=0, quant="mxu",
        compute_dtype=torch.bfloat16)
    real = {op: getattr(pillar, f"scatter_{op}") for op in ("add", "max")}
    seen = {op: [] for op in real}
    taken = {op: {} for op in real}

    def spy(op):
        def run(feat, pid, num_segments, **kw):
            seen[op].append((feat.clone(), pid.clone(), num_segments))
            return real[op](feat, pid, num_segments, **kw)
        return run

    for op in real:
        setattr(pillar, f"scatter_{op}", spy(op))
    try:
        for t in range(1, 16):
            for op in real:
                seen[op].clear()
            _, state, _ = step(models, state, obs)
            for op in real:
                if len(seen[op]) != 1:
                    raise AssertionError(f"tick {t}: scatter_{op} ran "
                                         f"{len(seen[op])} times")
            full = int(state.buf_count.min()) > 10
            if t == 1 or full:
                for op in real:
                    taken[op][f"tick {t}"] = seen[op][0]
            if full:
                break
    finally:
        for op in real:
            setattr(pillar, f"scatter_{op}", real[op])
    if len(taken["add"]) != 2:
        raise AssertionError(f"the ring buffer never filled: "
                             f"{list(taken['add'])}")
    del step, models, state, obs
    torch.cuda.empty_cache()
    return taken


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
# (batch, H, W, C, O, k, padding) of two convs on no path
OFF_PATH_CONVS = ((16, 40, 40, 24, 64, 3, 1), (4, 40, 40, 64, 64, 9, 4))
INT8_UPCONVS = 3           # LAV_INT8_UPCONV=1: backbone upconv1-3


def _variant_conv_shapes():
    """The int8 convs the variant routes add or change at NUM_EGO_PROD egos:
    (name, batch, H, W, C, O, k, pads ((top, bottom), (left, right)), input
    dilation, convs per tick, transposed conv (stride, padding,
    output_padding) or None).  The s2d conv1 replaces planner.conv1; the
    upconvs (nf = 64) run as convs over the input dilated by their stride
    with padding (k-1-p, k-1-p+op)."""
    E = NUM_EGO_PROD
    return [
        ("planner.conv1_s2d", E * 16, 48, 48, 4 * 384, 64, 4,
         ((2, 1), (2, 1)), 1, 1, None),
        ("lidar.upconv1", E, 160, 160, 64, 128, 1, ((0, 0), (0, 0)), 1, 1,
         (1, 0, 0)),
        ("lidar.upconv2", E, 80, 80, 128, 128, 4, ((2, 2), (2, 2)), 2, 1,
         (2, 1, 0)),
        ("lidar.upconv3", E, 40, 40, 128, 128, 4, ((2, 4), (2, 4)), 4, 1,
         (4, 1, 2)),
    ]


def _taps_hit(n, k, pads, lhs):
    """(output position, tap) pairs along one axis whose tap reads a real
    input pixel of the dilated, padded input (the rest read zeros)."""
    out = (n - 1) * lhs + 1 + pads[0] + pads[1] - k + 1
    return sum(1 for o in range(out) for t in range(k)
               if (o - pads[0] + t) % lhs == 0
               and 0 <= (o - pads[0] + t) // lhs < n)


def _taps_walked(n, k, stride, pads, lhs):
    """(output position, tap) pairs along one axis that a conv split into
    output phases walks: the taps whose position in the dilated, padded
    input is a multiple of the dilation, on an input pixel or in the
    padding (each phase walks its taps at every one of its outputs; only
    the taps that land on an inserted zero are left out)."""
    out = ((n - 1) * lhs + 1 + pads[0] + pads[1] - k) // stride + 1
    return sum(1 for o in range(out) for t in range(k)
               if (o * stride - pads[0] + t) % lhs == 0)


def _conv_case(torch, dev, g, N, H, W, C, O, k, stride, pads, lhs, w=None):
    """Random int8 inputs of one conv, checked exactly against the plain
    version (f32 output with a bias, then bf16 without); returns (args of
    the bf16 call, output, max abs error)."""
    from lav_tpu_torch.nn.quant import conv2d_int8_nhwc, conv2d_int8_plain

    xq = torch.randint(-127, 128, (N, H, W, C), generator=g,
                       dtype=torch.int8, device=dev)
    if w is None:
        w = torch.randint(-127, 128, (O, k, k, C), generator=g,
                          dtype=torch.int8, device=dev)
    w_scale = torch.rand((O,), generator=g, device=dev) * 1e-3 + 1e-4
    s_x = torch.tensor(0.02, device=dev)
    bias = torch.randn((O,), generator=g, device=dev)
    worst = 0.0
    for out_dtype, b in ((torch.float32, bias), (torch.bfloat16, None)):
        args = (xq, w, w_scale, s_x, b, (stride, stride), pads, (1, 1),
                out_dtype, (lhs, lhs))
        out = conv2d_int8_nhwc(*args)
        ref = conv2d_int8_plain(*args)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        worst = max(worst, err)
        if not torch.equal(out, ref):
            raise AssertionError(f"conv2d_int8 {(N, H, W, C, O, k)} "
                                 f"{out_dtype} disagrees with plain: "
                                 f"max_abs_err {err}")
        del ref
    return args, out, worst


def _time_conv(torch, args, yardsticks, useful, walked, dense, nbytes):
    """One conv shape's numbers: the kernel's host-paced (`ms`) and
    device-only ms, host us per call, the plain version's ms, each
    yardstick's (name -> fn) host-paced and device-only ms, the useful
    int8 TOPS and share of the peak, the work walked and the work an
    input-dilated conv walks (`dense`) over the useful work, and the
    bound."""
    from lav_tpu_torch.nn.quant import conv2d_int8_nhwc, conv2d_int8_plain

    def run():
        conv2d_int8_nhwc(*args)

    dev_ms = device_ms(torch, run, iters=10)
    r = dict(ms=cuda_ms(torch, run, iters=5), device_ms=dev_ms,
             host_us=host_us(torch, run, n=20),
             plain_ms=cuda_ms(torch, lambda: conv2d_int8_plain(*args),
                              iters=1, warmup=1),
             ops=useful, walked_ops=walked, dense_ops=dense, nbytes=nbytes)
    for name, fn in yardsticks.items():
        r[f"{name}_ms"] = cuda_ms(torch, fn, iters=5)
        r[f"{name}_device_ms"] = device_ms(torch, fn, iters=10)
    r["bound_ms"], r["bound_by"] = bound_ms(nbytes, useful, INT8_OPS)
    r["tops"] = useful / dev_ms / 1e9
    r["peak_share"] = r["tops"] * 1e12 / INT8_OPS
    return r


YARDSTICKS = {"cudnn": "cuDNN bf16 conv (another function)",
              "tconv": "F.conv_transpose2d bf16 (another function)",
              "int_mm": "torch._int_mm (the same int32 sums)"}


def _conv_line(name, count, shape, r):
    libs = "; ".join(
        f"{what} {r[f'{key}_ms']:.4f} ms host-paced, "
        f"{r[f'{key}_device_ms']:.4f} device-only"
        for key, what in YARDSTICKS.items() if f"{key}_ms" in r)
    return (f"{name} x{count}: {shape}: exact, host-paced {r['ms']:.4f} ms,"
            f" device-only {r['device_ms']:.4f} ms, host {r['host_us']:.1f}"
            f" us a call, {r['tops']:.1f} TOPS useful = "
            f"{100 * r['peak_share']:.1f}% of the int8 peak, walked/useful "
            f"{r['walked_ops'] / r['ops']:.3f} (an input-dilated conv "
            f"{r['dense_ops'] / r['ops']:.3f}); plain {r['plain_ms']:.3f} "
            f"ms; {libs}; bound {r['bound_ms']:.4f} ms ({r['bound_by']})")


def _yardsticks(torch, xq, w, k, st, pad):
    """The PyTorch calls timed beside a direct conv: cuDNN's bf16 conv
    (another function), and for a 1x1 conv torch._int_mm over the input
    subsampled beforehand (cuBLASLt's int8 matmul: the same int32
    sums)."""
    import torch.nn.functional as F

    xb = xq.permute(0, 3, 1, 2).to(torch.bfloat16)
    wb = w.permute(0, 3, 1, 2).to(torch.bfloat16)
    fns = {"cudnn": lambda: F.conv2d(xb, wb, None, st, pad)}
    if k == 1:
        x2 = xq[:, ::st, ::st].reshape(-1, xq.shape[3]).contiguous()
        w2 = w.reshape(w.shape[0], -1).t()
        fns["int_mm"] = lambda: torch._int_mm(x2, w2)
    return fns


def phase_conv_int8(ctx):
    import torch
    import torch.nn.functional as F

    from lav_tpu_torch.nn.quant import s2d_weight

    dev = torch.device(ctx["device"])
    g = torch.Generator(device=dev).manual_seed(5)
    shapes = _conv_int8_shapes()
    assert sum(r[-1] for r in shapes) == INT8_CONVS_PER_TICK
    # X_ms host-paced, X_device_ms device-only, as in phases scatter and
    # gather
    keys = ("ms", "device_ms", "plain_ms", "bound_ms", "ops", "nbytes",
            "cudnn_ms", "cudnn_device_ms")
    tot = dict.fromkeys(keys + ("one_by_one_ms", "one_by_one_device_ms",
                                "int_mm_ms", "int_mm_device_ms"), 0.0)
    per_shape = {}
    worst = 0.0
    for name, N, H, W, C, O, k, st, pad, count in shapes:
        pads = ((pad, pad), (pad, pad))
        args, out, err = _conv_case(torch, dev, g, N, H, W, C, O, k, st,
                                    pads, 1)
        worst = max(worst, err)
        xq, w = args[0], args[1]
        OH, OW = out.shape[1:3]
        useful = 2.0 * N * OH * OW * O * k * k * C
        walked = 2.0 * N * O * C * _taps_walked(H, k, st, pads[0], 1) \
            * _taps_walked(W, k, st, pads[1], 1)
        nbytes = xq.numel() + w.numel() + O * 4 + out.numel() * 2
        libs = _yardsticks(torch, xq, w, k, st, pad)
        r = _time_conv(torch, args, libs, useful, walked, useful, nbytes)
        log("conv_int8", _conv_line(name, count, f"{N}x{H}x{W}x{C} -> {O} "
                                    f"k{k} s{st}", r))
        r["count"] = count
        per_shape[name] = r
        for key in keys:
            tot[key] += count * r[key]
        if k == 1:
            for key in ("ms", "device_ms"):
                tot[f"one_by_one_{key}"] += count * r[key]
                tot[f"int_mm_{key}"] += count * r[f"int_mm_{key}"]
        del xq, w, out, args, libs
        torch.cuda.empty_cache()
    by = ("operations" if tot["ops"] / INT8_OPS
          >= tot["nbytes"] / HBM_BYTES_PER_S else "bytes")
    # no one PyTorch call computes an int8 convolution on CUDA: library_ms
    # is null; cuDNN's bf16 conv (another function) and, for the 1x1
    # convs, torch._int_mm (the same sums) are kept beside it
    ctx["conv_int8"] = dict(
        max_abs_err=worst, ms=tot["ms"], device_ms=tot["device_ms"],
        plain_ms=tot["plain_ms"], library_ms=None, bound_ms=tot["bound_ms"],
        bound_by=by, cudnn_bf16_conv_ms=tot["cudnn_ms"],
        cudnn_bf16_conv_device_ms=tot["cudnn_device_ms"],
        one_by_one_ms=tot["one_by_one_ms"],
        one_by_one_device_ms=tot["one_by_one_device_ms"],
        int_mm_1x1_ms=tot["int_mm_ms"],
        int_mm_1x1_device_ms=tot["int_mm_device_ms"])
    log("conv_int8", f"one production tick ({INT8_CONVS_PER_TICK} convs): "
        f"kernel host-paced {tot['ms']:.3f} ms, device-only "
        f"{tot['device_ms']:.3f} ms, plain {tot['plain_ms']:.3f} ms, bound "
        f"{tot['bound_ms']:.4f} ms ({by}); cuDNN bf16 {tot['cudnn_ms']:.3f}"
        f" ms host-paced, {tot['cudnn_device_ms']:.3f} device-only; the 1x1"
        f" convs {tot['one_by_one_device_ms']:.4f} ms device-only against "
        f"torch._int_mm's {tot['int_mm_device_ms']:.4f} on "
        f"{ctx.get('smi', '?')}")

    # the variant routes' shapes: the s2d conv1 (its weight derived from a
    # 7x7 one, zeros included) and the upconvs as transposed convs
    var = {k: tot[k] - per_shape["planner.conv1"][k] for k in keys}
    for (name, N, H, W, C, O, k, pads, lhs, count,
         tconv) in _variant_conv_shapes():
        w = None
        if tconv is None:
            w7 = torch.randint(-127, 128, (O, 7, 7, C // 4), generator=g,
                               dtype=torch.int8, device=dev)
            w = s2d_weight(w7)
            del w7
        args, out, err = _conv_case(torch, dev, g, N, H, W, C, O, k, 1,
                                    pads, lhs, w)
        worst = max(worst, err)
        xq, w = args[0], args[1]
        OH, OW = out.shape[1:3]
        xb = xq.permute(0, 3, 1, 2).to(torch.bfloat16)
        if tconv is None:
            # cuDNN's bf16 conv on the input padded once beforehand
            xb = F.pad(xb, (pads[1][0], pads[1][1], pads[0][0], pads[0][1]))
            wb = w.permute(0, 3, 1, 2).to(torch.bfloat16)
            libs = {"cudnn": lambda: F.conv2d(xb, wb)}
            useful = 2.0 * N * OH * OW * O * 49 * (C // 4)
        else:
            s, p, op = tconv
            # the transposed conv's own weight: the flipped kernel, (I, O,
            # kh, kw)
            wb = w.flip(1, 2).permute(3, 0, 1, 2).to(torch.bfloat16)
            libs = {"tconv": lambda: F.conv_transpose2d(
                xb, wb, None, s, p, op)}
            useful = (2.0 * N * O * C * _taps_hit(H, k, pads[0], lhs)
                      * _taps_hit(W, k, pads[1], lhs))
        walked = 2.0 * N * O * C * _taps_walked(H, k, 1, pads[0], lhs) \
            * _taps_walked(W, k, 1, pads[1], lhs)
        dense = 2.0 * N * OH * OW * O * k * k * C
        nbytes = xq.numel() + w.numel() + O * 4 + out.numel() * 2
        r = _time_conv(torch, args, libs, useful, walked, dense, nbytes)
        log("conv_int8", _conv_line(
            name, count, f"{N}x{H}x{W}x{C} -> {O} k{k} pads {pads} input "
            f"dilation {lhs}", r))
        r["count"] = count
        per_shape[name] = r
        lib = "cudnn" if tconv is None else "tconv"
        r["cudnn_ms"], r["cudnn_device_ms"] = (r[f"{lib}_ms"],
                                               r[f"{lib}_device_ms"])
        for key in keys:
            var[key] += count * r[key]
        del xq, w, out, xb, wb, args, libs
        torch.cuda.empty_cache()
    ctx["conv_int8"].update(max_abs_err=worst, variants_ms=var["ms"],
                            variants_device_ms=var["device_ms"],
                            variants_plain_ms=var["plain_ms"],
                            variants_bound_ms=var["bound_ms"],
                            variants_cudnn_bf16_ms=var["cudnn_ms"],
                            variants_cudnn_bf16_device_ms=var[
                                "cudnn_device_ms"])
    ctx["conv_shapes"] = per_shape
    # convs on no path, which lav_tpu's s8 conv computes: C = 24 (the
    # wrapper pads it to 32 with zero channels) and 9 taps a phase and axis
    for N, H, W, C, O, k, pad in OFF_PATH_CONVS:
        _, out, err = _conv_case(torch, dev, g, N, H, W, C, O, k, 1,
                                 ((pad, pad), (pad, pad)), 1)
        log("conv_int8", f"off the paths: {N}x{H}x{W}x{C} -> {O} k{k} pad "
            f"{pad}: exact (f32 + bias and bf16), output "
            f"{tuple(out.shape)}, not in the tick totals")
        worst = max(worst, err)
        del out
    ctx["conv_int8"]["max_abs_err"] = worst
    ctx["camera_convs"] = _camera_conv_cases(torch, ctx)
    log("conv_int8", f"one variants tick ({INT8_CONVS_PER_TICK + INT8_UPCONVS}"
        f" convs, s2d conv1): kernel host-paced {var['ms']:.3f} ms, "
        f"device-only {var['device_ms']:.3f} ms, plain {var['plain_ms']:.3f}"
        f" ms, cuDNN bf16 {var['cudnn_ms']:.3f} ms host-paced, "
        f"{var['cudnn_device_ms']:.3f} device-only, bound "
        f"{var['bound_ms']:.4f} ms on {ctx.get('smi', '?')}")


HOST_ROUNDS = 5             # phase gather's host costs timed in turns
GATHER_CASES = ((8, 128, "float32"), (512, 128, "float32"),
                (9216, 128, "float32"), (9216, 128, "bfloat16"),
                (9216, 256, "float32"), (25600, 128, "float32"))
# scripts/exp_gather.py:55-60


def phase_gather(ctx):
    """The gather probe: take_along_rows at the probe's six cases, driven
    once with the counts at 0, then each checked (rows random and in
    order) and timed; then lav_tpu's contract at out-of-range indices
    (ROADMAP C11) and what a launch costs the host."""
    import torch

    from lav_tpu_torch.ops.gather import take_along_rows, take_along_rows_plain
    from lav_tpu_torch.utils import native

    dev = torch.device(ctx["device"])
    g = torch.Generator(device=dev).manual_seed(7)
    cases = []
    for S, L, dt in GATHER_CASES:
        x = torch.randn((S, L), generator=g, device=dev).to(getattr(torch, dt))
        idx = torch.randint(0, S, (S, L), generator=g, device=dev,
                            dtype=torch.int32)
        cases.append((S, L, dt, x, idx))
    native.reset_launches()
    outs = [take_along_rows(x, idx) for _, _, _, x, idx in cases]
    torch.cuda.synchronize()
    launches = native.LAUNCHES["take_along_rows"]
    ctx["launches_gather"] = {"take_along_rows": launches}
    if launches != len(cases):
        raise AssertionError(f"take_along_rows launched {launches} times for "
                             f"{len(cases)} cases")
    keys = ("ms", "device_ms", "host_us", "plain_ms", "library_ms",
            "library_device_ms", "library_host_us", "bound_ms",
            "ordered_device_ms", "ordered_bound_ms")
    tot = dict.fromkeys(keys, 0.0)
    per_case = []
    for (S, L, dt, x, idx), out in zip(cases, outs):
        esize = x.element_size()
        # the same rows in order (idx[i, l] = i): the bytes of a full x,
        # but each warp's 32 reads of x fall on one sector run
        rows = torch.arange(S, dtype=torch.int32, device=dev)[:, None]
        rows = rows.expand(S, L).contiguous()
        for label, got, want in (
                ("rows random", out, take_along_rows_plain(x, idx)),
                ("rows in order", take_along_rows(x, rows), x)):
            if not torch.equal(got, want):
                raise AssertionError(f"take_along_rows ({S}, {L}) {dt}, "
                                     f"{label}: not equal bit for bit")
        idx64 = idx.long()
        r = dict(
            ms=cuda_ms(torch, lambda: take_along_rows(x, idx), iters=20),
            device_ms=device_ms(torch, lambda: take_along_rows(x, idx)),
            host_us=host_us(torch, lambda: take_along_rows(x, idx)),
            plain_ms=cuda_ms(torch, lambda: take_along_rows_plain(x, idx),
                             iters=20),
            library_ms=cuda_ms(torch, lambda: torch.gather(x, 0, idx64),
                               iters=20),
            library_device_ms=device_ms(torch,
                                        lambda: torch.gather(x, 0, idx64)),
            library_host_us=host_us(torch, lambda: torch.gather(x, 0, idx64)),
            ordered_device_ms=device_ms(torch,
                                        lambda: take_along_rows(x, rows)),
            ordered_bound_ms=bound_ms(
                rows.numel() * 4 + 2 * x.numel() * esize)[0])
        # idx read and out written once; of x only the distinct (row,
        # column) pairs this idx names
        hit = torch.unique(idx64 * L + torch.arange(L, device=dev)).numel()
        nbytes = idx.numel() * 4 + (out.numel() + hit) * esize
        r["bound_ms"], by = bound_ms(nbytes)
        log("gather", f"({S}, {L}) {dt}: exact; kernel {r['ms']:.4f} ms "
            f"host-paced, {r['device_ms']:.4f} ms device-only "
            f"({r['device_ms'] / r['bound_ms']:.2f}x the bound), "
            f"{r['host_us']:.1f} us host per call; torch.gather "
            f"{r['library_ms']:.4f} / {r['library_device_ms']:.4f} ms, "
            f"{r['library_host_us']:.1f} us; plain {r['plain_ms']:.4f} ms; "
            f"bound {r['bound_ms']:.5f} ms ({by}, {nbytes / 1e6:.2f} MB); "
            f"rows in order {r['ordered_device_ms']:.4f} ms device-only "
            f"({r['ordered_device_ms'] / r['ordered_bound_ms']:.2f}x its "
            f"bound {r['ordered_bound_ms']:.5f} ms) on {ctx.get('smi', '?')}")
        per_case.append(dict(S=S, L=L, dtype=dt, **r))
        for key in keys:
            tot[key] += r[key]
    for key in ("host_us", "library_host_us"):
        tot[key] /= len(cases)
    _gather_contract(torch, cases)
    ctx["gather"] = dict(max_abs_err=0.0, bound_by="bytes", **tot,
                         cases=per_case)
    log("gather", f"six cases together: kernel {tot['ms']:.4f} ms "
        f"host-paced, {tot['device_ms']:.4f} ms device-only "
        f"({tot['bound_ms'] / tot['device_ms']:.0%} of the bound), "
        f"{tot['host_us']:.1f} us host per call (mean); torch.gather "
        f"{tot['library_ms']:.4f} / {tot['library_device_ms']:.4f} ms, "
        f"{tot['library_host_us']:.1f} us; plain {tot['plain_ms']:.4f} ms; "
        f"bound {tot['bound_ms']:.5f} ms")
    _launch_reads(torch, cases[0][3])
    _host_costs(torch, ctx, cases[0][3], cases[0][4])


def _gather_contract(torch, cases):
    """lav_tpu's contract at out-of-range indices (jnp.take_along_axis,
    ROADMAP C11), on the first case of each dtype and on the largest: -1
    and -S wrap to rows S - 1 and 0; -S - 1, S, 2^20 and -2^20 give NaN.
    The kernel against the plain version: NaN positions equal, every
    other bit equal."""
    from lav_tpu_torch.ops.gather import take_along_rows, take_along_rows_plain

    picked = list({c[2]: c for c in reversed(cases)}.values()) + [cases[-1]]
    for S, L, dt, x, idx in picked:
        bad = idx.clone()
        for k, v in enumerate((-1, -S, -S - 1, S, 1 << 20, -(1 << 20))):
            bad[k::7, k % 5::5] = v
        want = take_along_rows_plain(x, bad)
        nan = torch.isnan(want)
        if not (nan.any() and (~nan).any()):
            raise AssertionError("take_along_rows contract: no NaN or no "
                                 "value to compare")
        bits = torch.int32 if x.element_size() == 4 else torch.int16
        got = take_along_rows(x, bad)
        if not (torch.equal(torch.isnan(got), nan) and torch.equal(
                got.view(bits)[~nan], want.view(bits)[~nan])):
            raise AssertionError(f"take_along_rows ({S}, {L}) {dt}: "
                                 "out-of-range indices differ from the "
                                 "plain version")
    log("gather", "indices -1, -S wrap; -S - 1, S, 2^20, -2^20 give NaN: "
        "the kernel equals the plain version (f32 and bf16)")


def _launch_reads(torch, x):
    """native.launch's private reads of the current device and stream give
    what the public ones give, on the default stream and under a side
    stream."""
    from lav_tpu_torch.utils import native

    i = x.get_device()
    side = torch.cuda.Stream(device=x.device)
    for label, ctxm in (("the default stream", contextlib.nullcontext()),
                        ("a side stream", torch.cuda.stream(side))):
        with ctxm:
            got = (native.current_device(), native.raw_stream(i))
            want = (torch.cuda.current_device(),
                    torch.cuda.current_stream(i).cuda_stream)
        if got != want:
            raise AssertionError(f"native.launch's reads on {label}: {got}, "
                                 f"the public reads {want}")
    if side.cuda_stream == torch.cuda.default_stream(i).cuda_stream:
        raise AssertionError("the side stream is the default stream")
    log("gather", "native.current_device() and raw_stream(index) equal "
        "torch.cuda.current_device() and current_stream(index).cuda_stream "
        "on the default stream and under a side stream")


def _host_costs(torch, ctx, x, idx):
    """What the pieces of a launch cost the host, in us per call, on CUDA
    tensors x and idx: the ways to read the current stream and device,
    the output allocation, and the device guard."""
    from lav_tpu_torch.ops.gather import kernel_entry
    from lav_tpu_torch.utils import native

    d = x.device
    i = x.get_device()
    import ctypes

    entry = native.ENTRIES["take_along_rows_b32"]
    # the same entry through ctypes.PyDLL, which keeps the GIL held
    held = getattr(ctypes.PyDLL(str(native._lib_path(entry.source))),
                   entry.symbol)
    held.argtypes, held.restype = entry.fn.argtypes, entry.fn.restype
    shape = idx.shape
    pieces = {
        # M = 0: the entry returns before any CUDA call; nothing is counted
        "ctypes call of an entry, CDLL (GIL released; 7 arguments, "
        "returns at once)": lambda: entry.fn(0, 0, 0, 8, 0, 128, 0),
        "the same through PyDLL (GIL held)":
            lambda: held(0, 0, 0, 8, 0, 128, 0),
        "torch.cuda.current_stream().cuda_stream":
            lambda: torch.cuda.current_stream().cuda_stream,
        "torch.cuda.current_stream(index).cuda_stream":
            lambda: torch.cuda.current_stream(i).cuda_stream,
        "native.raw_stream(index) (torch._C._cuda_getCurrentRawStream)":
            lambda: native.raw_stream(i),
        "torch.cuda.current_device()": torch.cuda.current_device,
        "native.current_device() (torch._C._cuda_getDevice)":
            native.current_device,
        "x.get_device()": x.get_device,
        "x.device": lambda: x.device,
        "with torch.cuda.device(device)": lambda: _enter(torch.cuda.device(d)),
        "x.data_ptr()": x.data_ptr,
        "the wrapper's checks (ops.gather.kernel_entry)":
            lambda: kernel_entry(x, idx),
        "native.launch of an entry that returns at once (M = 0)":
            lambda: native.launch(entry, i, 0, 0, 0, 8, 0, 128),
    }
    ctx["host_costs_us"] = {k: host_us(torch, f, n=2000)
                            for k, f in pieces.items()}
    native.reset_launches()
    log("gather", "host us per call: " + "; ".join(
        f"{k} {v:.2f}" for k, v in ctx["host_costs_us"].items()))
    # forms whose costs lie within a microsecond of each other, timed in
    # turns (HOST_ROUNDS rounds, each form once a round): the allocations
    # that give the output tensor, and the whole wrapper against
    # torch.gather
    from lav_tpu_torch.ops.gather import take_along_rows

    idx64 = idx.long()
    forms = {
        "torch.empty(shape, dtype=, device=)":
            lambda: torch.empty(shape, dtype=x.dtype, device=d),
        "x.new_empty(shape)": lambda: x.new_empty(shape),
        "idx.new_empty(shape, dtype=)":
            lambda: idx.new_empty(shape, dtype=x.dtype),
        "torch.empty_like(idx, dtype=) (the wrapper's)":
            lambda: torch.empty_like(idx, dtype=x.dtype),
        "take_along_rows(x, idx)": lambda: take_along_rows(x, idx),
        "torch.gather(x, 0, idx64)": lambda: torch.gather(x, 0, idx64),
    }
    rounds = {k: [] for k in forms}
    for _ in range(HOST_ROUNDS):
        for k, f in forms.items():
            rounds[k].append(host_us(torch, f, n=2000))
    native.reset_launches()
    ctx["host_rounds_us"] = rounds
    log("gather", f"host us per call, {HOST_ROUNDS} rounds in turns "
        "(median; each round): " + "; ".join(
            f"{k} {statistics.median(v):.2f} ("
            + " / ".join(f"{u:.2f}" for u in v) + ")"
            for k, v in rounds.items()))


def _enter(guard):
    with guard:
        pass


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


REPEAT_TICKS = 12


def _global_flags(torch):
    return (torch.are_deterministic_algorithms_enabled(),
            torch.backends.cudnn.deterministic)


def _repeat_check(torch, ctx, phase, step, models, state, obs):
    """The tick repeats itself (ROADMAP C10): REPEAT_TICKS ticks twice from
    `state`, with no deterministic flag set for the process before,
    during or after them, must give every output leaf (controls, state,
    aux) equal bit for bit, NaN positions equal (`_same_leaves`)."""
    if any(_global_flags(torch)):
        raise AssertionError(f"{phase}: a deterministic flag is set for the "
                             f"process before the repeat check: "
                             f"{_global_flags(torch)}")
    runs = []
    for _ in range(2):
        st, ticks = state, []
        for _ in range(REPEAT_TICKS):
            ctrl, st, aux = step(models, st, obs)
            ticks.append((tuple(ctrl), tuple(st), aux))
        runs.append(ticks)
    same = [_same_leaves(torch, a, b) for a, b in zip(*runs)]
    flags = _global_flags(torch)
    log(phase, f"{REPEAT_TICKS} ticks twice from one state, no "
        f"deterministic flag for the process (after them: algorithms "
        f"{flags[0]}, cudnn {flags[1]}): ticks equal {same}")
    if not all(same) or any(flags):
        raise AssertionError(f"{phase}: the tick does not repeat itself bit "
                             f"for bit, or set a process-wide flag: {same}, "
                             f"{flags}")
    ctx[f"{phase}_repeats"] = True


def phase_agent(ctx):
    import numpy as np
    import torch

    from lav_tpu_torch.agent.setup import v2_agent_setup
    from lav_tpu_torch.utils import native

    step, models, state, obs, _ = v2_agent_setup(
        max_points=MAX_POINTS, num_ego=NUM_EGO, device=ctx["device"], seed=0,
        use_pallas=True)
    _repeat_check(torch, ctx, "agent", step, models, state, obs)
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
    _tied_peaks(torch, torch.device(ctx["device"]), ctx)


def phase_production(ctx):
    _bench_tick(ctx, "production", {}, INT8_CONVS_PER_TICK,
                {"crop_shared_q8": 1, "scatter_max": 1, "scatter_add": 1},
                absent=())


def phase_variants(ctx):
    _bench_tick(ctx, "variants",
                dict(use_pallas=True, s2d_crops=True, int8_upconv=True),
                INT8_CONVS_PER_TICK + INT8_UPCONVS,
                {"pillar_scatter_max_bf16": 1, "crop_shared_q8_s2d": 1,
                 "scatter_add": 1}, absent=VARIANT_ABSENT)
    log("variants", f"p50 tick {ctx['variants_p50_ms']:.3f} ms against "
        f"production's {ctx.get('production_p50_ms', 'not run')} ms in this "
        "call")
    # lav_tpu's all-stacks int8 scope (quant="all"): the camera nets too
    _bench_tick(ctx, "all", dict(quant="all"), None,
                {"crop_shared_q8": 1, "scatter_max": 1, "scatter_add": 1},
                absent=())
    log("variants", f"quant='all': p50 tick {ctx['all_p50_ms']:.3f} ms, "
        f"conv2d_int8 {ctx['all_convs']} a tick ({ctx['all_conv_ms']:.3f} "
        f"ms device-only) against mxu's {INT8_CONVS_PER_TICK} "
        f"({ctx.get('production_conv_ms', 'not run')} ms) on "
        f"{ctx.get('smi', '?')}")


def _bench_tick(ctx, phase, knobs, n_convs, at_least, absent):
    """bench.py's configuration (16 egos, 10000 points per sweep, bf16,
    int8 "mxu" calibrated on the card) with the variant `knobs` (quant="all"
    among them: every stack int8): 3 ticks with launch counts per tick
    (`at_least` launches of each named kernel, exactly `n_convs` of
    conv2d_int8, or with None more than "mxu"'s, none of `absent`), then 5
    more; the p50 of ticks 2-8; conv2d_int8's device-only ms in one tick;
    ticks 1-2 of ego 0 against the port's CPU run on the same weights and
    scales."""
    import copy

    import numpy as np
    import torch

    from lav_tpu_torch.agent.agent import build_agent
    from lav_tpu_torch.agent.setup import make_obs, v2_agent_setup
    from lav_tpu_torch.nn.quant import int8_convs
    from lav_tpu_torch.utils import native

    t0 = time.perf_counter()
    knobs = dict(knobs)
    quant = knobs.pop("quant", "mxu")
    step, models, state, obs, cfg = v2_agent_setup(
        max_points=MAX_POINTS_PROD, num_ego=NUM_EGO_PROD,
        device=ctx["device"], seed=0, quant=quant,
        compute_dtype=torch.bfloat16, **knobs)
    torch.cuda.synchronize()
    convs = list(int8_convs(models))
    # the brake net's seg head is not on the tick: never observed
    unseen = {p for p, c in convs if c.x_scale is None}
    log(phase, f"setup {knobs} (seeded weights, int8 {quant}, calibrated on "
        f"the card) {time.perf_counter() - t0:.1f} s: {len(convs)} int8 "
        f"convs, {len(convs) - len(unseen)} with static scales")
    if (n_convs is not None and len(convs) != n_convs) or unseen - {
            "/bra_model/seg_head/out"}:
        raise AssertionError(f"{phase}: the configuration has the wrong int8 "
                             f"convs ({len(convs)}, uncalibrated {unseen})")
    cpu_models = copy.deepcopy(models).to("cpu")  # same weights and scales
    if phase == "production":
        _repeat_check(torch, ctx, phase, step, models, state, obs)

    names = tuple(at_least) + ("conv2d_int8",) + tuple(absent)
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
            per_tick.append({k: now[k] - prev[k] for k in names})
            prev = now
            if t == 2:
                ctx[f"launches_{phase}"] = {k: now[k] for k in names}
    log(phase, f"{NUM_EGO_PROD} egos, launches per tick {per_tick}")
    for t, counts in enumerate(per_tick):
        if any(counts[k] < n for k, n in at_least.items()) or \
                (counts["conv2d_int8"] != n_convs if n_convs is not None
                 else counts["conv2d_int8"] <= INT8_CONVS_PER_TICK) or \
                any(counts[k] for k in absent):
            raise AssertionError(f"{phase} tick {t + 1}: a kernel did not "
                                 f"launch as it should: {counts}")
    _check_controls(torch, outs)
    p50 = statistics.median(tick_ms[1:])
    ctx[f"{phase}_p50_ms"] = p50
    ctx[f"{phase}_convs"] = per_tick[0]["conv2d_int8"]
    split = device_split(torch, lambda: step(models, state, obs), iters=3,
                         warmup=1)
    ctx[f"{phase}_conv_ms"] = sum(v for k, v in split.items()
                                  if "conv2d_int8_kernel" in k)
    log(phase, f"tick ms {[round(t, 3) for t in tick_ms]}; p50 of ticks 2-8 "
        f"{p50:.3f} ms ({NUM_EGO_PROD} egos, {MAX_POINTS_PROD} points per "
        f"sweep) on {ctx.get('smi', '?')}")

    # ego 0 through the port on the CPU, same weights, scales and inputs
    cinit, cstep = build_agent(cfg, max_points=MAX_POINTS_PROD,
                               compute_dtype=torch.bfloat16, device="cpu",
                               use_pallas=knobs.get("use_pallas", False),
                               s2d_crops=knobs.get("s2d_crops", False))
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
        log(phase, f"tick {t + 1} ego 0 detections: {int(v.sum())} on the "
            f"CPU, {int(dg['valid'].sum())} on the card, valid masks agree "
            f"{same}, max |xy| diff {xy}")
        got, want = _ego0(ctrl_g, aux_g), _ego0(ctrl_c, aux_c)
        err = float(np.abs(got - want).max())
        worst = max(worst, err)
        np.testing.assert_allclose(got, want, atol=PROD_ATOL, rtol=PROD_RTOL,
                                   err_msg=f"tick {t + 1} ego 0 GPU vs CPU")
    log(phase, f"ticks 1-2 of ego 0 match the CPU port: max_abs_err "
        f"{worst:.3e} (atol {PROD_ATOL}, rtol {PROD_RTOL})")


def phase_profile(ctx):
    import torch

    prod = dict(max_points=MAX_POINTS_PROD, num_ego=NUM_EGO_PROD,
                quant="mxu", compute_dtype=torch.bfloat16)
    setups = {
        "f32": dict(max_points=MAX_POINTS, num_ego=NUM_EGO, use_pallas=True),
        "production": prod,
        "variants": dict(prod, use_pallas=True, s2d_crops=True,
                         int8_upconv=True),
    }
    names = {"both": ["f32", "production"], "all": list(setups)}.get(
        ctx["config"], [ctx["config"]])
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
    convs = [e for e in kernels if "conv2d_int8" in e.key]
    log("profile", f"{config}: conv2d_int8 "
        f"{sum(e.self_device_time_total for e in convs) / 1e3:.3f} ms "
        f"x{sum(e.count for e in convs)} of the device busy time")
    if busy_ms <= 0:
        raise AssertionError("the profiler saw no device time")


def _student_crop_grids(torch, dev, B=NUM_EGO_TRAIN, H=160, ppm=2.0,
                        crop=96):
    """The distillation step's student crop grids at full width: per item
    K_TRAIN other-car crops and the ego crop, 96x96 from the 160x160
    feature map (ppm / 2 = 2), jittered poses; item 0's first crop
    straddles the border and its second lies wholly outside.  With H =
    320, ppm = 4, crop = 192: the teacher's crops of the BEV at the same
    poses."""
    from lav_tpu_torch.core.warp import affine_grid, crop_theta

    g = torch.Generator(device="cpu").manual_seed(7)
    grids = []
    for K in (K_TRAIN, 1):
        locs = torch.randn((B, K, 2), generator=g) * 3.0
        oris = (torch.rand((B, K), generator=g) * 2 - 1) * 0.35
        if K > 1:
            locs[0, 0] = torch.tensor([38.0, -39.0])
            locs[0, 1] = torch.tensor([1e3, -1e3])
        theta = crop_theta(locs.reshape(-1, 2), oris.reshape(-1), H, H, ppm,
                           crop, 0.0, 0.75)
        grids.append(affine_grid(theta, crop, crop).reshape(
            B, K, crop, crop, 2).to(dev).contiguous())
    return grids


def _crop_fwd_step(torch, ctx, dev, dtype):
    """Kernel crop_shared on the distillation step's four calls in `dtype`
    (the student's crops of the 160x160x384 features, K_TRAIN others and
    the ego, 96x96; the teacher's of the 320x320x9 BEV at the same poses,
    192x192), against its plain version (f32 to CROP_F32_ATOL, bf16 to
    CROP_BF16_ULPS of the largest value), timed as the step's four beside
    its bound, the plain version and F.grid_sample."""
    import torch.nn.functional as F

    from lav_tpu_torch.core.warp import crop_shared, grid_sample_shared

    g = torch.Generator(device="cpu").manual_seed(11)
    calls = []
    for (H, C, ppm, crop) in ((160, 384, 2.0, 96), (320, 9, 4.0, 192)):
        src = torch.randn((NUM_EGO_TRAIN, H, H, C), generator=g).to(dev, dtype)
        for grid in _student_crop_grids(torch, dev, H=H, ppm=ppm, crop=crop):
            calls.append((src, grid))
    err = 0.0
    for src, grid in calls:
        out = crop_shared(src, grid).float()
        ref = grid_sample_shared(src, grid).float()
        torch.cuda.synchronize()
        e = (out - ref).abs().max().item()
        tol = CROP_F32_ATOL if dtype == torch.float32 else (
            CROP_BF16_ULPS * 2.0 ** -7 * 2.0 ** math.ceil(
                math.log2(max(ref.abs().max().item(), 1e-30))))
        if not (e <= tol and torch.isfinite(out).all()):
            raise AssertionError(f"crop_shared {dtype} disagrees with plain "
                                 f"at the step's shapes ({e} > {tol})")
        err = max(err, e)
    nbytes = sum(crop_bytes(torch, src, grid, src.element_size())
                 for src, grid in calls)
    flops = sum(grid[..., 0].numel() * (8 * src.shape[-1] + 24)
                for src, grid in calls)
    lib_args = [(src.permute(0, 3, 1, 2), grid.to(dtype)) for src, grid in
                calls]

    def lib():
        with torch.backends.cudnn.flags(enabled=False):
            return [F.grid_sample(nchw[b:b + 1].expand(
                grid.shape[1], *nchw.shape[1:]), grid[b], mode="bilinear",
                padding_mode="zeros", align_corners=True)
                for nchw, grid in lib_args for b in range(nchw.shape[0])]

    bms, by = bound_ms(nbytes, flops)
    r = dict(max_abs_err=err,
             ms=cuda_ms(torch, lambda: [crop_shared(*a) for a in calls],
                        iters=20),
             device_ms=device_ms(torch, lambda: [crop_shared(*a)
                                                 for a in calls]),
             plain_ms=cuda_ms(torch, lambda: [grid_sample_shared(*a)
                                              for a in calls], iters=3,
                              warmup=1),
             library_ms=cuda_ms(torch, lib, iters=5),
             bound_ms=bms, bound_by=by)
    log("train_kernels", f"crop_shared {str(dtype)[6:]} at the step's four "
        f"calls ({nbytes / 1e6:.1f} MB): max_abs_err {err:.3e}; kernel "
        f"{r['ms']:.4f} ms host-paced, {r['device_ms']:.4f} ms device-only, "
        f"bound {bms:.4f} ms ({by}), plain {r['plain_ms']:.4f} ms, "
        f"F.grid_sample {r['library_ms']:.4f} ms on {ctx.get('smi', '?')}")
    del calls, lib_args
    torch.cuda.empty_cache()
    return r


def _crop_bwd_check(torch, label, g, gr, H, W):
    """crop_shared_bwd(g, gr) against its plain version, per cell within
    CROP_BWD_RTOL of the cell's sum of |g * w| (both sum in f32, in
    another order) and, for a bf16 g, CROP_BWD_BF16_ULPS bf16 ulp of the
    larger result beyond that (each rounds its f32 sum once); -> max abs
    error."""
    from lav_tpu_torch.core.warp import crop_shared_bwd, grid_sample_shared_bwd

    out = crop_shared_bwd(g, gr, H, W).float()
    ref = grid_sample_shared_bwd(g, gr, H, W).float()
    mag = grid_sample_shared_bwd(g.abs().float(), gr, H, W)
    torch.cuda.synchronize()
    tol = CROP_BWD_RTOL * mag
    if g.dtype == torch.bfloat16:   # the spacing of bf16 at the larger
        big = torch.maximum(out.abs(), ref.abs()).clamp(min=2.0 ** -126)
        tol = tol + CROP_BWD_BF16_ULPS * torch.exp2(
            torch.floor(torch.log2(big)) - 7)
    excess = ((out - ref).abs() - tol).max().item()
    err = (out - ref).abs().max().item()
    log("train_kernels", f"crop_shared_bwd {str(g.dtype)[6:]} {label}: "
        f"max_abs_err {err:.3e}, max |d_src| {ref.abs().max().item():.3f}, "
        f"cells reached {(mag.amax(-1) > 0).float().mean().item():.3f}, "
        f"excess over {CROP_BWD_RTOL:g} x sum|g w|"
        + (f" + {CROP_BWD_BF16_ULPS:g} bf16 ulp" if g.dtype == torch.bfloat16
           else "") + f" {excess:.3e} (must be <= 0)")
    if not (excess <= 0 and torch.isfinite(out).all()):
        raise AssertionError(f"crop_shared_bwd ({label}) disagrees with "
                             "plain")
    return err


def _crop_bwd_grids(torch, dev):
    """(label, grid, H, W, C) of crops the step's do not cover: rotations
    of 0, pi/4, pi/2, 3pi/4, pi and -3pi/4 at the step's scale (96 from
    160), crop 64 from 160, crops straddling each border (and the corner
    every far tap is clamped to), a 157 x 163 source, and C = 6 (the
    scalar path)."""
    from lav_tpu_torch.core.warp import affine_grid, crop_theta

    def grid(H, W, crop, locs, oris):
        theta = crop_theta(torch.tensor(locs, dtype=torch.float32),
                           torch.tensor(oris, dtype=torch.float32), H, W,
                           2.0, crop, 0.0, 0.75)
        return affine_grid(theta, crop, crop)[None].to(dev).contiguous()

    turns = [0.0, math.pi / 4, math.pi / 2, 3 * math.pi / 4, math.pi,
             -3 * math.pi / 4]
    locs = [[(-1) ** i * 3.0, 2.0 - i] for i in range(6)]
    edges = [[38.0, 0.0], [-38.0, 0.0], [0.0, 38.0], [0.0, -38.0],
             [38.0, 38.0]]
    return [("rotations", grid(160, 160, 96, locs, turns), 160, 160, 384),
            ("crop 64 from 160", grid(160, 160, 64, locs[:4], turns[:4]),
             160, 160, 384),
            ("border straddles", grid(160, 160, 96, edges,
                                      [0.3, -2.0, 1.2, 2.8, 0.0]),
             160, 160, 384),
            ("157 x 163", grid(157, 163, 96, locs[:3] + edges[:2],
                               turns[:5]), 157, 163, 384),
            ("C = 6", grid(160, 160, 96, locs[:3] + edges[:2], turns[:5]),
             160, 160, 6)]


def _crop_bwd_case(torch, ctx, dev, dtype=None):
    """Kernel crop_shared_bwd (f32, or crop_shared_bwd_bf16 with a bf16
    `dtype`) on the student's two calls of a step (K_TRAIN crops, then the
    ego's) and on `_crop_bwd_grids` against its plain version; a crop
    wholly outside adds nothing; two calls are equal bit for bit; a
    gradient of another dtype is refused on the card; timed as the step's
    pair."""
    import torch.nn.functional as F

    from lav_tpu_torch.core.warp import crop_shared_bwd, grid_sample_shared_bwd

    dtype = dtype or torch.float32
    H = W = 160
    C = 384
    grids = _student_crop_grids(torch, dev)
    gen = torch.Generator(device="cpu").manual_seed(8)
    gs = [torch.randn(tuple(gr.shape[:4]) + (C,), generator=gen).to(
        dev, dtype) for gr in grids]
    worst = 0.0
    for gr, g in zip(grids, gs):
        worst = max(worst, _crop_bwd_check(torch, f"K={gr.shape[1]}", g, gr,
                                           H, W))
        if not torch.equal(crop_shared_bwd(g, gr, H, W),
                           crop_shared_bwd(g, gr, H, W)):
            raise AssertionError("crop_shared_bwd is not bit-reproducible")
        if gr.shape[1] > 1:   # the crop wholly outside adds nothing
            alone = crop_shared_bwd(g[:1, 1:2].contiguous(),
                                    gr[:1, 1:2].contiguous(), H, W)
            if alone.abs().max().item() != 0.0:
                raise AssertionError("a crop outside the source added to it")
    log("train_kernels", f"crop_shared_bwd {str(dtype)[6:]}: two calls on "
        "the step's inputs equal bit for bit (must be)")
    try:
        crop_shared_bwd(gs[1].half(), grids[1], H, W)
    except TypeError as e:
        log("train_kernels", f"crop_shared_bwd refuses f16 on the card: {e}")
    else:
        raise AssertionError("crop_shared_bwd took an f16 gradient")
    for label, gr, h, w, c in _crop_bwd_grids(torch, dev):
        g = torch.randn(tuple(gr.shape[:4]) + (c,), generator=gen).to(
            dev, dtype)
        worst = max(worst, _crop_bwd_check(torch, label, g, gr, h, w))

    def kernel():
        return [crop_shared_bwd(g, gr, H, W) for g, gr in zip(gs, grids)]

    def plain():
        return [grid_sample_shared_bwd(g, gr, H, W) for g, gr in
                zip(gs, grids)]

    # library yardstick, timed only: F.grid_sample's input gradient by
    # autograd on the NCHW form (each item's source expanded over its
    # crops; in bf16 with a bf16 grid, as it requires), the forward taken
    # once outside the timing
    srcs, outs, gouts = [], [], []
    for gr, g in zip(grids, gs):
        B, K = gr.shape[:2]
        src = torch.zeros((B, C, H, W), device=dev, dtype=dtype,
                          requires_grad=True)
        with torch.backends.cudnn.flags(enabled=False):
            o = torch.cat([F.grid_sample(src[b:b + 1].expand(K, C, H, W),
                                         gr[b].to(dtype), mode="bilinear",
                                         padding_mode="zeros",
                                         align_corners=True)
                           for b in range(B)])
        srcs.append(src)
        outs.append(o)
        gouts.append(g.reshape(B * K, *g.shape[2:]).permute(0, 3, 1, 2))

    def lib():
        return torch.autograd.grad(outs, srcs, gouts, retain_graph=True)

    name = "crop_shared_bwd" + ("_bf16" if dtype == torch.bfloat16 else "")
    r = _timed(torch, ctx, name, kernel, plain, lib)
    e = gs[0].element_size()
    nbytes = sum(g.numel() * e + gr.numel() * 4 + gr.shape[0] * H * W * C * e
                 for g, gr in zip(gs, grids))
    flops = sum(g.numel() * 8 for g in gs)
    r["bound_ms"], r["bound_by"] = bound_ms(nbytes, flops)
    log("train_kernels", f"{name} (a step's two calls, "
        f"{nbytes / 1e6:.1f} MB): bound {r['bound_ms']:.4f} ms "
        f"({r['bound_by']}); device-only "
        f"{r['device_ms'] / r['bound_ms']:.2f}x the bound on "
        f"{ctx.get('smi', '?')}")
    del srcs, outs, gouts, gs, grids
    torch.cuda.empty_cache()
    return dict(max_abs_err=worst, **r)


def _timed(torch, ctx, name, kernel, plain, lib):
    """Host-paced and device-only ms and host us per call of `kernel`,
    beside `plain` (host-paced) and `lib` (host-paced and device-only)."""
    r = dict(ms=cuda_ms(torch, kernel, iters=20),
             device_ms=device_ms(torch, kernel),
             host_us=host_us(torch, kernel, n=50),
             plain_ms=cuda_ms(torch, plain, iters=3, warmup=1),
             library_ms=cuda_ms(torch, lib, iters=10),
             library_device_ms=device_ms(torch, lib, iters=10))
    log("train_kernels", f"{name}: kernel {r['ms']:.4f} ms host-paced, "
        f"{r['device_ms']:.4f} ms device-only, {r['host_us']:.1f} us host "
        f"per call; plain {r['plain_ms']:.4f} ms; library "
        f"{r['library_ms']:.4f} / {r['library_device_ms']:.4f} ms on "
        f"{ctx.get('smi', '?')}")
    return r


def _canvas_bwd_inputs(torch, ctx, compute_dtype=None):
    """The (g, feat, pid, canvas, sort) that one distillation step (B =
    NUM_EGO_TRAIN, MAX_POINTS_TRAIN points an item, in `compute_dtype`)
    hands kernel pillar_scatter_max_bwd, taken by wrapping the wrapper;
    the step must hand it the forward's sort."""
    from lav_tpu_torch.ops import pillar
    from lav_tpu_torch.train.distill import distill_setup

    step, models, opt, batch, gen, _ = distill_setup(
        NUM_EGO_TRAIN, MAX_POINTS_TRAIN, device=ctx["device"], seed=0,
        compute_dtype=compute_dtype)
    real, seen = pillar.pillar_scatter_max_bwd, []

    def spy(*args):
        seen.append(tuple(None if a is None else a.clone() for a in args))
        return real(*args)

    pillar.pillar_scatter_max_bwd = spy
    try:
        step(models, opt, batch, gen)
    finally:
        pillar.pillar_scatter_max_bwd = real
    if len(seen) != 1 or len(seen[0]) != 5 or seen[0][4] is None:
        raise AssertionError(f"the step ran the canvas backward "
                             f"{len(seen)} times, or without the forward's "
                             "sort")
    del step, models, opt, batch
    torch.cuda.empty_cache()
    return seen[0]


def _canvas_bwd_cases(torch, dev, dtype=None):
    """Crafted (label, g, feat, pid, canvas, sort) cases in `dtype` (f32
    unless given): ties of 2, 3 and 40 equal maxima, ties at 0, dropped
    ids (negative and past S), empty rows, C = 4 (the vector path), C = 6
    (the scalar path) and 64; one hot row (above CANVAS_HOT: counted by
    whole blocks in chunks) of 5,000 points of which 300 tie in every
    channel; and hot rows of 255, 256, 257, 300 and 1,000 points tied in
    every channel (bf16 counts ties up to 256)."""
    from lav_tpu_torch.ops.pillar import pillar_scatter_max

    g = torch.Generator(device="cpu").manual_seed(9)
    cases = []
    for C in (4, 6, 64):
        S, N = 50, 400
        feat = torch.rand((N, C), generator=g)
        pid = torch.randint(0, S // 2, (N,), generator=g)  # rows 25+ empty
        feat[:2] = 0.75
        pid[:2] = 3                      # a tie of 2 in every channel
        pid[2:5] = 4
        feat[2:5, 0] = 2.0               # a tie of 3 in channel 0
        pid[5:45] = 7
        feat[5:45] = 1.5                 # a tie of 40
        pid[45:60] = 9
        feat[45:60] = torch.minimum(feat[45:60], torch.zeros(()))  # ties at 0
        pid[60:70] = -1
        pid[70:80] = S                   # dropped ids
        feat[60:80] = 5.0
        cases.append((f"crafted C={C}", S, feat, pid))
    S, N = 4 * 102400, 4 * MAX_POINTS_TRAIN
    feat = torch.relu(torch.randn((N, 64), generator=g))
    pid = torch.randint(0, S, (N,), generator=g)
    pid[:5000] = 17                      # one hot row
    feat[:300] = 9.0                     # 300 of its points tie, above
                                         # every other value
    pid[5000:5100] = -1                  # dropped ids
    cases.append(("a hot row of 5000 points", S, feat, pid))
    g2 = torch.Generator(device="cpu").manual_seed(10)
    sizes = (255, 256, 257, 300, 1000)
    S = 20
    feat = torch.rand((sum(sizes) + 100, 64), generator=g2)
    pid = torch.randint(len(sizes), S, (feat.shape[0],), generator=g2)
    at = 0
    for row, n in enumerate(sizes):      # ties at 0 in channel 0, at 3.0
        pid[at:at + n] = row             # in the others
        feat[at:at + n] = 3.0
        feat[at:at + n, 0] = 0.0
        at += n
    cases.append(("rows of 255-1000 tied points", S, feat, pid))
    out = []
    for label, S, feat, pid in cases:
        feat = feat.to(dev, dtype or torch.float32)
        pid = pid.to(torch.int32).to(dev)
        canvas, sort = pillar_scatter_max(feat, pid, S, keep_sort=True)
        grad = torch.randn((S, feat.shape[1]), generator=g).to(
            dev, feat.dtype)
        out.append((label, grad, feat, pid, canvas, sort))
    return out


def _canvas_sort_check(torch, label, feat, pid, canvas, sort):
    """The forward's scratch read as the backward reads it: each row's
    offset and its points (`read_canvas_sort`), the chunk in its meta."""
    from lav_tpu_torch.ops.pillar import (
        _i32, canvas_chunk, canvas_layout, read_canvas_sort,
    )

    (N, C), S, e = feat.shape, canvas.shape[0], feat.element_size()
    offsets, idx = read_canvas_sort(sort, N, C, S, e)
    p = pid.long()
    ok = (p >= 0) & (p < S)
    counts = torch.bincount(p[ok], minlength=S)
    rows = torch.repeat_interleave(torch.arange(S, device=p.device),
                                   offsets.diff())
    chunk = _i32(sort, canvas_layout(N, C, S, e)["meta"], 3)[2].item()
    good = (torch.equal(offsets[1:], counts.cumsum(0)) and offsets[0] == 0
            and torch.equal(p[idx], rows)
            and torch.equal(torch.sort(idx).values,
                            torch.nonzero(ok).flatten())
            and (feat.data_ptr() % 16 or chunk == canvas_chunk(C, e)))
    if not good:
        raise AssertionError(f"pillar_scatter_max's sort ({label}) is not "
                             "laid out as read_canvas_sort reads it")


def _canvas_bwd_case(torch, ctx, dev, dtype=None):
    """Kernel pillar_scatter_max_bwd (f32, or pillar_scatter_max_bwd_bf16
    with a bf16 `dtype`) against its plain version, exact, by both routes
    (on the forward's sort, and sorting itself), on the step's own inputs
    (the bf16 step's in bf16), on crafted ties and on hot rows; the
    forward's sort as the backward reads it; another dtype refused on the
    card; timed on the step's, by both routes."""
    from lav_tpu_torch.ops.pillar import (
        NEG, pillar_scatter_max_bwd, pillar_scatter_max_bwd_plain, tie_count,
    )

    step_args = _canvas_bwd_inputs(torch, ctx, dtype)
    dtype = step_args[1].dtype
    for label, *args in [("the step's", *step_args)] + _canvas_bwd_cases(
            torch, dev, dtype):
        g, feat, pid, canvas, sort = args
        _canvas_sort_check(torch, label, feat, pid, canvas, sort)
        ref = pillar_scatter_max_bwd_plain(g, feat, pid, canvas)
        routes = {"sorted": pillar_scatter_max_bwd(g, feat, pid, canvas,
                                                   sort),
                  "standalone": pillar_scatter_max_bwd(g, feat, pid, canvas)}
        torch.cuda.synchronize()
        S = canvas.shape[0]
        ok = (pid >= 0) & (pid < S)
        s = torch.where(ok, pid.long(), 0)
        tie = ok[:, None] & (feat == canvas[s])
        n = torch.zeros_like(canvas, dtype=torch.int64).index_add_(
            0, s, tie.long())
        equal = {k: torch.equal(v, ref) for k, v in routes.items()}
        log("train_kernels", f"pillar_scatter_max_bwd {str(dtype)[6:]} "
            f"{label}: {feat.shape[0]} points x {feat.shape[1]}, {S} rows, "
            f"most points a row {int(torch.bincount(s[ok]).max().item())}, "
            f"tied cells {(n > 1).sum().item()} (most {int(n.max().item())} "
            f"points, counted as {float(tie_count(n.max(), dtype)):g}), "
            f"dropped ids {(~ok).sum().item()}, equal {equal} (must be)")
        if not all(equal.values()):
            raise AssertionError(f"pillar_scatter_max_bwd ({label}) "
                                 "disagrees with plain")
    g, feat, pid, canvas, sort = step_args
    try:
        pillar_scatter_max_bwd(g.half(), feat.half(), pid, canvas.half())
    except ValueError as e:
        log("train_kernels", "pillar_scatter_max_bwd refuses f16 on the "
            f"card: {str(e)[:60]}...")
    else:
        raise AssertionError("pillar_scatter_max_bwd took f16")
    S, C = canvas.shape
    ok = (pid >= 0) & (pid < S)
    idx = pid.long()[ok][:, None].expand(-1, C)
    fvalid = feat[ok].detach().clone().requires_grad_(True)
    lib_canvas = torch.full((S, C), NEG, device=dev, dtype=dtype).scatter_reduce(
        0, idx, fvalid, "amax", include_self=True)

    def lib():
        return torch.autograd.grad(lib_canvas, fvalid, g, retain_graph=True)

    def alone():
        return pillar_scatter_max_bwd(g, feat, pid, canvas)

    name = "pillar_scatter_max_bwd" + ("_bf16" if dtype == torch.bfloat16
                                       else "")
    r = _timed(torch, ctx, name,
               lambda: pillar_scatter_max_bwd(*step_args),
               lambda: pillar_scatter_max_bwd_plain(*step_args[:4]), lib)
    r["standalone_ms"] = cuda_ms(torch, alone, iters=20)
    r["standalone_device_ms"] = device_ms(torch, alone)
    log("train_kernels", f"{name} standalone (sorting itself): "
        f"{r['standalone_ms']:.4f} ms host-paced, "
        f"{r['standalone_device_ms']:.4f} ms device-only")
    rows = torch.unique(pid[ok]).numel()
    e = feat.element_size()
    nbytes = 2 * feat.numel() * e + pid.numel() * 4 + 2 * rows * C * e
    r["bound_ms"], r["bound_by"] = bound_ms(nbytes, feat.numel())
    log("train_kernels", f"{name} ({rows} touched rows, "
        f"{nbytes / 1e6:.1f} MB): bound {r['bound_ms']:.4f} ms "
        f"({r['bound_by']}); device-only "
        f"{r['device_ms'] / r['bound_ms']:.2f}x the bound on "
        f"{ctx.get('smi', '?')}")
    del step_args, lib_canvas, fvalid, idx
    torch.cuda.empty_cache()
    return dict(max_abs_err=0.0, **r)


def phase_train_kernels(ctx):
    import torch

    dev = torch.device(ctx["device"])
    bf16 = torch.bfloat16
    ctx["train_kernels"] = {
        "crop_shared_step": _crop_fwd_step(torch, ctx, dev, torch.float32),
        "crop_shared_step_bf16": _crop_fwd_step(torch, ctx, dev, bf16),
        "crop_shared_bwd": _crop_bwd_case(torch, ctx, dev),
        "crop_shared_bwd_bf16": _crop_bwd_case(torch, ctx, dev, bf16),
        "pillar_scatter_max_bwd": _canvas_bwd_case(torch, ctx, dev),
        "pillar_scatter_max_bwd_bf16": _canvas_bwd_case(torch, ctx, dev,
                                                        bf16)}


def _card_vs_cpu(ctx, phase, label, cpu_models, cpu_batch, run, leaves,
                 tols):
    """Step 1 of a train step on the card, twice (its own spread: atomics
    and some cuDNN kernels add in another order in every run), and on the
    CPU, from copies of `cpu_models` and `cpu_batch`: run(models, batch,
    device) -> metrics.  Logs loss, grad_norm and the gradient leaves
    `leaves` in L2 against the CPU; returns the names outside `tols` =
    (loss rtol, grad_norm rtol[, leaf L2 when there are `leaves`])."""
    import copy

    runs = []
    for dev in (ctx["device"], ctx["device"], "cpu"):
        models = copy.deepcopy(cpu_models).to(dev)
        t0 = time.perf_counter()
        m = run(models, {k: v.to(dev) for k, v in cpu_batch.items()}, dev)
        secs = time.perf_counter() - t0
        p = dict(models.named_parameters())
        runs.append(({k: float(m[k]) for k in ("loss", "grad_norm")},
                     {n: p[n].grad.cpu() for n in leaves}, secs))
        del models, p
    (g1, g1_leaves, _), (g2, g2_leaves, _), (c, c_leaves, cpu_s) = runs
    bad = []
    for k, rtol in zip(("loss", "grad_norm"), tols):
        rel = abs(g1[k] - c[k]) / abs(c[k])
        log(phase, f"{label} B=2 step 1 {k}: card {g1[k]:.7g}, CPU "
            f"{c[k]:.7g}, rel {rel:.3e} (rtol {rtol}); card run to run "
            f"{abs(g1[k] - g2[k]) / abs(c[k]):.3e}")
        if not rel <= rtol:
            bad.append(f"{label} {k}")
    for name in leaves:
        a, b = g1_leaves[name], c_leaves[name]
        rel = float((a - b).norm() / b.norm())
        spread = float((a - g2_leaves[name]).norm() / b.norm())
        log(phase, f"{label} B=2 step 1 grad {name}: L2 rel {rel:.3e} (tol "
            f"{tols[2]}), card run to run {spread:.3e}, max |g| "
            f"{b.abs().max().item():.4g}")
        if not rel <= tols[2]:
            bad.append(f"{label} {name}")
    log(phase, f"{label}: the CPU step took {cpu_s:.1f} s")
    return bad


def _card_steps(ctx, phase, label, run, B):
    """7 steps of run() -> metrics on the card: the launches of every
    kernel in each of the first 3, loss and grad_norm finite, the p50
    step over steps 2-7, samples/s and peak memory (since the caller's
    reset), then one more step under torch.profiler: its device busy time,
    launches, host syncs, top kernels and top host ops.  Returns (per-step
    launches of the first 3, the counts after them)."""
    import numpy as np
    import torch

    from lav_tpu_torch.utils import native

    native.reset_launches()
    per_step, step_ms, losses = [], [], []
    for i in range(7):
        before = dict(native.LAUNCHES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = run()
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append((float(m["loss"]), float(m["grad_norm"])))
        if i < 3:
            per_step.append({k: native.LAUNCHES[k] - before[k]
                             for k in native.LAUNCHES})
            if i == 2:
                totals = dict(native.LAUNCHES)
    log(phase, f"{label}: launches per step "
        f"{[{k: v for k, v in c.items() if v} for c in per_step]}; "
        f"(loss, grad_norm) {losses}")
    if not np.isfinite(np.array(losses)).all():
        raise AssertionError(f"{label}: non-finite loss or grad_norm")
    p50 = statistics.median(step_ms[1:])
    log(phase, f"{label}: step ms {[round(t, 3) for t in step_ms]}; p50 over "
        f"steps 2-7 {p50:.3f} ms, {B / p50 * 1e3:.2f} samples/s, peak "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB on "
        f"{ctx.get('smi', '?')}")
    from torch.autograd import DeviceType

    avgs, split = profiled(torch, run, iters=1, warmup=0)
    busy = sum(split.values())
    top = sorted(split.items(), key=lambda kv: -kv[1])[:12]
    host = [e for e in avgs if e.device_type != DeviceType.CUDA]
    count = {e.key: e.count for e in host}
    log(phase, f"{label}: one step under the profiler: device busy "
        f"{busy:.3f} ms ({busy / p50:.1%} of the p50), {len(split)} kernel "
        f"names, {count.get('cudaLaunchKernel', 0)} + "
        f"{count.get('cudaLaunchKernelExC', 0)} launches, "
        f"{count.get('cudaStreamSynchronize', 0)} stream syncs; top: "
        + "; ".join(
            f"{re.sub(r'[(]anonymous namespace[)]::|^void ', '', k).split('(')[0][:60]} {v:.3f}"
            for k, v in top))
    log(phase, f"{label}: host self ms: " + "; ".join(
        f"{e.key[:40]} {e.self_cpu_time_total / 1e3:.3f} x{e.count}"
        for e in sorted(host, key=lambda e: -e.self_cpu_time_total)[:8]))
    return per_step, totals


def phase_train(ctx):
    import torch

    from lav_tpu_torch.config import v2_config
    from lav_tpu_torch.models.planner import draw_noise
    from lav_tpu_torch.train.distill import (
        adam, distill_models, distill_setup, make_batch,
        make_distill_forward, make_full_train_step,
    )
    from lav_tpu_torch.utils import native

    # step 1 on the card against the port on the CPU: B = 2, the same
    # weights, batch and noise; f32, then bf16 (lav_tpu's --dtype), then
    # the bf16 step's gradients with BN on its running statistics
    cfg = v2_config()
    noise = draw_noise(torch.Generator().manual_seed(1), 2,
                       cfg.max_objs - 1, cfg.max_num_cars_student)
    bf16_forward = make_distill_forward(cfg, v2=True, mode="full",
                                        compute_dtype=torch.bfloat16)

    def moved(dev):
        return {k: v.to(dev) for k, v in noise.items()}

    def train_step(dtype):
        step = make_full_train_step(cfg, v2=True, mode="full",
                                    compute_dtype=dtype)
        return lambda m, b, dev: step(m, adam(m), b, noise=moved(dev))

    def eval_grads(m, b, dev):
        # the lidar model's eval route: its canvas max is kernel
        # scatter_max, its gradient kernel scatter_max_bwd
        loss, metrics = bf16_forward(m.eval(), b, moved(dev))
        loss.backward()
        metrics["grad_norm"] = torch.sqrt(sum(
            (p.grad * p.grad).sum() for p in m.parameters()
            if p.grad is not None))
        return metrics

    for label, run, leaves, tols in (
            ("distill", train_step(None), TRAIN_LEAVES,
             (TRAIN_LOSS_RTOL, TRAIN_GNORM_RTOL, TRAIN_LEAF_L2)),
            ("distill bf16", train_step(torch.bfloat16), (),
             TRAIN_BF16_TOLS),
            ("distill bf16, BN on its running statistics", eval_grads,
             TRAIN_LEAVES + EVAL_LEAF, TRAIN_BF16_EVAL_TOLS)):
        eval_path = run is eval_grads
        if eval_path:
            native.reset_launches()
        bad = _card_vs_cpu(
            ctx, "train", label,
            distill_models(cfg, torch.Generator().manual_seed(0)),
            make_batch(cfg, 2, MAX_POINTS_TRAIN, seed=0, device="cpu"),
            run, leaves, tols)
        if eval_path:   # two runs on the card, one backward each
            ctx["launches_eval"] = dict(native.LAUNCHES)
            log("train", f"{label}: launches on the card "
                f"{ {k: v for k, v in native.LAUNCHES.items() if v} }")
            if native.LAUNCHES["scatter_max_bwd"] != 2:
                raise AssertionError("the eval route's backward did not run "
                                     "kernel scatter_max_bwd once a run")
        if bad:
            raise AssertionError(f"train step 1, card vs CPU: {bad}")
        torch.cuda.empty_cache()

    # full width, MAX_POINTS_TRAIN points, 3 steps with launch counts, then
    # 4 more, timed: f32 and bf16 at B = NUM_EGO_TRAIN, then f32 at the
    # reference's default batch with remat (the scoped student-crop
    # checkpoint runs inside it)
    runs = (("train", "distill", NUM_EGO_TRAIN, {}, TRAIN_KERNELS),
            ("train_bf16", "distill bf16", NUM_EGO_TRAIN,
             dict(compute_dtype=torch.bfloat16), TRAIN_BF16_KERNELS),
            ("train_b32", "distill remat", B_REF, dict(remat=True),
             TRAIN_KERNELS))
    for path, label, B, kw, kernels in runs:
        torch.cuda.reset_peak_memory_stats()
        step, models, opt, batch, gen, _ = distill_setup(
            B, MAX_POINTS_TRAIN, device=ctx["device"], seed=0, **kw)
        per_step, totals = _card_steps(
            ctx, "train", f"{label} B={B}, {MAX_POINTS_TRAIN} points",
            lambda: step(models, opt, batch, gen), B)
        ctx[f"launches_{path}"] = {k: totals[k] for k in kernels}
        bwd = [k for k in kernels if "_bwd" in k]
        others = [k for k in TRAIN_KERNELS + TRAIN_BF16_KERNELS
                  if k not in kernels]
        if any(min(c[k] for k in kernels) < 1 or c[bwd[0]] != 2
               or c[bwd[1]] != 1 or any(c[k] for k in others)
               for c in per_step):
            raise AssertionError(
                f"{label}: a kernel of {kernels} missed a step, {bwd[0]} "
                f"ran other than on the student's two crops or {bwd[1]} "
                f"other than once, or one of {others} ran")
        del step, models, opt, batch
        torch.cuda.empty_cache()


def phase_privileged(ctx):
    import torch

    from lav_tpu_torch.config import v1_config, v2_config
    from lav_tpu_torch.models.planner import BEVPlanner, draw_bev_noise
    from lav_tpu_torch.models.rgb import BrakeModel, SegModel
    from lav_tpu_torch.train import privileged as TP
    from lav_tpu_torch.train.distill import adam

    def seeded(seed):
        return torch.Generator().manual_seed(seed)

    def moved(d, dev):
        return {k: v.to(dev) for k, v in d.items()}

    # step 1 of each trainer on the card against the port on the CPU: B =
    # 2 at full width, the same weights, batch, noise and dropout masks
    # (drawn once on the CPU)
    cfg, cfg1 = v2_config(), v1_config()
    n_sem = len(cfg1.seg_channels)
    bev_step = TP.make_bev_train_step(cfg, v2=True)
    noise = draw_bev_noise(seeded(1), 2, cfg.max_objs - 1, cfg.max_num_cars)
    seg = SegModel(n_sem, seeded(0))
    masks = seg.erfnet.draw_masks(seeded(1), (2, 3, *TP.SEG_HW))
    seg_step = TP.make_seg_train_step(cfg1)
    bra_step = TP.make_bra_train_step(cfg1, version=2)
    cases = (
        ("bev", BEVPlanner(cfg, seeded(0)), TP.bev_batch(cfg, 2, 0, "cpu"),
         lambda m, b, dev: bev_step(m, adam(m), b, noise=moved(noise, dev))),
        ("seg", seg, TP.seg_batch(2, n_sem, 0, "cpu"),
         lambda m, b, dev: seg_step(m, adam(m), b, masks=moved(masks, dev))),
        ("bra", BrakeModel(2, seeded(0)), TP.bra_batch(2, 0, "cpu"),
         lambda m, b, dev: bra_step(m, adam(m), b)),
    )
    bad = []
    for name, models, batch, run in cases:
        bad += _card_vs_cpu(ctx, "privileged", name, models, batch, run,
                            PRIV_LEAVES[name], PRIV_TOLS[name])
    if bad:
        raise AssertionError(f"privileged step 1, card vs CPU: {bad}")
    del cases, seg, masks
    torch.cuda.empty_cache()

    # each trainer at full width: 3 steps with launch counts, 4 more timed
    dev = ctx["device"]
    for name, B in (("bev", B_BEV), ("seg", B_SEG), ("bra", B_BRA)):
        torch.cuda.reset_peak_memory_stats()
        if name == "bev":
            step, models, opt, batch, gen, _ = TP.bev_setup(B, device=dev)
            label = f"bev v2 B={B}"
        elif name == "seg":
            step, models, opt, batch, gen, _ = TP.seg_setup(B, device=dev)
            label = f"seg B={B}"
        else:
            step, models, opt, batch, _ = TP.bra_setup(B, device=dev,
                                                       version=2)
            gen, label = None, f"bra v2 B={B}"
        run = ((lambda: step(models, opt, batch)) if gen is None else
               (lambda: step(models, opt, batch, gen)))
        per_step, totals = _card_steps(ctx, "privileged", label, run, B)
        if name == "bev":
            ctx["launches_privileged"] = totals
            if any(c["crop_shared"] < 2 or c["crop_shared_bwd"]
                   for c in per_step):
                raise AssertionError("the BEV step must launch crop_shared "
                                     "twice a step and crop_shared_bwd "
                                     "never")
        elif any(sum(c.values()) for c in per_step):
            raise AssertionError(f"the {name} step launched a kernel of "
                                 "the port; it runs library convs only")
        del step, models, opt, batch, gen, run
        torch.cuda.empty_cache()


# phase privileged's batches and phase train's, the bev stage's cut to 32:
# its numpy loader builds a 320x320 sample in ~0.4 s on the card's host
CLI_BATCH = {"bev": 32, "seg": B_SEG, "bra": B_BRA, "full": NUM_EGO_TRAIN}
# steps an epoch; each stage runs 2 epochs, and each logs (a host sync) at
# each epoch's first step.  The bev stage stays at 2: its loader takes
# 6-11 s a step, so its p50 is a spot reading of 3 steps
CLI_STEPS = {"bev": 2, "seg": 8, "bra": 8, "full": 8}
CLI_LIDAR = 40000           # points a sweep: three stacked sweeps fill most
                            # of v2's 120,000 slots
CLI_HW = (288, 256)         # train/privileged.py SEG_HW: the seg, brake and
                            # paint paths' camera images
CLI_TEL_HW = (288, 480)     # the telephoto (lav_tpu/agent/carla_adapter.py
                            # TEL_RGB); the brake dataset cuts its bottom 96


def _cli_cfgs():
    """(v2, v1) configurations of the repository's configs/."""
    import os

    from lav_tpu_torch.config import load_config

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "configs")
    return (load_config(os.path.join(root, "v2.yaml")),
            load_config(os.path.join(root, "v1.yaml")))


def _cli_yaml(path, cfg, **kw):
    import dataclasses

    import yaml

    cfg = cfg.replace(**kw)
    with open(path, "w") as f:
        yaml.safe_dump({f.name: getattr(cfg, f.name)
                        for f in dataclasses.fields(cfg)}, f)
    return path


def _cli_data(root, cfg2, cfg1):
    """Synthetic data dirs at full width, one a stage, each with the frames
    for CLI_STEPS[stage] batches of its stage's CLI_BATCH samples: bev (v2:
    num_plan + 2 * 32 frames, the 320x320 BEV grid; its cameras and sweeps
    unread and small), seg (v1, 5 cameras a frame), bra (v2, its telephoto
    rewritten at CLI_TEL_HW), and the full stage's episode of
    CLI_LIDAR-point sweeps, kept in memory for the paint pass.  Returns
    ({stage: seconds to build}, the full stage's episodes)."""
    import os

    import numpy as np

    from lav_tpu_torch.data.lavpack import convert_episode
    from lav_tpu_torch.data.store import _encode_png, make_synthetic_episode

    bev_hw = (cfg2.ny, cfg2.nx)
    ncam = len(cfg1.camera_yaws)
    frames = {stage: CLI_STEPS[stage] * CLI_BATCH[stage]
                     for stage in ("bev", "seg", "bra", "full")}
    frames["seg"] = -(-frames["seg"] // ncam)
    secs, full = {}, None
    for i, (stage, n) in enumerate(frames.items()):
        t0 = time.perf_counter()
        small = stage == "bev"
        n += (cfg1 if stage == "seg" else cfg2).num_plan
        ep = make_synthetic_episode(
            n_frames=n, n_lidar=64 if stage != "full" else CLI_LIDAR,
            img_hw=(8, 8) if small else CLI_HW, bev_hw=bev_hw, seed=i)
        if stage == "bra":
            rng = np.random.default_rng(i)
            for t in range(n):
                ep.store.put(f"tel_rgb_{t:05d}".encode(), _encode_png(
                    rng.integers(0, 255, (*CLI_TEL_HW, 3), dtype=np.uint8)))
                ep.store.put(f"tel_sem_{t:05d}".encode(), _encode_png(
                    rng.integers(0, 23, CLI_TEL_HW, dtype=np.uint8)))
        os.makedirs(os.path.join(root, stage))
        if stage == "full":
            full = [ep]
        else:
            convert_episode(ep, os.path.join(root, stage, "ep0.lavpack"))
        secs[stage] = time.perf_counter() - t0
    return secs, full


def _sample_profile(label, ds, n: int = 2):
    """The host's ms to build a sample of `ds` (the last n, which stack
    every sweep, under cProfile) and the functions with the most self
    time."""
    import cProfile
    import os
    import pstats

    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    for i in range(len(ds) - n, len(ds)):
        ds[i]
    prof.disable()
    ms = (time.perf_counter() - t0) * 1e3 / n
    rows = sorted(pstats.Stats(prof).stats.items(), key=lambda kv: -kv[1][2])
    log("cli", f"{label}: {ms:.1f} ms to build a sample on the host "
        f"(cProfile on, the last {n}); self ms a sample: " + "; ".join(
            f"{fn} ({os.path.basename(path)}:{line}) {st[2] * 1e3 / n:.1f}"
            for (path, line, fn), st in rows[:6]))


def _same_state(a, b) -> bool:
    """Two state trees equal, tensor for tensor (torch.equal on the CPU)."""
    import torch

    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and torch.equal(a.cpu(), b.cpu())
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same_state(a[k], b[k])
                                            for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(map(_same_state, a, b))
    return a == b


def _cli_run(ctx, label, argv):
    """cli.main(argv) with every launch count set to 0 just before and read
    just after; checks the metrics logged and the checkpoints; prints the
    stage's step p50 (steps 2 and later, CUDA events), samples/s (the last
    epoch, host clock, loader waits included), ms a step waited on the
    loader, and peak memory.  Returns (run, launches)."""
    import json
    import os

    import numpy as np
    import torch

    from lav_tpu_torch.data.loader import device_dtype
    from lav_tpu_torch.train import cli
    from lav_tpu_torch.utils import native

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    native.reset_launches()
    run = cli.main(argv + ["--device", ctx["device"]])
    torch.cuda.synchronize()
    launches = {k: v for k, v in native.LAUNCHES.items() if v}
    peak = torch.cuda.max_memory_allocated() / 2**30
    name = run.stage.name
    save = os.path.join(argv[argv.index("--save-dir") + 1], name)
    recs = [json.loads(ln) for ln in open(os.path.join(save,
                                                       "metrics.jsonl"))]
    losses = [(r["loss"], r["grad_norm"]) for r in recs]
    if run.step_ms:
        logged = [i for i in range(run.it - len(run.step_ms), run.it)
                  if i % CLI_STEPS[run.stage.name] == 0]
        if ([r["step"] for r in recs] != logged
                or not np.isfinite(np.array(losses)).all()):
            raise AssertionError(f"cli {label}: metrics {losses}")
        if not os.path.exists(os.path.join(save, f"{name}_{run.epoch}")):
            raise AssertionError(f"cli {label}: no checkpoint "
                                 f"{name}_{run.epoch}")
        # the samples' dtypes: lav_tpu's after device_put
        want = {k: str(device_dtype(np.asarray(v).dtype)) for k, v in
                run.stage.dataset[0].items()}
        got = {k: str(v).replace("torch.", "") for k, v in
               run.batch_dtypes.items()}
        if got != want:
            raise AssertionError(f"cli {label}: batch dtypes {got}, want "
                                 f"{want}")
    B = int(argv[argv.index("--batch-size") + 1])
    later = run.step_ms[1:]
    p50 = statistics.median(later) if later else float("nan")
    wait = statistics.mean(run.wait_ms[1:]) if later else float("nan")
    n, secs = run.epochs[-1] if run.epochs else (0, float("nan"))
    line = (f"{label}: {len(run.step_ms)} steps to it {run.it}, B={B}; "
            f"dtypes {got if run.step_ms else '-'}; step ms "
            f"{[round(t, 1) for t in run.step_ms]}; p50 over steps 2+ "
            f"{p50:.1f} ms; {n / secs:.2f} samples/s over the last epoch "
            f"({secs:.2f} s); loader wait {wait:.1f} ms a step after the "
            f"first ({run.wait_ms[:1]} ms for the first); peak memory "
            f"{peak:.2f} GiB on {ctx.get('smi', '?')}; launches {launches}; "
            f"(loss, grad_norm) {losses}")
    log("cli", line)
    if run.step_ms:
        _sample_profile(label, run.stage.dataset)
    ctx.setdefault("cli_numbers", {})[label] = dict(
        B=B, step_ms=run.step_ms, wait_ms=run.wait_ms, epochs=run.epochs,
        peak_gib=peak, launches=launches)
    return run, launches


def phase_cli(ctx):
    """The staged training CLI (bev -> seg -> bra -> paint -> full) through
    cli.main on synthetic data dirs at full width."""
    import os
    import tempfile

    import torch

    from lav_tpu_torch.data import lavpack
    from lav_tpu_torch.data.lavpack import convert_episode
    from lav_tpu_torch.models.rgb import SegModel
    from lav_tpu_torch.train import checkpoints as CK
    from lav_tpu_torch.train.paint import run_paint

    t0 = time.perf_counter()
    lavpack.build()
    log("cli", f"g++ built {lavpack.LIB_PATH} in "
        f"{time.perf_counter() - t0:.1f} s")
    cfg2, cfg1 = _cli_cfgs()
    counts = {}
    with tempfile.TemporaryDirectory() as tmp:
        secs, full_eps = _cli_data(os.path.join(tmp, "data"), cfg2, cfg1)
        log("cli", "seconds to build the data: " + ", ".join(
            f"{k} {v:.1f}" for k, v in secs.items()))
        ck = os.path.join(tmp, "ck")
        yml = {stage: _cli_yaml(os.path.join(tmp, f"{stage}.yaml"),
                                cfg1 if stage == "seg" else cfg2,
                                data_dir=os.path.join(tmp, "data", stage))
               for stage in ("bev", "seg", "bra")}

        def argv(stage, cfg_path, save, *extra):
            return [stage, "--config-path", cfg_path, "--batch-size",
                    str(CLI_BATCH[stage]), "--num-epoch", "2",
                    "--num-per-log", str(CLI_STEPS[stage]), "--save-dir",
                    os.path.join(ck, save), *extra]

        def count(launches):
            for k, v in launches.items():
                counts[k] = counts.get(k, 0) + v

        # 1-3: the stage-1 trainers
        run, launches = _cli_run(ctx, "bev v2", argv("bev", yml["bev"], "bev",
                                                     "--v2"))
        count(launches)
        if (launches.get("crop_shared", 0) < 2 * run.it
                or launches.get("crop_shared_bwd")):
            raise AssertionError("the bev stage must launch crop_shared twice "
                                 "a step and crop_shared_bwd never")
        bev_ck = os.path.join(ck, "bev", "bev", "bev_2")
        for stage, extra in (("seg", ()), ("bra", ("--v2",))):
            run, launches = _cli_run(ctx, f"{stage} {' '.join(extra)}".strip(),
                                     argv(stage, yml[stage], stage, *extra))
            if launches:
                raise AssertionError(f"the {stage} stage launched {launches}; "
                                     "it runs library convs only")
        tel = run.stage.dataset[0]["tel_rgb"].shape
        if tel != (CLI_TEL_HW[0] - cfg2.crop_tel_bottom, CLI_TEL_HW[1], 3):
            raise AssertionError(f"bra: a telephoto of {tel}")
        log("cli", f"bra --v2: wide {run.stage.dataset[0]['rgb'].shape}, "
            f"telephoto {tel} a sample")
        # 4: paint the full stage's episode in memory with the seg stage's
        # checkpoint, then pack it
        t0 = time.perf_counter()
        seg = CK.load_params(os.path.join(ck, "seg", "seg", "seg_2"),
                             SegModel(len(cfg2.seg_channels)))
        n = run_paint(cfg2, seg.to(ctx["device"]), full_eps,
                      max_points=CLI_LIDAR, rgb_hw=CLI_HW)
        for i, ep in enumerate(full_eps):
            convert_episode(ep, os.path.join(tmp, "data", "full",
                                             f"ep{i}.lavpack"))
        log("cli", f"paint: {n} frames painted and packed in "
            f"{time.perf_counter() - t0:.1f} s")
        del seg
        full_yml = _cli_yaml(os.path.join(tmp, "full.yaml"), cfg2,
                             data_dir=os.path.join(tmp, "data", "full"),
                             bev_model_dir=bev_ck)
        # 5-6: the full stage in f32 and in bf16, its teacher the bev
        # stage's
        teacher = torch.load(bev_ck, map_location="cpu")["params"]
        for label, save, extra, kernels in (
                ("full v2", "full", (), TRAIN_KERNELS),
                ("full v2 bf16", "full_bf16", ("--dtype", "bfloat16"),
                 TRAIN_BF16_KERNELS)):
            run, launches = _cli_run(ctx, label, argv(
                "full", full_yml, save, "--v2", *extra))
            count(launches)
            steps = run.it
            others = [k for k in TRAIN_KERNELS + TRAIN_BF16_KERNELS
                      if k not in kernels]
            bwd = [k for k in kernels if "_bwd" in k]
            if (min(launches.get(k, 0) for k in kernels) < steps
                    or launches.get(bwd[0]) != 2 * steps
                    or launches.get(bwd[1]) != steps
                    or any(launches.get(k) for k in others)):
                raise AssertionError(f"{label}: launches {launches}, want "
                                     f"each of {kernels} every step")
            got = run.stage.models["uniplanner"].bev_planner.state_dict()
            if not _same_state(got, teacher):
                raise AssertionError(f"{label}: the teacher is not the bev "
                                     "stage's checkpoint")
            ds = run.stage.dataset
            valid = int(ds[len(ds) - 1]["lidar_valid"].sum())
            log("cli", f"{label}: a sample of three sweeps holds {valid} "
                f"valid points of {cfg2.max_lidar_points}")
            del run
            torch.cuda.empty_cache()
        # 7: resume from the f32 run's epoch-1 checkpoint: restored exactly
        # (a run of no steps), then trained for the second epoch
        snap_path = os.path.join(ck, "full", "full", "full_1")
        snap = torch.load(snap_path, map_location="cpu")
        run, _ = _cli_run(ctx, "full v2 resume (restore)", argv(
            "full", full_yml, "resume0", "--v2", "--num-epoch", "1",
            "--resume", snap_path))
        opt = run.stage.optimizer
        if not (_same_state(run.stage.models.state_dict(), snap["params"])
                and _same_state(opt.state_dict(), snap["opt_state"])
                and opt.scheduler.last_epoch == snap["opt_state"][
                    "scheduler"]["last_epoch"] == snap["it"]
                and (run.epoch, run.it) == (snap["epoch"], snap["it"])):
            raise AssertionError("the resumed run did not restore the "
                                 "snapshot's params, optimizer state and "
                                 "schedule count")
        log("cli", f"resume: params, optimizer state and schedule count "
            f"({opt.scheduler.last_epoch}) equal the epoch-1 snapshot's")
        del run, opt
        run, launches = _cli_run(ctx, "full v2 resumed", argv(
            "full", full_yml, "resume", "--v2", "--resume", snap_path))
        count(launches)
        if run.it != 2 * snap["it"] or min(launches.get(k, 0) for k in
                                          TRAIN_KERNELS) < snap["it"]:
            raise AssertionError(f"resumed run: it {run.it}, launches "
                                 f"{launches}")
        del run
        torch.cuda.empty_cache()
    ctx["launches_cli"] = counts


EVAL_KERNELS = ("crop_shared", "scatter_max", "scatter_add")
EVAL_ATOL = 1e-4            # ego 0 card vs CPU under det_override and in
EVAL_RTOL = 1e-3            # the adapter's core (phase agent: 4.8e-7)
EVAL_EPISODES, EVAL_TICKS = 2, 40
EVAL_EGOS, EVAL_EGO_TICKS = 16, 20
EVAL_ROUTE_TICKS = 120
EVAL_SWEEP = 40000          # points in a raw CARLA-like sweep, cut to 8192
EVAL_SCENE_TICKS = (6, 7)   # the crossing car in front of the ego
EVAL_OFFSETS = (0.0, -1.0, 1.0, 2.0)   # each ego's lateral scene shift, m
# the route file the phase writes (leaderboard format): a 90 degree turn
# and a lateral lane change; evaluate.main adds both reversed
EVAL_ROUTES = ([(0, 0), (60, 0), (120, 0), (120, 60), (120, 120)],
               [(0, 0), (60, 0), (85, 3.5), (150, 3.5)])


def _eval_launches(native):
    return {k: native.LAUNCHES[k] for k in EVAL_KERNELS}


def _valid_order(aux, W):
    """Ego 0's valid detection slots sorted by pixel: invalid slots tie at
    score 0, and top-k picks them in its own order on each device."""
    import numpy as np

    d = {k: v[0].cpu().numpy() for k, v in aux["dets"].items()}
    idx = np.flatnonzero(d["valid"])
    return idx[np.argsort(d["y"][idx].astype(np.int64) * W + d["x"][idx],
                          kind="stable")]


def _eval_ego0(aux, W):
    """Ego 0's plan, valid other vehicles and their casts, on the host."""
    order = _valid_order(aux, W)
    valid = aux["other_valid"][0].cpu().numpy()[order]
    return order, valid, aux["other_cast_locs"][0].cpu().numpy()[order][valid]


def _eval_gt(ctx, models, cpu_models, cfg, native):
    """Step 1: the 4-ego det_override agent on the scripted scene, card
    against CPU for ego 0 (ROADMAP C2)."""
    import numpy as np
    import torch

    from lav_tpu_torch.agent.agent import build_agent
    from lav_tpu_torch.agent.evaluate import scene_maps, scripted_scene
    from lav_tpu_torch.agent.setup import make_obs

    def scenes(t, offsets):
        out = []
        for off in offsets:
            locs, oris, valid = scripted_scene(t)
            out.append((locs + np.float32([off, 0.0]), oris, valid))
        return out

    def run(dev, m, E):
        init, step = build_agent(cfg, num_ego=E, max_points=MAX_POINTS,
                                 det_override=True, device=dev)
        state, obs, outs = init(), make_obs(E, MAX_POINTS, device=dev), []
        for t in EVAL_SCENE_TICKS:
            obs.update(scene_maps(cfg, scenes(t, EVAL_OFFSETS[:E]), dev))
            ctrl, state, aux = step(m, state, obs)
            outs.append((ctrl, aux))
        return outs

    native.reset_launches()
    outs = run(ctx["device"], models, NUM_EGO)
    torch.cuda.synchronize()
    got = _eval_launches(native)
    if min(got.values()) < len(EVAL_SCENE_TICKS):
        raise AssertionError(f"ground-truth ticks missed a kernel: {got}")
    _check_controls(torch, outs)
    worst, n_valid = 0.0, []
    for t, ((cg, ag), (cc, ac)) in enumerate(zip(outs, run("cpu",
                                                           cpu_models, 1))):
        og, vg, lg = _eval_ego0(ag, cfg.nx)
        oc, vc, lc = _eval_ego0(ac, cfg.nx)
        if not (np.array_equal(vg, vc) and len(og) == len(oc)):
            raise AssertionError(f"tick {t + 1}: other_valid card {vg} CPU "
                                 f"{vc}")
        n_valid.append(int(vg.sum()))
        pairs = ((_ego0(cg, ag), _ego0(cc, ac)), (lg, lc))
        for g, c in pairs:
            np.testing.assert_allclose(g, c, atol=EVAL_ATOL, rtol=EVAL_RTOL,
                                       err_msg=f"tick {t + 1} ego 0")
            worst = max(worst, float(np.abs(g - c).max(initial=0.0)))
    if min(n_valid) < 2:
        raise AssertionError(f"ego 0 sees {n_valid} valid vehicles")
    log("eval", f"ground truth: {NUM_EGO} egos x {len(EVAL_SCENE_TICKS)} "
        f"ticks, launches {got}; ego 0's valid vehicles {n_valid}; its "
        f"controls, plan and casts match the CPU port: max_abs_err "
        f"{worst:.3e} (atol {EVAL_ATOL}, rtol {EVAL_RTOL})")
    return got


def _eval_skip(ctx, models, cfg, native):
    """Step 2: two ticks with each stage skipped."""
    import torch

    from lav_tpu_torch.agent.agent import SKIP_STAGES, build_agent
    from lav_tpu_torch.agent.setup import make_obs

    obs = make_obs(NUM_EGO, MAX_POINTS, device=ctx["device"])
    seen = {}
    for stage in SKIP_STAGES:
        init, step = build_agent(cfg, num_ego=NUM_EGO, max_points=MAX_POINTS,
                                 skip=(stage,), device=ctx["device"])
        native.reset_launches()
        outs = _run_ticks(step, models, init(), obs, 2)
        torch.cuda.synchronize()
        got = seen[stage] = _eval_launches(native)
        _check_controls(torch, outs)
        if stage == "lidar" and got["scatter_max"] + got["scatter_add"]:
            raise AssertionError(f"skip lidar launched a scatter: {got}")
        if stage == "planner" and got["crop_shared"]:
            raise AssertionError(f"skip planner launched crop_shared: {got}")
    log("eval", f"skip, launches in 2 ticks: {seen}")


def _eval_main(label, argv, native):
    """evaluate.main on `argv`, its launches counted, its seconds split
    into the synthetic episodes' build, the evaluation loops and the rest
    (parsing, weights, agent build, results.json)."""
    import torch

    from lav_tpu_torch.agent import evaluate

    parts = {"episodes": ("_episodes",),
             "loops": ("evaluate_episode", "evaluate_batched",
                       "evaluate_routes")}
    secs = dict.fromkeys(parts, 0.0)
    held = {n: getattr(evaluate, n) for names in parts.values()
            for n in names}

    def timed(part, fn):
        def run(*args, **kwargs):
            t = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                torch.cuda.synchronize()
                secs[part] += time.perf_counter() - t
        return run

    for part, names in parts.items():
        for n in names:
            setattr(evaluate, n, timed(part, held[n]))
    native.reset_launches()
    t0 = time.perf_counter()
    try:
        out = evaluate.main(argv + ["--device", "cuda"])
        torch.cuda.synchronize()
    finally:
        for n, fn in held.items():
            setattr(evaluate, n, fn)
    total = time.perf_counter() - t0
    got = _eval_launches(native)
    log("eval", f"{label}: {total:.1f} s (episodes built "
        f"{secs['episodes']:.1f} s, evaluation loops {secs['loops']:.1f} s, "
        f"rest {total - sum(secs.values()):.1f} s), launches {got}")
    return out, got


def _avi_frames(path) -> int:
    import struct

    with open(path, "rb") as f:
        data = f.read()
    return struct.unpack_from("<14I", data, data.index(b"avih") + 8)[4]


def _route_xml(path):
    import math

    lines = ['<?xml version="1.0"?>', "<routes>"]
    for i, wps in enumerate(EVAL_ROUTES):
        lines.append(f'<route id="{i}" town="Town05">')
        for (x0, y0), (x1, y1) in zip(wps, wps[1:] + wps[-1:]):
            yaw = math.degrees(math.atan2(y1 - y0, x1 - x0))
            lines.append(f'<waypoint pitch="0.0" roll="0.0" x="{x0}" '
                         f'y="{y0}" yaw="{yaw:.1f}" z="0.0"/>')
        lines.append("</route>")
    with open(path, "w") as f:
        f.write("\n".join(lines + ["</routes>", ""]))
    return path


def _eval_runs(ctx, tmp, native):
    """Steps 3-5: evaluate.main's episodes, lockstep egos and routes."""
    import json
    import os

    total = {k: 0 for k in EVAL_KERNELS}

    def add(got, at_least):
        if min(got.values()) < at_least:
            raise AssertionError(f"a kernel missed a tick: {got}")
        for k in total:
            total[k] += got[k]

    out = os.path.join(tmp, "results.json")
    res, got = _eval_main("episodes", [
        "--v2", "--episodes", str(EVAL_EPISODES), "--ticks",
        str(EVAL_TICKS), "--max-points", str(MAX_POINTS), "--out", out,
        "--video", os.path.join(tmp, "ep.avi")], native)
    add(got, EVAL_EPISODES * EVAL_TICKS)
    with open(out) as f:
        if json.load(f) != res:
            raise AssertionError("results.json differs from main's result")
    if set(res) != {"_checkpoint", "values", "labels"}:
        raise AssertionError(f"results.json keys {sorted(res)}")
    for e, r in enumerate(res["_checkpoint"]["records"]):
        lat, meta = r["meta"]["latency"], r["meta"]
        frames = _avi_frames(os.path.join(tmp, f"ep_{e}.avi"))
        if (r["status"] != "Completed" or meta["ticks"] != EVAL_TICKS
                or frames != EVAL_TICKS):
            raise AssertionError(f"episode {e}: {r['status']}, "
                                 f"{meta['ticks']} ticks, {frames} frames")
        log("eval", f"episode {e}: p50 tick {lat['p50_s'] * 1e3:.3f} ms, "
            f"{lat['steps_per_sec']:.2f} steps/s, plan L2 "
            f"{meta['expert_plan_l2']:.3f} m, brake agreement "
            f"{meta['brake_agreement']:.3f}, {frames} video frames; "
            f"on {ctx.get('smi', '?')}")

    rec, got = _eval_main("lockstep", [
        "--v2", "--num-ego", str(EVAL_EGOS), "--ticks", str(EVAL_EGO_TICKS),
        "--max-points", str(MAX_POINTS), "--out", out], native)
    add(got, EVAL_EGO_TICKS)
    if rec["nan_controls"] or rec["ticks"] != EVAL_EGOS * EVAL_EGO_TICKS:
        raise AssertionError(f"lockstep: {rec}")
    ctx["eval_ego_ticks_per_s"] = rec["ego_steps_per_sec"]
    log("eval", f"lockstep {EVAL_EGOS} egos x {EVAL_EGO_TICKS} ticks: p50 "
        f"{rec['latency']['p50_s'] * 1e3:.3f} ms, "
        f"{rec['ego_steps_per_sec']} ego-ticks/s")

    res, got = _eval_main("routes", [
        "--v2", "--routes", _route_xml(os.path.join(tmp, "routes.xml")),
        "--ticks", str(EVAL_ROUTE_TICKS), "--max-points", str(MAX_POINTS),
        "--out", out], native)
    recs = res["_checkpoint"]["records"]
    add(got, sum(r["meta"]["ticks"] for r in recs))
    if len(recs) != 2 * len(EVAL_ROUTES):
        raise AssertionError(f"{len(recs)} route records")
    for r in recs:
        m = r["meta"]
        hist = {int(k): v for k, v in m["cmd_hist"].items()}
        ok = (r["status"] == "Completed" and m["plan_progress"] > 80.0
              and 3 in hist and len(hist) > 1)
        log("eval", f"{r['route_id']}: {m['ticks']} ticks, plan_progress "
            f"{m['plan_progress']}, cmd_hist {hist}, collides "
            f"{m['collides_ticks']}, collide_releases "
            f"{m['collide_releases']}, p50 "
            f"{m['latency']['p50_s'] * 1e3:.3f} ms")
        if not ok:
            raise AssertionError(f"route {r['route_id']}: {r}")
    return total


def _carla_stubs():
    import sys
    import types

    class VehicleControl:
        def __init__(self, steer=0.0, throttle=0.0, brake=0.0):
            self.steer, self.throttle, self.brake = steer, throttle, brake

    class AutonomousAgent:
        def __init__(self, path_to_conf_file=None):
            self._global_plan = None
            self.setup(path_to_conf_file)

        def set_global_plan(self, global_plan_gps, global_plan_world=None):
            self._global_plan = global_plan_gps

    carla = types.ModuleType("carla")
    carla.VehicleControl = VehicleControl
    auto = types.ModuleType("leaderboard.autoagents.autonomous_agent")
    auto.AutonomousAgent = AutonomousAgent
    auto.Track = types.SimpleNamespace(SENSORS="SENSORS")
    mods = {"carla": carla, "leaderboard": types.ModuleType("leaderboard"),
            "leaderboard.autoagents":
                types.ModuleType("leaderboard.autoagents"),
            "leaderboard.autoagents.autonomous_agent": auto}
    sys.modules.update(mods)
    return list(mods)


def _eval_adapter(ctx, tmp, models, cpu_models, cfg, native):
    """Step 6: LAVAgentCore on 40,000-point sweeps, card against CPU, then
    LAVAgent through stub carla / leaderboard modules on checkpoints."""
    import importlib
    import os
    import sys

    import numpy as np
    import torch

    from lav_tpu_torch.agent import carla_adapter as ca
    from lav_tpu_torch.agent.demo import build_params
    from lav_tpu_torch.agent.env import ReplayEnv
    from lav_tpu_torch.data.store import make_synthetic_episode
    from lav_tpu_torch.train.checkpoints import save_checkpoint

    env = ReplayEnv(make_synthetic_episode(
        n_frames=10, n_lidar=EVAL_SWEEP, img_hw=(288, 256),
        bev_hw=(cfg.ny, cfg.nx), seed=0), cfg, max_points=EVAL_SWEEP)
    frames = list(env.frames())
    cores = [ca.LAVAgentCore(cfg, m, device=d) for m, d in
             ((models, ctx["device"]), (cpu_models, "cpu"))]
    for core in cores:
        core.set_global_plan(env.global_plan())
    native.reset_launches()
    outs, worst = [], 0.0
    for t, f in enumerate(frames):
        args = (f["lidar"], f["rgbs"], f["tel_rgb"], f["gps"], f["compass"],
                f["speed"])
        *c, aux = cores[0].run_step(*args)
        outs.append(c)
        if t < 2:
            *cc, auxc = cores[1].run_step(*args)
            g = np.concatenate([c, aux["plan_locs"][0].cpu().numpy().ravel()])
            w = np.concatenate([cc, auxc["plan_locs"][0].numpy().ravel()])
            np.testing.assert_allclose(g, w, atol=EVAL_ATOL, rtol=EVAL_RTOL,
                                       err_msg=f"adapter tick {t + 1}")
            worst = max(worst, float(np.abs(g - w).max()))
    got = _eval_launches(native)
    if min(got.values()) < len(frames) or not np.isfinite(outs).all():
        raise AssertionError(f"adapter core: launches {got}, {outs}")
    log("eval", f"LAVAgentCore: {len(frames)} ticks of {EVAL_SWEEP}-point "
        f"sweeps (cut to {MAX_POINTS}), launches {got}; ticks 1-2 match "
        f"the CPU: max_abs_err {worst:.3e}")

    # the checkpoints hold seed-9 weights: setup first builds seed 0, so
    # only a load makes each of its models differ from `models`
    names = ("lidar_model", "uniplanner", "seg_model", "bra_model")
    saved = build_params(cfg, seed=9, eval_priors=True, device="cpu")
    dirs = {}
    for name in names:
        sd = getattr(saved, name).state_dict()
        tree = (dict(params=sd, opt_state={}, epoch=1, it=1)
                if name == "lidar_model" else sd)
        dirs[f"{name}_dir"] = save_checkpoint(
            os.path.join(tmp, name, "ck.th"), tree)
    conf = _cli_yaml(os.path.join(tmp, "agent.yaml"), cfg, **dirs)
    stubs = _carla_stubs()
    try:
        mod = importlib.reload(ca)
        agent = mod.LAVAgent(conf)
        for name in names:
            held = getattr(agent.core.models, name).state_dict()
            seed0 = getattr(models, name).state_dict()
            want = getattr(saved, name).state_dict()
            if not all(torch.equal(held[k].cpu(), v)
                       for k, v in want.items()):
                raise AssertionError(f"LAVAgent.setup: {name} is not the "
                                     "checkpoint's")
            if all(torch.equal(held[k], seed0[k]) for k in want):
                raise AssertionError(f"LAVAgent.setup: {name} kept the "
                                     "seed-0 weights")
        agent.set_global_plan(env.global_plan())
        rng = np.random.default_rng(0)
        ctrls = []
        for t, f in enumerate(frames[:3]):
            data = {"LIDAR": (t, f["lidar"]), "GPS": (t, np.append(
                f["gps"], 0.0)), "IMU": (t, np.append(np.zeros(6),
                                                      f["compass"])),
                    "EGO": (t, {"speed": float(f["speed"])}),
                    "TEL_RGB": (t, rng.integers(0, 255, (288, 480, 4),
                                                dtype=np.uint8))}
            for i in range(3):
                data[f"RGB_{i}"] = (t, rng.integers(0, 255, (288, 256, 4),
                                                    dtype=np.uint8))
            c = agent.run_step(data, t)
            ctrls.append((c.steer, c.throttle, c.brake))
        agent.destroy()
    finally:
        for name in stubs:
            sys.modules.pop(name, None)
        importlib.reload(ca)
    if not np.isfinite(ctrls).all():
        raise AssertionError(f"LAVAgent controls {ctrls}")
    log("eval", f"LAVAgent through stub carla / leaderboard: setup loaded "
        f"the four seed-9 checkpoints (each differs from seed 0), 3 "
        f"run_steps {np.round(ctrls, 4).tolist()}")
    return got


def phase_eval(ctx):
    import tempfile

    import torch

    from lav_tpu_torch.agent.demo import build_params
    from lav_tpu_torch.config import v2_config
    from lav_tpu_torch.utils import native

    cfg = v2_config()
    models = build_params(cfg, seed=0, eval_priors=True,
                          device=ctx["device"])
    cpu_models = build_params(cfg, seed=0, eval_priors=True, device="cpu")
    steps = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        gt = _eval_gt(ctx, models, cpu_models, cfg, native)
        steps["ground truth"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        _eval_skip(ctx, models, cfg, native)
        steps["skip"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        runs = _eval_runs(ctx, tmp, native)
        steps["episodes, lockstep, routes"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        core = _eval_adapter(ctx, tmp, models, cpu_models, cfg, native)
        steps["adapter"] = time.perf_counter() - t0
    ctx["launches_evaluator"] = {k: gt[k] + runs[k] + core[k]
                                 for k in EVAL_KERNELS}
    torch.cuda.empty_cache()
    log("eval", f"launches on the phase's paths "
        f"{ctx['launches_evaluator']}; "
        "seconds " + ", ".join(f"{k} {v:.1f}" for k, v in steps.items()))


def _same_leaves(torch, a, b) -> bool:
    """Every tensor of two pytrees equal: dtype, shape and values, NaN
    positions equal."""
    from torch.utils import _pytree

    la, lb = _pytree.tree_leaves(a), _pytree.tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape
        and torch.equal(torch.isnan(x) if x.is_floating_point() else x,
                        torch.isnan(y) if y.is_floating_point() else y)
        and torch.equal(torch.nan_to_num(x) if x.is_floating_point() else x,
                        torch.nan_to_num(y) if y.is_floating_point() else y)
        for x, y in zip(la, lb))


EXPORT_TICKS = 6


def phase_export(ctx):
    """The exported tick (agent/export.py): the f32 agent (4 egos, 8192
    points) and lav_tpu's serving configuration (16 egos, 10000 points,
    bf16, "mxu" int8 uncalibrated, so with dynamic scales) exported on the
    card, loaded from the bytes, and run for EXPORT_TICKS ticks beside the
    eager tick on the same models and observations: every tick's
    controls, state and aux equal (NaN positions equal), the same launch
    counts of every kernel over the first 3 ticks, and the p50 of ticks
    2+ of both on the host clock; no deterministic flag is set for the
    process (both ticks repeat themselves, ROADMAP C10).  Then what a
    custom op's call costs the host against the direct launch
    (`_op_dispatch_costs`)."""
    import torch

    dev = ctx["device"]
    res = {}
    _export_runs(torch, ctx, dev, res)
    res["dispatch"] = _op_dispatch_costs(torch, ctx)
    ctx["export"] = res


def _export_runs(torch, ctx, dev, res):
    import copy

    from lav_tpu_torch.agent.agent import build_agent
    from lav_tpu_torch.agent.export import export_agent_step, load_agent_step
    from lav_tpu_torch.agent.setup import v2_agent_setup
    from lav_tpu_torch.nn import quant as Q
    from lav_tpu_torch.utils import native

    for label, E, P, kw in (
            ("f32", NUM_EGO, MAX_POINTS, {}),
            ("serving", NUM_EGO_PROD, MAX_POINTS_PROD,
             dict(compute_dtype=torch.bfloat16, quant_int8=True))):
        _, models, _, obs, cfg = v2_agent_setup(max_points=P, num_ego=E,
                                                device=dev, seed=0)
        t0 = time.perf_counter()
        blob = export_agent_step(cfg, models, max_points=P, num_ego=E,
                                 device=dev, **kw)
        t_export = time.perf_counter() - t0
        t0 = time.perf_counter()
        loaded = load_agent_step(blob)
        t_load = time.perf_counter() - t0
        eager_models = models
        if kw:
            eager_models = copy.deepcopy(models)
            Q.quantize_tree(eager_models.lidar_model)
            Q.quantize_tree(eager_models.uniplanner)
        init, eager = build_agent(cfg, num_ego=E, max_points=P,
                                  compute_dtype=kw.get("compute_dtype"),
                                  device=dev)
        runs = {"loaded": lambda st: loaded(st, obs),
                "eager": lambda st: eager(eager_models, st, obs)}
        outs, counts, p50 = {}, {}, {}
        for name, fn in runs.items():
            native.reset_launches()
            st, ticks, ms = init(), [], []
            for t in range(EXPORT_TICKS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                ctrl, st, aux = fn(st)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
                ticks.append((tuple(ctrl), tuple(st), aux))
                if t == 2:
                    counts[name] = {k: v for k, v in native.LAUNCHES.items()
                                    if v}
            outs[name], p50[name] = ticks, statistics.median(ms[1:])
        same = [_same_leaves(torch, a, b) for a, b in
                zip(outs["loaded"], outs["eager"])]
        log("export", f"{label} ({E} egos, {P} points{', ' if kw else ''}"
            f"{'bf16, int8 mxu, dynamic scales' if kw else ''}): exported in "
            f"{t_export:.1f} s ({len(blob) / 2 ** 20:.1f} MiB), loaded in "
            f"{t_load:.1f} s; ticks equal to eager {same}; launches over 3 "
            f"ticks loaded {counts['loaded']}, eager {counts['eager']}; p50 "
            f"of ticks 2-{EXPORT_TICKS} loaded {p50['loaded']:.3f} ms, eager "
            f"{p50['eager']:.3f} ms on {ctx.get('smi', '?')}")
        if not all(same) or counts["loaded"] != counts["eager"] or \
                not counts["loaded"].get("scatter_add"):
            raise AssertionError(f"export {label}: the loaded tick differs "
                                 "from the eager tick")
        res[label] = dict(p50_loaded_ms=p50["loaded"],
                          p50_eager_ms=p50["eager"], export_s=t_export)
        ctx.setdefault("launches_export", {})
        for k, v in counts["loaded"].items():
            ctx["launches_export"][k] = ctx["launches_export"].get(k, 0) + v
        del models, eager_models, loaded, outs, blob
        torch.cuda.empty_cache()


def _op_dispatch_costs(torch, ctx):
    """Host us a call (`host_us`) of three wrappers' direct launch and of
    the same launch through their custom ops (torch.ops.lav_tpu_torch.*),
    on small inputs, so that the launch's host cost is what is read."""
    from lav_tpu_torch.core import warp
    from lav_tpu_torch.nn import quant as Q
    from lav_tpu_torch.ops import pillar

    dev = torch.device(ctx["device"])
    g = torch.Generator(device=dev).manual_seed(8)
    feat = torch.rand((4096, 4), generator=g, device=dev)
    pid = torch.randint(0, 1000, (4096,), generator=g, device=dev,
                        dtype=torch.int32)
    src = torch.rand((1, 64, 64, 32), generator=g, device=dev)
    grid = torch.rand((1, 2, 16, 16, 2), generator=g, device=dev) * 2 - 1
    xq = torch.randint(-127, 128, (1, 16, 16, 32), generator=g, device=dev,
                       dtype=torch.int8)
    w = torch.randint(-127, 128, (32, 3, 3, 32), generator=g, device=dev,
                      dtype=torch.int8)
    ws, sx = torch.ones(32, device=dev), torch.tensor(0.01, device=dev)
    ops = torch.ops.lav_tpu_torch
    pairs = {
        "scatter_add": (lambda: pillar._scatter_add(feat, pid, 1000),
                        lambda: ops.scatter_add(feat, pid, 1000)),
        "crop_shared": (lambda: warp._crop_shared(src, grid),
                        lambda: ops.crop_shared(src, grid)),
        "conv2d_int8": (
            lambda: Q._conv2d_int8_nhwc(xq, w, ws, sx, None, (1, 1),
                                        (1, 1), (1, 1), torch.float32),
            lambda: ops.conv2d_int8(xq, w, ws, sx, None, [1, 1],
                                    [1, 1, 1, 1], [1, 1], torch.float32,
                                    [1, 1]))}
    out = {}
    for name, (direct, op) in pairs.items():
        if not torch.equal(direct(), op()):
            raise AssertionError(f"{name}: the custom op's output differs "
                                 "from the direct launch's")
        out[name] = dict(direct_us=host_us(torch, direct),
                         op_us=host_us(torch, op))
    log("export", "host us a call, direct launch against the custom op: "
        + "; ".join(f"{k} {v['direct_us']:.1f} / {v['op_us']:.1f}"
                    for k, v in out.items()) + f" on {ctx.get('smi', '?')}")
    return out


PARALLEL_B = {"distill": NUM_EGO_TRAIN, "bev": 8}
# 2 ranks against one process on the card, relative: the first step's
# loss, grad_norm, gradients (all leaves' differences in L2 over
# grad_norm) and BatchNorm running statistics (in L2 over theirs), and the
# second step's loss after Adam's first update.  Each limit lies between
# the sound reading (another summation order, amplified by train-mode BN;
# distillation / BEV: 7.7e-7 / 9.3e-8, 4.0e-4 / 9.3e-7, 1.2e-2 / 9.1e-4,
# 2.7e-7 / 2.3e-8, 6.4e-3 / 1.2e-4) and the smallest reading of a fault
# planted in a copy that moves it: rank-local BN statistics (loss 9.0e-4,
# grad_norm 6.0e-3, gradients 0.30, loss_2 1.2e-2), rank-local running
# statistics (buffers 2.1e-3), per-rank ratios of means (loss 9.8e-3) and
# a missing gradient all-reduce (grad_norm 0.24, gradients 0.60); PERF.md.
PARALLEL_RTOL = dict(loss=3e-5, grad_norm=1.5e-3, grads=5e-2, buffers=2e-5,
                     loss_2=1e-2)


def phase_parallel(ctx):
    """Data-parallel training on the one card (parallel/dryrun.py):
    the distillation step at B = 4 in f32 (16384 points an item) and the
    v2 BEV step at B = 8, v2_config(), 2 steps each, run three ways, each
    in processes of its own with deterministic algorithms: without a
    process group, as 1 rank over NCCL, and as 2 ranks over gloo that
    share the card (NCCL refuses two ranks on one device).  1 rank equals
    no group bit for bit (losses, grad_norm, every gradient, parameter and
    BatchNorm running statistic); 2 ranks are held to PARALLEL_RTOL and to
    each other's parameters and buffers bit for bit.  Every rank's
    launches, per kernel, must equal the run without a group's; the
    kernels line's `parallel_launches` sums the ranks' (3 ranks, 2 cases,
    2 steps each)."""
    import torch

    from lav_tpu_torch.config import v2_config
    from lav_tpu_torch.parallel import dryrun as D

    cfg = v2_config()
    dev = ctx["device"]
    cuda = dev == "cuda"
    specs = [("distill", dict(batch_size=PARALLEL_B["distill"],
                              max_points=MAX_POINTS_TRAIN, cfg=cfg,
                              device=dev)),
             ("bev", dict(batch_size=PARALLEL_B["bev"], cfg=cfg,
                          device=dev))]
    runs, secs = {}, {}
    for label, world, device, backend in (
            ("no group", 0, dev, None),
            ("1 rank nccl", 1, dev, "nccl" if cuda else "gloo"),
            ("2 ranks gloo", 2, "cuda:0" if cuda else dev, "gloo")):
        t0 = time.perf_counter()
        runs[label] = D.spawn("cases", world, device=device, backend=backend,
                              timeout=600.0, deterministic=True, specs=specs)
        secs[label] = time.perf_counter() - t0
    solo = runs["no group"][0]
    ranks = [("1 rank nccl", r) for r in runs["1 rank nccl"]] + [
        (f"2 ranks gloo, rank {i}", r)
        for i, r in enumerate(runs["2 ranks gloo"])]
    res = {}
    for case, _ in specs:
        want = solo[case]
        one = runs["1 rank nccl"][0][case]
        exact = (one["metrics"] == want["metrics"] and all(
            torch.equal(g[n], w[n])
            for key in ("grads", "buffers")
            for g, w in zip(one[key], want[key]) for n in w) and all(
            torch.equal(one["params"][n], p)
            for n, p in want["params"].items()))
        two = [r[case] for r in runs["2 ranks gloo"]]
        w2 = [D.worst(r, want) for r in two]
        ranks_same = all(torch.equal(p, two[0]["params"][n])
                         for n, p in two[1]["params"].items())
        # each rank launches what one process launches on the whole batch
        launches = {label: r[case]["launches"] for label, r in ranks}
        log("parallel", f"{case} (B = {PARALLEL_B[case]}, f32): losses "
            f"{[m['loss'] for m in want['metrics']]}, grad_norm "
            f"{[m['grad_norm'] for m in want['metrics']]} without a group; "
            f"1 NCCL rank equal bit for bit {exact}; 2 gloo ranks worst "
            f"relative differences {w2} (limits {PARALLEL_RTOL}), their "
            f"params and buffers equal {ranks_same}; launches without a "
            f"group {want['launches']}, on the mesh {launches}")
        if not exact or not ranks_same or any(
                w[k] > PARALLEL_RTOL[k] for w in w2 for k in w):
            raise AssertionError(f"parallel {case}: the data-parallel steps "
                                 "differ from the one-process step")
        if (cuda and not want["launches"]) or any(
                v != want["launches"] for v in launches.values()):
            raise AssertionError(f"parallel {case}: the ranks' launches "
                                 f"{launches} differ from one process's "
                                 f"{want['launches']}")
        res[case] = dict(worst=w2, launches=launches)
    ctx["launches_parallel"] = {}
    for r in res.values():
        for counts in r["launches"].values():
            for k, v in counts.items():
                ctx["launches_parallel"][k] = \
                    ctx["launches_parallel"].get(k, 0) + v
    log("parallel", "seconds " + ", ".join(f"{k} {v:.1f}"
                                           for k, v in secs.items()))
    ctx["parallel"] = res


def _biased_heads(lidar_model):
    """Raise the center and box heads' output biases (in place) so that
    random weights give detections that pass the decode's score and size
    filters."""
    import torch

    with torch.no_grad():
        lidar_model.center_head.up.b += 2.0
        lidar_model.box_head.up.b += 3.0


def phase_diag(ctx):
    """The training diagnostics (train/diagnostics.py) at v2_config():
    make_lidar_probe on sample 0 of a distillation batch (16384 points)
    with the distillation models (heads biased so that detections pass
    the filters) and make_bev_probe on a BEV sample with the BEV planner,
    on the card against the same on the CPU: detections slot by slot
    (columns, rows, valid exact; scores, boxes at AGENT_ATOL), plans and
    casts at AGENT_ATOL / AGENT_RTOL; the probe's launches counted."""
    import copy

    import torch

    from lav_tpu_torch.config import v2_config
    from lav_tpu_torch.models.planner import BEVPlanner
    from lav_tpu_torch.train.diagnostics import (
        make_bev_probe, make_lidar_probe,
    )
    from lav_tpu_torch.train.distill import distill_models, make_batch
    from lav_tpu_torch.utils import native

    cfg = v2_config()
    models = distill_models(cfg, torch.Generator().manual_seed(0))
    _biased_heads(models.lidar_model)
    planner = BEVPlanner(cfg, torch.Generator().manual_seed(1))
    batch = make_batch(cfg, 1, MAX_POINTS_TRAIN, seed=2, device="cpu")
    args = (batch["lidar"][0], batch["lidar_valid"][0],
            torch.tensor(2, dtype=torch.int32), torch.tensor([1.5, -20.0]))
    bev = batch["bev"][0]
    out = {}
    for dev in ("cpu", ctx["device"]):
        m = copy.deepcopy(models).to(dev)
        p = copy.deepcopy(planner).to(dev)
        native.reset_launches()
        got = make_lidar_probe(cfg)(m, *(a.to(dev) for a in args))
        got_bev = make_bev_probe(cfg)(p, bev.to(dev), args[3].to(dev))
        torch.cuda.synchronize()
        out[dev] = (got, got_bev, {k: v for k, v in native.LAUNCHES.items()
                                   if v})
    (cpu, cpu_bev, _), (card, card_bev, launches) = out["cpu"], out[
        ctx["device"]]
    n_valid = int(cpu["dets"]["valid"].sum())
    worst = 0.0
    for f, want in cpu["dets"].items():
        got = card["dets"][f].cpu()
        if f in ("x", "y", "valid"):
            if not torch.equal(got, want):
                raise AssertionError(f"diag: detections' {f} differ")
        else:
            worst = max(worst, (got - want).abs().max().item())
    for k in ("pred_bev", "ego_plan_locs", "other_cast_locs"):
        torch.testing.assert_close(card[k].cpu(), cpu[k], atol=AGENT_ATOL,
                                   rtol=AGENT_RTOL)
    for k, want in cpu_bev.items():
        torch.testing.assert_close(card_bev[k].cpu(), want, atol=AGENT_ATOL,
                                   rtol=AGENT_RTOL)
    if worst > AGENT_ATOL or n_valid == 0:
        raise AssertionError(f"diag: detections differ by {worst} or none "
                             "is valid")
    ctx["launches_diag"] = launches
    log("diag", f"lidar probe: {n_valid} valid detections, card equal to "
        f"the CPU slot by slot (scores and boxes within {worst:.2e}); plans "
        f"and the BEV probe within atol {AGENT_ATOL} / rtol {AGENT_RTOL}; "
        f"launches {launches}")
    if not all(launches.get(k) for k in ("crop_shared", "scatter_max",
                                         "scatter_add")):
        raise AssertionError(f"diag: a kernel of the probes did not launch: "
                             f"{launches}")


def _tied_peaks(torch, dev, ctx):
    """A heatmap with more tied peaks than max_det (40 of exactly 0.9 a
    map, 2 classes, 16 egos at 320x320) decodes on the card to the CPU's
    detections slot by slot; and what its top-k (a stable sort) costs
    against torch.topk (ties in no fixed order) and a
    top-k over an int64 key (the value's order-preserving bits above the
    reversed index), per tick (two extract_peaks a tick, 16 and 4
    egos)."""
    from lav_tpu_torch.ops.peak import det_inference

    g = torch.Generator().manual_seed(9)
    E, H, W = NUM_EGO_PROD, 320, 320
    hm = torch.rand((E, 2, H, W), generator=g) * 0.05
    ys, xs = torch.meshgrid(torch.arange(4, H - 4, 8),
                            torch.arange(4, W - 4, 8), indexing="ij")
    ys, xs = ys.flatten(), xs.flatten()
    for e in range(E):
        for c in range(2):
            pick = torch.randperm(ys.numel(), generator=g)[:40]
            hm[e, c, ys[pick], xs[pick]] = 0.9
    size = torch.rand((E, 2, H, W), generator=g) * 4.0 + 2.0
    ori = torch.rand((E, 2, H, W), generator=g) * 2.0 - 1.0
    kw = dict(pixels_per_meter=4.0, max_det=15)
    want = det_inference(hm, size, ori, **kw)
    got = det_inference(hm.to(dev), size.to(dev), ori.to(dev), **kw)
    same = all(torch.equal(getattr(got, f).cpu(), getattr(want, f))
               for f in want._fields)
    if not same or not (want.score == 0.9).all():
        raise AssertionError("tied peaks: the card's detections differ "
                             "from the CPU's")
    cost = {}
    for egos in (NUM_EGO_PROD, NUM_EGO):
        x = hm[:egos, 0].reshape(egos, -1).to(dev)

        def key():
            n = x.shape[-1]
            bits = x.view(torch.int32).long()
            order = bits ^ ((bits >> 31) & 0x7FFFFFFF)
            low = torch.arange(n - 1, -1, -1, device=x.device)
            top = torch.topk(torch.add(low, order, alpha=1 << 32), 15).values
            idx = n - 1 - (top & 0xFFFFFFFF)
            return torch.gather(x, 1, idx), idx

        def sort():
            values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
            return values[:, :15], idx[:, :15]

        def topk():
            return torch.topk(x, 15, dim=-1)
        if not all(torch.equal(a, b) for a, b in zip(key(), sort())):
            raise AssertionError("tied peaks: the int64 key top-k differs "
                                 "from the stable sort's")
        c = {f"{k}_{name}": fn(torch, f)
             for name, f in (("key", key), ("sort", sort), ("topk", topk))
             for k, fn in (("ms", lambda t, f: cuda_ms(t, f, iters=50)),
                           ("device_ms", device_ms))}
        c["tick_device_ms"] = 2 * (c["device_ms_sort"]
                                   - c["device_ms_topk"])
        cost[egos] = c
    log("agent", f"tied peaks (40 a map at 0.9, max_det 15, {E} egos x 2 "
        f"classes): card equal to the CPU slot by slot; the int64 key "
        f"top-k vs the stable sort vs topk per extract_peaks call, "
        f"host-paced and device-only, and the tick's two calls' device-only difference, by egos: {cost} on "
        f"{ctx.get('smi', '?')}")
    ctx["peak_cost"] = cost


def _camera_conv_cases(torch, ctx):
    """quant="all" (lav_tpu's whole-tree scope) at 16 egos: every int8
    conv the camera nets run (ERFNet on 48 images of 288x256, the brake
    net's ResNet on the 288x768 wide and 192x480 telephoto images),
    captured from one forward of each with dynamic scales, each distinct
    call held against conv2d_int8_plain on its own inputs, exactly, and
    timed (host-paced and device-only).  Returns the shapes' rows."""
    from lav_tpu_torch.agent.agent import AgentModels
    from lav_tpu_torch.agent.setup import TEL_HW
    from lav_tpu_torch.config import v2_config
    from lav_tpu_torch.nn import quant as Q

    dev = torch.device(ctx["device"])
    cfg = v2_config()
    models = AgentModels(cfg, brake_version=2,
                         gen=torch.Generator().manual_seed(0))
    Q.quantize_tree(models.seg_model)
    Q.quantize_tree(models.bra_model)
    seg, bra = models.seg_model.to(dev).eval(), models.bra_model.to(
        dev).eval()
    seen = {}
    real = Q.conv2d_int8_nhwc

    def spy(*args, **kw):
        xq, w = args[0], args[1]
        key = (tuple(xq.shape), tuple(w.shape), tuple(args[5]),
               str(args[6]), tuple(args[7]), str(args[8]),
               tuple(kw.get("lhs_dilation", (1, 1))))
        if key not in seen:
            seen[key] = ([a.clone() if torch.is_tensor(a) else a
                          for a in args], dict(kw))
        else:
            seen[key][1]["count"] = seen[key][1].get("count", 1) + 1
        return real(*args, **kw)

    g = torch.Generator().manual_seed(3)
    rgb = (torch.rand((3 * NUM_EGO_PROD, 288, 256, 3), generator=g)
           * 255.0).to(dev, torch.bfloat16)
    wide = (torch.rand((NUM_EGO_PROD, 288, 768, 3), generator=g)
            * 255.0).to(dev, torch.bfloat16)
    tel = (torch.rand((NUM_EGO_PROD, *TEL_HW, 3), generator=g)
           * 255.0).to(dev, torch.bfloat16)
    Q.conv2d_int8_nhwc = spy
    try:
        with torch.no_grad():
            seg(rgb)
            bra(wide, tel)
    finally:
        Q.conv2d_int8_nhwc = real
    rows = []
    for key, (args, kw) in seen.items():
        count = kw.pop("count", 1)
        out = real(*args, **kw)
        ref = Q.conv2d_int8_plain(*args, **kw)
        torch.cuda.synchronize()
        if not torch.equal(out, ref):
            raise AssertionError(f"conv2d_int8 {key} disagrees with plain")
        ms = cuda_ms(torch, lambda: real(*args, **kw), iters=5)
        dms = device_ms(torch, lambda: real(*args, **kw), iters=5)
        rows.append(dict(x=key[0], w=key[1], stride=key[2], pad=key[3],
                         dilation=key[4], lhs=key[6], count=count, ms=ms,
                         device_ms=dms))
        del out, ref
    for r in rows:
        log("conv_int8", f"camera (quant='all'): x {r['x']} w {r['w']} "
            f"stride {r['stride']} pad {r['pad']} dilation {r['dilation']} "
            f"input dilation {r['lhs']} x{r['count']}: exact; "
            f"{r['ms']:.4f} ms host-paced, {r['device_ms']:.4f} ms "
            "device-only")
    log("conv_int8", f"camera convs of the all-stacks int8 scope: "
        f"{len(rows)} distinct calls, {sum(r['count'] for r in rows)} a "
        f"tick, all exact against conv2d_int8_plain; their device-only sum "
        f"{sum(r['count'] * r['device_ms'] for r in rows):.3f} ms a tick "
        f"on {ctx.get('smi', '?')}")
    del seg, bra, models, rgb, wide, tel, seen
    torch.cuda.empty_cache()
    return rows


TOOLS_RUNS = (
    ("point_budget", []),
    ("bench_skip", ["--iters", "2"]),
    ("bench_ablate", ["--iters", "2"]),
    ("bench_chain", ["--iters", "2"]),
    ("bench_profile", ["--quant", "mxu", "--trace"]),
    ("bench_train", ["--stage", "full", "--v2", "--batch-size", "4"]),
    ("bench_train", ["--stage", "bev", "--v2"]),
    ("bench_train", ["--stage", "seg", "--batch-size", "32"]),
    ("bench_train", ["--stage", "bra", "--v2", "--batch-size", "8"]),
)
TOOLS_TRAIN_STEPS = (1, 2)  # bench_train's warm-up and timed steps here
# each tool's keys, as lav_tpu's prints them for the same flags
TOOLS_KEYS = {
    "bench_ablate": {"seg_ms", "brake_ms", "paint_ms", "pillar_ms",
                     "lidar_model_ms", "det_decode_ms", "planner_ms",
                     "num_ego", "dtype"},
    "bench_chain": {f"thru_{k}_ms" for k in ("stack", "pillar", "lidar",
                                              "decode", "plan")},
    "bench_profile": {"num_ego", "gflops_per_tick", "gbytes_per_tick",
                      "gflops_per_ego_step", "temp_mb", "argument_mb",
                      "output_mb", "classes_ms"},
    "bench_train": {"stage", "v2", "batch_size", "dtype", "step_ms",
                    "samples_per_sec"},
}


def phase_tools(ctx):
    """lav_tpu's measurement tools, ported (`lav_tpu_torch/utils/`), each
    run in this process through its `main` at v2_config() full width with
    few iterations (TOOLS_RUNS; bench_train TOOLS_TRAIN_STEPS steps): their
    lines print above; each result must hold lav_tpu's keys with finite
    times, the skip ablation every variant, and the profiled tick's
    kernels, by name (`roofline.hand_class`), the port's crop, scatter
    and int8 conv kernels.  Then `roofline.roofline_summary` of the
    bench_chain's whole chain (16 egos, bf16): FLOPs of PyTorch's
    operators, the port's kernels by name with FLOPs null."""
    import importlib

    import torch

    from lav_tpu_torch.utils import bench_chain, bench_train, native, roofline

    dev = ctx["device"]
    native.reset_launches()
    saved = (bench_train.WARMUP, bench_train.ITERS)
    bench_train.WARMUP, bench_train.ITERS = TOOLS_TRAIN_STEPS
    out = {}
    try:
        for name, argv in TOOLS_RUNS:
            t0 = time.perf_counter()
            mod = importlib.import_module(f"lav_tpu_torch.utils.{name}")
            res = (mod.summary() if name == "point_budget" else
                   mod.main(argv + ["--device", dev]))
            log("tools", f"{name} {' '.join(argv)}: "
                f"{time.perf_counter() - t0:.1f} s")
            out.setdefault(name, []).append(res)
            keys = TOOLS_KEYS.get(name)
            times = [v for k, v in res.items() if k.endswith("_ms")
                     and isinstance(v, float)]
            if keys is not None and not keys <= set(res) or \
                    not all(math.isfinite(v) and v > 0 for v in times):
                raise AssertionError(f"tools: {name} {argv} printed {res}")
    finally:
        bench_train.WARMUP, bench_train.ITERS = saved
    skip = out["bench_skip"][0]
    if len(skip) != 7:
        raise AssertionError(f"tools: the skip ablation lacks a variant: "
                             f"{skip}")
    hand = out["bench_profile"][0]["hand_kernels"]
    if not {"hand_crop", "hand_scatter", "hand_conv_int8"} <= {
            roofline.hand_class(name) for name in hand}:
        raise AssertionError(f"tools: the profiled tick lacks a kernel of "
                             f"the port: {sorted(hand)}")

    cfg = bench_chain.v2_config()
    models = bench_chain.chain_models(cfg).to(dev)
    inp = bench_chain.chain_inputs(cfg, bench_chain.NUM_EGO,
                                   bench_chain.SWEEP_POINTS, dev)
    with torch.no_grad():
        summary = roofline.roofline_summary(bench_chain.stage_plan,
                                            (models, cfg, inp), iters=2)
    print(json.dumps({"roofline_summary": summary}), flush=True)
    hand = summary["hand_kernels"]
    if summary["flops"] <= 0 or not hand or any(
            h["flops"] is not None for h in hand.values()):
        raise AssertionError(f"tools: roofline_summary {summary}")
    ctx["launches_tools"] = dict(native.LAUNCHES)
    log("tools", f"launches {ctx['launches_tools']} on {ctx.get('smi', '?')}")
    del models, inp
    torch.cuda.empty_cache()


def kernels_line(ctx):
    """Every kernel with its numbers; `launches` counts the main path that
    runs it: the f32 agent for crop_shared and pillar_scatter_max, the
    production tick for crop_shared_q8, scatter_max, scatter_add and
    conv2d_int8, the variants tick for crop_shared_q8_s2d and
    pillar_scatter_max_bf16, the gather probe for take_along_rows, the
    distillation step (3 steps) for crop_shared_bwd and
    pillar_scatter_max_bwd, the bf16 step (3 steps) for their bf16 forms,
    the bf16 eval-mode gradient of phase train (two runs on the card) for
    scatter_max_bwd, timed on the production tick's canvas with the f32
    agent's canvas as `f32_agent_*`; crop_shared's row adds
    `bev_launches`, the BEV trainer's (3 steps), with its `bev_*` times
    from phase crop, and `step_*` / `step_bf16_*`, its four calls a
    distillation step timed in phase train_kernels with the f32 / bf16
    step's launches (3 steps).  Every row adds `cli_launches` (phase
    cli's training run) and `eval_launches` (phase eval's ground-truth
    ticks, evaluate.main's three runs and the adapter's core), and the
    later paths' counts: `export_launches` (the loaded programs' first 3
    ticks, f32 and serving), `parallel_launches` (the data-parallel
    phase's steps without a process group), `diag_launches` (the two
    probes on the card), `all_launches` (the quant="all" tick, 3
    ticks) and `tools_launches` (phase tools: the measurement tools'
    runs)."""
    crop, scatter = ctx.get("crop", {}), ctx.get("scatter", {})
    train = ctx.get("train_kernels", {})
    bwd = ctx.get("scatter_bwd", {})
    zero_bwd = next((dict(v) for k, v in bwd.items()
                     if k.startswith("production") and "f32" not in k), None)
    if zero_bwd is not None:
        zero_bwd.update({f"f32_agent_{k}": v for k, v in
                         bwd["f32 agent's canvas"].items()})
    specs = (
        ("crop_shared", crop.get("float32"), "agent", "crop_shared.cu",
         "lav_tpu/core/warp_pallas.py:108"),
        ("crop_shared_q8", crop.get("q8"), "production", "crop_shared.cu",
         "lav_tpu/core/warp_pallas.py:164"),
        ("crop_shared_q8_s2d", crop.get("q8_s2d"), "variants",
         "crop_shared.cu", "lav_tpu/core/warp_pallas.py:171"),
        ("pillar_scatter_max", ctx.get("pillar"), "agent",
         "pillar_scatter_max.cu", "lav_tpu/ops/pillar_pallas.py:36"),
        ("pillar_scatter_max_bf16", ctx.get("pillar_bf16"), "variants",
         "pillar_scatter_max.cu", "lav_tpu/ops/pillar_pallas.py:36"),
        ("scatter_max", scatter.get("max"), "production",
         "pillar_scatter_max.cu", "lav_tpu/ops/pillar_pallas2.py:84"),
        ("scatter_add", scatter.get("add"), "production", "pillar_scatter.cu",
         "lav_tpu/ops/pillar_pallas2.py:84"),
        ("conv2d_int8", ctx.get("conv_int8"), "production", "conv2d_int8.cu",
         "lav_tpu/nn/quant.py:246"),
        ("take_along_rows", ctx.get("gather"), "gather",
         "take_along_rows.cu", "scripts/exp_gather.py:28"),
        ("crop_shared_bwd", train.get("crop_shared_bwd"), "train",
         "crop_shared_bwd.cu", "lav_tpu/core/warp.py:213"),
        ("crop_shared_bwd_bf16", train.get("crop_shared_bwd_bf16"),
         "train_bf16", "crop_shared_bwd.cu", "lav_tpu/core/warp.py:213"),
        ("pillar_scatter_max_bwd", train.get("pillar_scatter_max_bwd"),
         "train", "pillar_scatter_max.cu", "lav_tpu/ops/pillar.py:519"),
        ("pillar_scatter_max_bwd_bf16",
         train.get("pillar_scatter_max_bwd_bf16"), "train_bf16",
         "pillar_scatter_max.cu", "lav_tpu/ops/pillar.py:519"),
        ("scatter_max_bwd", zero_bwd, "eval", "pillar_scatter_max.cu",
         "lav_tpu/ops/pillar.py:483"),
    )
    rows = []
    for name, r, path, source, replaces in specs:
        if r is None:
            continue
        rows.append(dict(name=name, route="cuda",
                         source=f"lav_tpu_torch/csrc/{source}",
                         replaces=replaces,
                         launches=ctx.get(f"launches_{path}", {}).get(name, 0),
                         **r))
        if name == "crop_shared":
            rows[-1]["bev_launches"] = ctx.get(
                "launches_privileged", {}).get(name, 0)
            rows[-1]["grid_sample_launches"] = ctx.get(
                "launches_grid_sample", {}).get(name, 0)
            for key, path in (("step", "train"), ("step_bf16", "train_bf16")):
                rows[-1].update({f"{key}_{k}": v for k, v in train.get(
                    f"crop_shared_{key}", {}).items()})
                rows[-1][f"{key}_launches"] = ctx.get(
                    f"launches_{path}", {}).get(name, 0)
        if "launches_cli" in ctx:
            rows[-1]["cli_launches"] = ctx["launches_cli"].get(name, 0)
        if "launches_evaluator" in ctx:
            rows[-1]["eval_launches"] = ctx["launches_evaluator"].get(name,
                                                                      0)
        for path in ("export", "parallel", "diag", "all", "tools"):
            if f"launches_{path}" in ctx:
                rows[-1][f"{path}_launches"] = ctx[f"launches_{path}"].get(
                    name, 0)
    return {"kernels": rows}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(ALL_PHASES),
                    help="comma-separated subset of "
                    + ",".join(ALL_PHASES + EXTRA_PHASES))
    ap.add_argument("--config", default="both",
                    choices=("f32", "production", "variants", "both", "all"),
                    help="the agent configuration(s) the profile phase "
                    "runs: one, both (f32 and production) or all three")
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
    t_start = time.perf_counter()
    for name in ALL_PHASES + EXTRA_PHASES:
        if name in phases or name == "build":
            t0 = time.perf_counter()
            globals()[f"phase_{name}"](ctx)
            log(name, f"ok in {time.perf_counter() - t0:.1f} s")
    print(f"chip_smoke: every phase passed in "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps(kernels_line(ctx)), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
