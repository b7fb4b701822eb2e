"""Measurements on the card, each run once to answer a question rather
than on every smoke run.

    python3 -m lav_tpu_torch.utils.probes memory
    python3 -m lav_tpu_torch.utils.probes determinism
    python3 -m lav_tpu_torch.utils.probes repeat [--config f32|production]
    python3 -m lav_tpu_torch.utils.probes ticks --parent DIR [--turns N]

Run on a machine with a card, from the root of a checkout.  Each prints
the card's name and power limit first; TF32 is off, as in
`chip_smoke.py`, so f32 means f32.

memory: where the f32 step's memory goes at lav_tpu's default batch
(`lav_tpu/train/cli.py:239`, B = 32, 16384 points), without and with
`remat` (the scoped student-crop checkpoint runs in both).  After 4
steps, timed (host clock to a synchronize), one forward and backward of
the step's loss with the memory read at its boundaries: after the point
pillar's forward, after the rest of the lidar forward, after the planner
forward and the losses, after the planner's backward (where the lidar
recompute starts, under remat) and after the whole backward, each with
the peak since the previous mark.  Then the planner segment alone (its
forward on the lidar features, its losses and its backward), with and
without its checkpoint.  Sizes are in GiB above what the models, Adam's
moments and the batch hold.

determinism: step 1 of the f32 and the bf16 step at B = 2, twice each,
under torch.use_deterministic_algorithms(True, warn_only=True),
cudnn.deterministic and CUBLAS_WORKSPACE_CONFIG=:4096:8: the gradient
leaves that still differ between the two runs and the operations
PyTorch warns it runs without a deterministic form; then the same with
the decoration sums taken on the host (`scatter_add_plain`), which kernel
scatter_add, summing each pillar in point order, equals bit for bit.

repeat: whether the agent tick repeats itself bit for bit.  The f32
tick (4 egos, 8192 points a sweep, use_pallas=True) and the production
tick (16 egos, 10000 points, bf16, int8 "mxu") run twice for
REPEAT_TICKS ticks from the same state, with no deterministic flag set
by the caller; the output leaves (controls, state, aux) that differ
between the two runs are listed with the first tick they differ at.

ticks: the p50 tick and ego-ticks/s of the f32 tick (4 egos) and the
production tick (16 egos) of this tree and of another checkout DIR (for
instance the parent commit unpacked with `git archive`), each in a
process of its own started in its tree, in turns (DIR, this, this, DIR,
`--turns` times): TICKS ticks a configuration, the first two left out;
each process also reports whether it found PyTorch's deterministic
algorithms or cuDNN's deterministic flag set after its ticks.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import statistics
import subprocess
import sys
import time
import warnings

import torch

from lav_tpu_torch.utils.profiling import card_line

MAX_POINTS = 16384       # lav_tpu/utils/bench_train.py --max-points
B_REF = 32               # lav_tpu/train/cli.py:239, the full stage's batch
GIB = 2 ** 30


def memory() -> None:
    for remat in (False, True):
        step_ms, held0, marks = _memory_split(remat)
        torch.cuda.empty_cache()
        print(f"memory B={B_REF} f32, remat={remat}, the scoped "
              f"checkpoint on; step ms {[round(t, 3) for t in step_ms]}"
              f" (median of steps 2-4 {statistics.median(step_ms[1:]):.3f}); "
              f"models, Adam's moments and the batch "
              f"{held0 / GIB:.3f}: " + "; ".join(
                  f"{label}: held {held / GIB:.3f}, peak {peak / GIB:.3f}"
                  for label, held, peak in marks), flush=True)


def _memory_split(remat: bool):
    """(ms of 4 steps, bytes held before the forward, [(label, bytes
    held at the mark, peak bytes since the previous mark), ...]): see the
    module note."""
    from lav_tpu_torch.models.planner import draw_noise, uniplanner_forward
    from lav_tpu_torch.train.distill import (
        distill_setup, make_distill_forward, make_distill_loss_fn,
    )
    from lav_tpu_torch.utils.tree import checkpoint

    step, models, opt, batch, gen, cfg = distill_setup(
        B_REF, MAX_POINTS, device="cuda", seed=0, remat=remat)
    step_ms = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(models, opt, batch, gen)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    opt.zero_grad(set_to_none=True)
    torch.cuda.synchronize()
    base = held0 = torch.cuda.memory_allocated()
    marks = []

    def mark(label):
        torch.cuda.synchronize()
        marks.append((label, torch.cuda.memory_allocated() - base,
                      torch.cuda.max_memory_allocated() - base))
        torch.cuda.reset_peak_memory_stats()

    lidar, core = models["lidar_model"], models["uniplanner"]
    # the lidar recompute starts when the planner's backward ends; it stops
    # once it has what the backward needs, before the lidar model's
    # forward hooks would run
    hooks = (lidar.point_pillar.register_forward_hook(
                 lambda *_: None if marks else mark("point pillar forward")),
             lidar.register_forward_hook(
                 lambda *_: None if len(marks) > 1
                 else mark("backbone and heads forward")),
             lidar.register_forward_pre_hook(
                 lambda *_: mark("planner backward") if marks else None))
    B, N = batch["typs"].shape
    noise = draw_noise(gen, B, N - 1, cfg.max_num_cars_student,
                       device=batch["typs"].device)
    forward = make_distill_forward(cfg, v2=True, mode="full", remat=remat)
    torch.cuda.reset_peak_memory_stats()
    loss, _ = forward(models, batch, noise)
    mark("planner forward and losses")
    loss.backward()
    mark("lidar backward" if remat else "backward")
    for h in hooks:
        h.remove()
    opt.zero_grad(set_to_none=True)
    del loss

    # the planner segment alone, on the lidar model's outputs
    with torch.no_grad():
        feats, *preds = lidar(batch["lidar"], batch["lidar_valid"])[:5]
    feats.requires_grad_(True)
    planner = functools.partial(uniplanner_forward, core, cfg)
    args = (feats, batch["bev"], batch["ego_locs"], batch["locs"],
            batch["oris"], batch["nxps"], batch["typs"], noise)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = (checkpoint(planner, *args, module=core) if remat
           else planner(*args))
    loss, _ = make_distill_loss_fn(cfg, v2=True, mode="full")(
        tuple(p.float() for p in preds), out, batch)
    mark("planner alone: forward and losses")
    loss.backward()
    mark("planner alone: backward")
    return step_ms, held0, marks


def _step1(dtype, B: int = 2):
    """Step 1 of the distillation step at full width on the card: the
    metrics and every gradient leaf (on the CPU)."""
    from lav_tpu_torch.config import v2_config
    from lav_tpu_torch.models.planner import draw_noise
    from lav_tpu_torch.train.distill import (
        adam, distill_models, make_batch, make_full_train_step,
    )

    cfg = v2_config()
    noise = draw_noise(torch.Generator().manual_seed(1), B,
                       cfg.max_objs - 1, cfg.max_num_cars_student, "cuda")
    models = distill_models(cfg, torch.Generator().manual_seed(0)).cuda()
    batch = make_batch(cfg, B, MAX_POINTS, seed=0, device="cuda")
    step = make_full_train_step(cfg, v2=True, compute_dtype=dtype)
    m = step(models, adam(models), batch, noise=noise)
    grads = {n: p.grad.cpu() for n, p in models.named_parameters()
             if p.grad is not None}
    return {k: float(v) for k, v in m.items()}, grads


def determinism() -> None:
    from lav_tpu_torch.ops import pillar

    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    print("determinism: deterministic algorithms (warn_only), "
          "cudnn.deterministic, CUBLAS_WORKSPACE_CONFIG="
          f"{os.environ.get('CUBLAS_WORKSPACE_CONFIG')}", flush=True)
    real = pillar.scatter_add

    def host_sum(feat, pid, num_segments):
        return pillar.scatter_add_plain(feat.cpu(), pid.cpu(),
                                        num_segments).to(feat.device)

    for sums, fn in (("scatter_add on the card", real),
                     ("decoration sums on the host", host_sum)):
        pillar.scatter_add = fn
        try:
            for label, dtype in (("f32", None), ("bf16", torch.bfloat16)):
                with warnings.catch_warnings(record=True) as caught:
                    warnings.simplefilter("always")
                    (m1, g1), (m2, g2) = (_step1(dtype) for _ in range(2))
                ops = sorted({str(w.message).split(" does not have")[0]
                              for w in caught
                              if "deterministic" in str(w.message)})
                differ = {n: float((g1[n] - g2[n]).norm() / g1[n].norm())
                          for n in g1 if not torch.equal(g1[n], g2[n])}
                worst = sorted(differ.items(), key=lambda kv: -kv[1])[:6]
                print(f"determinism: {label}, {sums}: loss equal "
                      f"{m1['loss'] == m2['loss']}, grad_norm "
                      f"{m1['grad_norm']!r} / {m2['grad_norm']!r}; "
                      f"{len(differ)} of {len(g1)} leaves differ run to "
                      f"run, worst (L2 rel) "
                      f"{[(n, f'{v:.2e}') for n, v in worst]}; ops "
                      f"without a deterministic form: {ops}", flush=True)
        finally:
            pillar.scatter_add = real


REPEAT_TICKS = 12


def _tick_setup(config: str):
    from lav_tpu_torch.agent.setup import v2_agent_setup

    kw = (dict(num_ego=4, max_points=8192, use_pallas=True)
          if config == "f32" else
          dict(num_ego=16, max_points=10000, quant="mxu",
               compute_dtype=torch.bfloat16))
    step, models, state, obs, _ = v2_agent_setup(device="cuda", seed=0, **kw)
    return step, models, state, obs


def _named_leaves(tree):
    from torch.utils import _pytree

    pairs, _ = _pytree.tree_flatten_with_path(tree)
    return [(_pytree.keystr(p), x) for p, x in pairs]


def _ticks(step, models, state, obs):
    outs, ms = [], []
    for _ in range(REPEAT_TICKS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ctrl, state, aux = step(models, state, obs)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        outs.append(_named_leaves((ctrl, state, aux)))
    return outs, ms


def _equal(x, y) -> bool:
    if x.is_floating_point():
        return (torch.equal(torch.isnan(x), torch.isnan(y))
                and torch.equal(torch.nan_to_num(x), torch.nan_to_num(y)))
    return torch.equal(x, y)


def _differing(a, b) -> dict:
    """{leaf: [first tick it differs at, max |difference|]}."""
    out = {}
    for t, (ta, tb) in enumerate(zip(a, b)):
        for (name, x), (_, y) in zip(ta, tb):
            if not _equal(x, y):
                d = (x.double() - y.double()).abs().nan_to_num().max()
                row = out.setdefault(name, [t + 1, 0.0])
                row[1] = max(row[1], float(d))
    return out


def repeat(config: str) -> None:
    step, models, state, obs = _tick_setup(config)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        a, ms_a = _ticks(step, models, state, obs)
        b, ms_b = _ticks(step, models, state, obs)
    ops = sorted({str(w.message)[:120] for w in caught
                  if "deterministic" in str(w.message)})
    bad = _differing(a, b)
    first = min((v[0] for v in bad.values()), default=None)
    worst = max((v[1] for v in bad.values()), default=0.0)
    print(f"repeat: {config}, {REPEAT_TICKS} ticks twice from one state, "
          f"no flag: {len(bad)} of {len(a[0])} leaves differ (first at "
          f"tick {first}: "
          f"{sorted(k for k, v in bad.items() if v[0] == first)}), max "
          f"|diff| {worst:.3e}; p50 tick "
          f"{statistics.median(ms_a[1:]):.3f} / "
          f"{statistics.median(ms_b[1:]):.3f} ms; warnings {ops}",
          flush=True)
    del a, b
    torch.cuda.empty_cache()


TICKS = 64
_TICKS_CHILD = r"""
import json, statistics, time
import torch
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
from lav_tpu_torch.agent.setup import v2_agent_setup
out = {}
for name, kw in (("f32", dict(num_ego=4, max_points=8192, use_pallas=True)),
                 ("production", dict(num_ego=16, max_points=10000,
                                     quant="mxu",
                                     compute_dtype=torch.bfloat16))):
    step, models, state, obs, _ = v2_agent_setup(device="cuda", seed=0, **kw)
    ms = []
    for _ in range(%d):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, state, _ = step(models, state, obs)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    p50 = statistics.median(ms[2:])
    out[name] = dict(p50_ms=p50, ego_ticks_per_s=kw["num_ego"] * 1e3 / p50,
                     flags_after=[torch.are_deterministic_algorithms_enabled(),
                                  torch.backends.cudnn.deterministic])
    del step, models, state, obs
    torch.cuda.empty_cache()
print(json.dumps(out))
"""


def ticks(parent: str, turns: int = 1) -> None:
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    trees = [("parent", os.path.abspath(parent)), ("this tree", here)]
    order = (trees + trees[::-1]) * turns
    rows = {}
    for label, tree in order:
        env = dict(os.environ, PYTHONPATH=tree)
        run = subprocess.run([sys.executable, "-c", _TICKS_CHILD % TICKS],
                             cwd=tree, env=env, capture_output=True,
                             text=True, timeout=600)
        if run.returncode:
            raise RuntimeError(f"{label} ({tree}) failed:\n{run.stderr}")
        res = json.loads(run.stdout.strip().splitlines()[-1])
        print(f"ticks: {label}: " + "; ".join(
            f"{k} p50 {v['p50_ms']:.3f} ms, {v['ego_ticks_per_s']:.2f} "
            f"ego-ticks/s, flags after {v['flags_after']}"
            for k, v in res.items()), flush=True)
        for k, v in res.items():
            rows.setdefault((label, k), []).append(v["p50_ms"])
    for (label, k), v in rows.items():
        print(f"ticks: {k}, {label}: p50 {[round(x, 3) for x in v]} ms",
              flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("probe", choices=("memory", "determinism", "repeat",
                                      "ticks"))
    ap.add_argument("--parent", default=None,
                    help="the other checkout the ticks probe times")
    ap.add_argument("--turns", type=int, default=1,
                    help="rounds of (parent, this, this, parent)")
    ap.add_argument("--config", default="both",
                    choices=("f32", "production", "both"),
                    help="the tick(s) the repeat probe runs")
    args = ap.parse_args(argv)
    if args.probe == "determinism":   # read when cuBLAS starts
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    if not torch.cuda.is_available():
        print("probes: no card", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(card_line("cuda"), flush=True)
    if args.probe == "memory":
        memory()
    elif args.probe == "determinism":
        determinism()
    elif args.probe == "ticks":
        ticks(args.parent, args.turns)
    else:
        for config in (("f32", "production") if args.config == "both"
                       else (args.config,)):
            repeat(config)
    return 0


if __name__ == "__main__":
    sys.exit(main())
