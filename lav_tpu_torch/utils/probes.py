"""Two measurements of the distillation step on the card, each run once
to answer a question rather than on every smoke run.

    python3 -m lav_tpu_torch.utils.probes memory
    python3 -m lav_tpu_torch.utils.probes determinism

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
"""

from __future__ import annotations

import argparse
import functools
import os
import statistics
import subprocess
import sys
import time
import warnings

import torch

MAX_POINTS = 16384       # lav_tpu/utils/bench_train.py --max-points
B_REF = 32               # lav_tpu/train/cli.py:239, the full stage's batch
GIB = 2 ** 30


def _card() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return smi.stdout.strip().splitlines()[0] if smi.stdout else "?"


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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("probe", choices=("memory", "determinism"))
    args = ap.parse_args(argv)
    if args.probe == "determinism":   # read when cuBLAS starts
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    if not torch.cuda.is_available():
        print("probes: no card", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(_card(), flush=True)
    if args.probe == "memory":
        memory()
    else:
        determinism()
    return 0


if __name__ == "__main__":
    sys.exit(main())
