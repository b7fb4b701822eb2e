"""Training throughput: the train steps at (scaled) reference batch sizes
(counterpart of `lav_tpu/utils/bench_train.py`).

    python -m lav_tpu_torch.utils.bench_train --stage bev --batch-size 64
    python -m lav_tpu_torch.utils.bench_train --stage full --batch-size 8 \\
        --v2 [--dtype bfloat16] [--remat] [--device cpu]

Runs on the card unless `--device cpu` is given.  The steps and their
random batches are `train/privileged.py`'s `bev_setup`, `seg_setup` and
`bra_setup` and `train/distill.py`'s `distill_setup` (v2_config() with
`--v2`, else v1_config(); seg and brake on v1_config(), as lav_tpu's),
seeded weights, Adam(3e-4); 2 warm-up steps, then 8 on the host clock
ending in a synchronize.  Prints the card, then {"stage", "v2",
"batch_size", "dtype", "step_ms", "samples_per_sec"}.
"""

from __future__ import annotations

import argparse
import json

import torch

from lav_tpu_torch.config import v1_config, v2_config
from lav_tpu_torch.train.distill import distill_setup
from lav_tpu_torch.train.privileged import bev_setup, bra_setup, seg_setup
from lav_tpu_torch.utils.device import resolve_device
from lav_tpu_torch.utils.profiling import card_line, timeit

ITERS, WARMUP = 8, 2


def timeit_steps(step) -> float:
    """Seconds a step of `step()` over ITERS steps, after WARMUP."""
    return timeit(step, iters=ITERS, warmup=WARMUP) / 1000


def bench_bev(bs: int, v2: bool, device=None) -> float:
    step, models, opt, batch, gen, _ = bev_setup(
        bs, device, cfg=v2_config() if v2 else v1_config(), v2=v2)
    return timeit_steps(lambda: step(models, opt, batch, gen))


def bench_full(bs: int, v2: bool, max_points: int, dtype="float32",
               remat: bool = False, device=None) -> float:
    step, models, opt, batch, gen, _ = distill_setup(
        bs, max_points, device, cfg=v2_config() if v2 else v1_config(),
        v2=v2, compute_dtype=getattr(torch, dtype), remat=remat)
    return timeit_steps(lambda: step(models, opt, batch, gen))


def bench_seg(bs: int, device=None) -> float:
    """ERFNet seg stage at the reference batch regime."""
    step, models, opt, batch, gen, _ = seg_setup(bs, device,
                                                 cfg=v1_config())
    return timeit_steps(lambda: step(models, opt, batch, gen))


def bench_bra(bs: int, version: int = 2, device=None) -> float:
    """Brake-prediction stage (wide 3-camera image + telephoto)."""
    step, models, opt, batch, _ = bra_setup(bs, device, cfg=v1_config(),
                                            version=version)
    return timeit_steps(lambda: step(models, opt, batch))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--stage", choices=["bev", "seg", "bra", "full"],
                   default="bev")
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--v2", action="store_true")
    p.add_argument("--max-points", type=int, default=16384)
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--remat", action="store_true")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    print(f"device: {card_line(dev)}", flush=True)

    if args.stage == "bev":
        sec = bench_bev(args.batch_size, args.v2, dev)
    elif args.stage == "seg":
        sec = bench_seg(args.batch_size, dev)
    elif args.stage == "bra":
        sec = bench_bra(args.batch_size, 2 if args.v2 else 1, dev)
    else:
        sec = bench_full(args.batch_size, args.v2, args.max_points,
                         args.dtype, args.remat, dev)
    results = {
        "stage": args.stage, "v2": args.v2, "batch_size": args.batch_size,
        "dtype": args.dtype,
        "step_ms": round(sec * 1000, 1),
        "samples_per_sec": round(args.batch_size / sec, 1),
    }
    print(json.dumps(results), flush=True)
    return results


if __name__ == "__main__":
    main()
