"""Skip ablation of the whole agent tick: the tick timed with one stage
replaced by its dummy at a time (`build_agent(skip=...)`), so each stage's
cost is read in the tick, with what it does to the stages around it
(counterpart of `lav_tpu/utils/bench_skip.py`).

    python -m lav_tpu_torch.utils.bench_skip [--num-ego 16]
        [--max-points 8192] [--variants none,seg,...] [--device cpu]

Runs on the card unless `--device cpu` is given.  v2_config() at full
width in bf16, seeded weights, every ego seeing lav_tpu's one observation;
2 warm-up ticks, then `iters` ticks on the host clock ending in a
synchronize.  Prints the card, one line {"skip_<v>_ms"} a variant, then
{"full_ms", "attributed_ms"}: the full tick less each skipped one.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from lav_tpu_torch.agent.agent import AgentModels, build_agent
from lav_tpu_torch.config import v2_config
from lav_tpu_torch.utils.device import resolve_device
from lav_tpu_torch.utils.profiling import card_line, timeit

VARIANTS = "none,seg,paint,brake,lidar,planner,stack"
IMG_HW = (288, 256)      # the three cameras' images
TEL_HW = (192, 480)      # the telephoto image


def tick_obs(num_ego: int, max_points: int, device) -> dict:
    """lav_tpu's bench observation (numpy default_rng(0)), the same for
    every ego."""
    rng = np.random.default_rng(0)
    one = dict(
        lidar=rng.uniform(-20, 40, (max_points, 4)).astype(np.float32),
        lidar_valid=np.ones((max_points,), bool),
        rgbs=rng.uniform(0, 255, (3, *IMG_HW, 3)).astype(np.float32),
        tel_rgb=rng.uniform(0, 255, (*TEL_HW, 3)).astype(np.float32),
        gps=np.float32([1e-4, 2e-4]), compass=np.float32(0.1),
        speed=np.float32(4.0), cmd=np.int32(3),
        target=np.float32([10.0, 1.0]))
    return {k: torch.from_numpy(np.stack([v] * num_ego)).to(device)
            for k, v in one.items()}


def run_variant(skip, num_ego, max_points, iters=8, device=None) -> float:
    """ms a tick of the bf16 agent with the stages `skip` dummied out."""
    dev = resolve_device(device)
    cfg = v2_config()
    init_state, step = build_agent(cfg, num_ego=num_ego,
                                   max_points=max_points, rgb_hw=IMG_HW,
                                   compute_dtype=torch.bfloat16, skip=skip,
                                   device=dev)
    models = AgentModels(cfg, brake_version=2,
                         gen=torch.Generator().manual_seed(0)).to(dev).eval()
    obs = tick_obs(num_ego, max_points, dev)
    state = [init_state()]

    def tick():
        _, state[0], _ = step(models, state[0], obs)

    return timeit(tick, iters=iters, warmup=2)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--num-ego", type=int, default=16)
    p.add_argument("--max-points", type=int, default=8192)
    p.add_argument("--variants", default=VARIANTS)
    p.add_argument("--iters", type=int, default=8)
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    print(f"device: {card_line(dev)}", flush=True)

    results = {}
    for v in args.variants.split(","):
        skip = () if v == "none" else tuple(v.split("+"))
        ms = run_variant(skip, args.num_ego, args.max_points, args.iters,
                         dev)
        results[f"skip_{v}_ms"] = round(ms, 1)
        print(json.dumps({f"skip_{v}_ms": round(ms, 1)}), flush=True)
    base = results.get("skip_none_ms")
    if base:
        attrib = {
            k.replace("skip_", "").replace("_ms", ""): round(base - v, 1)
            for k, v in results.items() if k != "skip_none_ms"
        }
        print(json.dumps({"full_ms": base, "attributed_ms": attrib}))
    return results


if __name__ == "__main__":
    main()
