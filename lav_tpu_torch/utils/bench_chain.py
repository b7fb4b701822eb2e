"""Cumulative timing of the perception -> planning chain with its real data
flow: stack -> pillar -> lidar (backbone and heads) -> decode -> plan,
each prefix timed whole; the differences attribute each stage's cost in
context (counterpart of `lav_tpu/utils/bench_chain.py`).

    python -m lav_tpu_torch.utils.bench_chain [--device cpu]

Runs on the card unless `--device cpu` is given: v2_config() at full
width, B = 16 egos, ring buffers of 2 x 8192 points a sweep, bf16, seeded
weights, lav_tpu's buffers drawn from numpy default_rng(0); each prefix
one warm-up call, then 8 on the host clock ending in a synchronize.
Prints the card, one line {"thru_<stage>_ms"} a prefix, then all five.
The stages are module functions, `STAGES` in order, each taking
(models, cfg, inputs, compute_dtype) and running the stages before it.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch
from torch import nn

from lav_tpu_torch.agent.agent import GAP
from lav_tpu_torch.config import v2_config
from lav_tpu_torch.core.geometry import move_lidar_points
from lav_tpu_torch.models.lidar import LidarModel
from lav_tpu_torch.models.planner import UniPlanner, uniplanner_infer
from lav_tpu_torch.ops.peak import det_inference
from lav_tpu_torch.utils.device import resolve_device
from lav_tpu_torch.utils.profiling import card_line, timeit

NUM_EGO = 16
SWEEP_POINTS = 2 * 8192    # a fused sweep: the current and previous one


def chain_models(cfg, seed: int = 0) -> nn.ModuleDict:
    """{'lidar_model', 'uniplanner'} from the port's initialisers, eval."""
    gen = torch.Generator().manual_seed(seed)
    return nn.ModuleDict(dict(
        lidar_model=LidarModel(cfg.num_input, cfg.num_features,
                               min_x=cfg.min_x, max_x=cfg.max_x,
                               min_y=cfg.min_y, max_y=cfg.max_y,
                               pixels_per_meter=cfg.pixels_per_meter,
                               gen=gen),
        uniplanner=UniPlanner(cfg, gen=gen))).eval()


def chain_inputs(cfg, batch: int = NUM_EGO, points: int = SWEEP_POINTS,
                 device=None) -> dict:
    """lav_tpu's ring buffers (default_rng(0)): buf (B, F, Pb, 4 + n_sem),
    val (B, F, Pb), locs (B, F, 2), oris (B, F); cmd (B,) = 3, nxp zeros."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    num_keep = (cfg.num_frame_stack + 1) * GAP
    Df = 4 + len(cfg.seg_channels)
    B = batch

    def t(x):
        return torch.from_numpy(np.asarray(x, np.float32)).to(dev)

    return dict(
        buf=t(rng.uniform(-20, 40, (B, num_keep, points, Df))),
        val=torch.ones((B, num_keep, points), dtype=torch.bool, device=dev),
        locs=t(rng.normal(0, 5, (B, num_keep, 2))),
        oris=t(rng.normal(0, 1, (B, num_keep))),
        cmd=torch.full((B,), 3, dtype=torch.int32, device=dev),
        nxp=torch.zeros((B, 2), device=dev))


def stage_stack(models, cfg, inp, cdt=torch.bfloat16):
    """The temporal stack: the last sweep of every GAP re-registered into
    the newest sweep's frame, with one-hot age channels."""
    buf, val, locs, oris = inp["buf"], inp["val"], inp["locs"], inp["oris"]
    B, num_keep, Pb, _ = buf.shape
    num_stack = cfg.num_frame_stack + 1
    loc0, ori0 = locs[:, -1], oris[:, -1]
    sweeps, valids = [], []
    for i in range(num_stack):
        idx = num_keep - 1 - i * GAP
        sweep = buf[:, idx]
        xyz = move_lidar_points(sweep[..., :3], locs[:, idx] - loc0, ori0,
                                oris[:, idx])
        age = torch.zeros((B, Pb, num_stack), device=buf.device)
        age[..., i] = 1.0
        sweeps.append(torch.cat([xyz, sweep[..., 3:], age], -1))
        valids.append(val[:, idx])
    return torch.cat(sweeps, 1), torch.cat(valids, 1)


def stage_pillar(models, cfg, inp, cdt=torch.bfloat16):
    stacked, svalid = stage_stack(models, cfg, inp, cdt)
    return models.lidar_model.point_pillar(stacked.to(cdt), svalid)


def stage_lidar(models, cfg, inp, cdt=torch.bfloat16):
    stacked, svalid = stage_stack(models, cfg, inp, cdt)
    return models.lidar_model(stacked.to(cdt), svalid)[:5]


def stage_decode(models, cfg, inp, cdt=torch.bfloat16):
    feats, hm, size, ori, _ = stage_lidar(models, cfg, inp, cdt)
    H, W = cfg.ny, cfg.nx
    ego_px = (W / 2.0, H / 2.0 + cfg.y_offset * H / 2.0)
    dets = det_inference(torch.sigmoid(hm.float()), size.float(),
                         ori.float(), pixels_per_meter=cfg.pixels_per_meter,
                         max_det=cfg.max_det, min_score=cfg.det_min_score,
                         ego_xy=ego_px)
    return feats, dets


def stage_plan(models, cfg, inp, cdt=torch.bfloat16):
    feats, dets = stage_decode(models, cfg, inp, cdt)
    veh = {k: v[:, 1] for k, v in dets._asdict().items()}
    return uniplanner_infer(models.uniplanner, cfg, feats, veh, inp["cmd"],
                            inp["nxp"])[0]


STAGES = (("stack", stage_stack), ("pillar", stage_pillar),
          ("lidar", stage_lidar), ("decode", stage_decode),
          ("plan", stage_plan))


@torch.no_grad()
def run(device=None, iters: int = 8) -> dict:
    dev = resolve_device(device)
    cfg = v2_config()
    models = chain_models(cfg).to(dev)
    inp = chain_inputs(cfg, NUM_EGO, SWEEP_POINTS, dev)
    results = {}
    for name, fn in STAGES:
        ms = timeit(fn, models, cfg, inp, iters=iters, warmup=1)
        results[f"thru_{name}_ms"] = round(ms, 1)
        print(json.dumps({f"thru_{name}_ms": results[f"thru_{name}_ms"]}),
              flush=True)
    return results


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--iters", type=int, default=8)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    print(f"device: {card_line(dev)}", flush=True)
    results = run(dev, args.iters)
    print(json.dumps(results), flush=True)
    return results


if __name__ == "__main__":
    main()
