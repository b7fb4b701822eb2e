"""Per-stage timing of the agent's nets and ops, each alone, batched over
the egos (counterpart of `lav_tpu/utils/bench_ablate.py`): camera seg,
brake net, point painting, the pillar featurizer, the whole lidar model
(pillars, backbone and heads), detection decode and planner inference
(crops, crop ResNet and GRUs).

    python -m lav_tpu_torch.utils.bench_ablate [--num-ego 16]
        [--max-points 8192] [--dtype bf16] [--device cpu]

Runs on the card unless `--device cpu` is given: v2_config() at full
width, seeded weights, lav_tpu's inputs drawn from numpy default_rng(0)
in its order; each stage 2 warm-up calls, then 10 on the host clock
ending in a synchronize.  Prints the card, then one line {"seg_ms",
"brake_ms", "paint_ms", "pillar_ms", "lidar_model_ms", "det_decode_ms",
"planner_ms", "num_ego", "dtype"}.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from lav_tpu_torch.agent.agent import AgentModels
from lav_tpu_torch.config import v2_config
from lav_tpu_torch.models.planner import uniplanner_infer
from lav_tpu_torch.ops.painting import CameraRig, point_painting
from lav_tpu_torch.ops.peak import det_inference
from lav_tpu_torch.utils.device import resolve_device
from lav_tpu_torch.utils.profiling import card_line, timeit

IMG_HW = (288, 256)      # a camera image; the brake net's wide image is 3
TEL_HW = (192, 480)      # side by side, and its telephoto image this


@torch.no_grad()
def run(num_ego: int = 16, max_points: int = 8192, dtype: str = "bf16",
        device=None, iters: int = 10) -> dict:
    dev = resolve_device(device)
    cdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    cfg = v2_config()
    B = num_ego
    rng = np.random.default_rng(0)
    models = AgentModels(cfg, brake_version=2,
                         gen=torch.Generator().manual_seed(0)).to(dev).eval()
    lidar = models.lidar_model

    def t(x, dt=torch.float32):
        return torch.from_numpy(np.asarray(x)).to(dev, dt)

    def time(fn, *args):
        return timeit(fn, *args, iters=iters, warmup=2)

    H, W = IMG_HW
    results = {}
    # camera segmentation: B * 3 images
    rgbs = t(rng.uniform(0, 255, (B * 3, H, W, 3)).astype(np.float32), cdt)
    results["seg_ms"] = time(models.seg_model, rgbs)

    # brake net: the three cameras side by side, and the telephoto
    wide = t(rng.uniform(0, 255, (B, H, 3 * W, 3)).astype(np.float32), cdt)
    tel = t(rng.uniform(0, 255, (B, *TEL_HW, 3)).astype(np.float32), cdt)
    results["brake_ms"] = time(models.bra_model, wide, tel)

    # painting
    P = max_points * 2 * 3
    pts3 = t(rng.uniform(-30, 30, (B, P, 3)).astype(np.float32))
    rigs = tuple(CameraRig.build(y, rgb_h=H, rgb_w=W, fov=64)
                 for y in (-60, 0, 60))
    sems = t(rng.uniform(0, 1, (B, 3, H, W, 4)).astype(np.float32))
    results["paint_ms"] = time(point_painting, pts3, sems, rigs)

    # pillars only, then the whole lidar model
    D = cfg.num_input - 5
    pts = t(rng.uniform(-20, 50, (B, P, D)).astype(np.float32), cdt)
    valid = torch.ones((B, P), dtype=torch.bool, device=dev)
    results["pillar_ms"] = time(lidar.point_pillar, pts, valid)
    results["lidar_model_ms"] = time(lambda x, v: lidar(x, v)[1], pts, valid)

    # detection decode
    shape = (B, 2, cfg.ny, cfg.nx)
    hm = t(rng.uniform(0, 1, shape).astype(np.float32))
    sz = t(rng.uniform(0, 8, shape).astype(np.float32))
    om = t(rng.uniform(-1, 1, shape).astype(np.float32))
    results["det_decode_ms"] = time(
        lambda h, s, o: det_inference(
            h, s, o, pixels_per_meter=cfg.pixels_per_meter,
            max_det=cfg.max_det, min_score=cfg.det_min_score), hm, sz, om)

    # planner inference (crops, crop ResNet, GRUs)
    feats = t(rng.normal(0, 1, (B, cfg.ny // 2, cfg.nx // 2,
                                cfg.num_features[-1] * 6)
                         ).astype(np.float32), cdt)
    K = cfg.max_det
    ar = torch.arange(K, dtype=torch.int32, device=dev)[None].repeat(B, 1)
    ones = torch.ones((B, K), device=dev)
    det = dict(x=ar * 10, y=ar * 8, w=ones, h=ones, cos=ones,
               sin=torch.zeros_like(ones),
               valid=torch.ones((B, K), dtype=torch.bool, device=dev))
    cmd = torch.full((B,), 3, dtype=torch.int32, device=dev)
    nxp = torch.zeros((B, 2), device=dev)
    results["planner_ms"] = time(
        lambda f, d: uniplanner_infer(models.uniplanner, cfg, f, d, cmd,
                                      nxp)[0], feats, det)

    results = {k: round(v, 2) for k, v in results.items()}
    results["num_ego"] = B
    results["dtype"] = dtype
    return results


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--num-ego", type=int, default=16)
    p.add_argument("--max-points", type=int, default=8192)
    p.add_argument("--dtype", default="bf16", choices=["f32", "bf16"])
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    print(f"device: {card_line(dev)}", flush=True)
    results = run(args.num_ego, args.max_points, args.dtype, dev, args.iters)
    print(json.dumps(results), flush=True)
    return results


if __name__ == "__main__":
    main()
