"""Closed-loop demo: run the agent on a replayed synthetic episode and
report control statistics and per-tick latency (counterpart of
`lav_tpu/agent/demo.py`).

    python -m lav_tpu_torch.agent.demo --ticks 20 --v2
    python -m lav_tpu_torch.agent.demo --ticks 5 --tiny --device cpu
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from lav_tpu_torch.agent.agent import AgentModels, build_agent
from lav_tpu_torch.agent.env import ReplayEnv, obs_to_tensors
from lav_tpu_torch.config import tiny_config, v1_config, v2_config
from lav_tpu_torch.data.store import make_synthetic_episode
from lav_tpu_torch.utils.device import resolve_device
from lav_tpu_torch.utils.profiling import StepTimer
from lav_tpu_torch.utils.visualization import visualize_agent_tick


@torch.no_grad()
def apply_eval_priors(models: AgentModels) -> AgentModels:
    """lav_tpu's two priors that make an untrained agent scoreable in the
    replay evaluation (a trained checkpoint needs neither), in place:
      * a calm brake head (classifier w * 0.1, b - 3, so p ~ 0.05): an
        untrained classifier hard-brakes on about half the ticks;
      * a forward plan (bias component 1 of every `cast_mlps` and
        `plan_mlp` set to -0.5; ahead is -y in the plan frame): an
        untrained GRU plans to stand still, so the PID brakes every tick.
    """
    cls = models.bra_model.classifier
    cls.w.mul_(0.1)
    cls.b.sub_(3.0)
    for name, mod in models.uniplanner.named_modules():
        if name.rsplit(".", 1)[-1] in ("cast_mlps", "plan_mlp"):
            mod.b[..., 1] = -0.5
    return models


def build_params(cfg, seed: int = 0, eval_priors: bool = False,
                 device=None) -> AgentModels:
    """Random demo / evaluation weights from the port's initialisers on a
    generator seeded with `seed`, on `device` (default `cuda`; raises
    without a card unless `device='cpu'`); the brake net is version 2 for
    a temporal-stack config, else 1.  eval_priors: `apply_eval_priors`."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    models = AgentModels(
        cfg, brake_version=2 if cfg.num_frame_stack > 0 else 1, gen=gen)
    if eval_priors:
        apply_eval_priors(models)
    return models.to(dev).eval()


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--ticks", type=int, default=20)
    p.add_argument("--v2", action="store_true")
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--max-points", type=int, default=2048)
    p.add_argument("--viz", default=None,
                   help="directory to write per-tick BEV canvases (PNG)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = (tiny_config() if args.tiny
           else v2_config() if args.v2 else v1_config())
    img_hw = (32, 32) if args.tiny else (288, 256)

    ep = make_synthetic_episode(
        n_frames=max(args.ticks + cfg.num_plan + 1, 16),
        n_lidar=args.max_points, img_hw=img_hw,
        bev_hw=(cfg.ny, cfg.nx),
    )
    env = ReplayEnv(ep, cfg, max_points=args.max_points)

    init_state, step = build_agent(cfg, max_points=args.max_points,
                                   rgb_hw=img_hw, device=dev)
    models = build_params(cfg, device=dev)
    state = init_state()

    timer = StepTimer(warmup=2)
    controls = []
    for t, frame in enumerate(env.frames()):
        if t >= args.ticks:
            break
        obs = obs_to_tensors([frame], dev)
        timer.start()
        ctrl, state, aux = step(models, state, obs)
        dt = timer.stop(ctrl)
        controls.append([float(ctrl.steer[0]), float(ctrl.throttle[0]),
                         float(ctrl.brake[0])])
        print(f"tick {t:3d}: steer={controls[-1][0]:+.3f} "
              f"throttle={controls[-1][1]:.3f} brake={controls[-1][2]:.0f} "
              f"({dt * 1000:.1f} ms)")
        if args.viz:
            from PIL import Image

            os.makedirs(args.viz, exist_ok=True)
            canvas = visualize_agent_tick(
                frame["lidar"][:, :2],
                aux["plan_locs"][0].cpu().numpy(),
                aux["other_cast_locs"][0].cpu().numpy(),
                aux["other_cast_cmds"][0].cpu().numpy(),
                aux["other_valid"][0].cpu().numpy(),
                aux["nxp"][0].cpu().numpy(),
                pixels_per_meter=cfg.pixels_per_meter,
                cmd_thresh=cfg.cmd_thresh,
                min_x=int(cfg.min_x), max_x=int(cfg.max_x),
                min_y=int(cfg.min_y), max_y=int(cfg.max_y),
            )
            Image.fromarray(canvas).save(
                os.path.join(args.viz, f"tick_{t:04d}.png"))

    c = np.asarray(controls)
    if not np.isfinite(c).all():
        raise RuntimeError("non-finite control emitted")
    latency = timer.stats()
    print("latency:", {k: round(v, 4) for k, v in latency.items()})
    return dict(controls=c, latency=latency)


if __name__ == "__main__":
    main()
