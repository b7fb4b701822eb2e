"""Set up the v2 agent at full width with random weights from a seed
(the port's counterpart of lav_tpu's `_v2_agent_setup`, needing no JAX).

Weights come from the port's own initialisers on a seeded
`torch.Generator` (built on the CPU, then moved).  Observations are drawn
with numpy, ego e from `default_rng(seed + e)`, in the same order and
ranges as lav_tpu's setup, so ego 0 of seed 0 sees lav_tpu's observation.
"""

from __future__ import annotations

import numpy as np
import torch

from lav_tpu_torch.agent.agent import AgentModels, build_agent
from lav_tpu_torch.config import v2_config
from lav_tpu_torch.utils.device import resolve_device

TEL_HW = (192, 480)


def make_obs(num_ego: int, max_points: int, img_hw=(288, 256), seed: int = 0,
             device=None):
    """One tick of synthetic observations for `num_ego` egos."""
    dev = resolve_device(device)
    lidar, rgbs, tel = [], [], []
    for e in range(num_ego):
        rng = np.random.default_rng(seed + e)
        lidar.append(rng.uniform(-20, 40, size=(max_points, 4)))
        rgbs.append(rng.uniform(0, 255, size=(3, *img_hw, 3)))
        tel.append(rng.uniform(0, 255, size=(*TEL_HW, 3)))

    def t(x, dtype=torch.float32):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)

    E = num_ego
    return dict(
        lidar=t(np.stack(lidar).astype(np.float32)),
        lidar_valid=torch.ones((E, max_points), dtype=torch.bool, device=dev),
        rgbs=t(np.stack(rgbs).astype(np.float32)),
        tel_rgb=t(np.stack(tel).astype(np.float32)),
        gps=t(np.tile(np.float32([1e-4, 2e-4]), (E, 1))),
        compass=t(np.full((E,), 0.1, np.float32)),
        speed=t(np.full((E,), 4.0, np.float32)),
        cmd=t(np.full((E,), 3), torch.int32),
        target=t(np.tile(np.float32([10.0, 1.0]), (E, 1))),
    )


def v2_agent_setup(max_points: int = 8192, num_ego: int = 1,
                   img_hw=(288, 256), device=None, seed: int = 0):
    """Returns (step, models, state, obs, cfg) for the full-width v2 agent
    (3 cameras at img_hw, the 192x480 telephoto image) on `device`
    (default `cuda`; raises without a card unless `device='cpu'`)."""
    dev = resolve_device(device)
    cfg = v2_config()
    init_state, step = build_agent(cfg, num_ego=num_ego,
                                   max_points=max_points, rgb_hw=img_hw,
                                   device=dev)
    gen = torch.Generator().manual_seed(seed)
    models = AgentModels(cfg, brake_version=2, gen=gen).to(dev).eval()
    obs = make_obs(num_ego, max_points, img_hw, seed, dev)
    return step, models, init_state(), obs, cfg
