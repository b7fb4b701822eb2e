"""Set up the v2 agent at full width with random weights from a seed
(the port's counterpart of lav_tpu's `_v2_agent_setup`, needing no JAX).

Weights come from the port's own initialisers on a seeded
`torch.Generator` (built on the CPU, then moved).  Observations are drawn
with numpy, ego e from `default_rng(seed + e)`, in the same order and
ranges as lav_tpu's setup, so ego 0 of seed 0 sees lav_tpu's observation.

quant="mxu" is bench.py's production configuration: the lidar model and
the planner's crop ResNet are quantized (`nn/quant.py`), then calibrated
as lav_tpu calibrates them, eagerly in f32 observer mode, here over two
ticks of a one-ego agent on seeded observations, on the target device.
quant="all" is lav_tpu's whole-tree scope (`BENCH_INT8=1` with any other
`quant_int8` than "mxu", `__graft_entry__.py:64-77`): every stack of the
agent, the camera ERFNet and the brake net's ResNet too, by the same
rules (`quantize_tree`: convs of at least 16 input channels outside the
float subtrees), calibrated the same way.  A setup that fails raises; the
port has no fallback to float.
lav_tpu's committed scales (`artifacts/calib/`) belong to JAX-initialised
weights; `utils/weights.py::load_calibration` applies them to converted
lav_tpu params.

bench.py's three variant routes are arguments here; the port reads no
environment variable: `use_pallas` (`BENCH_PALLAS=1`), `s2d_crops`
(`LAV_S2D_CROPS=1`) and `int8_upconv` (`LAV_INT8_UPCONV=1`, which
quantizes the lidar backbone's three transposed convs too).
"""

from __future__ import annotations

import numpy as np
import torch

from lav_tpu_torch.agent.agent import AgentModels, build_agent
from lav_tpu_torch.config import v2_config
from lav_tpu_torch.nn import quant as Q
from lav_tpu_torch.utils.device import resolve_device

TEL_HW = (192, 480)
CALIB_SEED = 42
CALIB_TICKS = 2


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


def calibrate_agent(models, cfg, max_points: int, img_hw, device):
    """Static activation scales for every int8 conv of `models`: CALIB_TICKS
    ticks of a one-ego f32 agent (production pillar route) in observer
    mode; the planner's crops stay float there, so its conv1 observes
    them."""
    init_state, step = build_agent(cfg, max_points=max_points,
                                   rgb_hw=img_hw, device=device)

    def run():
        state = init_state()
        for t in range(CALIB_TICKS):
            obs = make_obs(1, max_points, img_hw, CALIB_SEED + t, device)
            _, state, _ = step(models, state, obs)

    Q.calibrate(run)
    return models


def v2_agent_setup(max_points: int = 8192, num_ego: int = 1,
                   img_hw=(288, 256), device=None, seed: int = 0,
                   quant=None, compute_dtype=None, use_pallas: bool = False,
                   s2d_crops: bool = False, int8_upconv: bool = False):
    """Returns (step, models, state, obs, cfg) for the full-width v2 agent
    (3 cameras at img_hw, the 192x480 telephoto image) on `device`
    (default `cuda`; raises without a card unless `device='cpu'`).
    quant None, "mxu" or "all"; compute_dtype None (f32) or torch.bfloat16;
    use_pallas picks the pillar route (ops/pillar.py, `BENCH_PALLAS=1`);
    s2d_crops the planner's space-to-depth int8 crops (`LAV_S2D_CROPS=1`);
    int8_upconv, under "mxu" or "all", the int8 upconvs
    (`LAV_INT8_UPCONV=1`)."""
    if quant not in (None, "mxu", "all"):
        raise ValueError(f"quant={quant!r}: None, 'mxu' or 'all'")
    if int8_upconv and quant is None:
        raise ValueError("int8_upconv needs quant='mxu' or 'all'")
    dev = resolve_device(device)
    cfg = v2_config()
    init_state, step = build_agent(cfg, num_ego=num_ego,
                                   max_points=max_points, rgb_hw=img_hw,
                                   compute_dtype=compute_dtype,
                                   use_pallas=use_pallas,
                                   s2d_crops=s2d_crops, device=dev)
    gen = torch.Generator().manual_seed(seed)
    models = AgentModels(cfg, brake_version=2, gen=gen)
    include = r"^upconv\d$" if int8_upconv else None
    if quant == "mxu":
        Q.quantize_tree(models.lidar_model, include=include)
        Q.quantize_tree(models.uniplanner)
    elif quant == "all":
        Q.quantize_tree(models, include=include)
    models = models.to(dev).eval()
    if quant:
        calibrate_agent(models, cfg, max_points, img_hw, dev)
    obs = make_obs(num_ego, max_points, img_hw, seed, dev)
    return step, models, init_state(), obs, cfg
