"""The general traffic generator: observation pools for the agent tick and
batch pools for the distillation step, drawn on the device from the seed.

The recipes are frozen copies of the port's synthetic inputs
(`agent/setup.py::make_obs`, `train/distill.py::make_batch`), drawn with a
`torch.Generator` on the device instead of numpy on the host; a traffic
file (`traffic/<name>.json`) sets the sizes.  The agent's scalar inputs
(speed, compass, command, target) are drawn per ego, so that every
command's planner branch and the lane-change path are taken.

The agent's lidar is drawn from the sensor's geometry, as
`utils/point_budget.py` models it, with the parameters of the traffic's
`lidar` block: each point is a ray of one of `channels` channels spaced
evenly over the vertical field of view, at a uniform azimuth, from a
sensor `sensor_z` m above a flat ground.  A `structure_share` of the rays
(and every ray that would miss the ground within `range_m`) returns from
a vertical surface at a horizontal distance uniform in `structure_m`,
clipped to the range; the rest return from the ground, `ground_sigma_m`
of height noise on it.  So the points are dense near the ego and thin out
with range, and z stays in the band the sensor sees.  Intensity is
CARLA's exp(-`attenuation` x distance).  Coordinates are the lidar's
frame: x forward, y left, z up from the sensor.
"""

from __future__ import annotations

import numpy as np
import torch

TEL_HW = (192, 480)
NUM_CMDS = 6


def sweep(gen, shape, lidar: dict, device):
    """Points (*shape, 4) of a ray-cast sweep (the module's note)."""
    def u(lo, hi):
        return torch.rand(shape, generator=gen, device=device) * (hi - lo) + lo

    lo, hi = lidar["fov_deg"]
    channel = torch.randint(0, lidar["channels"], shape, generator=gen,
                            device=device)
    pitch = torch.deg2rad(lo + (hi - lo) * channel /
                          (lidar["channels"] - 1))
    az = u(-np.pi, np.pi)
    h, reach = lidar["sensor_z"], lidar["range_m"]
    tan_p = torch.tan(pitch)
    ground = torch.where(tan_p < 0, h / -tan_p.clamp(max=-1e-6),
                         torch.full_like(tan_p, np.inf))
    ground_hit = (ground * torch.sqrt(1 + tan_p * tan_p) <= reach) & (
        u(0.0, 1.0) >= lidar["structure_share"])
    s_lo, s_hi = lidar["structure_m"]
    d_wall = u(s_lo, s_hi)
    # a wall is hit before the ground, inside the range
    d_wall = torch.minimum(torch.minimum(d_wall, ground),
                           reach * torch.cos(pitch))
    d = torch.where(ground_hit, ground, d_wall)
    z = torch.where(ground_hit,
                    -h + lidar["ground_sigma_m"] * torch.randn(
                        shape, generator=gen, device=device),
                    d * tan_p)
    dist = torch.sqrt(d * d + z * z)
    return torch.stack([d * torch.cos(az), d * torch.sin(az), z,
                        torch.exp(-lidar["attenuation"] * dist)], dim=-1)


def obs_set(gen, num_ego: int, points: int, img_hw, lidar: dict, device):
    """One tick of observations for `num_ego` egos (`build_agent`'s obs)."""
    E = num_ego

    def u(shape, lo, hi):
        return torch.rand(shape, generator=gen, device=device) * (hi - lo) + lo

    return dict(
        lidar=sweep(gen, (E, points), lidar, device),
        lidar_valid=torch.ones((E, points), dtype=torch.bool, device=device),
        rgbs=u((E, 3, *img_hw, 3), 0.0, 255.0),
        tel_rgb=u((E, *TEL_HW, 3), 0.0, 255.0),
        gps=torch.tensor([1e-4, 2e-4], device=device).repeat(E, 1),
        compass=u((E,), -np.pi, np.pi),
        speed=u((E,), 0.0, 8.0),
        cmd=torch.randint(0, NUM_CMDS, (E,), generator=gen, device=device,
                          dtype=torch.int32),
        target=u((E, 2), -30.0, 30.0),
    )


def obs_pool(traffic: dict, seed: int, device):
    """traffic["pool"] distinct observation sets, cycled by the window."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return [obs_set(gen, traffic["num_ego"], traffic["points_per_sweep"],
                    tuple(traffic["img_hw"]), traffic["lidar"], device)
            for _ in range(traffic["pool"])]


def make_obs_np(num_ego: int, max_points: int, img_hw, seed: int, device):
    """The port's `make_obs` recipe as it is (numpy on the host): ego e
    from default_rng(seed + e).  Both sides calibrate on these."""
    lidar, rgbs, tel = [], [], []
    for e in range(num_ego):
        rng = np.random.default_rng(seed + e)
        lidar.append(rng.uniform(-20, 40, size=(max_points, 4)))
        rgbs.append(rng.uniform(0, 255, size=(3, *img_hw, 3)))
        tel.append(rng.uniform(0, 255, size=(*TEL_HW, 3)))

    def t(x, dtype=torch.float32):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    E = num_ego
    return dict(
        lidar=t(np.stack(lidar).astype(np.float32)),
        lidar_valid=torch.ones((E, max_points), dtype=torch.bool,
                               device=device),
        rgbs=t(np.stack(rgbs).astype(np.float32)),
        tel_rgb=t(np.stack(tel).astype(np.float32)),
        gps=t(np.tile(np.float32([1e-4, 2e-4]), (E, 1))),
        compass=t(np.full((E,), 0.1, np.float32)),
        speed=t(np.full((E,), 4.0, np.float32)),
        cmd=t(np.full((E,), 3), torch.int32),
        target=t(np.tile(np.float32([10.0, 1.0]), (E, 1))),
    )


def batch(gen, cfg, batch_size: int, max_points: int, device):
    """One distillation batch, `make_batch`'s recipe drawn on the device."""
    bs, T, N, C = (batch_size, cfg.num_plan, cfg.max_objs,
                   cfg.bev_input_channels)
    H, W = cfg.ny, cfg.nx

    def u(shape, lo, hi):
        return torch.rand(shape, generator=gen, device=device) * (hi - lo) + lo

    def n(shape):
        return torch.randn(shape, generator=gen, device=device)

    return dict(
        lidar=u((bs, max_points, cfg.num_input - 5), -10.0, 40.0),
        heatmaps=u((bs, 2, H, W), 0.0, 1.0),
        sizemaps=u((bs, 2, H, W), 0.0, 8.0),
        orimaps=u((bs, 2, H, W), -1.0, 1.0),
        bev=(u((bs, H, W, C), 0.0, 1.0) > 0.5).float(),
        ego_locs=n((bs, T + 1, 2)),
        locs=n((bs, N, T + 1, 2)),
        lidar_valid=torch.ones((bs, max_points), dtype=torch.bool,
                               device=device),
        cmds=torch.zeros((bs,), dtype=torch.int32, device=device),
        nxps=torch.zeros((bs, 2), device=device),
        bras=torch.zeros((bs,), dtype=torch.int32, device=device),
        oris=torch.zeros((bs, N), device=device),
        typs=torch.ones((bs, N), dtype=torch.int32, device=device))


def batch_pool(traffic: dict, cfg, seed: int, device):
    gen = torch.Generator(device=device).manual_seed(seed)
    return [batch(gen, cfg, traffic["batch_size"], traffic["points"], device)
            for _ in range(traffic["pool"])]


def noise(gen, cfg, batch_size: int, device):
    """The uniform draws of one student forward (`draw_noise`'s shapes),
    from the CPU generator `gen`."""
    B, N, K = batch_size, cfg.max_objs - 1, cfg.max_num_cars_student
    shapes = dict(scores=(B, N), loc_o=(B, K, 2), ori_o=(B, K),
                  loc_e=(B, 2), ori_e=(B,))
    return {k: torch.rand(v, generator=gen).to(device)
            for k, v in shapes.items()}
