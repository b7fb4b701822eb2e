"""The agent's realistic LiDAR point budget, derived from the sensor spec
(a copy of `lav_tpu/utils/point_budget.py`, which imports no JAX; pure
numpy, no device, no measured number).

    python -m lav_tpu_torch.utils.point_budget

The sensor is the CARLA leaderboard's `sensor.lidar.ray_cast` (600,000
rays/s, 10 Hz rotation, 64 channels, vertical FOV +10..-30 deg, range
85 m).  At the 20 Hz sim tick that is 30,000 rays a tick (a half
rotation); the agent fuses the current and previous tick into one full
360-degree sweep of at most 60,000 rays (LAV's `lav_agent.py:229-231`).
Rays that hit nothing inside 85 m return no point, so 60,000 is the hard
cap a fused sweep.  The pillar featurizer keeps points inside the BEV box
x in [-10, 70], y in [-40, 40] m (LAV's `config.yaml:27-30`) after
ego-hull removal.

`flat_world_sweep` ray-casts every (channel, azimuth) cell of a fused
sweep against a bare ground plane from the mounted height (z = 2.4 m,
`config_v2.yaml:23`) and counts the returns inside the BEV box: an
empty-scene estimate.  Structure in a real scene turns misses above the
horizon into returns, bounded by the all-rays count, so the table
brackets reality:

    flat-world in-box  <=  realistic sweep  <=  in-box geometric cap

v2 stacks num_frame_stack + 1 = 3 fused sweeps (`config_v2.yaml:38`),
capped at max_lidar_points = 120,000 (`config_v2.yaml:36`); bench.py's
operating points refer to these numbers.
"""

from __future__ import annotations

import json
import math

import numpy as np

# leaderboard-1.0 pinned lidar attributes (external spec; the reference
# repo's leaderboard/ submodule is the authority but is not vendored)
POINTS_PER_SECOND = 600_000
ROTATION_HZ = 10
CHANNELS = 64
UPPER_FOV_DEG = 10.0
LOWER_FOV_DEG = -30.0
RANGE_M = 85.0
TICK_HZ = 20

SENSOR_Z = 2.4          # config_v2.yaml:23 (lidar mounted with the cameras)
BEV_X = (-10.0, 70.0)   # config.yaml:27-30 (x forward)
BEV_Y = (-40.0, 40.0)
N_STACK = 3             # num_frame_stack + 1 (config_v2.yaml:38)
V2_CAP = 120_000        # max_lidar_points (config_v2.yaml:36)

# CARLA 0.9.10 ray_cast lidar default general dropoff rate: the sensor
# randomly discards this fraction of returns (the 0.9.10 "LiDAR revamp"
# added intensity + dropoff; the leaderboard pins only the geometry
# attributes, so the dropoff default applies).  ASSUMPTION documented
# here because the leaderboard submodule is not vendored to confirm.
DROPOFF_GENERAL_RATE = 0.45


def rays_per_fused_sweep() -> int:
    return POINTS_PER_SECOND // ROTATION_HZ  # one full rotation


def flat_world_sweep(ground_z: float = 0.0) -> dict:
    """Ray-cast one fused sweep against a bare ground plane; count
    returns and in-BEV-box returns."""
    n_az = rays_per_fused_sweep() // CHANNELS
    az = np.linspace(0.0, 2 * math.pi, n_az, endpoint=False)
    pitch = np.deg2rad(np.linspace(UPPER_FOV_DEG, LOWER_FOV_DEG, CHANNELS))
    h = SENSOR_Z - ground_z

    # ground intersection distance r (horizontal) for down-pointing rays
    tan_p = np.tan(pitch)                      # (C,)
    with np.errstate(divide="ignore"):
        r_ground = np.where(tan_p < 0, h / -tan_p, np.inf)
    slant = np.sqrt(r_ground ** 2 + h ** 2)
    hits = slant <= RANGE_M                    # (C,) channel has a return

    r = r_ground[hits][:, None]                # (Ch, 1)
    x = r * np.cos(az)[None, :]
    y = r * np.sin(az)[None, :]
    in_box = ((x >= BEV_X[0]) & (x < BEV_X[1])
              & (y >= BEV_Y[0]) & (y < BEV_Y[1]))
    n_return = int(hits.sum()) * n_az
    n_in_box = int(in_box.sum())

    # geometric cap: every ray returns (dense urban canyon) at a range
    # that lands in the box if its azimuth points into the box at <=85 m;
    # integrate the box/disc azimuth coverage at a nominal wall distance
    # sweep: use the fraction of (channel, azimuth) cells whose ray WOULD
    # cross the box footprint at any range <= 85 m
    r_line = np.linspace(0.5, RANGE_M, 256)
    xx = r_line[None, :] * np.cos(az)[:, None]
    yy = r_line[None, :] * np.sin(az)[:, None]
    az_crosses = (((xx >= BEV_X[0]) & (xx < BEV_X[1])
                   & (yy >= BEV_Y[0]) & (yy < BEV_Y[1])).any(axis=1))
    cap_in_box = int(az_crosses.sum()) * CHANNELS

    return {
        "rays_per_fused_sweep": rays_per_fused_sweep(),
        "flat_world_returns": n_return,
        "flat_world_in_bev_box": n_in_box,
        "geometric_in_box_cap": cap_in_box,
    }


def summary() -> dict:
    s = flat_world_sweep()
    lo = s["flat_world_in_bev_box"]
    cap = s["geometric_in_box_cap"]
    keep = 1.0 - DROPOFF_GENERAL_RATE
    expected = int(lo * keep)
    return {
        **s,
        # flat-world in-box returns after the sensor's default dropoff:
        # the central estimate for a typical sweep (structure raises it,
        # occlusion+dropoff-at-range lower it; bracketed by the bounds)
        "expected_in_box_after_dropoff": expected,
        "stacked_flat_world": N_STACK * lo,
        "stacked_expected": N_STACK * expected,
        "stacked_geometric_cap": min(N_STACK * cap, V2_CAP),
        "v2_config_cap": V2_CAP,
        # bench MAX_POINTS is raw per HALF rotation: stacked = 6x
        "bench_default_stacked": 60_000,   # 10,000 x2 fused x3 stacked
        "bench_max_stacked": V2_CAP,
    }


def main():
    s = summary()
    print(json.dumps(s, indent=2))
    print(
        f"\nper fused sweep: flat-world in-box {s['flat_world_in_bev_box']:,}"
        f" <= realistic <= in-box cap {s['geometric_in_box_cap']:,}"
        f" (of {s['rays_per_fused_sweep']:,} rays)"
        f"\nstacked (x{N_STACK}): {s['stacked_flat_world']:,} .. "
        f"{s['stacked_geometric_cap']:,} (config cap {s['v2_config_cap']:,})"
        f"\nbench operating points: {s['bench_default_stacked']:,} default, "
        f"{s['bench_max_stacked']:,} max"
    )


if __name__ == "__main__":
    main()
