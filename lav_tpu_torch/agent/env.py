"""Replay environment: closed-loop agent evaluation without a simulator
(a copy of `lav_tpu/agent/env.py`, numpy over the port's `Episode`).

LAV's only integration test is a live CARLA leaderboard run.  This
environment replays recorded episodes (the LAV LMDB schema or synthetic
ones) as the sensor source, so the whole agent loop runs and is measured
without a simulator; the CARLA adapter (`agent/carla_adapter.py`) is the
live path where a simulator is present.
"""

from __future__ import annotations

import math
from typing import Dict, Iterator

import numpy as np
import torch

from lav_tpu_torch.config import LAVConfig
from lav_tpu_torch.data.store import Episode


EARTH_RADIUS = 6371e3


def obs_to_tensors(frames, device) -> Dict[str, torch.Tensor]:
    """Per-ego observation dicts of numpy values (as `ReplayEnv.frames`
    yields them) -> the agent's tensors on `device`, stacked on a leading
    ego axis; float64 becomes float32 and int64 int32, the dtypes
    `jnp.asarray` gives lav_tpu's step."""
    out = {}
    for k in frames[0]:
        a = np.stack([np.asarray(f[k]) for f in frames])
        if a.dtype == np.float64:
            a = a.astype(np.float32)
        elif a.dtype == np.int64:
            a = a.astype(np.int32)
        out[k] = torch.from_numpy(a).to(device)
    return out


class ReplayEnv:
    """Iterates an episode's frames as agent observations.

    Since recorded episodes don't store raw GPS, ego world locations are
    converted to synthetic lat/lon around the origin (inverse of the
    waypointer's equirectangular projection with cos0=0 -> cos=1)."""

    def __init__(self, episode: Episode, cfg: LAVConfig,
                 max_points: int = 8192, n_cams: int = 3):
        self.ep = episode
        self.cfg = cfg
        self.max_points = max_points
        self.n_cams = n_cams

    def _latlon(self, loc):
        lat = loc[0] / EARTH_RADIUS / (math.pi / 180.0)
        lon = loc[1] / EARTH_RADIUS / (math.pi / 180.0)
        return np.array([lat, lon])

    def global_plan(self, stride: int = 4):
        """Sparse (gnss, cmd) plan in leaderboard format from the episode's
        recorded ego track."""
        plan = []
        for t in range(0, len(self.ep), stride):
            loc = self.ep.access("loc", t, 1).reshape(-1, 2)[0]
            cmd = int(self.ep.access("cmd", t, 1, np.uint8).reshape(-1)[0])
            lat, lon = self._latlon(loc)
            plan.append(({"lat": float(lat), "lon": float(lon)}, cmd + 1))
        return plan

    def __len__(self):
        return len(self.ep)

    def frames(self) -> Iterator[Dict[str, np.ndarray]]:
        cfg = self.cfg
        prev_loc = None
        for t in range(len(self.ep)):
            lidar = self.ep.access("lidar", t, 1).reshape(-1, 4)
            pts = np.zeros((self.max_points, 4), np.float32)
            valid = np.zeros((self.max_points,), bool)
            n = min(len(lidar), self.max_points)
            pts[:n] = lidar[:n]
            valid[:n] = True

            rgbs = np.stack([
                self.ep.load_img(f"rgb_{c}", t) for c in
                range(1, 1 + self.n_cams)
            ]).astype(np.float32)
            tel = self.ep.load_img("tel_rgb", t).astype(np.float32)
            crop = min(cfg.crop_tel_bottom, tel.shape[0] - 1)
            tel = tel[:-crop]

            loc = self.ep.access("loc", t, 1).reshape(-1, 2)[0]
            ori = math.radians(
                float(self.ep.access("ori", t, 1).reshape(-1)[0])
            )
            spd = 0.0 if prev_loc is None else float(
                np.linalg.norm(loc - prev_loc) * cfg.fps
            )
            prev_loc = loc

            nxp_world = self.ep.access("nxp", t, 1).reshape(2)
            yield dict(
                lidar=pts,
                lidar_valid=valid,
                rgbs=rgbs,
                tel_rgb=tel,
                gps=self._latlon(loc),
                compass=np.float32(ori + math.pi / 2),
                speed=np.float32(spd),
                cmd=np.int32(
                    self.ep.access("cmd", t, 1, np.uint8).reshape(-1)[0]
                ),
                target=(nxp_world - loc).astype(np.float32),
            )
