"""Host-side route following: high-level commands and dense goal waypoints
(a copy of `lav_tpu/agent/route.py`).

These are small stateful per-episode objects that consume the leaderboard's
sparse GPS plan — they stay on the host (they're control flow, not compute),
matching LAV's split (team_code_v2/waypointer.py:7-103,
planner.py:7-58).  Command integers follow the CARLA RoadOption convention
the models were trained with: 0 left, 1 right, 2 straight, 3 lanefollow,
4 changelaneleft, 5 changelaneright (value-1 of RoadOption).
"""

from __future__ import annotations

import math

from typing import Sequence, Tuple

import numpy as np

EARTH_RADIUS = 6371e3

# RoadOption values (CARLA agents.navigation.local_planner)
LEFT, RIGHT, STRAIGHT, LANEFOLLOW, CHANGELANELEFT, CHANGELANERIGHT = 1, 2, 3, 4, 5, 6


def _latlon_to_xy(lat, lon, cos0):
    x = EARTH_RADIUS * lat * (math.pi / 180.0)
    y = EARTH_RADIUS * lon * (math.pi / 180.0) * math.cos(cos0)
    return x, y


def _mean_lat_rad(global_plan) -> float:
    return sum(g["lat"] * (math.pi / 180.0) for g, _ in global_plan) / len(global_plan)


class Waypointer:
    """Tracks progress along the sparse command plan and emits the current
    high-level command (reference waypointer.py semantics, including the
    3-step lane-change lookahead when pop_lane_change)."""

    def __init__(self, global_plan: Sequence[Tuple[dict, int]], current_gnss,
                 threshold_before: float = 4.5, threshold_after: float = 3.0,
                 pop_lane_change: bool = True):
        self._before = threshold_before
        self._after = threshold_after
        self._pop_lane_change = pop_lane_change

        self.cos_0 = _mean_lat_rad(global_plan)
        self.global_plan = [
            (*_latlon_to_xy(g["lat"], g["lon"], self.cos_0), int(cmd))
            for g, cmd in global_plan
        ]
        lat, lon = float(current_gnss[0]), float(current_gnss[1])
        cx, cy = _latlon_to_xy(lat, lon, self.cos_0)
        self.checkpoint = (cx, cy, LANEFOLLOW)
        self.current_idx = -1

    def tick(self, gnss):
        lat, lon = float(gnss[0]), float(gnss[1])
        cur_x, cur_y = _latlon_to_xy(lat, lon, self.cos_0)

        i = 0
        for i, (wx, wy, cmd) in enumerate(self.global_plan):
            distance = math.hypot(cur_x - wx, cur_y - wy)
            if self.checkpoint[2] == LANEFOLLOW and cmd != LANEFOLLOW:
                threshold = self._before
            else:
                threshold = self._after
            if distance < threshold and i - self.current_idx == 1:
                self.checkpoint = (wx, wy, cmd)
                self.current_idx += 1
                break

        if self._pop_lane_change:
            look_ahead = 0
            _, _, cmd = self.checkpoint
            while i + 1 < len(self.global_plan) and look_ahead < 3:
                wx, wy, wcmd = self.global_plan[i + 1]
                if cmd != LANEFOLLOW:
                    break
                if wcmd in (CHANGELANELEFT, CHANGELANERIGHT):
                    self.checkpoint = (wx, wy, wcmd)
                    self.current_idx = i + 1
                    break
                cmd = wcmd
                i += 1
                look_ahead += 1

        wx, wy, cmd = self.checkpoint
        return wx - cur_x, wy - cur_y, cmd


class RoutePlanner:
    """Dense goal-waypoint source for the planner's nxp conditioning
    (reference planner.py:7-58)."""

    def __init__(self, global_plan, curr_threshold: float = 20.0,
                 next_threshold: float = 75.0):
        self.curr_threshold = curr_threshold
        self.next_threshold = next_threshold
        self.cos_0 = _mean_lat_rad(global_plan)
        self.route = [
            _latlon_to_xy(g["lat"], g["lon"], self.cos_0) for g, _ in global_plan
        ]
        self.current_idx = 0
        self.checkpoint = self.route[0]

    def run_step(self, gnss):
        x, y = _latlon_to_xy(float(gnss[0]), float(gnss[1]), self.cos_0)
        wx, wy = self.checkpoint
        curr_distance = math.hypot(wx - x, wy - y)
        for i, (wx, wy) in enumerate(self.route):
            distance = math.hypot(wx - x, wy - y)
            if (distance < self.next_threshold and i - self.current_idx == 1
                    and curr_distance < self.curr_threshold):
                self.checkpoint = (wx, wy)
                self.current_idx += 1
                break
        return np.array(self.checkpoint) - np.array([x, y])


def cmd_to_model_value(cmd: int) -> int:
    """RoadOption value -> model command index (lav_agent.py:282-283)."""
    v = cmd - 1
    return 3 if v < 0 else v
