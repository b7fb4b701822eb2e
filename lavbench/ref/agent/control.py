"""Waypoint-following control and collision-forecast braking, batched over
egos (counterpart of `lav_tpu/agent/control.py`)."""

from __future__ import annotations

import math

import torch

from lavbench.ref.agent.pid import pid_step


def pid_control(ctl, turn_window, speed_window, waypoints, speed, cmd):
    """waypoints (E, T, 2) meters; speed (E,) m/s; cmd (E,) int.

    ctl: turn_pid, speed_pid constants, aim_point and speed_ratio
    (num_cmds,) tensors, pixels_per_meter, brake_speed, clip_delta,
    max_throttle.  Returns (steer, throttle, brake, turn_window,
    speed_window), each per ego."""
    ppm = ctl["pixels_per_meter"]
    wps = waypoints * ppm
    wps = torch.stack([wps[..., 0], wps[..., 1] * -1.0], dim=-1)

    deltas = torch.linalg.norm(wps[:, 1:] - wps[:, :-1], dim=-1)
    desired_speed = deltas.mean(dim=1)

    cmd = cmd.long()
    ar = torch.arange(wps.shape[0], device=wps.device)
    # an aim index past the plan's end reads its last waypoint, as JAX's
    # clamped gather does
    aim_idx = ctl["aim_point"][cmd].long().clamp(0, wps.shape[1] - 1)
    aim = wps[ar, aim_idx]
    angle = torch.rad2deg(math.pi / 2 - torch.atan2(aim[:, 1], aim[:, 0]))
    angle = angle / 90.0
    steer, turn_window = pid_step(ctl["turn_pid"], turn_window, angle)
    steer = torch.clamp(steer, -1.0, 1.0)

    brake = desired_speed < ctl["brake_speed"] * ppm
    ratio = ctl["speed_ratio"][cmd]
    delta = torch.clamp(desired_speed * ratio - speed, 0.0, ctl["clip_delta"])
    throttle, speed_window = pid_step(ctl["speed_pid"], speed_window, delta)
    throttle = torch.clamp(throttle, 0.0, ctl["max_throttle"])
    throttle = torch.where(brake, torch.zeros_like(throttle), throttle)
    return steer, throttle, brake, turn_window, speed_window


def plan_collide(ego_plan_locs, other_cast_locs, other_cast_cmds, other_valid,
                 *, pixels_per_meter: float, cmd_thresh: float,
                 brake_speed: float, dist_threshold_static: float = 1.0,
                 dist_threshold_moving: float = 2.5):
    """Does any plausible forecast of a detected car meet the ego plan?

    ego_plan_locs (E, T, 2); other_cast_locs (E, K, C, T, 2);
    other_cast_cmds (E, K, C); other_valid (E, K) -> (E,) bool."""
    init_y = other_cast_locs[:, :, 0, 0, 1]
    car_ok = other_valid & ~(init_y > 0.5 * pixels_per_meter)
    traj = other_cast_locs
    spd = torch.linalg.norm(traj[..., 1:, :] - traj[..., :-1, :],
                            dim=-1).mean(dim=-1)
    thresh = torch.where(spd < brake_speed,
                         torch.full_like(spd, dist_threshold_static),
                         torch.full_like(spd, dist_threshold_moving))
    dist = torch.linalg.norm(traj - ego_plan_locs[:, None, None],
                             dim=-1).amin(dim=-1)
    hit = (dist < thresh) & (other_cast_cmds >= cmd_thresh) & car_ok[..., None]
    return hit.flatten(1).any(dim=1)
