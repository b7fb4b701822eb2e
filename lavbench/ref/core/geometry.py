"""Planar geometry (counterpart of `lav_tpu/core/geometry.py`): LAV's
coordinate conventions as batched elementwise tensor functions."""

from __future__ import annotations

import math

import torch

EARTH_RADIUS = 6371e3  # meters


def apply_rot2(x, y, cos, sin):
    """p' = p @ [[cos, sin], [-sin, cos]] for row vectors, elementwise."""
    return cos * x - sin * y, sin * x + cos * y


def transform_points(locs, oris):
    """Rotate (..., N, 2) point sets into frames given by `oris`; `oris`
    broadcasts against `locs[..., 0]` (a lower-rank `oris` is aligned to
    the leading axes)."""
    oris = torch.as_tensor(oris, dtype=locs.dtype, device=locs.device)
    cos, sin = torch.cos(oris), torch.sin(oris)
    if 0 < cos.ndim < locs.ndim - 1:
        shape = tuple(cos.shape) + (1,) * (locs.ndim - 1 - cos.ndim)
        cos, sin = cos.reshape(shape), sin.reshape(shape)
    xr, yr = apply_rot2(locs[..., 0], locs[..., 1], cos, sin)
    return torch.stack([xr, yr], dim=-1)


def rotate_points_deg(points, angle_deg, center):
    """Rotate points (..., 2) by `angle_deg` degrees about `center` (2,)."""
    rad = torch.deg2rad(torch.as_tensor(angle_deg, dtype=points.dtype,
                                        device=points.device))
    center = torch.as_tensor(center, dtype=points.dtype, device=points.device)
    p = points - center
    xr, yr = apply_rot2(p[..., 0], p[..., 1], torch.cos(rad), torch.sin(rad))
    return torch.stack([xr, yr], dim=-1) + center


def rotate_lidar_deg(lidar, angle_deg):
    """Rotate lidar (N, 4+) xyzr points about the z axis by `angle_deg`
    degrees.  LAV's convention rotates x / y with R^T relative to
    `transform_points` ([cos, sin; -sin, cos] applied to the column [x,
    y]), as lav_tpu's copy keeps it."""
    rad = torch.deg2rad(torch.as_tensor(angle_deg, dtype=lidar.dtype,
                                        device=lidar.device))
    cos, sin = torch.cos(rad), torch.sin(rad)
    x, y = lidar[..., 0], lidar[..., 1]
    xr = cos * x - sin * y
    yr = sin * x + cos * y
    return torch.cat([torch.stack([xr, yr], dim=-1), lidar[..., 2:]], dim=-1)


def move_lidar_points(lidar_xyz, dloc, ori0, ori1):
    """Re-register a sweep captured at pose (loc, ori1) into the frame of
    pose (loc0, ori0), with dloc = loc - loc0.  lidar_xyz (..., N, 3);
    dloc (..., 2); ori0, ori1 (...)."""
    c0, s0 = torch.cos(ori0), torch.sin(ori0)
    dx = dloc[..., 0] * c0 + dloc[..., 1] * s0
    dy = -dloc[..., 0] * s0 + dloc[..., 1] * c0
    d = torch.stack([dx, dy], dim=-1)
    ori = ori1 - ori0
    cos, sin = torch.cos(ori)[..., None], torch.sin(ori)[..., None]
    x, y = lidar_xyz[..., 0], lidar_xyz[..., 1]
    xr = cos * x - sin * y
    yr = sin * x + cos * y
    out = torch.stack([xr, yr], dim=-1) + d.unsqueeze(-2)
    return torch.cat([out, lidar_xyz[..., 2:3]], dim=-1)


def latlon_to_xy(lat, lon, cos0):
    """Equirectangular GNSS lat / lon (degrees, tensors) to local xy
    meters; cos0 is the route's mean latitude in radians.  (The route
    followers in agent/route.py keep their own copy on host floats, in
    double precision, as lav_tpu's do.)"""
    cos0 = torch.as_tensor(cos0, dtype=lon.dtype, device=lon.device)
    x = EARTH_RADIUS * lat * (math.pi / 180.0)
    y = EARTH_RADIUS * lon * (math.pi / 180.0) * torch.cos(cos0)
    return x, y
