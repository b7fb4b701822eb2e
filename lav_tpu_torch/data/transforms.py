"""Host-side numpy transforms for the input pipeline.

numpy counterparts of the dataset-side geometry in the reference
(lidar_dataset.py:131-173, bev_dataset.py:76-107, lav/utils/__init__.py:3-8),
including a cv2-free `rotate_image` (bilinear warpAffine about a center)
so that OpenCV is not needed.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np


def filter_sem(sem: np.ndarray, labels: Sequence[int]) -> np.ndarray:
    """Remap raw CARLA semantic ids to compact class indices (background=0)."""
    out = np.zeros_like(sem)
    for i, label in enumerate(labels):
        out[sem == label] = i + 1
    return out


def rotate_image(image: np.ndarray, angle_deg: float,
                 center=(160, 280)) -> np.ndarray:
    """cv2.warpAffine(getRotationMatrix2D(center, angle, 1)) equivalent:
    bilinear, zero border.  Positive angle rotates the image content
    counter-clockwise (OpenCV convention)."""
    h, w = image.shape[:2]
    theta = math.radians(angle_deg)
    a, b = math.cos(theta), math.sin(theta)
    cx, cy = center

    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    # inverse map: rotate dst coords by -angle about the center
    sx = a * (xs - cx) - b * (ys - cy) + cx
    sy = b * (xs - cx) + a * (ys - cy) + cy

    x0 = np.floor(sx).astype(np.int64)
    y0 = np.floor(sy).astype(np.int64)
    wx = sx - x0
    wy = sy - y0

    img = image.astype(np.float64)
    if img.ndim == 2:
        img = img[..., None]

    out = np.zeros((h, w, img.shape[-1]))
    for dy in (0, 1):
        for dx in (0, 1):
            xi, yi = x0 + dx, y0 + dy
            inb = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
            weight = ((wx if dx else 1 - wx) * (wy if dy else 1 - wy))[..., None]
            vals = img[np.clip(yi, 0, h - 1), np.clip(xi, 0, w - 1)]
            out += np.where(inb[..., None], vals * weight, 0.0)

    out = out.astype(image.dtype) if np.issubdtype(image.dtype, np.integer) \
        else out.astype(image.dtype)
    return out[..., 0] if image.ndim == 2 else out


def rotate_lidar_np(lidar: np.ndarray, angle_deg: float) -> np.ndarray:
    """Rotate lidar xy about z by angle (reference rotate_lidar,
    lidar_dataset.py:158-165 applies [[c, s], [-s, c]] to row vectors)."""
    r = math.radians(angle_deg)
    c, s = math.cos(r), math.sin(r)
    out = lidar.copy()
    x, y = lidar[:, 0].copy(), lidar[:, 1].copy()
    out[:, 0] = c * x - s * y
    out[:, 1] = s * x + c * y
    return out


def rotate_points_np(points: np.ndarray, angle_deg: float,
                     center: np.ndarray) -> np.ndarray:
    r = math.radians(angle_deg)
    c, s = math.cos(r), math.sin(r)
    p = points - center
    x, y = p[..., 0].copy(), p[..., 1].copy()
    out = np.stack([c * x - s * y, s * x + c * y], axis=-1)
    return out + center


def transform_ego(ego_locs, locs, oris, ego_ori: float):
    """World -> ego-frame normalization with LAV's axis convention
    R = [[sin, cos], [-cos, sin]] (lidar_dataset.py:131-147).
    locs (N, T+1, 2) INCLUDES the ego at slot 0."""
    R = np.array([
        [math.sin(ego_ori), math.cos(ego_ori)],
        [-math.cos(ego_ori), math.sin(ego_ori)],
    ])
    ego_loc = ego_locs[0]
    return (ego_locs - ego_loc) @ R, (locs - ego_loc) @ R, oris - ego_ori


def ego_hull_filter(lidar_xyzr: np.ndarray, *extra: np.ndarray):
    """Remove returns from the ego body (lidar_dataset.py:14-23)."""
    x, y, z = lidar_xyzr[:, 0], lidar_xyzr[:, 1], lidar_xyzr[:, 2]
    hull = (x > -2.4) & (x < 0) & (y > -0.8) & (y < 0.8) & (z > -1.5) & (z < -1)
    keep = ~hull
    if extra:
        return (lidar_xyzr[keep],) + tuple(e[keep] for e in extra)
    return lidar_xyzr[keep]


def move_lidar_points_np(lidar, dloc, ori0, ori1):
    """numpy twin of lav_tpu.core.geometry.move_lidar_points for dataset
    workers (temporal sweep re-registration)."""
    c0, s0 = math.cos(ori0), math.sin(ori0)
    d = np.array([dloc[0] * c0 + dloc[1] * s0, -dloc[0] * s0 + dloc[1] * c0])
    o = ori1 - ori0
    c, s = math.cos(o), math.sin(o)
    out = lidar.copy()
    x, y = lidar[:, 0].copy(), lidar[:, 1].copy()
    out[:, 0] = c * x - s * y + d[0]
    out[:, 1] = s * x + c * y + d[1]
    return out


def detections_to_heatmap_np(locs, oris, bbox, typs, *, h: int, w: int,
                             pixels_per_meter: float, min_x: float,
                             min_y: float, max_y: float, radius: float = 1.0):
    """numpy twin of lav_tpu.core.heatmap.detections_to_heatmap for the
    host input pipeline (reference lidar_dataset.py:92-127)."""
    heatmap = np.zeros((2, h, w), np.float32)
    sizemap = np.zeros((2, h, w), np.float32)
    orimap = np.zeros((2, h, w), np.float32)
    ppm = pixels_per_meter

    # float32 on purpose: the reference computes the gaussians in f32
    # (torch default) and the far-field UNDERFLOW to exact zero defines the
    # write mask (`gaussian > heatmap.max(0)`); f64 would fill the whole map
    xs = np.arange(w, dtype=np.float32)
    ys = np.arange(h, dtype=np.float32)

    for cls in (0, 1):
        sel = typs == cls
        if not sel.any():
            continue
        loc, ori, box = locs[sel], oris[sel], bbox[sel]
        cx = (-loc[:, 0] * ppm + (max_y - min_y) * ppm / 2.0).astype(np.float32)
        cy = (-loc[:, 1] * ppm + h + min_x * ppm).astype(np.float32)
        gx = np.exp(-(((xs[:, None] - cx[None]) / radius) ** 2),
                    dtype=np.float32)                             # (w, N)
        gy = np.exp(-(((ys[:, None] - cy[None]) / radius) ** 2),
                    dtype=np.float32)                             # (h, N)
        g = gx[None] * gy[:, None]                                # (h, w, N)
        gaussian = g.max(-1)
        obj = g.argmax(-1)
        mask = gaussian > heatmap.max(0)
        sizemap[:, mask] = (box.T[:, obj[mask]]) * ppm
        orimap[0, mask] = np.cos(ori[obj[mask]])
        orimap[1, mask] = np.sin(ori[obj[mask]])
        heatmap[cls] = gaussian

    return heatmap, sizemap, orimap
