"""Visualization: BEV composites, lidar splats, semantic palettes (a copy
of `lav_tpu/utils/visualization.py`).

cv2-free numpy re-creation of the reference viz stack
(lav/utils/visualization.py:11-188, team_code_v2/lav_agent.py:459-518):
semantic colorization, lidar histogram splat, trajectory/box overlays, and
the agent's per-tick canvas.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

# CARLA semantic palette (class id -> RGB), reference visualization.py:11-36
CARLA_PALETTE = np.array([
    (0, 0, 0), (70, 70, 70), (100, 40, 40), (55, 90, 80), (220, 20, 60),
    (153, 153, 153), (157, 234, 50), (128, 64, 128), (244, 35, 232),
    (107, 142, 35), (0, 0, 142), (102, 102, 156), (220, 220, 0),
    (70, 130, 180), (81, 0, 81), (150, 100, 100), (230, 150, 140),
    (180, 165, 180), (250, 170, 30), (110, 190, 160), (170, 120, 50),
    (45, 60, 150), (145, 170, 100),
], dtype=np.uint8)


def visualize_semantic(sem: np.ndarray, labels: Optional[Sequence[int]] = None
                       ) -> np.ndarray:
    """sem (H, W) int class map -> (H, W, 3) RGB."""
    if labels is not None:
        ids = np.zeros(len(labels) + 1, np.int64)
        ids[1:] = labels
        sem = ids[sem]
    return CARLA_PALETTE[np.clip(sem, 0, len(CARLA_PALETTE) - 1)]


def lidar_to_bev(lidar_xy: np.ndarray, *, min_x=-10, max_x=70, min_y=-40,
                 max_y=40, pixels_per_meter=4, hist_max_per_pixel=10
                 ) -> np.ndarray:
    """2-D histogram splat of lidar points (lav_agent.py:531-545):
    returns a grayscale uint8 image with x increasing downward-flipped."""
    xbins = np.linspace(min_x, max_x + 1,
                        int((max_x - min_x) * pixels_per_meter) + 1)
    ybins = np.linspace(min_y, max_y + 1,
                        int((max_y - min_y) * pixels_per_meter) + 1)
    hist, _, _ = np.histogram2d(lidar_xy[:, 0], lidar_xy[:, 1],
                                bins=(xbins, ybins))
    hist = np.minimum(hist, hist_max_per_pixel)
    return (hist / hist_max_per_pixel * 255.0)[::-1].astype(np.uint8)


def draw_disc(img: np.ndarray, xy, radius: int, color):
    """In-place filled circle (replaces cv2.circle)."""
    h, w = img.shape[:2]
    x0, y0 = int(round(xy[0])), int(round(xy[1]))
    if not (0 <= x0 < w and 0 <= y0 < h):
        return img
    ys, xs = np.ogrid[max(0, y0 - radius):min(h, y0 + radius + 1),
                      max(0, x0 - radius):min(w, x0 + radius + 1)]
    mask = (xs - x0) ** 2 + (ys - y0) ** 2 <= radius ** 2
    img[max(0, y0 - radius):min(h, y0 + radius + 1),
        max(0, x0 - radius):min(w, x0 + radius + 1)][mask] = color
    return img


def visualize_agent_tick(lidar_xy, plan_locs, other_cast_locs, other_cast_cmds,
                         other_valid, target_xy, *, pixels_per_meter=4,
                         cmd_thresh=0.2, min_x=-10, max_x=70, min_y=-40,
                         max_y=40) -> np.ndarray:
    """Per-tick BEV canvas: lidar splat + ego plan (red) + plausible other
    forecasts (orange) + goal (green); the agent-side composition of
    reference visualize (lav_agent.py:459-501)."""
    canvas = lidar_to_bev(
        lidar_xy, min_x=min_x, max_x=max_x, min_y=min_y, max_y=max_y,
        pixels_per_meter=pixels_per_meter,
    )
    canvas = np.stack([canvas] * 3, -1)
    h, w = canvas.shape[:2]
    ego = np.array([w // 2, int(h + min_x * pixels_per_meter)])

    for loc in np.asarray(plan_locs):
        draw_disc(canvas, ego + loc * pixels_per_meter, 1, (255, 0, 0))
    ocl = np.asarray(other_cast_locs)
    occ = np.asarray(other_cast_cmds)
    for k in range(ocl.shape[0]):
        if not bool(np.asarray(other_valid)[k]):
            continue
        for c in range(ocl.shape[1]):
            if occ[k, c] < cmd_thresh:
                continue
            for loc in ocl[k, c]:
                draw_disc(canvas, ego + loc * pixels_per_meter, 1, (255, 140, 0))
    draw_disc(canvas, np.clip(ego + np.asarray(target_xy) * pixels_per_meter,
                              0, max(h, w) - 1), 2, (0, 255, 0))
    return canvas
