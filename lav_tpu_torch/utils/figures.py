"""Matplotlib diagnostic panels for each training stage (a copy of
`lav_tpu/utils/figures.py`).

Recreates the reference Logger's rich figures (lav/utils/logger.py:39-210):
BEV panels with plan/cast trajectories and the goal point, detection panels
with predicted vs GT boxes, segmentation comparisons, brake panels — as
pure figure-builders returning np.uint8 RGB images, consumable by the
JSONL/wandb Logger.  matplotlib is imported by each panel when it draws
(`_pyplot`), not with the module: the machine with the card has none, and
nothing on the card's paths draws a figure.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from lav_tpu_torch.utils.visualization import visualize_semantic


def _pyplot():
    """matplotlib.pyplot on the Agg backend, imported on first use."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def _fig_to_array(fig) -> np.ndarray:
    plt = _pyplot()
    fig.canvas.draw()
    buf = np.asarray(fig.canvas.buffer_rgba())[..., :3].copy()
    plt.close(fig)
    return buf


def _draw_traj(ax, locs, ppm, center, **kw):
    locs = np.asarray(locs)
    ax.plot(locs[..., 0] * ppm + center[0], locs[..., 1] * ppm + center[1],
            ".", **kw)


def bev_panel(bev_mean: np.ndarray, *, ego_plan_locs=None, ego_cast_locs=None,
              nxp=None, pixels_per_meter: float = 4.0,
              center=(160.0, 280.0)) -> np.ndarray:
    """Teacher-stage diagnostic: BEV + plan (red), casts (cyan), goal
    (green) — reference log_bev_info (logger.py:181-210)."""
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(5, 5))
    ax.imshow(np.asarray(bev_mean), cmap="gray")
    if ego_cast_locs is not None:
        _draw_traj(ax, ego_cast_locs, pixels_per_meter, center,
                   color="cyan", markersize=2)
    if ego_plan_locs is not None:
        _draw_traj(ax, ego_plan_locs, pixels_per_meter, center,
                   color="red", markersize=3)
    if nxp is not None:
        nxp = np.asarray(nxp)
        ax.plot([nxp[0] * pixels_per_meter + center[0]],
                [nxp[1] * pixels_per_meter + center[1]], "g*", markersize=10)
    ax.set_axis_off()
    return _fig_to_array(fig)


def det_panel(pred_bev_mean: np.ndarray, dets, gt_dets=None) -> np.ndarray:
    """Detection diagnostic: predicted BEV seg + pred (red) / GT (lime)
    oriented boxes — reference log_lidar_info (logger.py:94-162).
    dets: dict with x, y, w, h, cos, sin, valid arrays."""
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(5, 5))
    ax.imshow(np.asarray(pred_bev_mean), cmap="gray")

    def draw(d, color):
        x, y = np.asarray(d["x"], float), np.asarray(d["y"], float)
        w, h = np.asarray(d["w"], float), np.asarray(d["h"], float)
        cos, sin = np.asarray(d["cos"], float), np.asarray(d["sin"], float)
        valid = np.asarray(d["valid"], bool)
        for i in range(len(x)):
            if not valid[i]:
                continue
            R = np.array([[-sin[i], cos[i]], [-cos[i], -sin[i]]])
            corners = np.array([
                [-w[i], -h[i]], [-w[i], h[i]], [w[i], h[i]], [w[i], -h[i]],
                [-w[i], -h[i]],
            ]) @ R + [x[i], y[i]]
            ax.plot(corners[:, 0], corners[:, 1], color=color, linewidth=1.5)

    draw(dets, "red")
    if gt_dets is not None:
        draw(gt_dets, "lime")
    ax.set_axis_off()
    return _fig_to_array(fig)


def seg_panel(rgb: np.ndarray, sem: np.ndarray, pred_sem: np.ndarray,
              labels: Optional[Sequence[int]] = None) -> np.ndarray:
    """Segmentation diagnostic: image / GT / prediction — reference
    log_seg_info (logger.py:39-60)."""
    plt = _pyplot()
    fig, axes = plt.subplots(1, 3, figsize=(12, 4))
    axes[0].imshow(np.asarray(rgb).astype(np.uint8))
    axes[1].imshow(visualize_semantic(np.asarray(sem), labels))
    axes[2].imshow(visualize_semantic(np.asarray(pred_sem), labels))
    for ax, title in zip(axes, ("rgb", "gt", "pred")):
        ax.set_title(title)
        ax.set_axis_off()
    return _fig_to_array(fig)


def bra_panel(rgb: np.ndarray, tel_rgb: np.ndarray, bra: float,
              pred_bra: float) -> np.ndarray:
    """Brake diagnostic — reference log_bra_info (logger.py:62-92)."""
    plt = _pyplot()
    fig, axes = plt.subplots(1, 2, figsize=(10, 4))
    axes[0].imshow(np.asarray(rgb).astype(np.uint8))
    axes[1].imshow(np.asarray(tel_rgb).astype(np.uint8))
    fig.suptitle(f"brake gt={bra:.0f} pred={pred_bra:.3f}")
    for ax in axes:
        ax.set_axis_off()
    return _fig_to_array(fig)


def point_histogram_panel(num_points: np.ndarray) -> np.ndarray:
    """Histogram of per-sample lidar point counts (logger.py:160)."""
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(4, 3))
    ax.hist(np.asarray(num_points).reshape(-1), bins=20)
    ax.set_xlabel("points/sample")
    return _fig_to_array(fig)
