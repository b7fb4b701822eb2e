"""BEV target maps (counterpart of `lav_tpu/core/heatmap.py`; a copy of
what the port uses)."""

from __future__ import annotations

import torch


def build_seg_mask(h: int, w: int, cx: float, cy: float,
                   radius_x: float = 240.0, radius_y: float = 240.0,
                   device=None):
    """(h, w) Gaussian weights centred on the ego pixel (cx, cy), which
    the v2 distillation step puts on the BEV seg loss (LAV
    lav_final_v2.py:261-271)."""
    gx = torch.exp(-(((torch.arange(w, dtype=torch.float32, device=device)
                       - cx) / radius_x) ** 2))
    gy = torch.exp(-(((torch.arange(h, dtype=torch.float32, device=device)
                       - cy) / radius_y) ** 2))
    return gy[:, None] * gx[None, :]
