"""Static-shape heatmap peak extraction (counterpart of
`lav_tpu/ops/peak.py`), batched over a leading axis: max-pool NMS, a fixed
`max_det` top-k, and LAV's score/geometry filters as masks."""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F


class Detections(NamedTuple):
    """Fixed-capacity detections, (..., K) each; slot i counts iff valid."""
    score: torch.Tensor
    x: torch.Tensor       # int32 column
    y: torch.Tensor       # int32 row
    w: torch.Tensor
    h: torch.Tensor
    cos: torch.Tensor
    sin: torch.Tensor
    valid: torch.Tensor


def extract_peaks(heatmap, *, max_pool_ks: int = 7, min_score: float = 0.1,
                  max_det: int = 15):
    """heatmap (B, H, W) -> (scores, xs, ys, valid), each (B, K).

    A peak must equal its ks x ks local max; then the top k by score, from
    a stable descending sort, so tied scores keep the lower index first,
    as JAX's top_k orders them (torch.topk leaves ties in no fixed order).
    The sort takes two launches, where a top-k over an int64 key that
    breaks ties by index takes about a dozen: twice the host time a call,
    and the ticks are launch-bound (PERF.md)."""
    B, H, W = heatmap.shape
    local_max = F.max_pool2d(heatmap[:, None], max_pool_ks, 1,
                             max_pool_ks // 2)[:, 0]
    suppressed = heatmap - (local_max > heatmap).to(heatmap.dtype) * 1e5
    k = min(max_det, H * W)
    scores, idx = torch.sort(suppressed.reshape(B, -1), dim=-1,
                             descending=True, stable=True)
    scores, idx = scores[:, :k], idx[:, :k]
    xs = (idx % W).to(torch.int32)
    ys = (idx // W).to(torch.int32)
    return scores, xs, ys, scores > min_score


def det_inference(heatmaps, sizemaps, orimaps, *, pixels_per_meter=4.0,
                  max_pool_ks: int = 7, min_score: float = 0.1,
                  max_det: int = 15, ego_xy=None,
                  ego_exclusion_px: float = 2.0) -> Detections:
    """heatmaps (B, C, H, W) already sigmoided; sizemaps, orimaps
    (B, 2, H, W) -> Detections with fields (B, C, K).

    LAV's predicate `if i==1 and w < 0.1*ppm or h < 0.2*ppm: continue`
    drops ANY class with h < 0.2*ppm by Python precedence; kept as is.
    ego_xy (2,) excludes peaks within `ego_exclusion_px` of the ego."""
    B, C, H, W = heatmaps.shape
    ar = torch.arange(B, device=heatmaps.device)[:, None]

    def per_class(cls_idx):
        hm = heatmaps[:, cls_idx]
        scores, xs, ys, valid = extract_peaks(
            hm, max_pool_ks=max_pool_ks, min_score=min_score, max_det=max_det)
        yl, xl = ys.long(), xs.long()
        w = sizemaps[ar, 0, yl, xl]
        h = sizemaps[ar, 1, yl, xl]
        cos = orimaps[ar, 0, yl, xl]
        sin = orimaps[ar, 1, yl, xl]
        drop = ((cls_idx == 1) & (w < 0.1 * pixels_per_meter)) | (
            h < 0.2 * pixels_per_meter)
        valid = valid & ~drop
        if ego_xy is not None:
            d2 = ((xs.to(hm.dtype) - ego_xy[0]) ** 2
                  + (ys.to(hm.dtype) - ego_xy[1]) ** 2)
            valid = valid & (d2 > ego_exclusion_px ** 2)
        return Detections(scores, xs, ys, w, h, cos, sin, valid)

    dets = [per_class(i) for i in range(C)]
    return Detections(*[torch.stack(f, dim=1) for f in zip(*dets)])
