"""BEV target maps (counterpart of `lav_tpu/core/heatmap.py`)."""

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


def detections_to_heatmap(locs, oris, bbox, typs, valid, *, h: int, w: int,
                          pixels_per_meter: float, min_x: float,
                          min_y: float, max_y: float, radius: float = 1.0):
    """Ground-truth boxes -> 2-class Gaussian heatmaps and the shared
    size / orientation maps, on the tensors' device.

    locs (N, 2) ego-frame meters (x lateral, y ahead); oris (N,); bbox
    (N, 2) half-extents in meters; typs (N,) int class (0 pedestrian, 1
    vehicle); valid (N,) bool.  Returns heatmap (2, h, w), sizemap
    (2, h, w) in pixels and orimap (2, h, w) = (cos, sin).  The ego pixel
    is ((max_y - min_y) ppm / 2, h + min_x ppm), x right, y down."""
    ppm = pixels_per_meter
    dev = locs.device
    cx = -locs[:, 0] * ppm + (max_y - min_y) * ppm / 2.0
    cy = -locs[:, 1] * ppm + h + min_x * ppm
    xs = torch.arange(w, dtype=torch.float32, device=dev)
    ys = torch.arange(h, dtype=torch.float32, device=dev)
    zero = torch.zeros((), device=dev)
    tiny = torch.finfo(torch.float32).tiny

    def ftz(x):
        # XLA flushes subnormal results to 0; a subnormal Gaussian tail
        # would otherwise win a write where lav_tpu's is 0
        return torch.where(x < tiny, zero, x)

    gx = ftz(torch.exp(-(((xs[None, :] - cx[:, None]) / radius) ** 2)))
    gy = ftz(torch.exp(-(((ys[None, :] - cy[:, None]) / radius) ** 2)))
    g = ftz(gy[:, :, None] * gx[:, None, :])                # (N, h, w)
    g = torch.where(valid[:, None, None], g, zero)

    heatmap = torch.zeros((2, h, w), device=dev)
    sizemap = torch.zeros((2, h, w), device=dev)
    orimap = torch.zeros((2, h, w), device=dev)
    size_px = bbox * ppm
    for cls in (0, 1):
        g_cls = torch.where(((typs == cls) & valid)[:, None, None], g, zero)
        # argmax over equal Gaussians takes the first object, as JAX's
        # does; where every object gives 0 (masked or far) obj_id is 0
        gaussian, obj_id = g_cls.amax(dim=0), g_cls.argmax(dim=0)
        # class 1 writes the shared maps only where it beats the heatmap
        # with class 0 already in it: where a pedestrian's Gaussian is at
        # least a vehicle's, the pedestrian's size and orientation stay
        write = gaussian > heatmap.amax(dim=0)
        sz = size_px[obj_id].permute(2, 0, 1)               # (2, h, w)
        sizemap = torch.where(write[None], sz, sizemap)
        ori_sel = oris[obj_id]
        orimap = torch.where(
            write[None], torch.stack([torch.cos(ori_sel), torch.sin(ori_sel)]),
            orimap)
        heatmap[cls] = gaussian
    return heatmap, sizemap, orimap
