"""Affine crops from one shared source, in plain PyTorch: a frozen copy
of the port's plain forms (`grid_sample_shared`, its int8 and
space-to-depth forms).  Autograd differentiates the crops with respect to
the source only (the grid is detached), as lav_tpu's custom VJP does.

Sampling semantics (align_corners=True bilinear, zero padding): the tap
origin is clamped into [0, W-2] x [0, H-2] and each tap is weighted by the
hinge max(0, 1 - |pos - tap|).  Weights are computed in f32 and cast to
the source dtype; the four products are accumulated in f32.  With
`q8_x_scale` the crops are quantized from the f32 sum: q =
clip(round(acc / x_scale), +-QMAX), round half to even.
"""

from __future__ import annotations

import torch

from lavbench.ref import record



def affine_grid(theta, out_h: int, out_w: int):
    """theta (N, 2, 3) maps normalised target (x, y, 1) to normalised source
    coordinates -> grid (N, out_h, out_w, 2), align_corners=True.  Always
    f32: positions are parity-critical."""
    dev = theta.device
    xs = torch.linspace(-1.0, 1.0, out_w, dtype=torch.float32, device=dev)
    ys = torch.linspace(-1.0, 1.0, out_h, dtype=torch.float32, device=dev)
    base = torch.stack([
        xs[None, :].expand(out_h, out_w),
        ys[:, None].expand(out_h, out_w),
        torch.ones((out_h, out_w), dtype=torch.float32, device=dev),
    ], dim=-1)  # (H, W, 3)
    return torch.einsum("hwk,bjk->bhwj", base, theta.float())


def crop_theta(rel_locs, rel_oris, H, W, pixels_per_meter, crop_size,
               offset_x, offset_y):
    """The reference crop_feature's affine map for rel_locs (N, 2) meters
    and rel_oris (N,) radians -> theta (N, 2, 3)."""
    dev = rel_locs.device
    rel = rel_locs.reshape(-1, 2).float() * pixels_per_meter / torch.tensor(
        [H / 2.0, W / 2.0], dtype=torch.float32, device=dev)
    cos = torch.cos(rel_oris.reshape(-1).float())
    sin = torch.sin(rel_oris.reshape(-1).float())
    k = crop_size / H
    rot_x_off = -k * offset_x * cos + k * offset_y * sin + offset_x
    rot_y_off = -k * offset_x * sin - k * offset_y * cos + offset_y
    row0 = torch.stack([k * cos, -k * sin, rot_x_off + rel[..., 0]], dim=-1)
    row1 = torch.stack([k * sin, k * cos, rot_y_off + rel[..., 1]], dim=-1)
    return torch.stack([row0, row1], dim=-2)


def _bilinear_f32(src, grid):
    """The f32 bilinear sums, (B, K, Ho, Wo, C) f32."""
    B, H, W, C = src.shape
    _, K, Ho, Wo, _ = grid.shape
    ix = (grid[..., 0] + 1.0) * 0.5 * (W - 1)
    iy = (grid[..., 1] + 1.0) * 0.5 * (H - 1)
    x0 = torch.clamp(torch.floor(ix), 0, W - 2)
    y0 = torch.clamp(torch.floor(iy), 0, H - 2)
    wy = [torch.clamp(1.0 - torch.abs(iy - (y0 + d)), min=0.0) for d in (0, 1)]
    wx = [torch.clamp(1.0 - torch.abs(ix - (x0 + d)), min=0.0) for d in (0, 1)]
    base = (y0.long() * W + x0.long()).reshape(B, -1)
    flat = src.reshape(B, H * W, C)
    bidx = torch.arange(B, device=src.device)[:, None]
    out = None
    for dy in (0, 1):
        for dx in (0, 1):
            vals = flat[bidx, base + (dy * W + dx)].float()
            w = (wy[dy] * wx[dx]).to(src.dtype).float().reshape(B, -1, 1)
            out = vals * w if out is None else out + vals * w
    return out.reshape(B, K, Ho, Wo, C)


def grid_sample_shared(src, grid):
    """Plain version of kernel `crop_shared`: src (B, H, W, C), grid
    (B, K, Ho, Wo, 2) f32 -> (B, K, Ho, Wo, C) in src's dtype."""
    return _bilinear_f32(src, grid).to(src.dtype)


def inverse_scale(x_scale):
    """inv_s = 1/x_scale in f32, as the Pallas wrapper computes it."""
    return (1.0 / x_scale.float()).reshape(())


def grid_sample_shared_q8(src, grid, inv_s):
    """Plain version of kernel `crop_shared_q8`: the f32 sums quantized,
    clip(round(acc * inv_s), +-127) as int8."""
    from lavbench.ref.nn.quant import QMAX

    acc = _bilinear_f32(src, grid)
    return torch.clamp(torch.round(acc * inv_s), -QMAX, QMAX).to(torch.int8)


def space_to_depth(x):
    """(B, K, H, W, C) -> (B, K, H/2, W/2, 4C), channel order (dy, dx, c)
    (lav_tpu `core/warp.py:340-344`)."""
    B, K, H, W, C = x.shape
    x = x.reshape(B, K, H // 2, 2, W // 2, 2, C).permute(0, 1, 2, 4, 3, 5, 6)
    return x.reshape(B, K, H // 2, W // 2, 4 * C)


def crop_shared(src, grid, q8_x_scale=None, s2d: bool = False):
    """K bilinear crops per batch item from that item's own source: src
    (B, H, W, C), grid (B, K, Ho, Wo, 2) f32 -> (B, K, Ho, Wo, C) in src's
    dtype, int8 with `q8_x_scale`, space-to-depth with `s2d` too."""
    record.note("crop", src=src, grid=grid, q8=q8_x_scale is not None,
                grad=src.requires_grad and torch.is_grad_enabled())
    if q8_x_scale is None:
        return grid_sample_shared(src, grid)
    out = grid_sample_shared_q8(src, grid, inverse_scale(q8_x_scale))
    return space_to_depth(out) if s2d else out


def crop_feature_shared(features, rel_locs, rel_oris, *,
                        pixels_per_meter: float, crop_size: int,
                        offset_x: float = 0.0, offset_y: float = 0.75,
                        q8_x_scale=None, s2d: bool = False):
    """K rotated crops from one feature map per batch item.

    features (H, W, C) with rel_locs (K, 2) meters and rel_oris (K,) radians
    -> (K, crop, crop, C); or features (B, H, W, C) with (B, K, 2) / (B, K)
    -> (B, K, crop, crop, C); int8 crops with `q8_x_scale`, space-to-depth
    (.., crop/2, crop/2, 4C) with `s2d` as well."""
    single = features.ndim == 3
    if single:
        features, rel_locs, rel_oris = (features[None], rel_locs[None],
                                        rel_oris[None])
    B, H, W, _ = features.shape
    K = rel_locs.shape[1]
    theta = crop_theta(rel_locs, rel_oris, H, W, pixels_per_meter,
                       crop_size, offset_x, offset_y)
    grid = affine_grid(theta, crop_size, crop_size)
    grid = grid.reshape(B, K, crop_size, crop_size, 2).contiguous()
    crops = crop_shared(features, grid.detach(), q8_x_scale, s2d)
    return crops[0] if single else crops


def grid_sample(img, grid):
    """Bilinear sample img (B, H, W, C) at grid (B, Ho, Wo, 2) f32, x
    first, align_corners=True, zero padding; the gradient reaches img
    only."""
    if grid.requires_grad and torch.is_grad_enabled():
        raise ValueError("grid_sample: no gradient with respect to grid; "
                         "detach it or sample under torch.no_grad()")
    return crop_shared(img, grid[:, None].detach())[:, 0]


def crop_feature(features, rel_locs, rel_oris, *, pixels_per_meter: float,
                 crop_size: int, offset_x: float = 0.0,
                 offset_y: float = 0.75):
    """One rotated crop per batch item (lav_tpu `core/warp.py:348`):
    features (B, H, W, C), rel_locs (B, 2), rel_oris (B,) -> (B, crop,
    crop, C); the K = 1 shared crop, which is the same function."""
    return crop_feature_shared(
        features, rel_locs[:, None], rel_oris[:, None],
        pixels_per_meter=pixels_per_meter, crop_size=crop_size,
        offset_x=offset_x, offset_y=offset_y)[:, 0]
