"""Affine crops from one shared source (counterpart of `lav_tpu/core/warp.py`).

Hosts kernel `crop_shared` (csrc/crop_shared.cu), the port of lav_tpu's
Pallas crop kernel (`lav_tpu/core/warp_pallas.py::_kernel`).  The device
of the source decides the route: a CUDA tensor launches the kernel (or the
wrapper raises), a CPU tensor takes the plain version `grid_sample_shared`.

Sampling semantics (align_corners=True bilinear, zero padding): the tap
origin is clamped into [0, W-2] x [0, H-2] and each tap is weighted by the
hinge max(0, 1 - |pos - tap|).  That is exact zero padding with partial
weights at the border, and exact zeros for taps wholly outside.  Weights
are computed in f32 and cast to the source dtype; the four products are
accumulated in f32 and the sum is cast to the source dtype.

With `q8_x_scale` the crops come out int8, quantized from the f32 sum
(the Pallas kernel's q8 epilogue, `warp_pallas.py:164-168`): q =
clip(round(acc * inv_s), +-127), inv_s = 1/x_scale in f32, round half to
even.  On the card that is kernel `crop_shared_q8`; the plain version is
`grid_sample_shared_q8`.

With `s2d` as well (lav_tpu's `LAV_S2D_CROPS=1` form, `warp_pallas.py:
171-219`) the int8 crops come out space-to-depth, (B, K, Ho/2, Wo/2, 4C)
in (dy, dx, c) channel order, the input form of the crop ResNet's 4x4
stride-1 conv1 (`nn/quant.py::conv2d_int8_s2d`): kernel
`crop_shared_q8_s2d`, the same sums and rounding as `crop_shared_q8`; the
plain version is `grid_sample_shared_q8` followed by `space_to_depth`.
"""

from __future__ import annotations

import ctypes

import torch

from lav_tpu_torch.utils import native


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
    acc = _bilinear_f32(src, grid)
    return torch.clamp(torch.round(acc * inv_s), -127, 127).to(torch.int8)


def space_to_depth(x):
    """(B, K, H, W, C) -> (B, K, H/2, W/2, 4C), channel order (dy, dx, c)
    (lav_tpu `core/warp.py:340-344`)."""
    B, K, H, W, C = x.shape
    x = x.reshape(B, K, H // 2, 2, W // 2, 2, C).permute(0, 1, 2, 4, 3, 5, 6)
    return x.reshape(B, K, H // 2, W // 2, 4 * C)


_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}


def crop_shared(src, grid, q8_x_scale=None, s2d: bool = False):
    """Kernel `crop_shared`: K bilinear crops per batch item from that
    item's own source.  src (B, H, W, C) f32 or bf16, grid (B, K, Ho, Wo, 2)
    f32 -> (B, K, Ho, Wo, C) in src's dtype, or int8 with `q8_x_scale` (a
    0-dim f32 tensor; kernel `crop_shared_q8`), or with `s2d` too int8
    (B, K, Ho/2, Wo/2, 4C) (kernel `crop_shared_q8_s2d`; Ho, Wo even).
    CPU tensors take `grid_sample_shared` / `grid_sample_shared_q8` (+
    `space_to_depth`)."""
    q8 = q8_x_scale is not None
    if s2d and not (q8 and grid.shape[2] % 2 == 0 and grid.shape[3] % 2 == 0):
        raise ValueError(f"crop_shared: s2d needs q8_x_scale and an even "
                         f"crop, got grid {tuple(grid.shape)}")
    if src.device.type == "cpu":
        if q8:
            out = grid_sample_shared_q8(src, grid, inverse_scale(q8_x_scale))
            return space_to_depth(out) if s2d else out
        return grid_sample_shared(src, grid)
    if src.device.type != "cuda" or grid.device != src.device:
        raise ValueError(f"crop_shared: src on {src.device}, grid on "
                         f"{grid.device}; both must be on one CUDA device")
    if src.dtype not in _DTYPES or grid.dtype != torch.float32:
        raise TypeError(f"crop_shared: src {src.dtype} (f32/bf16), grid "
                        f"{grid.dtype} (f32)")
    if src.ndim != 4 or grid.ndim != 5 or grid.shape[0] != src.shape[0] \
            or grid.shape[-1] != 2:
        raise ValueError(f"crop_shared: src {tuple(src.shape)}, grid "
                         f"{tuple(grid.shape)}")
    if not (src.is_contiguous() and grid.is_contiguous()):
        raise ValueError("crop_shared: src and grid must be contiguous")
    B, H, W, C = src.shape
    _, K, Ho, Wo, _ = grid.shape
    if H < 2 or W < 2:
        raise ValueError("crop_shared: source must be at least 2x2")
    out = torch.empty((B, K, Ho // 2, Wo // 2, 4 * C) if s2d else
                      (B, K, Ho, Wo, C),
                      dtype=torch.int8 if q8 else src.dtype,
                      device=src.device)
    vec = 16 // src.element_size()
    if C % vec or src.data_ptr() % 16 or out.data_ptr() % 16:
        vec = 1
    name = ("crop_shared_q8_s2d" if s2d else
            "crop_shared_q8" if q8 else "crop_shared")
    fn = getattr(_lib(), f"{name}_{_DTYPES[src.dtype]}")
    args = [src.data_ptr(), grid.data_ptr(), out.data_ptr()]
    if q8:
        if q8_x_scale.device != src.device:
            raise ValueError("crop_shared: q8_x_scale on "
                             f"{q8_x_scale.device}, src on {src.device}")
        inv_s = inverse_scale(q8_x_scale).reshape(1).contiguous()
        args.append(inv_s.data_ptr())
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream(src.device).cuda_stream
        err = fn(*args, B, H, W, C, K, Ho, Wo, vec, stream)
    native.check(err, name)
    native.LAUNCHES[name] += 1
    return out


def _lib():
    lib = native.load("crop_shared")
    for name, nptr in (("crop_shared_f32", 3), ("crop_shared_bf16", 3),
                       ("crop_shared_q8_f32", 4), ("crop_shared_q8_bf16", 4),
                       ("crop_shared_q8_s2d_f32", 4),
                       ("crop_shared_q8_s2d_bf16", 4)):
        fn = getattr(lib, name)
        if fn.argtypes is None:
            fn.argtypes = ([ctypes.c_void_p] * nptr + [ctypes.c_int] * 8
                           + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
    return lib


def crop_feature_shared(features, rel_locs, rel_oris, *,
                        pixels_per_meter: float, crop_size: int,
                        offset_x: float = 0.0, offset_y: float = 0.75,
                        q8_x_scale=None, s2d: bool = False):
    """K rotated crops from one feature map per batch item.

    features (H, W, C) with rel_locs (K, 2) meters and rel_oris (K,) radians
    -> (K, crop, crop, C); or features (B, H, W, C) with (B, K, 2) / (B, K)
    -> (B, K, crop, crop, C).  One `crop_shared` launch for all crops;
    int8 crops with `q8_x_scale`, space-to-depth (.., crop/2, crop/2, 4C)
    with `s2d` as well (lav_tpu's `q8_s2d`)."""
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
    crops = crop_shared(features.contiguous(), grid, q8_x_scale, s2d)
    return crops[0] if single else crops
