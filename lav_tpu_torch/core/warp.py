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

Training differentiates the f32 or bf16 crop with respect to its source
only, as lav_tpu's custom VJP `_grid_sample_shared_bwd`
(`core/warp.py:213-229`) does: `CropShared` is the autograd Function
around `crop_shared`, and its backward is kernel `crop_shared_bwd`
(csrc/crop_shared_bwd.cu) on the card, `grid_sample_shared_bwd` on the
CPU: each output pixel's gradient, times each tap's hinge weight, is
added into the source's gradient at the tap; the grid gets none.  In bf16
the weight and each product are rounded to bf16 as in lav_tpu, and the
sum is taken in f32 and rounded once.  The kernel computes it as a gather (each
source cell sums the output pixels that reach it, found through an affine
fit of each crop's grid, `crop_bwd_map`; a tile of cells tests the pixels
of its window, `crop_bwd_tile_window`, once), with no atomics and in a
fixed order.
"""

from __future__ import annotations

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
    if native.EXPORTING:
        if not q8:
            return _OPS["crop_shared"](src, grid)
        return _OPS["crop_shared_q8_s2d" if s2d else "crop_shared_q8"](
            src, grid, q8_x_scale)
    return _crop_shared(src, grid, q8_x_scale, s2d)


def _crop_shared(src, grid, q8_x_scale=None, s2d: bool = False):
    q8 = q8_x_scale is not None
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
    args = [src.data_ptr(), grid.data_ptr(), out.data_ptr()]
    if q8:
        if q8_x_scale.device != src.device:
            raise ValueError("crop_shared: q8_x_scale on "
                             f"{q8_x_scale.device}, src on {src.device}")
        inv_s = inverse_scale(q8_x_scale).reshape(1).contiguous()
        args.append(inv_s.data_ptr())
    native.launch(native.ENTRIES[f"{name}_{_DTYPES[src.dtype]}"],
                  src.get_device(), *args, B, H, W, C, K, Ho, Wo, vec)
    return out


def grid_sample_shared_bwd(g, grid, H: int, W: int):
    """Plain version of kernel `crop_shared_bwd`: g (B, K, Ho, Wo, C) f32
    or bf16, grid (B, K, Ho, Wo, 2) f32 -> d_src (B, H, W, C) in g's
    dtype, the four taps of each output pixel added in turn (lav_tpu's
    `_grid_sample_shared_bwd`).  In bf16 each tap's f32 weight is rounded
    to bf16 and each product g * weight to bf16, as lav_tpu rounds them;
    the products are summed in f32 and rounded to bf16 once (lav_tpu sums
    them in bf16)."""
    B, K, Ho, Wo, C = g.shape
    ix = (grid[..., 0] + 1.0) * 0.5 * (W - 1)
    iy = (grid[..., 1] + 1.0) * 0.5 * (H - 1)
    x0 = torch.clamp(torch.floor(ix), 0, W - 2)
    y0 = torch.clamp(torch.floor(iy), 0, H - 2)
    wy = [torch.clamp(1.0 - torch.abs(iy - (y0 + d)), min=0.0) for d in (0, 1)]
    wx = [torch.clamp(1.0 - torch.abs(ix - (x0 + d)), min=0.0) for d in (0, 1)]
    base = ((torch.arange(B, device=g.device)[:, None] * (H * W))
            + (y0.long() * W + x0.long()).reshape(B, -1)).reshape(-1)
    g_flat = g.reshape(-1, C)
    d_src = g.new_zeros((B * H * W, C), dtype=torch.float32)
    for dy in (0, 1):
        for dx in (0, 1):
            w = (wy[dy] * wx[dx]).reshape(-1, 1)
            if g.dtype == torch.float32:
                term = g_flat * w
            else:
                term = (g_flat * w.to(g.dtype)).float()
            d_src.index_add_(0, base + (dy * W + dx), term)
    return d_src.reshape(B, H, W, C).to(g.dtype)


def crop_bwd_map(grid, H: int, W: int):
    """Plain version of kernel `crop_shared_bwd`'s first pass: per crop
    of grid (B, K, Ho, Wo, 2) -> (B * K, 8) f32 (inv00, inv01, inv10,
    inv11, ox, oy, hu, hv).  The crop's positions (ix, iy), in source
    pixels as the forward computes them, are fitted by an affine function
    of the output pixel (u, v) through three corners of the grid (in
    float64); `dev` is the largest distance of any position from the fit.
    The fit's inverse maps a source cell (x, y) to the centre of its
    candidate window, hu and hv are the window's half sides: the inverse
    image of the square of half side 1 + dev (+ 1e-3) around the cell,
    widened by one output pixel.  A degenerate fit (|det| <= 1e-9 of its
    scale, a 1-pixel side, a non-finite position) gives hu = hv = inf
    (every output pixel a candidate) and zeros elsewhere."""
    B, K, Ho, Wo, _ = grid.shape
    ix = (grid[..., 0] + 1.0) * 0.5 * (W - 1)
    iy = (grid[..., 1] + 1.0) * 0.5 * (H - 1)
    pos = torch.stack([ix, iy], -1).reshape(B * K, Ho, Wo, 2).double()
    p00, p10, p01 = pos[:, 0, 0], pos[:, 0, -1], pos[:, -1, 0]
    du = (p10 - p00) / (Wo - 1) if Wo > 1 else torch.zeros_like(p00)
    dv = (p01 - p00) / (Ho - 1) if Ho > 1 else torch.zeros_like(p00)
    v, u = torch.meshgrid(
        torch.arange(Ho, dtype=torch.float64, device=grid.device),
        torch.arange(Wo, dtype=torch.float64, device=grid.device),
        indexing="ij")
    fit = (p00[:, None, None] + du[:, None, None] * u[..., None]
           + dv[:, None, None] * v[..., None])
    miss = (pos - fit).abs().amax(-1).reshape(B * K, -1)
    dev = torch.where(torch.isnan(miss).any(-1), torch.inf, miss.amax(-1))
    a, c = du[:, 0], du[:, 1]
    b, d = dv[:, 0], dv[:, 1]
    det = a * d - b * c
    scale = (a.abs() + b.abs()) * (c.abs() + d.abs())
    ok = (torch.isfinite(dev) & torch.isfinite(det) & torch.isfinite(scale)
          & (det.abs() > 1e-9 * scale) & torch.isfinite(p00).all(-1))
    inv = torch.stack([d, -b, -c, a], -1) / det[:, None]
    r = 1.0 + dev + 1e-3
    hu = r * (inv[:, 0].abs() + inv[:, 1].abs()) + 1.0
    hv = r * (inv[:, 2].abs() + inv[:, 3].abs()) + 1.0
    out = torch.cat([inv, p00, hu[:, None], hv[:, None]], -1).float()
    bad = torch.tensor([0.0] * 6 + [torch.inf] * 2, device=out.device)
    return torch.where(ok[:, None], out, bad)


def _bwd_centre(cmap, x, y):
    """The centre of source cell (x, y)'s candidate window in each crop of
    cmap, the fit's inverse at the cell, rounded as the kernel rounds it
    (each product, then the sum, in f32)."""
    i00, i01, i10, i11, ox, oy = cmap.unbind(-1)[:6]
    dx, dy = x.float() - ox, y.float() - oy
    return i00 * dx + i01 * dy, i10 * dx + i11 * dy


def _bwd_box(cmap, ulo, uhi, vlo, vhi, Ho: int, Wo: int):
    """The output pixels within (hu, hv) of centres in [ulo, uhi] x [vlo,
    vhi], clamped to the crop, as int64 (u0, u1, v0, v1)."""
    hu, hv = cmap[..., 6], cmap[..., 7]
    u0 = torch.clamp(torch.ceil(ulo - hu), min=0.0)
    u1 = torch.clamp(torch.floor(uhi + hu), max=float(Wo - 1))
    v0 = torch.clamp(torch.ceil(vlo - hv), min=0.0)
    v1 = torch.clamp(torch.floor(vhi + hv), max=float(Ho - 1))
    big = float(max(Ho, Wo) + 1)   # an infinite side, held in int64
    return tuple(torch.clamp(t, -big, big).long() for t in (u0, u1, v0, v1))


def crop_bwd_window(cmap, x, y, Ho: int, Wo: int):
    """The candidate window of source cell (x, y) (tensors of one shape,
    broadcast against cmap's crops (n, 8)) in f32, as kernel
    `crop_shared_bwd` rounds it -> (u0, u1, v0, v1) int64, inclusive and
    clamped to the crop; empty where u0 > u1 or v0 > v1.  Every tap of
    weight above 0 on the cell lies in it."""
    uc, vc = _bwd_centre(cmap, x, y)
    return _bwd_box(cmap, uc, uc, vc, vc, Ho, Wo)


# csrc/crop_shared_bwd.cu's kTileX, kTileY: the cells of d_src a block owns
CROP_BWD_TILE = (4, 4)


def crop_bwd_tile_window(cmap, xa, xb, ya, yb, Ho: int, Wo: int):
    """The candidate window of the tile of source cells [xa, xb] x [ya,
    yb] (inclusive; tensors broadcast as `crop_bwd_window`'s), as kernel
    `crop_shared_bwd` computes it in f32: the union of its cells' windows,
    which is the box of its four corner cells' (each rounded step of a
    centre is monotone in x and in y, and so are ceil and floor) ->
    (u0, u1, v0, v1) int64, inclusive and clamped to the crop."""
    us, vs = zip(*(_bwd_centre(cmap, x, y) for x in (xa, xb)
                   for y in (ya, yb)))
    us, vs = torch.stack(us), torch.stack(vs)
    return _bwd_box(cmap, us.amin(0), us.amax(0), vs.amin(0), vs.amax(0),
                    Ho, Wo)


def crop_shared_bwd(g, grid, H: int, W: int):
    """Kernel `crop_shared_bwd` (contract of `grid_sample_shared_bwd`):
    the source gradient of `crop_shared`, f32 or bf16 g, as a gather: each
    cell of d_src sums, in a fixed order and in f32, the output pixels
    whose taps reach it, and is written once (so d_src is not zeroed
    first, and two calls give the same bits).  A tile of CROP_BWD_TILE
    cells tests each output pixel of its window once; the window comes
    from an affine fit of each crop's grid (`crop_bwd_map`, always in f32;
    `crop_bwd_tile_window`), as `affine_grid` makes every crop's grid; a
    grid that is not affine is still right (the fit's largest miss widens
    the window, up to every output pixel), only slower.  A tap of weight 0 is skipped (it
    adds g * 0 = 0 for a finite g).  CPU tensors take the plain version;
    on the card any other dtype raises."""
    if g.device.type == "cpu":
        return grid_sample_shared_bwd(g, grid, H, W)
    if g.device.type != "cuda" or grid.device != g.device:
        raise ValueError(f"crop_shared_bwd: g on {g.device}, grid on "
                         f"{grid.device}; both must be on one CUDA device")
    if g.dtype not in _DTYPES or grid.dtype != torch.float32:
        raise TypeError(f"crop_shared_bwd: g {g.dtype} (f32/bf16), grid "
                        f"{grid.dtype} (f32)")
    if g.ndim != 5 or grid.shape != g.shape[:4] + (2,) or H < 2 or W < 2:
        raise ValueError(f"crop_shared_bwd: g {tuple(g.shape)}, grid "
                         f"{tuple(grid.shape)}, source {H}x{W}")
    if not (g.is_contiguous() and grid.is_contiguous()):
        raise ValueError("crop_shared_bwd: g and grid must be contiguous")
    B, K, Ho, Wo, C = g.shape
    d_src = g.new_empty((B, H, W, C))
    cmap = torch.empty((max(B * K, 1), 8), dtype=torch.float32,
                       device=g.device)
    vec = 16 // g.element_size()   # channels in a 16-byte vector
    if C % vec or g.data_ptr() % 16:
        vec = 1
    native.launch(native.ENTRIES[f"crop_shared_bwd_{_DTYPES[g.dtype]}"],
                  g.get_device(), g.data_ptr(), grid.data_ptr(),
                  d_src.data_ptr(), cmap.data_ptr(), B, H, W, C, K, Ho, Wo,
                  vec)
    return d_src


def _crop_op(q8: bool, s2d: bool):
    """crop_shared's form as a custom op's implementation and fake."""
    if q8:
        def impl(src: torch.Tensor, grid: torch.Tensor,
                 x_scale: torch.Tensor) -> torch.Tensor:
            return _crop_shared(src, grid, x_scale, s2d)
    else:
        def impl(src: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
            return _crop_shared(src, grid)

    def fake(src, grid, *x_scale):
        B, K, Ho, Wo, _ = grid.shape
        C = src.shape[-1]
        return src.new_empty((B, K, Ho // 2, Wo // 2, 4 * C) if s2d else
                             (B, K, Ho, Wo, C),
                             dtype=torch.int8 if q8 else src.dtype)
    return impl, fake


# the crops as custom ops (`native.custom_op`), for export
_OPS = {name: native.custom_op(name, *_crop_op(q8, s2d))
        for name, q8, s2d in (("crop_shared", False, False),
                              ("crop_shared_q8", True, False),
                              ("crop_shared_q8_s2d", True, True))}


class CropShared(torch.autograd.Function):
    """`crop_shared(src, grid)` with a gradient for the f32 or bf16 source
    (`crop_shared_bwd`, in the gradient's dtype); the grid gets none, as
    in lav_tpu."""

    @staticmethod
    def forward(ctx, src, grid):
        ctx.save_for_backward(grid)
        ctx.hw = src.shape[1:3]
        return crop_shared(src, grid)

    @staticmethod
    def backward(ctx, g):
        (grid,) = ctx.saved_tensors
        return crop_shared_bwd(g.contiguous(), grid, *ctx.hw), None


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
    if features.requires_grad and torch.is_grad_enabled():
        if q8_x_scale is not None:
            raise ValueError("crop_feature_shared: int8 crops have no "
                             "gradient")
        crops = CropShared.apply(features.contiguous(), grid)
    else:
        crops = crop_shared(features.contiguous(), grid, q8_x_scale, s2d)
    return crops[0] if single else crops


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
