"""Row gather (counterpart of the gather probe `scripts/exp_gather.py`).

Hosts kernel `take_along_rows` (csrc/take_along_rows.cu), the port of the
probe's Pallas kernel, `jnp.take_along_axis(x, idx, axis=0)`, with its
contract: an index in [-S, 0) wraps to row idx + S, one outside [-S, S)
gives NaN.  No path of the agent runs it; `chip_smoke.py` phase `gather`
drives it at the probe's shapes.  A CUDA tensor launches the kernel (or
the wrapper raises), a CPU tensor takes the plain version
`take_along_rows_plain`.
"""

from __future__ import annotations

import torch

from lav_tpu_torch.utils import native

_ENTRY = {torch.float32: native.ENTRIES["take_along_rows_b32"],
          torch.bfloat16: native.ENTRIES["take_along_rows_b16"]}


def take_along_rows_plain(x, idx):
    """Plain version of kernel `take_along_rows`: out[i, l] = x[r, l] for
    x (S, L) and idx (M, L) int32, where r = idx[i, l], plus S if it is
    negative; NaN where r is still outside [0, S) (jnp.take_along_axis's
    wrap and fill).  In range the bits move unchanged."""
    S = x.shape[0]
    r = idx.long()
    r = torch.where(r < 0, r + S, r)
    outside = (r < 0) | (r >= S)
    if S == 0:
        return torch.full(idx.shape, float("nan"), dtype=x.dtype,
                          device=x.device)
    out = torch.gather(x, 0, r.clamp(0, S - 1))
    return out.masked_fill(outside, float("nan"))


def kernel_entry(x, idx):
    """The C entry that takes (x, idx) as they are, or None: both on one
    CUDA device, contiguous, x (S, L) f32 or bf16 and idx (M, L) int32.
    The wrapper's one test on its fast path."""
    entry = _ENTRY.get(x.dtype)
    xs, ids = x.shape, idx.shape
    if (x.is_cuda and entry is not None and idx.dtype is torch.int32
            and len(xs) == 2 and len(ids) == 2 and ids[1] == xs[1]
            and idx.get_device() == x.get_device() and x.is_contiguous()
            and idx.is_contiguous()):
        return entry
    return None


def take_along_rows(x, idx):
    """Kernel `take_along_rows` (contract of `take_along_rows_plain`): x
    (S, L) f32 or bf16, idx (M, L) int32 -> (M, L) in x's dtype.  CPU
    tensors take the plain version; other tensors that `kernel_entry`
    refuses raise."""
    entry = kernel_entry(x, idx)
    if entry is None:
        if x.device.type == "cpu":
            return take_along_rows_plain(x, idx)
        _refuse(x, idx)
    xs, ids = x.shape, idx.shape
    # the cheapest allocation of the same tensor (chip_smoke.py phase
    # `gather` times the options)
    out = torch.empty_like(idx, dtype=x.dtype)
    native.launch(entry, x.get_device(), x.data_ptr(), idx.data_ptr(),
                  out.data_ptr(), xs[0], ids[0], xs[1])
    return out


def _refuse(x, idx):
    if x.device.type != "cuda" or idx.device != x.device:
        raise ValueError(f"take_along_rows: x on {x.device}, idx on "
                         f"{idx.device}; both must be on one CUDA device")
    if x.dtype not in _ENTRY or idx.dtype != torch.int32:
        raise TypeError(f"take_along_rows: x {x.dtype} (f32/bf16), idx "
                        f"{idx.dtype} (int32)")
    if x.ndim != 2 or idx.ndim != 2 or idx.shape[1] != x.shape[1]:
        raise ValueError(f"take_along_rows: x {tuple(x.shape)}, idx "
                         f"{tuple(idx.shape)}")
    raise ValueError("take_along_rows: inputs must be contiguous")
