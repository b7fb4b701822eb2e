"""Row gather (counterpart of the gather probe `scripts/exp_gather.py`).

Hosts kernel `take_along_rows` (csrc/take_along_rows.cu), the port of the
probe's Pallas kernel, `jnp.take_along_axis(x, idx, axis=0)`.  No path of
the agent runs it; `chip_smoke.py` phase `gather` drives it at the probe's
shapes.  A CUDA tensor launches the kernel (or the wrapper raises), a CPU
tensor takes the plain version `take_along_rows_plain`.
"""

from __future__ import annotations

import torch

from lav_tpu_torch.utils import native

_ENTRY = {torch.float32: native.ENTRIES["take_along_rows_b32"],
          torch.bfloat16: native.ENTRIES["take_along_rows_b16"]}


def take_along_rows_plain(x, idx):
    """Plain version of kernel `take_along_rows`: out[i, l] = x[idx[i, l],
    l] for x (S, L) and idx (M, L) int32 in [0, S)."""
    return torch.gather(x, 0, idx.long())


def take_along_rows(x, idx):
    """Kernel `take_along_rows` (contract of `take_along_rows_plain`): x
    (S, L) f32 or bf16, idx (M, L) int32 -> (M, L) in x's dtype; on the
    card an index outside [0, S) gives 0.  CPU tensors take the plain
    version."""
    entry = _ENTRY.get(x.dtype)
    xs, ids = x.shape, idx.shape
    dev = x.get_device()
    # one test on the fast path; _refuse says what is wrong
    if not (x.is_cuda and entry is not None and idx.dtype is torch.int32
            and len(xs) == 2 and len(ids) == 2 and ids[1] == xs[1]
            and idx.get_device() == dev and x.is_contiguous()
            and idx.is_contiguous()):
        if x.device.type == "cpu":
            return take_along_rows_plain(x, idx)
        _refuse(x, idx)
    out = x.new_empty(ids)
    native.launch(entry, dev, x.data_ptr(), idx.data_ptr(), out.data_ptr(),
                  xs[0], ids[0], xs[1])
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
