"""Device selection for the port's entry points.

Entry points run on the card unless the caller asks for the CPU.  A request
for `cuda` on a machine without a card raises: nothing moves to the CPU on
its own.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`None` means `cuda`; raises if CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "a CUDA device was requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the port on the CPU"
        )
    return dev
