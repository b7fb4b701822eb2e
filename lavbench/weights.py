"""Weights made on the device from the seed, in one large draw.

The reference's models (`ref/`) are built with a `Draw` in place of a
`torch.Generator`: each initialiser takes its slice of one uniform draw
made on the device, scaled to its bound: He's uniform for the conv and
linear weights, the port's bounds for biases, GRU weights and the stacked
output linears, a normal attention query.  The program's models then load
the reference's state, so both sides start from the same numbers.
"""

from __future__ import annotations

import torch


class Draw:
    """Slices of one uniform draw of `total` numbers on `device`, made
    from `seed`.  A first pass with `total=None` only counts (the models
    are built on the meta device); `Draw.make` runs both passes."""

    def __init__(self, seed: int, device, total=None):
        self.device = torch.device(device)
        self.used = 0
        self.flat = None
        if total is not None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            self.flat = torch.rand(total, generator=gen, device=self.device)

    def _take(self, shape):
        n = 1
        for s in shape:
            n *= int(s)
        if self.flat is None:
            self.used += n
            return torch.empty(shape, device="meta")
        piece = self.flat[self.used:self.used + n].view(*shape)
        self.used += n
        return piece

    def uniform(self, shape, bound: float):
        u = self._take(shape)
        return u if u.is_meta else (u * 2.0 - 1.0) * bound

    def weight(self, shape, fan_in: int):
        """A conv or linear weight: He's uniform, bound sqrt(6 / fan_in),
        which keeps the size of the signal through a ReLU layer, so that
        the outputs of the deep random nets still depend on their inputs
        (with the port's kaiming-uniform(a=sqrt(5)) bound each layer
        shrinks it threefold and the heads return their biases)."""
        return self.uniform(shape, (6.0 / fan_in) ** 0.5)

    def normal(self, shape):
        """Standard normal numbers from two uniform slices (Box-Muller)."""
        u1, u2 = self._take(shape), self._take(shape)
        if u1.is_meta:
            return u1
        return torch.sqrt(-2.0 * torch.log1p(-u1)) * torch.cos(
            2.0 * torch.pi * u2)

    @staticmethod
    def make(build, seed: int, device):
        """build(draw) -> module, called twice: on the meta device to count
        the numbers, then on `device` with them drawn."""
        counter = Draw(seed, "meta")
        with torch.device("meta"):
            build(counter)
        draw = Draw(seed, device, counter.used)
        with torch.device(device):
            module = build(draw)
        if draw.used != counter.used:
            raise RuntimeError(f"weights: {draw.used} numbers taken, "
                               f"{counter.used} counted")
        return module
