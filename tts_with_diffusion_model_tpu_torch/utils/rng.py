"""Per-row random streams for batched sampling (counterpart of
``utils/rng.py`` in the JAX package).

A request's sampling noise depends only on its own seed, never on its batch
cohort: every row carries its own 64-bit key, a stage or step is selected by
folding a tag into each row's key, and every draw is made row by row from a
``torch.Generator`` seeded with that row's folded key.  Torch cannot
reproduce JAX's threefry streams, so parity with the JAX package is defined
under injected noise: samplers take any object with this class's ``fold`` /
``gumbel`` / ``uniform`` / ``normal`` methods, and the tests hand both
packages the same numbers.
"""

from __future__ import annotations

import torch

_MASK = (1 << 64) - 1


def _mix(x: int) -> int:
    """splitmix64 finaliser: a bijective scramble of a 64-bit integer."""
    x = (x + 0x9E3779B97F4A7C15) & _MASK
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK
    return x ^ (x >> 31)


class RowKeys:
    """One 64-bit key per batch row."""

    def __init__(self, keys):
        self.keys = [int(k) & _MASK for k in keys]

    @classmethod
    def from_seeds(cls, seeds) -> "RowKeys":
        """(B,) request seeds → per-row keys."""
        return cls(_mix(int(s) & _MASK) for s in seeds)

    def fold(self, tag: int) -> "RowKeys":
        """Fold a tag (stage id, step index, level) into every row key."""
        t = _mix((int(tag) & _MASK) ^ 0xD1B54A32D192ED03)
        return RowKeys(_mix(k ^ t) for k in self.keys)

    def _generators(self, device):
        out = []
        for k in self.keys:
            g = torch.Generator(device=device)
            g.manual_seed(k & ((1 << 63) - 1))
            out.append(g)
        return out

    def uniform(self, shape, device="cpu") -> torch.Tensor:
        """(B, *shape) fp32 uniforms in [0, 1); row i depends only on key i."""
        shape = tuple(shape)
        return torch.stack([
            torch.rand(shape, generator=g, device=device, dtype=torch.float32)
            for g in self._generators(device)
        ])

    def normal(self, shape, device="cpu") -> torch.Tensor:
        """(B, *shape) fp32 standard normals, row by row (the Gaussian
        family's initial noise and reverse-step draws)."""
        shape = tuple(shape)
        return torch.stack([
            torch.randn(shape, generator=g, device=device, dtype=torch.float32)
            for g in self._generators(device)
        ])

    def gumbel(self, shape, device="cpu") -> torch.Tensor:
        """(B, *shape) fp32 standard Gumbel noise, row by row."""
        u = self.uniform(shape, device)
        tiny = torch.finfo(torch.float32).tiny
        return -torch.log(-torch.log(u.clamp_min(tiny)))
