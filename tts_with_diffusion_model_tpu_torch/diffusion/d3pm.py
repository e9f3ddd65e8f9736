"""The part of the D3PM process that MaskGIT decoding reads (counterpart of
``diffusion/d3pm.py`` in the JAX package): the cumulative transition
scalars, the absorbing state and the number of timesteps.

Both rank-one transition families have ``Q̄_t = c_t·I + d_t·(absorb or
uniform)``; ``cum_off[t] = d_t`` is the probability that a token has been
absorbed by step t.  The posterior and the ancestral sampler are not ported
yet.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .schedules import get_schedule


@dataclasses.dataclass(frozen=True)
class D3PM:
    timesteps: int
    num_classes: int
    transition: str
    betas: np.ndarray      # (T+1,) float32
    cum_diag: np.ndarray   # (T,) float32, c_t
    cum_off: np.ndarray    # (T,) float32, d_t

    @property
    def absorbing_state(self) -> int:
        return self.num_classes // 2

    @classmethod
    def create(cls, timesteps: int = 100, num_classes: int = 1025,
               schedule: str = "cosine", transition: str = "absorbing") -> "D3PM":
        betas = np.asarray(get_schedule(schedule, timesteps + 1), np.float64)
        b = betas[:timesteps]
        c = np.cumprod(1.0 - b)
        d = np.empty_like(c)
        d[0] = b[0]
        for t in range(1, timesteps):
            d[t] = c[t - 1] * b[t] + d[t - 1]
        if not np.allclose(c + d, 1.0):
            raise ValueError("cumulative transition rows must sum to 1")
        return cls(
            timesteps=timesteps,
            num_classes=num_classes,
            transition=transition,
            betas=betas.astype(np.float32),
            cum_diag=c.astype(np.float32),
            cum_off=d.astype(np.float32),
        )
