"""The part of the D3PM process that MaskGIT decoding and the training loss
read (counterpart of ``diffusion/d3pm.py`` in the JAX package): the
cumulative transition scalars, the absorbing state, the number of timesteps
and the forward corruption ``q_sample``.

Both rank-one transition families have ``Q̄_t = c_t·I + d_t·(absorb or
uniform)``; ``cum_off[t] = d_t`` is the probability that a token has been
absorbed by step t.  The dense ``from_matrices`` family, the posterior and
the ancestral sampler are not ported yet.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .schedules import get_schedule


@dataclasses.dataclass(frozen=True)
class D3PM:
    timesteps: int
    num_classes: int
    transition: str
    betas: np.ndarray      # (T+1,) float32
    cum_diag: np.ndarray   # (T,) float32, c_t
    cum_off: np.ndarray    # (T,) float32, d_t
    eps: float = 1e-6

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

    def _cum_row(self, t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """Row x of Q̄_t: c_t·e_x + the off-diagonal term, (B, W, V) fp32."""
        c = torch.as_tensor(self.cum_diag, device=x.device)[t][:, None, None]
        d = torch.as_tensor(self.cum_off, device=x.device)[t][:, None, None]
        row = c * torch.nn.functional.one_hot(x, self.num_classes).float()
        if self.transition == "absorbing":
            row[..., self.absorbing_state] += d[..., 0]
            return row
        return row + d / self.num_classes

    def q_probs(self, x_start: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """q(x_t | x_0) rows for integer x_0 (B, W) at timesteps t (B,)."""
        return self._cum_row(t, x_start)

    def q_sample(self, x_start: torch.Tensor, t: torch.Tensor,
                 uniform_noise: torch.Tensor | None = None,
                 generator: torch.Generator | None = None) -> torch.Tensor:
        """Sample x_t ~ q(x_t | x_0) by Gumbel-argmax over log(q + eps).
        ``uniform_noise`` (B, W, V) in [0, 1) is injected, else drawn from
        ``generator`` on x_start's device."""
        logits = torch.log(self.q_probs(x_start, t) + self.eps)
        if uniform_noise is None:
            if generator is None:
                raise ValueError("q_sample needs uniform_noise or a generator")
            uniform_noise = torch.rand(logits.shape, generator=generator,
                                       device=logits.device, dtype=torch.float32)
        noise = uniform_noise.float().clamp(torch.finfo(torch.float32).tiny, 1.0)
        gumbel = -torch.log(-torch.log(noise))
        return torch.argmax(logits + gumbel, dim=-1)
