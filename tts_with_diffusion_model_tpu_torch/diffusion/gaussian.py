"""Continuous Gaussian DDPM core (counterpart of ``diffusion/gaussian.py`` in
the JAX package): the closed-form terms, the forward corruption, the
ancestral reverse step from an ε-prediction, and both decode domains
(normalized token values, nearest embedding).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .schedules import get_schedule


@dataclasses.dataclass(frozen=True)
class GaussianDiffusion:
    """Closed-form DDPM terms: computed in float64 on the host, stored as
    float32 tensors (on the CPU; ``_gather`` moves them to ``t``'s device)."""

    timesteps: int
    betas: torch.Tensor
    alphas: torch.Tensor
    alphas_cumprod: torch.Tensor
    alphas_cumprod_prev: torch.Tensor
    sqrt_recip_alphas: torch.Tensor
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor
    posterior_variance: torch.Tensor

    @classmethod
    def create(cls, timesteps: int = 100, schedule: str = "cosine", **kw):
        betas = np.asarray(get_schedule(schedule, timesteps, **kw), np.float64)
        alphas = 1.0 - betas
        ac = np.cumprod(alphas)
        ac_prev = np.concatenate([[1.0], ac[:-1]])
        post_var = betas * (1.0 - ac_prev) / (1.0 - ac)

        def f(x):
            return torch.tensor(np.asarray(x, np.float32))

        return cls(
            timesteps=timesteps,
            betas=f(betas),
            alphas=f(alphas),
            alphas_cumprod=f(ac),
            alphas_cumprod_prev=f(ac_prev),
            sqrt_recip_alphas=f(np.sqrt(1.0 / alphas)),
            sqrt_alphas_cumprod=f(np.sqrt(ac)),
            sqrt_one_minus_alphas_cumprod=f(np.sqrt(1.0 - ac)),
            posterior_variance=f(post_var),
        )

    @staticmethod
    def _gather(a: torch.Tensor, t: torch.Tensor, ndim: int) -> torch.Tensor:
        return a.to(t.device)[t.long()].reshape(t.shape[0], *([1] * (ndim - 1)))

    def q_sample(self, x0, t, noise):
        """x_t = √ᾱ_t·x₀ + √(1−ᾱ_t)·ε."""
        s1 = self._gather(self.sqrt_alphas_cumprod, t, x0.ndim)
        s2 = self._gather(self.sqrt_one_minus_alphas_cumprod, t, x0.ndim)
        return s1 * x0 + s2 * noise

    def p_sample(self, eps_pred, x_t, t, noise, clip: float | None = None):
        """Ancestral reverse step: μ = 1/√α_t (x_t − β_t/√(1−ᾱ_t)·ε̂),
        clipped to ±``clip`` when given, plus √posterior_var·z where t > 0."""
        nd = x_t.ndim
        sra = self._gather(self.sqrt_recip_alphas, t, nd)
        beta = self._gather(self.betas, t, nd)
        som = self._gather(self.sqrt_one_minus_alphas_cumprod, t, nd)
        pv = self._gather(self.posterior_variance, t, nd)
        mean = sra * (x_t - beta / som * eps_pred)
        if clip is not None:
            mean = mean.clamp(-clip, clip)
        nonzero = (t > 0).to(x_t.dtype).reshape(-1, *([1] * (nd - 1)))
        return mean + nonzero * torch.sqrt(pv) * noise


def normalize_tokens(x: torch.Tensor, num_tokens: int) -> torch.Tensor:
    """ints [0, V) → [-1, 1]."""
    return x.float() / (num_tokens - 1) * 2.0 - 1.0


def denormalize_tokens(x: torch.Tensor, num_tokens: int) -> torch.Tensor:
    """[-1, 1] → ints [0, V); ``torch.round`` rounds half to even, as
    ``jnp.round`` does."""
    ids = torch.round((x + 1.0) / 2.0 * (num_tokens - 1))
    return ids.clamp(0, num_tokens - 1).long()


def nearest_embedding(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Nearest-embedding token decode: argmin over the table of ‖e‖² − 2 x·e
    in fp32.  x: (..., D); table: (V, D) → (...,) int64."""
    tf = table.float()
    dots = torch.einsum("...d,vd->...v", x.float(), tf)
    sq = (tf ** 2).sum(dim=-1)
    return torch.argmin(sq - 2.0 * dots, dim=-1)
