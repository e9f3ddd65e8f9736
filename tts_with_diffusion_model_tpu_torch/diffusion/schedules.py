"""Beta schedules for the discrete diffusion process (copy of
``diffusion/schedules.py`` in the JAX package; numpy, fp64 on the host)."""

from __future__ import annotations

import numpy as np


def cosine_beta_schedule(timesteps: int, s: float = 0.008) -> np.ndarray:
    """Cosine ("Improved DDPM") schedule: returns (timesteps,) β."""
    steps = timesteps + 1
    x = np.linspace(0, steps, steps)
    alphas_cumprod = np.cos(((x / steps) + s) / (1 + s) * np.pi * 0.5) ** 2
    alphas_cumprod = alphas_cumprod / alphas_cumprod[0]
    betas = 1 - (alphas_cumprod[1:] / alphas_cumprod[:-1])
    return np.clip(betas, 0, 0.999)


def linear_beta_schedule(timesteps: int, start: float, stop: float) -> np.ndarray:
    return np.linspace(start, stop, timesteps)


def _vpsde_beta_t(t: int, T: int, min_beta: float, max_beta: float) -> float:
    t_coef = (2 * t - 1) / (T**2)
    return 1.0 - np.exp(-min_beta / T - 0.5 * (max_beta - min_beta) * t_coef)


def vpsde_beta_schedule(
    timesteps: int, min_beta: float = 0.1, max_beta: float = 40
) -> np.ndarray:
    return np.array(
        [_vpsde_beta_t(t, timesteps, min_beta, max_beta) for t in range(1, timesteps + 1)]
    )


def get_schedule(name: str, timesteps: int, **kw) -> np.ndarray:
    if name == "cosine":
        return cosine_beta_schedule(timesteps, **kw)
    if name == "linear":
        return linear_beta_schedule(
            timesteps, kw.get("start", 1e-4), kw.get("stop", 0.02)
        )
    if name == "vpsde":
        return vpsde_beta_schedule(timesteps, **kw)
    raise ValueError(f"Unknown schedule {name!r}")
