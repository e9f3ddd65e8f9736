"""The D3PM discrete-state diffusion process (counterpart of
``diffusion/d3pm.py`` in the JAX package): the transition families, the
forward corruption ``q_sample``, the posterior ``q(x_{t-1} | x_t, x_0)`` and
the ancestral sampler, one process step at a time (``p_sample``) or over a
stride of steps (``p_sample_strided``).

Both structured families are rank one and closed under products,
``Q̄_t = c_t·I + d_t·(absorb or uniform)``; ``cum_diag[t] = c_t`` and
``cum_off[t] = d_t`` (the probability that a token has been absorbed by
step t), so every row and mix is O(V) vector work; the dense one-step
matrices of both families are ``absorbing_transition_mat`` and
``uniform_transition_mat`` (numpy, float64).  ``from_matrices`` takes
arbitrary dense one-step matrices instead ("dense"), and the ops then index
them.  Every sampling step takes explicit uniform noise or a generator, so
parity with the JAX package is tested under injected noise.  The posterior
is computed in fp32.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .schedules import get_schedule

_TINY = torch.finfo(torch.float32).tiny


def _gumbel(uniform_noise: torch.Tensor) -> torch.Tensor:
    noise = uniform_noise.float().clamp(_TINY, 1.0)
    return -torch.log(-torch.log(noise))


def _per_row(t: torch.Tensor, ndim: int) -> torch.Tensor:
    """(B,) → (B, 1, …, 1) with ``ndim`` dimensions."""
    return t.reshape(t.shape[0], *([1] * (ndim - 1)))


def absorbing_transition_mat(beta_t: float, num_classes: int) -> np.ndarray:
    """Dense float64 one-step Q_t with an absorbing state at ``num_classes //
    2``: (1 − β_t)·I plus β_t in the absorbing column."""
    mat = np.diag(np.full(num_classes, 1.0 - beta_t, dtype=np.float64))
    mat[:, num_classes // 2] += beta_t
    return mat


def uniform_transition_mat(beta_t: float, num_classes: int) -> np.ndarray:
    """Dense float64 one-step uniform-corruption Q_t: β_t / V off the
    diagonal, 1 − β_t·(V − 1) / V on it."""
    mat = np.full((num_classes, num_classes), beta_t / num_classes, dtype=np.float64)
    np.fill_diagonal(mat, 1.0 - beta_t * (num_classes - 1) / num_classes)
    return mat


@dataclasses.dataclass(frozen=True)
class D3PM:
    timesteps: int
    num_classes: int
    transition: str                       # "absorbing" | "uniform" | "dense"
    betas: np.ndarray                     # (T+1,) float32; Q_t uses betas[t]
    cum_diag: np.ndarray | None = None    # (T,) float32, c_t
    cum_off: np.ndarray | None = None     # (T,) float32, d_t
    q_onestep: np.ndarray | None = None   # dense (T, V, V) float32
    q_cum: np.ndarray | None = None       # dense (T, V, V) float32
    eps: float = 1e-6
    #: the constants as tensors, by (name, device)
    _consts: dict = dataclasses.field(default_factory=dict, compare=False, repr=False)

    @property
    def absorbing_state(self) -> int:
        return self.num_classes // 2

    # ---------------- constructors ----------------

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

    @classmethod
    def from_matrices(cls, betas: np.ndarray, q_onestep: np.ndarray) -> "D3PM":
        """Arbitrary dense one-step matrices (T, V, V); the cumulative
        products are taken in fp64 and both stacks stored in fp32."""
        q_onestep = np.asarray(q_onestep)
        T, V, _ = q_onestep.shape
        q_cum = np.empty(q_onestep.shape, np.float64)
        q_cum[0] = q_onestep[0]
        for t in range(1, T):
            q_cum[t] = q_cum[t - 1] @ q_onestep[t]
        return cls(timesteps=T, num_classes=V, transition="dense",
                   betas=np.asarray(betas, np.float32),
                   q_onestep=q_onestep.astype(np.float32), q_cum=q_cum.astype(np.float32))

    def _const(self, name: str, device) -> torch.Tensor:
        """A process constant as an fp32 tensor on ``device`` (cached)."""
        key = (name, str(torch.device(device)))
        out = self._consts.get(key)
        if out is None:
            out = torch.as_tensor(np.asarray(getattr(self, name), np.float32), device=device)
            self._consts[key] = out
        return out

    # ---------------- dense views (verification / the dense family) ----------------

    def _structured_mats(self, cum: bool) -> np.ndarray:
        """The structured family's (T, V, V) matrices in fp64: Q̄_t when
        ``cum``, else Q_t."""
        b = np.asarray(self.betas[: self.timesteps], np.float64)
        if cum:
            diag = np.asarray(self.cum_diag, np.float64)
            off = np.asarray(self.cum_off, np.float64)
        else:
            diag, off = 1.0 - b, b
        V = self.num_classes
        out = np.zeros((self.timesteps, V, V))
        idx = np.arange(V)
        out[:, idx, idx] = diag[:, None]
        if self.transition == "absorbing":
            out[:, :, V // 2] += off[:, None]
        else:  # uniform: the off mass spread over J/V
            out += (off / V)[:, None, None]
        return out

    @property
    def q_onestep_mats(self) -> torch.Tensor:
        """(T, V, V) fp32 one-step matrices Q_t (on the CPU)."""
        if self.q_onestep is not None:
            return torch.as_tensor(self.q_onestep)
        return torch.as_tensor(self._structured_mats(cum=False), dtype=torch.float32)

    @property
    def q_mats(self) -> torch.Tensor:
        """(T, V, V) fp32 cumulative matrices Q̄_t (on the CPU)."""
        if self.q_cum is not None:
            return torch.as_tensor(self.q_cum)
        return torch.as_tensor(self._structured_mats(cum=True), dtype=torch.float32)

    @property
    def transpose_q_onestep_mats(self) -> torch.Tensor:
        return self.q_onestep_mats.transpose(1, 2)

    # ---------------- structured row helpers ----------------

    def _onehot(self, x: torch.Tensor) -> torch.Tensor:
        return torch.nn.functional.one_hot(x.long(), self.num_classes).float()

    def _cum_row(self, t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """Row x of Q̄_t: c_t·e_x + the off-diagonal term, (B, W, V) fp32."""
        c = self._const("cum_diag", x.device)[t][:, None, None]
        d = self._const("cum_off", x.device)[t][:, None, None]
        row = c * self._onehot(x)
        if self.transition == "absorbing":
            row[..., self.absorbing_state] += d[..., 0]
            return row
        return row + d / self.num_classes

    def _cum_mix(self, t: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
        """p @ Q̄_t for probability rows p: c_t·p + d_t·(Σp)·e_a (absorbing)
        or + d_t·(Σp)/V (uniform)."""
        c = self._const("cum_diag", p.device)[t][:, None, None]
        d = self._const("cum_off", p.device)[t][:, None, None]
        mass = p.sum(dim=-1, keepdim=True)
        out = c * p
        if self.transition == "absorbing":
            out[..., self.absorbing_state] += (d * mass)[..., 0]
            return out
        return out + d * mass / self.num_classes

    def _onestep_T_row(self, t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """Row x of Q_tᵀ: (1-β_t)·e_x + β_t·[x = a]·1 (absorbing) or
        + β_t/V·1 (uniform)."""
        beta = self._const("betas", x.device)[t][:, None, None]
        row = (1.0 - beta) * self._onehot(x)
        if self.transition == "absorbing":
            is_absorb = (x == self.absorbing_state).float()[..., None]
            return row + beta * is_absorb
        return row + beta / self.num_classes

    # ---------------- dense helpers ----------------

    @staticmethod
    def _at(a: torch.Tensor, t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """Rows a[t][x] (≡ one-hot(x) @ a[t]): (B, W, V)."""
        return a[t[:, None], x]

    @staticmethod
    def _at_onehot(a: torch.Tensor, t: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
        """p @ a[t] for probability rows p (B, W, V)."""
        return torch.einsum("bwv,bvu->bwu", p.float(), a[t])

    # ---------------- the forward process ----------------

    def q_probs(self, x_start: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """q(x_t | x_0) rows for integer x_0 (B, W) at timesteps t (B,)."""
        if self.transition == "dense":
            return self._at(self._const("q_cum", x_start.device), t, x_start.long())
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
        return torch.argmax(logits + _gumbel(uniform_noise), dim=-1)

    # ---------------- the posterior and the ancestral sampler ----------------

    def q_posterior_logits(self, x_start: torch.Tensor, x_t: torch.Tensor, t: torch.Tensor,
                           x_start_logits: bool) -> torch.Tensor:
        """log q(x_{t-1} | x_t, x_0) up to a constant, (B, W, V) fp32.

        fact1 is row x_t of Q_tᵀ; fact2 is softmax(x_0 logits) @ Q̄_{t-1}
        (or row x_0 of Q̄_{t-1} for integer x_0).  Rows at t == 0 return the
        x_0 logits (for integer x_0, log(one-hot + eps))."""
        t = t.long()
        t_1 = torch.where(t == 0, t, t - 1)
        if x_start_logits:
            x_start = x_start.float()
            probs = torch.softmax(x_start, dim=-1)
        if self.transition == "dense":
            dev = x_t.device
            fact1 = self._at(self._const("q_onestep", dev).transpose(1, 2), t, x_t.long())
            if x_start_logits:
                fact2 = self._at_onehot(self._const("q_cum", dev), t_1, probs)
            else:
                fact2 = self._at(self._const("q_cum", dev), t_1, x_start.long())
        else:
            fact1 = self._onestep_T_row(t, x_t)
            fact2 = self._cum_mix(t_1, probs) if x_start_logits else self._cum_row(t_1, x_start)
        if x_start_logits:
            tzero_logits = x_start
        else:
            tzero_logits = torch.log(self._onehot(x_start) + self.eps)
        out = torch.log(fact1 + self.eps) + torch.log(fact2 + self.eps)
        return torch.where(_per_row(t, out.ndim) == 0, tzero_logits, out)

    def p_logits(self, model_logits: torch.Tensor, t: torch.Tensor,
                 x_t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """log p(x_{t-1} | x_t) from the denoiser's x_0 logits: the
        posterior under the predicted x_0, the x_0 logits themselves at
        t == 0.  → (transition logits, x_0 logits), fp32."""
        pred = model_logits.float()
        post = self.q_posterior_logits(pred, x_t, t, x_start_logits=True)
        return torch.where(_per_row(t, post.ndim) == 0, pred, post), pred

    def _sample(self, logits: torch.Tensor, t: torch.Tensor,
                uniform_noise: torch.Tensor | None,
                generator: torch.Generator | None, what: str) -> torch.Tensor:
        """Gumbel-argmax over ``logits``, with no noise on rows at t == 0."""
        if uniform_noise is None:
            if generator is None:
                raise ValueError(f"{what} needs uniform_noise or a generator")
            uniform_noise = torch.rand(logits.shape, generator=generator,
                                       device=logits.device, dtype=torch.float32)
        nonzero = _per_row(t != 0, logits.ndim).float()
        return torch.argmax(logits + nonzero * _gumbel(uniform_noise), dim=-1)

    def p_sample(self, model_logits: torch.Tensor, t: torch.Tensor, x_t: torch.Tensor,
                 uniform_noise: torch.Tensor | None = None,
                 generator: torch.Generator | None = None) -> torch.Tensor:
        """Ancestral step x_{t-1} ~ p(x_{t-1} | x_t)."""
        logits, _ = self.p_logits(model_logits, t, x_t)
        return self._sample(logits, t, uniform_noise, generator, "p_sample")

    # ---------------- strided (skip-step) sampling ----------------

    def _interval_diag(self, s: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """Diagonal coefficient of Q_{(s,t]} = Π_{u∈(s,t]} Q_u: the interval
        operator is a·I + (1-a)·M with a = c_t / c_s (c_{-1} = 1), so at
        s = t-1 it is the one-step 1-β_t."""
        c = self._const("cum_diag", t.device)
        cs = torch.where(s < 0, torch.ones((), device=t.device), c[s.clamp_min(0)])
        return c[t] / cs

    def q_posterior_logits_strided(self, x_start_logits: torch.Tensor, x_t: torch.Tensor,
                                   t: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
        """log q(x_s | x_t, x_0 logits) for a stride t → s (s < t), through
        the closed-form interval transition.  Structured families only."""
        if self.transition == "dense":
            raise ValueError("strided sampling needs a structured transition")
        t, s = t.long(), s.long()
        x_start_logits = x_start_logits.float()
        a = self._interval_diag(s, t)[:, None, None]
        row = a * self._onehot(x_t)
        if self.transition == "absorbing":
            is_absorb = (x_t == self.absorbing_state).float()[..., None]
            fact1 = row + (1.0 - a) * is_absorb
        else:
            fact1 = row + (1.0 - a) / self.num_classes
        fact2 = self._cum_mix(s, torch.softmax(x_start_logits, dim=-1))
        out = torch.log(fact1 + self.eps) + torch.log(fact2 + self.eps)
        return torch.where(_per_row(t, out.ndim) == 0, x_start_logits, out)

    def p_sample_strided(self, model_logits: torch.Tensor, t: torch.Tensor, s: torch.Tensor,
                         x_t: torch.Tensor, uniform_noise: torch.Tensor | None = None,
                         generator: torch.Generator | None = None) -> torch.Tensor:
        """Ancestral step x_s ~ p(x_s | x_t), skipping ``t - s`` process steps."""
        logits = self.q_posterior_logits_strided(model_logits, x_t, t, s)
        return self._sample(logits, t, uniform_noise, generator, "p_sample_strided")
