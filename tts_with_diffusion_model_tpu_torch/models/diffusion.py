"""The D3PM diffusion TTS model's serving path (counterpart of
``models/diffusion.py`` in the JAX package): the config, the serving
response bucket and MaskGIT decoding.

The training loss and the ancestral sampler are not ported yet.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..diffusion.d3pm import D3PM
from .dit import DiTDenoiser


@dataclasses.dataclass(frozen=True)
class DiffusionConfig:
    n_classes: int = 1025
    d_model: int = 512
    n_heads: int = 8
    n_layers: int = 8
    n_prom_levels: int = 8
    timesteps: int = 100
    schedule: str = "cosine"
    transition: str = "absorbing"
    resp_len: int = 448
    text_len: int = 50
    prom_len: int = 398
    gen_len: int = 350
    tower_ffn_dim: int | None = None
    tower_act: str = "gelu"
    resp_pe: bool = True

    @property
    def serving_resp_bucket(self) -> int:
        """Smallest 128-multiple covering ``gen_len`` (384 for 350), capped at
        ``resp_len``."""
        return min(self.resp_len, -(-self.gen_len // 128) * 128)


def maskgit_schedule(d3pm: D3PM, gen_len: int, steps: int):
    """Static per-step schedule → (timesteps, keep counts, anneal factors).

    Tokens still masked after step i follow the cosine γ((i+1)/K); the
    timestep fed at step i is the one whose expected mask rate ``cum_off``
    matches the fraction masked before the step (``searchsorted``)."""
    mask_rate = np.asarray(d3pm.cum_off, np.float64)
    n_mask_after = [int(np.floor(gen_len * np.cos(np.pi / 2 * (i + 1) / steps)))
                    for i in range(steps)]
    n_mask_after[-1] = 0
    ts, keeps, anneal = [], [], []
    prev = gen_len
    for i in range(steps):
        t_i = int(np.searchsorted(mask_rate, prev / gen_len))
        ts.append(max(1, min(d3pm.timesteps - 1, t_i)))
        keeps.append(gen_len - n_mask_after[i])
        anneal.append(1.0 - (i + 1) / steps)
        prev = n_mask_after[i]
    return ts, keeps, anneal


class DiffusionModel(torch.nn.Module):
    """A ``DiTDenoiser`` paired with the D3PM process constants."""

    def __init__(self, config: DiffusionConfig = DiffusionConfig(), dtype=torch.bfloat16):
        super().__init__()
        self.config = config
        self.denoiser = DiTDenoiser(
            n_classes=config.n_classes, d_model=config.d_model, n_heads=config.n_heads,
            n_layers=config.n_layers, n_prom_levels=config.n_prom_levels,
            timesteps=config.timesteps, dtype=dtype, tower_ffn_dim=config.tower_ffn_dim,
            tower_act=config.tower_act, resp_pe=config.resp_pe)
        self.d3pm = D3PM.create(timesteps=config.timesteps, num_classes=config.n_classes,
                                schedule=config.schedule, transition=config.transition)

    @torch.no_grad()
    def generate_maskgit(self, text, text_mask, proms, prom_mask, keys, steps: int = 12,
                         temperature: float = 1.0, choice_temperature: float = 4.5,
                         gen_len: int | None = None, resp_bucket: int | None = None):
        """Confidence-ordered parallel decoding in ``steps`` denoiser calls.

        Start all-absorbed; at step i sample every position from the x_0
        logits (Gumbel noise tagged ``2i``), score each by its log-probability
        plus annealed selection Gumbel noise (tag ``2i+1``), keep the top
        ``keep_i`` (threshold with ``>=``; committed tokens always stay) and
        re-absorb the rest.  ``keys`` is a per-row ``RowKeys`` (or any object
        with its ``fold``/``gumbel`` methods).  Returns (B, resp_bucket) int64
        tokens; positions ≥ gen_len are 0."""
        c = self.config
        if self.d3pm.transition != "absorbing":
            raise ValueError("maskgit decoding requires the absorbing family")
        B, dev = text.shape[0], text.device
        gl = gen_len if gen_len is not None else c.gen_len
        bucket = resp_bucket if resp_bucket is not None else c.resp_len
        if bucket < gl:
            raise ValueError(f"resp_bucket {bucket} < gen_len {gl}")
        K = int(steps)
        if not 1 <= K <= gl:
            raise ValueError(f"steps must be in [1, {gl}], got {K}")
        absorb = self.d3pm.absorbing_state

        rm = (torch.arange(bucket, device=dev)[None, :] < gl).float().expand(B, bucket).contiguous()
        valid = rm.bool()
        x = torch.where(valid, absorb, 0).long()

        den = self.denoiser
        text_cond, spkr_cond = den.conds(text, text_mask, proms, prom_mask)
        kv_list = den.cond_kv(text_cond, spkr_cond)

        ts, keeps, anneal = maskgit_schedule(self.d3pm, gl, K)
        known = torch.zeros_like(valid)
        pos_inf = torch.tensor(1e30, device=dev)
        neg_inf = torch.tensor(-1e30, device=dev)
        for i in range(K):
            t = torch.full((B,), ts[i], dtype=torch.long, device=dev)
            logits = den.denoise_with_kv(x, rm, t, kv_list, text_mask, prom_mask).float()
            g_tok = keys.fold(2 * i).gumbel(logits.shape[1:], dev)
            if temperature > 0:
                sampled = (logits / temperature + g_tok).argmax(dim=-1)
            else:
                sampled = logits.argmax(dim=-1)
            logp = torch.log_softmax(logits, dim=-1)
            conf = logp.gather(-1, sampled[..., None])[..., 0]
            g_sel = keys.fold(2 * i + 1).gumbel(conf.shape[1:], dev)
            conf = conf + np.float32(choice_temperature) * np.float32(anneal[i]) * g_sel
            conf = torch.where(known, pos_inf, conf)
            conf = torch.where(valid, conf, neg_inf)
            top_vals = torch.topk(conf, gl, dim=1).values
            thresh = top_vals[:, keeps[i] - 1: keeps[i]]
            selected = (conf >= thresh) & valid
            cand = torch.where(known, x, sampled)
            x = torch.where(selected, cand, absorb)
            x = torch.where(valid, x, 0)
            known = selected
        return x
