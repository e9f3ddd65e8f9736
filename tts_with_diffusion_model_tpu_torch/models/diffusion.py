"""The D3PM diffusion TTS model (counterpart of ``models/diffusion.py`` in
the JAX package): the config, the serving response bucket, the training
loss, the ancestral sampler (``generate``, every process step or a stride of
them) and MaskGIT decoding.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..diffusion.d3pm import D3PM
from ..parallel.comm import draw_global, global_sum
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
    train_mode: str = "sampled"  # "sampled" | "all_t"
    # per-block recompute in the backward (from cfg.gradient_checkpointing)
    remat: bool = False
    # only None (whole-block recompute) is ported
    remat_policy: str | None = None
    # read for compatibility; on the card every differentiated attention
    # takes the training kernel and every other one the serving kernel
    # (ops/route.py), whatever this says
    attn_impl: str | None = None

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


def ancestral_schedule(timesteps: int, stride: int) -> tuple[list[int], list[int]]:
    """The ancestral chain's (t, s) pairs: t = T−1, T−1−stride, … ≥ 1, and
    s the next t (0 after the last)."""
    if stride < 1:
        raise ValueError(f"stride must be >= 1, got {stride}")
    ts = list(range(timesteps - 1, 0, -stride))
    return ts, ts[1:] + [0]


class DiffusionModel(torch.nn.Module):
    """A ``DiTDenoiser`` paired with the D3PM process constants."""

    def __init__(self, config: DiffusionConfig = DiffusionConfig(), dtype=torch.bfloat16):
        super().__init__()
        self.config = config
        self.denoiser = DiTDenoiser(
            n_classes=config.n_classes, d_model=config.d_model, n_heads=config.n_heads,
            n_layers=config.n_layers, n_prom_levels=config.n_prom_levels,
            timesteps=config.timesteps, dtype=dtype, tower_ffn_dim=config.tower_ffn_dim,
            tower_act=config.tower_act, resp_pe=config.resp_pe, remat=config.remat,
            remat_policy=config.remat_policy)
        self.d3pm = D3PM.create(timesteps=config.timesteps, num_classes=config.n_classes,
                                schedule=config.schedule, transition=config.transition)

    def loss(self, batch: dict, generator: torch.Generator | None, max_t: int | None = None,
             q_noise: torch.Tensor | None = None, t: torch.Tensor | None = None,
             conds: tuple | None = None, rows=None):
        """Masked x_0-prediction cross-entropy → (loss, {"nll": loss}).

        batch: text (B, Tt), text_mask, proms (B, Tp, 8), prom_mask, resp
        (B, Tr) level-0 ids, resp_mask.  ``max_t`` caps the timestep range.
        "sampled" mode draws t ~ U{1, …, T−1} per row, "all_t" averages every
        t in 1..T−1.  The forward corruption's uniform noise is drawn from
        ``generator`` unless ``q_noise`` injects it: (B, Tr, V) for
        "sampled", (T−1, B, Tr, V) for "all_t".  ``t`` injects the sampled
        timesteps and ``conds`` the towers' outputs (text_cond, spkr_cond),
        so tests can feed both packages the same draws.  In a dp step
        (``rows``: ``parallel.comm.Rows``) every draw is made for the global
        batch and cut to this rank's rows, and the mean's denominator is the
        global batch's."""
        c = self.config
        T = max_t or c.timesteps
        text, tm = batch["text"], batch["text_mask"]
        proms, pm = batch["proms"], batch["prom_mask"]
        resp, rm = batch["resp"], batch["resp_mask"]
        B, dev = resp.shape[0], resp.device
        den = self.denoiser
        text_cond, spkr_cond = conds if conds is not None else den.conds(text, tm, proms, pm)

        def ce_at_t(tt, noise):
            if noise is None and generator is not None:
                noise = draw_global(lambda n: torch.rand(
                    (n, *resp.shape[1:], c.n_classes), generator=generator, device=dev,
                    dtype=torch.float32), B, rows)
            x_t = self.d3pm.q_sample(resp, tt, uniform_noise=noise, generator=generator)
            x_t = (x_t * rm).long()
            logits = den.denoise(x_t, rm, tt, text_cond, tm, spkr_cond, pm)
            logp = torch.log_softmax(logits, dim=-1)
            nll = -logp.gather(-1, resp[..., None].long())[..., 0]
            return (nll * rm).sum() / global_sum(rm.sum(), rows).clamp_min(1.0)

        if c.train_mode == "all_t":
            total = 0.0
            for i, step in enumerate(range(1, T)):
                tt = torch.full((B,), step, dtype=torch.long, device=dev)
                total = total + ce_at_t(tt, None if q_noise is None else q_noise[i])
            loss = total / (T - 1)
        elif c.train_mode == "sampled":
            if t is None:
                t = draw_global(lambda n: torch.randint(1, T, (n,), generator=generator,
                                                        device=dev), B, rows)
            loss = ce_at_t(t.to(dev).long(), q_noise)
        else:
            raise ValueError(f"unknown train_mode {c.train_mode!r}")
        return loss, {"nll": loss}

    @torch.no_grad()
    def generate(self, text, text_mask, proms, prom_mask, keys, gen_len: int | None = None,
                 stride: int = 1, resp_bucket: int | None = None):
        """The reverse D3PM chain from all-absorbed: one denoiser call per
        process step t = T−1, T−1−stride, …, then x_s ~ p(x_s | x_t) with
        s the next step (0 after the last).  ``stride`` 1 samples the
        one-step posterior (``p_sample``), larger strides the closed-form
        interval posterior (``p_sample_strided``).  Each row's uniforms are
        drawn from ``keys.fold(t).uniform`` with t the process timestep, so
        a row's stream depends neither on its cohort nor on the stride.
        ``keys`` is a per-row ``RowKeys`` (or any object with its ``fold``
        / ``uniform`` methods).  Returns (B, resp_bucket) int64 tokens
        (``resp_bucket`` defaults to ``config.resp_len``); positions ≥
        gen_len are 0."""
        c = self.config
        B, dev = text.shape[0], text.device
        gl = gen_len if gen_len is not None else c.gen_len
        bucket = resp_bucket if resp_bucket is not None else c.resp_len
        if bucket < gl:
            raise ValueError(f"resp_bucket {bucket} < gen_len {gl}")
        rm = (torch.arange(bucket, device=dev)[None, :] < gl).float().expand(B, bucket).contiguous()
        x = torch.where(rm > 0, self.d3pm.absorbing_state, 0).long()

        den = self.denoiser
        text_cond, spkr_cond = den.conds(text, text_mask, proms, prom_mask)
        kv_list = den.cond_kv(text_cond, spkr_cond)

        for t_i, s_i in zip(*ancestral_schedule(c.timesteps, stride)):
            t = torch.full((B,), t_i, dtype=torch.long, device=dev)
            logits = den.denoise_with_kv(x, rm, t, kv_list, text_mask, prom_mask)
            noise = keys.fold(t_i).uniform(logits.shape[1:], dev)
            if stride == 1:
                x = self.d3pm.p_sample(logits, t, x, uniform_noise=noise)
            else:
                s = torch.full((B,), s_i, dtype=torch.long, device=dev)
                x = self.d3pm.p_sample_strided(logits, t, s, x, uniform_noise=noise)
            x = x * rm.long()
        return x

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
