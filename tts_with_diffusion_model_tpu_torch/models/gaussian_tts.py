"""Continuous Gaussian-diffusion TTS model (counterpart of
``models/gaussian_tts.py`` in the JAX package).

A denoiser predicts the noise ε over either
  - ``domain="embedding"``: level-0 token embedding vectors (the
    ``resp_table`` parameter), decoded by nearest-embedding lookup, or
  - ``domain="value"``: token values normalized to [-1, 1], decoded by
    de-normalize and round.
Three denoisers sit behind one ``conds`` / ``cond_kv`` / ``denoise_with_kv``
interface: the DiT (``GaussianDenoiser``, on ``dit.DiTBlock`` and its
towers; with ``unet_dims`` a bottleneck of down / up projections around a
narrower DiT core), the 1-D conv-UNet (``models/unet.py``) and the
published UNet2DCondition topology (``models/unet2dcond.py``).

Every attention of the DiT and the conv-UNet goes through
``ops/route.attend``; the conditioning's cross-attention K/V are computed
once per utterance (``cond_kv``) and reused by every reverse step.
Registry names: ``diffusion-gaussian`` (embedding), ``-value``, ``-unet``,
``-unet2d`` (conv-UNet) and ``-unet2d-ref``.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..diffusion.gaussian import (GaussianDiffusion, denormalize_tokens, nearest_embedding,
                                  normalize_tokens)
from .base import Dense, Embed, MultiEmbedding, resolve_remat_policy, sinusoidal_embedding
from .dit import CondTower, DiTBlock, tower_inputs


@dataclasses.dataclass(frozen=True)
class GaussianConfig:
    n_tokens: int = 1024
    d_model: int = 256
    n_heads: int = 8
    n_layers: int = 8
    n_prom_levels: int = 8
    timesteps: int = 100
    schedule: str = "cosine"
    domain: str = "embedding"  # "embedding" | "value"
    resp_len: int = 448
    text_len: int = 50
    prom_len: int = 398
    gen_len: int = 350
    # bottleneck widths around the DiT core; empty = plain DiT
    unet_dims: tuple = ()
    # "dit", "conv-unet" (models/unet.py) or "unet2d-ref" (models/unet2dcond.py)
    denoiser: str = "dit"
    unet_channels: tuple = (64, 128, 256)
    # per-block recompute in the DiT stack's backward (cfg.gradient_checkpointing)
    remat: bool = False
    remat_policy: str | None = None  # models/base.resolve_remat_policy


class GaussianDenoiser(nn.Module):
    """Continuous-input DiT denoiser: a Dense in-projection, DiT blocks with
    text / speaker cross-attention and FiLM(t), an fp32 out-projection back
    to the domain width."""

    def __init__(self, in_dim: int, d_model: int, n_heads: int, n_layers: int,
                 n_classes: int, n_prom_levels: int, timesteps: int, unet_dims: tuple = (),
                 dtype=torch.bfloat16, remat: bool = False, remat_policy=None):
        super().__init__()
        self.d_model, self.n_layers, self.dtype = d_model, n_layers, dtype
        self.unet_dims = tuple(unet_dims)
        self.remat = remat
        self.remat_context = resolve_remat_policy(remat_policy)
        core = self.core_dim
        self.in_proj = Dense(in_dim, d_model, dtype=dtype)
        self.resp_table = nn.Parameter(torch.zeros(n_classes, d_model))
        if self.unet_dims:
            ins = [d_model, *self.unet_dims[:-1]]
            for i, (a, b) in enumerate(zip(ins, self.unet_dims)):
                self.add_module(f"down_projs_{i}", Dense(a, b, dtype=dtype))
            outs = [*reversed(self.unet_dims[:-1]), d_model]
            for i, (a, b) in enumerate(zip([core, *outs[:-1]], outs)):
                self.add_module(f"up_projs_{i}", Dense(a, b, dtype=dtype))
            self.cond_proj = Dense(d_model, core, dtype=dtype)
        self.text_emb = Embed(n_classes, d_model)
        self.proms_emb = MultiEmbedding(n_prom_levels, n_classes, d_model)
        self.time_emb = Embed(timesteps + 1, core)
        self.text_tower = CondTower(d_model, n_heads, mlp_mult=2, dtype=dtype)
        self.prom_tower = CondTower(d_model, n_heads, mlp_mult=3, dtype=dtype)
        for i in range(n_layers):
            self.add_module(f"dit_{i}", DiTBlock(core, n_heads, dtype=dtype))
        self.out_proj = Dense(d_model, in_dim, dtype=torch.float32)

    @property
    def core_dim(self) -> int:
        """Width of the DiT stack: the bottleneck when U-Net-shaped."""
        return self.unet_dims[-1] if self.unet_dims else self.d_model

    def blocks(self):
        return [getattr(self, f"dit_{i}") for i in range(self.n_layers)]

    def _projs(self, kind: str):
        return [getattr(self, f"{kind}_projs_{i}") for i in range(len(self.unet_dims))]

    def conds(self, text, text_mask, proms, prom_mask):
        """→ (text_cond, spkr_cond), once per utterance."""
        te, pe = tower_inputs(self, text, text_mask, proms, prom_mask)
        return self.text_tower(te, text_mask), self.prom_tower(pe, prom_mask)

    def cond_kv(self, text_cond, text_mask, spkr_cond, prom_mask):
        """Per-block cross-attention K/V of the conditioning (through
        ``cond_proj`` into the bottleneck first), with the key masks."""
        if self.unet_dims:
            text_cond, spkr_cond = self.cond_proj(text_cond), self.cond_proj(spkr_cond)
        return [blk.cross_kv(text_cond, spkr_cond) for blk in self.blocks()], text_mask, prom_mask

    def denoise_with_kv(self, x_t, resp_mask, t, kv):
        """x_t: (B, Tr, in_dim) continuous noisy input → ε̂, same shape, fp32,
        zero at padding positions."""
        kv_list, text_mask, prom_mask = kv
        dt = self.dtype
        x = self.in_proj(x_t.to(dt))
        x = x + sinusoidal_embedding(torch.arange(x.shape[1], device=x.device)[None],
                                     self.d_model).to(dt)
        x = x * resp_mask[..., None].to(dt)
        skips = []
        for proj in self._projs("down"):
            skips.append(x)
            x = F.gelu(proj(x), approximate="tanh")
        t_emb = self.time_emb(t).to(dt)
        use_remat = self.remat and torch.is_grad_enabled()
        for blk, (kv_text, kv_spkr) in zip(self.blocks(), kv_list):
            args = (x, resp_mask, kv_text, text_mask, kv_spkr, prom_mask, t_emb)
            x = (checkpoint(blk.apply_step, *args, use_reentrant=False,
                            context_fn=self.remat_context)
                 if use_remat else blk.apply_step(*args))
        for proj, skip in zip(self._projs("up"), reversed(skips)):
            x = F.gelu(proj(x), approximate="tanh") + skip
        eps = self.out_proj(x.float())
        return eps * resp_mask[..., None]

    def denoise(self, x_t, resp_mask, t, text_cond, text_mask, spkr_cond, prom_mask):
        return self.denoise_with_kv(x_t, resp_mask, t,
                                    self.cond_kv(text_cond, text_mask, spkr_cond, prom_mask))

    def forward(self, text, text_mask, proms, prom_mask, x_t, resp_mask, t):
        tc, sc = self.conds(text, text_mask, proms, prom_mask)
        return self.denoise(x_t, resp_mask, t, tc, text_mask, sc, prom_mask)


class GaussianDiffusionModel(nn.Module):
    """A Gaussian denoiser paired with the process constants: the ε-MSE loss
    and the T-step ancestral sampler."""

    def __init__(self, config: GaussianConfig = GaussianConfig(), dtype=torch.bfloat16):
        super().__init__()
        self.config = c = config
        self.in_dim = c.d_model if c.domain == "embedding" else 1
        common = dict(in_dim=self.in_dim, d_model=c.d_model, n_heads=c.n_heads,
                      n_classes=c.n_tokens + 1, n_prom_levels=c.n_prom_levels,
                      timesteps=c.timesteps, dtype=dtype)
        if c.denoiser in ("unet2d-ref", "conv-unet") and c.domain != "value":
            raise ValueError(f"{c.denoiser} denoiser requires domain='value'")
        if c.denoiser == "unet2d-ref":
            from .unet2dcond import UNet2DCondDenoiser

            self.denoiser = UNet2DCondDenoiser(text_len=c.text_len, prom_len=c.prom_len,
                                               channels=tuple(c.unet_channels), **common)
        elif c.denoiser == "conv-unet":
            from .unet import ConvUNetDenoiser

            self.denoiser = ConvUNetDenoiser(channels=tuple(c.unet_channels), **common)
        else:
            self.denoiser = GaussianDenoiser(n_layers=c.n_layers, unet_dims=tuple(c.unet_dims),
                                             remat=c.remat, remat_policy=c.remat_policy,
                                             **common)
        self.process = GaussianDiffusion.create(c.timesteps, c.schedule)

    @property
    def full_prompt(self) -> bool:
        """The UNet2DCondition conditioning flattens the whole ``prom_len``
        prompt into one vector, so it takes no shorter prompt bucket."""
        return self.config.denoiser == "unet2d-ref"

    def _conds(self, text, text_mask, proms, prom_mask):
        """The denoiser's conditioning state, a 4-tuple matching ``denoise``'s
        trailing arguments: (text_cond, text_mask, spkr_cond, prom_mask) for
        the DiT, (cond, cond_mask, None, None) for the UNets."""
        out = self.denoiser.conds(text, text_mask, proms, prom_mask)
        if self.config.denoiser in ("conv-unet", "unet2d-ref"):
            return (*out, None, None)
        return out[0], text_mask, out[1], prom_mask

    def _to_domain(self, resp):
        """Integer level-0 tokens → the continuous diffusion domain, fp32."""
        if self.config.domain == "embedding":
            return self.denoiser.resp_table[resp].float()
        return normalize_tokens(resp, self.config.n_tokens)[..., None]

    def _from_domain(self, x):
        if self.config.domain == "embedding":
            return nearest_embedding(x, self.denoiser.resp_table)
        return denormalize_tokens(x[..., 0], self.config.n_tokens)

    def loss(self, batch: dict, generator: torch.Generator | None, max_t: int | None = None,
             noise: torch.Tensor | None = None, t: torch.Tensor | None = None):
        """ε-prediction MSE at a sampled timestep → (mse, {"mse": mse}): t ~
        U{1, …, T−1} per row with T = ``max_t`` or the config's, ε ~ N(0, 1)
        over the domain, both from ``generator`` unless ``t`` / ``noise``
        inject them; the squared error summed over valid frames and the
        domain width, divided by (valid frames × width)."""
        c = self.config
        T = max_t or c.timesteps
        resp, rm = batch["resp"], batch["resp_mask"]
        B, dev = resp.shape[0], resp.device
        x0 = self._to_domain(resp.long())
        if t is None:
            t = torch.randint(1, T, (B,), generator=generator, device=dev)
        if noise is None:
            noise = torch.randn(x0.shape, generator=generator, device=dev)
        t, noise = t.to(dev).long(), noise.to(dev).float()
        x_t = self.process.q_sample(x0, t, noise) * rm[..., None]
        eps = self.denoiser(batch["text"], batch["text_mask"], batch["proms"],
                            batch["prom_mask"], x_t, rm, t)
        mse = ((eps - noise) ** 2 * rm[..., None]).sum() / (rm.sum() * x0.shape[-1]).clamp_min(1.0)
        return mse, {"mse": mse}

    @torch.no_grad()
    def generate(self, text, text_mask, proms, prom_mask, keys, gen_len: int | None = None):
        """The reverse chain over every process step, T−1 down to 0, then the
        decode to tokens.  Each row's normals come from ``keys`` (a
        ``RowKeys``, or any object with its ``fold`` / ``normal`` methods):
        the initial noise from ``keys.fold(T)``, step t's from
        ``keys.fold(t)``, so a row's stream does not depend on its cohort.
        Returns (B, resp_len) int64 tokens; positions ≥ gen_len are 0."""
        c = self.config
        B, dev = text.shape[0], text.device
        gl = gen_len if gen_len is not None else c.gen_len
        rm = (torch.arange(c.resp_len, device=dev)[None] < gl).float().expand(B, c.resp_len)
        rm = rm.contiguous()
        x = keys.fold(c.timesteps).normal((c.resp_len, self.in_dim), dev) * rm[..., None]
        den = self.denoiser
        kv = den.cond_kv(*self._conds(text, text_mask, proms, prom_mask))
        for t_i in range(c.timesteps - 1, -1, -1):
            t = torch.full((B,), t_i, dtype=torch.long, device=dev)
            eps = den.denoise_with_kv(x, rm, t, kv)
            z = keys.fold(t_i).normal(x.shape[1:], dev)
            x = self.process.p_sample(eps, x, t, z) * rm[..., None]
        return self._from_domain(x) * rm.long()
