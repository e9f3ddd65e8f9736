"""DiT-style denoiser for the D3PM codec-token diffusion model (counterpart
of ``models/dit.py`` in the JAX package).

Two conditioning towers (post-norm encoder layers + MLP) for the text phones
and the speaker prompt, N DiT blocks (self-attention, text cross-attention,
speaker cross-attention, FiLM timestep modulation, MLP) and an fp32 logits
head.  Every attention goes through ``ops/route.attend`` (the training
kernel when a gradient is needed, the serving kernel otherwise); the
cross-attention K/V of the conditioning are computed once per utterance
(``cond_kv``) and reused by every denoiser step.  With ``remat`` each
block's ``apply_step`` is recomputed in the backward instead of keeping its
activations (``torch.utils.checkpoint``, as ``nn.remat`` in the JAX
package), under ``remat_policy`` (``models/base.resolve_remat_policy``).

Submodule names equal the flax names (``dit_0``, ``text_tower.layer_0``,
...), so a flax parameter path maps onto the ``state_dict`` one to one
(``convert.py``).  LayerNorm eps: 1e-5 in the towers, 1e-6 in the blocks.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops import route
from ..parallel.mesh import Split
from .base import (Dense, Embed, LayerNorm, MultiEmbedding, TensorParallelMlp, gelu,
                   resolve_remat_policy, sinusoidal_embedding)


class Mlp(TensorParallelMlp, nn.Module):
    """in → hidden → out with erf GELU, SiLU or ReLU."""

    def __init__(self, d_in: int, hidden: int, out: int, act: str = "gelu", dtype=None):
        super().__init__()
        self.fc1 = Dense(d_in, hidden, dtype=dtype)
        self.fc2 = Dense(hidden, out, dtype=dtype)
        self.act = act

    def forward(self, x):
        h = self.fc1(x)
        if self.act == "silu":
            h = torch.nn.functional.silu(h)
        elif self.act == "relu":
            h = torch.relu(h)
        else:
            h = gelu(h)
        return self.fc2(h)


class MHA(nn.Module):
    """Projections + key-masked attention; ``kv()`` exposes the key/value
    projections so constant conditioning K/V are computed once."""

    def __init__(self, d_model: int, n_heads: int, dtype=None):
        super().__init__()
        self.d_model, self.n_heads = d_model, n_heads
        self.q = Dense(d_model, d_model, dtype=dtype)
        self.k = Dense(d_model, d_model, dtype=dtype)
        self.v = Dense(d_model, d_model, dtype=dtype)
        self.out = Dense(d_model, d_model, dtype=dtype)

    def tp_plan(self, tp: int) -> dict[str, Split]:
        """q, k, v (EMBED, HEADS) column-parallel, out (HEADS, EMBED)
        row-parallel."""
        if self.n_heads % tp:
            return {}
        cols = {f"{n}.{w}": Split(0, "heads") for n in "qkv" for w in ("weight", "bias")}
        return {**cols, "out.weight": Split(1, "heads")}

    def tp_shard(self, axis):
        self.n_heads //= axis.size
        self.d_model //= axis.size
        for lin in (self.q, self.k, self.v):
            lin.tp = ("col", axis)
        self.out.tp = ("row", axis)

    def _heads(self, t):
        return t.reshape(*t.shape[:-1], self.n_heads, self.d_model // self.n_heads)

    def kv(self, kv_in):
        return self._heads(self.k(kv_in)), self._heads(self.v(kv_in))

    def attend(self, q_in, k, v, kv_mask):
        q = self._heads(self.q(q_in))
        o = route.attend(q, k, v, kv_mask)
        return self.out(o.reshape(*o.shape[:-2], self.d_model))

    def forward(self, q_in, kv_in, kv_mask):
        return self.attend(q_in, *self.kv(kv_in), kv_mask)


class EncoderLayer(nn.Module):
    """Post-norm transformer encoder layer (LN eps 1e-5)."""

    def __init__(self, d_model: int, n_heads: int, ffn_dim=None, act="gelu", dtype=None):
        super().__init__()
        ffn = ffn_dim if ffn_dim is not None else 4 * d_model
        self.self_attn = MHA(d_model, n_heads, dtype=dtype)
        self.norm1 = LayerNorm(d_model, 1e-5)
        self.ffn = Mlp(d_model, ffn, d_model, act=act, dtype=dtype)
        self.norm2 = LayerNorm(d_model, 1e-5)

    def forward(self, x, mask):
        x = self.norm1(x + self.self_attn(x, x, mask))
        return self.norm2(x + self.ffn(x))


class CondTower(nn.Module):
    """``n_layers`` encoder layers + SiLU MLP; output zeroed at pads."""

    def __init__(self, d_model: int, n_heads: int, mlp_mult: int, n_layers: int = 2,
                 ffn_dim=None, act="gelu", dtype=None):
        super().__init__()
        self.n_layers = n_layers
        for i in range(n_layers):
            self.add_module(f"layer_{i}", EncoderLayer(d_model, n_heads, ffn_dim, act, dtype=dtype))
        self.mlp = Mlp(d_model, d_model * mlp_mult, d_model, act="silu", dtype=dtype)

    def forward(self, x, mask):
        for i in range(self.n_layers):
            x = getattr(self, f"layer_{i}")(x, mask)
        x = self.mlp(x)
        return x * mask[..., None].to(x.dtype)


class DiTBlock(nn.Module):
    """Self-attn + dual cross-attn + FiLM(t) + MLP (LN eps 1e-6)."""

    def __init__(self, d_model: int, n_heads: int, mlp_ratio: float = 4.0, dtype=None):
        super().__init__()
        self.norm1 = LayerNorm(d_model, 1e-6)
        self.attn = MHA(d_model, n_heads, dtype=dtype)
        self.norm2 = LayerNorm(d_model, 1e-6)
        self.cross_attn = MHA(d_model, n_heads, dtype=dtype)
        self.norm22 = LayerNorm(d_model, 1e-6)
        self.cross_attn2 = MHA(d_model, n_heads, dtype=dtype)
        self.norm3 = LayerNorm(d_model, 1e-6)
        self.mlp = Mlp(d_model, int(d_model * mlp_ratio), d_model, dtype=dtype)
        # flax tags it (EMBED, MLP); it has no row-parallel partner, so it
        # declares no split and replicates under tp
        self.timestep_fc = Dense(d_model, 2 * d_model, dtype=dtype)

    def cross_kv(self, text_cond, spkr_cond):
        return self.cross_attn.kv(text_cond), self.cross_attn2.kv(spkr_cond)

    def apply_step(self, x, mask, kv_text, text_mask, kv_spkr, spkr_mask, t_emb):
        m = mask[..., None].to(x.dtype)
        x = x * m
        h = self.norm1(x)
        x = x + self.attn(h, h, mask)
        ct = self.cross_attn.attend(self.norm2(x), *kv_text, text_mask)
        cs = self.cross_attn2.attend(self.norm22(x), *kv_spkr, spkr_mask)
        x = x + ct + cs
        scale, shift = self.timestep_fc(t_emb)[:, None, :].chunk(2, dim=-1)
        h = self.norm3(x) * (1 + scale) + shift
        x = x + self.mlp(h)
        return x * m


def tower_inputs(den, text, text_mask, proms, prom_mask):
    """The towers' inputs of a denoiser with ``text_emb``, ``proms_emb``,
    ``d_model`` and ``dtype``: embeddings plus sinusoidal positions, in the
    compute dtype, zeroed at pads → (text, prompt)."""
    dt, d = den.dtype, den.d_model
    te = den.text_emb(text) + sinusoidal_embedding(
        torch.arange(text.shape[1], device=text.device)[None], d)
    pe = den.proms_emb(proms) + sinusoidal_embedding(
        torch.arange(proms.shape[1], device=proms.device)[None], d)
    return (te.to(dt) * text_mask[..., None].to(dt), pe.to(dt) * prom_mask[..., None].to(dt))


class DiTDenoiser(nn.Module):
    """Conditioning towers + N DiT blocks + fp32 logits head.  x_0-prediction:
    noisy level-0 tokens and a timestep → logits over ``n_classes``."""

    def __init__(self, n_classes: int = 1025, d_model: int = 512, n_heads: int = 8,
                 n_layers: int = 8, n_prom_levels: int = 8, timesteps: int = 100,
                 dtype=torch.bfloat16, tower_ffn_dim=None, tower_act: str = "gelu",
                 resp_pe: bool = True, remat: bool = False, remat_policy=None):
        super().__init__()
        self.d_model, self.n_layers, self.dtype, self.resp_pe = d_model, n_layers, dtype, resp_pe
        self.remat = remat
        self.remat_context = resolve_remat_policy(remat_policy)
        self.text_emb = Embed(n_classes, d_model, vocab=True)
        self.proms_emb = MultiEmbedding(n_prom_levels, n_classes, d_model)
        self.resps_emb = Embed(n_classes, d_model, vocab=True)
        self.time_emb = Embed(timesteps + 1, d_model)
        self.text_tower = CondTower(d_model, n_heads, mlp_mult=2, ffn_dim=tower_ffn_dim,
                                    act=tower_act, dtype=dtype)
        self.prom_tower = CondTower(d_model, n_heads, mlp_mult=3, ffn_dim=tower_ffn_dim,
                                    act=tower_act, dtype=dtype)
        for i in range(n_layers):
            self.add_module(f"dit_{i}", DiTBlock(d_model, n_heads, dtype=dtype))
        self.final = Dense(d_model, n_classes, dtype=torch.float32, vocab=True)

    def blocks(self):
        return [getattr(self, f"dit_{i}") for i in range(self.n_layers)]

    def _positions(self, T: int, device):
        return sinusoidal_embedding(torch.arange(T, device=device)[None], self.d_model)

    def conds(self, text, text_mask, proms, prom_mask):
        """Conditioning towers, once per utterance → (text_cond, spkr_cond)."""
        te, pe = tower_inputs(self, text, text_mask, proms, prom_mask)
        return self.text_tower(te, text_mask), self.prom_tower(pe, prom_mask)

    def cond_kv(self, text_cond, spkr_cond):
        """Per-block cross-attention K/V of the conditioning."""
        return [blk.cross_kv(text_cond, spkr_cond) for blk in self.blocks()]

    def denoise_with_kv(self, x_t, resp_mask, t, kv_list, text_mask, prom_mask):
        """One denoiser evaluation → fp32 logits (B, Tr, n_classes), zero at
        padding positions."""
        dt = self.dtype
        x = self.resps_emb(x_t)
        if self.resp_pe:
            x = x + self._positions(x_t.shape[1], x_t.device)
        x = x.to(dt) * resp_mask[..., None].to(dt)
        t_emb = self.time_emb(t).to(dt)
        use_remat = self.remat and torch.is_grad_enabled()
        for blk, (kv_text, kv_spkr) in zip(self.blocks(), kv_list):
            args = (x, resp_mask, kv_text, text_mask, kv_spkr, prom_mask, t_emb)
            x = (checkpoint(blk.apply_step, *args, use_reentrant=False,
                            context_fn=self.remat_context)
                 if use_remat else blk.apply_step(*args))
        logits = self.final(x.float())
        return logits * resp_mask[..., None]

    def denoise(self, x_t, resp_mask, t, text_cond, text_mask, spkr_cond, prom_mask):
        """One denoiser evaluation from the towers' outputs."""
        kv_list = self.cond_kv(text_cond, spkr_cond)
        return self.denoise_with_kv(x_t, resp_mask, t, kv_list, text_mask, prom_mask)

    def forward(self, text, text_mask, proms, prom_mask, x_t, resp_mask, t):
        text_cond, spkr_cond = self.conds(text, text_mask, proms, prom_mask)
        return self.denoise(x_t, resp_mask, t, text_cond, text_mask, spkr_cond, prom_mask)
