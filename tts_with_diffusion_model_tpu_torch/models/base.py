"""Shared backbone pieces (counterpart of ``models/base.py`` in the JAX
package), and the flax-equivalent layers the port's models are built from.

The packed slot layout ``[ text (Tt) | sep | proms (Tp) | sep | resps (Tr) ]``
with per-segment masks and packed positions ``cumsum(mask) - 1`` is kept as
it is.  Only the batch (non-cached) forward is ported; the AR KV-cache paths
come with the AR slice.

Dtypes follow flax's promotion so the port serves in the JAX package's
precision: a ``Dense`` with a compute ``dtype`` casts input, weight and bias
to it (bf16 in serving, fp32 for the logits heads); ``LayerNorm`` computes in
fp32 and returns fp32 (its scale and bias stay fp32); embedding lookups keep
the table's dtype.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import route


class Dense(nn.Module):
    """``flax.linen.Dense``: weight (out, in) (the flax kernel transposed)."""

    def __init__(self, d_in: int, d_out: int, bias: bool = True, dtype=None):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(d_out, d_in))
        self.bias = nn.Parameter(torch.zeros(d_out)) if bias else None
        self.dtype = dtype

    def forward(self, x):
        dt = self.dtype or torch.promote_types(x.dtype, self.weight.dtype)
        b = self.bias.to(dt) if self.bias is not None else None
        return F.linear(x.to(dt), self.weight.to(dt), b)


class LayerNorm(nn.Module):
    """``flax.linen.LayerNorm``: statistics and output in fp32."""

    def __init__(self, d: int, eps: float):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(d))
        self.bias = nn.Parameter(torch.zeros(d))
        self.eps = eps

    def forward(self, x):
        return F.layer_norm(x.float(), (x.shape[-1],), self.weight.float(),
                            self.bias.float(), self.eps)


class Embed(nn.Module):
    """``flax.linen.Embed``: a table lookup in the table's dtype."""

    def __init__(self, n: int, d: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(n, d))

    def forward(self, ids):
        return self.weight[ids]


def gelu(x):
    """erf-form GELU (flax ``gelu(approximate=False)`` ≡ torch ``nn.GELU``)."""
    return F.gelu(x, approximate="none")


def sinusoidal_embedding(pos: torch.Tensor, d_model: int) -> torch.Tensor:
    """``[sin(ω_i·x) ‖ cos(ω_i·x)]`` with ``ω_i = exp(-ln(1e4)·i/(d/2))``, fp32."""
    d_half = d_model // 2
    exponent = torch.arange(d_half, dtype=torch.float32, device=pos.device) / d_half
    omega = torch.exp(-math.log(1e4) * exponent)
    x = pos.float()[..., None] * omega
    return torch.cat([torch.sin(x), torch.cos(x)], dim=-1)


class MultiEmbedding(nn.Module):
    """Sum of per-RVQ-level embeddings.  tokens (..., T, L) → (..., T, D);
    ``level_mask`` (..., L) selects the levels that contribute."""

    def __init__(self, max_n_levels: int, n_tokens: int, token_dim: int):
        super().__init__()
        self.max_n_levels = max_n_levels
        self.weight = nn.Parameter(torch.zeros(max_n_levels, n_tokens, token_dim))

    def forward(self, tokens, level_mask=None):
        lvl = torch.arange(self.max_n_levels, device=tokens.device)
        emb = self.weight[lvl, tokens]  # (..., T, L, D)
        if level_mask is not None:
            while level_mask.ndim < emb.ndim - 1:
                level_mask = level_mask[..., None, :]
            emb = emb * level_mask[..., None].to(emb.dtype)
        return emb.sum(dim=-2)


def _layer_norm(x, eps: float = 1e-5):
    """Parameter-free LN computed in fp32, returned in x's dtype."""
    return F.layer_norm(x.float(), (x.shape[-1],), eps=eps).to(x.dtype)


class AdaLN(nn.Module):
    """Level-conditioned norm with the AdaNorm trick ``c·(1 − k·h)·h`` (the
    ``h`` inside the bracket is a constant under autodiff, as in the JAX
    package)."""

    def __init__(self, d_model: int, n_levels: int, eps: float = 1e-5,
                 k: float = 0.1, c: float = 2.0):
        super().__init__()
        self.emb = nn.Parameter(torch.zeros(n_levels, 2 * d_model))
        self.eps, self.k, self.c = eps, k, c

    def forward(self, x, level):
        params = self.emb[level]  # (B, 2D)
        log_gamma, beta = params[:, None, :].chunk(2, dim=-1)
        h = _layer_norm(x, self.eps)
        h = self.c * (1 - (self.k * h).detach()) * h
        return (torch.exp(log_gamma) * h + beta).to(x.dtype)


class Attention(nn.Module):
    """Non-causal multi-head attention over packed positions, batch mode
    (the NAR's), through ``ops/route.attend``.  Keys are masked by the
    kernel; padding query rows are zeroed by ``to_out(o) * mask``."""

    def __init__(self, d_model: int, n_heads: int, dtype=None):
        super().__init__()
        self.d_model, self.n_heads = d_model, n_heads
        self.to_qkv = Dense(d_model, 3 * d_model, bias=False, dtype=dtype)
        self.to_out = Dense(d_model, d_model, dtype=dtype)

    def forward(self, x, mask):
        B, T, _ = x.shape
        qkv = self.to_qkv(x).view(B, T, 3, self.n_heads, self.d_model // self.n_heads)
        o = route.attend(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], mask)
        o = o.reshape(B, T, self.d_model)
        return self.to_out(o) * mask[..., None].to(x.dtype)


class FeedForward(nn.Module):
    def __init__(self, d_model: int, dtype=None):
        super().__init__()
        self.fc1 = Dense(d_model, 4 * d_model, dtype=dtype)
        self.fc2 = Dense(4 * d_model, d_model, dtype=dtype)

    def forward(self, x):
        return self.fc2(gelu(self.fc1(x)))


class PrenormBlock(nn.Module):
    """Pre-norm attention + FFN residual block with AdaLN (the NAR's norm)."""

    def __init__(self, d_model: int, n_heads: int, n_levels: int, dtype=None):
        super().__init__()
        self.norm_attn = AdaLN(d_model, n_levels)
        self.norm_ffn = AdaLN(d_model, n_levels)
        self.attn = Attention(d_model, n_heads, dtype=dtype)
        self.ffn = FeedForward(d_model, dtype=dtype)

    def forward(self, x, mask, level):
        m = mask[..., None].to(x.dtype)
        h = self.attn(self.norm_attn(x, level) * m, mask)
        x = (x + h) * m
        h = self.ffn(self.norm_ffn(x, level) * m)
        return (x + h) * m


def packed_layout(text_mask, prom_mask, resp_mask):
    """Merged mask / packed positions / segment ids, each (B, Tt+1+Tp+1+Tr);
    segment ids: 0=text, 1=sep, 2=prom, 3=sep2, 4=resp."""
    B = text_mask.shape[0]
    one = text_mask.new_ones((B, 1))
    mask = torch.cat([text_mask, one, prom_mask, one, resp_mask], dim=1)
    pos = torch.cumsum(mask, dim=1) - 1
    seg = torch.cat([
        torch.full_like(text_mask, 0), torch.full_like(one, 1),
        torch.full_like(prom_mask, 2), torch.full_like(one, 3),
        torch.full_like(resp_mask, 4),
    ], dim=1)
    return mask, pos, seg


class Base(nn.Module):
    """The shared trunk, non-causal AdaLN form (the NAR's): embeds the three
    segments, runs ``n_layers`` blocks, projects to ``n_tokens`` logits."""

    def __init__(self, n_tokens: int, d_model: int = 512, n_heads: int = 8,
                 n_layers: int = 12, n_resp_levels: int = 7,
                 n_prom_levels: int = 8, dtype=torch.bfloat16):
        super().__init__()
        self.d_model, self.n_layers, self.dtype = d_model, n_layers, dtype
        self.text_emb = Embed(n_tokens, d_model)
        self.proms_emb = MultiEmbedding(n_prom_levels, n_tokens, d_model)
        self.resps_emb = MultiEmbedding(n_resp_levels, n_tokens, d_model)
        self.sep = nn.Parameter(torch.zeros(d_model))
        for i in range(n_layers):
            self.add_module(f"block_{i}", PrenormBlock(d_model, n_heads, n_resp_levels, dtype=dtype))
        self.classifier = Dense(d_model, n_tokens, dtype=torch.float32)

    def blocks(self):
        return [getattr(self, f"block_{i}") for i in range(self.n_layers)]

    def forward(self, text, text_mask, proms, prom_mask, resps, resp_mask,
                resp_level_mask=None, quant_levels=None):
        """Logits (B, T, n_tokens) over the merged layout."""
        B = text.shape[0]
        text_e = self.text_emb(text)
        proms_e = self.proms_emb(proms)
        resps_e = self.resps_emb(resps, resp_level_mask)
        sep = self.sep.expand(B, 1, self.d_model)
        dt = torch.promote_types(torch.promote_types(text_e.dtype, sep.dtype), proms_e.dtype)
        x = torch.cat([text_e.to(dt), sep.to(dt), proms_e.to(dt), sep.to(dt), resps_e.to(dt)], dim=1)
        mask, pos, _ = packed_layout(text_mask, prom_mask, resp_mask)
        x = x + sinusoidal_embedding(pos, self.d_model)
        x = x.to(self.dtype) * mask[..., None].to(self.dtype)
        level = quant_levels if quant_levels is not None else torch.zeros(B, dtype=torch.long, device=text.device)
        for block in self.blocks():
            x = block(x, mask, level)
        logits = self.classifier(x.float())
        return logits * mask[..., None]


def sample_categorical(logits, temperature: float = 1.0, gumbel_noise=None):
    """Temperature sampling with the noise passed in; ``temperature <= 0`` is
    greedy."""
    logits = logits.float()
    if temperature <= 0:
        return logits.argmax(dim=-1)
    if gumbel_noise is None:
        raise ValueError("stochastic sampling needs gumbel_noise")
    return (logits / temperature + gumbel_noise).argmax(dim=-1)
