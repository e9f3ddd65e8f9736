"""Conv-UNet denoiser for the value-domain Gaussian family (counterpart of
``models/unet.py`` in the JAX package; registry name
``diffusion-gaussian-unet2d``).

A channel-last 1-D pyramid: FiLM-modulated residual conv blocks with
strided down-sampling, a cross-attention to the concatenated prompt / text
towers at every resolution, and a skip-connected up path through
transposed convolutions.  Norm statistics cover valid frames only
(``MaskedGroupNorm``), so an utterance's output at its valid frames does
not depend on the bucket's padding.

The cross-attentions go through ``ops/route.attend``, whose kernels mask
keys only.  The JAX package's dense path also masks padding *queries*: a
query row whose pair mask is all zero gets a uniform softmax over every
key, so its output is the mean of V.  Here, unlike in the DiT, that row is
not multiplied away: the next strided or transposed convolution reads it
into the valid frames at the boundary.  ``CrossAttnBlock`` therefore puts
the mean of V into the padding query rows itself.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import route
from .base import (Conv, ConvTranspose, Dense, Embed, LayerNorm, MultiEmbedding)
from .dit import MHA, CondTower, tower_inputs


def _groups(ch: int) -> int:
    return 8 if ch % 8 == 0 else 1


class MaskedGroupNorm(nn.Module):
    """GroupNorm whose statistics cover only valid frames: per (batch,
    group) over valid frames × the group's channels, in fp32, eps 1e-6;
    padded frames come out zero, in x's dtype."""

    def __init__(self, num_groups: int, d: int, eps: float = 1e-6):
        super().__init__()
        self.num_groups, self.eps = num_groups, eps
        self.weight = nn.Parameter(torch.ones(d))
        self.bias = nn.Parameter(torch.zeros(d))

    def forward(self, x, mask):
        B, T, C = x.shape
        G = self.num_groups
        m = mask.float()
        cnt = m.sum(dim=1).clamp_min(1.0) * (C // G)                 # (B,)
        xg = (x.float() * m[..., None]).reshape(B, T, G, C // G)
        mean = xg.sum(dim=(1, 3)) / cnt[:, None]                     # (B, G)
        centered = (xg - mean[:, None, :, None]) * m[..., None, None]
        var = (centered ** 2).sum(dim=(1, 3)) / cnt[:, None]
        y = (centered * torch.rsqrt(var + self.eps)[:, None, :, None]).reshape(B, T, C)
        y = y * self.weight.float() + self.bias.float()
        return (y * m[..., None]).to(x.dtype)


class ConvResBlock(nn.Module):
    """GroupNorm → SiLU → Conv(k3) → FiLM(t) → GroupNorm → SiLU → Conv(k3),
    with a 1×1-conv skip when the width changes."""

    def __init__(self, d_in: int, ch: int, d_t: int, dtype=None):
        super().__init__()
        g = _groups(ch)
        self.norm1 = MaskedGroupNorm(g, d_in)
        self.conv1 = Conv(d_in, ch, (3,), dtype=dtype)
        self.film = Dense(d_t, 2 * ch, dtype=dtype)
        self.norm2 = MaskedGroupNorm(g, ch)
        self.conv2 = Conv(ch, ch, (3,), dtype=dtype)
        self.skip = Conv(d_in, ch, (1,), dtype=dtype) if d_in != ch else None

    def forward(self, x, t_emb, mask):
        m = mask[..., None].to(x.dtype)
        h = self.norm1(x, mask)
        h = self.conv1(F.silu(h) * m)
        scale, shift = self.film(F.silu(t_emb))[:, None, :].chunk(2, dim=-1)
        h = h * (1 + scale) + shift
        h = self.norm2(h, mask)
        h = self.conv2(F.silu(h) * m)
        if self.skip is not None:
            x = self.skip(x)
        return (x + h) * m


class CrossAttnBlock(nn.Module):
    """Pre-norm cross-attention of the sequence over the conditioning
    stream; ``kv`` gives the stream's K/V, and the mean of V over every key
    for the padding query rows, once per utterance."""

    def __init__(self, ch: int, n_heads: int, d_cond: int, dtype=None):
        super().__init__()
        self.cond_proj = Dense(d_cond, ch, dtype=dtype)
        self.norm = LayerNorm(ch, 1e-6)
        self.attn = MHA(ch, n_heads, dtype=dtype)

    def kv(self, cond):
        k, v = self.attn.kv(self.cond_proj(cond))
        return k, v, v.float().mean(dim=1, keepdim=True)

    def forward(self, x, kv, q_mask, kv_mask):
        attn = self.attn
        k, v, v_mean = kv
        q = attn._heads(attn.q(self.norm(x)))
        o = route.attend(q, k, v, kv_mask)
        # a padding query row: the dense path's uniform softmax over all keys
        o = torch.where(q_mask[:, :, None, None] > 0, o, v_mean.to(o.dtype))
        return x + attn.out(o.reshape(*o.shape[:-2], attn.d_model))


def _downsample_mask(mask):
    """Validity of stride-2 frames: valid when either source slot is."""
    B, T = mask.shape
    m = F.pad(mask, (0, T % 2))
    return m.reshape(B, -1, 2).amax(dim=-1)


class ConvUNetDenoiser(nn.Module):
    """The ε-prediction conv-UNet: (B, Tr, in_dim) → ε̂ (B, Tr, in_dim),
    conditioned on the text / speaker towers and the timestep."""

    def __init__(self, in_dim: int, d_model: int, n_heads: int, n_classes: int,
                 n_prom_levels: int, timesteps: int, channels=(64, 128, 256),
                 dtype=torch.bfloat16):
        super().__init__()
        self.d_model, self.dtype = d_model, dtype
        chs = list(channels)
        self.n_levels = len(chs)
        d_t = chs[0] * 4
        self.text_emb = Embed(n_classes, d_model)
        self.proms_emb = MultiEmbedding(n_prom_levels, n_classes, d_model)
        self.text_tower = CondTower(d_model, n_heads, mlp_mult=2, dtype=dtype)
        self.prom_tower = CondTower(d_model, n_heads, mlp_mult=3, dtype=dtype)
        self.time_emb = Embed(timesteps + 1, chs[0])
        self.time_mlp = Dense(chs[0], d_t, dtype=dtype)
        self.conv_in = Conv(in_dim, chs[0], (3,), dtype=dtype)
        for i, c in enumerate(chs):
            self.add_module(f"down_res_{i}", ConvResBlock(c, c, d_t, dtype))
            self.add_module(f"down_attn_{i}", CrossAttnBlock(c, n_heads, d_model, dtype))
        for i, c in enumerate(chs[1:]):
            self.add_module(f"down_{i}", Conv(chs[i], c, (3,), (2,), dtype=dtype))
        self.mid_res1 = ConvResBlock(chs[-1], chs[-1], d_t, dtype)
        self.mid_attn = CrossAttnBlock(chs[-1], n_heads, d_model, dtype)
        self.mid_res2 = ConvResBlock(chs[-1], chs[-1], d_t, dtype)
        rev = list(reversed(chs))
        for i, c in enumerate(rev[1:]):
            self.add_module(f"up_{i}", ConvTranspose(rev[i], c, 4, 2, dtype=dtype))
        for i, c in enumerate(rev):
            self.add_module(f"up_res_{i}", ConvResBlock(c if i == 0 else 2 * c, c, d_t, dtype))
            self.add_module(f"up_attn_{i}", CrossAttnBlock(c, n_heads, d_model, dtype))
        self.norm_out = MaskedGroupNorm(_groups(chs[0]), chs[0])
        self.conv_out = Conv(chs[0], in_dim, (3,), dtype=torch.float32)

    def _attn_blocks(self):
        n = self.n_levels
        return ([getattr(self, f"down_attn_{i}") for i in range(n)] + [self.mid_attn]
                + [getattr(self, f"up_attn_{i}") for i in range(n)])

    def conds(self, text, text_mask, proms, prom_mask):
        """One conditioning stream, prompt tower then text tower → (cond,
        cond_mask)."""
        te, pe = tower_inputs(self, text, text_mask, proms, prom_mask)
        cond = torch.cat([self.prom_tower(pe, prom_mask), self.text_tower(te, text_mask)], dim=1)
        return cond, torch.cat([prom_mask, text_mask], dim=1).float().contiguous()

    def cond_kv(self, cond, cond_mask, spkr_cond=None, prom_mask=None):
        """Every cross-attention's K/V of the stream, with its key mask."""
        cond = cond.to(self.dtype)
        return [blk.kv(cond) for blk in self._attn_blocks()], cond_mask

    def denoise_with_kv(self, x_t, resp_mask, t, kv):
        kv_list, cond_mask = kv
        n = self.n_levels
        down_kv, mid_kv, up_kv = kv_list[:n], kv_list[n], kv_list[n + 1:]
        dt = self.dtype
        t_emb = self.time_mlp(self.time_emb(t)).to(dt)
        x = self.conv_in(x_t.to(dt) * resp_mask[..., None].to(dt))
        mask = resp_mask
        skips, masks = [], []
        for i in range(n):
            x = getattr(self, f"down_res_{i}")(x, t_emb, mask)
            x = getattr(self, f"down_attn_{i}")(x, down_kv[i], mask, cond_mask)
            skips.append(x)
            masks.append(mask)
            if i < n - 1:
                x = getattr(self, f"down_{i}")(x)
                mask = _downsample_mask(mask)
                x = x * mask[..., None].to(x.dtype)
        x = self.mid_res1(x, t_emb, mask)
        x = self.mid_attn(x, mid_kv, mask, cond_mask)
        x = self.mid_res2(x, t_emb, mask)
        for i in range(n):
            if i > 0:
                x = getattr(self, f"up_{i - 1}")(x)
                mask = masks[-i - 1]
                x = x[:, : mask.shape[1]] * mask[..., None].to(x.dtype)
                x = torch.cat([x, skips[-i - 1]], dim=-1)
            x = getattr(self, f"up_res_{i}")(x, t_emb, mask)
            x = getattr(self, f"up_attn_{i}")(x, up_kv[i], mask, cond_mask)
        x = F.silu(self.norm_out(x, mask))
        eps = self.conv_out(x.float())
        return eps * resp_mask[..., None]

    def denoise(self, x_t, resp_mask, t, cond, cond_mask, spkr_cond=None, prom_mask=None):
        return self.denoise_with_kv(x_t, resp_mask, t, self.cond_kv(cond, cond_mask))

    def forward(self, text, text_mask, proms, prom_mask, x_t, resp_mask, t):
        cond, cond_mask = self.conds(text, text_mask, proms, prom_mask)
        return self.denoise(x_t, resp_mask, t, cond, cond_mask)
