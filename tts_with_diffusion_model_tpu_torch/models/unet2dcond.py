"""The published ``UNet2DConditionModel`` topology as a Gaussian denoiser
(counterpart of ``models/unet2dcond.py`` in the JAX package; registry name
``diffusion-gaussian-unet2d-ref``, value domain).

The utterance is a (B, 1, Tr, 1) channel-last image.  Topology (diffusers
defaults for block widths (320, 640, 1280, 1280)): conv_in 3×3; down blocks
of two ResnetBlock2D each, with a Transformer2D after every resnet but in
the last block, and a 3×3 stride-2 conv between blocks; mid res / attn /
res; up blocks of three resnets over the skip stack (attention in all but
the first), nearest up-sampling pinned to the next skip's width then a 3×3
conv; GroupNorm → SiLU → conv 3×3 out.  The conditioning is two tokens:
the whole prompt's codes flattened through an MLP and a 10-layer encoder,
the text ids through an MLP and a 4-layer encoder, lifted to the
1280-wide cross stream.

``Attention`` has no mask (head widths 40, 80 and 160 at the published
widths).  The JAX package computes it with einsums in XLA, outside any
Pallas kernel, so it is no Pallas site to port and stays a plain PyTorch
product here, as the AR's cached decode attention does: nothing in this
module launches a kernel.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .base import Conv, Dense, GroupNorm, LayerNorm


def _gn_groups(ch: int, want: int = 32) -> int:
    """Largest divisor of ``ch`` not exceeding the diffusers default 32."""
    g = min(want, ch)
    while ch % g:
        g -= 1
    return g


class GroupNorm32(nn.Module):
    """GroupNorm with fp32 statistics whatever the compute dtype, output in
    x's dtype (the flax module's child is ``GroupNorm_0``)."""

    def __init__(self, ch: int, eps: float = 1e-5):
        super().__init__()
        self.GroupNorm_0 = GroupNorm(_gn_groups(ch), ch, eps)

    def forward(self, x):
        return self.GroupNorm_0(x).to(x.dtype)


def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """diffusers ``Timesteps(dim, flip_sin_to_cos=True, freq_shift=0)``:
    ``[cos | sin]`` halves, max period 1e4, fp32."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    ang = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1)


class _CastLayerNorm(LayerNorm):
    """flax ``LayerNorm(dtype=...)``: eps 1e-6, fp32 statistics, output in
    ``dtype``."""

    def __init__(self, d: int, dtype):
        super().__init__(d, 1e-6)
        self.out_dtype = dtype

    def forward(self, x):
        y = super().forward(x)
        return y if self.out_dtype is None else y.to(self.out_dtype)


class ResnetBlock2D(nn.Module):
    """GN → SiLU → conv3×3 → (+time) → GN → SiLU → conv3×3, 1×1 shortcut."""

    def __init__(self, d_in: int, ch: int, d_t: int, dtype=None):
        super().__init__()
        self.norm1 = GroupNorm32(d_in)
        self.conv1 = Conv(d_in, ch, (3, 3), dtype=dtype)
        self.time_emb_proj = Dense(d_t, ch, dtype=dtype)
        self.norm2 = GroupNorm32(ch)
        self.conv2 = Conv(ch, ch, (3, 3), dtype=dtype)
        self.conv_shortcut = Conv(d_in, ch, (1, 1), dtype=dtype) if d_in != ch else None

    def forward(self, x, t_emb):
        h = self.conv1(F.silu(self.norm1(x)))
        h = h + self.time_emb_proj(F.silu(t_emb))[:, None, None, :]
        h = self.conv2(F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class GEGLUFeedForward(nn.Module):
    """Dense → GEGLU gate (tanh GELU, flax's default) → Dense, inner 4×ch."""

    def __init__(self, ch: int, dtype=None):
        super().__init__()
        self.proj_in = Dense(ch, ch * 8, dtype=dtype)
        self.proj_out = Dense(ch * 4, ch, dtype=dtype)

    def forward(self, x):
        h, gate = self.proj_in(x).chunk(2, dim=-1)
        return self.proj_out(h * F.gelu(gate, approximate="tanh"))


class Attention(nn.Module):
    """Multi-head attention, q from ``x``, k / v from ``ctx`` (or ``x``),
    no mask, plain PyTorch (see the module docstring): scores in the compute
    dtype, softmax in fp32."""

    def __init__(self, ch: int, n_heads: int, d_ctx: int | None = None, dtype=None):
        super().__init__()
        d_ctx = ch if d_ctx is None else d_ctx
        self.ch, self.n_heads = ch, n_heads
        self.q = Dense(ch, ch, bias=False, dtype=dtype)
        self.k = Dense(d_ctx, ch, bias=False, dtype=dtype)
        self.v = Dense(d_ctx, ch, bias=False, dtype=dtype)
        self.out = Dense(ch, ch, dtype=dtype)

    def forward(self, x, ctx=None):
        ctx = x if ctx is None else ctx
        H, d = self.n_heads, self.ch // self.n_heads

        def sh(a):
            return a.reshape(*a.shape[:-1], H, d)

        q, k, v = sh(self.q(x)), sh(self.k(ctx)), sh(self.v(ctx))
        att = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(d)
        att = torch.softmax(att.float(), dim=-1).to(q.dtype)
        o = torch.einsum("bhqk,bkhd->bqhd", att, v)
        return self.out(o.reshape(*o.shape[:-2], self.ch))


class BasicTransformerBlock(nn.Module):
    """LN → self-attn, LN → cross-attn (the 1280-wide stream), LN → GEGLU FF."""

    def __init__(self, ch: int, n_heads: int, d_ctx: int, dtype=None):
        super().__init__()
        self.norm1 = _CastLayerNorm(ch, dtype)
        self.attn1 = Attention(ch, n_heads, dtype=dtype)
        self.norm2 = _CastLayerNorm(ch, dtype)
        self.attn2 = Attention(ch, n_heads, d_ctx, dtype=dtype)
        self.norm3 = _CastLayerNorm(ch, dtype)
        self.ff = GEGLUFeedForward(ch, dtype)

    def forward(self, x, ctx):
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), ctx)
        return x + self.ff(self.norm3(x))


class Transformer2D(nn.Module):
    """GN → 1×1 proj_in → H·W tokens → block → 1×1 proj_out + residual."""

    def __init__(self, ch: int, n_heads: int, d_ctx: int, dtype=None):
        super().__init__()
        self.norm = GroupNorm32(ch, eps=1e-6)
        self.proj_in = Conv(ch, ch, (1, 1), dtype=dtype)
        self.block0 = BasicTransformerBlock(ch, n_heads, d_ctx, dtype)
        self.proj_out = Conv(ch, ch, (1, 1), dtype=dtype)

    def forward(self, x, ctx):
        B, H, W, C = x.shape
        h = self.proj_in(self.norm(x)).reshape(B, H * W, C)
        h = self.block0(h, ctx).reshape(B, H, W, C)
        return self.proj_out(h) + x


def _resize_nearest(x, width: int):
    """``jax.image.resize(..., "nearest")`` along the width of (B, H, W, C):
    source index floor((i + 0.5)·W_in/W_out), computed in fp32."""
    n_in = x.shape[2]
    if n_in == width:
        return x
    idx = torch.floor((torch.arange(width, dtype=torch.float32) + 0.5) * n_in / width).long()
    return x[:, :, idx.to(x.device)]


class UNet2DConditionNet(nn.Module):
    """sample (B, H, W, C_in) + t (B,) + stream (B, S, cross_dim) → ε̂
    (B, H, W, C_out)."""

    def __init__(self, block_out_channels=(320, 640, 1280, 1280), layers_per_block: int = 2,
                 n_heads: int = 8, cross_dim: int = 1280, in_channels: int = 1,
                 out_channels: int = 1, dtype=torch.bfloat16):
        super().__init__()
        chs = list(block_out_channels)
        self.chs, self.layers_per_block, self.dtype = chs, layers_per_block, dtype
        n = len(chs)
        d_t = chs[0] * 4
        self.time_dense1 = Dense(chs[0], d_t, dtype=dtype)
        self.time_dense2 = Dense(d_t, d_t, dtype=dtype)
        self.conv_in = Conv(in_channels, chs[0], (3, 3), dtype=dtype)
        skip_ch, c_prev = [chs[0]], chs[0]
        for i, ch in enumerate(chs):
            for j in range(layers_per_block):
                self.add_module(f"down_{i}_res_{j}", ResnetBlock2D(c_prev, ch, d_t, dtype))
                c_prev = ch
                if i < n - 1:
                    self.add_module(f"down_{i}_attn_{j}",
                                    Transformer2D(ch, n_heads, cross_dim, dtype))
                skip_ch.append(ch)
            if i < n - 1:
                self.add_module(f"down_{i}_downsample", Conv(ch, ch, (3, 3), (2, 2), dtype=dtype))
                skip_ch.append(ch)
        self.mid_res_0 = ResnetBlock2D(chs[-1], chs[-1], d_t, dtype)
        self.mid_attn = Transformer2D(chs[-1], n_heads, cross_dim, dtype)
        self.mid_res_1 = ResnetBlock2D(chs[-1], chs[-1], d_t, dtype)
        c_prev = chs[-1]
        for i, ch in enumerate(reversed(chs)):
            for j in range(layers_per_block + 1):
                self.add_module(f"up_{i}_res_{j}",
                                ResnetBlock2D(c_prev + skip_ch.pop(), ch, d_t, dtype))
                c_prev = ch
                if i > 0:
                    self.add_module(f"up_{i}_attn_{j}",
                                    Transformer2D(ch, n_heads, cross_dim, dtype))
            if i < n - 1:
                self.add_module(f"up_{i}_upsample", Conv(ch, ch, (3, 3), dtype=dtype))
        self.norm_out = GroupNorm32(chs[0])
        self.conv_out = Conv(chs[0], out_channels, (3, 3), dtype=torch.float32)

    def forward(self, sample, t, encoder_hidden_states):
        dt, chs, n = self.dtype, self.chs, len(self.chs)
        t_emb = self.time_dense1(timestep_embedding(t, chs[0]).to(dt))
        t_emb = self.time_dense2(F.silu(t_emb))
        ctx = encoder_hidden_states.to(dt)
        x = self.conv_in(sample.to(dt))
        skips = [x]
        for i in range(n):
            for j in range(self.layers_per_block):
                x = getattr(self, f"down_{i}_res_{j}")(x, t_emb)
                if i < n - 1:
                    x = getattr(self, f"down_{i}_attn_{j}")(x, ctx)
                skips.append(x)
            if i < n - 1:
                x = getattr(self, f"down_{i}_downsample")(x)
                skips.append(x)
        x = self.mid_res_0(x, t_emb)
        x = self.mid_attn(x, ctx)
        x = self.mid_res_1(x, t_emb)
        for i in range(n):
            for j in range(self.layers_per_block + 1):
                x = torch.cat([x, skips.pop()], dim=-1)
                x = getattr(self, f"up_{i}_res_{j}")(x, t_emb)
                if i > 0:
                    x = getattr(self, f"up_{i}_attn_{j}")(x, ctx)
            if i < n - 1:
                x = _resize_nearest(x, skips[-1].shape[2])
                x = getattr(self, f"up_{i}_upsample")(x)
        x = F.silu(self.norm_out(x))
        return self.conv_out(x.float())


class MLP(nn.Module):
    """Dense → SiLU → Dense (the conditioning projector)."""

    def __init__(self, d_in: int, hidden: int, out: int, dtype=None):
        super().__init__()
        self.fc1 = Dense(d_in, hidden, dtype=dtype)
        self.fc2 = Dense(hidden, out, dtype=dtype)

    def forward(self, x):
        return self.fc2(F.silu(self.fc1(x)))


class EncoderStack(nn.Module):
    """Self-attention encoder over the (short) conditioning sequence."""

    def __init__(self, ch: int, n_layers: int, n_heads: int, mlp_mult: int, dtype=None):
        super().__init__()
        self.n_layers = n_layers
        for i in range(n_layers):
            self.add_module(f"ln_{i}", _CastLayerNorm(ch, dtype))
            self.add_module(f"attn_{i}", Attention(ch, n_heads, dtype=dtype))
            self.add_module(f"ln2_{i}", _CastLayerNorm(ch, dtype))
            self.add_module(f"ff_{i}", GEGLUFeedForward(ch, dtype))
        self.out_mlp = MLP(ch, ch * mlp_mult, ch, dtype)

    def forward(self, x):
        for i in range(self.n_layers):
            x = x + getattr(self, f"attn_{i}")(getattr(self, f"ln_{i}")(x))
            x = x + getattr(self, f"ff_{i}")(getattr(self, f"ln2_{i}")(x))
        return self.out_mlp(x)


class UNet2DCondDenoiser(nn.Module):
    """The full denoiser stack behind the ``conds`` / ``cond_kv`` /
    ``denoise_with_kv`` interface of ``GaussianDiffusionModel`` (value
    domain, ``in_dim == 1``)."""

    def __init__(self, in_dim: int, d_model: int, n_heads: int, n_classes: int,
                 n_prom_levels: int, timesteps: int, text_len: int, prom_len: int,
                 channels=(320, 640, 1280, 1280), enc_text_layers: int = 4,
                 enc_prom_layers: int = 10, dtype=torch.bfloat16):
        super().__init__()
        del timesteps  # the sinusoidal time embedding has no table
        self.n_classes, self.dtype = n_classes, dtype
        d = d_model
        flat = prom_len * n_prom_levels
        self.condition1_proj = MLP(flat, min(2 * flat, 4 * d), d, dtype)
        self.condition2_proj = MLP(text_len, 2 * d, d, dtype)
        self.encodertext = EncoderStack(d, enc_text_layers, 4, 2, dtype)
        self.encoder2 = EncoderStack(d, enc_prom_layers, 4, 3, dtype)
        self.encoder_hid_proj = Dense(d, 1280, dtype=dtype)
        self.unet = UNet2DConditionNet(block_out_channels=tuple(channels), n_heads=n_heads,
                                       in_channels=in_dim, out_channels=in_dim, dtype=dtype)

    def conds(self, text, text_mask, proms, prom_mask):
        """The prompt's normalized codes flattened → MLP → encoder, the text
        ids → MLP → encoder: a 2-token stream → (cond, all-ones mask)."""
        dt, B = self.dtype, text.shape[0]
        pflat = (proms * prom_mask[..., None]).float()
        pflat = (pflat / (self.n_classes - 1) * 2.0 - 1.0).reshape(B, -1)
        cond1 = self.encoder2(self.condition1_proj(pflat.to(dt))[:, None])
        tval = (text * text_mask).float() / max(self.n_classes - 1, 1)
        cond2 = self.encodertext(self.condition2_proj(tval.to(dt))[:, None])
        cond = torch.cat([cond1, cond2], dim=1)
        return cond, torch.ones((B, 2), dtype=torch.float32, device=text.device)

    def cond_kv(self, cond, cond_mask, spkr_cond=None, prom_mask=None):
        """The UNet's cross stream, once per utterance."""
        return self.encoder_hid_proj(cond)

    def denoise_with_kv(self, x_t, resp_mask, t, ctx):
        m = resp_mask[..., None]
        sample = (x_t * m)[:, None]  # (B, 1, Tr, in_dim)
        return self.unet(sample, t, ctx)[:, 0] * m

    def denoise(self, x_t, resp_mask, t, cond, cond_mask, spkr_cond=None, prom_mask=None):
        return self.denoise_with_kv(x_t, resp_mask, t, self.cond_kv(cond, cond_mask))

    def forward(self, text, text_mask, proms, prom_mask, x_t, resp_mask, t):
        cond, cm = self.conds(text, text_mask, proms, prom_mask)
        return self.denoise(x_t, resp_mask, t, cond, cm)
