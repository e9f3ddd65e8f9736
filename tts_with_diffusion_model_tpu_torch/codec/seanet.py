"""SEANet encoder/decoder of the EnCodec-24kHz-compatible codec (counterpart
of ``codec/seanet.py`` in the JAX package).

Causal, weight-normalised convolutions (w = g·v/‖v‖, composed at call time),
reflect padding with the JAX package's short-input rule, ELU, and a 2-layer
residual LSTM.  Tensors run in torch's (B, C, T) layout inside; the public
``SEANetEncoder`` / ``SEANetDecoder`` take and return the JAX package's
(B, T, C).  Parameters keep torch layouts: a conv's ``v`` is (Cout, Cin, K),
a transposed conv's (Cin, Cout, K), ``g`` is (dim 0 of v, 1, 1).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def _weight_norm(v, g):
    norm = torch.sqrt((v.float() ** 2).sum(dim=(1, 2), keepdim=True))
    return (g / norm.clamp_min(1e-12)) * v


def pad1d(x, pad_left: int, pad_right: int, mode: str = "reflect"):
    """Pad (B, C, T) along T; a reflect pad wider than the input zero-pads
    the input first, then trims that extra off."""
    if mode == "reflect":
        T = x.shape[-1]
        max_pad = max(pad_left, pad_right)
        extra = 0
        if T <= max_pad:
            extra = max_pad - T + 1
            x = F.pad(x, (0, extra))
        y = F.pad(x, (pad_left, pad_right), mode="reflect")
        return y[..., : y.shape[-1] - extra] if extra else y
    return F.pad(x, (pad_left, pad_right))


def extra_padding_for_frames(length: int, kernel: int, stride: int, pad_total: int) -> int:
    n_frames = (length - kernel + pad_total) / stride + 1
    ideal = (math.ceil(n_frames) - 1) * stride + (kernel - pad_total)
    return max(0, ideal - length)


class StreamableConv1d(nn.Module):
    """Causal weight-normed Conv1d, (B, Cin, T) → (B, Cout, T')."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1,
                 dilation: int = 1, pad_mode: str = "reflect"):
        super().__init__()
        self.v = nn.Parameter(torch.zeros(out_ch, in_ch, kernel))
        self.g = nn.Parameter(torch.ones(out_ch, 1, 1))
        self.b = nn.Parameter(torch.zeros(out_ch))
        self.kernel, self.stride, self.dilation, self.pad_mode = kernel, stride, dilation, pad_mode

    def forward(self, x):
        k_eff = (self.kernel - 1) * self.dilation + 1
        pad_total = k_eff - self.stride
        extra = extra_padding_for_frames(x.shape[-1], k_eff, self.stride, pad_total)
        x = pad1d(x, pad_total, extra, self.pad_mode)
        return F.conv1d(x, _weight_norm(self.v, self.g), self.b,
                        stride=self.stride, dilation=self.dilation)


class StreamableConvTranspose1d(nn.Module):
    """Causal weight-normed transposed Conv1d; trims the ``kernel - stride``
    overhang on the right."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1):
        super().__init__()
        self.v = nn.Parameter(torch.zeros(in_ch, out_ch, kernel))
        self.g = nn.Parameter(torch.ones(in_ch, 1, 1))
        self.b = nn.Parameter(torch.zeros(out_ch))
        self.kernel, self.stride = kernel, stride

    def forward(self, x):
        y = F.conv_transpose1d(x, _weight_norm(self.v, self.g), self.b, stride=self.stride)
        pad_total = self.kernel - self.stride
        return y[..., : y.shape[-1] - pad_total] if pad_total > 0 else y


class SEANetResnetBlock(nn.Module):
    """[ELU → Conv(k3, dim→dim/2) → ELU → Conv(k1, dim/2→dim)] + 1×1 conv
    shortcut."""

    def __init__(self, dim: int, compress: int = 2, pad_mode: str = "reflect"):
        super().__init__()
        hidden = dim // compress
        self.conv1 = StreamableConv1d(dim, hidden, 3, pad_mode=pad_mode)
        self.conv2 = StreamableConv1d(hidden, dim, 1, pad_mode=pad_mode)
        self.shortcut = StreamableConv1d(dim, dim, 1, pad_mode=pad_mode)

    def forward(self, x):
        h = self.conv2(F.elu(self.conv1(F.elu(x))))
        return self.shortcut(x) + h


class ResidualLSTM(nn.Module):
    """2-layer LSTM with a residual connection over the stack, (B, C, T).
    torch gate order (i, f, g, o); the JAX package's single bias per layer
    is ``bias_ih`` and ``bias_hh`` is zero."""

    def __init__(self, dim: int, num_layers: int = 2):
        super().__init__()
        self.lstm = nn.LSTM(dim, dim, num_layers=num_layers, batch_first=True)

    def forward(self, x):
        y, _ = self.lstm(x.transpose(1, 2).float())
        return x + y.transpose(1, 2)


class SEANetEncoder(nn.Module):
    def __init__(self, channels: int = 1, dimension: int = 128, n_filters: int = 32,
                 ratios=(8, 5, 4, 2), pad_mode: str = "reflect"):
        super().__init__()
        self.ratios = tuple(ratios)
        self.conv_in = StreamableConv1d(channels, n_filters, 7, pad_mode=pad_mode)
        mult = 1
        for i, ratio in enumerate(reversed(self.ratios)):
            ch = mult * n_filters
            self.add_module(f"block_{i}", SEANetResnetBlock(ch, pad_mode=pad_mode))
            self.add_module(f"down_{i}", StreamableConv1d(ch, 2 * ch, 2 * ratio, stride=ratio,
                                                          pad_mode=pad_mode))
            mult *= 2
        ch = mult * n_filters
        self.lstm = ResidualLSTM(ch)
        self.conv_out = StreamableConv1d(ch, dimension, 7, pad_mode=pad_mode)

    def forward(self, x):
        """x: (B, T, 1) waveform → (B, frames, dimension)."""
        h = self.conv_in(x.transpose(1, 2))
        for i in range(len(self.ratios)):
            h = getattr(self, f"block_{i}")(h)
            h = getattr(self, f"down_{i}")(F.elu(h))
        h = self.conv_out(F.elu(self.lstm(h)))
        return h.transpose(1, 2)


class SEANetDecoder(nn.Module):
    def __init__(self, channels: int = 1, dimension: int = 128, n_filters: int = 32,
                 ratios=(8, 5, 4, 2), pad_mode: str = "reflect"):
        super().__init__()
        self.ratios = tuple(ratios)
        mult = 2 ** len(self.ratios)
        ch = mult * n_filters
        self.conv_in = StreamableConv1d(dimension, ch, 7, pad_mode=pad_mode)
        self.lstm = ResidualLSTM(ch)
        for i, ratio in enumerate(self.ratios):
            ch = mult * n_filters
            self.add_module(f"up_{i}", StreamableConvTranspose1d(ch, ch // 2, 2 * ratio, stride=ratio))
            self.add_module(f"block_{i}", SEANetResnetBlock(ch // 2, pad_mode=pad_mode))
            mult //= 2
        self.conv_out = StreamableConv1d(n_filters, channels, 7, pad_mode=pad_mode)

    def forward(self, z):
        """z: (B, frames, dimension) → (B, T, 1) waveform."""
        h = self.lstm(self.conv_in(z.transpose(1, 2)))
        for i in range(len(self.ratios)):
            h = getattr(self, f"up_{i}")(F.elu(h))
            h = getattr(self, f"block_{i}")(h)
        return self.conv_out(F.elu(h)).transpose(1, 2)
