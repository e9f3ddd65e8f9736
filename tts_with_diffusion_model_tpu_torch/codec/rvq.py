"""Residual vector quantization (counterpart of ``codec/rvq.py`` in the JAX
package): nearest-code encode on the residual, summed-codebook decode."""

from __future__ import annotations

import torch
from torch import nn


def nearest_code(x, codebook):
    """x: (..., D); codebook: (K, D) → (...,) int64 ids of the nearest code
    (argmin of |E|² − 2·x·E; |x|² is constant in the argmin)."""
    dots = torch.einsum("...d,kd->...k", x.float(), codebook.float())
    code_sq = (codebook.float() ** 2).sum(dim=-1)
    return torch.argmin(code_sq - 2.0 * dots, dim=-1)


class ResidualVQ(nn.Module):
    def __init__(self, n_q: int = 32, bins: int = 1024, dim: int = 128):
        super().__init__()
        self.dim = dim
        self.codebooks = nn.Parameter(torch.zeros(n_q, bins, dim))

    def encode(self, x, num_quantizers: int):
        """x: (B, T, D) latents → codes (B, num_quantizers, T)."""
        residual = x.float()
        codes = []
        for q in range(num_quantizers):
            idx = nearest_code(residual, self.codebooks[q])
            residual = residual - self.codebooks[q][idx]
            codes.append(idx)
        return torch.stack(codes, dim=1)

    def decode(self, codes):
        """codes: (B, Q, T) → latents (B, T, D)."""
        out = torch.zeros((codes.shape[0], codes.shape[2], self.dim),
                          dtype=torch.float32, device=codes.device)
        for q in range(codes.shape[1]):
            out = out + self.codebooks[q][codes[:, q]]
        return out
