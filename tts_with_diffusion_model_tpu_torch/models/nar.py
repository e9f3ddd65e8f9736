"""NAR model: the parallel residual-level (2..8) codec-token filler
(counterpart of ``models/nar.py`` in the JAX package): a non-causal AdaLN
backbone over 7 response levels.  Inference only: level n is predicted from
levels < n in one forward, n = 1..7.
"""

from __future__ import annotations

import torch
from torch import nn

from .base import Base, sample_categorical


class NAR(nn.Module):
    n_resp_levels = 7

    def __init__(self, n_tokens: int, d_model: int = 512, n_heads: int = 8,
                 n_layers: int = 12, dtype=torch.bfloat16):
        super().__init__()
        self.n_tokens = n_tokens
        self.base = Base(n_tokens, d_model, n_heads, n_layers,
                         n_resp_levels=self.n_resp_levels, dtype=dtype)

    def forward_level(self, text, text_mask, proms, prom_mask, resps, resp_mask, n_known: int):
        """Predict level ``n_known`` from levels < n_known → resp-position
        logits (B, Tr, V).  ``resps``: (B, Tr, 7), levels ≥ n_known are junk."""
        B = text.shape[0]
        lvl = torch.arange(self.n_resp_levels, device=text.device)
        level_mask = (lvl[None, :] < n_known).float().expand(B, self.n_resp_levels)
        quant = torch.full((B,), n_known - 1, dtype=torch.long, device=text.device)
        logits = self.base(text, text_mask, proms, prom_mask, resps, resp_mask,
                           resp_level_mask=level_mask, quant_levels=quant)
        return logits[:, -resps.shape[1]:, :]


@torch.no_grad()
def nar_generate(model: NAR, text, text_mask, proms, prom_mask, resp_level0, resp_mask,
                 keys, sampling_temperature: float = 0.2):
    """Fill levels 1..7 given level 0 → (B, Tr, 8) codes.  Level n's Gumbel
    noise is ``keys.fold(n)``'s draw, row by row."""
    B, Tr = resp_level0.shape
    buf = torch.zeros((B, Tr, model.n_resp_levels), dtype=torch.long, device=resp_level0.device)
    buf[..., 0] = resp_level0
    out = [resp_level0.long()]
    for n_known in range(1, model.n_resp_levels + 1):
        logits = model.forward_level(text, text_mask, proms, prom_mask, buf, resp_mask, n_known)
        if sampling_temperature <= 0:
            sampled = sample_categorical(logits, 0.0)
        else:
            noise = keys.fold(n_known).gumbel(logits.shape[1:], logits.device)
            sampled = sample_categorical(logits, sampling_temperature, gumbel_noise=noise)
        sampled = torch.where(resp_mask > 0, sampled, 0)
        out.append(sampled)
        if n_known < model.n_resp_levels:
            buf[..., n_known] = sampled
    return torch.stack(out, dim=-1)
