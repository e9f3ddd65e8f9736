"""NAR model: the parallel residual-level (2..8) codec-token filler
(counterpart of ``models/nar.py`` in the JAX package): a non-causal AdaLN
backbone over 7 response levels, with its loss on response slots only.

Training samples a level l per batch row, feeds levels ≤ l and predicts
level l + 1 (``forward``); inference predicts level n from levels < n in one
forward, n = 1..7 (``forward_level``, ``nar_generate``).
"""

from __future__ import annotations

import torch
from torch import nn

from .base import Base, build_targets, masked_cross_entropy, sample_categorical


class NAR(nn.Module):
    n_resp_levels = 7

    def __init__(self, n_tokens: int, d_model: int = 512, n_heads: int = 8,
                 n_layers: int = 12, p_dropout: float = 0.1, remat: bool = True,
                 remat_policy=None, attn_impl=None, dtype=torch.bfloat16):
        """``attn_impl`` is read for compatibility: every attention takes the
        route of ``ops/route.py`` whatever it says."""
        super().__init__()
        self.n_tokens = n_tokens
        self.base = Base(n_tokens, d_model, n_heads, n_layers, p_dropout=p_dropout,
                         causal=False, n_resp_levels=self.n_resp_levels, use_stop_token=False,
                         norm_type="adaln", remat=remat, remat_policy=remat_policy,
                         dtype=dtype)

    def forward(self, text, text_mask, proms, prom_mask, resps, resp_mask, quant_levels,
                generator=None):
        """Training forward.  ``resps``: (B, Tr, 8) all levels;
        ``quant_levels``: (B,) level l in [0, 7) per row.  A ``generator``
        turns dropout on.  Returns (logits, {"nll": loss})."""
        lvl = torch.arange(self.n_resp_levels, device=text.device)
        level_mask = (lvl[None, :] <= quant_levels[:, None]).float()
        targ = resps.gather(-1, (quant_levels + 1)[:, None, None].expand(-1, resps.shape[1], 1))
        logits = self.base(text, text_mask, proms, prom_mask, resps[..., :self.n_resp_levels],
                           resp_mask, resp_level_mask=level_mask, quant_levels=quant_levels,
                           generator=generator)
        targets = build_targets(text, text_mask, prom_mask, targ[..., 0], resp_mask,
                                resp_loss_only=True, shift=False, stop_token=None)
        return logits, {"nll": masked_cross_entropy(logits, targets)}

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
