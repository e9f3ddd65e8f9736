"""AR model: the causal level-0 codec-token generator (counterpart of
``models/ar.py`` in the JAX package): one response level, a stop token,
LayerNorm blocks and a loss over the whole packed sequence with shifted
targets.

Only the teacher-forced training forward is ported.  The incremental
decode (``prefill``, ``decode_step``, ``decode_chunk``) and ``ar_generate``
are not: they raise, naming the ROADMAP item that ports them.
"""

from __future__ import annotations

import torch
from torch import nn

from .base import Base, build_targets, masked_cross_entropy, refuse_remat_policy

_SERVING = ("the AR first stage for serving is not ported yet (ROADMAP queue 1, \"the AR "
            "first stage for serving\")")


class AR(nn.Module):
    def __init__(self, n_tokens: int, d_model: int = 512, n_heads: int = 8,
                 n_layers: int = 12, p_dropout: float = 0.1, remat: bool = True,
                 remat_policy=None, attn_impl=None, dtype=torch.bfloat16):
        """``attn_impl`` is read for compatibility: every attention takes the
        route of ``ops/route.py`` whatever it says."""
        super().__init__()
        refuse_remat_policy(remat_policy)
        self.n_tokens = n_tokens
        self.base = Base(n_tokens, d_model, n_heads, n_layers, p_dropout=p_dropout,
                         causal=True, n_resp_levels=1, use_stop_token=True, norm_type="ln",
                         remat=remat, dtype=dtype)

    @property
    def stop_token(self) -> int:
        return self.n_tokens

    def forward(self, text, text_mask, proms, prom_mask, resp, resp_mask, generator=None):
        """Teacher-forced training forward.  ``resp``: (B, Tr) level-0
        tokens.  A ``generator`` turns dropout on.  Returns (logits,
        {"nll": loss})."""
        logits = self.base(text, text_mask, proms, prom_mask, resp[..., None], resp_mask,
                           generator=generator)
        targets = build_targets(text, text_mask, prom_mask, resp, resp_mask,
                                resp_loss_only=False, shift=True, stop_token=self.stop_token)
        return logits, {"nll": masked_cross_entropy(logits, targets)}

    def prefill(self, *args, **kwargs):
        raise NotImplementedError(_SERVING)

    def decode_step(self, *args, **kwargs):
        raise NotImplementedError(_SERVING)

    def decode_chunk(self, *args, **kwargs):
        raise NotImplementedError(_SERVING)


def ar_generate(*args, **kwargs):
    raise NotImplementedError(_SERVING)
