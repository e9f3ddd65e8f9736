"""Plain masked attention (counterpart of ``ops/attention.py`` in the JAX
package): dense scores with the pair mask.

Every Hopper attention kernel of the port is tested against this path:
fp32 scores scaled by Dh^-0.5, masked entries filled with the finite
``NEG_INF`` (never ``-inf``: a fully masked row then gets a finite uniform
softmax that callers multiply away, where ``-inf`` would make it NaN and
NaN·0 stays NaN), and pair mask = q-mask ⊗ k-mask.
"""

from __future__ import annotations

import torch

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


def dense_attention(q, k, v, pair_mask=None):
    """q, k, v: (B, T, H, Dh); pair_mask: (B, Tq, Tk) 1 = attend.
    Returns (B, Tq, H, Dh) in v's dtype."""
    scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bihd,bjhd->bhij", q.float(), k.float()) * scale
    if pair_mask is not None:
        scores = torch.where(pair_mask[:, None].bool(), scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhij,bjhd->bihd", probs.to(v.dtype).float(), v.float())
    return out.to(v.dtype)


def cross_attention(q, k, v, q_mask=None, kv_mask=None):
    """Attention with independent query (B, Tq) / key (B, Tk) masks, as the
    pair mask q_mask ⊗ kv_mask."""
    pair = None
    if q_mask is not None or kv_mask is not None:
        B, Tq = q.shape[:2]
        Tk = k.shape[1]
        qm = q_mask if q_mask is not None else q.new_ones((B, Tq), dtype=torch.float32)
        km = kv_mask if kv_mask is not None else q.new_ones((B, Tk), dtype=torch.float32)
        pair = qm[:, :, None].float() * km[:, None, :].float()
    return dense_attention(q, k, v, pair_mask=pair)
