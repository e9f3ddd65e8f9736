"""Which attention runs: the one place the port's models choose between the
two Hopper kernels (each wrapper runs its plain version for CPU tensors).

* grad enabled and an input that requires grad: the training kernel,
  forward and backward (``train_flash_attention``);
* otherwise (serving, eval under ``no_grad``): the forward-only kernel
  (``masked_attention``), or the training kernel's forward for a causal
  call, which the forward-only kernel does not take.

The JAX package sends only the DiT self-attention under ``attn_impl:
flash`` to its training kernel and everything else to XLA's dense path;
the port has no dense path on the card, so every differentiated attention
takes the training kernel whatever ``attn_impl`` says.
"""

from __future__ import annotations

import torch

from . import masked_attention as _serve
from . import train_flash_attention as _train


def attend(q, k, v, kv_mask, causal: bool = False):
    """Key-masked attention over (B, T, H, Dh) tensors, routed as above."""
    needs_grad = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
    if needs_grad or causal:
        return _train.train_flash_attention(q, k, v, kv_mask, causal)
    return _serve.masked_attention(q, k, v, kv_mask)
