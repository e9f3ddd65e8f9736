"""Which attention runs: the one place the port's models choose between the
two Hopper kernels (each wrapper runs its plain version for CPU tensors),
and which route a kernel takes inside its library (``tensor_core_route``).

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

#: head widths the tensor-core (wgmma / TMA) path of both kernels takes
TENSOR_CORE_WIDTHS = (8, 16, 32, 64)


def attend(q, k, v, kv_mask, causal: bool = False):
    """Key-masked attention over (B, T, H, Dh) tensors, routed as above."""
    needs_grad = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
    if needs_grad or causal:
        return _train.train_flash_attention(q, k, v, kv_mask, causal)
    return _serve.masked_attention(q, k, v, kv_mask)


def tma_aligned(*tensors) -> bool:
    """The libraries' alignment rule for the tensor-core path
    (``hopper::tma_ok`` in ``csrc/hopper_attention.cuh``): each (B, T, H, Dh)
    tensor starts on 16 bytes, and its batch and time strides are multiples
    of 8 elements wherever that dimension has more than one entry."""
    return all(t.data_ptr() % 16 == 0 and
               all(t.shape[d] == 1 or t.stride(d) % 8 == 0 for d in (0, 1))
               for t in tensors)


def tensor_core_route(Dh: int, dtype: torch.dtype, aligned: bool) -> bool:
    """The rule both libraries follow (``hopper::tensor_core_route``): True
    when a call runs on the tensor cores (wgmma fed by TMA), False when it
    runs the SIMT kernels.  bf16 at a head width of 8, 16, 32 or 64 with
    every tensor ``tma_aligned`` takes the tensor cores; fp32, other widths
    (multiples of 8 up to 64) and unaligned views take SIMT.  Raises
    ValueError for a width neither kernel takes."""
    if Dh < 1 or Dh % 8 != 0 or Dh > _serve.MAX_DH:
        raise ValueError(f"head width {Dh} must be a multiple of 8, at most {_serve.MAX_DH}")
    return dtype == torch.bfloat16 and Dh in TENSOR_CORE_WIDTHS and bool(aligned)
