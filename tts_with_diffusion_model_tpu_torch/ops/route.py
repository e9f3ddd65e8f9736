"""Which attention runs: the one place the port's models choose between the
two Hopper kernels (each wrapper runs its plain version for CPU tensors),
and which route a call takes on the card.

* grad enabled and an input that requires grad: the training kernel,
  forward and backward (``train_flash_attention``);
* otherwise (serving, eval under ``no_grad``): the forward-only kernel
  (``masked_attention``), or the training kernel's forward for a causal
  call, which the forward-only kernel does not take.

Inside a wrapper, on a CUDA tensor, by the head width Dh (one rule in
Python and in ``csrc/hopper_attention.cuh``):

* bf16 at a multiple of 8 up to ``MAX_TC_DH`` (128) with every tensor
  ``tma_aligned``: the tensor cores (wgmma fed by TMA), at the next of the
  instantiated widths 8, 16, 32, 64 and 128 up;
* fp32, unaligned views, and the other widths up to ``MAX_DH`` (256; not
  a multiple of 8, or past 128): the SIMT kernels
  (``tensor_core_route``);
* a wider head: no kernel; the wrapper raises.  No route is a fallback
  from a failed build or launch: those raise too.

The JAX package sends only the DiT self-attention under ``attn_impl:
flash`` to its training kernel and everything else to XLA's dense path;
the port has no dense path on the card, so every differentiated attention
takes the training kernel whatever ``attn_impl`` says.
"""

from __future__ import annotations

import torch

from . import masked_attention as _serve
from . import train_flash_attention as _train
from .masked_attention import MAX_DH, kernel_width

#: the widest head on the tensor cores (``hopper::kTcDhMax``)
MAX_TC_DH = 128


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
    runs the SIMT kernels.  bf16 at a multiple of 8 up to ``MAX_TC_DH``
    (``hopper::tc_width``) with every tensor ``tma_aligned`` takes the
    tensor cores; fp32, unaligned views and the other widths up to
    ``MAX_DH`` take SIMT.  Raises ValueError for a width no kernel takes
    (not ``kernel_width``), as the wrappers do."""
    if not kernel_width(Dh):
        raise ValueError(f"head width {Dh}: no attention kernel takes a head wider than {MAX_DH}")
    return (dtype == torch.bfloat16 and bool(aligned)
            and Dh % 8 == 0 and 8 <= Dh <= MAX_TC_DH)
