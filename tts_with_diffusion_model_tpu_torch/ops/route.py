"""Which attention runs: the one place the port's models choose between the
two Hopper kernels (each wrapper runs its plain version for CPU tensors),
and which route a call takes on the card.

* grad enabled and an input that requires grad: the training kernel,
  forward and backward (``train_flash_attention``);
* otherwise (serving, eval under ``no_grad``): the forward-only kernel
  (``masked_attention``), or the training kernel's forward for a causal
  call, which the forward-only kernel does not take.

Inside a wrapper, on a CUDA tensor, by dtype, alignment and the head width
Dh (``tensor_core_route``; the libraries' rule is
``hopper::tensor_core_route`` in ``csrc/hopper_attention.cuh``):

* bf16: the tensor cores (wgmma fed by TMA), at the next of the
  instantiated widths 8, 16, 32, 64, 128 and 256 up, when every tensor is
  ``tma_aligned``; bf16 views at a multiple of 8 that are not: the SIMT
  kernels.  A width that is not a multiple of 8 is the wrappers' to
  handle, and only theirs: they launch it on contiguous zero-padded copies
  at the next multiple of 8 with its own Dh^-0.5
  (``masked_attention.pad_for_tensor_cores``) and slice the results back,
  so it always takes the tensor cores; the libraries refuse it unpadded;
* fp32: the SIMT kernels, at any Dh;
* a head wider than ``masked_attention.MAX_DH`` (256): no kernel; the
  wrapper raises.  No route is a fallback from a failed build or launch:
  those raise too.

The JAX package sends only the DiT self-attention under ``attn_impl:
flash`` to its training kernel and everything else to XLA's dense path;
the port has no dense path on the card, so every differentiated attention
takes the training kernel whatever ``attn_impl`` says.
"""

from __future__ import annotations

import torch

from . import masked_attention as _serve
from . import train_flash_attention as _train
from .masked_attention import check_kernel_width


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
    """True when a wrapper's call runs on the tensor cores (wgmma fed by
    TMA), False when it runs the SIMT kernels, for tensors that are
    ``tma_aligned`` or not (``aligned``).  bf16 takes the tensor cores when
    aligned, and at a width that is not a multiple of 8 always (the
    wrappers' padded copies are aligned); fp32 takes SIMT.  Raises
    ValueError for a head wider than ``masked_attention.MAX_DH``, as the
    wrappers do."""
    check_kernel_width(Dh)
    return dtype == torch.bfloat16 and (bool(aligned) or Dh % 8 != 0)
