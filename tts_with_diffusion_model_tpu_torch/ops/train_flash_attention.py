"""Training attention (forward and backward): the Hopper kernel's autograd
wrapper, its plain version and its launch counters.

Counterpart of ``ops/attention.py::_train_flash_attention`` in the JAX
package, which calls the library Pallas TPU flash-attention kernel for the
forward and for dq, dk, dv.  The kernel (``csrc/train_flash_attention.cu``)
masks keys from a (B, Tk) validity vector and, with ``causal``, hides key j
from query i when j > i (slot causality).  Masked scores are replaced by
the finite ``NEG_INF``, so a row whose keys are all masked is a finite
uniform row, and the gradient stops at every replaced score.  Padding query
rows are not masked: every caller multiplies them away, and the gradients
are exact because dO is 0 there.

For a tensor on the CPU the wrapper runs the plain version (differentiated
by autograd); for a CUDA tensor it launches the kernel or raises, at any
head width up to ``MAX_DH`` (``kernel_width``).  The launchers report the
route each forward and backward took (tensor cores or SIMT,
``route.tensor_core_route``'s rule), counted in ``launches_tc`` and
``backward_launches_tc``.  A bf16 call at a width that is not a multiple
of 8 is launched, forward and backward, on zero-padded copies
(``masked_attention.pad_for_tensor_cores``) with the scale of its true
width, and o, dq, dk and dv sliced back.
"""

from __future__ import annotations

import ctypes

import torch

from .attention import NEG_INF
from .masked_attention import _DTYPE_CODE, check_inputs, check_kernel_width, pad_for_tensor_cores

_fns = None


def _kernels():
    global _fns
    if _fns is None:
        from . import _build

        lib = _build.load("train_flash_attention")
        fwd, bwd = lib.train_flash_attention_fwd, lib.train_flash_attention_bwd
        route_out = [ctypes.POINTER(ctypes.c_int)]
        tail = [ctypes.c_float, ctypes.c_void_p] + route_out  # scale, stream, route
        fwd.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 15 + tail
        bwd.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 17 + tail
        fwd.restype = bwd.restype = ctypes.c_int
        _fns = fwd, bwd
    return _fns


def visible(kv_mask, Tq: int, causal: bool):
    """(B, 1, Tq, Tk) bool: key j is visible from query i (valid, and j <= i
    under ``causal``)."""
    vis = kv_mask[:, None, None, :] > 0
    if causal:
        Tk = kv_mask.shape[1]
        i = torch.arange(Tq, device=kv_mask.device)[:, None]
        j = torch.arange(Tk, device=kv_mask.device)[None, :]
        vis = vis & (j <= i)
    return vis


def train_flash_attention_plain(q, k, v, kv_mask, causal: bool = False):
    """Plain PyTorch version, differentiated by autograd: fp32 scores scaled
    by Dh^-0.5, scores at masked (and, with ``causal``, hidden) keys replaced
    by ``NEG_INF``, row softmax, p cast to v's dtype, p·v accumulated in
    fp32.  q: (B, Tq, H, Dh); k, v: (B, Tk, H, Dh); kv_mask: (B, Tk).
    Returns (B, Tq, H, Dh) in v's dtype."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bihd,bjhd->bhij", q.float(), k.float()) * scale
    s = torch.where(visible(kv_mask, q.shape[1], causal), s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhij,bjhd->bihd", p.to(v.dtype).float(), v.float())
    return o.to(v.dtype)


def _heads_dense(t):
    """``t`` itself when its heads and head width are dense, else a copy."""
    Dh = t.shape[-1]
    return t if t.stride(3) == 1 and t.stride(2) == Dh else t.contiguous()


def _forward(q, k, v, kv_mask, causal: bool):
    """The forward launch → (o, lse), on padded copies at a bf16 width off 8
    (o sliced back to Dh)."""
    B, Tq, H, Dh = q.shape
    scale = Dh ** -0.5
    q, k, v = pad_for_tensor_cores(q, k, v)
    W = q.shape[-1]  # Dh, or its padded width
    Tk = k.shape[1]
    o = torch.empty((B, Tq, H, W), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
    route = ctypes.c_int(-1)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _kernels()[0](
            q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_mask.data_ptr(), o.data_ptr(),
            lse.data_ptr(), q.stride(0), q.stride(1), k.stride(0), k.stride(1),
            v.stride(0), v.stride(1), o.stride(0), o.stride(1),
            B, Tq, Tk, H, W, int(causal), _DTYPE_CODE[q.dtype], scale, stream,
            ctypes.byref(route))
    if rc != 0:
        raise RuntimeError(f"train_flash_attention forward launch failed: error {rc}")
    train_flash_attention.launches += 1
    train_flash_attention.launches_tc += route.value
    return (o if W == Dh else o[..., :Dh].contiguous()), lse


def _backward(q, k, v, kv_mask, o, lse, do, causal: bool):
    """The backward launches (D, dK/dV, dQ) → (dq, dk, dv), on padded copies
    as in ``_forward``."""
    B, Tq, H, Dh = q.shape
    scale = Dh ** -0.5
    Tk = k.shape[1]
    do = _heads_dense(do.to(q.dtype))
    q, k, v, o, do = pad_for_tensor_cores(q, k, v, o, do)
    W = q.shape[-1]
    dq = torch.empty((B, Tq, H, W), dtype=q.dtype, device=q.device)
    dk = torch.empty((B, Tk, H, W), dtype=q.dtype, device=q.device)
    dv = torch.empty((B, Tk, H, W), dtype=q.dtype, device=q.device)
    delta = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
    route = ctypes.c_int(-1)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _kernels()[1](
            q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_mask.data_ptr(), o.data_ptr(),
            lse.data_ptr(), do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            delta.data_ptr(), q.stride(0), q.stride(1), k.stride(0), k.stride(1),
            v.stride(0), v.stride(1), o.stride(0), o.stride(1), do.stride(0), do.stride(1),
            B, Tq, Tk, H, W, int(causal), _DTYPE_CODE[q.dtype], scale, stream,
            ctypes.byref(route))
    if rc != 0:
        raise RuntimeError(f"train_flash_attention backward launch failed: error {rc}")
    train_flash_attention.backward_launches += 1
    train_flash_attention.backward_launches_tc += route.value
    if W != Dh:
        dq, dk, dv = (g[..., :Dh].contiguous() for g in (dq, dk, dv))
    return dq, dk, dv


class _TrainFlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, kv_mask, causal):
        o, lse = _forward(q, k, v, kv_mask, causal)
        ctx.save_for_backward(q, k, v, kv_mask, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, kv_mask, o, lse = ctx.saved_tensors
        dq, dk, dv = _backward(q, k, v, kv_mask, o, lse, do, ctx.causal)
        return dq, dk, dv, None, None


def train_flash_attention(q, k, v, kv_mask, causal: bool = False):
    """Differentiable fused attention.  q: (B, Tq, H, Dh); k, v: (B, Tk, H,
    Dh) with heads and head width contiguous; kv_mask: (B, Tk) float32
    (no gradient).  Returns a new contiguous (B, Tq, H, Dh) tensor in q's
    dtype; its backward gives dq, dk, dv."""
    check_inputs(q, k, v, kv_mask)
    if train_flash_attention.shapes is not None:
        train_flash_attention.shapes[(*q.shape, k.shape[1], bool(causal))] += 1
    if q.device.type == "cpu":
        train_flash_attention.plain_calls += 1
        return train_flash_attention_plain(q, k, v, kv_mask, causal)
    if q.device.type != "cuda":
        raise ValueError(f"no training-attention kernel for device {q.device}")
    check_kernel_width(q.shape[-1])
    return _TrainFlashAttention.apply(q, k, v, kv_mask, bool(causal))


#: forward kernel launches (CUDA tensors only); set to 0 before a run to count it
train_flash_attention.launches = 0
#: of ``launches``, those on the tensor cores (the rest ran the SIMT kernels)
train_flash_attention.launches_tc = 0
#: backward launches (one per backward call: D, dK/dV and dQ kernels)
train_flash_attention.backward_launches = 0
#: of ``backward_launches``, those on the tensor cores
train_flash_attention.backward_launches_tc = 0
#: plain-version calls made for CPU tensors (never incremented on the card)
train_flash_attention.plain_calls = 0
#: a ``collections.Counter`` to record each forward's (B, Tq, H, Dh, Tk,
#: causal) in, kernel or plain, or None (as ``masked_attention.shapes``)
train_flash_attention.shapes = None
