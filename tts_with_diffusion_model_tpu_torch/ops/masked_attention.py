"""Key-masked attention: the Hopper kernel's wrapper, its plain version and
its launch counter.

Counterpart of ``ops/flash_attention.py`` in the JAX package (``_attn_kernel``
through ``_flash_impl``).  The kernel (``csrc/masked_attention.cu``) masks keys
only, from a (B, Tk) validity vector; it differs from the pair-mask dense path
only on padding *query* rows, which every caller multiplies away (DiT blocks,
condition towers, the NAR's ``to_out(o) * mask``).

For a tensor on the CPU the wrapper runs the plain version; for a CUDA tensor
it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from .attention import NEG_INF

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_DH = 64
_INT_MAX = 2**31 - 1

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        from . import _build

        fn = _build.load("masked_attention").masked_attention_fwd
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 14 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def masked_attention_plain(q, k, v, kv_mask):
    """Plain PyTorch version (≡ ``_dense_ref``): fp32 scores scaled by
    Dh^-0.5, finite ``NEG_INF`` on masked keys, row softmax, p cast to v's
    dtype, p·v accumulated in fp32.  q: (B, Tq, H, Dh); k, v: (B, Tk, H, Dh);
    kv_mask: (B, Tk).  Returns (B, Tq, H, Dh) in v's dtype."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bihd,bjhd->bhij", q.float(), k.float()) * scale
    s = torch.where(kv_mask[:, None, None, :] > 0, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhij,bjhd->bihd", p.to(v.dtype).float(), v.float())
    return o.to(v.dtype)


def check_inputs(q, k, v, kv_mask):
    """Raise ValueError on anything the kernel does not take."""
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("q, k, v must be (B, T, H, Dh)")
    B, Tq, H, Dh = q.shape
    Tk = k.shape[1]
    if k.shape != (B, Tk, H, Dh) or v.shape != (B, Tk, H, Dh):
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not match q {tuple(q.shape)}")
    if kv_mask.shape != (B, Tk):
        raise ValueError(f"kv_mask {tuple(kv_mask.shape)} must be (B, Tk) = {(B, Tk)}")
    if min(B, Tq, Tk, H, Dh) < 1:
        raise ValueError("empty attention")
    if Dh % 8 != 0 or Dh > MAX_DH:
        raise ValueError(f"head width {Dh} must be a multiple of 8, at most {MAX_DH}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODE:
        raise ValueError(f"q, k, v must share float32 or bfloat16, got {q.dtype}/{k.dtype}/{v.dtype}")
    if kv_mask.dtype != torch.float32:
        raise ValueError(f"kv_mask must be float32, got {kv_mask.dtype}")
    devs = {t.device for t in (q, k, v, kv_mask)}
    if len(devs) != 1:
        raise ValueError(f"inputs on several devices: {devs}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1 or t.stride(2) != Dh:
            raise ValueError(f"{name}: heads and head width must be contiguous")
        if max(t.stride(0), t.stride(1)) > _INT_MAX:
            raise ValueError(f"{name}: strides exceed the kernel's int range")
    if not kv_mask.is_contiguous():
        raise ValueError("kv_mask must be contiguous")


def masked_attention(q, k, v, kv_mask):
    """Fused key-masked attention, forward only.  q: (B, Tq, H, Dh); k, v:
    (B, Tk, H, Dh) with heads and head width contiguous (time and batch may
    be strided, as in a split of a fused qkv projection); kv_mask: (B, Tk)
    float32.  Returns a new contiguous (B, Tq, H, Dh) tensor in q's dtype.
    On a CUDA tensor with grad enabled and an input that requires grad it
    raises rather than detach."""
    check_inputs(q, k, v, kv_mask)
    if q.device.type == "cpu":
        masked_attention.plain_calls += 1
        return masked_attention_plain(q, k, v, kv_mask)
    if q.device.type != "cuda":
        raise ValueError(f"no masked-attention kernel for device {q.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("masked_attention is forward-only: differentiated attention "
                           "goes through ops/train_flash_attention.py (ops/route.attend)")
    B, Tq, H, Dh = q.shape
    Tk = k.shape[1]
    o = torch.empty((B, Tq, H, Dh), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _kernel()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_mask.data_ptr(), o.data_ptr(),
            q.stride(0), q.stride(1), k.stride(0), k.stride(1),
            v.stride(0), v.stride(1), o.stride(0), o.stride(1),
            B, Tq, Tk, H, Dh, _DTYPE_CODE[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"masked_attention kernel launch failed: error {rc}")
    masked_attention.launches += 1
    return o


#: kernel launches (CUDA tensors only); set to 0 before a run to count it
masked_attention.launches = 0
#: plain-version calls made for CPU tensors (lets a CPU rehearsal count the
#: attention calls of a run; never incremented on the card)
masked_attention.plain_calls = 0
