"""The training attention's plain version (``ops/train_flash_attention``)
against the JAX package's own ``_train_flash_attention``, the library Pallas
TPU kernel, run in the Pallas interpreter on the CPU: forward and the
gradients of q, k, v, ragged Tq ≠ Tk that are not multiples of 128, causal
and not, fp32 and bf16.  The Hopper kernel is held against the same plain
version on the card (``test_torch_gpu.py``, ``chip_smoke.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tts_with_diffusion_model_tpu.ops.attention import _train_flash_attention, cross_attention
from tts_with_diffusion_model_tpu_torch.ops.train_flash_attention import (
    train_flash_attention,
    train_flash_attention_plain,
)

from torch_port_helpers import t

#: (forward, gradients): fp32 sums in another order; bf16 rounds p, the
#: output and the gradients to 8 bits of mantissa (2e-2 × max(1, |ref|))
TOL = {"float32": (1e-5, 1e-4), "bfloat16": (2e-2, 2e-2)}


def _inputs(B, Tq, Tk, H, Dh, seed, all_masked_row=False):
    rs = np.random.RandomState(seed)
    q, k, v, do = (rs.randn(B, T, H, Dh).astype(np.float32) for T in (Tq, Tk, Tk, Tq))
    km = np.ones((B, Tk), np.float32)
    km[0, Tk - Tk // 3:] = 0          # ragged valid prefix
    km[-1] = (rs.rand(Tk) > 0.3)      # holes
    km[-1, 0] = 1
    if all_masked_row:
        km[-1] = 0
    return q, k, v, km, do


def _jax_fwd_grads(fn, q, k, v, km, do, dtype):
    cast = lambda a: jnp.asarray(a).astype(dtype)  # noqa: E731

    def loss(q_, k_, v_):
        o = fn(q_, k_, v_, jnp.asarray(km))
        return jnp.sum(o.astype(jnp.float32) * jnp.asarray(do)), o

    (_, o), grads = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
        cast(q), cast(k), cast(v))
    return [np.asarray(x.astype(jnp.float32)) for x in (o, *grads)]


def _port_fwd_grads(q, k, v, km, do, causal, dtype):
    q_, k_, v_ = (t(a).to(dtype).requires_grad_(True) for a in (q, k, v))
    o = train_flash_attention_plain(q_, k_, v_, t(km), causal)
    (o.float() * t(do)).sum().backward()
    return [x.detach().float().numpy() for x in (o, q_.grad, k_.grad, v_.grad)]


def _assert_close(got, ref, dtype):
    tol_f, tol_g = TOL[dtype]
    for name, a, b, tol in zip(("o", "dq", "dk", "dv"), got, ref, (tol_f, tol_g, tol_g, tol_g)):
        scale = max(1.0, float(np.abs(b).max())) if dtype == "bfloat16" else 1.0
        err = float(np.abs(a - b).max())
        assert err <= tol * scale, (name, err, tol * scale)


@pytest.mark.parametrize("B,Tq,Tk,H,Dh,causal,dtype", [
    (2, 40, 56, 2, 32, False, "float32"),
    (2, 70, 70, 2, 16, True, "float32"),
    (2, 40, 56, 2, 32, False, "bfloat16"),
])
def test_plain_matches_the_library_tpu_kernel_in_interpret_mode(B, Tq, Tk, H, Dh, causal, dtype):
    q, k, v, km, do = _inputs(B, Tq, Tk, H, Dh, seed=Tq + Tk)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    with pltpu.force_tpu_interpret_mode():
        ref = _jax_fwd_grads(lambda a, b, c, m: _train_flash_attention(a, b, c, m, causal=causal),
                             q, k, v, km, do, jdt)
    got = _port_fwd_grads(q, k, v, km, do, causal, tdt)
    _assert_close(got, ref, dtype)


def test_all_masked_row_matches_the_dense_path_and_stops_the_gradient():
    """A row whose keys are all masked: uniform forward, dq = 0 and no dk
    from it, dv fed by the uniform P — JAX's dense ``where(mask, s,
    NEG_INF)`` path.  (The library TPU kernel adds the mask value instead of
    replacing the score, so it passes a gradient through such a row; no
    caller of either package has one at a valid query.)"""
    q, k, v, km, do = _inputs(2, 9, 13, 2, 8, seed=3, all_masked_row=True)
    ref = _jax_fwd_grads(lambda a, b, c, m: cross_attention(a, b, c, kv_mask=m),
                         q, k, v, km, do, jnp.float32)
    got = _port_fwd_grads(q, k, v, km, do, False, torch.float32)
    _assert_close(got, ref, "float32")
    np.testing.assert_array_equal(got[1][-1], 0.0)
    np.testing.assert_allclose(got[0][-1], np.broadcast_to(v[-1].mean(0), got[0][-1].shape),
                               atol=1e-5)


def test_wrapper_runs_the_plain_version_on_cpu_and_counts_it():
    q, k, v, km, _ = _inputs(2, 5, 6, 1, 8, seed=0)
    train_flash_attention.launches = train_flash_attention.plain_calls = 0
    o = train_flash_attention(t(q), t(k), t(v), t(km), causal=True)
    ref = train_flash_attention_plain(t(q), t(k), t(v), t(km), True)
    assert torch.equal(o, ref)
    assert (train_flash_attention.launches, train_flash_attention.plain_calls) == (0, 1)
