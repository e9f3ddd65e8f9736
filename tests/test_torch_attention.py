"""The port's masked attention against the JAX package's: the plain version
against the Pallas kernel run in interpret mode and against the pair-mask
dense path (valid query rows), and the wrapper's input checks.  The CUDA
kernel itself is held against the plain version in ``test_torch_gpu.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tts_with_diffusion_model_tpu.ops.attention import dense_attention
from tts_with_diffusion_model_tpu.ops.flash_attention import _flash_impl
from tts_with_diffusion_model_tpu_torch.ops import attention as port_attention
from tts_with_diffusion_model_tpu_torch.ops.masked_attention import (
    masked_attention,
    masked_attention_plain,
)

from torch_port_helpers import t

FP32_TOL = 1e-5  # same arithmetic, fp32 sums in another order


def _inputs(B=3, Tq=10, Tk=13, H=2, Dh=16, seed=0):
    rs = np.random.RandomState(seed)
    q = rs.randn(B, Tq, H, Dh).astype(np.float32)
    k = rs.randn(B, Tk, H, Dh).astype(np.float32)
    v = rs.randn(B, Tk, H, Dh).astype(np.float32)
    km = (rs.rand(B, Tk) > 0.3).astype(np.float32)
    km[:, 0] = 1.0
    km[min(1, B - 1), 7:] = 0.0  # ragged tail
    qm = np.ones((B, Tq), np.float32)
    qm[B - 1, 6:] = 0.0  # padding query rows
    return q, k, v, km, qm


@pytest.mark.parametrize("shape", [(3, 10, 13, 2, 16), (2, 7, 50, 4, 8), (1, 24, 24, 2, 64)])
def test_plain_matches_pallas_interpret(shape):
    q, k, v, km, _ = _inputs(*shape)
    ref = np.asarray(_flash_impl(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 jnp.asarray(km), interpret=True))
    got = masked_attention_plain(t(q), t(k), t(v), t(km)).numpy()
    np.testing.assert_allclose(got, ref, atol=FP32_TOL)


def test_plain_matches_dense_pair_mask_on_valid_rows():
    q, k, v, km, qm = _inputs()
    pair = qm[:, :, None] * km[:, None, :]
    ref = np.asarray(dense_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                     pair_mask=jnp.asarray(pair)))
    got = masked_attention_plain(t(q), t(k), t(v), t(km)).numpy()
    valid = qm > 0
    np.testing.assert_allclose(got[valid], ref[valid], atol=FP32_TOL)
    # the port's own pair-mask reference agrees everywhere, padding rows too
    dense = port_attention.cross_attention(t(q), t(k), t(v), t(qm), t(km)).numpy()
    np.testing.assert_allclose(dense, ref, atol=FP32_TOL)


def test_all_masked_keys_row_is_finite_and_uniform():
    q, k, v, km, _ = _inputs()
    km[0] = 0.0
    got = masked_attention(t(q), t(k), t(v), t(km))
    assert torch.isfinite(got).all()
    # finite NEG_INF: a fully masked row is the mean of its values
    np.testing.assert_allclose(got[0].numpy(), np.broadcast_to(v[0].mean(0), got[0].shape),
                               atol=FP32_TOL)


def test_wrapper_counts_plain_calls_on_cpu_and_no_launches():
    q, k, v, km, _ = _inputs()
    masked_attention.launches = 0
    masked_attention.plain_calls = 0
    masked_attention(t(q), t(k), t(v), t(km))
    assert (masked_attention.launches, masked_attention.plain_calls) == (0, 1)


@pytest.mark.parametrize("bad", ["dtype", "mask_dtype", "shape", "head_width", "mask_shape",
                                 "mixed_dtype", "strided_heads"])
def test_wrapper_rejects_bad_inputs(bad):
    q, k, v, km, _ = _inputs()
    q, k, v, km = t(q), t(k), t(v), t(km)
    if bad == "dtype":
        q, k, v = q.half(), k.half(), v.half()
    elif bad == "mask_dtype":
        km = km.bool()
    elif bad == "shape":
        k = k[:, :, :1]
    elif bad == "head_width":
        q, k, v = q[..., :12], k[..., :12], v[..., :12]
    elif bad == "mask_shape":
        km = km[:, :-1]
    elif bad == "mixed_dtype":
        v = v.double()
    elif bad == "strided_heads":
        q = q.transpose(2, 3).contiguous().transpose(2, 3)
    with pytest.raises(ValueError):
        masked_attention(q, k, v, km)

