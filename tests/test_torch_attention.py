"""The port's masked attention against the JAX package's: the plain version
against the Pallas kernel run in interpret mode and against the pair-mask
dense path (valid query rows), both plain versions (forward and gradients)
against ``_dense_ref`` at the Gaussian family's head widths and at widths
off the registry's (4, 12, 40, 80, 128, 136, 200, 250 and 256, through
``route.attend``),
and the wrapper's input checks.  The CUDA kernel itself is held against the plain
version in ``test_torch_gpu.py`` and ``test_torch_gaussian_gpu.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tts_with_diffusion_model_tpu.ops.attention import dense_attention
from tts_with_diffusion_model_tpu.ops.flash_attention import _dense_ref, _flash_impl
from tts_with_diffusion_model_tpu_torch.ops import attention as port_attention
from tts_with_diffusion_model_tpu_torch.ops.masked_attention import (
    masked_attention,
    masked_attention_plain,
)
from tts_with_diffusion_model_tpu_torch.ops.train_flash_attention import (
    train_flash_attention_plain,
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


@pytest.mark.parametrize("Dh", [8, 16, 32])
def test_plain_versions_match_dense_ref_at_the_gaussian_head_widths(Dh):
    """Both plain versions against JAX's ``_dense_ref`` (the reference of
    the Pallas kernel's backward) at Tq, Tk across a 64-row tile edge, with
    an all-masked row: the forward, and the training one's dq, dk, dv."""
    q, k, v, km, _ = _inputs(B=3, Tq=65, Tk=63, H=2, Dh=Dh, seed=Dh)
    km[2] = 0.0
    do = np.random.RandomState(Dh + 1).randn(*q.shape).astype(np.float32)
    ref, vjp = jax.vjp(lambda a, b, c: _dense_ref(a, b, c, jnp.asarray(km)),
                       jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ref_grads = vjp(jnp.asarray(do))
    np.testing.assert_allclose(masked_attention_plain(t(q), t(k), t(v), t(km)).numpy(),
                               np.asarray(ref), atol=FP32_TOL)
    qg, kg, vg = (t(a).requires_grad_(True) for a in (q, k, v))
    o = train_flash_attention_plain(qg, kg, vg, t(km), False)
    (o * t(do)).sum().backward()
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(ref), atol=FP32_TOL)
    for got, want in zip((qg.grad, kg.grad, vg.grad), ref_grads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


#: head widths off the registry's: between and at the kernels'
#: instantiations (40, 80, 128, 136, 200, 256) and widths that are not a
#: multiple of 8 (4, 12, 250: zero-padded copies on the card in bf16)
WIDTHS = [4, 12, 40, 80, 128, 136, 200, 250, 256]


@pytest.mark.parametrize("Dh", WIDTHS)
def test_plain_versions_match_jax_at_every_head_width(Dh):
    """Both plain versions against JAX's ``_dense_ref``, forward and dq, dk,
    dv, with an all-masked row; kernel 1's also against the Pallas kernel
    in interpret mode where its ``supported`` takes the width (Dh % 8 == 0).
    ``route.attend`` runs each width on the CPU, with and without grad (on
    the card in bf16 the tensor cores at every width, the widths off 8 on
    padded copies)."""
    from tts_with_diffusion_model_tpu.ops.flash_attention import supported
    from tts_with_diffusion_model_tpu_torch.ops.route import attend

    q, k, v, km, _ = _inputs(B=2, Tq=40, Tk=64, H=2, Dh=Dh, seed=Dh)
    km[1] = 0.0
    do = np.random.RandomState(Dh + 1).randn(*q.shape).astype(np.float32)
    ref, vjp = jax.vjp(lambda a, b, c: _dense_ref(a, b, c, jnp.asarray(km)),
                       jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ref_grads = vjp(jnp.asarray(do))
    got = masked_attention_plain(t(q), t(k), t(v), t(km)).numpy()
    np.testing.assert_allclose(got, np.asarray(ref), atol=FP32_TOL)
    if supported(q.shape, k.shape):
        interp = _flash_impl(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(km),
                             interpret=True)
        np.testing.assert_allclose(got, np.asarray(interp), atol=FP32_TOL)
    with torch.no_grad():
        np.testing.assert_array_equal(attend(t(q), t(k), t(v), t(km)).numpy(), got)
    qg, kg, vg = (t(a).requires_grad_(True) for a in (q, k, v))
    o = attend(qg, kg, vg, t(km))
    (o * t(do)).sum().backward()
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(ref), atol=FP32_TOL)
    for g, want in zip((qg.grad, kg.grad, vg.grad), ref_grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(want), atol=1e-4)


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
    elif bad == "head_width":  # empty (any other width runs on the CPU)
        q, k, v = q[..., :0].contiguous(), k[..., :0].contiguous(), v[..., :0].contiguous()
    elif bad == "mask_shape":
        km = km[:, :-1]
    elif bad == "mixed_dtype":
        v = v.double()
    elif bad == "strided_heads":
        q = q.transpose(2, 3).contiguous().transpose(2, 3)
    with pytest.raises(ValueError):
        masked_attention(q, k, v, km)

