"""The port's NAR against the JAX package's, in fp32 on the CPU:
``forward_level`` logits per level, the packed layout and the shared
backbone pieces."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tts_with_diffusion_model_tpu.models import base as jax_base
from tts_with_diffusion_model_tpu.models.nar import NAR as JaxNAR
from tts_with_diffusion_model_tpu_torch.convert import jax_params_to_torch
from tts_with_diffusion_model_tpu_torch.models import base
from tts_with_diffusion_model_tpu_torch.models.nar import NAR

from torch_port_helpers import perturbed, t, unflatten

TOL = 1e-4  # fp32 on both sides
N_TOKENS = 40
DIMS = dict(d_model=64, n_heads=4, n_layers=2)


def _batch(seed=0, B=2, Tt=6, Tp=8, Tr=10):
    rs = np.random.RandomState(seed)
    text = rs.randint(1, N_TOKENS, (B, Tt))
    tm = np.ones((B, Tt), np.float32)
    tm[0, 4:] = 0
    proms = rs.randint(0, N_TOKENS, (B, Tp, 8))
    pm = np.ones((B, Tp), np.float32)
    pm[1, 5:] = 0
    resps = rs.randint(0, N_TOKENS, (B, Tr, 7))
    rm = np.ones((B, Tr), np.float32)
    rm[1, 8:] = 0
    return text, tm, proms, pm, resps, rm


@pytest.fixture(scope="module")
def models():
    jn = JaxNAR(N_TOKENS, dtype=jnp.float32, remat=False, **DIMS)
    text, tm, proms, pm, resps, rm = _batch()
    full = np.concatenate([resps, resps[..., :1]], -1)
    params = jax.jit(jn.init)(jax.random.PRNGKey(0), text, tm, proms, pm, full, rm,
                              jnp.zeros((2,), jnp.int32))
    flat = perturbed(params, seed=3)
    tn = NAR(N_TOKENS, dtype=torch.float32, **DIMS)
    jax_params_to_torch(flat, tn)
    return jn, unflatten(flat), tn


@pytest.mark.parametrize("n_known", range(1, 8))
def test_forward_level_logits_match(models, n_known):
    jn, jp, tn = models
    text, tm, proms, pm, resps, rm = _batch(n_known)
    fwd = jax.jit(functools.partial(jn.apply, method=JaxNAR.forward_level))
    ref = np.asarray(fwd(jp, text, tm, proms, pm, resps, rm, jnp.int32(n_known)))
    got = tn.forward_level(t(text), t(tm), t(proms), t(pm), t(resps), t(rm), n_known)
    np.testing.assert_allclose(got.detach().numpy(), ref, atol=TOL * max(1.0, np.abs(ref).max()))


def test_packed_layout_and_sinusoids_match():
    _, tm, _, pm, _, rm = _batch()
    jm, jpos, jseg = jax_base.packed_layout(jnp.asarray(tm), jnp.asarray(pm), jnp.asarray(rm))
    m, pos, seg = base.packed_layout(t(tm), t(pm), t(rm))
    np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(seg.numpy(), np.asarray(jseg))
    np.testing.assert_allclose(base.sinusoidal_embedding(pos, 64).numpy(),
                               np.asarray(jax_base.sinusoidal_embedding(jpos, 64)), atol=1e-5)


def test_sample_categorical_matches_under_injected_noise():
    rs = np.random.RandomState(5)
    logits = rs.randn(2, 6, 11).astype(np.float32) * 3
    g = rs.gumbel(size=logits.shape).astype(np.float32)
    for temp in (0.0, 0.2, 1.0):
        ref = np.asarray(jax_base.sample_categorical(None, jnp.asarray(logits), temp,
                                                     gumbel_noise=jnp.asarray(g)))
        got = base.sample_categorical(t(logits), temp, gumbel_noise=t(g)).numpy()
        np.testing.assert_array_equal(got, ref)
