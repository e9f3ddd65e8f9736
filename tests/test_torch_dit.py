"""The port's DiT denoiser against the JAX package's, in fp32 on the CPU:
flax parameters carried over with ``jax_params_to_torch``, the same inputs,
logits compared on valid positions (padding positions are zero in both)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tts_with_diffusion_model_tpu.models.dit import DiTDenoiser as JaxDiT
from tts_with_diffusion_model_tpu_torch.convert import jax_params_to_torch
from tts_with_diffusion_model_tpu_torch.models.dit import DiTDenoiser

from torch_port_helpers import perturbed, t, unflatten

TOL = 1e-4  # fp32 on both sides; sums in another order through 2 blocks
KW = dict(n_classes=33, d_model=64, n_heads=4, n_layers=2, timesteps=10)


def _batch(seed=0, B=2, Tt=7, Tp=9, Tr=12):
    rs = np.random.RandomState(seed)
    text = rs.randint(1, 33, (B, Tt))
    tm = np.ones((B, Tt), np.float32)
    tm[1, 5:] = 0
    proms = rs.randint(0, 33, (B, Tp, 8))
    pm = np.ones((B, Tp), np.float32)
    pm[0, 6:] = 0
    x = rs.randint(0, 33, (B, Tr))
    rm = np.ones((B, Tr), np.float32)
    rm[:, 10:] = 0
    tt = np.array([3, 7])[:B]
    return text, tm, proms, pm, x, rm, tt


@pytest.fixture(scope="module")
def models():
    jd = JaxDiT(dtype=jnp.float32, **KW)
    flat = perturbed(jax.jit(jd.init)(jax.random.PRNGKey(0), *_batch()), seed=1)
    td = DiTDenoiser(dtype=torch.float32, **KW)
    jax_params_to_torch(flat, td)
    return jd, unflatten(flat), td


@pytest.mark.parametrize("seed", [0, 1])
def test_denoiser_logits_match(models, seed):
    jd, jp, td = models
    batch = _batch(seed)
    ref = np.asarray(jax.jit(jd.apply)(jp, *batch))
    got = td(*[t(a) for a in batch]).detach().numpy()
    np.testing.assert_allclose(got, ref, atol=TOL * max(1.0, np.abs(ref).max()))


def test_conds_and_hoisted_kv_match(models):
    jd, jp, td = models
    text, tm, proms, pm, x, rm, tt = _batch(2)
    def apply(method):
        return jax.jit(functools.partial(jd.apply, method=method))

    tc, sc = apply(JaxDiT.conds)(jp, text, tm, proms, pm)
    ptc, psc = td.conds(t(text), t(tm), t(proms), t(pm))
    np.testing.assert_allclose(ptc.detach().numpy(), np.asarray(tc), atol=TOL)
    np.testing.assert_allclose(psc.detach().numpy(), np.asarray(sc), atol=TOL)
    kv = apply(JaxDiT.cond_kv)(jp, tc, sc)
    ref = np.asarray(apply(JaxDiT.denoise_with_kv)(jp, x, rm, tt, kv, tm, pm))
    got = td.denoise_with_kv(t(x), t(rm), t(tt), td.cond_kv(ptc, psc), t(tm), t(pm))
    np.testing.assert_allclose(got.detach().numpy(), ref, atol=TOL * max(1.0, np.abs(ref).max()))
