"""The port's D3PM forward corruption and training loss against the JAX
package's, in fp32 on the CPU: flax parameters carried over with
``jax_params_to_torch``, the same batch, the same injected timesteps and
corruption noise; the loss within 1e-5 relative and every parameter's
gradient within 1e-4·max(1, |ref|), with and without per-block remat."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tts_with_diffusion_model_tpu.diffusion.d3pm import D3PM as JaxD3PM
from tts_with_diffusion_model_tpu.models.diffusion import DiffusionConfig as JaxCfg
from tts_with_diffusion_model_tpu.models.diffusion import DiffusionModel as JaxModel
from tts_with_diffusion_model_tpu_torch.convert import jax_params_to_torch, torch_params_to_jax
from tts_with_diffusion_model_tpu_torch.diffusion.d3pm import D3PM
from tts_with_diffusion_model_tpu_torch.models.diffusion import DiffusionConfig, DiffusionModel

from torch_port_helpers import flatten, seeded_flax_params, t, unflatten

LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4  # × max(1, max |ref|) per parameter; fp32 sums in another order
KW = dict(n_classes=33, d_model=32, n_heads=2, n_layers=2, timesteps=6, resp_len=12,
          text_len=7, prom_len=9)


def _batch(seed=0, B=2):
    rs = np.random.RandomState(seed)
    c = KW
    batch = dict(
        text=rs.randint(1, 33, (B, c["text_len"])).astype(np.int32),
        text_mask=np.ones((B, c["text_len"]), np.float32),
        proms=rs.randint(0, 33, (B, c["prom_len"], 8)).astype(np.int32),
        prom_mask=np.ones((B, c["prom_len"]), np.float32),
        resp=rs.randint(0, 32, (B, c["resp_len"])).astype(np.int32),
        resp_mask=np.ones((B, c["resp_len"]), np.float32),
    )
    batch["text_mask"][1, 5:] = 0
    batch["prom_mask"][0, 6:] = 0
    batch["resp_mask"][0, 10:] = 0
    batch["resp"] = batch["resp"] * batch["resp_mask"].astype(np.int32)
    return batch


def _torch_batch(batch):
    return {k: t(v).long() if v.dtype.kind == "i" else t(v) for k, v in batch.items()}


@functools.cache
def _flat_params():
    return seeded_flax_params(DiffusionModel(DiffusionConfig(**KW)).denoiser, seed=1)


def _models(train_mode="sampled", remat=False):
    jm = JaxModel(JaxCfg(train_mode=train_mode, remat=remat, **KW), dtype=jnp.float32)
    flat = _flat_params()
    pm = DiffusionModel(DiffusionConfig(train_mode=train_mode, remat=remat, **KW),
                        dtype=torch.float32)
    jax_params_to_torch(flat, pm.denoiser)
    return jm, unflatten(flat), pm


def _jax_t(rng, B, T):
    """The timesteps JAX's sampled-mode loss draws from ``rng``."""
    rng_t, _ = jax.random.split(rng)
    return np.asarray(jax.random.randint(rng_t, (B,), 1, T))


@pytest.mark.parametrize("transition", ["absorbing", "uniform"])
def test_q_sample_gives_identical_tokens_under_the_same_noise(transition):
    rs = np.random.RandomState(0)
    x0 = rs.randint(0, 33, (3, 17))
    tt = np.array([1, 5, 9])
    noise = rs.rand(3, 17, 33).astype(np.float32)
    noise[0, 0, :] = 0.0  # clipped at fp32 tiny, not -inf
    jd = JaxD3PM.create(timesteps=10, num_classes=33, transition=transition)
    pd = D3PM.create(timesteps=10, num_classes=33, transition=transition)
    ref = np.asarray(jd.q_sample(jnp.asarray(x0), jnp.asarray(tt), uniform_noise=jnp.asarray(noise)))
    got = pd.q_sample(t(x0), t(tt), uniform_noise=t(noise)).numpy()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_allclose(pd.q_probs(t(x0), t(tt)).numpy(),
                               np.asarray(jd.q_probs(jnp.asarray(x0), jnp.asarray(tt))), rtol=1e-6)


def test_q_sample_draws_from_a_generator():
    pd = D3PM.create(timesteps=10, num_classes=33)
    x0 = torch.randint(0, 33, (2, 50))
    a = pd.q_sample(x0, torch.tensor([9, 9]), generator=torch.Generator().manual_seed(0))
    b = pd.q_sample(x0, torch.tensor([9, 9]), generator=torch.Generator().manual_seed(0))
    assert torch.equal(a, b) and (a == pd.absorbing_state).any()
    with pytest.raises(ValueError):
        pd.q_sample(x0, torch.tensor([1, 1]))


@pytest.mark.parametrize("remat", [False, True])
def test_sampled_loss_and_every_gradient_match_jax(remat):
    jm, params, pm = _models("sampled", remat)
    batch = _batch()
    B, Tr, V = batch["resp"].shape[0], KW["resp_len"], KW["n_classes"]
    noise = np.random.RandomState(5).rand(B, Tr, V).astype(np.float32)
    rng = jax.random.PRNGKey(7)

    def jloss(p):
        return jm.loss(p, {k: jnp.asarray(v) for k, v in batch.items()}, rng,
                       q_noise=jnp.asarray(noise))[0]

    ref_loss, ref_grads = jax.jit(jax.value_and_grad(jloss))(params)
    tt = _jax_t(rng, B, KW["timesteps"])
    loss, stats = pm.loss(_torch_batch(batch), None, q_noise=t(noise), t=t(tt))
    assert stats["nll"] is loss
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=LOSS_RTOL)
    loss.backward()
    grads = torch_params_to_jax(pm.denoiser, {n: p.grad for n, p in pm.denoiser.named_parameters()})
    ref = {k.removeprefix("params/"): v for k, v in flatten(ref_grads).items()}
    assert set(grads) == set(ref)
    for key, r in ref.items():
        err = float(np.abs(grads[key] - r).max())
        assert err <= GRAD_TOL * max(1.0, float(np.abs(r).max())), (key, err)


def test_all_t_loss_matches_jax():
    jm, params, pm = _models("all_t")
    batch = _batch(seed=2)
    B, Tr, V, T = batch["resp"].shape[0], KW["resp_len"], KW["n_classes"], KW["timesteps"]
    noise = np.random.RandomState(6).rand(T - 1, B, Tr, V).astype(np.float32)
    ref, _ = jax.jit(lambda p, b, n: jm.loss(p, b, None, q_noise=n))(
        params, {k: jnp.asarray(v) for k, v in batch.items()}, jnp.asarray(noise))
    with torch.no_grad():
        got, _ = pm.loss(_torch_batch(batch), None, q_noise=t(noise))
    np.testing.assert_allclose(got.item(), float(ref), rtol=LOSS_RTOL)


def test_max_t_caps_the_sampled_timesteps():
    _, _, pm = _models("sampled")
    pm = DiffusionModel(dataclasses.replace(pm.config), dtype=torch.float32)
    g = torch.Generator().manual_seed(0)
    seen = set()
    orig = pm.denoiser.denoise

    def spy(x_t, rm, tt, *a):
        seen.update(tt.tolist())
        return orig(x_t, rm, tt, *a)

    pm.denoiser.denoise = spy
    with torch.no_grad():
        for _ in range(5):
            pm.loss(_torch_batch(_batch()), g, max_t=3)
    assert seen <= {1, 2} and seen
