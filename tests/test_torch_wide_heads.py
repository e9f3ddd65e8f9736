"""The DiT denoiser and the NAR at head widths the registry does not use,
against the JAX package in fp32 on the CPU: Dh 128 (d_model 128 with one
head, 256 with two) and Dh 4 (the JAX ``get_model`` docstring's own
``{"d_model": 64, "n_layers": 2}`` on ``nar``, 16 heads).  The port routes
every such attention through ``route.attend`` (the plain versions here; on
the card the tensor cores at Dh 128 and the SIMT kernels at Dh 4), the
JAX package through its dense path.  Flax parameters (seeded noise on top)
carried over with ``jax_params_to_torch``; logits and every parameter's
gradient of a seeded weighted sum of the logits within 1e-4·max(1, |ref|)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tts_with_diffusion_model_tpu.models import get_model as jax_get_model
from tts_with_diffusion_model_tpu.models.dit import DiTDenoiser as JaxDiT
from tts_with_diffusion_model_tpu.models.nar import NAR as JaxNAR
from tts_with_diffusion_model_tpu_torch.convert import jax_params_to_torch, torch_params_to_jax
from tts_with_diffusion_model_tpu_torch.models import get_model
from tts_with_diffusion_model_tpu_torch.models.dit import DiTDenoiser
from tts_with_diffusion_model_tpu_torch.ops import masked_attention as serve_ops
from tts_with_diffusion_model_tpu_torch.ops import train_flash_attention as train_ops

from torch_port_helpers import flatten, perturbed, t, unflatten

TOL = 1e-4  # × max(1, max |ref|): fp32 on both sides, sums in another order
N_TOKENS = 40
#: (d_model, n_heads) by case; Dh = d_model / n_heads
WIDTHS = {"Dh 128, d128 x 1": (128, 1), "Dh 128, d256 x 2": (256, 2), "Dh 4, d64 x 16": (64, 16)}


def _close(got, ref, what):
    ref = np.asarray(ref)
    err = float(np.abs(np.asarray(got) - ref).max())
    assert err <= TOL * max(1.0, float(np.abs(ref).max())), (what, err)


def _grads_match(module, ref_grads):
    got = torch_params_to_jax(module, {n: p.grad for n, p in module.named_parameters()})
    ref = {k.removeprefix("params/"): v for k, v in flatten(ref_grads).items()}
    assert set(got) == set(ref)
    for key, r in ref.items():
        _close(got[key], r, key)


def _dit_batch(seed=0, B=2, Tt=7, Tp=9, Tr=12):
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
    return text, tm, proms, pm, x, rm, np.array([3, 7])[:B]


def _count_attention(fn):
    """Run ``fn`` with both wrappers' CPU call counts read around it."""
    before = serve_ops.masked_attention.plain_calls + train_ops.train_flash_attention.plain_calls
    out = fn()
    after = serve_ops.masked_attention.plain_calls + train_ops.train_flash_attention.plain_calls
    return out, after - before


@pytest.mark.parametrize("case", WIDTHS)
def test_dit_logits_and_gradients_match_jax(case):
    d_model, n_heads = WIDTHS[case]
    kw = dict(n_classes=33, d_model=d_model, n_heads=n_heads, n_layers=2, timesteps=10)
    jd = JaxDiT(dtype=jnp.float32, **kw)
    batch = _dit_batch()
    flat = perturbed(jax.jit(jd.init)(jax.random.PRNGKey(0), *batch), seed=1)
    batch = _dit_batch(seed=1)
    w = np.random.RandomState(2).randn(*batch[4].shape, 33).astype(np.float32)

    def jloss(p):
        logits = jd.apply(p, *batch)
        return jnp.sum(logits * w), logits

    (_, ref), ref_grads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(unflatten(flat))
    td = DiTDenoiser(dtype=torch.float32, **kw)
    jax_params_to_torch(flat, td)
    got, calls = _count_attention(lambda: td(*[t(a) for a in batch]))
    assert calls > 0  # through the attention wrappers, at Dh = d_model / n_heads
    _close(got.detach().numpy(), ref, "logits")
    (got * t(w)).sum().backward()
    _grads_match(td, ref_grads)


def _nar_batch(seed=0, B=2, Tt=6, Tp=8, Tr=10):
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


@functools.cache
def _nar(d_model, n_heads):
    """The registry ``nar`` with ``overrides`` in both packages; the Dh-4
    case is the JAX docstring's ``{"d_model": 64, "n_layers": 2}``, which
    keeps the default 16 heads."""
    ov = {"d_model": d_model, "n_layers": 2, "remat": False}
    if n_heads != 16:
        ov["n_heads"] = n_heads
    jn = jax_get_model("nar", N_TOKENS, ov, dtype=jnp.float32)
    assert (jn.d_model, jn.n_heads) == (d_model, n_heads)
    text, tm, proms, pm, resps, rm = _nar_batch()
    full = np.concatenate([resps, resps[..., :1]], -1)
    params = jax.jit(jn.init)(jax.random.PRNGKey(0), text, tm, proms, pm, full, rm,
                              jnp.zeros((2,), jnp.int32))
    return jn, ov, perturbed(params, seed=3)


@pytest.mark.parametrize("case", WIDTHS)
def test_nar_logits_and_gradients_match_jax(case):
    jn, ov, flat = _nar(*WIDTHS[case])
    tn = get_model("nar", N_TOKENS, ov, dtype=torch.float32)
    assert tn.base.blocks()[0].attn.n_heads == WIDTHS[case][1]
    jax_params_to_torch(flat, tn)
    text, tm, proms, pm, resps, rm = _nar_batch(seed=1)
    n_known = 3
    w = np.random.RandomState(4).randn(*resps.shape[:2], N_TOKENS).astype(np.float32)
    fwd = functools.partial(jn.apply, method=JaxNAR.forward_level)

    def jloss(p):
        logits = fwd(p, text, tm, proms, pm, resps, rm, jnp.int32(n_known))
        return jnp.sum(logits * w), logits

    (_, ref), ref_grads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(unflatten(flat))
    got, calls = _count_attention(lambda: tn.forward_level(
        t(text), t(tm), t(proms), t(pm), t(resps), t(rm), n_known))
    assert calls > 0
    _close(got.detach().numpy(), ref, "logits")
    (got * t(w)).sum().backward()
    _grads_match(tn, ref_grads)
