"""The DiT denoiser and the NAR at head widths the registry does not use,
against the JAX package in fp32 on the CPU: Dh 128 (d_model 128 with one
head, 256 with two), Dh 256 (d_model 256 with one head) and Dh 4 (the JAX
``get_model`` docstring's own ``{"d_model": 64, "n_layers": 2}`` on
``nar``, 16 heads).  The port routes every such attention through
``route.attend`` (the plain versions here; on the card in bf16 the tensor
cores at every width, Dh 4 on copies padded to 8), the JAX package through
its dense path.  Flax parameters (seeded noise on top)
carried over with ``jax_params_to_torch``; logits and every parameter's
gradient of a seeded weighted sum of the logits within 1e-4·max(1, |ref|).

The DiT at Dh 256 (one head of 256) is held twice.  In fp32 at flax's own
init weights (``test_dit_at_dh_256_matches_jax_in_fp32_at_its_init_weights``;
JAX 3.1e-6 and the port 2.7e-6 off the float64 result).  With the seeded
noise it is held in float64 on both sides (``FLOAT64``): there the prompt
tower's first self-attention saturates (scores to 100, one head of 256),
and the fp32 rounding of its scores q·k (``torch.einsum`` on the CPU,
XLA's dot in JAX) is amplified into the gradients in both packages.  At
the seeded point JAX lies 5.7e-5 off the float64 result and the port
1.5e-4; over ten one-ulp changes of the weights JAX lies 2.9e-5 to 1.4e-4
off (median 5.6e-5) and the port 3.1e-5 to 2.5e-4 (median 7.6e-5); those
scores computed in float64 and rounded once to fp32 bring the port to
2.9e-5 (``tests/dit_dh256_precision.py`` prints each figure).  So no op
of either package is at fault, and neither package's fp32 result meets
1e-4 there reliably; in float64 the same code is held to the same bound
with the rounding out of the way."""

import contextlib
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
#: DiT cases compared in float64 (the module docstring)
FLOAT64 = {"Dh 256, d256 x 1"}
N_TOKENS = 40
#: (d_model, n_heads) by case; Dh = d_model / n_heads
WIDTHS = {"Dh 128, d128 x 1": (128, 1), "Dh 128, d256 x 2": (256, 2), "Dh 256, d256 x 1": (256, 1),
          "Dh 4, d64 x 16": (64, 16)}


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


class _Lifted:
    """A module's ``jnp`` or ``torch`` whose ``float32`` reads as float64."""

    def __init__(self, lib, wide):
        self._lib, self.float32 = lib, wide

    def __getattr__(self, name):
        return getattr(self._lib, name)


@contextlib.contextmanager
def _precision(monkeypatch, wide: bool):
    """float32 as it is, or (``wide``) JAX in x64 with every fp32 cast on the
    DiT's path lifted to float64 in both packages (``jnp.float32`` /
    ``torch.float32`` in the modules that name them, ``Tensor.float()``), and
    the attention wrappers' plain versions taking float64 on the CPU."""
    if not wide:
        yield jnp.float32, torch.float32
        return
    import tts_with_diffusion_model_tpu.models.base as j_base
    import tts_with_diffusion_model_tpu.models.dit as j_dit
    import tts_with_diffusion_model_tpu.ops.attention as j_attention
    import tts_with_diffusion_model_tpu_torch.models.base as p_base
    import tts_with_diffusion_model_tpu_torch.models.dit as p_dit

    for mod in (j_base, j_dit, j_attention):
        monkeypatch.setattr(mod, "jnp", _Lifted(jnp, jnp.float64))
    for mod in (p_base, p_dit):
        monkeypatch.setattr(mod, "torch", _Lifted(torch, torch.float64))
    monkeypatch.setattr(torch.Tensor, "float", lambda self, *a, **k: self.double())
    monkeypatch.setitem(serve_ops._DTYPE_CODE, torch.float64, 0)
    with jax.enable_x64(True):
        yield jnp.float64, torch.float64


def _count_attention(fn):
    """Run ``fn`` with both wrappers' CPU call counts read around it."""
    before = serve_ops.masked_attention.plain_calls + train_ops.train_flash_attention.plain_calls
    out = fn()
    after = serve_ops.masked_attention.plain_calls + train_ops.train_flash_attention.plain_calls
    return out, after - before


def _check_dit(d_model, n_heads, monkeypatch, wide=False, noise=True):
    """The DiT at (d_model, n_heads) against JAX: fp32 (or, ``wide``,
    float64) on both sides, at flax's init weights with seeded noise on top
    (or, without ``noise``, as they are)."""
    kw = dict(n_classes=33, d_model=d_model, n_heads=n_heads, n_layers=2, timesteps=10)
    with _precision(monkeypatch, wide) as (jdt, tdt):
        jd = JaxDiT(dtype=jdt, **kw)
        batch = _dit_batch()
        flat = jax.jit(jd.init)(jax.random.PRNGKey(0), *batch)
        flat = perturbed(flat, seed=1) if noise else flatten(flat)
        flat = {k: v.astype(jdt) for k, v in flat.items()}
        batch = _dit_batch(seed=1)  # masks stay float32, as the wrappers take them
        w = np.random.RandomState(2).randn(*batch[4].shape, 33).astype(jdt)

        def jloss(p):
            logits = jd.apply(p, *batch)
            return jnp.sum(logits * w), logits

        (_, ref), ref_grads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(unflatten(flat))
        td = DiTDenoiser(dtype=tdt, **kw).to(tdt)
        jax_params_to_torch(flat, td)
        assert all(p.dtype == tdt for p in td.parameters())
        got, calls = _count_attention(lambda: td(*[t(a) for a in batch]))
        assert calls > 0  # through the attention wrappers, at Dh = d_model / n_heads
        assert got.dtype == tdt
        _close(got.detach().numpy(), ref, "logits")
        (got * t(w)).sum().backward()
        _grads_match(td, ref_grads)


@pytest.mark.parametrize("case", WIDTHS)
def test_dit_logits_and_gradients_match_jax(case, monkeypatch):
    _check_dit(*WIDTHS[case], monkeypatch, wide=case in FLOAT64)


def test_dit_at_dh_256_matches_jax_in_fp32_at_its_init_weights(monkeypatch):
    """The Dh-256 DiT in fp32 on both sides, the port's own fp32 casts in
    place, at flax's init weights (the module docstring)."""
    _check_dit(256, 1, monkeypatch, noise=False)


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
