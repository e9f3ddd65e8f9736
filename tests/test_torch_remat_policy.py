"""The port's remat policies (``models/base.resolve_remat_policy``, JAX's
``gradient_checkpointing_policy``) on the CPU, in fp32: on a tiny DiT,
NAR and AR with dropout on, every gradient under ``dots``, ``dots_all``
and ``nothing`` equals whole-block recompute's (``null``) within 1e-6, and
with dropout off within 1e-4·max(1, |ref|) of the JAX package's under the
same policy; an unknown name raises ``ValueError`` as JAX's does."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tts_with_diffusion_model_tpu.models import base as jax_base
from tts_with_diffusion_model_tpu.models.ar import AR as JaxAR
from tts_with_diffusion_model_tpu.models.diffusion import DiffusionConfig as JaxCfg
from tts_with_diffusion_model_tpu.models.diffusion import DiffusionModel as JaxModel
from tts_with_diffusion_model_tpu.models.nar import NAR as JaxNAR
from tts_with_diffusion_model_tpu_torch.convert import jax_params_to_torch, torch_params_to_jax
from tts_with_diffusion_model_tpu_torch.models import base
from tts_with_diffusion_model_tpu_torch.models.ar import AR
from tts_with_diffusion_model_tpu_torch.models.diffusion import DiffusionConfig, DiffusionModel
from tts_with_diffusion_model_tpu_torch.models.nar import NAR

from torch_port_helpers import flatten, perturbed, seeded_flax_params, t, unflatten

POLICIES = ["dots", "dots_all", "nothing"]
#: the same function recomputed: only the order of fp32 sums may differ
SELF_TOL = 1e-6
GRAD_TOL = 1e-4  # × max(1, max |ref|) per parameter, against JAX
N_TOKENS = 40
DIMS = dict(d_model=32, n_heads=2, n_layers=2)
DIT = dict(n_classes=33, d_model=32, n_heads=2, n_layers=2, timesteps=6, resp_len=12,
           text_len=7, prom_len=9)


def _batch(seed=0, B=3, Tt=6, Tp=8, Tr=10):
    rs = np.random.RandomState(seed)
    text = rs.randint(1, N_TOKENS, (B, Tt)).astype(np.int32)
    tm = np.ones((B, Tt), np.float32)
    tm[0, 4:] = 0
    proms = rs.randint(0, N_TOKENS, (B, Tp, 8)).astype(np.int32)
    pm = np.ones((B, Tp), np.float32)
    pm[1, 5:] = 0
    resps = rs.randint(0, N_TOKENS, (B, Tr, 8)).astype(np.int32)
    rm = np.ones((B, Tr), np.float32)
    rm[-1, 6:] = 0
    return text * tm.astype(np.int32), tm, proms, pm, resps * rm[..., None].astype(np.int32), rm


def _dit_batch():
    text, tm, proms, pm, resps, rm = _batch(B=2, Tt=7, Tp=9, Tr=12)
    return dict(text=text % 33, text_mask=tm, proms=proms % 33, prom_mask=pm,
                resp=resps[..., 0] % 32, resp_mask=rm)


class Family:
    """One model family: the port's loss and gradients under a policy (with
    or without dropout), and JAX's loss gradients under the same policy."""

    def __init__(self, name):
        self.name = name
        text, tm, proms, pm, resps, rm = _batch()
        z = jnp.zeros((3,), jnp.int32)
        if name == "dit":
            self.flat = seeded_flax_params(DiffusionModel(DiffusionConfig(**DIT)).denoiser, seed=1)
        elif name == "nar":
            jn = JaxNAR(N_TOKENS, dtype=jnp.float32, remat=False, **DIMS)
            self.flat = perturbed(jax.jit(jn.init)(jax.random.PRNGKey(0), text, tm, proms, pm,
                                                   resps, rm, z), seed=3)
        else:
            ja = JaxAR(N_TOKENS, dtype=jnp.float32, remat=False, **DIMS)
            self.flat = perturbed(jax.jit(ja.init)(jax.random.PRNGKey(1), text, tm, proms, pm,
                                                   resps[..., 0], rm), seed=4)
        self.noise = np.random.RandomState(5).rand(2, 12, 33).astype(np.float32)

    def port_grads(self, policy, dropout: bool):
        text, tm, proms, pm, resps, rm = _batch(seed=1)
        gen = torch.Generator().manual_seed(3) if dropout else None
        if self.name == "dit":
            model = DiffusionModel(DiffusionConfig(remat=True, remat_policy=policy, **DIT),
                                   dtype=torch.float32)
            module = model.denoiser
            jax_params_to_torch(self.flat, module)
            b = {k: t(v).long() if v.dtype.kind == "i" else t(v) for k, v in _dit_batch().items()}
            loss, _ = model.loss(b, None, q_noise=t(self.noise), t=torch.tensor([2, 5]))
        else:
            cls = NAR if self.name == "nar" else AR
            module = cls(N_TOKENS, dtype=torch.float32, remat=True, remat_policy=policy, **DIMS)
            jax_params_to_torch(self.flat, module)
            args = (t(text).long(), t(tm), t(proms).long(), t(pm))
            if self.name == "nar":
                _, losses = module(*args, t(resps).long(), t(rm), torch.tensor([0, 6, 3]),
                                   generator=gen)
            else:
                _, losses = module(*args, t(resps[..., 0]).long(), t(rm), generator=gen)
            loss = losses["nll"]
        loss.backward()
        return loss.item(), torch_params_to_jax(
            module, {n: p.grad for n, p in module.named_parameters()})

    def jax_grads(self, policy):
        text, tm, proms, pm, resps, rm = _batch(seed=1)
        params = unflatten(self.flat)
        if self.name == "dit":
            jm = JaxModel(JaxCfg(remat=True, remat_policy=policy, **DIT), dtype=jnp.float32)
            b = {k: jnp.asarray(v) for k, v in _dit_batch().items()}

            def jloss(p):
                tc, sc = jm.denoiser.apply(p, b["text"], b["text_mask"], b["proms"],
                                           b["prom_mask"], method=jm.denoiser.conds)
                tt = jnp.array([2, 5])
                x_t = (jm.d3pm.q_sample(b["resp"], tt, uniform_noise=jnp.asarray(self.noise))
                       * b["resp_mask"]).astype(jnp.int32)
                logits = jm.denoiser.apply(p, x_t, b["resp_mask"], tt, tc, b["text_mask"], sc,
                                           b["prom_mask"], method=jm.denoiser.denoise)
                logp = jax.nn.log_softmax(logits, axis=-1)
                nll = -jnp.take_along_axis(logp, b["resp"][..., None], axis=-1)[..., 0]
                return (nll * b["resp_mask"]).sum() / jnp.maximum(b["resp_mask"].sum(), 1.0)
        elif self.name == "nar":
            jn = JaxNAR(N_TOKENS, dtype=jnp.float32, remat=True, remat_policy=policy, **DIMS)

            def jloss(p):
                return jn.apply(p, text, tm, proms, pm, resps, rm, jnp.array([0, 6, 3]),
                                deterministic=True)[1]["nll"]
        else:
            ja = JaxAR(N_TOKENS, dtype=jnp.float32, remat=True, remat_policy=policy, **DIMS)

            def jloss(p):
                return ja.apply(p, text, tm, proms, pm, resps[..., 0], rm,
                                deterministic=True)[1]["nll"]
        loss, grads = jax.jit(jax.value_and_grad(jloss))(params)
        return float(loss), {k.removeprefix("params/"): np.asarray(v)
                             for k, v in flatten(grads).items()}


_FAMILIES = {}


def _family(name):
    if name not in _FAMILIES:
        _FAMILIES[name] = Family(name)
    return _FAMILIES[name]


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("family", ["dit", "nar", "ar"])
def test_policy_gradients_equal_whole_block_recompute_and_jax(family, policy):
    fam = _family(family)
    dropout = family != "dit"  # the DiT has no dropout
    ref_loss, ref = fam.port_grads(None, dropout)
    loss, got = fam.port_grads(policy, dropout)
    assert loss == ref_loss
    for key, r in ref.items():
        err = float(np.abs(got[key] - r).max())
        assert err <= SELF_TOL * max(1.0, float(np.abs(r).max())), (key, err)

    jloss, jgrads = fam.jax_grads(policy)
    loss, got = fam.port_grads(policy, dropout=False)
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    assert set(got) == set(jgrads)
    for key, r in jgrads.items():
        err = float(np.abs(got[key] - r).max())
        assert err <= GRAD_TOL * max(1.0, float(np.abs(r).max())), (key, err)


def test_unknown_policy_raises_value_error_like_jax():
    with pytest.raises(ValueError, match="unknown remat policy"):
        jax_base.resolve_remat_policy("everything")
    with pytest.raises(ValueError, match="unknown remat policy"):
        base.resolve_remat_policy("everything")
    with pytest.raises(ValueError, match="unknown remat policy"):
        NAR(N_TOKENS, remat_policy="everything", **DIMS)
    # JAX's nothing_saveable is whole-block recompute: the same context as null
    for name in (None, "nothing"):
        assert base.resolve_remat_policy(name) is torch.utils.checkpoint.noop_context_fn


def test_dots_saves_the_projections_and_recomputes_attention():
    """Under ``dots`` the recompute of a block runs no projection matmul
    again (the saved outputs are handed back) but does run attention; under
    ``nothing`` it runs both."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops.append(func)
            return func(*args, **(kwargs or {}))

    counts = {}
    for policy in (None, "dots", "nothing"):
        model = NAR(N_TOKENS, dtype=torch.float32, remat=True, remat_policy=policy, **DIMS)
        jax_params_to_torch(_family("nar").flat, model)
        text, tm, proms, pm, resps, rm = _batch(seed=1)
        _, losses = model(t(text).long(), t(tm), t(proms).long(), t(pm), t(resps).long(), t(rm),
                          torch.tensor([0, 6, 3]))
        with Count() as c:
            losses["nll"].backward()
        counts[policy] = sum(op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
                             for op in c.ops)
    # the backward's own gradient matmuls are the same under every policy;
    # whole-block recompute adds every block's forward projections again
    assert counts["dots"] < counts["nothing"] == counts[None]
