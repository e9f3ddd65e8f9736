"""The port's AR and NAR training forwards against the JAX package's, in
fp32 on the CPU: flax parameters carried over with ``jax_params_to_torch``
(seeded noise on top, so the zero-initialised AdaLN tables and biases take
part and AdaLN's stop-gradient term is exercised), the same ragged batch,
dropout off on both sides (flax's dropout streams cannot be reproduced in
torch); the loss within 1e-5 relative and every parameter's gradient within
1e-4·max(1, |ref|), remat on and off.  Also: ``build_targets`` identical,
slot causality against the JAX dense path's position causality, the port's
dropout (rate, scaling, and remat redrawing the same masks), and the
registry's ``ar*`` / ``nar*`` branches."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tts_with_diffusion_model_tpu.models import get_model as jax_get_model
from tts_with_diffusion_model_tpu.models import base as jax_base
from tts_with_diffusion_model_tpu.models.ar import AR as JaxAR
from tts_with_diffusion_model_tpu.models.nar import NAR as JaxNAR
from tts_with_diffusion_model_tpu.ops.attention import dense_attention as jax_dense_attention
from tts_with_diffusion_model_tpu_torch.convert import jax_params_to_torch, torch_params_to_jax
from tts_with_diffusion_model_tpu_torch.models import base, get_model
from tts_with_diffusion_model_tpu_torch.models.ar import AR
from tts_with_diffusion_model_tpu_torch.models.nar import NAR
from tts_with_diffusion_model_tpu_torch.ops.train_flash_attention import (
    train_flash_attention_plain,
)

from torch_port_helpers import flatten, perturbed, t, unflatten

LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4  # × max(1, max |ref|) per parameter; fp32 sums in another order
N_TOKENS = 40
DIMS = dict(d_model=64, n_heads=4, n_layers=2)


def _batch(seed=0, B=3, Tt=6, Tp=8, Tr=10):
    """A ragged batch: text and prompt pads in the middle of the packed row,
    and (row 2) a response of a single frame."""
    rs = np.random.RandomState(seed)
    text = rs.randint(1, N_TOKENS, (B, Tt)).astype(np.int32)
    tm = np.ones((B, Tt), np.float32)
    tm[0, 4:] = 0
    tm[2, 2:] = 0
    proms = rs.randint(0, N_TOKENS, (B, Tp, 8)).astype(np.int32)
    pm = np.ones((B, Tp), np.float32)
    pm[1, 5:] = 0
    pm[2, 3:] = 0
    resps = rs.randint(0, N_TOKENS, (B, Tr, 8)).astype(np.int32)
    rm = np.ones((B, Tr), np.float32)
    rm[1, 7:] = 0
    rm[2, 1:] = 0
    resps = resps * rm[..., None].astype(np.int32)
    text = text * tm.astype(np.int32)
    return text, tm, proms, pm, resps, rm


def _grads_match(module, ref_grads):
    got = torch_params_to_jax(module, {n: p.grad for n, p in module.named_parameters()})
    ref = {k.removeprefix("params/"): v for k, v in flatten(ref_grads).items()}
    assert set(got) == set(ref)
    for key, r in ref.items():
        err = float(np.abs(got[key] - r).max())
        assert err <= GRAD_TOL * max(1.0, float(np.abs(r).max())), (key, err)


@functools.cache
def _nar_params():
    jn = JaxNAR(N_TOKENS, dtype=jnp.float32, remat=False, **DIMS)
    text, tm, proms, pm, resps, rm = _batch()
    params = jax.jit(jn.init)(jax.random.PRNGKey(0), text, tm, proms, pm, resps, rm,
                              jnp.zeros((3,), jnp.int32))
    return perturbed(params, seed=3)


@functools.cache
def _ar_params():
    ja = JaxAR(N_TOKENS, dtype=jnp.float32, remat=False, **DIMS)
    text, tm, proms, pm, resps, rm = _batch()
    params = jax.jit(ja.init)(jax.random.PRNGKey(1), text, tm, proms, pm, resps[..., 0], rm)
    return perturbed(params, seed=4)


@pytest.mark.parametrize("remat", [False, True])
def test_nar_loss_and_every_gradient_match_jax(remat):
    flat = _nar_params()
    assert np.abs(flat["params/base/block_0/norm_attn/emb"]).max() > 0  # AdaLN takes part
    jn = JaxNAR(N_TOKENS, dtype=jnp.float32, remat=remat, **DIMS)
    text, tm, proms, pm, resps, rm = _batch(seed=1)
    ql = np.array([0, 6, 3], np.int32)

    def jloss(p):
        return jn.apply(p, text, tm, proms, pm, resps, rm, jnp.asarray(ql),
                        deterministic=True)[1]["nll"]

    ref_loss, ref_grads = jax.jit(jax.value_and_grad(jloss))(unflatten(flat))
    tn = NAR(N_TOKENS, dtype=torch.float32, remat=remat, **DIMS)
    jax_params_to_torch(flat, tn)
    _, losses = tn(t(text).long(), t(tm), t(proms).long(), t(pm), t(resps).long(), t(rm),
                   t(ql).long())
    np.testing.assert_allclose(losses["nll"].item(), float(ref_loss), rtol=LOSS_RTOL)
    losses["nll"].backward()
    _grads_match(tn, ref_grads)


@pytest.mark.parametrize("remat", [False, True])
def test_ar_loss_and_every_gradient_match_jax(remat):
    flat = _ar_params()
    ja = JaxAR(N_TOKENS, dtype=jnp.float32, remat=remat, **DIMS)
    text, tm, proms, pm, resps, rm = _batch(seed=2)
    resp = resps[..., 0]

    def jloss(p):
        return ja.apply(p, text, tm, proms, pm, resp, rm, deterministic=True)[1]["nll"]

    ref_loss, ref_grads = jax.jit(jax.value_and_grad(jloss))(unflatten(flat))
    ta = AR(N_TOKENS, dtype=torch.float32, remat=remat, **DIMS)
    jax_params_to_torch(flat, ta)
    logits, losses = ta(t(text).long(), t(tm), t(proms).long(), t(pm), t(resp).long(), t(rm))
    assert logits.shape[-1] == N_TOKENS + 1 and ta.stop_token == N_TOKENS
    np.testing.assert_allclose(losses["nll"].item(), float(ref_loss), rtol=LOSS_RTOL)
    losses["nll"].backward()
    _grads_match(ta, ref_grads)


@pytest.mark.parametrize("mode", ["nar", "ar"])
def test_build_targets_are_identical(mode):
    text, tm, proms, pm, resps, rm = _batch(seed=5)
    targ = resps[..., 2]
    kw = (dict(resp_loss_only=True, shift=False, stop_token=None) if mode == "nar"
          else dict(resp_loss_only=False, shift=True, stop_token=N_TOKENS))
    ref = np.asarray(jax_base.build_targets(*[jnp.asarray(a) for a in (text, tm, pm, targ, rm)],
                                            **kw))
    got = base.build_targets(t(text).long(), t(tm), t(pm), t(targ).long(), t(rm), **kw).numpy()
    np.testing.assert_array_equal(got, ref)
    assert (got != base.IGNORE_INDEX).any()
    if mode == "ar":  # the single-frame response: the sep targets it, its slot the stop token
        sep2 = text.shape[1] + 1 + pm.shape[1]
        assert got[2, sep2] == targ[2, 0] and got[2, sep2 + 1] == N_TOKENS


def test_masked_cross_entropy_matches():
    rs = np.random.RandomState(6)
    logits = rs.randn(2, 9, 11).astype(np.float32) * 3
    targets = rs.randint(0, 11, (2, 9))
    targets[0, :4] = base.IGNORE_INDEX
    ref = float(jax_base.masked_cross_entropy(jnp.asarray(logits), jnp.asarray(targets)))
    got = base.masked_cross_entropy(t(logits), t(targets).long()).item()
    np.testing.assert_allclose(got, ref, rtol=1e-6)
    none = torch.full((2, 9), base.IGNORE_INDEX)
    assert base.masked_cross_entropy(t(logits), none).item() == 0.0


def test_slot_causality_equals_position_causality_at_valid_queries():
    """The kernel's plain version hides key slot j > i; the JAX dense path
    hides packed position pos_j > pos_i.  Pads sit at segment tails, so the
    two agree at every valid query, with text and prompt pads in the middle
    of the packed row."""
    text, tm, proms, pm, resps, rm = _batch(seed=7)
    mask, pos, _ = base.packed_layout(t(tm), t(pm), t(rm))
    B, T = mask.shape
    rs = np.random.RandomState(8)
    q, k, v = (rs.randn(B, T, 4, 16).astype(np.float32) for _ in range(3))
    pair = (mask[:, :, None] * mask[:, None, :]).numpy()
    pair = pair * (pos.numpy()[:, None, :] <= pos.numpy()[:, :, None])
    ref = np.asarray(jax_dense_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                         pair_mask=jnp.asarray(pair)))
    got = train_flash_attention_plain(t(q), t(k), t(v), mask, causal=True).numpy()
    valid = mask.numpy() > 0
    assert (~valid[:, :tm.shape[1]]).any() and (~valid[:, tm.shape[1] + 1:-rm.shape[1] - 1]).any()
    np.testing.assert_allclose(got[valid], ref[valid], atol=1e-5)


def test_dropout_keeps_nine_tenths_and_scales_by_one_over_nine_tenths():
    drop = base.Dropout(0.1, seed=11, device="cpu")
    x = torch.ones(1000, 1000)
    y = drop(x)
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.9) < 0.01
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1 / 0.9), rtol=0, atol=0)
    again = base.Dropout(0.1, seed=11, device="cpu")(x)
    assert torch.equal(again, y)  # the seed alone fixes the mask
    assert not torch.equal(drop(x), y)  # the next site gets the next mask


def _train_forward(family, remat, generator):
    model = get_model(f"{family}-quarter", N_TOKENS, dict(DIMS, remat=remat), dtype=torch.float32)
    jax_params_to_torch(_nar_params() if family == "nar" else _ar_params(), model)
    text, tm, proms, pm, resps, rm = (t(a) for a in _batch(seed=9))
    args = (text.long(), tm, proms.long(), pm)
    if family == "nar":
        _, losses = model(*args, resps.long(), rm, torch.tensor([1, 4, 6]), generator=generator)
    else:
        _, losses = model(*args, resps[..., 0].long(), rm, generator=generator)
    losses["nll"].backward()
    return model, losses["nll"].item(), [p.grad.clone() for p in model.parameters()]


@pytest.mark.parametrize("family", ["nar", "ar"])
def test_remat_on_and_off_give_identical_loss_and_gradients_with_dropout_on(family):
    """Checkpoint recomputes each block in the backward; the block must draw
    the masks it drew in the forward, or the gradient is another function's."""
    _, loss_off, grads_off = _train_forward(family, False, torch.Generator().manual_seed(3))
    model, loss_on, grads_on = _train_forward(family, True, torch.Generator().manual_seed(3))
    assert model.base.p_dropout == 0.1 and model.base.remat
    assert loss_on == loss_off
    assert all(torch.equal(a, b) for a, b in zip(grads_on, grads_off))
    _, loss_det, _ = _train_forward(family, True, None)
    assert loss_det != loss_on  # the generator did turn dropout on


@pytest.mark.parametrize("name", ["ar", "ar-half", "ar-quarter", "nar", "nar-quarter"])
def test_registry_dims_match_jax(name):
    ref = jax_get_model(name, 1024)
    with torch.device("meta"):
        got = get_model(name, 1024)
    assert type(got).__name__ == type(ref).__name__
    blocks = got.base.blocks()
    assert (got.base.d_model, blocks[0].attn.n_heads, len(blocks)) == (
        ref.d_model, ref.n_heads, ref.n_layers)
    assert got.base.remat and got.base.p_dropout == ref.p_dropout
    over = get_model(name, 64, {"d_model": 32, "n_heads": 2, "n_layers": 1, "remat": False,
                                "attn_impl": "flash", "timesteps": 9})
    assert over.base.d_model == 32 and over.base.n_layers == 1 and not over.base.remat


def test_registry_refuses_bad_names():
    with pytest.raises(NotImplementedError):
        get_model("nar-eighth")
    with pytest.raises(ValueError):
        get_model("tts")
    # the Gaussian family is built; its UNet denoisers still refuse the
    # embedding domain, as JAX's do
    with pytest.raises(ValueError, match="requires domain='value'"):
        get_model("diffusion-gaussian", 64, {"denoiser": "conv-unet"})
    # every policy JAX knows is ported; an unknown one raises as JAX's does
    with pytest.raises(ValueError, match="unknown remat policy"):
        get_model("ar-quarter", 64, {"remat_policy": "dot"})


@pytest.mark.parametrize("family", ["ar", "nar"])
def test_flax_initialised_tree_carries_over_with_nothing_left(family):
    flat = _nar_params() if family == "nar" else _ar_params()
    model = get_model(f"{family}-quarter", N_TOKENS, DIMS, dtype=torch.float32)
    assert len(flat) == len(list(model.parameters()))
    jax_params_to_torch(flat, model)  # raises on a leftover array or an unset parameter
    back = torch_params_to_jax(model)
    assert set(back) == {k.removeprefix("params/") for k in flat}
    for k, v in back.items():
        np.testing.assert_array_equal(v, flat[f"params/{k}"])
