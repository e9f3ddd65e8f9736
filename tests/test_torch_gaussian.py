"""The port's Gaussian family against the JAX package, module by module, in
fp32 on the CPU: the process terms and samples, the two decode domains,
per-row normals, the registry, and for each denoiser (the DiT in the
embedding and value domains, its ``-unet`` bottleneck, the conv-UNet) ε̂
within 1e-4·max(1, |ref|), the loss at a fixed
t and noise within 1e-5 relative and every gradient within
1e-4·max(1, |ref|); then ``generate`` under injected normals.

Sizes: d 32, T=6, resp 16 (and 15: an odd length takes flax's (0, 1)
padding of the stride-2 conv and the transposed conv's crop).  Head widths
are multiples of 8, as the kernels take them: 2 heads for the DiT, a
(24, 16) bottleneck for ``-unet``, 1 head for the conv-UNet's channels
(8, 16).  The UNet2DCondition's parity and the conv-UNet's bucket
invariance are in ``test_torch_gaussian_unet.py``.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import (  # noqa: F401 (one_thread: fixture)
    TableKeys,
    flatten,
    one_thread,
    patch_jax_noise,
    perturbed,
    t,
    unflatten,
)
from tts_with_diffusion_model_tpu.diffusion import gaussian as jg
from tts_with_diffusion_model_tpu.models import get_model as jax_get_model
from tts_with_diffusion_model_tpu.models.gaussian_tts import GaussianConfig as JConfig
from tts_with_diffusion_model_tpu.models.gaussian_tts import GaussianDiffusionModel as JModel
from tts_with_diffusion_model_tpu_torch.convert import (init_seeded, jax_params_to_torch,
                                                         torch_params_to_jax)
from tts_with_diffusion_model_tpu_torch.diffusion import gaussian as pg
from tts_with_diffusion_model_tpu_torch.models import get_model
from tts_with_diffusion_model_tpu_torch.models.gaussian_tts import GaussianConfig
from tts_with_diffusion_model_tpu_torch.models.gaussian_tts import GaussianDiffusionModel
from tts_with_diffusion_model_tpu_torch.utils.rng import RowKeys

pytestmark = pytest.mark.usefixtures("one_thread")

V, TT, TP = 64, 5, 7
#: (name, config fields, resp lengths of the generic test, perturbation)
KINDS = {
    "dit-embedding": (dict(domain="embedding", n_heads=2), (16,), 0.1),
    "dit-value": (dict(domain="value", n_heads=2), (16,), 0.1),
    "dit-unet": (dict(domain="embedding", n_heads=2, unet_dims=(24, 16)), (16,), 0.1),
    "conv-unet": (dict(domain="value", denoiser="conv-unet", n_heads=1,
                       unet_channels=(8, 16)), (16, 15), 0.1),
    "unet2d-ref": (dict(domain="value", denoiser="unet2d-ref", n_heads=2,
                        unet_channels=(8, 16, 32, 32)), (), 0.0),
}
CASES = [(k, r) for k, (_, lens, _) in KINDS.items() for r in lens]


def _cfg(kind: str, resp_len: int) -> dict:
    return dict(n_tokens=V, d_model=32, n_layers=2, timesteps=6, resp_len=resp_len,
                text_len=TT, prom_len=TP, gen_len=resp_len - 4, **KINDS[kind][0])


@functools.lru_cache(maxsize=None)
def _init(kind: str, resp_len: int, seed: int) -> dict:
    """The JAX init, perturbed, flat; one compile per (kind, resp_len, seed)
    for the whole module (callers copy it)."""
    jm = JModel(JConfig(**_cfg(kind, resp_len)), dtype=jnp.float32)
    return perturbed(jax.jit(jm.init)(jax.random.PRNGKey(seed)), seed + 1, scale=KINDS[kind][2])


def _pair(kind: str, resp_len: int, seed: int = 0):
    jm = JModel(JConfig(**_cfg(kind, resp_len)), dtype=jnp.float32)
    pm = GaussianDiffusionModel(GaussianConfig(**_cfg(kind, resp_len)), dtype=torch.float32)
    flat = _init(kind, resp_len, seed)
    jax_params_to_torch(flat, pm.denoiser)
    return jm, unflatten(flat), pm


def _batch(resp_len: int, B: int = 3, seed: int = 2) -> dict:
    rs = np.random.RandomState(seed)
    tm = np.ones((B, TT), np.float32)
    tm[1, 3:] = 0
    pm = np.ones((B, TP), np.float32)
    pm[2, 4:] = 0
    rm = np.ones((B, resp_len), np.float32)
    rm[1, resp_len - 4:] = 0
    rm[2, resp_len - 7:] = 0
    return dict(text=rs.randint(1, V, (B, TT)), text_mask=tm,
                proms=rs.randint(0, V, (B, TP, 8)), prom_mask=pm,
                resp=rs.randint(0, V, (B, resp_len)), resp_mask=rm)


def _close(got, ref, what, rel=1e-4):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    err = float(np.abs(got - ref).max()) if got.size else 0.0
    assert err <= rel * max(1.0, float(np.abs(ref).max())), f"{what}: max |Δ| {err:.3g}"


# ---------------- process and domains ----------------

@pytest.mark.parametrize("schedule", ["cosine", "linear"])
def test_process_terms_and_steps_match(schedule):
    jp, pp = jg.GaussianDiffusion.create(9, schedule), pg.GaussianDiffusion.create(9, schedule)
    for f in dataclasses.fields(pp):
        if f.name != "timesteps":
            a, b = getattr(pp, f.name), np.asarray(getattr(jp, f.name))
            assert a.dtype == torch.float32
            np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-7, err_msg=f.name)
    rs = np.random.RandomState(0)
    x0, eps, z = (rs.randn(4, 5, 3).astype(np.float32) for _ in range(3))
    tt = np.array([0, 1, 4, 8])
    _close(pp.q_sample(t(x0), t(tt), t(eps)), jp.q_sample(x0, tt, eps), "q_sample", 1e-6)
    for clip in (None, 1.0):
        _close(pp.p_sample(t(eps), t(x0), t(tt), t(z), clip=clip),
               jp.p_sample(eps, x0, tt, z, clip=clip), f"p_sample clip={clip}", 1e-6)
    # t = 0 adds no noise: the step is deterministic
    zero = np.zeros(4, np.int64)
    a = pp.p_sample(t(eps), t(x0), t(zero), t(z))
    b = pp.p_sample(t(eps), t(x0), t(zero), t(rs.randn(4, 5, 3).astype(np.float32)))
    assert torch.equal(a, b)


def test_domains_round_trip_and_nearest_embedding():
    ids = np.arange(V)
    x = pg.normalize_tokens(t(ids), V)
    _close(x, jg.normalize_tokens(jnp.asarray(ids), V), "normalize", 1e-7)
    assert torch.equal(pg.denormalize_tokens(x, V), t(ids))
    # half-way values round to even in both packages
    rs = np.random.RandomState(1)
    halves = (np.arange(-3, V + 3) + 0.5) / (V - 1) * 2 - 1
    vals = np.concatenate([halves, rs.uniform(-1.2, 1.2, 200)]).astype(np.float32)
    np.testing.assert_array_equal(pg.denormalize_tokens(t(vals), V).numpy(),
                                  np.asarray(jg.denormalize_tokens(jnp.asarray(vals), V)))
    table = rs.randn(V + 1, 16).astype(np.float32)
    xs = rs.randn(4, 30, 16).astype(np.float32) * 2
    got = pg.nearest_embedding(t(xs), t(table)).numpy()
    ref = np.asarray(jg.nearest_embedding(jnp.asarray(xs), jnp.asarray(table)))
    d = np.sort((table ** 2).sum(-1) - 2 * xs @ table.T, axis=-1)
    clear = (d[..., 1] - d[..., 0]) > 1e-4
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(got[clear], ref[clear])
    np.testing.assert_array_equal(pg.nearest_embedding(t(table[[3, 7]]), t(table)).numpy(), [3, 7])


def test_row_normals_depend_only_on_their_row():
    keys = RowKeys.from_seeds([5, 9, 11])
    both = keys.fold(3).normal((6, 2))
    solo = RowKeys.from_seeds([9]).fold(3).normal((6, 2))
    assert both.shape == (3, 6, 2) and both.dtype == torch.float32
    assert torch.equal(both[1], solo[0])
    assert not torch.equal(both[0], keys.fold(4).normal((6, 2))[0])


# ---------------- registry ----------------

NAMES = ["diffusion-gaussian", "diffusion-gaussian-value", "diffusion-gaussian-unet",
         "diffusion-gaussian-unet2d", "diffusion-gaussian-unet2d-ref",
         "diffusion-gaussian-unet-value"]


@pytest.mark.parametrize("name", NAMES)
def test_registry_names_match_jax(name):
    ov = {"d_model": 16, "n_layers": 1, "timesteps": 4, "unet_channels": (8, 16, 16, 16),
          "not_a_field": 1} if name.endswith("unet2d-ref") else {"d_model": 16, "n_layers": 1}
    with torch.device("meta"):
        pm = get_model(name, 64, ov)
    jm = jax_get_model(name, 64, ov)
    assert dataclasses.asdict(pm.config) == dataclasses.asdict(jm.config)
    if name.endswith("unet2d-ref"):
        # overrides apply on top of the published widths and 8 heads
        assert pm.config.unet_channels == (8, 16, 16, 16) and pm.config.n_heads == 8
        with torch.device("meta"):
            assert get_model(name, 64).config.unet_channels == (320, 640, 1280, 1280)


# ---------------- denoisers: ε̂, loss, gradients ----------------

def _jax_loss(jm, params, batch, tt, noise):
    """The JAX ``loss`` with the timesteps and noise given (its lines after
    the draws) → (loss, (ε̂, x_t))."""
    rm = batch["resp_mask"]
    x0 = jm._to_domain(params, batch["resp"])
    x_t = jm.process.q_sample(x0, tt, noise) * rm[..., None]
    eps = jm.denoiser.apply(params, batch["text"], batch["text_mask"], batch["proms"],
                            batch["prom_mask"], x_t, rm, tt)
    loss = ((eps - noise) ** 2 * rm[..., None]).sum() / jnp.maximum(rm.sum() * x0.shape[-1], 1.0)
    return loss, (eps, x_t)


def _check_eps_loss_and_gradients(jm, params, pm, batch, tt, noise, what, rel=1e-4):
    """ε̂ at the loss's x_t within ``rel``·max(1, |ref|), the loss within
    ``rel`` / 10 relative, and every gradient of the denoiser within
    ``rel``·max(1, |ref|), against one jitted JAX value-and-grad."""
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    pb = {k: t(v) for k, v in batch.items()}
    (ref_loss, (ref_eps, x_t)), ref_grads = jax.jit(jax.value_and_grad(
        lambda p: _jax_loss(jm, p, jb, jnp.asarray(tt), jnp.asarray(noise)), has_aux=True))(params)
    with torch.no_grad():
        got = pm.denoiser(pb["text"], pb["text_mask"], pb["proms"], pb["prom_mask"],
                          t(np.asarray(x_t)), pb["resp_mask"], t(tt))
    _close(got, ref_eps, f"{what} eps", rel)
    R = batch["resp"].shape[1]
    assert float(got[1, R - 4:].abs().sum()) == 0.0

    loss, stats = pm.loss(pb, None, t=t(tt), noise=t(noise))
    assert abs(loss.item() - float(ref_loss)) <= rel / 10 * abs(float(ref_loss))
    assert stats["mse"] is loss
    loss.backward()
    # the value domain leaves resp_table unused: JAX's gradient there is 0
    grads = torch_params_to_jax(pm.denoiser, {
        n: torch.zeros_like(p) if p.grad is None else p.grad
        for n, p in pm.denoiser.named_parameters()})
    refg = {k.removeprefix("params/"): v for k, v in flatten(ref_grads).items()}
    assert set(grads) == set(refg)
    for key, r in refg.items():
        _close(grads[key], r, f"{what} grad {key}", rel)


@pytest.mark.parametrize("kind,resp_len", CASES)
def test_denoiser_eps_loss_and_gradients_match(kind, resp_len):
    jm, params, pm = _pair(kind, resp_len)
    rs = np.random.RandomState(3)
    noise = rs.randn(3, resp_len, pm.in_dim).astype(np.float32)
    _check_eps_loss_and_gradients(jm, params, pm, _batch(resp_len), np.array([1, 3, 5]), noise,
                                  kind)


def test_dit_remat_gives_the_same_gradients():
    base = GaussianConfig(**_cfg("dit-unet", 16))
    b = {k: t(v) for k, v in _batch(16).items()}
    tt, noise = t(np.array([1, 2, 5])), torch.randn(3, 16, 32, generator=torch.Generator()
                                                      .manual_seed(0))
    out = []
    for remat in (False, True):
        m = GaussianDiffusionModel(dataclasses.replace(base, remat=remat), dtype=torch.float32)
        init_seeded(m.denoiser, 4)
        m.loss(b, None, t=tt, noise=noise)[0].backward()
        out.append([p.grad.clone() for p in m.denoiser.parameters()])
    for a, c in zip(*out):
        assert torch.allclose(a, c, atol=1e-6)


# ---------------- generate ----------------

def _tables(pm, B: int, seed: int = 7) -> dict:
    rs = np.random.RandomState(seed)
    c = pm.config
    return {(tag, 2): rs.randn(B, c.resp_len, pm.in_dim).astype(np.float32)
            for tag in range(c.timesteps + 1)}


@pytest.mark.parametrize("kind", ["dit-embedding", "dit-value", "conv-unet"])
def test_generate_matches_jax_under_injected_normals(monkeypatch, kind):
    from tts_with_diffusion_model_tpu.utils import rng as jrng

    R = 16
    jm, params, pm = _pair(kind, R)
    b = _batch(R)
    tables = _tables(pm, 3)
    seen = {}
    j_from, p_from = jm._from_domain, pm._from_domain

    def keep(side, fn):
        def wrapped(*args):
            seen[side] = np.asarray(args[-1])
            return fn(*args)
        return wrapped

    monkeypatch.setattr(jm, "_from_domain", keep("jax", j_from))
    monkeypatch.setattr(pm, "_from_domain", keep("port", p_from))
    patch_jax_noise(monkeypatch, jrng, tables)
    args = [b[k] for k in ("text", "text_mask", "proms", "prom_mask")]
    ref = np.asarray(jm.generate(params, *map(jnp.asarray, args), jnp.zeros((3, 2), jnp.uint32)))
    got = pm.generate(*map(t, args), TableKeys(tables)).numpy()
    gl = pm.config.gen_len
    _close(seen["port"], seen["jax"], f"{kind} final x")
    x = seen["jax"]
    if pm.config.domain == "value":
        v = (x[..., 0] + 1.0) / 2.0 * (V - 1)
        near = np.abs(v - np.floor(v) - 0.5) < 1e-3
    else:
        table = np.asarray(params["params"]["resp_table"])
        d = np.sort((table ** 2).sum(-1) - 2 * x @ table.T, axis=-1)
        near = (d[..., 1] - d[..., 0]) < 1e-4
    near[:, gl:] = False  # padding: x is 0 there, and the tokens are masked to 0
    assert near.sum() <= 2, f"{near.sum()} positions at a decision boundary"
    np.testing.assert_array_equal(got[~near], ref[~near])
    assert got.shape == (3, R) and (got[:, gl:] == 0).all()
    assert got.min() >= 0 and got.max() < V


@pytest.mark.parametrize("kind", ["dit-embedding", "conv-unet"])
def test_generate_rows_do_not_depend_on_their_cohort(kind):
    _, _, pm = _pair(kind, 16)
    b = {k: t(v) for k, v in _batch(16).items()}
    args = [b[k] for k in ("text", "text_mask", "proms", "prom_mask")]
    keys = RowKeys.from_seeds([3, 4, 5])
    both = pm.generate(*args, keys)
    solo = pm.generate(*[a[1:2] for a in args], RowKeys.from_seeds([4]))
    assert torch.equal(both[1:2], solo)
    assert torch.equal(both, pm.generate(*args, keys))
