"""The D3PM recipe ``config/gen4c/diffusion.yml`` as each package resolves
it, on the CPU: every field of the resolved config, defaults included; the
learning rate each optimizer applies at every one of the recipe's 2000
updates; gradient clipping, Adam without weight decay and the EMA at 0.999
over the warm-up's end; the model the train CLI builds, the loss's
timestep draw and weighting; the 95/5 seed-0 split with ``max_num_val`` 32
and ``min_phones`` 3, prompt sampling (``p_additional_prompt``) and the
batches of the ``resp_len_buckets: [192]`` sampler.  Widths are cut
(``model_overrides``); everything else is the recipe's."""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tts_with_diffusion_model_tpu.config import Config as JaxConfig
from tts_with_diffusion_model_tpu.data.dataset import (
    create_train_val_dataloader as jax_loaders,
)
from tts_with_diffusion_model_tpu.train import train as jax_train
from tts_with_diffusion_model_tpu.train.engine import make_optimizer
from tts_with_diffusion_model_tpu_torch import smoke_train
from tts_with_diffusion_model_tpu_torch.config import Config
from tts_with_diffusion_model_tpu_torch.convert import jax_params_to_torch
from tts_with_diffusion_model_tpu_torch.data.dataset import create_train_val_dataloader
from tts_with_diffusion_model_tpu_torch.train import train as port_train
from tts_with_diffusion_model_tpu_torch.train.engine import Engine

from torch_port_helpers import one_thread, seeded_flax_params, t, unflatten  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

REPO = Path(__file__).resolve().parents[1]
RECIPE = f"yaml={REPO / 'config/gen4c/diffusion.yml'}"
CUT = ["model_overrides={d_model: 32, n_heads: 2, n_layers: 2}", "use_fp16=false"]


def _configs(*extra):
    return JaxConfig.from_cli([RECIPE, *extra]), Config.from_cli([RECIPE, *extra])


def test_resolved_recipe_config_equals_the_jax_packages():
    """Every field, defaults included, equal but the device (each
    package's own default); the optimizer block equal."""
    jcfg, pcfg = _configs()
    jf = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    pf = {f.name: getattr(pcfg, f.name) for f in dataclasses.fields(pcfg)}
    assert set(jf) == set(pf)
    assert {k for k in jf if jf[k] != pf[k]} == {"device"}
    assert (jf["device"], pf["device"]) == ("tpu", "cuda")
    assert jcfg.optimizer_cfg == pcfg.optimizer_cfg
    sched = pcfg.optimizer_cfg["scheduler"]
    assert (sched["warmup_max_lr"], sched["warmup_num_steps"], sched["total_num_steps"]) == (
        5e-4, 200, 2000)
    assert (pcfg.gradient_clipping, pcfg.ema_decay, pcfg.batch_size, pcfg.seed) == (
        1.0, 0.999, 32, 0)
    assert (pcfg.p_additional_prompt, pcfg.max_prompts, pcfg.max_num_val, pcfg.min_phones) == (
        0.8, 6, 32, 3)
    assert (pcfg.resp_len_buckets, pcfg.diffusion_train_mode, pcfg.max_train_diffusion_steps) == (
        [192], "sampled", None)


class _Two(torch.nn.Module):
    def __init__(self, w, b):
        super().__init__()
        self.w = torch.nn.Parameter(torch.from_numpy(w))
        self.b = torch.nn.Parameter(torch.from_numpy(b))


def test_learning_rate_applied_at_every_update_of_the_recipe():
    """The port's schedule equals optax's (``make_optimizer``, float32) bit
    for bit at every count 0..2000 of the recipe: linear from
    ``warmup_min_lr`` to 5e-4 at count 200, then down to 0 at 2000.  Each
    optimizer applies count n at update n: a constant unit gradient makes
    Adam's update −lr/(1 + eps), so the update reads back the lr applied
    (optax's within the float32 rounding of its bias corrections, 2e-4;
    one count off would differ by 5.5e-4 or more)."""
    jcfg, pcfg = _configs()
    n = pcfg.max_iter
    tx, schedule = make_optimizer(jcfg.optimizer_cfg)
    module = _Two(np.zeros((1,), np.float64), np.zeros((0,), np.float64))
    engine = Engine("model", module, None, pcfg.optimizer_cfg, REPO)
    lrs = np.array([engine.schedule(i) for i in range(n + 1)])
    np.testing.assert_array_equal(lrs, [float(schedule(i)) for i in range(n + 1)])
    np.testing.assert_allclose(lrs[[0, 100, 200, 1100, 1999, 2000]],
                               [1e-9, 0.5 * (1e-9 + 5e-4), 5e-4, 2.5e-4, 5e-4 / 1800, 0.0],
                               rtol=1e-6, atol=1e-10)

    state = tx.init({"w": jnp.zeros((1,), jnp.float32)})
    unit = {"w": jnp.ones((1,), jnp.float32)}
    step = jax.jit(lambda s: tx.update(unit, s))
    ref, got = [], []
    for _ in range(n):
        upd, state = step(state)
        ref.append(-float(upd["w"][0]) * (1 + 1e-8))
        before = module.w.detach().clone()
        engine._apply([torch.ones(1, dtype=torch.float64), torch.zeros(0, dtype=torch.float64)])
        got.append(float(before - module.w.detach()) * (1 + 1e-8))
    assert engine.update_count == n
    np.testing.assert_allclose(got, lrs[:n], rtol=1e-9)  # float64 bias corrections
    np.testing.assert_allclose(ref, lrs[:n], rtol=2e-4)


def test_clipping_adam_and_ema_of_the_recipe_match_optax():
    """205 updates from seeded gradients, half of them above the clipping
    norm 1.0: the parameters and the EMA (decay 0.999) of the port's
    ``Engine`` stay within fp32 rounding of optax's chain and the JAX
    engine's EMA, through the warm-up's end at update 200; torch's Adam has
    no weight decay, as optax's has none."""
    jcfg, pcfg = _configs()
    rs = np.random.RandomState(0)
    w0 = rs.randn(4, 8).astype(np.float32)
    b0 = rs.randn(8).astype(np.float32)
    n = 205
    grads = []
    for i in range(n):
        g = {"w": rs.randn(4, 8).astype(np.float32), "b": rs.randn(8).astype(np.float32)}
        norm = np.sqrt(sum(float((v ** 2).sum()) for v in g.values()))
        scale = (3.0 if i % 2 else 0.4) / norm  # clipped on odd updates only
        grads.append({k: v * np.float32(scale) for k, v in g.items()})

    tx, _ = make_optimizer(jcfg.optimizer_cfg)
    params = {"w": jnp.asarray(w0), "b": jnp.asarray(b0)}
    ema = dict(params)
    state = tx.init(params)
    d = jnp.float32(jcfg.ema_decay)

    @jax.jit
    def update(g, state, params, ema):
        upd, state = tx.update(g, state, params)
        params = optax.apply_updates(params, upd)
        return state, params, jax.tree.map(lambda e, p: d * e + (1.0 - d) * p, ema, params)

    module = _Two(w0.copy(), b0.copy())
    calls = iter(range(n))

    def loss_fn(m, batch, generator):
        i = next(calls)
        return (m.w * t(grads[i]["w"])).sum() + (m.b * t(grads[i]["b"])).sum(), {}

    engine = Engine("model", module, loss_fn, pcfg.optimizer_cfg, REPO, ema_decay=pcfg.ema_decay)
    assert all(g["weight_decay"] == 0 for g in engine.optimizer.param_groups)
    # the EMA sums in another order (d·e + (1 − d)·p fused or not): at most
    # one float32 rounding step of the weights' magnitude per update
    ema_tol = n * float(np.spacing(np.float32(np.abs(w0).max() + 0.5)))
    checked = 0
    for i in range(n):
        state, params, ema = update({k: jnp.asarray(v) for k, v in grads[i].items()}, state,
                                    params, ema)
        stats = engine.train_batch({}, None)
        np.testing.assert_allclose(stats["grad_norm"], 3.0 if i % 2 else 0.4, rtol=1e-5)
        if i in (0, 1, 198, 199, 200, 201, n - 1):
            port_ema = engine.ema_state_dict()
            for k in ("w", "b"):
                np.testing.assert_allclose(getattr(module, k).detach().numpy(),
                                           np.asarray(params[k]), atol=2e-6, err_msg=f"{k} @ {i}")
                np.testing.assert_allclose(port_ema[k].numpy(), np.asarray(ema[k]), atol=ema_tol,
                                           err_msg=f"ema {k} @ {i}")
            checked += 1
    assert checked == 7
    assert float(np.abs(np.asarray(params["w"]) - w0).max()) > 1e-3  # the updates moved it


def test_recipe_model_timestep_draw_and_loss_weighting_match():
    """The train CLI's model from the recipe (cut width, fp32): the same
    ``DiffusionConfig`` (T = 100, cosine absorbing, sampled, remat); the
    feeders draw t uniform in [1, 100) per row, one draw of shape (B,); and
    at the same t and corruption noise the loss (an unweighted mean over
    valid response tokens of the x0 cross-entropy) is JAX's within 1e-5."""
    jcfg, pcfg = _configs(*CUT, "device=cpu")
    jm, pm = jax_train.build_model(jcfg), port_train.build_model(pcfg, "cpu")
    jc, pc = dataclasses.asdict(jm.config), dataclasses.asdict(pm.config)
    assert jc == pc and (pc["timesteps"], pc["train_mode"], pc["remat"]) == (100, "sampled", True)

    B, T, Tr, V = 2, pc["timesteps"], 192, pc["n_classes"]
    rs = np.random.RandomState(3)
    batch = dict(text=rs.randint(1, 60, (B, 50)).astype(np.int32),
                 text_mask=np.ones((B, 50), np.float32),
                 proms=rs.randint(0, 1024, (B, 398, 8)).astype(np.int32),
                 prom_mask=np.ones((B, 398), np.float32),
                 resp=rs.randint(0, 1024, (B, Tr)).astype(np.int32),
                 resp_mask=np.ones((B, Tr), np.float32))
    batch["text_mask"][1, 20:] = 0
    batch["prom_mask"][0, 300:] = 0
    batch["resp_mask"][1, 150:] = 0
    batch["resp"] *= batch["resp_mask"].astype(np.int32)

    draws = {}
    real_j, real_p = jax.random.randint, torch.randint

    def spy_j(key, shape, minval, maxval, *a, **kw):
        draws["jax"] = (tuple(shape), int(minval), int(maxval))
        return real_j(key, shape, minval, maxval, *a, **kw)

    def spy_p(low, high, size, *a, **kw):
        draws["port"] = (tuple(size), int(low), int(high))
        return real_p(low, high, size, *a, **kw)

    flat = seeded_flax_params(pm.denoiser, seed=4)
    params = unflatten(flat)
    jax_params_to_torch(flat, pm.denoiser)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    pbatch = {k: t(v).long() if v.dtype.kind == "i" else t(v) for k, v in batch.items()}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "randint", spy_j)
        mp.setattr(torch, "randint", spy_p)
        jax_train.make_loss_fn(jcfg, jm)(params, jbatch, jax.random.PRNGKey(0))
        with torch.no_grad():
            port_train.make_loss_fn(pcfg, pm)(pm, pbatch, torch.Generator().manual_seed(0))
    assert draws == {"jax": ((B,), 1, T), "port": ((B,), 1, T)}
    g = torch.Generator().manual_seed(0)
    seen = torch.randint(1, T, (20000,), generator=g)
    assert int(seen.min()) == 1 and int(seen.max()) == T - 1 and len(seen.unique()) == T - 1

    tt = np.array([1, T - 1], np.int32)
    noise = rs.rand(B, Tr, V).astype(np.float32)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "randint", lambda *a, **kw: jnp.asarray(tt))
        ref, _ = jm.loss(params, jbatch, jax.random.PRNGKey(0), q_noise=jnp.asarray(noise))
    with torch.no_grad():
        got, _ = pm.loss(pbatch, None, q_noise=t(noise), t=t(tt))
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-5)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("recipe_corpus")
    smoke_train.write_train_corpus(root, n_speakers=8, n_utts=12, seed=0, frames=(60, 168),
                                   phones=(2, 40))
    return root


def test_recipe_split_prompts_and_bucketed_batches_match_the_jax_loader(corpus):
    """The recipe's loaders over a seeded corpus of 96 utterances (8
    speakers): the 95/5 seed-0 split capped at ``max_num_val`` 32 after the
    ``min_phones`` 3 filter, and every batch (texts, prompts drawn with
    ``p_additional_prompt`` 0.8 from up to 6 same-speaker utterances,
    responses, masks, paths) of the ``resp_len_buckets: [192]`` sampler,
    identical to the JAX package's Python loader.  ``nj`` 1 and the Python
    loader on both sides (thread order is not reproducible; the port has
    no native loader)."""
    extra = [f"data_dirs=[{corpus}]", "nj=1", "use_native_loader=false"]
    jcfg, pcfg = _configs(*extra, *CUT)
    jm, pm = jax_train.build_model(jcfg), port_train.build_model(pcfg, "cpu")
    jb, pb = jax_train.make_bucket(jcfg, jm), port_train.make_bucket(pcfg, pm)
    assert (jb.text_len, jb.prom_len, jb.resp_len) == (pb.text_len, pb.prom_len, pb.resp_len) == (
        50, 398, 448)
    port, ref = create_train_val_dataloader(pcfg, pb), jax_loaders(jcfg, jb)
    n_batches = []
    for p_dl, r_dl, n in zip(port, ref, (6, None, None)):
        p_it, r_it = iter(p_dl), iter(r_dl)
        p_batches = [next(p_it) for _ in range(n)] if n else list(p_it)
        r_batches = [next(r_it) for _ in range(n)] if n else list(r_it)
        assert len(p_batches) == len(r_batches) > 0
        for pbatch, rbatch in zip(p_batches, r_batches):
            assert pbatch.keys() == rbatch.keys()
            for k in rbatch:
                if isinstance(rbatch[k], np.ndarray):
                    np.testing.assert_array_equal(pbatch[k], rbatch[k], err_msg=k)
                else:
                    assert [str(x) for x in pbatch[k]] == [str(x) for x in rbatch[k]], k
        n_batches.append(sum(len(b["path"]) for b in p_batches))
        p_it.close()
        r_it.close()
    train_rows, sub_rows, val_rows = n_batches
    assert train_rows == 6 * 32 and 1 <= val_rows <= 32
    assert p_batches[0]["resp"].shape[1] in (192, 448)
