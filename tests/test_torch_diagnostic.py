"""The port's diagnostics (``utils/diagnostic.py``, ``Engine.diagnose``)
against the JAX package's, on the CPU: ``tensor_stats`` and
``singular_values`` equal; one batch's gradient and parameter statistics
per JAX parameter path within 1e-5 relative (to the tensor's largest
magnitude) of JAX's ``Engine.diagnose``
on the same weights, batch and injected noise; activations through forward
hooks; the CSV written with pandas blocked from import, with JAX's columns
and file name."""

import csv
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tts_with_diffusion_model_tpu.models.diffusion import DiffusionConfig as JaxCfg
from tts_with_diffusion_model_tpu.models.diffusion import DiffusionModel as JaxModel
from tts_with_diffusion_model_tpu.parallel.mesh import build_mesh
from tts_with_diffusion_model_tpu.train.engine import Engine as JaxEngine
from tts_with_diffusion_model_tpu.utils import diagnostic as jax_diagnostic
from tts_with_diffusion_model_tpu_torch.convert import jax_params_to_torch
from tts_with_diffusion_model_tpu_torch.models.diffusion import DiffusionConfig, DiffusionModel
from tts_with_diffusion_model_tpu_torch.train.engine import Engine
from tts_with_diffusion_model_tpu_torch.utils import diagnostic
from tts_with_diffusion_model_tpu_torch.utils.diagnostic import Diagnostic

from torch_port_helpers import seeded_flax_params, t, unflatten

KW = dict(n_classes=33, d_model=32, n_heads=2, n_layers=2, timesteps=6, resp_len=12,
          text_len=7, prom_len=9)
OPT = {"scheduler": {"warmup_min_lr": 1e-4, "warmup_max_lr": 1e-3, "warmup_num_steps": 2,
                     "total_num_steps": 10}, "gradient_clipping": 1.0}
RTOL = 1e-5
#: the attention key biases' gradient is zero in exact arithmetic (softmax
#: ignores a per-query constant): both sides read fp32 rounding (~1e-8), so
#: those rows are held to that, not compared stat by stat
ROUNDING = 1e-6


def test_tensor_stats_and_singular_values_equal_jax():
    rs = np.random.RandomState(0)
    for x in (rs.randn(4, 7), rs.randn(3, 5, 6).astype(np.float32), np.zeros(0), rs.randn(9)):
        assert diagnostic.tensor_stats(x) == jax_diagnostic.tensor_stats(x)
    for x in (rs.randn(50, 2) @ rs.randn(2, 8), rs.randn(10, 600), rs.randn(1, 4), rs.randn(7)):
        np.testing.assert_array_equal(diagnostic.singular_values(x),
                                      jax_diagnostic.singular_values(x))


def _batch():
    rs = np.random.RandomState(0)
    b = dict(text=rs.randint(1, 33, (2, 7)), text_mask=np.ones((2, 7), np.float32),
             proms=rs.randint(0, 33, (2, 9, 8)), prom_mask=np.ones((2, 9), np.float32),
             resp=rs.randint(0, 32, (2, 12)), resp_mask=np.ones((2, 12), np.float32))
    b["text_mask"][1, 5:] = 0
    b["resp_mask"][0, 10:] = 0
    return {k: v.astype(np.int32) if v.dtype.kind == "i" else v for k, v in b.items()}


def test_engine_diagnose_equals_jax(tmp_path):
    flat = seeded_flax_params(DiffusionModel(DiffusionConfig(**KW)).denoiser, seed=1)
    tt = np.array([2, 5])
    noise = np.random.RandomState(5).rand(2, 12, 33).astype(np.float32)
    jm = JaxModel(JaxCfg(**KW), dtype=jnp.float32)

    def jloss(p, b, rng):
        tc, sc = jm.denoiser.apply(p, b["text"], b["text_mask"], b["proms"], b["prom_mask"],
                                   method=jm.denoiser.conds)
        x_t = (jm.d3pm.q_sample(b["resp"], jnp.asarray(tt), uniform_noise=jnp.asarray(noise))
               * b["resp_mask"]).astype(jnp.int32)
        logits = jm.denoiser.apply(p, x_t, b["resp_mask"], jnp.asarray(tt), tc, b["text_mask"],
                                   sc, b["prom_mask"], method=jm.denoiser.denoise)
        logp = jax.nn.log_softmax(logits, axis=-1)
        nll = -jnp.take_along_axis(logp, b["resp"][..., None], axis=-1)[..., 0]
        return (nll * b["resp_mask"]).sum() / jnp.maximum(b["resp_mask"].sum(), 1.0), {}

    ref_engine = JaxEngine("model", unflatten(flat), jloss, OPT, tmp_path / "jax",
                           mesh=build_mesh(1, 1, jax.devices()[:1]))
    ref = jax_diagnostic.Diagnostic(log_dir=tmp_path / "jax")
    ref_engine.diagnose(_batch(), jax.random.PRNGKey(0), ref)

    pm = DiffusionModel(DiffusionConfig(**KW), dtype=torch.float32)
    jax_params_to_torch(flat, pm.denoiser)
    engine = Engine("model", pm, lambda m, b, g: m.loss(b, g, q_noise=t(noise), t=t(tt)), OPT,
                    tmp_path / "port")
    got = Diagnostic(log_dir=tmp_path / "port")
    assert engine.diagnose(_batch(), None, got) is got
    assert all(p.grad is None for p in pm.parameters())  # nothing was updated

    ref_rows = {r["name"]: r for r in ref.table().to_dict("records")}
    rows = {r["name"]: r for r in got.table()}
    assert set(rows) == set(ref_rows)
    assert any(n.startswith("grad.params.dit_0.") for n in rows)
    assert any(n == "param.params.text_emb.embedding" for n in rows)
    for name, r in ref_rows.items():
        if name.startswith("grad.") and name.endswith(".k.bias"):
            assert max(abs(r["max_p100"]), abs(r["min_p0"]), abs(rows[name]["max_p100"]),
                       abs(rows[name]["min_p0"])) < ROUNDING, name
            continue
        # relative to the tensor's scale: a mean can cancel to far below it
        scale = max(abs(r["max_p100"]), abs(r["min_p0"]))
        for k, v in r.items():
            if k != "name":
                np.testing.assert_allclose(rows[name][k], v, rtol=RTOL, atol=RTOL * scale,
                                           err_msg=f"{name} {k}")


def test_forward_hooks_observe_every_submodule():
    pm = DiffusionModel(DiffusionConfig(**KW), dtype=torch.float32)
    jax_params_to_torch(seeded_flax_params(pm.denoiser, seed=1), pm.denoiser)
    b = {k: torch.from_numpy(v).long() if v.dtype.kind == "i" else torch.from_numpy(v)
         for k, v in _batch().items()}
    diag = Diagnostic()
    with diag.capture(pm.denoiser):
        x = pm.denoiser(b["text"], b["text_mask"], b["proms"], b["prom_mask"],
                        b["resp"], b["resp_mask"], torch.tensor([2, 5]))
    rows = {r["name"]: r for r in diag.table()}
    assert "fwd.__call__" in rows and "fwd.dit_1.attn.__call__" in rows
    assert any(n.startswith("fwd.text_tower.") for n in rows)
    assert rows["fwd.__call__"]["rms_p50"] == pytest.approx(
        float(np.sqrt((x.detach().double().numpy() ** 2).mean())), rel=1e-6)
    n_rows = len(rows)
    pm.denoiser(b["text"], b["text_mask"], b["proms"], b["prom_mask"], b["resp"],
                b["resp_mask"], torch.tensor([2, 5]))  # hooks removed: nothing observed
    assert len(diag.table()) == n_rows


def test_save_without_pandas_matches_jax_columns_and_name(tmp_path, monkeypatch):
    rs = np.random.RandomState(1)
    obs = [{"a": {"w": rs.randn(3, 4)}, "b": (rs.randn(5),)} for _ in range(3)]
    ref = jax_diagnostic.Diagnostic(log_dir=tmp_path / "jax")
    for o in obs:
        ref.observe_grads(o)
    ref_path = ref.save(iteration=7)

    monkeypatch.setitem(sys.modules, "pandas", None)  # `import pandas` raises
    got = Diagnostic(log_dir=tmp_path / "port")
    for o in obs:
        got.observe_grads(o)
    path = got.save(iteration=7)
    assert path.name == ref_path.name == "000007.csv"
    assert path.relative_to(tmp_path / "port") == ref_path.relative_to(tmp_path / "jax")
    with open(path) as f, open(ref_path) as g:
        rows, ref_rows = list(csv.DictReader(f)), list(csv.DictReader(g))
    assert [list(r) for r in rows] == [list(r) for r in ref_rows]
    for r, rr in zip(rows, ref_rows):
        assert r["name"] == rr["name"] and r["steps"] == rr["steps"] == "3"
        np.testing.assert_allclose([float(r[k]) for k in r if k != "name"],
                                   [float(rr[k]) for k in rr if k != "name"], rtol=1e-12)
    got.clear()
    assert got.table() == [] and Diagnostic().save() is None
