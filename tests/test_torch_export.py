"""The port's export CLI against the JAX package's bundle format, in fp32 on
the CPU: tiny D3PM, NAR and AR models trained two steps by the port's train
CLI (``model_overrides`` d32 / 2 heads / 2 layers) and exported raw, with
``--ema`` and with ``--dtype f16``; the JAX package's ``export.load_bundle``
and ``__main__.build_model`` accept each bundle and give the port's logits
(1e-4·max(1, |ref|)); the npz keys, ``model.json`` and the symmaps are what
the JAX exporter writes for the same run; the zoo bundles come back bit for
bit through a port module and the port's ``save_bundle --dtype f16``; and
``--ema`` on a run without EMA exits."""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from tts_with_diffusion_model_tpu import export as jax_export
from tts_with_diffusion_model_tpu.__main__ import build_model as jax_build_model
from tts_with_diffusion_model_tpu.config import Config as JaxConfig
from tts_with_diffusion_model_tpu.data.dataset import create_datasets as jax_create_datasets
from tts_with_diffusion_model_tpu.models.nar import NAR as JaxNAR
from tts_with_diffusion_model_tpu_torch import export, smoke_train
from tts_with_diffusion_model_tpu_torch.bundle import load_bundle
from tts_with_diffusion_model_tpu_torch.config import Config
from tts_with_diffusion_model_tpu_torch.convert import jax_params_to_torch
from tts_with_diffusion_model_tpu_torch.serve import build_model
from tts_with_diffusion_model_tpu_torch.train import train as port_train

from torch_port_helpers import (  # noqa: F401 (one_thread: fixture)
    one_thread,
    t,
)

#: tiny models only: one intra-op thread each
pytestmark = pytest.mark.usefixtures("one_thread")

REPO = Path(__file__).resolve().parents[1]
TOL = 1e-4  # × max(1, max |ref|)
DIMS = dict(d_model=32, n_heads=2, n_layers=2)
FAMILIES = {
    "diffusion": dict(model="diffusion",
                      model_overrides=dict(DIMS, timesteps=8, resp_len=48, text_len=16,
                                           prom_len=64)),
    "nar": dict(model="nar", model_overrides=dict(DIMS)),
    "ar": dict(model="ar", model_overrides=dict(DIMS)),
}
MODES = {"raw": [], "ema": ["--ema"], "f16": ["--ema", "--dtype", "f16"]}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    smoke_train.write_train_corpus(root, n_speakers=3, n_utts=12, seed=0, frames=(10, 40),
                                   phones=(3, 12))
    return root


def _write_yaml(root: Path, corpus, family, **extra):
    cfg = dict(cfg_name=f"tiny_{family}", data_dirs=[str(corpus)], spkr_name_getter="parts:-2",
               batch_size=2, eval_batch_size=4, max_iter=2, eval_every=0, save_ckpt_every=2,
               min_phones=3, max_num_val=4, nj=1, ema_decay=0.9, warmup_max_lr=1e-3,
               warmup_num_steps=2, max_text_len=16, max_prom_len=64, max_resp_len=48,
               resp_len_buckets=[48], prom_len_buckets=[64], max_prompts=2,
               log_root=str(root / "logs"), ckpt_root=str(root / "ckpts"),
               **FAMILIES[family])
    cfg.update(extra)
    path = root / f"{family}.yml"
    path.write_text(yaml.safe_dump(cfg))
    return path


@pytest.fixture(scope="module")
def runs(tmp_path_factory, corpus):
    """family → (yaml, trained engine): two steps of the port's train CLI."""
    out = {}
    for family in FAMILIES:
        root = tmp_path_factory.mktemp(family)
        yml = _write_yaml(root, corpus, family)
        engines = port_train.main(Config.from_cli([f"yaml={yml}", "device=cpu"]))
        assert engines.global_step == 2
        out[family] = (yml, engines["model"])
    return out


def _inputs(family, meta, seed=0):
    """Seeded inputs at the tiny shapes, as numpy (int32 ids)."""
    rs = np.random.RandomState(seed)
    B, Tt, Tp, Tr = 2, 16, 24, 20
    text = rs.randint(1, 30, (B, Tt)).astype(np.int32)
    tm = np.ones((B, Tt), np.float32)
    tm[1, 11:] = 0
    proms = rs.randint(0, 1024, (B, Tp, 8)).astype(np.int32)
    pm = np.ones((B, Tp), np.float32)
    pm[0, 17:] = 0
    rm = np.ones((B, Tr), np.float32)
    rm[1, 15:] = 0
    if family == "diffusion":
        x = rs.randint(0, 1025, (B, Tr)).astype(np.int32)
        return text, tm, proms, pm, x, rm, np.array([1, 6], np.int32)
    if family == "nar":
        return text, tm, proms, pm, rs.randint(0, 1024, (B, Tr, 7)).astype(np.int32), rm
    return text, tm, proms, pm, rs.randint(0, 1024, (B, Tr)).astype(np.int32), rm


def _jax_logits(family, meta, params, inputs):
    """The JAX package's logits for a bundle, in fp32: the architecture from
    its ``__main__.build_model``, applied with its ``export.load_bundle``'s
    parameters."""
    model = jax_build_model(meta)
    if family == "diffusion":
        den = model.denoiser.clone(dtype=jnp.float32)
        return np.asarray(den.apply(params, *inputs))
    model = model.clone(dtype=jnp.float32, remat=False)
    if family == "nar":
        return np.asarray(model.apply(params, *inputs, 3, method=JaxNAR.forward_level))
    return np.asarray(model.apply(params, *inputs, deterministic=True)[0])


def _port_logits(family, meta, flat, inputs):
    model = build_model(meta, torch.float32).eval()
    jax_params_to_torch(flat, getattr(model, "denoiser", model))
    args = [t(a).long() if a.dtype.kind == "i" else t(a) for a in inputs]
    with torch.no_grad():
        if family == "diffusion":
            return model.denoiser(*args).numpy()
        if family == "nar":
            return model.forward_level(*args, 3).numpy()
        return model(*args)[0].numpy()


def _export(yml, dest, flags):
    export.main([f"yaml={yml}", "device=cpu", *flags, str(dest)])
    return dest


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("family", FAMILIES)
def test_port_bundle_loads_in_jax_with_the_same_logits(tmp_path, runs, family, mode):
    yml, engine = runs[family]
    dest = _export(yml, tmp_path / "bundle", MODES[mode])
    flat, meta, _, _ = load_bundle(dest)
    assert meta["weights"] == ("raw" if mode == "raw" else "ema") and meta["step"] == 2
    # the arrays are the engine's weights (f16: rounded once)
    want = export.bundle_params(engine.module,
                                None if mode == "raw" else engine.ema_state_dict())
    with np.load(dest / "params.npz") as z:
        assert set(z.files) == set(want)
        for k, v in want.items():
            stored = z[k]
            assert stored.dtype == (np.float16 if mode == "f16" else np.float32), k
            np.testing.assert_array_equal(stored, v.astype(stored.dtype), err_msg=k)
    if mode != "raw":  # EMA after two steps at decay 0.9 is not the raw weights
        raw = export.bundle_params(engine.module)
        assert any(not np.array_equal(raw[k], want[k]) for k in want)

    params, jmeta, phones, spkrs = jax_export.load_bundle(dest)
    assert jmeta == meta and phones and spkrs
    inputs = _inputs(family, meta)
    ref = _jax_logits(family, meta, params, inputs)
    got = _port_logits(family, meta, flat, inputs)
    assert got.shape == ref.shape
    err, bound = float(np.abs(got - ref).max()), TOL * max(1.0, float(np.abs(ref).max()))
    assert err <= bound, (family, mode, err, bound)


@pytest.mark.parametrize("family", FAMILIES)
def test_npz_keys_model_json_and_symmaps_match_the_jax_exporter(tmp_path, runs, family):
    """The JAX exporter's bundle for the same run: its ``save_bundle`` on a
    JAX init of the architecture that ``build_model`` makes from the port's
    ``model.json``, with the meta and symmaps its ``main`` derives from the
    same config."""
    yml, _ = runs[family]
    dest = _export(yml, tmp_path / "port", ["--ema"])
    _, meta, phones, spkrs = load_bundle(dest)

    jcfg = JaxConfig.from_cli([f"yaml={yml}"])
    jax_meta = {"model": jcfg.model, "num_tokens": jcfg.num_tokens, "step": 2,
                "cfg_name": jcfg.cfg_name, "weights": "ema", **(jcfg.model_overrides or {})}
    assert meta == jax_meta
    assert list(meta) == list(jax_meta)
    jtrain, _ = jax_create_datasets(jcfg)
    assert phones == jtrain.phone_symmap and spkrs == jtrain.spkr_symmap

    model = jax_build_model(meta)
    if family == "diffusion":
        init = model.init(jax.random.PRNGKey(0))
    else:
        text, tm, proms, pm, resp, rm = _inputs(family, meta)
        init = model.clone(remat=False).init(
            jax.random.PRNGKey(0), text, tm, proms, pm,
            np.concatenate([resp, resp[..., :1]], -1) if family == "nar" else resp, rm,
            *([np.zeros(2, np.int32)] if family == "nar" else []))
    jax_export.save_bundle(tmp_path / "jax", init, meta, phones, spkrs)
    with np.load(dest / "params.npz") as a, np.load(tmp_path / "jax" / "params.npz") as b:
        assert set(a.files) == set(b.files)
        assert all(a[k].shape == b[k].shape for k in b.files)
    for name in ("model.json", "phone_symmap.json", "spkr_symmap.json"):
        assert (dest / name).read_text() == (tmp_path / "jax" / name).read_text(), name


@pytest.mark.parametrize("bundle", ["diffusion", "nar"])
def test_zoo_bundle_round_trips_bit_for_bit_through_the_port(tmp_path, bundle):
    src = REPO / "zoo" / bundle
    if not (src / "params.npz").exists():
        pytest.skip(f"zoo/{bundle} is not in this checkout")
    flat, meta, phones, spkrs = load_bundle(src)
    model = build_model(meta, torch.float32)
    jax_params_to_torch(flat, getattr(model, "denoiser", model))
    del flat
    out = {k: v.astype(np.float16) for k, v in export.bundle_params(model).items()}
    export.save_bundle(tmp_path, out, meta, phones, spkrs)
    with np.load(src / "params.npz") as a, np.load(tmp_path / "params.npz") as b:
        assert set(a.files) == set(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype == np.float16, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert json.loads((tmp_path / "model.json").read_text()) == meta
    for name in ("model.json", "phone_symmap.json", "spkr_symmap.json"):
        assert (tmp_path / name).read_bytes() == (src / name).read_bytes(), name


def test_ema_without_an_ema_run_exits(tmp_path, corpus):
    yml = _write_yaml(tmp_path, corpus, "nar", ema_decay=None, max_iter=1, save_ckpt_every=1)
    port_train.main(Config.from_cli([f"yaml={yml}", "device=cpu"]))
    with pytest.raises(SystemExit, match="ema_decay"):
        _export(yml, tmp_path / "bundle", ["--ema"])
    assert not (tmp_path / "bundle").exists()
    _export(yml, tmp_path / "bundle", [])  # the raw weights export
    assert load_bundle(tmp_path / "bundle")[1]["weights"] == "raw"
