"""The Gaussian family through the port's entry points on the CPU, at tiny
sizes: bundles both ways (a JAX-saved bundle loads in the port with equal
ε̂; the train CLI's run, exported by the export CLI, loads in the JAX
package with ε̂ within 1e-4·max(1, |ref|)), the train CLI with an eval tick
that decodes audio, ``Synthesizer``, the inference CLI (long-form past the
bundle's own text bucket), the serve CLI, and the rehearsal of the chip
phase "train -> export -> serve gaussian" with the plain attention calls
counted against the sites.  The train runs and bundles are the rehearsal's
own, made once for the module.
"""

from __future__ import annotations

import io
import json
import os
import signal
import subprocess
import sys
import urllib.request
import wave
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import (  # noqa: F401 (fixtures)
    one_thread,
    perturbed,
    small_codec,
    t,
    unflatten,
)
from tts_with_diffusion_model_tpu.__main__ import build_model as jax_build_model
from tts_with_diffusion_model_tpu.export import load_bundle as jax_load_bundle
from tts_with_diffusion_model_tpu.export import save_bundle as jax_save_bundle
from tts_with_diffusion_model_tpu.models.gaussian_tts import GaussianDiffusionModel as JModel
from tts_with_diffusion_model_tpu_torch import smoke, smoke_gaussian, smoke_serve
from tts_with_diffusion_model_tpu_torch.codec import encodec
from tts_with_diffusion_model_tpu_torch.serve import Synthesizer, load_model

REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
CORPUS = (3, 12, (8, 30), (3, 12))
COMMON = ["device=cpu", "batch_size=4", "eval_batch_size=8", "max_num_val=8", "nj=1",
          "resp_len_buckets=[32]"]
BASE = dict(d_model=32, n_layers=2, timesteps=3, text_len=24, prom_len=64, resp_len=48,
            gen_len=40)
#: the registry name's tiny overrides
TINY = {"diffusion-gaussian": dict(BASE, n_heads=2),
        "diffusion-gaussian-unet2d": dict(BASE, n_heads=1, unet_channels=[8, 16]),
        "diffusion-gaussian-unet2d-ref": dict(BASE, n_heads=2, unet_channels=[8, 16, 32, 32])}

pytestmark = pytest.mark.usefixtures("one_thread")


def _inputs(c, B=2, seed=0):
    rs = np.random.RandomState(seed)
    tm = np.ones((B, c["text_len"]), np.float32)
    tm[1, 7:] = 0
    pm = np.ones((B, c["prom_len"]), np.float32)
    pm[0, 40:] = 0
    rm = np.ones((B, c["resp_len"]), np.float32)
    rm[1, 30:] = 0
    return [rs.randint(1, 60, (B, c["text_len"])), tm, rs.randint(0, 1024, (B, c["prom_len"], 8)),
            pm, rs.randn(B, c["resp_len"], 1).astype(np.float32), rm, np.array([0, 2])]


def _fp32(jm):
    """The JAX package's model rebuilt in fp32 compute (its ``build_model``
    keeps the flax default bf16; the port's comparisons run in fp32)."""
    return JModel(jm.config, dtype=jnp.float32)


def _eps_close(got, ref):
    ref = np.asarray(ref)
    err = float(np.abs(np.asarray(got) - ref).max())
    assert err <= 1e-4 * max(1.0, float(np.abs(ref).max())), err


@pytest.mark.parametrize("name", ["diffusion-gaussian-value", "diffusion-gaussian-unet2d"])
def test_jax_saved_bundle_loads_in_the_port_with_equal_eps(tmp_path, name):
    c = TINY["diffusion-gaussian-unet2d" if "unet2d" in name else "diffusion-gaussian"]
    meta = {"model": name, "num_tokens": 1024,
            **{k: v for k, v in c.items() if k != "unet_channels"}}
    if "unet_channels" in c:
        meta["unet_channels"] = list(c["unet_channels"])
    jm = jax_build_model(meta)
    flat = perturbed(jax.jit(jm.init)(jax.random.PRNGKey(0)), 1)
    jax_save_bundle(tmp_path / "b", unflatten(flat), meta, {"_": 1}, {"spk": 0})
    flat_j, meta_j, _, _ = jax_load_bundle(tmp_path / "b")
    jm = _fp32(jax_build_model(meta_j))
    pm, _ = load_model(tmp_path / "b", torch.float32)
    assert pm.config.denoiser == jm.config.denoiser and pm.in_dim == 1
    args = _inputs(c)
    ref = jm.denoiser.apply(flat_j, *map(jnp.asarray, args))
    with torch.no_grad():
        got = pm.denoiser(*map(t, args))
    _eps_close(got, ref)


@pytest.fixture(scope="module")
def nar_bundle(tmp_path_factory):
    return smoke_serve.write_seeded_bundles(tmp_path_factory.mktemp("nar"), "tiny")[1]


@pytest.fixture(scope="module")
def rehearsal(tmp_path_factory, nar_bundle, small_codec):
    """The chip phase at tiny sizes through the plain versions, in a working
    directory of its own: the train CLI on ``diffusion.yml`` with ``model=``
    each variant, 2 steps with an eval tick that decodes audio; the DiT and
    the conv-UNet exported with ``--ema`` and served, the unet2d-ref served
    from seeded weights → ``phase_gaussian``'s result."""
    from tts_with_diffusion_model_tpu_torch import smoke_train

    mp = pytest.MonkeyPatch()
    mp.setattr(encodec, "load_codec", lambda *a, **kw: small_codec)
    work = tmp_path_factory.mktemp("smoke")
    for mod in (smoke, smoke_train, smoke_gaussian):
        mp.setattr(mod, "SMOKE_DIR", work)
    variants = (("diffusion-gaussian", 2, True), ("diffusion-gaussian-unet2d", 2, True),
                ("diffusion-gaussian-unet2d-ref", 2, False))
    try:
        return smoke_gaussian.phase_gaussian(
            CPU, nar_bundle, variants=variants, repeats=1,
            overrides=[*COMMON, "eval_decode_audio=true"], model_overrides=TINY,
            corpus=CORPUS, codec=small_codec, ref_seconds=0.5)
    finally:
        mp.undo()


@pytest.mark.parametrize("name", ["diffusion-gaussian", "diffusion-gaussian-unet2d"])
def test_train_cli_eval_decode_and_export_load_in_jax(rehearsal, name):
    tr = rehearsal[name]
    bundle = Path(tr["export"]["path"])
    assert len(tr["decodes"]) == 2 and all(d["metrics"]["n_utts"] >= 1 for d in tr["decodes"])
    assert all(np.isfinite(x) for x in tr["losses"]) and tr["moved"] > 0
    meta = json.loads((bundle / "model.json").read_text())
    assert meta["model"] == name and meta["weights"] == "ema"
    assert meta["timesteps"] == 3 and meta["d_model"] == 32  # model_overrides carried
    flat, meta_j, _, _ = jax_load_bundle(bundle)
    jm = _fp32(jax_build_model(meta_j))
    pm, _ = load_model(bundle, torch.float32)
    args = _inputs(BASE)
    if jm.config.domain == "embedding":
        args[4] = np.random.RandomState(3).randn(2, BASE["resp_len"], 32).astype(np.float32)
    ref = jm.denoiser.apply(flat, *map(jnp.asarray, args))
    with torch.no_grad():
        got = pm.denoiser(*map(t, args))
    _eps_close(got, ref)


def test_synthesizer_and_cli_answer_with_a_gaussian_bundle(rehearsal, nar_bundle, small_codec,
                                                            monkeypatch, tmp_path):
    """``Synthesizer.from_bundles`` over the exported DiT: the reverse chain
    at the model's bucket, codes and wavs of gen_len frames, the same seeds
    again; the CLI on a short text and on one over the bundle's 24-phone
    text bucket (long-form)."""
    from tts_with_diffusion_model_tpu_torch.__main__ import main

    monkeypatch.setattr(encodec, "load_codec", lambda *a, **kw: small_codec)
    bundle = Path(rehearsal["diffusion-gaussian"]["export"]["path"])
    synth = Synthesizer.from_bundles(bundle, nar_bundle, None, device="cpu", max_batch=2)
    assert synth.is_gaussian and synth.denoiser_calls == 3 and synth.text_len == 24
    ref = smoke.reference_wavs(1, 0.5, seed=61)[0]
    outs = synth.synthesize_batch([("she said hello", ref, 1), ("how are you", ref, 2)])
    assert [w.shape for w, _ in outs] == [(40 * 320,)] * 2
    again = synth.synthesize_batch([("she said hello", ref, 1), ("how are you", ref, 2)])
    assert all(np.array_equal(a[0], b[0]) for a, b in zip(outs, again))
    for text, n_seg in (("hello there", 1), (" ".join(["the quick brown fox"] * 4), 2)):
        out = tmp_path / f"{n_seg}.wav"
        main([text, str(ref), str(out), "--device", "cpu", "--ar-ckpt", str(bundle),
              "--nar-ckpt", str(nar_bundle)])
        with wave.open(str(out)) as f:
            frames = f.getnframes()
        # every segment is a gen_len window of the fixed-length first stage
        assert frames % (40 * 320) == 0 and frames >= n_seg * 40 * 320


def test_serve_cli_answers_with_a_gaussian_bundle(rehearsal, nar_bundle):
    """``python -m tts_with_diffusion_model_tpu_torch.serve --device cpu``
    over the exported conv-UNet bundle: one /tts through its Batcher, then
    SIGTERM drains and the process exits 0."""
    bundle = Path(rehearsal["diffusion-gaussian-unet2d"]["export"]["path"])
    ref = smoke.reference_wavs(1, 0.3, seed=53)[0]
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(REPO))
    proc = subprocess.Popen(
        [sys.executable, "-m", "tts_with_diffusion_model_tpu_torch.serve", "--device", "cpu",
         "--ar-ckpt", str(bundle), "--nar-ckpt", str(nar_bundle), "--port", "0",
         "--max-batch", "2"], cwd=bundle.parent, env=env, stderr=subprocess.PIPE, text=True)
    try:
        port, log = None, []
        for line in proc.stderr:
            log.append(line)
            if "Serving on http://" in line:
                port = int(line.split("http://", 1)[1].split(" ")[0].rsplit(":", 1)[1])
                break
        assert port, "".join(log)
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/tts", method="POST",
            data=json.dumps({"text": "she said hello", "reference": str(ref),
                             "seed": 1}).encode())
        with urllib.request.urlopen(req, timeout=120) as resp:
            assert resp.status == 200
            with wave.open(io.BytesIO(resp.read())) as f:
                assert f.getnframes() == 40 * 320
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
        proc.stderr.close()


def test_gaussian_phase_rehearsal(rehearsal):
    """The chip phase at tiny sizes through the plain versions: the plain
    attention calls per train step, per eval batch and per served batch
    equal the sites (at full width: 52 + 28 and 11 + 11 per step, 2488,
    788 and 84 per batch), fp32 codes alone equal those in a cohort of 4."""
    out = rehearsal
    nar = 7 * 2
    # towers 2 + 2, blocks 3 per layer (twice under remat); 2 levels: 5 crosses
    assert [(r["fwd_per_step"], r["bwd_per_step"]) for r in out.values()] == [
        (4 + 2 * 2 * 3, 4 + 2 * 3), (4 + 5, 4 + 5), (0, 0)]
    assert [r["served"]["expected"] for r in out.values()] == [4 + 3 * 6 + nar, 4 + 3 * 5 + nar,
                                                                nar]
    assert [r["served"]["plain"] for r in out.values()] == [36, 33, 14]
    assert out["diffusion-gaussian-unet2d-ref"]["served"]["prompt_bucket"] == 64
    assert all(out[n]["cohort fp32"]["identical"] for n in ("diffusion-gaussian",
                                                            "diffusion-gaussian-unet2d"))


def test_full_width_sites_give_the_launch_counts():
    """The sites at the registry defaults and the gen4c recipe: kernel 1 per
    served batch 4 + 100 × 24 + 84 (DiT) and 4 + 100 × 7 + 84 (conv-UNet),
    kernel 2 per step 52 + 28 and 11 + 11; the new sites' head widths."""
    from tts_with_diffusion_model_tpu_torch import smoke_train
    from tts_with_diffusion_model_tpu_torch.config import Config
    from tts_with_diffusion_model_tpu_torch.train.train import build_model

    nar = {"d_model": 1024, "n_heads": 16, "n_layers": 12}
    want = {"diffusion-gaussian": (2488, (52, 28), {32}),
            "diffusion-gaussian-unet2d": (788, (11, 11), {8, 16, 32}),
            "diffusion-gaussian-unet": (2488, (52, 28), {8, 32}),
            "diffusion-gaussian-unet2d-ref": (84, (0, 0), set())}
    for name, (served, step, dhs) in want.items():
        cfg = Config.from_cli([f"yaml={smoke_train.TRAIN_YAML}", f"model={name}"])
        with torch.device("meta"):
            model = build_model(cfg)
        sites = smoke_gaussian.serve_sites(model, nar, 256)
        assert sum(s.count for s in sites) == served, name
        ts = smoke_train.step_sites(model, cfg)
        assert (sum(s.fwd for s in ts), sum(s.bwd for s in ts)) == step, name
        assert {s.Dh for s in sites[:-1]} == dhs, name
    serve_sites, train_sites = smoke_gaussian.kernel_sites(256, 4, 32, 192)
    assert {s.Dh for s in serve_sites} == {8, 16, 32}
    assert {s.Dh for s in train_sites} == {8, 16, 32}
