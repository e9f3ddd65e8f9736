"""The port's train CLI for the AR and NAR families on the CPU, through
``python -m tts_with_diffusion_model_tpu_torch.train`` with tiny
``model_overrides``: three steps, a checkpoint and the val-loss eval, then
a second run that resumes from it; the feeders' draws (the NAR's levels,
dropout in training and in eval) come from the step's and the eval's
generators; ``eval_decode_audio`` and ``gradient_checkpointing_policy``
run for both families."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from tts_with_diffusion_model_tpu_torch import smoke_train
from tts_with_diffusion_model_tpu_torch.config import Config
from tts_with_diffusion_model_tpu_torch.models import get_model
from tts_with_diffusion_model_tpu_torch.train import train as port_train

from torch_port_helpers import small_codec  # noqa: F401 (fixture)

REPO = Path(__file__).resolve().parents[1]
FAMILIES = ["ar", "nar"]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    smoke_train.write_train_corpus(root, n_speakers=3, n_utts=12, seed=0, frames=(10, 40),
                                   phones=(3, 12))
    return root


def _write_yaml(tmp_path, corpus, family, **extra):
    cfg = dict(cfg_name=f"tiny_{family}", data_dirs=[str(corpus)], spkr_name_getter="parts:-2",
               model=family, model_overrides=dict(d_model=32, n_heads=2, n_layers=2),
               batch_size=2, eval_batch_size=4, max_iter=3, eval_every=3, save_ckpt_every=3,
               min_phones=3, max_num_val=4, nj=1, ema_decay=0.9, warmup_max_lr=1e-3,
               warmup_num_steps=2, max_text_len=16, max_prom_len=64, max_resp_len=48,
               resp_len_buckets=[48], prom_len_buckets=[64], max_prompts=2,
               log_root=str(tmp_path / "logs"), ckpt_root=str(tmp_path / "ckpts"), **extra)
    path = tmp_path / f"{family}.yml"
    path.write_text(yaml.safe_dump(cfg))
    return path


def _run_cli(yml, *argv):
    return subprocess.run(
        [sys.executable, "-m", "tts_with_diffusion_model_tpu_torch.train", f"yaml={yml}",
         "device=cpu", *argv], cwd=REPO, input="", capture_output=True, text=True, timeout=300)


def _stats(out):
    return [json.loads(line[line.index("{"):]) for line in out.splitlines()
            if " - {" in line and '"global_step"' in line]


@pytest.mark.parametrize("family", FAMILIES)
def test_train_cli_three_steps_checkpoint_then_resume(tmp_path, corpus, family):
    yml = _write_yaml(tmp_path, corpus, family)
    out = _run_cli(yml)
    assert out.returncode == 0, out.stderr[-3000:]
    stats = _stats(out.stdout)
    assert [s["global_step"] for s in stats] == [1, 2, 3]
    assert all(np.isfinite(s["model.loss"]) and np.isfinite(s["grad_norm"]) for s in stats)
    assert all(np.isfinite(s["nll"]) for s in stats)
    assert out.stdout.count("Eval: {'loss'") == 2  # subtrain and val
    ckpts = tmp_path / "ckpts" / f"tiny_{family}" / "model"
    assert sorted(p.name for p in ckpts.iterdir()) == ["step_00000003.pt"]
    state = torch.load(ckpts / "step_00000003.pt", weights_only=True)
    head = state["params"]["base.classifier.weight"]
    assert head.shape == (1025 if family == "ar" else 1024, 32)  # the AR's stop token

    out = _run_cli(yml, "max_iter=5", "save_ckpt_every=5", "eval_every=0")
    assert out.returncode == 0, out.stderr[-3000:]
    assert "Restored checkpoint" in out.stdout and "(step 3)" in out.stdout
    assert [s["global_step"] for s in _stats(out.stdout)] == [4, 5]
    assert (ckpts / "step_00000005.pt").exists()


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("knob", ["eval_decode_audio=true", "gradient_checkpointing_policy=dots"])
def test_unported_knobs_are_refused_by_name(tmp_path, corpus, family, knob, small_codec,
                                            monkeypatch):
    """Both knobs are ported now: three steps with ``eval_decode_audio``
    write hyp / ref wavs and ``metrics.json`` for subtrain and val (the
    NAR's level 0 reported as teacher-provided), and ``dots`` trains under
    the selective-recompute policy."""
    from tts_with_diffusion_model_tpu_torch.codec import encodec

    monkeypatch.setattr(encodec, "load_codec", lambda *a, **kw: small_codec)
    cfg = Config.from_cli([f"yaml={_write_yaml(tmp_path, corpus, family)}", "device=cpu", knob,
                           "max_val_ar_steps=8"])
    engines = port_train.main(cfg)
    assert engines.global_step == 3
    if knob.startswith("gradient_checkpointing_policy"):
        assert engines["model"].module.base.remat_context is not \
            torch.utils.checkpoint.noop_context_fn
        return
    for split in ("subtrain", "val"):
        out = Path(cfg.log_dir) / "3" / split
        blob = json.loads((out / "metrics.json").read_text())
        # wavs are named by utterance stem, as JAX names them (speakers share stems)
        assert blob["mean"]["n_utts"] >= len(list((out / "ref").glob("*.wav"))) >= 1
        assert 0.0 <= blob["mean"]["acc"] <= 1.0
        assert ("level0_acc_teacher" in blob["per_utt"][0]) == (family == "nar")
        if list((out / "hyp").glob("*.wav")):
            assert np.isfinite(blob["mean"]["mcd"]) and blob["mean"]["mcd"] >= 0.0


def _tiny_batch(B=3):
    rs = np.random.RandomState(0)
    batch = {"text": rs.randint(1, 30, (B, 6)), "text_mask": np.ones((B, 6), np.float32),
             "proms": rs.randint(0, 30, (B, 8, 8)), "prom_mask": np.ones((B, 8), np.float32),
             "resps": rs.randint(0, 30, (B, 10, 8)), "resp_mask": np.ones((B, 10), np.float32)}
    batch["resp"] = batch["resps"][..., 0]
    return {k: torch.from_numpy(v).long() if v.dtype.kind == "i" else torch.from_numpy(v)
            for k, v in batch.items()}


@pytest.mark.parametrize("family", FAMILIES)
def test_loss_feeders_draw_from_the_generator(family):
    cfg = Config(model=family, device="cpu")
    model = get_model(f"{family}-quarter", 32, dict(d_model=16, n_heads=2, n_layers=1),
                      dtype=torch.float32)
    port_train.init_params(cfg, model)
    assert model.base.sep.abs().sum() > 0  # the whole model is seeded, not a denoiser
    loss_fn = port_train.make_loss_fn(cfg, model)
    batch = _tiny_batch()
    with torch.no_grad():
        a = loss_fn(model, batch, torch.Generator().manual_seed(0))[0]
        b = loss_fn(model, batch, torch.Generator().manual_seed(0))[0]
        c = loss_fn(model, batch, torch.Generator().manual_seed(1))[0]
        d = loss_fn(model, batch, None)[0]
    assert a == b and a != c and torch.isfinite(d)
