"""The smoke run's phases rehearsed on the CPU at a tiny size with the plain
versions (the card runs them at full width through ``chip_smoke.py``), and
``chip_smoke.py``'s refusals without a card or without the repository."""

import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from tts_with_diffusion_model_tpu_torch import smoke
from tts_with_diffusion_model_tpu_torch.models.diffusion import DiffusionConfig

REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")


def test_main_path_sites_launch_376_times_at_full_width():
    sites = smoke.attention_sites(DiffusionConfig(), {"d_model": 1024, "n_heads": 16,
                                                      "n_layers": 12}, 12, 256)
    assert smoke.expected_launches(sites) == 4 + 12 * 8 * 3 + 7 * 12 == 376
    nar = sites[-1]
    assert (nar.Tq, nar.H, nar.Dh) == (50 + 1 + 256 + 1 + 350, 16, 64)


def test_bound_is_bytes_at_the_dit_self_attention_shape():
    ms, by = smoke.bound_ms(1, 384, 384, 8, 64, torch.bfloat16)
    assert by == "bytes" and 0 < ms < 0.01


def test_kernel_phase_rehearsal():
    first, _, nar_dims, _ = smoke.tiny_models()
    res = smoke.phase_kernel_check(CPU, first.config, nar_dims, steps=2, B=4,
                                   prompt_buckets=(64,), timed_bucket=64)
    assert len(res) == 12 and all(r["finite"] and r["max_abs_err"] == 0.0 for r in res)
    line = smoke.kernel_summary(res, launches=0)
    assert line["route"] == "cuda" and line["ms"] is None and line["source"].endswith(".cu")


def test_slice_phase_rehearsal():
    assert smoke.phase_device(CPU)["platform"] == "cpu"
    assert smoke.phase_build(CPU) == 0.0
    out = smoke.phase_slice(CPU, "tiny", seed=0, repeats=1, ref_seconds=0.5)
    cfg = out["dit_cfg"]
    assert out["expected"] == 4 + out["steps"] * cfg.n_layers * 3 + 7 * out["nar_dims"]["n_layers"]
    assert out["launches"] == 0 and out["denoiser_err"] == 0.0


def test_chip_smoke_refuses_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode != 0 and '"ok"' not in out.stdout


def test_chip_smoke_refuses_outside_the_repository(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode != 0 and '"ok"' not in out.stdout
