"""The smoke run's "codec + evals" phase rehearsed on the CPU at a tiny size
with the plain versions (``chip_smoke.py`` runs it on the card at the
published widths): the corpus, calibration from a seeded codec, ``emb.qnt``,
8 steps of the ``codec.train`` CLI, and the four evaluation entry points end
to end through their CLIs, with the attention calls each makes; then the
launch counts their sites give at full width, and the JAX records' keys."""

import json
from pathlib import Path

import pytest
import torch

from tts_with_diffusion_model_tpu_torch import smoke_codec

REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
CODEC = dict(dimension=16, n_filters=4, n_q_total=8)


@pytest.fixture(scope="module")
def rehearsal(tmp_path_factory):
    from tts_with_diffusion_model_tpu_torch.smoke_serve import write_seeded_bundles

    root = tmp_path_factory.mktemp("codec_phase")
    d3pm, nar, ar = write_seeded_bundles(root / "bundles", "tiny", 0)
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        return smoke_codec.phase_codec_evals(
            CPU, {"d3pm": d3pm, "nar": nar, "ar": ar}, corpus=(3, 11), codec_dims=CODEC,
            train_overrides=["batch_size=2"], segment_frames=8, extra=["--resp-bucket", "64"],
            root=root / "codec")
    finally:
        torch.set_num_threads(n)


def test_calibration_rehearsal(rehearsal):
    cal = rehearsal["calibrate"]
    rms = [lv["residual_rms"] for lv in cal["levels"]]
    assert len(rms) == 8 and all(a > b for a, b in zip(rms, rms[1:]))
    assert cal["latents"][1] == CODEC["dimension"] and cal["latents"][0] > 1024


def test_codec_train_rehearsal(rehearsal):
    tr = rehearsal["train"]
    assert len(tr["step_s"]) == smoke_codec.CODEC_STEPS and tr["batch_size"] == 2
    assert tr["moved"] > 0 and tr["peak_bytes"] is None


def test_evals_rehearsal(rehearsal):
    """Every entry point's plain attention calls equal the count its sites
    give; the tiny DiT (2 + 2 tower layers, 2 blocks, 19 process steps) and
    NAR (2 blocks) give 4 + 19·6 + 14 per ancestral batch."""
    runs = rehearsal["evals"]["runs"]
    assert list(runs) == ["heldout_eval ancestral", "heldout_eval maskgit", "heldout_eval ar",
                          "speaker_transfer_eval", "quality_gate", "longform_seam_eval"]
    chain, maskgit, nar = 4 + 19 * 6, 4 + 12 * 6, 7 * 2
    assert runs["heldout_eval ancestral"]["expected"]["kernel1"] == chain + nar
    assert runs["heldout_eval maskgit"]["expected"]["kernel1"] == maskgit + nar
    assert runs["heldout_eval ar"]["expected"] == {"kernel1": nar, "kernel2_fwd": 2}
    assert runs["speaker_transfer_eval"]["expected"]["kernel1"] == 2 * smoke_codec.TRIALS * (
        chain + nar)
    assert runs["quality_gate"]["expected"]["kernel1"] == chain + nar
    n_seg = rehearsal["evals"]["json"]["longform_seam"]["n_segments"]
    assert runs["longform_seam_eval"]["expected"]["kernel1"] == n_seg * (maskgit + nar)
    for r in runs.values():
        assert r["launches"]["plain"] == sum(r["expected"].values()) > 0
        assert r["launches"]["kernel1"] == r["launches"]["kernel2_fwd"] == 0
    blobs = rehearsal["evals"]["json"]
    assert blobs["quality_gate"]["ok"] and blobs["heldout_ar"]["summary"]["decode"] == "ar"


def test_eval_kernel_check_rehearsal(rehearsal):
    """Both kernels' wrappers against their plain versions at every shape
    the evaluations gave (fp32 and bf16), and a path line per evaluation."""
    k = rehearsal["kernels"]
    shapes = {(r["B"], r["Tq"], r["Tk"]) for r in k["kernel1"]}
    assert len(k["kernel1"]) == 2 * len(shapes) >= 2 * 10
    assert set(k["paths1"]) == set(rehearsal["evals"]["runs"])
    assert [r[0] for r in k["runs2"]] == ["heldout_eval ar"]
    assert {r["dtype"] for r in k["kernel2"]} == {"float32", "bfloat16"}


@pytest.mark.parametrize("kind,record", [
    ("heldout", "heldout_fullstack_mini_v3.json"), ("heldout_ar", "heldout_fullstack_ar_mini_v2.json"),
    ("transfer", "transfer_eval_fullstack_mini_v2.json"), ("quality_gate", "quality_gate_mini_v3.json"),
    ("seam", "longform_seam_mini_v3.json")])
def test_keys_are_the_jax_records(kind, record):
    """The keys the phase holds each JSON to are those of the JAX
    repository's record of the same evaluation."""
    blob = json.loads((REPO / "benchmarks" / "gen_r4" / record).read_text())
    smoke_codec.check_json(kind, blob)


def test_launches_at_full_width(tmp_path):
    """The registry widths: 2380 + 84 kernel-1 launches per ancestral batch
    and gate call, 376 per MaskGIT batch (and long-form segment), 84 + 12
    kernel-2 forwards for the AR, 8 · 2464 for the transfer's 4 trials."""
    from tts_with_diffusion_model_tpu_torch.models.diffusion import ancestral_schedule

    for name, meta in (("d", {"model": "diffusion"}), ("n", {"model": "nar"}),
                       ("a", {"model": "ar"})):
        (tmp_path / name).mkdir()
        (tmp_path / name / "model.json").write_text(json.dumps({**meta, "num_tokens": 1024}))
    dit, nar, ar = (smoke_codec.per_call(tmp_path / n) for n in "dna")
    chain = dit["towers"] + len(ancestral_schedule(dit["timesteps"], 1)[0]) * dit["denoiser"]
    assert (chain, nar["nar"], ar["prefill"]) == (2380, 84, 12)
    assert dit["towers"] + 12 * dit["denoiser"] + nar["nar"] == 376
    assert 2 * smoke_codec.TRIALS * (chain + nar["nar"]) == 19712
