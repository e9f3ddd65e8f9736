"""The port's codebook calibration against the JAX package's on the CPU:
k-means (its k-means++ seeding, Lloyd's updates and empty-cluster reseeds on
numpy's ``default_rng``), residual calibration, the latents' collection
order, and the CLI's converted-weights file, which both packages load."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tts_with_diffusion_model_tpu.codec import calibrate as jcal
from tts_with_diffusion_model_tpu_torch.codec import calibrate as tcal

CPU = "cpu"
TINY = dict(dimension=16, n_filters=4, n_q_total=8, bins=16)
#: assignments are compared where the best and second-best squared
#: distances differ by more than this (relative): the two packages sum the
#: products in other orders
MARGIN = 1e-5


def _clusters(n_clusters=16, per=40, d=8, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((n_clusters, d)) * 4.0
    return np.concatenate([c + 0.1 * rng.standard_normal((per, d)) for c in centers]
                          ).astype(np.float32)


def _margins(x, cb):
    d2 = ((x.astype(np.float64)[:, None] - cb.astype(np.float64)[None]) ** 2).sum(-1)
    two = np.sort(d2, axis=1)[:, :2]
    return (two[:, 1] - two[:, 0]) / np.maximum(two[:, 1], 1e-30)


def test_assign_matches_jax_off_ties():
    rs = np.random.RandomState(0)
    x, cb = rs.randn(500, 8).astype(np.float32), rs.randn(32, 8).astype(np.float32)
    got = tcal._assign(torch.as_tensor(x), torch.as_tensor(cb)).numpy()
    ref = np.asarray(jcal._assign(jnp.asarray(x), jnp.asarray(cb)))
    off = _margins(x, cb) > MARGIN
    assert off.mean() > 0.99
    np.testing.assert_array_equal(got[off], ref[off])


@pytest.mark.parametrize("case", ["clusters", "random"])
def test_kmeans_matches_jax(case):
    """Separated clusters, and random latents (no assignment of the run
    within ``MARGIN`` of a tie, checked): centroids within 1e-6."""
    if case == "clusters":
        x, k, iters = _clusters(), 16, 8
    else:
        x, k, iters = np.random.RandomState(3).randn(600, 8).astype(np.float32), 24, 6
    got = tcal.kmeans(x, k, iters, seed=4, device=CPU)
    ref = jcal.kmeans(x, k, iters, seed=4)
    assert got.shape == ref.shape == (k, 8)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    if case == "random":
        assert _margins(x, ref).min() > MARGIN


def test_calibrate_codebooks_matches_jax():
    """Three levels on clustered latents: each level's codebook within 1e-6,
    the untouched level kept, the residual RMS falling level by level."""
    x = _clusters(n_clusters=32, per=20, seed=1)
    cbs = np.random.default_rng(0).standard_normal((4, 32, 8)).astype(np.float32)
    report = []
    got = tcal.calibrate_codebooks(x, cbs, levels=3, iters=6, device=CPU, report=report)
    ref = jcal.calibrate_codebooks(x, cbs, levels=3, iters=6)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got[3], cbs[3])
    rms = [r["residual_rms"] for r in report]
    assert len(rms) == 3 and rms[0] > rms[1] > rms[2]
    assert [r["codes_used"] for r in report][0] == 32


def test_collect_latents_visits_paths_in_jax_order(tmp_path):
    """The paths shuffled by ``default_rng(seed)``, the stop at
    ``max_frames`` and the subsample: identical latents, with a stand-in
    codec whose latents name their file."""
    from tts_with_diffusion_model_tpu.audio.wavio import write_wav

    paths = []
    for i in range(7):
        p = tmp_path / f"u{i}.wav"
        write_wav(p, np.full(320 * (3 + i), 0.01 * (i + 1), np.float32), 24_000)
        paths.append(p)

    class Tagged:
        def encode_latents(self, wav, sr):
            n = len(np.asarray(wav).reshape(-1)) // 320
            return np.full((n, 4), float(np.asarray(wav).reshape(-1)[0]), np.float32)

    for max_frames in (10, 25, 1000):
        got = tcal.collect_latents(Tagged(), paths, max_frames=max_frames, seed=3)
        ref = jcal.collect_latents(Tagged(), paths, max_frames=max_frames, seed=3)
        np.testing.assert_array_equal(got, ref)


def test_cli_file_loads_in_both_packages(tmp_path, monkeypatch):
    """``codec.calibrate`` from a tiny seeded codec (found through
    ``$ENCODEC_WEIGHTS``): the file keeps every other array, swaps the
    first levels' codebooks, and both packages encode a wav to the same
    codes with it."""
    from tts_with_diffusion_model_tpu.codec.convert import load_npz_params
    from tts_with_diffusion_model_tpu.codec.encodec import EncodecModel as JaxEncodec
    from tts_with_diffusion_model_tpu_torch.audio.wavio import write_wav
    from tts_with_diffusion_model_tpu_torch.bundle import load_npz
    from tts_with_diffusion_model_tpu_torch.codec.encodec import load_codec
    from tts_with_diffusion_model_tpu_torch.smoke_codec import write_seeded_codec

    seeded = write_seeded_codec(tmp_path / "seeded.npz", 2, TINY)
    rs = np.random.RandomState(0)
    (tmp_path / "wavs").mkdir()
    for i in range(6):
        n = np.arange(320 * (20 + 3 * i)) / 24_000
        wav = 0.3 * np.sin(2 * np.pi * (150 + 40 * i) * n) + 0.02 * rs.randn(len(n))
        write_wav(tmp_path / "wavs" / f"{i}.wav", wav.astype(np.float32), 24_000)
    monkeypatch.setenv("ENCODEC_WEIGHTS", str(seeded))
    out = tmp_path / "calibrated.npz"
    res = tcal.main([str(tmp_path / "wavs"), "--out", str(out), "--levels", "2", "--iters", "3",
                     "--device", "cpu"])
    assert [lv["level"] for lv in res["levels"]] == [0, 1]
    before, after = load_npz(seeded), load_npz(out)
    assert before.keys() == after.keys()
    for k in before:
        if k != tcal.CODEBOOKS:
            np.testing.assert_array_equal(before[k], after[k])
    cb0, cb1 = before[tcal.CODEBOOKS], after[tcal.CODEBOOKS]
    assert not np.array_equal(cb0[:2], cb1[:2])
    np.testing.assert_array_equal(cb0[2:], cb1[2:])

    codec = load_codec(out, device="cpu")
    wav = 0.3 * np.sin(2 * np.pi * 220 * np.arange(320 * 12) / 24_000).astype(np.float32)
    got = codec.encode(wav, 24_000)
    ref = JaxEncodec(**TINY).apply(load_npz_params(out), jnp.asarray(wav)[None, :, None], 8,
                                   method=JaxEncodec.encode)
    np.testing.assert_array_equal(got, np.asarray(ref)[0])
