"""The port's copy of the eval metrics (``utils/metrics.py``) and the eval
decode's ``decode_rows`` against the JAX package's, on the CPU: token
metrics exact, mel cepstra, MCD and seam flux within 1e-6 relative, the DTW
path identical; for given code rows, ``decode_rows`` wavs within 1e-4 of
JAX's (a small codec with the same weights on both sides) and the
utterance metrics within 1e-5."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tts_with_diffusion_model_tpu.codec.encodec import EncodecModel as JaxEncodec
from tts_with_diffusion_model_tpu.utils import metrics as jax_metrics
from tts_with_diffusion_model_tpu_torch.codec.encodec import HOP, Codec, EncodecModel
from tts_with_diffusion_model_tpu_torch.convert import jax_params_to_torch
from tts_with_diffusion_model_tpu_torch.train.train import decode_rows
from tts_with_diffusion_model_tpu_torch.utils import metrics

from torch_port_helpers import flatten, unflatten

SR = 24000
RTOL = 1e-6
#: decoded wavs, port against JAX: fp32 convolutions and LSTM summed in
#: another order (tests/test_torch_codec.py)
WAV_TOL = 1e-4
METRIC_RTOL = 1e-5
CODEC_KW = dict(dimension=16, n_filters=4, n_q_total=8, bins=1024)


def _wav(seed, n):
    rs = np.random.RandomState(seed)
    t = np.arange(n) / SR
    return (0.3 * np.sin(2 * np.pi * (150 + 40 * seed) * t) + 0.05 * rs.randn(n)).astype(np.float32)


@pytest.mark.parametrize("teacher_levels", [0, 1, 3])
def test_token_accuracy_is_exact(teacher_levels):
    rs = np.random.RandomState(teacher_levels)
    ref = rs.randint(0, 8, (40, 8))
    for hyp in (ref.copy(), rs.randint(0, 8, (33, 8)), rs.randint(0, 8, (50, 1)),
                np.zeros((0, 8), int)):
        hyp[: len(hyp) // 2] = ref[: len(hyp) // 2, : hyp.shape[1]]
        assert metrics.token_accuracy(hyp, ref, teacher_levels) == \
            jax_metrics.token_accuracy(hyp, ref, teacher_levels)
    with pytest.raises(ValueError):
        metrics.token_accuracy(np.zeros(3), ref)


@pytest.mark.parametrize("n_mels,n_fft", [(40, 1024), (80, 512)])
def test_mel_filterbank_and_cepstra(n_mels, n_fft):
    np.testing.assert_allclose(metrics.mel_filterbank(SR, n_fft, n_mels),
                               jax_metrics.mel_filterbank(SR, n_fft, n_mels), rtol=RTOL)
    for n in (100, 4000, 12345):
        w = _wav(n % 7, n)
        np.testing.assert_allclose(metrics.mel_cepstra(w, SR, n_fft=n_fft, n_mels=n_mels),
                                   jax_metrics.mel_cepstra(w, SR, n_fft=n_fft, n_mels=n_mels),
                                   rtol=RTOL, atol=1e-12)


def test_dtw_path_is_identical():
    rs = np.random.RandomState(0)
    for shape in ((1, 1), (5, 9), (30, 17), (40, 40)):
        cost = rs.rand(*shape)
        assert metrics._dtw_path(cost) == jax_metrics._dtw_path(cost)


def test_mcd_seam_flux_utterance_and_aggregate():
    a, b = _wav(1, 9000), _wav(2, 7000)
    for x, y in ((a, b), (a, a), (b, a[:10])):
        got, ref = metrics.mel_cepstral_distortion(x, y, SR), \
            jax_metrics.mel_cepstral_distortion(x, y, SR)
        assert got["frames"] == ref["frames"]
        np.testing.assert_allclose(got["mcd"], ref["mcd"], rtol=RTOL, atol=1e-12)
    wav = np.concatenate([a, b, a])
    for bounds in ([9000, 16000], [], [0, 24999]):
        got, ref = metrics.seam_spectral_flux(wav, SR, bounds), \
            jax_metrics.seam_spectral_flux(wav, SR, bounds)
        assert got.keys() == ref.keys()
        for k in ref:
            np.testing.assert_allclose(got[k], ref[k], rtol=RTOL)
    assert metrics.seam_spectral_flux(a[:300], SR, [100]) == \
        jax_metrics.seam_spectral_flux(a[:300], SR, [100])
    rs = np.random.RandomState(3)
    codes = rs.randint(0, 16, (30, 8))
    rows = [metrics.eval_utterance_metrics(codes[:20], codes, a, b, SR, teacher_levels=1),
            metrics.eval_utterance_metrics(codes, codes, None, None),
            {"len_ratio": 0.0, "acc": 0.0, "mcd": float("inf")}]
    ref_rows = [jax_metrics.eval_utterance_metrics(codes[:20], codes, a, b, SR, teacher_levels=1),
                jax_metrics.eval_utterance_metrics(codes, codes, None, None), rows[2]]
    for got, ref in zip(rows, ref_rows):
        assert got.keys() == ref.keys()
        np.testing.assert_allclose([got[k] for k in ref], [ref[k] for k in ref], rtol=RTOL)
    assert metrics.aggregate_metrics(rows) == jax_metrics.aggregate_metrics(ref_rows)
    assert metrics.aggregate_metrics([]) == jax_metrics.aggregate_metrics([]) == {"n_utts": 0}


@functools.cache
def _codecs():
    """A small EnCodec with the same weights on both sides: the port's
    ``Codec`` and the JAX model's batched decode."""
    jm = JaxEncodec(**CODEC_KW)
    flat = flatten(jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, 1280, 1))))
    rs = np.random.RandomState(1)
    for k in list(flat):  # non-trivial gains and biases
        if k.endswith(("/g", "/b")) or "/b_l" in k:
            flat[k] = (flat[k] + 0.1 * rs.randn(*flat[k].shape)).astype(np.float32)
    port = EncodecModel(**CODEC_KW)
    jax_params_to_torch(flat, port)
    params = unflatten(flat)
    decode = jax.jit(lambda c: jm.apply(params, c, method=JaxEncodec.decode))
    return Codec(port, "cpu"), lambda codes: (np.asarray(decode(jnp.asarray(codes, jnp.int32)))[..., 0], SR)


def _jax_decode_rows(rows, decode):
    """The JAX package's ``decode_rows`` (a closure of ``train.main``)
    applied with the JAX codec's decode: edge-replicated to a multiple of 64
    frames, one call, each wav cut to its row's length."""
    lens = [len(r) for r in rows]
    T = -(-max(lens) // 64) * 64
    padded = np.stack([np.concatenate([r, np.repeat(r[-1:], T - len(r), axis=0)], axis=0)
                       for r in rows])
    wavs, sr = decode(np.moveaxis(padded, 1, 2))
    return [wavs[i, : lens[i] * HOP] for i in range(len(rows))], sr


@pytest.mark.parametrize("levels", [1, 8])
def test_decode_rows_and_metrics_equal_jax(levels):
    port, jax_decode = _codecs()
    rs = np.random.RandomState(levels)
    rows = [rs.randint(0, 1024, (n, levels)) for n in (5, 64, 70, 1)]
    got, sr = decode_rows(rows, port)
    ref, ref_sr = _jax_decode_rows(rows, jax_decode)
    assert sr == ref_sr == SR
    for g, r, row in zip(got, ref, rows):
        assert g.shape == r.shape == (len(row) * HOP,)
        np.testing.assert_allclose(g, r, atol=WAV_TOL)
    refs = [rs.randint(0, 1024, (len(r), 8)) for r in rows]
    for i in range(len(rows)):
        m = metrics.eval_utterance_metrics(rows[i], refs[i], got[i], got[(i + 1) % 4], SR)
        m_ref = jax_metrics.eval_utterance_metrics(rows[i], refs[i], ref[i], ref[(i + 1) % 4], SR)
        assert m.keys() == m_ref.keys()
        for k in m_ref:
            np.testing.assert_allclose(m[k], m_ref[k], rtol=METRIC_RTOL, atol=1e-9, err_msg=k)
