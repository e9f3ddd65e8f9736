"""The port's long-form synthesis against the JAX package's, in fp32 on the
CPU, with tiny bundles written by the JAX package's exporter:

- ``segment_phones`` equal to JAX's on the JAX tests' inputs and on seeded
  random phone lists, and the derived per-segment seeds;
- ``iter_segment_codes`` / ``synthesize_long`` for an AR and a D3PM
  (MaskGIT) first stage: the same segment rows (continuation prompts), the
  same derived seeds and identical codes under the same injected Gumbel
  noise (JAX's ``Synthesizer`` rebuilt with fp32 compute, both NARs at
  temperature 0), and the wav of the joined codes within the codec's fp32
  tolerance of JAX's (a small codec with the same weights on both sides);
- ``synthesize_stream`` equal to ``synthesize`` when the context covers
  every earlier frame, and its chunks equal to JAX's;
- ``Synthesizer.synthesize`` dispatching over-long texts to long-form;
- the inference CLI's ``--segment-phones`` and its automatic long-form
  path."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tts_with_diffusion_model_tpu.models.ar as jax_ar
import tts_with_diffusion_model_tpu.models.diffusion as jax_diffusion
from tts_with_diffusion_model_tpu import longform as jax_longform
from tts_with_diffusion_model_tpu.codec.encodec import EncodecModel as JaxEncodec
from tts_with_diffusion_model_tpu.export import save_bundle
from tts_with_diffusion_model_tpu.models.ar import AR as JaxAR
from tts_with_diffusion_model_tpu.models.nar import NAR as JaxNAR
from tts_with_diffusion_model_tpu_torch import longform, serve, smoke
from tts_with_diffusion_model_tpu_torch.codec.encodec import Codec, EncodecModel
from tts_with_diffusion_model_tpu_torch.convert import init_seeded, jax_params_to_torch
from tts_with_diffusion_model_tpu_torch.serve import Synthesizer

from torch_port_helpers import (  # noqa: F401 (one_thread: fixture)
    TableKeys,
    flatten,
    one_thread,
    patch_jax_noise,
    perturbed,
    unflatten,
)

pytestmark = pytest.mark.usefixtures("one_thread")

DIMS = dict(d_model=32, n_heads=2, n_layers=2)
#: the AR's decode budget: every segment ≥ 8 frames, so streamed chunks
#: are prefix-exact (EnCodec pads shorter inputs)
AR_STEPS = 16
STOP = 1024
TEXT_LEN, PROM_LEN = 10, 24
D3PM = dict(timesteps=8, resp_len=16, text_len=TEXT_LEN, prom_len=32, gen_len=16)
MASKGIT_STEPS = 4
LONG_TEXT = "make some noise and then make even more noise for me today"
#: decoded wavs, port against JAX: fp32 convolutions and LSTM summed in
#: another order (tests/test_torch_codec.py)
WAV_TOL = 1e-4
CODEC_KW = dict(dimension=16, n_filters=4, n_q_total=8, bins=1024)


@pytest.fixture(scope="module")
def bundles(tmp_path_factory):
    """Tiny AR, NAR and D3PM bundles (seeded, the D3PM's zero-initialised
    tables perturbed so that no two MaskGIT scores tie)."""
    root = tmp_path_factory.mktemp("longform_bundles")
    symmap = smoke.default_symmap()
    z = np.zeros((1, 4), np.int32)
    f = z.astype(np.float32)
    resp = np.zeros((1, 4, 8), np.int32)
    ar = jax.jit(JaxAR(1024, remat=False, **DIMS).init)(jax.random.PRNGKey(0), z, f, resp, f, z, f)
    save_bundle(root / "ar", ar, dict(model="ar", num_tokens=1024, **DIMS), symmap, {"spk": 0})
    nar = jax.jit(JaxNAR(1024, remat=False, **DIMS).init)(
        jax.random.PRNGKey(1), z, f, resp, f, resp, f, jnp.zeros((1,), jnp.int32))
    save_bundle(root / "nar", nar, dict(model="nar", num_tokens=1024, **DIMS), symmap, {"spk": 0})
    dm = jax_diffusion.DiffusionModel(jax_diffusion.DiffusionConfig(n_classes=1025, **DIMS, **D3PM),
                                      dtype=jnp.float32)
    params = unflatten(perturbed(jax.jit(dm.init)(jax.random.PRNGKey(2)), seed=3))
    save_bundle(root / "diffusion", params,
                dict(model="diffusion", num_tokens=1024, **DIMS, **D3PM), symmap, {"spk": 0})
    return root


@pytest.fixture(scope="module")
def codecs():
    """A small EnCodec with the same weights on both sides: the port's
    ``Codec`` and a JAX stand-in for the JAX ``Codec``'s ``decode``."""
    jm = JaxEncodec(**CODEC_KW)
    flat = flatten(jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, 1280, 1))))
    rs = np.random.RandomState(1)
    for k in list(flat):  # non-trivial gains and biases
        if k.endswith(("/g", "/b")) or "/b_l" in k:
            flat[k] = (flat[k] + 0.1 * rs.randn(*flat[k].shape)).astype(np.float32)
    port = EncodecModel(**CODEC_KW)
    jax_params_to_torch(flat, port)
    decode = jax.jit(functools.partial(jm.apply, method=JaxEncodec.decode))
    params = unflatten(flat)

    class JaxCodec:
        model = jm

        def __init__(self):
            self.params = params

        def decode(self, codes):
            return np.asarray(decode(params, jnp.asarray(codes, jnp.int32)[None]))[0, :, 0], 24000

    return Codec(port, "cpu"), JaxCodec()


#: the reference prompt both sides get (no codec encode)
PROMPT = np.random.RandomState(5).randint(0, 1024, (30, 8)).astype(np.int32)


def _jax_synth(monkeypatch, bundles, family):
    """JAX's ``Synthesizer`` with its models rebuilt in fp32 compute (its
    ``bf16=False`` keeps bf16 activations)."""
    import tts_with_diffusion_model_tpu.__main__ as jax_cli
    from tts_with_diffusion_model_tpu.serve import Synthesizer as JaxSynthesizer

    build = jax_cli.build_model

    def fp32(meta):
        m = build(meta)
        if isinstance(m, jax_diffusion.DiffusionModel):
            return jax_diffusion.DiffusionModel(m.config, dtype=jnp.float32)
        return m.clone(dtype=jnp.float32)

    monkeypatch.setattr(jax_cli, "build_model", fp32)
    if family == "ar":
        return JaxSynthesizer(bundles / "ar", bundles / "nar", text_len=TEXT_LEN,
                              prom_len=PROM_LEN, max_ar_steps=AR_STEPS, nar_temperature=0.0,
                              bf16=False)
    return JaxSynthesizer(bundles / "diffusion", bundles / "nar", nar_temperature=0.0, bf16=False,
                          maskgit_steps=MASKGIT_STEPS)


def _port_synth(bundles, family, codec, max_batch=1):
    first, symmap = serve.load_model(bundles / ("ar" if family == "ar" else "diffusion"),
                                     torch.float32)
    nar, _ = serve.load_model(bundles / "nar", torch.float32)
    synth = Synthesizer(first, nar, codec, symmap, device="cpu", bf16=False, max_batch=max_batch,
                        max_ar_steps=AR_STEPS, maskgit_steps=MASKGIT_STEPS, nar_temperature=0.0)
    if family == "ar":  # the JAX Synthesizer's text_len / prom_len arguments
        synth.text_len, synth.prom_len = TEXT_LEN, PROM_LEN
    return synth


class _Stages:
    """``RowKeys.from_seeds`` stand-in: the first stage reads the tables,
    the NAR (temperature 0) draws nothing."""

    def __init__(self, tables):
        self.tables = tables

    def fold(self, tag):
        return TableKeys(self.tables) if tag == 0 else None


def _tables(family, seed=0):
    rs = np.random.RandomState(seed)
    if family == "ar":
        tables = {(i, 1): rs.gumbel(size=(1, STOP + 1)).astype(np.float32)
                  for i in range(AR_STEPS + 1)}
        for tab in tables.values():
            tab[:, STOP] = -50.0  # no row stops: every segment is AR_STEPS frames
        return tables
    bucket, V = D3PM["resp_len"], 1025
    tables = {}
    for i in range(MASKGIT_STEPS):
        tables[(2 * i, 2)] = rs.gumbel(size=(1, bucket, V)).astype(np.float32)
        tables[(2 * i + 1, 1)] = rs.gumbel(size=(1, bucket)).astype(np.float32)
    return tables


def _spy_batches(monkeypatch, synth):
    """Record each device batch's rows and seeds."""
    calls = []
    orig = synth._device_batch

    def spy(prepared, seeds, want_wav=False):
        calls.append(([dict(r) for r in prepared], list(seeds)))
        return orig(prepared, seeds, want_wav=want_wav)

    monkeypatch.setattr(synth, "_device_batch", spy)
    return calls


PHONES_CASES = [
    (["HH", "IY1", "_", "M", "EY1", "K", "_", "S", "AH1", "M", "_", "N", "OY1", "Z"], 6),
    (["M", "EY1", "K"], 50),
    (["A"] * 10, 4),
    (["A", "B", "_", "C", "D", "E", "F", "G"], 5),
    (["_", "_", "A", "_"], 1),
    ([], 3),
]


def _random_phones(seed):
    rs = np.random.RandomState(seed)
    return [str(p) for p in rs.choice(["_", "A", "B", "C", "DH", "EY1"], rs.randint(1, 90),
                                      p=[0.3, 0.2, 0.2, 0.1, 0.1, 0.1])], int(rs.randint(1, 20))


@pytest.mark.parametrize("case", [*PHONES_CASES, *(_random_phones(s) for s in range(12))])
def test_segment_phones_matches_jax(case):
    phones, max_len = case
    assert longform.segment_phones(phones, max_len) == jax_longform.segment_phones(phones, max_len)


def test_segment_phones_refuses_an_empty_budget():
    with pytest.raises(ValueError, match="max_len"):
        longform.segment_phones(["A"], 0)


@pytest.mark.parametrize("seed", [0, 1, 7, 2**31 - 1, 123_456_789])
def test_segment_seeds_are_the_jax_packages(seed):
    assert [longform.segment_seed(seed, i) for i in range(4)] == [
        (seed * 1_000_003 + i) & 0x7FFFFFFF for i in range(4)]


@pytest.mark.parametrize("family", ["ar", "d3pm"])
def test_long_form_codes_match_jax(bundles, codecs, monkeypatch, family):
    """The same segment rows, derived seeds and codes as JAX's under the
    same noise; the joined decode and the stream's chunks within the codec
    tolerance of JAX's, the stream equal to ``synthesize_long``."""
    port_codec, jax_codec = codecs
    jsynth = _jax_synth(monkeypatch, bundles, family)
    jsynth.codec = jax_codec
    synth = _port_synth(bundles, family, port_codec)
    for s in (jsynth, synth):
        monkeypatch.setattr(s, "prompt_codes", lambda ref: PROMPT)
    tables = _tables(family)
    jax.clear_caches()
    patch_jax_noise(monkeypatch, jax_ar if family == "ar" else jax_diffusion, tables)
    monkeypatch.setattr(serve.RowKeys, "from_seeds", lambda seeds: _Stages(tables))

    j_calls, p_calls = _spy_batches(monkeypatch, jsynth), _spy_batches(monkeypatch, synth)
    try:
        ref = list(jax_longform.iter_segment_codes(jsynth, LONG_TEXT, "ref.wav", seed=9))
        ref_wav, _ = jax_longform.synthesize_long(jsynth, LONG_TEXT, "ref.wav", seed=9)
        ref_chunks = list(jsynth.synthesize_stream(LONG_TEXT, "ref.wav", seed=9))
    finally:
        jax.clear_caches()
    got = list(longform.iter_segment_codes(synth, LONG_TEXT, "ref.wav", seed=9))
    assert len(got) == len(ref) >= 3
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    want_frames = AR_STEPS if family == "ar" else D3PM["gen_len"]
    assert all(g.shape == (want_frames, 8) for g in got)
    # rows and seeds of iter_segment_codes: the prompt is the reference cut
    # to prom_len - prom_len // 3 frames, then the previous segment's tail
    assert len(p_calls) == len(got)
    for (p_rows, p_seeds), (j_rows, j_seeds) in zip(p_calls, j_calls[: len(got)]):
        assert p_seeds == j_seeds
        for k in ("text", "text_mask", "proms", "prom_mask", "prom_n"):
            np.testing.assert_array_equal(p_rows[0][k], j_rows[0][k], err_msg=k)
    assert [s for _, s in p_calls] == [[longform.segment_seed(9, i)] for i in range(len(got))]
    keep = synth.prom_len - synth.prom_len // 3
    second = p_calls[1][0][0]
    np.testing.assert_array_equal(second["proms"][0, :keep], PROMPT[:keep])
    np.testing.assert_array_equal(second["proms"][0, keep:synth.prom_len],
                                  got[0][-(synth.prom_len // 3):])

    wav, sr = longform.synthesize_long(synth, LONG_TEXT, "ref.wav", seed=9)
    assert sr == 24000 and wav.shape == ref_wav.shape == (len(got) * want_frames * 320,)
    np.testing.assert_allclose(wav, ref_wav, atol=WAV_TOL)
    chunks = list(synth.synthesize_stream(LONG_TEXT, "ref.wav", seed=9))
    assert [c.shape for c in chunks] == [c.shape for c in ref_chunks] == [
        (want_frames * 320,)] * len(got)
    for c, r in zip(chunks, ref_chunks):
        np.testing.assert_allclose(c, r, atol=WAV_TOL)
    # the default context (112 frames) covers every earlier frame here
    np.testing.assert_allclose(np.concatenate(chunks), wav, atol=1e-5)


@pytest.fixture(scope="module")
def small_codec():
    model = smoke.tiny_models()[3]
    init_seeded(model, 2)
    return Codec(model, "cpu")


@pytest.mark.parametrize("context_frames", [10_000, 0, 5])
def test_stream_equals_synthesize_with_full_context(bundles, small_codec, context_frames):
    """With seeded noise (the port's own keys): a context covering every
    earlier frame streams ``synthesize``'s wav within 1e-5; no context
    decodes each segment alone; a short context keeps every chunk's length."""
    synth = _port_synth(bundles, "d3pm", small_codec)
    ref = smoke.reference_wavs(1, 0.3, seed=41)[0]
    wav, _ = synth.synthesize(LONG_TEXT, ref, seed=4)
    chunks = list(synth.synthesize_stream(LONG_TEXT, ref, seed=4, context_frames=context_frames))
    assert len(chunks) >= 3 and all(c.shape == (D3PM["gen_len"] * 320,) for c in chunks)
    joined = np.concatenate(chunks)
    assert joined.shape == wav.shape
    if context_frames >= 10_000:
        np.testing.assert_allclose(joined, wav, atol=1e-5)
    elif context_frames == 0:
        codes = list(longform.iter_segment_codes(synth, LONG_TEXT, ref, seed=4))
        for c, seg in zip(chunks, codes):
            np.testing.assert_array_equal(c, synth.decode_codes(seg)[0])
    assert np.isfinite(joined).all()


def test_synthesize_dispatches_long_texts_and_keeps_short_ones(bundles, small_codec, monkeypatch):
    synth = _port_synth(bundles, "ar", small_codec)
    ref = smoke.reference_wavs(1, 0.3, seed=42)[0]
    calls = _spy_batches(monkeypatch, synth)
    wav, sr = synth.synthesize(LONG_TEXT, ref, seed=1)
    n_seg = len(longform.segment_phones(synth.phones_and_ids(LONG_TEXT)[0], TEXT_LEN))
    assert len(calls) == n_seg >= 3 and all(len(seeds) == 1 for _, seeds in calls)
    assert sr == 24000 and wav.shape[0] > 0 and np.isfinite(wav).all()
    calls.clear()
    short, _ = synth.synthesize("make noise", ref, seed=1)
    assert len(calls) == 1 and short.shape[0] > 0
    # one chunk for a text within the bucket, equal to synthesize's wav
    (chunk,) = synth.synthesize_stream("make noise", ref, seed=1)
    np.testing.assert_allclose(chunk, short, atol=1e-5)


def _cli(bundles, out, text, *extra):
    ref = smoke.reference_wavs(1, 0.5, seed=21)[0]
    return [text, str(ref), str(out), "--device", "cpu", "--seed", "3",
            "--ar-ckpt", str(bundles / "ar"), "--nar-ckpt", str(bundles / "nar"),
            "--max-ar-steps", "12", "--temperature", "0", *extra]


@pytest.mark.parametrize("text,extra,want_segments", [
    (" ".join(smoke.TEXTS), [], "bucket"),   # over the AR's 50-phone bucket
    ("she said hello to me", ["--segment-phones", "5"], "forced"),
    ("she said hello", [], "none")])
def test_cli_long_form(bundles, tmp_path, monkeypatch, small_codec, text, extra, want_segments):
    """The CLI dispatches over the first stage's text bucket (50 for an AR)
    or on ``--segment-phones``; every segment is one device batch of one
    row and the wav is the joined codes' decode."""
    from tts_with_diffusion_model_tpu_torch.__main__ import main
    from tts_with_diffusion_model_tpu_torch.audio.wavio import read_wav
    from tts_with_diffusion_model_tpu_torch.codec import encodec

    monkeypatch.setattr(encodec, "load_codec", lambda *a, **kw: small_codec)
    frames, long_calls = [], []
    real_batch, real_long = Synthesizer._device_batch, longform.synthesize_long

    def spy_batch(self, prepared, seeds, want_wav=True):
        out = real_batch(self, prepared, seeds, want_wav)
        frames.append(len(out[0][0]))
        return out

    def spy_long(*a, **kw):
        long_calls.append(kw.get("max_segment_phones"))
        return real_long(*a, **kw)

    monkeypatch.setattr(Synthesizer, "_device_batch", spy_batch)
    monkeypatch.setattr(longform, "synthesize_long", spy_long)
    out = tmp_path / "out.wav"
    main(_cli(bundles, out, text, *extra))
    wav, sr = read_wav(out)
    assert sr == 24000 and wav.shape == (1, sum(frames) * 320) and np.isfinite(wav).all()
    from tts_with_diffusion_model_tpu_torch.text import g2p

    phones = g2p.encode(text)
    if want_segments == "bucket":
        assert long_calls == [None] and len(frames) == len(longform.segment_phones(phones, 50)) >= 2
    elif want_segments == "forced":
        assert long_calls == [5] and len(frames) == len(longform.segment_phones(phones, 5)) >= 2
    else:
        assert long_calls == [] and len(frames) == 1
