"""The port's AR serving path against the JAX package's, on the CPU, with
tiny AR and NAR bundles written by the JAX package's exporter:

- the ``Synthesizer``'s codes identical to the JAX ``Synthesizer
  ._device_batch(want_wav=False)``, both in fp32 (the JAX one's models
  rebuilt with fp32 compute: its ``bf16=False`` keeps fp32 weights but
  bf16 activations), at temperatures 0 / 0, and at 1 / 0
  under injected Gumbel tables that stop one row early (per-row NAR masks
  and the cut to each row's length); the port's codes do not depend on the
  cohort at temperature 1 (a request alone and inside a batch of 3);
- the CLI on an AR bundle with and without ``--draft-ckpt``, and its
  refusals (a draft that is not an AR, another vocabulary, a long text with
  a negative long-form segment budget);
- the prompt cache under 4 threads: never above its capacity, every code
  array equal to a single-threaded encode."""

import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import tts_with_diffusion_model_tpu.models.ar as jax_ar
from tts_with_diffusion_model_tpu.export import save_bundle
from tts_with_diffusion_model_tpu.models.ar import AR as JaxAR
from tts_with_diffusion_model_tpu.models.nar import NAR as JaxNAR
from tts_with_diffusion_model_tpu_torch import serve, smoke
from tts_with_diffusion_model_tpu_torch.codec.encodec import Codec
from tts_with_diffusion_model_tpu_torch.convert import init_seeded
from tts_with_diffusion_model_tpu_torch.serve import Synthesizer

from torch_port_helpers import (  # noqa: F401 (one_thread: fixture)
    TableKeys,
    one_thread,
    patch_jax_noise,
)

pytestmark = pytest.mark.usefixtures("one_thread")

DIMS = dict(d_model=32, n_heads=2, n_layers=2)
STEPS = 24  # max_ar_steps: the NAR's response bucket
STOP = 1024


def _init_backbone(module, seed, n_tokens=1024):
    z = np.zeros((1, 4), np.int32)
    f = z.astype(np.float32)
    resp = np.zeros((1, 4, 8), np.int32)
    if isinstance(module, JaxNAR):
        return jax.jit(module.init)(jax.random.PRNGKey(seed), z, f, resp, f, resp, f,
                                    jnp.zeros((1,), jnp.int32))
    return jax.jit(module.init)(jax.random.PRNGKey(seed), z, f, resp, f, z, f)


@pytest.fixture(scope="module")
def bundles(tmp_path_factory):
    """Tiny bundles: an AR (d32/2/2), a one-block AR draft, an AR over
    another vocabulary, and a NAR."""
    root = tmp_path_factory.mktemp("ar_bundles")
    symmap = smoke.default_symmap()
    specs = {"ar": (JaxAR(1024, remat=False, **DIMS), dict(model="ar", num_tokens=1024, **DIMS)),
             "draft": (JaxAR(1024, remat=False, **dict(DIMS, n_layers=1)),
                       dict(model="ar-quarter", num_tokens=1024, **dict(DIMS, n_layers=1))),
             "ar512": (JaxAR(512, remat=False, **DIMS), dict(model="ar", num_tokens=512, **DIMS)),
             "nar": (JaxNAR(1024, remat=False, **DIMS), dict(model="nar", num_tokens=1024, **DIMS))}
    for i, (name, (module, meta)) in enumerate(specs.items()):
        save_bundle(root / name, _init_backbone(module, i), meta, symmap, {"spk": 0})
    return root


def _rows(synth, seed=0, n=2):
    """Prepared rows from phone ids and prompt codes (no codec encode):
    ragged text and prompts."""
    rs = np.random.RandomState(seed)
    rows = []
    for i in range(n):
        ids = rs.randint(1, len(synth.phone_symmap), 30 - 7 * i)
        proms = rs.randint(0, 1024, (100 - 30 * i, 8))
        text_a, text_m = synth._pad(ids, synth.text_len)
        prom_a, prom_m = synth._pad(proms, synth.prom_len, (8,))
        rows.append(dict(text=text_a, text_mask=text_m, proms=prom_a, prom_mask=prom_m,
                         prom_n=len(proms)))
    return rows


def _port(bundles, **kw):
    return Synthesizer.from_bundles(bundles / "ar", bundles / "nar", None, device="cpu",
                                    bf16=False, max_batch=3, max_ar_steps=STEPS, **kw)


class _Stages:
    """``RowKeys.from_seeds`` stand-in: the AR stage reads the tables."""

    def __init__(self, tables):
        self.tables = tables

    def fold(self, tag):
        return TableKeys(self.tables) if tag == 0 else None


@pytest.mark.parametrize("temperature", [0.0, 1.0])
def test_codes_match_the_jax_synthesizer(bundles, monkeypatch, temperature):
    import tts_with_diffusion_model_tpu.__main__ as jax_cli
    from tts_with_diffusion_model_tpu.serve import Synthesizer as JaxSynthesizer

    build = jax_cli.build_model
    monkeypatch.setattr(jax_cli, "build_model",
                        lambda meta: build(meta).clone(dtype=jnp.float32))
    ref_synth = JaxSynthesizer(bundles / "ar", bundles / "nar", max_ar_steps=STEPS,
                               temperature=temperature, nar_temperature=0.0, bf16=False,
                               max_batch=3)
    synth = _port(bundles, temperature=temperature, nar_temperature=0.0)
    rows = _rows(synth)
    if temperature > 0:
        rs = np.random.RandomState(3)
        tables = {(i, 1): rs.gumbel(size=(3, STOP + 1)).astype(np.float32)
                  for i in range(STEPS + 1)}
        for tab in tables.values():
            tab[:, STOP] = -50.0
        tables[(9, 1)][1, STOP] = 50.0  # row 1 stops at step 9
        jax.clear_caches()
        patch_jax_noise(monkeypatch, jax_ar, tables)
        monkeypatch.setattr(serve.RowKeys, "from_seeds", lambda seeds: _Stages(tables))
    try:
        ref = ref_synth._device_batch([dict(r) for r in rows], [1, 2], want_wav=False)[0]
    finally:
        jax.clear_caches()
    got, wavs = synth._device_batch(rows, [1, 2], want_wav=False)
    assert wavs is None and len(got) == len(ref) == 2
    want_lens = [STEPS, 9] if temperature > 0 else [STEPS, STEPS]
    assert [len(c) for c in got] == [len(c) for c in ref] == want_lens
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
        assert g.shape[1] == 8 and g.min() >= 0 and g.max() < 1024


def test_codes_do_not_depend_on_the_cohort(bundles):
    synth = _port(bundles)
    rows = _rows(synth, seed=1, n=3)
    alone = synth.synthesize_codes_batch([rows[2]], [7])[0]
    together = synth.synthesize_codes_batch(rows, [5, 6, 7])[2]
    np.testing.assert_array_equal(alone, together)


def test_speculative_serving_equals_plain_at_temperature_0(bundles):
    plain = _port(bundles, temperature=0.0)
    spec = _port(bundles, temperature=0.0, draft_ckpt=bundles / "draft", spec_k=3)
    assert spec.decode == "ar speculative" and plain.decode == "ar"
    rows = _rows(plain)
    for a, b in zip(plain.synthesize_codes_batch(rows, [1, 2]),
                    spec.synthesize_codes_batch(rows, [1, 2])):
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def small_codec():
    model = smoke.tiny_models()[3]
    init_seeded(model, 2)
    return Codec(model, "cpu")


def _cli(bundles, out, *extra):
    ref = smoke.reference_wavs(1, 0.5, seed=21)[0]
    return ["she said hello", str(ref), str(out), "--device", "cpu", "--seed", "3",
            "--ar-ckpt", str(bundles / "ar"), "--nar-ckpt", str(bundles / "nar"),
            "--max-ar-steps", "12", "--temperature", "0", *extra]


@pytest.mark.parametrize("draft", [False, True])
def test_cli_on_an_ar_bundle(bundles, tmp_path, monkeypatch, small_codec, draft):
    """The CLI serves the AR bundle (a small codec stands in for the full
    one, whose decode would dominate); with ``--draft-ckpt`` through the
    speculative loop, to the same wav at temperature 0."""
    from tts_with_diffusion_model_tpu_torch.__main__ import main
    from tts_with_diffusion_model_tpu_torch.audio.wavio import read_wav
    from tts_with_diffusion_model_tpu_torch.codec import encodec

    monkeypatch.setattr(encodec, "load_codec", lambda *a, **kw: small_codec)
    calls = []
    for name in ("ar_generate", "ar_generate_speculative"):
        real = getattr(serve, name)

        def spy(*a, _real=real, _name=name, **kw):
            calls.append((_name, kw["max_steps"], kw.get("k")))
            return _real(*a, **kw)

        monkeypatch.setattr(serve, name, spy)
    wavs = []
    for use_draft in sorted({False, draft}):
        out = tmp_path / f"out_{use_draft}.wav"
        extra = ["--draft-ckpt", str(bundles / "draft"), "--spec-k", "2"] if use_draft else []
        main(_cli(bundles, out, *extra))
        wav, sr = read_wav(out)
        assert sr == 24000 and wav.shape == (1, 12 * 320) and np.isfinite(wav).all()
        wavs.append(wav)
    want = [("ar_generate", 12, None)] + ([("ar_generate_speculative", 12, 2)] if draft else [])
    assert calls == want
    np.testing.assert_array_equal(wavs[0], wavs[-1])


@pytest.mark.parametrize("case,match", [("nar_draft", "requires AR bundles"),
                                        ("vocab", "must match"),
                                        ("long_text", "long-form")])
def test_cli_refusals(bundles, tmp_path, capsys, monkeypatch, small_codec, case, match):
    from tts_with_diffusion_model_tpu_torch.__main__ import main
    from tts_with_diffusion_model_tpu_torch.codec import encodec

    monkeypatch.setattr(encodec, "load_codec", lambda *a, **kw: small_codec)
    args = _cli(bundles, tmp_path / "out.wav")
    if case == "long_text":  # long-form runs (tests/test_torch_longform.py); a bad budget does not
        args[0] = " ".join(["the quick brown fox jumps over the lazy dog"] * 4)
        extra = ["--segment-phones", "-3"]
    else:
        extra = ["--draft-ckpt", str(bundles / ("nar" if case == "nar_draft" else "ar512"))]
    with pytest.raises(SystemExit) as e:
        main(args + extra)
    assert e.value.code == 2 and match in capsys.readouterr().err


def test_prompt_cache_is_safe_under_four_threads(bundles, small_codec):
    """4 threads × 8 files × 3 rounds through a cache of capacity 4 (a short
    switch interval forces interleaving): the cache never holds more than 4
    (read under its lock after each call), every array equals a
    single-threaded encode, and hits + misses count every call."""
    refs = smoke.reference_wavs(8, 0.2, seed=31)
    base = _port(bundles)
    synth = Synthesizer(base.first, base.nar, small_codec, base.phone_symmap, device="cpu",
                        bf16=False)
    synth.PROM_CACHE_CAP = 4
    alone = Synthesizer(base.first, base.nar, small_codec, base.phone_symmap, device="cpu",
                        bf16=False)
    want = [alone.prompt_codes(r) for r in refs]
    errors, sizes = [], []

    def worker(w):
        try:
            order = np.random.RandomState(w).permutation(8)
            for _ in range(3):
                for i in order:
                    got = synth.prompt_codes(refs[i])
                    with synth._prom_cache_lock:
                        sizes.append(len(synth._prom_cache))
                    if not np.array_equal(got, want[i]):
                        errors.append((w, i))
        except Exception as e:  # recorded and asserted on below
            errors.append(repr(e))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(w,)) for w in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    assert errors == []
    assert len(sizes) == 4 * 3 * 8 and max(sizes) <= 4
    assert synth.prom_cache_hits + synth.prom_cache_misses == 4 * 3 * 8
    assert synth.prom_cache_misses >= 8
