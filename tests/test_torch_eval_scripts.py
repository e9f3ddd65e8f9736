"""The port's evaluation entry points against the JAX repository's scripts
(``scripts/{heldout_eval,speaker_transfer_eval,quality_gate,
longform_seam_eval}.py``, loaded with ``importlib`` and run through their
own ``main``), on one tiny corpus (``make_gen_corpus.py``, 3 speakers × 11
utterances, coded by a seeded tiny codec) and tiny seeded bundles:

- *select*: the same picks, prompts and input arrays (read where the JAX
  script hands them to its first stage and NAR);
- *score*: the same JSON, numbers within 1e-9, from the same codes (both
  sides' first stage and NAR replaced by the same injected codes, both
  sides' codec by the port's tiny codec);
- the AR at temperature 0 (fp32 on both sides): identical codes and
  lengths, then the same JSON.

Each port entry point runs end to end in the chip phase's rehearsal
(``test_torch_smoke_codec.py``); here ``quality_gate``'s exit codes."""

import importlib.util
import json
import os
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tts_with_diffusion_model_tpu_torch.scripts import (heldout_eval, longform_seam_eval,
                                                        quality_gate, speaker_transfer_eval)

REPO = Path(__file__).resolve().parents[1]
#: numbers in the JSON of the two packages, from the same codes
TOL = 1e-9
CODEC = dict(dimension=16, n_filters=4, n_q_total=8)


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(f"jax_script_{name}",
                                                  REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _close(got, ref, where="json"):
    """Same structure and strings; numbers within ``TOL``."""
    if isinstance(ref, dict):
        assert list(got) == list(ref), where
        for k in ref:
            _close(got[k], ref[k], f"{where}.{k}")
    elif isinstance(ref, list):
        assert len(got) == len(ref), where
        for i, (a, b) in enumerate(zip(got, ref)):
            _close(a, b, f"{where}[{i}]")
    elif isinstance(ref, bool) or ref is None or isinstance(ref, str):
        assert got == ref, (where, got, ref)
    else:
        assert abs(got - ref) <= TOL * max(1.0, abs(ref)), (where, got, ref)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The corpus, its codes, fp32 tiny bundles and the tiny codec."""
    from tts_with_diffusion_model_tpu_torch.codec.encodec import load_codec
    from tts_with_diffusion_model_tpu_torch.emb import qnt
    from tts_with_diffusion_model_tpu_torch.smoke_codec import write_corpus, write_seeded_codec
    from tts_with_diffusion_model_tpu_torch.smoke_serve import write_seeded_bundles

    root = tmp_path_factory.mktemp("evals")
    data = write_corpus(root / "data", 3, 11)
    codec_file = write_seeded_codec(root / "codec.npz", 3, CODEC)
    old = os.environ.get("ENCODEC_WEIGHTS")
    os.environ["ENCODEC_WEIGHTS"] = str(codec_file)
    try:
        qnt.main([str(data), "--device", "cpu"])
    finally:
        os.environ.pop("ENCODEC_WEIGHTS") if old is None else os.environ.update(
            ENCODEC_WEIGHTS=old)
    bundles = write_seeded_bundles(root / "bundles", "tiny", 4)
    for b in bundles:  # fp32 on both sides
        with np.load(b / "params.npz") as z:
            np.savez(b / "params.npz", **{k: z[k].astype(np.float32) for k in z.files})
    codec = load_codec(codec_file, device="cpu")
    jax_codec = SimpleNamespace(encode=codec.encode, decode=codec.decode)
    return SimpleNamespace(root=root, data=data, codec=codec, jax_codec=jax_codec,
                           d3pm=str(bundles[0]), nar=str(bundles[1]), ar=str(bundles[2]),
                           d3pm_cfg=[f"yaml={REPO / 'config/gen4c/diffusion.yml'}",
                                     f"data_dirs=[{data}]"],
                           ar_cfg=[f"yaml={REPO / 'config/gen4c/ar.yml'}", f"data_dirs=[{data}]"])


@pytest.fixture
def jax_codec(world, monkeypatch):
    """The JAX package's ``emb.qnt`` encoding and decoding with the port's
    tiny codec."""
    from tts_with_diffusion_model_tpu.emb import qnt as jqnt

    monkeypatch.setattr(jqnt, "load_codec", lambda *a, **k: world.jax_codec)


def _np(*arrays):
    return [np.asarray(a) for a in arrays]


def test_heldout_select_and_score_match_jax(world, jax_codec, monkeypatch, tmp_path):
    from tts_with_diffusion_model_tpu.models import nar as jnar
    from tts_with_diffusion_model_tpu.models.diffusion import DiffusionModel as JaxDiffusion
    from tts_with_diffusion_model_tpu_torch.models import nar as tnar
    from tts_with_diffusion_model_tpu_torch.serve import load_model

    bucket, rs = 64, np.random.RandomState(5)
    level0 = rs.randint(0, 1024, (8, bucket))
    codes = rs.randint(0, 1024, (8, bucket, 8))
    seen = {}

    def jax_generate(self, params, text, tm, pr, pm, key, gen_len, resp_bucket):
        seen["jax_gen"] = (gen_len, resp_bucket)
        return jnp.asarray(level0[: text.shape[0]])

    def jax_nar(model, params, *args, sampling_temperature):
        seen["jax_nar"] = _np(*args[:6])
        return jnp.asarray(codes[: args[0].shape[0]])

    monkeypatch.setattr(JaxDiffusion, "generate", jax_generate)
    monkeypatch.setattr(jnar, "nar_generate", jax_nar)
    argv = [world.d3pm, "--nar-bundle", world.nar, "--n", "8", "--resp-bucket", str(bucket),
            *world.d3pm_cfg]
    monkeypatch.setattr(sys, "argv", ["heldout_eval.py", *argv, "--out", str(tmp_path / "j.json")])
    _jax_script("heldout_eval").main()
    ref = json.loads((tmp_path / "j.json").read_text())

    cfg, args = heldout_eval.parse_args([*argv, "--out", str(tmp_path / "p.json"), "--device",
                                         "cpu"])
    first, phones = load_model(world.d3pm, torch.float32)
    nar, _ = load_model(world.nar, torch.float32)
    text_len, prom_len, gl = heldout_eval.buckets(cfg, first, False, bucket)
    sel = heldout_eval.select(cfg, phones, 8, 0, text_len, prom_len)
    assert [str(p) for p in sel.picks] == [u["path"] for u in ref["per_utt"]]
    assert seen["jax_gen"] == (gl, bucket)

    first.generate = lambda *a, **kw: torch.as_tensor(level0[: len(sel.picks)])

    def port_nar(model, *args, sampling_temperature):
        seen["port_nar"] = [a.numpy() for a in args[:6]]
        return torch.as_tensor(codes[: args[0].shape[0]])

    monkeypatch.setattr(tnar, "nar_generate", port_nar)
    got_codes, lens = heldout_eval.generate(first, nar, sel, is_ar=False, bucket=bucket, gl=gl)
    assert lens is None
    for a, b in zip(seen["port_nar"], seen["jax_nar"]):
        np.testing.assert_array_equal(a, b)
    per_utt, mean = heldout_eval.score(sel, got_codes, None, gl, world.codec)
    summary = heldout_eval.summarize(args, {"model": "diffusion"}, len(sel.picks), mean, False)
    _close(json.loads(json.dumps({"summary": summary, "per_utt": per_utt}, default=str)), ref)


def test_heldout_ar_greedy_codes_match_jax(world, jax_codec, monkeypatch, tmp_path):
    """The AR and the NAR at temperature 0 in fp32: the JAX script's codes
    and lengths (read at its NAR's output), the port's generate's, then the
    same JSON."""
    import tts_with_diffusion_model_tpu.__main__ as jmain
    from tts_with_diffusion_model_tpu.models import ar as jar
    from tts_with_diffusion_model_tpu.models import nar as jnar
    from tts_with_diffusion_model_tpu_torch.serve import load_model

    real_build, real_nar, real_ar = jmain.build_model, jnar.nar_generate, jar.ar_generate
    seen = {}
    monkeypatch.setattr(jmain, "build_model",
                        lambda meta: real_build(meta).clone(dtype=jnp.float32, remat=False))

    def ar_generate(*a, **kw):
        seen["toks"], seen["lens"] = _np(*real_ar(*a, **kw))
        return seen["toks"], seen["lens"]

    def nar_generate(*a, **kw):
        seen["codes"] = np.asarray(real_nar(*a, **kw))
        return seen["codes"]

    monkeypatch.setattr(jar, "ar_generate", ar_generate)
    monkeypatch.setattr(jnar, "nar_generate", nar_generate)
    bucket = 24
    argv = [world.ar, "--nar-bundle", world.nar, "--n", "8", "--resp-bucket", str(bucket),
            "--ar-temperature", "0", "--nar-temperature", "0", *world.ar_cfg]
    monkeypatch.setattr(sys, "argv", ["heldout_eval.py", *argv, "--out", str(tmp_path / "j.json")])
    _jax_script("heldout_eval").main()
    jax.clear_caches()
    ref = json.loads((tmp_path / "j.json").read_text())

    cfg, args = heldout_eval.parse_args([*argv, "--out", str(tmp_path / "p.json"), "--device",
                                         "cpu"])
    first, phones = load_model(world.ar, torch.float32)
    nar, _ = load_model(world.nar, torch.float32)
    first, nar = first.eval(), nar.eval()
    text_len, prom_len, gl = heldout_eval.buckets(cfg, first, True, bucket)
    sel = heldout_eval.select(cfg, phones, 8, 0, text_len, prom_len)
    codes, lens = heldout_eval.generate(first, nar, sel, is_ar=True, bucket=bucket, gl=gl,
                                        ar_temperature=0.0, nar_temperature=0.0)
    np.testing.assert_array_equal(lens, np.minimum(seen["lens"], bucket))
    np.testing.assert_array_equal(codes, seen["codes"])
    per_utt, mean = heldout_eval.score(sel, codes, lens, gl, world.codec)
    summary = heldout_eval.summarize(args, {"model": "ar"}, len(sel.picks), mean, True)
    _close(json.loads(json.dumps({"summary": summary, "per_utt": per_utt}, default=str)), ref)


def test_transfer_select_and_score_match_jax(world, jax_codec, monkeypatch, tmp_path):
    """``--nar-bundle``: per generation the same text and prompt, then the
    decode → re-encode of the same injected codes, and the same JSON."""
    from tts_with_diffusion_model_tpu.models import nar as jnar
    from tts_with_diffusion_model_tpu.models.diffusion import DiffusionModel as JaxDiffusion
    from tts_with_diffusion_model_tpu_torch.models import nar as tnar
    from tts_with_diffusion_model_tpu_torch.serve import load_model

    trials, bucket, rs = 3, 48, np.random.RandomState(6)
    level0 = rs.randint(0, 1024, (2 * trials, 1, bucket))
    codes = rs.randint(0, 1024, (2 * trials, 1, bucket, 8))
    jax_in, port_in = [], []

    def jax_generate(self, params, text, tm, proms, pm, key, gen_len, resp_bucket):
        jax_in.append(_np(text, tm, proms, pm) + [gen_len, resp_bucket])
        return jnp.asarray(level0[len(jax_in) - 1])

    def jax_nar(model, params, *args, sampling_temperature):
        return jnp.asarray(codes[len(jax_in) - 1])

    monkeypatch.setattr(JaxDiffusion, "generate", jax_generate)
    monkeypatch.setattr(jnar, "nar_generate", jax_nar)
    monkeypatch.setattr(jax, "jit", lambda f, **kw: f)  # the script's own jit of generate
    argv = [world.d3pm, "--trials", str(trials), "--resp-bucket", str(bucket), "--nar-bundle",
            world.nar, *world.d3pm_cfg]
    monkeypatch.setattr(sys, "argv", ["transfer.py", *argv, "--out", str(tmp_path / "j.json")])
    _jax_script("speaker_transfer_eval").main()
    monkeypatch.undo()
    ref = json.loads((tmp_path / "j.json").read_text())

    cfg, args = speaker_transfer_eval.parse_args([*argv, "--out", str(tmp_path / "p.json"),
                                                  "--device", "cpu"])
    first, phones = load_model(world.d3pm, torch.float32)
    nar, _ = load_model(world.nar, torch.float32)
    c = first.config
    sel = speaker_transfer_eval.select(cfg, phones, trials, 0, c.text_len, c.prom_len)
    gl = min(bucket, c.gen_len)
    for g, want in zip(sel.generations, jax_in):
        for a, b in zip((g.text, g.text_mask, g.proms, g.prom_mask), want[:4]):
            np.testing.assert_array_equal(a, b)
        assert want[4:] == [gl, bucket]
    monkeypatch.setattr(tnar, "nar_generate", lambda *a, **kw: torch.as_tensor(codes[len(port_in) - 1]))
    got = []
    for i, g in enumerate(sel.generations):
        port_in.append(g)
        first.generate = lambda *a, i=i, **kw: torch.as_tensor(level0[i])
        got.append(speaker_transfer_eval.generate(first, g, resp_bucket=bucket, gl=gl, nar=nar,
                                                  codec=world.codec))
    results = speaker_transfer_eval.score(sel, got, args.frames)
    summary = speaker_transfer_eval.summarize(args, sel, results)
    _close(json.loads(json.dumps({"summary": summary, "trials": results})), ref)


def test_quality_gate_select_and_score_match_jax(world, jax_codec, monkeypatch, tmp_path, capsys):
    from tts_with_diffusion_model_tpu.models import nar as jnar
    from tts_with_diffusion_model_tpu.models.diffusion import DiffusionModel as JaxDiffusion
    from tts_with_diffusion_model_tpu_torch.serve import load_model

    wav = sorted(world.data.rglob("*.wav"))[0]
    other = sorted(world.data.rglob("*.wav"))[1]
    text = (wav.parent / (wav.name.split(".")[0] + ".normalized.txt")).read_text().strip()
    rs = np.random.RandomState(7)
    level0 = rs.randint(0, 1024, (1, 400))
    codes = rs.randint(0, 1024, (1, 400, 8))
    seen = {}

    def jax_generate(self, params, text, tm, pr, pm, key, gen_len):
        seen["in"] = _np(text, tm, pr, pm) + [gen_len]
        return jnp.asarray(level0)

    monkeypatch.setattr(JaxDiffusion, "generate", jax_generate)
    monkeypatch.setattr(jnar, "nar_generate",
                        lambda model, params, *a, sampling_temperature: jnp.asarray(
                            codes[:, : a[4].shape[1]]))
    argv = [world.d3pm, str(wav), text, "--prompt-wav", str(other), "--min-acc", "0",
            "--nar-bundle", world.nar]
    monkeypatch.setattr(sys, "argv", ["quality_gate.py", *argv])
    _jax_script("quality_gate").main()
    ref = json.loads(capsys.readouterr().out.splitlines()[0])

    first, phones = load_model(world.d3pm, torch.float32)
    sel = quality_gate.select(first.config, phones, world.codec, wav, text, other)
    for a, b in zip((sel.text, sel.text_mask, sel.proms, sel.prom_mask), seen["in"]):
        np.testing.assert_array_equal(a, b)
    assert seen["in"][4] == sel.n_cmp
    n = sel.n_cmp
    report = quality_gate.score(sel, level0[0, :n], 0.0, "ancestral")
    m = quality_gate.score_full_stack(sel, codes[0, :n], wav, world.codec)
    report["full_stack"] = {k: round(float(v), 4) for k, v in m.items()}
    _close(report, ref)


def test_quality_gate_exit_codes(world, capsys):
    """0 at or above ``--min-acc``, 1 below it (the report printed first
    either way)."""
    argv = [world.d3pm, str(sorted(world.data.rglob("*.wav"))[0]), "the north river",
            "--decode", "maskgit", "--device", "cpu"]
    os.environ["ENCODEC_WEIGHTS"] = str(world.root / "codec.npz")
    try:
        report = quality_gate.main([*argv, "--min-acc", "0"])
        assert report["ok"] and capsys.readouterr().out.splitlines()[-1] == "quality gate OK"
        n = report["tokens_compared"]
        acc = round(report["level0_token_accuracy"] * n) / n  # the unrounded share
        assert quality_gate.main([*argv, "--min-acc", str(acc)])["ok"]
        capsys.readouterr()
        with pytest.raises(SystemExit) as e:
            quality_gate.main([*argv, "--min-acc", str(acc + 1e-6)])
        assert e.value.code == 1
        assert json.loads(capsys.readouterr().out.splitlines()[0])["ok"] is False
    finally:
        os.environ.pop("ENCODEC_WEIGHTS")


def test_longform_seam_score_matches_jax(world, monkeypatch, tmp_path):
    """The same segments' codes, decoded by the same codec: the same
    seam JSON."""
    import tts_with_diffusion_model_tpu.longform as jlong
    import tts_with_diffusion_model_tpu.serve as jserve

    rs = np.random.RandomState(8)
    pieces = [rs.randint(0, 1024, (n, 8)) for n in (30, 41, 26)]

    class Synth:
        def __init__(self, *a, **kw):
            pass

        def decode_codes(self, codes):
            return world.codec.decode(np.asarray(codes).T)

    monkeypatch.setattr(jserve, "Synthesizer", Synth)
    monkeypatch.setattr(jlong, "iter_segment_codes", lambda *a, **kw: iter(pieces))
    monkeypatch.setattr(sys, "argv", ["seam.py", world.d3pm, world.nar, "ref.wav", "--out",
                                      str(tmp_path / "j.json")])
    _jax_script("longform_seam_eval").main()
    ref = json.loads((tmp_path / "j.json").read_text())
    got = longform_seam_eval.score(pieces, Synth().decode_codes)
    _close(json.loads(json.dumps(got)), ref)
