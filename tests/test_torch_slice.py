"""The port's serving slice against the JAX package's, in fp32 on the CPU:
MaskGIT and NAR tokens under the same injected Gumbel noise (the JAX
modules' ``row_gumbel`` / ``fold_rows`` are patched to read a numpy table,
the port reads the same table), per-row cohort independence inside the
port, and the small end-to-end ``Synthesizer``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tts_with_diffusion_model_tpu.models.diffusion as jax_diffusion
import tts_with_diffusion_model_tpu.models.nar as jax_nar
from tts_with_diffusion_model_tpu.models.diffusion import DiffusionConfig as JaxConfig
from tts_with_diffusion_model_tpu.models.diffusion import DiffusionModel as JaxDiffusion
from tts_with_diffusion_model_tpu_torch import smoke
from tts_with_diffusion_model_tpu_torch.convert import jax_params_to_torch
from tts_with_diffusion_model_tpu_torch.models.diffusion import (
    DiffusionConfig,
    DiffusionModel,
    maskgit_schedule,
)
from tts_with_diffusion_model_tpu_torch.models.nar import NAR, nar_generate
from tts_with_diffusion_model_tpu_torch.utils.rng import RowKeys

from torch_port_helpers import (  # noqa: F401 (one_thread: fixture)
    TableKeys,
    one_thread,
    patch_jax_noise,
    perturbed,
    t,
    unflatten,
)

#: tiny models only: one intra-op thread each
pytestmark = pytest.mark.usefixtures("one_thread")

#: the tie rule (ROADMAP.md §3): where the fp32 top-2 margin of the sampled
#: score is below this, either token counts as a match
TIE_MARGIN = 0.1
CFG = dict(n_classes=65, d_model=32, n_heads=2, n_layers=2, timesteps=20,
           resp_len=48, text_len=10, prom_len=16, gen_len=40)
B = 2


def _cond_batch(seed=0):
    rs = np.random.RandomState(seed)
    text = rs.randint(1, 60, (B, CFG["text_len"]))
    tm = np.ones((B, CFG["text_len"]), np.float32)
    tm[1, 6:] = 0
    proms = rs.randint(0, 64, (B, CFG["prom_len"], 8))
    pm = np.ones((B, CFG["prom_len"]), np.float32)
    pm[0, 11:] = 0
    return text, tm, proms, pm


def test_maskgit_schedule_matches():
    jm = JaxDiffusion(JaxConfig(**CFG), dtype=jnp.float32)
    pm = DiffusionModel(DiffusionConfig(**CFG), dtype=torch.float32)
    np.testing.assert_array_equal(pm.d3pm.cum_off, np.asarray(jm.d3pm.cum_off))
    assert pm.d3pm.absorbing_state == jm.d3pm.absorbing_state == 32
    ts, keeps, _ = maskgit_schedule(pm.d3pm, 350, 12)
    assert keeps[-1] == 350 and all(1 <= x <= 19 for x in ts)


@pytest.mark.parametrize("name", ["cosine", "linear", "vpsde"])
def test_beta_schedules_match(name):
    from tts_with_diffusion_model_tpu.diffusion.schedules import get_schedule as jax_schedule
    from tts_with_diffusion_model_tpu_torch.diffusion.schedules import get_schedule

    np.testing.assert_array_equal(get_schedule(name, 101), jax_schedule(name, 101))


@pytest.fixture(scope="module")
def maskgit_pair():
    jm = JaxDiffusion(JaxConfig(**CFG), dtype=jnp.float32)
    flat = perturbed(jax.jit(jm.init)(jax.random.PRNGKey(0)), seed=2)
    pm = DiffusionModel(DiffusionConfig(**CFG), dtype=torch.float32)
    jax_params_to_torch(flat, pm.denoiser)
    return jm, unflatten(flat), pm


@pytest.mark.parametrize("temperature", [1.0, 0.0])
def test_maskgit_tokens_identical_under_injected_noise(monkeypatch, maskgit_pair, temperature):
    steps, bucket = 6, CFG["resp_len"]
    jm, jp, pm = maskgit_pair
    rs = np.random.RandomState(7)
    tables = {}
    for i in range(steps):
        tables[(2 * i, 2)] = rs.gumbel(size=(B, bucket, CFG["n_classes"])).astype(np.float32)
        tables[(2 * i + 1, 1)] = rs.gumbel(size=(B, bucket)).astype(np.float32)
    patch_jax_noise(monkeypatch, jax_diffusion, tables)
    batch = _cond_batch(1)
    ref = np.asarray(jm.generate_maskgit(
        jp, *[jnp.asarray(a) for a in batch], jnp.zeros((B, 2), jnp.uint32),
        steps=steps, temperature=temperature, resp_bucket=bucket))
    got = pm.generate_maskgit(*[t(a) for a in batch], TableKeys(tables), steps=steps,
                              temperature=temperature, resp_bucket=bucket).numpy()
    assert got.shape == ref.shape == (B, bucket)
    np.testing.assert_array_equal(got, ref)
    assert (got[:, CFG["gen_len"]:] == 0).all() and (got[:, : CFG["gen_len"]] != 32).all()


@pytest.fixture(scope="module")
def nar_pair():
    n_tokens, dims = 48, dict(d_model=32, n_heads=2, n_layers=2)
    jn = jax_nar.NAR(n_tokens, dtype=jnp.float32, remat=False, **dims)
    text, tm, proms, pm = _cond_batch(2)
    text, proms = text % n_tokens, proms % n_tokens
    resps = np.zeros((B, 12, 8), np.int64)
    rm = np.ones((B, 12), np.float32)
    params = jax.jit(jn.init)(jax.random.PRNGKey(1), text, tm, proms, pm, resps, rm,
                              jnp.zeros((B,), jnp.int32))
    flat = perturbed(params, seed=4)
    tn = NAR(n_tokens, dtype=torch.float32, **dims)
    jax_params_to_torch(flat, tn)
    return jn, unflatten(flat), tn, (text, tm, proms, pm)


def test_nar_tokens_identical_under_injected_noise(monkeypatch, nar_pair):
    jn, jp, tn, (text, tm, proms, pm) = nar_pair
    Tr, V, temp = 12, 48, 0.2
    rs = np.random.RandomState(9)
    lvl0 = rs.randint(0, V, (B, Tr))
    rm = np.ones((B, Tr), np.float32)
    rm[1, 9:] = 0
    tables = {(n, 2): rs.gumbel(size=(B, Tr, V)).astype(np.float32) for n in range(1, 8)}
    patch_jax_noise(monkeypatch, jax_nar, tables)
    ref = np.asarray(jax_nar.nar_generate(
        jn, jp, *[jnp.asarray(a) for a in (text, tm, proms, pm, lvl0, rm)],
        jnp.zeros((B, 2), jnp.uint32), sampling_temperature=temp))
    got = nar_generate(tn, *[t(a) for a in (text, tm, proms, pm, lvl0, rm)], TableKeys(tables),
                       sampling_temperature=temp).numpy()
    assert got.shape == ref.shape == (B, Tr, 8)
    # level by level, teacher-forced on the JAX package's tokens, with the
    # tie rule on the port's perturbed scores
    buf = t(ref[..., :7])
    for n in range(1, 8):
        logits = tn.forward_level(*[t(a) for a in (text, tm, proms, pm)], buf, t(rm), n)
        score = logits.detach() / temp + t(tables[(n, 2)])
        top2 = score.topk(2, dim=-1).values
        tie = (top2[..., 0] - top2[..., 1]).numpy() < TIE_MARGIN
        mine = torch.where(t(rm) > 0, score.argmax(-1), 0).numpy()
        assert ((mine == ref[..., n]) | tie).all(), f"level {n}"
    np.testing.assert_array_equal(got, ref)


def test_row_keys_are_cohort_independent():
    a = RowKeys.from_seeds([5, 6, 7]).fold(0).fold(3).gumbel((4, 9))
    b = RowKeys.from_seeds([6]).fold(0).fold(3).gumbel((4, 9))
    torch.testing.assert_close(a[1], b[0], rtol=0, atol=0)
    assert not torch.equal(a[0], a[1])
    assert not torch.equal(RowKeys.from_seeds([6]).fold(1).gumbel((4,)),
                           RowKeys.from_seeds([6]).fold(2).gumbel((4,)))


@pytest.fixture(scope="module")
def tiny_synth():
    synth, _ = smoke.build_synthesizer("cpu", "tiny", zoo=False, seed=0, max_batch=2)
    refs = smoke.reference_wavs(2, 0.5, seed=11)
    return synth, refs


def test_synthesizer_codes_do_not_depend_on_the_cohort(tiny_synth):
    synth, refs = tiny_synth
    a = synth.prepare(smoke.TEXTS[0], refs[0])
    b = synth.prepare(smoke.TEXTS[1], refs[1])
    alone = synth.synthesize_codes_batch([a], [3])[0]
    together = synth.synthesize_codes_batch([b, a], [4, 3])[1]
    np.testing.assert_array_equal(alone, together)


def test_small_synthesizer_end_to_end(tiny_synth):
    synth, refs = tiny_synth
    out = synth.synthesize_batch([(smoke.TEXTS[2], refs[0], 1), (smoke.TEXTS[3], refs[1], 2)])
    for wav, sr in out:
        assert sr == 24000 and wav.shape == (synth.gen_len * 320,)
        assert np.isfinite(wav).all()
    # alone, the same request decodes the same codes; the codec's batched
    # convolutions round differently at batch 1, hence the fp32 tolerance
    again, _ = synth.synthesize(smoke.TEXTS[2], refs[0], seed=1)
    np.testing.assert_allclose(again, out[0][0], atol=1e-5)


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        smoke.build_synthesizer("cuda", "tiny", zoo=False, seed=0)


@pytest.fixture(scope="module")
def tiny_bundles(tmp_path_factory):
    """A tiny diffusion bundle (T = 20, gen_len 40) and a tiny NAR bundle,
    written by the JAX package's exporter."""
    from tts_with_diffusion_model_tpu.export import save_bundle

    root = tmp_path_factory.mktemp("bundles")
    dims = dict(d_model=32, n_heads=2, n_layers=2)
    dit_meta = dict(model="diffusion", num_tokens=1024, timesteps=20, resp_len=64, text_len=50,
                    prom_len=64, gen_len=40, **dims)
    jm = JaxDiffusion(JaxConfig(n_classes=1025, **{k: v for k, v in dit_meta.items()
                                                   if k not in ("model", "num_tokens")}))
    symmap = smoke.default_symmap()
    save_bundle(root / "diffusion", jax.jit(jm.init)(jax.random.PRNGKey(0)),
                dit_meta, symmap, {"spk": 0})
    jn = jax_nar.NAR(1024, remat=False, **dims)
    z = np.zeros((1, 4), np.int32)
    nar_p = jax.jit(jn.init)(jax.random.PRNGKey(1), z, z.astype(np.float32), np.zeros((1, 4, 8), np.int32),
                             z.astype(np.float32), np.zeros((1, 4, 8), np.int32),
                             z.astype(np.float32), jnp.zeros((1,), jnp.int32))
    save_bundle(root / "nar", nar_p, dict(model="nar", num_tokens=1024, **dims), symmap, {"spk": 0})
    return root


def _cli_args(bundles, out, *extra):
    ref = smoke.reference_wavs(1, 0.5, seed=12)[0]
    return ["she said hello", str(ref), str(out), "--device", "cpu", "--seed", "3",
            "--ar-ckpt", str(bundles / "diffusion"), "--nar-ckpt", str(bundles / "nar"), *extra]


def test_cli_end_to_end_on_tiny_bundles(tmp_path, tiny_bundles):
    """Bundles written by the JAX package's exporter, read by the port's CLI
    on the CPU (the codec is the committed 24 kHz one when present)."""
    from tts_with_diffusion_model_tpu_torch.__main__ import main
    from tts_with_diffusion_model_tpu_torch.audio.wavio import read_wav

    codec = smoke.REPO / "zoo" / "encodec_24khz.npz"
    out = tmp_path / "out.wav"
    args = _cli_args(tiny_bundles, out, "--maskgit-steps", "4")
    if not codec.exists():
        pytest.skip("zoo/encodec_24khz.npz is not in this checkout")
    main(args + ["--codec", str(codec)])
    wav, sr = read_wav(out)
    assert sr == 24000 and wav.shape == (1, 40 * 320) and np.isfinite(wav).all()


@pytest.mark.parametrize("stride", [1, 3])
def test_synthesizer_ancestral_on_tiny_bundles(tiny_bundles, stride):
    from tts_with_diffusion_model_tpu_torch.codec.encodec import Codec
    from tts_with_diffusion_model_tpu_torch.convert import init_seeded
    from tts_with_diffusion_model_tpu_torch.ops import masked_attention as attn_ops
    from tts_with_diffusion_model_tpu_torch.serve import Synthesizer

    loaded = Synthesizer.from_bundles(tiny_bundles / "diffusion", tiny_bundles / "nar", None,
                                      device="cpu", bf16=False, max_batch=2,
                                      decode="ancestral", stride=stride)
    assert loaded.decode == "ancestral" and loaded.denoiser_calls == (19 if stride == 1 else 7)
    # the same models over a small codec (the full one's decode would dominate)
    small = smoke.tiny_models()[3]
    init_seeded(small, 2)
    synth = Synthesizer(loaded.first, loaded.nar, Codec(small, "cpu"), loaded.phone_symmap,
                        device="cpu", bf16=False, max_batch=2, decode="ancestral",
                        stride=stride)
    refs = smoke.reference_wavs(2, 0.5, seed=13)
    prepared = [synth.prepare(smoke.TEXTS[i], refs[i]) for i in range(2)]
    fn = attn_ops.masked_attention
    fn.plain_calls = 0
    codes, wavs = synth._device_batch(prepared, [5, 6])
    sites = smoke.attention_sites(synth.first.config, smoke.nar_dims_of(synth.nar),
                                  synth.denoiser_calls, synth.prompt_bucket(prepared))
    assert fn.plain_calls == smoke.expected_launches(sites) == 4 + synth.denoiser_calls * 6 + 14
    for c, w in zip(codes, wavs):
        assert c.shape == (40, 8) and 0 <= c.min() and c.max() < 1024
        assert w.shape == (40 * 320,) and np.isfinite(w).all()
    # the same seeds give the same codes, and the first stage is the
    # model's own ancestral chain at the serving bucket with the row keys
    again = synth.synthesize_codes_batch(prepared, [5, 6])
    assert all(np.array_equal(a, b) for a, b in zip(codes, again))
    text, tm = (torch.as_tensor(np.concatenate([r[k] for r in prepared]))
                for k in ("text", "text_mask"))
    pb = synth.prompt_bucket(prepared)
    proms, pm = (torch.as_tensor(np.concatenate([r[k] for r in prepared]))[:, :pb]
                 for k in ("proms", "prom_mask"))
    toks = synth.first.generate(text, tm, proms, pm, RowKeys.from_seeds([5, 6]).fold(0),
                                stride=stride, resp_bucket=synth.resp_bucket)
    np.testing.assert_array_equal(np.stack(codes)[..., 0], toks[:, :40].numpy())


def test_cli_ancestral_stride3_end_to_end(tmp_path, tiny_bundles, monkeypatch):
    from tts_with_diffusion_model_tpu_torch.__main__ import main
    from tts_with_diffusion_model_tpu_torch.audio.wavio import read_wav

    calls = _spy_samplers(monkeypatch)
    out = tmp_path / "out.wav"
    main(_cli_args(tiny_bundles, out, "--decode", "ancestral", "--stride", "3"))
    wav, sr = read_wav(out)
    assert sr == 24000 and wav.shape == (1, 40 * 320) and np.isfinite(wav).all()
    assert calls == [("generate", 3)]


@pytest.mark.parametrize("argv,want", [(["--stride", "3"], ("generate", 3)),
                                       ([], ("generate_maskgit", None)),
                                       (["--decode", "maskgit", "--stride", "3"],
                                        ("generate_maskgit", None))])
def test_cli_stride_alone_selects_ancestral(tmp_path, tiny_bundles, monkeypatch, argv, want):
    from tts_with_diffusion_model_tpu_torch.__main__ import main
    from tts_with_diffusion_model_tpu_torch.serve import resolve_decode

    assert resolve_decode(None, 3) == "ancestral" and resolve_decode(None, 1) == "maskgit"
    calls = _spy_samplers(monkeypatch)
    main(_cli_args(tiny_bundles, tmp_path / "out.wav", "--maskgit-steps", "2", *argv))
    assert calls == [want]


def _spy_samplers(monkeypatch) -> list:
    """Record which first-stage sampler runs (and its stride)."""
    calls = []
    for name in ("generate", "generate_maskgit"):
        real = getattr(DiffusionModel, name)

        def spy(self, *a, _real=real, _name=name, **kw):
            calls.append((_name, kw.get("stride")))
            return _real(self, *a, **kw)

        monkeypatch.setattr(DiffusionModel, name, spy)
    return calls
