"""The port's main path against the JAX package's at full width on the
committed zoo weights, in fp32 on the CPU at B = 1: DiT logits
(``zoo/diffusion``), one NAR level (``zoo/nar``) at the packed serving
length, the AR's training-forward logits (``zoo/ar``) at the gen4c packed
length, the AR's cached decode (prefill, 8 decode steps, 24 greedy tokens
with the 0.1 top-2 tie rule of ROADMAP.md §3), and MaskGIT and ancestral
(stride 3) codes under injected noise.  Logits within 1e-3·max(1, max
|ref|); each test prints its observed max |Δ|."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tts_with_diffusion_model_tpu.models.diffusion as jax_diffusion
from tts_with_diffusion_model_tpu.models import get_model as jax_get_model
from tts_with_diffusion_model_tpu.models.ar import AR as JaxAR
from tts_with_diffusion_model_tpu.models.ar import ar_generate as jax_ar_generate
from tts_with_diffusion_model_tpu.models.diffusion import DiffusionConfig as JaxConfig
from tts_with_diffusion_model_tpu.models.diffusion import DiffusionModel as JaxDiffusion
from tts_with_diffusion_model_tpu.models.nar import NAR as JaxNAR
from tts_with_diffusion_model_tpu_torch.bundle import load_bundle
from tts_with_diffusion_model_tpu_torch.convert import jax_params_to_torch
from tts_with_diffusion_model_tpu_torch.models.ar import ar_generate
from tts_with_diffusion_model_tpu_torch.serve import build_model

from torch_port_helpers import TableKeys, patch_jax_noise, t, unflatten

ZOO = Path(__file__).resolve().parents[1] / "zoo"
TOL = 1e-3  # × max(1, max |ref|): fp32 through 8 or 12 blocks at d512 / d1024
#: the serving shapes: text bucket 50, a 128-frame prompt bucket, the
#: 384-slot response bucket (gen_len 350)
TEXT, PROMPT, RESP, GEN = 50, 128, 384, 350


def _load(bundle: str):
    """(flat fp32 params, meta, port model in fp32 with them loaded)."""
    path = ZOO / bundle
    if not (path / "params.npz").exists():
        pytest.skip(f"zoo/{bundle} is not in this checkout")
    flat, meta, _, _ = load_bundle(path)
    model = build_model(meta, torch.float32)
    jax_params_to_torch(flat, getattr(model, "denoiser", model))
    return flat, meta, model.eval()


def _cond(seed, Tt, Tp, text_valid, prom_valid, n_text=1024):
    rs = np.random.RandomState(seed)
    text = rs.randint(1, n_text, (1, Tt)).astype(np.int32)
    tm = (np.arange(Tt)[None] < text_valid).astype(np.float32)
    proms = rs.randint(0, 1024, (1, Tp, 8)).astype(np.int32)
    pm = (np.arange(Tp)[None] < prom_valid).astype(np.float32)
    return text * tm.astype(np.int32), tm, proms, pm, rs


def _close(got, ref, what):
    err = float(np.abs(got - ref).max())
    bound = TOL * max(1.0, float(np.abs(ref).max()))
    print(f"{what}: max |d| {err:.3g} (bound {bound:.3g}, max |ref| {np.abs(ref).max():.3g})")
    assert err <= bound, (what, err, bound)


def test_zoo_dit_logits_at_the_serving_shapes():
    flat, meta, pm = _load("diffusion")
    c = pm.config
    jm = JaxDiffusion(JaxConfig(n_classes=c.n_classes, d_model=c.d_model, n_heads=c.n_heads,
                                n_layers=c.n_layers, timesteps=c.timesteps), dtype=jnp.float32)
    text, tm, proms, prm, rs = _cond(0, TEXT, PROMPT, 31, 117)
    x = rs.randint(0, c.n_classes, (1, RESP)).astype(np.int32)
    rm = (np.arange(RESP)[None] < GEN).astype(np.float32)
    tt = np.array([37], np.int32)
    ref = np.asarray(jax.jit(jm.denoiser.apply)(unflatten(flat), text, tm, proms, prm, x, rm, tt))
    del flat
    with torch.no_grad():
        got = pm.denoiser(*[t(a).long() if a.dtype.kind == "i" else t(a)
                            for a in (text, tm, proms, prm, x, rm, tt)]).numpy()
    assert got.shape == ref.shape == (1, RESP, c.n_classes)
    _close(got, ref, "zoo/diffusion DiT logits")


def test_zoo_nar_level_at_the_packed_serving_length():
    flat, meta, tn = _load("nar")
    base = tn.base
    jn = JaxNAR(1024, d_model=base.d_model, n_heads=base.blocks()[0].attn.n_heads,
                n_layers=base.n_layers, remat=False, dtype=jnp.float32)
    text, tm, proms, pm, rs = _cond(1, TEXT, PROMPT, 40, 128)
    resps = rs.randint(0, 1024, (1, GEN, 7)).astype(np.int32)
    rm = (np.arange(GEN)[None] < 301).astype(np.float32)
    n_known = 3
    ref = np.asarray(jax.jit(lambda p, *a: jn.apply(p, *a, n_known, method=JaxNAR.forward_level))(
        unflatten(flat), text, tm, proms, pm, resps, rm))
    del flat
    with torch.no_grad():
        got = tn.forward_level(*[t(a).long() if a.dtype.kind == "i" else t(a)
                                 for a in (text, tm, proms, pm, resps, rm)], n_known).numpy()
    assert got.shape == ref.shape == (1, GEN, 1024)
    assert TEXT + 1 + PROMPT + 1 + GEN == 530
    _close(got, ref, "zoo/nar level-3 logits")


def test_zoo_ar_training_forward_at_the_gen4c_packed_length():
    """The gen4c recipe's packed layout: text 64 | sep | prompt 512 | sep |
    response 192 = 770 slots, causal, LayerNorm blocks, the stop-token head."""
    flat, meta, ta = _load("ar")
    ja = jax_get_model(meta["model"], meta["num_tokens"], {"remat": False}, dtype=jnp.float32)
    text, tm, proms, pm, rs = _cond(2, 64, 512, 52, 430)
    resp = rs.randint(0, 1024, (1, 192)).astype(np.int32)
    rm = (np.arange(192)[None] < 150).astype(np.float32)
    logits, losses = jax.jit(lambda p, *a: ja.apply(p, *a, deterministic=True))(
        unflatten(flat), text, tm, proms, pm, resp * rm.astype(np.int32), rm)
    ref, ref_loss = np.asarray(logits), float(losses["nll"])
    del flat, logits
    with torch.no_grad():
        got, got_losses = ta(*[t(a).long() if a.dtype.kind == "i" else t(a)
                               for a in (text, tm, proms, pm, resp * rm.astype(np.int32), rm)])
    assert got.shape == ref.shape == (1, 770, 1025)
    _close(got.numpy(), ref, "zoo/ar training-forward logits")
    np.testing.assert_allclose(got_losses["nll"].item(), ref_loss, rtol=1e-4)


#: the top-2 margin below which either token counts as a match (ROADMAP.md §3)
TIE_MARGIN = 0.1


def test_zoo_ar_cached_decode_and_greedy_tokens():
    """``zoo/ar`` at the serving buckets (text 50 with 30 valid, prompt 128
    with 100 valid), B = 1: the prefill's last logits and 8 decode steps'
    logits along JAX's greedy tokens, then 24 greedy tokens of
    ``ar_generate``, identical up to a top-2 tie of the port's logits."""
    flat, meta, ta = _load("ar")
    ja = jax_get_model(meta["model"], meta["num_tokens"], {"remat": False}, dtype=jnp.float32)
    jp = unflatten(flat)
    del flat
    text, tm, proms, pm, _ = _cond(5, TEXT, PROMPT, 30, 100)
    n_steps, P = 24, TEXT + 1 + PROMPT + 1
    ref_toks, ref_lens = jax_ar_generate(ja, jp, *[jnp.asarray(a) for a in (text, tm, proms, pm)],
                                         jax.random.PRNGKey(0), max_steps=n_steps,
                                         sampling_temperature=0.0)
    ref_toks = np.array(ref_toks)
    prefill = jax.jit(lambda p, *a: ja.apply(p, *a, P + 8, method=JaxAR.prefill))
    step = jax.jit(lambda p, tok, c: ja.apply(p, tok, c, method=JaxAR.decode_step))
    ref_logits, ref_cache = prefill(jp, text, tm, proms, pm)
    refs = [np.asarray(ref_logits)]
    for j in range(8):
        lg, ref_cache = step(jp, ref_toks[:, j], ref_cache)
        refs.append(np.asarray(lg))
    del jp, ref_cache
    port = [t(a).long() if a.dtype.kind == "i" else t(a) for a in (text, tm, proms, pm)]
    with torch.no_grad():
        logits, cache = ta.prefill(*port, P + 8)
        gots = [logits.numpy()]
        for j in range(8):
            logits, cache = ta.decode_step(torch.as_tensor(ref_toks[:, j]).long(), cache)
            gots.append(logits.numpy())
        _close(np.stack(gots), np.stack(refs), "zoo/ar prefill + 8 decode-step logits")
        toks, lens = ar_generate(ta, *port, None, max_steps=n_steps, sampling_temperature=0.0)
    toks = toks.numpy()
    diff = np.nonzero(toks[0] != ref_toks[0])[0]
    print(f"zoo/ar greedy: {n_steps - len(diff)} of {n_steps} tokens identical")
    if len(diff):  # a tie of the port's logits at the first divergence
        d = int(diff[0])
        with torch.no_grad():
            full, _ = ta(*port, torch.as_tensor(ref_toks[:, :d]).long(), torch.ones(1, d))
        top2 = full[0, P - 1 + d].topk(2).values
        assert float(top2[0] - top2[1]) < TIE_MARGIN, (d, toks[0], ref_toks[0])
    else:
        assert int(lens[0]) == int(ref_lens[0])


def test_zoo_maskgit_codes_under_injected_noise(monkeypatch):
    """The serving default of 12 MaskGIT steps at the serving bucket, the
    same Gumbel tables on both sides.  Every code is identical, so the 0.1
    top-2 tie rule of the NAR's token test (``test_torch_slice.py``) would
    loosen nothing here, and the stricter identity is asserted."""
    flat, meta, pm = _load("diffusion")
    c = pm.config
    jm = JaxDiffusion(JaxConfig(n_classes=c.n_classes, d_model=c.d_model, n_heads=c.n_heads,
                                n_layers=c.n_layers, timesteps=c.timesteps), dtype=jnp.float32)
    steps = 12
    text, tm, proms, prm, rs = _cond(3, TEXT, PROMPT, 25, 96)
    tables = {}
    for i in range(steps):
        tables[(2 * i, 2)] = rs.gumbel(size=(1, RESP, c.n_classes)).astype(np.float32)
        tables[(2 * i + 1, 1)] = rs.gumbel(size=(1, RESP)).astype(np.float32)
    patch_jax_noise(monkeypatch, jax_diffusion, tables)
    ref = np.asarray(jm.generate_maskgit(
        {"params": unflatten(flat)["params"]}, *[jnp.asarray(a) for a in (text, tm, proms, prm)],
        jnp.zeros((1, 2), jnp.uint32), steps=steps, temperature=1.0, resp_bucket=RESP))
    del flat
    with torch.no_grad():
        got = pm.generate_maskgit(*[t(a).long() if a.dtype.kind == "i" else t(a)
                                    for a in (text, tm, proms, prm)], TableKeys(tables),
                                  steps=steps, temperature=1.0, resp_bucket=RESP).numpy()
    assert got.shape == ref.shape == (1, RESP)
    same = float((got == ref).mean())
    print(f"zoo/diffusion MaskGIT: {same:.4f} of {RESP} codes identical")
    np.testing.assert_array_equal(got, ref)


def test_zoo_ancestral_stride3_codes_under_injected_noise(monkeypatch):
    """The ancestral chain at stride 3 (33 denoiser calls, t = 99, 96, …, 3)
    at the serving bucket, the same uniform tables on both sides, keyed by
    the process timestep."""
    flat, meta, pm = _load("diffusion")
    c = pm.config
    jm = JaxDiffusion(JaxConfig(n_classes=c.n_classes, d_model=c.d_model, n_heads=c.n_heads,
                                n_layers=c.n_layers, timesteps=c.timesteps), dtype=jnp.float32)
    steps = list(range(c.timesteps - 1, 0, -3))
    assert len(steps) == 33
    text, tm, proms, prm, rs = _cond(4, TEXT, PROMPT, 33, 110)
    tables = {(ti, 2): rs.uniform(size=(1, RESP, c.n_classes)).astype(np.float32)
              for ti in steps}
    patch_jax_noise(monkeypatch, jax_diffusion, tables)
    ref = np.asarray(jm.generate(
        {"params": unflatten(flat)["params"]}, *[jnp.asarray(a) for a in (text, tm, proms, prm)],
        jnp.zeros((1, 2), jnp.uint32), stride=3, resp_bucket=RESP))
    del flat
    with torch.no_grad():
        got = pm.generate(*[t(a).long() if a.dtype.kind == "i" else t(a)
                            for a in (text, tm, proms, prm)], TableKeys(tables),
                          stride=3, resp_bucket=RESP).numpy()
    assert got.shape == ref.shape == (1, RESP)
    print(f"zoo/diffusion ancestral stride 3: {float((got == ref).mean()):.4f} of {RESP} "
          "codes identical")
    np.testing.assert_array_equal(got, ref)
    assert (got[0, GEN:] == 0).all()
