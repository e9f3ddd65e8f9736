"""The port's AR decode paths against the JAX package's, in fp32 on the CPU
with a tiny AR (d32, 2 blocks, B = 2, text and prompt pads mid-row) and
flax parameters carried over with seeded noise on top:

- ``prefill``: the last logits and the cache (k, v at valid slots, mask,
  index, pos) within 1e-5;
- ``decode_step`` logits along a teacher-forced sequence, and
  ``decode_chunk`` against JAX's and against the port's own sequential
  steps, within 1e-5; the cached decode against a full teacher-forced
  forward within 1e-5;
- reading only ``cache[:, :index + W]``: the full cache's masked slots get
  probability exactly 0, the outputs agree within fp32 rounding (2e-6; the
  reductions' blocking depends on the length, so not bit for bit) and the
  greedy tokens are identical;
- ``ar_generate`` and ``ar_generate_speculative`` tokens, lengths and stats
  identical to JAX's at temperature 0 and under injected noise tables
  (JAX's noise is drawn inside ``jit``: its caches are cleared around each
  patched call); the early exit against the full loop; greedy speculative
  equal to plain greedy for a random and a perfect draft."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tts_with_diffusion_model_tpu.models.ar as jax_ar
from tts_with_diffusion_model_tpu.models.ar import AR as JaxAR
from tts_with_diffusion_model_tpu_torch.convert import jax_params_to_torch
from tts_with_diffusion_model_tpu_torch.models import ar as port_ar
from tts_with_diffusion_model_tpu_torch.models.ar import (
    AR,
    ar_generate,
    ar_generate_speculative,
)
from tts_with_diffusion_model_tpu_torch.ops.attention import NEG_INF, dense_attention

from torch_port_helpers import (  # noqa: F401 (one_thread: fixture)
    TableKeys,
    one_thread,
    patch_jax_noise,
    perturbed,
    t,
    unflatten,
)

pytestmark = pytest.mark.usefixtures("one_thread")

TOL = 1e-5  # fp32 through two blocks, sums in another order
N_TOKENS = 48
V = N_TOKENS + 1  # the stop token
STOP = N_TOKENS
B, TT, TP = 2, 6, 8
DIMS = dict(d_model=32, n_heads=2, n_layers=2)
ZERO_KEYS = jnp.zeros((B, 2), jnp.uint32)


def _cond(seed=0):
    """Text and prompt pads in the middle of the packed row (row 1 has 4 of
    6 phones, row 0 5 of 8 prompt frames)."""
    rs = np.random.RandomState(seed)
    text = rs.randint(1, N_TOKENS, (B, TT)).astype(np.int32)
    tm = np.ones((B, TT), np.float32)
    tm[1, 4:] = 0
    proms = rs.randint(0, N_TOKENS, (B, TP, 8)).astype(np.int32)
    pm = np.ones((B, TP), np.float32)
    pm[0, 5:] = 0
    return text * tm.astype(np.int32), tm, proms, pm


@functools.cache
def _pair(seed: int, n_layers: int = 2):
    """(JAX AR, its params, port AR with the same weights), fp32, no dropout."""
    dims = dict(DIMS, n_layers=n_layers)
    ja = JaxAR(N_TOKENS, dtype=jnp.float32, remat=False, p_dropout=0.0, **dims)
    text, tm, proms, pm = _cond()
    params = jax.jit(ja.init)(jax.random.PRNGKey(seed), text, tm, proms, pm,
                              np.zeros((B, 4), np.int32), np.ones((B, 4), np.float32))
    flat = perturbed(params, seed=seed + 10)
    ta = AR(N_TOKENS, dtype=torch.float32, remat=False, p_dropout=0.0, **dims).eval()
    jax_params_to_torch(flat, ta)
    return ja, unflatten(flat), ta


def _port_cond(seed=0):
    text, tm, proms, pm = _cond(seed)
    return t(text).long(), t(tm), t(proms).long(), t(pm)


@pytest.fixture
def fresh_jax():
    """JAX draws the noise inside ``jit``: clear its caches around a patched
    call, so neither the patched trace nor an unpatched one is reused."""
    jax.clear_caches()
    yield
    jax.clear_caches()


def _close(got, ref, what, tol=TOL):
    err = float(np.abs(np.asarray(got) - np.asarray(ref)).max())
    assert err <= tol, (what, err)


def _jax_prefill(ja, jp, total):
    text, tm, proms, pm = _cond()
    return jax.jit(lambda p, *a: ja.apply(p, *a, total, method=JaxAR.prefill))(
        jp, text, tm, proms, pm)


def _valid(cache_mask):
    return np.asarray(cache_mask) > 0


def test_prefill_matches_jax():
    ja, jp, ta = _pair(0)
    text, tm, proms, pm = _cond()
    total = TT + 1 + TP + 1 + 5
    ref_logits, ref = _jax_prefill(ja, jp, total)
    logits, cache = ta.prefill(*_port_cond(), total)
    _close(logits.numpy(), ref_logits, "last logits")
    assert logits.shape == (B, V)
    np.testing.assert_array_equal(cache.mask.numpy(), np.asarray(ref["mask"]))
    assert cache.index == int(ref["index"]) == TT + 1 + TP + 1
    np.testing.assert_array_equal(cache.pos.numpy(), np.asarray(ref["pos"]))
    valid = _valid(ref["mask"])
    assert not valid.all() and valid.sum() == int(np.asarray(ref["pos"]).sum())
    for i in range(DIMS["n_layers"]):
        for name, got in (("k", cache.k[i]), ("v", cache.v[i])):
            assert got.shape == (B, total, 2, 16)
            _close(got.numpy()[valid], np.asarray(ref[name][i])[valid], f"{name}[{i}]")


def _teacher_tokens(n, seed=3):
    return np.random.RandomState(seed).randint(0, V, (B, n)).astype(np.int32)


def test_decode_steps_match_jax_along_a_teacher_forced_sequence():
    ja, jp, ta = _pair(0)
    text, tm, proms, pm = _cond()
    n = 6
    total = TT + 1 + TP + 1 + n
    toks = _teacher_tokens(n)
    _, ref = _jax_prefill(ja, jp, total)
    _, cache = ta.prefill(*_port_cond(), total)
    step = jax.jit(lambda p, tok, c: ja.apply(p, tok, c, method=JaxAR.decode_step))
    for j in range(n):
        ref_logits, ref = step(jp, toks[:, j], ref)
        logits, cache = ta.decode_step(t(toks[:, j]).long(), cache)
        _close(logits.numpy(), ref_logits, f"step {j}")
    assert cache.index == int(ref["index"]) == total
    np.testing.assert_array_equal(cache.pos.numpy(), np.asarray(ref["pos"]))
    np.testing.assert_array_equal(cache.mask.numpy(), np.asarray(ref["mask"]))
    valid = _valid(ref["mask"])
    for i in range(DIMS["n_layers"]):
        _close(cache.k[i].numpy()[valid], np.asarray(ref["k"][i])[valid], f"k[{i}]")


def test_decode_chunk_matches_jax_and_sequential_steps():
    """After two steps, a chunk of W = 4: JAX's ``decode_chunk``, and the
    port's own steps over the same tokens (mirrors ``tests/test_ar_spec.py``)."""
    ja, jp, ta = _pair(0)
    text, tm, proms, pm = _cond()
    W = 4
    total = TT + 1 + TP + 1 + 2 + W
    toks = _teacher_tokens(2 + W)
    _, ref = _jax_prefill(ja, jp, total)
    _, cache = ta.prefill(*_port_cond(), total)
    step = jax.jit(lambda p, tok, c: ja.apply(p, tok, c, method=JaxAR.decode_step))
    for j in range(2):
        _, ref = step(jp, toks[:, j], ref)
        _, cache = ta.decode_step(t(toks[:, j]).long(), cache)
    chunk = toks[:, 2:]
    _, seq = ta.prefill(*_port_cond(), total)
    for j in range(2):
        _, seq = ta.decode_step(t(toks[:, j]).long(), seq)
    seq_logits = []
    for j in range(W):
        lg, seq = ta.decode_step(t(chunk[:, j]).long(), seq)
        seq_logits.append(lg)
    ref_logits, ref = jax.jit(lambda p, *a: ja.apply(p, *a, method=JaxAR.decode_chunk))(
        jp, chunk, ref["pos"], ref)
    logits, cache = ta.decode_chunk(t(chunk).long(), cache.pos.clone(), cache)
    assert logits.shape == (B, W, V)
    _close(logits.numpy(), ref_logits, "chunk vs JAX")
    _close(logits.numpy(), torch.stack(seq_logits, 1).numpy(), "chunk vs steps")
    assert cache.index == seq.index == int(ref["index"])
    np.testing.assert_array_equal(cache.mask.numpy(), seq.mask.numpy())
    np.testing.assert_array_equal(cache.mask.numpy(), np.asarray(ref["mask"]))
    np.testing.assert_array_equal(cache.pos.numpy(), seq.pos.numpy())


def test_cached_decode_matches_a_full_teacher_forced_forward():
    """The reference's full-prefix recompute as the oracle (mirrors
    ``tests/test_models_base.py``): the logits that predict every response
    token, from the cache and from one causal forward over the sequence."""
    _, _, ta = _pair(0)
    text, tm, proms, pm = _port_cond()
    n = 5
    toks = torch.as_tensor(_teacher_tokens(n, seed=4) % N_TOKENS).long()
    first, cache = ta.prefill(text, tm, proms, pm, TT + 1 + TP + 1 + n)
    cached = [first]
    for j in range(n - 1):
        lg, cache = ta.decode_step(toks[:, j], cache)
        cached.append(lg)
    with torch.no_grad():
        full, _ = ta(text, tm, proms, pm, toks, torch.ones(B, n))
    P = TT + 1 + TP + 1
    _close(torch.stack(cached, 1).numpy(), full[:, P - 1:P - 1 + n].numpy(), "cached vs full")


def _attend_cut_and_full(W):
    """One block's cached attention after prefill and 3 steps: reading
    ``cache[:, :index + W]`` and reading the whole cache."""
    _, _, ta = _pair(0)
    total = TT + 1 + TP + 1 + 3 + W + 20
    _, cache = ta.prefill(*_port_cond(), total)
    for j in range(3):
        _, cache = ta.decode_step(torch.full((B,), j + 1), cache)
    attn = ta.base.blocks()[1].attn
    x = torch.randn(B, W, DIMS["d_model"], generator=torch.Generator().manual_seed(W))
    qkv = attn._qkv(x)
    n = cache.index + W
    ck, cv = cache.k[1].clone(), cache.v[1].clone()
    ck[:, cache.index:n], cv[:, cache.index:n] = qkv[:, :, 1], qkv[:, :, 2]
    mask = cache.mask.clone()
    mask[:, cache.index:n] = 1
    slot = torch.arange(total)
    pair = mask[:, None, :] * (slot[None, :] <= cache.index + torch.arange(W)[:, None])
    q = qkv[:, :, 0]
    cut = dense_attention(q, ck[:, :n], cv[:, :n], pair_mask=pair[:, :, :n])
    full = dense_attention(q, ck, cv, pair_mask=pair)
    scores = torch.einsum("bihd,bjhd->bhij", q, ck) * q.shape[-1] ** -0.5
    probs = torch.softmax(torch.where(pair[:, None].bool(), scores, NEG_INF), dim=-1)
    return cut, full, probs, n


@pytest.mark.parametrize("W", [1, 4])
def test_reading_only_the_filled_slots_changes_nothing_but_rounding(W):
    cut, full, probs, n = _attend_cut_and_full(W)
    assert (probs[..., n:] == 0).all()  # exp(NEG_INF - max) is exactly 0
    assert cut.shape == full.shape == (B, W, 2, 16)
    _close(cut.detach().numpy(), full.detach().numpy(), "cut vs full", tol=2e-6)


def test_greedy_tokens_equal_with_the_whole_cache_read(monkeypatch):
    """``ar_generate`` at temperature 0 with ``Attention.decode`` reading the
    whole cache gives the same tokens as reading the filled slots."""
    from tts_with_diffusion_model_tpu_torch.models import base

    _, _, ta = _pair(0)
    cut = ar_generate(ta, *_port_cond(), None, max_steps=12, sampling_temperature=0.0)

    def decode_full(self, x, cache_k, cache_v, index, kv_mask):
        Bq, W, _ = x.shape
        qkv = self._qkv(x)
        cache_k[:, index:index + W], cache_v[:, index:index + W] = qkv[:, :, 1], qkv[:, :, 2]
        slot = torch.arange(cache_k.shape[1])
        pair = kv_mask[:, None, :] * (slot[None, :] <= index + torch.arange(W)[:, None])
        o = dense_attention(qkv[:, :, 0], cache_k, cache_v, pair_mask=pair)
        return self.to_out(o.reshape(Bq, W, self.d_model))

    monkeypatch.setattr(base.Attention, "decode", decode_full)
    full = ar_generate(ta, *_port_cond(), None, max_steps=12, sampling_temperature=0.0)
    for a, b in zip(cut, full):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def _gumbel_tables(max_steps, seed=5, stop_row1_at=None):
    """Gumbel noise for every step (tag i), with the stop token held off
    (−50) except where ``stop_row1_at`` puts +50 on it for row 1."""
    rs = np.random.RandomState(seed)
    tables = {(i, 1): rs.gumbel(size=(B, V)).astype(np.float32) for i in range(max_steps + 1)}
    for tab in tables.values():
        tab[:, STOP] = -50.0
    if stop_row1_at is not None:
        tables[(stop_row1_at, 1)][1, STOP] = 50.0
    return tables


def _jax_generate(ja, jp, max_steps, temperature):
    text, tm, proms, pm = _cond()
    toks, lens = jax_ar.ar_generate(ja, jp, *[jnp.asarray(a) for a in (text, tm, proms, pm)],
                                    ZERO_KEYS, max_steps=max_steps,
                                    sampling_temperature=temperature)
    return np.asarray(toks), np.asarray(lens)


def test_ar_generate_greedy_matches_jax():
    ja, jp, ta = _pair(0)
    ref_toks, ref_lens = _jax_generate(ja, jp, 12, 0.0)
    toks, lens = ar_generate(ta, *_port_cond(), None, max_steps=12, sampling_temperature=0.0)
    np.testing.assert_array_equal(toks.numpy(), ref_toks)
    np.testing.assert_array_equal(lens.numpy(), ref_lens)


@pytest.mark.parametrize("stop_at", [None, 5])
def test_ar_generate_matches_jax_under_injected_gumbel_noise(monkeypatch, fresh_jax, stop_at):
    """Temperature 1; with ``stop_at`` a large value at the stop index makes
    row 1 stop at step 5, so stop pruning and the ``stop`` padding run."""
    ja, jp, ta = _pair(0)
    max_steps = 12
    tables = _gumbel_tables(max_steps, stop_row1_at=stop_at)
    patch_jax_noise(monkeypatch, jax_ar, tables)
    ref_toks, ref_lens = _jax_generate(ja, jp, max_steps, 1.0)
    toks, lens = ar_generate(ta, *_port_cond(), TableKeys(tables), max_steps=max_steps,
                             sampling_temperature=1.0)
    assert int(lens[0]) == max_steps
    if stop_at is not None:
        assert int(lens[1]) == stop_at and (toks[1, stop_at:] == STOP).all()
    np.testing.assert_array_equal(toks.numpy(), ref_toks)
    np.testing.assert_array_equal(lens.numpy(), ref_lens)


def test_early_exit_gives_the_full_loops_tokens(monkeypatch):
    """Both rows stop early (steps 2 and 5): the loop notices at step 16 and
    pads with ``stop``; without the check it decodes all 39 steps."""
    _, _, ta = _pair(0)
    max_steps = 40
    tables = _gumbel_tables(max_steps, seed=6)
    tables[(2, 1)][0, STOP] = 50.0
    tables[(5, 1)][1, STOP] = 50.0
    steps = []
    real = AR.decode_step

    def counting(self, tok, cache):
        steps.append(1)
        return real(self, tok, cache)

    monkeypatch.setattr(AR, "decode_step", counting)
    early = ar_generate(ta, *_port_cond(), TableKeys(tables), max_steps=max_steps)
    n_early = len(steps)
    monkeypatch.setattr(port_ar, "EXIT_CHECK_STEPS", 10 ** 6)
    full = ar_generate(ta, *_port_cond(), TableKeys(tables), max_steps=max_steps)
    assert n_early == 15 and len(steps) - n_early == max_steps - 1
    assert early[1].tolist() == [2, 5]
    for a, b in zip(early, full):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def _spec_tables(max_steps, k, seed=7):
    """Every tag a round can draw: the draft's Gumbel noise (V,) at
    ``1 + r·(k + 4) + j``, the acceptance uniforms (k,) at ``+ k`` and the
    residual Gumbel noise at ``+ k + 1``; tag 0 for the first token."""
    rs = np.random.RandomState(seed)
    tables = {(0, 1): rs.gumbel(size=(B, V)).astype(np.float32)}
    for r in range(max_steps):
        base = 1 + r * (k + 4)
        for j in range(k):
            tables[(base + j, 1)] = rs.gumbel(size=(B, V)).astype(np.float32)
        tables[(base + k, 1)] = rs.uniform(size=(B, k)).astype(np.float32)
        tables[(base + k + 1, 1)] = rs.gumbel(size=(B, V)).astype(np.float32)
    return tables


@pytest.mark.parametrize("temperature,k", [(0.0, 3), (1.0, 2)])
def test_speculative_matches_jax(monkeypatch, fresh_jax, temperature, k):
    """A random one-block draft: tokens, lengths and ``with_stats``
    identical to JAX's (at temperature 1 under injected tables)."""
    ja, jp, ta = _pair(0)
    jd, dp, td = _pair(1, n_layers=1)
    max_steps = 10
    keys = None
    if temperature > 0:
        tables = _spec_tables(max_steps, k)
        patch_jax_noise(monkeypatch, jax_ar, tables)
        keys = TableKeys(tables)
    text, tm, proms, pm = _cond()
    ref_toks, ref_lens, ref_stats = jax_ar.ar_generate_speculative(
        ja, jp, jd, dp, *[jnp.asarray(a) for a in (text, tm, proms, pm)], ZERO_KEYS,
        max_steps=max_steps, k=k, sampling_temperature=temperature, with_stats=True)
    toks, lens, stats = ar_generate_speculative(
        ta, td, *_port_cond(), keys, max_steps=max_steps, k=k,
        sampling_temperature=temperature, with_stats=True)
    np.testing.assert_array_equal(toks.numpy(), np.asarray(ref_toks))
    np.testing.assert_array_equal(lens.numpy(), np.asarray(ref_lens))
    assert int(stats["rounds"]) == int(ref_stats["rounds"]) >= 1
    np.testing.assert_array_equal(stats["committed"].numpy(), np.asarray(ref_stats["committed"]))


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("draft", ["random", "perfect"])
def test_greedy_speculative_equals_plain_greedy(k, draft):
    """Any draft yields the target's greedy decode (mirrors
    ``tests/test_ar_spec.py``); the perfect draft accepts every proposal."""
    _, _, ta = _pair(0)
    td = _pair(2, n_layers=1)[2] if draft == "random" else ta
    max_steps = 12
    ref_toks, ref_lens = ar_generate(ta, *_port_cond(), None, max_steps=max_steps,
                                     sampling_temperature=0.0)
    toks, lens, stats = ar_generate_speculative(ta, td, *_port_cond(), None,
                                                max_steps=max_steps, k=k, with_stats=True)
    np.testing.assert_array_equal(lens.numpy(), ref_lens.numpy())
    for b in range(B):
        n = max(int(ref_lens[b]), 1)
        np.testing.assert_array_equal(toks[b, :n].numpy(), ref_toks[b, :n].numpy())
    committed, rounds = stats["committed"], int(stats["rounds"])
    assert (committed >= 1).all() and (committed <= max_steps).all()
    if draft == "perfect":
        assert int(committed.max()) - 1 >= min(max_steps - 1, (rounds - 1) * (k + 1))
