"""Tests that need a CUDA card: the port's kernels against their plain
versions (the training kernel forward and backward) at the main paths'
shapes and at ragged edges, the training backward's determinism, a tiny
serving batch (MaskGIT and ancestral) that must go through the kernels, the
ancestral chain's per-row uniforms and tight bucket on the card, a tiny
train step that must go through the training kernel, and the serving
runtime: a tiny ``Batcher`` cohort whose fp32 codes equal each request's
solo run, and a long-form ``/tts_stream`` that returns every chunk; the
gen4b eval decode and train sites, and the remat policies on the card.

They import neither jax nor the JAX package, so they also run on a machine
that has only PyTorch: ``python -m pytest --noconftest -m gpu
tests/test_torch_gpu.py``.  Without a card each test skips."""

import numpy as np
import pytest
import torch

from tts_with_diffusion_model_tpu_torch import smoke
from tts_with_diffusion_model_tpu_torch.ops.masked_attention import (
    masked_attention,
    masked_attention_plain,
)
from tts_with_diffusion_model_tpu_torch.ops.train_flash_attention import (
    train_flash_attention,
    train_flash_attention_plain,
)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = old


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("B,Tq,Tk,H,Dh", [(4, 384, 384, 8, 64), (4, 384, 50, 8, 64),
                                          (4, 384, 398, 8, 64), (2, 800, 800, 16, 64),
                                          (3, 7, 70, 2, 8), (1, 130, 1, 1, 16),
                                          (3, 50, 1, 2, 64), (2, 100, 70, 3, 64)])
def test_masked_attention_kernel_matches_plain(cuda, dtype, tol, B, Tq, Tk, H, Dh):
    rs = np.random.RandomState(Tq + Tk)
    q, k, v = (torch.from_numpy(rs.randn(B, T, H, Dh).astype(np.float32)).to(dtype).to(cuda)
               for T in (Tq, Tk, Tk))
    km = (rs.rand(B, Tk) > 0.3).astype(np.float32)
    km[:, 0] = 1
    km[-1] = 0  # every key masked: finite, uniform
    km = torch.from_numpy(km).to(cuda)
    before = masked_attention.launches
    got = masked_attention(q, k, v, km)
    torch.cuda.synchronize()
    assert masked_attention.launches == before + 1
    ref = masked_attention_plain(q, k, v, km)
    assert torch.isfinite(got).all()
    assert (got.float() - ref.float()).abs().max().item() <= tol


def _serving_sites_b1():
    from tts_with_diffusion_model_tpu_torch.models.diffusion import DiffusionConfig

    nar = {"d_model": 1024, "n_heads": 16, "n_layers": 12}
    return [(s.name, s.Tq, s.Tk, s.H, s.Dh)
            for s in smoke.attention_sites(DiffusionConfig(), nar, steps=12, prompt_bucket=256)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("site", _serving_sites_b1(), ids=lambda s: s[0].replace(" ", "_"))
def test_masked_attention_serving_sites_at_batch_one(cuda, dtype, tol, site):
    """One request: each serving site at B = 1 with a ragged mask with holes,
    then with every key masked (finite, uniform)."""
    _, Tq, Tk, H, Dh = site
    rs = np.random.RandomState(Tq * 3 + Tk)
    q, k, v = (torch.from_numpy(rs.randn(1, T, H, Dh).astype(np.float32)).to(dtype).to(cuda)
               for T in (Tq, Tk, Tk))
    ragged = (rs.rand(1, Tk) > 0.3).astype(np.float32)
    ragged[:, 0] = 1
    ragged[:, Tk - Tk // 5:] = 0
    for km in (ragged, np.zeros((1, Tk), np.float32)):
        km = torch.from_numpy(km).to(cuda)
        got = masked_attention(q, k, v, km)
        ref = masked_attention_plain(q, k, v, km)
        assert torch.isfinite(got).all()
        assert (got.float() - ref.float()).abs().max().item() <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
def test_nar_packed_self_attention_reads_the_fused_qkv_in_place(cuda, dtype, tol):
    """The NAR's 658-slot packed self-attention at H = 16: q, k, v are
    strided views of one fused (B, T, 3, H, Dh) projection."""
    rs = np.random.RandomState(658)
    qkv = torch.from_numpy(rs.randn(4, 658, 3, 16, 64).astype(np.float32)).to(dtype).to(cuda)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    assert q.stride(1) == 3 * 16 * 64 and not q.is_contiguous()
    km = (rs.rand(4, 658) > 0.2).astype(np.float32)
    km[:, 0] = 1
    km[1, 400:] = 0
    km[-1] = 0  # every key masked: finite, uniform
    km = torch.from_numpy(km).to(cuda)
    got = masked_attention(q, k, v, km)
    ref = masked_attention_plain(q, k, v, km)
    assert torch.isfinite(got).all()
    assert (got.float() - ref.float()).abs().max().item() <= tol


@pytest.mark.gpu
def test_strided_qkv_split_is_read_in_place(cuda):
    qkv = torch.randn(2, 33, 3, 4, 16, device=cuda)
    km = torch.ones(2, 33, device=cuda)
    got = masked_attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], km)
    ref = masked_attention_plain(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], km)
    assert (got - ref).abs().max().item() <= 1e-4


@pytest.mark.gpu
def test_first_call_on_a_thread_can_be_graph_captured(cuda):
    # the per-thread context set-up before a tensor map is encoded must be
    # legal inside a (global-mode) CUDA-graph capture
    import threading

    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn(4, 384, 16, 64, device=cuda, dtype=torch.bfloat16, generator=g)
               for _ in range(3))
    km = torch.ones(4, 384, device=cuda)
    km[:, 300:] = 0
    ref = masked_attention(q, k, v, km)
    torch.cuda.synchronize()
    out = {}

    def run():
        try:
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                out["o"] = masked_attention(q, k, v, km)
            graph.replay()
            torch.cuda.synchronize()
        except Exception as e:  # re-raised on the test's thread
            out["error"] = e

    t = threading.Thread(target=run)
    t.start()
    t.join()
    if "error" in out:
        raise out["error"]
    assert torch.equal(out["o"], ref)


@pytest.mark.gpu
def test_tiny_serving_batch_goes_through_the_kernel(cuda):
    out = smoke.phase_slice(cuda, "tiny", seed=0, repeats=1, ref_seconds=0.5)
    assert out["launches"] == out["expected"] > 0


def _grads(fn, q, k, v, km, causal, do):
    q, k, v = (x.detach().clone().requires_grad_(True) for x in (q, k, v))
    o = fn(q, k, v, km, causal)
    dq, dk, dv = torch.autograd.grad(o, (q, k, v), do)
    return o.detach(), dq, dk, dv


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("B,Tq,Tk,H,Dh,causal", [(4, 192, 192, 8, 64, False),
                                                 (4, 192, 50, 8, 64, False),
                                                 (3, 130, 130, 2, 64, True),
                                                 (3, 100, 131, 2, 32, True),
                                                 (3, 7, 70, 2, 8, False),
                                                 (2, 65, 1, 1, 16, False),
                                                 (4, 70, 7, 2, 64, True),
                                                 (4, 7, 130, 3, 64, False),
                                                 (2, 770, 770, 16, 64, True),
                                                 (3, 50, 1, 2, 64, False),
                                                 (3, 50, 1, 2, 64, True),
                                                 (2, 100, 70, 3, 64, True)])
def test_train_flash_attention_kernel_matches_plain(cuda, dtype, tol, B, Tq, Tk, H, Dh, causal):
    rs = np.random.RandomState(Tq * 7 + Tk)
    q, k, v, do = (torch.from_numpy(rs.randn(B, T, H, Dh).astype(np.float32)).to(dtype).to(cuda)
                   for T in (Tq, Tk, Tk, Tq))
    km = (rs.rand(B, Tk) > 0.3).astype(np.float32)
    km[:, 0] = 1
    km[-1] = 0  # every key masked: finite, uniform, no dS
    km = torch.from_numpy(km).to(cuda)
    f0, b0 = train_flash_attention.launches, train_flash_attention.backward_launches
    got = _grads(train_flash_attention, q, k, v, km, causal, do)
    torch.cuda.synchronize()
    assert (train_flash_attention.launches, train_flash_attention.backward_launches) == (f0 + 1, b0 + 1)
    ref = _grads(train_flash_attention_plain, q, k, v, km, causal, do)
    for name, a, b in zip(("o", "dq", "dk", "dv"), got, ref):
        assert torch.isfinite(a).all(), name
        scale = max(1.0, b.float().abs().max().item()) if dtype == torch.bfloat16 else 1.0
        err = (a.float() - b.float()).abs().max().item()
        assert err <= tol * scale, (name, err, scale)


@pytest.mark.gpu
@pytest.mark.parametrize("B,Tq,Tk,H,causal", [(32, 192, 192, 8, False), (32, 192, 398, 8, False),
                                             (2, 770, 770, 16, True)])
def test_train_flash_attention_backward_is_deterministic(cuda, B, Tq, Tk, H, causal):
    """No atomics: two backward calls on the same inputs give bit-identical
    dq, dk and dv."""
    from tts_with_diffusion_model_tpu_torch.ops import train_flash_attention as ops

    rs = np.random.RandomState(Tq + Tk)
    q, k, v, do = (torch.from_numpy(rs.randn(B, T, H, 64).astype(np.float32)).bfloat16().to(cuda)
                   for T in (Tq, Tk, Tk, Tq))
    km = (rs.rand(B, Tk) > 0.3).astype(np.float32)
    km[:, 0] = 1
    km[-1] = 0
    km = torch.from_numpy(km).to(cuda)
    o, lse = ops._forward(q, k, v, km, causal)
    first = ops._backward(q, k, v, km, o, lse, do, causal)
    second = ops._backward(q, k, v, km, o, lse, do, causal)
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(a, b), name


@pytest.mark.gpu
def test_masked_attention_refuses_to_be_differentiated(cuda):
    q = torch.randn(1, 8, 1, 8, device=cuda, requires_grad=True)
    km = torch.ones(1, 8, device=cuda)
    with pytest.raises(RuntimeError, match="forward-only"):
        masked_attention(q, q, q, km)


@pytest.mark.gpu
def test_tiny_train_steps_go_through_the_training_kernel(cuda):
    from tts_with_diffusion_model_tpu_torch import smoke_train

    overrides = ["model_overrides={d_model: 128, n_heads: 2, n_layers: 2, timesteps: 8, "
                 "text_len: 50, prom_len: 64, resp_len: 48}", "batch_size=4",
                 "eval_batch_size=8", "max_num_val=8", "nj=1", "resp_len_buckets=[32]"]
    out = smoke_train.phase_train(cuda, steps=2, overrides=overrides,
                                  corpus=(3, 12, (8, 30), (3, 12)))
    # phase_train checks the launches of every step against these counts
    assert (out["fwd_per_step"], out["bwd_per_step"]) == (2 + 2 + 2 * 2 * 3, 2 + 2 + 2 * 3)
    assert out["run_launches"] == 2 * (16 + 10) and out["eval_launches"] > 0


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("causal", [False, True])
def test_packed_self_attention_gradients_land_in_the_fused_qkv(cuda, dtype, tol, causal):
    """The NAR's (non-causal) and the AR's (causal) 770-slot packed
    self-attention at H = 16: q, k, v are strided views of one fused
    projection, and dq, dk, dv must land in its gradient."""
    rs = np.random.RandomState(770 + causal)
    base = torch.from_numpy(rs.randn(2, 770, 3, 16, 64).astype(np.float32)).to(dtype).to(cuda)
    do = torch.from_numpy(rs.randn(2, 770, 16, 64).astype(np.float32)).to(dtype).to(cuda)
    km = (rs.rand(2, 770) > 0.2).astype(np.float32)
    km[:, 0] = 1
    km[1, 500:] = 0
    km = torch.from_numpy(km).to(cuda)
    grads = []
    for fn in (train_flash_attention, train_flash_attention_plain):
        qkv = base.detach().clone().requires_grad_(True)
        o = fn(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], km, causal)
        (g,) = torch.autograd.grad(o, qkv, do)
        grads.append((o.detach(), g))
    for a, b in zip(*grads):
        assert torch.isfinite(a).all()
        scale = max(1.0, b.float().abs().max().item()) if dtype == torch.bfloat16 else 1.0
        assert (a.float() - b.float()).abs().max().item() <= tol * scale


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
def test_eval_bucket_self_attention_at_1474_slots(cuda, dtype, tol):
    """The AR/NAR val-loss eval pads to the max_*_len bucket (1474 packed
    slots): kernel 1 non-causal and kernel 2's forward causal."""
    rs = np.random.RandomState(1474)
    q, k, v = (torch.from_numpy(rs.randn(2, 1474, 16, 64).astype(np.float32)).to(dtype).to(cuda)
               for _ in range(3))
    km = np.ones((2, 1474), np.float32)
    km[0, 30:65] = 0  # text pads, then prompt pads mid-row
    km[0, 400:962] = 0
    km[1, 1100:] = 0
    km = torch.from_numpy(km).to(cuda)
    with torch.no_grad():
        pairs = [(masked_attention(q, k, v, km), masked_attention_plain(q, k, v, km)),
                 (train_flash_attention(q, k, v, km, True),
                  train_flash_attention_plain(q, k, v, km, True))]
    for got, ref in pairs:
        assert torch.isfinite(got).all()
        assert (got.float() - ref.float()).abs().max().item() <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("yaml", ["nar", "ar"])
def test_tiny_nar_and_ar_train_steps_go_through_the_training_kernel(cuda, yaml):
    from tts_with_diffusion_model_tpu_torch import smoke_train

    overrides = ["model_overrides={d_model: 128, n_heads: 2, n_layers: 2}", "batch_size=4",
                 "eval_batch_size=8", "max_num_val=8", "nj=1", "resp_len_buckets=[32]",
                 "prom_len_buckets=[64]", "max_prom_len=128", "max_resp_len=64"]
    out = smoke_train.phase_train(cuda, getattr(smoke_train, f"{yaml.upper()}_YAML"), steps=2,
                                  overrides=overrides, corpus=(3, 12, (8, 30), (3, 12)))
    # phase_train checks the launches of every step against these counts
    assert (out["fwd_per_step"], out["bwd_per_step"]) == (2 * 2, 2)
    assert out["run_launches"] == 2 * 6 and out["eval_launches"] == 2 * out["eval_per_batch"]


@pytest.mark.gpu
@pytest.mark.parametrize("stride", [1, 3])
def test_tiny_ancestral_batch_goes_through_the_kernel(cuda, stride):
    from tts_with_diffusion_model_tpu_torch.serve import Synthesizer

    base, nar_dims = smoke.build_synthesizer(cuda, "tiny", zoo=False, seed=0, max_batch=2)
    synth = Synthesizer(base.first, base.nar, base.codec, base.phone_symmap, device=cuda,
                        max_batch=2, decode="ancestral", stride=stride, bf16=False)
    requests = smoke.make_requests(2, 0.5, seed=1)
    out = smoke.serve_and_check(synth, nar_dims, requests, "gpu test", repeats=1)
    # T = 20: 19 process steps, 7 at stride 3
    assert out["steps"] == (19 if stride == 1 else 7)
    assert out["launches"] == out["expected"] == 4 + out["steps"] * 2 * 3 + 7 * 2


@pytest.mark.gpu
def test_row_uniforms_are_prefix_stable_across_buckets_on_the_card(cuda):
    """A row's uniforms at the 384 serving bucket are the first 384 rows of
    its draw at the 448 model bucket."""
    from tts_with_diffusion_model_tpu_torch.utils.rng import RowKeys

    keys = RowKeys.from_seeds([3, 4]).fold(0).fold(99)
    tight, full = keys.uniform((384, 1025), cuda), keys.uniform((448, 1025), cuda)
    assert torch.equal(tight, full[:, :384])


@pytest.mark.gpu
def test_ancestral_tight_and_full_buckets_agree_on_the_card(cuda):
    """The full-width DiT (seeded, fp32) at stride 3: the 384 serving bucket
    and the 448 model bucket give identical valid tokens."""
    from tts_with_diffusion_model_tpu_torch.convert import init_seeded
    from tts_with_diffusion_model_tpu_torch.models.diffusion import DiffusionConfig, DiffusionModel
    from tts_with_diffusion_model_tpu_torch.utils.rng import RowKeys

    model = DiffusionModel(DiffusionConfig(), dtype=torch.float32)
    init_seeded(model.denoiser, 0)
    model = model.to(cuda).eval()
    rs = np.random.RandomState(5)
    text = torch.from_numpy(rs.randint(1, 60, (2, 50))).to(cuda)
    tm = torch.ones(2, 50, device=cuda)
    tm[1, 30:] = 0
    proms = torch.from_numpy(rs.randint(0, 1024, (2, 256, 8))).to(cuda)
    pm = torch.ones(2, 256, device=cuda)
    pm[0, 200:] = 0
    keys = RowKeys.from_seeds([7, 8]).fold(0)
    tight = model.generate(text, tm, proms, pm, keys, stride=3, resp_bucket=384)
    full = model.generate(text, tm, proms, pm, keys, stride=3, resp_bucket=448)
    assert torch.equal(tight[:, :350], full[:, :350])


def _ar_batch(cuda, B=4, pb=256, seed=9):
    """Seeded AR conditioning at the serving buckets: text 50 and prompt
    ``pb`` with pads mid-row."""
    rs = np.random.RandomState(seed)
    text = torch.from_numpy(rs.randint(1, 60, (B, 50))).to(cuda)
    tm = torch.ones(B, 50, device=cuda)
    tm[1, 31:] = 0
    proms = torch.from_numpy(rs.randint(0, 1024, (B, pb, 8))).to(cuda)
    pm = torch.ones(B, pb, device=cuda)
    pm[0, 225:] = 0
    pm[2, 97:] = 0
    return text * tm.long(), tm, proms, pm


def _seeded_ar(cuda, name, dtype, seed):
    from tts_with_diffusion_model_tpu_torch.convert import init_seeded
    from tts_with_diffusion_model_tpu_torch.utils.precision import cast_params_bf16
    from tts_with_diffusion_model_tpu_torch.models import get_model

    model = get_model(name, 1024, dtype=dtype)
    init_seeded(model, seed)
    model = model.to(cuda).eval()
    return cast_params_bf16(model) if dtype == torch.bfloat16 else model


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
def test_ar_prefill_through_kernel_2_matches_the_plain_route(cuda, dtype, tol):
    """The registry AR (d1024/16/12, seeded) at 50 + 1 + 256 + 1 slots:
    last logits and every block's cached k, v through kernel 2's forward
    against the plain causal attention, within tol·max(1, max |ref|)."""
    from unittest import mock

    from tts_with_diffusion_model_tpu_torch.ops import train_flash_attention as train_ops

    model = _seeded_ar(cuda, "ar", dtype, 0)
    batch = _ar_batch(cuda)
    before = train_flash_attention.launches
    got, cache = model.prefill(*batch, 308 + 8)
    torch.cuda.synchronize()
    assert train_flash_attention.launches == before + 12
    with mock.patch.object(train_ops, "train_flash_attention", train_flash_attention_plain):
        ref, ref_cache = model.prefill(*batch, 308 + 8)
    for a, b in [(got, ref), *zip(cache.k + cache.v, ref_cache.k + ref_cache.v)]:
        assert torch.isfinite(a).all()
        err = (a.float() - b.float()).abs().max().item()
        assert err <= tol * max(1.0, b.float().abs().max().item()), err


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 4])
def test_fp32_greedy_speculative_equals_plain_greedy_on_the_card(cuda, k):
    """A seeded ar-quarter target in fp32 (TF32 off) with a seeded one-block
    draft, and with itself as the draft: the speculative tokens and lengths
    are the plain greedy decode's."""
    from tts_with_diffusion_model_tpu_torch.models.ar import ar_generate, ar_generate_speculative

    target = _seeded_ar(cuda, "ar-quarter", torch.float32, 1)
    from tts_with_diffusion_model_tpu_torch.convert import init_seeded
    from tts_with_diffusion_model_tpu_torch.models import get_model

    draft = get_model("ar-quarter", 1024, {"n_layers": 1}, dtype=torch.float32)
    init_seeded(draft, 2)
    draft = draft.to(cuda).eval()
    batch = _ar_batch(cuda, pb=128)
    plain, plain_lens = ar_generate(target, *batch, None, max_steps=48, sampling_temperature=0.0)
    for d in (draft, target):
        toks, lens = ar_generate_speculative(target, d, *batch, None, max_steps=48, k=k)
        assert torch.equal(lens, plain_lens)
        for b in range(4):
            n = max(int(plain_lens[b]), 1)
            assert torch.equal(toks[b, :n], plain[b, :n])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
def test_decode_step_reading_the_filled_slots_matches_the_whole_cache(cuda, dtype, tol,
                                                                      monkeypatch):
    """A decode step of the registry AR that reads ``cache[:, :index + 1]``
    against one that reads the whole cache (every later slot masked): the
    logits agree within tol·max(1, max |ref|) (the reductions' lengths
    differ, so not bit for bit) and argmax to the same tokens."""
    import copy

    from tts_with_diffusion_model_tpu_torch.models import base
    from tts_with_diffusion_model_tpu_torch.ops.attention import dense_attention

    model = _seeded_ar(cuda, "ar", dtype, 3)
    batch = _ar_batch(cuda)
    _, cache = model.prefill(*batch, 308 + 448)
    tok = torch.tensor([5, 6, 7, 8], device=cuda)
    for _ in range(3):
        _, cache = model.decode_step(tok, cache)
    twin = copy.deepcopy(cache)
    cut, _ = model.decode_step(tok, cache)

    def decode_full(self, x, cache_k, cache_v, index, kv_mask):
        B, W, _ = x.shape
        qkv = self._qkv(x)
        cache_k[:, index:index + W], cache_v[:, index:index + W] = qkv[:, :, 1], qkv[:, :, 2]
        o = dense_attention(qkv[:, :, 0], cache_k, cache_v, pair_mask=kv_mask[:, None, :])
        return self.to_out(o.reshape(B, W, self.d_model))

    monkeypatch.setattr(base.Attention, "decode", decode_full)
    full, _ = model.decode_step(tok, twin)
    err = (cut - full).abs().max().item()
    assert err <= tol * max(1.0, full.abs().max().item()), err
    assert torch.equal(cut.argmax(-1), full.argmax(-1))


@pytest.mark.gpu
def test_tiny_ar_serving_batch_goes_through_both_kernels(cuda):
    """A tiny AR + NAR Synthesizer on the card: 2 kernel-2 forwards (the
    prefill) and 14 kernel-1 launches (the NAR) per batch, no plain call."""
    from tts_with_diffusion_model_tpu_torch.convert import init_seeded
    from tts_with_diffusion_model_tpu_torch.models import get_model
    from tts_with_diffusion_model_tpu_torch.serve import Synthesizer
    from tts_with_diffusion_model_tpu_torch.smoke_ar import serve_ar_and_check

    base, _ = smoke.build_synthesizer(cuda, "tiny", zoo=False, seed=0, max_batch=2)
    ar = get_model("ar", 1024, {"d_model": 128, "n_heads": 2, "n_layers": 2},
                   dtype=torch.float32)
    init_seeded(ar, 4)
    synth = Synthesizer(ar, base.nar, base.codec, base.phone_symmap, device=cuda, max_batch=2,
                        bf16=False, max_ar_steps=32)
    out = serve_ar_and_check(synth, smoke.make_requests(2, 0.5, seed=1), "gpu test", repeats=1)
    assert out["launches"]["kernel2"] == 2 and out["launches"]["kernel1"] == 14


@pytest.mark.gpu
def test_tiny_batcher_cohort_on_the_card_gives_each_request_its_solo_codes(cuda):
    """A tiny fp32 Synthesizer on the card behind a ``Batcher``: each of 4
    requests alone, then all 4 in one cohort; every batch goes through
    kernel 1 (no plain call) and the cohort's codes equal the solo ones."""
    from tts_with_diffusion_model_tpu_torch.smoke_serve import cohort_check

    synth, nar_dims = smoke.build_synthesizer(cuda, "tiny", zoo=False, seed=0, max_batch=4)
    per_batch = smoke.expected_launches(smoke.attention_sites(synth.first.config, nar_dims,
                                                              synth.denoiser_calls, 64))
    masked_attention.launches = masked_attention.plain_calls = 0
    out = cohort_check(synth, smoke.reference_wavs(3, 0.5, seed=61), 0, "gpu test",
                       assert_equal=True)
    assert out["identical"] and out["share"] == 1.0
    assert masked_attention.launches == 5 * per_batch and masked_attention.plain_calls == 0


@pytest.mark.gpu
def test_tiny_long_form_stream_on_the_card_returns_every_chunk(cuda):
    """POST /tts_stream of a 3-segment text to a tiny server on the card:
    every chunk arrives, each equal to ``synthesize_stream``'s in L16."""
    from tts_with_diffusion_model_tpu_torch.smoke_serve import LONG_TEXT, Served, pcm, stream

    synth, _ = smoke.build_synthesizer(cuda, "tiny", zoo=False, seed=0, max_batch=4)
    ref = smoke.reference_wavs(1, 0.5, seed=62)[0]
    served = Served(synth)
    try:
        st = stream(served.port, {"text": LONG_TEXT, "reference": str(ref), "seed": 2})
    finally:
        served.drain()
    assert st["status"] == 200 and st["end"] is not None
    want = list(synth.synthesize_stream(LONG_TEXT, ref, 2))
    assert len(st["chunks"]) == len(want) == 3
    for c, w in zip(st["chunks"], want):
        got = np.frombuffer(c, ">i2").astype(np.int32)
        assert got.shape == (synth.gen_len * 320,)
        assert np.abs(got - pcm(w)).max() <= 1


def _gen4b_decode_sites():
    from tts_with_diffusion_model_tpu_torch import smoke_gen4b

    return {f: smoke_gen4b.decode_sites(y) for f, y in smoke_gen4b.RECIPES.items()}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_eval_decode_sites_match_plain(cuda, dtype):
    """The gen4b eval decode's new sites: the D3PM's ancestral chain at
    B=32 (towers and the three DiT attentions over the 448-slot bucket) on
    kernel 1, and the AR's 962-slot causal prefill at B=32 on kernel 2's
    forward, each against its plain version (the smoke's checks)."""
    from tts_with_diffusion_model_tpu_torch import smoke_train

    sites = _gen4b_decode_sites()
    for site in sites["d3pm"]["sites"]:
        smoke.check_site(site, sites["d3pm"]["B"], dtype, cuda, seed=0, time_it=False)
    for site in sites["ar"]["sites"]:
        smoke_train.check_train_site(site, dtype, cuda, seed=0, time_it=False)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gen4b_train_sites_at_b64_match_plain(cuda, dtype):
    from tts_with_diffusion_model_tpu_torch import smoke_gen4b, smoke_train

    for site in smoke_gen4b.train_sites():
        smoke_train.check_train_site(site, dtype, cuda, seed=0, time_it=False)


@pytest.mark.gpu
@pytest.mark.parametrize("family", ["d3pm", "nar"])
def test_remat_policies_give_null_gradients_on_the_card(cuda, family):
    """A tiny D3PM and NAR step (bf16 compute, kernel 2 forward and
    backward) under each policy: every gradient equal to whole-block
    recompute's within fp32 rounding, and the same kernel-2 launches."""
    import dataclasses

    from tts_with_diffusion_model_tpu_torch import smoke_gen4b, smoke_train
    from tts_with_diffusion_model_tpu_torch.config import Config
    from tts_with_diffusion_model_tpu_torch.train.train import build_model, make_bucket

    yaml = smoke_train.TRAIN_YAML if family == "d3pm" else smoke_train.NAR_YAML
    base = Config.from_cli([f"yaml={yaml}", "batch_size=4", "nj=1", "resp_len_buckets=[32]",
                            "prom_len_buckets=[64]", "max_prom_len=128", "max_resp_len=64",
                            "model_overrides={d_model: 128, n_heads: 2, n_layers: 2, timesteps: 8, "
                            "text_len: 50, prom_len: 64, resp_len: 48}"])
    with torch.device("meta"):
        bucket = make_bucket(base, build_model(base))
    batch = smoke_gen4b._remat_batch(base, bucket, seed=0)
    runs = {p: smoke_gen4b.remat_step(dataclasses.replace(base, gradient_checkpointing_policy=p),
                                      cuda, batch, seed=0) for p in smoke_gen4b.POLICIES}
    ref = runs[None]
    assert ref["launches"][0] > 0 and ref["launches"][2] == 0
    for policy, r in runs.items():
        assert r["launches"] == ref["launches"], policy
        for g, g0 in zip(r["grads"], ref["grads"]):
            err = (g - g0).abs().max().item()
            assert err <= smoke_gen4b.REMAT_TOL * max(1.0, g0.abs().max().item()), policy
