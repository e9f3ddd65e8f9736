"""Tests that need a CUDA card: both attention kernels at head widths between
and above the registry's (40, 80, 96, 128, 136, 200 and 256, and 24, 72
and 120 beside them) and at widths that are not a multiple of 8 (4, 12,
130 and 250, on zero-padded copies) against their plain versions, forward
and backward, in bf16 on the tensor cores and in fp32 on the SIMT kernels,
at ragged lengths across 64-row tile edges, causal and not, with an
all-masked row; the training backward bit-identical across calls (on the
tensor cores, at 256 and padded at 12 too);
fused qkv views and unaligned views at Dh 128 and 256; a bf16 width off 8
refused by the libraries unpadded; and a head wider than 256 refused on
the card.

They import neither jax nor the JAX package: ``python -m pytest --noconftest
-m gpu tests/test_torch_wide_gpu.py``.  Without a card each test skips."""

import ctypes

import numpy as np
import pytest
import torch

from tts_with_diffusion_model_tpu_torch import smoke
from tts_with_diffusion_model_tpu_torch.ops import masked_attention as serve_ops
from tts_with_diffusion_model_tpu_torch.ops import train_flash_attention as train_ops
from tts_with_diffusion_model_tpu_torch.ops.masked_attention import (
    masked_attention,
    masked_attention_plain,
)
from tts_with_diffusion_model_tpu_torch.ops.masked_attention import MAX_DH
from tts_with_diffusion_model_tpu_torch.ops.route import tensor_core_route, tma_aligned
from tts_with_diffusion_model_tpu_torch.ops.train_flash_attention import (
    train_flash_attention,
    train_flash_attention_plain,
)

#: kernel against plain: fp32 sums in another order; bf16 rounds p, the
#: output and the gradients to 8 bits of mantissa (× max(1, |ref|))
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
WIDE = [24, 40, 72, 80, 96, 120, 128, 136, 200, 256]
#: widths that are not a multiple of 8: bf16 on zero-padded copies at the
#: next one (8, 16, 136, 256), fp32 on the SIMT kernels
OFF8 = [4, 12, 130, 250]
#: (B, Tq, Tk, H, causal): ragged across tile edges, a single key, causal
SHAPES = [(3, 65, 63, 2, False), (2, 130, 200, 2, True), (3, 50, 1, 2, False),
          (2, 192, 192, 4, False)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = old


def _inputs(B, Tq, Tk, H, Dh, dtype, device, seed):
    rs = np.random.RandomState(seed)
    q, k, v, do = (torch.from_numpy(rs.randn(B, T, H, Dh).astype(np.float32)).to(dtype)
                   .to(device) for T in (Tq, Tk, Tk, Tq))
    km = (rs.rand(B, Tk) > 0.3).astype(np.float32)
    km[:, 0] = 1
    km[-1] = 0  # every key masked: finite, uniform, no dS
    return q, k, v, torch.from_numpy(km).to(device), do


def _grads(fn, q, k, v, km, causal, do):
    q, k, v = (x.detach().clone().requires_grad_(True) for x in (q, k, v))
    o = fn(q, k, v, km, causal)
    return (o.detach(), *torch.autograd.grad(o, (q, k, v), do))


def _train_counters():
    fn = train_flash_attention
    return [fn.launches, fn.launches_tc, fn.backward_launches, fn.backward_launches_tc]


def _assert_close(got, ref, dtype, names=("o", "dq", "dk", "dv")):
    for name, a, b in zip(names, got, ref):
        assert torch.isfinite(a).all(), name
        scale = max(1.0, b.float().abs().max().item()) if dtype == torch.bfloat16 else 1.0
        err = (a.float() - b.float()).abs().max().item()
        assert err <= TOL[dtype] * scale, (name, err, TOL[dtype] * scale)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s[:4])) + "c" * s[4])
@pytest.mark.parametrize("Dh", WIDE + OFF8)
def test_both_kernels_match_plain_at_wide_heads(cuda, dtype, shape, Dh):
    """Kernel 1 (non-causal shapes) and kernel 2 forward and backward, every
    launch on the route ``tensor_core_route`` gives (tensor cores in bf16 at
    every width up to 256, the widths off 8 on padded copies; SIMT in
    fp32)."""
    B, Tq, Tk, H, causal = shape
    q, k, v, km, do = _inputs(B, Tq, Tk, H, Dh, dtype, cuda, Tq * 7 + Tk + Dh)
    tc = int(tensor_core_route(Dh, dtype, tma_aligned(q, k, v, do)))
    assert tc == (dtype == torch.bfloat16)
    if not causal:
        n, n_tc = masked_attention.launches, masked_attention.launches_tc
        got = masked_attention(q, k, v, km)
        torch.cuda.synchronize()
        assert (masked_attention.launches - n, masked_attention.launches_tc - n_tc) == (1, tc)
        _assert_close([got], [masked_attention_plain(q, k, v, km)], dtype, ("o",))
    counts = _train_counters()
    got = _grads(train_flash_attention, q, k, v, km, causal, do)
    torch.cuda.synchronize()
    after = _train_counters()
    assert [a - b for a, b in zip(after, counts)] == [1, tc, 1, tc]
    _assert_close(got, _grads(train_flash_attention_plain, q, k, v, km, causal, do), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("Dh", [40, 80, 96, 128, 12, 136, 200, 256])
@pytest.mark.parametrize("causal", [False, True])
def test_training_backward_is_bit_identical_at_wide_heads(cuda, Dh, causal):
    """No atomics at any width: two backward calls on the same bf16 inputs
    give bit-identical dq, dk and dv (on the tensor cores at every width:
    Dh 12 on padded copies, 256 with dK/dV split over two blocks per key
    tile)."""
    q, k, v, km, do = _inputs(4, 200, 200, 4, Dh, torch.bfloat16, cuda, Dh)
    o, lse = train_ops._forward(q, k, v, km, causal)
    first = train_ops._backward(q, k, v, km, o, lse, do, causal)
    second = train_ops._backward(q, k, v, km, o, lse, do, causal)
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(a, b), name


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_qkv_views_at_dh_128_are_read_in_place(cuda, dtype):
    """A (B, T, 3, H, 128) projection split into q, k, v views (time stride
    3·H·128): the gradients land in the fused tensor, on the tensor cores in
    bf16."""
    g = torch.Generator().manual_seed(5)
    qkv = torch.randn(2, 150, 3, 8, 128, generator=g).to(dtype).to(cuda)
    do = torch.randn(2, 150, 8, 128, generator=g).to(dtype).to(cuda)
    km = torch.ones(2, 150, device=cuda)
    km[1, 100:] = 0

    def run(fn):
        x = qkv.detach().clone().requires_grad_(True)
        q, k, v = x.unbind(2)
        o = fn(q, k, v, km, True)
        (dx,) = torch.autograd.grad(o, x, do)
        return o.detach(), dx

    n_tc = train_flash_attention.backward_launches_tc
    got = run(train_flash_attention)
    torch.cuda.synchronize()
    assert train_flash_attention.backward_launches_tc - n_tc == int(dtype == torch.bfloat16)
    _assert_close(got, run(train_flash_attention_plain), dtype, ("o", "dqkv"))


@pytest.mark.gpu
@pytest.mark.parametrize("Dh", [128, 256])
def test_unaligned_views_at_dh_128_take_the_simt_kernels(cuda, Dh):
    """Unaligned bf16 views at a multiple of 8 (128, and 256 beside it) run
    the SIMT kernels on the same values."""
    q, k, v, km, do = _inputs(2, 70, 90, 2, Dh, torch.bfloat16, cuda, 11)
    uq, uk, uv, udo = (smoke.unaligned(t) for t in (q, k, v, do))
    assert not tma_aligned(uq, uk, uv)
    n_tc, t_tc = masked_attention.launches_tc, train_flash_attention.backward_launches_tc
    got = masked_attention(uq, uk, uv, km)
    tgot = _grads(train_flash_attention, uq, uk, uv, km, False, udo)
    torch.cuda.synchronize()
    assert masked_attention.launches_tc == n_tc
    assert train_flash_attention.backward_launches_tc == t_tc
    _assert_close([got], [masked_attention_plain(q, k, v, km)], torch.bfloat16, ("o",))
    _assert_close(tgot, _grads(train_flash_attention_plain, q, k, v, km, False, do),
                  torch.bfloat16)


@pytest.mark.gpu
@pytest.mark.parametrize("Dh", [4, 130, 250])
def test_widths_off_8_run_the_tensor_cores_on_padded_copies(cuda, Dh):
    """A bf16 call at a width that is not a multiple of 8 launches the
    kernel once on copies padded to the next multiple of 8, with its own
    Dh^-0.5, and returns contiguous outputs and gradients at Dh (unaligned
    views included: the copies are contiguous)."""
    q, k, v, km, do = _inputs(2, 70, 90, 3, Dh, torch.bfloat16, cuda, Dh)
    uq, uk, uv = (smoke.unaligned(t) for t in (q, k, v))
    n = masked_attention.launches, masked_attention.launches_tc
    got = masked_attention(uq, uk, uv, km)
    counts = _train_counters()
    tgot = _grads(train_flash_attention, uq, uk, uv, km, True, do)
    torch.cuda.synchronize()
    assert (masked_attention.launches - n[0], masked_attention.launches_tc - n[1]) == (1, 1)
    assert [a - b for a, b in zip(_train_counters(), counts)] == [1, 1, 1, 1]
    for t in (got, *tgot):
        assert t.shape[-1] == Dh and t.is_contiguous()
    _assert_close([got], [masked_attention_plain(q, k, v, km)], torch.bfloat16, ("o",))
    _assert_close(tgot, _grads(train_flash_attention_plain, q, k, v, km, True, do),
                  torch.bfloat16)


@pytest.mark.gpu
@pytest.mark.parametrize("Dh", [12, 250])
def test_libraries_refuse_bf16_widths_off_8_unpadded(cuda, Dh):
    """The padding is the wrappers' alone: each library's entry point,
    called straight with a bf16 width that is not a multiple of 8, returns
    -1 and launches nothing, and takes the same width in fp32."""
    outs = {}
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v, km, do = _inputs(2, 70, 90, 3, Dh, dtype, cuda, Dh)
        o = torch.empty_like(q)
        lse = torch.empty(2, 3, 70, device=cuda)
        strides = (q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0),
                   v.stride(1), o.stride(0), o.stride(1))
        code = train_ops._DTYPE_CODE[dtype]
        stream = torch.cuda.current_stream(cuda).cuda_stream
        route = ctypes.c_int(-1)
        rc1 = serve_ops._kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(), km.data_ptr(),
                                  o.data_ptr(), *strides, 2, 70, 90, 3, Dh, code, Dh ** -0.5,
                                  stream, ctypes.byref(route))
        rc2 = train_ops._kernels()[0](q.data_ptr(), k.data_ptr(), v.data_ptr(), km.data_ptr(),
                                      o.data_ptr(), lse.data_ptr(), *strides, 2, 70, 90, 3, Dh,
                                      0, code, Dh ** -0.5, stream, ctypes.byref(route))
        torch.cuda.synchronize()
        outs[dtype] = (rc1, rc2)
    assert outs == {torch.bfloat16: (-1, -1), torch.float32: (0, 0)}


@pytest.mark.gpu
def test_fp32_at_dh_256_runs_the_simt_kernels(cuda):
    """fp32 stays on the SIMT kernels at 256, summed in fp32 throughout."""
    q, k, v, km, do = _inputs(2, 130, 70, 2, 256, torch.float32, cuda, 3)
    n_tc, counts = masked_attention.launches_tc, _train_counters()
    got = masked_attention(q, k, v, km)
    tgot = _grads(train_flash_attention, q, k, v, km, False, do)
    torch.cuda.synchronize()
    assert masked_attention.launches_tc == n_tc
    assert [a - b for a, b in zip(_train_counters(), counts)] == [1, 0, 1, 0]
    _assert_close([got], [masked_attention_plain(q, k, v, km)], torch.float32, ("o",))
    _assert_close(tgot, _grads(train_flash_attention_plain, q, k, v, km, False, do),
                  torch.float32)


@pytest.mark.gpu
@pytest.mark.parametrize("Dh", [MAX_DH + 1, 512])
def test_heads_wider_than_256_are_refused_on_the_card(cuda, Dh):
    """No kernel takes them, and the wrappers raise before any launch."""
    q, k, v, km, do = _inputs(1, 20, 20, 1, Dh, torch.bfloat16, cuda, Dh)
    n = (masked_attention.launches, *_train_counters())
    with pytest.raises(ValueError, match="no attention kernel"):
        masked_attention(q, k, v, km)
    with pytest.raises(ValueError, match="no attention kernel"):
        train_flash_attention(q, k, v, km)
    assert (masked_attention.launches, *_train_counters()) == n
