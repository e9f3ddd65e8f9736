"""Tests of the Gaussian family that need a CUDA card: both kernels against
their plain versions at the head widths the Gaussian denoisers give them
(32, 16, 8: bf16 on the tensor cores, fp32 on the SIMT kernels), at ragged
Tq and Tk with all-masked rows, causal for the training kernel, on a fused
qkv view read in place, with the backward bit-identical across calls and
every bf16 launch counted on the tensor cores; and a tiny Gaussian run of
the chip phase (train, export, serve, the fp32 cohort) whose attention must
go through the kernels; and the fp32 conv-UNet's rows bit-identical at a
fixed batch whatever their neighbours.  Like ``test_torch_gpu.py`` they import neither jax
nor the JAX package: ``python -m pytest --noconftest -m gpu
tests/test_torch_gaussian_gpu.py``.  Without a card each test skips."""

import numpy as np
import pytest
import torch

from tts_with_diffusion_model_tpu_torch.ops import train_flash_attention as train_ops
from tts_with_diffusion_model_tpu_torch.ops.masked_attention import (
    masked_attention,
    masked_attention_plain,
)
from tts_with_diffusion_model_tpu_torch.ops.route import tensor_core_route, tma_aligned
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


#: (B, Tq, Tk, H, Dh): the DiT and towers at Dh 32, the -unet core at 8, the
#: conv-UNet's levels at 8 / 16 / 32 (prompt 256 + text 50 keys), odd sizes
SITES = [(4, 448, 448, 8, 32), (4, 448, 306, 8, 8), (4, 224, 306, 8, 16),
         (4, 112, 306, 8, 32), (3, 77, 45, 2, 8), (2, 33, 129, 4, 16)]


def _inputs(B, Tq, Tk, H, Dh, dtype, device, seed=0):
    rs = np.random.RandomState(seed)
    q, k, v, do = (torch.from_numpy(rs.randn(B, T, H, Dh).astype(np.float32)).to(dtype).to(device)
                   for T in (Tq, Tk, Tk, Tq))
    mask = np.ones((B, Tk), np.float32)
    mask[-1, Tk // 3:] = 0
    if B > 2:
        mask[1] = rs.rand(Tk) > 0.3
        mask[1, 0] = 1
    return q, k, v, do, torch.from_numpy(mask).to(device)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("B,Tq,Tk,H,Dh", SITES)
def test_both_kernels_match_plain_at_the_gaussian_head_widths(cuda, dtype, tol, B, Tq, Tk, H,
                                                               Dh):
    q, k, v, do, mask = _inputs(B, Tq, Tk, H, Dh, dtype, cuda)
    ref = masked_attention_plain(q, k, v, mask).float()
    got = masked_attention(q, k, v, mask).float()
    scale = max(1.0, ref.abs().max().item()) if dtype == torch.bfloat16 else 1.0
    assert (got - ref).abs().max().item() <= tol * scale

    def fwd_bwd(fn):
        qg, kg, vg = (x.detach().requires_grad_(True) for x in (q, k, v))
        o = fn(qg, kg, vg, mask, False)
        return (o.detach(), *torch.autograd.grad(o, (qg, kg, vg), do))

    for a, b in zip(fwd_bwd(train_flash_attention), fwd_bwd(train_flash_attention_plain)):
        b = b.float()
        scale = max(1.0, b.abs().max().item()) if dtype == torch.bfloat16 else 1.0
        assert (a.float() - b).abs().max().item() <= tol * scale


#: ragged (Tq, Tk) pairs at the edges of 64-row tiles and the sites' lengths
RAGGED = [(1, 50), (50, 1), (63, 65), (65, 63), (306, 448), (448, 306)]
TOL_BF16 = 2e-2  # × max(1, |ref|): bf16 rounds p, the output and the gradients


def _ragged_inputs(B, Tq, Tk, H, Dh, device, seed, fused=False):
    """bf16 q, k, v, dO and a key mask with a full row, a ragged prefix,
    holes and an all-masked row; q, k, v views of one (B, T, 3, H, Dh)
    projection when ``fused``."""
    rs = np.random.RandomState(seed)

    def randn(*shape):
        return torch.from_numpy(rs.randn(*shape).astype(np.float32)).to(torch.bfloat16).to(device)

    if fused:
        q, k, v = randn(B, Tq, 3, H, Dh).unbind(2)
    else:
        q, k, v = randn(B, Tq, H, Dh), randn(B, Tk, H, Dh), randn(B, Tk, H, Dh)
    do = randn(B, Tq, H, Dh)
    mask = np.ones((B, Tk), np.float32)
    mask[1, max(1, Tk // 3):] = 0
    mask[2] = rs.rand(Tk) > 0.3
    mask[2, 0] = 1
    mask[3] = 0
    return q, k, v, do, torch.from_numpy(mask).to(device)


def _close(got, ref):
    ref = ref.float()
    return (got.float() - ref).abs().max().item() <= TOL_BF16 * max(1.0, ref.abs().max().item())


def _check_tensor_core_path(q, k, v, do, mask):
    """Both kernels against plain (kernel 2 with and without causality),
    every launch on the tensor cores as ``tensor_core_route`` says, and
    kernel 2's backward bit-identical across two calls."""
    Dh = q.shape[-1]
    assert tensor_core_route(Dh, torch.bfloat16, tma_aligned(q, k, v, do))
    fn1, fn2 = masked_attention, train_flash_attention
    n1, t1 = fn1.launches, fn1.launches_tc
    got = fn1(q, k, v, mask)
    torch.cuda.synchronize()
    assert (fn1.launches - n1, fn1.launches_tc - t1) == (1, 1)
    assert torch.isfinite(got).all() and _close(got, masked_attention_plain(q, k, v, mask))
    for causal in (False, True):
        counts = (fn2.launches, fn2.launches_tc, fn2.backward_launches, fn2.backward_launches_tc)

        def fwd_bwd(fn):
            qg, kg, vg = (x.detach().requires_grad_(True) for x in (q, k, v))
            o = fn(qg, kg, vg, mask, causal)
            return (o.detach(), *torch.autograd.grad(o, (qg, kg, vg), do))

        got = fwd_bwd(fn2)
        torch.cuda.synchronize()
        assert (fn2.launches - counts[0], fn2.launches_tc - counts[1],
                fn2.backward_launches - counts[2], fn2.backward_launches_tc - counts[3]) == (1,) * 4
        for a, b in zip(got, fwd_bwd(train_flash_attention_plain)):
            assert torch.isfinite(a).all() and _close(a, b)
        o, lse = train_ops._forward(q, k, v, mask, causal)
        first = train_ops._backward(q, k, v, mask, o, lse, do, causal)
        second = train_ops._backward(q, k, v, mask, o, lse, do, causal)
        assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.gpu
@pytest.mark.parametrize("Tq,Tk", RAGGED)
@pytest.mark.parametrize("Dh", [8, 16, 32])
def test_tensor_core_path_at_ragged_lengths(cuda, Dh, Tq, Tk):
    _check_tensor_core_path(*_ragged_inputs(4, Tq, Tk, 2, Dh, cuda, seed=Tq * 31 + Tk + Dh))


@pytest.mark.gpu
@pytest.mark.parametrize("T", [65, 448])
@pytest.mark.parametrize("Dh", [8, 16, 32])
def test_tensor_core_path_reads_a_fused_qkv_view_in_place(cuda, Dh, T):
    q, k, v, do, mask = _ragged_inputs(4, T, T, 2, Dh, cuda, seed=T + Dh, fused=True)
    assert q.stride(1) == 3 * 2 * Dh and not q.is_contiguous()
    _check_tensor_core_path(q, k, v, do, mask)


@pytest.mark.gpu
@pytest.mark.parametrize("Dh", [8, 16, 32])
def test_unaligned_views_and_fp32_take_the_simt_kernels(cuda, Dh):
    """The same values as an unaligned view (time stride not a multiple of
    8) or in fp32: the SIMT kernels, counted as launches but not on the
    tensor cores, within the bounds of their type (kernel 2 on the
    unaligned views, forward and backward)."""
    from tts_with_diffusion_model_tpu_torch.smoke import unaligned

    q, k, v, do, mask = _ragged_inputs(4, 65, 63, 2, Dh, cuda, seed=Dh)
    ref = masked_attention_plain(q, k, v, mask)
    for args, close in (((unaligned(q), unaligned(k), unaligned(v)), _close),
                        ((q.float(), k.float(), v.float()),
                         lambda a, b: (a - b.float()).abs().max().item() <= 1e-4)):
        n, t = masked_attention.launches, masked_attention.launches_tc
        got = masked_attention(*args, mask)
        assert (masked_attention.launches - n, masked_attention.launches_tc - t) == (1, 0)
        if args[0].dtype == torch.float32:
            ref = masked_attention_plain(*args, mask)
        assert close(got.float(), ref)
    # kernel 2, forward and backward, on the unaligned views
    fn2 = train_flash_attention
    counts = (fn2.launches, fn2.launches_tc, fn2.backward_launches, fn2.backward_launches_tc)
    qu, ku, vu = (unaligned(x).requires_grad_(True) for x in (q, k, v))
    o = fn2(qu, ku, vu, mask)
    got = (o.detach(), *torch.autograd.grad(o, (qu, ku, vu), unaligned(do)))
    assert (fn2.launches - counts[0], fn2.launches_tc - counts[1],
            fn2.backward_launches - counts[2], fn2.backward_launches_tc - counts[3]) == (1, 0, 1, 0)
    qg, kg, vg = (x.detach().requires_grad_(True) for x in (q, k, v))
    o = train_flash_attention_plain(qg, kg, vg, mask)
    for a, b in zip(got, (o.detach(), *torch.autograd.grad(o, (qg, kg, vg), do))):
        assert torch.isfinite(a).all() and _close(a, b)


@pytest.mark.gpu
def test_tiny_gaussian_phase_goes_through_the_kernels(cuda, tmp_path):
    """The chip phase at a tiny size on the card: kernel launches per train
    step and per served batch equal the sites, no plain call, fp32 codes
    identical alone and in a cohort of 4."""
    from tts_with_diffusion_model_tpu_torch import smoke_gaussian, smoke_serve

    nar = smoke_serve.write_seeded_bundles(tmp_path, "tiny")[1]
    base = dict(d_model=64, n_layers=2, timesteps=3, text_len=50, prom_len=64, resp_len=48,
                gen_len=40)
    mo = {"diffusion-gaussian": dict(base, n_heads=2),
          "diffusion-gaussian-unet2d": dict(base, n_heads=1, unet_channels=[8, 16])}
    out = smoke_gaussian.phase_gaussian(
        cuda, nar, variants=(("diffusion-gaussian", 2, True), ("diffusion-gaussian-unet2d", 2,
                                                                True)),
        repeats=1, overrides=["batch_size=4", "eval_batch_size=8", "max_num_val=8", "nj=1",
                              "resp_len_buckets=[32]"],
        model_overrides=mo, corpus=(3, 12, (8, 30), (3, 12)), ref_seconds=0.5)
    dit, conv = out["diffusion-gaussian"], out["diffusion-gaussian-unet2d"]
    assert (dit["fwd_per_step"], dit["bwd_per_step"]) == (4 + 2 * 2 * 3, 4 + 2 * 3)
    assert (conv["fwd_per_step"], conv["bwd_per_step"]) == (4 + 5, 4 + 5)
    for r in (dit, conv):
        assert r["served"]["plain"] == 0 and r["served"]["launches"] == r["served"]["expected"]
        assert r["served"]["launches_tc"] == r["served"]["launches"]
        assert r["run_launches_tc"] == r["run_launches"] > 0
        assert r["cohort fp32"]["identical"]


@pytest.mark.gpu
@pytest.mark.parametrize("overrides", [
    dict(d_model=64, n_heads=1, n_layers=2, timesteps=3, text_len=50, prom_len=64, resp_len=48,
         gen_len=40, unet_channels=[8, 16]),
    dict(timesteps=3)], ids=["tiny", "full"])
def test_fp32_conv_unet_rows_do_not_depend_on_their_batch(cuda, overrides):
    """In fp32 at a fixed batch of 4, a row's denoiser outputs and tokens
    are bit-identical whether the other rows are copies of it or other
    requests: why fp32 serving runs every batch at ``max_batch``."""
    from tts_with_diffusion_model_tpu_torch.convert import init_seeded
    from tts_with_diffusion_model_tpu_torch.models import get_model
    from tts_with_diffusion_model_tpu_torch.smoke import full_fp32
    from tts_with_diffusion_model_tpu_torch.utils.rng import RowKeys

    m = get_model("diffusion-gaussian-unet2d", 1024, overrides, dtype=torch.float32)
    init_seeded(m.denoiser, 0)
    m = m.to(cuda).eval()
    c = m.config
    outs = []
    m.denoiser.conv_out.register_forward_hook(lambda mod, i, o: outs.append(o.detach().clone()))
    g = torch.Generator().manual_seed(1)
    tm = (torch.arange(c.text_len)[None] < torch.tensor([30, 12, 45, 22])[:, None]).float()
    text = torch.randint(1, 200, (4, c.text_len), generator=g) * tm.long()
    proms, pm = torch.randint(0, 1024, (4, 40, 8), generator=g), torch.ones(4, 40)
    seeds = [11, 18, 25, 32]
    with torch.no_grad(), full_fp32():
        toks = m.generate(text.to(cuda), tm.to(cuda), proms.to(cuda), pm.to(cuda),
                          RowKeys.from_seeds(seeds))
        batch = list(outs)
        for r in range(4):
            outs.clear()
            rep = [x[r:r + 1].expand(4, *x.shape[1:]).contiguous().to(cuda)
                   for x in (text, tm, proms, pm)]
            alone = m.generate(*rep, RowKeys.from_seeds([seeds[r]] * 4))
            assert len(outs) == len(batch) == c.timesteps
            assert all(torch.equal(a[0], b[r]) for a, b in zip(outs, batch))
            assert torch.equal(alone[0], toks[r])
