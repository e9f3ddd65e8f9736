"""Tests of the Gaussian family that need a CUDA card: both kernels against
their plain versions at the head widths the Gaussian denoisers give them
(32, 16, 8; SIMT on every one), and a tiny Gaussian run of the chip phase
(train, export, serve, the fp32 cohort) whose attention must go through the
kernels.  Like ``test_torch_gpu.py`` they import neither jax nor the JAX
package: ``python -m pytest --noconftest -m gpu
tests/test_torch_gaussian_gpu.py``.  Without a card each test skips."""

import numpy as np
import pytest
import torch

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
        assert r["cohort fp32"]["identical"]
