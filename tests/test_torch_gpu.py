"""Tests that need a CUDA card: the port's kernels against their plain
versions, and a tiny serving batch that must go through the kernels.

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
                                          (3, 7, 70, 2, 8), (1, 130, 1, 1, 16)])
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


@pytest.mark.gpu
def test_strided_qkv_split_is_read_in_place(cuda):
    qkv = torch.randn(2, 33, 3, 4, 16, device=cuda)
    km = torch.ones(2, 33, device=cuda)
    got = masked_attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], km)
    ref = masked_attention_plain(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], km)
    assert (got - ref).abs().max().item() <= 1e-4


@pytest.mark.gpu
def test_tiny_serving_batch_goes_through_the_kernel(cuda):
    out = smoke.phase_slice(cuda, "tiny", seed=0, repeats=1, ref_seconds=0.5)
    assert out["launches"] == out["expected"] > 0
