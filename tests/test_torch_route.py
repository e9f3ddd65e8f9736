"""The route rule of both attention kernels (``ops/route.tensor_core_route``,
the Python statement of ``hopper::tensor_core_route`` that each library
applies and reports): tensor cores for bf16 at every site the main paths
give the kernels at registry widths (head widths 8, 16, 32 and 64, fused
qkv views included), SIMT for fp32, unaligned views and other widths, and
a refusal past 64.  Runs on the CPU: tensors are allocated, not filled; the
libraries' own routes are held to this rule on the card (``chip_smoke.py``,
``tests/test_torch_gaussian_gpu.py``)."""

import pytest
import torch

from tts_with_diffusion_model_tpu_torch import smoke, smoke_gaussian, smoke_train
from tts_with_diffusion_model_tpu_torch.models.diffusion import DiffusionConfig
from tts_with_diffusion_model_tpu_torch.ops.route import (
    TENSOR_CORE_WIDTHS,
    tensor_core_route,
    tma_aligned,
)

NAR = {"d_model": 1024, "n_heads": 16, "n_layers": 12}


def _tensors(B, Tq, Tk, H, Dh, dtype, fused=False):
    """q, k, v and the output as the wrappers see them (B cut to 2: the
    rule reads strides and the base, not the batch size)."""
    B = min(B, 2)
    if fused:
        q, k, v = torch.empty(B, Tq, 3, H, Dh, dtype=dtype).unbind(2)
    else:
        q, k, v = (torch.empty(B, T, H, Dh, dtype=dtype) for T in (Tq, Tk, Tk))
    return q, k, v, torch.empty(B, Tq, H, Dh, dtype=dtype)


def _sites(which):
    """(name, B, Tq, Tk, H, Dh, fused) of a site list at registry widths."""
    if which == "gaussian serve":
        return [(s.name, 4, s.Tq, s.Tk, s.H, s.Dh, False)
                for s in smoke_gaussian.kernel_sites(256, 4, 32, 192)[0]]
    if which == "gaussian train":
        return [(s.name, s.B, s.Tq, s.Tk, s.H, s.Dh, s.fused)
                for s in smoke_gaussian.kernel_sites(256, 4, 32, 192)[1]]
    if which == "d3pm serve":
        return [(s.name, 4, s.Tq, s.Tk, s.H, s.Dh, False)
                for pb in (128, 256, 384, 398)
                for s in smoke.attention_sites(DiffusionConfig(), NAR, 12, pb)]
    if which == "d3pm train":
        cfg, model = smoke_train.recipe(smoke_train.TRAIN_YAML)
        return [(s.name, s.B, s.Tq, s.Tk, s.H, s.Dh, s.fused)
                for s in smoke_train.step_sites(model, cfg)]
    return [(s.name, s.B, s.Tq, s.Tk, s.H, s.Dh, s.fused)
            for s in [*smoke_train.packed_sites(),
                      *smoke_train.ar_prefill_sites((128, 256, 384, 398), 256)]]


@pytest.mark.parametrize("which", ["gaussian serve", "gaussian train", "d3pm serve",
                                   "d3pm train", "nar and ar packed"])
def test_every_bf16_site_takes_the_tensor_cores(which):
    sites = _sites(which)
    widths = {s[5] for s in sites}
    assert sites and widths <= set(TENSOR_CORE_WIDTHS)
    for name, B, Tq, Tk, H, Dh, fused in sites:
        ts = _tensors(B, Tq, Tk, H, Dh, torch.bfloat16, fused)
        assert tma_aligned(*ts), name
        assert tensor_core_route(Dh, torch.bfloat16, tma_aligned(*ts)), name
        # the same site in fp32 runs the SIMT kernels, summed in fp32 throughout
        assert not tensor_core_route(Dh, torch.float32, True), name


def test_the_gaussian_sites_cover_head_widths_8_16_and_32():
    serve, train = smoke_gaussian.kernel_sites(256, 4, 32, 192)
    assert {s.Dh for s in serve} == {s.Dh for s in train} == {8, 16, 32}


@pytest.mark.parametrize("case", ["fp32", "time stride", "batch stride", "base", "Dh 24",
                                  "Dh 40"])
def test_simt_route(case):
    Dh = {"Dh 24": 24, "Dh 40": 40}.get(case, 32)
    dtype = torch.float32 if case == "fp32" else torch.bfloat16
    q, k, v, o = _tensors(2, 50, 63, 2, Dh, dtype)
    if case == "time stride":
        k = smoke.unaligned(k)  # time stride H·Dh + 4
        assert k.stride(1) % 8 == 4
    elif case == "batch stride":
        buf = torch.empty(2 * 50 * 2 * Dh + 4, dtype=dtype)
        q = torch.as_strided(buf, (2, 50, 2, Dh), (50 * 2 * Dh + 4, 2 * Dh, Dh, 1))
    elif case == "base":
        q = torch.empty(2 * 50 * 2 * Dh + 1, dtype=dtype)[1:].view(2, 50, 2, Dh)
    aligned = tma_aligned(q, k, v, o)
    assert aligned == (case in ("fp32", "Dh 24", "Dh 40"))
    assert not tensor_core_route(Dh, dtype, aligned)


def test_size_one_dimensions_are_not_checked():
    # a single batch row or time step has no stride to align
    t = torch.as_strided(torch.empty(64, dtype=torch.bfloat16), (1, 1, 2, 8), (3, 5, 8, 1))
    assert tma_aligned(t)
    assert tensor_core_route(8, torch.bfloat16, tma_aligned(t))


@pytest.mark.parametrize("Dh", [72, 128, 12, 0])
def test_refused_widths(Dh):
    with pytest.raises(ValueError):
        tensor_core_route(Dh, torch.bfloat16, True)
