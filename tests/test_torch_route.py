"""The route rule of both attention kernels (``ops/route.tensor_core_route``,
the wrappers' statement of the route each library applies and reports,
and ``masked_attention.kernel_width``): tensor cores for bf16 at every
site the main paths give the kernels at registry widths (head widths 8,
16, 32 and 64, fused qkv views included) and at every width up to 256 (a
width that is not a multiple of 8 on the wrappers' zero-padded copies,
``masked_attention.pad_for_tensor_cores``), SIMT for fp32 and for
unaligned views at a multiple of 8, and no kernel past 256; the padded
copies' shapes, zeros and scale.  Runs on the CPU: tensors are allocated,
not filled (the padding tests fill them); the libraries' own routes are
held to this rule on the card (``chip_smoke.py``,
``tests/test_torch_gpu.py``, ``tests/test_torch_gaussian_gpu.py``,
``tests/test_torch_wide_gpu.py``)."""

import pytest
import torch

from tts_with_diffusion_model_tpu_torch import smoke, smoke_gaussian, smoke_train
from tts_with_diffusion_model_tpu_torch.models.diffusion import DiffusionConfig
from tts_with_diffusion_model_tpu_torch.ops.masked_attention import (
    MAX_DH,
    kernel_width,
    masked_attention_plain,
    pad_for_tensor_cores,
    padded_width,
)
from tts_with_diffusion_model_tpu_torch.ops.route import tensor_core_route, tma_aligned
from tts_with_diffusion_model_tpu_torch.ops.train_flash_attention import (
    train_flash_attention_plain,
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
    assert sites and widths <= {8, 16, 32, 64}
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
    # "Dh 24" / "Dh 40": fp32 at a width between two instantiations (bf16
    # there takes the tensor cores, test_route_by_width)
    Dh = {"Dh 24": 24, "Dh 40": 40}.get(case, 32)
    dtype = torch.float32 if case in ("fp32", "Dh 24", "Dh 40") else torch.bfloat16
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


@pytest.mark.parametrize("Dh", [0, 257, 264, 512])
def test_refused_widths(Dh):
    # no kernel takes these widths: the wrappers raise on the card
    assert not kernel_width(Dh)
    with pytest.raises(ValueError):
        tensor_core_route(Dh, torch.bfloat16, True)


#: (Dh, the route of an aligned bf16 call, of an fp32 call)
ROUTES = [(4, "tc", "simt"), (8, "tc", "simt"), (12, "tc", "simt"), (16, "tc", "simt"),
          (24, "tc", "simt"), (32, "tc", "simt"), (40, "tc", "simt"), (56, "tc", "simt"),
          (64, "tc", "simt"), (72, "tc", "simt"), (80, "tc", "simt"), (96, "tc", "simt"),
          (120, "tc", "simt"), (128, "tc", "simt"), (130, "tc", "simt"),
          (136, "tc", "simt"), (200, "tc", "simt"), (250, "tc", "simt"), (256, "tc", "simt"),
          (257, "none", "none")]


def _route(Dh, dtype, aligned=True):
    if not kernel_width(Dh):
        return "none"
    return "tc" if tensor_core_route(Dh, dtype, aligned) else "simt"


@pytest.mark.parametrize("Dh,bf16,fp32", ROUTES, ids=[f"Dh {r[0]}" for r in ROUTES])
def test_route_by_width(Dh, bf16, fp32):
    """The route table by head width and dtype: every width up to 256 on
    the tensor cores in bf16, SIMT in fp32; an unaligned bf16 view on SIMT
    at a multiple of 8, on the tensor cores otherwise (the padded copy is
    contiguous); none past 256."""
    assert _route(Dh, torch.bfloat16) == bf16
    assert _route(Dh, torch.float32) == fp32
    unaligned = "none" if bf16 == "none" else "simt" if Dh % 8 == 0 else "tc"
    assert _route(Dh, torch.bfloat16, aligned=False) == unaligned


def test_kernel_widths_are_1_to_256_and_the_tensor_cores_take_multiples_of_8_to_128():
    """Every width the kernels take (1 to 256) runs on the tensor cores in
    bf16: the multiples of 8 to 128 as before, and since the ``Width<256>``
    instantiation and the padded copies every other width up to 256."""
    assert MAX_DH == 256
    assert [d for d in range(300) if kernel_width(d)] == list(range(1, 257))
    tc = [d for d in range(1, 257) if tensor_core_route(d, torch.bfloat16, True)]
    assert tc == list(range(1, 257))
    assert set(range(8, 129, 8)) <= set(tc)
    assert [d for d in range(1, 257) if tensor_core_route(d, torch.bfloat16, False)] == [
        d for d in range(1, 257) if d % 8]


@pytest.mark.parametrize("Dh,want", [(1, 8), (4, 8), (8, 8), (12, 16), (130, 136), (250, 256),
                                     (256, 256)])
def test_padded_width_is_the_next_multiple_of_8(Dh, want):
    assert padded_width(Dh) == want


@pytest.mark.parametrize("Dh", [4, 12, 130, 250])
def test_bf16_widths_off_8_are_padded_to_contiguous_copies(Dh):
    """bf16 q, k, v at a width off 8 (an unaligned view included) become
    contiguous copies at ``padded_width`` whose first Dh columns are the
    inputs' and the rest zeros; fp32 and the multiples of 8 pass through as
    the same tensors."""
    g = torch.Generator().manual_seed(Dh)
    q, k, v = (torch.randn(2, T, 3, Dh, generator=g).to(torch.bfloat16) for T in (5, 7, 7))
    view = smoke.unaligned(k)
    padded = pad_for_tensor_cores(q, view, v)
    W = padded_width(Dh)
    for src, dst in zip((q, view, v), padded):
        assert dst.shape == (*src.shape[:-1], W) and dst.is_contiguous()
        assert dst.dtype == torch.bfloat16 and tma_aligned(dst)
        assert torch.equal(dst[..., :Dh], src) and not dst[..., Dh:].any()
    fp32 = tuple(x.float() for x in (q, k, v))
    assert all(a is b for a, b in zip(pad_for_tensor_cores(*fp32), fp32))
    eight = torch.zeros(2, 5, 3, 16, dtype=torch.bfloat16)
    assert pad_for_tensor_cores(eight, eight, eight)[0] is eight


@pytest.mark.parametrize("Dh,causal", [(4, False), (12, True), (130, False), (250, True)])
def test_padded_copies_at_the_true_scale_give_the_attention_at_dh(Dh, causal):
    """What the wrappers launch at a width off 8 (the kernel's arithmetic, in
    its plain version): attention over the padded copies with the true
    width's Dh^-0.5 (here q scaled by sqrt(W / Dh) against the plain
    version's W^-0.5), sliced back to Dh, equals the attention at Dh,
    forward and dq, dk, dv (autograd through the pad slices the
    gradients); the padded width's own scale would not."""
    g = torch.Generator().manual_seed(Dh)
    q, k, v = (torch.randn(2, T, 2, Dh, generator=g) for T in (9, 11, 11))
    do = torch.randn(2, 9, 2, Dh, generator=g)
    km = torch.ones(2, 11)
    km[1, 6:] = 0
    W = padded_width(Dh)
    lift = (W / Dh) ** 0.5

    def pad(x):
        return torch.nn.functional.pad(x, (0, W - Dh))

    ref = masked_attention_plain(q, k, v, km)
    got = masked_attention_plain(pad(q * lift), pad(k), pad(v), km)[..., :Dh]
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)
    wrong = masked_attention_plain(pad(q), pad(k), pad(v), km)[..., :Dh]
    assert (wrong - ref).abs().max() > 1e-3

    def grads(padded):
        xs = [x.clone().requires_grad_(True) for x in (q, k, v)]
        ins = [pad(xs[0] * lift), pad(xs[1]), pad(xs[2])] if padded else xs
        o = train_flash_attention_plain(*ins, km, causal)[..., :Dh]
        return (o.detach(), *torch.autograd.grad(o, xs, do))

    for a, b in zip(grads(True), grads(False)):
        assert a.shape == b.shape
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
