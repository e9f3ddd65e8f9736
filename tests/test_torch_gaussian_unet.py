"""The port's conv-UNet and UNet2DCondition denoisers against the JAX
package (the helpers and sizes of ``test_torch_gaussian.py``): the conv-UNet's
bucket invariance, and the UNet2DCondition topology at the JAX tests'
channels (8, 16, 32, 32).

The UNet2DCondition is held twice.  In fp32 at resp 64 with the JAX
package's own init weights, unperturbed, every check within
1e-4·max(1, |ref|): its conditioning stream, the UNet's output and every
gradient over a unit-scale stream, and the whole denoiser's ε̂.  And in
float64 at resp 16 with perturbed weights (so biases and norm scales take
part): ε̂, the loss at a fixed t and noise, and every gradient of the whole
denoiser, conditioning side included.  Two things make an fp32 comparison
of the perturbed denoiser ill-conditioned, in either package's own
arithmetic: at resp 16 its bottom level has 2 frames, and a GroupNorm
group of one channel over 2 frames can have a variance near 0 (1e-2 at the
output); a 0.1 perturbation makes the 1280-fan-in projections of its cross
stream ~3.5× their init scale, so its 2-key cross-attention sees logits of
order 10² and turns the conditioning's fp32 rounding (3e-5) into 1e-3 to
1e-2 at ε̂.  Hence float64 there, with every fp32 cast of both packages
lifted.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_gaussian import _batch, _cfg, _check_eps_loss_and_gradients, _close
from torch_port_helpers import (  # noqa: F401 (one_thread: fixture)
    flatten,
    one_thread,
    perturbed,
    t,
    unflatten,
)
from tts_with_diffusion_model_tpu.models.gaussian_tts import GaussianConfig as JConfig
from tts_with_diffusion_model_tpu.models.gaussian_tts import GaussianDiffusionModel as JModel
from tts_with_diffusion_model_tpu.models.unet2dcond import UNet2DConditionNet
from tts_with_diffusion_model_tpu_torch.convert import (init_seeded, jax_params_to_torch,
                                                         torch_params_to_jax)
from tts_with_diffusion_model_tpu_torch.models.gaussian_tts import (GaussianConfig,
                                                                    GaussianDiffusionModel)

pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.fixture(scope="module")
def unet2d_init():
    """The JAX package's init of the small UNet2DCondition denoiser, flat in
    fp32 (its shapes do not depend on ``resp_len``), shared by both tests."""
    jm = JModel(JConfig(**_cfg("unet2d-ref", 16)), dtype=jnp.float32)
    return perturbed(jax.jit(jm.init)(jax.random.PRNGKey(0)), 1, scale=0.0)


def _unet2d_pair(flat, resp_len, jdtype, tdtype):
    jm = JModel(JConfig(**_cfg("unet2d-ref", resp_len)), dtype=jdtype)
    pm = GaussianDiffusionModel(GaussianConfig(**_cfg("unet2d-ref", resp_len)), dtype=tdtype)
    jax_params_to_torch(flat, pm.denoiser)
    pm.denoiser.to(tdtype)
    return jm, unflatten({k: v.astype(jdtype) for k, v in flat.items()}), pm


def test_conv_unet_masked_norm_bucket_invariant():
    """The JAX test of the same name, on the port: the same utterance at a
    16- and a 32-frame bucket gives the same ε̂ at its 12 valid frames, 0
    beyond."""
    from tts_with_diffusion_model_tpu_torch.models.unet import ConvUNetDenoiser

    den = ConvUNetDenoiser(in_dim=4, d_model=16, n_heads=1, n_classes=33, n_prom_levels=8,
                           timesteps=6, channels=(8, 16), dtype=torch.float32)
    init_seeded(den, 11)
    r = np.random.default_rng(5)
    text, tm = t(r.integers(1, 33, (1, 5))), torch.ones(1, 5)
    proms, pm = t(r.integers(0, 33, (1, 7, 8))), torch.ones(1, 7)
    tt = torch.tensor([3])
    valid = 12
    x = r.normal(size=(valid, 4)).astype(np.float32)
    outs = []
    with torch.no_grad():
        for n in (16, 32):
            xs, m = torch.zeros(1, n, 4), torch.zeros(1, n)
            xs[0, :valid], m[0, :valid] = t(x), 1
            outs.append(den(text, tm, proms, pm, xs, m, tt))
    np.testing.assert_allclose(outs[1][0, :valid].numpy(), outs[0][0, :valid].numpy(),
                               rtol=1e-4, atol=1e-5)
    assert float(outs[1][0, valid:].abs().sum()) == 0.0


def test_unet2d_ref_conditioning_unet_and_eps_match(unet2d_init):
    R = 64
    jm, params, pm = _unet2d_pair(unet2d_init, R, jnp.float32, torch.float32)
    b = _batch(R)
    jb = [jnp.asarray(b[k]) for k in ("text", "text_mask", "proms", "prom_mask")]
    pb = [t(b[k]) for k in ("text", "text_mask", "proms", "prom_mask")]
    cj, _ = jm.denoiser.apply(params, *jb, method="conds")
    with torch.no_grad():
        cp, mp = pm.denoiser.conds(*pb)
    _close(cp, cj, "conditioning stream")
    assert torch.equal(mp, torch.ones(3, 2))

    rs = np.random.RandomState(3)
    x = rs.randn(3, R, 1).astype(np.float32)
    tt = np.array([1, 3, 5])
    ctx = rs.randn(3, 2, 1280).astype(np.float32)
    w = rs.randn(3, 1, R, 1).astype(np.float32)
    net = UNet2DConditionNet(block_out_channels=(8, 16, 32, 32), n_heads=2, out_channels=1,
                             dtype=jnp.float32)
    up = {"params": params["params"]["unet"]}

    def objective(p):
        y = net.apply(p, jnp.asarray(x)[:, None], jnp.asarray(tt), jnp.asarray(ctx))
        return (y * w).sum(), y

    (_, ref_y), ref_g = jax.jit(jax.value_and_grad(objective, has_aux=True))(up)
    y = pm.denoiser.unet(t(x)[:, None], t(tt), t(ctx))
    _close(y.detach(), ref_y, "UNet output")
    (y * t(w)).sum().backward()
    unet = pm.denoiser.unet
    grads = torch_params_to_jax(unet, {n: p.grad for n, p in unet.named_parameters()})
    refg = {k.removeprefix("params/"): v for k, v in flatten(ref_g).items()}
    assert set(grads) == set(refg)
    for key, r in refg.items():
        _close(grads[key], r, f"UNet grad {key}")

    rm = np.ones((3, R), np.float32)
    rm[1, R - 4:] = 0
    ref = jax.jit(jm.denoiser.apply)(params, *jb, jnp.asarray(x), jnp.asarray(rm),
                                     jnp.asarray(tt))
    with torch.no_grad():
        got = pm.denoiser(*pb, t(x), t(rm), t(tt))
    _close(got, ref, "eps")
    assert float(got[1, R - 4:].abs().sum()) == 0.0


class _Lifted:
    """A module's ``jnp`` or ``torch`` whose ``float32`` reads as float64."""

    def __init__(self, lib, wide):
        self._lib, self.float32 = lib, wide

    def __getattr__(self, name):
        return getattr(self._lib, name)


@pytest.fixture
def float64(monkeypatch):
    """JAX in x64, and every fp32 cast on the UNet2DCondition's path lifted
    to float64 in both packages: ``jnp.float32`` / ``torch.float32`` /
    ``np.float32`` in the modules that name them, and ``Tensor.float()``."""
    import tts_with_diffusion_model_tpu.diffusion.gaussian as j_process
    import tts_with_diffusion_model_tpu.models.gaussian_tts as j_model
    import tts_with_diffusion_model_tpu.models.unet2dcond as j_unet
    import tts_with_diffusion_model_tpu_torch.diffusion.gaussian as p_process
    import tts_with_diffusion_model_tpu_torch.models.base as p_base
    import tts_with_diffusion_model_tpu_torch.models.gaussian_tts as p_model
    import tts_with_diffusion_model_tpu_torch.models.unet2dcond as p_unet

    for mod in (j_process, j_model, j_unet):
        monkeypatch.setattr(mod, "jnp", _Lifted(jnp, jnp.float64))
    for mod in (p_base, p_model, p_unet):
        monkeypatch.setattr(mod, "torch", _Lifted(torch, torch.float64))
    monkeypatch.setattr(p_process, "np", _Lifted(np, np.float64))
    monkeypatch.setattr(torch.Tensor, "float", lambda self, *a, **k: self.double())
    with jax.enable_x64(True):
        yield


def test_unet2d_ref_perturbed_eps_loss_and_gradients_match_in_float64(float64, unet2d_init):
    R = 16
    flat = perturbed(unflatten(unet2d_init), 1, scale=0.1)
    jm, params, pm = _unet2d_pair(flat, R, jnp.float64, torch.float64)
    assert params["params"]["unet"]["conv_in"]["kernel"].dtype == jnp.float64
    assert pm.denoiser.unet.conv_in.weight.dtype == torch.float64
    noise = np.random.RandomState(3).randn(3, R, 1)
    # the whole denoiser's gradients: the conditioning side's too
    assert any(n.startswith("encoder") for n, _ in pm.denoiser.named_parameters())
    _check_eps_loss_and_gradients(jm, params, pm, _batch(R), np.array([1, 3, 5]), noise,
                                  "unet2d-ref float64", rel=1e-6)
