"""The port's codec training path against the JAX package's on the CPU: the
STFT and multi-scale losses, the reconstruction objective with every
gradient on a tiny codec (16-code codebooks), the training-path methods, and
the wav segment loader's batches.  fp32; tolerances stated per test."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tts_with_diffusion_model_tpu.codec import losses as jl
from tts_with_diffusion_model_tpu.codec.encodec import EncodecModel as JaxEncodec
from tts_with_diffusion_model_tpu_torch.codec import losses as tl
from tts_with_diffusion_model_tpu_torch.codec.encodec import HOP, EncodecModel
from tts_with_diffusion_model_tpu_torch.convert import jax_params_to_torch, tree_path

from torch_port_helpers import flatten, seeded_flax_params, t, unflatten

TINY = dict(dimension=16, n_filters=4, n_q_total=8, bins=16)


def _rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max() / max(1e-12, np.abs(b).max()))


@pytest.mark.parametrize("T", [1500, 4800])
def test_stft_and_multiscale_loss_match_jax(T):
    """1500 samples skip the 2048 scale (and 4800 takes all four); the
    magnitudes and the loss within 1e-5 relative."""
    rs = np.random.RandomState(T)
    x, y = rs.randn(2, T).astype(np.float32), rs.randn(2, T).astype(np.float32)
    for frame in (256, 512, 1024, 2048):
        if T < frame:
            continue
        got = tl.stft_mag(t(x), frame, frame // 4).numpy()
        ref = np.asarray(jax.jit(jl.stft_mag, static_argnums=(1, 2))(jnp.asarray(x), frame,
                                                                      frame // 4))
        assert got.shape == ref.shape
        assert _rel(got, ref) <= 1e-5, frame
    got = float(tl.multiscale_stft_loss(t(x), t(y)))
    ref = float(jax.jit(jl.multiscale_stft_loss)(jnp.asarray(x), jnp.asarray(y)))
    assert abs(got - ref) <= 1e-5 * abs(ref)
    assert float(tl.multiscale_stft_loss(t(x[:, :200]), t(y[:, :200]))) == 0.0


def test_vq_losses_and_straight_through():
    z = torch.tensor([[1.0, 2.0]], requires_grad=True)
    zq = torch.tensor([[1.5, 1.5]], requires_grad=True)
    cb, commit = tl.vq_losses(z, zq)
    assert float(cb.detach()) == pytest.approx(0.25)
    assert float(commit.detach()) == pytest.approx(0.25 * 0.25)
    tl.straight_through(z, zq).sum().backward()
    np.testing.assert_array_equal(z.grad.numpy(), [[1.0, 1.0]])
    assert zq.grad is None


@pytest.fixture(scope="module")
def tiny_codec():
    """The same perturbed weights in both packages' tiny codec, and a batch
    of two 1280-sample wavs (4 frames: the 2048 scale is skipped)."""
    model = EncodecModel(**TINY)
    flat = seeded_flax_params(model, 5)
    jax_params_to_torch(flat, model)
    rs = np.random.RandomState(1)
    n = np.arange(HOP * 4) / 24_000
    wav = np.stack([0.4 * np.sin(2 * np.pi * 220 * n), 0.3 * np.sin(2 * np.pi * 660 * n)])
    wav = (wav + 0.05 * rs.randn(*wav.shape)).astype(np.float32)[..., None]
    return model, flat, wav


def test_reconstruction_loss_and_gradients_match_jax(tiny_codec):
    """The loss and its four stats within 1e-5 relative; every gradient (v,
    g, biases, LSTM, codebooks) within 1e-4·max(1, |ref|).  torch's LSTM
    splits flax's one bias per layer in two, each taking its gradient."""
    model, flat, wav = tiny_codec
    jmodel = JaxEncodec(**TINY)
    params = {"params": unflatten({k[len("params/"):]: v for k, v in flat.items()})}

    def loss_fn(p):
        return jl.codec_reconstruction_loss(jmodel, p, jnp.asarray(wav), num_quantizers=8)

    grad_fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    (ref_loss, ref_stats), ref_grads = grad_fn(params)
    model.zero_grad()
    loss, stats = tl.codec_reconstruction_loss(model, t(wav), num_quantizers=8)
    loss.backward()
    assert abs(float(loss.detach()) - float(ref_loss)) <= 1e-5 * abs(float(ref_loss))
    for k in ("stft", "l1", "codebook", "commit"):
        got = float(stats[k].detach())
        assert abs(got - float(ref_stats[k])) <= 1e-5 * abs(float(ref_stats[k])), k

    ref = flatten(ref_grads["params"])
    seen = set()
    for name, p in model.named_parameters():
        assert p.grad is not None, name
        g = p.grad.numpy()
        if ".lstm.lstm." in name:
            kind, n = name.rsplit(".", 1)[1].rsplit("_l", 1)
            owner = name.split(".lstm.lstm.")[0].replace(".", "/") + "/lstm"
            key = f"{owner}/{'b' if kind.startswith('bias') else 'w_' + kind[7:]}_l{n}"
            r = ref[key] if kind.startswith("bias") else ref[key].T
        else:
            key = tree_path(model, name)
            r = ref[key]
            leaf = key.rsplit("/", 1)[1]
            if leaf == "v":
                r = r.transpose(1, 2, 0) if "/up_" in key else r.transpose(2, 1, 0)
            elif leaf == "g":
                r = r.reshape(-1, 1, 1)
        seen.add(key)
        err = np.abs(g - r).max()
        assert err <= 1e-4 * max(1.0, np.abs(r).max()), (name, err)
    assert seen == set(ref)


def test_training_path_methods_carry_gradients(tiny_codec):
    """``encode_latents`` → ``quantize_latents`` → ``decode_latents`` is the
    no-grad ``encode`` / ``decode`` with gradients (the same codes; the
    wav within 1e-6, the LSTM's kernels differing with autograd on), the
    codebooks reached through z_q."""
    model, _, wav = tiny_codec
    model.zero_grad()
    x = t(wav)
    z = model.encode_latents(x)
    z_q, codes = model.quantize_latents(z, 8)
    torch.testing.assert_close(codes, model.encode(x, 8), rtol=0, atol=0)
    torch.testing.assert_close(model.decode_latents(z_q), model.decode(codes), rtol=0, atol=1e-6)
    z_q.sum().backward()
    assert model.quantizer.codebooks.grad[:8].abs().sum() > 0


def test_wav_segment_loader_matches_jax(tmp_path):
    """The same files and seed give the same segments (Python
    ``random.Random``), long files cut and short ones tiled."""
    from tts_with_diffusion_model_tpu.audio.wavio import write_wav
    from tts_with_diffusion_model_tpu.codec.train import WavSegmentLoader as JaxLoader
    from tts_with_diffusion_model_tpu_torch.codec.train import WavSegmentLoader

    rs = np.random.RandomState(0)
    for i, seconds in enumerate((0.5, 0.05, 0.3)):
        d = tmp_path / f"spk{i}"
        d.mkdir()
        write_wav(d / "a.wav", 0.3 * rs.randn(int(seconds * 24_000)).astype(np.float32), 24_000)
    a = iter(WavSegmentLoader([tmp_path], batch_size=3, segment_frames=10, seed=7))
    b = iter(JaxLoader([tmp_path], batch_size=3, segment_frames=10, seed=7))
    for _ in range(4):
        x, y = next(a)["wav"], next(b)["wav"]
        assert x.shape == (3, 10 * HOP, 1) and x.dtype == np.float32
        np.testing.assert_array_equal(x, y)
