"""The port's EnCodec against the JAX package's, in fp32 on the CPU, at a
narrow width (4 base filters, 16-dim latents, 8 codebooks): identical
encode codes, decoded wavs within 1e-4, and the padding helpers."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tts_with_diffusion_model_tpu.codec import seanet as jax_seanet
from tts_with_diffusion_model_tpu.codec.encodec import EncodecModel as JaxEncodec
from tts_with_diffusion_model_tpu_torch.codec import seanet
from tts_with_diffusion_model_tpu_torch.codec.encodec import EncodecModel
from tts_with_diffusion_model_tpu_torch.convert import jax_params_to_torch

from torch_port_helpers import flatten, t, unflatten

WAV_TOL = 1e-4  # fp32 convolutions and LSTM, sums in another order
KW = dict(dimension=16, n_filters=4, n_q_total=8, bins=64)


def _wav(n, seed):
    rs = np.random.RandomState(seed)
    x = np.arange(n) / 24000
    w = 0.3 * np.sin(2 * np.pi * 140 * x) + 0.1 * np.sin(2 * np.pi * 630 * x)
    return (w + 0.02 * rs.randn(n)).astype(np.float32)[None, :, None]


@pytest.fixture(scope="module")
def codecs():
    jm = JaxEncodec(**KW)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, 1280, 1)))
    flat = flatten(params)
    rs = np.random.RandomState(1)
    for k in list(flat):  # non-trivial gains and biases
        if k.endswith(("/g", "/b")) or "/b_l" in k:
            flat[k] = (flat[k] + 0.1 * rs.randn(*flat[k].shape)).astype(np.float32)
    tm = EncodecModel(**KW)
    jax_params_to_torch(flat, tm)
    encode = jax.jit(functools.partial(jm.apply, method=JaxEncodec.encode), static_argnums=2)
    decode = jax.jit(functools.partial(jm.apply, method=JaxEncodec.decode))
    return encode, decode, unflatten(flat), tm


@pytest.mark.parametrize("n", [9600, 4000, 250])
def test_encode_codes_identical(codecs, n):
    encode, _, jp, tm = codecs
    wav = _wav(n, n)
    ref = np.asarray(encode(jp, jnp.asarray(wav), 8))
    got = tm.encode(t(wav), 8).numpy()
    np.testing.assert_array_equal(got, ref)


def test_decode_wav_matches(codecs):
    _, decode, jp, tm = codecs
    codes = np.random.RandomState(3).randint(0, KW["bins"], (2, 8, 40))
    ref = np.asarray(decode(jp, jnp.asarray(codes)))
    got = tm.decode(t(codes)).numpy()
    assert got.shape == ref.shape == (2, 40 * 320, 1)
    np.testing.assert_allclose(got, ref, atol=WAV_TOL)


def test_decoder_is_causal_so_padded_tails_trim_exactly(codecs):
    tm = codecs[-1]
    codes = torch.from_numpy(np.random.RandomState(4).randint(0, KW["bins"], (1, 8, 30)))
    padded = torch.cat([codes, torch.zeros((1, 8, 18), dtype=codes.dtype)], -1)
    short, long = tm.decode(codes), tm.decode(padded)
    torch.testing.assert_close(long[:, : 30 * 320], short, atol=1e-5, rtol=0)


@pytest.mark.parametrize("T,left,right", [(10, 3, 0), (2, 6, 1), (5, 0, 4)])
def test_pad1d_reflect_matches_short_input_rule(T, left, right):
    x = np.random.RandomState(T).randn(1, T, 3).astype(np.float32)
    ref = np.asarray(jax_seanet.pad1d(jnp.asarray(x), left, right, "reflect"))
    got = seanet.pad1d(t(x).transpose(1, 2), left, right, "reflect").transpose(1, 2).numpy()
    np.testing.assert_array_equal(got, ref)


def test_host_codec_wrapper_matches_the_model(codecs):
    from tts_with_diffusion_model_tpu_torch.codec.encodec import Codec

    tm = codecs[-1]
    codec = Codec(tm, "cpu")
    wav = _wav(3200, 7)[0, :, 0]
    codes = codec.encode(wav, 24000)
    np.testing.assert_array_equal(codes, tm.encode(t(wav)[None, :, None], 8)[0].numpy())
    out, sr = codec.decode(codes)
    assert sr == 24000 and out.shape == (codes.shape[1] * 320,)
    np.testing.assert_array_equal(out, tm.decode(t(codes)[None])[0, :, 0].numpy())
