"""The port's EnCodec checkpoint converter against the JAX package's on a
seeded state dict in the published checkpoint's key layout
(``tests/torch_encodec_oracle.py``): identical arrays under identical keys
for the official, HF ``transformers`` and parametrized-weight-norm layouts;
the port's codec on the converted file encodes the oracle's wav to the
oracle's codes; the CLI and the verification battery."""

import re

import numpy as np
import pytest
import torch

from tts_with_diffusion_model_tpu.codec import convert as jconv
from tts_with_diffusion_model_tpu_torch.codec import convert as tconv

from torch_encodec_oracle import HOP, TorchEncodec24k


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, key) if isinstance(v, dict) else {key: np.asarray(v)})
    return out


@pytest.fixture(scope="module")
def oracle():
    model = TorchEncodec24k(seed=0)
    return model, model.checkpoint_state_dict()


def _hf(sd):
    out = {}
    for k, v in sd.items():
        k = re.sub(r"^(encoder|decoder)\.model\.", r"\1.layers.", k).replace(".convtr.", ".conv.")
        k = re.sub(r"^quantizer\.vq\.layers\.(\d+)\._codebook\.embed$",
                   r"quantizer.layers.\1.codebook.embed", k)
        k = k.replace(".weight_g", ".parametrizations.weight.original0")
        out[k.replace(".weight_v", ".parametrizations.weight.original1")] = v
    return out


def _official(sd):
    return {k.replace(".conv.weight", ".conv.conv.weight").replace(".conv.bias", ".conv.conv.bias")
            .replace(".convtr.weight", ".convtr.convtr.weight")
            .replace(".convtr.bias", ".convtr.convtr.bias"): v for k, v in sd.items()}


@pytest.mark.parametrize("layout", ["canonical", "hf", "official"])
def test_conversion_matches_jax(oracle, layout):
    _, sd = oracle
    sd = {"canonical": sd, "hf": _hf(sd), "official": _official(sd)}[layout]
    got, ref = _flat(tconv.convert_state_dict(sd)), _flat(jconv.convert_state_dict(sd))
    assert got.keys() == ref.keys() and len(got) > 100
    for k in ref:
        assert got[k].dtype == ref[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], ref[k])


def test_cli_file_equals_jax_and_encodes_to_oracle_codes(oracle, tmp_path):
    """The CLI's ``.npz`` from a tensors-only checkpoint holds the JAX
    converter's arrays under its keys; the port's codec on it encodes the
    oracle's wav to the oracle's codes, and passes the battery."""
    from tts_with_diffusion_model_tpu_torch.bundle import load_npz
    from tts_with_diffusion_model_tpu_torch.codec.encodec import load_codec

    model, sd = oracle
    ckpt = tmp_path / "encodec_24khz.th"
    torch.save({"best_state": {k: torch.from_numpy(v) for k, v in sd.items()}}, ckpt)
    out = tmp_path / "encodec.npz"
    assert tconv.main([str(ckpt), str(out)]) is None
    jax_out = tmp_path / "jax.npz"
    jconv.save_npz_params(jconv.convert_state_dict(jconv.load_torch_checkpoint(ckpt)), jax_out)
    got, ref = load_npz(out), dict(np.load(jax_out))
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k])

    t = np.arange(HOP * 16) / 24_000.0
    wav = (0.5 * np.sin(2 * np.pi * 220 * t) + 0.2 * np.sin(2 * np.pi * 1320 * t)).astype(np.float32)
    with torch.no_grad():
        want = model.rvq_encode(model.encode_latents(torch.from_numpy(wav)[None, None]), 8)[0]
    codes = load_codec(out, device="cpu").encode(wav, 24_000)
    np.testing.assert_array_equal(codes, want.numpy())

    report = tconv.verify_params(got, device="cpu")
    assert report["ok"] and report["codes_shape"] == [1, 8, 16], report
