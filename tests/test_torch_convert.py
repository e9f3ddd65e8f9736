"""The weight carry-over and the port's isolation: every array of the
committed zoo bundles lands in a port parameter of the right shape with none
left over, f16 bundles are upcast, and the port and ``chip_smoke.py`` import
with ``jax`` and ``flax`` blocked."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tts_with_diffusion_model_tpu_torch.bundle import load_bundle, load_npz
from tts_with_diffusion_model_tpu_torch.codec.encodec import EncodecModel
from tts_with_diffusion_model_tpu_torch.convert import init_seeded, jax_params_to_torch
from tts_with_diffusion_model_tpu_torch.models.base import Dense
from tts_with_diffusion_model_tpu_torch.serve import build_model
from tts_with_diffusion_model_tpu_torch.utils.precision import cast_params_bf16

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "tts_with_diffusion_model_tpu_torch"
ZOO = REPO / "zoo"


def _needs(path: Path):
    if not path.exists():
        pytest.skip(f"{path.relative_to(REPO)} is not in this checkout")


@pytest.mark.parametrize("bundle", ["diffusion", "nar", "ar"])
def test_zoo_bundle_lands_in_port_parameters(bundle):
    _needs(ZOO / bundle / "params.npz")
    flat, meta, phones, _ = load_bundle(ZOO / bundle)
    assert all(a.dtype != np.float16 for a in flat.values())
    model = build_model(meta, torch.float32)
    target = model.denoiser if bundle == "diffusion" else model
    n_port = sum(1 for _ in target.parameters())
    jax_params_to_torch(flat, target)  # raises on leftovers / unset params
    assert n_port == len(flat) and phones
    key = ("params/final/kernel" if bundle == "diffusion" else "params/base/classifier/kernel")
    head = target.final if bundle == "diffusion" else target.base.classifier
    np.testing.assert_array_equal(head.weight.detach().numpy(), flat[key].T)


def test_zoo_codec_lands_in_port_parameters():
    _needs(ZOO / "encodec_24khz.npz")
    flat = load_npz(ZOO / "encodec_24khz.npz")
    model = EncodecModel()
    jax_params_to_torch(flat, model)
    lstm = model.decoder.lstm.lstm
    np.testing.assert_array_equal(lstm.weight_hh_l1.detach().numpy(),
                                  flat["params/decoder/lstm/w_hh_l1"].T)
    assert not lstm.bias_hh_l0.detach().any()
    np.testing.assert_array_equal(model.decoder.up_0.v.detach().numpy(),
                                  flat["params/decoder/up_0/v"].transpose(1, 2, 0))


def test_f16_upcast_and_carry_over_errors(tmp_path):
    rs = np.random.RandomState(0)
    w = rs.randn(3, 5).astype(np.float16)
    np.savez(tmp_path / "p.npz", **{"params/kernel": w, "params/bias": np.zeros(5, np.float16)})
    flat = load_npz(tmp_path / "p.npz")
    assert flat["params/kernel"].dtype == np.float32
    np.testing.assert_array_equal(flat["params/kernel"], w.astype(np.float32))
    dense = Dense(3, 5)
    jax_params_to_torch(flat, dense)
    np.testing.assert_array_equal(dense.weight.detach().numpy(), w.astype(np.float32).T)
    with pytest.raises(KeyError, match="no port parameter"):
        jax_params_to_torch({**flat, "params/extra": np.zeros(2)}, Dense(3, 5))
    with pytest.raises(KeyError, match="left unset"):
        jax_params_to_torch({"params/kernel": flat["params/kernel"]}, Dense(3, 5))
    with pytest.raises(ValueError, match="shape"):
        jax_params_to_torch(flat, Dense(5, 3))


def test_cast_params_bf16_keeps_norms_and_vectors_fp32():
    model = build_model({"model": "nar", "d_model": 32, "n_heads": 2, "n_layers": 1},
                        torch.float32)
    cast_params_bf16(model)
    dt = {n: p.dtype for n, p in model.named_parameters()}
    assert dt["base.block_0.attn.to_qkv.weight"] == torch.bfloat16
    assert dt["base.text_emb.weight"] == torch.bfloat16
    assert dt["base.block_0.norm_attn.emb"] == torch.float32
    assert dt["base.block_0.ffn.fc1.bias"] == torch.float32
    assert dt["base.sep"] == torch.float32


@pytest.mark.parametrize("case", ["gaussian_bundle", "ancestral"])
def test_cli_rejects_what_is_not_ported(tmp_path, capsys, case):
    """A Gaussian bundle is served by the CLI; the D3PM's samplers are not
    its own, so ``--stride 3`` and ``--decode ancestral`` are refused for it
    (the bundles are the port's, seeded and saved by ``export``)."""
    from tts_with_diffusion_model_tpu_torch.__main__ import main
    from tts_with_diffusion_model_tpu_torch.export import bundle_params, save_bundle
    from tts_with_diffusion_model_tpu_torch.models import get_model

    dims = {"d_model": 32, "n_heads": 2, "n_layers": 1}
    for name, ov in (("diffusion-gaussian", {**dims, "timesteps": 2, "resp_len": 16,
                                             "gen_len": 12}), ("nar", dims)):
        model = get_model(name, 1024, ov)
        init_seeded(getattr(model, "denoiser", model), 0)
        save_bundle(tmp_path / name, bundle_params(model),
                    {"model": name, "num_tokens": 1024, **ov}, {"_": 1}, {"spk": 0})
    args = ["hello there", "ref.wav", str(tmp_path / "out.wav"), "--device", "cpu",
            "--ar-ckpt", str(tmp_path / "diffusion-gaussian"), "--nar-ckpt",
            str(tmp_path / "nar")]
    args += ["--stride", "3"] if case == "gaussian_bundle" else ["--decode", "ancestral"]
    with pytest.raises(SystemExit) as e:
        main(args)
    assert e.value.code == 2
    assert "D3PM samplers" in capsys.readouterr().err


def test_port_and_chip_smoke_import_without_jax():
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\nsys.modules['flax'] = None\n"
        "import tts_with_diffusion_model_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "import chip_smoke\n"
        "assert not any(k == 'jax' or k.startswith(('jax.', 'flax', 'tts_with_diffusion_model_tpu.'))"
        " for k, v in sys.modules.items() if v is not None)\n"
        "print(' '.join(names))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    names = set(out.stdout.split())
    assert len(names) >= 30
    for mod in ("train.__main__", "train.train", "train.trainer", "train.engine", "config",
                "data.dataset", "data.sampler", "utils.config_base", "utils.logging",
                "ops.train_flash_attention", "ops.route", "models", "models.ar", "models.nar",
                "smoke_train", "export", "emb.g2p", "emb.qnt", "smoke_export", "smoke_ar",
                "serve", "longform", "smoke_serve", "data.native_loader", "utils.profiling",
                "utils.metrics", "utils.diagnostic", "utils.helpers", "utils.precision",
                "utils.artifacts", "codec.losses", "codec.train", "codec.calibrate",
                "codec.convert", "compat.reference", "compat.import_reference",
                "scripts.heldout_eval", "scripts.speaker_transfer_eval", "scripts.quality_gate",
                "scripts.longform_seam_eval", "smoke_codec", "parallel.mesh", "parallel.comm",
                "parallel.infer", "utils.distributed", "version", "smoke_parallel"):
        assert f"tts_with_diffusion_model_tpu_torch.{mod}" in names, mod


def test_port_sources_never_name_jax_or_the_jax_package():
    files = [*PORT.rglob("*.py"), *PORT.rglob("*.cu"), REPO / "chip_smoke.py"]
    assert len(files) > 30
    assert PORT / "train" / "__main__.py" in files
    assert PORT / "csrc" / "train_flash_attention.cu" in files
    for f in files:
        text = f.read_text()
        for needle in ("import jax", "from jax", "import flax", "from flax",
                       "tts_with_diffusion_model_tpu."):
            assert needle not in text, f"{f.relative_to(REPO)} contains {needle!r}"
