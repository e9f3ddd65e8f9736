"""The port's reference importer against the JAX package's on the CPU.

A seeded state dict in the reference's key layout is built here from a
tiny port model's weights, by the key names the converters read (the
inverse of ``compat/reference.py``'s maps).  Both packages' converters must
give identical trees (and that tree is the model's own weights back, with
``cross_attn`` mirrored into ``cross_attn2``), and a bundle written by the
port's ``import_checkpoint`` must give the port's logits equal to the JAX
package's within 1e-4·max(1, |ref|).  The tests that need the reference
itself (``reference.DEFAULT_REFERENCE_ROOT``) skip without it, as the JAX
package's do."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tts_with_diffusion_model_tpu.compat import reference as jref
from tts_with_diffusion_model_tpu_torch.compat import import_reference, reference
from tts_with_diffusion_model_tpu_torch.convert import init_seeded, torch_params_to_jax

from torch_port_helpers import flatten, t

TOL = 1e-4
DIMS = dict(d_model=32, n_heads=4, n_layers=2)


def _lin(sd, ref, flat, path):
    sd[f"{ref}.weight"] = flat[f"{path}/kernel"].T
    if f"{path}/bias" in flat:
        sd[f"{ref}.bias"] = flat[f"{path}/bias"]


def _ln(sd, ref, flat, path):
    sd[f"{ref}.weight"], sd[f"{ref}.bias"] = flat[f"{path}/scale"], flat[f"{path}/bias"]


def _mha(sd, ref, flat, path):
    sd[f"{ref}.in_proj_weight"] = np.concatenate([flat[f"{path}/{n}/kernel"].T for n in "qkv"])
    sd[f"{ref}.in_proj_bias"] = np.concatenate([flat[f"{path}/{n}/bias"] for n in "qkv"])
    _lin(sd, f"{ref}.out_proj", flat, f"{path}/out")


def base_sd(flat: dict, n_layers: int, adaln: bool) -> dict:
    """A ``Base`` trunk's weights (flax paths under ``base/``) in the
    reference's layout."""
    f = {k[len("base/"):]: v for k, v in flat.items()}
    sd = {"text_emb.weight": f["text_emb/embedding"], "proms_emb.weight": f["proms_emb/weight"],
          "resps_emb.weight": f["resps_emb/weight"], "sep": f["sep"]}
    _lin(sd, "classifier", f, "classifier")
    for i in range(n_layers):
        for ref, name in (("attn", "norm_attn"), ("ffn", "norm_ffn")):
            if adaln:
                sd[f"blocks.{i}.{ref}.norm.emb.weight"] = f[f"block_{i}/{name}/emb"]
            else:
                _ln(sd, f"blocks.{i}.{ref}.norm", f, f"block_{i}/{name}")
        sd[f"blocks.{i}.attn.block.to_qkv.weight"] = f[f"block_{i}/attn/to_qkv/kernel"].T
        _lin(sd, f"blocks.{i}.attn.block.to_out", f, f"block_{i}/attn/to_out")
        _lin(sd, f"blocks.{i}.ffn.block.0", f, f"block_{i}/ffn/fc1")
        _lin(sd, f"blocks.{i}.ffn.block.3", f, f"block_{i}/ffn/fc2")
    return sd


def dit_sd(flat: dict, n_layers: int) -> dict:
    """A DiT denoiser's weights in the reference's (``ar_discrete.AR``)
    layout."""
    sd = {"text_emb.weight": flat["text_emb/embedding"], "proms_emb.weight": flat["proms_emb/weight"],
          "resps_emb.weight": flat["resps_emb/embedding"], "time_emb.weight": flat["time_emb/embedding"]}
    _lin(sd, "final", flat, "final")
    for ref, tower in (("encodertext", "text_tower"), ("encoder2", "prom_tower")):
        for i in range(2):
            p, r = f"{tower}/layer_{i}", f"{ref}.0.layers.{i}"
            _mha(sd, f"{r}.self_attn", flat, f"{p}/self_attn")
            _ln(sd, f"{r}.norm1", flat, f"{p}/norm1")
            _ln(sd, f"{r}.norm2", flat, f"{p}/norm2")
            _lin(sd, f"{r}.linear1", flat, f"{p}/ffn/fc1")
            _lin(sd, f"{r}.linear2", flat, f"{p}/ffn/fc2")
        _lin(sd, f"{ref}.1.fc1", flat, f"{tower}/mlp/fc1")
        _lin(sd, f"{ref}.1.fc2", flat, f"{tower}/mlp/fc2")
    for i in range(n_layers):
        p, r = f"dit_{i}", f"blocks.{i}"
        for n in ("norm1", "norm2", "norm22", "norm3"):
            _ln(sd, f"{r}.{n}", flat, f"{p}/{n}")
        _mha(sd, f"{r}.attn", flat, f"{p}/attn")
        _mha(sd, f"{r}.cross_attn", flat, f"{p}/cross_attn")
        _lin(sd, f"{r}.mlp.fc1", flat, f"{p}/mlp/fc1")
        _lin(sd, f"{r}.mlp.fc2", flat, f"{p}/mlp/fc2")
        _lin(sd, f"{r}.timestep_fc", flat, f"{p}/timestep_fc")
    return sd


def _model(family):
    """A tiny seeded port model at reference-parity options, and its
    weights as flat flax paths (the DiT's ``cross_attn2`` set to its
    ``cross_attn``, as a converted reference checkpoint has it)."""
    from tts_with_diffusion_model_tpu_torch.models import get_model
    from tts_with_diffusion_model_tpu_torch.models.diffusion import DiffusionConfig, DiffusionModel

    if family == "d3pm":
        model = DiffusionModel(DiffusionConfig(timesteps=8, tower_ffn_dim=2048, tower_act="relu",
                                               resp_pe=False, **DIMS), dtype=torch.float32)
        target = model.denoiser
    else:
        model = target = get_model(family, 1024, dict(DIMS), dtype=torch.float32)
    init_seeded(target, 11)
    rs = np.random.RandomState(12)
    with torch.no_grad():
        for p in target.parameters():
            p.add_(0.1 * torch.from_numpy(rs.randn(*p.shape).astype(np.float32)))
        if family == "d3pm":
            for blk in target.blocks():
                blk.cross_attn2.load_state_dict(blk.cross_attn.state_dict())
    return model, torch_params_to_jax(target)


@pytest.fixture(scope="module")
def models():
    return {f: _model(f) for f in ("ar", "nar", "d3pm")}


def _sd(family, flat):
    if family == "d3pm":
        return dit_sd(flat, DIMS["n_layers"])
    return base_sd(flat, DIMS["n_layers"], adaln=family == "nar")


@pytest.mark.parametrize("family", ["ar", "nar", "d3pm"])
def test_converters_match_jax_and_invert_the_layout(models, family):
    _, flat = models[family]
    sd = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in _sd(family, flat).items()}
    if family == "d3pm":
        got, ref = reference.dit_params_from_torch(sd, 2), jref.dit_params_from_torch(sd, 2)
    else:
        norm = "adaln" if family == "nar" else "ln"
        got = {"base": reference.base_params_from_torch(sd, 2, norm)}
        ref = {"base": jref.base_params_from_torch(sd, 2, norm)}
    got, ref = flatten(got), flatten(ref)
    assert got.keys() == ref.keys() == flat.keys()
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k])
        np.testing.assert_array_equal(got[k], flat[k])


def _inputs(family):
    rs = np.random.RandomState(0)
    B, Tt, Tp, Tr = 2, 12, 20, 16
    text = rs.randint(1, 30, (B, Tt)).astype(np.int32)
    tm = np.ones((B, Tt), np.float32)
    tm[1, 8:] = 0
    proms = rs.randint(0, 1024, (B, Tp, 8)).astype(np.int32)
    pm = np.ones((B, Tp), np.float32)
    pm[0, 15:] = 0
    rm = np.ones((B, Tr), np.float32)
    rm[1, 11:] = 0
    if family == "d3pm":
        return text, tm, proms, pm, rs.randint(0, 1025, (B, Tr)).astype(np.int32), rm, \
            np.array([1, 6], np.int32)
    if family == "nar":
        return text, tm, proms, pm, rs.randint(0, 1024, (B, Tr, 7)).astype(np.int32), rm
    return text, tm, proms, pm, rs.randint(0, 1024, (B, Tr)).astype(np.int32), rm


@pytest.mark.parametrize("family", ["ar", "nar", "d3pm"])
def test_imported_bundle_gives_jax_logits(models, family, tmp_path):
    """``import_checkpoint`` on a tensors-only state dict: the family and
    dims read from the keys, and the bundle's logits in the port (through
    ``serve.load_model``) equal the JAX package's (its ``build_model`` and
    ``load_bundle``, fp32) within 1e-4·max(1, |ref|)."""
    from tts_with_diffusion_model_tpu.__main__ import build_model as jax_build_model
    from tts_with_diffusion_model_tpu.export import load_bundle as jax_load_bundle
    from tts_with_diffusion_model_tpu.models.nar import NAR as JaxNAR
    from tts_with_diffusion_model_tpu_torch.serve import load_model

    _, flat = models[family]
    src = tmp_path / "ckpt.pt"
    torch.save({"module": {k: torch.from_numpy(np.ascontiguousarray(v))
                           for k, v in _sd(family, flat).items()}}, src)
    meta = import_reference.main([str(src), str(tmp_path / "bundle"), "--n-heads", "4"])
    assert meta["model"] == ("diffusion" if family == "d3pm" else family)
    assert (meta["d_model"], meta["n_layers"], meta["n_heads"]) == (32, 2, 4)
    inputs = _inputs(family)

    params, jmeta, _, _ = jax_load_bundle(tmp_path / "bundle")
    jmodel = jax_build_model(jmeta)
    if family == "d3pm":
        ref = jmodel.denoiser.clone(dtype=jnp.float32).apply(params, *inputs)
    elif family == "nar":
        ref = jmodel.clone(dtype=jnp.float32, remat=False).apply(
            params, *inputs, 3, method=JaxNAR.forward_level)
    else:
        ref = jmodel.clone(dtype=jnp.float32, remat=False).apply(
            params, *inputs, deterministic=True)[0]
    ref = np.asarray(ref)

    model, _ = load_model(tmp_path / "bundle", torch.float32)
    model.eval()
    args = [t(a).long() if a.dtype.kind == "i" else t(a) for a in inputs]
    with torch.no_grad():
        if family == "d3pm":
            got = model.denoiser(*args)
        elif family == "nar":
            got = model.forward_level(*args, 3)
        else:
            got = model(*args)[0]
    got = got.numpy()
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= TOL * max(1.0, np.abs(ref).max())


def test_load_torch_object_refusals(tmp_path):
    """A missing path reads as missing, and a file that is not tensors-only
    is refused without ``--allow-pickle``."""
    with pytest.raises(SystemExit, match="not found"):
        import_reference._load_torch_object(tmp_path / "nope.pt")
    bad = tmp_path / "corrupt.pt"
    bad.write_bytes(b"\x00\x01 this is not a torch file")
    with pytest.raises(SystemExit, match="allow-pickle"):
        import_reference._load_torch_object(bad)


def test_stubs_are_import_system_citizens(monkeypatch):
    """The ``timm`` / ``diffusers`` stand-ins carry real module specs, and
    the ``Mlp`` stand-in is timm's fc1 → act → fc2 (the stand-ins leave
    ``sys.modules`` with the test)."""
    import importlib.util
    import sys

    names = ("timm", "timm.models", "timm.models.vision_transformer", "diffusers")
    for name in names:
        if name in sys.modules:
            monkeypatch.setitem(sys.modules, name, sys.modules[name])
        else:
            monkeypatch.setitem(sys.modules, name, None)
            monkeypatch.delitem(sys.modules, name)
    reference.install_dependency_stubs()
    for name in names:
        spec = importlib.util.find_spec(name)
        assert spec is not None and spec.name == name
    mlp = sys.modules["timm.models.vision_transformer"].Mlp(4, 8, 3)
    x = torch.randn(2, 4)
    torch.testing.assert_close(mlp(x), mlp.fc2(mlp.act(mlp.fc1(x))))


def test_reference_pickled_ar_imports_with_its_logits(tmp_path):
    """The reference's own pickled export (a whole AR module with its
    symmaps) through ``--allow-pickle``: the port's logits equal the
    reference's at the valid response slots."""
    if not os.path.isdir(reference.DEFAULT_REFERENCE_ROOT):
        pytest.skip("reference repo not available")
    from tts_with_diffusion_model_tpu_torch.serve import load_model

    ref = reference.load_reference()
    torch.manual_seed(31)
    tm_model = ref.ar.AR(n_tokens=48, d_model=64, n_heads=8, n_layers=2, p_dropout=0.0).eval()
    tm_model.phone_symmap, tm_model.spkr_symmap = {"<s>": 1, "</s>": 2, "HH": 3}, {"sp01": 0}
    torch.save(tm_model, tmp_path / "ar.pt")
    with pytest.raises(SystemExit, match="allow-pickle"):
        import_reference.import_checkpoint(tmp_path / "ar.pt", tmp_path / "b", n_heads=8)
    meta = import_reference.import_checkpoint(tmp_path / "ar.pt", tmp_path / "b", n_heads=8,
                                              allow_pickle=True)
    assert meta["model"] == "ar" and meta["num_tokens"] == 48
    model, phones = load_model(tmp_path / "b", torch.float32)
    assert phones["HH"] == 3
    g = torch.Generator().manual_seed(32)
    text = [torch.randint(1, 48, (7,), generator=g)]
    proms = [torch.randint(0, 48, (9, 8), generator=g)]
    resp = [torch.randint(0, 48, (11,), generator=g)]
    store = {}
    tm_model.classifier.register_forward_hook(lambda m, i, o: store.__setitem__("h", o.detach()))
    with torch.no_grad():
        tm_model(text, proms, resp)
        got = model.eval()(text[0][None], torch.ones(1, 7), proms[0][None], torch.ones(1, 9),
                           resp[0][None], torch.ones(1, 11))[0]
    ref_h = store["h"][0, -11:]
    torch.testing.assert_close(got[0, -11:], ref_h, rtol=0, atol=TOL * max(1.0, ref_h.abs().max()))
