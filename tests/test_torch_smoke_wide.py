"""The wide-heads phases of the smoke run (``smoke_wide.py``): the Dh-128 and
Dh-256 recipes' configs, sites and launch counts at full width (shapes
only), and both phases rehearsed on the CPU at a tiny size through the
plain versions (the card runs them at full width through
``chip_smoke.py``)."""

import pytest
import torch

from tts_with_diffusion_model_tpu_torch import smoke, smoke_train, smoke_wide
from tts_with_diffusion_model_tpu_torch.codec import encodec

from torch_port_helpers import one_thread  # noqa: F401 (fixture)

CPU = torch.device("cpu")
pytestmark = pytest.mark.usefixtures("one_thread")


def _params(model) -> int:
    return sum(p.numel() for p in model.parameters())


def test_wide_recipes_are_the_registry_models_at_dh_128(tmp_path):
    """The written configs are the committed recipes plus ``model_overrides``
    ({n_heads: 4} on the D3PM, {n_heads: 8} on the NAR): every attention at
    Dh 128, the parameter count of the registry models, and the launch
    counts of the registry paths (376 per MaskGIT batch, 52 + 28 and 24 +
    12 per step)."""
    yamls = smoke_wide.write_configs(tmp_path)
    for name, yaml in yamls.items():
        committed = (smoke.REPO / "config" / "gen4c" / f"{name}.yml").read_text()
        assert yaml.read_text().startswith(committed)
        assert yaml.parent.name == "gen4c" and yaml.parent.parent.name == "config"
    serve, train = smoke_wide.path_sites(yamls)
    assert {s.Dh for s in serve} == {s.Dh for s in train} == {128}
    assert sum(s.count for s in serve) == 376
    by_path = {p: (sum(s.fwd for s in train if s.path == p), sum(s.bwd for s in train
                                                                  if s.path == p))
               for p in ("wide d3pm", "wide nar")}
    assert by_path == {"wide d3pm": (52, 28), "wide nar": (24, 12)}
    for name, yaml in yamls.items():
        cfg, wide = smoke_train.recipe(yaml)
        _, registry = smoke_train.recipe(smoke.REPO / "config" / "gen4c" / f"{name}.yml")
        assert cfg.model_overrides == {"n_heads": smoke_wide.WIDE[name]}
        assert _params(wide) == _params(registry)


def test_wider_recipes_are_the_registry_models_at_dh_256(tmp_path):
    """``WIDER`` ({n_heads: 2} on the D3PM, {n_heads: 4} on the NAR): every
    attention at Dh 256, the registry models' parameter counts, and the
    registry paths' launch counts, on the paths ``wide256 d3pm`` and
    ``wide256 nar``."""
    yamls = smoke_wide.write_configs(tmp_path / "wide256", smoke_wide.WIDER)
    serve, train = smoke_wide.path_sites(yamls, tag="wide256")
    assert {s.Dh for s in serve} == {s.Dh for s in train} == {256}
    assert sum(s.count for s in serve) == 376
    assert all(s.name.startswith("wide256 ") for s in [*serve, *train])
    by_path = {p: (sum(s.fwd for s in train if s.path == p), sum(s.bwd for s in train
                                                                  if s.path == p))
               for p in ("wide256 d3pm", "wide256 nar")}
    assert by_path == {"wide256 d3pm": (52, 28), "wide256 nar": (24, 12)}
    for name, yaml in yamls.items():
        cfg, wide = smoke_train.recipe(yaml)
        _, registry = smoke_train.recipe(smoke.REPO / "config" / "gen4c" / f"{name}.yml")
        assert cfg.model_overrides == {"n_heads": smoke_wide.WIDER[name]}
        assert _params(wide) == _params(registry)
    # the Dh-128 pair keeps its own directory and heads
    assert set(smoke_wide.TAGS) == {"wide", "wide256"}
    assert smoke_wide.TAGS["wide"] is smoke_wide.WIDE


def test_synthetic_widths_cover_the_tensor_cores_from_4_to_256():
    """Every synthetic width takes the tensor cores in bf16 (the widths off
    8 on padded copies) and the SIMT kernels in fp32."""
    from tts_with_diffusion_model_tpu_torch.ops.route import tensor_core_route

    widths = set(smoke_wide.SYNTHETIC_WIDTHS) | set(smoke_wide.CAUSAL_WIDTHS)
    assert {4, 12, 136, 200, 250, 256} <= widths and 256 in smoke_wide.CAUSAL_WIDTHS
    for dh in widths:
        assert tensor_core_route(dh, torch.bfloat16, True)
        assert not tensor_core_route(dh, torch.float32, True)


def test_wide_kernel_phase_rehearsal(monkeypatch, tmp_path):
    """The kernel phase through the plain versions at tiny stand-ins of the
    path's sites (the real ones are shapes at full width) and the synthetic
    widths, tensor-core and SIMT ones."""
    tiny_serve = [smoke.Site("wide DiT self", 20, 20, 1, 128, 36)]
    tiny_train = [smoke_train.TrainSite("wide DiT self", 2, 20, 20, 1, 128, False, 16, 8,
                                        path="wide d3pm")]
    monkeypatch.setattr(smoke_wide, "path_sites", lambda yamls: (tiny_serve, tiny_train))
    monkeypatch.setattr(smoke_wide, "synthetic_sites", lambda widths, causal_widths: (
        [smoke.Site(f"synthetic self Dh {dh}", 9, 11, 1, dh, 1) for dh in widths],
        [smoke_train.TrainSite(f"synthetic self Dh {dh}", 2, 9, 11, 1, dh, True, 1, 1,
                               path="synthetic") for dh in widths]))
    serve, train = smoke_wide.phase_kernel_check(CPU, {}, B_serve=4, widths=(12, 40, 136))
    assert [r["Dh"] for r in serve] == [128, 128, 12, 12, 40, 40, 136, 136]
    assert [r["dtype"] for r in serve] == ["float32", "bfloat16"] * 4
    assert [r["site"] for r in train] == ["wide DiT self"] * 2 + [
        f"synthetic self Dh {dh}" for dh in (12, 12, 40, 40, 136, 136)]
    assert all(r["max_abs_err"] == 0.0 for r in [*serve, *train])


def test_wide_kernel_phase_rehearsal_with_the_dh_256_pair(monkeypatch):
    """With ``wider``, the Dh-256 pair's sites are checked after the Dh-128
    pair's and before the synthetic ones."""
    def sites(yamls, tag="wide"):
        dh = 256 if tag == "wide256" else 128
        return ([smoke.Site(f"{tag} DiT self", 20, 20, 1, dh, 36)],
                [smoke_train.TrainSite(f"{tag} DiT self", 2, 20, 20, 1, dh, False, 16, 8,
                                       path=f"{tag} d3pm")])

    monkeypatch.setattr(smoke_wide, "path_sites", sites)
    monkeypatch.setattr(smoke_wide, "synthetic_sites", lambda widths, causal_widths: (
        [smoke.Site(f"synthetic self Dh {dh}", 9, 11, 1, dh, 1) for dh in widths],
        [smoke_train.TrainSite(f"synthetic {kind} Dh {dh}", 2, 9, 11, 1, dh, kind == "causal",
                               1, 1, path="synthetic")
         for kind, ws in (("self", widths), ("causal", causal_widths)) for dh in ws]))
    serve, train = smoke_wide.phase_kernel_check(CPU, {}, B_serve=2, widths=(250,),
                                                 causal_widths=(256,), wider={})
    assert [(r["site"], r["Dh"]) for r in serve] == [
        ("wide DiT self", 128)] * 2 + [("wide256 DiT self", 256)] * 2 + [
        ("synthetic self Dh 250", 250)] * 2
    assert [r["site"] for r in train] == ["wide DiT self"] * 2 + ["wide256 DiT self"] * 2 + [
        "synthetic self Dh 250"] * 2 + ["synthetic causal Dh 256"] * 2
    assert all(r["max_abs_err"] == 0.0 for r in [*serve, *train])


def test_wide_phase_rehearsal(monkeypatch, tmp_path):
    """Tiny Dh-128 D3PM and NAR runs of the train CLI over the written
    configs, their exports with the round trips, and one MaskGIT batch
    through the plain versions."""
    from tts_with_diffusion_model_tpu_torch.codec.encodec import Codec
    from tts_with_diffusion_model_tpu_torch.convert import init_seeded

    for mod in (smoke, smoke_train, smoke_wide):
        monkeypatch.setattr(mod, "SMOKE_DIR", tmp_path)
    small = smoke.tiny_models()[3]  # the full codec's decode would dominate the test
    init_seeded(small, 2)
    codec = Codec(small, CPU)
    monkeypatch.setattr(encodec, "load_codec", lambda *a, **kw: codec)
    common = ["device=cpu", "batch_size=4", "eval_batch_size=8", "max_num_val=8", "nj=1",
              "resp_len_buckets=[32]"]
    overrides = {
        "diffusion": [*common, "model_overrides={d_model: 128, n_heads: 1, n_layers: 1, "
                      "timesteps: 8, text_len: 50, prom_len: 64, resp_len: 48, gen_len: 40}"],
        "nar": [*common, "model_overrides={d_model: 128, n_heads: 1, n_layers: 1}",
                "prom_len_buckets=[64]", "max_prom_len=128", "max_resp_len=64"]}
    out = smoke_wide.phase_wide(CPU, smoke_wide.write_configs(tmp_path / "wide"), steps=2,
                                repeats=1, overrides=overrides, corpus=(3, 12, (8, 30), (3, 12)),
                                codec=codec, ref_seconds=0.5)
    for name, run in out["runs"].items():
        assert {s.Dh for s in run["sites"]} == {128}, name
        assert len(run["losses"]) == 2
    assert all(e["bytes"] > 0 and e["params"] > 0 for e in out["exports"].values())
    served = out["served"]
    assert served["launches"] == 0
    assert served["expected"] == 4 + 12 * 1 * 3 + 7 * 1
    assert all(c.shape == (40, 8) for c in served["codes"])


def test_wide256_phase_rehearsal(monkeypatch, tmp_path):
    """The Dh-256 pair: tiny D3PM and NAR runs (one head of 256) of the
    train CLI over the ``WIDER`` configs under their own tag, exports with
    the round trips, and one MaskGIT batch through the plain versions."""
    from tts_with_diffusion_model_tpu_torch.codec.encodec import Codec
    from tts_with_diffusion_model_tpu_torch.convert import init_seeded

    for mod in (smoke, smoke_train, smoke_wide):
        monkeypatch.setattr(mod, "SMOKE_DIR", tmp_path)
    small = smoke.tiny_models()[3]
    init_seeded(small, 3)
    codec = Codec(small, CPU)
    monkeypatch.setattr(encodec, "load_codec", lambda *a, **kw: codec)
    common = ["device=cpu", "batch_size=4", "eval_batch_size=8", "max_num_val=8", "nj=1",
              "resp_len_buckets=[32]"]
    overrides = {
        "diffusion": [*common, "model_overrides={d_model: 256, n_heads: 1, n_layers: 1, "
                      "timesteps: 8, text_len: 50, prom_len: 64, resp_len: 48, gen_len: 40}"],
        "nar": [*common, "model_overrides={d_model: 256, n_heads: 1, n_layers: 1}",
                "prom_len_buckets=[64]", "max_prom_len=128", "max_resp_len=64"]}
    yamls = smoke_wide.write_configs(tmp_path / "wide256", smoke_wide.WIDER)
    out = smoke_wide.phase_wide(CPU, yamls, steps=2, repeats=1, overrides=overrides,
                                corpus=(3, 12, (8, 30), (3, 12)), codec=codec, ref_seconds=0.5,
                                tag="wide256")
    for name, run in out["runs"].items():
        assert {s.Dh for s in run["sites"]} == {256}, name
        assert all(s.path.startswith(("d3pm", "nar")) for s in run["sites"])
        assert len(run["losses"]) == 2
    assert {e["path"].name for e in out["exports"].values()} == {"diffusion_wide256",
                                                                 "nar_wide256"}
    assert all(e["bytes"] > 0 and e["params"] > 0 for e in out["exports"].values())
    served = out["served"]
    assert served["launches"] == 0
    assert served["expected"] == 4 + 12 * 1 * 3 + 7 * 1
    assert all(c.shape == (40, 8) for c in served["codes"])
