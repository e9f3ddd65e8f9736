"""The port's whole chain (``recipe_run``) rehearsed on the CPU at its tiny
size: corpus → g2p → qnt → D3PM and NAR training → the val-loss spread →
export → serving with MaskGIT and the ancestral chain, bf16 and fp32."""

import json

import numpy as np

from tts_with_diffusion_model_tpu_torch import recipe_run

from torch_port_helpers import one_thread  # noqa: F401 (fixture)


def test_recipe_run_tiny_on_the_cpu(tmp_path, one_thread):
    report = recipe_run.main([str(tmp_path), "--device", "cpu", "--tiny"])
    assert json.loads((tmp_path / "report.json").read_text()).keys() == report.keys()
    assert report["device"] == "cpu"
    assert len(list((tmp_path / "data" / "train").rglob("*.qnt.npy"))) == 22
    for family in ("d3pm", "nar"):
        run = report[family]
        assert run["steps"] == 4 and [s for s, _ in run["val"]] == [2, 4]
    spread = report["d3pm_val_spread"]
    assert sorted(spread) == [2, 4]
    assert all(s[w]["min"] <= s[w]["mean"] <= s[w]["max"] and s[w]["std"] > 0
               for s in spread.values() for w in ("raw", "ema"))
    best = min(report["d3pm"]["val"], key=lambda sv: sv[1])[0]
    assert report["exported"] == {"d3pm": {"step": best, "val_loss": dict(report["d3pm"]["val"])[best]},
                                  "nar": {"step": 4}}
    for name in ("diffusion", "nar"):
        meta = json.loads((tmp_path / "zoo" / name / "model.json").read_text())
        assert meta["weights"] == "ema"
    assert report["served_requests"] == 2  # one val utterance per speaker
    assert set(report["serve_p50_ms"]) == {"maskgit bf16", "ancestral stride 3 bf16",
                                           "maskgit fp32", "ancestral stride 3 fp32"}
    for agree in report["bf16_vs_fp32"].values():
        assert 0 <= agree["all_levels_identical"] <= agree["level0_identical"] <= 1
    logits = report["first_call_logits"]
    assert 0 < logits["max_abs_diff"] < logits["max_abs_fp32"]
    with np.load(tmp_path / "codes.npz") as z:
        assert all(z[k].shape == (2, 40, 8) for k in z.files) and len(z.files) == 4
