"""The port's whole chain (``recipe_run``) rehearsed on the CPU at its tiny
size: corpus → g2p → qnt → D3PM and NAR training → the val-loss spread →
export → serving with MaskGIT and the ancestral chain, bf16 and fp32; then
the AR chain in the same workdir (``--ar``), reusing its corpus, codes and
NAR bundle: AR and ar-quarter training, exports, AR serving and greedy
speculative decoding at k = 2, 4, 6, 8."""

import json

import numpy as np
import pytest
import torch

from tts_with_diffusion_model_tpu_torch import recipe_run


@pytest.fixture(scope="module")
def tiny_run(tmp_path_factory):
    """The tiny D3PM chain on one intra-op thread (its children too)."""
    work = tmp_path_factory.mktemp("recipe")
    n = torch.get_num_threads()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        torch.set_num_threads(1)
        try:
            yield work, recipe_run.main([str(work), "--device", "cpu", "--tiny"])
        finally:
            torch.set_num_threads(n)


def test_recipe_run_tiny_on_the_cpu(tiny_run):
    tmp_path, report = tiny_run
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


def test_recipe_run_ar_chain_reuses_the_workdir(tiny_run):
    tmp_path, _ = tiny_run
    report = recipe_run.main([str(tmp_path), "--device", "cpu", "--tiny", "--ar"])
    assert json.loads((tmp_path / "report_ar.json").read_text()).keys() == report.keys()
    # the corpus, its codes and the NAR bundle were the D3PM run's
    assert not {"corpus", "g2p", "qnt", "train_nar", "export_nar"} & set(report["seconds"])
    for name in ("ar", "ar-quarter"):
        assert report[name]["steps"] == 4 and [s for s, _ in report[name]["val"]] == [2, 4]
        assert report["exported"][name]["step"] == 4
        meta = json.loads((tmp_path / "zoo" / name / "model.json").read_text())
        assert meta["weights"] == "ema" and meta["model"] == name
    served = report["ar_serve"]
    assert served["served_requests"] == 2 and served["max_ar_steps"] == 24
    assert all(1 <= n <= 24 for n in served["lengths"]) and served["serve_p50_ms"] > 0
    greedy = served["greedy"]
    assert greedy["max_steps"] == 16 and list(greedy["k"]) == [2, 4, 6, 8]
    for k, entry in greedy["k"].items():
        # served in bf16: a divergence from plain greedy is recorded with the
        # top-2 margin where it happened
        assert entry["identical"] == (entry["first_divergence"] is None)
        assert (entry["tie_margin"] is None) == entry["identical"]
        assert entry["rounds"] >= 1 and 0.0 <= entry["accepted_per_round"] <= k + 1
        assert 0.0 <= entry["acceptance_rate"] <= 1.0 and entry["tok_s"] > 0


def test_zoo_estimator_holds_a_bundle_against_the_run(tiny_run):
    """``--zoo-estimator``'s comparison, on the tiny run's own exported
    D3PM as the bundle: both estimators on the same val split, for the
    bundle and the run's EMA at step 4 (the same weights when the exported
    val-minimum tick is step 4)."""
    tmp_path, report = tiny_run
    run = recipe_run.Run(tmp_path, "cpu", None, tiny=True)
    out = recipe_run.zoo_estimate(run, tmp_path / "zoo" / "diffusion", 4)
    assert out["same_phone_symmap"] and out["val_utterances"] == 2
    for side in ("zoo", "port"):
        e = out[side]
        assert e["min"] <= e["mean"] <= e["max"] and e["std"] > 0 and np.isfinite(e["all_t"])
    assert out["port"]["step"] == 4 and out["zoo"]["weights"] == "ema"
    if report["exported"]["d3pm"]["step"] == 4:
        assert out["zoo"] == {**out["port"], "bundle": out["zoo"]["bundle"]}
        assert out["all_t_gap"] == 0 and out["within_spread"]


def test_recipe_run_zoo_evals_on_the_workdir_bundles(tiny_run):
    """``--zoo-evals`` on the tiny chain's exported D3PM, NAR and AR (made
    by the AR chain above when this runs alone): every evaluation and
    metric of the JAX records at one seed, beside the record's value."""
    tmp_path, _ = tiny_run
    if not (tmp_path / "zoo" / "ar" / "model.json").exists():
        recipe_run.main([str(tmp_path), "--device", "cpu", "--tiny", "--ar"])
    report = recipe_run.main([str(tmp_path), "--device", "cpu", "--tiny", "--zoo-evals",
                              str(tmp_path / "zoo")])["zoo_evals"]
    assert json.loads((tmp_path / "report_zoo_evals.json").read_text())["zoo_evals"] == report
    assert report["seeds"] == [0]
    for name, metrics in recipe_run.ZOO_METRICS.items():
        entry = report[name]
        assert entry["seconds"] > 0 and entry["record"] == recipe_run.ZOO_RECORDS[name][0]
        for key in metrics:
            m = entry[key]
            assert len(m["values"]) == 1 and m["min"] <= m["mean"] <= m["max"]
            assert m["record"] is not None  # the records are in benchmarks/gen_r4
    assert report["heldout ancestral"]["level0_acc"]["record"] == 0.0136
    assert report["longform_seam"]["n_segments"]["record"] == 5
