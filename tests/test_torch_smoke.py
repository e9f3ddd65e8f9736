"""The smoke run's phases rehearsed on the CPU at a tiny size with the plain
versions (the card runs them at full width through ``chip_smoke.py``), and
``chip_smoke.py``'s refusals without a card or without the repository."""

import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from tts_with_diffusion_model_tpu_torch import smoke
from tts_with_diffusion_model_tpu_torch.models.diffusion import DiffusionConfig

from torch_port_helpers import one_thread  # noqa: F401 (fixture)

REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
#: every rehearsal here runs tiny models on one intra-op thread
pytestmark = pytest.mark.usefixtures("one_thread")


def test_main_path_sites_launch_376_times_at_full_width():
    sites = smoke.attention_sites(DiffusionConfig(), {"d_model": 1024, "n_heads": 16,
                                                      "n_layers": 12}, 12, 256)
    assert smoke.expected_launches(sites) == 4 + 12 * 8 * 3 + 7 * 12 == 376
    nar = sites[-1]
    assert (nar.Tq, nar.H, nar.Dh) == (50 + 1 + 256 + 1 + 350, 16, 64)


@pytest.mark.parametrize("stride,calls,launches", [(1, 99, 2464), (3, 33, 880)])
def test_ancestral_sites_launch_2464_and_880_times_at_full_width(stride, calls, launches):
    from tts_with_diffusion_model_tpu_torch.models.diffusion import ancestral_schedule

    ts, ss = ancestral_schedule(100, stride)
    assert len(ts) == calls and ts[0] == 99 and ss[-1] == 0 and ss[:-1] == ts[1:]
    sites = smoke.attention_sites(DiffusionConfig(), {"d_model": 1024, "n_heads": 16,
                                                      "n_layers": 12}, calls, 256)
    assert smoke.expected_launches(sites) == 4 + calls * 8 * 3 + 7 * 12 == launches
    # the per-batch sums of the ancestral path reuse MaskGIT's timed sites
    timed = [dict(site=x.name, dtype="bfloat16", max_abs_err=0.0, ms=1.0, plain_ms=2.0,
                  library_ms=3.0, bound_ms=0.5, bound_by="bytes", count=x.count)
             for x in smoke.attention_sites(DiffusionConfig(), {"d_model": 1024, "n_heads": 16,
                                                                "n_layers": 12}, 12, 256)]
    tot = smoke.path_totals(timed, sites, launches_run=7)
    assert tot["launches"] == launches and tot["ms"] == launches and tot["launches_run"] == 7
    line = smoke.kernel_summary(timed, 376, paths={f"ancestral stride {stride}": tot})
    assert line["launches"] == 376 and line["paths"][f"ancestral stride {stride}"] == tot


def test_bound_is_bytes_at_the_dit_self_attention_shape():
    ms, by = smoke.bound_ms(1, 384, 384, 8, 64, torch.bfloat16)
    assert by == "bytes" and 0 < ms < 0.01


def test_kernel_phase_rehearsal():
    first, _, nar_dims, _ = smoke.tiny_models()
    res = smoke.phase_kernel_check(CPU, first.config, nar_dims, steps=2, B=4,
                                   prompt_buckets=(64,), timed_bucket=64)
    assert len(res) == 12 and all(r["finite"] and r["max_abs_err"] == 0.0 for r in res)
    line = smoke.kernel_summary(res, launches=0)
    assert line["route"] == "cuda" and line["ms"] is None and line["source"].endswith(".cu")


def test_slice_phase_rehearsal():
    assert smoke.phase_device(CPU)["platform"] == "cpu"
    assert smoke.phase_build(CPU) == 0.0
    out = smoke.phase_slice(CPU, "tiny", seed=0, repeats=1, ref_seconds=0.5)
    cfg = out["dit_cfg"]
    assert out["expected"] == 4 + out["steps"] * cfg.n_layers * 3 + 7 * out["nar_dims"]["n_layers"]
    assert out["launches"] == 0 and out["denoiser_err"] == 0.0


def test_chip_smoke_refuses_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode != 0 and '"ok"' not in out.stdout


def test_chip_smoke_refuses_outside_the_repository(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode != 0 and '"ok"' not in out.stdout


def test_train_step_runs_52_forward_and_28_backward_attentions_at_full_width():
    from tts_with_diffusion_model_tpu_torch import smoke_train
    from tts_with_diffusion_model_tpu_torch.config import Config
    from tts_with_diffusion_model_tpu_torch.train.train import build_model

    cfg = Config.from_cli([f"yaml={smoke_train.TRAIN_YAML}"])
    sites = smoke_train.train_attention_sites(build_model(cfg), cfg.batch_size,
                                              min(cfg.resp_len_buckets))
    # 2 + 2 tower layers, 8 blocks × 3 attentions, the blocks' again under remat
    assert sum(s.fwd for s in sites) == 4 + 24 + 24 == 52
    assert sum(s.bwd for s in sites) == 4 + 24 == 28
    assert {(s.B, s.Tq, s.Tk, s.H, s.Dh) for s in sites} == {
        (32, 50, 50, 8, 64), (32, 398, 398, 8, 64), (32, 192, 192, 8, 64),
        (32, 192, 50, 8, 64), (32, 192, 398, 8, 64)}
    ar = smoke_train.ar_causal_site()
    assert (ar.B, ar.Tq, ar.H, ar.causal) == (16, 64 + 1 + 512 + 1 + 192, 16, True)


def test_train_bound_counts_the_backward_at_two_and_a_half_forwards():
    from tts_with_diffusion_model_tpu_torch import smoke_train

    s = smoke_train.TrainSite("x", 2, 8, 8, 2, 16, False, 1, 1)
    qk = pv = 2 * 8 * 8 * 2
    b = smoke_train.train_bound_ms(s, torch.bfloat16, qk, pv)
    assert b["bwd_gflop"] == pytest.approx(2.5 * b["fwd_gflop"])


def test_train_phases_rehearsal():
    from tts_with_diffusion_model_tpu_torch import smoke_train

    sites = [smoke_train.TrainSite("self", 4, 9, 9, 2, 16, False, 2, 1),
             smoke_train.TrainSite("causal", 4, 7, 9, 2, 8, True, 0, 0)]
    res = smoke_train.phase_train_kernel_check(CPU, sites)
    assert len(res) == 4 and all(r["max_abs_err"] == 0.0 for r in res)
    line = smoke_train.train_kernel_summary(res, [("d3pm", 2, 1, 0)])
    assert line["launches"] == 3 and line["ms"] is None and line["source"].endswith(".cu")
    overrides = ["device=cpu", "model_overrides={d_model: 32, n_heads: 2, n_layers: 2, "
                 "timesteps: 8, text_len: 50, prom_len: 64, resp_len: 48}", "batch_size=4",
                 "eval_batch_size=8", "max_num_val=8", "nj=1", "resp_len_buckets=[32]"]
    out = smoke_train.phase_train(CPU, steps=2, overrides=overrides,
                                  corpus=(3, 12, (8, 30), (3, 12)))
    assert (out["fwd_per_step"], out["bwd_per_step"]) == (2 + 2 + 2 * 2 * 3, 2 + 2 + 2 * 3)
    assert len(out["eval"]) == 2 and out["moved"] > 0 and out["run_launches"] == 0


def test_nar_and_ar_steps_run_24_forward_and_12_backward_packed_attentions():
    from tts_with_diffusion_model_tpu_torch import smoke_train

    sites = {s.name: s for s in smoke_train.packed_sites()}
    shape = {n: (s.B, s.Tq, s.Tk, s.H, s.Dh, s.causal, s.fwd, s.bwd, s.fused)
             for n, s in sites.items()}
    packed = 64 + 1 + 512 + 1 + 192
    evalT = 64 + 1 + 896 + 1 + 512  # the eval loaders pad to the max_* bucket
    assert shape == {
        "NAR packed self": (16, packed, packed, 16, 64, False, 24, 12, True),
        "AR packed causal self": (16, packed, packed, 16, 64, True, 24, 12, True),
        "ar-quarter packed causal self": (64, packed, packed, 4, 64, True, 24, 12, True),
        "AR eval causal self": (32, evalT, evalT, 16, 64, True, 12, 0, True)}
    B, site = smoke_train.nar_eval_site()
    assert (B, site.Tq, site.Tk, site.H, site.Dh, site.count) == (32, evalT, evalT, 16, 64, 12)


@pytest.mark.parametrize("yaml", ["nar", "ar"])
def test_nar_and_ar_train_phases_rehearsal(yaml):
    from tts_with_diffusion_model_tpu_torch import smoke_train

    sites = [smoke_train.TrainSite("packed", 4, 12, 12, 2, 8, yaml == "ar", 4, 2, path=yaml,
                                   fused=True)]
    res = smoke_train.phase_train_kernel_check(CPU, sites)
    assert len(res) == 2 and all(r["max_abs_err"] == 0.0 and r["fused"] for r in res)
    overrides = ["device=cpu", "model_overrides={d_model: 32, n_heads: 2, n_layers: 2}",
                 "batch_size=4", "eval_batch_size=8", "max_num_val=8", "nj=1",
                 "resp_len_buckets=[32]", "prom_len_buckets=[64]", "max_prom_len=128",
                 "max_resp_len=64"]
    out = smoke_train.phase_train(CPU, getattr(smoke_train, f"{yaml.upper()}_YAML"), steps=2,
                                  overrides=overrides, corpus=(3, 12, (8, 30), (3, 12)))
    assert (out["fwd_per_step"], out["bwd_per_step"]) == (2 * 2, 2)
    assert out["eval_kernel"] == ("train_flash_attention" if yaml == "ar" else "masked_attention")
    assert out["eval_launches"] == 2 * out["eval_per_batch"] == 2 * 2  # subtrain + val batch
    assert out["moved"] > 0 and out["run_launches"] == 0 and out["sites"][0].path == yaml
    line = smoke_train.train_kernel_summary(res, [(yaml, 4, 2, 0)], [("ar eval", 2, 0, 4)])
    assert line["paths"][yaml]["launches"] == 6 and line["ms"] is None
    assert line["launches"] == 6 and line["launches_run"] == 4


def test_eval_site_rehearsal_and_kernel_line_paths():
    site = smoke.Site("eval self", 20, 20, 2, 8, 3)
    res = smoke.phase_site_check(CPU, site, B=4)
    assert len(res) == 2 and all(r["max_abs_err"] == 0.0 and r["count"] == 3 for r in res)
    line = smoke.kernel_summary(res, launches=0, eval_results=res, eval_launches=6)
    assert set(line["paths"]) == {"serving", "nar eval"}
    assert line["paths"]["nar eval"]["launches_run"] == 6


def test_work_counts_every_query_row_of_a_key_mask():
    km = torch.ones(2, 10)
    km[1, 5:] = 0
    km[0] = 0  # every key masked: no q·k, but the row averages all 10 values
    assert smoke.work(km, 10, 3) == (10 * 5 * 3, (10 * 5 + 10 * 10) * 3)
    assert smoke.work(km, 10, 3, causal=True) == (40 * 3, (40 + 100) * 3)
    full = smoke.bound_ms(16, 770, 770, 16, 64, torch.bfloat16)
    ones = smoke.bound_ms(16, 770, 770, 16, 64, torch.bfloat16,
                          smoke.work(torch.ones(16, 770), 770, 16))
    assert full == ones and full[1] == "operations"


def test_export_serve_phase_rehearsal():
    """Tiny D3PM and NAR runs of the train phase, then the export → serve
    phase over them: exports, bit-for-bit round trips, and three samplers
    through the plain versions."""
    from tts_with_diffusion_model_tpu_torch import smoke_export, smoke_train

    corpus = (3, 12, (8, 30), (3, 12))
    common = ["device=cpu", "batch_size=4", "eval_batch_size=8", "max_num_val=8", "nj=1",
              "resp_len_buckets=[32]"]
    d3pm = smoke_train.phase_train(CPU, steps=2, corpus=corpus, overrides=[
        *common, "model_overrides={d_model: 32, n_heads: 2, n_layers: 2, timesteps: 8, "
        "text_len: 50, prom_len: 64, resp_len: 48, gen_len: 40}"])
    nar = smoke_train.phase_train(CPU, smoke_train.NAR_YAML, steps=2, corpus=corpus, overrides=[
        *common, "model_overrides={d_model: 32, n_heads: 2, n_layers: 2}",
        "prom_len_buckets=[64]", "max_prom_len=128", "max_resp_len=64"])
    from tts_with_diffusion_model_tpu_torch.codec.encodec import Codec
    from tts_with_diffusion_model_tpu_torch.convert import init_seeded

    small = smoke.tiny_models()[3]  # the full codec's decode would dominate the test
    init_seeded(small, 2)
    codec = Codec(small, CPU)
    out = smoke_export.phase_export_serve(CPU, d3pm["argv"], nar["argv"], 2, repeats=1,
                                          ref_seconds=0.5, codec=codec)
    assert set(out["exports"]) == {"diffusion", "nar"}
    assert all(e["bytes"] > 0 and e["params"] > 0 for e in out["exports"].values())
    served = out["served"]
    assert list(served) == ["maskgit", "ancestral stride 1", "ancestral stride 3"]
    # T = 8: 7 process steps, 3 at stride 3 (t = 7, 4, 1)
    assert [r["steps"] for r in served.values()] == [12, 7, 3]
    for r in served.values():
        assert r["launches"] == 0 and r["denoiser_err"] == 0.0 and r["p50_s"] > 0
        assert r["expected"] == 4 + r["steps"] * 2 * 3 + 7 * 2
        assert all(c.shape == (40, 8) for c in r["codes"])


def test_export_serve_ar_phase_rehearsal():
    """Tiny AR and NAR runs of the train phase, the NAR exported, then the
    AR phase over them through the plain versions: the AR's export and
    round trip, one served batch with the plain calls counted (2 prefill
    forwards, 14 NAR attentions), codes and lengths checked, and the fp32
    speculative comparisons (a one-block quarter draft)."""
    from tts_with_diffusion_model_tpu_torch import smoke_ar, smoke_export, smoke_train
    from tts_with_diffusion_model_tpu_torch.codec.encodec import Codec
    from tts_with_diffusion_model_tpu_torch.convert import init_seeded

    corpus = (3, 12, (8, 30), (3, 12))
    overrides = ["device=cpu", "batch_size=4", "eval_batch_size=8", "max_num_val=8", "nj=1",
                 "resp_len_buckets=[32]", "model_overrides={d_model: 32, n_heads: 2, n_layers: 2}",
                 "prom_len_buckets=[64]", "max_prom_len=128", "max_resp_len=64"]
    runs = {yaml: smoke_train.phase_train(CPU, getattr(smoke_train, f"{yaml}_YAML"), steps=2,
                                          corpus=corpus, overrides=overrides)
            for yaml in ("AR", "NAR")}
    nar = smoke_export.export_run(runs["NAR"]["argv"], smoke.SMOKE_DIR / "export" / "nar", 2)
    small = smoke.tiny_models()[3]
    init_seeded(small, 2)
    out = smoke_ar.phase_export_serve_ar(
        CPU, runs["AR"]["argv"], nar["path"], 2, repeats=1, ref_seconds=0.5,
        codec=Codec(small, CPU), max_steps=24, quarter_steps=8,
        quarter_overrides={"d_model": 32, "n_heads": 2, "n_layers": 1})
    assert out["export"]["params"] > 0 and out["export"]["bytes"] > 0
    served = out["served"]
    assert served["expected"] == {"kernel2": 2, "kernel1": 14}
    assert served["launches"]["kernel2_plain"] == 2 and served["launches"]["kernel1_plain"] == 14
    assert all(1 <= n <= 24 for n in served["lengths"]) and served["prefill_err"] == 0.0
    spec = out["spec"]
    assert spec["fp32 self"]["identical"] and spec["fp32 quarter"]["identical"]
    assert spec["fp32 quarter"]["kernel2_plain"] == 3  # the target's 2 blocks + the draft's 1
    # the target as its own draft accepts every proposal: 23 tokens after the
    # first in rounds of k + 1 = 5, the last one cut at max_steps
    if min(spec["fp32 self"]["lengths"]) == 24:
        assert spec["fp32 self"]["rounds"] == 5
    assert set(spec) == {"fp32 self", "fp32 quarter", "bf16 self", "bf16 quarter"}


def test_ar_prefill_sites_and_their_layout_masks():
    """Kernel 2's AR prefill sites: 50 + 1 + pb + 1 slots, 12 forwards per
    batch only at the timed bucket (and the quarter draft's, 4 heads), keys
    masked as the packed prefix is: text and prompt pads mid-row, seps
    valid; the site check runs them through the plain version here."""
    from tts_with_diffusion_model_tpu_torch import smoke_ar, smoke_train

    sites = smoke_train.ar_prefill_sites((128, 256, 384, 398), timed_bucket=256)
    assert [(s.Tq, s.H, s.fwd, s.bwd, s.path) for s in sites] == [
        (180, 16, 0, 0, "ar serve"), (308, 16, 12, 0, "ar serve"), (436, 16, 0, 0, "ar serve"),
        (450, 16, 0, 0, "ar serve"), (308, 4, 12, 0, "ar serve draft")]
    assert all(s.causal and s.fused and s.Dh == 64 for s in sites)
    mask = smoke_train.prefix_mask(4, 50, 256, torch.Generator().manual_seed(0))
    assert mask.shape == (4, 308) and (mask[:, 50] == 1).all() and (mask[:, 307] == 1).all()
    assert (mask[:, :50].sum(1) >= 3).all() and (mask[:, :3] == 1).all()
    nar = smoke_ar.nar_site(50, 256, 448, {"d_model": 1024, "n_heads": 16, "n_layers": 12})
    assert (nar.Tq, nar.Tk, nar.H, nar.Dh, nar.count) == (756, 756, 16, 64, 84)
    tiny = [smoke_train.TrainSite("prefill", 3, 14, 14, 2, 8, True, 2, 0, path="ar serve",
                                  fused=True, layout=(4, 8))]
    res = smoke_train.phase_train_kernel_check(CPU, tiny)
    assert [r["max_abs_err"] for r in res] == [0.0, 0.0]
    line = smoke_train.train_kernel_summary(res, [], [("ar serve", 2, 0, 2)])
    assert line["paths"]["ar serve"]["launches"] == 2 and line["launches"] == 0


def test_serve_http_phase_rehearsal(tmp_path):
    """The serve http phase over tiny seeded bundles through the plain
    versions: the D3PM server's bursts, stream, overload, /stats, plain
    calls per batch and drain; the fp32 cohort identity; the AR burst."""
    from tts_with_diffusion_model_tpu_torch import smoke_serve
    from tts_with_diffusion_model_tpu_torch.codec.encodec import Codec
    from tts_with_diffusion_model_tpu_torch.convert import init_seeded

    bundles = smoke_serve.write_seeded_bundles(tmp_path, "tiny", seed=0)
    codec_model = smoke.tiny_models()[3]
    init_seeded(codec_model, 3)
    out = smoke_serve.phase_serve_http(CPU, *bundles, codec=Codec(codec_model, CPU),
                                       ref_seconds=0.5, max_ar_steps=16)
    d3pm = out["d3pm"]
    assert d3pm["per_batch"] == 4 + 12 * 2 * 3 + 7 * 2
    assert d3pm["launches"]["kernel1_plain"] == d3pm["stats"]["batches"] * d3pm["per_batch"]
    assert d3pm["stream"]["chunks"] == 3 and d3pm["overload"]["shed"] >= 1
    assert d3pm["stats"]["rejected"] == d3pm["overload"]["shed"]
    assert out["cohort fp32"]["identical"] and out["cohort fp32"]["share"] == 1.0
    assert out["ar"]["launches"]["kernel2_plain"] == 2 * out["ar"]["stats"]["batches"]
    assert set(out["first_request_s"]) == {"without_warmup", "warmup", "after_warmup"}


def test_serve_http_alone_refuses_without_cuda():
    from tts_with_diffusion_model_tpu_torch import smoke_serve

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(smoke.SmokeError, match="cuda.is_available"):
        smoke_serve.main([])
