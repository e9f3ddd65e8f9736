"""The smoke run's gen4b training phase and remat-policy check, rehearsed on
the CPU at a tiny size with the plain versions (``chip_smoke.py`` runs them
at full width on the card), and the launch counts their sites give at full
width."""

import pytest
import torch

from tts_with_diffusion_model_tpu_torch import smoke_gen4b

from torch_port_helpers import one_thread, small_codec  # noqa: F401 (fixtures)

CPU = torch.device("cpu")
pytestmark = pytest.mark.usefixtures("one_thread")
TINY = ["device=cpu", "batch_size=4", "eval_batch_size=8", "max_num_val=8", "nj=1",
        "resp_len_buckets=[32]", "prom_len_buckets=[64]", "max_prom_len=128", "max_resp_len=64",
        "max_val_ar_steps=8", "model_overrides={d_model: 32, n_heads: 2, n_layers: 2, "
        "timesteps: 8, text_len: 50, prom_len: 64, resp_len: 48, gen_len: 40}"]


@pytest.mark.parametrize("family,kernel,B,expected", [
    ("d3pm", "masked_attention", 32, 2 + 2 + 99 * 8 * 3),
    ("nar", "masked_attention", 32, 7 * 12),
    ("ar", "train_flash_attention", 32, 12)])
def test_eval_decode_launches_per_batch_at_full_width(family, kernel, B, expected):
    """2380 kernel-1 launches per D3PM eval decode batch (the ancestral
    chain's 99 process steps), 84 per NAR batch at the 1474-slot eval
    bucket, 12 kernel-2 forwards per AR batch (its prefill)."""
    got = smoke_gen4b.decode_sites(smoke_gen4b.RECIPES[family])
    assert (got["kernel"], got["B"], got["expected"]) == (kernel, B, expected)
    assert expected in (2380, 84, 12)
    if family == "nar":
        assert got["sites"][0].Tq == 64 + 1 + 896 + 1 + 512 == 1474
    if family == "ar":
        s = got["sites"][0]
        assert (s.Tq, s.causal, s.fwd, s.bwd, s.layout) == (962, True, 12, 0, (64, 896))


def test_gen4b_train_sites_at_b64():
    sites = {(s.path, s.name): s for s in smoke_gen4b.train_sites()}
    assert {s.B for s in sites.values()} == {64}
    assert sum(s.fwd for s in sites.values() if s.path == "gen4b d3pm") == 52
    assert sum(s.bwd for s in sites.values() if s.path == "gen4b d3pm") == 28
    for family in ("nar", "ar"):
        (s,) = [s for s in sites.values() if s.path == f"gen4b {family}"]
        assert (s.Tq, s.fwd, s.bwd, s.causal) == (64 + 1 + 512 + 1 + 192, 24, 12, family == "ar")


def test_gen4b_phase_rehearsal(monkeypatch, small_codec):
    """The three recipes at a tiny size: the native loader, two eval
    decodes each through the plain versions, hyp / ref wavs and metrics per
    split, and the D3PM's trace under ``profile/step_2`` from its own
    traced run."""
    from tts_with_diffusion_model_tpu_torch.codec import encodec

    monkeypatch.setattr(encodec, "load_codec", lambda *a, **kw: small_codec)
    out = smoke_gen4b.phase_gen4b(CPU, overrides=TINY, corpus=(3, 12, (8, 30), (3, 12)))
    assert set(out) == {"d3pm", "nar", "ar"}
    for family, r in out.items():
        assert [d["name"] for d in r["decodes"]] == ["subtrain", "val"]
        assert all(d["plain"] > 0 and d["kernel1"] == d["kernel2_fwd"] == 0
                   for d in r["decodes"])
        assert r["metrics"]["val"]["n_utts"] >= 1 and r["batch_size"] == 4
    # the D3PM's decode: 2 + 2 tower layers, then 7 process steps x 2 blocks x 3
    assert out["d3pm"]["decodes"][0]["plain"] == 2 + 2 + 7 * 2 * 3
    assert out["nar"]["decodes"][0]["plain"] == 7 * 2
    assert out["ar"]["decodes"][0]["plain"] == 2
    assert out["d3pm"]["trace_bytes"] > 0


def test_remat_phase_rehearsal():
    out = smoke_gen4b.phase_remat(CPU, overrides=TINY)
    for family in ("d3pm", "nar"):
        rows = out[family]
        assert list(rows) == ["None", "dots", "dots_all", "nothing"]
        assert all(r["max_rel_err"] <= smoke_gen4b.REMAT_TOL for r in rows.values())
        assert len({r["launches"] for r in rows.values()}) == 1
        assert rows["None"]["launches"][2] > 0  # the plain version ran every attention
