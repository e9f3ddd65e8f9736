"""The "codec + evals" phase of the port's smoke run (``chip_smoke.py``
drives it on the card at the published widths, over the bundles earlier
phases exported; the CPU tests rehearse it at a tiny size with the plain
versions).

1. corpus     — ``scripts/make_gen_corpus.py`` (8 speakers × 11 utterances:
                the fewest per speaker that leave one in the 95/5 val
                split) and the port's ``emb.g2p``;
2. calibrate  — ``codec.calibrate`` from the seeded codec (written as
                converted weights and found through ``$ENCODEC_WEIGHTS``) at
                8 levels × 12 iterations: the residual RMS must fall level
                by level; the calibrated file loads through ``load_codec``,
                and ``emb.qnt`` encodes the corpus with it;
3. codec train — the ``codec.train`` CLI on ``config/gen4c/diffusion.yml``
                (its ``batch_size``, 150-frame segments) for 8 steps: loss
                and stats finite every step, parameters moved, the
                checkpoint reloads bit-identical; step p50 / p90 and the
                run's own peak memory;
4. evals      — ``heldout_eval`` (ancestral, MaskGIT, and the AR),
                ``speaker_transfer_eval`` (``--nar-bundle``),
                ``quality_gate`` (``--min-acc 0`` on a wav decoded from a
                corpus utterance's codes) and ``longform_seam_eval``, each
                through its CLI: its JSON with the JAX records' keys and
                finite numbers, and the kernels' launches equal to
                (denoiser calls × sites per call) with no plain call (on the
                CPU: the plain calls equal that count).

``python -m tts_with_diffusion_model_tpu_torch.smoke_codec`` runs the build
and this phase alone on the card, over seeded full-width bundles.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import shutil
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

import numpy as np
import torch

from .ops import masked_attention as attn_ops
from .ops import train_flash_attention as train_ops
from .smoke import REPO, SMOKE_DIR, check, log

CORPUS = (8, 11)
CODEC_YAML = REPO / "config" / "gen4c" / "diffusion.yml"
CODEC_STEPS = 8
CALIBRATE = ("--levels", "8", "--iters", "12")
EVAL_N = 8
TRIALS = 4
#: the JSON keys of the JAX repository's records of each evaluation
#: (``benchmarks/gen_r4``: ``heldout_fullstack_mini_v3.json``,
#: ``heldout_fullstack_ar_mini_v2.json``, ``transfer_eval_fullstack_mini_v2
#: .json``, ``quality_gate_mini_v3.json``, ``longform_seam_mini_v3.json``)
KEYS = {
    "heldout": {"summary": ["n_utts", "first_stage", "decode", "bundle", "nar_bundle", "split",
                            "mean"],
                "mean": ["n_utts", "acc", "codec_floor_mcd", "frames", "len_ratio",
                         *(f"level{i}_acc" for i in range(8)), "mcd", "mcd_vs_raw"],
                "per_utt": ["len_ratio", *(f"level{i}_acc" for i in range(8)), "acc", "mcd",
                            "frames", "mcd_vs_raw", "codec_floor_mcd", "path"]},
    "heldout_ar": {"summary": ["n_utts", "first_stage", "decode", "ar_temperature", "bundle",
                               "nar_bundle", "split", "mean"]},
    "transfer": {"summary": ["n_trials", "n_generations", "transfer_accuracy_2way",
                             "mean_margin", "attribution_accuracy_full", "n_speakers",
                             "chance_2way", "chance_full", "bundle", "frames_scored", "stack",
                             "nar_bundle"],
                 "trial": ["val_path", "prompted", "a", "b"],
                 "generation": ["speaker", "correct_2way", "margin", "pred_32way"]},
    "quality_gate": ["tokens_compared", "level0_token_accuracy", "min_acc", "decode", "ok"],
    "seam": {"top": ["n_segments", "total_frames", "one_shot", "hard_splice", "seam_free"],
             "flux": ["seam_flux_ratios", "seam_flux_ratio_max", "seam_flux_ratio_mean",
                      "flux_median"]},
}


def counts(device) -> dict:
    """The kernels' counters (after a sync): kernel-1 launches, kernel-2
    forward and backward launches, and both plain versions' calls."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    k1, k2 = attn_ops.masked_attention, train_ops.train_flash_attention
    return {"kernel1": k1.launches, "kernel2_fwd": k2.launches, "kernel2_bwd": k2.backward_launches,
            "plain": k1.plain_calls + k2.plain_calls}


def zero_counts():
    """Every counter to 0, and both shape recorders started afresh."""
    k1, k2 = attn_ops.masked_attention, train_ops.train_flash_attention
    k1.launches = k1.plain_calls = k2.launches = k2.backward_launches = k2.plain_calls = 0
    k1.shapes, k2.shapes = Counter(), Counter()


@contextlib.contextmanager
def codec_weights(path: Path):
    """``$ENCODEC_WEIGHTS`` set to ``path`` inside the block."""
    old = os.environ.get("ENCODEC_WEIGHTS")
    os.environ["ENCODEC_WEIGHTS"] = str(path)
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("ENCODEC_WEIGHTS", None)
        else:
            os.environ["ENCODEC_WEIGHTS"] = old


# ---------------- 1. corpus ----------------

def write_corpus(root: Path, speakers: int, utts: int) -> Path:
    """The synthetic corpus's wavs and texts (a child process) and their
    phones (``emb.g2p``)."""
    from .emb import g2p

    shutil.rmtree(root, ignore_errors=True)
    subprocess.run([sys.executable, str(REPO / "scripts" / "make_gen_corpus.py"), str(root),
                    "--speakers", str(speakers), "--utts", str(utts)], check=True,
                   stdin=subprocess.DEVNULL, stdout=subprocess.DEVNULL, timeout=600)
    with contextlib.redirect_stdout(io.StringIO()):  # a line per file written
        g2p.main([str(root)])
    return root


# ---------------- 2. calibrate ----------------

def write_seeded_codec(path: Path, seed: int, dims: dict | None = None) -> Path:
    """A codec's weights drawn from ``seed`` (the published widths, or
    ``dims``) as a converted-weights file."""
    from .codec.convert import codec_params, save_npz_params
    from .codec.encodec import EncodecModel
    from .convert import init_seeded

    model = EncodecModel(**(dims or {}))
    init_seeded(model, seed)
    path.parent.mkdir(parents=True, exist_ok=True)
    save_npz_params(codec_params(model), path)
    return path


def phase_calibrate(device, data: Path, seeded: Path, out: Path) -> dict:
    """``codec.calibrate`` on the corpus from the ``seeded`` codec, the
    checks, then ``emb.qnt`` with the calibrated codec."""
    from .codec import calibrate
    from .codec.encodec import load_codec
    from .emb import qnt

    t0 = time.perf_counter()
    with codec_weights(seeded):
        res = calibrate.main([str(data), "--out", str(out), *CALIBRATE, "--device", str(device)])
    secs = time.perf_counter() - t0
    rms = [lv["residual_rms"] for lv in res["levels"]]
    for lv in res["levels"]:
        log(f"calibrate level {lv['level']}: residual RMS {lv['residual_rms']:.5f}, codes used "
            f"{lv['codes_used']}, {lv['seconds']:.2f} s")
    check(len(rms) == 8 and all(math.isfinite(r) for r in rms), f"residual RMS {rms}")
    check(all(b < a for a, b in zip(rms, rms[1:])), f"the residual RMS does not fall: {rms}")
    codec = load_codec(out, device=device)
    check(codec.model.quantizer.codebooks.shape[0] >= 8, "the calibrated codec has < 8 levels")
    del codec
    t1 = time.perf_counter()
    with codec_weights(out), contextlib.redirect_stdout(io.StringIO()):
        written = qnt.main([str(data), "--device", str(device)])
    n_wavs = len(list(data.rglob("*.wav")))
    check(len(written) == n_wavs, f"emb.qnt wrote {len(written)} code files for {n_wavs} wavs")
    log(f"calibrate: {res['latents'][0]} latents of {res['latents'][1]} dims, 8 levels in "
        f"{secs:.2f} s; emb.qnt {n_wavs} utterances in {time.perf_counter() - t1:.2f} s")
    return {"levels": res["levels"], "seconds": secs, "latents": list(res["latents"]),
            "qnt_seconds": time.perf_counter() - t1}


# ---------------- 3. codec train ----------------

def phase_codec_train(device, data: Path, out: Path, seed: int = 0, overrides=(),
                      segment_frames: int = 150) -> dict:
    """The ``codec.train`` CLI for ``CODEC_STEPS`` steps, and the checks."""
    from .codec import train as codec_train
    from .codec.encodec import EncodecModel
    from .config import Config
    from .convert import init_seeded
    from .train.engine import Engine

    shutil.rmtree(out, ignore_errors=True)
    argv = [f"yaml={CODEC_YAML}", f"data_dirs=[{data}]", f"log_root={out / 'logs'}",
            f"ckpt_root={out / 'ckpts'}", f"max_iter={CODEC_STEPS}",
            f"save_ckpt_every={CODEC_STEPS}", f"device={device}", f"seed={seed}", *overrides]
    cfg = Config.from_cli(argv)
    log(f"codec train: {' '.join(argv)}")
    records = []
    on_card = device.type == "cuda"
    held = torch.cuda.memory_allocated(device) if on_card else None
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    engine = codec_train.main(cfg, logger=lambda data: records.append(data),
                              segment_frames=segment_frames)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device) - held if on_card else None

    check(len(records) == CODEC_STEPS, f"{len(records)} logged steps != {CODEC_STEPS}")
    for i, stats in enumerate(records):
        check(stats["global_step"] == i + 1, f"step {i + 1} logged as {stats['global_step']}")
        for key in ("codec.loss", "stft", "l1", "codebook", "commit", "grad_norm"):
            check(math.isfinite(stats[key]), f"codec step {i + 1}: {key} = {stats[key]}")
    init = EncodecModel()
    init_seeded(init, cfg.seed)
    moved = max((a.detach().cpu() - b).abs().max().item()
                for a, b in zip(engine.module.parameters(), init.parameters()))
    check(moved > 0, "the codec's parameters did not move")
    ckpt = cfg.ckpt_dir / "codec" / f"step_{CODEC_STEPS:08d}.pt"
    check(ckpt.exists(), f"no checkpoint at {ckpt}")
    fresh_model = EncodecModel()
    init_seeded(fresh_model, cfg.seed + 1)
    fresh = Engine("codec", fresh_model.to(device), codec_train.make_codec_loss_fn(),
                   dict(cfg.optimizer_cfg), cfg.ckpt_dir)
    check(fresh.load_checkpoint() and fresh.step == CODEC_STEPS, "the checkpoint did not reload")
    same = all(torch.equal(a, b) for a, b in zip(fresh.params, engine.params))
    opt_a, opt_b = fresh.optimizer.state_dict()["state"], engine.optimizer.state_dict()["state"]
    same = same and all(torch.equal(opt_a[i][k].cpu(), opt_b[i][k].cpu())
                        for i in opt_b for k in opt_b[i])
    check(same, "the reloaded codec engine differs from the trained one")
    del fresh, fresh_model, opt_a, opt_b
    times = [r["elapsed_time"] for r in records]
    p50, p90 = float(np.median(times[1:])), float(np.percentile(times[1:], 90))
    mem = "n/a" if peak is None else (f"{peak / 2**30:.2f} GiB above the {held / 2**30:.2f} GiB "
                                      "held before the run")
    log(f"codec train: {CODEC_STEPS} steps (B={cfg.batch_size} x {segment_frames} frames) in "
        f"{wall:.1f} s; step p50 {p50 * 1e3:.1f} ms, p90 {p90 * 1e3:.1f} ms, first "
        f"{times[0] * 1e3:.1f} ms; peak allocated {mem}; losses "
        f"{[round(r['codec.loss'], 4) for r in records]}")
    return {"p50_step_s": p50, "p90_step_s": p90, "step_s": times, "peak_bytes": peak,
            "held_bytes": held, "wall_s": wall, "moved": moved, "batch_size": cfg.batch_size,
            "losses": [r["codec.loss"] for r in records]}


# ---------------- 4. evals ----------------

def per_call(bundle: Path) -> dict:
    """Sites per call of a bundle's model, from its ``model.json``: the
    diffusion model's towers (once per generation) and denoiser (3 per
    block), the NAR's 7 levels × blocks, the AR's prefill (a block each)."""
    from .bundle import load_meta
    from .serve import build_model

    meta = load_meta(bundle)
    with torch.device("meta"):
        model = build_model(meta)
    if hasattr(model, "denoiser"):
        den = model.denoiser
        return {"towers": den.text_tower.n_layers + den.prom_tower.n_layers,
                "denoiser": 3 * den.n_layers, "timesteps": model.config.timesteps,
                "gen_len": model.config.gen_len}
    if meta["model"].startswith("nar"):
        return {"nar": 7 * model.base.n_layers}
    return {"prefill": model.base.n_layers}


def _run(name: str, device, fn, want, results: dict):
    """``fn()`` with every counter set to 0 just before it and read just
    after, checked against ``want`` ({"kernel1": n, "kernel2_fwd": m}, or a
    function of ``fn``'s result giving it): on the card exactly, with no
    plain call and no backward; on the CPU, the plain calls total n + m.
    The shapes of the calls are kept for the kernel check."""
    k1, k2 = attn_ops.masked_attention, train_ops.train_flash_attention
    zero_counts()
    t0 = time.perf_counter()
    try:
        out = fn()
        got = counts(device)
    finally:
        shapes = {"kernel1": k1.shapes, "kernel2": k2.shapes}
        k1.shapes = k2.shapes = None
    secs = time.perf_counter() - t0
    want = want(out) if callable(want) else want
    want = {"kernel1": want.get("kernel1", 0), "kernel2_fwd": want.get("kernel2_fwd", 0)}
    if device.type == "cuda":
        check(got == {**want, "kernel2_bwd": 0, "plain": 0},
              f"{name}: launches {got} != {want} with no plain call")
    else:
        check(got["plain"] == sum(want.values()) and got["kernel1"] == got["kernel2_fwd"] == 0,
              f"{name}: plain calls {got['plain']} != {sum(want.values())}")
    check(sum(shapes["kernel1"].values()) == want["kernel1"]
          and sum(shapes["kernel2"].values()) == want["kernel2_fwd"],
          f"{name}: recorded shapes {shapes} do not add up to {want}")
    log(f"eval {name}: {secs:.2f} s, launches {got} (expected {want})")
    results[name] = {"seconds": secs, "launches": got, "expected": want, "shapes": shapes}
    return out


def _finite(obj, where: str):
    """Every number in a JSON tree is finite."""
    if isinstance(obj, dict):
        for k, v in obj.items():
            _finite(v, f"{where}.{k}")
    elif isinstance(obj, list):
        for i, v in enumerate(obj):
            _finite(v, f"{where}[{i}]")
    elif isinstance(obj, float):
        check(math.isfinite(obj), f"{where} = {obj}")


def _keys(got, want: list, where: str):
    check(list(got) == want, f"{where}: keys {list(got)} != the JAX record's {want}")


def check_json(kind: str, blob: dict):
    """``blob`` has the JAX record's keys (in order) and finite numbers."""
    _finite(blob, kind)
    if kind.startswith("heldout"):
        k = KEYS[kind]["summary"]
        _keys(blob["summary"], k, f"{kind} summary")
        _keys(blob["summary"]["mean"], KEYS["heldout"]["mean"], f"{kind} mean")
        for row in blob["per_utt"]:
            if row.get("len_ratio") != 0.0 or "mcd" in row:  # an AR row that stopped at once
                _keys(row, KEYS["heldout"]["per_utt"], f"{kind} per_utt")
    elif kind == "transfer":
        _keys(blob["summary"], KEYS["transfer"]["summary"], "transfer summary")
        for row in blob["trials"]:
            _keys(row, KEYS["transfer"]["trial"], "transfer trial")
            for tag in ("a", "b"):
                _keys(row[tag], KEYS["transfer"]["generation"], "transfer generation")
    elif kind == "quality_gate":
        _keys(blob, KEYS["quality_gate"] + (["full_stack"] if "full_stack" in blob else []),
              "quality_gate")
    else:
        _keys(blob, KEYS["seam"]["top"], "seam")
        for part in ("one_shot", "hard_splice"):
            _keys(blob[part], KEYS["seam"]["flux"], f"seam {part}")


def gate_input(data: Path, out: Path, codec_file: Path, device) -> tuple[Path, str]:
    """A wav decoded from the first corpus utterance's codes, and its text."""
    from .audio.wavio import write_wav
    from .codec.encodec import load_codec
    from .data.dataset import load_quants

    qnt = sorted(data.rglob("*.qnt.npy"))[0]
    codes = load_quants(qnt)  # (t, 8)
    codec = load_codec(codec_file, device=device)
    wav, sr = codec.decode(codes.T)
    path = out / "gate_ref.wav"
    write_wav(path, wav, sr)
    text = (qnt.parent / (qnt.name.split(".")[0] + ".normalized.txt")).read_text().strip()
    return path, text


def phase_evals(device, data: Path, codec_file: Path, bundles: dict, out: Path,
                extra=()) -> dict:
    """The four entry points through their CLIs on ``bundles`` ({"d3pm",
    "nar", "ar"}) and the corpus coded with ``codec_file``, with the checks.
    ``extra``: more flags for ``heldout_eval`` and ``speaker_transfer_eval``
    (smaller buckets for a tiny rehearsal)."""
    from .models.diffusion import ancestral_schedule
    from .scripts import heldout_eval, longform_seam_eval, quality_gate, speaker_transfer_eval

    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    dev = str(device)
    d3pm, nar, ar = (str(bundles[k]) for k in ("d3pm", "nar", "ar"))
    sites = {k: per_call(Path(bundles[k])) for k in ("d3pm", "nar", "ar")}
    dit, n_nar = sites["d3pm"], sites["nar"]["nar"]
    # kernel-1 launches of one batch: the ancestral chain, MaskGIT's 12 calls
    chain = dit["towers"] + len(ancestral_schedule(dit["timesteps"], 1)[0]) * dit["denoiser"]
    maskgit = dit["towers"] + min(12, dit["gen_len"]) * dit["denoiser"]
    data_args = [f"data_dirs=[{data}]"]
    d3pm_cfg = [f"yaml={REPO / 'config' / 'gen4c' / 'diffusion.yml'}", *data_args]
    ar_cfg = [f"yaml={REPO / 'config' / 'gen4c' / 'ar.yml'}", *data_args]
    # the AR prefill's key layout: its text and prompt buckets
    ar_layout = heldout_eval.buckets(heldout_eval.parse_args([ar, "--nar-bundle", nar, *ar_cfg])[0],
                                     None, True, 0)[:2]
    runs, blobs = {}, {}
    with codec_weights(codec_file):
        for decode, per_batch in (("ancestral", chain), ("maskgit", maskgit)):
            path = out / f"heldout_{decode}.json"
            _run(f"heldout_eval {decode}", device, lambda: heldout_eval.main([
                d3pm, "--nar-bundle", nar, "--out", str(path), "--n", str(EVAL_N), "--decode",
                decode, "--device", dev, *extra, *d3pm_cfg]),
                {"kernel1": per_batch + n_nar}, runs)
            blobs[f"heldout_{decode}"] = blob = json.loads(path.read_text())
            check_json("heldout", blob)
        path = out / "heldout_ar.json"
        _run("heldout_eval ar", device, lambda: heldout_eval.main([
            ar, "--nar-bundle", nar, "--out", str(path), "--n", str(EVAL_N), "--device", dev,
            *extra, *ar_cfg]),
            {"kernel1": n_nar, "kernel2_fwd": sites["ar"]["prefill"]}, runs)
        blobs["heldout_ar"] = blob = json.loads(path.read_text())
        check_json("heldout_ar", blob)

        path = out / "transfer.json"
        _run("speaker_transfer_eval", device, lambda: speaker_transfer_eval.main([
            d3pm, "--out", str(path), "--trials", str(TRIALS), "--nar-bundle", nar, "--device",
            dev, *extra, *d3pm_cfg]), {"kernel1": 2 * TRIALS * (chain + n_nar)}, runs)
        blobs["transfer"] = blob = json.loads(path.read_text())
        check_json("transfer", blob)
        check(blob["summary"]["n_generations"] == 2 * TRIALS, "transfer: generations")

        # the report is the first line of the gate's standard output
        wav, text = gate_input(data, out, codec_file, device)
        stdout = io.StringIO()
        with contextlib.redirect_stdout(stdout):
            _run("quality_gate", device, lambda: quality_gate.main([
                d3pm, str(wav), text, "--min-acc", "0", "--nar-bundle", nar, "--device", dev]),
                {"kernel1": chain + n_nar}, runs)
        print(stdout.getvalue(), end="", flush=True)
        path = out / "quality_gate.json"
        path.write_text(stdout.getvalue().splitlines()[0] + "\n")
        blobs["quality_gate"] = blob = json.loads(path.read_text())
        check_json("quality_gate", blob)
        check(blob["ok"] is True, f"quality_gate at --min-acc 0: {blob}")

        path = out / "longform_seam.json"
        _run("longform_seam_eval", device, lambda: longform_seam_eval.main([
            d3pm, nar, str(wav), "--out", str(path), "--device", dev]),
            lambda res: {"kernel1": res["n_segments"] * (maskgit + n_nar)}, runs)
        blobs["longform_seam"] = blob = json.loads(path.read_text())
        check_json("seam", blob)
        check(blob["n_segments"] >= 2, f"longform: {blob['n_segments']} segments")
    return {"runs": runs, "json": blobs, "sites": sites, "ar_layout": ar_layout}


def eval_kernel_check(device, runs: dict, ar_layout: tuple[int, int], seed: int = 0) -> dict:
    """Each kernel against its plain version at every shape the evaluations
    gave it (fp32 and bf16, timed in bf16), once per shape; then per
    evaluation Σ launches × time over its shapes.  Kernel 1's results and
    paths, kernel 2's (the AR prefill's, with ``ar_layout``'s key mask)."""
    from .smoke import Site, batch_totals, phase_site_check
    from .smoke_train import TrainSite, phase_train_kernel_check

    k1 = {}
    for r in runs.values():
        for (B, Tq, H, Dh, Tk) in r["shapes"]["kernel1"]:
            if (B, Tq, Tk, H, Dh) not in k1:
                k1[B, Tq, Tk, H, Dh] = phase_site_check(
                    device, Site(f"eval {Tq}x{Tk} H{H}", Tq, Tk, H, Dh, 1), B, seed)
    paths1, sites2 = {}, []
    for name, r in runs.items():
        timed = [dict(res, count=n) for (B, Tq, H, Dh, Tk), n in r["shapes"]["kernel1"].items()
                 for res in k1[B, Tq, Tk, H, Dh]]
        paths1[name] = dict(batch_totals(timed), launches_run=r["launches"]["kernel1"])
        sites2 += [TrainSite(f"{name} prefill", B, Tq, Tk, H, Dh, causal, n, 0, path=name,
                             fused=True, layout=ar_layout)
                   for (B, Tq, H, Dh, Tk, causal), n in r["shapes"]["kernel2"].items()]
    results2 = phase_train_kernel_check(device, sites2, seed=seed) if sites2 else []
    runs2 = [(s.path, s.fwd, 0, runs[s.path]["launches"]["kernel2_fwd"]) for s in sites2]
    return {"kernel1": [res for pair in k1.values() for res in pair], "paths1": paths1,
            "kernel2": results2, "runs2": runs2}


def phase_codec_evals(device, bundles: dict, seed: int = 0, corpus=CORPUS, codec_dims=None,
                      train_overrides=(), segment_frames: int = 150, extra=(),
                      root: Path | None = None) -> dict:
    """Steps 1-4 under ``root`` (default ``build/smoke/codec``).
    ``codec_dims``, ``train_overrides``, ``segment_frames`` and ``extra``
    shrink the phase for a CPU rehearsal."""
    root = root or SMOKE_DIR / "codec"
    t0 = time.perf_counter()
    data = write_corpus(root / "data", *corpus)
    log(f"codec corpus: {corpus[0]} speakers x {corpus[1]} utterances in "
        f"{time.perf_counter() - t0:.2f} s")
    seeded = write_seeded_codec(root / "seeded_codec.npz", seed, codec_dims)
    calibrated = root / "calibrated_codec.npz"
    out = {"corpus_s": time.perf_counter() - t0,
           "calibrate": phase_calibrate(device, data, seeded, calibrated)}
    out["train"] = phase_codec_train(device, data, root / "train", seed, train_overrides,
                                     segment_frames)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    out["evals"] = phase_evals(device, data, calibrated, bundles, root / "evals", extra)
    out["kernels"] = eval_kernel_check(device, out["evals"]["runs"], out["evals"]["ar_layout"],
                                       seed)
    return out


def main(argv=None) -> int:
    import argparse

    from .smoke import phase, phase_build, phase_device
    from .smoke_serve import write_seeded_bundles

    parser = argparse.ArgumentParser(description="the codec + evals phase alone, on the card, "
                                                 "over seeded full-width bundles")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    device = torch.device("cuda", 0)
    phase_device(device)  # raises without a card
    with phase("build"):
        phase_build(device)
    d3pm, nar, ar = write_seeded_bundles(SMOKE_DIR / "codec_seeded", "full", args.seed)
    with phase("codec + evals"):
        phase_codec_evals(device, {"d3pm": d3pm, "nar": nar, "ar": ar}, seed=args.seed)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
