"""The whole chain users run, on the port, with what it measures:

    python -m tts_with_diffusion_model_tpu_torch.recipe_run <workdir> \\
        [--device cuda] [--codec weights.npz] [--tiny]

1. ``scripts/make_gen_corpus.py`` writes the mini corpus (32 speakers × 24
   utterances) under ``<workdir>/data/train``;
2. ``emb.g2p`` and ``emb.qnt`` write its phones and codes (1 and 2 are
   skipped where an earlier run left the codes);
3. the train CLI runs ``config/gen4c/diffusion.yml`` (2000 steps) and then
   ``nar.yml`` (600 steps), their data and outputs pointed into
   ``<workdir>``;
4. the D3PM's val loss at every saved tick is evaluated again under 16
   generator seeds (sampled t, as the run's own eval) and averaged over
   every t (``all_t``), for the raw and the EMA weights, to give the
   estimator's spread;
5. the export CLI writes the D3PM's val-minimum tick and the NAR's last
   step (``--ema``);
6. a ``Synthesizer`` over the two bundles answers the val utterances' texts
   with their own speakers' prompts (another utterance of the speaker),
   with MaskGIT and with the ancestral chain at stride 3, in bf16 and in
   fp32 with the same seeds: p50 per batch of 4, the share of identical
   codes bf16 against fp32, and the first denoiser call's logits.

With ``--zoo-estimator BUNDLE`` it makes the corpus and codes and trains
the D3PM recipe (steps 1-3 without the NAR), then holds the run's last
step's EMA against the D3PM bundle (``zoo/diffusion``: the JAX package's
``gen4c/diffusion`` run, EMA at step 2000, trained on this corpus and
codec) on the run's val split with both estimators of step 4, and writes
``report_zoo.json``.

With ``--ar`` it runs the AR chain instead, reusing the workdir's corpus,
codes and NAR bundle when an earlier run left them (else making them as
above):

1. the train CLI runs ``config/gen4c/ar.yml`` (600 steps) and
   ``ar_quarter.yml`` (800 steps), and the export CLI writes both at their
   last step (``--ema``);
2. a ``Synthesizer`` over the AR and NAR bundles answers the val
   utterances at temperature 1.0 (``max_ar_steps`` 448): p50 per batch of
   4, tokens per second, the lengths' distribution;
3. the AR first stage alone, greedy at ``max_steps`` 192, plain and
   speculative with the quarter draft at k = 2, 4, 6, 8: the fields of the
   JAX package's record ``benchmarks/gen_r4/spec_decode_mini_v2.json``
   (p50, tokens per second, rounds, accepted per round, acceptance rate,
   identity with plain greedy, the first divergence and the top-2 margin of
   the serving target's teacher-forced logits there), over batches of 4:
   rounds summed over the batches, the per-round rates averaged.

Writes ``<workdir>/report.json`` (``report_ar.json`` with ``--ar``; each
step's log beside it) and prints a summary.  ``--tiny`` runs the same chain
at a tiny size (2 speakers × 11 utterances, 4 steps, d32 models), for a
rehearsal on the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
PKG = __package__
BATCH = 4
TINY_D3PM = ["model_overrides={d_model: 32, n_heads: 2, n_layers: 2, timesteps: 8, text_len: 50, "
             "prom_len: 64, resp_len: 48, gen_len: 40}", "max_iter=4", "eval_every=2",
             "save_ckpt_every=2", "batch_size=4", "resp_len_buckets=[32]", "nj=1"]
TINY_NAR = ["model_overrides={d_model: 32, n_heads: 2, n_layers: 2}", "max_iter=4",
            "eval_every=2", "save_ckpt_every=2", "batch_size=4", "resp_len_buckets=[32]",
            "prom_len_buckets=[64]", "max_prom_len=128", "max_resp_len=64", "nj=1"]
TINY_AR = [*TINY_NAR[1:], "model_overrides={d_model: 32, n_heads: 2, n_layers: 2}"]
TINY_AR_QUARTER = [*TINY_NAR[1:], "model_overrides={d_model: 32, n_heads: 2, n_layers: 1}"]
SEEDS = 16
#: speculative chunk sizes of the JAX record, and its greedy max_steps
SPEC_KS = (2, 4, 6, 8)
SPEC_STEPS = 192
#: the serving default's response bucket
AR_SERVE_STEPS = 448


class Run:
    """The chain's state: where it writes, the device and the report."""

    def __init__(self, workdir: Path, device: str, codec: Path | None, tiny: bool):
        self.work, self.device, self.codec, self.tiny = Path(workdir), device, codec, tiny
        self.data = self.work / "data" / "train"
        self.t0 = time.perf_counter()
        self.report: dict = {"device": device_name(device), "seconds": {}}
        outputs = [f"data_dirs=[{self.data}]", f"log_root={self.work / 'logs'}",
                   f"ckpt_root={self.work / 'ckpts'}", f"device={device}"]
        self.d3pm = ["yaml=config/gen4c/diffusion.yml", *outputs, *(TINY_D3PM if tiny else [])]
        self.nar = ["yaml=config/gen4c/nar.yml", *outputs, *(TINY_NAR if tiny else [])]
        self.ar = ["yaml=config/gen4c/ar.yml", *outputs, *(TINY_AR if tiny else [])]
        self.ar_quarter = ["yaml=config/gen4c/ar_quarter.yml", *outputs,
                           *(TINY_AR_QUARTER if tiny else [])]

    def log(self, msg: str):
        print(f"[{time.perf_counter() - self.t0:8.1f} s] {msg}", flush=True)

    def sync(self):
        if torch.device(self.device).type == "cuda":
            torch.cuda.synchronize()

    def step(self, name: str, *args, env=None) -> str:
        """One command of the chain (a child Python, no input) → its output."""
        t0 = time.perf_counter()
        out = self.work / f"{name}.log"
        with open(out, "w") as f:
            p = subprocess.run([sys.executable, *args], cwd=REPO, stdin=subprocess.DEVNULL,
                               stdout=f, stderr=subprocess.STDOUT,
                               env={**os.environ, "PYTHONPATH": str(REPO), **(env or {})})
        self.report["seconds"][name] = time.perf_counter() - t0
        self.log(f"{name}: exit {p.returncode} in {self.report['seconds'][name]:.1f} s")
        if p.returncode:
            raise RuntimeError(f"{name} failed (exit {p.returncode}):\n"
                               + out.read_text()[-4000:])
        return out.read_text()

    def save(self, name: str = "report.json"):
        self.report["wall_s"] = time.perf_counter() - self.t0
        (self.work / name).write_text(json.dumps(self.report, indent=1))


def device_name(device: str) -> str:
    """The card's ``nvidia-smi`` name and power limit, or "cpu"."""
    if torch.device(device).type != "cuda":
        return "cpu"
    from .smoke import nvidia_smi_line

    return nvidia_smi_line()


def parse_train_log(text: str) -> dict:
    """The train CLI's output → the loader it took, step-time percentiles
    (its stats' ``elapsed_time``, the first step left out), the stalls
    (steps over 3× the p50: how many, and their share of the summed step
    time), the loss every 100 steps and the Eval lines."""
    steps = [json.loads(ln[ln.index("{"):]) for ln in text.splitlines()
             if " - {" in ln and '"elapsed_time"' in ln]
    evals = re.findall(r"'loss': ([0-9.eE+-]+), 'global_step': (\d+), 'name': '(\w+)'", text)
    loader = re.search(r"Training batches from the (\w+) loader", text)
    times = np.array([s["elapsed_time"] for s in steps[1:]]) * 1e3
    slow = times[times > 3 * np.median(times)]
    return {"loader": loader.group(1) if loader else None,
            "steps": len(steps), "first_step_ms": steps[0]["elapsed_time"] * 1e3,
            "step_ms_p10_p50_p90": [float(np.percentile(times, q)) for q in (10, 50, 90)],
            "step_s_sum": float(times.sum() / 1e3),
            "slow_steps": int(len(slow)), "slow_share": float(slow.sum() / times.sum()),
            "loss_every_100": [(s["global_step"], s["model.loss"]) for s in steps
                               if s["global_step"] % 100 == 0],
            "val": [(int(s), float(v)) for v, s, n in evals if n == "val"],
            "subtrain": [(int(s), float(v)) for v, s, n in evals if n == "subtrain"]}


def estimate(model, batches, device) -> dict:
    """A D3PM's val loss over ``batches`` under ``SEEDS`` generator seeds
    (sampled t, as the run's own eval: mean, spread, extremes) and averaged
    over every t (``all_t``)."""
    def mean_loss(seed: int) -> float:
        g = torch.Generator(device=device).manual_seed(seed)
        return float(np.mean([float(model.loss(b, g)[0]) for b in batches]))

    losses = [mean_loss(s) for s in range(SEEDS)]
    sampled = model.config
    model.config = dataclasses.replace(sampled, train_mode="all_t")
    all_t = mean_loss(0)
    model.config = sampled
    return {"mean": float(np.mean(losses)), "std": float(np.std(losses)), "min": min(losses),
            "max": max(losses), "all_t": all_t}


@torch.no_grad()
def val_spread(run: Run, steps: list[int]) -> dict:
    """At each checkpoint step: the D3PM's val loss under ``SEEDS``
    generator seeds (sampled t, as the run's own eval) and averaged over
    every t, for the raw weights (what the run's eval reads) and for the
    EMA (what ``--ema`` exports)."""
    from .config import Config
    from .data.dataset import create_train_val_dataloader
    from .train.engine import batch_to_device
    from .train.train import load_engines, make_bucket

    out = {}
    for step in steps:
        cfg = Config.from_cli([*run.d3pm, f"restore_step={step}"])
        engine = load_engines(cfg)["model"]
        model = engine.module
        _, _, val_dl = create_train_val_dataloader(cfg, make_bucket(cfg, model))
        batches = [batch_to_device(b, run.device) for b in val_dl]
        out[step] = {}
        for weights in ("raw", "ema"):
            if weights == "ema":
                for p, e in zip(engine.params, engine.ema):
                    p.copy_(e)
            out[step][weights] = estimate(model, batches, run.device)
        run.log(f"val spread at step {step}: {json.dumps(out[step])}")
        del engine, model, batches
    return out


@torch.no_grad()
def zoo_estimate(run: Run, zoo_bundle: Path, step: int) -> dict:
    """The JAX package's own run and the port's, side by side: the D3PM
    bundle ``zoo_bundle`` (``zoo/diffusion``: JAX's ``gen4c/diffusion`` run,
    EMA weights at step 2000) and the port's EMA at ``step`` of this run,
    each through ``estimate`` on this run's val split, in the run's compute
    dtype.  The bundle's phone symmap must be the run's (the same corpus
    through the same g2p), else its ids would mean other phones."""
    from .config import Config
    from .data.dataset import create_datasets, create_train_val_dataloader
    from .serve import load_model
    from .train.engine import batch_to_device
    from .train.train import load_engines, make_bucket

    cfg = Config.from_cli([*run.d3pm, f"restore_step={step}"])
    engine = load_engines(cfg)["model"]
    port = engine.module
    port_step = engine.global_step
    for p, e in zip(engine.params, engine.ema):
        p.copy_(e)
    zoo, zoo_symmap = load_model(zoo_bundle, port.denoiser.dtype)
    zoo = zoo.to(run.device).eval()
    train_ds, _ = create_datasets(cfg)
    same_symmap = zoo_symmap == train_ds.phone_symmap
    if not same_symmap:
        raise RuntimeError(f"{zoo_bundle}'s phone symmap is not this corpus's")
    meta = json.loads((Path(zoo_bundle) / "model.json").read_text())
    _, _, val_dl = create_train_val_dataloader(cfg, make_bucket(cfg, port))
    batches = [batch_to_device(b, run.device) for b in val_dl]
    out = {"val_utterances": sum(int(b["text"].shape[0]) for b in batches),
           "zoo": {"bundle": str(zoo_bundle), "step": meta.get("step"),
                   "weights": meta.get("weights"), **estimate(zoo, batches, run.device)},
           "port": {"step": port_step, "weights": "ema", **estimate(port, batches, run.device)},
           "same_phone_symmap": same_symmap}
    gap = abs(out["zoo"]["all_t"] - out["port"]["all_t"])
    out["all_t_gap"] = gap
    out["within_spread"] = gap <= max(out["zoo"]["std"], out["port"]["std"])
    run.log(f"zoo estimator: {json.dumps(out)}")
    return out


def requests(run: Run, argv: list[str] | None = None) -> list[tuple]:
    """(text, reference wav, seed) per val utterance of the run ``argv``
    (default: the D3PM's); the reference is the speaker's first training
    utterance."""
    from .config import Config
    from .data.dataset import create_datasets

    train_ds, val_ds = create_datasets(Config.from_cli(argv or run.d3pm))
    first = {}
    for p in sorted(Path(p) for p in train_ds.paths):
        first.setdefault(p.parent.name, p)
    out = []
    for i, p in enumerate(Path(p) for p in val_ds.paths):
        stem = p.name.split(".")[0]
        ref = first[p.parent.name]
        out.append(((p.parent / f"{stem}.normalized.txt").read_text(),
                    ref.parent / (ref.name.split(".")[0] + ".wav"), 1000 + i))
    return out


@torch.no_grad()
def serve(run: Run, zoo: Path) -> None:
    """The val utterances through MaskGIT and the ancestral chain at stride
    3, bf16 and fp32; p50s, code agreement and the first call's logits."""
    from .models.diffusion import maskgit_schedule
    from .serve import Synthesizer

    reqs = requests(run)
    run.report["served_requests"] = len(reqs)
    batch = min(BATCH, len(reqs))
    codes, first_logits, p50 = {}, {}, {}
    for prec in ("bf16", "fp32"):
        base = Synthesizer.from_bundles(zoo / "diffusion", zoo / "nar", run.codec,
                                        device=run.device, max_batch=batch, bf16=prec == "bf16")
        prepared = [base.prepare(t, r) for t, r, _ in reqs]
        for decode, stride in (("maskgit", 1), ("ancestral", 3)):
            synth = Synthesizer(base.first, base.nar, base.codec, base.phone_symmap,
                                device=run.device, max_batch=batch, decode=decode,
                                stride=stride, bf16=prec == "bf16")
            out, times = [], []
            for b in range(0, len(reqs), batch):
                run.sync()
                t0 = time.perf_counter()
                c, wavs = synth._device_batch(prepared[b:b + batch],
                                              [s for _, _, s in reqs[b:b + batch]])
                run.sync()
                times.append(time.perf_counter() - t0)
                if not all(np.isfinite(w).all() for w in wavs):
                    raise RuntimeError(f"{decode} {prec}: non-finite samples")
                out.extend(c)
            key = f"{decode}{f' stride {stride}' if decode == 'ancestral' else ''} {prec}"
            codes[key] = np.stack(out)
            p50[key] = float(np.median(times[1:] or times)) * 1e3
            run.log(f"{key}: p50 {p50[key]:.1f} ms per batch of {batch} ({len(times)} batches)")
        first_logits[prec] = first_call_logits(base, prepared[:batch],
                                               maskgit_schedule(base.first.d3pm,
                                                                base.gen_len, 12)[0][0])
    run.report["serve_p50_ms"] = p50
    run.report["bf16_vs_fp32"] = {
        what: {"level0_identical": float((codes[f"{what} bf16"][..., 0]
                                          == codes[f"{what} fp32"][..., 0]).mean()),
               "all_levels_identical": float((codes[f"{what} bf16"]
                                              == codes[f"{what} fp32"]).mean())}
        for what in ("maskgit", "ancestral stride 3")}
    b, f = first_logits["bf16"], first_logits["fp32"]
    run.report["first_call_logits"] = {"max_abs_diff": float(np.abs(b - f).max()),
                                       "max_abs_fp32": float(np.abs(f).max()),
                                       "argmax_agree": float((b.argmax(-1) == f.argmax(-1)).mean())}
    np.savez_compressed(run.work / "codes.npz",
                        **{k.replace(" ", "_"): v for k, v in codes.items()})


def first_call_logits(synth, rows: list[dict], t: int) -> np.ndarray:
    """The denoiser's logits at its first MaskGIT call (all absorbed, step
    ``t``) on ``rows``, over the gen_len valid slots, as fp32 numpy."""
    dev = synth.device
    pb = synth.prompt_bucket(rows)

    def stack(key):
        return torch.as_tensor(np.concatenate([r[key] for r in rows]), device=dev)

    text, tm = stack("text"), stack("text_mask")
    proms, pm = stack("proms")[:, :pb], stack("prom_mask")[:, :pb].contiguous()
    den, gl, B = synth.first.denoiser, synth.gen_len, len(rows)
    rm = (torch.arange(synth.resp_bucket, device=dev)[None] < gl).float().expand(B, -1)
    x = torch.where(rm > 0, synth.first.d3pm.absorbing_state, 0).long()
    tt = torch.full((B,), t, dtype=torch.long, device=dev)
    tc, sc = den.conds(text, tm, proms, pm)
    logits = den.denoise_with_kv(x, rm.contiguous(), tt, den.cond_kv(tc, sc), tm, pm)
    return logits[:, :gl].float().cpu().numpy()


def _batches(synth, reqs, prepared):
    """(prepared rows, seeds, the batch's device tensors) per batch of
    ``synth.max_batch``."""
    from .smoke_ar import batch_tensors

    n = synth.max_batch
    return [(prepared[b:b + n], [s for _, _, s in reqs[b:b + n]],
             batch_tensors(synth, prepared[b:b + n])) for b in range(0, len(reqs), n)]


def _timed(run: Run, fn):
    run.sync()
    t0 = time.perf_counter()
    out = fn()
    run.sync()
    return out, time.perf_counter() - t0


@torch.no_grad()
def serve_ar(run: Run, zoo: Path, serve_steps: int, spec_steps: int) -> dict:
    """The val utterances through the AR first stage (bf16, the serving
    precision): time to wav at temperature 1.0, then greedy plain against
    greedy speculative with the quarter draft at each of ``SPEC_KS``."""
    from .convert import cast_params_bf16
    from .models.ar import ar_generate, ar_generate_speculative
    from .serve import Synthesizer, check_draft, load_model
    from .smoke_ar import first_divergence, spec_stats, top2_margin
    from .utils.rng import RowKeys

    reqs = requests(run, run.ar)
    synth = Synthesizer.from_bundles(zoo / "ar", zoo / "nar", run.codec, device=run.device,
                                     max_batch=min(BATCH, len(reqs)), max_ar_steps=serve_steps,
                                     temperature=1.0)
    target = synth.first
    draft = load_model(zoo / "ar-quarter")[0]
    check_draft(target, draft)
    draft = cast_params_bf16(draft.to(synth.device).eval())
    prepared = [synth.prepare(t, r) for t, r, _ in reqs]
    batches = _batches(synth, reqs, prepared)
    times, lengths = [], []
    for rows, seeds, _ in batches:
        (codes, wavs), secs = _timed(run, lambda: synth._device_batch(rows, seeds))
        if not all(np.isfinite(w).all() for w in wavs):
            raise RuntimeError("AR serving: non-finite samples")
        times.append(secs)
        lengths += [len(c) for c in codes]
    out = {"served_requests": len(reqs), "batch": synth.max_batch, "max_ar_steps": serve_steps,
           "serve_p50_ms": float(np.median(times[1:] or times)) * 1e3,
           "serve_tok_s": sum(lengths) / sum(times), "lengths": lengths,
           "lengths_p10_p50_p90": [float(np.percentile(lengths, q)) for q in (10, 50, 90)],
           "stopped_share": float(np.mean([n < serve_steps for n in lengths]))}
    run.log(f"AR serving: p50 {out['serve_p50_ms']:.1f} ms per batch of {synth.max_batch}, "
            f"lengths p10/p50/p90 {out['lengths_p10_p50_p90']}")

    def greedy(fn):
        toks, times, lens, stats = [], [], [], []
        for rows, seeds, batch in batches:
            res, secs = _timed(run, lambda: fn(batch, RowKeys.from_seeds(seeds).fold(0)))
            toks.append(res[0])
            lens.append(res[1])
            stats.append(res[2] if len(res) > 2 else None)
            times.append(secs)
        n = int(sum(int(x.sum()) for x in lens))
        return toks, lens, stats, {"p50_ms": float(np.median(times[1:] or times)) * 1e3,
                                   "tok_s": n / sum(times)}

    plain_toks, plain_lens, _, plain = greedy(lambda batch, keys: ar_generate(
        target, *batch, keys, max_steps=spec_steps, sampling_temperature=0.0))
    out["greedy"] = {"max_steps": spec_steps, "plain_p50_ms": plain["p50_ms"],
                     "plain_tok_s": plain["tok_s"], "k": {}}
    for k in SPEC_KS:
        toks, lens, stats, timing = greedy(lambda batch, keys, k=k: ar_generate_speculative(
            target, draft, *batch, keys, max_steps=spec_steps, k=k, with_stats=True))
        per_batch = [spec_stats(st, k) for st in stats]
        entry = {**timing, "speedup": plain["p50_ms"] / timing["p50_ms"],
                 "rounds": sum(st["rounds"] for st in per_batch),
                 **{key: float(np.mean([st[key] for st in per_batch]))
                    for key in ("accepted_per_round", "acceptance_rate")},
                 "identical": True, "first_divergence": None,
                 "first_divergence_request": None, "tie_margin": None}
        for bi, (_, _, batch) in enumerate(batches):
            div = first_divergence(plain_toks[bi], plain_lens[bi], toks[bi], lens[bi])
            if div is not None:
                entry.update(identical=False, first_divergence=div[1],
                             first_divergence_request=bi * synth.max_batch + div[0],
                             tie_margin=top2_margin(target, batch, plain_toks[bi], *div))
                break
        out["greedy"]["k"][k] = entry
        run.log(f"speculative k={k}: {json.dumps(entry)}")
    return out


def prepare_data(run: Run, device: str, tiny: bool) -> None:
    """The corpus, its phones and its codes, unless an earlier run left the
    codes in the workdir."""
    if any(run.data.rglob("*.qnt.npy")):
        run.log(f"reusing the corpus and codes under {run.data}")
        return
    if not any(run.data.glob("spk*")):
        run.step("corpus", "scripts/make_gen_corpus.py", str(run.data),
                 *(["--speakers", "2", "--utts", "11"] if tiny else []))
    run.step("g2p", "-m", f"{PKG}.emb.g2p", str(run.data))
    codec_env = {"ENCODEC_WEIGHTS": str(run.codec)} if run.codec else {}
    run.step("qnt", "-m", f"{PKG}.emb.qnt", str(run.data), "--device", device, env=codec_env)


def run_ar(run: Run, device: str, tiny: bool) -> dict:
    """The AR chain (module docstring)."""
    prepare_data(run, device, tiny)
    zoo = run.work / "zoo"
    if (zoo / "nar" / "model.json").exists():
        run.log(f"reusing the NAR bundle {zoo / 'nar'}")
    else:
        run.report["nar"] = parse_train_log(run.step("train_nar", "-m", f"{PKG}.train", *run.nar))
        nar_step = max(s for s, _ in run.report["nar"]["val"])
        run.step("export_nar", "-m", f"{PKG}.export", str(zoo / "nar"), *run.nar,
                 f"restore_step={nar_step}", "--ema")
    exported = {}
    for name, argv in (("ar", run.ar), ("ar-quarter", run.ar_quarter)):
        run.report[name] = log = parse_train_log(run.step(f"train_{name}", "-m", f"{PKG}.train",
                                                          *argv))
        run.save("report_ar.json")
        step = max(s for s, _ in log["val"])
        run.step(f"export_{name}", "-m", f"{PKG}.export", str(zoo / name), *argv,
                 f"restore_step={step}", "--ema")
        exported[name] = {"step": step, "val_loss": dict(log["val"])[step]}
    run.report["exported"] = exported
    run.report["ar_serve"] = serve_ar(run, zoo, 24 if tiny else AR_SERVE_STEPS,
                                      16 if tiny else SPEC_STEPS)
    run.save("report_ar.json")
    return run.report


def main(argv: list[str] | None = None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("workdir", type=Path)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--codec", type=Path, default=None,
                        help="converted EnCodec weights (default: as emb.qnt finds them)")
    parser.add_argument("--tiny", action="store_true",
                        help="2 speakers, 4 steps, d32 models: a CPU rehearsal")
    parser.add_argument("--zoo-estimator", type=Path, default=None, metavar="BUNDLE",
                        help="train the D3PM recipe only, then hold its last step's EMA "
                             "against this D3PM bundle (zoo/diffusion) on the same val split "
                             "with the 16-seed and all-t estimators; writes report_zoo.json")
    parser.add_argument("--ar", action="store_true",
                        help="the AR chain (train ar and ar-quarter, export, serve, "
                             "speculative decoding), reusing the workdir's corpus, codes and "
                             "NAR bundle")
    args = parser.parse_args(argv)
    from .codec.encodec import find_weights
    from .utils.device import resolve_device

    resolve_device(args.device)
    run = Run(args.workdir, args.device, find_weights(args.codec), args.tiny)
    run.work.mkdir(parents=True, exist_ok=True)
    run.log(f"{run.report['device']}; codec weights {run.codec}")
    if args.zoo_estimator is not None:
        prepare_data(run, args.device, args.tiny)
        run.report["d3pm"] = parse_train_log(run.step("train_d3pm", "-m", f"{PKG}.train",
                                                      *run.d3pm))
        last = max(s for s, _ in run.report["d3pm"]["val"])
        run.report["zoo_estimator"] = zoo_estimate(run, args.zoo_estimator, last)
        run.save("report_zoo.json")
        print(json.dumps(run.report["zoo_estimator"], default=str))
        return run.report
    if args.ar:
        report = run_ar(run, args.device, args.tiny)
        print(json.dumps(report["ar_serve"] | {"exported": report["exported"]}, default=str))
        return report
    prepare_data(run, args.device, args.tiny)
    run.report["d3pm"] = parse_train_log(run.step("train_d3pm", "-m", f"{PKG}.train", *run.d3pm))
    run.save()
    run.report["nar"] = parse_train_log(run.step("train_nar", "-m", f"{PKG}.train", *run.nar))
    run.save()
    run.report["d3pm_val_spread"] = val_spread(run, [s for s, _ in run.report["d3pm"]["val"]])
    best_step, best_loss = min(run.report["d3pm"]["val"], key=lambda sv: sv[1])
    nar_step = max(s for s, _ in run.report["nar"]["val"])
    run.report["exported"] = {"d3pm": {"step": best_step, "val_loss": best_loss},
                              "nar": {"step": nar_step}}
    zoo = run.work / "zoo"
    run.step("export_d3pm", "-m", f"{PKG}.export", str(zoo / "diffusion"), *run.d3pm,
             f"restore_step={best_step}", "--ema")
    run.step("export_nar", "-m", f"{PKG}.export", str(zoo / "nar"), *run.nar,
             f"restore_step={nar_step}", "--ema")
    serve(run, zoo)
    run.save()
    summary = {k: v for k, v in run.report.items() if k not in ("d3pm", "nar")}
    summary["d3pm_val"], summary["nar_val"] = run.report["d3pm"]["val"], run.report["nar"]["val"]
    print(json.dumps(summary, default=str))
    return run.report


if __name__ == "__main__":
    main()
