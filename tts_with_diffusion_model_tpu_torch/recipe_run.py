"""The whole chain users run, on the port, with what it measures:

    python -m tts_with_diffusion_model_tpu_torch.recipe_run <workdir> \\
        [--device cuda] [--codec weights.npz] [--tiny]

1. ``scripts/make_gen_corpus.py`` writes the mini corpus (32 speakers × 24
   utterances) under ``<workdir>/data/train``;
2. ``emb.g2p`` and ``emb.qnt`` write its phones and codes;
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

Writes ``<workdir>/report.json`` (and each step's log beside it) and prints
a summary.  ``--tiny`` runs the same chain at a tiny size (2 speakers × 11
utterances, 4 steps, d32 models), for a rehearsal on the CPU.
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
SEEDS = 16


class Run:
    """The chain's state: where it writes, the device and the report."""

    def __init__(self, workdir: Path, device: str, codec: Path | None, tiny: bool):
        self.work, self.device, self.codec = Path(workdir), device, codec
        self.data = self.work / "data" / "train"
        self.t0 = time.perf_counter()
        self.report: dict = {"device": device_name(device), "seconds": {}}
        outputs = [f"data_dirs=[{self.data}]", f"log_root={self.work / 'logs'}",
                   f"ckpt_root={self.work / 'ckpts'}", f"device={device}"]
        self.d3pm = ["yaml=config/gen4c/diffusion.yml", *outputs, *(TINY_D3PM if tiny else [])]
        self.nar = ["yaml=config/gen4c/nar.yml", *outputs, *(TINY_NAR if tiny else [])]

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

    def save(self):
        self.report["wall_s"] = time.perf_counter() - self.t0
        (self.work / "report.json").write_text(json.dumps(self.report, indent=1))


def device_name(device: str) -> str:
    """The card's ``nvidia-smi`` name and power limit, or "cpu"."""
    if torch.device(device).type != "cuda":
        return "cpu"
    from .smoke import nvidia_smi_line

    return nvidia_smi_line()


def parse_train_log(text: str) -> dict:
    """The train CLI's output → step-time percentiles (its stats'
    ``elapsed_time``), the loss every 100 steps and the Eval lines."""
    steps = [json.loads(ln[ln.index("{"):]) for ln in text.splitlines()
             if " - {" in ln and '"elapsed_time"' in ln]
    evals = re.findall(r"'loss': ([0-9.eE+-]+), 'global_step': (\d+), 'name': '(\w+)'", text)
    times = np.array([s["elapsed_time"] for s in steps[1:]]) * 1e3
    return {"steps": len(steps), "first_step_ms": steps[0]["elapsed_time"] * 1e3,
            "step_ms_p10_p50_p90": [float(np.percentile(times, q)) for q in (10, 50, 90)],
            "step_s_sum": float(times.sum() / 1e3),
            "loss_every_100": [(s["global_step"], s["model.loss"]) for s in steps
                               if s["global_step"] % 100 == 0],
            "val": [(int(s), float(v)) for v, s, n in evals if n == "val"],
            "subtrain": [(int(s), float(v)) for v, s, n in evals if n == "subtrain"]}


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

        def mean_loss(seed: int) -> float:
            g = torch.Generator(device=run.device).manual_seed(seed)
            return float(np.mean([float(model.loss(b, g)[0]) for b in batches]))

        out[step] = {}
        for weights in ("raw", "ema"):
            if weights == "ema":
                for p, e in zip(engine.params, engine.ema):
                    p.copy_(e)
            losses = [mean_loss(s) for s in range(SEEDS)]
            sampled = model.config
            model.config = dataclasses.replace(sampled, train_mode="all_t")
            all_t = mean_loss(0)
            model.config = sampled
            out[step][weights] = {"mean": float(np.mean(losses)), "std": float(np.std(losses)),
                                  "min": min(losses), "max": max(losses), "all_t": all_t}
        run.log(f"val spread at step {step}: {json.dumps(out[step])}")
        del engine, model, batches
    return out


def requests(run: Run) -> list[tuple]:
    """(text, reference wav, seed) per val utterance; the reference is the
    speaker's first training utterance."""
    from .config import Config
    from .data.dataset import create_datasets

    train_ds, val_ds = create_datasets(Config.from_cli(run.d3pm))
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


def main(argv: list[str] | None = None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("workdir", type=Path)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--codec", type=Path, default=None,
                        help="converted EnCodec weights (default: as emb.qnt finds them)")
    parser.add_argument("--tiny", action="store_true",
                        help="2 speakers, 4 steps, d32 models: a CPU rehearsal")
    args = parser.parse_args(argv)
    from .codec.encodec import find_weights
    from .utils.device import resolve_device

    resolve_device(args.device)
    run = Run(args.workdir, args.device, find_weights(args.codec), args.tiny)
    run.work.mkdir(parents=True, exist_ok=True)
    run.log(f"{run.report['device']}; codec weights {run.codec}")
    if not any(run.data.glob("spk*")):
        run.step("corpus", "scripts/make_gen_corpus.py", str(run.data),
                 *(["--speakers", "2", "--utts", "11"] if args.tiny else []))
    run.step("g2p", "-m", f"{PKG}.emb.g2p", str(run.data))
    codec_env = {"ENCODEC_WEIGHTS": str(run.codec)} if run.codec else {}
    run.step("qnt", "-m", f"{PKG}.emb.qnt", str(run.data), "--device", args.device,
             env=codec_env)
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
