"""Speaker-prompt transfer: does the prompt steer the voice?  (Counterpart
of ``scripts/speaker_transfer_eval.py`` in the JAX repository.)

1. Per-speaker voiceprints: level-0 code unigram distributions over the
   TRAIN split (the trainer's own 95/5 seed-0 split, ``create_datasets``).
2. Each trial takes the text of a HELD-OUT (val) utterance and synthesizes
   it twice with the same seed: prompted with speaker A's training audio,
   then with speaker B's (A ≠ B drawn per trial).
3. Each generation is attributed to the nearer of the {A, B} voiceprints (L1
   on unigram histograms): transfer accuracy is the share attributed to the
   prompted speaker, the margin distance(other) − distance(prompted); the
   attribution over every speaker is reported beside it.

A prompt-deaf model scores ~0.5; a speaker-cloning one near 1.0.

    python -m tts_with_diffusion_model_tpu_torch.scripts.speaker_transfer_eval \\
        BUNDLE_DIR --out OUT.json yaml=CFG.yml [--trials 32] [--frames 160] \\
        [--resp-bucket 256] [--nar-bundle NAR_DIR] [--device cuda]

The yaml must be the training config (its data and split recreate the
partition the model saw).  With ``--nar-bundle`` the attribution is made on
the full served stack: first-stage level 0 → the NAR's levels 1-7 → codec
decode → the wav re-encoded, and its level-0 codes attributed.  Without it,
the first stage's codes are scored directly.  The first stage is the
diffusion model's ancestral chain; a generation's noise comes from
``RowKeys`` of seed ``seed·7 + trial`` (the NAR's from that folded with 1).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch


def code_hist(codes: np.ndarray, bins: int = 1024) -> np.ndarray:
    h = np.bincount(np.asarray(codes, np.int64).ravel(), minlength=bins)
    h = h.astype(np.float64)
    return h / max(h.sum(), 1.0)


@dataclasses.dataclass
class Generation:
    """One generation's inputs: the prompted speaker, the text and prompt
    arrays (batch of 1), and its seed."""
    speaker: str
    text: np.ndarray       # (1, text_len) int32
    text_mask: np.ndarray  # (1, text_len) float32
    proms: np.ndarray      # (1, prom_len, 8) int32
    prom_mask: np.ndarray  # (1, prom_len) float32
    seed: int


@dataclasses.dataclass
class Selection:
    speakers: list[str]
    voiceprint: dict       # speaker → level-0 unigram histogram
    trials: list[dict]     # {"val_path", "prompted": [a, b]}
    generations: list[Generation]  # two per trial: a, then b


def parse_args(argv=None):
    from ..config import Config
    from ..utils.config_base import _is_cfg_argv

    cfg = Config.from_cli(argv)
    ap = argparse.ArgumentParser(description="Speaker-prompt transfer evaluation.")
    ap.add_argument("bundle", type=Path)
    ap.add_argument("--out", type=Path, default=Path("transfer_eval.json"))
    ap.add_argument("--trials", type=int, default=32)
    ap.add_argument("--frames", type=int, default=160,
                    help="classify over the first N generated frames")
    ap.add_argument("--resp-bucket", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--nar-bundle", type=Path, default=None,
                    help="score the full first-stage→NAR→wav→re-encode chain instead of "
                         "first-stage codes")
    ap.add_argument("--nar-temperature", type=float, default=0.2)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(None if argv is None else [a for a in argv if not _is_cfg_argv(a)])
    return cfg, args


def select(cfg, phone_symmap: dict, trials: int, seed: int, text_len: int,
           prom_len: int) -> Selection:
    """Voiceprints from the train split, then each trial's speakers, val
    text and the two prompts, from ``default_rng(seed·100003 + trial)``."""
    from ..data.dataset import create_datasets, get_phones, load_quants
    from ..text.symmap import phones_to_ids

    train_ds, val_ds = create_datasets(cfg)
    get_spkr = train_ds.get_spkr
    train_by_spkr = defaultdict(list)
    for p in train_ds.paths:
        train_by_spkr[get_spkr(p)].append(p)
    voiceprint, train_codes = {}, {}
    for s, paths in sorted(train_by_spkr.items()):
        codes = [load_quants(p) for p in paths]  # (t, 8) each
        train_codes[s] = codes
        voiceprint[s] = code_hist(np.concatenate([q[:, 0] for q in codes]))
    speakers = sorted(voiceprint)
    if len(speakers) < 2:
        raise SystemExit("need >= 2 speakers for transfer trials")
    val_paths = list(val_ds.paths)
    if not val_paths:
        raise SystemExit("empty val split")

    def make_prompt(s: str, trial_rng):
        """Up to 3 training utterances of speaker s, concatenated."""
        pool = train_codes[s]
        take = trial_rng.choice(len(pool), size=min(3, len(pool)), replace=False)
        q = np.concatenate([pool[i] for i in take], axis=0)[:prom_len]
        proms = np.zeros((prom_len, 8), np.int32)
        proms[: q.shape[0]] = q
        pm = np.zeros((prom_len,), np.float32)
        pm[: q.shape[0]] = 1.0
        return proms, pm

    rows, gens = [], []
    for trial in range(trials):
        trng = np.random.default_rng(seed * 100_003 + trial)
        a, b = trng.choice(len(speakers), size=2, replace=False)
        spk_a, spk_b = speakers[a], speakers[b]
        vp = val_paths[trng.integers(len(val_paths))]
        ids = phones_to_ids(list(get_phones(vp)), phone_symmap, strict=False)[:text_len]
        text = np.zeros((1, text_len), np.int32)
        text[0, : len(ids)] = ids
        tm = np.zeros((1, text_len), np.float32)
        tm[0, : len(ids)] = 1.0
        rows.append({"val_path": str(vp), "prompted": [spk_a, spk_b]})
        for spk in (spk_a, spk_b):
            proms, pm = make_prompt(spk, trng)
            gens.append(Generation(spk, text, tm, proms[None], pm[None], seed * 7 + trial))
    return Selection(speakers, voiceprint, rows, gens)


@torch.no_grad()
def generate(first, g: Generation, *, resp_bucket: int, gl: int, nar=None, codec=None,
             nar_temperature: float = 0.2) -> np.ndarray:
    """One generation's scored codes: the first stage's level 0 (ancestral,
    ``gl`` frames in the ``resp_bucket`` window), or with ``nar`` the NAR's
    8 levels over the whole window, decoded and re-encoded by ``codec``:
    the re-encode's level 0."""
    from ..models.nar import nar_generate
    from ..utils.rng import RowKeys

    dev = next(first.parameters()).device
    text, tm, pr, pm = (torch.as_tensor(a, device=dev) for a in (
        g.text.astype(np.int64), g.text_mask, g.proms.astype(np.int64), g.prom_mask))
    keys = RowKeys.from_seeds([g.seed])
    out = first.generate(text, tm, pr, pm, keys, gen_len=gl, resp_bucket=resp_bucket)
    if nar is None:
        return out[0].cpu().numpy()
    rm = torch.ones((1, resp_bucket), dtype=torch.float32, device=dev)
    resps = nar_generate(nar, text, tm, pr, pm, out[:, :resp_bucket], rm, keys.fold(1),
                         sampling_temperature=nar_temperature)
    codes8 = resps[0][:gl].cpu().numpy()  # (gl, 8)
    wavs, sr = codec.decode(np.moveaxis(codes8[None], 1, 2))
    return np.asarray(codec.encode(np.asarray(wavs[0]).reshape(-1), sr)[0])


def score(sel: Selection, codes: list[np.ndarray], frames: int) -> list[dict]:
    """Each trial's row: per generation (a, b) the prompted speaker, whether
    the 2-way attribution is right, the margin and the nearest speaker."""
    results = []
    for i, row in enumerate(sel.trials):
        row = dict(row)
        spk_a, spk_b = row["prompted"]
        for j, tag in enumerate(("a", "b")):
            spk = sel.generations[2 * i + j].speaker
            h = code_hist(codes[2 * i + j][:frames])
            d_a = float(np.abs(h - sel.voiceprint[spk_a]).sum())
            d_b = float(np.abs(h - sel.voiceprint[spk_b]).sum())
            d_all = {s: float(np.abs(h - sel.voiceprint[s]).sum()) for s in sel.speakers}
            prompted_d = d_a if spk == spk_a else d_b
            other_d = d_b if spk == spk_a else d_a
            row[tag] = {"speaker": spk, "correct_2way": prompted_d < other_d,
                        "margin": other_d - prompted_d,
                        "pred_32way": min(d_all, key=d_all.get)}
        results.append(row)
    return results


def summarize(args, sel: Selection, results: list[dict]) -> dict:
    fullstack = args.nar_bundle is not None
    gens = [row[t] for row in results for t in ("a", "b")]
    return {
        "n_trials": args.trials,
        "n_generations": len(gens),
        "transfer_accuracy_2way": float(np.mean([g["correct_2way"] for g in gens])),
        "mean_margin": float(np.mean([g["margin"] for g in gens])),
        "attribution_accuracy_full": float(np.mean([g["pred_32way"] == g["speaker"]
                                                    for g in gens])),
        "n_speakers": len(sel.speakers),
        "chance_2way": 0.5,
        "chance_full": 1.0 / len(sel.speakers),
        "bundle": str(args.bundle),
        "frames_scored": args.frames,
        "stack": "fullstack:first+nar+wav+reencode" if fullstack else "first_stage_codes",
        "nar_bundle": str(args.nar_bundle) if fullstack else None,
    }


def main(argv: list[str] | None = None) -> dict:
    from ..codec import encodec
    from ..serve import load_model
    from ..utils.device import resolve_device

    cfg, args = parse_args(argv)
    device = resolve_device(args.device)
    first, phone_symmap = load_model(args.bundle)
    first = first.to(device).eval()
    c = first.config
    sel = select(cfg, phone_symmap, args.trials, args.seed, c.text_len, c.prom_len)
    # the generation must fit the tightened bucket (generate raises on
    # resp_bucket < gen_len)
    gl = min(args.resp_bucket, c.gen_len)
    nar = codec = None
    if args.nar_bundle is not None:
        nar = load_model(args.nar_bundle)[0].to(device).eval()
        codec = encodec.load_codec(encodec.find_weights(), device=device)
    codes = [generate(first, g, resp_bucket=args.resp_bucket, gl=gl, nar=nar, codec=codec,
                      nar_temperature=args.nar_temperature) for g in sel.generations]
    results = score(sel, codes, args.frames)
    summary = summarize(args, sel, results)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps({"summary": summary, "trials": results}, indent=1))
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
