"""Quality gate: a diffusion bundle, asked for a training utterance's text
with a prompt of that speaker, must reproduce the utterance's level-0 codec
tokens (counterpart of ``scripts/quality_gate.py`` in the JAX repository;
≡ the reference's one-sample overfit convention,
``vall_e/vall_e/nar.py:149-165``).  Exits non-zero below
``--min-acc`` (default 0.7).

    python -m tts_with_diffusion_model_tpu_torch.scripts.quality_gate <bundle-dir> \\
        <train.wav> '<text>' [--prompt-wav <other.wav>] [--min-acc 0.7] [--seed 0] \\
        [--decode ancestral|maskgit] [--nar-bundle NAR] [--max-mcd DB] [--device cuda]

``--prompt-wav`` (default: the target wav) should follow the training
convention, where prompts are *other* utterances of the speaker
(the reference's ``vall_e/data.py:136-155``).  With ``--nar-bundle`` the gate
runs the full stack: the NAR fills levels 1-7, the stack is decoded, and the
per-level token accuracy and DTW-MCD against the ground truth's codec
round-trip (``mcd``; ``mcd_vs_raw`` against the recording) are reported;
``--max-mcd`` then gates on ``mcd`` too.  The report is the first line of
standard output.  The first stage draws from ``RowKeys`` of ``--seed`` (the
NAR from ``--seed`` + 1).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import torch


@dataclasses.dataclass
class Selection:
    codes: np.ndarray      # the target's codes (8, T)
    text: np.ndarray       # (1, text_len) int32
    text_mask: np.ndarray
    proms: np.ndarray      # (1, prom_len, 8) int32
    prom_mask: np.ndarray
    n_cmp: int             # frames generated and compared


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="Level-0 token accuracy gate on a training "
                                             "utterance.")
    ap.add_argument("bundle", type=Path)
    ap.add_argument("wav", type=Path)
    ap.add_argument("text")
    ap.add_argument("--prompt-wav", type=Path, default=None)
    ap.add_argument("--min-acc", type=float, default=0.7)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--decode", choices=("ancestral", "maskgit"), default="ancestral",
                    help="first-stage sampler (maskgit = confidence-ordered parallel decoding)")
    ap.add_argument("--maskgit-steps", type=int, default=12)
    ap.add_argument("--nar-bundle", type=Path, default=None,
                    help="trained NAR bundle: extend the gate through all 8 RVQ levels, decode "
                         "the stack to a wav and report per-level token accuracy and DTW-MCD")
    ap.add_argument("--max-mcd", type=float, default=None,
                    help="with --nar-bundle: fail the gate if the codec-controlled DTW-MCD (dB; "
                         "hyp vs the ground-truth codes' round-trip) exceeds this")
    ap.add_argument("--nar-temperature", type=float, default=0.2)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def select(config, phone_symmap: dict, codec, wav: Path, text: str,
           prompt_wav: Path | None) -> Selection:
    """The target's codes, the text's phone ids and the prompt's codes
    (the prompt wav's, else the target's), padded to the model's buckets."""
    from ..emb import qnt
    from ..text import g2p
    from ..text.symmap import phones_to_ids

    codes = qnt.encode_from_file(wav, codec)  # (8, T)
    prom_codes = qnt.encode_from_file(prompt_wav, codec) if prompt_wav else codes
    proms = np.asarray(prom_codes).T  # (T, 8)
    phn_ids = phones_to_ids(g2p.encode(text), phone_symmap, strict=False)
    c = config
    t = np.zeros((1, c.text_len), np.int32)
    tm = np.zeros((1, c.text_len), np.float32)
    n = min(len(phn_ids), c.text_len)
    t[0, :n] = phn_ids[:n]
    tm[0, :n] = 1
    pr = np.zeros((1, c.prom_len, 8), np.int32)
    pm = np.zeros((1, c.prom_len), np.float32)
    np_ = min(len(proms), c.prom_len)
    pr[0, :np_] = proms[:np_]
    pm[0, :np_] = 1
    return Selection(np.asarray(codes), t, tm, pr, pm, min(codes.shape[1], c.gen_len))


@torch.no_grad()
def generate(first, sel: Selection, *, decode: str = "ancestral", maskgit_steps: int = 12,
             seed: int = 0, nar=None, nar_temperature: float = 0.2):
    """→ (level 0 (n_cmp,), the NAR's (n_cmp, 8) codes or None)."""
    from ..models.nar import nar_generate
    from ..utils.rng import RowKeys

    dev = next(first.parameters()).device
    text, tm, pr, pm = (torch.as_tensor(a, device=dev) for a in (
        sel.text.astype(np.int64), sel.text_mask, sel.proms.astype(np.int64), sel.prom_mask))
    n = sel.n_cmp
    if decode == "maskgit":
        out = first.generate_maskgit(text, tm, pr, pm, RowKeys.from_seeds([seed]), gen_len=n,
                                     steps=maskgit_steps)
    else:
        out = first.generate(text, tm, pr, pm, RowKeys.from_seeds([seed]), gen_len=n)
    if nar is None:
        return out[0, :n].cpu().numpy(), None
    rm = torch.ones((1, n), dtype=torch.float32, device=dev)
    resps = nar_generate(nar, text, tm, pr, pm, out[:, :n], rm, RowKeys.from_seeds([seed + 1]),
                         sampling_temperature=nar_temperature)
    return out[0, :n].cpu().numpy(), resps[0].cpu().numpy()


def score(sel: Selection, hyp: np.ndarray, min_acc: float, decode: str) -> dict:
    """The level-0 report."""
    n = sel.n_cmp
    acc = float((hyp == sel.codes[0, :n]).mean())
    return {"tokens_compared": int(n), "level0_token_accuracy": round(acc, 4),
            "min_acc": min_acc, "decode": decode, "ok": acc >= min_acc}


def score_full_stack(sel: Selection, hyp_codes: np.ndarray, wav: Path, codec) -> dict:
    """Per-level accuracy and DTW-MCD of the NAR's stack against the target:
    ``mcd`` against the round-trip of the target's codes,
    ``mcd_vs_raw`` against the recording, ``codec_floor_mcd`` between the
    two."""
    from ..audio.wavio import read_wav
    from ..utils.metrics import eval_utterance_metrics, mel_cepstral_distortion

    ref_codes = sel.codes[:, : sel.n_cmp].T  # (n_cmp, 8)
    hyp_wav, sr = codec.decode(hyp_codes.T)
    hyp_wav = np.asarray(hyp_wav).reshape(-1)
    ref_wav, _ = read_wav(wav)
    ref_wav = np.asarray(ref_wav).reshape(-1)
    rt_wav, _ = codec.decode(ref_codes.T)
    rt_wav = np.asarray(rt_wav).reshape(-1)
    m = eval_utterance_metrics(hyp_codes, ref_codes, hyp_wav=hyp_wav, ref_wav=rt_wav, sr=sr)
    m["mcd_vs_raw"] = mel_cepstral_distortion(hyp_wav, ref_wav, sr)["mcd"]
    m["codec_floor_mcd"] = mel_cepstral_distortion(rt_wav, ref_wav, sr)["mcd"]
    return m


def main(argv: list[str] | None = None) -> dict:
    """The CLI: prints the report (the first line of standard output) and
    exits 1 when the gate fails; returns the report when it passes."""
    from ..codec import encodec
    from ..serve import load_model
    from ..utils.device import resolve_device

    args = parse_args(argv)
    device = resolve_device(args.device)
    first, phone_symmap = load_model(args.bundle)
    first = first.to(device).eval()
    codec = encodec.load_codec(encodec.find_weights(), device=device)
    sel = select(first.config, phone_symmap, codec, args.wav, args.text, args.prompt_wav)
    nar = (load_model(args.nar_bundle)[0].to(device).eval() if args.nar_bundle is not None
           else None)
    hyp, hyp_codes = generate(first, sel, decode=args.decode, maskgit_steps=args.maskgit_steps,
                              seed=args.seed, nar=nar, nar_temperature=args.nar_temperature)
    report = score(sel, hyp, args.min_acc, args.decode)
    if hyp_codes is not None:
        m = score_full_stack(sel, hyp_codes, args.wav, codec)
        report["full_stack"] = {k: round(float(v), 4) for k, v in m.items()}
        if args.max_mcd is not None:
            report["max_mcd"] = args.max_mcd
            report["ok"] = bool(report["ok"] and m.get("mcd", float("inf")) <= args.max_mcd)
    print(json.dumps(report), flush=True)
    if not report["ok"]:
        print(f"QUALITY GATE FAILED: {json.dumps(report)}", file=sys.stderr)
        raise SystemExit(1)
    print("quality gate OK")
    return report


if __name__ == "__main__":
    main()
