"""Full-stack held-out evaluation: a trained first stage + a trained NAR →
wav, scored against the recordings of utterances the models never saw
(counterpart of ``scripts/heldout_eval.py`` in the JAX repository).

For N utterances of the val split (the trainer's own 95/5 seed-0 split,
``create_datasets``), the first stage generates level 0 from the text and a
same-speaker prompt (codes of up to 3 *other* utterances of the speaker from
the train split, as in training), the NAR fills levels 1-7, and the 8-level
stack is decoded and scored against the ground truth: per-level token
accuracy, DTW-MCD against the codec round-trip of the ground-truth codes
(``mcd``), against the raw recording (``mcd_vs_raw``) and the codec's own
floor (``codec_floor_mcd``).  The first stage is a diffusion bundle (the
ancestral chain or MaskGIT over a fixed window, scored on each reference's
span) or an AR (``ar_generate``, stop-pruned, scored on its own span with
``len_ratio`` for the pacing).

    python -m tts_with_diffusion_model_tpu_torch.scripts.heldout_eval FIRST_BUNDLE \\
        --nar-bundle NAR_BUNDLE --out OUT.json yaml=TRAIN_CFG.yml [--n 16] \\
        [--resp-bucket 192] [--decode ancestral|maskgit] [--device cuda]

Row i draws from ``RowKeys`` of seed i folded with ``--seed`` (the first
stage) and ``--seed`` + 1 (the NAR).  The codec is found as ``emb.qnt``
finds it.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch


@dataclasses.dataclass
class Selection:
    """The utterances picked and their padded inputs (numpy)."""
    picks: list[Path]
    text: np.ndarray       # (N, text_len) int32
    text_mask: np.ndarray  # (N, text_len) float32
    proms: np.ndarray      # (N, prom_len, 8) int32
    prom_mask: np.ndarray  # (N, prom_len) float32
    refs: list[np.ndarray]  # ground-truth codes, (t, 8) each


def parse_args(argv=None):
    """(config, arguments): ``key=value`` items go to the config."""
    from ..config import Config
    from ..utils.config_base import _is_cfg_argv

    cfg = Config.from_cli(argv)
    ap = argparse.ArgumentParser(description="Full-stack held-out evaluation.")
    ap.add_argument("bundle", type=Path)
    ap.add_argument("--nar-bundle", type=Path, required=True)
    ap.add_argument("--out", type=Path, default=Path("heldout_fullstack.json"))
    ap.add_argument("--n", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--resp-bucket", type=int, default=192)
    ap.add_argument("--decode", choices=("ancestral", "maskgit"), default="ancestral")
    ap.add_argument("--maskgit-steps", type=int, default=12)
    ap.add_argument("--nar-temperature", type=float, default=0.2)
    ap.add_argument("--ar-temperature", type=float, default=1.0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(None if argv is None else [a for a in argv if not _is_cfg_argv(a)])
    return cfg, args


def buckets(cfg, first, is_ar: bool, resp_bucket: int) -> tuple[int, int, int]:
    """(text bucket, prompt bucket, generation length): an AR at the
    training regime's shapes (``max_text_len``, the largest prompt bucket),
    a diffusion model at its config's, generating min(bucket, gen_len)."""
    if is_ar:
        prom_cap = getattr(cfg, "prom_len_buckets", None)
        return (cfg.max_text_len,
                min(cfg.max_prom_len, max(prom_cap) if prom_cap else cfg.max_prom_len),
                resp_bucket)
    c = first.config
    return c.text_len, c.prom_len, min(resp_bucket, c.gen_len)


def select(cfg, phone_symmap: dict, n: int, seed: int, text_len: int, prom_len: int) -> Selection:
    """Up to ``n`` val utterances whose speaker has train-split utterances,
    drawn by ``default_rng(seed)``, with their phone ids and prompts (the
    same generator then draws up to 3 of the speaker's train utterances)."""
    from ..data.dataset import create_datasets, get_phones, load_quants
    from ..text.symmap import phones_to_ids

    train_ds, val_ds = create_datasets(cfg)
    get_spkr = train_ds.get_spkr
    train_by_spkr = defaultdict(list)
    for p in train_ds.paths:
        train_by_spkr[get_spkr(p)].append(p)

    rng = np.random.default_rng(seed)
    vals = [p for p in val_ds.paths if train_by_spkr[get_spkr(p)]]
    if not vals:
        raise SystemExit("no val utterance has same-speaker train prompts")
    picks = [vals[i] for i in rng.choice(len(vals), size=min(n, len(vals)), replace=False)]

    N = len(picks)
    text = np.zeros((N, text_len), np.int32)
    tm = np.zeros((N, text_len), np.float32)
    pr = np.zeros((N, prom_len, 8), np.int32)
    pm = np.zeros((N, prom_len), np.float32)
    refs = []
    for i, p in enumerate(picks):
        ids = phones_to_ids(list(get_phones(p)), phone_symmap, strict=False)[:text_len]
        text[i, : len(ids)] = ids
        tm[i, : len(ids)] = 1.0
        pool = train_by_spkr[get_spkr(p)]
        take = rng.choice(len(pool), size=min(3, len(pool)), replace=False)
        q = np.concatenate([load_quants(pool[j]) for j in take], axis=0)[:prom_len]
        pr[i, : q.shape[0]] = q
        pm[i, : q.shape[0]] = 1.0
        refs.append(np.asarray(load_quants(p)))
    return Selection(picks, text, tm, pr, pm, refs)


@torch.no_grad()
def generate(first, nar, sel: Selection, *, is_ar: bool, bucket: int, gl: int,
             decode: str = "ancestral", maskgit_steps: int = 12, ar_temperature: float = 1.0,
             nar_temperature: float = 0.2, seed: int = 0):
    """One batched first-stage call and the NAR over the selection →
    (codes (N, bucket, 8) int64, each row's generated length or None).  The
    AR's junk past each stop (and the stop id) is zeroed before the NAR."""
    from ..models.ar import ar_generate
    from ..models.nar import nar_generate
    from ..utils.rng import RowKeys

    dev = next(first.parameters()).device
    text, tm, pr, pm = (torch.as_tensor(a, device=dev) for a in (
        sel.text.astype(np.int64), sel.text_mask, sel.proms.astype(np.int64), sel.prom_mask))
    N = len(sel.picks)
    rows = RowKeys.from_seeds(range(N))
    keys, nar_keys = rows.fold(seed), rows.fold(seed + 1)
    gen_lens = None
    if is_ar:
        toks, lens = ar_generate(first, text, tm, pr, pm, keys, max_steps=bucket,
                                 sampling_temperature=ar_temperature)
        gen_lens = np.minimum(lens.cpu().numpy(), bucket).astype(np.int64)
        valid = torch.arange(bucket, device=dev)[None, :] < torch.as_tensor(gen_lens, device=dev)[:, None]
        level0 = torch.where(valid, toks[:, :bucket].clamp(0, first.n_tokens - 1), 0)
        rm = valid.float()
    else:
        if decode == "maskgit":
            level0 = first.generate_maskgit(text, tm, pr, pm, keys, gen_len=gl, resp_bucket=bucket,
                                            steps=maskgit_steps)
        else:
            level0 = first.generate(text, tm, pr, pm, keys, gen_len=gl, resp_bucket=bucket)
        rm = np.zeros((N, bucket), np.float32)
        for i, ref in enumerate(sel.refs):
            rm[i, : min(len(ref), gl)] = 1.0
        rm = torch.as_tensor(rm, device=dev)
    codes = nar_generate(nar, text, tm, pr, pm, level0[:, :bucket], rm, nar_keys,
                         sampling_temperature=nar_temperature)
    return codes.cpu().numpy(), gen_lens


def score(sel: Selection, codes: np.ndarray, gen_lens, gl: int, codec) -> tuple[list, dict]:
    """Per-utterance metrics and their means: each hypothesis and each
    reference's code round-trip decoded in one codec call (rows padded to a
    64-frame multiple, ``train.decode_rows``), scored against each other and
    against the raw recording."""
    from ..audio.wavio import read_wav
    from ..train.train import decode_rows
    from ..utils.metrics import aggregate_metrics, eval_utterance_metrics, mel_cepstral_distortion

    items, rows = [], []  # (path, ref, span, hyp or None)
    for i, (p, ref) in enumerate(zip(sel.picks, sel.refs)):
        span = min(len(ref), gl)
        hspan = int(gen_lens[i]) if gen_lens is not None else span
        if hspan == 0:  # the AR stopped at once: scored as the trainer does
            items.append((p, ref, span, None))
            continue
        hyp = np.asarray(codes[i][:hspan])
        items.append((p, ref, span, hyp))
        rows += [hyp, np.asarray(ref[:span])]
    wavs, sr = decode_rows(rows, codec) if rows else ([], 24_000)
    wav_it = iter(wavs)

    per_utt = []
    for p, ref, span, hyp in items:
        if hyp is None:
            per_utt.append({"len_ratio": 0.0, "acc": 0.0})
            continue
        hyp_wav, rt_wav = next(wav_it), next(wav_it)
        ref_wav, _ = read_wav(p.parent / (p.name.split(".")[0] + ".wav"))
        ref_wav = np.asarray(ref_wav).reshape(-1)
        # ``mcd`` against the codec round-trip of the ground truth isolates
        # the TTS stack; ``mcd_vs_raw`` beside the codec's own floor
        m = eval_utterance_metrics(hyp, ref[:span], hyp_wav=hyp_wav, ref_wav=rt_wav, sr=sr)
        m["mcd_vs_raw"] = mel_cepstral_distortion(hyp_wav, ref_wav, sr)["mcd"]
        m["codec_floor_mcd"] = mel_cepstral_distortion(rt_wav, ref_wav, sr)["mcd"]
        per_utt.append(m)
    mean = aggregate_metrics(per_utt)
    for m, p in zip(per_utt, sel.picks):
        m["path"] = str(p)
    return per_utt, mean


def summarize(args, meta: dict, n: int, mean: dict, is_ar: bool) -> dict:
    return {
        "n_utts": n,
        "first_stage": meta["model"],
        "decode": ("ar" if is_ar else args.decode),
        **({"ar_temperature": args.ar_temperature} if is_ar else {}),
        "bundle": str(args.bundle),
        "nar_bundle": str(args.nar_bundle),
        "split": "val (trainer 95/5 seed-0; eval ∩ train = ∅)",
        "mean": {k: round(float(v), 4) for k, v in mean.items() if isinstance(v, (int, float))},
    }


def main(argv: list[str] | None = None) -> dict:
    """The CLI; returns the summary it prints (the JSON also holds
    ``per_utt``)."""
    from ..bundle import load_meta
    from ..codec import encodec
    from ..serve import load_model
    from ..utils.device import resolve_device

    cfg, args = parse_args(argv)
    device = resolve_device(args.device)
    meta = load_meta(args.bundle)
    first, phone_symmap = load_model(args.bundle)
    nar, _ = load_model(args.nar_bundle)
    first, nar = first.to(device).eval(), nar.to(device).eval()
    is_ar = meta["model"].lower().startswith("ar")
    text_len, prom_len, gl = buckets(cfg, first, is_ar, args.resp_bucket)

    sel = select(cfg, phone_symmap, args.n, args.seed, text_len, prom_len)
    codes, gen_lens = generate(
        first, nar, sel, is_ar=is_ar, bucket=args.resp_bucket, gl=gl, decode=args.decode,
        maskgit_steps=args.maskgit_steps, ar_temperature=args.ar_temperature,
        nar_temperature=args.nar_temperature, seed=args.seed)
    codec = encodec.load_codec(encodec.find_weights(), device=device)
    per_utt, mean = score(sel, codes, gen_lens, gl, codec)
    summary = summarize(args, meta, len(sel.picks), mean, is_ar)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps({"summary": summary, "per_utt": per_utt}, indent=1,
                                   default=str))
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
