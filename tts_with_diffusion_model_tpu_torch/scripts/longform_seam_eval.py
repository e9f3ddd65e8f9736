"""Long-form seam evidence on trained weights (counterpart of
``scripts/longform_seam_eval.py`` in the JAX repository).

Chains the segments of a long text through a ``Synthesizer`` (the trained
first stage + NAR, ``longform.iter_segment_codes``), decodes the joined code
stream in one convolutional pass, and reports the seam spectral-flux ratio
at every join (``utils/metrics.seam_spectral_flux``) beside the hard splice
of per-segment decodes.

    python -m tts_with_diffusion_model_tpu_torch.scripts.longform_seam_eval \\
        FIRST_BUNDLE NAR_BUNDLE REF_WAV --out OUT.json [--text "..."] [--seed 11] \\
        [--segment-budget N] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

# in the vocabulary of the synthetic corpus (scripts/make_gen_corpus.py
# VOCAB), and long enough to force several segments at the 50-phone bucket
DEFAULT_TEXT = (
    "anchor bright copper drift ember fable glide harbor island jasper "
    "kettle lumen marble north orbit pepper quiver river stone timber "
    "under velvet willow yonder zephyr amber birch cedar dune elm fern "
    "grove hazel iris juniper lark maple oak pine reed"
)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="Long-form seam evaluation.")
    ap.add_argument("first_bundle")
    ap.add_argument("nar_bundle")
    ap.add_argument("ref_wav")
    ap.add_argument("--out", required=True)
    ap.add_argument("--text", default=DEFAULT_TEXT)
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--segment-budget", type=int, default=None,
                    help="phones per segment (default: the synthesizer's)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def generate(synth, text: str, ref_wav, seed: int, segment_budget: int | None = None):
    """The chained segments' (t, 8) codes."""
    from ..longform import iter_segment_codes

    kw = {"max_segment_phones": segment_budget} if segment_budget else {}
    return list(iter_segment_codes(synth, text, ref_wav, seed=seed, **kw))


def score(pieces: list[np.ndarray], decode_codes) -> dict:
    """Seam flux of the one-shot decode of the joined codes and of the
    spliced per-segment decodes at the same boundaries.  ``decode_codes``:
    (t, 8) codes → (wav, sample rate)."""
    from ..codec.encodec import HOP
    from ..utils.metrics import seam_spectral_flux

    boundaries = np.cumsum([p.shape[0] for p in pieces])[:-1] * HOP
    one_shot, sr = decode_codes(np.concatenate(pieces, axis=0))
    spliced = np.concatenate([decode_codes(p)[0] for p in pieces], axis=-1)
    seam_one = seam_spectral_flux(one_shot, sr, boundaries)
    seam_spl = seam_spectral_flux(spliced, sr, boundaries)
    return {
        "n_segments": len(pieces),
        "total_frames": int(sum(p.shape[0] for p in pieces)),
        "one_shot": dict(seam_one),
        "hard_splice": dict(seam_spl),
        "seam_free": bool(seam_one["seam_flux_ratio_max"]
                          <= seam_spl["seam_flux_ratio_max"] + 1e-6),
    }


def main(argv: list[str] | None = None) -> dict:
    """The CLI; exits 1 when the text makes a single segment."""
    from ..codec import encodec
    from ..serve import Synthesizer

    args = parse_args(argv)
    synth = Synthesizer.from_bundles(args.first_bundle, args.nar_bundle, encodec.find_weights(),
                                     device=args.device)
    pieces = generate(synth, args.text, args.ref_wav, args.seed, args.segment_budget)
    if len(pieces) < 2:
        print(json.dumps({"error": "text produced a single segment — lengthen it or shrink "
                                   "--segment-budget"}))
        raise SystemExit(1)
    out = score(pieces, synth.decode_codes)
    Path(args.out).write_text(json.dumps(out, indent=1))
    print(json.dumps({"out": args.out,
                      "one_shot_max": out["one_shot"]["seam_flux_ratio_max"],
                      "splice_max": out["hard_splice"]["seam_flux_ratio_max"],
                      "seam_free": out["seam_free"]}))
    return out


if __name__ == "__main__":
    main()
