"""Zero-shot TTS inference CLI on the card (counterpart of ``__main__.py`` in
the JAX package), for an AR, a D3PM or a Gaussian diffusion first stage:

    python -m tts_with_diffusion_model_tpu_torch '<text>' ref.wav out.wav \\
        [--ar-ckpt zoo/ar] [--nar-ckpt zoo/nar] [--device cuda] [--seed 0] \\
        [--max-ar-steps 1000] [--draft-ckpt <AR bundle> --spec-k 4] \\
        [--decode maskgit|ancestral] [--stride 3] [--segment-phones N]

The first stage is dispatched on the bundle's model family.  An AR decodes
up to ``--max-ar-steps`` tokens over a KV cache, or speculatively with a
``--draft-ckpt`` proposing ``--spec-k`` tokens per round (at
``--temperature 0`` the target's own greedy decode).  A D3PM bundle decodes
with MaskGIT or the ancestral chain; ``--stride`` above 1 alone selects the
ancestral chain.  A Gaussian bundle (``diffusion-gaussian*``) runs its whole
reverse chain at its ``resp_len`` bucket; ``--decode`` and ``--stride`` are
refused for it.

Every request goes through ``serve.Synthesizer``, at its text bucket (50
phones for an AR, the bundle's ``text_len`` for a diffusion bundle) and a
128-multiple prompt bucket (``prom_len`` for ``-unet2d-ref``, whose
conditioning flattens the whole prompt).  The JAX CLI runs an AR unbucketed at B = 1; the pads are
masked, so at temperature 0 both give the same tokens.  A text over the
text bucket is synthesized in chained segments with one decode of the
joined codes (``longform.py``); ``--segment-phones N`` forces that path
with at most N phones per segment.
"""

from __future__ import annotations

import argparse
from pathlib import Path


def main(argv=None):
    parser = argparse.ArgumentParser("VALL-E / diffusion TTS (PyTorch/CUDA)")
    parser.add_argument("text")
    parser.add_argument("reference", type=Path)
    parser.add_argument("out_path", type=Path)
    parser.add_argument("--ar-ckpt", type=Path, default=Path("zoo/ar"),
                        help="first-stage bundle (an AR, D3PM or Gaussian diffusion bundle)")
    parser.add_argument("--nar-ckpt", type=Path, default=Path("zoo/nar"))
    parser.add_argument("--codec", type=Path, default=None,
                        help="converted EnCodec weights (.npz); default $ENCODEC_WEIGHTS, "
                             "then zoo/encodec_24khz.npz, else weights drawn from seed 0")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--temperature", type=float, default=1.0)
    parser.add_argument("--nar-temperature", type=float, default=0.2)
    parser.add_argument("--max-ar-steps", type=int, default=1000,
                        help="most tokens an AR first stage decodes")
    parser.add_argument("--draft-ckpt", type=Path, default=None,
                        help="AR bundle that drafts --spec-k tokens per round for the AR "
                             "first stage to verify in one forward (speculative decoding)")
    parser.add_argument("--spec-k", type=int, default=4,
                        help="draft tokens per speculative round")
    parser.add_argument("--decode", choices=("ancestral", "maskgit"), default=None,
                        help="D3PM sampler (default: ancestral when --stride > 1, "
                             "else maskgit)")
    parser.add_argument("--stride", type=int, default=1,
                        help="ancestral skip-step stride (3: 33 denoiser calls, not 99)")
    parser.add_argument("--maskgit-steps", type=int, default=12)
    parser.add_argument("--fp32", action="store_true",
                        help="keep fp32 weights (default: bf16 serving precision)")
    parser.add_argument("--segment-phones", type=int, default=None,
                        help="force long-form synthesis with this per-segment phone budget "
                             "(long-form engages by itself over the first stage's text bucket)")
    args = parser.parse_args(argv)
    if args.segment_phones is not None and args.segment_phones < 0:
        parser.error(f"--segment-phones {args.segment_phones}: a long-form segment needs at "
                     "least one phone (0: the text bucket)")

    from .audio.wavio import write_wav
    from .codec.encodec import find_weights
    from .serve import Synthesizer

    try:
        synth = Synthesizer.from_bundles(
            args.ar_ckpt, args.nar_ckpt, find_weights(args.codec), device=args.device,
            bf16=not args.fp32, decode=args.decode, stride=args.stride,
            maskgit_steps=args.maskgit_steps, max_ar_steps=args.max_ar_steps,
            draft_ckpt=args.draft_ckpt, spec_k=args.spec_k,
            temperature=args.temperature, nar_temperature=args.nar_temperature,
        )
    except (NotImplementedError, ValueError) as e:
        parser.error(str(e))
    if args.segment_phones is not None:
        from .longform import synthesize_long

        wav, sr = synthesize_long(synth, args.text, args.reference, seed=args.seed,
                                  max_segment_phones=args.segment_phones)
    else:
        wav, sr = synth.synthesize(args.text, args.reference, seed=args.seed)
    write_wav(args.out_path, wav, sr)
    print(args.out_path, "saved.")


if __name__ == "__main__":
    main()
