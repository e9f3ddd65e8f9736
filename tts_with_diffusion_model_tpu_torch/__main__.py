"""Zero-shot TTS inference CLI on the card (counterpart of ``__main__.py`` in
the JAX package), for a D3PM diffusion bundle with MaskGIT decoding:

    python -m tts_with_diffusion_model_tpu_torch '<text>' ref.wav out.wav \\
        --ar-ckpt zoo/diffusion --nar-ckpt zoo/nar [--device cuda] [--seed 0]

AR first stages and ``--decode ancestral`` are not ported yet and are
rejected.
"""

from __future__ import annotations

import argparse
from pathlib import Path


def main(argv=None):
    parser = argparse.ArgumentParser("D3PM TTS (PyTorch/CUDA)")
    parser.add_argument("text")
    parser.add_argument("reference", type=Path)
    parser.add_argument("out_path", type=Path)
    parser.add_argument("--ar-ckpt", type=Path, default=Path("zoo/diffusion"),
                        help="first-stage bundle (a D3PM diffusion bundle)")
    parser.add_argument("--nar-ckpt", type=Path, default=Path("zoo/nar"))
    parser.add_argument("--codec", type=Path, default=Path("zoo/encodec_24khz.npz"),
                        help="converted EnCodec weights (.npz)")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--temperature", type=float, default=1.0)
    parser.add_argument("--nar-temperature", type=float, default=0.2)
    parser.add_argument("--decode", choices=("ancestral", "maskgit"), default="maskgit")
    parser.add_argument("--maskgit-steps", type=int, default=12)
    parser.add_argument("--fp32", action="store_true",
                        help="keep fp32 weights (default: bf16 serving precision)")
    args = parser.parse_args(argv)
    if args.decode != "maskgit":
        parser.error("--decode ancestral is not ported yet (only maskgit is)")

    from .audio.wavio import write_wav
    from .serve import Synthesizer

    try:
        synth = Synthesizer.from_bundles(
            args.ar_ckpt, args.nar_ckpt, args.codec, device=args.device,
            bf16=not args.fp32, decode=args.decode, maskgit_steps=args.maskgit_steps,
            temperature=args.temperature, nar_temperature=args.nar_temperature,
        )
    except NotImplementedError as e:
        parser.error(str(e))
    wav, sr = synth.synthesize(args.text, args.reference, seed=args.seed)
    write_wav(args.out_path, wav, sr)
    print(args.out_path, "saved.")


if __name__ == "__main__":
    main()
