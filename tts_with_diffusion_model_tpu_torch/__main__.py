"""Zero-shot TTS inference CLI on the card (counterpart of ``__main__.py`` in
the JAX package), for a D3PM diffusion bundle decoded with MaskGIT or the
ancestral chain:

    python -m tts_with_diffusion_model_tpu_torch '<text>' ref.wav out.wav \\
        --ar-ckpt zoo/diffusion --nar-ckpt zoo/nar [--device cuda] [--seed 0] \\
        [--decode maskgit|ancestral] [--stride 3]

``--stride`` above 1 alone selects the ancestral chain.  AR first stages are
not ported yet and are rejected.
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
    parser.add_argument("--codec", type=Path, default=None,
                        help="converted EnCodec weights (.npz); default $ENCODEC_WEIGHTS, "
                             "then zoo/encodec_24khz.npz, else weights drawn from seed 0")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--temperature", type=float, default=1.0)
    parser.add_argument("--nar-temperature", type=float, default=0.2)
    parser.add_argument("--decode", choices=("ancestral", "maskgit"), default=None,
                        help="first-stage sampler (default: ancestral when --stride > 1, "
                             "else maskgit)")
    parser.add_argument("--stride", type=int, default=1,
                        help="ancestral skip-step stride (3: 33 denoiser calls, not 99)")
    parser.add_argument("--maskgit-steps", type=int, default=12)
    parser.add_argument("--fp32", action="store_true",
                        help="keep fp32 weights (default: bf16 serving precision)")
    args = parser.parse_args(argv)

    from .audio.wavio import write_wav
    from .codec.encodec import find_weights
    from .serve import Synthesizer

    try:
        synth = Synthesizer.from_bundles(
            args.ar_ckpt, args.nar_ckpt, find_weights(args.codec), device=args.device,
            bf16=not args.fp32, decode=args.decode, stride=args.stride,
            maskgit_steps=args.maskgit_steps,
            temperature=args.temperature, nar_temperature=args.nar_temperature,
        )
    except NotImplementedError as e:
        parser.error(str(e))
    wav, sr = synth.synthesize(args.text, args.reference, seed=args.seed)
    write_wav(args.out_path, wav, sr)
    print(args.out_path, "saved.")


if __name__ == "__main__":
    main()
