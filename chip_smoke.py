"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--zoo] [--seed 0] [--repeats 3] [--profile]

Drives the port's main path (D3PM MaskGIT serving: DiT → NAR → EnCodec) at
full width through ``Synthesizer``, builds every CUDA kernel from the sources
in this checkout with ``nvcc``, holds each kernel against its plain PyTorch
version at the main path's shapes, and checks that the main path launched
each kernel.  Weights are drawn from ``--seed`` unless ``--zoo`` loads the
committed bundles.  Prints each phase's seconds as it goes; the last lines
are the kernels' JSON, the card's ``nvidia-smi`` name and power limit, and
``{"ok": true, "device": {...}}``.  Exits non-zero, with no result, when
CUDA is unavailable or any phase fails.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--zoo", action="store_true",
                        help="load zoo/diffusion, zoo/nar and zoo/encodec_24khz.npz")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--repeats", type=int, default=3)
    parser.add_argument("--profile", action="store_true",
                        help="also trace one batch with torch.profiler and print where the time goes")
    args = parser.parse_args()
    t_start = time.perf_counter()

    try:
        import torch
        from tts_with_diffusion_model_tpu_torch import smoke
    except ImportError as e:
        print(f"chip_smoke: FAILED: cannot import the port ({e})", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: FAILED: torch.cuda.is_available() is false", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)

    with smoke.phase("device"):
        info = smoke.phase_device(device)
    with smoke.phase("build"):
        smoke.phase_build(device)
    from tts_with_diffusion_model_tpu_torch.models.diffusion import DiffusionConfig

    cfg = DiffusionConfig()
    nar_dims = {"d_model": 1024, "n_heads": 16, "n_layers": 12}
    with smoke.phase("kernel vs plain"):
        # 3 s references encode to 225 frames: prompt bucket 256 on the main path
        results = smoke.phase_kernel_check(
            device, cfg, nar_dims, steps=12, B=len(smoke.TEXTS),
            prompt_buckets=(128, 256, 384, 398), timed_bucket=256, seed=args.seed)
    with smoke.phase("slice"):
        sl = smoke.phase_slice(device, "full", zoo=args.zoo, seed=args.seed,
                               repeats=args.repeats)
    if args.profile:
        with smoke.phase("profile"):
            smoke.profile_batch(sl["synth"], sl["requests"])
    smoke.check(sl["prompt_bucket"] == 256,
                f"prompt bucket {sl['prompt_bucket']} != the timed bucket 256")
    smoke.check(sl["expected"] == 376, f"expected launches {sl['expected']} != 376")
    smoke.check(sl["launches"] > 0, "the main path never launched masked_attention")
    kernels = [smoke.kernel_summary(results, sl["launches"])]
    smoke.log(f"chip_smoke: whole run {time.perf_counter() - t_start:.1f} s "
              f"on {info['kind']} ({info['smi']})")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(info["smi"], flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": info["kind"],
                                             "count": info["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
