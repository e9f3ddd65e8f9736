"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--zoo] [--seed 0] [--repeats 3] [--profile]

Drives the port's two main paths at full width: D3PM MaskGIT serving
(DiT → NAR → EnCodec) through ``Synthesizer``, and D3PM training through the
train CLI's ``main`` on ``config/gen4c/diffusion.yml`` (8 steps over a
seeded synthetic corpus, checkpoint and val-loss eval at the last).  Builds
every CUDA kernel from the sources in this checkout with ``nvcc`` and counts
the wgmma (HGMMA) and TMA (UTMALDG) instructions in each library, holds
each kernel against its plain PyTorch version at its main path's shapes
(printing each site's kernel/SDPA and kernel/bound ratios), checks that the
training backward is deterministic, and checks that each main path
launched its kernels.  Weights are drawn from
``--seed`` unless ``--zoo`` loads the committed serving bundles.  Prints each
phase's seconds as it goes; the last lines are the kernels' JSON, the card's
``nvidia-smi`` name and power limit, and ``{"ok": true, "device": {...}}``.
Exits non-zero, with no result, when CUDA is unavailable or any phase fails.
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
                        help="also trace one serving batch and one train step with "
                             "torch.profiler and print where the time goes")
    args = parser.parse_args()
    t_start = time.perf_counter()

    try:
        import torch
        from tts_with_diffusion_model_tpu_torch import smoke, smoke_train
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
    with smoke.phase("train kernel vs plain"):
        from tts_with_diffusion_model_tpu_torch.config import Config
        from tts_with_diffusion_model_tpu_torch.train.train import build_model

        train_cfg = Config.from_cli([f"yaml={smoke_train.TRAIN_YAML}"])
        train_sites = smoke_train.train_attention_sites(
            build_model(train_cfg), train_cfg.batch_size, min(train_cfg.resp_len_buckets))
        train_results = smoke_train.phase_train_kernel_check(
            device, [*train_sites, smoke_train.ar_causal_site()], seed=args.seed)
        smoke_train.check_backward_determinism(
            next(s for s in train_sites if s.name == "DiT self"), device, seed=args.seed)
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
    with smoke.phase("train"):
        tr = smoke_train.phase_train(device, seed=args.seed)
    if args.profile:
        with smoke.phase("profile train step"):
            smoke_train.profile_train_step(tr["engines"], tr["cfg"])
    peak_gib = tr["peak_bytes"] / 2**30
    smoke.log(f"train: step p50 {tr['p50_step_s'] * 1e3:.1f} ms, "
              f"{tr['frames_per_s']:.0f} padded frames/s, peak allocated {peak_gib:.2f} GiB "
              f"on {info['smi']}")
    smoke.check((tr["fwd_per_step"], tr["bwd_per_step"]) == (52, 28),
                f"train launches per step {tr['fwd_per_step']}+{tr['bwd_per_step']} != 52+28")
    kernels = [smoke.kernel_summary(results, sl["launches"]),
               smoke_train.train_kernel_summary(train_results, tr["fwd_per_step"],
                                                tr["bwd_per_step"], tr["run_launches"])]
    smoke.log(f"chip_smoke: whole run {time.perf_counter() - t_start:.1f} s "
              f"on {info['kind']} ({info['smi']})")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(info["smi"], flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": info["kind"],
                                             "count": info["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
