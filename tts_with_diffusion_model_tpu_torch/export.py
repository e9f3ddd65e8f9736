"""Export a trained model to a deployment bundle (counterpart of
``export.py`` in the JAX package):

    python -m tts_with_diffusion_model_tpu_torch.export <path> yaml=<cfg> \\
        [--ema] [--dtype f32|f16] [restore_step=<n>] [device=cpu]

Loads the run's latest checkpoint (or ``restore_step``) through the train
CLI's ``load_engines`` (checkpoints hold full tensors, so a run saved under
any mesh exports; under torchrun the ranks gather the config's mesh's
blocks and the global leader writes) and writes the bundle that both
packages read:

    <path>/params.npz       flax-path arrays (``params/dit_0/attn/k/kernel``)
    <path>/model.json       model family, step, weights and the run's
                            ``model_overrides``
    <path>/phone_symmap.json, spkr_symmap.json   from the run's data
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from .bundle import load_bundle  # noqa: F401 (re-export: export.load_bundle)
from .text.symmap import save_symmap


def save_bundle(path, flat_params: dict[str, np.ndarray], model_meta: dict,
                phone_symmap: dict, spkr_symmap: dict) -> None:
    """Write a bundle: ``flat_params`` keyed by ``/``-joined flax paths with
    the leading ``params/``."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    np.savez(path / "params.npz", **flat_params)
    (path / "model.json").write_text(json.dumps(model_meta, indent=1))
    save_symmap(phone_symmap, path / "phone_symmap.json")
    save_symmap(spkr_symmap, path / "spkr_symmap.json")


def bundle_params(module: torch.nn.Module,
                  tensors: dict[str, torch.Tensor] | None = None) -> dict[str, np.ndarray]:
    """A trained model's parameters (or ``tensors`` in their place, keyed by
    the model's parameter names: the EMA copy) as flat fp32 flax arrays: the
    denoiser's for the diffusion family, the whole AR / NAR otherwise."""
    from .convert import torch_params_to_jax

    target = getattr(module, "denoiser", module)
    if tensors is not None and target is not module:
        tensors = {k.removeprefix("denoiser."): v for k, v in tensors.items()}
    return {f"params/{k}": v for k, v in torch_params_to_jax(target, tensors).items()}


def main(argv: list[str] | None = None):
    """``argv``: the command line without the program name (default
    ``sys.argv``); ``key=value`` items go to the config."""
    from .config import Config
    from .data.dataset import create_datasets
    from .train.train import load_engines
    from .utils import distributed
    from .utils.config_base import _is_cfg_argv

    # from_cli first: with sys.argv it strips the key=value items, so
    # argparse sees only the path and the flags
    cfg = Config.from_cli(argv)
    parser = argparse.ArgumentParser("Save a trained model to a bundle.")
    parser.add_argument("path", type=Path)
    parser.add_argument("--ema", action="store_true",
                        help="export the EMA-averaged weights (needs a run trained with "
                             "ema_decay set)")
    parser.add_argument("--dtype", choices=("f32", "f16"), default="f32",
                        help="storage dtype of params.npz: f16 halves the bundle; readers "
                             "upcast to fp32")
    args = parser.parse_args(None if argv is None else [a for a in argv if not _is_cfg_argv(a)])

    engine = load_engines(cfg)["model"]
    # full tensors whatever the mesh (a gather over tp on every rank)
    tensors = engine.full_state_dict()
    if args.ema:
        tensors = engine.ema_state_dict()
        if tensors is None:
            raise SystemExit("--ema requires a run trained with ema_decay set "
                             "(the checkpoint carries no averaged weights)")
    flat = bundle_params(engine.module, tensors)
    if not distributed.is_global_leader():
        return args.path
    if args.dtype == "f16":
        flat = {k: v.astype(np.float16) if np.issubdtype(v.dtype, np.floating) else v
                for k, v in flat.items()}

    train_dataset, _ = create_datasets(cfg)
    meta = {
        "model": cfg.model,
        "num_tokens": cfg.num_tokens,
        "step": engine.global_step,
        "cfg_name": cfg.cfg_name,
        "weights": "ema" if args.ema else "raw",
        # the architecture overrides, so the readers rebuild the trained model
        **(cfg.model_overrides or {}),
    }
    save_bundle(args.path, flat, meta, train_dataset.phone_symmap, train_dataset.spkr_symmap)
    print(args.path, "saved.")
    return args.path


if __name__ == "__main__":
    from .utils.distributed import shutdown_distributed

    try:
        main()
    finally:
        shutdown_distributed()
