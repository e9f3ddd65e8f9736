"""Import a reference-trained checkpoint into a bundle (counterpart of
``compat/import_reference.py`` in the JAX package):

    python -m tts_with_diffusion_model_tpu_torch.compat.import_reference \
        zoo/ar.pt out_bundle/ [--family auto|ar|nar|d3pm] [--n-heads N] \
        [--allow-pickle]

Accepts the reference's deployment artifacts — the whole-model pickles its
export writes (the reference's ``vall_e/export.py:15-20``, with
``phone_symmap``/``spkr_symmap`` stapled onto the module) — and raw
state_dicts (plain ``.pt`` or DeepSpeed ``mp_rank_00_model_states.pt`` with
a ``module`` key).  Weights are converted with the maps in
``compat.reference`` and written as a bundle that ``serve.load_model`` (and
the JAX package) load, so the CLIs serve reference-trained models directly:

    python -m tts_with_diffusion_model_tpu_torch '<text>' ref.wav out.wav \
        --ar-ckpt out_bundle/ ...

Family detection: pickled modules carry their class; state_dicts are
classified by key shape (``blocks.0.attn.norm.emb.weight`` → NAR's AdaLN,
``encodertext...`` → the D3PM denoiser, otherwise AR).
"""

from __future__ import annotations

import argparse
import pickle
from pathlib import Path


def _load_torch_object(path: Path, allow_pickle: bool = False):
    """Load a checkpoint, tensors-only by default.

    ``weights_only=True`` handles raw state_dicts and DeepSpeed model-state
    files without executing pickled code.  The reference's *export* format
    is a whole pickled module (``export.py:20``) — unpickling it runs
    arbitrary code from the file, so that path is an explicit opt-in
    (``--allow-pickle``) reserved for checkpoints the operator trusts.
    """
    import torch

    from .reference import load_reference

    if not Path(path).exists():  # a typo'd path must not read as "pickled"
        raise SystemExit(f"Checkpoint not found: {path}")
    try:
        return torch.load(str(path), map_location="cpu", weights_only=True)
    except pickle.UnpicklingError:
        # weights_only rejects non-tensor pickles with UnpicklingError —
        # the signature of the reference's pickled-module export format.
        # Anything else (corrupt file, I/O error) propagates as itself.
        pass
    if not allow_pickle:
        raise SystemExit(
            f"{path} is not a tensors-only checkpoint (it is a pickled "
            "module, the reference's export format). Unpickling executes "
            "code embedded in the file; re-run with --allow-pickle only if "
            "you trust its origin, or export a state_dict instead."
        )
    # Pickled reference modules resolve against 'vall_e.vall_e.*' — the
    # synthetic packages load_reference registers provide exactly those.
    load_reference()
    try:
        obj = torch.load(str(path), map_location="cpu", weights_only=False)
    except ModuleNotFoundError as e:  # pickled against an unknown layout
        raise SystemExit(
            f"Cannot unpickle {path}: {e}. Export a state_dict instead."
        )
    return obj


def _classify(sd: dict) -> str:
    if any(k.startswith("encodertext") for k in sd):
        return "d3pm"
    if "blocks.0.attn.norm.emb.weight" in sd:
        return "nar"
    return "ar"


def _dims_from_sd(sd: dict, family: str) -> dict:
    if family == "d3pm":
        d_model = sd["final.weight"].shape[1]
        n_layers = 1 + max(
            int(k.split(".")[1]) for k in sd if k.startswith("blocks.")
        )
        # timesteps and vocab live in the embedding-table shapes — a
        # checkpoint trained at non-default sizes must rebuild the same
        # architecture, not the registry defaults.
        return {
            "d_model": int(d_model),
            "n_layers": int(n_layers),
            "timesteps": int(sd["time_emb.weight"].shape[0]) - 1,
            "num_tokens": int(sd["text_emb.weight"].shape[0]) - 1,
        }
    n_tokens = sd["text_emb.weight"].shape[0]
    d_model = sd["text_emb.weight"].shape[1]
    n_layers = 1 + max(
        int(k.split(".")[1]) for k in sd if k.startswith("blocks.")
    )
    return {
        "num_tokens": int(n_tokens),
        "d_model": int(d_model),
        "n_layers": int(n_layers),
    }


def import_checkpoint(
    src: Path,
    dst: Path,
    family: str = "auto",
    n_heads: int | None = None,
    allow_pickle: bool = False,
) -> dict:
    """Convert ``src`` → bundle directory ``dst``.  Returns the meta dict."""
    from ..export import save_bundle
    from ..utils.helpers import flatten_dict
    from .reference import base_params_from_torch, dit_params_from_torch

    obj = _load_torch_object(src, allow_pickle=allow_pickle)
    phone_symmap, spkr_symmap = {}, {}
    if hasattr(obj, "state_dict"):  # pickled module (reference export format)
        phone_symmap = dict(getattr(obj, "phone_symmap", {}) or {})
        spkr_symmap = dict(getattr(obj, "spkr_symmap", {}) or {})
        sd = obj.state_dict()
    elif isinstance(obj, dict) and "module" in obj:  # DeepSpeed model states
        sd = obj["module"]
    else:
        sd = obj
    sd = {k: v for k, v in sd.items()}

    fam = _classify(sd) if family == "auto" else family
    dims = _dims_from_sd(sd, fam)

    if fam == "d3pm":
        params = {"params": dit_params_from_torch(sd, dims["n_layers"])}
        meta = {
            "model": "diffusion",
            "n_heads": n_heads or 16,   # the reference hard-codes nhead=16
            "imported_from": str(src),
            # reference-parity architecture knobs (ar_discrete.py defaults)
            "tower_ffn_dim": 2048,
            "tower_act": "relu",
            "resp_pe": False,
            **dims,  # d_model/n_layers/timesteps/num_tokens from the sd
        }
    else:
        norm = "adaln" if fam == "nar" else "ln"
        params = {
            "params": {"base": base_params_from_torch(sd, dims["n_layers"], norm)}
        }
        num_tokens = dims.pop("num_tokens")  # == text_emb rows, both families
        meta = {
            "model": fam,
            "num_tokens": int(num_tokens),
            "n_heads": n_heads or (dims["d_model"] // 64),
            "imported_from": str(src),
            **dims,
        }

    save_bundle(Path(dst), flatten_dict(params, sep="/"), meta, phone_symmap, spkr_symmap)
    return meta


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("src", type=Path)
    ap.add_argument("dst", type=Path)
    ap.add_argument("--family", default="auto", choices=["auto", "ar", "nar", "d3pm"])
    ap.add_argument("--n-heads", type=int, default=None)
    ap.add_argument(
        "--allow-pickle", action="store_true",
        help="permit full unpickling for the reference's pickled-module "
             "export format (executes code embedded in the checkpoint — "
             "only for files you trust)",
    )
    args = ap.parse_args(argv)
    meta = import_checkpoint(args.src, args.dst, args.family, args.n_heads,
                             allow_pickle=args.allow_pickle)
    print(f"{args.dst} saved: {meta}")
    return meta


if __name__ == "__main__":
    main()
