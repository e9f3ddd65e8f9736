"""Published EnCodec-24kHz checkpoint → converted-weights ``.npz``
(counterpart of ``codec/convert.py`` in the JAX package, whose numpy code
this copies: both write the same arrays under the same keys, so
``$ENCODEC_WEIGHTS`` serves either package).

    python -m tts_with_diffusion_model_tpu_torch.codec.convert encodec_24khz.th \\
        [zoo/encodec_24khz.npz] [--verify] [--device cuda]

Every tensor is kept bit-exact; only layouts change, into the flax layouts
the converted-weights format uses (``convert.jax_params_to_torch`` maps them
onto the port's modules):
  - Conv1d weight_v (Cout, Cin, K) → (K, Cin, Cout); weight_g (Cout, 1, 1)
    → (1, 1, Cout);
  - ConvTranspose1d weight_v (Cin, Cout, K) → (K, Cin, Cout); weight_g
    (Cin, 1, 1) → (1, Cin, 1) (torch weight norm at dim 0 is per-Cin);
  - LSTM weight_ih_l{n} (4H, C) → (C, 4H); the two biases are summed;
  - RVQ codebooks: ``quantizer.vq.layers.{q}._codebook.embed`` stacked.
Accepted layouts: the official ``encodec`` release (with its doubled
``conv.conv`` names), a plain state dict, HF ``transformers``'
``EncodecModel`` and torch ≥ 2.1's parametrized weight norm
(``normalize_checkpoint_keys``).
"""

from __future__ import annotations

import argparse
import json
import re
from pathlib import Path

import numpy as np


def _t(x):
    return np.asarray(x, dtype=np.float32)


def _conv(sd: dict, prefix: str) -> dict:
    """A weight-normed conv: ``<prefix>.conv.weight_{g,v}`` and its bias."""
    v = _t(sd[f"{prefix}.conv.weight_v"])  # (Cout, Cin, K)
    g = _t(sd[f"{prefix}.conv.weight_g"])  # (Cout, 1, 1)
    b = _t(sd[f"{prefix}.conv.bias"])
    return {"v": v.transpose(2, 1, 0), "g": g.reshape(1, 1, -1), "b": b}


def _convtr(sd: dict, prefix: str) -> dict:
    v = _t(sd[f"{prefix}.convtr.weight_v"])  # (Cin, Cout, K)
    g = _t(sd[f"{prefix}.convtr.weight_g"])  # (Cin, 1, 1)
    b = _t(sd[f"{prefix}.convtr.bias"])
    return {"v": v.transpose(2, 0, 1), "g": g.reshape(1, -1, 1), "b": b}


def _lstm(sd: dict, prefix: str, num_layers: int = 2) -> dict:
    out = {}
    for layer in range(num_layers):
        w_ih = _t(sd[f"{prefix}.lstm.weight_ih_l{layer}"])  # (4H, C)
        w_hh = _t(sd[f"{prefix}.lstm.weight_hh_l{layer}"])  # (4H, H)
        b = _t(sd[f"{prefix}.lstm.bias_ih_l{layer}"]) + _t(sd[f"{prefix}.lstm.bias_hh_l{layer}"])
        out[f"w_ih_l{layer}"] = w_ih.T
        out[f"w_hh_l{layer}"] = w_hh.T
        out[f"b_l{layer}"] = b
    return out


def _resblock(sd: dict, prefix: str) -> dict:
    out = {"conv1": _conv(sd, f"{prefix}.block.1"), "conv2": _conv(sd, f"{prefix}.block.3")}
    if f"{prefix}.shortcut.conv.weight_v" in sd:
        out["shortcut"] = _conv(sd, f"{prefix}.shortcut")
    return out


def normalize_checkpoint_keys(sd: dict) -> dict:
    """The known public layouts onto the official ``encodec`` package's key
    names: HF ``transformers``' ``encoder.layers.N...`` and
    ``quantizer.layers.q.codebook.embed`` (and its transposed convs named
    ``conv``), the official release's doubled ``conv.conv`` /
    ``convtr.convtr``, and torch ≥ 2.1's
    ``parametrizations.weight.original0/1`` for ``weight_g/v``.  Returns a
    new dict; unknown keys pass through."""
    out = {}
    for k, v in sd.items():
        k = re.sub(r"^(encoder|decoder)\.layers\.", r"\1.model.", k)
        # the decoder's upsampling layers sit at 3/6/9/12 in the 24 kHz
        # topology; HF calls them ``conv``
        k = re.sub(r"^decoder\.model\.(3|6|9|12)\.conv\.", r"decoder.model.\1.convtr.", k)
        k = k.replace(".conv.conv.", ".conv.").replace(".convtr.convtr.", ".convtr.")
        k = re.sub(r"^quantizer\.layers\.(\d+)\.codebook\.embed$",
                   r"quantizer.vq.layers.\1._codebook.embed", k)
        k = k.replace(".parametrizations.weight.original0", ".weight_g")
        k = k.replace(".parametrizations.weight.original1", ".weight_v")
        out[k] = v
    return out


def convert_state_dict(sd: dict) -> dict:
    """A checkpoint's state dict (numpy arrays) → the codec's converted
    parameters, nested: {"params": {"encoder", "decoder", "quantizer"}}."""
    sd = normalize_checkpoint_keys(sd)
    n_ratios = 4
    enc = {"conv_in": _conv(sd, "encoder.model.0")}
    for i in range(n_ratios):
        enc[f"block_{i}"] = _resblock(sd, f"encoder.model.{1 + 3 * i}")
        enc[f"down_{i}"] = _conv(sd, f"encoder.model.{3 + 3 * i}")
    enc["lstm"] = _lstm(sd, f"encoder.model.{1 + 3 * n_ratios}")
    enc["conv_out"] = _conv(sd, f"encoder.model.{3 + 3 * n_ratios}")

    dec = {"conv_in": _conv(sd, "decoder.model.0"), "lstm": _lstm(sd, "decoder.model.1")}
    for i in range(n_ratios):
        dec[f"up_{i}"] = _convtr(sd, f"decoder.model.{3 + 3 * i}")
        dec[f"block_{i}"] = _resblock(sd, f"decoder.model.{4 + 3 * i}")
    # [..., res13, ELU14, conv15]: index 14 is the parameterless ELU
    dec["conv_out"] = _conv(sd, f"decoder.model.{3 + 3 * n_ratios}")

    n_q = 0
    while f"quantizer.vq.layers.{n_q}._codebook.embed" in sd:
        n_q += 1
    codebooks = np.stack([_t(sd[f"quantizer.vq.layers.{q}._codebook.embed"])
                          for q in range(n_q)])
    return {"params": {"encoder": enc, "decoder": dec, "quantizer": {"codebooks": codebooks}}}


def load_torch_checkpoint(path: str | Path) -> dict:
    """The official ``.th`` release, a plain torch state dict (tensors only:
    ``weights_only=True``) or an HF ``.safetensors`` file → numpy arrays."""
    if str(path).endswith(".safetensors"):
        from safetensors.numpy import load_file

        return dict(load_file(str(path)))
    import torch

    obj = torch.load(str(path), map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "best_state" in obj:  # the official release's format
        obj = obj["best_state"]
    return {k: v.numpy() for k, v in obj.items()}


def save_npz_params(params: dict, path: str | Path) -> None:
    """Write parameters, nested or flat (``params/...`` keys), as ``.npz``."""
    from ..utils.helpers import flatten_dict

    np.savez(path, **{k: np.asarray(v) for k, v in flatten_dict(params, sep="/").items()})


def codec_params(model) -> dict[str, np.ndarray]:
    """An ``EncodecModel``'s weights as flat converted parameters
    (``params/...``)."""
    from ..convert import torch_params_to_jax

    return {f"params/{k}": v for k, v in torch_params_to_jax(model).items()}


def verify_params(flat: dict, device="cuda") -> dict:
    """The checkpoint-validation battery: converted parameters through
    encode → decode → encode on a fixed multi-tone signal; codes in range,
    more than one distinct code (a broken conversion collapses the
    quantizer), finite audio, a finite re-encode.  Returns a report with
    ``ok``."""
    import torch

    from .encodec import HOP, codec_from_params

    bins = flat["params/quantizer/codebooks"].shape[1]
    codec = codec_from_params(flat, device)
    model = codec.model
    t = np.arange(HOP * 16) / 24_000.0
    wav = (0.5 * np.sin(2 * np.pi * 220 * t) + 0.3 * np.sin(2 * np.pi * 880 * t + 0.5)
           + 0.1 * np.sin(2 * np.pi * 3520 * t)).astype(np.float32)
    x = torch.as_tensor(wav, device=codec.device)[None, :, None]
    codes = model.encode(x, 8)
    out = model.decode(codes)
    codes2 = model.encode(out, 8)
    codes, out, codes2 = (a.cpu().numpy() for a in (codes, out, codes2))
    report = {
        "codes_shape": list(codes.shape),
        "codes_in_range": bool((codes >= 0).all() and (codes < bins).all()),
        "distinct_codes": int(len(np.unique(codes))),
        "finite_audio": bool(np.isfinite(out).all()),
        "audio_rms": float(np.sqrt((out ** 2).mean())),
        "reencode_finite": bool((codes2 >= 0).all() and (codes2 < bins).all()),
        "reencode_l0_match": float((codes2[:, 0] == codes[:, 0]).mean()),
    }
    report["ok"] = (report["codes_in_range"] and report["finite_audio"]
                    and report["distinct_codes"] > 1 and report["reencode_finite"])
    return report


def main(argv: list[str] | None = None) -> dict | None:
    """The CLI: convert (or, given an ``.npz``, load) and optionally verify;
    returns the verification report."""
    from ..bundle import load_npz

    ap = argparse.ArgumentParser(description="Convert the published EnCodec-24kHz checkpoint.")
    ap.add_argument("src", type=Path, help="a .th / .pt / .safetensors checkpoint, or an .npz "
                                           "to verify")
    ap.add_argument("dst", type=Path, nargs="?", default=Path("zoo/encodec_24khz.npz"))
    ap.add_argument("--verify", action="store_true",
                    help="run the checkpoint-validation battery after conversion (or on an "
                         "existing .npz)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu, for --verify")
    args = ap.parse_args(argv)
    if args.src.suffix == ".npz":
        flat = load_npz(args.src)
    else:
        args.dst.parent.mkdir(parents=True, exist_ok=True)
        params = convert_state_dict(load_torch_checkpoint(args.src))
        save_npz_params(params, args.dst)
        flat = load_npz(args.dst)
        print(f"{args.dst} saved.")
    if not args.verify:
        return None
    report = verify_params(flat, args.device)
    print(json.dumps(report, indent=2))
    if not report["ok"]:
        raise SystemExit(2)
    print("verification OK")
    return report


if __name__ == "__main__":
    main()
