"""Weight carry-over between the JAX package's flax parameters and the port
(both directions), seeded weights, and the serving cast to bf16.

The port names its submodules after the flax modules, so a ``/``-joined flax
path becomes a ``state_dict`` name by module path plus one leaf rename,
decided by the type of the port module that owns the leaf:

  ``Dense``       ``kernel`` (in, out) → ``weight`` (out, in); ``bias``
  ``LayerNorm``   ``scale`` → ``weight``; ``bias``
  ``Embed``       ``embedding`` → ``weight``
  ``Conv``        ``kernel`` (*K, Cin, Cout) → ``weight`` (Cout, Cin, *K),
                  1-D or 2-D; ``bias``
  ``ConvTranspose`` ``kernel`` (K, Cin, Cout) → ``weight`` (Cin, Cout, K)
                  flipped along K (flax does not flip the kernel, torch's
                  transposed convolution does); ``bias``
  ``GroupNorm``, ``MaskedGroupNorm``  ``scale`` → ``weight``; ``bias``
  SEANet convs    ``v`` (K, Cin, Cout) → (Cout, Cin, K), or (Cin, Cout, K) for
                  a transposed conv; ``g`` → (dim 0 of v, 1, 1); ``b``
  ``ResidualLSTM`` ``w_ih_l{n}`` / ``w_hh_l{n}`` (in, 4H) → ``lstm.weight_*_l{n}``
                  (4H, in); ``b_l{n}`` → ``lstm.bias_ih_l{n}``, with
                  ``lstm.bias_hh_l{n}`` set to zero
  anything else   same name, same shape (``MultiEmbedding.weight``,
                  ``AdaLN.emb``, ``sep``, ``codebooks``, ``resp_table``)
"""

from __future__ import annotations

import numpy as np
import torch

from .codec.seanet import ResidualLSTM, StreamableConv1d, StreamableConvTranspose1d
from .models.base import Conv, ConvTranspose, Dense, Embed, GroupNorm, LayerNorm
from .models.unet import MaskedGroupNorm

_NORMS = (LayerNorm, GroupNorm, MaskedGroupNorm)


def _leaf_targets(owner, leaf: str, arr: np.ndarray) -> list[tuple[str, np.ndarray]]:
    """(port parameter name relative to ``owner``, array in the port's
    layout) for one flax leaf."""
    if isinstance(owner, Dense):
        if leaf == "kernel":
            return [("weight", arr.T)]
    elif isinstance(owner, _NORMS):
        if leaf == "scale":
            return [("weight", arr)]
    elif isinstance(owner, Embed):
        if leaf == "embedding":
            return [("weight", arr)]
    elif isinstance(owner, Conv):
        if leaf == "kernel":
            return [("weight", np.moveaxis(arr, (-1, -2), (0, 1)))]
    elif isinstance(owner, ConvTranspose):
        if leaf == "kernel":
            return [("weight", arr.transpose(1, 2, 0)[..., ::-1])]
    elif isinstance(owner, StreamableConvTranspose1d):
        if leaf == "v":
            return [("v", arr.transpose(1, 2, 0))]
        if leaf == "g":
            return [("g", arr.reshape(-1, 1, 1))]
    elif isinstance(owner, StreamableConv1d):
        if leaf == "v":
            return [("v", arr.transpose(2, 1, 0))]
        if leaf == "g":
            return [("g", arr.reshape(-1, 1, 1))]
    elif isinstance(owner, ResidualLSTM):
        kind, n = leaf.rsplit("_l", 1)
        if kind in ("w_ih", "w_hh"):
            return [(f"lstm.weight_{kind[2:]}_l{n}", arr.T)]
        if kind == "b":
            return [(f"lstm.bias_ih_l{n}", arr),
                    (f"lstm.bias_hh_l{n}", np.zeros_like(arr))]
    return [(leaf, arr)]


def jax_params_to_torch(flat: dict[str, np.ndarray], module: torch.nn.Module) -> None:
    """Copy flax parameters (``{"a/b/kernel": array}``, with or without the
    leading ``params/``) into ``module``'s parameters, in place.

    Raises ``KeyError`` on a flax array that lands nowhere and on a port
    parameter left unset, ``ValueError`` on a shape mismatch."""
    params = dict(module.named_parameters())
    unset = set(params)
    leftover = []
    with torch.no_grad():
        for key, arr in flat.items():
            parts = key.split("/")
            if parts[0] == "params":
                parts = parts[1:]
            try:
                owner = module.get_submodule(".".join(parts[:-1]))
            except AttributeError:
                leftover.append(key)
                continue
            prefix = ".".join(parts[:-1])
            for name, val in _leaf_targets(owner, parts[-1], np.asarray(arr)):
                full = f"{prefix}.{name}" if prefix else name
                p = params.get(full)
                if p is None:
                    leftover.append(key)
                    continue
                if tuple(p.shape) != val.shape:
                    raise ValueError(f"{key} → {full}: shape {val.shape} != {tuple(p.shape)}")
                p.copy_(torch.tensor(np.ascontiguousarray(val), dtype=p.dtype))
                unset.discard(full)
    if leftover:
        raise KeyError(f"flax arrays with no port parameter: {sorted(leftover)[:10]}")
    if unset:
        raise KeyError(f"port parameters left unset: {sorted(unset)[:10]}")


def _flax_leaf(owner, leaf: str, val: np.ndarray) -> tuple[str, np.ndarray]:
    """Inverse of ``_leaf_targets`` for the model layers: (flax leaf name,
    array in the flax layout)."""
    if isinstance(owner, Dense) and leaf == "weight":
        return "kernel", val.T
    if isinstance(owner, _NORMS) and leaf == "weight":
        return "scale", val
    if isinstance(owner, Embed) and leaf == "weight":
        return "embedding", val
    if isinstance(owner, Conv) and leaf == "weight":
        return "kernel", np.moveaxis(val, (0, 1), (-1, -2))
    if isinstance(owner, ConvTranspose) and leaf == "weight":
        return "kernel", val[..., ::-1].transpose(2, 0, 1)
    if isinstance(owner, (StreamableConv1d, StreamableConvTranspose1d, ResidualLSTM)):
        raise NotImplementedError("codec parameters are not exported to flax yet")
    return leaf, val


def torch_params_to_jax(module: torch.nn.Module,
                        tensors: dict[str, torch.Tensor] | None = None) -> dict[str, np.ndarray]:
    """The inverse of ``jax_params_to_torch``: ``{"a/b/kernel": fp32 array}``
    with the ``/``-joined flax paths (no leading ``params/``).  ``tensors``
    maps parameter names to other values to convert in the parameters'
    place (gradients, an EMA copy); by default the parameters themselves."""
    out = {}
    for name, p in module.named_parameters():
        val = p if tensors is None else tensors[name]
        key, arr = _flax_item(module, name, val.detach().float().cpu().numpy())
        out[key] = np.ascontiguousarray(arr)
    return out


def _flax_item(module: torch.nn.Module, name: str, val) -> tuple[str, np.ndarray]:
    prefix, _, leaf = name.rpartition(".")
    owner = module.get_submodule(prefix) if prefix else module
    flax_leaf, arr = _flax_leaf(owner, leaf, val)
    return ("/".join([*prefix.split("."), flax_leaf]) if prefix else flax_leaf), arr


def tree_path(module: torch.nn.Module, name: str) -> str:
    """The ``/``-joined flax path (no leading ``params/``) of ``module``'s
    parameter ``name``: ``base.text_emb.weight`` → ``base/text_emb/embedding``."""
    return _flax_item(module, name, np.empty(0))[0]


def init_seeded(module: torch.nn.Module, seed: int) -> None:
    """Random weights drawn from ``seed`` on the CPU (device independent):
    lecun-normal for projection and conv weights, N(0, 1) for embedding
    tables, ``resp_table`` and codebooks, ones for norm scales and weight-norm gains, zeros
    for biases and AdaLN tables."""
    g = torch.Generator().manual_seed(int(seed))
    with torch.no_grad():
        for name, p in module.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            owner = module.get_submodule(name.rsplit(".", 1)[0]) if "." in name else module
            if isinstance(owner, _NORMS) and leaf == "weight" or leaf == "g":
                val = torch.ones(p.shape)
            elif leaf in ("bias", "b", "emb") or leaf.startswith("bias_"):
                val = torch.zeros(p.shape)
            elif (isinstance(owner, (Dense, Conv, ConvTranspose)) or leaf == "v"
                  or leaf.startswith("weight_")):
                fan_in = p[0].numel()
                if isinstance(owner, (StreamableConvTranspose1d, ConvTranspose)):
                    fan_in = p.shape[0] * p.shape[2]
                val = torch.randn(p.shape, generator=g) / fan_in ** 0.5
            else:
                val = torch.randn(p.shape, generator=g)
            p.copy_(val.to(p.dtype))


def cast_params_bf16(module: torch.nn.Module) -> torch.nn.Module:
    """Serving precision, as the JAX package's ``cast_params_bf16``: every
    parameter of two or more dimensions becomes bf16, except under a norm;
    biases, norms and other 1-D parameters stay fp32."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            if p.ndim >= 2 and "norm" not in name.lower():
                p.data = p.data.to(torch.bfloat16)
    return module
