"""Model registry (counterpart of ``models/__init__.py`` in the JAX package).

``get_model(name)`` dispatches on the name prefix:

- ``diffusion``: the D3PM family, registry defaults d_model 512, 8 heads,
  8 blocks, 100 timesteps, ``n_classes = num_tokens + 1``;
- ``diffusion-gaussian*``: the Gaussian family (``models/gaussian_tts.py``),
  registry defaults d_model 256, 8 heads, 8 blocks, 100 timesteps;
- ``ar`` / ``nar`` (with ``-quarter`` 256/4/12, ``-half`` 512/8/12, bare
  1024/16/12).
"""

from __future__ import annotations

import dataclasses

import torch

from .ar import AR
from .diffusion import DiffusionConfig, DiffusionModel
from .gaussian_tts import GaussianConfig, GaussianDiffusionModel
from .nar import NAR

#: the override keys the ar / nar branches read (the JAX registry's)
_BACKBONE_KEYS = ("d_model", "n_heads", "n_layers", "remat", "remat_policy", "attn_impl")


def _backbone_dims(name: str) -> dict:
    """d_model / n_heads / n_layers of an ``ar*`` or ``nar*`` registry name."""
    if "-quarter" in name:
        return dict(d_model=256, n_heads=4, n_layers=12)
    if "-half" in name:
        return dict(d_model=512, n_heads=8, n_layers=12)
    if name in ("ar", "nar"):
        return dict(d_model=1024, n_heads=16, n_layers=12)
    raise NotImplementedError(name)


def _gaussian(name: str, num_tokens: int, ov: dict, dtype):
    """The ``diffusion-gaussian*`` branch, name checks in the JAX registry's
    order: ``unet2d-ref`` (the published widths (320, 640, 1280, 1280), 8
    heads), ``unet2d`` (the conv-UNet), then the DiT with the ``value``
    suffix's domain and ``unet``'s (128, 64) bottleneck."""
    if "unet2d-ref" in name:
        domain, unet, denoiser = "value", (), "unet2d-ref"
    elif "unet2d" in name:
        domain, unet, denoiser = "value", (), "conv-unet"
    else:
        domain = "value" if name.endswith("value") else "embedding"
        unet = (128, 64) if "unet" in name else ()
        denoiser = "dit"
    cfg = GaussianConfig(n_tokens=num_tokens, domain=domain, unet_dims=unet, denoiser=denoiser)
    if denoiser == "unet2d-ref":
        cfg = dataclasses.replace(cfg, unet_channels=(320, 640, 1280, 1280), n_heads=8)
    valid = {f.name for f in dataclasses.fields(GaussianConfig)}
    cfg = dataclasses.replace(cfg, **{k: v for k, v in ov.items() if k in valid})
    return GaussianDiffusionModel(cfg, dtype=dtype)


def get_model(name: str, num_tokens: int = 1024, overrides: dict | None = None,
              dtype=torch.bfloat16):
    """Build a model from its registry name.  ``overrides`` replaces
    individual ``DiffusionConfig`` or ``GaussianConfig`` fields, or the
    backbone keys above for ``ar`` / ``nar`` (unknown keys are ignored, as
    in the JAX package); ``dtype`` is the compute precision."""
    name = name.lower()
    ov = overrides or {}
    if name.startswith("diffusion-gaussian"):
        return _gaussian(name, num_tokens, ov, dtype)
    if name.startswith("diffusion"):
        cfg = DiffusionConfig(n_classes=num_tokens + 1, d_model=512, n_heads=8, n_layers=8,
                              timesteps=100)
        valid = {f.name for f in dataclasses.fields(DiffusionConfig)}
        cfg = dataclasses.replace(cfg, **{k: v for k, v in ov.items() if k in valid})
        return DiffusionModel(cfg, dtype=dtype)
    if name.startswith("ar"):
        model = AR
    elif name.startswith("nar"):
        model = NAR
    else:
        raise ValueError("Model name should start with AR or NAR.")
    dims = _backbone_dims(name)
    dims.update({k: v for k, v in ov.items() if k in _BACKBONE_KEYS})
    return model(num_tokens, dtype=dtype, **dims)
