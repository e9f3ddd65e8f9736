"""Model registry (counterpart of ``models/__init__.py`` in the JAX package).

``get_model(name)`` dispatches on the name prefix.  Only the D3PM
``diffusion`` family is ported: registry defaults d_model 512, 8 heads,
8 blocks, 100 timesteps, ``n_classes = num_tokens + 1``.  The other families
raise ``NotImplementedError`` naming the ROADMAP item that ports them.
"""

from __future__ import annotations

import dataclasses

import torch

from .diffusion import DiffusionConfig, DiffusionModel

_NOT_PORTED = (
    ("diffusion-gaussian", "the Gaussian family is ROADMAP queue 1 item 14"),
    ("ar", "AR training is ROADMAP queue 1 item 11 (after NAR training, item 12)"),
    ("nar", "NAR training is the next slice of ROADMAP queue 1 item 12"),
)


def get_model(name: str, num_tokens: int = 1024, overrides: dict | None = None,
              dtype=torch.bfloat16):
    """Build a model from its registry name.  ``overrides`` replaces
    individual ``DiffusionConfig`` fields (unknown keys are ignored, as in
    the JAX package); ``dtype`` is the compute precision."""
    name = name.lower()
    for prefix, why in _NOT_PORTED:
        if name.startswith(prefix):
            raise NotImplementedError(f"model {name!r} is not ported yet: {why}")
    if not name.startswith("diffusion"):
        raise ValueError("Model name should start with AR or NAR.")
    cfg = DiffusionConfig(n_classes=num_tokens + 1, d_model=512, n_heads=8, n_layers=8,
                          timesteps=100)
    valid = {f.name for f in dataclasses.fields(DiffusionConfig)}
    cfg = dataclasses.replace(cfg, **{k: v for k, v in (overrides or {}).items() if k in valid})
    return DiffusionModel(cfg, dtype=dtype)
