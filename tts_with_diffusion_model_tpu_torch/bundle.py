"""Bundle reader, numpy only (counterpart of ``export.load_bundle`` and
``codec/convert.load_npz_params`` in the JAX package).

A bundle is a directory: ``params.npz`` (arrays keyed by ``/``-joined flax
paths), ``model.json`` and the two symmaps.  f16 arrays (a storage-size
option of the exporter) are upcast to fp32.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from .text.symmap import load_symmap


def load_npz(path: str | Path) -> dict[str, np.ndarray]:
    """Flat ``{flax path: array}``; f16 arrays upcast to fp32."""
    out = {}
    with np.load(path) as data:
        for k in data.files:
            a = data[k]
            out[k] = a.astype(np.float32) if a.dtype == np.float16 else a
    return out


def load_meta(path: str | Path) -> dict:
    """A bundle's ``model.json``: model family and hyperparameters."""
    return json.loads((Path(path) / "model.json").read_text())


def load_bundle(path: str | Path) -> tuple[dict, dict, dict, dict]:
    """→ (flat params, model meta, phone symmap, speaker symmap)."""
    path = Path(path)
    return (
        load_npz(path / "params.npz"),
        load_meta(path),
        load_symmap(path / "phone_symmap.json"),
        load_symmap(path / "spkr_symmap.json"),
    )
