"""Model diagnostics: per-module activation and gradient statistics
(counterpart of ``utils/diagnostic.py`` in the JAX package, the
reference's icefall-inspired ``Diagnostic``).

Activations come from forward hooks on every submodule (``capture``), as
in the reference; gradients and parameters from ``Engine.diagnose``, keyed
by the JAX package's parameter paths.  Every observation feeds one
accumulator, reported as a percentile table across the observed steps and
saved as CSV under ``log_dir/artifacts/diagnostic/`` with the JAX
package's columns and file names.  No pandas: the rows are plain dicts and
the CSV is written with the ``csv`` module.
"""

from __future__ import annotations

import contextlib
import csv
import logging
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

from .device import is_global_leader

_logger = logging.getLogger(__name__)

STATS = ("abs", "pos", "val", "rms", "min", "max", "cnt")
PERCENTILES = (0, 5, 25, 50, 75, 95, 100)


def tensor_stats(x: np.ndarray) -> dict[str, float]:
    """The per-tensor statistics the reference accumulates per axis,
    computed over the whole tensor."""
    x = np.asarray(x, np.float64).ravel()
    if x.size == 0:
        return {k: 0.0 for k in STATS}
    return {
        "abs": float(np.abs(x).mean()),
        "pos": float((x > 0).mean()),
        "val": float(x.mean()),
        "rms": float(np.sqrt((x**2).mean())),
        "min": float(x.min()),
        "max": float(x.max()),
        "cnt": float(x.size),
    }


def singular_values(x: np.ndarray, max_dim: int = 512, k: int = 8) -> np.ndarray:
    """Top-k singular values of a tensor seen as a (rows, last dim) matrix
    whose last dim is below ``max_dim`` (the reference's ``pca_lowrank``)."""
    x = np.asarray(x, np.float64)
    if x.ndim < 2:
        return np.array([])
    mat = x.reshape(-1, x.shape[-1])
    if mat.shape[-1] >= max_dim or mat.shape[0] < 2:
        return np.array([])
    sub = mat[: min(len(mat), 4096)]
    try:
        s = np.linalg.svd(sub - sub.mean(0), compute_uv=False)
    except np.linalg.LinAlgError:
        return np.array([])
    return s[:k]


def _numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x)


class Diagnostic:
    """Accumulate stats across steps; ``save()`` writes a percentile CSV."""

    def __init__(self, log_dir: str | Path | None = None):
        self.log_dir = Path(log_dir) if log_dir else None
        self._acc: dict[str, list[dict]] = defaultdict(list)

    # ---------------- collection ----------------

    def observe_intermediates(self, intermediates: dict, prefix: str = "fwd"):
        """Feed a nested dict of module outputs (leaves: tensors, arrays or
        tuples of them), as ``capture`` collects them."""
        self._walk(intermediates, prefix)

    def observe_grads(self, grads: dict, prefix: str = "grad"):
        self._walk(grads, prefix)

    def observe_params(self, params: dict, prefix: str = "param"):
        self._walk(params, prefix)

    @contextlib.contextmanager
    def capture(self, module: torch.nn.Module, prefix: str = "fwd"):
        """Forward hooks on every submodule of ``module`` for the ``with``
        block; each call's output is observed under the module's dotted
        name and ``__call__`` (flax's intermediates layout)."""
        outputs: dict[str, list] = defaultdict(list)

        def hook(name):
            def record(mod, args, out):
                outputs[name].append(out)
            return record

        handles = [m.register_forward_hook(hook(name))
                   for name, m in module.named_modules()]
        try:
            yield self
        finally:
            for h in handles:
                h.remove()
        tree: dict = {}  # flax's layout: a module's outputs under "__call__"
        for name, outs in outputs.items():
            node = tree
            for part in name.split(".") if name else ():
                node = node.setdefault(part, {})
            node["__call__"] = tuple(outs)
        self.observe_intermediates(tree, prefix)

    def _walk(self, node, name):
        if isinstance(node, dict):
            for k, v in node.items():
                self._walk(v, f"{name}.{k}")
        elif isinstance(node, (tuple, list)):
            for i, v in enumerate(node):
                suffix = "" if len(node) == 1 else f".{i}"
                self._walk(v, f"{name}{suffix}")
        elif hasattr(node, "shape"):
            self._acc[name].append(tensor_stats(_numpy(node)))

    # ---------------- reporting ----------------

    def table(self) -> list[dict]:
        """One row per observed name: ``name``, ``steps`` and each stat's
        percentiles across the observations (``rms_p50``, ...)."""
        rows = []
        for name, stats_list in sorted(self._acc.items()):
            row = {"name": name, "steps": len(stats_list)}
            for stat in STATS:
                vals = np.array([s[stat] for s in stats_list])
                for p in PERCENTILES:
                    row[f"{stat}_p{p}"] = float(np.percentile(vals, p))
            rows.append(row)
        return rows

    def save(self, iteration: int | None = None) -> Path | None:
        """Write ``log_dir/artifacts/diagnostic/<iteration, 6 digits>.csv``
        (global leader only; None without a ``log_dir``)."""
        if not is_global_leader() or self.log_dir is None:
            return None
        out_dir = self.log_dir / "artifacts" / "diagnostic"
        out_dir.mkdir(parents=True, exist_ok=True)
        path = out_dir / f"{iteration or 0:06d}.csv"
        rows = self.table()
        columns = ["name", "steps"] + [f"{s}_p{p}" for s in STATS for p in PERCENTILES]
        with open(path, "w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=columns)
            writer.writeheader()
            writer.writerows(rows)
        _logger.info(f"Saved diagnostic {path}")
        return path

    def clear(self):
        self._acc.clear()
