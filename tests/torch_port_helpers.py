"""Shared helpers of the PyTorch port's parity tests (``test_torch_*.py``):
flax parameter trees as flat numpy dicts, seeded perturbation of zero-init
parameters, and injected noise tables shared by both packages."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn


def flatten(tree, prefix="") -> dict[str, np.ndarray]:
    out = {}
    tree = nn.meta.unbox(tree)
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(flatten(v, key))
        else:
            out[key] = np.asarray(v, np.float32)
    return out


def unflatten(flat: dict[str, np.ndarray]) -> dict:
    tree: dict = {}
    for k, v in flat.items():
        node = tree
        parts = k.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = jnp.asarray(v)
    return tree


def perturbed(params, seed: int, scale: float = 0.1) -> dict[str, np.ndarray]:
    """Flat params plus seeded noise, so zero-initialised tables (AdaLN,
    biases, the timestep FiLM) take part in the comparison."""
    rs = np.random.RandomState(seed)
    return {k: (v + scale * rs.randn(*v.shape)).astype(np.float32)
            for k, v in flatten(params).items()}


def seeded_flax_params(module: torch.nn.Module, seed: int, scale: float = 0.1) -> dict:
    """Flat flax parameters (``params/...`` keys) for ``module``'s JAX
    counterpart, without a flax init: the port's seeded weights carried over
    by ``torch_params_to_jax``, plus seeded noise so zero-initialised tables
    take part."""
    from tts_with_diffusion_model_tpu_torch.convert import init_seeded, torch_params_to_jax

    init_seeded(module, seed)
    rs = np.random.RandomState(seed + 1)
    return {f"params/{k}": (v + scale * rs.randn(*v.shape)).astype(np.float32)
            for k, v in torch_params_to_jax(module).items()}


def t(a, dtype=None):
    """numpy → torch (CPU)."""
    x = torch.from_numpy(np.ascontiguousarray(a))
    return x.to(dtype) if dtype is not None else x


class TableKeys:
    """Port-side stand-in for ``RowKeys``: ``fold(tag)`` selects a tag and
    ``gumbel(shape)`` / ``uniform(shape)`` / ``normal(shape)`` return the
    table's noise for it,
    so both packages sample from the same numbers.  Tables are keyed by
    (tag, rank) and hold (B, *shape) arrays."""

    def __init__(self, tables: dict, tag=None):
        self.tables, self.tag = tables, tag

    def fold(self, tag):
        return TableKeys(self.tables, int(tag))

    def gumbel(self, shape, device="cpu"):
        arr = self.tables[(self.tag, len(shape))]
        assert arr.shape[1:] == tuple(shape), (self.tag, arr.shape, shape)
        return torch.from_numpy(arr).to(device)

    uniform = normal = gumbel


def patch_jax_noise(monkeypatch, module, tables: dict):
    """Make ``module``'s ``fold_rows`` carry the tag and its ``row_gumbel``,
    ``row_uniform`` and ``row_normal`` return the same table as ``TableKeys`` (traced tags,
    a MaskGIT step, an ancestral timestep or a speculative round's, index a
    table stacked over tags, so this also works inside ``lax.scan`` and
    ``lax.while_loop``).  Tables are stacked by the shape of one row's draw,
    so draws of one rank and different shapes (the speculative loop's
    Gumbel noise (V,) and acceptance uniforms (k,)) each find their own.
    Functions jitted before the patch keep their traces: clear JAX's caches
    (``jax.clear_caches()``) around a patched call of one."""
    by_shape: dict[tuple, list] = {}
    for (tag, rank), arr in sorted(tables.items()):
        by_shape.setdefault(arr.shape[1:], []).append((tag, arr))
    stacked = {}
    for shape, items in by_shape.items():
        n = max(tag for tag, _ in items) + 1
        full = np.zeros((n, items[0][1].shape[0], *shape), np.float32)
        for tag, arr in items:
            full[tag] = arr
        stacked[shape] = jnp.asarray(full)

    def fold_rows(row_keys, tag):
        B = row_keys.shape[0]
        return jnp.stack([jnp.full((B,), tag, jnp.int32), jnp.arange(B, dtype=jnp.int32)], 1)

    def row_gumbel(row_keys, shape, dtype=jnp.float32):
        return stacked[tuple(shape)][row_keys[0, 0]].astype(dtype)

    monkeypatch.setattr(module, "fold_rows", fold_rows)
    monkeypatch.setattr(module, "row_gumbel", row_gumbel)
    for name in ("row_uniform", "row_normal"):
        if hasattr(module, name):
            monkeypatch.setattr(module, name, row_gumbel)


@pytest.fixture(scope="module")
def small_codec():
    """A seeded tiny codec on the CPU, for ``encodec.load_codec`` in tests
    that decode audio (the full codec on the CPU would dominate them)."""
    from tts_with_diffusion_model_tpu_torch import smoke
    from tts_with_diffusion_model_tpu_torch.codec.encodec import Codec
    from tts_with_diffusion_model_tpu_torch.convert import init_seeded

    model = smoke.tiny_models()[3]
    init_seeded(model, 2)
    return Codec(model, "cpu")


@pytest.fixture
def one_thread(monkeypatch):
    """One intra-op thread for the test, and ``OMP_NUM_THREADS=1`` for the
    processes it starts: tiny models run thousands of small ops, and beside
    the other test workers more threads only contend for the cores."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
