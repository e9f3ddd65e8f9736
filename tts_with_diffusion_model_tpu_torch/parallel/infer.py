"""Mesh-sharded inference (counterpart of ``parallel/infer.py`` in the JAX
package).

The first stage runs SPMD over a ``dp×tp`` mesh of processes:

  - ``dp``: request rows split over it, each rank running the whole
    sampler on its rows (no traffic inside the loop), and the outputs are
    gathered so every rank holds the whole batch;
  - ``tp``: heads / MLP hidden / vocab split over it (``mesh.shard_module``),
    each matmul's partial products summed over the row.

Outputs are dp-invariant by construction: every sampler draw comes from the
row's own key (``utils/rng.RowKeys``), and a rank takes its rows' keys, so a
request's tokens do not depend on how rows were split.  Under tp > 1 the
split reductions reassociate floating-point sums; tokens stay identical in
practice because sampling decisions have finite logit margins (held on the
CPU in ``tests/test_torch_parallel*.py`` and on the card by ``chip_smoke.py``).
"""

from __future__ import annotations

import torch

from ..utils.rng import RowKeys
from . import comm
from .mesh import shard_module


def shard_params(mesh, model):
    """Keep this rank's tp blocks of the model's parameters (in place), as
    the trainer does; call once at load."""
    return shard_module(model, mesh)


def _generate(model, *args, **kw):
    return model.generate(*args, **kw)


def make_sharded_generate(model, mesh, fn=_generate):
    """An SPMD sampler over the mesh: ``gen(text, text_mask, proms,
    prom_mask, keys, **kw)`` with the full batch on every rank (``keys``:
    ``RowKeys`` or one seed per row) runs ``fn(model, <this rank's rows>,
    <their keys>, **kw)`` (the D3PM's ancestral ``generate`` by default;
    ``lambda m, *a, **k: m.generate_maskgit(*a, **k)`` or the AR's
    ``ar_generate`` take the same form) and returns its output (a tensor or
    a tuple of them) gathered over dp, replicated on every rank.  The model
    must already be sharded (``shard_params``).  The batch must divide dp."""
    dp = mesh.dp

    def gen(text, text_mask, proms, prom_mask, keys, **kw):
        B = text.shape[0]
        if B % dp.size != 0:
            raise ValueError(
                f"batch {B} does not divide the dp mesh axis ({dp.size}); pad the "
                f"cohort to a multiple of dp"
            )
        keys = keys if isinstance(keys, RowKeys) else RowKeys.from_seeds(keys)
        n = B // dp.size
        rows = slice(dp.rank * n, (dp.rank + 1) * n)
        out = fn(model, text[rows], text_mask[rows], proms[rows], prom_mask[rows],
                 RowKeys(keys.keys[rows]), **kw)
        if isinstance(out, torch.Tensor):
            return comm.all_gather(out, dp, dim=0)
        return tuple(comm.all_gather(o, dp, dim=0) for o in out)

    return gen
