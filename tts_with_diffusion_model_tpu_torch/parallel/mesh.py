"""The dp×tp mesh of torch processes and its sharding rules (counterpart of
``parallel/mesh.py`` in the JAX package).

JAX lays a mesh over the devices one process drives
(``np.asarray(devices).reshape(dp, tp)``); here every device has a process
of its own, so the mesh is laid over the ranks of the process group the
same way: ``ranks.reshape(dp, tp)``.  A tp group is a row of consecutive
ranks, a dp group a column.

  - ``dp``: data parallelism.  Each rank takes ``batch // dp`` rows of the
    global batch and the gradients are summed over the column;
  - ``tp``: tensor parallelism.  The layers declare their own split, as
    the flax modules tag their logical axes: a layer with ``tp_plan(tp)``
    names the dimension of each of its parameters that splits
    (``heads`` / ``mlp`` / ``vocab``, mapped onto ``tp`` by
    ``LOGICAL_RULES``), and ``tp_shard(axis)`` switches it to its
    tensor-parallel forward (Megatron's column and row parallel layers,
    ``parallel/comm.py``'s f / g pairs), each rank holding its block.  A
    layer returns no split where tp does not divide the tagged dimension
    (JAX's ragged rule); a module with ``tp_replicate = True`` keeps its
    whole subtree replicated.

A world of one is a 1×1 mesh: the same code path, no collective.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..utils import distributed
from .comm import Axis, all_gather

# logical axis → mesh axis (a ``Split`` names one of the tp ones)
LOGICAL_RULES = (
    ("batch", "dp"),
    ("embed", None),
    ("heads", "tp"),
    ("mlp", "tp"),
    ("vocab", "tp"),
)


class Mesh:
    """This rank's view of a dp×tp mesh: ``shape`` {"dp", "tp"}, ``size``,
    its coordinates and the two axes' process groups (``dp``: the column,
    ``tp``: the row)."""

    def __init__(self, dp: Axis, tp: Axis, rank: int = 0):
        self.dp, self.tp, self.rank = dp, tp, rank
        self.shape = {"dp": dp.size, "tp": tp.size}
        self.size = dp.size * tp.size

    @property
    def coords(self) -> tuple[int, int]:
        return self.dp.rank, self.tp.rank

    def __repr__(self):
        return f"Mesh(dp={self.dp.size}, tp={self.tp.size}, rank={self.rank})"


def build_mesh(dp: int = -1, tp: int = 1) -> Mesh:
    """The mesh over the process group (``utils.distributed``): ``dp=-1``
    takes every rank tp leaves.  A mesh larger than the world raises; a
    mesh larger than 1×1 must cover it (every rank is in one place)."""
    n = distributed.world_size()
    if dp == -1:
        assert n % tp == 0, f"{n} devices not divisible by tp={tp}"
        dp = n // tp
    assert dp * tp <= n, (
        f"mesh dp={dp} x tp={tp} needs {dp * tp} devices but only {n} are "
        f"available ({distributed.backend() or 'no process group'}: one rank per device)"
    )
    rank = distributed.global_rank()
    if dp * tp == 1:
        return Mesh(Axis(None, 1, 0), Axis(None, 1, 0), rank)
    if dp * tp != n:
        raise ValueError(f"mesh dp={dp} x tp={tp} must cover all {n} ranks")
    import torch.distributed as dist

    ranks = np.arange(n).reshape(dp, tp)
    axes = {}
    # every rank creates every group, in one order
    for name, lines in (("tp", ranks), ("dp", ranks.T)):
        for line in lines:
            members = [int(r) for r in line]
            group = dist.new_group(members) if len(members) > 1 else None
            if rank in members:
                axes[name] = Axis(group, len(members), members.index(rank))
    return Mesh(axes["dp"], axes["tp"], rank)


# ---------------- parameter layout ----------------

@dataclasses.dataclass(frozen=True)
class Split:
    """How a parameter splits over tp: dimension ``dim`` of the port's
    tensor, tagged ``logical`` (as in the flax module); ``groups`` equal
    parts of that dimension split alike (the packed qkv projection: each
    rank takes its heads of q, of k and of v)."""

    dim: int
    logical: str
    groups: int = 1


def _layers(module, prefix: str = ""):
    """(parameter prefix, layer) of every layer that declares a split
    (``tp_plan``), outside the subtrees that replicate; a declaring layer
    speaks for its sub-layers."""
    if getattr(module, "tp_replicate", False):
        return
    if hasattr(module, "tp_plan"):
        yield prefix, module
        return
    for name, child in module.named_children():
        yield from _layers(child, f"{prefix}{name}.")


def _plans(model, tp: int):
    """(prefix, layer, its splits) of every layer that splits over ``tp``."""
    rules = dict(LOGICAL_RULES)
    for prefix, layer in _layers(model):
        plan = {n: s for n, s in layer.tp_plan(tp).items() if rules[s.logical] == "tp"}
        if plan:
            yield prefix, layer, plan


def param_shardings(mesh, model) -> dict[str, Split | None]:
    """Every parameter's tp split (None: replicated), by parameter name:
    the counterpart of the JAX package's resolution of the flax logical
    tags.  ``mesh`` is a ``Mesh`` or the tp degree.  A sharded model keeps
    the layout it was sharded with."""
    layout = getattr(model, "_tp_layout", None)
    if layout is not None:
        return dict(layout)
    tp = mesh if isinstance(mesh, int) else mesh.shape["tp"]
    out = {n: None for n, _ in model.named_parameters()}
    if tp > 1:
        for prefix, _, plan in _plans(model, tp):
            out.update({prefix + name: split for name, split in plan.items()})
    return out


def shard_tensor(t: torch.Tensor, split: Split, rank: int, tp: int) -> torch.Tensor:
    """Rank ``rank``'s block of a full tensor."""
    d = split.dim
    x = t.unflatten(d, (split.groups, tp, t.shape[d] // (split.groups * tp)))
    return x.select(d + 1, rank).flatten(d, d + 1).contiguous()


def unshard_tensor(blocks: torch.Tensor, split: Split, tp: int) -> torch.Tensor:
    """The full tensor from the ranks' blocks concatenated along the split
    dimension in rank order (``all_gather``)."""
    d = split.dim
    x = blocks.unflatten(d, (tp, split.groups, blocks.shape[d] // (split.groups * tp)))
    return x.transpose(d, d + 1).flatten(d, d + 2).contiguous()


def shard_module(model, mesh: Mesh):
    """Keep only this rank's block of every parameter that splits over tp
    and switch its layers to their tensor-parallel forward (in place;
    returns the model).  The attention layers then hold ``n_heads / tp``
    heads, which is what the kernels see."""
    tp = mesh.tp
    plans = list(_plans(model, tp.size)) if tp.size > 1 else []
    layout = param_shardings(tp.size, model)
    model._tp_layout, model._tp_axis = layout, tp
    params = dict(model.named_parameters())
    with torch.no_grad():
        for name, split in layout.items():
            if split is not None:
                params[name].data = shard_tensor(params[name].data, split, tp.rank, tp.size)
    for _, layer, _ in plans:
        layer.tp_shard(tp)
    return model


def full_tensor(model, name: str, t: torch.Tensor) -> torch.Tensor:
    """The full value of parameter ``name`` (or of a tensor laid out like
    it: a moment, an EMA copy) from this rank's block: gathered over tp
    (every rank of the row calls it), or ``t`` itself when it replicates."""
    split = param_shardings(1, model).get(name)
    axis = getattr(model, "_tp_axis", None)
    if split is None or axis is None or axis.size == 1:
        return t
    return unshard_tensor(all_gather(t, axis, dim=split.dim), split, axis.size)


def local_tensor(model, name: str, full: torch.Tensor) -> torch.Tensor:
    """This rank's block of a full tensor laid out like parameter ``name``
    (the inverse of ``full_tensor``: restoring a checkpoint written under
    another mesh)."""
    split = param_shardings(1, model).get(name)
    axis = getattr(model, "_tp_axis", None)
    if split is None or axis is None or axis.size == 1:
        return full
    return shard_tensor(full, split, axis.rank, axis.size)


def full_state_dict(model) -> dict[str, torch.Tensor]:
    """``model.state_dict()`` with every split parameter gathered to its full
    value (every rank of a tp row calls it)."""
    return {k: full_tensor(model, k, v) for k, v in model.state_dict().items()}


def zero1_shardings(mesh, model, names=None) -> dict[str, int | None]:
    """ZeRO-1's layout of the optimizer moments: each parameter's moments
    (this rank's tp block of them) split over dp on their first dimension
    that dp divides and tp does not already split; scalars and ragged
    leaves replicate (None).  On a dp×tp mesh the moments end up split over
    both axes, never worse than either alone.  ``names`` restricts it to
    some parameters (the trained ones)."""
    dp = mesh if isinstance(mesh, int) else mesh.shape["dp"]
    layout = param_shardings(1, model)
    out = {}
    for name, p in model.named_parameters():
        if names is not None and name not in names:
            continue
        split = layout.get(name)
        out[name] = None
        if dp > 1:
            for i, d in enumerate(p.shape):
                if (split is None or split.dim != i) and d > 0 and d % dp == 0:
                    out[name] = i
                    break
    return out



def shard_batch(batch: dict, mesh: Mesh) -> dict:
    """This rank's dp rows of a global batch (numpy arrays or tensors with a
    batch axis; other entries pass through).  Raises a clear error when the
    batch does not divide the dp axis."""
    dp = mesh.dp
    out = {}
    for k, v in batch.items():
        if hasattr(v, "shape") and getattr(v, "ndim", 0) >= 1:
            if v.shape[0] % dp.size != 0:
                raise ValueError(
                    f"batch axis of '{k}' has size {v.shape[0]}, which is not "
                    f"divisible by the dp mesh axis ({dp.size}); pick a batch_size "
                    f"that is a multiple of dp"
                )
            n = v.shape[0] // dp.size
            out[k] = v[dp.rank * n:(dp.rank + 1) * n]
        else:
            out[k] = v
    return out
