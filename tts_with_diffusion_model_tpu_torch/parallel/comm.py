"""The mesh's collectives, in one place, and the autograd functions that
tensor parallelism is built from (Megatron's f / g pairs).

Every collective runs over one mesh axis (an ``Axis``: the process group of
this rank's tp row or dp column).  All-gather and reduce-scatter are NCCL's
own calls (``all_gather_into_tensor``, ``reduce_scatter_tensor``) on every
backend: PyTorch's backend table lists only broadcast, all-reduce and
barrier for gloo on the GPU, but gloo took both for CUDA tensors on the
card (torch 2.11, two ranks sharing one H100; ``smoke_parallel.py`` probes
it there) and takes every collective on the CPU.  Sums of a tensor split
over tp run in fp32 whatever its dtype.

A data-parallel step's rows (``Rows``) are passed to the losses as an
argument: their draws are made for the global batch and their denominators
count it.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


class Axis:
    """One mesh axis as this rank sees it: the process group of its peers
    along the axis (None for an axis of size 1), their count and this
    rank's index among them."""

    def __init__(self, group, size: int, rank: int):
        self.group, self.size, self.rank = group, int(size), int(rank)

    def __repr__(self):
        return f"Axis(size={self.size}, rank={self.rank})"


def all_reduce(t: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Sum over the axis, in place (returns ``t``)."""
    if axis.size > 1:
        dist.all_reduce(t, group=axis.group)
    return t


def all_gather(t: torch.Tensor, axis: Axis, dim: int = 0):
    """The axis's blocks concatenated along ``dim``, rank order."""
    if axis.size == 1:
        return t
    x = t.movedim(dim, 0).contiguous()
    out = x.new_empty((axis.size * x.shape[0], *x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=axis.group)
    return out.movedim(0, dim)


def reduce_scatter(t: torch.Tensor, axis: Axis, dim: int = 0):
    """This rank's block (along ``dim``) of the axis's sum of ``t``."""
    if axis.size == 1:
        return t
    x = t.movedim(dim, 0).contiguous()
    out = x.new_empty((x.shape[0] // axis.size, *x.shape[1:]))
    dist.reduce_scatter_tensor(out, x, group=axis.group)
    return out.movedim(0, dim)


def _sum(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    return all_reduce(x.to(torch.float32, copy=True).contiguous(), axis).to(x.dtype)


class _CopyToTP(torch.autograd.Function):
    """f: identity forward, the axis's sum of the gradient backward (the
    input of a column-parallel layer)."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.axis), None


class _ReduceFromTP(torch.autograd.Function):
    """g: the axis's sum forward, identity backward (the output of a
    row-parallel layer, a vocab-parallel lookup)."""

    @staticmethod
    def forward(ctx, x, axis):
        return _sum(x, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromTP(torch.autograd.Function):
    """The axis's blocks concatenated along the last dim forward; this
    rank's block of the gradient backward (a vocab-parallel head's
    logits)."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis, ctx.n = axis, x.shape[-1]
        return all_gather(x, axis, dim=x.ndim - 1)

    @staticmethod
    def backward(ctx, g):
        r, n = ctx.axis.rank, ctx.n
        return g[..., r * n:(r + 1) * n].contiguous(), None


def copy_to(x, axis: Axis):
    return x if axis.size == 1 else _CopyToTP.apply(x, axis)


def reduce_from(x, axis: Axis):
    return x if axis.size == 1 else _ReduceFromTP.apply(x, axis)


def gather_from(x, axis: Axis):
    return x if axis.size == 1 else _GatherFromTP.apply(x, axis)


# ---------------- the data-parallel step's rows ----------------

class Rows:
    """This rank's rows of a data-parallel step: ``n`` rows from ``start``
    of a global batch of ``total``, split over the dp axis ``dp``.  The
    engine passes it to the loss (``rows=``); a loss gives it to
    ``draw_global`` and ``global_sum`` (where ``None`` means the batch is
    held whole), so a dp step computes what the 1×1 step computes on the
    whole batch."""

    def __init__(self, dp: Axis, n: int):
        self.dp, self.n = dp, int(n)
        self.start, self.total = dp.rank * self.n, dp.size * self.n

    def __repr__(self):
        return f"Rows({self.start}:{self.start + self.n} of {self.total})"


def draw_global(draw, n: int, rows: Rows | None = None) -> torch.Tensor:
    """``draw(k)`` (a random tensor with k leading rows, from the step's
    generator) made for the global batch and cut to this rank's ``n``
    rows: every rank draws alike, so dp changes no draw."""
    if rows is None:
        return draw(n)
    return draw(rows.total)[rows.start:rows.start + n]


def global_sum(t: torch.Tensor, rows: Rows | None = None) -> torch.Tensor:
    """A count (no gradient) summed over the dp step's ranks: the global
    denominator of a token-weighted mean."""
    if rows is None or rows.dp.size == 1:
        return t
    return all_reduce(t.detach().float().clone(), rows.dp).to(t.dtype)
