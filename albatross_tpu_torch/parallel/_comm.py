"""Collectives of the row-sharded layout, with their gradients.

A distributed computation here is SPMD, as a ``shard_map`` body is: every
rank runs the same code on its own rows ("varying" values) and on values
that every rank holds whole ("replicated" values), and a loss is
replicated.  Each rank runs its own backward pass.  For it to give every
rank the whole gradient, a replicated value's cotangent on each rank must
be the whole cotangent, which these Functions keep (JAX's ``shard_map``
transposes its collectives the same way):

* ``all_reduce_sum`` (``psum``, varying -> replicated): the backward is
  the identity on the replicated cotangent;
* ``gather_rows`` (``all_gather``, varying -> replicated): the backward
  takes this rank's slice of the cotangent;
* ``vary`` (a replicated value used in this rank's own rows): the
  forward is the identity, the backward sums the cotangent over the ranks,
  since each rank's rows add their own part of it.

A backward collective runs only if every rank reaches it, so ``tie``
gives each replicated value a rank leaves unused a zero cotangent, and
``zeros`` stands in for a block a rank does not own with a graph that
reaches the same inputs as the owner's block (``torch.autograd.grad``
runs only the nodes on a path to the inputs it is asked for): every rank
then runs the same collectives in the same order.  The all-gather
is an all-reduce of a zero-padded buffer (as the JAX package's masked
``psum``): NCCL and gloo, on CPU and CUDA tensors, take ``all_reduce``,
and a sum of one value and zeros is exact.  On a world of one rank every
collective is skipped.

The 2-D tile layout runs the same Functions over the two dimension groups
of a 2-D mesh: a value may vary over the row group, the column group, both
or neither, and ``all_reduce_sum``, ``vary``, ``zeros`` and ``tie`` take one
axis or a sequence of axes (applied in that order; ``vary``'s backward
sums in the reverse order).  ``vary`` goes exactly where a value that is
the same along an axis first meets one that varies along it, as JAX's
varying-axes inference inserts ``pvary``: a rank-dependent slice or mask,
or arithmetic with a varying value.  The tile code keeps the graph the
same on every rank (``torch.where`` over a rank's ownership, never a
Python branch, while autograd records), so every rank of each group
reaches the same backward collectives in the same order.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Axis:
    """One named dimension of a mesh, as this rank sees it."""

    group: object  # the dimension's ProcessGroup
    rank: int
    size: int


def mesh_axis(mesh, axis: str) -> Axis:
    names = getattr(mesh, "mesh_dim_names", None) or ()
    if axis not in names:
        raise ValueError(f"mesh has no axis {axis!r}; its axes are {names}")
    dim = names.index(axis)
    return Axis(mesh.get_group(axis), mesh.get_local_rank(axis), mesh.size(dim))


def _all_reduce(x: torch.Tensor, ax: Axis) -> torch.Tensor:
    out = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, group=ax.group)
    return out


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        return _all_reduce(x, ax)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Vary(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.ax), None


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, first, b):
        ctx.slot = ax.rank - first
        buf = x.new_zeros(((ax.size - first) * b, *x.shape[1:]))
        if ctx.slot >= 0:
            buf[ctx.slot * b:(ctx.slot + 1) * b] = x
        ctx.b = b
        dist.all_reduce(buf, group=ax.group)
        return buf

    @staticmethod
    def backward(ctx, g):
        if ctx.slot < 0:
            return g.new_zeros((0, *g.shape[1:])), None, None, None
        return g[ctx.slot * ctx.b:(ctx.slot + 1) * ctx.b], None, None, None


class _Zeros(torch.autograd.Function):
    @staticmethod
    def forward(ctx, shape, like, *anchors):
        ctx.metas = [(a.shape, a.dtype, a.device) for a in anchors]
        return like.new_zeros(shape)

    @staticmethod
    def backward(ctx, g):
        return (None, None, *(torch.zeros(s, dtype=t, device=d) for s, t, d in ctx.metas))


class _Tie(torch.autograd.Function):
    @staticmethod
    def forward(ctx, out, *deps):
        ctx.metas = [(d.shape, d.dtype, d.device) for d in deps]
        return out.view_as(out)

    @staticmethod
    def backward(ctx, g):
        return (g, *(torch.zeros(s, dtype=t, device=d) for s, t, d in ctx.metas))


def _axes(ax) -> tuple:
    return (ax,) if isinstance(ax, Axis) else tuple(ax)


def _alone(ax) -> bool:
    return all(a.size == 1 for a in _axes(ax))


def all_reduce_sum(x: torch.Tensor, ax) -> torch.Tensor:
    """The sum over the axis' ranks of each rank's ``x`` (replicated over
    the axis); over each of a sequence of axes in turn."""
    for a in _axes(ax):
        if a.size > 1:
            x = _AllReduceSum.apply(x, a)
    return x


def vary(x: torch.Tensor, ax) -> torch.Tensor:
    """``x``, replicated over the axis (or each of a sequence of axes),
    marked as entering this rank's own share of the computation."""
    for a in _axes(ax):
        if a.size > 1:
            x = _Vary.apply(x, a)
    return x


def gather_rows(x, ax: Axis, b: int, first: int = 0) -> torch.Tensor:
    """The row blocks of ranks first..size-1 stacked, on every rank: rank
    r >= first gives its (b, ...) block ``x``; a rank below ``first``
    gives an empty (0, ...) tensor of the same trailing shape."""
    if ax.size == 1:
        return x
    return _GatherRows.apply(x, ax, first, b)


def gather_cols(x: torch.Tensor, ax: Axis) -> torch.Tensor:
    """The column blocks of every rank of the axis side by side (JAX's
    tiled ``all_gather`` along axis 1), on every rank."""
    if ax.size == 1:
        return x
    return _GatherRows.apply(x.mT, ax, 0, x.shape[1]).mT


def zeros(shape, like: torch.Tensor, anchors, ax) -> torch.Tensor:
    """Zeros of ``shape`` (``like``'s dtype and device) standing in for a
    block another rank computes from ``anchors``: when any anchor requires
    grad, so does the result, through a node whose backward gives each
    anchor a zero cotangent."""
    anchors = [a for a in anchors if a is not None and a.requires_grad]
    if _alone(ax) or not anchors or not torch.is_grad_enabled():
        return like.new_zeros(shape)
    return _Zeros.apply(tuple(shape), like, *anchors)


def tie(out: torch.Tensor, deps, ax) -> torch.Tensor:
    """``out``, with a zero cotangent for each of ``deps`` that requires
    grad, so that their backward collectives run on this rank too."""
    deps = [d for d in deps if d is not None and d.requires_grad]
    if _alone(ax) or not deps or not torch.is_grad_enabled():
        return out
    return _Tie.apply(out, *deps)
