"""Collectives over the axes of a mesh (the port's counterpart of the
``jax.lax`` collectives that the reference's ``shard_map`` routes call).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh``
(:mod:`repro_torch.launch.mesh`); ``axes`` is one of its dimension names
or a tuple of them, such as the batch axes ``("pod", "data")``, which
act as one axis over the flattened sub-mesh (:func:`axis_group`), rows
before columns, as ``gnn.py`` numbers the shards.

The autograd Functions follow JAX's transposes under ``shard_map``:

- :func:`psum_scatter`: ``reduce_scatter`` tiled on dim 0; backward
  :func:`all_gather`;
- :func:`all_gather`: tiled on ``dim``; backward :func:`psum_scatter`;
- :func:`psum`: ``all_reduce``; the cotangent goes back to each rank
  unchanged (``torch.distributed.nn.functional.all_reduce`` sums it
  again, which is not JAX's rule);
- :func:`pmean`: the mean over the ranks; backward the cotangent over
  the rank count;
- :func:`pmax`: ``all_reduce(MAX)``, no gradient;
- :func:`pvary`: the identity; backward a sum over the ranks. JAX inserts
  it where a value replicated over ``axes`` meets one that varies over
  them; the port states it where the expert-parallel MoE takes its
  replicated tokens and router.

Every call reaches the process group, also on an axis of one rank: a
world of one runs the same collectives as a larger one.

On a :class:`~repro_torch.launch.mesh.MetaMesh` (the dry run's rank 0 of
a production mesh, no process group) a collective of a ``meta`` tensor
returns a meta tensor of the right shape and reaches no group (any other
tensor raises ``ValueError``); it adds
its output bytes and one op to its kind's tally (``all-gather``,
``reduce-scatter``, ``all-reduce``), as the reference's
``collective_bytes`` sums the output shapes of the post-SPMD HLO's
collectives. :func:`collective_counts` reads the tally.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

# the names torch 2.13 gives these two; older releases have only the
# deprecated ones, with the same signature
_reduce_scatter = getattr(dist, "reduce_scatter_single",
                          dist.reduce_scatter_tensor)
_all_gather = getattr(dist, "all_gather_single",
                      dist.all_gather_into_tensor)


_TALLY: dict[str, dict[str, int]] = {"bytes_by_kind": {},
                                     "ops_by_kind": {}}


class MetaGroup:
    """The stand-in of an axis group on a meta mesh: its rank count."""

    def __init__(self, size: int):
        self.size = size


def collective_counts() -> dict:
    """The meta collectives since :func:`reset_collective_counts`: bytes
    and ops by kind and their total bytes (the reference's
    ``collective_bytes`` record)."""
    return {"bytes_by_kind": dict(_TALLY["bytes_by_kind"]),
            "ops_by_kind": dict(_TALLY["ops_by_kind"]),
            "total_bytes": sum(_TALLY["bytes_by_kind"].values())}


def reset_collective_counts() -> None:
    for d in _TALLY.values():
        d.clear()


def _count(kind: str, out: torch.Tensor) -> torch.Tensor:
    by, ops = _TALLY["bytes_by_kind"], _TALLY["ops_by_kind"]
    by[kind] = by.get(kind, 0) + out.numel() * out.element_size()
    ops[kind] = ops.get(kind, 0) + 1
    return out


def _on_meta(x: torch.Tensor, group) -> bool:
    """Whether ``group`` is a :class:`MetaGroup`; one takes meta tensors
    only (a real tensor would get uninitialized memory or an unreduced
    value), and raises ``ValueError`` on any other."""
    if not isinstance(group, MetaGroup):
        return False
    if not x.is_meta:
        raise ValueError(f"a meta mesh's collective takes meta tensors, got "
                         f"one on {x.device}")
    return True


def _size(group) -> int:
    if isinstance(group, MetaGroup):
        return group.size
    return dist.get_world_size(group)


def _names(axes) -> tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def axis_size(mesh, axes) -> int:
    """The number of ranks along ``axes`` (1 for an empty tuple)."""
    names = mesh.mesh_dim_names
    return math.prod(mesh.shape[names.index(a)] for a in _names(axes))


def axis_index(mesh, axes) -> int:
    """This rank's index along ``axes``, row-major over a tuple (the
    reference's ``idx * mesh.shape[ax] + axis_index(ax)``)."""
    idx = 0
    names = mesh.mesh_dim_names
    for a in _names(axes):
        idx = idx * mesh.shape[names.index(a)] + mesh.get_local_rank(a)
    return idx


def axis_group(mesh, axes):
    """The process group of ``axes``: the mesh dimension's group for one
    name, the flattened sub-mesh's for a tuple (created once and kept by
    the mesh); a :class:`MetaGroup` on a meta mesh."""
    names = _names(axes)
    if not names:
        raise ValueError("axis_group: no axes")
    if getattr(mesh, "is_meta", False):
        return MetaGroup(axis_size(mesh, names))
    if len(names) == 1:
        return mesh.get_group(names[0])
    return mesh[names]._flatten().get_group()


def _rs(x: torch.Tensor, group) -> torch.Tensor:
    n = _size(group)
    if x.shape[0] % n:
        raise ValueError(f"psum_scatter: dim 0 of {tuple(x.shape)} is not "
                         f"divisible by {n} ranks")
    out = x.new_empty((x.shape[0] // n, *x.shape[1:]))
    if _on_meta(x, group):
        return _count("reduce-scatter", out)
    _reduce_scatter(out, x.contiguous(), group=group)
    return out


def _ag(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    n = _size(group)
    x = x.movedim(dim, 0).contiguous()
    out = x.new_empty((x.shape[0] * n, *x.shape[1:]))
    if _on_meta(x, group):
        return _count("all-gather", out).movedim(0, dim)
    _all_gather(out, x, group=group)
    return out.movedim(0, dim)


def _own(x: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``x``: a collective reduces raw memory, so
    every rank must lay its operand out alike (one rank's permuted view
    would meet another's rows)."""
    return x.detach().clone(memory_format=torch.contiguous_format)


def _ar(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``x`` (contiguous) reduced over ``group`` in place."""
    if not x.is_contiguous():
        raise ValueError("a collective reduces a contiguous tensor")
    if _on_meta(x, group):
        return _count("all-reduce", x)
    dist.all_reduce(x, op=op, group=group)
    return x


def _rs_dim(g: torch.Tensor, group, dim: int) -> torch.Tensor:
    return _rs(g.movedim(dim, 0), group).movedim(0, dim)


class _PsumScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _rs(x, group)

    @staticmethod
    def backward(ctx, g):
        return _ag(g, ctx.group, 0), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _ag(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _rs_dim(g, ctx.group, ctx.dim), None, None


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _ar(_own(x), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Pmean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.n = _size(group)
        return _ar(_own(x), group) / ctx.n

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


class _Pvary(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _ar(_own(g), ctx.group), None


def psum_scatter(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """The sum over ``axes`` of ``x`` [R, ...], each rank keeping its
    [R / n, ...] tile of dim 0 (``lax.psum_scatter(..., tiled=True)``)."""
    return _PsumScatter.apply(x, axis_group(mesh, axes))


def all_gather(x: torch.Tensor, mesh, axes, dim: int = 0) -> torch.Tensor:
    """The ranks' ``x`` concatenated on ``dim`` in rank order along
    ``axes`` (``lax.all_gather(..., tiled=True)``)."""
    return _AllGather.apply(x, axis_group(mesh, axes), dim)


def psum(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """The sum over ``axes`` (``lax.psum``)."""
    return _Psum.apply(x, axis_group(mesh, axes))


def pmean(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """The mean over ``axes`` (``lax.pmean``)."""
    return _Pmean.apply(x, axis_group(mesh, axes))


def pmax(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """The elementwise maximum over ``axes`` (``lax.pmax``); no
    gradient."""
    return _ar(_own(x), axis_group(mesh, axes), dist.ReduceOp.MAX)


def all_reduce_(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """``x`` summed over ``axes`` in place, outside autograd (the train
    step's gradient all-reduce and ``global_norm``'s sums); a
    non-contiguous ``x`` (a gradient through ``psum_scatter``'s backward
    on a dim past 0) through a contiguous copy."""
    if x.is_contiguous():
        return _ar(x, axis_group(mesh, axes))
    return x.copy_(_ar(_own(x), axis_group(mesh, axes)))


def pvary(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """``x`` as it is, its gradient summed over ``axes`` (``lax.pvary``)."""
    return _Pvary.apply(x, axis_group(mesh, axes))
