"""Collectives over one axis of a :class:`~repro_torch.parallel.sharding.ProcessMesh`,
as ``torch.autograd.Function``s (Megatron's idiom).

* :func:`all_gather` concatenates the ranks' tensors along a dimension;
  its backward is a reduce-scatter;
* :func:`reduce_scatter` sums the ranks' tensors and keeps this rank's
  slice of a dimension; its backward is an all-gather;
* :func:`all_reduce` sums the ranks' tensors; its backward is an
  all-reduce (``max``, used on values that carry no gradient, has none);
* :func:`redistribute` moves a tensor between two layouts by gathers and
  slices, optionally cast first to another dtype, its gradient then
  summed in the tensor's own.

These are the transposes that ``jax.lax.all_gather``, ``psum_scatter``
and ``psum`` have in a ``shard_map`` body, so the port keeps JAX's
convention for cotangents: a tensor replicated over an axis holds, on
each rank, a part of its cotangent, and the parts sum to the whole.
The loss is replicated over every rank, so its cotangent is split among
them (``repro_torch.train.steps.loss_and_grads``), and a param replicated
over an axis is summed over it once its gradient is complete.

Each call counts the bytes it moved on ``mesh.comm_bytes`` by
(operation, axis): an all-gather's output, a reduce-scatter's input, an
all-reduce's tensor.  An axis of size 1 moves nothing and counts nothing.

The route is the backend's: NCCL where every rank has a card of its
own, gloo where ranks share one (NCCL refuses two ranks on one device)
or run on the CPU.  Gloo's all-reduce, all-gather into a tensor and
reduce-scatter of a tensor all take CUDA tensors (fp32 and bf16, found
on an H100 with torch 2.11; gloo copies through the host itself), so
both backends are handed the tensors where they lie.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from .sharding import ProcessMesh

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def _gather(x: torch.Tensor, mesh: ProcessMesh, axis: str, dim: int) -> torch.Tensor:
    n = mesh.axis_size(axis)
    xt = x.movedim(dim, 0).contiguous()
    out = torch.empty((n * xt.shape[0],) + tuple(xt.shape[1:]), dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, xt, group=mesh.groups[axis])
    mesh.count("all_gather", axis, _nbytes(out))
    return out.movedim(0, dim)


def _scatter(x: torch.Tensor, mesh: ProcessMesh, axis: str, dim: int,
             dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Reduce-scatter in ``dtype`` (``x``'s by default; a cast is made in
    the same copy that lays ``dim`` out first)."""
    n = mesh.axis_size(axis)
    if x.shape[dim] % n:
        raise ValueError(f"reduce-scatter of dim {dim} ({x.shape[dim]}) over {axis} ({n})")
    xt = x.movedim(dim, 0).to(dtype or x.dtype, memory_format=torch.contiguous_format)
    out = torch.empty((xt.shape[0] // n,) + tuple(xt.shape[1:]), dtype=xt.dtype, device=x.device)
    dist.reduce_scatter_tensor(out, xt, group=mesh.groups[axis])
    mesh.count("reduce_scatter", axis, _nbytes(xt))
    return out.movedim(0, dim)


def _reduce(x: torch.Tensor, mesh: ProcessMesh, axis: str, op: str = "sum") -> torch.Tensor:
    out = x.contiguous().clone()
    dist.all_reduce(out, op=_OPS[op], group=mesh.groups[axis])
    mesh.count("all_reduce", axis, _nbytes(out))
    return out


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.args = (mesh, axis, dim)
        return _gather(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return _scatter(g, *ctx.args), None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.args = (mesh, axis, dim)
        return _scatter(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, *ctx.args), None, None, None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.args = (mesh, axis)
        return _reduce(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return _reduce(g, *ctx.args), None, None


def all_gather(x: torch.Tensor, mesh: ProcessMesh, axis: str, dim: int) -> torch.Tensor:
    """Concatenate every rank's ``x`` along ``dim``, in the order of their
    coordinates on ``axis`` (``jax.lax.all_gather(..., tiled=True)``)."""
    if mesh.axis_size(axis) == 1:
        return x
    return _AllGather.apply(x, mesh, axis, dim)


def reduce_scatter(x: torch.Tensor, mesh: ProcessMesh, axis: str, dim: int) -> torch.Tensor:
    """The sum of every rank's ``x``, cut into ``|axis|`` chunks along
    ``dim``; this rank keeps chunk ``axis_index(axis)``
    (``jax.lax.psum_scatter(..., tiled=True)``)."""
    if mesh.axis_size(axis) == 1:
        return x
    return _ReduceScatter.apply(x, mesh, axis, dim)


def all_reduce(x: torch.Tensor, mesh: ProcessMesh, axis: str, op: str = "sum") -> torch.Tensor:
    """The sum (or, without a gradient, the max) of every rank's ``x``."""
    if mesh.axis_size(axis) == 1:
        return x
    if op == "sum":
        return _AllReduce.apply(x, mesh, axis)
    if x.requires_grad:
        raise ValueError(f"all_reduce({op!r}) has no gradient; pass a detached tensor")
    return _reduce(x, mesh, axis, op)


def take(x: torch.Tensor, mesh: ProcessMesh, axis: str, dim: int) -> torch.Tensor:
    """This rank's chunk of ``dim`` when it is split evenly over ``axis``:
    replicated -> sharded, with no communication (its backward pads the
    chunk's gradient with zeros)."""
    n = mesh.axis_size(axis)
    if n == 1:
        return x
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} ({x.shape[dim]}) does not split evenly over {axis} ({n})")
    chunk = x.shape[dim] // n
    return x.narrow(dim, mesh.axis_index(axis) * chunk, chunk)


def _pad(g: torch.Tensor, mesh: ProcessMesh, axis: str, dim: int) -> torch.Tensor:
    """The transpose of :func:`take`: ``g`` at this rank's chunk of a
    dimension ``|axis|`` times longer, zeros elsewhere."""
    n = mesh.axis_size(axis)
    shape = list(g.shape)
    shape[dim] *= n
    out = g.new_zeros(shape)
    out.narrow(dim, mesh.axis_index(axis) * g.shape[dim], g.shape[dim]).copy_(g)
    return out


def _moves(mesh: ProcessMesh, src: tuple, dst: tuple) -> tuple[list, list]:
    """:func:`redistribute`'s moves, as (axis, dim) pairs on axes above
    size 1: the gathers (per dimension, the axes past the two layouts'
    common prefix, minor first), then the takes (the axes ``dst`` adds,
    major first)."""
    gathers, takes = [], []
    for i, (s, d) in enumerate(zip(src, dst)):
        k = 0
        while k < min(len(s), len(d)) and s[k] == d[k]:
            k += 1
        gathers += [(ax, i) for ax in reversed(s[k:]) if mesh.axis_size(ax) > 1]
        takes += [(ax, i) for ax in d[k:] if mesh.axis_size(ax) > 1]
    return gathers, takes


class _CastRedistribute(torch.autograd.Function):
    """``x`` cast to ``dtype``, then redistributed; the backward casts the
    cotangent back to ``x``'s dtype before it takes the moves'
    transposes, so the reduce-scatters sum in ``x``'s dtype."""

    @staticmethod
    def forward(ctx, x, mesh, src, dst, dtype):
        gathers, takes = _moves(mesh, src, dst)
        ctx.args = (mesh, gathers, takes, x.dtype)
        y = x.to(dtype)
        for ax, i in gathers:
            y = _gather(y, mesh, ax, i)
        for ax, i in takes:
            y = take(y, mesh, ax, i)
        return y

    @staticmethod
    def backward(ctx, g):
        mesh, gathers, takes, dtype = ctx.args
        for ax, i in reversed(takes):
            g = _pad(g, mesh, ax, i)       # zeros: exact in either dtype
        for ax, i in reversed(gathers):
            g = _scatter(g, mesh, ax, i, dtype)
        return g.to(dtype), None, None, None, None


def redistribute(x: torch.Tensor, mesh: ProcessMesh, src: tuple, dst: tuple,
                 dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Move a local tensor from layout ``src`` to layout ``dst`` (per
    dimension, the tuple of mesh axes that split it, major first): on each
    dimension the axes past the two layouts' common prefix are gathered,
    minor first, and then the axes ``dst`` adds are taken, major first.
    Every gather comes before every slice, so an axis may move from one
    dimension to another.

    With a ``dtype`` other than ``x``'s, ``x`` is cast to it first, so the
    gathers move that dtype, while the gradient comes back in ``x``'s:
    its reduce-scatters sum in ``x``'s dtype (the fp32 masters' gradients
    are summed over the ranks in fp32)."""
    if dtype is not None and dtype != x.dtype:
        return _CastRedistribute.apply(x, mesh, src, dst, dtype)
    gathers, takes = _moves(mesh, src, dst)
    for ax, i in gathers:
        x = all_gather(x, mesh, ax, i)
    for ax, i in takes:
        x = take(x, mesh, ax, i)
    return x


def sum_over(x: torch.Tensor, mesh: ProcessMesh, axes) -> torch.Tensor:
    """``x`` summed over each of ``axes`` in turn (no gradient kept)."""
    for ax in axes:
        if mesh.axis_size(ax) > 1:
            x = _reduce(x, mesh, ax)
    return x
