"""Collectives over a :class:`~.topology.Mesh` axis (the port of
``mmlspark_tpu/parallel/collectives.py``'s ring and reduction helpers).

Each takes per-rank tensors ``[n_hosted, ...]`` and a
:class:`~.topology.MeshAxis` where the JAX helpers take an axis name
inside ``shard_map``. On a hosted mesh they act on the leading
dimension, as reshapes and sums that autograd differentiates as they
are; under ``torch.distributed`` they send and reduce across processes,
each through a ``torch.autograd.Function`` of its own:

* :func:`ring_permute` — its gradient is the permute the other way (the
  transpose of ``ppermute``);
* :func:`all_to_all` — its gradient is the all-to-all the other way.

:func:`allreduce_sum` across processes gives a value only (a count, a
loss's or a statistic's total); where a sum carries a gradient, the
branch pair below does.

Across processes the JAX ``psum`` also has the two faces that
``shard_map``'s varying-type rules give it at a tensor-parallel
branch, Megatron's pair: :func:`enter_branch` (identity, its gradient
summed over the axis) where a value every rank holds alike meets
per-rank weights, and :func:`leave_branch` (the sum, its gradient
passed through) where the ranks' partial outputs meet. On a hosted
mesh the two are the identity and :func:`allreduce_sum`.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from mmlspark_tpu_torch.parallel.topology import MeshAxis


def axis_index(axis: MeshAxis) -> torch.Tensor:
    """Each hosted rank's coordinate on ``axis``: int64 [n_hosted]."""
    return axis.index()


def _send_recv(x: torch.Tensor, axis: MeshAxis, shift: int) -> torch.Tensor:
    """This process's ``x`` to the rank ``shift`` along ``axis``; the
    tensor from the rank ``shift`` before it back."""
    x = x.contiguous()
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, axis.neighbour(shift)),
           dist.P2POp(dist.irecv, out, axis.neighbour(-shift))]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _RingPermute(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, axis, shift):
        ctx.axis, ctx.shift = axis, shift
        return _send_recv(x, axis, shift)

    @staticmethod
    def backward(ctx, g):
        return _send_recv(g, ctx.axis, -ctx.shift), None, None


def ring_permute(x: torch.Tensor, axis: MeshAxis,
                 shift: int = 1) -> torch.Tensor:
    """Each rank's ``x`` moves ``shift`` steps along the ring of ``axis``
    (rank ``i`` -> ``i + shift`` mod n): the JAX ``ppermute`` with
    ``perm = [(i, (i + shift) % n)]``."""
    if axis.size == 1 or shift % axis.size == 0:
        return x
    if axis.mesh.hosted:
        return torch.roll(axis.grid(x), shift, dims=axis.pos).reshape(
            x.shape)
    return _RingPermute.apply(x, axis, shift)


def _all_reduce(x: torch.Tensor, axis: MeshAxis) -> torch.Tensor:
    out = x.detach().contiguous().clone()
    dist.all_reduce(out, group=axis.group)
    return out


class _EnterBranch(torch.autograd.Function):
    """Identity forward, the gradient summed over the axis (Megatron's
    ``f``)."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.axis), None


class _LeaveBranch(torch.autograd.Function):
    """The sum over the axis forward, the gradient passed through
    (Megatron's ``g``)."""

    @staticmethod
    def forward(ctx, x, axis):
        return _all_reduce(x, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


def allreduce_sum(x: torch.Tensor, axis: MeshAxis) -> torch.Tensor:
    """Every rank's ``x`` summed over ``axis`` (the JAX ``psum``): each
    rank gets the sum (differentiable on a hosted mesh; across processes
    a value, see the module docstring)."""
    if axis.size == 1:
        return x
    if axis.mesh.hosted:
        grid = axis.grid(x)
        return grid.sum(dim=axis.pos, keepdim=True).expand(
            grid.shape).reshape(x.shape)
    return _all_reduce(x, axis)


def enter_branch(x: torch.Tensor, axis: MeshAxis) -> torch.Tensor:
    """``x``, held alike by every rank of ``axis``, as the input of a
    branch whose ranks hold different weights or tokens: the identity,
    with its gradient summed over the axis across processes (so what
    produced ``x`` sees every rank's part of the gradient). The identity
    on a hosted mesh, where autograd sums the ranks' parts itself."""
    if axis.size == 1 or axis.mesh.hosted:
        return x
    return _EnterBranch.apply(x, axis)


def leave_branch(x: torch.Tensor, axis: MeshAxis) -> torch.Tensor:
    """The ranks' partial outputs ``x`` of such a branch summed over
    ``axis``: across processes the gradient passes through to each
    rank's part unchanged (every rank holds the whole cotangent of the
    sum); on a hosted mesh :func:`allreduce_sum`."""
    if axis.size == 1 or axis.mesh.hosted:
        return allreduce_sum(x, axis)
    return _LeaveBranch.apply(x, axis)


def allreduce_mean(x: torch.Tensor, axis: MeshAxis) -> torch.Tensor:
    """:func:`allreduce_sum` over the axis size (the JAX ``pmean``)."""
    return allreduce_sum(x, axis) / axis.size


def all_to_all(x: torch.Tensor, axis: MeshAxis, split_axis: int,
               concat_axis: int) -> torch.Tensor:
    """The JAX ``all_to_all(x, axis, split_axis, concat_axis,
    tiled=True)``: each rank splits its ``x`` (per-rank dims, without the
    leading hosted one) into ``axis.size`` chunks along ``split_axis``,
    sends chunk ``j`` to the rank at index ``j`` on ``axis``, and
    concatenates what it receives, in source-rank order, along
    ``concat_axis``. On a hosted mesh this is a reshape and a transpose
    over the ranks' leading dimension, which autograd differentiates as
    it is; across processes, sends and receives over the axis, whose
    gradient is the all-to-all the other way."""
    n = axis.size
    if n == 1:
        return x
    if not axis.mesh.hosted:
        return _AllToAll.apply(x, axis, split_axis, concat_axis)
    if x.shape[1 + split_axis] % n:
        raise ValueError(f"all_to_all: dim {split_axis} of the per-rank "
                         f"shape {tuple(x.shape[1:])} does not split over "
                         f"{axis.name}={n}")
    m = len(axis.mesh.shape)
    g = axis.grid(x)
    s = m + split_axis
    # the chunk index (the destination rank) beside the split dim, then
    # swapped with the mesh axis: the mesh axis now names the
    # destination and the chunk dim the source
    g = g.unflatten(s, (n, g.shape[s] // n)).transpose(axis.pos, s)
    c = concat_axis + (concat_axis >= split_axis)   # with the chunk dim
    dst = m + (c - 1 if c > split_axis else c)
    g = g.movedim(s, dst).flatten(dst, dst + 1)
    return g.reshape(x.shape[0], *g.shape[m:])


def _exchange(x: torch.Tensor, axis: MeshAxis, split_axis: int,
              concat_axis: int) -> torch.Tensor:
    """This process's [1, ...] ``x`` split along ``split_axis`` (per-rank
    dims), chunk ``j`` sent to the rank at index ``j`` on ``axis``, the
    chunks received concatenated in source order along ``concat_axis``."""
    n = axis.size
    if x.shape[1 + split_axis] % n:
        raise ValueError(f"all_to_all: dim {split_axis} of the per-rank "
                         f"shape {tuple(x.shape[1:])} does not split over "
                         f"{axis.name}={n}")
    mesh = axis.mesh
    me = list(mesh.coords(mesh.rank))
    chunks = [c.contiguous() for c in x.chunk(n, dim=1 + split_axis)]
    got = [torch.empty_like(chunks[0]) for _ in range(n)]
    ops = []
    for j in range(n):
        peer = mesh.rank_at(me[:axis.pos] + [j] + me[axis.pos + 1:])
        if peer == mesh.rank:
            got[j].copy_(chunks[j])
            continue
        ops += [dist.P2POp(dist.isend, chunks[j], peer),
                dist.P2POp(dist.irecv, got[j], peer)]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return torch.cat(got, dim=1 + concat_axis)


class _AllToAll(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, axis, split_axis, concat_axis):
        ctx.args = axis, split_axis, concat_axis
        return _exchange(x, axis, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        axis, split_axis, concat_axis = ctx.args
        return _exchange(g, axis, concat_axis, split_axis), None, None, None
