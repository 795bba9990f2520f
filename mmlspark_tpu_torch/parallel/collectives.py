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

On a mixed mesh (several processes, each hosting several ranks) an axis
has a hosted part and a part across processes: an axis wholly inside the
processes acts as on a hosted mesh, one wholly across them as one rank
per process (each hosted rank meets the ranks at its own place in the
other processes, so whole ``[n_hosted, ...]`` blocks travel), and an
axis split between the two gathers its across part over the axis's
group (:func:`gather_axis`), acts on the whole axis as a hosted mesh
does, and keeps this process's block.

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

gloo takes CUDA tensors in ``all_reduce`` and ``broadcast`` only; two
processes that share one card meet over gloo, so every collective here
stages a CUDA tensor through a host copy under gloo (:func:`on_wire`):
the computation stays on the card, only the exchange crosses the host.
"""

from __future__ import annotations

from typing import List

import torch
import torch.distributed as dist

from mmlspark_tpu_torch.parallel.topology import MeshAxis


def on_wire(x: torch.Tensor, group=None) -> torch.Tensor:
    """``x`` as a collective of ``group``'s backend takes it: a host copy
    of a CUDA tensor under gloo, else ``x`` itself (contiguous)."""
    x = x.contiguous()
    if x.is_cuda and dist.get_backend(group) == "gloo":
        return x.cpu()
    return x


def all_reduce(x: torch.Tensor, group=None,
               op=dist.ReduceOp.SUM) -> torch.Tensor:
    """A reduced copy of ``x`` over ``group`` (None: the world), on
    ``x``'s device."""
    wire = on_wire(x.detach(), group)
    wire = wire.clone() if wire.data_ptr() == x.data_ptr() else wire
    dist.all_reduce(wire, op=op, group=group)
    return wire.to(x.device)


def all_gather(x: torch.Tensor, group=None) -> List[torch.Tensor]:
    """Every process's ``x`` over ``group``, in the group's rank order,
    on ``x``'s device."""
    wire = on_wire(x.detach(), group)
    parts = [torch.empty_like(wire)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, wire, group=group)
    return [p.to(x.device) for p in parts]


def exchange(sends: List[torch.Tensor], to: List[int], frm: List[int],
             like: torch.Tensor) -> List[torch.Tensor]:
    """Point-to-point: ``sends[i]`` goes to process ``to[i]``, and a
    tensor shaped as ``like`` comes from each process of ``frm``, all
    posted at once -> the received tensors on ``like``'s device. A CUDA
    tensor travels through a host copy under gloo."""
    staged = like.is_cuda and dist.get_backend() == "gloo"
    wdev = torch.device("cpu") if staged else like.device
    got = [torch.empty(like.shape, dtype=like.dtype, device=wdev)
           for _ in frm]
    ops = [dist.P2POp(dist.isend, x.contiguous().to(wdev), peer)
           for x, peer in zip(sends, to)]
    ops += [dist.P2POp(dist.irecv, buf, peer) for buf, peer in zip(got, frm)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return [g.to(like.device) for g in got]


def gather_axis(x: torch.Tensor, axis: MeshAxis) -> torch.Tensor:
    """The whole of ``axis`` on this process: every process's per-rank
    ``x`` [n_hosted, ...] along the axis's across part, as the hosted
    grid (:meth:`MeshAxis.grid`) with the axis's dim at its full size,
    ranks in coordinate order. Not differentiable."""
    parts = all_gather(x, axis.group)
    return torch.cat([axis.grid(p) for p in parts], dim=axis.pos)


def _own_block(full: torch.Tensor, axis: MeshAxis, like: torch.Tensor):
    """This process's block of a whole-axis grid (:func:`gather_axis`'s
    layout) as per-rank tensors shaped as ``like``."""
    h = axis.hosted_size
    a = axis.across_index()
    return full.narrow(axis.pos, a * h, h).reshape(like.shape)


def axis_index(axis: MeshAxis) -> torch.Tensor:
    """Each hosted rank's coordinate on ``axis``: int64 [n_hosted]."""
    return axis.index()


def _send_recv(x: torch.Tensor, axis: MeshAxis, shift: int) -> torch.Tensor:
    """This process's ``x`` to the process ``shift`` along ``axis``; the
    tensor from the process ``shift`` before it back."""
    return exchange([x], [axis.neighbour(shift)], [axis.neighbour(-shift)],
                    x)[0]


def _hosted_roll(x: torch.Tensor, axis: MeshAxis, shift: int):
    return torch.roll(axis.grid(x), shift, dims=axis.pos).reshape(x.shape)


def _split_roll(x: torch.Tensor, axis: MeshAxis, shift: int):
    """The ring permute of an axis split between hosted ranks and
    processes: the whole axis gathered, rolled, this process's block."""
    full = gather_axis(x, axis)
    return _own_block(torch.roll(full, shift, dims=axis.pos), axis, x)


class _RingPermute(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, axis, shift):
        ctx.axis, ctx.shift = axis, shift
        return _permute(x, axis, shift)

    @staticmethod
    def backward(ctx, g):
        return _permute(g, ctx.axis, -ctx.shift), None, None


def _permute(x, axis, shift):
    if axis.hosted_size == 1:
        return _send_recv(x, axis, shift)
    return _split_roll(x, axis, shift)


def ring_permute(x: torch.Tensor, axis: MeshAxis,
                 shift: int = 1) -> torch.Tensor:
    """Each rank's ``x`` moves ``shift`` steps along the ring of ``axis``
    (rank ``i`` -> ``i + shift`` mod n): the JAX ``ppermute`` with
    ``perm = [(i, (i + shift) % n)]``."""
    if axis.size == 1 or shift % axis.size == 0:
        return x
    if axis.across_size == 1:
        return _hosted_roll(x, axis, shift)
    return _RingPermute.apply(x, axis, shift)


def _all_reduce(x: torch.Tensor, axis: MeshAxis) -> torch.Tensor:
    return all_reduce(x, axis.group)


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
    a value, see the module docstring). The hosted part sums over the
    leading dimension, the part across processes over the axis's
    group."""
    if axis.size == 1:
        return x
    if axis.hosted_size > 1:
        grid = axis.grid(x)
        x = grid.sum(dim=axis.pos, keepdim=True).expand(
            grid.shape).reshape(x.shape)
    if axis.across_size == 1:
        return x
    return _all_reduce(x, axis)


def enter_branch(x: torch.Tensor, axis: MeshAxis) -> torch.Tensor:
    """``x``, held alike by every rank of ``axis``, as the input of a
    branch whose ranks hold different weights or tokens: the identity,
    with its gradient summed over the axis's part across processes (so
    what produced ``x`` sees every rank's part of the gradient). Its
    hosted part is the identity, where autograd sums the ranks' parts
    itself."""
    if axis.size == 1 or axis.across_size == 1:
        return x
    return _EnterBranch.apply(x, axis)


def leave_branch(x: torch.Tensor, axis: MeshAxis) -> torch.Tensor:
    """The ranks' partial outputs ``x`` of such a branch summed over
    ``axis``: over its hosted part as :func:`allreduce_sum` does (autograd
    differentiates the sum), over its part across processes with the
    gradient passed through to each process's part unchanged (every
    process holds the whole cotangent of the sum)."""
    if axis.size == 1:
        return x
    if axis.hosted_size > 1:
        grid = axis.grid(x)
        x = grid.sum(dim=axis.pos, keepdim=True).expand(
            grid.shape).reshape(x.shape)
    if axis.across_size == 1:
        return x
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
    if x.shape[1 + split_axis] % n:
        raise ValueError(f"all_to_all: dim {split_axis} of the per-rank "
                         f"shape {tuple(x.shape[1:])} does not split over "
                         f"{axis.name}={n}")
    if axis.across_size > 1:
        return _AllToAll.apply(x, axis, split_axis, concat_axis)
    return _hosted_all_to_all(x, axis, split_axis, concat_axis)


def _hosted_all_to_all(x, axis, split_axis, concat_axis, grid=None):
    """The all-to-all over the hosted grid ``grid`` (default: ``x``'s)
    of whole axes -> per-rank tensors of the grid's leading dims."""
    n = axis.size
    g = axis.grid(x) if grid is None else grid
    lead = g.shape[:len(axis.mesh.shape)]
    m = len(lead)
    s = m + split_axis
    # the chunk index (the destination rank) beside the split dim, then
    # swapped with the mesh axis: the mesh axis now names the
    # destination and the chunk dim the source
    g = g.unflatten(s, (n, g.shape[s] // n)).transpose(axis.pos, s)
    c = concat_axis + (concat_axis >= split_axis)   # with the chunk dim
    dst = m + (c - 1 if c > split_axis else c)
    g = g.movedim(s, dst).flatten(dst, dst + 1)
    return g.reshape(-1, *g.shape[m:])


def _exchange(x: torch.Tensor, axis: MeshAxis, split_axis: int,
              concat_axis: int) -> torch.Tensor:
    """The all-to-all of an axis with an across part. Wholly across: this
    process's [n_hosted, ...] ``x`` split along ``split_axis`` (per-rank
    dims), chunk ``j`` sent to the process at index ``j`` on ``axis``
    (each hosted rank's chunk to the rank at its place there), the
    chunks received concatenated in source order along ``concat_axis``.
    Split between hosted ranks and processes: the whole axis gathered,
    the hosted all-to-all over it, this process's block."""
    n = axis.size
    if axis.hosted_size > 1:
        full = gather_axis(x, axis)
        out = _hosted_all_to_all(x, axis, split_axis, concat_axis, full)
        grid = out.reshape(*full.shape[:len(axis.mesh.shape)],
                           *out.shape[1:])
        like = torch.empty((x.shape[0], *out.shape[1:]), device="meta")
        return _own_block(grid, axis, like)
    me = axis.across_index()
    chunks = list(x.chunk(n, dim=1 + split_axis))
    others = [j for j in range(n) if j != me]
    peers = [axis.peer(j) for j in others]
    got = exchange([chunks[j] for j in others], peers, peers, chunks[0])
    recv = dict(zip(others, got))
    recv[me] = chunks[me]
    return torch.cat([recv[j] for j in range(n)], dim=1 + concat_axis)


class _AllToAll(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, axis, split_axis, concat_axis):
        ctx.args = axis, split_axis, concat_axis
        return _exchange(x, axis, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        axis, split_axis, concat_axis = ctx.args
        return _exchange(g, axis, concat_axis, split_axis), None, None, None
