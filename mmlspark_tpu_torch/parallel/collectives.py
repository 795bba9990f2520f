"""Collectives over a :class:`~.topology.Mesh` axis (the port of
``mmlspark_tpu/parallel/collectives.py``'s ring and reduction helpers).

Each takes per-rank tensors ``[n_hosted, ...]`` and a
:class:`~.topology.MeshAxis` where the JAX helpers take an axis name
inside ``shard_map``. On a hosted mesh they act on the leading
dimension; under ``torch.distributed`` they send and reduce across
processes. :func:`ring_permute` is differentiable in both forms (its
gradient is the permute the other way, as ``ppermute``'s transpose);
the reductions are differentiable only in the hosted form.
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


def allreduce_sum(x: torch.Tensor, axis: MeshAxis) -> torch.Tensor:
    """Every rank's ``x`` summed over ``axis`` (the JAX ``psum``): each
    rank gets the sum."""
    if axis.size == 1:
        return x
    if axis.mesh.hosted:
        grid = axis.grid(x)
        return grid.sum(dim=axis.pos, keepdim=True).expand(
            grid.shape).reshape(x.shape)
    out = x.detach().clone()
    dist.all_reduce(out, group=axis.group)
    return out


def allreduce_mean(x: torch.Tensor, axis: MeshAxis) -> torch.Tensor:
    """:func:`allreduce_sum` over the axis size (the JAX ``pmean``)."""
    return allreduce_sum(x, axis) / axis.size
