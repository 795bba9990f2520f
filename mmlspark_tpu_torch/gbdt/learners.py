"""Distributed tree learners: data-, feature- and voting-parallel.

The port of ``mmlspark_tpu/gbdt/learners.py``. The reference passes
``tree_learner = data | feature | voting`` to LightGBM's socket fabric;
the JAX package makes each one a sharding and collective pattern over
the same split math, and so does this one, over the port's
:class:`~mmlspark_tpu_torch.parallel.topology.Mesh` (its ``data`` axis)
in both of the mesh's forms:

- **hosted**: one process holds every rank on one device. The data
  learner's ranks share one K9 launch a leaf over all rows (the sum of
  their histograms), the feature learner's ranks one launch over every
  feature; the voting learner launches K9 once a rank over the rank's
  own contiguous block of rows, and its reductions are sums over the
  rank dimension in rank order.
- **one rank per process**: each process holds its rows (data, voting)
  or its feature slice (feature, with every row, as LightGBM's
  feature-parallel workers hold the whole data) and launches K9 on
  them; ``torch.distributed.all_reduce`` over the data axis's group sums
  the data learner's histograms and the voting learner's votes and
  voted histograms (MAX for its anchor), and ``all_gather`` joins the
  feature learner's slices into the whole histogram, so every process
  finds the same split. Histograms are int64 fixed point on one grid a
  tree (:func:`fit_scale`: its largest ``|v|`` is MAX-reduced over the
  axis first), so every sum over ranks and processes is exact and a
  sharded fit's histograms equal the single-device fit's bit for bit.
- **mixed** (several processes, each hosting several data ranks): each
  process holds its ranks' block of the rows (data, voting) or of the
  features (feature) and computes it as a hosted mesh computes all of
  them; the reductions and the gathers run over the processes as above.

:class:`DataAxis` holds that plumbing; :class:`VotingHist` is the voting
learner's histogram (LightGBM's parallel voting, Meng et al.,
NeurIPS'16): each rank votes for its locally best ``top_k`` features
under shard-scaled gates, the votes are summed, and only the top
``min(2 * top_k, F)`` features' histograms (and the count-richest
feature's, the parent-stat anchor) are summed; every other feature is
zero, fails the ``min_data_in_leaf`` gate and can never be chosen.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List

import numpy as np
import torch
import torch.distributed as dist

from mmlspark_tpu_torch.gbdt.cuda_hist import (
    build_histogram_cuda, fixed_scale, fixed_to_float, prepare_bins_t,
)
from mmlspark_tpu_torch.gbdt.tree import (
    GrowthParams, _gains, tie_width,
)
from mmlspark_tpu_torch.parallel.collectives import all_gather, all_reduce
from mmlspark_tpu_torch.parallel.topology import AXIS_DATA, Mesh

_INF = float("inf")


def build_histogram_per_feature(bins, grad, hess, in_leaf, n_bins: int):
    """Per-(feature, bin) ``[sum_grad, sum_hess, count]`` of the rows in
    ``in_leaf``, each feature's column scattered on its own: (n, F)
    bins -> (F, B, 3) f32. Identical to :func:`~.tree.build_histogram`
    (exact sums on the grid of these gradients, rounded once): K9 for
    CUDA tensors, its plain version for CPU ones. The feature learner's
    ranks call K9 on their feature slices of the transposed bins
    directly, in fixed point."""
    scale = fixed_scale(grad, hess, grad.shape[0])
    return fixed_to_float(build_histogram_cuda(
        prepare_bins_t(bins), grad, hess, in_leaf, bins.shape[1], n_bins,
        scale), scale)


def check_sharding(sharding) -> Mesh:
    """A sharded fit's ``sharding``: a :class:`Mesh` with a ``data``
    axis (the port's counterpart of JAX's ``batch_sharding(mesh)``)."""
    if not isinstance(sharding, Mesh):
        raise TypeError(f"sharding must be a Mesh with a {AXIS_DATA!r} "
                        f"axis, got {type(sharding).__name__}")
    if AXIS_DATA not in sharding.shape:
        raise ValueError(f"mesh {sharding.shape} has no {AXIS_DATA!r} "
                         f"axis")
    return sharding


class DataAxis:
    """The ``data`` axis of a sharded fit: its size, this process's
    place on it, and the reductions over it. Hosted, this process holds
    every rank's rows; over processes, the block of a fit's (padded)
    rows of its ranks on the axis (one rank, or several hosted by each
    process of a mixed mesh), by its coordinate on the axis's part
    across processes."""

    def __init__(self, mesh: Mesh):
        axis = mesh.axis(AXIS_DATA)
        self.mesh = mesh
        self.size = axis.size
        self.hosted = mesh.hosted
        #: this process's ranks on the axis, and how many processes' blocks
        #: make its rows
        self.n_hosted = axis.hosted_size
        self.across = axis.across_size
        self.coord = 0 if mesh.hosted else axis.across_index()
        self.group = None if mesh.hosted else axis.group

    @property
    def distributed(self) -> bool:
        """The rows spread over more than one process."""
        return not self.hosted and self.across > 1

    def local(self, x):
        """This process's block of a global (padded) row array or
        tensor, along dim 0 (every row, hosted)."""
        if not self.distributed:
            return x
        m = x.shape[0] // self.across
        return x[self.coord * m:(self.coord + 1) * m]

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every process's block of ``x`` (dim 0) joined in rank order."""
        if not self.distributed:
            return x
        wire = x.to(torch.uint8) if x.dtype == torch.bool else x
        out = torch.cat(all_gather(wire, self.group))
        return out.to(torch.bool) if x.dtype == torch.bool else out

    def all_reduce(self, x: torch.Tensor, op=dist.ReduceOp.SUM
                   ) -> torch.Tensor:
        """``x`` reduced over the processes of the axis (a reduced copy;
        ``x`` itself when the rows are on one process). A CUDA tensor
        crosses gloo through a host copy (``collectives.on_wire``)."""
        return all_reduce(x, self.group, op) if self.distributed else x

    def row_blocks(self, bins_t: torch.Tensor) -> List[torch.Tensor]:
        """This process's ranks' contiguous (F, n / d) blocks of its
        ``bins_t`` (its own block alone when it is one rank)."""
        if self.n_hosted == 1:
            return [bins_t]
        m = bins_t.shape[1] // self.n_hosted
        return [bins_t[:, r * m:(r + 1) * m].contiguous()
                for r in range(self.n_hosted)]

    def feature_slice(self, bins_t: torch.Tensor) -> torch.Tensor:
        """This process's contiguous rows of the (F, n) bins: its ranks'
        feature slices (every feature, hosted)."""
        if not self.distributed:
            return bins_t
        per = bins_t.shape[0] // self.across
        return bins_t[self.coord * per:(self.coord + 1) * per].contiguous()


def fit_scale(grad, hess, in_fit, n_rows: int, axis=None) -> torch.Tensor:
    """The histograms' fixed point for one tree
    (:func:`.cuda_hist.fixed_scale`): the largest ``|v|`` over the rows
    that enter its histograms (``in_fit``; the others, pads and
    validation rows among them, never do), with room for a sum over
    ``n_rows``, the fit's real rows. On a data axis over processes
    (``axis`` a :class:`DataAxis`) the largest ``|v|`` is MAX-reduced
    first, so every rank takes the grid of the fit on one device,
    however the rows are spread and padded."""
    grad, hess = (torch.where(in_fit, v, 0.0) for v in (grad, hess))
    if axis is None or not axis.distributed:
        return fixed_scale(grad, hess, n_rows)
    return fixed_scale(grad, hess, n_rows,
                       lambda top: axis.all_reduce(top, dist.ReduceOp.MAX))


def rank_sum(x: torch.Tensor) -> torch.Tensor:
    """``x[0] + x[1] + ...`` over the leading (rank) dim, in rank order."""
    out = x[0].clone()
    for r in range(1, x.shape[0]):
        out += x[r]
    return out


class VotingHist:
    """The voting-parallel histogram of one fit (see the module
    docstring): ``hist(blocks, grad, hess, in_leaf, scale, feat_mask)``
    -> (F, B, 3) int64 in the fixed point ``scale``, exact on the voted
    features and the anchor, zero elsewhere. ``blocks`` are
    :meth:`DataAxis.row_blocks`; ``grad``, ``hess`` and ``in_leaf`` this
    process's rows."""

    def __init__(self, axis: DataAxis, growth: GrowthParams,
                 is_categorical, n_features: int, n_bins: int, top_k: int):
        self.axis = axis
        n_shards = axis.size
        # vote gains are scored on LOCAL histograms, so the min-data and
        # min-hessian gates are scaled down by the shard count; with the
        # global gates a small leaf has every local gain at -inf and the
        # vote degenerates to the low feature ids
        self.local_growth = dataclasses.replace(
            growth,
            min_data_in_leaf=max(1, growth.min_data_in_leaf // n_shards),
            min_sum_hessian_in_leaf=growth.min_sum_hessian_in_leaf
            / n_shards)
        self.is_categorical = is_categorical
        self.n_features = n_features
        self.n_bins = n_bins
        self.k = min(top_k, n_features)
        self.n_sel = min(2 * top_k, n_features)

    def local(self, blocks, grad, hess, in_leaf, scale) -> torch.Tensor:
        """Each of this process's ranks' histogram over its own rows:
        (ranks, F, B, 3) int64 in ``scale``, one K9 launch a rank."""
        m = blocks[0].shape[1]
        return torch.stack([
            build_histogram_cuda(b, grad[r * m:(r + 1) * m],
                                 hess[r * m:(r + 1) * m],
                                 in_leaf[r * m:(r + 1) * m],
                                 self.n_features, self.n_bins, scale)
            for r, b in enumerate(blocks)])

    def __call__(self, blocks, grad, hess, in_leaf, scale, feat_mask=None):
        F, axis = self.n_features, self.axis
        local = self.local(blocks, grad, hess, in_leaf, scale)
        dev = local.device
        gains, _, _, parent_score = _gains(local, scale, self.is_categorical,
                                           self.local_growth)
        if feat_mask is not None:
            # vote only over the sampled columns, or the voted set could
            # be disjoint from what the split search allows
            gains = torch.where(feat_mask[:, None], gains, -_INF)
        per_feature = torch.amax(gains, dim=(1, 3))          # (R, F)
        voted = torch.sort(vote_places(per_feature, parent_score), dim=1,
                           stable=True).indices[:, :self.k]
        votes = torch.zeros_like(per_feature, dtype=torch.int64).scatter_(
            1, voted, 1)
        votes = axis.all_reduce(rank_sum(votes))              # (F,)
        # the index breaks ties, so every rank picks the same winners
        rank = votes.to(torch.float32) * F - torch.arange(
            F, dtype=torch.float32, device=dev)
        sel = torch.sort(rank, descending=True,
                         stable=True).indices[:self.n_sel]
        # the parent-stat anchor: the count-richest local feature
        anchor = torch.amax(torch.argmax(torch.sum(local[..., 2], dim=2),
                                         dim=1))
        anchor = axis.all_reduce(anchor.reshape(1), dist.ReduceOp.MAX)
        sel = torch.cat([sel, anchor])
        reduced = axis.all_reduce(rank_sum(local[:, sel]))
        out = torch.zeros_like(local[0])
        out[sel] = reduced
        return out


#: features compared pair by pair within blocks of this many; wider
#: spans of features are counted by sorted blocks (:func:`_lower_within`)
VOTE_BLOCK = 32


@functools.lru_cache(maxsize=None)
def _lower(n: int, device: torch.device) -> torch.Tensor:
    """(n, n) bool, made once a device: [f, g] is ``g < f``."""
    return torch.ones((n, n), dtype=torch.bool, device=device).tril(-1)


def vote_places(per_feature, parent_score):
    """Each feature's place in each rank's vote (R, F): how many features
    beat it, a feature beating another when its best gain is higher by
    more than the rank's near-tie width (:func:`.tree.tie_width`) or lies
    within it at a lower index. Without
    near ties this is the position in a stable descending sort, as
    ``jax.lax.top_k`` lists the lower index first among equal values;
    with them, the lower index goes first, as the split search's
    near-tie rule takes the first. Up to :data:`VOTE_BLOCK` features
    every pair is compared (the fewest operators, on a host-bound path);
    wider, O(F log^2 F) a rank: voting is for wide data, where an (F, F)
    table of the pairs would not fit."""
    F = per_feature.shape[1]
    width = tie_width(torch.amax(per_feature, dim=1), parent_score)[:, None]
    if F <= VOTE_BLOCK:
        mine = per_feature[:, :, None]                   # (R, F, 1): f
        other = per_feature[:, None, :]                  # (R, 1, F): g
        w = width[:, :, None]
        beats = ((other > mine + w)
                 | ((other >= mine - w) & _lower(F, per_feature.device)))
        return beats.sum(dim=2)
    n = 1 << (F - 1).bit_length()                        # F padded to 2^k
    # pad features of gain -inf, after every real one: they beat none
    v = torch.nn.functional.pad(per_feature, (0, n - F), value=-_INF)
    hi, lo = v + width, v - width
    # clearly ahead: the gains above hi, counted in the sorted gains
    ahead = n - torch.searchsorted(torch.sort(v, dim=1).values, hi,
                                   right=True)
    return (ahead + _lower_within(v, lo, hi))[:, :F]


def _lower_within(v, lo, hi):
    """``#{g < f : lo[r, f] <= v[r, g] <= hi[r, f]}`` for every (r, f) of
    (R, n) tensors, n a power of two and a multiple of
    :data:`VOTE_BLOCK`. Within each block of ``VOTE_BLOCK`` features the
    pairs are compared directly. Above, the features [0, f) are one
    block of 2^l features a level l at most (the set bits of f), and
    each such block is the one just before a block whose queries it
    answers: so a level sorts its even blocks and searches them with its
    odd blocks' bounds."""
    R, n = v.shape
    b = VOTE_BLOCK
    shape = (R, n // b, b)
    other = v.view(shape)[:, :, None, :]                 # (R, n/b, 1, b): g
    inside = ((other >= lo.view(shape)[..., None])
              & (other <= hi.view(shape)[..., None]))
    count = (inside & _lower(b, v.device)).sum(dim=3).view(R, n)
    size = b
    while size < n:
        shape = (R, n // (2 * size), 2, size)
        keys = torch.sort(v.view(shape)[:, :, 0], dim=-1).values
        count.view(shape)[:, :, 1] += (
            torch.searchsorted(keys, hi.view(shape)[:, :, 1].contiguous(),
                               right=True)
            - torch.searchsorted(keys, lo.view(shape)[:, :, 1].contiguous()))
        size *= 2
    return count


def pad_features(bins: np.ndarray, multiple: int) -> np.ndarray:
    """(n, F) bins padded to a feature count divisible by ``multiple``
    with bin 0, the missing bin: every candidate split on a pad column
    sends all rows or none one way, so it never passes the gates."""
    pad = -bins.shape[1] % multiple
    return np.pad(bins, ((0, 0), (0, pad))) if pad else bins


def feature_histogram(axis: DataAxis, bins_slice, grad, hess, in_leaf,
                      n_features: int, n_bins: int, scale) -> torch.Tensor:
    """The feature learner's histogram: K9 over this process's feature
    slice (every feature, hosted) in the fixed point ``scale``, the
    slices gathered in rank order into the whole (F, B, 3) int64
    histogram."""
    part = build_histogram_cuda(bins_slice, grad, hess, in_leaf,
                                bins_slice.shape[0], n_bins, scale)
    return axis.gather(part) if axis.distributed else part


def renewal_rows(axis, node_of_row, residual, weights,
                 sample_mask):
    """The global rows a leaf renewal needs: each process's rows
    gathered once a tree, so every process renews alike."""
    if axis is None or not axis.distributed:
        return node_of_row, residual, weights, sample_mask
    return (axis.gather(node_of_row), axis.gather(residual),
            axis.gather(weights), axis.gather(sample_mask))
