"""The GBDT histogram build (K9), the engine's hot op.

The port of ``mmlspark_tpu/gbdt/pallas_hist.py``. On the card it is the
hand-written Hopper kernel ``csrc/gbdt_histogram.cu``: each block
compacts the rows of its chunk that are in the leaf, stages their grad,
hess and bins through a cp.async ring, and fills one shared-memory
histogram per feature in a fixed row order; the blocks of a thread
block cluster sum their histograms through distributed shared memory
in rank order, and a second small launch sums the clusters' partials in
order — deterministic, with no float atomics (the source says why and
what bounds it). The TPU kernel's one-hot MXU product does not carry
over.

:func:`build_histogram_cuda` takes the transposed bins of
:func:`prepare_bins_t`, (F, n) uint8 while the bin count is at most 256
and int32 above (lanes read consecutive rows of a feature), grad and
hess (n,) f32 and ``in_leaf`` (n,) bool, and returns (F, B, 3) f32 of
``[sum_grad, sum_hess, count]`` per (feature, bin). It runs
:func:`build_histogram_plain` — the reference's flat scatter-add
(``tree.build_histogram``) written with ``index_add_`` — only when
handed CPU tensors; for CUDA tensors it launches the kernel or raises.
There is no fallback. :data:`LAUNCHES` counts one per kernel call (its
merge launch is not counted apart). :func:`hist_plan` picks the grid.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Dict, Tuple

import torch

from mmlspark_tpu_torch.native import cuda_build
from mmlspark_tpu_torch.native.launch import I, P, check, device_of, launch

#: kernel calls (plain-version calls never count)
LAUNCHES: Dict[str, int] = {"gbdt_histogram": 0}

#: the kernel's largest bin count (one feature's histogram in shared
#: memory beside the ring)
MAX_BINS = 2048
#: the largest bin count the uint8 layout holds (bins 0 .. 255)
U8_BINS = 256

CLUSTER = 8        # blocks a cluster along the rows
_MIN_ROWS = 8192   # rows a block at least (the kernel compacts 8192 at once)

_HIST = ("mmt_gbdt_histogram", [P] * 6 + [I] * 8)
_max_clusters: Dict[Tuple[bool, int, int], int] = {}
_max_feats: Dict[int, int] = {}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def prepare_bins_t(bins, n_bins=None) -> torch.Tensor:
    """(n, F) bins -> the (F, n) layout the histogram reads, made once
    per fit and reused for every leaf: uint8 when ``n_bins`` (the bin
    count) is at most 256, else (or when it is not given) int32. No
    padding: the kernel masks its ragged edge."""
    dtype = (torch.uint8 if n_bins is not None and n_bins <= U8_BINS
             else torch.int32)
    return torch.as_tensor(bins).to(dtype).t().contiguous()


def features_per_block(n_features: int, max_feats: int) -> Tuple[int, int]:
    """(features a block, feature groups): at most ``max_feats`` features
    a block (what its shared memory holds at the bin count, as the kernel
    reports it: :func:`max_feats`), spread evenly over the groups."""
    groups = -(-n_features // min(n_features, max_feats))
    return -(-n_features // groups), groups


@dataclass(frozen=True)
class HistPlan:
    """K9's grid: ``groups`` x ``row_blocks`` blocks of ``feats`` warps,
    ``chunk_rows`` rows a block, clusters of ``cluster`` blocks along
    the rows (one partial histogram each)."""
    feats: int
    groups: int
    row_blocks: int
    cluster: int
    chunk_rows: int

    @property
    def n_clusters(self) -> int:
        return self.row_blocks // self.cluster

    def partial_bytes(self, n_features: int, n_bins: int) -> int:
        """Bytes of the clusters' partials, each written once and read
        once by the merge (0 with one cluster)."""
        if self.n_clusters == 1:
            return 0
        return 2 * self.n_clusters * n_features * n_bins * 12


@functools.lru_cache(maxsize=256)
def hist_plan(n: int, n_features: int, max_feats: int,
              max_clusters: int) -> HistPlan:
    """The grid for ``n`` rows: at most ``max_feats`` features a block,
    at least ``_MIN_ROWS`` rows a block, and no more clusters of
    ``CLUSTER`` than the card holds at once (``max_clusters``, over all
    feature groups), so every block runs in one wave; fewer than
    ``CLUSTER`` blocks form one cluster of a power of two. Up to 8192
    rows run in one block, whose per-bin sums are then the plain
    version's, row by row in row order. ``chunk_rows`` is a multiple of
    16 (the mask's vector loads)."""
    feats, groups = features_per_block(n_features, max_feats)
    blocks = max(1, -(-n // _MIN_ROWS))
    if blocks >= CLUSTER:
        cluster = CLUSTER
        row_blocks = CLUSTER * max(1, min(blocks // CLUSTER,
                                          max_clusters // groups))
    else:
        cluster = row_blocks = 1 << (blocks.bit_length() - 1)
    rows = -(-n // row_blocks)
    return HistPlan(feats, groups, row_blocks, cluster, -(-rows // 16) * 16)


def build_histogram_plain(bins_t, grad, hess, in_leaf, n_features: int,
                          n_bins: int):
    """The plain version: ``[g·m, h·m, m]`` scatter-added into a flat
    (F·B) accumulator per channel with ``index_add_`` (the reference's
    scatter-add; each bin sums its rows in row order, as XLA's does on
    the CPU, and a 1-D add per channel is far quicker there than one
    2-D add)."""
    mask = in_leaf.to(torch.float32)
    n = mask.shape[0]
    offsets = torch.arange(n_features, dtype=torch.int64,
                           device=bins_t.device) * n_bins
    flat_idx = (bins_t.to(torch.int64) + offsets[:, None]).reshape(-1)
    hist = torch.zeros(3, n_features * n_bins, dtype=torch.float32,
                       device=bins_t.device)
    for c, vals in enumerate((grad * mask, hess * mask, mask)):
        hist[c].index_add_(0, flat_idx,
                           vals.expand(n_features, n).reshape(-1))
    return hist.t().reshape(n_features, n_bins, 3)


def _check(bins_t, grad, hess, in_leaf, n_features, n_bins):
    dev = device_of("bins_t", bins_t)
    if bins_t.dtype not in (torch.uint8, torch.int32):
        raise TypeError(f"bins_t must be uint8 or int32, got "
                        f"{bins_t.dtype}")
    check("bins_t", bins_t, bins_t.dtype, (n_features, None), dev)
    n = bins_t.shape[1]
    check("grad", grad, torch.float32, (n,), dev)
    check("hess", hess, torch.float32, (n,), dev)
    check("in_leaf", in_leaf, torch.bool, (n,), dev)
    if n_features < 1 or not 1 <= n_bins <= MAX_BINS:
        raise ValueError(f"n_features={n_features} must be >= 1 and "
                         f"n_bins={n_bins} in [1, {MAX_BINS}]")
    if bins_t.dtype == torch.uint8 and n_bins > U8_BINS:
        raise ValueError(f"uint8 bins hold at most {U8_BINS} bins, "
                         f"got n_bins={n_bins}")
    return dev, n


def max_feats(n_bins: int) -> int:
    """The most features a block of the kernel takes at ``n_bins`` bins
    (``mmt_gbdt_histogram_max_feats``: its shared-memory layout's own
    size; asked once per bin count)."""
    if n_bins not in _max_feats:
        fn = cuda_build.load().mmt_gbdt_histogram_max_feats
        fn.argtypes = [I, ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
        got = ctypes.c_int(0)
        rc = fn(n_bins, ctypes.byref(got))
        if rc:
            raise RuntimeError(f"mmt_gbdt_histogram_max_feats failed: "
                               f"CUDA error {rc}")
        _max_feats[n_bins] = got.value
    return _max_feats[n_bins]


def max_clusters(dev: torch.device, u8: bool, feats: int,
                 n_bins: int) -> int:
    """How many clusters of ``CLUSTER`` blocks of the kernel the card
    holds at once (``cudaOccupancyMaxActiveClusters``; asked once per
    layout)."""
    key = (u8, feats, n_bins)
    if key not in _max_clusters:
        lib = cuda_build.load()
        fn = lib.mmt_gbdt_histogram_max_clusters
        fn.argtypes = [I, I, I, I, ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
        got = ctypes.c_int(0)
        with torch.cuda.device(dev):
            rc = fn(int(u8), feats, n_bins, CLUSTER, ctypes.byref(got))
        if rc:
            raise RuntimeError(f"mmt_gbdt_histogram_max_clusters failed: "
                               f"CUDA error {rc}")
        _max_clusters[key] = max(1, got.value)
    return _max_clusters[key]


def plan_for(dev: torch.device, bins_t, n_features: int,
             n_bins: int) -> HistPlan:
    """The grid :func:`build_histogram_cuda` launches for these bins."""
    fit = max_feats(n_bins)
    feats, _ = features_per_block(n_features, fit)
    return hist_plan(bins_t.shape[1], n_features, fit,
                     max_clusters(dev, bins_t.dtype == torch.uint8, feats,
                                  n_bins))


def build_histogram_cuda(bins_t, grad, hess, in_leaf, n_features: int,
                         n_bins: int):
    """K9: (F, B, 3) f32 ``[sum_grad, sum_hess, count]`` of the rows in
    ``in_leaf``, per (feature, bin). ``bins_t`` (F, n) uint8 (at most
    256 bins) or int32 from :func:`prepare_bins_t`; grad/hess (n,) f32;
    in_leaf (n,) bool."""
    dev, n = _check(bins_t, grad, hess, in_leaf, n_features, n_bins)
    if dev.type == "cpu":
        return build_histogram_plain(bins_t, grad, hess, in_leaf,
                                     n_features, n_bins)
    out = torch.empty(n_features, n_bins, 3, dtype=torch.float32,
                      device=dev)
    if n == 0:
        return out.zero_()
    plan = plan_for(dev, bins_t, n_features, n_bins)
    scratch = (torch.empty(plan.n_clusters * n_features * n_bins * 3,
                           dtype=torch.float32, device=dev)
               if plan.n_clusters > 1 else None)
    launch(*_HIST, dev, bins_t.data_ptr(), grad.data_ptr(),
           hess.data_ptr(), in_leaf.data_ptr(),
           None if scratch is None else scratch.data_ptr(),
           out.data_ptr(), n, n_features, n_bins,
           int(bins_t.dtype == torch.uint8), plan.feats,
           plan.row_blocks, plan.cluster, plan.chunk_rows)
    LAUNCHES["gbdt_histogram"] += 1
    return out
