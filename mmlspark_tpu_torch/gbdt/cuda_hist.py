"""The GBDT histogram build (K9), the engine's hot op.

The port of ``mmlspark_tpu/gbdt/pallas_hist.py``. On the card it is the
hand-written Hopper kernel ``csrc/gbdt_histogram.cu``: per feature, a
warp-private shared-memory histogram filled in a fixed row order, one
partial per row chunk, and a second small launch that sums the chunks
in order — deterministic, with no float atomics (the source says why
and what bounds it). The TPU kernel's one-hot MXU product does not
carry over.

:func:`build_histogram_cuda` takes the transposed bins of
:func:`prepare_bins_t`, (F, n) int32 (lanes read consecutive rows of a
feature), grad and hess (n,) f32 and ``in_leaf`` (n,) bool, and returns
(F, B, 3) f32 of ``[sum_grad, sum_hess, count]`` per (feature, bin).
It runs :func:`build_histogram_plain` — the reference's flat scatter-add
(``tree.build_histogram``) written with ``index_add_`` — only when
handed CPU tensors; for CUDA tensors it launches the kernel or raises.
There is no fallback. :data:`LAUNCHES` counts one per kernel call (its
merge launch is not counted apart).
"""

from __future__ import annotations

from typing import Dict

import torch

from mmlspark_tpu_torch.native.launch import I, P, check, device_of, launch

#: kernel calls (plain-version calls never count)
LAUNCHES: Dict[str, int] = {"gbdt_histogram": 0}

#: the kernel's largest bin count (its warps' histograms in shared memory)
MAX_BINS = 2048

_WARPS = 8             # features per block (``kWarps`` in the source)
_TARGET_BLOCKS = 528   # 4 blocks per SM on the H100's 132
_MIN_CHUNK = 1024      # rows per block at least

_HIST = ("mmt_gbdt_histogram", [P] * 6 + [I] * 5)


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def prepare_bins_t(bins) -> torch.Tensor:
    """(n, F) bins -> the (F, n) int32 layout the histogram reads, made
    once per fit and reused for every leaf. No padding: the kernel
    masks its ragged edge."""
    return torch.as_tensor(bins).to(torch.int32).t().contiguous()


def chunk_rows(n: int, n_features: int) -> int:
    """Rows per block: enough blocks to fill the card (about
    ``_TARGET_BLOCKS`` over the feature groups), at least ``_MIN_CHUNK``
    rows each, a multiple of 32."""
    groups = -(-n_features // _WARPS)
    chunks = max(1, -(-_TARGET_BLOCKS // groups))
    rows = -(-n // chunks)
    return max(_MIN_CHUNK, -(-rows // 32) * 32)


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
    check("bins_t", bins_t, torch.int32, (n_features, None), dev)
    n = bins_t.shape[1]
    check("grad", grad, torch.float32, (n,), dev)
    check("hess", hess, torch.float32, (n,), dev)
    check("in_leaf", in_leaf, torch.bool, (n,), dev)
    if n_features < 1 or not 1 <= n_bins <= MAX_BINS:
        raise ValueError(f"n_features={n_features} must be >= 1 and "
                         f"n_bins={n_bins} in [1, {MAX_BINS}]")
    return dev, n


def build_histogram_cuda(bins_t, grad, hess, in_leaf, n_features: int,
                         n_bins: int):
    """K9: (F, B, 3) f32 ``[sum_grad, sum_hess, count]`` of the rows in
    ``in_leaf``, per (feature, bin). ``bins_t`` (F, n) int32 from
    :func:`prepare_bins_t`; grad/hess (n,) f32; in_leaf (n,) bool."""
    dev, n = _check(bins_t, grad, hess, in_leaf, n_features, n_bins)
    if dev.type == "cpu":
        return build_histogram_plain(bins_t, grad, hess, in_leaf,
                                     n_features, n_bins)
    out = torch.empty(n_features, n_bins, 3, dtype=torch.float32,
                      device=dev)
    if n == 0:
        return out.zero_()
    rows = chunk_rows(n, n_features)
    n_chunks = -(-n // rows)
    scratch = (torch.empty(n_chunks * n_features * n_bins * 3,
                           dtype=torch.float32, device=dev)
               if n_chunks > 1 else None)
    launch(*_HIST, dev, bins_t.data_ptr(), grad.data_ptr(),
           hess.data_ptr(), in_leaf.data_ptr(),
           None if scratch is None else scratch.data_ptr(),
           out.data_ptr(), n, n_features, n_bins, rows, n_chunks)
    LAUNCHES["gbdt_histogram"] += 1
    return out
