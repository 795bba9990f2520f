"""Batch placement (the port's ``mmlspark_tpu/parallel/sharding.py``).

The padding helpers and the shape-bucket ladder (copies of
``pad_to_multiple``, ``pad_to_bucket``, ``bucket_target``,
``bucket_ladder``, ``padded_device_batch`` and ``unpad``): prompts and
serving micro-batches pad to these buckets, so the decode plane and the
serving data plane see a small, fixed set of shapes. And a global
batch's blocks for the ranks of a :class:`~.topology.Mesh`, split over
its data and seq axes and replicated over the others
(:func:`shard_batch`), and back (:func:`gather_shards`).
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from mmlspark_tpu_torch.parallel.collectives import all_gather
from mmlspark_tpu_torch.parallel.topology import AXIS_DATA, AXIS_SEQ, Mesh


def _pad_axis(arr: np.ndarray, extra: int, axis: int, pad_value,
              pad_mode: str) -> np.ndarray:
    widths = [(0, 0)] * arr.ndim
    widths[axis] = (0, extra)
    if pad_mode == "edge" and arr.shape[axis] > 0:
        # repeat the last row: stays valid for object/string columns and
        # for models that choke on all-zero rows (serving pad policy)
        return np.pad(arr, widths, mode="edge")
    return np.pad(arr, widths, constant_values=pad_value)


def pad_to_multiple(arr: np.ndarray, multiple: int,
                    axis: int = 0, pad_value=0,
                    pad_mode: str = "constant") -> Tuple[np.ndarray, int]:
    """Pad ``axis`` up to a multiple of ``multiple``.

    Returns (padded, original_length). ``pad_mode="edge"`` repeats the
    last row instead of writing ``pad_value`` (valid for any dtype,
    including object columns).
    """
    n = arr.shape[axis]
    target = ((n + multiple - 1) // multiple) * multiple
    if target == n:
        return arr, n
    return _pad_axis(arr, target - n, axis, pad_value, pad_mode), n


def pad_to_bucket(arr: np.ndarray, cap: int = 1024,
                  axis: int = 0, pad_value=0,
                  pad_mode: str = "constant",
                  multiple: int = 1) -> Tuple[np.ndarray, int]:
    """Pad ``axis`` to a bounded shape bucket.

    Small inputs round up to the next power of two, clamped at ``cap``
    (few distinct shapes for serving micro-batches of assorted sizes,
    and never a dispatch larger than the operator's ceiling); inputs
    past ``cap`` pad to a multiple of ``cap`` instead, bounding the
    waste for large offline batches at ``cap - 1`` rows. ``multiple``
    rounds every bucket up to a divisibility constraint (a mesh's
    data-axis size).
    """
    n = arr.shape[axis]
    if n > cap:
        return pad_to_multiple(arr, _lcm(cap, multiple), axis=axis,
                               pad_value=pad_value, pad_mode=pad_mode)
    if n == 0:  # empty inputs still bucket to one row (a real shape)
        return _pad_axis(arr, max(int(multiple), 1), axis, pad_value,
                         "constant"), 0
    return pad_to_multiple(arr, bucket_target(n, cap, multiple=multiple),
                           axis=axis, pad_value=pad_value,
                           pad_mode=pad_mode)


def _lcm(a: int, b: int) -> int:
    a, b = max(int(a), 1), max(int(b), 1)
    return a * b // math.gcd(a, b)


def _effective_cap(cap: int, multiple: int) -> int:
    """The cap a divisibility-constrained ladder really serves: the
    operator ceiling rounded DOWN to the multiple (the ceiling is a
    budget — overshooting it to satisfy divisibility would be a memory
    lie), except a multiple larger than the cap IS the floor (there is
    no smaller dispatchable shape)."""
    cap, multiple = int(cap), max(int(multiple), 1)
    if multiple <= 1 or cap <= multiple:
        return max(cap, multiple) if multiple > 1 else cap
    return (cap // multiple) * multiple


def round_to_multiple(n: int, multiple: int, up: bool = True) -> int:
    """Round ``n`` to a multiple (up by default; ``up=False`` rounds
    down but never below ``multiple``)."""
    multiple = max(int(multiple), 1)
    n = int(n)
    if up:
        return ((max(n, 1) + multiple - 1) // multiple) * multiple
    return max((n // multiple) * multiple, multiple)


def bucket_target(n: int, cap: int = 1024, multiple: int = 1) -> int:
    """The bucket a batch of ``n`` rows pads to: next power of two,
    clamped at ``cap`` (a batch within the cap never pads past it —
    ``cap`` is an operator ceiling, e.g. a serving memory budget); above
    ``cap``, the next multiple of ``cap``. With ``multiple`` > 1 every
    bucket is additionally rounded up to that multiple. The ``cap``
    stays an operator CEILING: with a multiple that does not divide it,
    the effective cap is ``cap`` rounded DOWN to the multiple (a 100-row
    budget over 8 shards tops out at 96; when the multiple itself
    exceeds the cap it wins, as the smallest dispatchable shape)."""
    multiple = max(int(multiple), 1)
    cap = _effective_cap(cap, multiple)
    if n <= 0:
        return multiple
    if n > cap:
        return round_to_multiple(n, _lcm(cap, multiple))
    target = 1
    while target < n:
        target *= 2
    return min(round_to_multiple(min(target, cap), multiple), cap)


def bucket_ladder(cap: int, multiple: int = 1) -> List[int]:
    """Every bucket :func:`bucket_target` can return for ``n`` in
    ``[1, cap]``: the powers of two below ``cap`` plus ``cap`` itself,
    each rounded up to ``multiple`` (deduplicated — small pow2 buckets
    collapse onto the multiple). Derived directly, in O(log cap)."""
    cap = _effective_cap(cap, multiple)
    multiple = max(int(multiple), 1)
    if cap <= 1:
        return [bucket_target(1, cap, multiple=multiple)]
    ladder = []
    b = 1
    while b < cap:
        t = round_to_multiple(b, multiple)
        if not ladder or ladder[-1] != t:
            ladder.append(t)
        b *= 2
    if not ladder or ladder[-1] != cap:
        ladder.append(cap)
    return ladder


def padded_device_batch(chunk: np.ndarray, size: int, placement=None,
                        put=None, bucket: bool = False, axis: int = 0,
                        pad_value=0, pad_mode: str = "constant",
                        multiple: int = 1,
                        ) -> Tuple[Any, int]:
    """Pad a batch to its static shape and (optionally) place it on a
    device.

    ``bucket=True`` pads to the shape bucket of cap ``size`` (the
    serving data plane), else to a multiple of ``size``. Returns
    ``(padded, original_length)``; with ``placement`` (a device) the
    padded array is uploaded via ``put`` (default
    ``torch.as_tensor(padded).to(placement)``), else it stays numpy.
    """
    if bucket:
        padded, n = pad_to_bucket(chunk, cap=size, axis=axis,
                                  pad_value=pad_value, pad_mode=pad_mode,
                                  multiple=multiple)
    else:
        padded, n = pad_to_multiple(chunk, size, axis=axis,
                                    pad_value=pad_value, pad_mode=pad_mode)
    if placement is not None:
        if put is None:
            def put(a, device):
                return torch.as_tensor(a).to(device)
        padded = put(padded, placement)
    return padded, n


def unpad(arr, n: int, axis: int = 0):
    """Slice padding back off (host- or device-side)."""
    index = [slice(None)] * arr.ndim
    index[axis] = slice(0, n)
    return arr[tuple(index)]


# ---------------------------------------------------------------------------
# the batch's shard for a rank of a mesh


def _coord(mesh: Mesh, rank: int, axis: str) -> int:
    return (mesh.coords(rank)[mesh.axis_names.index(axis)]
            if axis in mesh.shape else 0)


def _rank_of(mesh: Mesh, coords: Dict[str, int]) -> int:
    return mesh.rank_at([coords.get(a, 0) for a in mesh.axis_names])


def shard_batch(batch: Dict[str, Any], mesh: Mesh, axis: str = AXIS_DATA,
                pad_value=0, seq_axis: str = AXIS_SEQ
                ) -> Tuple[Dict[str, torch.Tensor], int]:
    """This process's ranks' blocks of a global batch (the JAX
    ``shard_batch``, with the sequence split the JAX ``shard_map`` makes
    over ``P(data, seq)``): each array's leading dim is padded with
    ``pad_value`` to a multiple of the ``axis`` size and split over it,
    and its second dim, where the mesh has ``seq_axis``, split over that
    (it must divide). Ranks that differ only on another axis (``model``,
    ``expert``, ``pipe``) get the same block: the batch is replicated
    over them. Returns ``({name: [n_hosted, rows, cols, ...]} on the
    mesh's device, the true row count)``."""
    n_rows = mesh.shape.get(axis, 1)
    n_seq = mesh.shape.get(seq_axis, 1)
    out: Dict[str, torch.Tensor] = {}
    n_true = None
    for name, arr in batch.items():
        x = torch.as_tensor(arr)
        n = x.shape[0]
        n_true = n if n_true is None else n_true
        extra = -n % n_rows
        if extra:
            x = torch.cat([x, x.new_full((extra, *x.shape[1:]), pad_value)])
        if n_seq > 1 and (x.dim() < 2 or x.shape[1] % n_seq):
            raise ValueError(f"{name}: sequence dim of shape "
                             f"{tuple(x.shape)} does not split over "
                             f"{seq_axis}={n_seq}")
        rows = x.shape[0] // n_rows
        blocks = []
        for r in mesh.ranks:
            d, c = _coord(mesh, r, axis), _coord(mesh, r, seq_axis)
            blk = x[d * rows:(d + 1) * rows]
            if n_seq > 1:
                cols = x.shape[1] // n_seq
                blk = blk[:, c * cols:(c + 1) * cols]
            blocks.append(blk)
        out[name] = torch.stack(blocks).to(mesh.device)
    return out, int(n_true or 0)


def gather_shards(local: torch.Tensor, mesh: Mesh, axis: str = AXIS_DATA,
                  seq_axis: str = AXIS_SEQ) -> torch.Tensor:
    """The inverse of :func:`shard_batch` for one array: per-rank blocks
    [n_hosted, rows, cols, ...] -> the global [rows * data, cols * seq,
    ...] array on every process (ranks that differ only on other axes
    hold copies; the first is taken). Differentiable on a hosted mesh;
    under ``torch.distributed`` an ``all_gather`` of every process's
    ranks, which are the world's ranks in order."""
    if mesh.hosted:
        blocks = list(local.unbind(0))
    else:
        blocks = [b for part in all_gather(local) for b in part.unbind(0)]
    n_rows = mesh.shape.get(axis, 1)
    n_seq = mesh.shape.get(seq_axis, 1)
    rows = []
    for d in range(n_rows):
        cols = [blocks[_rank_of(mesh, {axis: d, seq_axis: c})]
                for c in range(n_seq)]
        rows.append(torch.cat(cols, dim=1) if n_seq > 1 else cols[0])
    return torch.cat(rows, dim=0)
