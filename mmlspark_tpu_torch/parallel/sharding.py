"""Batch placement (the port's ``mmlspark_tpu/parallel/sharding.py``).

The shape-bucket ladder (copies of ``bucket_target`` and
``bucket_ladder``, for the unsharded case the decode plane uses):
prompts pad to these buckets, so the decode plane serves a small, fixed
set of prefill shapes. And a global batch's blocks for the ranks of a
(data, seq) :class:`~.topology.Mesh` (:func:`shard_batch`) and back
(:func:`gather_shards`).
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch
import torch.distributed as dist

from mmlspark_tpu_torch.parallel.topology import AXIS_DATA, AXIS_SEQ, Mesh


def bucket_target(n: int, cap: int = 1024) -> int:
    """The bucket ``n`` rows pad to: the next power of two, clamped at
    ``cap``; above ``cap``, the next multiple of ``cap``."""
    cap = int(cap)
    if n <= 0:
        return 1
    if n > cap:
        return -(-int(n) // cap) * cap
    target = 1
    while target < n:
        target *= 2
    return min(target, cap)


def bucket_ladder(cap: int) -> List[int]:
    """Every bucket :func:`bucket_target` can return for ``n`` in
    ``[1, cap]``: the powers of two below ``cap`` plus ``cap`` itself."""
    cap = int(cap)
    ladder: List[int] = []
    b = 1
    while b < cap:
        ladder.append(b)
        b *= 2
    ladder.append(max(cap, 1))
    return ladder


# ---------------------------------------------------------------------------
# the batch's shard for a rank of a (data, seq) mesh


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
    (it must divide). Returns ``({name: [n_hosted, rows, cols, ...]} on
    the mesh's device, the true row count)``."""
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
    under ``torch.distributed`` an ``all_gather``."""
    if mesh.hosted:
        blocks = list(local.unbind(0))
    else:
        blocks = [torch.empty_like(local[0]) for _ in range(mesh.size)]
        dist.all_gather(blocks, local[0].contiguous())
    n_rows = mesh.shape.get(axis, 1)
    n_seq = mesh.shape.get(seq_axis, 1)
    rows = []
    for d in range(n_rows):
        cols = [blocks[_rank_of(mesh, {axis: d, seq_axis: c})]
                for c in range(n_seq)]
        rows.append(torch.cat(cols, dim=1) if n_seq > 1 else cols[0])
    return torch.cat(rows, dim=0)
