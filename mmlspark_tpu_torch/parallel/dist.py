"""Per-process input plumbing (the port of ``process_local_rows`` from
``mmlspark_tpu/parallel/dist.py``)."""

from __future__ import annotations

from typing import Tuple

from mmlspark_tpu_torch.parallel.topology import AXIS_DATA, Mesh


def process_local_rows(n_global: int, mesh: Mesh, axis: str = AXIS_DATA
                       ) -> Tuple[int, int]:
    """``(start, stop)`` of this process's row slice of a global batch
    sharded over ``axis``: each process loads only rows ``[start,
    stop)``. A hosted mesh's one process loads every row; under
    ``torch.distributed`` the slice follows the process's coordinate on
    ``axis`` (processes that differ only on ``seq`` load the same rows,
    and each takes its part of the sequence, :func:`~.sharding.shard_batch`)."""
    n = mesh.shape.get(axis, 1)
    if mesh.hosted or n == 1:
        return 0, n_global
    if n_global % n:
        raise ValueError(f"global batch {n_global} not divisible by the "
                         f"{axis} axis size {n}")
    per = n_global // n
    c = mesh.coords(mesh.rank)[mesh.axis_names.index(axis)]
    return c * per, (c + 1) * per
