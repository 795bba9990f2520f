"""The shape-bucket ladder (the port's copy of ``bucket_target`` and
``bucket_ladder`` from ``mmlspark_tpu/parallel/sharding.py``, for the
unsharded case the decode plane uses). Prompts pad to these buckets, so
the decode plane serves a small, fixed set of prefill shapes."""

from __future__ import annotations

from typing import List


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
