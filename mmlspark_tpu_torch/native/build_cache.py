"""The build cache the port's two native builds share (``cuda_build``
for the CUDA kernels, ``loader`` for the host C++ reader): one
directory per digest of the compiler's flags and the sources, and an
atomic publish into it."""

from __future__ import annotations

import hashlib
import os
from pathlib import Path
from typing import Callable, Iterable


def digest_dir(root: Path, flags: Iterable[str], paths: Iterable[Path]) -> Path:
    """``root/<digest>``: the digest hashes the flags and each path's name
    and bytes, so an edited source rebuilds and an unchanged one is
    reused."""
    h = hashlib.sha256(" ".join(flags).encode())
    for path in paths:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return root / h.hexdigest()[:16]


def publish(target: Path, write: Callable[[Path], None]) -> Path:
    """``write(tmp)`` into a private name beside ``target``, then rename
    it into place: concurrent builders (pytest-xdist workers, two
    cold-starting services) never see a half-written library. A failed
    ``write`` leaves no temp file."""
    tmp = target.with_name(f"{target.name}.tmp{os.getpid()}")
    try:
        write(tmp)
    except BaseException:
        tmp.unlink(missing_ok=True)
        raise
    os.replace(tmp, target)
    return target
