"""Filesystem abstraction: local paths plus ``gs://``-style URLs.

The reference reads wasb/HDFS everywhere through Hadoop's filesystem
layer (`core/hadoop/src/main/scala/HadoopUtils.scala`; the HDFS model
repo in `ModelDownloader.scala`). The TPU-pod analogue is fsspec: any
``protocol://`` path (``gs://``, ``s3://``, ``memory://``, ...) is
routed through the matching fsspec filesystem, while plain paths keep
using the local OS calls. Callers never touch fsspec directly — these
helpers are the single seam.

fsspec is baked into the image; if it's ever absent, remote URLs raise
with a clear message and local paths keep working.
"""

from __future__ import annotations

import fnmatch
import os
import posixpath
from typing import Iterator, List, Optional, Tuple


def is_remote(path: str) -> bool:
    """True for ``protocol://`` URLs that should go through fsspec."""
    if "://" not in path:
        return False
    proto = path.split("://", 1)[0]
    return proto not in ("file",)


def _strip_file(path: str) -> str:
    return path[len("file://"):] if path.startswith("file://") else path


def get_fs(path: str) -> Tuple["object", str]:
    """(fsspec filesystem, protocol-stripped path) for a remote URL."""
    try:
        import fsspec
    except ImportError as e:  # pragma: no cover - fsspec is in the image
        raise ImportError(
            f"remote path {path!r} needs fsspec, which is unavailable") from e
    return fsspec.core.url_to_fs(path)


def join(base: str, *parts: str) -> str:
    """Path join that keeps URL separators for remote bases."""
    if is_remote(base):
        return posixpath.join(base, *parts)
    return os.path.join(base, *parts)


def isabs(path: str) -> bool:
    return is_remote(path) or os.path.isabs(_strip_file(path))


def exists(path: str) -> bool:
    if is_remote(path):
        fs, p = get_fs(path)
        return fs.exists(p)
    return os.path.exists(_strip_file(path))


def isfile(path: str) -> bool:
    if is_remote(path):
        fs, p = get_fs(path)
        return fs.isfile(p)
    return os.path.isfile(_strip_file(path))


def makedirs(path: str) -> None:
    if is_remote(path):
        fs, p = get_fs(path)
        fs.makedirs(p, exist_ok=True)
    else:
        os.makedirs(_strip_file(path), exist_ok=True)


def open_file(path: str, mode: str = "rb"):
    if is_remote(path):
        fs, p = get_fs(path)
        return fs.open(p, mode)
    return open(_strip_file(path), mode)


def read_bytes(path: str) -> bytes:
    with open_file(path, "rb") as f:
        return f.read()


def write_bytes(path: str, data: bytes) -> None:
    with open_file(path, "wb") as f:
        f.write(data)


def read_text(path: str) -> str:
    # Always read binary + decode UTF-8 so read_text/write_text are
    # symmetric regardless of the host locale.
    return read_bytes(path).decode("utf-8")


def write_text(path: str, text: str) -> None:
    write_bytes(path, text.encode())


def rm_tree(path: str) -> None:
    if is_remote(path):
        fs, p = get_fs(path)
        if fs.exists(p):
            fs.rm(p, recursive=True)
    else:
        import shutil
        shutil.rmtree(_strip_file(path), ignore_errors=True)


def find_files(path: str, recursive: bool = True,
               pattern: Optional[str] = None) -> Iterator[str]:
    """Matching files under ``path`` in global sorted order, as openable
    paths (remote results keep their protocol prefix)."""
    if is_remote(path):
        fs, p = get_fs(path)
        if fs.isfile(p):
            yield path
            return
        out: List[str] = []
        if recursive:
            names = fs.find(p)
        else:
            # one listing with types — per-entry isfile() would cost a
            # metadata round-trip each on object stores
            names = [e["name"] for e in fs.ls(p, detail=True)
                     if e.get("type") == "file"]
        for full in names:
            base = full.rsplit("/", 1)[-1]
            if pattern is None or fnmatch.fnmatch(base, pattern):
                out.append(fs.unstrip_protocol(full))
        yield from sorted(out)
        return

    path = _strip_file(path)
    if os.path.isfile(path):
        yield path
        return
    out = []
    if recursive:
        for root, _, files in os.walk(path):
            for f in files:
                if pattern is None or fnmatch.fnmatch(f, pattern):
                    out.append(os.path.join(root, f))
    else:
        for f in os.listdir(path):
            full = os.path.join(path, f)
            if os.path.isfile(full) and (pattern is None
                                         or fnmatch.fnmatch(f, pattern)):
                out.append(full)
    yield from sorted(out)


def walk_rel_files(path: str) -> Iterator[Tuple[str, str]]:
    """(relative posix path, openable full path) for every file under a
    directory tree, sorted — the traversal order contract used for
    directory hashing."""
    if is_remote(path):
        fs, p = get_fs(path)
        root = p.rstrip("/")
        for full in sorted(fs.find(root)):
            rel = full[len(root):].lstrip("/")
            yield rel, fs.unstrip_protocol(full)
    else:
        path = _strip_file(path)
        entries = []
        for root, _, files in os.walk(path):
            for f in files:
                full = os.path.join(root, f)
                rel = os.path.relpath(full, path).replace(os.sep, "/")
                entries.append((rel, full))
        yield from sorted(entries)


def copy_tree(src: str, dst: str) -> None:
    """Copy a directory tree across any local/remote combination."""
    if not is_remote(src) and not is_remote(dst):
        import shutil
        shutil.copytree(_strip_file(src), _strip_file(dst))
        return
    for rel, full in walk_rel_files(src):
        target = join(dst, rel)
        parent = target.rsplit("/", 1)[0]
        makedirs(parent)
        write_bytes(target, read_bytes(full))
