"""Whole-file binary reader: files -> (path, bytes) rows (the port of
``mmlspark_tpu/io/binary.py``, both engines: the host C++ reader of
``native/`` and the in-process Python one).

Capability parity with the reference's custom Hadoop FileFormat
(`io/binary/src/main/scala/BinaryFileFormat.scala:114`,
`BinaryRecordReader.scala:34`): read a directory tree as rows of
``(path, bytes)``, with zip-archive inspection (members become rows) and
record-level subsampling — against the local/NFS filesystem that backs
TPU VMs, or any ``gs://``-style remote URL through the fsspec layer
(`io/fs.py`; parity: the reference reads wasb/HDFS via `HadoopUtils`).
"""

from __future__ import annotations

import random
import zipfile
from typing import List, Optional

import numpy as np

from mmlspark_tpu_torch.core.dataframe import DataFrame

PATH_COL = "path"
BYTES_COL = "bytes"


def read_binary_files(path: str,
                      recursive: bool = True,
                      pattern: Optional[str] = None,
                      sample_ratio: float = 1.0,
                      inspect_zip: bool = True,
                      seed: int = 0,
                      engine: str = "auto") -> DataFrame:
    """Read files under ``path`` as a frame with ``path``/``bytes`` columns.

    Zip archives are expanded into one row per member, with paths like
    ``archive.zip/member`` (parity: zip inspection + subsampling at the
    record-reader level, `BinaryRecordReader.scala:34`).

    ``engine``: ``native`` uses the C++ prefetching reader
    (``native/src/binary_reader.cpp``, threads off the GIL; raises
    ``ValueError`` for a remote path and ``RuntimeError`` when it cannot
    build), ``python`` the in-process fallback, ``auto`` the native
    reader when it builds and the path is local, else Python. Both
    deliver records in sorted-path file order; the two engines draw
    different RNG streams for ``sample_ratio``, so sampled *subsets*
    (not semantics) differ between them, and ``auto`` samples as the
    JAX package's ``auto`` does wherever both build the C++ reader.
    """
    if engine not in ("auto", "native", "python"):
        raise ValueError(f"unknown engine {engine!r}")
    from mmlspark_tpu_torch.io import fs
    if not fs.exists(path):
        # both engines would otherwise silently yield an empty frame
        # (os.walk and the native scanner both swallow missing roots)
        raise FileNotFoundError(path)
    use_native = False
    if engine in ("auto", "native"):
        if fs.is_remote(path):
            # the C++ reader only scans the local filesystem
            if engine == "native":
                raise ValueError(
                    f"engine='native' cannot read remote path {path!r}")
        else:
            from mmlspark_tpu_torch.native import native_available
            use_native = native_available()
            if engine == "native" and not use_native:
                raise RuntimeError(
                    "native reader unavailable (no g++/zlib?)")

    paths: List[str] = []
    blobs: List[bytes] = []
    if use_native:
        from mmlspark_tpu_torch.native import native_read_records
        for p, data in native_read_records(
                path, recursive=recursive, pattern=pattern,
                sample_ratio=sample_ratio, inspect_zip=inspect_zip,
                seed=seed):
            paths.append(p)
            blobs.append(data)
    else:
        rng = random.Random(seed)

        def emit(p: str, data: bytes) -> None:
            if sample_ratio >= 1.0 or rng.random() < sample_ratio:
                paths.append(p)
                blobs.append(data)

        for fp in fs.find_files(path, recursive, pattern):
            if inspect_zip and fp.lower().endswith(".zip"):
                # both local and fsspec file objects are seekable
                with fs.open_file(fp, "rb") as fh, \
                        zipfile.ZipFile(fh) as zf:
                    for name in zf.namelist():
                        if name.endswith("/"):
                            continue
                        emit(f"{fp}/{name}", zf.read(name))
            else:
                emit(fp, fs.read_bytes(fp))

    return DataFrame({
        PATH_COL: np.array(paths, dtype=object),
        BYTES_COL: np.array(blobs, dtype=object),
    })
