"""Whole-file binary reader: files -> (path, bytes) rows (the port of
``mmlspark_tpu/io/binary.py``, its Python engine).

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

    ``engine`` keeps the JAX signature: ``auto`` and ``python`` read in
    process (records in sorted-path file order); ``native`` (JAX's C++
    prefetching reader) has no counterpart in the port and raises.
    """
    if engine not in ("auto", "native", "python"):
        raise ValueError(f"unknown engine {engine!r}")
    if engine == "native":
        raise ValueError("engine='native' is the JAX package's C++ "
                         "reader; the port reads with engine='python'")
    from mmlspark_tpu_torch.io import fs
    if not fs.exists(path):
        # os.walk would otherwise silently yield an empty frame
        raise FileNotFoundError(path)

    paths: List[str] = []
    blobs: List[bytes] = []
    rng = random.Random(seed)

    def emit(p: str, data: bytes) -> None:
        if sample_ratio >= 1.0 or rng.random() < sample_ratio:
            paths.append(p)
            blobs.append(data)

    for fp in fs.find_files(path, recursive, pattern):
        if inspect_zip and fp.lower().endswith(".zip"):
            # both local and fsspec file objects are seekable
            with fs.open_file(fp, "rb") as fh, zipfile.ZipFile(fh) as zf:
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
