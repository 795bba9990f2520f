"""Build and load the port's hand-written CUDA kernels.

The kernels ship as CUDA C++ sources under ``mmlspark_tpu_torch/csrc``
with a plain C interface (no PyTorch headers, so a build takes seconds).
At first use ``nvcc`` compiles every ``csrc/*.cu`` for Hopper
(``sm_90a``), one process per source, all started at once, and links
the objects into one shared library under
``mmlspark_tpu_torch/_build/<digest>/``; the digest hashes the sources,
the headers and the flags, so an edited source rebuilds and an
unchanged one is reused. The library loads through ``ctypes``. Nothing
here runs at import time, and nothing falls back: a missing ``nvcc`` or
a failed compile raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
LIB_NAME = "libmmlspark_tpu_torch_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc`` (default ``/usr/local/cuda``), else the
    ``nvcc`` on ``PATH``."""
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the port's kernels need the "
                           "CUDA toolkit (set CUDA_HOME)")
    return found


def _digest(sources, headers) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in (*sources, *headers):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile and link the kernels unless the current sources are
    already built; returns the library's path. The compilers' output
    (``-Xptxas -v``: registers, shared memory, spills) lands in
    ``build.log`` beside the library."""
    sources = sorted(CSRC_DIR.glob("*.cu"))
    headers = sorted(CSRC_DIR.glob("*.cuh"))
    out_dir = BUILD_DIR / _digest(sources, headers)
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    pid = os.getpid()
    jobs = []
    for src in sources:
        obj = out_dir / f"{src.stem}.{pid}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC_DIR), "-c", "-o", str(obj),
               str(src)]
        jobs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs, failed = [], []
    for src, _, proc in jobs:
        out, _ = proc.communicate()
        logs.append(f"== {src.name} (rc={proc.returncode})\n{out}")
        if proc.returncode:
            failed.append(f"{src.name}:\n{out[-3000:]}")
    objs = [obj for _, obj, _ in jobs]
    try:
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
        # link to a private name, then publish atomically: a concurrent
        # loader never sees a half-written library
        tmp = out_dir / f"{LIB_NAME}.tmp{pid}"
        link = subprocess.run([nvcc, "-shared", "-o", str(tmp),
                               *map(str, objs)], capture_output=True,
                              text=True)
        logs.append(f"== link (rc={link.returncode})\n{link.stdout}"
                    f"{link.stderr}")
        if link.returncode:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc link failed:\n{link.stderr[-3000:]}")
        os.replace(tmp, lib)
    finally:
        (out_dir / "build.log").write_text("\n".join(logs))
        for obj in objs:
            obj.unlink(missing_ok=True)
    return lib


def load() -> ctypes.CDLL:
    """The kernel library, built at the first call."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = ctypes.CDLL(str(build()))
        return _lib
