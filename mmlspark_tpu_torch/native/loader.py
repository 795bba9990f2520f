"""Build and load the bundled host C++ runtime components (the port's copy
of ``mmlspark_tpu/native/loader.py``).

Parity: `core/env/src/main/scala/NativeLoader.java:28,48-62` — the
reference extracts named ``.so``s from jar resources and ``System.load``s
them, preferring ``java.library.path``. The port ships the C++ *sources*
(``native/src``) and compiles them with ``g++`` on first use. These are
host libraries, not kernels: they run on the CPU beside the card.

Search order for ``load_library_by_name(name)``:

1. ``$MMLSPARK_TPU_NATIVE_DIR/lib<name>.so`` (an operator's prebuilt
   library, the ``java.library.path`` analogue);
2. ``mmlspark_tpu_torch/_build/host/<digest>/lib<name>.so``, where the
   digest hashes the source and the compiler's flags, so an edited
   source rebuilds and an unchanged one is reused (``build_cache``,
   shared with ``cuda_build``);
3. a fresh ``g++`` build into that directory (``SOURCE``).

A failed load is remembered (a negative cache), so a machine without a
compiler does not run ``g++`` on every read.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict

from mmlspark_tpu_torch.native.build_cache import digest_dir, publish

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = Path(__file__).resolve().parent / "src"
BUILD_DIR = _PKG / "_build" / "host"
#: the one bundled library, its source and its link flags
LIB = "mmlbinary"
SOURCE = SRC_DIR / "binary_reader.cpp"
CXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC", "-pthread")
LINK_FLAGS = ("-lz",)

_lock = threading.Lock()
# name -> CDLL, or the Exception a previous attempt raised (negative cache:
# a missing toolchain must not re-run g++ on every read)
_cache: Dict[str, object] = {}


class NativeLoader:
    """Loads (building if needed) a named native library."""

    @staticmethod
    def load_library_by_name(name: str) -> ctypes.CDLL:
        with _lock:
            hit = _cache.get(name)
            if isinstance(hit, ctypes.CDLL):
                return hit
            if isinstance(hit, Exception):
                raise hit
            try:
                lib = ctypes.CDLL(_find_or_build(name))
            except Exception as e:
                _cache[name] = e
                raise
            _cache[name] = lib
            return lib


def _find_or_build(name: str) -> str:
    so_name = f"lib{name}.so"
    override = os.environ.get("MMLSPARK_TPU_NATIVE_DIR")
    if override:
        cand = os.path.join(override, so_name)
        if os.path.exists(cand):
            return cand
    if name != LIB:
        raise FileNotFoundError(f"unknown native library {name!r}")
    out_dir = digest_dir(BUILD_DIR, (*CXX_FLAGS, *LINK_FLAGS), [SOURCE])
    built = out_dir / so_name
    if built.exists():
        return str(built)
    out_dir.mkdir(parents=True, exist_ok=True)

    def compile_to(tmp: Path) -> None:
        cmd = ["g++", *CXX_FLAGS, str(SOURCE), "-o", str(tmp), *LINK_FLAGS]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
        except OSError as e:        # no g++ on PATH
            raise RuntimeError(f"native build of {name} failed: {e}") from e
        if proc.returncode != 0:
            raise RuntimeError(
                f"native build of {name} failed:\n{proc.stderr[-2000:]}")
    return str(publish(built, compile_to))


def native_available(name: str = LIB) -> bool:
    """True when the named native library can be loaded (builds on demand)."""
    try:
        NativeLoader.load_library_by_name(name)
        return True
    except Exception:
        return False
