"""ctypes binding for the native binary-file reader (the port's copy of
``mmlspark_tpu/native/binary.py``, over ``native/src/binary_reader.cpp``).

Same record semantics as the pure-Python reader in ``io/binary.py``
(whole files and zip members as ``(path, bytes)``, deterministic
sorted-path order), but the scan/read/unzip/sample pipeline runs in
native threads off the GIL with bounded prefetch.
"""

from __future__ import annotations

import ctypes
from typing import Iterator, Optional, Tuple

from mmlspark_tpu_torch.native.loader import NativeLoader


def _bind():
    lib = NativeLoader.load_library_by_name("mmlbinary")
    lib.mml_open_reader.restype = ctypes.c_void_p
    lib.mml_open_reader.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_double,
        ctypes.c_uint64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ]
    lib.mml_next_record.restype = ctypes.c_int
    lib.mml_next_record.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_char_p),
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int64),
    ]
    lib.mml_last_error.restype = ctypes.c_char_p
    lib.mml_last_error.argtypes = [ctypes.c_void_p]
    lib.mml_close_reader.argtypes = [ctypes.c_void_p]
    return lib


def native_read_records(path: str,
                        recursive: bool = True,
                        pattern: Optional[str] = None,
                        sample_ratio: float = 1.0,
                        inspect_zip: bool = True,
                        seed: int = 0,
                        n_threads: int = 8,
                        prefetch_files: int = 16,
                        ) -> Iterator[Tuple[str, bytes]]:
    """Yield ``(path, bytes)`` records via the native prefetching reader."""
    import os
    if not os.path.exists(path):  # engine parity: python engine raises too
        raise FileNotFoundError(path)
    lib = _bind()
    handle = lib.mml_open_reader(
        path.encode(), int(recursive),
        pattern.encode() if pattern else None,
        float(sample_ratio), seed, int(inspect_zip),
        n_threads, prefetch_files)
    if not handle:
        raise RuntimeError("mml_open_reader failed")
    try:
        p = ctypes.c_char_p()
        d = ctypes.c_void_p()
        n = ctypes.c_int64()
        while True:
            rc = lib.mml_next_record(handle, ctypes.byref(p),
                                     ctypes.byref(d), ctypes.byref(n))
            if rc == 0:
                return
            if rc < 0:
                raise IOError(lib.mml_last_error(handle).decode())
            data = ctypes.string_at(d.value, n.value) if n.value else b""
            yield p.value.decode(), data
    finally:
        lib.mml_close_reader(handle)
