"""The kernel wrappers' shared plumbing: argument checks and the ctypes
launch of a C entry of the kernel library (:mod:`.cuda_build`).

Every wrapper checks its tensors with :func:`check` before it hands a
pointer to native code, and launches through :func:`launch`, which
calls the C launcher on the device's current stream and raises on a
nonzero ``cudaGetLastError()``.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Sequence

import torch

from mmlspark_tpu_torch.native import cuda_build

P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

#: the input dtypes the kernels are instantiated for, as the C
#: interface's codes (``kMmtF32``, ``kMmtBF16`` in ``csrc/common.cuh``)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_bound: Dict[str, object] = {}


def bind(entry: str, argtypes: Sequence, lib: ctypes.CDLL) -> None:
    """Route every later :func:`launch` of ``entry`` to ``lib``'s function
    of that name: the library :mod:`.cuda_build` makes, or one built from
    another tree's sources with the same C interface (``chip_smoke.py
    --ab`` times two builds of a kernel in one process this way)."""
    fn = getattr(lib, entry)
    fn.argtypes = [*argtypes, P]
    fn.restype = ctypes.c_int
    lib.mmt_error_string.argtypes = [ctypes.c_int]
    lib.mmt_error_string.restype = ctypes.c_char_p
    _bound[entry] = (fn, lib.mmt_error_string)


def launch(entry: str, argtypes: Sequence, device: torch.device,
           *args) -> None:
    """Call the C launcher ``entry`` (``argtypes`` without the trailing
    stream pointer) on ``device``'s current stream; raise on a nonzero
    ``cudaGetLastError()``."""
    if entry not in _bound:
        bind(entry, argtypes, cuda_build.load())
    fn, error_string = _bound[entry]
    rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc:
        raise RuntimeError(f"{entry} failed to launch: CUDA error {rc} "
                           f"({error_string(rc).decode()})")


def check(name: str, t, dtype: torch.dtype, shape, device) -> None:
    """``t`` must be a contiguous ``dtype`` tensor on ``device`` whose
    shape matches ``shape`` (``None`` entries match any size)."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if len(shape) != t.dim() or any(
            s is not None and s != got for s, got in zip(shape, t.shape)):
        want = tuple("*" if s is None else s for s in shape)
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {want}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def device_of(name: str, t) -> torch.device:
    """The device a wrapper runs on: its first tensor's, CPU or CUDA."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t.device}")
    return t.device
