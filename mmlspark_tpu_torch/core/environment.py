"""Device resolution for the port's entry points.

Counterpart of ``mmlspark_tpu/core/environment.py``: the port runs on
the card unless its caller asks for the CPU, and it never falls back
silently — without CUDA, ``device=None`` raises. :func:`environment_info`
describes the card and the host, to stamp recorded numbers.
"""

from __future__ import annotations

import os
import platform as _platform
from typing import Any, Dict, Optional, Union

import torch

DeviceLike = Union[None, str, torch.device]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda`` (raising when CUDA is absent); otherwise the
    named device, which must be ``cpu`` or an available ``cuda``."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the card by default; "
                "pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not "
                           f"available; pass device='cpu' for the CPU")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev} (cpu or cuda)")
    return dev


def cuda_sm90_available(device: Optional[int] = None) -> bool:
    """Whether a Hopper-class card (compute capability >= 9.0), the
    target of the port's kernels, is present."""
    if not torch.cuda.is_available():
        return False
    return torch.cuda.get_device_capability(device) >= (9, 0)


def environment_info() -> Dict[str, Any]:
    """One JSON-able dict describing the card and the host (the JAX
    function's keys, with torch's versions in place of jax's): the
    platform (``gpu`` or ``cpu``), the card's name as torch reports it
    (``cpu`` without CUDA), the card count, this process's rank, and,
    with CUDA, the card's memory."""
    from mmlspark_tpu_torch.core.profiling import device_memory_stats
    cuda = torch.cuda.is_available()
    dist = torch.distributed.is_available() and \
        torch.distributed.is_initialized()
    info: Dict[str, Any] = {
        "platform": "gpu" if cuda else "cpu",
        "device_kind": torch.cuda.get_device_name(0) if cuda else "cpu",
        "n_devices": torch.cuda.device_count() if cuda else 1,
        "process_index": torch.distributed.get_rank() if dist else 0,
        "process_count": torch.distributed.get_world_size() if dist else 1,
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "host": {
            "os": _platform.system(),
            "machine": _platform.machine(),
            "python": _platform.python_version(),
            "cpu_count": os.cpu_count(),
        },
    }
    mem = device_memory_stats()
    if mem:
        info["memory"] = mem
    return info


def accelerator_count() -> int:
    """The number of CUDA cards visible to this process (0 on a host
    without CUDA); the JAX package counts its non-CPU devices."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def describe() -> str:
    """Human-readable one-liner for logs: platform/kind/counts/memory."""
    info = environment_info()
    parts = [f"{info['platform']}:{info['device_kind']}",
             f"{info['n_devices']} device(s)"]
    if info["process_count"] > 1:
        parts.append(f"process {info['process_index']}/"
                     f"{info['process_count']}")
    mem = info.get("memory")
    if mem and "bytes_limit" in mem:
        parts.append(f"{mem['bytes_limit'] / 2**30:.1f} GiB/device")
    return ", ".join(parts)
