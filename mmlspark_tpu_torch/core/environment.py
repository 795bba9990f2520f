"""Device resolution for the port's entry points.

Counterpart of ``mmlspark_tpu/core/environment.py``: the port runs on
the card unless its caller asks for the CPU, and it never falls back
silently — without CUDA, ``device=None`` raises.
"""

from __future__ import annotations

from typing import Optional, Union

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
