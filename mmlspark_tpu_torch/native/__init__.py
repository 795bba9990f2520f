"""Native code of the port: ``cuda_build`` and ``launch`` build and
launch the hand-written CUDA kernels (``csrc/``); ``loader`` and
``binary`` build the host C++ binary-file reader (``native/src``) with
``g++`` at first use and bind it over ``ctypes``."""

from mmlspark_tpu_torch.native.loader import NativeLoader, native_available
from mmlspark_tpu_torch.native.binary import native_read_records

__all__ = ["NativeLoader", "native_available", "native_read_records"]
