"""Batched image ops on NHWC tensors: the OpenCV-replacement compute path.

The port of ``mmlspark_tpu/ops/image.py``. Every op maps over an NHWC
batch of same-shaped images on the tensor's device (an HWC image is
taken as a batch of one and returned unbatched); variable-shape
columns are bucketed one level up (``stages/image.py``). Convention as
in JAX: float32 NHWC in [0, 255] inside pipelines, channel order RGB.

``resize`` follows ``jax.image.resize`` rather than
``F.interpolate``, whose antialias follows PIL's filter and parts from
JAX when downscaling: per spatial axis it builds JAX's weight matrix
(``compute_weight_mat``: the method's kernel, its width scaled by
``max(1 / scale, 1)`` under antialias, weights normalised per output
sample, zero where the sample falls outside the input) and applies the
two matrices as f32 ``einsum``s; ``"nearest"`` gathers JAX's f32
offsets. The depthwise blurs pad by replication and run
``F.conv2d(groups=C)`` in f32 (TF32 off on the card).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Sequence, Tuple

import torch
import torch.nn.functional as F

# OpenCV-compatible constants (parity: ImageTransformer.scala threshold/flip)
THRESH_BINARY = 0
THRESH_BINARY_INV = 1
THRESH_TRUNC = 2
THRESH_TOZERO = 3
THRESH_TOZERO_INV = 4

FLIP_VERTICAL = 0    # flip around x-axis
FLIP_HORIZONTAL = 1  # flip around y-axis
FLIP_BOTH = -1


def ieee_f32():
    """The models' full-f32 scope (TF32 off on the card), imported
    at call time: ``models`` imports the image stages, which import
    this module."""
    from mmlspark_tpu_torch.models.function import ieee_f32 as scope
    return scope()


def _as_batch(images: torch.Tensor) -> Tuple[torch.Tensor, bool]:
    """Accept HWC or NHWC; return NHWC plus whether input was single."""
    if images.ndim == 3:
        return images[None], True
    if images.ndim != 4:
        raise ValueError(f"expected HWC or NHWC, got shape "
                         f"{tuple(images.shape)}")
    return images, False


def _unbatch(out: torch.Tensor, single: bool) -> torch.Tensor:
    return out[0] if single else out


# -- resize: jax.image.resize's weight matrices -------------------------------

def _lanczos(radius: float) -> Callable[[torch.Tensor], torch.Tensor]:
    def kernel(x):
        y = radius * torch.sin(math.pi * x) * torch.sin(math.pi * x / radius)
        denom = torch.where(x != 0, math.pi ** 2 * x ** 2,
                            torch.ones_like(x))
        out = torch.where(x > 1e-3, y / denom, torch.ones_like(x))
        return torch.where(x > radius, torch.zeros_like(x), out)
    return kernel


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def _triangle(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(1.0 - x.abs(), 0.0)


_KERNELS: Dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "linear": _triangle, "lanczos3": _lanczos(3.0),
    "lanczos5": _lanczos(5.0), "cubic": _keys_cubic,
}
#: jax.image.ResizeMethod.from_string's names
_METHODS = {"nearest": "nearest", "linear": "linear", "bilinear": "linear",
            "trilinear": "linear", "triangle": "linear",
            "lanczos3": "lanczos3", "lanczos5": "lanczos5",
            "cubic": "cubic", "bicubic": "cubic", "tricubic": "cubic"}


def _method(name: str) -> str:
    if name not in _METHODS:
        raise ValueError(f'Unknown resize method "{name}"')
    return _METHODS[name]


def resize_weights(input_size: int, output_size: int, method: str,
                   antialias: bool, device=None) -> torch.Tensor:
    """JAX's ``compute_weight_mat`` in f32: ``(input_size,
    output_size)`` weights of the input samples for each output one."""
    kernel = _KERNELS[_method(method)]
    scale = output_size / input_size
    inv_scale = 1.0 / scale
    kernel_scale = max(inv_scale, 1.0) if antialias else 1.0
    f32 = dict(dtype=torch.float32, device=device)
    sample_f = (torch.arange(output_size, **f32) + 0.5) * inv_scale - 0.5
    x = (sample_f[None, :] - torch.arange(input_size, **f32)[:, None]
         ).abs() / kernel_scale
    weights = kernel(x)
    total = weights.sum(dim=0, keepdim=True)
    weights = torch.where(
        total.abs() > 1000.0 * float(torch.finfo(torch.float32).eps),
        weights / torch.where(total != 0, total, torch.ones_like(total)),
        torch.zeros_like(weights))
    inside = (sample_f >= -0.5) & (sample_f <= input_size - 0.5)
    return torch.where(inside[None, :], weights, torch.zeros_like(weights))


def _resize_nearest(x: torch.Tensor, height: int, width: int
                    ) -> torch.Tensor:
    for dim, n in ((1, height), (2, width)):
        m = x.shape[dim]
        if m == n:
            continue
        offsets = torch.floor((torch.arange(n, dtype=torch.float32,
                                            device=x.device) + 0.5)
                              * m / n).to(torch.long)
        x = x.index_select(dim, offsets)
    return x


def resize(images: torch.Tensor, height: int, width: int,
           method: str = "linear", antialias: bool = True) -> torch.Tensor:
    """Resize an NHWC batch to (height, width) as ``jax.image.resize``
    does (every method it takes; f32 out). Parity: Imgproc.resize."""
    x, single = _as_batch(images)
    x = x.to(torch.float32)
    if _method(method) == "nearest":
        return _unbatch(_resize_nearest(x, height, width), single)
    with ieee_f32():
        if x.shape[1] != height:
            wh = resize_weights(x.shape[1], height, method, antialias,
                                x.device)
            x = torch.einsum("nhwc,hy->nywc", x, wh)
        if x.shape[2] != width:
            ww = resize_weights(x.shape[2], width, method, antialias,
                                x.device)
            x = torch.einsum("nhwc,wx->nhxc", x, ww)
    return _unbatch(x, single)


# -- crops and flips ----------------------------------------------------------

def center_crop(images: torch.Tensor, height: int, width: int
                ) -> torch.Tensor:
    x, single = _as_batch(images)
    h, w = x.shape[1], x.shape[2]
    top = max((h - height) // 2, 0)
    left = max((w - width) // 2, 0)
    return _unbatch(x[:, top:top + height, left:left + width, :], single)


def crop(images: torch.Tensor, x0: int, y0: int,
         height: int, width: int) -> torch.Tensor:
    """Crop at (x0, y0). Parity: CropImage stage (x,y,height,width params)."""
    x, single = _as_batch(images)
    return _unbatch(x[:, y0:y0 + height, x0:x0 + width, :], single)


def flip(images: torch.Tensor, flip_code: int = FLIP_HORIZONTAL
         ) -> torch.Tensor:
    """Parity: Core.flip with OpenCV flip codes."""
    x, single = _as_batch(images)
    dims = {FLIP_VERTICAL: (1,), FLIP_HORIZONTAL: (2,),
            FLIP_BOTH: (1, 2)}.get(flip_code)
    if dims is None:
        raise ValueError(f"bad flip code {flip_code}")
    return _unbatch(torch.flip(x, dims), single)


# -- filters ------------------------------------------------------------------

def _depthwise_conv(x: torch.Tensor, kernel2d: torch.Tensor
                    ) -> torch.Tensor:
    """Depthwise 2D convolution of NHWC by one 2D kernel, replicate
    borders (OpenCV's default border: constant regions stay constant
    at the edges)."""
    kh, kw = kernel2d.shape
    top, bottom = (kh - 1) // 2, kh // 2
    left, right = (kw - 1) // 2, kw // 2
    y = x.to(torch.float32).permute(0, 3, 1, 2)
    y = F.pad(y, (left, right, top, bottom), mode="replicate")
    c = y.shape[1]
    k = kernel2d.to(device=y.device, dtype=torch.float32)[None, None].expand(
        c, 1, kh, kw)
    with ieee_f32():
        out = F.conv2d(y, k, groups=c)
    return out.permute(0, 2, 3, 1)


def box_blur(images: torch.Tensor, kh: int, kw: int) -> torch.Tensor:
    """Normalized box filter. Parity: Imgproc.blur."""
    x, single = _as_batch(images)
    kernel = torch.full((kh, kw), 1.0 / (kh * kw), dtype=torch.float32)
    return _unbatch(_depthwise_conv(x, kernel), single)


def gaussian_kernel(radius: int, sigma: float) -> torch.Tensor:
    """2D Gaussian kernel. Parity: GaussianKernel stage (radius, sigma)."""
    ax = torch.arange(-radius, radius + 1, dtype=torch.float32)
    g = torch.exp(-(ax ** 2) / (2.0 * sigma ** 2))
    k = torch.outer(g, g)
    return k / k.sum()


def gaussian_blur(images: torch.Tensor, radius: int, sigma: float
                  ) -> torch.Tensor:
    x, single = _as_batch(images)
    return _unbatch(_depthwise_conv(x, gaussian_kernel(radius, sigma)),
                    single)


def threshold(images: torch.Tensor, thresh: float, max_val: float = 255.0,
              threshold_type: int = THRESH_BINARY) -> torch.Tensor:
    """Parity: Imgproc.threshold with the five OpenCV modes (f32 out,
    as JAX's weak-typed ``where`` gives)."""
    x, single = _as_batch(images)
    x = x.to(torch.float32)
    above = x > thresh

    def full(v):
        return torch.full_like(x, float(v))
    if threshold_type == THRESH_BINARY:
        out = torch.where(above, full(max_val), full(0.0))
    elif threshold_type == THRESH_BINARY_INV:
        out = torch.where(above, full(0.0), full(max_val))
    elif threshold_type == THRESH_TRUNC:
        out = torch.where(above, full(thresh), x)
    elif threshold_type == THRESH_TOZERO:
        out = torch.where(above, x, full(0.0))
    elif threshold_type == THRESH_TOZERO_INV:
        out = torch.where(above, full(0.0), x)
    else:
        raise ValueError(f"bad threshold type {threshold_type}")
    return _unbatch(out, single)


# -- colour -------------------------------------------------------------------

def to_grayscale(images: torch.Tensor) -> torch.Tensor:
    """RGB -> single-channel luma. Parity: Imgproc.cvtColor COLOR_*2GRAY."""
    x, single = _as_batch(images)
    weights = torch.tensor([0.299, 0.587, 0.114], dtype=torch.float32,
                           device=x.device)
    with ieee_f32():
        out = torch.tensordot(x.to(torch.float32), weights,
                              dims=([3], [0]))[..., None]
    return _unbatch(out, single)


def swap_rb(images: torch.Tensor) -> torch.Tensor:
    """RGB<->BGR. Parity: cvtColor COLOR_BGR2RGB / RGB2BGR."""
    x, single = _as_batch(images)
    return _unbatch(torch.flip(x, (3,)), single)


def color_format(images: torch.Tensor, fmt: str) -> torch.Tensor:
    fmt = fmt.lower()
    if fmt in ("gray", "grey", "grayscale"):
        return to_grayscale(images)
    if fmt in ("bgr", "rgb_to_bgr", "bgr_to_rgb", "swap_rb"):
        return swap_rb(images)
    if fmt in ("rgb", "identity"):
        return images
    raise ValueError(f"unknown color format {fmt!r}")


def normalize(images: torch.Tensor, mean: Sequence[float],
              std: Sequence[float], scale: float = 1.0) -> torch.Tensor:
    """(x*scale - mean)/std per channel — standard model preprocessing."""
    x, single = _as_batch(images)
    m = torch.tensor(mean, dtype=torch.float32, device=x.device)
    s = torch.tensor(std, dtype=torch.float32, device=x.device)
    return _unbatch((x.to(torch.float32) * scale - m) / s, single)


# -- vectors ------------------------------------------------------------------

def unroll(images: torch.Tensor) -> torch.Tensor:
    """Flatten NHWC images to (N, C*H*W) vectors in CHW order.

    Parity: UnrollImage's CHW unroll to DenseVector
    (`UnrollImage.scala:21,84` — feature vector layout models expect).
    """
    x, single = _as_batch(images)
    n, h, w, c = x.shape
    out = x.permute(0, 3, 1, 2).reshape(n, c * h * w)
    return out[0] if single else out


def reroll(vectors: torch.Tensor, height: int, width: int,
           channels: int) -> torch.Tensor:
    """Inverse of :func:`unroll`: (N, C*H*W) -> NHWC."""
    single = vectors.ndim == 1
    v = vectors[None] if single else vectors
    x = v.reshape(v.shape[0], channels, height, width).permute(0, 2, 3, 1)
    return x[0] if single else x
