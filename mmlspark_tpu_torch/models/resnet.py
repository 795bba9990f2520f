"""Flagship architectures: CIFAR ResNet + ConvNet, built as LayeredModels.

The port of ``mmlspark_tpu/models/resnet.py``, layer for layer and name
for name, so the JAX package's param trees load unchanged: NHWC frames,
pre-activation residual blocks with GroupNorm (no running statistics,
so one function serves scoring and feature extraction), and a linear
top-level chain whose block boundaries are named cut points.

Numerics follow flax's: convolutions pad "SAME" as XLA does (a
stride-2 3x3 conv on an even input pads (0, 1), the 7x7/2 stem (2, 3)),
the stem's max pool pads with -inf, GroupNorm's epsilon is 1e-6. A
``"bfloat16"`` architecture runs each conv in bf16 over its f32 params;
GroupNorm promotes to f32 and the logits layer ``z`` (no dtype) to f32,
as flax's dtype promotion does. An f32 architecture computes in f32 on
the card (no TF32: :func:`~mmlspark_tpu_torch.models.function.ieee_f32`).
"""

from __future__ import annotations

import functools
from typing import Callable, Sequence

import torch
from torch import nn

from mmlspark_tpu_torch.models.function import (
    Conv, Dense, GroupNorm, LayeredModel, NNFunction, max_pool, relu,
)


def _dtype(name: str) -> torch.dtype:
    return torch.bfloat16 if name == "bfloat16" else torch.float32


class ResNetBlock(nn.Module):
    """Pre-activation residual block (GroupNorm + ReLU)."""

    def __init__(self, features: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        s = (stride, stride)
        self.GroupNorm_0 = GroupNorm()
        self.Conv_0 = Conv(features, (3, 3), s, use_bias=False, dtype=dtype)
        self.GroupNorm_1 = GroupNorm()
        self.Conv_1 = Conv(features, (3, 3), use_bias=False, dtype=dtype)
        # the projection: used (and given weights) when the block
        # changes the frame's shape
        self.Conv_2 = Conv(features, (1, 1), s, use_bias=False, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.Conv_0(torch.relu(self.GroupNorm_0(x)))
        y = self.Conv_1(torch.relu(self.GroupNorm_1(y)))
        residual = x if x.shape == y.shape else self.Conv_2(x)
        return y + residual


class BottleneckBlock(nn.Module):
    """Pre-activation 1-3-1 bottleneck (ResNet-50-family); ``features``
    is the inner width, the output 4x."""

    def __init__(self, features: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        s = (stride, stride)
        out_f = 4 * features
        self.GroupNorm_0 = GroupNorm()
        self.Conv_0 = Conv(features, (1, 1), use_bias=False, dtype=dtype)
        self.GroupNorm_1 = GroupNorm()
        self.Conv_1 = Conv(features, (3, 3), s, use_bias=False, dtype=dtype)
        self.GroupNorm_2 = GroupNorm()
        self.Conv_2 = Conv(out_f, (1, 1), use_bias=False, dtype=dtype)
        self.Conv_3 = Conv(out_f, (1, 1), s, use_bias=False, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.Conv_0(torch.relu(self.GroupNorm_0(x)))
        y = self.Conv_1(torch.relu(self.GroupNorm_1(y)))
        y = self.Conv_2(torch.relu(self.GroupNorm_2(y)))
        residual = x if x.shape == y.shape else self.Conv_3(x)
        return y + residual


class _BlockGroup(nn.Module):

    def __init__(self, features: int, n_blocks: int, stride: int,
                 dtype: torch.dtype = torch.float32,
                 block_cls: Callable[..., nn.Module] = ResNetBlock):
        super().__init__()
        self.blocks = [f"{block_cls.__name__}_{i}" for i in range(n_blocks)]
        for i, name in enumerate(self.blocks):
            self.add_module(name, block_cls(
                features, stride=stride if i == 0 else 1, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for name in self.blocks:
            x = self._modules[name](x)
        return x


def _global_pool(x: torch.Tensor) -> torch.Tensor:
    # a bf16 mean accumulates in f32 and rounds once, as jnp.mean does
    return x.mean(dim=(1, 2), dtype=torch.float32).to(x.dtype)


@NNFunction.register_builder("cifar_resnet")
def cifar_resnet(depth: int = 20, num_classes: int = 10,
                 width: int = 16, dtype: str = "float32") -> LayeredModel:
    """CIFAR-style ResNet (depth = 6n+2: 20/32/56/110).

    Layer names: conv_in, group1..3, pool, z (logits) — ``pool`` is the
    transfer-learning feature layer."""
    if (depth - 2) % 6:
        raise ValueError(f"depth must be 6n+2, got {depth}")
    n = (depth - 2) // 6
    dt = _dtype(dtype)
    return LayeredModel((
        ("conv_in", Conv(width, (3, 3), use_bias=False, dtype=dt)),
        ("group1", _BlockGroup(width, n, 1, dt)),
        ("group2", _BlockGroup(2 * width, n, 2, dt)),
        ("group3", _BlockGroup(4 * width, n, 2, dt)),
        ("pool", _global_pool),
        ("z", Dense(num_classes)),
    ))


_IMAGENET_LAYOUTS = {
    18: ((2, 2, 2, 2), ResNetBlock),
    34: ((3, 4, 6, 3), ResNetBlock),
    50: ((3, 4, 6, 3), BottleneckBlock),
    101: ((3, 4, 23, 3), BottleneckBlock),
}


def _stem_pool(x: torch.Tensor) -> torch.Tensor:
    return max_pool(x, (3, 3), (2, 2), padding="SAME")


@NNFunction.register_builder("imagenet_resnet")
def imagenet_resnet(depth: int = 50, num_classes: int = 1000,
                    width: int = 64, dtype: str = "float32") -> LayeredModel:
    """ImageNet-class ResNet (18/34/50/101): 7x7/2 stem + max pool, four
    groups (stride 2 between), global pool, logits; ``pool`` is the
    feature layer (2048-dim at depth 50)."""
    if depth not in _IMAGENET_LAYOUTS:
        raise ValueError(f"depth must be one of {sorted(_IMAGENET_LAYOUTS)}")
    blocks, block_cls = _IMAGENET_LAYOUTS[depth]
    dt = _dtype(dtype)
    layers = [
        ("conv_in", Conv(width, (7, 7), (2, 2), use_bias=False, dtype=dt)),
        ("stem_pool", _stem_pool),
    ]
    for g, n_blocks in enumerate(blocks):
        layers.append((f"group{g + 1}",
                       _BlockGroup(width * (2 ** g), n_blocks,
                                   1 if g == 0 else 2, dt,
                                   block_cls=block_cls)))
    layers += [("pool", _global_pool), ("z", Dense(num_classes))]
    return LayeredModel(layers)


def _pool2(x: torch.Tensor) -> torch.Tensor:
    return max_pool(x, (2, 2), (2, 2))


def _flatten(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[0], -1)        # NHWC order, as flax's reshape


@NNFunction.register_builder("cifar_convnet")
def cifar_convnet(num_classes: int = 10,
                  dtype: str = "float32") -> LayeredModel:
    """Small CIFAR conv net: conv/pool stack -> dense features ->
    logits; ``h2`` is the feature layer."""
    dt = _dtype(dtype)
    return LayeredModel((
        ("conv1", Conv(32, (3, 3), dtype=dt)),
        ("relu1", relu),
        ("pool1", _pool2),
        ("conv2", Conv(64, (3, 3), dtype=dt)),
        ("relu2", relu),
        ("pool2", _pool2),
        ("flatten", _flatten),
        ("h1", Dense(256)),
        ("relu3", relu),
        ("h2", Dense(128)),
        ("relu4", relu),
        ("z", Dense(num_classes)),
    ))


_ACTIVATIONS = {"relu": relu, "tanh": torch.tanh,
                # flax's nn.gelu is the tanh approximation by default
                "gelu": functools.partial(torch.nn.functional.gelu,
                                          approximate="tanh")}


@NNFunction.register_builder("mlp")
def mlp(hidden: Sequence[int] = (128, 64), num_outputs: int = 1,
        activation: str = "relu") -> LayeredModel:
    """Plain MLP for tabular heads."""
    act = _ACTIVATIONS[activation]
    layers = []
    for i, h in enumerate(hidden):
        layers.append((f"h{i + 1}", Dense(h)))
        layers.append((f"act{i + 1}", act))
    layers.append(("z", Dense(num_outputs)))
    return LayeredModel(layers)


# aliases used around the framework
ResNet = cifar_resnet
ConvNet = cifar_convnet
