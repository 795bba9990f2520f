"""NNFunction: the framework's deep-net model format, in PyTorch.

The port of ``mmlspark_tpu/models/function.py``. A network is a
:class:`LayeredModel` — an ordered list of named layers, truncatable at
any name — and the serialized model is an architecture config
(``arch.json``) plus a param tree (``params.npz``) in the JAX package's
own layout and key names (``params/layers_1_1/ResNetBlock_0/Conv_0/
kernel``: flax's module paths, conv kernels HWIO, dense kernels
``(in, out)``). A directory written by either package loads in the
other.

The tree is the model's state of record: :attr:`NNFunction.params` holds
it as numpy, and :func:`module_from_flax` (the weight bridge) builds the
PyTorch modules from it — conv weights transposed to OIHW, dense weights
to ``(out, in)``, GroupNorm's ``scale`` as its weight — on an explicit
device. :func:`flax_from_module` is the inverse. Frames stay NHWC at
every layer boundary, so a cut at any named layer returns what the JAX
function returns there; inside a conv the tensor is viewed NCHW in
channels-last memory, which costs no copy.

Layers that take their input width from the data (a conv's input
channels, a dense layer's fan-in, GroupNorm's group count) are built
without weights: the bridge assigns them from the tree, and
:meth:`NNFunction.init` runs one forward over a dummy input that draws
each one from an explicit ``torch.Generator`` with flax's default
initializers (LeCun-normal kernels, zero biases, unit norm scales).
Parity with JAX is by bridged weights, never by seed.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import threading
import typing
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mmlspark_tpu_torch.core.environment import DeviceLike, resolve_device
from mmlspark_tpu_torch.parallel.dist import Shards, gathered, shard_state

# -- full-f32 scope ----------------------------------------------------------

_F32_LOCK = threading.Lock()
_F32_DEPTH = 0
_F32_SAVED: Tuple[bool, bool] = (True, False)


@contextlib.contextmanager
def ieee_f32():
    """cuDNN convolutions and cuBLAS matmuls of f32 tensors run in full
    f32 for the scope (PyTorch lets cuDNN use TF32 for f32 convs by
    default; the JAX model computes f32 in f32). Counted, so concurrent
    forwards on several threads restore the flags only when the last
    one leaves."""
    global _F32_DEPTH, _F32_SAVED
    with _F32_LOCK:
        if _F32_DEPTH == 0:
            _F32_SAVED = (torch.backends.cudnn.allow_tf32,
                          torch.backends.cuda.matmul.allow_tf32)
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        _F32_DEPTH += 1
    try:
        yield
    finally:
        with _F32_LOCK:
            _F32_DEPTH -= 1
            if _F32_DEPTH == 0:
                (torch.backends.cudnn.allow_tf32,
                 torch.backends.cuda.matmul.allow_tf32) = _F32_SAVED


# -- initialization (NNFunction.init) ----------------------------------------

_INIT = threading.local()


def _init_generator() -> torch.Generator:
    gen = getattr(_INIT, "gen", None)
    if gen is None:
        raise RuntimeError(
            "this layer has no weights: load them with module_from_flax "
            "(or NNFunction.to_module), or draw them with NNFunction.init")
    return gen


def _lecun_normal(shape: Sequence[int], fan_in: int) -> torch.Tensor:
    """flax's default kernel init: a normal truncated at two standard
    deviations, scaled so its variance is ``1 / fan_in``."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    out = torch.empty(tuple(shape), dtype=torch.float32)
    nn.init.trunc_normal_(out, 0.0, std, -2.0 * std, 2.0 * std,
                          generator=_init_generator())
    return out


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


# -- layers --------------------------------------------------------------------

def _same_pads(size: int, k: int, s: int) -> Tuple[int, int]:
    """XLA's "SAME" padding: output ``ceil(size / s)``, the extra row
    at the end (a stride-2 3x3 conv on an even input pads (0, 1))."""
    total = max((-(-size // s) - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)       # NHWC -> NCHW, channels-last view


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _compute_dtype(dtype: Optional[torch.dtype], *operands
                   ) -> torch.dtype:
    """flax's ``promote_dtype``: an explicit dtype casts every operand;
    ``None`` promotes them (input, kernel and bias alike)."""
    if dtype is not None:
        return dtype
    out = operands[0].dtype
    for t in operands[1:]:
        if t is not None:
            out = torch.promote_types(out, t.dtype)
    return out


def _permute(a, axes):
    """``a`` (numpy or a tensor) with its dims in the order ``axes``."""
    return a.permute(*axes) if isinstance(a, torch.Tensor) \
        else a.transpose(axes)


class FlaxLeaves(nn.Module):
    """A layer whose weights are flax leaves: ``load_flax`` takes them
    (flax layout, numpy) and ``export_flax`` gives them back."""

    #: flax leaf name -> torch parameter name
    LEAVES: Dict[str, str] = {}

    def _to_torch(self, leaf: str, a: np.ndarray) -> np.ndarray:
        return a

    def _to_flax(self, leaf: str, a: np.ndarray) -> np.ndarray:
        return a

    def load_flax(self, leaves: Dict[str, Any], device: torch.device
                  ) -> None:
        for leaf, value in leaves.items():
            if leaf not in self.LEAVES:
                raise KeyError(f"{type(self).__name__} has no flax leaf "
                               f"{leaf!r} (has {sorted(self.LEAVES)})")
            a = self._to_torch(leaf, np.asarray(value))
            setattr(self, self.LEAVES[leaf], _param(
                torch.from_numpy(np.array(a, order="C")).to(device)))
        self._loaded()

    def _loaded(self) -> None:
        """Derive what the weights fix (e.g. GroupNorm's groups)."""

    def export_flax(self) -> Dict[str, np.ndarray]:
        out = {}
        for leaf, name in self.LEAVES.items():
            t = getattr(self, name)
            if t is not None:
                out[leaf] = np.ascontiguousarray(
                    self._to_flax(leaf, t.detach().cpu().numpy()))
        return out


class Conv(FlaxLeaves):
    """flax ``nn.Conv`` over NHWC: "SAME" padding by default, the
    kernel ``(O, I, kh, kw)`` here and HWIO in the tree; an explicit
    ``dtype`` casts the input and the weights (a bf16 conv over f32
    params)."""

    LEAVES = {"kernel": "weight", "bias": "bias"}

    def __init__(self, features: int, kernel_size: Sequence[int],
                 strides: Sequence[int] = (1, 1), use_bias: bool = True,
                 dtype: Optional[torch.dtype] = None,
                 padding: str = "SAME"):
        super().__init__()
        self.features = int(features)
        self.kernel_size = tuple(int(k) for k in kernel_size)
        self.strides = tuple(int(s) for s in strides)
        self.use_bias = bool(use_bias)
        self.dtype = dtype
        self.padding = padding
        self.register_parameter("weight", None)
        self.register_parameter("bias", None)

    def _to_torch(self, leaf, a):
        return _permute(a, (3, 2, 0, 1)) if leaf == "kernel" else a

    def _to_flax(self, leaf, a):
        return _permute(a, (2, 3, 1, 0)) if leaf == "kernel" else a

    def _materialize(self, in_ch: int, device) -> None:
        kh, kw = self.kernel_size
        w = _lecun_normal((self.features, in_ch, kh, kw), in_ch * kh * kw)
        self.weight = _param(w.to(device))
        if self.use_bias:
            self.bias = _param(torch.zeros(self.features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.weight is None:
            self._materialize(x.shape[-1], x.device)
        dt = _compute_dtype(self.dtype, x, self.weight, self.bias)
        w = self.weight.to(dt)
        b = self.bias.to(dt) if self.bias is not None else None
        y = _nchw(x.to(dt))
        pads = [(0, 0), (0, 0)]
        if self.padding == "SAME":
            pads = [_same_pads(n, k, s) for n, k, s in
                    zip(y.shape[2:], self.kernel_size, self.strides)]
        if all(lo == hi for lo, hi in pads):
            y = F.conv2d(y, w, b, self.strides, [lo for lo, _ in pads])
        else:
            y = F.pad(y, (pads[1][0], pads[1][1], pads[0][0], pads[0][1]))
            y = F.conv2d(y, w, b, self.strides)
        return _nhwc(y)


class Dense(FlaxLeaves):
    """flax ``nn.Dense`` over the last axis: the kernel ``(out, in)``
    here and ``(in, out)`` in the tree."""

    LEAVES = {"kernel": "weight", "bias": "bias"}

    def __init__(self, features: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.features = int(features)
        self.dtype = dtype
        self.register_parameter("weight", None)
        self.register_parameter("bias", None)

    def _to_torch(self, leaf, a):
        return a.T if leaf == "kernel" else a

    def _to_flax(self, leaf, a):
        return a.T if leaf == "kernel" else a

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.weight is None:
            fan_in = x.shape[-1]
            self.weight = _param(_lecun_normal(
                (self.features, fan_in), fan_in).to(x.device))
            self.bias = _param(torch.zeros(self.features, device=x.device))
        dt = _compute_dtype(self.dtype, x, self.weight, self.bias)
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


def group_count(channels: int) -> int:
    """The largest group count <= 32 that divides ``channels``."""
    g = min(32, channels)
    while channels % g:
        g -= 1
    return g


def max0(v: torch.Tensor) -> torch.Tensor:
    """``jnp.maximum(0, v)`` with JAX's gradient: the same value, and
    half the gradient where ``v`` is exactly 0 (``clamp_min`` passes
    all of it there). Under ``no_grad`` it is ``clamp_min``."""
    if not torch.is_grad_enabled():
        return v.clamp_min(0.0)
    return 0.5 * (v + v.abs())


class GroupNorm(FlaxLeaves):
    """flax ``nn.GroupNorm`` (epsilon 1e-6, dtype None) over NHWC: the
    input is promoted with the f32 params, so a bf16 activation is
    normalized, and leaves, in f32. The statistics are flax's: the mean
    and the mean of squares, ``var = max(0, E[x^2] - E[x]^2)`` — a
    group of a few values (a 1x1 frame) cancels in that form, and
    PyTorch's two-pass ``group_norm`` would part from it there. The
    group count comes from the channels it sees (:func:`group_count`)."""

    LEAVES = {"scale": "weight", "bias": "bias"}

    def __init__(self, epsilon: float = 1e-6):
        super().__init__()
        self.epsilon = float(epsilon)
        self.num_groups: Optional[int] = None
        self.register_parameter("weight", None)
        self.register_parameter("bias", None)

    def _loaded(self) -> None:
        self.num_groups = group_count(int(self.weight.shape[0]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.weight is None:
            c = x.shape[-1]
            self.weight = _param(torch.ones(c, device=x.device))
            self.bias = _param(torch.zeros(c, device=x.device))
            self._loaded()
        dt = torch.promote_types(x.dtype, self.weight.dtype)
        g = self.num_groups
        shape = x.shape
        xg = x.to(dt).reshape(shape[0], -1, g, shape[-1] // g)
        mean = xg.mean(dim=(1, 3), keepdim=True)
        var = (xg * xg).mean(dim=(1, 3), keepdim=True) - mean * mean
        mul = torch.rsqrt(max0(var) + self.epsilon) \
            * self.weight.to(dt).view(g, -1)
        y = (xg - mean) * mul + self.bias.to(dt).view(g, -1)
        return y.reshape(shape)


def relu(x: torch.Tensor) -> torch.Tensor:
    return torch.relu(x)


def max_pool(x: torch.Tensor, window: Sequence[int], strides: Sequence[int],
             padding: str = "VALID") -> torch.Tensor:
    """flax ``nn.max_pool`` over NHWC; "SAME" pads with -inf."""
    y = _nchw(x)
    if padding == "SAME":
        pads = [_same_pads(n, k, s)
                for n, k, s in zip(y.shape[2:], window, strides)]
        y = F.pad(y, (pads[1][0], pads[1][1], pads[0][0], pads[0][1]),
                  value=float("-inf"))
    return _nhwc(F.max_pool2d(y, tuple(window), tuple(strides)))


# -- the layered model ---------------------------------------------------------

class LayeredModel(nn.Module):
    """Ordered named layers with truncation at any name.

    ``layers`` is a sequence of ``(name, module-or-callable)``. The
    modules are registered under flax's names for them
    (``layers_<i>_1``), so the weight bridge finds each tree leaf's
    module by its path. Residual wiring lives inside block modules; the
    top level stays a chain, so a named cut point lies between any two
    blocks."""

    def __init__(self, layers: Sequence[Tuple[str, Any]]):
        super().__init__()
        self._chain: List[Tuple[str, Any]] = []
        self.layers = nn.ModuleDict()
        for i, (name, layer) in enumerate(layers):
            if isinstance(layer, nn.Module):
                key = f"layers_{i}_1"
                self.layers[key] = layer
                self._chain.append((name, key))
            else:
                self._chain.append((name, layer))

    @property
    def layer_names(self) -> List[str]:
        return [name for name, _ in self._chain]

    # the weight holder's interface, shared with :class:`PlacedModule`

    def tensors(self) -> List[torch.Tensor]:
        """The tensors that hold the weights, for an optimizer to update
        in place."""
        return list(self.parameters())

    def whole(self) -> Dict[str, torch.Tensor]:
        """Every weight by ``state_dict`` name."""
        return dict(self.named_parameters())

    def to_flax(self) -> Dict[str, Any]:
        """The weights as a flax param tree of numpy arrays."""
        return flax_from_module(self)

    def forward(self, x: torch.Tensor, output_layer: Optional[str] = None,
                state: Optional[Dict[str, torch.Tensor]] = None
                ) -> torch.Tensor:
        """The chain up to ``output_layer``; ``state`` (``state_dict``
        names) stands in for those weights for this call only."""
        if state is not None:
            return torch.func.functional_call(
                self, state, (x,), {"output_layer": output_layer})
        if output_layer is not None and output_layer not in self.layer_names:
            raise KeyError(f"no layer named {output_layer!r}; "
                           f"have {self.layer_names}")
        with ieee_f32():
            for name, layer in self._chain:
                x = (self.layers[layer] if isinstance(layer, str)
                     else layer)(x)
                if output_layer is not None and name == output_layer:
                    return x
        return x


# -- the weight bridge ---------------------------------------------------------

def flatten_params(params, prefix="") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in params.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(flatten_params(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def unflatten_params(flat: Dict[str, np.ndarray]):
    root: Dict[str, Any] = {}
    for key, v in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return root


def _flax_layer(model: LayeredModel, path: Sequence[str]) -> FlaxLeaves:
    mod: nn.Module = model.layers
    for part in path:
        if part not in mod._modules:
            raise KeyError(f"the architecture has no module at "
                           f"{'/'.join(path)!r}")
        mod = mod._modules[part]
    if not isinstance(mod, FlaxLeaves):
        raise KeyError(f"{'/'.join(path)!r} holds no weights")
    return mod


def module_from_flax(params, model: LayeredModel,
                     device: DeviceLike = None) -> LayeredModel:
    """The weight bridge: load a flax param tree (nested dict or flat
    ``params/...`` keys; numpy or anything ``np.asarray`` reads) into
    ``model``'s layers on ``device`` (``None``: the card), in place.
    Leaves keep their dtype (an int8 kernel stays int8)."""
    dev = resolve_device(device)
    flat = (flatten_params(params)
            if any(isinstance(v, dict) for v in params.values())
            else params)
    grouped: Dict[Tuple[str, ...], Dict[str, Any]] = {}
    for key, value in flat.items():
        parts = key.split("/")
        if parts[0] != "params":
            raise KeyError(f"unexpected collection {parts[0]!r} in {key!r}")
        grouped.setdefault(tuple(parts[1:-1]), {})[parts[-1]] = value
    for path, leaves in grouped.items():
        _flax_layer(model, path).load_flax(leaves, dev)
    return model.to(dev)


def flax_from_module(model: LayeredModel) -> Dict[str, Any]:
    """The inverse bridge: the model's weights as a flax param tree of
    numpy arrays (``{"params": {...}}``)."""
    flat = {}
    for name, mod in model.layers.named_modules():
        if isinstance(mod, FlaxLeaves):
            for leaf, a in mod.export_flax().items():
                flat["/".join(["params", *name.split("."), leaf])] = a
    return unflatten_params(flat)


def state_key(flax_key: str) -> str:
    """The ``state_dict`` name of a flat flax key's tensor."""
    parts = flax_key.split("/")
    leaf = {"kernel": "weight", "scale": "weight"}.get(parts[-1], parts[-1])
    return ".".join(["layers", *parts[1:-1], leaf])


def layer_chain(model: LayeredModel) -> List[Tuple[str, Any]]:
    """``model``'s ``(name, layer)`` chain, modules and callables alike:
    what :class:`LayeredModel` is built from, so a slice of it builds a
    stage's sub-chain (its modules registered from ``layers_0_1``)."""
    return [(name, model.layers[key] if isinstance(key, str) else key)
            for name, key in model._chain]


def _flat_leaves(tree, prefix: str = "") -> Dict[str, Any]:
    """A nested dict's leaves under ``a/b/c`` keys, leaves untouched."""
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(_flat_leaves(v, key))
        else:
            out[key] = v
    return out


class PlacedModule:
    """A :class:`LayeredModel` whose weights are placed on a mesh by
    :func:`~mmlspark_tpu_torch.parallel.dist.shard_state` (the JAX
    ``NamedSharding`` placement of the flax tree): each leaf's spec is
    reckoned on its flax shape, so a conv kernel splits as JAX splits
    it, and the leaf is then held in the torch layout, a
    :class:`~mmlspark_tpu_torch.parallel.dist.Shards` of the model
    ranks' slices (along the flax dim's place in the torch layout) where
    the rule splits it. The layers are a weightless skeleton on the meta
    device; a call gathers the leaves and runs the skeleton over them
    (``torch.func.functional_call``), so the whole weights exist only
    inside the call.

    ``state`` maps each ``state_dict`` name to its tensor or ``Shards``
    (what :func:`~mmlspark_tpu_torch.parallel.dist.placement_report`
    reads). It is called, and read through :meth:`tensors` (the slices
    of a split leaf), :meth:`whole` and :meth:`to_flax`, as a
    :class:`LayeredModel` is."""

    def __init__(self, model: LayeredModel, params, mesh):
        self.model = model
        self.mesh = mesh
        self.state: Dict[str, Any] = {}
        self._keys: Dict[str, Tuple[FlaxLeaves, str]] = {}
        placed = _flat_leaves(shard_state(params, mesh))
        layers = set()
        for key, leaf in placed.items():
            parts = key.split("/")
            if parts[0] != "params":
                raise KeyError(f"unexpected collection {parts[0]!r} in "
                               f"{key!r}")
            layer = _flax_layer(model, parts[1:-1])
            attr = layer.LEAVES[parts[-1]]
            name = ".".join(["layers", *parts[1:-1], attr])
            self.state[name] = _torch_leaf(layer, parts[-1], leaf)
            self._keys[name] = (layer, parts[-1])
            whole = self.state[name]
            setattr(layer, attr, _param(torch.empty(
                whole.shape, dtype=whole.dtype, device="meta")))
            layers.add(layer)
        for layer in layers:
            layer._loaded()

    def tensors(self) -> List[torch.Tensor]:
        out: List[torch.Tensor] = []
        for v in self.state.values():
            out.extend(v.parts if isinstance(v, Shards) else [v])
        return out

    def whole(self) -> Dict[str, torch.Tensor]:
        """Every weight whole, by ``state_dict`` name (the slices of a
        split leaf concatenated)."""
        return {name: gathered(v) for name, v in self.state.items()}

    def __call__(self, x: torch.Tensor, output_layer: Optional[str] = None,
                 state: Optional[Dict[str, torch.Tensor]] = None
                 ) -> torch.Tensor:
        return torch.func.functional_call(
            self.model, self.whole() if state is None else state, (x,),
            {"output_layer": output_layer})

    def to_flax(self) -> Dict[str, Any]:
        """The weights as a flax param tree of numpy arrays."""
        flat = {}
        for name, t in self.whole().items():
            layer, leaf = self._keys[name]
            path = name.split(".")[1:-1]
            flat["/".join(["params", *path, leaf])] = np.ascontiguousarray(
                layer._to_flax(leaf, t.detach().cpu().numpy()))
        return unflatten_params(flat)


def _torch_leaf(layer: FlaxLeaves, leaf: str, value):
    """A placed flax-layout leaf (a tensor or ``Shards``) in the torch
    layout: a ``Shards``' slices converted one by one, its dim carried to
    where the layout moves it."""
    if not isinstance(value, Shards):
        return layer._to_torch(leaf, value).contiguous()
    shape = [1] * len(value.shape)
    shape[value.dim] = 2
    moved = layer._to_torch(leaf, torch.empty(shape, device="meta")).shape
    return Shards([layer._to_torch(leaf, p).contiguous()
                   for p in value.parts], list(moved).index(2), value.spec,
                  value.axis)


# -- NNFunction ------------------------------------------------------------------

@dataclasses.dataclass
class NNFunction:
    """A loadable/evaluable network: architecture config + param tree.

    ``arch`` is a JSON-able dict whose ``builder`` key names a
    registered architecture factory (see
    :mod:`mmlspark_tpu_torch.models.resnet`); ``params`` is the flax
    param tree as numpy (``{"params": {...}}``)."""

    arch: Dict[str, Any]
    params: Any

    # class-level registry of architecture builders (not a dataclass field)
    _BUILDERS: typing.ClassVar[Dict[str, Callable[..., nn.Module]]] = {}

    @classmethod
    def register_builder(cls, name: str):
        def deco(fn):
            cls._BUILDERS[name] = fn
            return fn
        return deco

    def module(self) -> LayeredModel:
        """The architecture's layers, without weights."""
        builder = NNFunction._BUILDERS.get(self.arch["builder"])
        if builder is None:
            raise KeyError(f"unknown architecture builder "
                           f"{self.arch['builder']!r}; registered: "
                           f"{sorted(NNFunction._BUILDERS)}")
        kwargs = {k: v for k, v in self.arch.items() if k != "builder"}
        return builder(**kwargs)

    def to_module(self, device: DeviceLike = None,
                  params=None) -> LayeredModel:
        """The layers with ``params`` (default: this function's tree)
        loaded on ``device`` (``None``: the card)."""
        return module_from_flax(self.params if params is None else params,
                                self.module(), device)

    # -- evaluation ---------------------------------------------------------

    @property
    def layer_names(self) -> List[str]:
        return list(self.module().layer_names)

    @torch.no_grad()
    def apply(self, x, output_layer: Optional[str] = None,
              device: DeviceLike = None) -> torch.Tensor:
        """Forward pass on ``device`` (``None``: the card);
        ``output_layer`` truncates at a named layer. ``x`` is NHWC (or
        ``[N, features]``), numpy or a tensor."""
        dev = resolve_device(device)
        xt = torch.as_tensor(np.asarray(x) if not torch.is_tensor(x)
                             else x).to(dev)
        return self.to_module(dev)(xt, output_layer=output_layer)

    def layer_name_for_cut(self, cut_layers: int) -> Optional[str]:
        """Name of the output layer after cutting the last ``cut_layers``
        layers (parity: ImageFeaturizer.setCutOutputLayers)."""
        names = self.layer_names
        if not 0 <= cut_layers < len(names):
            raise ValueError(f"cut_layers={cut_layers} out of range for "
                             f"{len(names)} layers")
        return None if cut_layers == 0 else names[len(names) - 1 - cut_layers]

    # -- persistence --------------------------------------------------------

    def save(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "arch.json"), "w") as f:
            json.dump(self.arch, f, indent=2)
        np.savez_compressed(os.path.join(path, "params.npz"),
                            **flatten_params(self.params))

    @staticmethod
    def load(path: str) -> "NNFunction":
        with open(os.path.join(path, "arch.json")) as f:
            arch = json.load(f)
        with np.load(os.path.join(path, "params.npz")) as npz:
            params = unflatten_params({k: npz[k] for k in npz.files})
        return NNFunction(arch=arch, params=params)

    @staticmethod
    def init(arch: Dict[str, Any], input_shape: Sequence[int],
             seed: int = 0, generator: Optional[torch.Generator] = None
             ) -> "NNFunction":
        """Random-init an architecture (the training entry point): one
        forward over a zero input of ``(1, *input_shape)`` on the CPU
        draws every layer's weights from ``generator`` (default: a CPU
        generator seeded with ``seed``) with flax's initializers."""
        fn = NNFunction(arch=arch, params=None)
        model = fn.module()
        gen = generator if generator is not None \
            else torch.Generator().manual_seed(int(seed))
        _INIT.gen = gen
        try:
            with torch.no_grad():
                model(torch.zeros((1, *input_shape), dtype=torch.float32))
        finally:
            _INIT.gen = None
        fn.params = flax_from_module(model)
        return fn
