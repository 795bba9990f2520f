"""Placement helpers (the port of ``mmlspark_tpu/parallel/dist.py``): the
mesh builder, the sharding rule, state placement, the batch plumbing and
the placement report.

A spec here is a tuple with one entry a dimension — an axis name, or
``None`` for a replicated dimension — where JAX writes a
``PartitionSpec``: ``spec_for_leaf``'s rule, the train step's
``param_specs`` and the decoder's ``decode_param_specs`` all give
them. A tensor carries no sharding of its own, so
:func:`placement_report` takes the spec tree the caller placed by
(the decoder passes its ``decode_param_specs``), reads a
:class:`Shards` leaf's own, and falls back to :func:`spec_for_leaf` for
the leaves it is given none for.

:func:`shard_state` places a state tree by the rule. With a ``model``
axis each sharded leaf becomes a :class:`Shards`: this process's model
ranks' slices, each a tensor of its own holding ``1 / t`` of the leaf,
gathered (:func:`gathered`) where the leaf is used: on a hosted mesh
every rank's slice; where the axis has a part across processes, the
process's own slices, and the gather takes the other processes' over
the axis's group. :func:`put_batch` pads a batch to the data axis and
places it: hosted, the global batch on the mesh's device; over
processes, each process's rows.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from mmlspark_tpu_torch.core.environment import DeviceLike
from mmlspark_tpu_torch.parallel.collectives import all_gather
from mmlspark_tpu_torch.parallel.topology import (
    AXIS_DATA, AXIS_MODEL, Mesh, MeshSpec, build_mesh,
)

__all__ = [
    "train_mesh", "spec_for_leaf", "state_specs", "state_shardings",
    "shard_state", "batch_shardings", "put_batch", "placement_report",
    "placement_label", "process_local_rows", "tree_bytes", "Shards",
    "gathered",
]

Spec = Tuple[Optional[str], ...]


def train_mesh(mesh_shape: Optional[Dict[str, int]] = None,
               device: DeviceLike = None) -> Mesh:
    """The trainer/serving mesh (the JAX ``train_mesh``): ``mesh_shape``
    may name any axes (``{"data": -1}`` by default), a ``model`` axis
    turns tensor parallelism on; :func:`~.topology.build_mesh` on
    ``device`` (hosted in a single process)."""
    spec = (MeshSpec.from_dict(mesh_shape) if mesh_shape
            else MeshSpec.data_parallel())
    return build_mesh(spec, device)


def spec_for_leaf(shape: Tuple[int, ...], mesh: Optional[Mesh],
                  model_axis: str = AXIS_MODEL) -> Spec:
    """The one shape-driven sharding rule (the JAX ``spec_for_leaf``):
    a leaf of rank >= 2 splits its largest dim that divides over the
    ``model`` axis (and is at least twice its size) over it, ties going
    to the trailing dim; scalars, vectors and leaves with no such dim
    replicate (``()``)."""
    n_model = mesh.shape.get(model_axis, 1) if mesh is not None else 1
    if n_model <= 1 or len(shape) < 2:
        return ()
    best_dim, best_size = None, 0
    for d in range(len(shape) - 1, -1, -1):   # the trailing dim wins ties
        if shape[d] % n_model == 0 and shape[d] > best_size \
                and shape[d] >= 2 * n_model:
            best_dim, best_size = d, shape[d]
    if best_dim is None:
        return ()
    axes: list = [None] * len(shape)
    axes[best_dim] = model_axis
    return tuple(axes)


class Shards:
    """A leaf laid out over a mesh's ``model`` axis: ``parts`` are this
    process's model ranks' slices along ``dim`` (each a tensor of its
    own, ``1 / t`` of the leaf), ``spec`` the rule's spec it was cut by.
    ``axis`` is the model axis where it has a part across processes
    (None on a hosted mesh): the parts are then this process's block and
    the other processes hold the rest. What JAX keeps as one sharded
    global array; :meth:`gather` is the whole leaf, built where it is
    used."""

    def __init__(self, parts: Sequence[torch.Tensor], dim: int, spec: Spec,
                 axis=None):
        self.parts: List[torch.Tensor] = list(parts)
        self.dim = int(dim)
        self.spec = tuple(spec)
        self.axis = axis

    @property
    def across(self) -> int:
        """How many processes' blocks make the leaf."""
        return self.axis.across_size if self.axis is not None else 1

    @property
    def offset(self) -> int:
        """Where this process's block starts along ``dim``."""
        if self.axis is None:
            return 0
        return self.axis.across_index() * self.block

    @property
    def block(self) -> int:
        return sum(p.shape[self.dim] for p in self.parts)

    @property
    def shape(self) -> Tuple[int, ...]:
        s = list(self.parts[0].shape)
        s[self.dim] = self.block * self.across
        return tuple(s)

    @property
    def dtype(self) -> torch.dtype:
        return self.parts[0].dtype

    def gather(self) -> torch.Tensor:
        local = torch.cat(self.parts, dim=self.dim)
        if self.across == 1:
            return local
        return _GatherBlocks.apply(local, self.axis, self.dim)

    def __repr__(self) -> str:
        return (f"Shards({len(self.parts)} x {tuple(self.parts[0].shape)} "
                f"of {self.shape}, spec={self.spec})")


class _GatherBlocks(torch.autograd.Function):
    """The processes' blocks of a leaf joined along ``dim`` over the
    axis's group; the gradient is this process's block of the whole
    leaf's. Every process computes the same function of the whole leaf
    (the model axis replicates the batch), so its block of that
    gradient is the block's gradient, with no sum."""

    @staticmethod
    def forward(ctx, local, axis, dim):
        ctx.args = axis, dim, local.shape[dim]
        return torch.cat(all_gather(local, axis.group), dim=dim)

    @staticmethod
    def backward(ctx, g):
        axis, dim, n = ctx.args
        return g.narrow(dim, axis.across_index() * n, n), None, None


def gathered(leaf):
    """The whole leaf: a :class:`Shards`' slices concatenated (a
    differentiable ``cat``), any other leaf as it is."""
    return leaf.gather() if isinstance(leaf, Shards) else leaf


def _is_leaf(x) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray, np.generic, Shards))


def _leaves(tree):
    """The array leaves of a nest of dicts, lists and tuples, in order."""
    if _is_leaf(tree):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves(tree[k])]
    return [x for v in tree for x in _leaves(v)]


def _map(fn, tree):
    if _is_leaf(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return type(tree)(_map(fn, v) for v in tree)


def _paired(tree, specs):
    """``(leaf, spec)`` pairs of ``tree`` and the spec tree beside it
    (``None`` where ``specs`` gives none; a spec is a tuple, so the spec
    tree's nests are dicts and lists)."""
    if _is_leaf(tree):
        return [(tree, specs if isinstance(specs, tuple) else None)]
    if isinstance(tree, dict):
        sub = specs if isinstance(specs, dict) else {}
        return [p for k, v in tree.items() for p in _paired(v, sub.get(k))]
    sub = specs if isinstance(specs, list) else [None] * len(tree)
    return [p for v, sp in zip(tree, sub) for p in _paired(v, sp)]


def state_specs(tree, mesh: Mesh, model_axis: str = AXIS_MODEL):
    """The spec tree of any state tree: :func:`spec_for_leaf` a leaf."""
    return _map(lambda leaf: spec_for_leaf(tuple(leaf.shape), mesh,
                                           model_axis), tree)


#: the JAX ``state_shardings``: a tensor's placement is its mesh and its
#: spec, so the tree is :func:`state_specs`' (an optimizer moment shaped
#: as its parameter lands as it does: the rule reads shapes only)
state_shardings = state_specs


def _place(leaf, device: torch.device) -> torch.Tensor:
    """A leaf as a tensor on ``device`` that aliases no host array (on
    the card, copied from a pinned staging copy without blocking)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.to(device)
    if device.type == "cuda":
        t = torch.from_numpy(np.ascontiguousarray(leaf))
        return t.pin_memory().to(device, non_blocking=True)
    return torch.from_numpy(np.array(leaf))      # np.array: its own copy


def _shard_leaf(leaf, mesh: Mesh, model_axis: str):
    spec = spec_for_leaf(tuple(np.shape(leaf)), mesh, model_axis)
    if model_axis not in spec:
        return _place(leaf, mesh.device)
    dim, axis = spec.index(model_axis), mesh.axis(model_axis)
    a = axis.across_size
    if a > 1:
        # this process's block only ever reaches its device
        n = np.shape(leaf)[dim] // a
        c = axis.across_index()
        leaf = leaf[(slice(None),) * dim + (slice(c * n, (c + 1) * n),)]
    t = _place(leaf, mesh.device)
    return Shards([p.contiguous() for p in t.chunk(axis.hosted_size, dim)],
                  dim, spec, axis if a > 1 else None)


def shard_state(tree, mesh: Mesh, model_axis: str = AXIS_MODEL):
    """The JAX ``shard_state``: a state tree (numpy or tensor leaves)
    placed on ``mesh``'s device by :func:`spec_for_leaf`. A replicated
    leaf is one tensor. A leaf the rule splits over ``model`` is a
    :class:`Shards` of this process's model ranks' slices (each rank's
    ``1 / t``): on a hosted mesh all of them, over processes its own
    block's."""
    return _map(lambda leaf: _shard_leaf(leaf, mesh, model_axis), tree)


def _leaf_nbytes(leaf) -> int:
    if isinstance(leaf, Shards):
        return sum(_leaf_nbytes(p) for p in leaf.parts)
    if isinstance(leaf, torch.Tensor):
        return leaf.numel() * leaf.element_size()
    leaf = np.asarray(leaf)
    return int(leaf.size) * leaf.dtype.itemsize


def tree_bytes(tree) -> int:
    """Total bytes of a state tree (shape x itemsize, no device sync)."""
    return sum(_leaf_nbytes(leaf) for leaf in _leaves(tree))


def placement_report(tree, mesh: Mesh, specs=None,
                     model_axis: str = AXIS_MODEL) -> Dict[str, Any]:
    """How a state tree lands on ``mesh`` (the JAX ``placement_report``,
    the ``/stats`` surface): the mesh's axis sizes, its ranks' devices,
    the sharded and replicated leaf counts, the state's bytes and each
    rank's. Each leaf's spec is a :class:`Shards`' own, else from
    ``specs`` (a tree beside ``tree``), else from :func:`spec_for_leaf`."""
    sharded = replicated = 0
    total = per_device = 0
    for leaf, spec in _paired(tree, specs):
        if isinstance(leaf, Shards):
            spec = leaf.spec
        if spec is None:
            spec = spec_for_leaf(tuple(leaf.shape), mesh, model_axis)
        # this process holds its block of a sharded leaf: the parts of
        # its axes across processes multiply it back to the whole, their
        # hosted parts divide it among the process's ranks
        nbytes = _leaf_nbytes(leaf)
        axes = [a for a in spec if a is not None]
        if axes:
            sharded += 1
            across = hosted = 1
            for a in axes:
                across *= int(mesh.across_shape.get(a, 1))
                hosted *= int(mesh.hosted_shape.get(a, 1))
            total += nbytes * across
            per_device += nbytes // max(hosted, 1)
        else:
            replicated += 1
            total += nbytes
            per_device += nbytes
    return {
        "mesh": {a: int(s) for a, s in mesh.shape.items()},
        "n_devices": int(mesh.size),
        "devices": [str(mesh.device)] * mesh.n_hosted,
        "sharded_leaves": sharded,
        "replicated_leaves": replicated,
        "state_bytes": total,
        "state_bytes_per_device": per_device,
    }


def placement_label(mesh: Mesh) -> str:
    """The compact span-attribute form: ``"data=4,model=2"``."""
    return ",".join(f"{a}={int(s)}" for a, s in mesh.shape.items())


def process_local_rows(n_global: int, mesh: Mesh, axis: str = AXIS_DATA
                       ) -> Tuple[int, int]:
    """``(start, stop)`` of this process's row slice of a global batch
    sharded over ``axis``: each process loads only rows ``[start,
    stop)``. A hosted mesh's one process loads every row; under
    ``torch.distributed`` the slice is the rows of the process's hosted
    ranks' coordinates on ``axis``, a contiguous block (processes that
    differ only on another axis load the same rows, and each takes its
    part of the sequence, :func:`~.sharding.shard_batch`)."""
    n = mesh.shape.get(axis, 1)
    if mesh.hosted or n == 1 or mesh.across_shape[axis] == 1:
        return 0, n_global
    if n_global % n:
        raise ValueError(f"global batch {n_global} not divisible by the "
                         f"{axis} axis size {n}")
    ax = mesh.axis(axis)
    per = n_global // n * ax.hosted_size
    c = ax.across_index()
    return c * per, (c + 1) * per


# ---------------------------------------------------------------------------
# batch plumbing


def batch_shardings(mesh: Mesh, axis: str = AXIS_DATA) -> Spec:
    """The global batch's spec: the leading dim over ``axis``, every
    other dim replicated (the model ranks see whole feature dims)."""
    return (axis,) if axis in mesh.shape else ()


def _pad_cached(cache: dict, name: str, arr: np.ndarray, multiple: int,
                pad_value) -> Tuple[np.ndarray, int]:
    """Pad ``arr``'s leading dim through a reused host staging buffer
    (the JAX ``_pad_cached``): one buffer per (name, padded shape,
    dtype), its pad rows written when it is made; a later tail of the
    same shape copies its real rows in, and a smaller tail cleans again
    the rows a larger one dirtied (``[n, dirty_to)``), so no earlier
    batch's rows (a nonzero weight, say) ride into this one. Divisible
    batches pass through untouched."""
    n = arr.shape[0]
    target = ((n + multiple - 1) // multiple) * multiple
    if target == n:
        return arr, n
    key = (name, target) + arr.shape[1:] + (arr.dtype.str,)
    buf = cache.get(key)
    if buf is None:
        buf = np.full((target,) + arr.shape[1:], pad_value, dtype=arr.dtype)
        cache[key] = buf
        cache[(key, "dirty_to")] = 0
    buf[:n] = arr
    buf[n:cache[(key, "dirty_to")]] = pad_value
    cache[(key, "dirty_to")] = n
    return buf, n


def put_batch(arrays: Dict[str, np.ndarray], mesh: Mesh,
              axis: str = AXIS_DATA, pad_value=0,
              pad_cache: Optional[dict] = None
              ) -> Tuple[Dict[str, torch.Tensor], int]:
    """Pad each array's leading dim to the data multiple and place it on
    the mesh's device (the JAX ``put_batch``) -> ``({name: tensor},
    true row count)``. Hosted, the arrays are the global batch and pad
    to the whole ``axis``; over processes, they are this process's rows
    (:func:`process_local_rows`) and pad to its hosted part of the axis,
    so no process holds the global batch. ``pad_cache`` (a
    dict the caller keeps) reuses one host buffer per tail shape
    (:func:`_pad_cached`); every upload copies out of it, so reusing
    it on the next call is safe."""
    from mmlspark_tpu_torch.parallel.sharding import pad_to_multiple

    multiple = mesh.hosted_shape.get(axis, 1)
    out: Dict[str, torch.Tensor] = {}
    n_true: Optional[int] = None
    for name, arr in arrays.items():
        arr = np.asarray(arr)
        if pad_cache is not None:
            padded, n = _pad_cached(pad_cache, name, arr, multiple,
                                    pad_value)
        else:
            padded, n = pad_to_multiple(arr, multiple, pad_value=pad_value)
        if n_true is None:
            n_true = n
        out[name] = _place(padded, mesh.device)
    return out, int(n_true or 0)
