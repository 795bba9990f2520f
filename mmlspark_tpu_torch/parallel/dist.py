"""Placement helpers (the port of ``mmlspark_tpu/parallel/dist.py``'s mesh
builder, sharding rule and placement report, and ``process_local_rows``).

A spec here is a tuple with one entry a dimension — an axis name, or
``None`` for a replicated dimension — where JAX writes a
``PartitionSpec``: ``spec_for_leaf``'s rule, the train step's
``param_specs`` and the decoder's ``decode_param_specs`` all give
them. A tensor carries no sharding of its own, so
:func:`placement_report` takes the spec tree the caller placed by
(the decoder passes its ``decode_param_specs``), and falls back to
:func:`spec_for_leaf` for leaves it is not given one for.

The batch plumbing (``put_batch``) and the GSPMD state placement
(``shard_state``) wait with ``NNModel``'s and ``NNLearner``'s meshes
(ROADMAP queue 1, the model, expert and pipe axes).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from mmlspark_tpu_torch.core.environment import DeviceLike
from mmlspark_tpu_torch.parallel.topology import (
    AXIS_DATA, AXIS_MODEL, Mesh, MeshSpec, build_mesh,
)

__all__ = [
    "train_mesh", "spec_for_leaf", "state_specs", "placement_report",
    "placement_label", "process_local_rows", "tree_bytes",
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


def _is_leaf(x) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray, np.generic))


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


def _leaf_nbytes(leaf) -> int:
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
    rank's. Each leaf's spec comes from ``specs`` (a tree beside
    ``tree``), else from :func:`spec_for_leaf`."""
    sharded = replicated = 0
    total = per_device = 0
    for leaf, spec in _paired(tree, specs):
        if spec is None:
            spec = spec_for_leaf(tuple(leaf.shape), mesh, model_axis)
        nbytes = _leaf_nbytes(leaf)
        total += nbytes
        axes = [a for a in spec if a is not None]
        if axes:
            sharded += 1
            factor = 1
            for a in axes:
                factor *= int(mesh.shape.get(a, 1))
            per_device += nbytes // max(factor, 1)
        else:
            replicated += 1
            per_device += nbytes
    return {
        "mesh": {a: int(s) for a, s in mesh.shape.items()},
        "n_devices": int(mesh.size),
        "devices": [str(mesh.device)] * (mesh.size if mesh.hosted else 1),
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
    ``torch.distributed`` the slice follows the process's coordinate on
    ``axis`` (processes that differ only on ``seq`` load the same rows,
    and each takes its part of the sequence, :func:`~.sharding.shard_batch`)."""
    n = mesh.shape.get(axis, 1)
    if mesh.hosted or n == 1:
        return 0, n_global
    if n_global % n:
        raise ValueError(f"global batch {n_global} not divisible by the "
                         f"{axis} axis size {n}")
    per = n_global // n
    c = mesh.coords(mesh.rank)[mesh.axis_names.index(axis)]
    return c * per, (c + 1) * per
