"""Device meshes for the port: the ``data``, ``seq``, ``model``,
``expert`` and ``pipe`` axes over ranks.

The port's counterpart of ``mmlspark_tpu/parallel/topology.py``. A
:class:`Mesh` names its axes and their sizes as the JAX mesh does
(``mesh.shape[axis]``, ``mesh.axis_names``), and its ranks are laid out
row-major over the axes. A rank is one per-device program of the JAX
``shard_map``; here it runs in one of two forms:

* **hosted** — one process hosts every rank of the mesh on one device
  (:func:`build_mesh` in a process outside ``torch.distributed``, or a
  world of one). Per-rank tensors carry a leading dimension of the
  hosted ranks, and the collectives act on that dimension: a ring
  permute is a ``torch.roll``, a sum a reduction over it. This is how
  one card runs a ``{"seq": 4}`` ring: the same per-rank code runs for
  every rank, and each kernel launch of a ring step takes all ranks at
  once, folded into its batch. The train step folds the ``model`` ranks
  into its branches instead (each rank's heads and hidden units beside
  the others', :mod:`~mmlspark_tpu_torch.models.transformer`).
* **distributed** — the mesh's ranks spread over the processes of
  ``torch.distributed`` (gloo on the CPU, NCCL on cards): in a world of
  P processes a mesh of P x k ranks puts k contiguous ranks in each
  process, in JAX's order of global devices (by process, so the process
  boundary falls on the leading axes). With k 1 each process is one
  rank: the leading per-rank dimension is 1, and the collectives are
  point-to-point sends and ``all_reduce`` over each axis's process
  group. With k > 1 (the **mixed** form, JAX's normal multi-host layout)
  each process hosts its k ranks as above, and each axis has a hosted
  part (its ranks within the process, :attr:`MeshAxis.hosted_size`) and
  a part across processes (:attr:`MeshAxis.across_size`): the leading
  axes lie wholly across processes, the trailing ones wholly inside
  them, and at most one axis is split between the two. A collective
  does its hosted part on the leading dimension and its cross-process
  part over the axis's process group.

Every axis runs in every form. A fully fixed mesh smaller than the world
raises ``ValueError``, as the JAX ``build_mesh`` does across processes.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import os
import threading
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from mmlspark_tpu_torch.core.environment import DeviceLike, resolve_device

AXIS_DATA = "data"
AXIS_MODEL = "model"
AXIS_SEQ = "seq"
AXIS_EXPERT = "expert"
AXIS_PIPE = "pipe"

ALL_AXES = (AXIS_DATA, AXIS_MODEL, AXIS_SEQ, AXIS_EXPERT, AXIS_PIPE)


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Logical mesh shape over named axes; -1 on one axis means 'the
    rest' (the JAX ``MeshSpec``)."""

    axes: Tuple[Tuple[str, int], ...] = ((AXIS_DATA, -1),)

    @staticmethod
    def data_parallel() -> "MeshSpec":
        return MeshSpec(((AXIS_DATA, -1),))

    @staticmethod
    def from_dict(shape: Dict[str, int]) -> "MeshSpec":
        return MeshSpec(tuple(shape.items()))

    @staticmethod
    def full_spmd(n_devices: int) -> "MeshSpec":
        """All five axes over ``n_devices`` (the JAX ``full_spmd``):
        factors of 2 go to ``model``, ``pipe``, ``seq``, ``expert`` in
        that order, the rest to ``data``; every axis is present, size-1
        axes included."""
        sizes = {AXIS_DATA: 1, AXIS_SEQ: 1, AXIS_MODEL: 1,
                 AXIS_EXPERT: 1, AXIS_PIPE: 1}
        rest = n_devices
        for axis in (AXIS_MODEL, AXIS_PIPE, AXIS_SEQ, AXIS_EXPERT):
            if rest % 2 == 0 and rest > 1:
                sizes[axis] = 2
                rest //= 2
        sizes[AXIS_DATA] = rest
        return MeshSpec.from_dict(sizes)

    def resolve(self, n_devices: int) -> Dict[str, int]:
        """Concrete per-axis sizes for a device count."""
        sizes = dict(self.axes)
        wildcards = [a for a, s in sizes.items() if s == -1]
        if len(wildcards) > 1:
            raise ValueError("at most one axis may be -1")
        fixed = math.prod(s for s in sizes.values() if s != -1)
        if wildcards:
            if n_devices % fixed:
                raise ValueError(
                    f"{n_devices} devices not divisible by fixed axes {sizes}")
            sizes[wildcards[0]] = n_devices // fixed
        elif fixed != n_devices:
            raise ValueError(f"mesh {sizes} needs {fixed} devices, have "
                             f"{n_devices}")
        return sizes

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(a for a, _ in self.axes)


def _split_shape(shape: Dict[str, int], k: int) -> Dict[str, int]:
    """Each axis's hosted part when a process holds ``k`` contiguous
    ranks of a row-major mesh ``shape``: the trailing axes whole, then a
    divisor of the next one. Raises ``ValueError`` where ``k`` contiguous
    ranks are not a block of the mesh's grid."""
    hosted = {a: 1 for a in shape}
    rest = k
    for a in reversed(tuple(shape)):
        n = shape[a]
        if rest == 1:
            break
        if rest % n == 0:
            hosted[a], rest = n, rest // n
        elif n % rest == 0:
            hosted[a], rest = rest, 1
        else:
            break
    if rest != 1:
        raise ValueError(
            f"mesh {shape}: {k} contiguous ranks a process are not a block "
            f"of its axes (the process boundary must split at most one "
            f"axis)")
    return hosted


class Mesh:
    """Named axes over ranks, hosted by this process or spread over the
    processes of ``torch.distributed`` (see the module docstring).
    ``shape`` maps each axis to its size, in order; ``device`` is where
    this process's per-rank tensors live. ``hosted_shape`` is the part of
    each axis inside a process (the whole axis on a hosted mesh),
    ``across_shape`` the part across processes; ``ranks`` are this
    process's ranks and ``rank`` the first of them (its only one, one
    rank per process); ``process`` is this process's index in the world
    (0 on a hosted mesh)."""

    def __init__(self, shape: Dict[str, int], device: torch.device,
                 hosted: bool, _groups_of: Optional["Mesh"] = None):
        for name, size in shape.items():
            if name not in ALL_AXES:
                raise ValueError(f"unknown mesh axis {name!r} (one of "
                                 f"{ALL_AXES})")
            if size < 1:
                raise ValueError(f"mesh axis {name!r} has size {size}")
        self.shape: Dict[str, int] = dict(shape)
        self.axis_names: Tuple[str, ...] = tuple(shape)
        self.size = math.prod(shape.values())
        if device.type == "cuda" and device.index is None:
            # the tensors it makes say cuda:<n>: name the device so
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = device
        self.hosted = hosted
        self.n_processes = 1 if hosted else dist.get_world_size()
        self.process = 0 if hosted else dist.get_rank()
        if self.size % self.n_processes:
            raise ValueError(
                f"mesh {self.shape} has {self.size} ranks, which do not "
                f"spread evenly over {self.n_processes} processes")
        k = self.size // self.n_processes
        self.hosted_shape: Dict[str, int] = _split_shape(self.shape, k)
        self.across_shape: Dict[str, int] = {
            a: n // self.hosted_shape[a] for a, n in self.shape.items()}
        #: this process's ranks, in order: all of them, or its block
        self.ranks = list(range(self.process * k, (self.process + 1) * k))
        self.rank = self.ranks[0]
        if hosted:
            self._groups = {}
        elif _groups_of is not None:
            self._groups = {a: _groups_of._groups.get(a)
                            for a in self.axis_names}
        else:
            self._groups = self._axis_groups()

    @property
    def n_hosted(self) -> int:
        """The leading dimension of this process's per-rank tensors."""
        return len(self.ranks)

    @property
    def mixed(self) -> bool:
        """Several processes, each hosting several ranks."""
        return not self.hosted and self.n_hosted > 1

    def coords(self, rank: int) -> Tuple[int, ...]:
        """A rank's coordinate on every axis (row-major)."""
        return tuple(int(c) for c in
                     np.unravel_index(rank, tuple(self.shape.values())))

    def rank_at(self, coords) -> int:
        return int(np.ravel_multi_index(tuple(coords),
                                        tuple(self.shape.values())))

    def process_coords(self, process: int) -> Tuple[int, ...]:
        """A process's coordinate on the across part of every axis."""
        return tuple(int(c) for c in np.unravel_index(
            process, tuple(self.across_shape.values())))

    def process_at(self, coords) -> int:
        return int(np.ravel_multi_index(
            tuple(coords), tuple(self.across_shape.values())))

    def axis(self, name: str) -> "MeshAxis":
        if name not in self.shape:
            raise ValueError(f"mesh {self.shape} has no axis {name!r}")
        return MeshAxis(self, name)

    def with_shape(self, shape: Dict[str, int]) -> "Mesh":
        """This mesh with some axes' hosted parts taken out (``shape``:
        the same axes, each at its size less a hosted factor), over the
        same processes and their groups: the mesh the per-rank tensors
        see where a hosted model axis folds into the branches."""
        if self.hosted:
            return Mesh(shape, self.device, hosted=True)
        return Mesh(shape, self.device, hosted=False, _groups_of=self)

    def _axis_groups(self) -> Dict[str, object]:
        """The process group of the across part of each axis that spans
        some but not all processes, holding this process. Every process
        creates every group, in the same order, as ``torch.distributed``
        requires."""
        groups = {}
        dims = tuple(self.across_shape.values())
        for pos, name in enumerate(self.axis_names):
            n = dims[pos]
            if n in (1, self.n_processes):
                groups[name] = None            # no peers / the world
                continue
            for other in np.ndindex(*(d for i, d in enumerate(dims)
                                      if i != pos)):
                procs = [self.process_at(other[:pos] + (c,) + other[pos:])
                         for c in range(n)]
                group = dist.new_group(procs)
                if self.process in procs:
                    groups[name] = group
        return groups

    def __repr__(self) -> str:
        form = ("hosted" if self.hosted else
                f"process {self.process}, ranks {self.ranks[0]}.."
                f"{self.ranks[-1]}" if self.mixed else f"rank {self.rank}")
        return f"Mesh({self.shape}, {form}, {self.device})"


class MeshAxis:
    """One axis of a :class:`Mesh`: what the JAX collectives take as an
    axis name inside ``shard_map``. ``hosted_size`` of its ranks lie in
    each process, ``across_size`` blocks of them in as many processes."""

    def __init__(self, mesh: Mesh, name: str):
        self.mesh = mesh
        self.name = name
        self.pos = mesh.axis_names.index(name)
        self.size = mesh.shape[name]
        self.hosted_size = mesh.hosted_shape[name]
        self.across_size = mesh.across_shape[name]

    def index(self) -> torch.Tensor:
        """Each hosted rank's coordinate on this axis: int64 [n_hosted]
        on the mesh's device."""
        return torch.tensor([self.mesh.coords(r)[self.pos]
                             for r in self.mesh.ranks],
                            dtype=torch.int64, device=self.mesh.device)

    def grid(self, x: torch.Tensor) -> torch.Tensor:
        """This process's per-rank ``x`` [n_hosted, ...] viewed over the
        hosted parts of the mesh's axes."""
        return x.reshape(*self.mesh.hosted_shape.values(), *x.shape[1:])

    def across_index(self) -> int:
        """This process's coordinate on the across part of this axis."""
        return self.mesh.process_coords(self.mesh.process)[self.pos]

    def neighbour(self, shift: int) -> int:
        """The process ``shift`` steps along the across part of this
        axis from this one (with one rank per process, the rank)."""
        c = list(self.mesh.process_coords(self.mesh.process))
        c[self.pos] = (c[self.pos] + shift) % self.across_size
        return self.mesh.process_at(c)

    def peer(self, j: int) -> int:
        """The process at across-coordinate ``j`` of this axis, the
        others as this one's."""
        c = list(self.mesh.process_coords(self.mesh.process))
        c[self.pos] = j
        return self.mesh.process_at(c)

    def peer_min(self, j: int) -> int:
        """The lowest process at across-coordinate ``j`` of this axis."""
        c = [0] * len(self.mesh.axis_names)
        c[self.pos] = j
        return self.mesh.process_at(c)

    @property
    def group(self):
        return self.mesh._groups.get(self.name)


_scope_state = threading.local()


@contextlib.contextmanager
def single_device_scope():
    """Confine the framework's stages to one device on this thread (the
    JAX ``single_device_scope``): inside it,
    :func:`in_single_device_scope` is True and ``NNModel`` and
    ``NNLearner`` place no mesh: ``tensor_parallel``,
    ``pipeline_parallel`` and a ``mesh_shape`` are not engaged, and
    their work stays on the stage's device. The flag is thread-local:
    other threads keep their meshes."""
    prev = getattr(_scope_state, "single", False)
    _scope_state.single = True
    try:
        yield
    finally:
        _scope_state.single = prev


def in_single_device_scope() -> bool:
    return getattr(_scope_state, "single", False)


def build_mesh(spec: Optional[MeshSpec] = None,
               device: DeviceLike = None) -> Mesh:
    """A :class:`Mesh` for ``spec`` (default: data parallel) on
    ``device`` (the card by default; ``"cpu"`` is the only way onto the
    CPU, and without CUDA ``None`` raises as ``resolve_device`` does).

    Outside ``torch.distributed`` (or in a world of one) this process
    hosts every rank of the mesh; a ``-1`` axis then resolves against one
    device, to size 1. In a world of P processes the ranks spread over
    the processes: a fully fixed spec of P x k ranks gives each process k
    contiguous ranks (k 1: one rank per process; k > 1: the mixed form),
    a ``-1`` axis resolves against P (one rank a process), and a fully
    fixed spec smaller than the world, or not a multiple of it, raises
    ``ValueError`` (the JAX ``build_mesh`` refuses a subset of the
    devices across processes). The default device is then
    ``cuda:<LOCAL_RANK mod the card count>``, under gloo as under NCCL
    (two processes may share a card and meet over gloo)."""
    spec = spec or MeshSpec.data_parallel()
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world == 1:
        sizes = spec.resolve(math.prod(s for _, s in spec.axes if s != -1))
        return Mesh(sizes, resolve_device(device), hosted=True)
    fixed = math.prod(s for _, s in spec.axes if s != -1)
    if all(s != -1 for _, s in spec.axes):
        if fixed < world or fixed % world:
            raise ValueError(
                f"mesh {dict(spec.axes)} has {fixed} ranks but the "
                f"multi-process world has {world} processes: every "
                f"process must hold the same number of ranks (size the "
                f"mesh to a multiple of the world, or use -1 for one "
                f"axis)")
        sizes = spec.resolve(fixed)
    else:
        sizes = spec.resolve(world)
    if device is None and torch.cuda.is_available():
        local = int(os.environ.get("LOCAL_RANK", 0))
        device = f"cuda:{local % torch.cuda.device_count()}"
    return Mesh(sizes, resolve_device(device), hosted=False)


def distributed_init(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None) -> None:
    """Join a ``torch.distributed`` process group (the JAX
    ``distributed_init``). No-op when single-process: no address (nor
    ``MMLSPARK_TPU_COORDINATOR``) and no process count. The address is a
    ``torch.distributed`` init method (``tcp://host:port``,
    ``file:///path``); a bare ``host:port`` means ``tcp://``. The backend
    defaults to NCCL where CUDA is available, else gloo; processes that
    share one card pass ``backend="gloo"`` (NCCL puts no two ranks on one
    device)."""
    addr = coordinator_address or os.environ.get("MMLSPARK_TPU_COORDINATOR")
    if addr is None and num_processes is None:
        return
    if addr is None:
        raise ValueError("num_processes given without a coordinator "
                         "address")
    if "://" not in addr:
        addr = f"tcp://{addr}"
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    dist.init_process_group(backend, init_method=addr,
                            world_size=num_processes, rank=process_id)
