"""Device meshes for the port: the ``data`` and ``seq`` axes over ranks.

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
  once, folded into its batch.
* **distributed** — one rank per process over ``torch.distributed``
  (gloo on the CPU, NCCL on cards). The world size must equal the
  mesh's size; the leading per-rank dimension is 1, and the
  collectives are point-to-point sends and ``all_reduce``.

Only the ``data`` and ``seq`` axes are supported: a ``model``,
``expert`` or ``pipe`` axis of size > 1 raises ``NotImplementedError``
(tensor, expert and pipeline parallelism are ROADMAP queue 1 item 9).
"""

from __future__ import annotations

import dataclasses
import math
import os
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
#: the axes the port runs; the others only at size 1
SUPPORTED_AXES = (AXIS_DATA, AXIS_SEQ)


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


class Mesh:
    """Named axes over ranks, hosted by this process or one per process
    (see the module docstring). ``shape`` maps each axis to its size, in
    order; ``device`` is where this process's per-rank tensors live."""

    def __init__(self, shape: Dict[str, int], device: torch.device,
                 hosted: bool):
        for name, size in shape.items():
            if name not in ALL_AXES:
                raise ValueError(f"unknown mesh axis {name!r} (one of "
                                 f"{ALL_AXES})")
            if size < 1:
                raise ValueError(f"mesh axis {name!r} has size {size}")
            if name not in SUPPORTED_AXES and size > 1:
                raise NotImplementedError(
                    f"mesh axis {name!r} of size {size}: the port runs "
                    f"only the data and seq axes (tensor, expert and "
                    f"pipeline parallelism are ROADMAP queue 1 item 9)")
        self.shape: Dict[str, int] = dict(shape)
        self.axis_names: Tuple[str, ...] = tuple(shape)
        self.size = math.prod(shape.values())
        if device.type == "cuda" and device.index is None:
            # the tensors it makes say cuda:<n>: name the device so
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = device
        self.hosted = hosted
        self.rank = 0 if hosted else dist.get_rank()
        if not hosted and dist.get_world_size() != self.size:
            raise ValueError(f"mesh {self.shape} has {self.size} ranks but "
                             f"the process group has "
                             f"{dist.get_world_size()}")
        #: this process's ranks, in order: all of them, or its own
        self.ranks = list(range(self.size)) if hosted else [self.rank]
        self._groups = {} if hosted else self._axis_groups()

    @property
    def n_hosted(self) -> int:
        """The leading dimension of this process's per-rank tensors."""
        return len(self.ranks)

    def coords(self, rank: int) -> Tuple[int, ...]:
        """A rank's coordinate on every axis (row-major)."""
        return tuple(int(c) for c in
                     np.unravel_index(rank, tuple(self.shape.values())))

    def rank_at(self, coords) -> int:
        return int(np.ravel_multi_index(tuple(coords),
                                        tuple(self.shape.values())))

    def axis(self, name: str) -> "MeshAxis":
        if name not in self.shape:
            raise ValueError(f"mesh {self.shape} has no axis {name!r}")
        return MeshAxis(self, name)

    def _axis_groups(self) -> Dict[str, object]:
        """The process group of each axis that spans some but not all
        processes, holding this process. Every process creates every
        group, in the same order, as ``torch.distributed`` requires."""
        groups = {}
        dims = tuple(self.shape.values())
        for pos, name in enumerate(self.axis_names):
            n = dims[pos]
            if n in (1, self.size):
                groups[name] = None            # no peers / the world
                continue
            for other in np.ndindex(*(d for i, d in enumerate(dims)
                                      if i != pos)):
                ranks = [self.rank_at(other[:pos] + (c,) + other[pos:])
                         for c in range(n)]
                group = dist.new_group(ranks)
                if self.rank in ranks:
                    groups[name] = group
        return groups

    def __repr__(self) -> str:
        form = "hosted" if self.hosted else f"rank {self.rank}"
        return f"Mesh({self.shape}, {form}, {self.device})"


class MeshAxis:
    """One axis of a :class:`Mesh`: what the JAX collectives take as an
    axis name inside ``shard_map``."""

    def __init__(self, mesh: Mesh, name: str):
        self.mesh = mesh
        self.name = name
        self.pos = mesh.axis_names.index(name)
        self.size = mesh.shape[name]

    def index(self) -> torch.Tensor:
        """Each hosted rank's coordinate on this axis: int64 [n_hosted]
        on the mesh's device."""
        return torch.tensor([self.mesh.coords(r)[self.pos]
                             for r in self.mesh.ranks],
                            dtype=torch.int64, device=self.mesh.device)

    def grid(self, x: torch.Tensor) -> torch.Tensor:
        """Hosted ``x`` [n_hosted, ...] viewed over the mesh's axes."""
        return x.reshape(*self.mesh.shape.values(), *x.shape[1:])

    def neighbour(self, shift: int) -> int:
        """The rank ``shift`` steps along this axis from this process's
        (distributed form)."""
        c = list(self.mesh.coords(self.mesh.rank))
        c[self.pos] = (c[self.pos] + shift) % self.size
        return self.mesh.rank_at(c)

    @property
    def group(self):
        return self.mesh._groups.get(self.name)


def build_mesh(spec: Optional[MeshSpec] = None,
               device: DeviceLike = None) -> Mesh:
    """A :class:`Mesh` for ``spec`` (default: data parallel).

    Outside ``torch.distributed`` (or in a world of one) this process
    hosts every rank of the mesh on ``device``; a ``-1`` axis then
    resolves against one device, to size 1. In a world of several
    processes each process is one rank: the spec must resolve to the
    world size, ``device`` defaults to ``cuda:<local rank>`` when the
    backend is NCCL and to the CPU under gloo. Mixing the forms (several
    processes, each hosting several ranks) is ROADMAP queue 1 item 9, as
    is a mesh with fewer ranks than processes (the JAX ``build_mesh``
    takes a leading subset of the devices there)."""
    spec = spec or MeshSpec.data_parallel()
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world == 1:
        sizes = spec.resolve(math.prod(s for _, s in spec.axes if s != -1))
        return Mesh(sizes, resolve_device(device), hosted=True)
    sizes = spec.resolve(world)
    if device is None:
        device = (f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"
                  if dist.get_backend() == "nccl" else "cpu")
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
    defaults to NCCL where CUDA is available, else gloo."""
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
