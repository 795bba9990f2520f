"""Sharded step checkpoints + checkpoint integrity (the port of
``mmlspark_tpu/io/checkpoint.py``).

The native checkpoint engine both training stacks use (``NNLearner``'s
step checkpoints, the transformer's ``save_train_state`` /
``restore_train_state``). The on-disk format is the JAX package's,
file for file: every leaf of a state tree is written as the set of
distinct slices that hold it (one ``.npy`` per slice — a replicated
leaf writes once, a leaf split over the ``model`` axis one file per
slice, and no process gathers a leaf it does not hold), plus an
``index.json`` recording each leaf's global shape and dtype and every
slice's window. Restore assembles any *requested* slice from the
overlapping saved slices, so a state saved on one mesh restores onto
another (the topology change is a placement decision, not a data
migration), and a checkpoint written by either package restores in the
other, bit for bit.

A tree is a nest of dicts (flattened by sorted key), lists and tuples
(by index) and NamedTuples (by field), whose leaves are tensors, numpy
arrays, Python scalars or :class:`~mmlspark_tpu_torch.parallel.dist.
Shards` — the order and the file names ``jax.tree_util`` gives the
same tree, so a JAX template and a port template name the same leaves.
bfloat16 has no numpy dtype: its slices are written as JAX writes its
extension dtypes, a flat uint8 ``.npy`` marked ``"raw"`` with the
dtype's name as its token, and read back as 16-bit views.

Integrity manifests: every directory checkpoint written through stage
persistence (:func:`mmlspark_tpu_torch.core.serialize.save_stage`) and
every sharded save gets a ``checkpoint.sha256.json`` manifest — a
per-file SHA-256 listing plus one combined tree digest — written LAST,
so a save that died mid-way can never present a complete-looking
manifest. :func:`verify_digest` re-hashes the tree against the manifest;
the rollout path runs it in strict mode before a model version is
flip-eligible. The manifest's format is the JAX package's, byte for
byte, so a checkpoint written by either package verifies in the other.
"""

from __future__ import annotations

import collections
import hashlib
import io
import json
import os
import shutil
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from mmlspark_tpu_torch.core.environment import DeviceLike
from mmlspark_tpu_torch.core.logs import get_logger
from mmlspark_tpu_torch.parallel.dist import Shards

logger = get_logger("io.checkpoint")

#: the integrity manifest written beside every stage checkpoint
MANIFEST_FILE = "checkpoint.sha256.json"


class CheckpointIntegrityError(RuntimeError):
    """A checkpoint's content does not match its digest manifest."""


def manager(path: str, max_to_keep: int = 3, create: bool = True
            ) -> "ShardedCheckpointManager":
    from mmlspark_tpu_torch.io import fs as _fs
    if _fs.is_remote(path):
        # the native store writes with plain os/open: silently dropping
        # a gs:// checkpoint onto the VM's ephemeral disk would look
        # like it worked until the preemption it exists for
        raise NotImplementedError(
            f"the native sharded checkpoint store writes local "
            f"filesystem paths only; got {path!r} — point "
            f"checkpoint_dir at a local/NFS mount (remote-object "
            f"backends are a future arc)")
    return ShardedCheckpointManager(os.path.abspath(path),
                                    max_to_keep=max_to_keep,
                                    create=create)


# ---------------------------------------------------------------------------
# trees, flattened as jax.tree_util flattens them
# ---------------------------------------------------------------------------

INDEX_FILE = "index.json"
_FORMAT = "mmlspark-sharded-v1"

Spec = Tuple[Optional[str], ...]


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten(tree, specs=None, path: tuple = ()) -> list:
    """``[(path, leaf, spec), ...]`` in ``tree_flatten_with_path``'s
    order: dicts (a ``defaultdict`` too) by sorted key, an
    ``OrderedDict`` in its insertion order, NamedTuples by field, lists
    and tuples by index; ``None`` is an empty subtree. ``specs`` is a
    tree beside ``tree`` whose leaves are spec tuples (``None`` where a
    subtree has none): a spec pairs with the leaf at its place."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        sub = specs if isinstance(specs, dict) else {}
        return [e for k in _dict_keys(tree)
                for e in _flatten(tree[k], sub.get(k), path + (k,))]
    if _is_namedtuple(tree):
        return [e for f in tree._fields
                for e in _flatten(getattr(tree, f),
                                  getattr(specs, f, None), path + (f,))]
    if isinstance(tree, (list, tuple)):
        sub = (specs if isinstance(specs, list)
               or (isinstance(specs, tuple) and not _is_spec(specs))
               else [None] * len(tree))
        return [e for i, v in enumerate(tree)
                for e in _flatten(v, sub[i] if i < len(sub) else None,
                                  path + (i,))]
    return [(path, tree, specs if _is_spec(specs) else None)]


def _is_spec(x) -> bool:
    """A spec: a tuple of axis names and ``None`` (``()`` replicated)."""
    return (isinstance(x, tuple) and not _is_namedtuple(x)
            and all(a is None or isinstance(a, str) for a in x))


def _dict_keys(d: dict) -> list:
    """A mapping's keys in flatten order: an ``OrderedDict`` keeps its
    insertion order, as JAX's ``OrderedDict`` node does; every other
    dict (``defaultdict`` included) sorts them."""
    return list(d) if isinstance(d, collections.OrderedDict) \
        else sorted(d)


def _unflatten(template, leaves):
    """``template``'s structure with its leaves taken in order from the
    iterator ``leaves``. A mapping comes back as the template's own
    type (an ``OrderedDict``, a ``defaultdict`` with its factory), its
    keys in the template's order."""
    if template is None:
        return None
    if isinstance(template, dict):
        out = {}
        for k in _dict_keys(template):
            out[k] = _unflatten(template[k], leaves)
        items = [(k, out[k]) for k in template]
        if isinstance(template, collections.defaultdict):
            return collections.defaultdict(template.default_factory, items)
        if isinstance(template, collections.OrderedDict):
            return collections.OrderedDict(items)
        return dict(items)
    if _is_namedtuple(template):
        return type(template)(*[_unflatten(getattr(template, f), leaves)
                                for f in template._fields])
    if isinstance(template, (list, tuple)):
        return type(template)(_unflatten(v, leaves) for v in template)
    return next(leaves)


def map_leaves(fn, tree):
    """``tree`` with ``fn`` applied to every leaf (its structure kept)."""
    return _unflatten(tree, iter([fn(leaf) for _, leaf, _ in
                                  _flatten(tree)]))


def _leaf_names(tree, specs=None) -> "Tuple[list, list, list]":
    """``(leaf_name_list, leaf_list, spec_list)`` from ONE flatten:
    the JAX ``_leaf_names``' file-safe names (each path key cut to 24
    characters, ``/`` and ``\\`` replaced), so both packages name the
    same tree's files alike; restore matches BY ORDER against a
    template's flatten."""
    flat = _flatten(tree, specs)
    names = []
    for i, (path, _, _) in enumerate(flat):
        label = "".join(str(k).replace("/", "_").replace("\\", "_")[:24]
                        + "." for k in path)
        names.append(f"leaf{i:05d}.{label.strip('.')}"
                     if label.strip(".") else f"leaf{i:05d}")
    return names, [leaf for _, leaf, _ in flat], [sp for _, _, sp in flat]


# ---------------------------------------------------------------------------
# dtypes: numpy's, and the extension dtypes as bit views
# ---------------------------------------------------------------------------

#: dtypes numpy lacks: written byte-encoded under their name (the JAX
#: store's ml_dtypes token), held in memory as the unsigned 16-bit view
_EXT = {"bfloat16": (torch.bfloat16, np.uint16)}
_EXT_BY_TORCH = {t: name for name, (t, _) in _EXT.items()}


def _leaf_dtype(leaf):
    """A leaf's dtype: a ``torch.dtype`` or a numpy dtype (``None`` for a
    Python scalar, whose dtype numpy picks at save)."""
    if isinstance(leaf, (torch.Tensor, Shards)):
        return leaf.dtype
    if isinstance(leaf, (np.ndarray, np.generic)):
        return leaf.dtype
    return None


def _dtype_token(dtype) -> str:
    """Serializable dtype name (the JAX ``_dtype_token``): numpy's
    ``.str`` (``<f4``), or an extension dtype's name (``bfloat16``)."""
    if isinstance(dtype, torch.dtype):
        if dtype in _EXT_BY_TORCH:
            return _EXT_BY_TORCH[dtype]
        dtype = torch.empty(0, dtype=dtype).numpy().dtype
    return np.dtype(dtype).str


def _resolve_dtype(token: str) -> "Tuple[torch.dtype, np.dtype]":
    """``(torch dtype, numpy storage dtype)`` of a token: equal for
    numpy's dtypes, the bit view for an extension dtype."""
    if token in _EXT:
        t, store = _EXT[token]
        return t, np.dtype(store)
    np_dt = np.dtype(token)
    return torch.from_numpy(np.empty(0, np_dt)).dtype, np_dt


def _host_array(x) -> np.ndarray:
    """A leaf (or slice) as a host array in its storage dtype (an
    extension dtype as its unsigned bit view)."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        name = _EXT_BY_TORCH.get(x.dtype)
        if name is not None:
            return x.contiguous().view(torch.int16).cpu().numpy() \
                .view(_EXT[name][1])
        return x.contiguous().cpu().numpy()
    return np.asarray(x)


class _HashingWriter:
    """File wrapper hashing every written byte: the shard's sha256
    falls out of the write itself, so the digest manifest never reads
    a multi-GB checkpoint back just to hash it."""

    __slots__ = ("_f", "hash")

    def __init__(self, f):
        self._f = f
        self.hash = hashlib.sha256()

    def write(self, b):
        self.hash.update(b)
        return self._f.write(b)


def _save_shard(fpath: str, data: np.ndarray, raw: bool
                ) -> str:
    """Write one slice and return its sha256. ``raw`` (an extension
    dtype, ``data`` its bit view) writes the flat uint8 bytes the JAX
    store writes, reshaped on load from the index's window + dtype."""
    if raw:
        data = np.ascontiguousarray(data).reshape(-1).view(np.uint8)
    with open(fpath, "wb") as f:
        hw = _HashingWriter(f)
        np.save(hw, data, allow_pickle=False)
    return hw.hash.hexdigest()


# ---------------------------------------------------------------------------
# the global slice plan
# ---------------------------------------------------------------------------

Window = Tuple[Tuple[int, int], ...]


def _full(shape) -> Window:
    return tuple((0, int(s)) for s in shape)


def _split_dims(spec: Optional[Spec], mesh) -> "List[Tuple[int, str]]":
    """``(dim, axis)`` for each dim ``spec`` splits over an axis of
    ``mesh`` larger than 1."""
    if spec is None or mesh is None:
        return []
    return [(d, a) for d, a in enumerate(spec)
            if a is not None and mesh.shape.get(a, 1) > 1]


def _rank_window(shape, dims, mesh, rank: int) -> Window:
    """The block of a leaf of global ``shape`` that ``rank`` holds."""
    c = mesh.coords(rank)
    win = list(_full(shape))
    for d, a in dims:
        n = int(shape[d]) // mesh.shape[a]
        k = c[mesh.axis_names.index(a)]
        win[d] = (k * n, (k + 1) * n)
    return tuple(win)


def _process_window(shape, dims, mesh) -> Window:
    """The block of a leaf of global ``shape`` that this process holds
    over processes: along each split dim, its coordinate's block of the
    axis's part across processes (its hosted ranks share the block)."""
    c = mesh.process_coords(mesh.process)
    win = list(_full(shape))
    for d, a in dims:
        pos = mesh.axis_names.index(a)
        n = int(shape[d]) // mesh.across_shape[a]
        win[d] = (c[pos] * n, (c[pos] + 1) * n)
    return tuple(win)


def _global_shape(leaf, spec, mesh) -> Tuple[int, ...]:
    shape = [int(s) for s in leaf.shape] if hasattr(leaf, "shape") \
        else list(np.shape(leaf))
    if mesh is not None and not mesh.hosted and not isinstance(leaf,
                                                                Shards):
        # over processes: the tensor is this process's block
        for d, a in _split_dims(spec, mesh):
            shape[d] *= mesh.across_shape[a]
    return tuple(shape)


def _global_shard_plan(leaf, spec, mesh
                       ) -> "List[Tuple[Window, int, Any]]":
    """The GLOBAL distinct-slice layout of a leaf (the JAX
    ``_global_shard_plan``): ``[(window, writer, data), ...]`` sorted by
    window, the same on every process. The writer is the process that
    writes the slice: the lowest rank holding it, one rank per process,
    so slice files never race across processes; process 0 otherwise.
    ``data`` is the slice where this process writes it.

    * a :class:`Shards` is its parts, each at its place along ``dim``;
      where its axis has a part across processes, every process's parts
      are planned, each written by the lowest process holding it;
    * a tensor with a spec on a hosted mesh is whole: one slice for
      each block of the axes its spec splits over (JAX's layout of the
      same leaf);
    * over processes, the tensor is this process's block of the global
      leaf (:func:`_process_window`), and every rank's block is planned
      (JAX's layout), written by the lowest process holding it;
    * any other leaf (replicated, or no mesh) is one full slice, written
      by process 0."""
    if isinstance(leaf, Shards):
        n = int(leaf.parts[0].shape[leaf.dim])
        pid = leaf.axis.mesh.process if leaf.axis is not None else 0
        mine = leaf.offset // n
        out = []
        for j in range(len(leaf.parts) * leaf.across):
            win = list(_full(leaf.shape))
            win[leaf.dim] = (j * n, (j + 1) * n)
            block = j // len(leaf.parts)
            writer = leaf.axis.peer_min(block) if leaf.axis is not None \
                else 0
            data = (leaf.parts[j - mine] if writer == pid
                    and mine <= j < mine + len(leaf.parts) else None)
            out.append((tuple(win), writer, data))
        return out
    shape = _global_shape(leaf, spec, mesh)
    dims = _split_dims(spec, mesh)
    if not dims:
        return [(_full(shape), 0, leaf)]
    by_win: Dict[Window, int] = {}
    k = mesh.n_hosted
    for r in range(mesh.size):
        win = _rank_window(shape, dims, mesh, r)
        by_win[win] = min(by_win.get(win, r // k), r // k)
    if mesh.hosted:
        # one process holds every rank's slice of the whole tensor
        return [(win, 0, leaf[tuple(slice(a, b) for a, b in win)])
                for win in sorted(by_win)]
    base = _process_window(shape, dims, mesh)
    return [(win, writer, leaf[tuple(slice(a - o, b - o) for (a, b), (o, _)
                                     in zip(win, base))]
             if writer == mesh.process else None)
            for win, writer in sorted(by_win.items())]


def _processes(mesh) -> Tuple[int, int]:
    """``(process count, this process's index)`` of a save: a mesh over
    processes, else the ``torch.distributed`` world (one process outside
    it)."""
    if mesh is not None and not mesh.hosted:
        return mesh.n_processes, mesh.process
    d = torch.distributed
    if d.is_available() and d.is_initialized() and d.get_world_size() > 1:
        return d.get_world_size(), d.get_rank()
    return 1, 0


def _barrier() -> None:
    # the JAX store's multihost_utils.sync_global_devices
    torch.distributed.barrier()


def save_sharded(path: str, tree, extra: Optional[Dict[str, object]] = None,
                 specs=None, mesh=None) -> None:
    """Write ``tree`` under ``path`` in the sharded leaf format.

    Each leaf's distinct slices land as ``<leaf>~<k>.npy`` with their
    global windows recorded in ``index.json``; the integrity manifest
    (:func:`write_digest`) is written LAST, so an interrupted save is
    detectably incomplete and a completed one is flip-eligible for the
    rollout plane exactly like any stage checkpoint. ``extra`` rides in
    the index (step number, host metadata). ``specs`` (a tree beside
    ``tree``, spec tuples at its leaves) and ``mesh`` lay each leaf out
    as :func:`_global_shard_plan` says; a :class:`Shards` leaf carries
    its own layout.

    Several processes (a mesh of one rank per process, or a
    ``torch.distributed`` world) write ONE directory on a shared
    filesystem cooperatively: every process derives the same global
    plan, writes only the slices it owns, and process 0 writes the index
    and the digest manifest after a barrier (the manifest-last contract
    holds globally). Restore needs no multi-process awareness: a
    2-process save restores in 1 process like any sharded checkpoint."""
    n_proc, pid = _processes(mesh)
    os.makedirs(path, exist_ok=True)
    if n_proc > 1:
        # shared-filesystem probe: every process drops a marker, and
        # after the barrier every process checks it can SEE all of them
        # — a per-host local disk fails HERE, loudly, before an index
        # would reference slices that exist on another machine
        marker = os.path.join(path, f".host_marker_{pid}")
        with open(marker, "w") as f:
            f.write(str(pid))
        _barrier()
        missing = [p for p in range(n_proc)
                   if not os.path.exists(
                       os.path.join(path, f".host_marker_{p}"))]
        if missing:
            raise NotImplementedError(
                f"save_sharded needs a filesystem every process "
                f"shares: process {pid} cannot see the markers of "
                f"process(es) {missing} under {path!r} — point "
                f"checkpoint_dir at shared storage")
    names, flat, spec_list = _leaf_names(tree, specs)
    leaves: Dict[str, dict] = {}
    digests: Dict[str, str] = {}
    for name, leaf, spec in zip(names, flat, spec_list):
        dtype = _leaf_dtype(leaf)
        if dtype is None:
            leaf = np.asarray(leaf)
            dtype = leaf.dtype
        token = _dtype_token(dtype)
        raw = token in _EXT
        shards = []
        for k, (win, writer, data) in enumerate(
                _global_shard_plan(leaf, spec, mesh)):
            fname = f"{name}~{k}.npy"
            if writer == pid:
                digests[fname] = _save_shard(os.path.join(path, fname),
                                             _host_array(data), raw)
            entry: Dict[str, Any] = {"index": [list(p) for p in win],
                                     "file": fname}
            if raw:
                entry["raw"] = True
            shards.append(entry)
        leaves[name] = {"shape": list(_global_shape(leaf, spec, mesh)),
                        "dtype": token, "shards": shards}
    if n_proc > 1:
        # all slices on disk before anyone writes (or trusts) the
        # index/manifest; and everyone returns only after the manifest
        # exists — both sides of the manifest-last contract
        _barrier()
    if pid == 0:
        # the probe markers served their purpose; they must not land
        # in the digest manifest's file set
        for p in range(n_proc):
            try:
                os.remove(os.path.join(path, f".host_marker_{p}"))
            except FileNotFoundError:
                pass
        index = {"format": _FORMAT, "leaves": leaves,
                 "extra": dict(extra or {})}
        tmp = os.path.join(path, INDEX_FILE + ".tmp")
        with open(tmp, "w") as f:
            json.dump(index, f, indent=1, sort_keys=True)
        os.replace(tmp, os.path.join(path, INDEX_FILE))
        # slice digests were hashed during the writes; files other
        # processes wrote are hashed from disk (shared filesystem)
        write_digest(path, precomputed=digests)
    if n_proc > 1:
        _barrier()


def read_index(path: str) -> Dict[str, object]:
    with open(os.path.join(path, INDEX_FILE)) as f:
        index = json.load(f)
    if index.get("format") != _FORMAT:
        raise CheckpointIntegrityError(
            f"unknown checkpoint format {index.get('format')!r} at "
            f"{path!r}")
    return index


def _load_shard(path: str, sh: dict, store: np.dtype, cache: Optional[dict],
                digests: Optional[Dict[str, str]] = None) -> np.ndarray:
    """Load one stored slice (memoized per leaf: a replicated leaf read
    by several requested windows reads its file once). With
    ``digests``, the slice's sha256 is checked against the manifest AS
    the bytes are read — every consumed byte verified in the same single
    disk pass."""
    fname = sh["file"]
    if cache is not None and fname in cache:
        return cache[fname]
    with open(os.path.join(path, fname), "rb") as f:
        blob = f.read()
    if digests is not None:
        actual = hashlib.sha256(blob).hexdigest()
        if actual != digests.get(fname):
            raise CheckpointIntegrityError(
                f"digest mismatch for {fname!r}: manifest "
                f"{str(digests.get(fname))[:12]}..., file "
                f"{actual[:12]}...")
    data = np.load(io.BytesIO(blob), allow_pickle=False)
    if sh.get("raw"):
        # byte-encoded extension dtype: flat uint8 back to the bit view
        s_shape = tuple(b - a for a, b in (tuple(p) for p in sh["index"]))
        data = np.frombuffer(data.tobytes(), dtype=store).reshape(s_shape)
    if cache is not None:
        cache[fname] = data
    return data


def _assemble_slice(path: str, meta: dict, win: Window, store: np.dtype,
                    cache: Optional[dict] = None,
                    digests: Optional[Dict[str, str]] = None
                    ) -> np.ndarray:
    """Assemble the window ``win`` of one leaf from its saved slices
    (reading only overlapping files; a same-layout restore reads exactly
    its own slice back), in the storage dtype."""
    shape = tuple(meta["shape"])
    lo = [a for a, _ in win]
    hi = [b for _, b in win]
    out = np.empty([h - l for l, h in zip(lo, hi)], dtype=store)
    filled = 0
    for sh in meta["shards"]:
        s_idx = [tuple(p) for p in sh["index"]]
        # overlap of the stored slice with the requested window
        o_lo = [max(l, a) for l, (a, _) in zip(lo, s_idx)]
        o_hi = [min(h, b) for h, (_, b) in zip(hi, s_idx)]
        if any(a >= b for a, b in zip(o_lo, o_hi)):
            continue
        data = _load_shard(path, sh, store, cache, digests)
        src = tuple(slice(a - s_lo, b - s_lo) for (a, b), (s_lo, _) in
                    zip(zip(o_lo, o_hi), s_idx))
        dst = tuple(slice(a - l, b - l) for (a, b), l in
                    zip(zip(o_lo, o_hi), lo))
        out[dst] = data[src]
        filled += int(np.prod([b - a for a, b in zip(o_lo, o_hi)],
                              dtype=np.int64))
    if filled < int(np.prod(out.shape, dtype=np.int64)):
        raise CheckpointIntegrityError(
            f"stored shards do not cover the requested slice "
            f"(leaf shape {shape}, requested {list(zip(lo, hi))})")
    return out


def _to_tensor(a: np.ndarray, dtype: torch.dtype,
               device: Optional[torch.device]) -> torch.Tensor:
    """An assembled slice (its own array, in the storage dtype) as a
    tensor of ``dtype`` on ``device`` (the CPU for ``None``)."""
    t = torch.from_numpy(a)
    if t.dtype != dtype:
        t = t.view(dtype)          # the 16-bit view back to bfloat16
    if device is None or device.type == "cpu":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def _requested(leaf, spec, mesh, shape) -> "Tuple[str, list]":
    """How a leaf is rebuilt: ``("shards", windows)`` for a
    :class:`Shards` template (its parts' windows), ``("block",
    [window])`` for this process's block one rank per process, else
    ``("whole", [full window])``."""
    if isinstance(leaf, Shards):
        wins, lo = [], leaf.offset
        for p in leaf.parts:
            win = list(_full(shape))
            hi = lo + int(p.shape[leaf.dim])
            win[leaf.dim] = (lo, hi)
            wins.append(tuple(win))
            lo = hi
        return "shards", wins
    dims = _split_dims(spec, mesh)
    if dims and not mesh.hosted:
        return "block", [_process_window(shape, dims, mesh)]
    return "whole", [_full(shape)]


def _template_shape(leaf) -> Tuple[int, ...]:
    return tuple(int(s) for s in (leaf.shape if hasattr(leaf, "shape")
                                  else np.shape(leaf)))


def restore_sharded(path: str, template, specs=None, mesh=None,
                    device: DeviceLike = None,
                    strict_digest: bool = False):
    """Restore a tree saved by :func:`save_sharded` (either package's).

    ``template`` fixes the structure (leaf order matches the save) and
    each leaf's GLOBAL shape and dtype (tensors, meta tensors, arrays or
    :class:`Shards`; a Python scalar checks no dtype). Leaves come back
    as tensors on ``mesh``'s device, else on ``device``, else on the CPU
    (the host arrays of the JAX store), each window assembled from only
    the saved files that overlap it — the topology-change path:

    * a :class:`Shards` template leaf comes back as a ``Shards`` with
      the same parts (a hosted model axis's slices);
    * with ``mesh`` over processes and ``specs`` (a tree beside
      ``template``), a leaf its spec splits comes back as this process's
      block;
    * every other leaf comes back whole.

    Integrity: with ``strict_digest`` the WHOLE tree is hashed up front
    (the rollout flip-eligibility contract). Otherwise the manifest's
    file set is checked up front (missing/extra files fail fast) and
    each slice's digest is verified AS it is read; legacy digest-less
    directories load with a warning, never a failure."""
    digests: Optional[Dict[str, str]] = None
    if strict_digest:
        ok, detail = verify_digest(path, strict=True)
        if not ok:
            raise CheckpointIntegrityError(
                f"sharded checkpoint {path!r} failed digest "
                f"verification: {detail}")
    else:
        manifest_path = os.path.join(path, MANIFEST_FILE)
        if not os.path.exists(manifest_path):
            logger.warning(
                "checkpoint %s has no integrity manifest (legacy "
                "save before digests); loading unverified", path)
        else:
            try:
                with open(manifest_path) as f:
                    digests = dict(json.load(f)["files"])
            except (ValueError, KeyError, TypeError) as e:
                raise CheckpointIntegrityError(
                    f"unreadable manifest at {path!r}: {e}")
            have = set(_iter_files(path))
            missing = sorted(set(digests) - have)
            if missing:
                raise CheckpointIntegrityError(
                    f"files missing from checkpoint: {missing[:5]}")
            extra = sorted(have - set(digests))
            if extra:
                raise CheckpointIntegrityError(
                    f"files not in manifest: {extra[:5]}")
            # the index is the map everything else is read through:
            # check its (tiny) digest up front
            if INDEX_FILE in digests:
                actual = _sha256_file(os.path.join(path, INDEX_FILE))
                if actual != digests[INDEX_FILE]:
                    raise CheckpointIntegrityError(
                        f"digest mismatch for {INDEX_FILE!r}")
    index = read_index(path)
    leaves_meta = index["leaves"]
    names, flat, spec_list = _leaf_names(template, specs)
    if len(names) != len(leaves_meta):
        raise CheckpointIntegrityError(
            f"checkpoint has {len(leaves_meta)} leaves; template "
            f"expects {len(names)}")
    dev = (mesh.device if mesh is not None
           else torch.device(device) if device is not None else None)
    out = []
    for name, leaf, spec in zip(names, flat, spec_list):
        meta = leaves_meta.get(name)
        if meta is None:
            raise CheckpointIntegrityError(
                f"leaf {name!r} missing from checkpoint index")
        shape = tuple(meta["shape"])
        t_shape = _template_shape(leaf)
        if shape != t_shape:
            raise CheckpointIntegrityError(
                f"leaf {name!r}: checkpoint shape {shape} != template "
                f"shape {t_shape}")
        dtype, store = _resolve_dtype(meta["dtype"])
        t_dtype = _leaf_dtype(leaf)
        if t_dtype is not None and _dtype_token(t_dtype) != meta["dtype"]:
            # dtype drift fails as loudly as shape drift: restoring the
            # saved precision into a reconfigured model trains at the
            # wrong dtype
            raise CheckpointIntegrityError(
                f"leaf {name!r}: checkpoint dtype {meta['dtype']} != "
                f"template dtype {_dtype_token(t_dtype)}")
        cache: dict = {}   # one file read per LEAF restore
        kind, wins = _requested(leaf, spec, mesh, shape)
        parts = [_to_tensor(_assemble_slice(path, meta, w, store,
                                            cache=cache, digests=digests),
                            dtype, dev) for w in wins]
        out.append(Shards(parts, leaf.dim, leaf.spec, leaf.axis)
                   if kind == "shards" else parts[0])
    return _unflatten(template, iter(out))


# ---------------------------------------------------------------------------
# step manager
# ---------------------------------------------------------------------------

class ShardedCheckpointManager:
    """Step-directory retention over :func:`save_sharded` — the
    checkpoint-manager surface the trainer drives (``latest_step`` /
    ``save`` / ``restore`` / ``wait_until_finished``; saves are
    synchronous, so ``wait_until_finished`` is the durability no-op
    the call sites keep for interface parity)."""

    STEP_PREFIX = "step_"

    def __init__(self, path: str, max_to_keep: int = 3,
                 create: bool = True):
        self.path = path
        self.max_to_keep = int(max_to_keep)
        if create:
            os.makedirs(path, exist_ok=True)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.path, f"{self.STEP_PREFIX}{step:08d}")

    def all_steps(self) -> "list[int]":
        if not os.path.isdir(self.path):
            return []
        out = []
        for name in os.listdir(self.path):
            if not name.startswith(self.STEP_PREFIX):
                continue
            # only COMPLETE saves count: the manifest is written last,
            # so its absence marks an interrupted save (never restored,
            # swept by retention)
            if not os.path.exists(os.path.join(
                    self.path, name, MANIFEST_FILE)):
                continue
            try:
                out.append(int(name[len(self.STEP_PREFIX):]))
            except ValueError:
                continue
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, tree,
             extra: Optional[Dict[str, object]] = None,
             specs=None, mesh=None) -> str:
        target = self._step_dir(int(step))
        save_sharded(target, tree,
                     extra={"step": int(step), **(extra or {})},
                     specs=specs, mesh=mesh)
        # multi-process saves are cooperative (save_sharded barriers);
        # retention is process 0's job alone — two processes rmtree-ing
        # the same step dir is a race with no winner
        if _processes(mesh)[1] == 0:
            self._prune(current=int(step))
        return target

    def restore(self, step: Optional[int], template, specs=None, mesh=None,
                device: DeviceLike = None, strict_digest: bool = False):
        target = self.latest_step() if step is None else int(step)
        if target is None:
            raise FileNotFoundError(f"no checkpoint under {self.path!r}")
        return restore_sharded(self._step_dir(target), template,
                               specs=specs, mesh=mesh, device=device,
                               strict_digest=strict_digest)

    def _prune(self, current: Optional[int] = None) -> None:
        if self.max_to_keep > 0:
            for step in self.all_steps()[:-self.max_to_keep]:
                shutil.rmtree(self._step_dir(step), ignore_errors=True)
        if current is None:
            return
        # interrupted saves: a manifest-less step dir OLDER than the
        # one just written is a dead partial (the crash the
        # manifest-last contract detects) — sweep it, or repeated
        # preemptions accumulate unbounded shard data retention never
        # sees. Never touch dirs >= current: another manager could be
        # mid-save on a newer step
        complete = set(self.all_steps())
        for name in os.listdir(self.path):
            if not name.startswith(self.STEP_PREFIX):
                continue
            try:
                step = int(name[len(self.STEP_PREFIX):])
            except ValueError:
                continue
            if step < current and step not in complete:
                shutil.rmtree(os.path.join(self.path, name),
                              ignore_errors=True)

    def wait_until_finished(self) -> None:
        return None

    def close(self) -> None:
        return None


def _iter_files(path: str):
    """Relative paths of every regular file under ``path``, sorted, the
    top-level manifest excluded (it cannot hash itself; NESTED manifests
    — substage checkpoints are checkpoints too — are content like any
    other file)."""
    out = []
    for root, dirs, files in os.walk(path):
        dirs.sort()
        for name in sorted(files):
            rel = os.path.relpath(os.path.join(root, name), path)
            if rel == MANIFEST_FILE:
                continue
            out.append(rel)
    return out


def _sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def compute_digest(path: str,
                   precomputed: Optional[Dict[str, str]] = None
                   ) -> Dict[str, object]:
    """Hash every file under ``path`` into a manifest dict:
    ``{"files": {relpath: sha256}, "digest": <combined tree digest>}``.
    The combined digest hashes the sorted ``relpath:sha256`` lines, so
    it pins both contents AND the file set (a deleted file changes it
    as surely as a flipped bit). ``precomputed`` supplies digests a
    writer hashed while streaming the bytes out (the sharded save
    path), so a multi-GB checkpoint is not read back just to hash it;
    files not covered are hashed from disk as before."""
    precomputed = precomputed or {}
    files = {rel: precomputed.get(rel)
             or _sha256_file(os.path.join(path, rel))
             for rel in _iter_files(path)}
    tree = hashlib.sha256()
    for rel in sorted(files):
        tree.update(f"{rel}:{files[rel]}\n".encode())
    return {"files": files, "digest": tree.hexdigest()}


def write_digest(path: str,
                 precomputed: Optional[Dict[str, str]] = None
                 ) -> Dict[str, object]:
    """Write (atomically: temp file + rename) the integrity manifest
    for the checkpoint directory at ``path`` and return it. Call LAST
    in any save path — an interrupted save must leave a missing or
    stale manifest, never a valid-looking one. ``precomputed`` as in
    :func:`compute_digest`."""
    manifest = compute_digest(path, precomputed=precomputed)
    manifest["algorithm"] = "sha256"
    target = os.path.join(path, MANIFEST_FILE)
    tmp = target + ".tmp"
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=2, sort_keys=True)
    os.replace(tmp, target)
    return manifest


def verify_digest(path: str, strict: bool = False
                  ) -> Tuple[bool, Optional[str]]:
    """Verify the checkpoint at ``path`` against its manifest.

    Returns ``(ok, detail)``. A **missing** manifest is the legacy
    (pre-digest) case: with ``strict=False`` it logs a warning and
    passes (``detail`` says why), with ``strict=True`` it fails — the
    rollout flip-eligibility contract, where "cannot prove integrity"
    must read as "not safe to serve". A **mismatch** (changed bytes,
    missing files, extra files) always fails; callers that load the
    checkpoint raise :class:`CheckpointIntegrityError` on it.
    """
    manifest_path = os.path.join(path, MANIFEST_FILE)
    if not os.path.exists(manifest_path):
        detail = ("no integrity manifest (legacy checkpoint saved "
                  "before digests)")
        if strict:
            return False, detail
        logger.warning("checkpoint %s has %s; loading unverified",
                       path, detail)
        return True, detail
    try:
        with open(manifest_path) as f:
            manifest = json.load(f)
        want = dict(manifest["files"])
    except (ValueError, KeyError, TypeError) as e:
        return False, f"unreadable manifest: {e}"
    have = set(_iter_files(path))
    missing = sorted(set(want) - have)
    if missing:
        return False, f"files missing from checkpoint: {missing[:5]}"
    extra = sorted(have - set(want))
    if extra:
        return False, f"files not in manifest: {extra[:5]}"
    for rel, digest in sorted(want.items()):
        actual = _sha256_file(os.path.join(path, rel))
        if actual != digest:
            return False, (f"digest mismatch for {rel!r}: "
                           f"manifest {digest[:12]}..., "
                           f"file {actual[:12]}...")
    return True, None
