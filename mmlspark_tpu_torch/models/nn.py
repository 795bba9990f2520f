"""NNModel: deep-network scoring as a pipeline Transformer, on the card.

The port of ``mmlspark_tpu/models/nn.py`` (single device). A frame's
column is stacked on the host, cast there to the transfer dtype, cut
into static ``batch_size`` minibatches (the last one padded through
:func:`~mmlspark_tpu_torch.parallel.sharding.padded_device_batch`),
uploaded from pinned memory without blocking, and scored by the
network's :class:`~mmlspark_tpu_torch.models.function.LayeredModel`
on the device. Outputs are unpadded and concatenated on the device, and
a whole group of minibatches comes back in one copy into pinned host
memory, started as soon as the group is sealed; one sealed group stays
in flight while the host waits for the one before, so the card keeps
computing while the host reads back. Nothing synchronizes per batch.

Integer and scaled wires are dequantized on the device before the first
layer (``x * scale + offset`` in the model's compute dtype); under
compute quantization the int8 kernels are dequantized to the activation
dtype inside each forward, and no dequantized copy persists.

The frame cache keeps a frame's padded device batches in a bounded LRU
shared across models, keyed by the column's identity, the transfer
dtype, the batch size, the device and a full content digest, so scoring
one frame through several models uploads it once more after its first
sighting, and an in-place edit of a cached column misses.

``data_parallel`` on one card places as one device, as JAX does on a
one-device host. The parallel modes run over a mesh hosted on the
stage's device (the port's form of JAX's device slices):

* ``tensor_parallel=t`` serves on the mesh ``{"data": 1, "model": t}``:
  the weights are placed by :func:`~mmlspark_tpu_torch.parallel.dist.
  shard_state` (a leaf the rule splits is held as its model ranks'
  slices, :class:`~mmlspark_tpu_torch.models.function.PlacedModule`) and
  gathered inside each forward;
* ``pipeline_parallel=p`` cuts the layer chain into ``p`` stages by
  :func:`~mmlspark_tpu_torch.parallel.pipeline.plan_stages` (a layer's
  cost is its parameter bytes), each stage on its own slice of the
  hosted ranks (``{"data": 1}``, or ``{"data": 1, "model": t}`` when
  tensor parallelism composes in), and drives micro-batched frames
  through them (:class:`~mmlspark_tpu_torch.parallel.pipeline.
  PipelineRunner`: a CUDA stream a stage on the card).

Neither mode engages with ``data_parallel`` off or inside
:func:`~mmlspark_tpu_torch.parallel.topology.single_device_scope`
(configuration alone never claims them; ``placement()`` says what
served). In a world of P processes ``tensor_parallel=t`` serves on the
mesh ``{"data": P / t, "model": t}`` (``t >= P``: ``{"data": 1,
"model": t}``) spread over the processes, as JAX's spans its global
devices: each process holds its model ranks' slices and a forward
gathers the rest over the model axis's group, so every process must
call ``transform`` alike (the same rows, batch for batch).
``pipeline_parallel`` in such a world raises ``ValueError``, as JAX's
does (its stages ``device_put`` onto devices of other processes).
"""

from __future__ import annotations

import functools
import hashlib
import threading
from collections import OrderedDict, deque
from typing import Any, Dict, Optional

import numpy as np
import torch

from mmlspark_tpu_torch.core import schema
from mmlspark_tpu_torch.core.dataframe import DataFrame
from mmlspark_tpu_torch.core.environment import resolve_device
from mmlspark_tpu_torch.core.params import (
    HasDevice, HasInputCol, HasOutputCol, Param, in_set,
)
from mmlspark_tpu_torch.core.stage import Model
from mmlspark_tpu_torch.models.function import (
    LayeredModel, NNFunction, PlacedModule, layer_chain,
)
from mmlspark_tpu_torch.parallel import dist as _dist
from mmlspark_tpu_torch.parallel.sharding import (
    pad_to_bucket, padded_device_batch, round_to_multiple, unpad,
)
from mmlspark_tpu_torch.parallel.topology import in_single_device_scope

#: the wire dtypes a frame can cross in; bf16 travels as its uint16 bits
#: (numpy has no bfloat16 of its own)
_WIRE = {"float32": (np.float32, torch.float32),
         "bfloat16": (np.uint16, torch.bfloat16),
         "uint8": (np.uint8, torch.uint8),
         "int8": (np.int8, torch.int8)}


def _host_cast(x: np.ndarray, wire: str) -> np.ndarray:
    """Cast a stacked frame to its wire on the host. bf16 rounds to
    nearest even (PyTorch's CPU cast) and is handed on as its uint16
    bits; the other wires are numpy casts, as in JAX."""
    if wire == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(x, np.float32))
        return t.to(torch.bfloat16).view(torch.int16).numpy().view(
            np.uint16)
    return np.ascontiguousarray(x.astype(_WIRE[wire][0], copy=False))


def _device_put(x: np.ndarray, placement: torch.device,
                wire: str = "float32") -> torch.Tensor:
    """Host->device upload (module-level so tests can count uploads):
    on the card from a pinned staging copy without blocking."""
    t = torch.from_numpy(np.ascontiguousarray(x))
    if wire == "bfloat16":
        t = t.view(torch.bfloat16)
    if placement.type == "cuda":
        return t.pin_memory().to(placement, non_blocking=True)
    return t.clone()          # a device copy never aliases the frame


# -- device-resident input cache --------------------------------------------
#
# Scoring the SAME frame through several models (tuning, featurizer
# sweeps) would pay the whole upload again each time. The cache keys a
# frame's padded device batches on the column object's identity plus a
# FULL content digest (blake2b over every byte; object columns hash each
# element), so an in-place edit of a cached column misses instead of
# serving stale scores. A frame is only STORED on its second sighting
# (one-shot frames such as serving batches never pin device memory),
# and the store is a bounded LRU (4 frames, 256 MB each).

_FRAME_CACHE: "OrderedDict[tuple, tuple]" = OrderedDict()  # key -> batches
_FRAME_SEEN: "OrderedDict[tuple, None]" = OrderedDict()    # once-seen keys
_FRAME_LOCK = threading.Lock()
_FRAME_CACHE_MAX_ENTRIES = 4
_FRAME_SEEN_MAX_ENTRIES = 64
_FRAME_CACHE_MAX_BYTES = 256 << 20

#: bytes of inputs, then of outputs, a read-back group may hold
_GROUP_BYTES = 256 << 20


def _frame_cache():
    return _FRAME_CACHE


def _content_digest(col) -> bytes:
    """Full-buffer blake2b of the column (every element for object
    columns): in-place mutations of a cached column are always
    detected."""
    h = hashlib.blake2b(digest_size=16)
    if col.dtype == np.dtype("O"):
        for e in col:
            a = np.ascontiguousarray(np.asarray(e))
            h.update(str((a.shape, a.dtype.str)).encode())
            h.update(a.data if a.flags.c_contiguous else a.tobytes())
    else:
        a = col if col.flags.c_contiguous else np.ascontiguousarray(col)
        h.update(a.data if a.flags.c_contiguous else a.tobytes())
    return h.digest()


def _frame_cheap_key(col, wire: str, bs: int, placement):
    """Hash-free first-stage key: the digest is only computed once this
    key has been SEEN (the frame is a store/lookup candidate)."""
    return (id(col), col.ctypes.data, col.shape, col.dtype.str, wire, bs,
            str(placement))


def _frame_est_bytes(col, wire: str) -> int:
    """Transfer-size estimate without stacking the column."""
    n = len(col)
    if n == 0:
        return 0
    itemsize = np.dtype(_WIRE[wire][0]).itemsize
    if col.dtype == np.dtype("O"):
        return n * int(np.asarray(col[0]).size) * itemsize
    return int(np.prod(col.shape, dtype=np.int64)) * itemsize


def _stack_column(col: np.ndarray) -> np.ndarray:
    """Stack a column to one array, preserving the source dtype (a uint8
    image column reaches the wire cast as uint8)."""
    if col.dtype == np.dtype("O"):
        if len(col) == 0:
            return np.zeros((0,), dtype=np.float32)
        return np.stack([np.asarray(v) for v in col])
    return np.asarray(col)


def _to_host(t: torch.Tensor) -> torch.Tensor:
    """Start copying ``t`` back to the host; the copy lands in pinned
    memory, without blocking, on the card."""
    if t.device.type != "cuda":
        return t
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    return host


def _as_numpy(t: torch.Tensor) -> np.ndarray:
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


class NNModel(Model, HasInputCol, HasOutputCol, HasDevice):
    """Score rows through a deep-net forward pass on the card."""

    input_col = Param("features", "input column (vectors or images)", ptype=str)
    output_col = Param("scores", "output column", ptype=str)
    model = Param(None, "the NNFunction to evaluate", complex=True)
    batch_size = Param(256, "minibatch size per device step", ptype=int)
    output_layer = Param(None, "truncate at this named layer", ptype=str)
    cut_output_layers = Param(0, "cut the last N layers instead of naming one",
                              ptype=int)
    data_parallel = Param(True, "shard minibatches over all local devices "
                          "(one card: a single device)", ptype=bool)
    tensor_parallel = Param(0, "tensor-parallel width (0/1 = off): the "
                            "weights split over a hosted 'model' axis of "
                            "this width by the dist rule, gathered in "
                            "each forward; a width that does not divide "
                            "a leaf replicates it", ptype=int)
    pipeline_parallel = Param(0, "pipeline-parallel stage count (0/1 = "
                              "off): the layer chain is cut into this "
                              "many contiguous stages balanced by "
                              "parameter bytes (parallel/pipeline."
                              "plan_stages), each on its own slice of the "
                              "hosted ranks, and every transform drives "
                              "micro-batched frames through them, a CUDA "
                              "stream a stage on the card; composes with "
                              "tensor_parallel (a 'model' axis within "
                              "each slice)", ptype=int)
    pipeline_microbatches = Param(4, "micro-batches per pipelined frame: "
                                  "more fills the bubble ((K-1)/(M+K-1)) "
                                  "but shrinks each dispatch; capped by "
                                  "the frame's rows", ptype=int)
    input_dtype = Param("auto", "host-side cast before transfer: auto casts "
                        "to bfloat16 for bfloat16 models | float32 | "
                        "bfloat16 | uint8 | int8 (quantized wire bytes, "
                        "dequantized ON DEVICE via input_scale/"
                        "input_offset before the first layer)",
                        validator=in_set("auto", "float32", "bfloat16",
                                         "uint8", "int8"))
    input_scale = Param(None, "on-device input scaling x*scale+offset; "
                        "default 1/255 for uint8/int8 transfers (images "
                        "-> [0,1]), 1.0 otherwise", ptype=float)
    input_offset = Param(0.0, "on-device input offset (see input_scale)",
                         ptype=float)
    quantization = Param(None, "a serving.quant.QuantizationConfig: wire "
                         "dtype + scale/zero_point end to end, overriding "
                         "input_dtype/input_scale/input_offset; its "
                         "compute section runs int8 kernels",
                         complex=True)
    fetch_batches = Param(32, "minibatches scored per device->host fetch: "
                          "outputs are unpadded and concatenated on the "
                          "device, so a whole group costs one read-back",
                          ptype=int)
    cache_inputs = Param(True, "keep the frame's padded minibatches "
                         "device-resident in a bounded LRU shared across "
                         "models (stored on a frame's second sighting; "
                         "frames over 256 MB bypass it; keys include a "
                         "full content digest)", ptype=bool)

    # -- execution ----------------------------------------------------------

    def _transfer_dtype(self) -> str:
        """The wire's name: ``float32``, ``bfloat16``, ``uint8`` or
        ``int8``."""
        mode = self.input_dtype
        if self.quantization is not None:
            wire = self.quantization.wire_dtype
            # "none" = compute-only quantization: payloads stay in the
            # model's native transfer dtype
            mode = "auto" if wire == "none" else wire
        if mode == "auto":
            arch = getattr(self.model, "arch", None) or {}
            mode = ("bfloat16" if arch.get("dtype") == "bfloat16"
                    else "float32")
        return mode

    def _resolve_output_layer(self) -> Optional[str]:
        if self.output_layer is not None:
            return self.output_layer
        if self.cut_output_layers:
            return self.model.layer_name_for_cut(self.cut_output_layers)
        return None

    def _set_param(self, name, value):
        # param changes invalidate the forward and the device placement
        for key in ("_forward", "_quant_state", "_setup_single_cache",
                    "_placement_single", "_setup_sharded",
                    "_setup_pipeline", "_pipeline_out_shape",
                    "_pipeline_plan", "_placement_label"):
            self.__dict__.pop(key, None)
        super()._set_param(name, value)

    @property
    def batch_multiple(self) -> int:
        """The divisibility the dispatch puts on batch rows: the data-axis
        size its batches split over (the serving plane's bucket ladder
        rounds every bucket up to it). Every mode here runs on a hosted
        mesh whose data axis has one rank, so it is 1 (JAX's is the
        host's device count over the model and pipe widths)."""
        return 1

    # -- placement visibility (the /stats and dispatch-span surface) --------

    @property
    def placement_label(self) -> Optional[str]:
        """The compact mesh label (``"data=1,model=2"``, or
        ``"pipe=2,data=1,model=2"`` pipelined) once a mesh has been
        placed; None before the first dispatch and on one device."""
        label = self.__dict__.get("_placement_label")
        if label is not None:
            return label
        placed = self.__dict__.get("_setup_sharded")
        if placed is None:
            return None
        label = _dist.placement_label(placed.mesh)
        self.__dict__["_placement_label"] = label
        return label

    def placement(self) -> Dict[str, Any]:
        """Where the model really serves, from the mesh a dispatch
        placed on, never from configuration alone: ``"unplaced"`` before
        the first dispatch; ``"pipeline_parallel"`` with each stage's
        ranks; ``"tensor_parallel"`` with the mesh's
        :func:`~mmlspark_tpu_torch.parallel.dist.placement_report` (what
        each rank holds); else ``"single_device"`` with the device and
        the card's name. Cheap — no device work."""
        out: Dict[str, Any] = {"tensor_parallel":
                               int(self.tensor_parallel or 0),
                               "pipeline_parallel":
                               int(self.pipeline_parallel or 0)}
        if self._pipeline_active() and "_setup_pipeline" in self.__dict__:
            runner, _ = self.__dict__["_setup_pipeline"]
            out["mode"] = "pipeline_parallel"
            out["n_stages"] = runner.n_stages
            out["stages"] = [{"stage": k, "devices": list(devs)}
                             for k, (_, _, _, devs)
                             in enumerate(runner.stages)]
            out["n_devices"] = sum(len(st["devices"])
                                   for st in out["stages"])
            return out
        placed = self.__dict__.get("_setup_sharded")
        if placed is not None:
            out["mode"] = "tensor_parallel"
            out.update(_dist.placement_report(placed.state, placed.mesh))
            return out
        single = self.__dict__.get("_placement_single")
        if single is None:
            out["mode"] = "unplaced"
            return out
        out["mode"] = "single_device"
        out["devices"] = [single[0]]
        out["device_kind"] = single[1]
        out["n_devices"] = 1
        return out

    def _dequant_constants(self):
        """(scale, offset, deq_dtype): the on-device input transform."""
        is_int = self._transfer_dtype() in ("uint8", "int8")
        if self.quantization is not None:
            scale = self.quantization.scale
            offset = float(self.quantization.zero_point)
        else:
            scale = self.input_scale
            if scale is None:
                scale = (1.0 / 255.0) if is_int else 1.0
            offset = float(self.input_offset)
        arch = getattr(self.model, "arch", None) or {}
        deq_dtype = (torch.bfloat16 if arch.get("dtype") == "bfloat16"
                     else torch.float32)
        return scale, offset, deq_dtype

    @property
    def _compute_quant(self):
        """The :class:`~mmlspark_tpu_torch.serving.quant.
        ComputeQuantization` riding this model's config, or None."""
        return getattr(self.quantization, "compute", None) \
            if self.quantization is not None else None

    @functools.cached_property
    def _quant_state(self):
        """``(int8-kernel param tree, {keystr path: per-channel
        scales})``, derived once per configured model; None without a
        compute section."""
        comp = self._compute_quant
        if comp is None:
            return None
        from mmlspark_tpu_torch.serving.quant import quantize_param_tree
        return quantize_param_tree(self.model.params, comp)

    @property
    def _served_params(self):
        """The tree placement uploads: int8 kernels under compute
        quantization, the f32 tree otherwise."""
        qs = self._quant_state
        return self.model.params if qs is None else qs[0]

    def _dequant_input(self, x: torch.Tensor) -> torch.Tensor:
        scale, offset, deq_dtype = self._dequant_constants()
        if not x.is_floating_point() or scale != 1.0 or offset != 0.0:
            # dequantize/normalize on the device: integer payloads
            # cross the link raw
            x = x.to(deq_dtype) * torch.tensor(scale, dtype=deq_dtype) \
                + torch.tensor(offset, dtype=deq_dtype)
        return x

    @functools.cached_property
    def _forward(self):
        """``forward(module, x) -> scores`` on the module's device."""
        out_layer = self._resolve_output_layer()
        comp = self._compute_quant
        if comp is None:
            @torch.no_grad()
            def forward(module, x):
                return module(self._dequant_input(x),
                              output_layer=out_layer)
            return forward
        from mmlspark_tpu_torch.models.function import state_key
        from mmlspark_tpu_torch.serving.quant import keystr
        act = getattr(torch, comp.activation_dtype)
        # keystr path -> state name, for the leaves that carry scales
        names = {keystr(tuple(k.split("/"))): state_key(k)
                 for k in _flat_keys(self.model.params)}
        qscales = self._quant_state[1]
        on_device: Dict[tuple, torch.Tensor] = {}

        @torch.no_grad()
        def forward(module, x):
            # int8 kernels dequantize into their convs and matmuls
            # (w_q -> f32 * scale -> activation dtype); the dequantized
            # weights live only inside this call
            sd = module.whole()
            over = {}
            for path, s in qscales.items():
                name = names[path]
                w = sd[name]
                key = (name, str(w.device))
                if key not in on_device:
                    # output channels lead the torch layouts: conv
                    # (O, I, kh, kw), dense (O, I)
                    on_device[key] = torch.as_tensor(s, device=w.device) \
                        .view(-1, *([1] * (w.ndim - 1)))
                over[name] = (w.to(torch.float32) * on_device[key]).to(act)
            x = self._dequant_input(x).to(act)
            out = module(x, output_layer=out_layer, state={**sd, **over})
            # the reply comes back f32, whatever the activation dtype
            return out.to(torch.float32)
        return forward

    def quant_parity_report(self, df, rtol: Optional[float] = None
                            ) -> Dict[str, Any]:
        """Row-wise parity of the int8-compute forward against the f32
        reference on one frame — the rollout verify step's evidence.

        Both forwards run on this model's device on the same dequantized
        input: the reference with the f32 tree, the candidate the served
        int8 forward. A row passes when every element satisfies
        ``|q - ref| <= tol + tol * |ref|`` (``np.isclose`` with ``atol =
        rtol = tol``); ``tol`` defaults to the config's ``tolerance``."""
        comp = self._compute_quant
        if comp is None:
            return {"passed": True, "rows": 0, "bad_rows": 0,
                    "max_rel": 0.0, "rtol": None}
        dev = resolve_device(self.device)
        wire = self._transfer_dtype()
        x = _device_put(_host_cast(_stack_column(df[self.input_col]), wire),
                        dev, wire)
        out_layer = self._resolve_output_layer()
        with torch.no_grad():
            ref = _as_numpy(self.model.to_module(dev)(
                self._dequant_input(x), output_layer=out_layer).cpu())
        got = _as_numpy(self._forward(self._device_module(dev), x).cpu())
        ref = ref.astype(np.float32)
        tol = float(rtol if rtol is not None else comp.tolerance)
        ok = np.isclose(got, ref, rtol=tol, atol=tol)
        flat_ok = ok.reshape(len(ok), -1) if ok.ndim > 1 \
            else ok.reshape(-1, 1)
        row_ok = flat_ok.all(axis=1)
        denom = np.maximum(np.abs(ref), 1.0)
        max_rel = float(np.max(np.abs(got - ref) / denom)) \
            if ref.size else 0.0
        return {"passed": bool(row_ok.all()),
                "rows": int(len(row_ok)),
                "bad_rows": int((~row_ok).sum()),
                "max_rel": max_rel, "rtol": tol}

    @functools.cached_property
    def _setup_single_cache(self):
        return {}  # str(device) -> the module with the served weights

    def _device_module(self, dev: torch.device):
        cache = self._setup_single_cache
        key = str(dev)
        if key not in cache:
            cache[key] = self.model.to_module(dev, self._served_params)
        return cache[key]

    def _tp_active(self) -> bool:
        """Tensor-parallel dispatch engages with ``tensor_parallel`` above
        1, ``data_parallel`` on and no pinned single-device scope."""
        return int(self.tensor_parallel or 0) > 1 \
            and bool(self.data_parallel) and not in_single_device_scope()

    @staticmethod
    def _world() -> int:
        d = torch.distributed
        return (d.get_world_size() if d.is_available() and d.is_initialized()
                else 1)

    def _check_world(self) -> None:
        """Pipeline parallelism runs in one process: JAX's places each
        stage on its slice of the global devices with ``device_put``,
        which refuses another process's devices."""
        world = self._world()
        if self._pipeline_active() and world > 1:
            raise ValueError(
                f"pipeline_parallel={self.pipeline_parallel} in a world of "
                f"{world} processes: the stages are placed on devices of "
                f"other processes, which a process cannot address (JAX's "
                f"device_put refuses them too); pipeline stages within one "
                f"process, or tensor_parallel across processes")

    @functools.cached_property
    def _setup_sharded(self) -> PlacedModule:
        """Tensor parallel: one copy of the served weights over the mesh
        ``{"data": d, "model": t}`` (hosted, d 1; over a world of P
        processes, d ``P / t`` or 1), each leaf the rule splits held as
        its model ranks' slices."""
        tp, world = int(self.tensor_parallel), self._world()
        if world > 1 and tp % world and world % tp:
            raise ValueError(f"tensor_parallel={tp} does not divide the "
                             f"{world}-process world")
        mesh = _dist.train_mesh(
            {"data": max(world // tp, 1), "model": tp},
            resolve_device(self.device))
        return PlacedModule(self.model.module(), self._served_params, mesh)

    def _device_setup(self) -> "tuple[torch.device, Any]":
        """Placement: (device, the module with the served weights there,
        or the tensor-parallel :class:`PlacedModule`). The decision is
        made each call: the single-device scope is a thread-local."""
        dev = resolve_device(self.device)
        if self._tp_active():
            return dev, self._setup_sharded
        module = self._device_module(dev)
        if "_placement_single" not in self.__dict__:
            label, kind = str(dev), "cpu"
            if dev.type == "cuda":
                index = dev.index if dev.index is not None \
                    else torch.cuda.current_device()
                label, kind = f"cuda:{index}", torch.cuda.get_device_name(
                    index)
            self.__dict__["_placement_single"] = (label, kind)
        return dev, module

    def _run(self, module, x: torch.Tensor) -> torch.Tensor:
        """One minibatch's forward (a seam tests and the chip script
        time through)."""
        return self._forward(module, x)

    # -- pipeline parallelism (parallel/pipeline.py) -------------------------

    def _pipeline_active(self) -> bool:
        """Pipelined dispatch engages with ``pipeline_parallel`` of 2 or
        more, ``data_parallel`` on and no pinned single-device scope. The
        hosted mesh has a slice of ranks for every stage, so no stage
        count is refused for want of devices (JAX turns off a count that
        does not divide the host's devices)."""
        pp = int(self.pipeline_parallel or 0)
        return pp >= 2 and bool(self.data_parallel) \
            and not in_single_device_scope()

    @functools.cached_property
    def _setup_pipeline(self):
        """``(runner, stage data multiple)``: the staged model. The layer
        chain (cut at the output layer) is partitioned by
        :func:`~mmlspark_tpu_torch.parallel.pipeline.plan_stages` over
        each layer's parameter bytes, and each stage's sub-chain (a
        :class:`LayeredModel`, its params renumbered from the stage's
        first layer) is placed on its slice of the hosted ranks:
        ``{"data": 1}``, or ``{"data": 1, "model": t}`` with tensor
        parallelism. The first stage dequantizes the wire."""
        import re
        from mmlspark_tpu_torch.parallel.pipeline import (
            PipelineRunner, plan_stages)

        pp = int(self.pipeline_parallel)
        dev = resolve_device(self.device)
        layers = layer_chain(self.model.module())
        out_layer = self._resolve_output_layer()
        if out_layer is not None:
            names = [n for n, _ in layers]
            layers = layers[:names.index(out_layer) + 1]
        # each layer's params: flax names the chain's modules
        # "layers_<i>_<j>", across every collection
        pat = re.compile(r"layers_(\d+)(_.+)?$")
        per_layer: list = [dict() for _ in layers]
        for cname, cdict in (self.model.params or {}).items():
            for key, sub in cdict.items():
                m = pat.match(key)
                if m is None or int(m.group(1)) >= len(layers):
                    continue
                per_layer[int(m.group(1))].setdefault(cname, {})[key] = sub
        costs = [max(float(_dist.tree_bytes(coll)), 1.0)
                 for coll in per_layer]
        tp = int(self.tensor_parallel or 0)
        width = max(tp, 1)
        # the hosted ranks' labels: each stage owns a disjoint slice
        ranks = [f"{dev}#{r}" for r in range(pp * width)]
        plan = plan_stages(costs, pp, ranks)
        shape = {"data": 1, "model": tp} if tp > 1 else {"data": 1}
        stages = []
        stage_data = 1
        for k, ((a, b), devs) in enumerate(zip(plan.boundaries,
                                               plan.devices)):
            sub_params: Dict[str, Any] = {}
            for i in range(a, b):
                for cname, keys in per_layer[i].items():
                    for key, sub in keys.items():
                        m = pat.match(key)
                        new = f"layers_{int(m.group(1)) - a}" \
                              f"{m.group(2) or ''}"
                        sub_params.setdefault(cname, {})[new] = sub
            mesh_k = _dist.train_mesh(shape, dev)
            stage_data = mesh_k.shape["data"]
            placed = PlacedModule(LayeredModel(layers[a:b]), sub_params,
                                  mesh_k)
            stages.append((self._stage_fn(first=k == 0), placed, dev,
                           tuple(devs)))
        runner = PipelineRunner(stages,
                                microbatches=self.pipeline_microbatches)
        self.__dict__["_pipeline_plan"] = plan
        self.__dict__["_placement_label"] = \
            f"pipe={pp},data={stage_data},model={width}"
        return runner, stage_data

    def _stage_fn(self, first: bool):
        @torch.no_grad()
        def fwd(placed, x):
            return placed(self._dequant_input(x) if first else x)
        return fwd

    def pipeline_report(self) -> Optional[Dict[str, Any]]:
        """The ``/stats`` "pipeline" block: stages, each stage's ranks
        and layers, the measured bubble, the micro-batches in flight.
        None when pipelining is off or nothing has dispatched yet."""
        if not self._pipeline_active() \
                or "_setup_pipeline" not in self.__dict__:
            return None
        runner, stage_data = self.__dict__["_setup_pipeline"]
        rep = runner.report()
        plan = self.__dict__.get("_pipeline_plan")
        if plan is not None:
            for entry, (bounds, cost) in zip(rep["stages"],
                                             zip(plan.boundaries,
                                                 plan.costs)):
                entry["layers"] = list(bounds)
                entry["param_bytes"] = int(cost)
        rep["stage_data_multiple"] = stage_data
        rep["tensor_parallel"] = int(self.tensor_parallel or 0)
        return rep

    def _transform_pipelined(self, df: DataFrame) -> DataFrame:
        """The pipelined dispatch: the frame in ``batch_size`` chunks,
        each padded on the bucket ladder, uploaded once and cut into
        micro-batches that the runner drives through the stages; the
        outputs are concatenated on the device and read back once. The
        first chunk also runs the runner's probe pass (its stage
        service times). The frame cache serves the fused path only, as
        in JAX."""
        from mmlspark_tpu_torch.core.tracing import ambient_tracer
        from mmlspark_tpu_torch.parallel.pipeline import split_rows

        if self._compute_quant is not None:
            raise NotImplementedError(
                "compute quantization with pipeline_parallel is not "
                "wired: the stage split remaps params per slice and "
                "would need per-stage scale trees — serve int8 compute "
                "on the fused or tensor-parallel paths")
        runner, stage_data = self._setup_pipeline
        dev = resolve_device(self.device)
        wire = self._transfer_dtype()
        x = _host_cast(_stack_column(df[self.input_col]), wire)
        n_rows = len(x)
        meta = schema.make_role_meta(schema.SCORES_KIND, self.uid)
        if n_rows == 0:
            width: Any = (0,)
            if x.ndim > 1:
                # the output width is fixed by the model: learn it once
                # from stage_data dummy rows, then empty frames cost
                # nothing
                width = self.__dict__.get("_pipeline_out_shape")
                if width is None:
                    dummy = _device_put(np.zeros((stage_data, *x.shape[1:]),
                                                 x.dtype), dev, wire)
                    width = tuple(runner.run([dummy])[0].shape[1:])
                    self.__dict__["_pipeline_out_shape"] = width
            return df.with_column(self.output_col,
                                  np.zeros((0, *width), np.float32),
                                  metadata=meta)
        bs = round_to_multiple(max(self.batch_size, stage_data), stage_data,
                               up=False)
        tracer = ambient_tracer()
        outs = []
        for start in range(0, n_rows, bs):
            padded, n = pad_to_bucket(x[start:start + bs], cap=bs,
                                      pad_mode="edge", multiple=stage_data)
            xd = _device_put(padded, dev, wire)
            ranges = split_rows(len(padded), self.pipeline_microbatches,
                                stage_data)
            ys = runner.run([xd[a:b] for a, b in ranges], tracer=tracer)
            if not runner._probed:
                # one synchronized pass for the stage service times,
                # never again on the live path
                a, b = ranges[0]
                runner.probe(xd[a:b])
            outs.append(unpad(torch.cat(ys) if len(ys) > 1 else ys[0], n))
        result = torch.cat(outs) if len(outs) > 1 else outs[0]
        return df.with_column(self.output_col,
                              _as_numpy(result.cpu()).astype(np.float32,
                                                             copy=False),
                              metadata=meta)

    def transform(self, df: DataFrame) -> DataFrame:
        self._check_world()
        if self._pipeline_active():
            return self._transform_pipelined(df)
        col = df[self.input_col]
        wire = self._transfer_dtype()
        dev, module = self._device_setup()
        bs = max(int(self.batch_size), 1)
        cache_key = None
        cached_batches = None
        store_this_pass = False
        if self.cache_inputs and isinstance(col, np.ndarray) \
                and 0 < _frame_est_bytes(col, wire) \
                <= _FRAME_CACHE_MAX_BYTES:
            cheap = _frame_cheap_key(col, wire, bs, dev)
            with _FRAME_LOCK:
                seen = cheap in _FRAME_SEEN
                if not seen:
                    _FRAME_SEEN[cheap] = None
                    while len(_FRAME_SEEN) > _FRAME_SEEN_MAX_ENTRIES:
                        _FRAME_SEEN.popitem(last=False)
            if seen:
                # a lookup/store candidate: NOW pay the content digest
                # (outside the lock)
                cache_key = cheap + (_content_digest(col),)
                with _FRAME_LOCK:
                    cached_batches = _FRAME_CACHE.get(cache_key)
                    if cached_batches is not None:
                        _FRAME_CACHE.move_to_end(cache_key)
                    else:
                        store_this_pass = True
        if cached_batches is not None:
            x = None                         # hit: never stack the frame
            n_rows = cached_batches[1]
            b0 = cached_batches[0][0][0]
            batch_bytes = max(b0.numel() * b0.element_size(), 1)
        else:
            x = _host_cast(_stack_column(col), wire)
            n_rows = len(x)
            batch_bytes = max(bs * int(np.prod(x.shape[1:], dtype=np.int64))
                              * x.dtype.itemsize, 1)

        # one read-back per group: outputs are unpadded and concatenated
        # on the device, copied back as soon as the group is sealed, and
        # one sealed group stays in flight while the host waits for the
        # one before; the group is bounded by input bytes, then by the
        # first output's bytes
        group = max(min(int(self.fetch_batches),
                        _GROUP_BYTES // batch_bytes), 1)
        inflight = []                 # dispatched batches of this group
        ready: deque = deque()        # (host copy, event) awaiting the host
        outs = []
        out_sized = False

        def seal():
            if not inflight:
                return
            if len(inflight) == 1:
                grp = unpad(*inflight[0])
            else:
                grp = torch.cat([unpad(o, n) for o, n in inflight])
            inflight.clear()
            host = _to_host(grp)
            event = None
            if grp.device.type == "cuda":
                event = torch.cuda.Event()
                event.record()
            ready.append((host, event))

        def fetch():
            host, event = ready.popleft()
            if event is not None:
                event.synchronize()
            outs.append(_as_numpy(host))

        def batch_iter():
            if cached_batches is not None:
                yield from cached_batches[0]    # zero uploads
                return
            store = [] if store_this_pass else None
            for start in range(0, n_rows, bs):
                padded, n = padded_device_batch(
                    x[start:start + bs], bs, placement=dev,
                    put=lambda a, d: _device_put(a, d, wire))
                if store is not None:
                    store.append((padded, n))
                yield padded, n
            if store is not None:
                with _FRAME_LOCK:
                    _FRAME_CACHE[cache_key] = (store, n_rows)
                    while len(_FRAME_CACHE) > _FRAME_CACHE_MAX_ENTRIES:
                        # LRU: frees the evicted frame's device copies
                        _FRAME_CACHE.popitem(last=False)

        for padded, n in batch_iter():
            inflight.append((self._run(module, padded), n))
            if not out_sized:
                # a truncated conv layer's output may be far wider than
                # its input: bound the group by output bytes too
                o = inflight[0][0]
                out_bytes = max(o.numel() * o.element_size(), 1)
                group = max(min(group, _GROUP_BYTES // out_bytes), 1)
                out_sized = True
            if len(inflight) >= group:
                seal()
                while len(ready) > 1:   # keep one group in flight
                    fetch()
        seal()
        while ready:
            fetch()
        if outs:
            result = np.concatenate(outs) if len(outs) > 1 else outs[0]
        elif x.ndim > 1:
            # empty input: score one dummy row to learn the output width
            # (x is never None here: empty frames are below the cache's
            # size floor)
            dummy, _ = padded_device_batch(
                np.zeros((1, *x.shape[1:]), x.dtype), 1, placement=dev,
                put=lambda a, d: _device_put(a, d, wire))
            width = self._run(module, dummy).shape[1:]
            result = np.zeros((0, *width), dtype=np.float32)
        else:
            result = np.zeros((0, 0), dtype=np.float32)
        meta = schema.make_role_meta(schema.SCORES_KIND, self.uid)
        return df.with_column(self.output_col, result, metadata=meta)

    # -- persistence --------------------------------------------------------

    def _save_extra(self, path: str, arrays: Dict[str, np.ndarray]) -> None:
        import json
        import os
        self.model.save(os.path.join(path, "nnfunction"))
        if self.quantization is not None:
            # the quant config is a complex param and must survive
            # save/load (a staged checkpoint carries its wire contract)
            with open(os.path.join(path, "quantization.json"), "w") as f:
                json.dump(self.quantization.to_dict(), f)

    def _load_extra(self, path: str, arrays: Dict[str, np.ndarray]) -> None:
        import json
        import os
        self.model = NNFunction.load(os.path.join(path, "nnfunction"))
        qpath = os.path.join(path, "quantization.json")
        if os.path.exists(qpath):
            from mmlspark_tpu_torch.serving.quant import QuantizationConfig
            with open(qpath) as f:
                self.quantization = QuantizationConfig.from_value(
                    json.load(f))

    @staticmethod
    def load_from_function(path: str, **params) -> "NNModel":
        return NNModel(model=NNFunction.load(path), **params)


def _flat_keys(tree, prefix: str = ""):
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            yield from _flat_keys(v, key)
        else:
            yield key

