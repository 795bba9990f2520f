"""NNLearner: deep-net training on a labelled frame, on one card.

The port of ``mmlspark_tpu/models/trainer.py``. An Estimator that takes
a labelled frame, trains an :class:`~mmlspark_tpu_torch.models.function.
NNFunction` with a configurable loss, optimizer and schedule, and
returns an :class:`~mmlspark_tpu_torch.models.nn.NNModel` that scores
where it trained (the card unless ``device="cpu"``).

The losses, optimizers and schedules are optax's, written here on
tensors: the schedule is read at the step count *before* the update
(so a cosine fit without warmup takes its first step at rate 0), the
optimizer state lives in tensors updated in place under ``no_grad``,
and ``clip_by_global_norm`` leaves a gradient whose norm is below the
limit as it is. ``torch.optim`` parts from optax in its defaults
(AdamW's decay, ``clip_grad_norm_``'s ``+1e-6``, schedulers stepped
after the update) and is not used.

A train step runs autograd through the network's ``LayeredModel`` and
updates the parameters in place, so each keeps its storage from step
to step (the port's form of JAX's donated train state). Two loops, as
in JAX: the host loop uploads each batch and keeps two steps in flight
(it waits on step t-2's loss); the device-resident loop uploads the
data once (uint8 stays uint8 until the card divides it by 255) and one
permutation an epoch, runs the epoch's steps on device tensors, and
reads the losses once an epoch. Each fit keeps its per-step losses in
``NNLearner.losses`` (one array an epoch).

Distribution (``mesh_shape``), in three forms:

* a data axis alone, hosted: the batch is shaped as JAX's shards would
  shape it (the batch-size rule, pad rows weighted 0) and the global
  batch runs on the card;
* a hosted ``model`` axis, e.g. ``{"data": 2, "model": 2}``: the
  parameters and the optimizer's moments are laid out by
  :func:`~mmlspark_tpu_torch.parallel.dist.state_shardings` over
  ``model`` (a leaf the rule splits is held as its model ranks' slices,
  :class:`~mmlspark_tpu_torch.models.function.PlacedModule`), gathered
  in each forward; the fit equals the data-only fit;
* the data axis one rank per process over ``torch.distributed``: each
  process feeds its rows of the global batch
  (:func:`~mmlspark_tpu_torch.parallel.dist.process_local_rows`), sums
  its rows' weighted losses and their gradients, and all-reduces the
  sums and the weight, so the loss stays the mean over the global
  batch's real rows (pad rows weigh 0, a ragged batch's processes hold
  unequal real rows) and every process takes the same update.

Over processes, the data axis may hold several ranks a process (a mixed
mesh such as ``{"data": 8}`` over two processes: each process feeds the
rows of its ranks), and a ``model`` axis composes with it where the
data axis divides over the processes (``{"data": 2, "model": 2}`` over
two: each process hosts its data rank's model ranks); a data axis that
does not divide over the processes raises ``ValueError``, as JAX's
``put_batch`` does, and so does the model axis one rank per process.
An expert or pipe axis raises ``NotImplementedError`` (JAX's
``NNLearner`` has neither). Inside
:func:`~mmlspark_tpu_torch.parallel.topology.single_device_scope` a fit
places no mesh (one data shard).

Step checkpoints (``checkpoint_dir``) go through the native sharded
store (:mod:`mmlspark_tpu_torch.io.checkpoint`) as the JAX trainer's
do: ``{"params": <flax tree>, "opt_state": <optax state>}`` in optax's
own structure (:meth:`Optimizer.state_tree`), so a checkpoint either
package writes resumes in the other. A failed step restores the latest
checkpoint and re-enters the same shuffle stream, at most
``max_restarts`` times. :meth:`NNLearner.fit_stream` trains from a
micro-batch stream (:mod:`mmlspark_tpu_torch.streaming`), warm-starting
from the latest train-state checkpoint and exporting servable models
for a :class:`~mmlspark_tpu_torch.streaming.loop.RetrainLoop`.
"""

from __future__ import annotations

import math
import os
import time
import warnings
from collections import deque
from typing import (
    Any, Callable, Dict, List, NamedTuple, Optional, Sequence, Union,
)

import numpy as np
import torch
import torch.nn.functional as F

from mmlspark_tpu_torch.core.dataframe import DataFrame
from mmlspark_tpu_torch.core.environment import resolve_device
from mmlspark_tpu_torch.core.params import (
    HasDevice, HasFeaturesCol, HasLabelCol, Param, in_range, in_set,
)
from mmlspark_tpu_torch.core.stage import Estimator
from mmlspark_tpu_torch.io import checkpoint as _ckpt
from mmlspark_tpu_torch.models.function import (
    FlaxLeaves, NNFunction, PlacedModule, _flat_leaves, _torch_leaf,
    ieee_f32, unflatten_params,
)
from mmlspark_tpu_torch.models.nn import NNModel, _device_put, _stack_column
from mmlspark_tpu_torch.parallel import dist as _dist
from mmlspark_tpu_torch.parallel.sharding import pad_to_multiple
from mmlspark_tpu_torch.parallel.topology import (
    AXIS_DATA, AXIS_EXPERT, AXIS_MODEL, AXIS_PIPE, Mesh, MeshSpec,
    build_mesh, in_single_device_scope,
)

LOSSES = ("softmax_cross_entropy", "sigmoid_cross_entropy", "squared_error")
OPTIMIZERS = ("sgd", "momentum", "adam", "adamw")

_TRAINER_METRICS = None


def _metrics():
    """Process-registry training telemetry, bound lazily so importing
    the trainer costs nothing."""
    global _TRAINER_METRICS
    if _TRAINER_METRICS is None:
        from mmlspark_tpu_torch.core.telemetry import REGISTRY, log_buckets
        _TRAINER_METRICS = {
            "step_ms": REGISTRY.histogram(
                "trainer_step_ms",
                "Host-loop wall-clock per train step (dispatch is "
                "async: mostly host+transfer time, with periodic "
                "device blocks when the in-flight window fills)."),
            "examples_per_sec": REGISTRY.histogram(
                "trainer_examples_per_sec",
                "Real (unpadded) examples per second per host-loop "
                "step.", buckets=log_buckets(1.0, 1e7)),
            # wider ladder than the request-latency default: a
            # multi-GB save/restore routinely takes 30-120 s, and a
            # 10 s top edge would collapse every sample into +Inf
            "ckpt_save_ms": REGISTRY.histogram(
                "trainer_checkpoint_save_ms",
                "Checkpoint save call wall-clock (per-shard writes + "
                "digest manifest).",
                buckets=log_buckets(10.0, 1e6)),
            "ckpt_restore_ms": REGISTRY.histogram(
                "trainer_checkpoint_restore_ms",
                "Checkpoint restore wall-clock.",
                buckets=log_buckets(10.0, 1e6)),
            "restarts": REGISTRY.counter(
                "trainer_restarts_total",
                "Bounded in-process fit restarts (restore + "
                "fast-forward) taken after step failures."),
        }
    return _TRAINER_METRICS


# -- losses -------------------------------------------------------------------

def make_loss(name: str, reduction: str = "mean") -> Callable:
    """``loss(logits, labels, weights)``: optax's loss per row, then a
    weighted mean over ``max(sum(w), 1e-8)`` (``reduction="sum"``: the
    weighted sum alone, which a process of a data mesh all-reduces
    before it divides)."""

    def weighted(per_row, weights):
        w = weights.to(per_row.dtype)
        if reduction == "sum":
            return (per_row * w).sum()
        return (per_row * w).sum() / torch.clamp_min(w.sum(), 1e-8)

    if name == "softmax_cross_entropy":
        def loss(logits, labels, weights):
            # softmax_cross_entropy_with_integer_labels
            lp = torch.log_softmax(logits, dim=-1)
            per_row = -lp.gather(-1, labels.to(torch.int64)[..., None])
            return weighted(per_row[..., 0], weights)
    elif name == "sigmoid_cross_entropy":
        def loss(logits, labels, weights):
            # sigmoid_binary_cross_entropy, in its log-sigmoid form
            z = logits[..., 0]
            t = labels.to(z.dtype)
            per_row = -t * F.logsigmoid(z) - (1.0 - t) * F.logsigmoid(-z)
            return weighted(per_row, weights)
    elif name == "squared_error":
        def loss(logits, labels, weights):
            z = logits[..., 0]
            return weighted(torch.square(z - labels.to(z.dtype)), weights)
    else:
        raise ValueError(f"unknown loss {name!r}; have {LOSSES}")
    return loss


# -- schedules ----------------------------------------------------------------

Schedule = Callable[[int], float]
_F32 = np.float32


def constant_schedule(value: float) -> Schedule:
    return lambda count: float(_F32(value))


def linear_schedule(init_value: float, end_value: float,
                    transition_steps: int) -> Schedule:
    """optax's ``linear_schedule`` (in f32)."""
    if transition_steps <= 0:
        return constant_schedule(init_value)

    def schedule(count: int) -> float:
        c = _F32(min(max(count, 0), transition_steps))
        frac = _F32(1) - c / _F32(transition_steps)
        return float(_F32(init_value - end_value) * frac + _F32(end_value))
    return schedule


def cosine_decay_schedule(init_value: float, decay_steps: int
                          ) -> Schedule:
    """optax's ``cosine_decay_schedule`` with ``alpha`` 0 (in f32)."""
    def schedule(count: int) -> float:
        c = _F32(min(count, decay_steps))
        cos = _F32(0.5) * (_F32(1) + np.cos(_F32(math.pi) * c
                                            / _F32(decay_steps)))
        return float(_F32(init_value) * cos)
    return schedule


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int
                                 ) -> Schedule:
    """optax's ``warmup_cosine_decay_schedule`` with end value 0: a
    linear warmup, then a cosine over ``decay_steps - warmup_steps``
    (the decay steps include the warmup)."""
    warm = linear_schedule(init_value, peak_value, warmup_steps)
    cos = cosine_decay_schedule(peak_value, decay_steps - warmup_steps)
    return lambda count: (warm(count) if count < warmup_steps
                          else cos(count - warmup_steps))


# -- optimizers ---------------------------------------------------------------

# optax's state types, by name and field: a checkpoint's optimizer state
# is laid out in optax's own structure, so its leaves are named as the
# JAX trainer names them (NamedTuples flatten by field)

class EmptyState(NamedTuple):
    """optax's ``EmptyState`` (identity, ``clip_by_global_norm``, a
    constant rate, ``add_decayed_weights``)."""


class TraceState(NamedTuple):
    trace: Any


class ScaleByAdamState(NamedTuple):
    count: Any
    mu: Any
    nu: Any


class ScaleByScheduleState(NamedTuple):
    count: Any


class Optimizer:
    """An optax chain on tensors: optional ``clip_by_global_norm``, the
    rule (``sgd``; ``momentum``, optax's ``trace`` without Nesterov;
    ``adam``; ``adamw``), then ``scale_by_learning_rate``. The rate is
    read at the count before the update; :meth:`step` changes the
    parameters and the state in place, under ``no_grad``. A callable
    ``learning_rate`` is a schedule, whose optax state keeps the rate's
    count; a number is a constant rate, whose state keeps none
    (:meth:`state_tree`)."""

    #: optax.adam's defaults, which the JAX trainer takes
    B1, B2, EPS = 0.9, 0.999, 1e-8

    def __init__(self, name: str, learning_rate: Union[float, Schedule],
                 momentum: float = 0.9, weight_decay: float = 1e-4,
                 clip_norm: float = 0.0):
        if name not in OPTIMIZERS:
            raise ValueError(f"unknown optimizer {name!r}; have "
                             f"{OPTIMIZERS}")
        self.name = name
        self.scheduled = callable(learning_rate)
        self.schedule = (learning_rate if self.scheduled
                         else constant_schedule(learning_rate))
        self.momentum = float(momentum)
        self.weight_decay = float(weight_decay)
        self.clip_norm = float(clip_norm or 0.0)

    def init(self, params: Sequence[torch.Tensor]) -> Dict[str, Any]:
        """The state: ``count`` (the rate's count, on the host) and the
        moments, zeros shaped as the parameters."""
        state: Dict[str, Any] = {"count": 0}
        if self.name == "momentum":
            state["trace"] = [torch.zeros_like(p) for p in params]
        elif self.name in ("adam", "adamw"):
            state["mu"] = [torch.zeros_like(p) for p in params]
            state["nu"] = [torch.zeros_like(p) for p in params]
        return state

    @torch.no_grad()
    def step(self, params: Sequence[torch.Tensor],
             grads: Sequence[torch.Tensor], state: Dict[str, Any]) -> None:
        count = state["count"]
        updates = list(grads)
        if self.clip_norm > 0:
            norm = torch.sqrt(sum(torch.sum(g * g) for g in updates))
            keep = norm < self.clip_norm
            updates = [torch.where(keep, g, g / norm * self.clip_norm)
                       for g in updates]
        if self.name == "momentum":
            for t, g in zip(state["trace"], updates):
                t.mul_(self.momentum).add_(g)       # g + decay * t
            updates = state["trace"]
        elif self.name in ("adam", "adamw"):
            n = count + 1
            c1 = float(_F32(1) - _F32(self.B1) ** _F32(n))
            c2 = float(_F32(1) - _F32(self.B2) ** _F32(n))
            out = []
            for p, m, v, g in zip(params, state["mu"], state["nu"],
                                  updates):
                m.mul_(self.B1).add_(g * (1 - self.B1))
                v.mul_(self.B2).add_(g * g * (1 - self.B2))
                u = (m / c1) / (torch.sqrt(v / c2) + self.EPS)
                if self.name == "adamw":
                    u = u + self.weight_decay * p
                out.append(u)
            updates = out
        lr = -self.schedule(count)
        for p, u in zip(params, updates):
            p.add_(u * lr)
        state["count"] = count + 1


    def state_tree(self, count: int, moment: Callable[[str], Any]):
        """The optax state of this chain: ``moment(name)`` gives the
        ``trace``/``mu``/``nu`` tree (shaped as the flax params), the
        counts are int32 scalars. ``sgd`` is ``(EmptyState, rate)``,
        ``momentum`` ``(TraceState, rate)``, ``adam``
        ``(ScaleByAdamState, rate)``, ``adamw`` ``(ScaleByAdamState,
        EmptyState, rate)``, the rate a ``ScaleByScheduleState`` under a
        schedule and an ``EmptyState`` otherwise; clipping wraps the
        chain as ``(EmptyState, chain)``."""
        c = np.asarray(count, dtype=np.int32)
        if self.name == "sgd":
            rule: tuple = (EmptyState(),)
        elif self.name == "momentum":
            rule = (TraceState(moment("trace")),)
        else:
            rule = (ScaleByAdamState(c, moment("mu"), moment("nu")),)
            if self.name == "adamw":
                rule += (EmptyState(),)
        chain = rule + (ScaleByScheduleState(c) if self.scheduled
                        else EmptyState(),)
        return (EmptyState(), chain) if self.clip_norm > 0 else chain

    def read_state_tree(self, tree) -> "tuple[Optional[int], Dict[str, Any]]":
        """``(count, {moment name: tree})`` of a :meth:`state_tree`
        (``count`` None where optax keeps none: a constant rate's
        ``sgd`` or ``momentum``)."""
        chain = tree[1] if self.clip_norm > 0 else tree
        rule, rate = chain[0], chain[-1]
        count, moments = None, {}
        if isinstance(rule, TraceState):
            moments["trace"] = rule.trace
        elif isinstance(rule, ScaleByAdamState):
            moments.update(mu=rule.mu, nu=rule.nu)
            count = int(rule.count)
        if count is None and isinstance(rate, ScaleByScheduleState):
            count = int(rate.count)
        return count, moments


def make_optimizer(name: str, learning_rate: Union[float, Schedule],
                   momentum: float = 0.9, weight_decay: float = 1e-4,
                   clip_norm: float = 0.0) -> Optimizer:
    return Optimizer(name, learning_rate, momentum=momentum,
                     weight_decay=weight_decay, clip_norm=clip_norm)


def _global_mean(total: torch.Tensor, grads: List[torch.Tensor],
                 weight: torch.Tensor, group) -> "tuple":
    """A process's weighted loss sum ``total``, its gradients and its
    rows' weight, all-reduced in one buffer over ``group`` (the data
    axis), then divided by the global weight (``max(W, 1e-8)``, optax's
    floor): the loss and gradients of the global batch's weighted mean,
    the same on every process."""
    flat = torch.cat([g.reshape(-1) for g in grads]
                     + [total.reshape(1), weight.to(total.dtype).reshape(1)])
    torch.distributed.all_reduce(flat, group=group)
    denom = torch.clamp_min(flat[-1], 1e-8)
    parts = flat[:-2].split([g.numel() for g in grads])
    return flat[-2] / denom, [p.view(g.shape) / denom
                              for p, g in zip(parts, grads)]


# -- the train state in the flax layout ---------------------------------------

def _flax_slots(net) -> list:
    """``(flat flax key, layer, flax leaf name, holder)`` of every weight
    of ``net`` (a ``LayeredModel`` or a :class:`PlacedModule`), the
    holder its tensor or :class:`~mmlspark_tpu_torch.parallel.dist.
    Shards` in the torch layout."""
    if isinstance(net, PlacedModule):
        return [("/".join(["params", *name.split(".")[1:-1], leaf]),
                 layer, leaf, net.state[name])
                for name, (layer, leaf) in net._keys.items()]
    out = []
    for name, mod in net.layers.named_modules():
        if isinstance(mod, FlaxLeaves):
            for leaf, attr in mod.LEAVES.items():
                t = getattr(mod, attr)
                if t is not None:
                    out.append(("/".join(["params", *name.split("."),
                                          leaf]), mod, leaf, t))
    return out


def _map_holder(h, fn):
    """``fn`` over a tensor, or over each slice of a ``Shards``."""
    if isinstance(h, _dist.Shards):
        return _dist.Shards([fn(p) for p in h.parts], h.dim, h.spec,
                            h.axis)
    return fn(h)


def _to_flax_layout(layer: FlaxLeaves, leaf: str, h):
    """A torch-layout weight (tensor or ``Shards``) as a view in the flax
    layout; a ``Shards``' dim follows its dim's place there (the inverse
    of :func:`~mmlspark_tpu_torch.models.function._torch_leaf`)."""
    if not isinstance(h, _dist.Shards):
        return layer._to_flax(leaf, h)
    shape = [1] * len(h.shape)
    shape[h.dim] = 2
    moved = layer._to_flax(leaf, torch.empty(shape, device="meta")).shape
    return _dist.Shards([layer._to_flax(leaf, p) for p in h.parts],
                        list(moved).index(2), h.spec, h.axis)


def _as_tensor(value):
    """A flax-tree leaf as a tensor (a host array copied in)."""
    if isinstance(value, (torch.Tensor, _dist.Shards)):
        return value
    return torch.from_numpy(np.ascontiguousarray(value))


def _copy_into(holder, value) -> None:
    """Copy ``value`` (a tensor or ``Shards``, torch layout) into the
    live ``holder`` in place, slice by slice where it is split."""
    if isinstance(holder, _dist.Shards):
        parts = (value.parts if isinstance(value, _dist.Shards)
                 else value.split([p.shape[holder.dim]
                                   for p in holder.parts], holder.dim))
        for p, v in zip(holder.parts, parts):
            p.copy_(v)
    else:
        holder.copy_(_dist.gathered(value))


def _meta_like(leaf):
    """A leaf's shape and dtype without its data (a restore template)."""
    if isinstance(leaf, torch.Tensor):
        return torch.empty(leaf.shape, dtype=leaf.dtype, device="meta")
    if isinstance(leaf, _dist.Shards):
        return _map_holder(leaf, _meta_like)
    return leaf


# -- the learner --------------------------------------------------------------

class NNLearner(Estimator, HasLabelCol, HasFeaturesCol, HasDevice):
    """Train an NNFunction on a labeled frame; returns an NNModel."""

    features_col = Param("features", "input column (vectors or images)",
                         ptype=str)
    label_col = Param("label", "label column", ptype=str)
    weight_col = Param(None, "optional per-row weight column", ptype=str)
    arch = Param(None, "architecture config dict (builder + kwargs)",
                 ptype=dict)
    model = Param(None, "optional warm-start NNFunction", complex=True)
    loss = Param("softmax_cross_entropy", "training loss",
                 validator=in_set(*LOSSES))
    optimizer = Param("momentum", "optimizer", validator=in_set(*OPTIMIZERS))
    learning_rate = Param(0.1, "peak learning rate", ptype=float)
    momentum = Param(0.9, "sgd momentum", ptype=float)
    weight_decay = Param(1e-4, "adamw weight decay", ptype=float)
    clip_norm = Param(0.0, "global-norm gradient clipping (0 = off); "
                      "guards deep-net fits against divergence at "
                      "aggressive peak learning rates", ptype=float)
    epochs = Param(10, "passes over the data", ptype=int)
    batch_size = Param(256, "global batch size", ptype=int)
    warmup_steps = Param(0, "linear LR warmup steps", ptype=int)
    cosine_decay = Param(True, "cosine-decay LR to 0 over training",
                         ptype=bool)
    seed = Param(0, "init/shuffle seed", ptype=int)
    mesh_shape = Param(None, "mesh axes dict, e.g. {'data': -1}: the data "
                       "axis shapes the batch as JAX's shards would (one "
                       "rank per process under torch.distributed); a "
                       "hosted 'model' axis lays the parameter and "
                       "optimizer state out over it", ptype=dict)
    checkpoint_dir = Param(None, "sharded step-checkpoint directory "
                           "(io/checkpoint native store)", ptype=str)
    checkpoint_every = Param(0, "steps between checkpoints (0 = off)",
                             ptype=int)
    push_gateway_url = Param(None, "optional metrics remote-write URL: a "
                             "MetricsPusher POSTs the process registry "
                             "there on an interval during fit, with a "
                             "final flush when the fit ends", ptype=str)
    push_interval_s = Param(30.0, "seconds between remote-write pushes",
                            ptype=float, validator=in_range(lo=1.0))
    max_restarts = Param(2, "bounded in-process auto-restarts: when a "
                         "train step fails and checkpointing is "
                         "configured, restore the latest step "
                         "checkpoint and resume the SAME shuffle stream; "
                         "after this many restores the error propagates "
                         "(without checkpointing, at once)", ptype=int)
    fault_injector = Param(None, "chaos-test hook: callable(global_step)"
                           " invoked before each host-loop step; "
                           "exceptions it raises exercise the bounded-"
                           "restart path (see testing.faults.FaultPlan."
                           "step_fault)", complex=True)
    log_every = Param(50, "steps between loss logs (0 = off)", ptype=int)
    device_resident = Param(False, "upload the dataset to the device ONCE "
                            "and run each epoch on device tensors (batches "
                            "gathered on device from an uploaded "
                            "permutation, losses read once an epoch); "
                            "uint8 image data stays uint8 on the wire. "
                            "Single-data-shard fits only; the host loop "
                            "otherwise", ptype=bool)
    augment = Param("none", "on-device per-batch augmentation: flip_crop "
                    "= random horizontal flip + random 4px translate "
                    "(the standard CIFAR recipe), in the device-resident "
                    "fit", validator=in_set("none", "flip_crop"))

    # -- the step -------------------------------------------------------------

    def build_train_step(self, module, tx: Optimizer, loss_fn: Callable,
                         mesh: Optional[Mesh] = None) -> Callable:
        """``step(x, y, w) -> loss``: autograd through ``module`` (a
        ``LayeredModel`` holding the weights, or a :class:`PlacedModule`
        whose tensors are its model ranks' slices), then ``tx`` updates
        the parameters in place; the loss comes back as a device scalar,
        unread. With ``mesh`` of one rank per process, ``loss_fn`` gives
        the weighted sum of this process's rows (``reduction="sum"``),
        and the sum, its gradients and the weight are all-reduced over
        the data axis before the division: the global batch's mean."""
        params = module.tensors()
        for p in params:
            p.requires_grad_(True)
        state = tx.init(params)
        group = None
        if mesh is not None and not mesh.hosted:
            group = mesh.axis(AXIS_DATA).group

        def step(x, y, w):
            with ieee_f32():
                loss = loss_fn(module(x), y, w)
                grads = torch.autograd.grad(loss, params, allow_unused=True)
                # a weight the forward does not reach gets JAX's zero grad
                grads = [torch.zeros_like(p) if g is None else g
                         for p, g in zip(params, grads)]
                if mesh is not None and not mesh.hosted:
                    loss, grads = _global_mean(loss.detach(), grads,
                                               w.sum(), group)
                tx.step(params, grads, state)
            return loss.detach()

        step.params = params
        step.state = state
        return step

    @staticmethod
    def _augment_flip_crop(gen: torch.Generator, xb: torch.Tensor
                           ) -> torch.Tensor:
        """Random horizontal flip (p 0.5 a row) + random 4px translate
        (reflect pad, one offset in [0, 8] per row and axis), drawn on
        ``xb``'s device from ``gen``."""
        b, hgt, wid = xb.shape[0], xb.shape[1], xb.shape[2]
        dev = xb.device
        flip = torch.rand(b, generator=gen, device=dev) < 0.5
        xb = torch.where(flip[:, None, None, None], xb.flip(2), xb)
        pad = 4
        padded = F.pad(xb.permute(0, 3, 1, 2), (pad, pad, pad, pad),
                       mode="reflect").permute(0, 2, 3, 1)
        offs = torch.randint(0, 2 * pad + 1, (b, 2), generator=gen,
                             device=dev)
        rows = offs[:, 0, None] + torch.arange(hgt, device=dev)
        cols = offs[:, 1, None] + torch.arange(wid, device=dev)
        return padded[torch.arange(b, device=dev)[:, None, None],
                      rows[:, :, None], cols[:, None, :]]

    def _schedule(self, steps_per_epoch: int) -> Union[float, Schedule]:
        warmup = max(self.warmup_steps, 1)
        total = max(self.epochs * steps_per_epoch, warmup + 1)
        if self.cosine_decay:
            return warmup_cosine_decay_schedule(
                0.0, self.learning_rate, warmup, total)
        if self.warmup_steps:
            return linear_schedule(0.0, self.learning_rate,
                                   self.warmup_steps)
        return self.learning_rate        # a constant rate, as optax's

    def _mesh(self, dev: torch.device
              ) -> "tuple[Optional[Mesh], int, int]":
        """``(mesh, data shards, model width)`` of ``mesh_shape``: a
        hosted ``model`` axis places a mesh; so does a world of several
        processes (the data axis spread over them, each process hosting
        its ranks, and a model axis hosted within each); a hosted data
        axis alone only shapes the batch (no mesh). Refuses an expert or
        pipe axis, a data axis that does not divide over the processes
        and any other axis."""
        if in_single_device_scope():
            return None, 1, 1
        shape = dict(self.mesh_shape or {AXIS_DATA: -1})
        for axis, size in shape.items():
            if axis in (AXIS_EXPERT, AXIS_PIPE) and size != 1:
                raise NotImplementedError(
                    f"mesh axis {axis!r} of size {size}: NNLearner has no "
                    f"expert or pipeline parallelism (JAX's has neither)")
            if axis not in (AXIS_DATA, AXIS_MODEL, AXIS_EXPERT, AXIS_PIPE) \
                    and size != 1:
                raise ValueError(f"mesh axis {axis!r} of size {size}: "
                                 f"NNLearner shards over the data axis "
                                 f"only")
        tp = int(shape.get(AXIS_MODEL, 1))
        d = torch.distributed
        if d.is_available() and d.is_initialized() \
                and d.get_world_size() > 1:
            world = d.get_world_size()
            n_data = int(shape.get(AXIS_DATA, -1))
            if tp > 1:
                n_data = world if n_data == -1 else n_data
                if n_data % world:
                    # JAX's put_batch refusal, word for word
                    raise ValueError(f"data axis ({n_data}) not divisible "
                                     f"by process count ({world})")
                mesh = build_mesh(MeshSpec.from_dict(
                    {AXIS_DATA: n_data, AXIS_MODEL: tp}), dev)
                return mesh, n_data, tp
            mesh = build_mesh(MeshSpec.from_dict({AXIS_DATA: n_data}), dev)
            return mesh, mesh.shape[AXIS_DATA], 1
        n_data = int(shape.get(AXIS_DATA, 1))
        n_data = 1 if n_data == -1 else n_data
        if tp > 1:
            return _dist.train_mesh({AXIS_DATA: n_data, AXIS_MODEL: tp},
                                    dev), n_data, tp
        return None, n_data, 1

    # -- fit ------------------------------------------------------------------

    def fit(self, df: DataFrame) -> NNModel:
        if not self.push_gateway_url:
            return self._fit(df)
        # remote-write rides the whole fit: periodic pushes while the
        # loop runs, one final flush on the way out (success or failure)
        from mmlspark_tpu_torch.core.telemetry import MetricsPusher
        with MetricsPusher(self.push_gateway_url,
                           interval_s=self.push_interval_s):
            return self._fit(df)

    def _fit(self, df: DataFrame) -> NNModel:
        dev = resolve_device(self.device)
        mesh, n_data, tp = self._mesh(dev)
        # uint8 is image bytes on BOTH loops (each normalizes /255 and
        # tags the scorer: a perf flag must never change the learned
        # function); every other dtype trains as f32
        x = _stack_column(df[self.features_col])
        if x.dtype != np.uint8:
            x = x.astype(np.float32, copy=False)
        y = np.asarray(df[self.label_col])
        w = (np.asarray(df[self.weight_col], dtype=np.float32)
             if self.weight_col else np.ones(len(y), dtype=np.float32))

        fn = self.model or NNFunction.init(self.arch, x.shape[1:],
                                           seed=self.seed)
        bs = max(self.batch_size - self.batch_size % n_data, n_data)
        steps_per_epoch = max(len(x) // bs, 1)
        tx = make_optimizer(self.optimizer, self._schedule(steps_per_epoch),
                            self.momentum, self.weight_decay,
                            self.clip_norm)
        loss_fn = make_loss(self.loss)
        self.losses: List[np.ndarray] = []
        was_int = x.dtype == np.uint8
        per_process = mesh is not None and not mesh.hosted
        mngr = self._checkpoint_manager()
        if self.device_resident and n_data == 1 and mngr is None:
            module = fn.to_module(dev)
            self._fit_device_resident(x, y, w, module, bs, tx, loss_fn, dev)
            params = module.to_flax()
        else:
            if self.augment != "none":
                warnings.warn(
                    "augment is applied by the device-resident fit "
                    "only; this fit takes the per-step host loop "
                    f"(device_resident={self.device_resident}, data "
                    f"shards={n_data}, checkpointing="
                    f"{self.checkpoint_dir is not None}) and trains "
                    "WITHOUT augmentation", stacklevel=3)
            if was_int:
                x = x.astype(np.float32) / 255.0
            # the state over a model axis: its leaves laid out by the
            # rule, the optimizer's moments shaped (and so laid out) as
            # their slices
            net = (PlacedModule(fn.module(), fn.params, mesh) if tp > 1
                   else fn.to_module(dev))
            if per_process:
                loss_fn = make_loss(self.loss, reduction="sum")
            step = self.build_train_step(net, tx, loss_fn, mesh)
            losses = self._resumable_fit(x, y, w, fn, net, step, tx,
                                         steps_per_epoch, bs, n_data, dev,
                                         mesh, mngr)
            self.losses = [losses[e] for e in sorted(losses)]
            params = net.to_flax()
        trained = NNFunction(arch=dict(fn.arch), params=params)
        # an integer-trained model's scorer keeps the training-time input
        # convention (uint8 in, /255 on device)
        extra = {"input_dtype": "uint8"} if was_int else {}
        return NNModel(model=trained, input_col=self.features_col,
                       output_col="scores", device=self.device, **extra)

    def _resumable_fit(self, x, y, w, fn: NNFunction, net, step, tx,
                       steps_per_epoch: int, bs: int, n_data: int,
                       dev: torch.device, mesh: Optional[Mesh], mngr
                       ) -> Dict[int, np.ndarray]:
        """The host loop under the fault-tolerant fit (the JAX ``_fit``'s
        restart loop): with checkpointing, the latest step is restored
        first; a step failure (an injected chaos fault, a failed
        checkpoint write) restores the latest checkpoint — or the
        initial state, before the first — and re-enters the SAME
        shuffle stream, at most ``max_restarts`` times, so a persistent
        fault still fails the fit. ``NotImplementedError`` is a
        capability gap, never retried; without checkpointing a failed
        step's error propagates. Returns each epoch's step losses (a
        step run again after a restart keeps its last loss)."""
        start_step = 0
        template = None
        if mngr is not None:
            # the structure and the global shapes, captured BEFORE any
            # step: a restore must not depend on live tensors that a
            # failed step may have left half updated
            template = _ckpt.map_leaves(
                _meta_like, self._state_tree(net, step, tx))
            if mngr.latest_step() is not None:
                start_step = self._restore(mngr, template, net, step, tx,
                                           dev)
        by_step: Dict[int, torch.Tensor] = {}
        restarts = 0
        while True:
            try:
                self._host_loop(x, y, w, step, steps_per_epoch, bs, n_data,
                                dev, mesh, start_step, mngr, net, tx,
                                by_step)
                break
            except Exception as e:  # noqa: BLE001 — classified below
                if isinstance(e, NotImplementedError):
                    raise   # a permanent capability gap, not a fault
                if mngr is None or restarts >= self.max_restarts:
                    raise
                restarts += 1
                _metrics()["restarts"].inc()
                latest = mngr.latest_step()
                print(f"[NNLearner] step failed ({type(e).__name__}: {e});"
                      f" restoring "
                      f"{'step ' + str(latest) if latest is not None else 'init'}"
                      f" (restart {restarts}/{self.max_restarts})")
                if latest is None:
                    self._load_state(net, step, tx, fn.params, {}, 0)
                    start_step = 0
                else:
                    start_step = self._restore(mngr, template, net, step,
                                               tx, dev)
        losses: Dict[int, list] = {}
        if by_step:
            order = sorted(by_step)
            values = torch.stack([by_step[g] for g in order]).cpu().numpy()
            for g, v in zip(order, values):
                losses.setdefault((g - 1) // steps_per_epoch, []).append(v)
        return {e: np.asarray(v) for e, v in losses.items()}

    def _host_loop(self, x, y, w, step, steps_per_epoch: int, bs: int,
                   n_data: int, dev: torch.device, mesh: Optional[Mesh],
                   start_step: int, mngr, net, tx: Optimizer,
                   by_step: Dict[int, torch.Tensor]) -> None:
        """One attempt at the per-step host loop, resumable at
        ``start_step``: JAX's numpy shuffle stream is regenerated from
        the seed and the steps already done are skipped, so every attempt
        sees the same batches in the same order. Each batch is padded to
        the data axis (pad rows weighted 0) and uploaded, two steps in
        flight; every ``checkpoint_every`` steps, and at the end, the
        state is checkpointed. One rank per process, each process
        uploads only its rows of the padded global batch
        (:func:`~mmlspark_tpu_torch.parallel.dist.process_local_rows`;
        the shuffle stream is the same on every process). Each step's
        loss lands in ``by_step`` (a device scalar, unread)."""
        from mmlspark_tpu_torch.core.tracing import ambient_tracer
        TRACER = ambient_tracer()
        rng = np.random.default_rng(self.seed)
        metrics = _metrics()
        m_step, m_eps = metrics["step_ms"], metrics["examples_per_sec"]
        global_step = 0
        # a batch shape this fit has not run yet marks its step's span
        # (recompile=True), as a JAX retrace would: the ragged tail
        shapes_seen: set = set()
        inflight: deque = deque()
        for epoch in range(self.epochs):
            order = rng.permutation(len(x))
            for s in range(steps_per_epoch):
                global_step += 1
                if global_step <= start_step:
                    continue  # fast-forward after resume (same shuffle stream)
                with TRACER.span("train_step", route="trainer",
                                 step=global_step, epoch=epoch + 1) as sp:
                    if self.fault_injector is not None:
                        self.fault_injector(global_step)
                    t_step = time.perf_counter()
                    idx = order[s * bs:(s + 1) * bs]
                    # ragged tail: pad to the data-axis multiple, zero
                    # the pad rows' weights
                    xp, n_real = pad_to_multiple(x[idx], n_data)
                    yp, _ = pad_to_multiple(y[idx], n_data)
                    wp, _ = pad_to_multiple(w[idx], n_data)
                    if n_real < len(wp):
                        wp = wp.copy()
                        wp[n_real:] = 0.0
                    recompile = xp.shape not in shapes_seen
                    if recompile:
                        shapes_seen.add(xp.shape)
                    t_disp = TRACER.clock.now()
                    if mesh is not None and not mesh.hosted:
                        lo, hi = _dist.process_local_rows(len(xp), mesh)
                        xp, yp, wp = xp[lo:hi], yp[lo:hi], wp[lo:hi]
                    loss = step(_device_put(xp, dev), _device_put(yp, dev),
                                _device_put(wp, dev))
                    by_step[global_step] = loss
                    done = None
                    if dev.type == "cuda":
                        done = torch.cuda.Event()
                        done.record()
                    inflight.append(done)
                    if len(inflight) > 2:
                        oldest = inflight.popleft()
                        if oldest is not None:
                            oldest.synchronize()
                    TRACER.add("step_dispatch", t_disp, TRACER.clock.now(),
                               parent=sp, recompile=recompile,
                               batch=int(len(xp)))
                    dt = time.perf_counter() - t_step
                    m_step.observe(dt * 1000.0)
                    if dt > 0:
                        m_eps.observe(n_real / dt)
                    if self.log_every and global_step % self.log_every == 0:
                        print(f"[NNLearner] step {global_step} "
                              f"epoch {epoch + 1}/{self.epochs} "
                              f"loss {float(loss):.5f}")
                    if (mngr is not None and self.checkpoint_every
                            and global_step % self.checkpoint_every == 0):
                        self._checkpoint(mngr, global_step, net, step, tx,
                                         mesh)
        if mngr is not None:
            self._checkpoint(mngr, global_step, net, step, tx, mesh)
            mngr.wait_until_finished()

    # -- sharded step checkpointing -------------------------------------------

    def _checkpoint_manager(self):
        if not self.checkpoint_dir:
            return None
        # several processes save cooperatively into ONE directory
        # (io/checkpoint.save_sharded: per-slice ownership + barriers,
        # manifest by process 0) — checkpoint_dir must sit on a
        # filesystem every process shares
        return _ckpt.manager(self.checkpoint_dir)

    @staticmethod
    def _state_tree(net, step, tx: Optimizer) -> Dict[str, Any]:
        """The train state as the JAX trainer saves it: ``{"params":
        <flax tree>, "opt_state": <optax state>}``, every weight and
        moment in the flax layout (a :class:`Shards` of the model ranks'
        slices where the weight is split), the counts int32 scalars.
        The leaves are views of the live tensors, read at save."""
        index = {id(t): i for i, t in enumerate(step.params)}
        slots = _flax_slots(net)

        def tree(of):
            return unflatten_params({key: _to_flax_layout(layer, leaf,
                                                          of(h))
                                     for key, layer, leaf, h in slots})

        def moment(name):
            return tree(lambda h: _map_holder(
                h, lambda t: step.state[name][index[id(t)]]))

        return {"params": tree(lambda h: h),
                "opt_state": tx.state_tree(step.state["count"], moment)}

    @staticmethod
    def _load_state(net, step, tx: Optimizer, params, moments: Dict[str, Any],
                    count: int) -> None:
        """Copy a state into the live tensors, in place: ``params`` and
        each of ``moments`` (flax trees, flax layout; a moment missing
        from ``moments`` is zeroed) and the rate's ``count``."""
        index = {id(t): i for i, t in enumerate(step.params)}
        flat_p = _flat_leaves(params)
        flat_m = {name: _flat_leaves(m) for name, m in moments.items()}
        with torch.no_grad():
            for key, layer, leaf, holder in _flax_slots(net):
                _copy_into(holder, _torch_leaf(layer, leaf,
                                               _as_tensor(flat_p[key])))
                for name in ("trace", "mu", "nu"):
                    if name not in step.state:
                        continue
                    live = _map_holder(
                        holder, lambda t: step.state[name][index[id(t)]])
                    if name in flat_m:
                        _copy_into(live, _torch_leaf(
                            layer, leaf, _as_tensor(flat_m[name][key])))
                    else:
                        _map_holder(live, lambda t: t.zero_())
        step.state["count"] = int(count)

    def _checkpoint(self, mngr, step_num: int, net, step, tx: Optimizer,
                    mesh: Optional[Mesh] = None) -> None:
        from mmlspark_tpu_torch.core.tracing import ambient_tracer
        TRACER = ambient_tracer()
        with TRACER.span("checkpoint_save", step=step_num), \
                _metrics()["ckpt_save_ms"].time():
            # the live tensors are written slice by slice (replicated
            # leaves once, model-split leaves per slice; one rank per
            # process, process 0 writes); the digest manifest lands last
            mngr.save(step_num, self._state_tree(net, step, tx), mesh=mesh)
        # a scrape rides every checkpoint: batch fits usually exit (or
        # are preempted) before any Prometheus scrape, so the registry
        # state lands next to the step it describes — under telemetry/
        # (NOT the checkpoint root: the manager owns that namespace's
        # step listing). Best-effort: telemetry must never fail a save.
        try:
            from mmlspark_tpu_torch.core.telemetry import snapshot_registries
            from mmlspark_tpu_torch.io import fs as _fs
            snapshot_registries(_fs.join(self.checkpoint_dir, "telemetry"),
                                tag=f"step{step_num:08d}", keep=8)
        except Exception:  # noqa: BLE001
            from mmlspark_tpu_torch.core.logs import get_logger
            get_logger("trainer").warning(
                "checkpoint metrics snapshot failed", exc_info=True)

    def _restore(self, mngr, template, net, step, tx: Optimizer,
                 dev: torch.device) -> int:
        """Restore the latest step against ``template`` (the structure
        captured before the first step) onto ``dev`` — each model-split
        weight as the slices the live state holds, whatever layout the
        saving run had — copy it into the live state, and return the
        step (a constant rate's optax state keeps no count: the step is
        the count)."""
        from mmlspark_tpu_torch.core.tracing import ambient_tracer
        TRACER = ambient_tracer()
        latest = mngr.latest_step()
        with TRACER.span("checkpoint_restore", step=latest), \
                _metrics()["ckpt_restore_ms"].time():
            restored = mngr.restore(latest, template, device=dev)
            count, moments = tx.read_state_tree(restored["opt_state"])
            self._load_state(net, step, tx, restored["params"], moments,
                             latest if count is None else count)
        print(f"[NNLearner] resumed from step {latest}")
        return int(latest)

    def _fit_device_resident(self, x, y, w, module, bs: int, tx, loss_fn,
                             dev: torch.device) -> None:
        """Whole epochs on device tensors: the data uploaded once, one
        int32 permutation of ``steps * bs`` indices an epoch (the ragged
        tail dropped, as JAX drops it), the steps gathered on the device,
        the losses read once an epoch."""
        from mmlspark_tpu_torch.core.tracing import ambient_tracer
        TRACER = ambient_tracer()
        is_int = x.dtype == np.uint8
        scale = float(np.float32(1.0 / 255.0)) if is_int else 1.0
        # datasets smaller than the batch keep working: the batch shrinks
        # to the data
        bs = min(bs, len(x))
        steps_per_epoch = max(len(x) // bs, 1)
        x_dev = _device_put(x, dev)
        y_dev = _device_put(y, dev)
        w_dev = _device_put(w, dev)
        step = self.build_train_step(module, tx, loss_fn)
        rng = np.random.default_rng(self.seed)
        n_use = steps_per_epoch * bs
        for epoch in range(self.epochs):
            perm = rng.permutation(len(x))[:n_use].astype(np.int32) \
                .reshape(steps_per_epoch, bs)
            perm_dev = _device_put(perm, dev).to(torch.int64)
            gen = torch.Generator(device=dev)
            gen.manual_seed(self.seed * 100003 + epoch)
            with TRACER.span("train_epoch", route="trainer",
                             epoch=epoch + 1, steps=int(steps_per_epoch)):
                losses = []
                for s in range(steps_per_epoch):
                    idx = perm_dev[s]
                    xb = x_dev[idx]
                    if is_int:
                        xb = xb.to(torch.float32) * scale
                    if self.augment == "flip_crop":
                        xb = self._augment_flip_crop(gen, xb)
                    losses.append(step(xb, y_dev[idx], w_dev[idx]))
                epoch_losses = torch.stack(losses).cpu().numpy()
            self.losses.append(epoch_losses)
            if self.log_every:
                print(f"[NNLearner] epoch {epoch + 1}/{self.epochs} "
                      f"mean loss {float(np.mean(epoch_losses)):.5f}")

    # -- incremental training from a stream -----------------------------------

    def fit_stream(self, source, export_dir: Optional[str] = None,
                   export_every_batches: int = 4,
                   export_prefix: str = "r",
                   steps_per_batch: int = 1,
                   checkpoint_every_batches: int = 1,
                   transform=None,
                   **query_kwargs) -> "StreamingFit":
        """Train incrementally from a micro-batch stream (the JAX
        ``fit_stream``).

        ``source`` is either an engine source (``plan``/``read``/``ack``
        — e.g. a :class:`~mmlspark_tpu_torch.streaming.traffic.
        TrafficLogSource` over served-traffic capture segments) from
        which a :class:`~mmlspark_tpu_torch.streaming.engine.
        StreamingQuery` is built (``query_kwargs`` forwarded —
        ``checkpoint_dir`` for the WAL, watermarks, backpressure knobs),
        or an already-built ``StreamingQuery`` whose sink slot is free —
        ``fit_stream`` installs itself as the sink either way.

        Every micro-batch becomes ``steps_per_batch`` steps of the train
        step ``fit`` uses, on ``resolve_device(self.device)`` (rows
        padded to the data-axis multiple on a power-of-two ladder, pad
        rows weighted 0). With ``checkpoint_dir`` (the Param) set, the
        fit WARM-STARTS from the latest digest-manifested train-state
        checkpoint and saves one every ``checkpoint_every_batches``
        batches (default 1: EVERY trained batch), recording the
        high-water stream batch id inside it — a post-crash replayed
        batch id at or below that mark is SKIPPED, which makes this sink
        idempotent and the end-to-end loop exactly-once. A larger
        cadence trades durability for save cost: batches the engine
        committed after the last train-state checkpoint warm-start as if
        untrained after a crash (at-most-once inside that window). With
        ``export_dir`` set, a servable ``NNModel`` stage checkpoint is
        exported every ``export_every_batches`` batches (manifest
        written last, so every export is flip-eligible the moment it
        appears — what a :class:`~mmlspark_tpu_torch.streaming.loop.
        RetrainLoop` watches).

        Streaming fits use a constant learning rate (no fixed horizon to
        decay over); ``cosine_decay``/``warmup_steps`` are ignored.
        Returns a :class:`StreamingFit` handle (drive the query
        synchronously via ``handle.query.process_available()`` or
        threaded via ``handle.query.start()``)."""
        from mmlspark_tpu_torch.streaming.engine import StreamingQuery
        sink = _StreamTrainerSink(self, export_dir=export_dir,
                                  export_every=export_every_batches,
                                  export_prefix=export_prefix,
                                  steps_per_batch=steps_per_batch,
                                  checkpoint_every=checkpoint_every_batches)
        if isinstance(source, StreamingQuery):
            if source.sink is not None:
                raise ValueError(
                    "fit_stream needs the query's sink slot (build the "
                    "StreamingQuery with sink=None)")
            if query_kwargs or transform is not None:
                raise ValueError(
                    "pass transform/query knobs when fit_stream builds "
                    "the query, not alongside a pre-built one")
            query = source
            query.sink = sink
        else:
            query_kwargs.setdefault("name", "fit_stream")
            query = StreamingQuery(source, sink=sink,
                                   transform=transform, **query_kwargs)
        return StreamingFit(query, sink)


def _as_label(v) -> float:
    """A usable numeric label or NaN (filtered): captured traffic rows
    carry JSON values, so None holes / strings / lists are expected."""
    try:
        if isinstance(v, (list, tuple, np.ndarray)):
            return float("nan")
        return float(v)
    except (TypeError, ValueError):
        return float("nan")


class _StreamTrainerSink:
    """The ``fit_stream`` sink: micro-batches -> train steps.

    Idempotent by batch id: the train-state checkpoint records the
    high-water stream batch id it covers, so a replayed batch (the
    engine re-runs planned-but-uncommitted batches after a crash) at or
    below the restored mark is skipped — replay beats re-dispatch, and a
    crash anywhere in the write/commit window never trains a batch twice
    past a checkpoint. Set up on the first frame (shapes come from the
    stream)."""

    def __init__(self, learner: NNLearner, export_dir: Optional[str],
                 export_every: int, export_prefix: str,
                 steps_per_batch: int, checkpoint_every: int = 1):
        self.learner = learner
        self.export_dir = (os.path.abspath(export_dir)
                           if export_dir else None)
        self.export_every = max(int(export_every), 1)
        self.export_prefix = str(export_prefix)
        self.steps_per_batch = max(int(steps_per_batch), 1)
        self.checkpoint_every = max(int(checkpoint_every), 1)
        self._ready = False
        self._was_int = False
        self.last_trained_batch = 0
        self.global_step = 0
        self.n_batches_trained = 0
        self.n_rows_trained = 0
        self.n_replays_skipped = 0
        self.n_rows_unlabeled = 0
        self.n_batches_unusable = 0
        self.n_exports = 0
        self.exports: "list[str]" = []
        self.last_loss: Optional[float] = None

    # -- set-up on the first frame --------------------------------------------

    def _setup(self, x: np.ndarray) -> None:
        learner = self.learner
        self._was_int = x.dtype == np.uint8
        shape = ((x.shape[1:]) if x.ndim > 1 else ())
        fn = learner.model or NNFunction.init(
            learner.arch, shape, seed=learner.seed)
        self._arch = dict(fn.arch)
        self._dev = resolve_device(learner.device)
        self._mesh, self._n_data, tp = learner._mesh(self._dev)
        per_process = self._mesh is not None and not self._mesh.hosted
        # a stream has no fixed horizon: constant learning rate (the
        # schedule params cosine_decay/warmup_steps are batch-fit only)
        self._tx = make_optimizer(learner.optimizer, learner.learning_rate,
                                  learner.momentum, learner.weight_decay,
                                  learner.clip_norm)
        self._net = (PlacedModule(fn.module(), fn.params, self._mesh)
                     if tp > 1 else fn.to_module(self._dev))
        self._step = learner.build_train_step(
            self._net, self._tx,
            make_loss(learner.loss, "sum" if per_process else "mean"),
            self._mesh)
        self._mngr = learner._checkpoint_manager()
        if self._mngr is not None:
            # the structure before any step (same rule as fit)
            template = _ckpt.map_leaves(_meta_like, learner._state_tree(
                self._net, self._step, self._tx))
            latest = self._mngr.latest_step()
            if latest is not None:
                learner._restore(self._mngr, template, self._net,
                                 self._step, self._tx, self._dev)
                self.global_step = int(latest)
                extra = _ckpt.read_index(
                    self._mngr._step_dir(latest)).get("extra", {})
                self.last_trained_batch = int(
                    extra.get("stream_batch_id", 0))
                self.n_exports = int(extra.get("n_exports", 0))
                print(f"[NNLearner] fit_stream warm-started from step "
                      f"{latest} (stream batch "
                      f"{self.last_trained_batch})")
        if self.export_dir:
            os.makedirs(self.export_dir, exist_ok=True)
            # continue the export sequence past anything already there
            # (a restarted loop must never reuse a pushed version name)
            for name in os.listdir(self.export_dir):
                if name.startswith(self.export_prefix):
                    try:
                        self.n_exports = max(
                            self.n_exports,
                            int(name[len(self.export_prefix):]))
                    except ValueError:
                        continue

    # -- the sink -------------------------------------------------------------

    def process(self, batch_id: int, df: DataFrame) -> None:
        from mmlspark_tpu_torch.parallel.sharding import pad_to_bucket

        learner = self.learner
        if df.num_rows == 0 or learner.features_col not in df:
            return
        # bad DATA must never kill the retrain loop: captured traffic
        # mixes labeled (feedback) and unlabeled (plain inference) rows,
        # and a malformed payload is a data problem, not a query-terminal
        # fault. Rows without a usable numeric label are dropped
        # (counted); a batch with nothing trainable is ignored —
        # deterministically, so a replay skips it too.
        try:
            if learner.label_col in df:
                y_raw = df[learner.label_col]
                if y_raw.dtype == object:
                    y = np.array([_as_label(v) for v in y_raw],
                                 dtype=np.float32)
                else:
                    y = np.asarray(y_raw, dtype=np.float32)
                mask = np.isfinite(y)
            else:
                y = np.zeros(df.num_rows, dtype=np.float32)
                mask = np.zeros(df.num_rows, dtype=bool)
            n_bad = int(df.num_rows - mask.sum())
            if n_bad:
                self.n_rows_unlabeled += n_bad
            if not mask.any():
                return
            if n_bad:
                df = df.filter(mask)
                y = y[mask]
            x = _stack_column(df[learner.features_col])
            if not self._ready:
                self._setup(x)
                self._ready = True
            if self._was_int and x.dtype == np.uint8:
                x = x.astype(np.float32) / 255.0
            elif x.dtype != np.float32:
                x = np.asarray(x, dtype=np.float32)
            w = (np.asarray(df[learner.weight_col], dtype=np.float32)
                 if learner.weight_col and learner.weight_col in df
                 else np.ones(len(y), dtype=np.float32))
        except (KeyError, TypeError, ValueError) as e:
            # a data-shape problem (ragged features, non-numeric
            # payloads): skip the batch loudly, keep the stream alive
            self.n_batches_unusable += 1
            from mmlspark_tpu_torch.core.logs import get_logger
            get_logger("trainer").warning(
                "fit_stream batch %d unusable (%s: %s); skipped",
                batch_id, type(e).__name__, e)
            return
        if batch_id <= self.last_trained_batch:
            # the idempotent-sink contract: this batch is already
            # inside the restored checkpoint's high-water mark
            self.n_replays_skipped += 1
            return
        # two-stage pad: power-of-two bucket (a bounded set of batch
        # shapes under ragged stream batches), then the data-axis
        # multiple; pad rows weigh 0, so they add nothing to the loss
        cap = max(int(learner.batch_size), self._n_data)
        xp, n_real = pad_to_bucket(x, cap=cap)
        xp, _ = pad_to_multiple(xp, self._n_data)
        target = len(xp)
        yp = np.zeros(target, dtype=np.float32)
        yp[:n_real] = y[:n_real]
        wp = np.zeros(target, dtype=np.float32)
        wp[:n_real] = w[:n_real]
        if self._mesh is not None and not self._mesh.hosted:
            lo, hi = _dist.process_local_rows(target, self._mesh)
            xp, yp, wp = xp[lo:hi], yp[lo:hi], wp[lo:hi]
        metrics = _metrics()
        for _ in range(self.steps_per_batch):
            t0 = time.perf_counter()
            loss = self._step(_device_put(xp, self._dev),
                              _device_put(yp, self._dev),
                              _device_put(wp, self._dev))
            self.global_step += 1
            dt = time.perf_counter() - t0
            metrics["step_ms"].observe(dt * 1000.0)
            if dt > 0:
                metrics["examples_per_sec"].observe(n_real / dt)
        self.last_loss = float(loss)
        self.last_trained_batch = int(batch_id)
        self.n_batches_trained += 1
        self.n_rows_trained += int(n_real)
        # two independent cadences: the train-state checkpoint is the
        # exactly-once high-water mark (default every batch — a larger
        # cadence opens an at-most-once window after a crash, see
        # fit_stream); the servable export is the rollout feed
        if self.n_batches_trained % self.checkpoint_every == 0:
            self._save_train_state()
        if self.export_dir \
                and self.n_batches_trained % self.export_every == 0:
            self._export()

    # -- checkpoint + servable export -----------------------------------------

    def _save_train_state(self) -> None:
        """Save the train state; the idempotence high-water mark
        (``stream_batch_id``) rides in ``extra``."""
        if self._mngr is None:
            return
        with _metrics()["ckpt_save_ms"].time():
            self._mngr.save(
                self.global_step,
                self.learner._state_tree(self._net, self._step, self._tx),
                extra={"stream_batch_id": self.last_trained_batch,
                       "n_exports": self.n_exports},
                mesh=self._mesh)

    def _export(self) -> Optional[str]:
        """Export a servable NNModel stage checkpoint whose digest
        manifest lands LAST — flip-eligible for the rollout plane the
        moment the directory is complete."""
        if not self.export_dir:
            return None
        self.n_exports += 1
        name = f"{self.export_prefix}{self.n_exports:06d}"
        path = os.path.join(self.export_dir, name)
        self.model().save(path)
        self.exports.append(path)
        return path

    def checkpoint_and_export(self) -> Optional[str]:
        """Off-cadence save + export (drain/shutdown; ``export_now``)."""
        if not self._ready:
            return None
        path = self._export()
        self._save_train_state()
        return path

    def model(self) -> NNModel:
        """A servable snapshot of the current streamed-trained model."""
        if not self._ready:
            raise RuntimeError("fit_stream has not seen a batch yet")
        fn = NNFunction(arch=dict(self._arch), params=self._net.to_flax())
        extra = {"input_dtype": "uint8"} if self._was_int else {}
        return NNModel(model=fn, input_col=self.learner.features_col,
                       output_col="scores", device=self.learner.device,
                       **extra)

    def status(self) -> Dict[str, Any]:
        return {"ready": self._ready,
                "global_step": self.global_step,
                "last_trained_batch": self.last_trained_batch,
                "n_batches_trained": self.n_batches_trained,
                "n_rows_trained": self.n_rows_trained,
                "n_replays_skipped": self.n_replays_skipped,
                "n_rows_unlabeled": self.n_rows_unlabeled,
                "n_batches_unusable": self.n_batches_unusable,
                "n_exports": self.n_exports,
                "exports": list(self.exports),
                "last_loss": self.last_loss}


class StreamingFit:
    """Handle over a streaming fit: the query (drive/stop it here) plus
    the trainer sink's counters, snapshots, and exports."""

    def __init__(self, query, sink: _StreamTrainerSink):
        self.query = query
        self._sink = sink

    @property
    def exports(self) -> "list[str]":
        return list(self._sink.exports)

    def model(self) -> NNModel:
        return self._sink.model()

    def export_now(self) -> Optional[str]:
        """Checkpoint + export outside the cadence (drain/shutdown)."""
        return self._sink.checkpoint_and_export()

    def status(self) -> Dict[str, Any]:
        return {"trainer": self._sink.status(),
                "query": self.query.status()}

    def stop(self) -> None:
        self.query.stop()

    def __enter__(self) -> "StreamingFit":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()
