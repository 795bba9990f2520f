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

The model axis one rank per process needs a card a rank and raises
(**the model, expert and pipe axes**), as do an expert or pipe axis
(JAX's ``NNLearner`` has neither). Inside
:func:`~mmlspark_tpu_torch.parallel.topology.single_device_scope` a fit
places no mesh (one data shard). ``checkpoint_dir`` waits for
**checkpoints and the port's benches** and ``fit_stream`` for
**streaming and the retrain loop**.
"""

from __future__ import annotations

import math
import time
import warnings
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F

from mmlspark_tpu_torch.core.dataframe import DataFrame
from mmlspark_tpu_torch.core.environment import resolve_device
from mmlspark_tpu_torch.core.params import (
    HasDevice, HasFeaturesCol, HasLabelCol, Param, in_range, in_set,
)
from mmlspark_tpu_torch.core.stage import Estimator
from mmlspark_tpu_torch.models.function import (
    NNFunction, PlacedModule, ieee_f32,
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
            # the checkpoint families of the JAX trainer, registered
            # alike; the port's fits take no checkpoints yet
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

class Optimizer:
    """An optax chain on tensors: optional ``clip_by_global_norm``, the
    rule (``sgd``; ``momentum``, optax's ``trace`` without Nesterov;
    ``adam``; ``adamw``), then ``scale_by_learning_rate``. The rate is
    read at the count before the update; :meth:`step` changes the
    parameters and the state in place, under ``no_grad``."""

    #: optax.adam's defaults, which the JAX trainer takes
    B1, B2, EPS = 0.9, 0.999, 1e-8

    def __init__(self, name: str, learning_rate: Union[float, Schedule],
                 momentum: float = 0.9, weight_decay: float = 1e-4,
                 clip_norm: float = 0.0):
        if name not in OPTIMIZERS:
            raise ValueError(f"unknown optimizer {name!r}; have "
                             f"{OPTIMIZERS}")
        self.name = name
        self.schedule = (learning_rate if callable(learning_rate)
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
    checkpoint_dir = Param(None, "step-checkpoint directory (waits for "
                           "checkpoints and the port's benches)", ptype=str)
    checkpoint_every = Param(0, "steps between checkpoints (0 = off)",
                             ptype=int)
    push_gateway_url = Param(None, "optional metrics remote-write URL: a "
                             "MetricsPusher POSTs the process registry "
                             "there on an interval during fit, with a "
                             "final flush when the fit ends", ptype=str)
    push_interval_s = Param(30.0, "seconds between remote-write pushes",
                            ptype=float, validator=in_range(lo=1.0))
    max_restarts = Param(2, "bounded in-process auto-restarts from the "
                         "latest step checkpoint; without checkpointing "
                         "a failed step's error propagates", ptype=int)
    fault_injector = Param(None, "chaos-test hook: callable(global_step)"
                           " invoked before each host-loop step",
                           complex=True)
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

    def _schedule(self, steps_per_epoch: int) -> Schedule:
        warmup = max(self.warmup_steps, 1)
        total = max(self.epochs * steps_per_epoch, warmup + 1)
        if self.cosine_decay:
            return warmup_cosine_decay_schedule(
                0.0, self.learning_rate, warmup, total)
        if self.warmup_steps:
            return linear_schedule(0.0, self.learning_rate,
                                   self.warmup_steps)
        return constant_schedule(self.learning_rate)

    def _mesh(self, dev: torch.device
              ) -> "tuple[Optional[Mesh], int, int]":
        """``(mesh, data shards, model width)`` of ``mesh_shape``: a
        hosted ``model`` axis places a mesh; so does a world of several
        processes (the data axis, one rank a process); a hosted data
        axis alone only shapes the batch (no mesh). Refuses an expert or
        pipe axis, the model axis one rank per process and any other
        axis."""
        if in_single_device_scope():
            return None, 1, 1
        shape = dict(self.mesh_shape or {AXIS_DATA: -1})
        for axis, size in shape.items():
            if axis in (AXIS_EXPERT, AXIS_PIPE) and size != 1:
                raise NotImplementedError(
                    f"mesh axis {axis!r} of size {size}: NNLearner has no "
                    f"expert or pipeline parallelism (JAX's has neither; "
                    f"ROADMAP queue 1: the model, expert and pipe axes)")
            if axis not in (AXIS_DATA, AXIS_MODEL, AXIS_EXPERT, AXIS_PIPE) \
                    and size != 1:
                raise ValueError(f"mesh axis {axis!r} of size {size}: "
                                 f"NNLearner shards over the data axis "
                                 f"only")
        tp = int(shape.get(AXIS_MODEL, 1))
        d = torch.distributed
        if d.is_available() and d.is_initialized() \
                and d.get_world_size() > 1:
            if tp > 1:
                raise NotImplementedError(
                    f"NNLearner's model axis ({tp}) one rank per process "
                    f"needs a card for each rank: ROADMAP queue 1, the "
                    f"model, expert and pipe axes (a hosted model axis "
                    f"runs in one process)")
            mesh = build_mesh(MeshSpec.from_dict(
                {AXIS_DATA: int(shape.get(AXIS_DATA, -1))}), dev)
            return mesh, mesh.shape[AXIS_DATA], 1
        n_data = int(shape.get(AXIS_DATA, 1))
        n_data = 1 if n_data == -1 else n_data
        if tp > 1:
            return _dist.train_mesh({AXIS_DATA: n_data, AXIS_MODEL: tp},
                                    dev), n_data, tp
        return None, n_data, 1

    # -- fit ------------------------------------------------------------------

    def fit(self, df: DataFrame) -> NNModel:
        if self.checkpoint_dir:
            raise NotImplementedError(
                "NNLearner.checkpoint_dir waits for ROADMAP queue 1: "
                "checkpoints and the port's benches (the port has no "
                "sharded train-state store yet)")
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
        if self.device_resident and n_data == 1:
            module = fn.to_module(dev)
            self._fit_device_resident(x, y, w, module, bs, tx, loss_fn, dev)
            params = module.to_flax()
        else:
            if self.augment != "none":
                warnings.warn(
                    "augment is applied by the device-resident fit "
                    "only; this fit takes the per-step host loop "
                    f"(device_resident={self.device_resident}, data "
                    f"shards={n_data}) and trains WITHOUT augmentation",
                    stacklevel=3)
            if was_int:
                x = x.astype(np.float32) / 255.0
            # the state over a model axis: its leaves laid out by the
            # rule, the optimizer's moments shaped (and so laid out) as
            # their slices
            net = (PlacedModule(fn.module(), fn.params, mesh) if tp > 1
                   else fn.to_module(dev))
            if per_process:
                loss_fn = make_loss(self.loss, reduction="sum")
            # a failed step's error propagates: restarts restore from a
            # step checkpoint, which the port does not take yet
            self._host_loop(x, y, w, self.build_train_step(
                net, tx, loss_fn, mesh), steps_per_epoch, bs, n_data, dev,
                mesh)
            params = net.to_flax()
        trained = NNFunction(arch=dict(fn.arch), params=params)
        # an integer-trained model's scorer keeps the training-time input
        # convention (uint8 in, /255 on device)
        extra = {"input_dtype": "uint8"} if was_int else {}
        return NNModel(model=trained, input_col=self.features_col,
                       output_col="scores", device=self.device, **extra)

    def _host_loop(self, x, y, w, step, steps_per_epoch: int, bs: int,
                   n_data: int, dev: torch.device,
                   mesh: Optional[Mesh] = None) -> None:
        """The per-step host loop: JAX's numpy shuffle stream, each
        batch padded to the data axis (pad rows weighted 0) and uploaded,
        two steps in flight. One rank per process, each process uploads
        only its rows of the padded global batch
        (:func:`~mmlspark_tpu_torch.parallel.dist.process_local_rows`;
        the shuffle stream is the same on every process)."""
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
            epoch_losses = []
            for s in range(steps_per_epoch):
                global_step += 1
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
                    epoch_losses.append(loss)
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
            self.losses.append(torch.stack(epoch_losses).cpu().numpy())

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

    def fit_stream(self, source, *args, **kwargs):
        raise NotImplementedError(
            "NNLearner.fit_stream waits for ROADMAP queue 1: streaming "
            "and the retrain loop (the port has no StreamingQuery yet)")
