"""Pipeline parallelism over slices of a mesh's ranks (the port of
``mmlspark_tpu/parallel/pipeline.py``).

A model's **stage graph** (an ordered chain of layers) is cut into
contiguous stages, each placed on its own slice of the ranks, and
**micro-batched frames** are driven through them: while stage 1 runs
micro-batch *i*, stage 0 already runs micro-batch *i+1*. The fill and
drain leave a **bubble**, for K balanced stages over M micro-batches
GPipe's ``(K-1)/(M+K-1)``.

* :func:`plan_stages` is the **stage placement rule**: a contiguous
  partition of per-layer costs that minimises the slowest stage (the
  linear-partition DP), mapped onto contiguous slices of the ranks. It
  and :func:`split_rows` and :func:`bubble_ratio` are numpy, copied
  from the JAX module.
* :class:`PipelineRunner` is the **micro-batch runner**. On the card
  each stage runs on a CUDA stream of its own, and a boundary hand-off
  is an event recorded on stage k's stream that stage k+1's stream
  waits on (JAX moves the boundary with ``device_put`` between device
  slices; a hosted mesh's slices share one device, so nothing moves).
  One host thread enqueues micro-batch-major, so micro-batches of
  different stages overlap on the card. A tensor made on one stage's
  stream and read on another's is marked with ``record_stream`` so the
  caching allocator does not reuse its memory before the reader is
  done. On the CPU the stages run one after another.
* **bubble accounting**: :meth:`PipelineRunner.probe` runs one
  micro-batch through the chain with a synchronize around each stage
  (once, off the steady path) for each stage's service time; with the
  schedule model it gives the measured ``bubble_ratio`` of the
  ``/stats`` block, and each run records a ``pipeline_stage`` span a
  stage (``pipeline_stage=k``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

__all__ = ["StagePlan", "plan_stages", "split_rows", "PipelineRunner",
           "bubble_ratio"]


@dataclasses.dataclass(frozen=True)
class StagePlan:
    """A contiguous layer partition mapped onto slices of the ranks."""

    #: per-stage ``(start, stop)`` layer index ranges (python slices)
    boundaries: Tuple[Tuple[int, int], ...]
    #: per-stage device lists (contiguous slices of the given devices)
    devices: Tuple[Tuple[Any, ...], ...]
    #: per-stage summed layer costs (the balance evidence)
    costs: Tuple[float, ...]

    @property
    def n_stages(self) -> int:
        return len(self.boundaries)


def _partition_costs(costs: Sequence[float], k: int) -> List[int]:
    """Contiguous k-partition of ``costs`` minimising the largest part's
    sum (the linear-partition DP, O(n^2 k)). Returns the k-1 cut
    points."""
    n = len(costs)
    prefix = [0.0]
    for c in costs:
        prefix.append(prefix[-1] + float(c))

    def part_sum(i, j):               # costs[i:j]
        return prefix[j] - prefix[i]

    # dp[j][p] = the least largest part sum of costs[:j] in p parts
    INF = float("inf")
    dp = [[INF] * (k + 1) for _ in range(n + 1)]
    cut = [[0] * (k + 1) for _ in range(n + 1)]
    dp[0][0] = 0.0
    for j in range(1, n + 1):
        for p in range(1, min(j, k) + 1):
            for i in range(p - 1, j):
                cand = max(dp[i][p - 1], part_sum(i, j))
                if cand < dp[j][p]:
                    dp[j][p] = cand
                    cut[j][p] = i
    cuts = []
    j, p = n, k
    while p > 1:
        i = cut[j][p]
        cuts.append(i)
        j, p = i, p - 1
    return sorted(cuts)


def plan_stages(costs: Sequence[float], n_stages: int,
                devices: Optional[Sequence[Any]] = None) -> StagePlan:
    """The stage placement rule: cut a layer chain's ``costs`` (one
    number a layer; ``NNModel`` passes parameter bytes) into ``n_stages``
    contiguous stages minimising the slowest, and map stage *k* onto the
    *k*-th contiguous slice of ``devices`` (the labels of a hosted
    mesh's ranks). Every stage gets at least one layer and every slice
    the same number of devices (``len(devices)`` must divide by
    ``n_stages``). JAX defaults ``devices`` to ``jax.devices()``; the
    port has no device list to default to, and refuses a missing one."""
    n_stages = int(n_stages)
    if n_stages < 2:
        raise ValueError(f"pipeline needs n_stages >= 2 (got {n_stages})")
    if len(costs) < n_stages:
        raise ValueError(
            f"cannot split {len(costs)} layers into {n_stages} stages")
    if devices is None:
        raise ValueError("plan_stages needs the devices (the hosted "
                         "ranks' labels) to place the stages on")
    devices = list(devices)
    if len(devices) < n_stages:
        raise ValueError(
            f"{n_stages} stages need >= {n_stages} devices "
            f"(have {len(devices)})")
    if len(devices) % n_stages:
        raise ValueError(
            f"{len(devices)} devices do not split into {n_stages} "
            f"equal slices")
    per = len(devices) // n_stages
    cuts = _partition_costs(list(costs), n_stages)
    bounds = []
    start = 0
    for c in cuts + [len(costs)]:
        bounds.append((start, c))
        start = c
    slices = tuple(tuple(devices[k * per:(k + 1) * per])
                   for k in range(n_stages))
    stage_costs = tuple(float(sum(costs[a:b])) for a, b in bounds)
    return StagePlan(boundaries=tuple(bounds), devices=slices,
                     costs=stage_costs)


def split_rows(n_rows: int, microbatches: int, multiple: int = 1
               ) -> List[Tuple[int, int]]:
    """Micro-batch row ranges of an ``n_rows`` frame: up to
    ``microbatches`` contiguous ranges, each a multiple of ``multiple``
    (the stage mesh's data-axis size). The frame arrives padded to the
    multiple; the sizes depend only on (n_rows, microbatches,
    multiple), so a fixed bucket ladder gives a fixed set of shapes."""
    multiple = max(int(multiple), 1)
    if n_rows <= 0:
        return []
    if n_rows % multiple:
        raise ValueError(
            f"pipeline frames must arrive padded to the stage multiple "
            f"({multiple}); got {n_rows} rows — the bucket ladder "
            f"should have rounded this up")
    units = n_rows // multiple
    m = max(min(int(microbatches), units), 1)
    per = (units + m - 1) // m * multiple     # equal-ish, multiple-divisible
    out = []
    start = 0
    while start < n_rows:
        stop = min(start + per, n_rows)
        out.append((start, stop))
        start = stop
    return out


def bubble_ratio(stage_ms: Sequence[float], n_micro: int) -> float:
    """The measured steady-state bubble of one pipelined frame: with
    stage service times ``t_k`` and ``M`` micro-batches, the schedule's
    wall is ``(M-1) * t_max + sum_k t_k`` and the busy time ``M * sum_k
    t_k`` over ``K`` slices, so ``bubble = 1 - busy / (K * wall)``;
    GPipe's ``(K-1)/(M+K-1)`` for balanced stages."""
    ts = [max(float(t), 1e-9) for t in stage_ms]
    K, M = len(ts), max(int(n_micro), 1)
    if K < 2:
        return 0.0
    t_max, t_sum = max(ts), sum(ts)
    wall = (M - 1) * t_max + t_sum
    return max(0.0, min(1.0, 1.0 - (M * t_sum) / (K * wall)))


class PipelineRunner:
    """Drive micro-batches through a chain of placed stage functions.

    ``stages`` is a list of ``(fn, params, placement, devices)``:
    ``fn(params, x) -> y``, ``placement`` the torch device its input
    lives on, ``devices`` the slice's labels for reports. :meth:`run`
    enqueues micro-batch-major (the GPipe order), each stage on its own
    CUDA stream on the card; :meth:`probe` runs one micro-batch with a
    synchronize around each stage, once at warmup, never on the live
    path."""

    def __init__(self, stages: List[Tuple[Callable, Any, Any,
                                          Tuple[str, ...]]],
                 microbatches: int = 4):
        if len(stages) < 2:
            raise ValueError("PipelineRunner needs >= 2 stages")
        self.stages = stages
        self.microbatches = max(int(microbatches), 2)
        self.stage_ms: List[float] = [0.0] * len(stages)
        self._probed = False
        self._streams: Optional[List[torch.cuda.Stream]] = None
        self.last_n_micro = 0
        self.last_wall_ms = 0.0
        self.n_frames = 0
        #: micro-batches the frame in progress has dispatched so far (0
        #: between frames; a finished frame reports last_n_micro)
        self.in_flight = 0

    @property
    def n_stages(self) -> int:
        return len(self.stages)

    def _stage_streams(self, device: torch.device
                       ) -> Optional[List[torch.cuda.Stream]]:
        """One stream a stage on the card (made on first use), None on
        the CPU."""
        if device.type != "cuda":
            return None
        if self._streams is None:
            self._streams = [torch.cuda.Stream(device=device)
                             for _ in self.stages]
        return self._streams

    def _chain(self, mb: torch.Tensor, on_stage=None) -> torch.Tensor:
        """One micro-batch through every stage. On the card: stage k's
        stream waits on the event that ends stage k-1's work (the
        caller's stream's for stage 0), the input is marked as used on
        stage k's stream, and the caller's stream waits on the last
        stage. ``on_stage(k, phase)`` brackets each stage (``"begin"``
        after its input is ready, ``"end"`` after it is enqueued)."""
        streams = self._stage_streams(mb.device)
        y = mb
        prev = torch.cuda.current_stream(mb.device) if streams else None
        for k, (fn, params, placement, _) in enumerate(self.stages):
            if on_stage is not None:
                on_stage(k, "begin")
            if streams is None:
                y = fn(params, y.to(placement))
            else:
                s = streams[k]
                handoff = torch.cuda.Event()
                handoff.record(prev)
                s.wait_event(handoff)
                with torch.cuda.stream(s):
                    y.record_stream(s)
                    y = fn(params, y.to(placement, non_blocking=True))
                prev = s
            if on_stage is not None:
                on_stage(k, "end")
        if streams is not None:
            cur = torch.cuda.current_stream(y.device)
            done = torch.cuda.Event()
            done.record(prev)
            cur.wait_event(done)
            y.record_stream(cur)
        return y

    def probe(self, mb: torch.Tensor) -> List[float]:
        """One pass with a synchronize around each stage: each stage's
        service time in ms (its compute, measured synchronously). Warmup
        calls this once; the live path never synchronizes."""
        times = [0.0] * self.n_stages
        cuda = mb.device.type == "cuda"
        t0 = [0.0]

        def on_stage(k, phase):
            if cuda:
                torch.cuda.synchronize(mb.device)
            if phase == "begin":
                t0[0] = time.perf_counter()
            else:
                times[k] = (time.perf_counter() - t0[0]) * 1000.0

        self._chain(mb, on_stage)
        self.stage_ms = times
        self._probed = True
        return times

    def run(self, microbatches: List[torch.Tensor], tracer=None,
            span_attrs=None) -> List[torch.Tensor]:
        """Enqueue every micro-batch through the stage chain; returns the
        per-micro-batch outputs, on the device and not synchronized (the
        caller unpads, concatenates and reads back). With a tracer, one
        ``pipeline_stage`` span a stage (the host's enqueue window,
        ``pipeline_stage=k``) under the ambient span."""
        t_wall = time.perf_counter()
        windows = [[None, None] for _ in self.stages]

        def on_stage(k, phase):
            t = time.perf_counter()
            if phase == "begin":
                if windows[k][0] is None:
                    windows[k][0] = t
            else:
                windows[k][1] = t

        ys: List[torch.Tensor] = []
        self.in_flight = 0
        for mb in microbatches:
            ys.append(self._chain(mb, on_stage))
            self.in_flight += 1
        self.last_n_micro = len(microbatches)
        self.last_wall_ms = (time.perf_counter() - t_wall) * 1000.0
        self.n_frames += 1
        self.in_flight = 0
        if tracer is not None:
            # the enqueue windows say which stage's dispatch backed up;
            # the service times live in report()
            from mmlspark_tpu_torch.core.tracing import current_span
            parent = current_span()
            if parent is not None:
                for k, (w0, w1) in enumerate(windows):
                    if w0 is not None:
                        tracer.add("pipeline_stage", w0, w1,
                                   parent=parent, pipeline_stage=k,
                                   devices=",".join(self.stages[k][3]),
                                   **(span_attrs or {}))
        return ys

    def report(self) -> Dict[str, Any]:
        """The ``/stats`` "pipeline" block (JAX's keys)."""
        m = self.last_n_micro or self.microbatches
        return {
            "n_stages": self.n_stages,
            "microbatches": self.microbatches,
            "last_n_micro": self.last_n_micro,
            "in_flight_micro_batches": self.in_flight,
            "stages": [{
                "stage": k,
                "devices": list(devs),
                "service_ms": round(self.stage_ms[k], 3),
            } for k, (_, _, _, devs) in enumerate(self.stages)],
            "stage_probe_valid": self._probed,
            "bubble_ratio": round(bubble_ratio(self.stage_ms, m), 4)
            if self._probed else None,
            "last_wall_ms": round(self.last_wall_ms, 3),
            "n_frames": self.n_frames,
        }
