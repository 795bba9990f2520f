"""Adaptive micro-batch dispatch policy (the port's copy of
``mmlspark_tpu/serving/policy.py``).

The frame plane's fixed ``max_latency_ms`` knob answers one question —
"how long may a batch wait for batch-mates?" — with a constant. The
right answer depends on two things the server can *measure*: how fast
requests are arriving (wait w seconds and ~rate*w more show up) and
how much a bigger shape bucket actually costs to dispatch (the
per-bucket latency histograms the telemetry layer already collects).

:class:`AdaptiveBatchPolicy` learns both online and picks the wait
that maximizes dispatch *throughput* (rows per second through the
model): for each reachable bucket it scores ``bucket / (time_to_fill
+ service_time(bucket))`` and waits just long enough to fill the best
one — under a hard ``ceiling_ms`` so latency can never run away, and
never waiting at all when arrivals are too slow to fill a bigger
bucket in time. Until it has a believable arrival-rate estimate and
``min_count`` histogram samples it returns ``None`` and the fixed
knob keeps ruling (the same warm-up contract as
:class:`~mmlspark_tpu_torch.core.tracing.AdaptiveThreshold`).

A/B selectable: ``ServingServer(batch_policy="adaptive")`` wires this
in; ``"fixed"`` (the default) keeps the constant knob — both planes
share every other stage, so the bench/test comparison isolates the
policy.
"""

from __future__ import annotations

import math
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from mmlspark_tpu_torch.core.resilience import SYSTEM_CLOCK, Clock

#: Tenant priority classes, most- to least-latency-sensitive. The
#: ordering is the shed ordering under pressure: ``background`` sheds
#: first, ``batch`` next, ``interactive`` only when the queue is full.
PRIORITY_CLASSES = ("interactive", "batch", "background")


class PriorityShedPolicy:
    """Map queue pressure to a per-priority-class shed verdict.

    Below the ``high_water`` fraction of capacity nobody sheds; above
    it the classes peel off in reverse priority order — ``background``
    at ``high_water``, ``batch`` midway between high water and full,
    ``interactive`` only at a genuinely full queue (which is exactly
    the pre-tenancy behavior, so latency-sensitive traffic is never
    worse off under this policy than under the plain full-queue
    check). A full queue sheds every class regardless.
    """

    def __init__(self, high_water: float = 0.5):
        hw = min(max(float(high_water), 0.0), 1.0)
        self.high_water = hw
        self._thresholds = {"background": hw,
                            "batch": (hw + 1.0) / 2.0,
                            "interactive": 1.0}

    def threshold(self, priority: str) -> float:
        """Pressure fraction at which ``priority`` starts shedding."""
        return self._thresholds.get(priority, 1.0)

    def should_shed(self, depth: int, capacity: int,
                    priority: str) -> bool:
        if capacity <= 0:
            return False
        if depth >= capacity:
            return True
        return depth >= self._thresholds.get(priority, 1.0) * capacity


class AdaptiveBatchPolicy:
    """Learn the arrival-rate/batch-size tradeoff online.

    ``stats_fn`` returns ``[(bucket_rows, edges, counts), ...]`` — one
    entry per per-bucket dispatch-latency histogram child.
    ``bucket_ladder`` is the reachable bucket set (the pow2 ladder
    clamped at ``max_batch_size``). ``ceiling_ms`` bounds any wait the
    policy may choose (the old fixed knob becomes the ceiling, so
    "adaptive" can only ever wait *less* than the configured worst
    case).

    Hot-path cost: :meth:`note_arrival` is one clock read + two float
    ops per request (called at enqueue); :meth:`tick` is one int bump
    per batch, with a bounded histogram walk every ``refresh_every``-th
    batch (the :class:`AdaptiveThreshold` cadence idiom).
    """

    def __init__(self, stats_fn: Callable[[], List[Tuple[int,
                                                         Sequence[float],
                                                         Sequence[int]]]],
                 bucket_ladder: Sequence[int],
                 ceiling_ms: float = 10.0,
                 quantile: float = 0.5,
                 min_count: int = 32,
                 refresh_every: int = 16,
                 ewma_alpha: float = 0.1,
                 max_gap_s: float = 5.0,
                 clock: Clock = SYSTEM_CLOCK):
        self.stats_fn = stats_fn
        self.ladder = sorted(int(b) for b in bucket_ladder)
        self.ceiling_ms = float(ceiling_ms)
        self.quantile = float(quantile)
        self.min_count = int(min_count)
        self.refresh_every = max(int(refresh_every), 1)
        self.alpha = float(ewma_alpha)
        self.max_gap_s = float(max_gap_s)
        self.clock = clock
        # inter-arrival EWMA (seconds); None until two arrivals seen
        self._gap_s: Optional[float] = None
        self._last_arrival: Optional[float] = None
        self._arrival_lock = threading.Lock()
        # bucket -> learned service time (ms); refreshed off-path
        self.service_ms: Dict[int, float] = {}
        self._n_samples = 0
        self._since = 0
        self.n_refreshes = 0
        self.last_wait_ms: Optional[float] = None

    # -- online inputs -------------------------------------------------------

    def note_arrival(self) -> None:
        """Called at ingress enqueue: fold one inter-arrival gap into
        the EWMA. Gaps past ``max_gap_s`` (an idle lull) reset the
        estimate instead of polluting it — after a quiet minute the
        first burst re-learns the rate from scratch."""
        now = self.clock.now()
        with self._arrival_lock:
            last, self._last_arrival = self._last_arrival, now
            if last is None:
                return
            gap = now - last
            if gap > self.max_gap_s:
                self._gap_s = None
                return
            self._gap_s = (gap if self._gap_s is None
                           else (1 - self.alpha) * self._gap_s
                           + self.alpha * gap)

    def tick(self, n: int = 1) -> None:
        """Per-batch cadence bump; every ``refresh_every``-th walks
        the histograms (racy plain int by design — a lost tick delays
        one refresh, free vs a lock on the commit path)."""
        self._since += n
        if self._since >= self.refresh_every:
            self._since = 0
            self.refresh()

    def refresh(self) -> None:
        """Re-read the per-bucket dispatch histograms into the service
        -time table (one quantile per seen bucket)."""
        from mmlspark_tpu_torch.core.telemetry import quantile_from_buckets
        table: Dict[int, float] = {}
        total = 0
        for bucket, edges, counts in self.stats_fn():
            n = sum(counts)
            if n == 0:
                continue
            total += n
            q = quantile_from_buckets(tuple(edges), list(counts),
                                      self.quantile)
            if q is not None:
                table[int(bucket)] = q
        self.service_ms = table
        self._n_samples = total
        self.n_refreshes += 1

    # -- the decision --------------------------------------------------------

    @property
    def rate_per_s(self) -> Optional[float]:
        gap = self._gap_s
        return (1.0 / gap) if gap and gap > 0 else None

    def _service(self, bucket: int) -> Optional[float]:
        """Service time (ms) for ``bucket``: measured when seen;
        otherwise scaled from the nearest measured bucket (dispatch
        cost grows at most linearly in rows for a compiled shape —
        a conservative fill-in until the bucket is actually
        dispatched)."""
        if bucket in self.service_ms:
            return self.service_ms[bucket]
        if not self.service_ms:
            return None
        near = min(self.service_ms,
                   key=lambda b: abs(math.log(b) - math.log(bucket)))
        return self.service_ms[near] * max(bucket / near, 1.0)

    def decide_wait_ms(self, queued: int) -> Optional[float]:
        """The batch-mate wait for a batch currently holding
        ``queued`` rows; ``None`` = not warmed up, caller falls back
        to the fixed knob. 0.0 = dispatch now."""
        rate = self.rate_per_s
        if rate is None or self._n_samples < self.min_count:
            self.last_wait_ms = None
            return None
        queued = max(int(queued), 1)
        now_bucket = self._bucket_for(queued)
        base_svc = self._service(now_bucket)
        if base_svc is None:
            self.last_wait_ms = None
            return None
        # dispatch-now serves the REAL queued rows (the batch pads to
        # now_bucket regardless) — scoring the padded capacity here
        # would make waiting look never-worth-it at high rates, the
        # exact regime the policy exists for
        best_score = queued / max(base_svc, 1e-6)      # rows/ms, wait 0
        best_wait = 0.0
        for b in self.ladder:
            if b <= queued:
                continue
            wait_ms = (b - queued) / rate * 1000.0
            if wait_ms > self.ceiling_ms:
                break                     # ladder ascends: all later
            svc = self._service(b)        # buckets wait even longer
            if svc is None:
                continue
            score = b / max(wait_ms + svc, 1e-6)
            if score > best_score:
                best_score, best_wait = score, wait_ms
        self.last_wait_ms = round(best_wait, 3)
        return best_wait

    def _bucket_for(self, n: int) -> int:
        for b in self.ladder:
            if b >= n:
                return b
        return self.ladder[-1] if self.ladder else n

    def status(self) -> Dict[str, object]:
        rate = self.rate_per_s
        return {"rate_per_s": round(rate, 3) if rate else None,
                "n_samples": self._n_samples,
                "n_refreshes": self.n_refreshes,
                "service_ms": {str(k): round(v, 4)
                               for k, v in sorted(
                                   self.service_ms.items())},
                "last_wait_ms": self.last_wait_ms,
                "ceiling_ms": self.ceiling_ms}


class SpeculationPolicy:
    """Acceptance-gated speculation: keep speculative decoding on only
    while it pays.

    A speculative round costs one draft propose plus one width-k
    verify; it beats plain stepping only when the target accepts
    enough proposals. A drifting workload (or a draft that never
    agreed — the failure mode of a badly matched model pair) can push
    acceptance below break-even, at which point speculation is
    actively SLOWER than single-token decode. This policy tracks an
    acceptance EWMA fed by the scheduler after every round and turns
    speculation off below ``min_rate``; every ``reprobe_every``-th
    round while off, one PROBE round runs anyway so a workload that
    becomes draft-friendly again is rediscovered — the policy is
    hysteretic, never sticky-dead.

    ``warmup_rounds`` rounds always speculate (the EWMA needs
    evidence before it may veto)."""

    def __init__(self, min_rate: float = 0.3, alpha: float = 0.2,
                 warmup_rounds: int = 8, reprobe_every: int = 32):
        self.min_rate = float(min_rate)
        self.alpha = float(alpha)
        self.warmup_rounds = int(warmup_rounds)
        self.reprobe_every = max(int(reprobe_every), 1)
        self.rate: Optional[float] = None   # acceptance EWMA
        self.n_rounds = 0
        self.n_suppressed = 0
        self._since_probe = 0

    def should_speculate(self) -> bool:
        """Consulted once per scheduler round BEFORE the cohort is
        built; counts suppressed rounds toward the re-probe cadence."""
        if self.n_rounds < self.warmup_rounds or self.rate is None \
                or self.rate >= self.min_rate:
            return True
        self._since_probe += 1
        if self._since_probe >= self.reprobe_every:
            self._since_probe = 0
            return True                     # probe round
        self.n_suppressed += 1
        return False

    def note(self, proposed: int, accepted: int) -> None:
        """Fold one completed round's acceptance into the EWMA."""
        if proposed <= 0:
            return
        self.n_rounds += 1
        r = accepted / proposed
        self.rate = (r if self.rate is None
                     else (1 - self.alpha) * self.rate + self.alpha * r)

    def status(self) -> Dict[str, object]:
        return {"min_rate": self.min_rate,
                "acceptance_ewma": (round(self.rate, 4)
                                    if self.rate is not None else None),
                "n_rounds": self.n_rounds,
                "n_suppressed": self.n_suppressed,
                "speculating": (self.rate is None
                                or self.rate >= self.min_rate
                                or self.n_rounds < self.warmup_rounds)}
