"""Composable resilience primitives: clocks, deadlines, retries and
circuit breakers (the port's copy of ``mmlspark_tpu/core/resilience.py``).

* :class:`RetryPolicy` — exponential backoff with decorrelated jitter,
  bounded by BOTH an attempt budget and an elapsed-time budget, honoring
  server ``Retry-After`` hints.
* :class:`Deadline` — an absolute time budget (the request's budget; the
  decode scheduler reaps a request whose deadline expired).
* :class:`CircuitBreaker` — closed/open/half-open per dependency (host,
  worker), so a dead endpoint sheds load instantly instead of burning a
  full retry schedule per request.

Every time-dependent piece takes an injectable :class:`Clock`, so tests
drive deadline expiry and breaker transitions with a
:class:`ManualClock` instead of sleeping. Retries and breaker
transitions are counted in the port's process-wide ``REGISTRY``.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Any, Callable, Dict, Optional, Tuple

class Clock:
    """Injectable time source: monotonic ``now()`` + ``sleep()``."""

    def now(self) -> float:
        return time.monotonic()

    def sleep(self, seconds: float) -> None:
        if seconds > 0:
            time.sleep(seconds)


class ManualClock(Clock):
    """Deterministic clock for tests: ``sleep`` advances ``now``
    instantly."""

    def __init__(self, start: float = 0.0):
        self._t = float(start)
        self._lock = threading.Lock()

    def now(self) -> float:
        with self._lock:
            return self._t

    def sleep(self, seconds: float) -> None:
        self.advance(seconds)

    def advance(self, seconds: float) -> None:
        with self._lock:
            self._t += max(float(seconds), 0.0)


SYSTEM_CLOCK = Clock()


# ---------------------------------------------------------------------------
# Telemetry hooks (lazy: telemetry imports Clock from this module, so the
# metric families are resolved at first event, never at import time)
# ---------------------------------------------------------------------------

_METRICS: Optional[Dict[str, Any]] = None
_BREAKER_STATE_VALUES = {"closed": 0, "half_open": 1, "open": 2}


def _metrics() -> Dict[str, Any]:
    global _METRICS
    if _METRICS is None:
        from mmlspark_tpu_torch.core.telemetry import BoundedLabelSet, REGISTRY
        _METRICS = {
            # breaker names are per dependency (host, worker url): an
            # unbounded fan-out must not grow the registry forever
            "breaker_labels": BoundedLabelSet(256),
            "retries": REGISTRY.counter(
                "resilience_retries_total",
                "Retry attempts actually scheduled (a backoff sleep was "
                "taken) across every policy-driven caller."),
            "breaker_transitions": REGISTRY.counter(
                "breaker_transitions_total",
                "Circuit-breaker state transitions.",
                labels=("breaker", "to")),
            "breaker_state": REGISTRY.gauge(
                "breaker_state",
                "Current breaker state per dependency: 0 closed, "
                "1 half-open, 2 open.", labels=("breaker",)),
        }
    return _METRICS


def _breaker_event(name: str, to_state: str) -> None:
    """Record a breaker transition (called with the breaker lock held —
    safe: telemetry takes only its own stripe locks and never calls
    back). Telemetry must never break a failure path, hence the guard."""
    try:
        m = _metrics()
        key, overflow = m["breaker_labels"].key(name or "unnamed")
        m["breaker_transitions"].labels(key, to_state).inc()
        # transitions aggregate sensibly under "other"; a shared state
        # gauge does not (last-writer-wins across unrelated breakers
        # would report closed while another overflow breaker is open)
        if not overflow:
            m["breaker_state"].labels(key).set(
                _BREAKER_STATE_VALUES[to_state])
    except Exception:  # noqa: BLE001 — observability is best-effort
        pass


# ---------------------------------------------------------------------------
# Deadlines
# ---------------------------------------------------------------------------

class DeadlineExceeded(Exception):
    """A time budget ran out before the work completed."""


class Deadline:
    """An absolute point in time the work must finish by (the request's
    budget; the scheduler reaps a request whose deadline expired).

    Propagation: :meth:`to_header` encodes the REMAINING budget in
    milliseconds under ``X-Deadline-Ms``; the receiving layer rebuilds an
    absolute deadline against its own clock with :meth:`from_headers`.
    Relative-on-the-wire is deliberate — it needs no cross-host clock
    sync, at the cost of ignoring network transit time (the budget
    restarts on arrival), the same tradeoff gRPC's timeout header makes.
    """

    HEADER = "X-Deadline-Ms"

    def __init__(self, timeout: float, clock: Clock = SYSTEM_CLOCK):
        self.clock = clock
        self._expires = clock.now() + float(timeout)

    @staticmethod
    def from_headers(headers, clock: Clock = SYSTEM_CLOCK
                     ) -> Optional["Deadline"]:
        """Deadline from an ``X-Deadline-Ms`` header, or None without one
        (or with a malformed value — an unparsable budget must not turn
        into an instant 504)."""
        raw = headers.get(Deadline.HEADER) if headers else None
        if raw is None:
            return None
        try:
            return Deadline(float(raw) / 1000.0, clock=clock)
        except (TypeError, ValueError):
            return None

    def remaining(self) -> float:
        return self._expires - self.clock.now()

    @property
    def expired(self) -> bool:
        return self.remaining() <= 0

    def to_header(self) -> str:
        return str(max(int(self.remaining() * 1000), 0))

    def check(self, what: str = "operation") -> None:
        if self.expired:
            raise DeadlineExceeded(
                f"{what} exceeded its deadline by {-self.remaining():.3f}s")


# ---------------------------------------------------------------------------
# Retry policies
# ---------------------------------------------------------------------------

class RetryPolicy:
    """Retry schedule: exponential backoff + decorrelated jitter, bounded
    by attempts AND elapsed time, ``Retry-After`` aware.

    ``delay_{n+1} = min(cap, uniform(base, delay_n * 3))`` — the
    decorrelated-jitter formula, which desynchronizes retry storms from
    many clients while keeping expected growth exponential. The jitter
    stream is seedable for tests (see below). ``backoffs`` takes
    an explicit delay list instead (the legacy fixed-list handlers ride
    this path and gain the budget/deadline bounds for free).

    One policy object is immutable shared config; each logical call gets
    its own :class:`RetrySchedule` via :meth:`schedule`. ``seed=None``
    (the default) draws each schedule's jitter from OS entropy — the
    production mode, where concurrent callers MUST desynchronize; pass
    a seed only when a test needs to pin the exact delay sequence.
    """

    def __init__(self, max_attempts: int = 4, base: float = 0.1,
                 cap: float = 10.0, budget: Optional[float] = None,
                 retry_statuses: Tuple[int, ...] = (429, 500, 502, 503, 504),
                 backoffs: Optional[Tuple[float, ...]] = None,
                 seed: Optional[int] = None, clock: Clock = SYSTEM_CLOCK):
        if backoffs is not None:
            backoffs = tuple(float(b) for b in backoffs)
            max_attempts = len(backoffs) + 1
        self.max_attempts = max(int(max_attempts), 1)
        self.base = float(base)
        self.cap = float(cap)
        self.budget = float(budget) if budget is not None else None
        self.retry_statuses = tuple(retry_statuses)
        self.backoffs = backoffs
        self.seed = seed
        self.clock = clock

    def retryable_status(self, status: int) -> bool:
        """Transport failures land as status 0 and always retry."""
        return status == 0 or status in self.retry_statuses

    def schedule(self, deadline: Optional[Deadline] = None
                 ) -> "RetrySchedule":
        return RetrySchedule(self, deadline)

    def call(self, fn: Callable[[], Any],
             retryable: Callable[[Exception], bool] = lambda e: True,
             deadline: Optional[Deadline] = None) -> Any:
        """Run ``fn`` under this policy, retrying exceptions ``retryable``
        accepts; re-raises the last error when the budget is spent."""
        sched = self.schedule(deadline)
        while True:
            try:
                return fn()
            except Exception as e:  # noqa: BLE001 — classified below
                if not retryable(e) or sched.give_up():
                    raise


class RetrySchedule:
    """Mutable per-call retry state produced by :meth:`RetryPolicy.schedule`."""

    def __init__(self, policy: RetryPolicy, deadline: Optional[Deadline]):
        self.policy = policy
        self.deadline = deadline
        self.attempt = 0          # completed attempts so far
        self._started = policy.clock.now()
        self._delay = policy.base
        self._rng = random.Random(policy.seed)

    def _next_delay(self) -> float:
        if self.policy.backoffs is not None:
            return self.policy.backoffs[self.attempt - 1]
        self._delay = min(self.policy.cap,
                          self._rng.uniform(self.policy.base,
                                            self._delay * 3.0))
        return self._delay

    def give_up(self, retry_after: Optional[float] = None) -> bool:
        """Called after a failed attempt. Returns True when no retry
        budget remains; otherwise sleeps the next backoff (at least
        ``retry_after`` when the server sent one) and returns False."""
        self.attempt += 1
        clock = self.policy.clock
        if self.attempt >= self.policy.max_attempts:
            return True
        wait = self._next_delay()
        if retry_after is not None:
            try:
                wait = max(wait, float(retry_after))
            except (TypeError, ValueError):
                pass
        elapsed = clock.now() - self._started
        if self.policy.budget is not None \
                and elapsed + wait > self.policy.budget:
            return True
        if self.deadline is not None and wait >= self.deadline.remaining():
            return True     # the retry could never finish in time
        try:
            _metrics()["retries"].inc()
        except Exception:  # noqa: BLE001 — observability is best-effort
            pass
        clock.sleep(wait)
        return False


# ---------------------------------------------------------------------------
# Circuit breakers
# ---------------------------------------------------------------------------

class CircuitOpen(Exception):
    """The breaker is open: the dependency is being given time to recover."""


class CircuitBreaker:
    """Closed / open / half-open breaker around one dependency.

    ``failure_threshold`` consecutive failures open the circuit; while
    open, :meth:`allow` refuses instantly (no connect timeouts burned on
    a dead host). After ``reset_timeout`` on the injected clock the
    breaker admits up to ``half_open_max`` concurrent probes: a probe
    success closes the circuit, a probe failure re-opens it and restarts
    the timer. Thread-safe; all transitions are clock-driven, never
    wall-clock-driven, so tests advance a :class:`ManualClock` instead of
    sleeping.
    """

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"

    def __init__(self, failure_threshold: int = 5,
                 reset_timeout: float = 30.0, half_open_max: int = 1,
                 clock: Clock = SYSTEM_CLOCK, name: str = ""):
        self.failure_threshold = max(int(failure_threshold), 1)
        self.reset_timeout = float(reset_timeout)
        self.half_open_max = max(int(half_open_max), 1)
        self.clock = clock
        self.name = name
        self._lock = threading.Lock()
        self._state = self.CLOSED
        self._failures = 0
        self._opened_at = 0.0
        self._probes = 0
        self.n_opened = 0
        self.n_rejected = 0

    @property
    def state(self) -> str:
        with self._lock:
            self._maybe_half_open_locked()
            return self._state

    def _maybe_half_open_locked(self) -> None:
        if self._state == self.OPEN and \
                self.clock.now() - self._opened_at >= self.reset_timeout:
            self._state = self.HALF_OPEN
            self._probes = 0
            _breaker_event(self.name, self.HALF_OPEN)

    def allow(self) -> bool:
        """May a call proceed right now? Half-open admits a bounded
        number of probes (each must be resolved by record_success /
        record_failure)."""
        with self._lock:
            self._maybe_half_open_locked()
            if self._state == self.CLOSED:
                return True
            if self._state == self.HALF_OPEN \
                    and self._probes < self.half_open_max:
                self._probes += 1
                return True
            self.n_rejected += 1
            return False

    def record_success(self) -> None:
        with self._lock:
            was_closed = self._state == self.CLOSED
            self._state = self.CLOSED
            self._failures = 0
            if not was_closed:
                _breaker_event(self.name, self.CLOSED)

    def record_failure(self) -> None:
        with self._lock:
            if self._state == self.HALF_OPEN:
                self._trip_locked()     # failed probe: back to open
                return
            self._failures += 1
            if self._failures >= self.failure_threshold:
                self._trip_locked()

    def _trip_locked(self) -> None:
        if self._state != self.OPEN:
            self.n_opened += 1
            _breaker_event(self.name, self.OPEN)
        self._state = self.OPEN
        self._opened_at = self.clock.now()
        self._failures = 0

    def call(self, fn: Callable[[], Any]) -> Any:
        """Run ``fn`` through the breaker: :class:`CircuitOpen` when
        refused, success/failure recorded from the outcome."""
        if not self.allow():
            raise CircuitOpen(
                f"circuit {self.name or id(self)} is {self._state}")
        try:
            out = fn()
        except Exception:
            self.record_failure()
            raise
        self.record_success()
        return out


class BreakerBoard:
    """Lazily-created :class:`CircuitBreaker` per key (host, worker url).

    The per-host breaker map the HTTP layers share: hundreds of rows
    targeting one dead host trip its breaker once, and every subsequent
    row is refused in microseconds instead of burning a retry schedule.
    """

    def __init__(self, clock: Clock = SYSTEM_CLOCK, **breaker_kwargs):
        self.clock = clock
        self.breaker_kwargs = breaker_kwargs
        self._breakers: Dict[Any, CircuitBreaker] = {}
        self._lock = threading.Lock()

    def get(self, key: Any) -> CircuitBreaker:
        with self._lock:
            br = self._breakers.get(key)
            if br is None:
                br = CircuitBreaker(clock=self.clock, name=str(key),
                                    **self.breaker_kwargs)
                self._breakers[key] = br
            return br

    def states(self) -> Dict[Any, str]:
        with self._lock:
            items = list(self._breakers.items())
        return {k: b.state for k, b in items}

    def reset(self) -> None:
        with self._lock:
            self._breakers.clear()
