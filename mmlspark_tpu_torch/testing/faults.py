"""Seeded, deterministic fault injection for chaos tests (the port of
``mmlspark_tpu/testing/faults.py``).

None of the resilience behaviors (:mod:`mmlspark_tpu_torch.core.resilience`)
can be *proven* without a way to make the stack fail on demand, the same
way every time. A :class:`FaultPlan` is that instrument: a per-site
schedule of injected faults, either scripted exactly (``["drop", "503",
"ok"]``) or drawn from seeded probabilities — both fully reproducible,
so a chaos test that passes once passes always.

Wrappers put the plan in front of each layer's failure surface:

* :class:`FaultySession` — a ``requests.Session``-compatible shim for
  the HTTP handlers (:mod:`mmlspark_tpu_torch.io.http`): connection drops,
  resets, injected 5xx/429 replies, slow responses.
* :class:`FaultyModel` — wraps a serving model's ``transform`` so batch
  inference fails or stalls on schedule
  (:class:`mmlspark_tpu_torch.serving.ServingServer`).
* :class:`FaultyCheckpointManager` — wraps a checkpoint manager so
  checkpoint writes fail on schedule.
* :meth:`FaultPlan.step_fault` — a trainer hook that raises at chosen
  global steps, driving ``NNLearner``'s bounded-restart fit loop.

Process-kill schedules are for multi-process harnesses
(``tools/chaos_serving.py``): the plan only *decides* when to kill; the
harness owns the actual signal.

Rollout fault points: a
:class:`~mmlspark_tpu_torch.serving.rollout.ModelVersionManager` constructed
with ``fault_plan=`` consults the sites ``rollout_load``,
``rollout_verify``, ``rollout_warmup``, and ``rollout_flip`` (via
:meth:`FaultPlan.raise_at`), so chaos tests can fail a hot-swap at any
stage of the load -> verify -> warmup -> flip machine and prove the
active version keeps serving.
"""

from __future__ import annotations

import random
import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

from mmlspark_tpu_torch.core.resilience import Clock, SYSTEM_CLOCK

#: Fault kinds a plan can schedule. ``ok`` passes through; ``drop``
#: raises ConnectionError (connect refused), ``reset`` raises
#: ConnectionResetError (mid-reply), ``status`` injects an HTTP error
#: reply, ``delay`` sleeps the injected clock then passes through,
#: ``fail`` raises InjectedFault (model / checkpoint / train-step
#: faults), ``kill`` tells a process harness to kill the target.
KINDS = ("ok", "drop", "reset", "status", "delay", "fail", "kill")


class InjectedFault(RuntimeError):
    """An error raised on purpose by a fault plan."""


@dataclass(frozen=True)
class Fault:
    kind: str = "ok"
    status: int = 503
    delay: float = 0.0
    retry_after: Optional[float] = None

    @staticmethod
    def parse(spec: Union[str, "Fault"]) -> "Fault":
        """Shorthand: ``"ok"``/``"drop"``/``"reset"``/``"fail"``/
        ``"kill"``, a status code (``"503"``), or ``"delay:0.25"``."""
        if isinstance(spec, Fault):
            return spec
        s = str(spec)
        if s.isdigit():
            return Fault(kind="status", status=int(s))
        if s.startswith("delay:"):
            return Fault(kind="delay", delay=float(s.split(":", 1)[1]))
        if s not in KINDS:
            raise ValueError(f"unknown fault spec {spec!r}; have {KINDS} "
                             f"or a status code or 'delay:<s>'")
        return Fault(kind=s)


class FaultPlan:
    """A deterministic per-site schedule of faults.

    ``script`` sites replay an exact sequence then return ``ok`` forever:

        plan = FaultPlan(script={"http": ["drop", "503", "ok"],
                                 "model": ["fail"]})

    ``rates`` sites draw from seeded probabilities (one shared
    ``random.Random(seed)`` stream, consumed in call order — the same
    seed and call order reproduce the same faults):

        plan = FaultPlan(seed=7, rates={"http": {"drop": 0.1,
                                                 "status": 0.05}})

    Every injected fault is counted in :attr:`injected` (site ->
    kind -> count) so tests and the chaos tool can assert/report what
    actually fired. Thread-safe: serving handlers hit plans from many
    threads.
    """

    def __init__(self, script: Optional[Dict[str, Sequence]] = None,
                 rates: Optional[Dict[str, Dict[str, float]]] = None,
                 seed: int = 0, status: int = 503,
                 delay: float = 0.05):
        self._scripts = {site: [Fault.parse(s) for s in seq]
                         for site, seq in (script or {}).items()}
        self._cursor: Dict[str, int] = {s: 0 for s in self._scripts}
        self._rates = {site: dict(r) for site, r in (rates or {}).items()}
        self._rng = random.Random(seed)
        self.seed = seed
        self._status = int(status)
        self._delay = float(delay)
        self._lock = threading.Lock()
        self.injected: Dict[str, Dict[str, int]] = {}
        self.n_calls: Dict[str, int] = {}

    def at(self, site: str) -> Fault:
        """The next fault for ``site`` (``ok`` when nothing is scheduled)."""
        with self._lock:
            self.n_calls[site] = self.n_calls.get(site, 0) + 1
            fault = Fault()
            if site in self._scripts:
                i = self._cursor[site]
                if i < len(self._scripts[site]):
                    fault = self._scripts[site][i]
                    self._cursor[site] = i + 1
            elif site in self._rates:
                # one draw per configured kind, in sorted-kind order, so
                # the consumed stream is independent of dict ordering
                for kind in sorted(self._rates[site]):
                    if self._rng.random() < self._rates[site][kind]:
                        fault = Fault(kind=kind, status=self._status,
                                      delay=self._delay)
                        break
            if fault.kind != "ok":
                per_site = self.injected.setdefault(site, {})
                per_site[fault.kind] = per_site.get(fault.kind, 0) + 1
            return fault

    def raise_at(self, site: str, clock: Clock = SYSTEM_CLOCK) -> None:
        """Consume one fault for ``site`` and raise/sleep accordingly —
        the one-liner for wrapping non-HTTP call sites."""
        f = self.at(site)
        if f.kind == "delay":
            clock.sleep(f.delay)
        elif f.kind == "drop":
            raise ConnectionError(f"injected connection drop at {site!r}")
        elif f.kind == "reset":
            raise ConnectionResetError(f"injected reset at {site!r}")
        elif f.kind in ("fail", "status", "kill"):
            raise InjectedFault(f"injected {f.kind} at {site!r}")

    def step_fault(self, site: str = "train_step"
                   ) -> Callable[[int], None]:
        """A trainer ``fault_injector`` hook bound to one plan site."""
        def hook(global_step: int) -> None:
            self.raise_at(site)
        return hook

    def summary(self) -> Dict[str, Any]:
        with self._lock:
            return {"seed": self.seed, "calls": dict(self.n_calls),
                    "injected": {s: dict(k)
                                 for s, k in self.injected.items()}}


# ---------------------------------------------------------------------------
# HTTP session wrapper
# ---------------------------------------------------------------------------

@dataclass
class CannedResponse:
    """The minimal response surface the HTTP handlers read."""

    status_code: int = 200
    reason: str = "OK"
    content: bytes = b"{}"
    headers: Dict[str, str] = field(default_factory=dict)


class FaultySession:
    """``requests.Session``-compatible wrapper that injects faults.

    ``inner`` is the real session to delegate clean calls to; with
    ``inner=None`` clean calls return a canned 200 (handler unit tests
    then need no sockets at all). Injected ``status`` faults return a
    synthetic reply carrying ``Retry-After`` when the fault specifies
    one; ``delay`` sleeps the injected clock before delegating, so slow
    handlers cost nothing under a :class:`ManualClock`.
    """

    def __init__(self, inner: Any = None, plan: Optional[FaultPlan] = None,
                 site: str = "http", clock: Clock = SYSTEM_CLOCK,
                 canned: Optional[CannedResponse] = None):
        self.inner = inner
        self.plan = plan or FaultPlan()
        self.site = site
        self.clock = clock
        self.canned = canned or CannedResponse()
        self.n_sent = 0

    def request(self, method, url, headers=None, data=None, timeout=None):
        f = self.plan.at(self.site)
        if f.kind == "delay":
            self.clock.sleep(f.delay)
        elif f.kind == "drop":
            raise ConnectionError(f"injected connection drop for {url}")
        elif f.kind == "reset":
            raise ConnectionResetError(f"injected reset for {url}")
        elif f.kind in ("status", "fail", "kill"):
            hdrs = {} if f.retry_after is None \
                else {"Retry-After": str(f.retry_after)}
            return CannedResponse(status_code=f.status,
                                  reason=f"injected {f.status}",
                                  content=b"", headers=hdrs)
        self.n_sent += 1
        if self.inner is None:
            return self.canned
        return self.inner.request(method, url, headers=headers, data=data,
                                  timeout=timeout)

    def close(self):
        if self.inner is not None:
            self.inner.close()


# ---------------------------------------------------------------------------
# Serving-model wrapper
# ---------------------------------------------------------------------------

class FaultyModel:
    """Wraps any Transformer-shaped model for serving chaos tests:
    ``transform`` consults the plan before delegating, so whole batches
    fail (-> 500s, never journaled) or stall on schedule. Duck-typed on
    purpose — serving only calls ``transform``; this wrapper is test
    instrumentation, not a persistable stage."""

    def __init__(self, inner: Any, plan: FaultPlan, site: str = "model",
                 clock: Clock = SYSTEM_CLOCK):
        self.inner = inner
        self.plan = plan
        self.site = site
        self.clock = clock
        self.n_transforms = 0

    def transform(self, df):
        self.plan.raise_at(self.site, clock=self.clock)
        self.n_transforms += 1
        return self.inner.transform(df)


# ---------------------------------------------------------------------------
# Checkpoint-write wrapper
# ---------------------------------------------------------------------------

class FaultyCheckpointManager:
    """Wraps a checkpoint manager so ``save`` fails on schedule;
    everything else proxies through. A failed save surfaces in the
    trainer as a step fault (the restart path restores the previous
    good checkpoint)."""

    def __init__(self, inner: Any, plan: FaultPlan,
                 site: str = "checkpoint"):
        self._inner = inner
        self._plan = plan
        self._site = site

    def save(self, *args, **kwargs):
        self._plan.raise_at(self._site)
        return self._inner.save(*args, **kwargs)

    def __getattr__(self, name):
        return getattr(self._inner, name)
