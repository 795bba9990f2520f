"""Declarative SLOs + multi-window burn-rate alerting (the port's copy
of ``mmlspark_tpu/serving/slo.py``).

The serving plane's operational contract, stated as data: an
:class:`SLOPolicy` names an objective (availability, or a latency
threshold at a quantile) over metrics that already live in a
:class:`~mmlspark_tpu_torch.core.telemetry.MetricsRegistry`, and the
:class:`SLOEngine` evaluates it with the multi-window burn-rate method
(the SRE-workbook alerting recipe): an alert condition holds only when
BOTH a long and a short window burn error budget faster than the
window pair's threshold — the long window filters blips, the short
window makes the alert resolve promptly once the cause is gone.

Everything here runs OFF the hot path. The engine never instruments
requests; it snapshots counter values and histogram bucket counts when
``evaluate()`` is called (``GET /alerts`` / ``GET /slo``, a scrape of
the firing gauge, or a test driving a ManualClock) and does window
math over the snapshot history. Counter deltas are clamped at zero so
a worker restart's counter reset reads as "no traffic", never negative
traffic (the fleet_stats idiom).

Alert lifecycle is a small state machine::

    ok -> pending --(for_s held)--> firing --(clear held
          resolve_after_s)--> resolved -> pending ...

``for_s`` and ``resolve_after_s`` are the anti-flap hysteresis: a burn
touching the threshold for one evaluation does not fire, and a firing
alert does not resolve until the condition has been clear for the
configured quiet period.

The optional :class:`AlertNotifier` POSTs firing/resolved transitions
to a webhook through the resilient HTTP client with a PRIVATE breaker
board (the MetricsPusher idiom): a dead alert receiver can never open
model-egress breakers, and notification failures are counted, never
raised.
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

from mmlspark_tpu_torch.core.resilience import SYSTEM_CLOCK, Clock
from mmlspark_tpu_torch.core.telemetry import quantile_from_buckets

#: default multi-window burn-rate pairs ``(long_s, short_s,
#: burn_threshold)`` — the SRE-workbook page/ticket pair: 14.4x burn
#: over (5 min, 1 min) exhausts a 30-day budget in ~2 days; 6x over
#: (1 h, 5 min) in ~5 days.
DEFAULT_WINDOWS: Tuple[Tuple[float, float, float], ...] = (
    (300.0, 60.0, 14.4),
    (3600.0, 300.0, 6.0),
)


class SLOPolicy:
    """One declarative objective.

    ``kind="availability"``: ``objective`` is the good-fraction target
    (0.999 = "99.9% of ``total_metric`` must not be ``bad_metric``");
    burn rate = (bad/total over the window) / (1 - objective).

    ``kind="latency"``: ``objective`` is the fraction of observations
    that must land at or under ``threshold_ms`` on the histogram
    ``metric``; burn rate = (fraction over threshold) / (1 -
    objective). ``quantile`` is reported alongside (measured via
    :func:`quantile_from_buckets` over the long-window bucket deltas)
    so an operator sees the actual tail, not just the verdict.

    ``labels`` optionally restricts which children of the metric
    families count (exact-match on a subset of label names) — a
    per-route or per-tenant SLO is the same policy with a filter.
    """

    KINDS = ("availability", "latency")

    def __init__(self, name: str, kind: str, objective: float,
                 total_metric: Optional[str] = None,
                 bad_metric: Optional[str] = None,
                 metric: Optional[str] = None,
                 threshold_ms: Optional[float] = None,
                 quantile: float = 0.95,
                 labels: Optional[Dict[str, str]] = None,
                 windows: Iterable[Tuple[float, float, float]]
                 = DEFAULT_WINDOWS,
                 for_s: float = 0.0,
                 resolve_after_s: float = 60.0):
        if kind not in self.KINDS:
            raise ValueError(f"unknown SLO kind {kind!r} "
                             f"(expected one of {self.KINDS})")
        if not 0.0 < float(objective) < 1.0:
            raise ValueError(
                f"objective must be in (0, 1), got {objective!r}")
        if kind == "availability":
            if not total_metric or not bad_metric:
                raise ValueError("availability SLOs need total_metric "
                                 "and bad_metric counter names")
        else:
            if not metric or threshold_ms is None:
                raise ValueError("latency SLOs need a histogram "
                                 "metric name and threshold_ms")
        self.name = str(name)
        self.kind = kind
        self.objective = float(objective)
        self.total_metric = total_metric
        self.bad_metric = bad_metric
        self.metric = metric
        self.threshold_ms = (float(threshold_ms)
                             if threshold_ms is not None else None)
        self.quantile = float(quantile)
        self.labels = dict(labels or {})
        self.windows = tuple(
            (float(l), float(s), float(t)) for l, s, t in windows)
        if not self.windows or any(
                l <= s for l, s, _ in self.windows):
            raise ValueError(
                "windows must be non-empty (long_s, short_s, "
                f"burn_threshold) triples with long > short, "
                f"got {windows!r}")
        self.for_s = float(for_s)
        self.resolve_after_s = float(resolve_after_s)

    @classmethod
    def from_value(cls, value: Any) -> "SLOPolicy":
        """A policy, a config dict, or a JSON string of one."""
        if isinstance(value, SLOPolicy):
            return value
        if isinstance(value, str):
            value = json.loads(value)
        if not isinstance(value, dict):
            raise ValueError(
                f"cannot build an SLOPolicy from {type(value).__name__}")
        return cls(**value)

    def metrics(self) -> Tuple[str, ...]:
        if self.kind == "availability":
            return (self.total_metric, self.bad_metric)
        return (self.metric,)

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "name": self.name, "kind": self.kind,
            "objective": self.objective,
            "windows": [list(w) for w in self.windows],
            "for_s": self.for_s,
            "resolve_after_s": self.resolve_after_s,
        }
        if self.kind == "availability":
            out["total_metric"] = self.total_metric
            out["bad_metric"] = self.bad_metric
        else:
            out["metric"] = self.metric
            out["threshold_ms"] = self.threshold_ms
            out["quantile"] = self.quantile
        if self.labels:
            out["labels"] = dict(self.labels)
        return out


class _AlertState:
    """The per-policy state machine (engine-lock protected)."""

    __slots__ = ("state", "pending_since", "last_violated", "fired_at",
                 "resolved_at", "n_fired", "n_resolved", "transitions")

    def __init__(self):
        self.state = "ok"
        self.pending_since: Optional[float] = None
        self.last_violated: Optional[float] = None
        self.fired_at: Optional[float] = None
        self.resolved_at: Optional[float] = None
        self.n_fired = 0
        self.n_resolved = 0
        # entries into each state, for the transitions counter view
        self.transitions: Dict[str, int] = {
            "pending": 0, "firing": 0, "resolved": 0}


class AlertNotifier:
    """Webhook delivery for firing/resolved transitions.

    Copies the MetricsPusher wiring exactly: the resilient
    :class:`~mmlspark_tpu_torch.io.http.HTTPClient` with a bounded
    :class:`~mmlspark_tpu_torch.core.resilience.RetryPolicy` and a PRIVATE
    :class:`~mmlspark_tpu_torch.core.resilience.BreakerBoard` — the alert
    receiver's health is isolated from every other egress surface.
    Sends run on a short-lived daemon thread so a transition noticed
    during a metrics scrape never blocks the scrape on the webhook.
    Never raises."""

    def __init__(self, url: str, timeout: float = 5.0,
                 headers: Optional[Dict[str, str]] = None):
        self.url = url
        self.timeout = float(timeout)
        self.headers = dict(headers or {})
        self.n_sent = 0
        self.n_errors = 0
        self.last_status: Optional[int] = None
        self._client = None
        self._lock = threading.Lock()

    def _get_client(self):
        # lazy: io.http is only imported when a transition actually
        # needs delivering (mirrors MetricsPusher._get_client)
        if self._client is None:
            from mmlspark_tpu_torch.core.resilience import (
                BreakerBoard, RetryPolicy,
            )
            from mmlspark_tpu_torch.io.http import HTTPClient
            self._client = HTTPClient(
                timeout=self.timeout,
                policy=RetryPolicy(max_attempts=3, base=0.2, cap=2.0),
                breakers=BreakerBoard(failure_threshold=5,
                                      reset_timeout=30.0))
        return self._client

    def notify(self, event: Dict[str, Any]) -> None:
        """Fire-and-forget delivery of one transition event."""
        threading.Thread(target=self._send, args=(event,),
                         daemon=True, name="slo-notify").start()

    def _send(self, event: Dict[str, Any]) -> None:
        try:
            from mmlspark_tpu_torch.core.telemetry import trace_context
            from mmlspark_tpu_torch.io.http import HTTPRequestData
            h = {"Content-Type": "application/json"}
            h.update(self.headers)
            req = HTTPRequestData(url=self.url, method="POST",
                                  headers=h,
                                  body=json.dumps(event).encode())
            # fresh trace id, no ambient span: a flaky receiver must
            # not churn the trace store every transition
            with trace_context():
                resp = self._get_client().send([req])[0]
            with self._lock:
                self.last_status = (resp.status_code
                                    if resp is not None else None)
                if resp is not None and 200 <= resp.status_code < 300:
                    self.n_sent += 1
                else:
                    self.n_errors += 1
        except Exception:  # noqa: BLE001 — alerting must never raise
            with self._lock:
                self.n_errors += 1
            from mmlspark_tpu_torch.core.logs import get_logger
            get_logger("slo").warning(
                "alert webhook %s failed", self.url, exc_info=True)

    def status(self) -> Dict[str, Any]:
        with self._lock:
            return {"url": self.url, "n_sent": self.n_sent,
                    "n_errors": self.n_errors,
                    "last_status": self.last_status}


class SLOEngine:
    """Burn-rate evaluation over a registry's counter/histogram state.

    ``evaluate()`` takes one snapshot of every policy-referenced
    family, appends it to a bounded history, and computes each
    policy's per-window burn rates from clamped deltas — then advances
    the alert state machines and (optionally) notifies transitions.
    Call it from ``GET /alerts`` / ``GET /slo`` handlers or a test
    loop; nothing here touches the request hot path.

    ``max_samples`` bounds history memory; when the ring is full the
    oldest snapshots drop and the long window degrades gracefully to
    "since the oldest retained sample" (reported as the effective
    window)."""

    def __init__(self, registry, policies: Iterable[SLOPolicy],
                 clock: Clock = SYSTEM_CLOCK,
                 notifier: Optional[AlertNotifier] = None,
                 max_samples: int = 4096,
                 min_eval_interval_s: float = 0.0):
        self.registry = registry
        self.policies: List[SLOPolicy] = [
            SLOPolicy.from_value(p) for p in policies]
        names = [p.name for p in self.policies]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate policy names in {names}")
        self.clock = clock
        self.notifier = notifier
        self._wanted = {m for p in self.policies for m in p.metrics()}
        self._history: "deque[Tuple[float, dict]]" = deque(
            maxlen=max(int(max_samples), 2))
        self._alerts: Dict[str, _AlertState] = {
            p.name: _AlertState() for p in self.policies}
        self._lock = threading.Lock()
        self._last_report: Optional[Dict[str, Any]] = None
        self._last_eval: Optional[float] = None
        self.n_evaluations = 0
        self.min_eval_interval_s = float(min_eval_interval_s)

    # -- snapshotting ---------------------------------------------------------

    def _collect(self) -> dict:
        """One snapshot of every policy-referenced family:
        ``{metric: (kind, edges, label_names, {label_key: value})}``
        where value is a float (counter/gauge) or a per-bucket count
        list (histogram)."""
        snap: dict = {}
        for fam in self.registry.families():
            if fam.name not in self._wanted:
                continue
            if fam.kind == "histogram":
                snap[fam.name] = (
                    "h", fam.buckets, fam.label_names,
                    {key: list(child.stats()["buckets"])
                     for key, child in fam.children()})
            else:
                snap[fam.name] = (
                    "c", None, fam.label_names,
                    {key: float(child.value)
                     for key, child in fam.children()})
        return snap

    def _baseline(self, now: float, window_s: float
                  ) -> Optional[Tuple[float, dict]]:
        """The OLDEST snapshot inside the window (first sample at or
        after ``now - window_s``, current sample excluded) — the
        window never stretches over older traffic, so a fresh error
        burst cannot be diluted by healthy history from before the
        window. Falls back to the newest sample before the window
        when an evaluation gap left none inside it (honest partial
        coverage); None when the current sample is the only one."""
        if len(self._history) < 2:
            return None
        target = now - window_s
        newest_before = None
        for t, snap in list(self._history)[:-1]:
            if t >= target:
                return (t, snap)
            newest_before = (t, snap)
        return newest_before

    @staticmethod
    def _match(policy_labels: Dict[str, str],
               label_names: Tuple[str, ...],
               key: Tuple[str, ...]) -> bool:
        if not policy_labels:
            return True
        have = dict(zip(label_names, key))
        return all(have.get(k) == v for k, v in policy_labels.items())

    def _deltas(self, metric: str, cur: dict, base: dict,
                labels: Dict[str, str]):
        """Per-child clamped deltas for one metric between two
        snapshots: ``(edges_or_None, {label_key: delta})`` where delta
        is a float or a per-bucket list. Missing metric -> empty."""
        cur_e = cur.get(metric)
        if cur_e is None:
            return None, {}
        kind, edges, label_names, cur_children = cur_e
        base_children = (base.get(metric) or (None, None, None, {}))[3]
        out: Dict[Tuple[str, ...], Any] = {}
        for key, val in cur_children.items():
            if not self._match(labels, label_names, key):
                continue
            prev = base_children.get(key)
            if kind == "h":
                if prev is None or len(prev) != len(val):
                    prev = [0] * len(val)
                # Prometheus reset semantics per bucket: a count below
                # its baseline means the worker restarted — the delta
                # is the post-reset count, never negative
                out[key] = [c - p if c >= p else c
                            for c, p in zip(val, prev)]
            else:
                prev_v = prev if prev is not None else 0.0
                out[key] = (val - prev_v if val >= prev_v
                            else max(val, 0.0))
        return edges, out

    # -- burn math ------------------------------------------------------------

    def _availability_burn(self, policy: SLOPolicy, cur: dict,
                           base: dict) -> Tuple[float, float, float,
                                                Dict[Tuple[str, ...],
                                                     float]]:
        """``(burn, bad, total, per_child_bad)`` over one window."""
        _, bad_d = self._deltas(policy.bad_metric, cur, base,
                                policy.labels)
        _, tot_d = self._deltas(policy.total_metric, cur, base,
                                policy.labels)
        bad = float(sum(bad_d.values()))
        total = float(sum(tot_d.values()))
        rate = bad / total if total > 0 else 0.0
        return rate / (1.0 - policy.objective), bad, total, bad_d

    def _latency_burn(self, policy: SLOPolicy, cur: dict, base: dict
                      ) -> Tuple[float, float, float,
                                 Optional[Tuple[tuple, List[int]]]]:
        """``(burn, over, total, (edges, summed_deltas))``."""
        edges, deltas = self._deltas(policy.metric, cur, base,
                                     policy.labels)
        if edges is None or not deltas:
            return 0.0, 0.0, 0.0, None
        summed = [0] * (len(edges) + 1)
        for counts in deltas.values():
            for i, c in enumerate(counts):
                summed[i] += c
        total = float(sum(summed))
        if total <= 0:
            return 0.0, 0.0, 0.0, (edges, summed)
        # observations in buckets whose upper edge is <= threshold are
        # good; the first edge >= threshold is the boundary (ladder
        # edges rarely equal the threshold exactly — the honest
        # reading is "at most this many were over")
        good = 0.0
        for i, edge in enumerate(edges):
            if edge <= policy.threshold_ms:
                good += summed[i]
            else:
                break
        over = total - good
        burn = (over / total) / (1.0 - policy.objective)
        return burn, over, total, (edges, summed)

    # -- evaluation -----------------------------------------------------------

    def maybe_evaluate(self) -> None:
        """Opportunistic evaluation for scrape-time freshness: skips
        when another thread is evaluating or the min interval has not
        elapsed. Never blocks."""
        if not self._lock.acquire(blocking=False):
            return
        try:
            now = self.clock.now()
            if self._last_eval is not None and \
                    now - self._last_eval < max(
                        self.min_eval_interval_s, 1.0):
                return
            self._evaluate_locked(now)
        finally:
            self._lock.release()

    def evaluate(self, now: Optional[float] = None) -> Dict[str, Any]:
        """One full evaluation pass; returns the burn report and
        advances alert states."""
        with self._lock:
            return self._evaluate_locked(
                self.clock.now() if now is None else float(now))

    def observe(self, now: float, snap: dict) -> Dict[str, Any]:
        """Evaluate against an externally-collected snapshot (the
        TSDB Recorder's unified scrape — see
        :meth:`mmlspark_tpu_torch.core.tsdb.Scrape.slo_snapshot`), so one
        scrape per interval feeds the dumper, the TSDB, AND this
        engine's history instead of each taking its own."""
        with self._lock:
            return self._evaluate_locked(float(now), snap)

    def wanted_metrics(self) -> set:
        """The metric names the policies reference — what an external
        snapshot must cover."""
        return set(self._wanted)

    def _evaluate_locked(self, now: float,
                         snap: Optional[dict] = None) -> Dict[str, Any]:
        if snap is None:
            snap = self._collect()
        if self._history and self._history[-1][0] >= now:
            # same (or rewound) instant: replace rather than duplicate
            self._history.pop()
        self._history.append((now, snap))
        # prune beyond the widest long window (plus slack for the
        # baseline just outside it)
        horizon = now - 2.0 * max(
            l for p in self.policies for l, _, _ in p.windows)
        while len(self._history) > 2 and self._history[1][0] <= horizon:
            self._history.popleft()
        transitions: List[Dict[str, Any]] = []
        report_policies = []
        for policy in self.policies:
            rep = self._evaluate_policy(policy, now, snap)
            self._advance_alert(policy, rep, now, transitions)
            alert = self._alerts[policy.name]
            rep["state"] = alert.state
            rep["fired_at"] = alert.fired_at
            rep["resolved_at"] = alert.resolved_at
            rep["n_fired"] = alert.n_fired
            report_policies.append(rep)
        self._last_eval = now
        self.n_evaluations += 1
        report = {
            "at": now,
            "n_evaluations": self.n_evaluations,
            "n_samples": len(self._history),
            "policies": report_policies,
            "firing": sum(1 for r in report_policies
                          if r["state"] == "firing"),
        }
        self._last_report = report
        if self.notifier is not None:
            for ev in transitions:
                self.notifier.notify(ev)
        return report

    def _evaluate_policy(self, policy: SLOPolicy, now: float,
                         snap: dict) -> Dict[str, Any]:
        windows = []
        violated = False
        long_detail: Dict[str, Any] = {}
        for long_s, short_s, threshold in policy.windows:
            row: Dict[str, Any] = {"long_s": long_s, "short_s": short_s,
                                   "burn_threshold": threshold}
            burns = {}
            for tag, win in (("long", long_s), ("short", short_s)):
                base = self._baseline(now, win)
                if base is None:
                    burns[tag] = 0.0
                    row[f"burn_{tag}"] = 0.0
                    row[f"window_{tag}_s"] = 0.0
                    continue
                b_t, b_snap = base
                row[f"window_{tag}_s"] = round(now - b_t, 3)
                if policy.kind == "availability":
                    burn, bad, total, bad_children = \
                        self._availability_burn(policy, snap, b_snap)
                    if tag == "long" and not long_detail:
                        long_detail = {"bad": bad, "total": total,
                                       "error_rate": round(
                                           bad / total, 6)
                                       if total > 0 else 0.0,
                                       "_bad_children": bad_children}
                else:
                    burn, over, total, hist = \
                        self._latency_burn(policy, snap, b_snap)
                    if tag == "long" and not long_detail:
                        long_detail = {"over_threshold": over,
                                       "total": total}
                        if hist is not None:
                            edges, counts = hist
                            q = quantile_from_buckets(
                                edges, counts, policy.quantile)
                            long_detail["measured_ms"] = (
                                round(q, 3) if q is not None else None)
                burns[tag] = burn
                row[f"burn_{tag}"] = round(burn, 4)
            row["violated"] = (burns.get("long", 0.0) >= threshold
                               and burns.get("short", 0.0) >= threshold)
            violated = violated or row["violated"]
            windows.append(row)
        rep: Dict[str, Any] = {
            "policy": policy.name, "kind": policy.kind,
            "objective": policy.objective,
            "windows": windows, "violated": violated,
        }
        if policy.kind == "latency":
            rep["threshold_ms"] = policy.threshold_ms
            rep["quantile"] = policy.quantile
        if policy.labels:
            rep["labels"] = dict(policy.labels)
        bad_children = long_detail.pop("_bad_children", None)
        rep.update(long_detail)
        if policy.kind == "availability" and bad_children:
            # per-child attribution over the first long window: who is
            # actually burning budget (the coordinator's per-worker
            # labels land here)
            fam = snap.get(policy.bad_metric)
            label_names = fam[2] if fam is not None else ()
            rows = sorted(
                ((key, delta) for key, delta in bad_children.items()
                 if delta > 0),
                key=lambda kv: -kv[1])[:8]
            rep["attribution"] = [
                {"labels": dict(zip(label_names, key)),
                 "bad": delta} for key, delta in rows]
        return rep

    def _advance_alert(self, policy: SLOPolicy, rep: Dict[str, Any],
                       now: float,
                       transitions: List[Dict[str, Any]]) -> None:
        alert = self._alerts[policy.name]
        violated = rep["violated"]
        if violated:
            alert.last_violated = now
            if alert.state in ("ok", "resolved"):
                alert.state = "pending"
                alert.pending_since = now
                alert.transitions["pending"] += 1
            if alert.state == "pending" and \
                    now - (alert.pending_since or now) >= policy.for_s:
                alert.state = "firing"
                alert.fired_at = now
                alert.n_fired += 1
                alert.transitions["firing"] += 1
                transitions.append(self._event("firing", policy, rep,
                                               now))
        else:
            if alert.state == "pending":
                # never fired: fold straight back to ok, no event
                alert.state = "ok"
                alert.pending_since = None
            elif alert.state == "firing":
                # the quiet clock counts from the LAST violated
                # evaluation — a re-violation mid-quiet resets it
                ref = alert.last_violated if alert.last_violated \
                    is not None else (alert.fired_at or now)
                if now - ref >= policy.resolve_after_s:
                    alert.state = "resolved"
                    alert.resolved_at = now
                    alert.n_resolved += 1
                    alert.transitions["resolved"] += 1
                    transitions.append(self._event("resolved", policy,
                                                   rep, now))

    @staticmethod
    def _event(kind: str, policy: SLOPolicy, rep: Dict[str, Any],
               now: float) -> Dict[str, Any]:
        return {"type": kind, "policy": policy.name,
                "slo_kind": policy.kind,
                "objective": policy.objective,
                "at_mono": now, "at_unix": time.time(),
                "report": {k: v for k, v in rep.items()
                           if k != "attribution"},
                "attribution": rep.get("attribution")}

    # -- views ----------------------------------------------------------------

    def alerts(self) -> Dict[str, Any]:
        """Evaluate, then return the compact alert view (state + the
        violating window pair per policy) — the ``GET /alerts``
        body."""
        report = self.evaluate()
        alerts = []
        for rep in report["policies"]:
            if rep["state"] == "ok" and not rep["violated"]:
                continue
            alerts.append({
                "policy": rep["policy"], "kind": rep["kind"],
                "state": rep["state"],
                "objective": rep["objective"],
                "violated": rep["violated"],
                "windows": [w for w in rep["windows"]
                            if w["violated"]] or rep["windows"],
                "fired_at": rep.get("fired_at"),
                "resolved_at": rep.get("resolved_at"),
                "n_fired": rep.get("n_fired", 0),
                "attribution": rep.get("attribution"),
            })
        return {"at": report["at"], "firing": report["firing"],
                "alerts": alerts}

    def firing(self) -> List[str]:
        with self._lock:
            return [name for name, a in self._alerts.items()
                    if a.state == "firing"]

    def status(self) -> Dict[str, Any]:
        """Compact engine state for ``/stats`` echo — last evaluation
        summary, no fresh evaluation."""
        with self._lock:
            return {
                "n_policies": len(self.policies),
                "policies": {p.name: self._alerts[p.name].state
                             for p in self.policies},
                "firing": [n for n, a in self._alerts.items()
                           if a.state == "firing"],
                "n_evaluations": self.n_evaluations,
                "n_samples": len(self._history),
                "last_eval": self._last_eval,
                "notifier": (self.notifier.status()
                             if self.notifier is not None else None),
            }

    def register_metrics(self, m) -> None:
        """Firing gauges + transition counters as exposition-time
        views (the serving counter idiom). The gauge's view runs
        :meth:`maybe_evaluate` first so an external scraper sees
        current state without anything else polling ``/alerts``."""
        g = m.gauge("serving_slo_alerts_firing",
                    "1 while the policy's alert is firing.",
                    labels=("policy",))
        c = m.counter("serving_slo_transitions_total",
                      "Alert state-machine entries, by policy and "
                      "destination state.", labels=("policy", "state"))
        first = True
        for policy in self.policies:
            alert = self._alerts[policy.name]
            if first:
                # one child refreshes state per scrape; the rest read
                first = False

                def _firing_fresh(a=alert):
                    self.maybe_evaluate()
                    return 1.0 if a.state == "firing" else 0.0

                g.labels(policy.name).set_function(_firing_fresh)
            else:
                g.labels(policy.name).set_function(
                    lambda a=alert: 1.0 if a.state == "firing" else 0.0)
            for state in ("pending", "firing", "resolved"):
                c.labels(policy.name, state).set_function(
                    lambda a=alert, s=state: a.transitions[s])


# -- stock policy sets --------------------------------------------------------

def default_worker_policies(
        has_decoder: bool = False,
        windows: Iterable[Tuple[float, float, float]] = DEFAULT_WINDOWS,
        for_s: float = 0.0,
        resolve_after_s: float = 60.0) -> List[SLOPolicy]:
    """The stock per-worker objectives: request availability, dispatch
    latency, and (decode planes) TTFT/TPOT. Thresholds are deliberately
    loose — they are the "is it on fire" layer, not a tuning tool;
    operators override via ``ServingServer(slo=[...])``."""
    kw = dict(windows=windows, for_s=for_s,
              resolve_after_s=resolve_after_s)
    policies = [
        SLOPolicy("availability", "availability", 0.999,
                  total_metric="serving_requests_total",
                  bad_metric="serving_errors_total", **kw),
        SLOPolicy("dispatch_latency", "latency", 0.99,
                  metric="serving_dispatch_latency_ms",
                  threshold_ms=1000.0, quantile=0.95, **kw),
    ]
    if has_decoder:
        policies.append(SLOPolicy(
            "decode_ttft", "latency", 0.99,
            metric="serving_decode_ttft_ms",
            threshold_ms=2500.0, quantile=0.95, **kw))
        policies.append(SLOPolicy(
            "decode_tpot", "latency", 0.99,
            metric="serving_decode_tpot_ms",
            threshold_ms=250.0, quantile=0.95, **kw))
    return policies


def resolve_policies(value: Any,
                     has_decoder: bool = False) -> List[SLOPolicy]:
    """The ``ServingServer(slo=...)`` surface: None -> the stock set;
    a list -> explicit policies (dicts or :class:`SLOPolicy`); a dict
    -> the stock set with ``windows``/``for_s``/``resolve_after_s``
    overridden (plus an optional ``"policies"`` list replacing the
    stock set outright)."""
    if value is None:
        return default_worker_policies(has_decoder)
    if isinstance(value, dict):
        if "policies" in value:
            return [SLOPolicy.from_value(p) for p in value["policies"]]
        kw: Dict[str, Any] = {"has_decoder": has_decoder}
        for k in ("windows", "for_s", "resolve_after_s"):
            if k in value:
                kw[k] = value[k]
        return default_worker_policies(**kw)
    return [SLOPolicy.from_value(p) for p in value]
