"""Tenant isolation & overload control for the serving plane (the
port's copy of ``mmlspark_tpu/serving/tenancy.py``).

Every request that reaches a :class:`~mmlspark_tpu_torch.serving.server.
ServingServer` carries (or fails to carry) an API key; this module
turns that key into a *tenant* with a priority class, rate and
concurrency quotas, a fair-share weight, and a prefix-cache page
budget — so one tenant's flood degrades only that tenant's
throughput, never the fleet's.

The subsystem is deliberately host-side-only bookkeeping: admission,
shedding, and fair-share ordering all happen before a request joins a
batch, so tenancy never changes dispatch shapes and stays off the
compiled path (the ``tenant_isolation_v1`` bench gate asserts zero
post-warmup recompiles with tenancy enabled).

Pieces
------
``extract_api_key``
    ``X-Api-Key`` header, else ``Authorization: Bearer <token>`` —
    identical on both frontends (the threaded ``http.server`` handler
    and the event-loop edge both expose case-insensitive ``.get``).
``Tenant`` / ``TenantRegistry``
    Static key → tenant mapping, loadable from JSON (inline dict, file
    path, or the ``MMLSPARK_TENANTS`` env var) with an
    ``unknown_key_policy`` of ``"reject"`` (401 on missing/unknown
    keys) or ``"anonymous"`` (map them to the anonymous tenant).
``TokenBucket``
    Injectable-clock token bucket; ``retry_after()`` computes the
    HONEST wait until the next token from refill math, which is what
    quota 429s carry instead of the fixed ``shed_retry_after``.
``FairCycle``
    Deficit-weighted round-robin chooser used for both decode slot
    claims and collector batch assembly: each present tenant accrues
    its weight per round, the largest deficit wins and pays the round
    total, so any tenant with positive weight is served within a
    bounded number of rounds (the bounded-starvation proof test).
``ReleaseRateEwma``
    EWMA over decode slot-release gaps → honest ``Retry-After`` for
    decode 429s; returns ``None`` while cold or stale so callers fall
    back to the constant.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from mmlspark_tpu_torch.core.resilience import SYSTEM_CLOCK, Clock
from mmlspark_tpu_torch.serving.policy import PRIORITY_CLASSES, PriorityShedPolicy

ENV_VAR = "MMLSPARK_TENANTS"
ANONYMOUS_ID = "anonymous"


def extract_api_key(headers) -> Optional[str]:
    """Pull the API key out of a request's headers.

    ``X-Api-Key`` wins; otherwise an ``Authorization: Bearer <token>``
    credential is accepted. Works against anything with a
    case-insensitive ``.get`` (``email.message.Message`` on the
    threaded frontend, :class:`~mmlspark_tpu_torch.serving.frontend.Headers`
    on the event-loop one). Returns ``None`` when no credential is
    present."""
    if headers is None:
        return None
    key = headers.get("X-Api-Key")
    if key:
        key = key.strip()
        if key:
            return key
    auth = headers.get("Authorization")
    if auth:
        parts = auth.split(None, 1)
        if len(parts) == 2 and parts[0].lower() == "bearer":
            token = parts[1].strip()
            if token:
                return token
    return None


class TokenBucket:
    """Classic token bucket with an injectable clock.

    ``rate_per_s <= 0`` (or ``None``) means unlimited — every acquire
    succeeds. ``retry_after`` answers "how long until ``n`` tokens
    exist?" from the refill math, so a 429 can carry an honest wait
    instead of a guess."""

    def __init__(self, rate_per_s: Optional[float],
                 burst: Optional[float] = None,
                 clock: Clock = SYSTEM_CLOCK):
        self.rate = float(rate_per_s) if rate_per_s else 0.0
        # default burst: one second's worth of tokens, never below 1
        self.burst = float(burst) if burst is not None \
            else max(self.rate, 1.0)
        self.clock = clock
        self._tokens = self.burst
        self._last = clock.now()
        self._lock = threading.Lock()

    @property
    def unlimited(self) -> bool:
        return self.rate <= 0.0

    def _refill_locked(self, now: float) -> None:
        dt = now - self._last
        self._last = now
        if dt > 0:
            self._tokens = min(self.burst, self._tokens + dt * self.rate)

    def try_acquire(self, n: float = 1.0) -> bool:
        if self.unlimited:
            return True
        with self._lock:
            self._refill_locked(self.clock.now())
            if self._tokens >= n:
                self._tokens -= n
                return True
            return False

    def retry_after(self, n: float = 1.0) -> float:
        """Seconds until ``n`` tokens will be available (0.0 if they
        already are)."""
        if self.unlimited:
            return 0.0
        with self._lock:
            self._refill_locked(self.clock.now())
            short = n - self._tokens
            if short <= 0:
                return 0.0
            return short / self.rate

    @property
    def tokens(self) -> float:
        """Current level (refilled to now) — test/stats surface."""
        if self.unlimited:
            return float("inf")
        with self._lock:
            self._refill_locked(self.clock.now())
            return self._tokens


class Tenant:
    """One tenant's static contract: identity, priority class, quotas,
    fair-share weight. ``None`` quotas mean unlimited."""

    __slots__ = ("id", "priority", "api_keys", "rate_per_s", "burst",
                 "max_inflight", "max_cache_pages", "weight")

    def __init__(self, id: str, priority: str = "interactive",
                 api_keys: Sequence[str] = (),
                 rate_per_s: Optional[float] = None,
                 burst: Optional[float] = None,
                 max_inflight: Optional[int] = None,
                 max_cache_pages: Optional[int] = None,
                 weight: float = 1.0):
        if priority not in PRIORITY_CLASSES:
            raise ValueError(
                f"unknown priority {priority!r} for tenant {id!r}; "
                f"expected one of {PRIORITY_CLASSES}")
        self.id = str(id)
        self.priority = priority
        self.api_keys = tuple(api_keys)
        self.rate_per_s = float(rate_per_s) if rate_per_s else None
        self.burst = float(burst) if burst is not None else None
        self.max_inflight = int(max_inflight) \
            if max_inflight is not None else None
        self.max_cache_pages = int(max_cache_pages) \
            if max_cache_pages is not None else None
        self.weight = max(float(weight), 0.0)

    def to_dict(self) -> Dict[str, object]:
        return {"id": self.id, "priority": self.priority,
                "rate_per_s": self.rate_per_s, "burst": self.burst,
                "max_inflight": self.max_inflight,
                "max_cache_pages": self.max_cache_pages,
                "weight": self.weight}


class TenantState:
    """Mutable runtime side of one tenant: the token bucket, the
    in-flight concurrency count (checked-and-bumped under one lock so
    N racing threads can never exceed the cap), and plain counters
    the metric views read lock-free."""

    __slots__ = ("tenant", "bucket", "lock", "inflight",
                 "inflight_high_water", "n_requests", "n_shed_rate",
                 "n_shed_concurrency", "n_shed_overload", "n_replayed",
                 "n_tokens", "n_goodput_tokens", "n_release_underflow")

    def __init__(self, tenant: Tenant, clock: Clock):
        self.tenant = tenant
        self.bucket = TokenBucket(tenant.rate_per_s, tenant.burst,
                                  clock=clock) \
            if tenant.rate_per_s else None
        self.lock = threading.Lock()
        self.inflight = 0
        self.inflight_high_water = 0
        self.n_requests = 0
        self.n_shed_rate = 0
        self.n_shed_concurrency = 0
        self.n_shed_overload = 0
        self.n_replayed = 0
        self.n_tokens = 0
        self.n_goodput_tokens = 0
        self.n_release_underflow = 0

    def stats(self) -> Dict[str, object]:
        t = self.tenant
        return {"id": t.id, "priority": t.priority,
                "weight": t.weight,
                "inflight": self.inflight,
                "inflight_high_water": self.inflight_high_water,
                "n_requests": self.n_requests,
                "n_replayed": self.n_replayed,
                "n_shed_rate": self.n_shed_rate,
                "n_shed_concurrency": self.n_shed_concurrency,
                "n_shed_overload": self.n_shed_overload,
                "n_tokens": self.n_tokens,
                "n_goodput_tokens": self.n_goodput_tokens,
                "n_release_underflow": self.n_release_underflow,
                "bucket_tokens": (round(self.bucket.tokens, 3)
                                  if self.bucket is not None else None),
                "max_inflight": t.max_inflight,
                "rate_per_s": t.rate_per_s}


class TenantRegistry:
    """Static API-key → tenant mapping plus the per-tenant runtime
    admission state.

    ``unknown_key_policy``:
      * ``"anonymous"`` (default) — requests with no key or an unknown
        key run as the anonymous tenant (its quotas still apply);
      * ``"reject"`` — they are refused at the edge with 401.

    ``high_water`` is the queue-pressure fraction where priority-aware
    shedding starts (see :class:`~mmlspark_tpu_torch.serving.policy.
    PriorityShedPolicy`); ``fair_share`` turns deficit-weighted
    round-robin ordering of collector batches and decode slot claims
    on/off (the A/B axis of the ``tenant_isolation_v1`` bench)."""

    def __init__(self, tenants: Iterable[Tenant] = (),
                 unknown_key_policy: str = "anonymous",
                 high_water: float = 0.5,
                 fair_share: bool = True,
                 anonymous: Optional[Tenant] = None,
                 clock: Clock = SYSTEM_CLOCK,
                 label_cap: int = 32):
        if unknown_key_policy not in ("reject", "anonymous"):
            raise ValueError("unknown_key_policy must be 'reject' or "
                             f"'anonymous', got {unknown_key_policy!r}")
        self.unknown_key_policy = unknown_key_policy
        self.fair_share = bool(fair_share)
        self.shed_policy = PriorityShedPolicy(high_water=high_water)
        self.clock = clock
        self.label_cap = int(label_cap)
        self.tenants: Dict[str, Tenant] = {}
        self._keys: Dict[str, str] = {}
        self._states: Dict[str, TenantState] = {}
        self._lock = threading.Lock()
        for t in tenants:
            self._add(t)
        if ANONYMOUS_ID not in self.tenants:
            self._add(anonymous if anonymous is not None
                      else Tenant(ANONYMOUS_ID, priority="batch"))
        elif anonymous is not None:
            raise ValueError("both an 'anonymous' tenant entry and an "
                             "explicit anonymous= were given")
        self.anonymous = self.tenants[ANONYMOUS_ID]
        # bounded label cardinality for metrics: declaration order is
        # the top-K; later tenants fold into "other"
        from mmlspark_tpu_torch.core.telemetry import BoundedLabelSet
        self._labels = BoundedLabelSet(cap=self.label_cap)
        for tid in self.tenants:
            self._labels.key(tid)

    def _add(self, t: Tenant) -> None:
        if t.id in self.tenants:
            raise ValueError(f"duplicate tenant id {t.id!r}")
        self.tenants[t.id] = t
        self._states[t.id] = TenantState(t, self.clock)
        for k in t.api_keys:
            if k in self._keys:
                raise ValueError(f"api key assigned to both "
                                 f"{self._keys[k]!r} and {t.id!r}")
            self._keys[k] = t.id

    # -- construction --------------------------------------------------------

    @classmethod
    def from_dict(cls, cfg: Dict[str, object],
                  clock: Clock = SYSTEM_CLOCK) -> "TenantRegistry":
        tenants = [Tenant(**row) for row in cfg.get("tenants", ())]
        kw = {k: cfg[k] for k in ("unknown_key_policy", "high_water",
                                  "fair_share", "label_cap") if k in cfg}
        return cls(tenants, clock=clock, **kw)

    @classmethod
    def from_json(cls, path: str,
                  clock: Clock = SYSTEM_CLOCK) -> "TenantRegistry":
        with open(path, "r", encoding="utf-8") as f:
            return cls.from_dict(json.load(f), clock=clock)

    @classmethod
    def from_env(cls, clock: Clock = SYSTEM_CLOCK
                 ) -> Optional["TenantRegistry"]:
        """Build from ``MMLSPARK_TENANTS`` — inline JSON (starts with
        ``{``) or a path to a JSON file; ``None`` when unset."""
        raw = os.environ.get(ENV_VAR, "").strip()
        if not raw:
            return None
        if raw.startswith("{"):
            return cls.from_dict(json.loads(raw), clock=clock)
        return cls.from_json(raw, clock=clock)

    @classmethod
    def from_value(cls, value, clock: Clock = SYSTEM_CLOCK
                   ) -> Optional["TenantRegistry"]:
        """Coerce a constructor argument: an existing registry, a
        config dict, a JSON file path, or ``None``."""
        if value is None:
            return None
        if isinstance(value, TenantRegistry):
            return value
        if isinstance(value, dict):
            return cls.from_dict(value, clock=clock)
        if isinstance(value, str):
            return cls.from_json(value, clock=clock)
        raise TypeError(f"tenancy= accepts TenantRegistry, dict, "
                        f"JSON path, or None — got {type(value)!r}")

    # -- identity ------------------------------------------------------------

    def resolve(self, api_key: Optional[str]) -> Optional[Tenant]:
        """Key → tenant; ``None`` means REJECT (policy is 'reject' and
        the key is missing or unknown)."""
        if api_key is not None:
            tid = self._keys.get(api_key)
            if tid is not None:
                return self.tenants[tid]
        if self.unknown_key_policy == "reject":
            return None
        return self.anonymous

    def state(self, tenant_id: str) -> TenantState:
        return self._states[tenant_id]

    def label_of(self, tenant_id: str) -> str:
        """Bounded-cardinality metric label for a tenant id (top-K by
        declaration order, then ``other``)."""
        label, _ = self._labels.key(tenant_id)
        return label

    def states_for_label(self, label: str) -> List[TenantState]:
        """Every state whose metric label is ``label`` — 1 for top-K
        tenants, the whole overflow tail for ``other``."""
        return [st for tid, st in self._states.items()
                if self.label_of(tid) == label]

    def labels(self) -> List[str]:
        """The distinct metric labels in declaration order."""
        out: List[str] = []
        for tid in self.tenants:
            lbl = self.label_of(tid)
            if lbl not in out:
                out.append(lbl)
        return out

    # -- admission -----------------------------------------------------------

    def admit(self, tenant: Tenant
              ) -> Optional[Tuple[str, Optional[float]]]:
        """Charge one request against ``tenant``'s quotas.

        Returns ``None`` on success (the in-flight slot is HELD — the
        caller must :meth:`release` exactly once when the request
        resolves), else ``(reason, retry_after)`` where reason is
        ``"rate"`` or ``"concurrency"`` and ``retry_after`` is the
        honest bucket wait (``None`` when the bucket can't say —
        concurrency sheds clear when some in-flight request finishes,
        which the caller estimates from its own release rate)."""
        st = self._states[tenant.id]
        if st.bucket is not None and not st.bucket.try_acquire():
            with st.lock:
                st.n_shed_rate += 1
            return ("rate", st.bucket.retry_after())
        with st.lock:
            if tenant.max_inflight is not None \
                    and st.inflight >= tenant.max_inflight:
                st.n_shed_concurrency += 1
                return ("concurrency", None)
            st.inflight += 1
            if st.inflight > st.inflight_high_water:
                st.inflight_high_water = st.inflight
            st.n_requests += 1
        return None

    def release(self, tenant_id: str) -> None:
        """Return an in-flight slot. Underflow (a release with no
        matching admit) is clamped and counted — the leak-check test
        asserts the counter stays 0."""
        st = self._states.get(tenant_id)
        if st is None:
            return
        with st.lock:
            if st.inflight > 0:
                st.inflight -= 1
            else:
                st.n_release_underflow += 1

    def should_shed(self, tenant: Tenant, depth: int,
                    capacity: int) -> bool:
        """Priority-aware overload verdict for queue pressure
        ``depth``/``capacity`` (only meaningful when tenancy is on;
        with ``fair_share`` off this degrades to the plain full-queue
        check for every class)."""
        if not self.fair_share:
            return capacity > 0 and depth >= capacity
        return self.shed_policy.should_shed(depth, capacity,
                                            tenant.priority)

    def note_shed_overload(self, tenant_id: str) -> None:
        st = self._states.get(tenant_id)
        if st is not None:
            with st.lock:
                st.n_shed_overload += 1

    def note_replay(self, tenant_id: str) -> None:
        st = self._states.get(tenant_id)
        if st is not None:
            with st.lock:
                st.n_replayed += 1

    def note_tokens(self, tenant_id: str, n: int) -> None:
        st = self._states.get(tenant_id)
        if st is not None:
            with st.lock:
                st.n_tokens += int(n)

    def note_goodput_tokens(self, tenant_id: str, n: int) -> None:
        """Tokens delivered by a CLEAN decode finish (eos/length) —
        the per-tenant goodput numerator; ``note_tokens`` above stays
        the all-reasons denominator."""
        st = self._states.get(tenant_id)
        if st is not None:
            with st.lock:
                st.n_goodput_tokens += int(n)

    def weight_of(self, tenant_id: str) -> float:
        t = self.tenants.get(tenant_id)
        return t.weight if t is not None else 1.0

    # -- introspection -------------------------------------------------------

    def total_inflight(self) -> int:
        return sum(st.inflight for st in self._states.values())

    def stats(self) -> Dict[str, object]:
        return {"unknown_key_policy": self.unknown_key_policy,
                "fair_share": self.fair_share,
                "high_water": self.shed_policy.high_water,
                "label_cap": self.label_cap,
                # nonzero = the metric cap is hiding tenants in the
                # "other" row (raise label_cap or prune tenants)
                "label_overflow": self._labels.n_overflowed,
                "tenants": [st.stats()
                            for st in self._states.values()]}


class FairCycle:
    """Deficit-weighted round-robin chooser over whatever tenants are
    *present* right now.

    Each :meth:`choose` call accrues every present tenant's weight
    into its deficit, picks the largest deficit (stable tie-break on
    presentation order), and charges the winner the round total. A
    tenant whose queue empties is forgotten (standard DRR: no credit
    hoarding while absent), and zero-weight tenants accrue a small
    epsilon so they still progress — which is the bounded-starvation
    guarantee the proof test exercises: with total weight ``W`` and a
    tenant of weight ``w``, that tenant is served at least once every
    ``ceil(W / w) + 1`` rounds it is present."""

    EPSILON = 1e-3

    def __init__(self):
        self._deficit: Dict[str, float] = {}

    def choose(self, present: Dict[str, float]) -> str:
        """Pick the next tenant to serve among ``present``
        (tenant id → weight). ``present`` must be non-empty."""
        if not present:
            raise ValueError("FairCycle.choose needs >= 1 tenant")
        self._deficit = {k: v for k, v in self._deficit.items()
                         if k in present}
        best = None
        best_d = 0.0
        total = 0.0
        for tid, w in present.items():
            w = w if w > 0 else self.EPSILON
            total += w
            d = self._deficit.get(tid, 0.0) + w
            self._deficit[tid] = d
            if best is None or d > best_d:
                best, best_d = tid, d
        self._deficit[best] -= total
        return best

    def reset(self) -> None:
        self._deficit.clear()


class ReleaseRateEwma:
    """EWMA over the gaps between decode slot-release events.

    Feeds the honest ``Retry-After`` on decode 429s: with ``q``
    requests ahead in the waiting queue and one slot freeing every
    ``gap`` seconds on average, a client should come back in about
    ``q * gap`` seconds. :meth:`retry_after` returns ``None`` while
    cold (fewer than ``min_samples`` releases) or stale (no release
    for ``max_idle_s``) so callers fall back to the configured
    constant."""

    def __init__(self, alpha: float = 0.2, min_samples: int = 4,
                 max_idle_s: float = 30.0,
                 clock: Clock = SYSTEM_CLOCK):
        self.alpha = float(alpha)
        self.min_samples = int(min_samples)
        self.max_idle_s = float(max_idle_s)
        self.clock = clock
        self._lock = threading.Lock()
        self._gap: Optional[float] = None
        self._last: Optional[float] = None
        self.n_samples = 0

    def note(self) -> None:
        """One slot released now."""
        now = self.clock.now()
        with self._lock:
            last, self._last = self._last, now
            if last is None:
                return
            gap = now - last
            if gap > self.max_idle_s:
                # an idle lull, not a service gap — restart the EWMA
                self._gap = None
                self.n_samples = 0
                return
            self._gap = gap if self._gap is None \
                else (1 - self.alpha) * self._gap + self.alpha * gap
            self.n_samples += 1

    def gap_s(self) -> Optional[float]:
        with self._lock:
            if self._gap is None or self.n_samples < self.min_samples:
                return None
            if self._last is not None \
                    and self.clock.now() - self._last > self.max_idle_s:
                return None
            return self._gap

    def retry_after(self, n_ahead: int) -> Optional[float]:
        """Honest wait for a client behind ``n_ahead`` queued
        requests; ``None`` when cold/stale (use the constant)."""
        gap = self.gap_s()
        if gap is None:
            return None
        return max(gap * max(int(n_ahead), 1), 1e-3)
