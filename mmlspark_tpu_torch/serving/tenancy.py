"""Tenancy pieces the decode scheduler uses (the port's copy of
``FairCycle``, ``ReleaseRateEwma`` and ``ANONYMOUS_ID`` from
``mmlspark_tpu/serving/tenancy.py``). Host-side bookkeeping only; the
tenant registry and quotas arrive with the HTTP serving stack."""

from __future__ import annotations

import threading
from typing import Dict, Optional

from mmlspark_tpu_torch.core.resilience import SYSTEM_CLOCK, Clock

ANONYMOUS_ID = "anonymous"


class FairCycle:
    """Deficit-weighted round-robin chooser over whatever tenants are
    *present* right now.

    Each :meth:`choose` call accrues every present tenant's weight into
    its deficit, picks the largest deficit (stable tie-break on
    presentation order), and charges the winner the round total. A
    tenant whose queue empties is forgotten (no credit hoarding while
    absent), and zero-weight tenants accrue a small epsilon so they
    still progress: with total weight ``W`` a tenant of weight ``w`` is
    served at least once every ``ceil(W / w) + 1`` rounds it is
    present."""

    EPSILON = 1e-3

    def __init__(self):
        self._deficit: Dict[str, float] = {}

    def choose(self, present: Dict[str, float]) -> str:
        """Pick the next tenant to serve among ``present``
        (tenant id -> weight). ``present`` must be non-empty."""
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
    """EWMA over the gaps between decode slot-release events — the
    honest ``Retry-After`` of a decode 429: with ``q`` requests ahead and
    one slot freeing every ``gap`` seconds, come back in ``q * gap``.
    :meth:`retry_after` returns ``None`` while cold (fewer than
    ``min_samples`` releases) or stale (no release for ``max_idle_s``)."""

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
        """Honest wait for a client behind ``n_ahead`` queued requests;
        ``None`` when cold/stale (use the constant)."""
        gap = self.gap_s()
        if gap is None:
            return None
        return max(gap * max(int(n_ahead), 1), 1e-3)
