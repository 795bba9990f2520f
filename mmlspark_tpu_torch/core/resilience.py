"""Clocks and deadlines (the port's copy of the pieces of
``mmlspark_tpu/core/resilience.py`` the decode plane uses).

Every time-dependent piece takes an injectable :class:`Clock`, so tests
drive deadline expiry with a :class:`ManualClock` instead of sleeping.
"""

from __future__ import annotations

import threading
import time


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


class Deadline:
    """An absolute point in time the work must finish by (the request's
    budget; the scheduler reaps a request whose deadline expired)."""

    def __init__(self, timeout: float, clock: Clock = SYSTEM_CLOCK):
        self.clock = clock
        self._expires = clock.now() + float(timeout)

    def remaining(self) -> float:
        return self._expires - self.clock.now()

    @property
    def expired(self) -> bool:
        return self.remaining() <= 0
