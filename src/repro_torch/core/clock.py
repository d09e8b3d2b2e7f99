"""Injectable clock: the whole control plane is written against this so the
lifecycle (leases, deadlines Eq. 11, make-before-break) is deterministic in
tests and in the §V Monte-Carlo simulation."""

from __future__ import annotations

import time


class Clock:
    def now(self) -> float:
        return time.monotonic()

    def sleep(self, dt: float) -> None:
        time.sleep(dt)


class VirtualClock(Clock):
    """Deterministic clock for tests/simulation."""

    def __init__(self, t0: float = 0.0):
        self._t = float(t0)

    def now(self) -> float:
        return self._t

    def sleep(self, dt: float) -> None:
        self.advance(dt)

    def advance(self, dt: float) -> float:
        if dt < 0:
            raise ValueError("time moves forward")
        self._t += dt
        return self._t
