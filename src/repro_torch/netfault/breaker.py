"""Per-target circuit breakers: closed → open → half-open → closed.

A breaker trips after ``failure_threshold`` *consecutive* transport
failures against one target (site or peer domain). While open, the target
is excluded from DISCOVER/PAGING/solicitation with the attributable
exclusion reason ``"circuit-open"`` — no request is wasted on a flapping
link. After ``cooldown_s`` the breaker lets exactly one probe through
(half-open); the probe's outcome closes or re-opens the circuit.

The board is consulted *before* sending (``allow``) and fed *after*
(``record``), so call sites stay one-liners and every transition is
observable via ``snapshot()`` for the analytics/event surfaces.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from repro_torch.core.clock import Clock

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half-open"


class CircuitBreaker:
    """One target's breaker state machine (driven by an external clock)."""

    def __init__(self, clock: Clock, failure_threshold: int = 3,
                 cooldown_s: float = 5.0):
        if failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        self.clock = clock
        self.failure_threshold = failure_threshold
        self.cooldown_s = cooldown_s
        self._state = CLOSED
        self._consecutive = 0
        self._opened_at = 0.0
        self._probe_out = False
        self.transitions: List[Tuple[float, str]] = []

    @property
    def state(self) -> str:
        return self._state

    def _to(self, state: str) -> None:
        if state != self._state:
            self._state = state
            self.transitions.append((self.clock.now(), state))

    def allow(self) -> bool:
        """May we send to this target now? Open circuits admit exactly one
        probe per cooldown window (half-open)."""
        if self._state == CLOSED:
            return True
        if self._state == OPEN:
            if self.clock.now() - self._opened_at >= self.cooldown_s:
                self._to(HALF_OPEN)
                self._probe_out = True
                return True
            return False
        # half-open: only the in-flight probe may talk
        if not self._probe_out:
            self._probe_out = True
            return True
        return False

    def reset(self) -> None:
        """Administrative close (a fleet-ops heal verdict): forget the
        failure history and admit traffic immediately — an explicit
        operator decision outranks the cooldown timer."""
        self._consecutive = 0
        self._probe_out = False
        self._to(CLOSED)

    def record(self, ok: bool) -> None:
        if ok:
            self._consecutive = 0
            self._probe_out = False
            self._to(CLOSED)
            return
        self._probe_out = False
        if self._state == HALF_OPEN:
            # failed probe: straight back to open, fresh cooldown
            self._opened_at = self.clock.now()
            self._to(OPEN)
            return
        self._consecutive += 1
        if self._consecutive >= self.failure_threshold:
            self._opened_at = self.clock.now()
            self._to(OPEN)


class BreakerBoard:
    """Registry of per-target breakers with one shared configuration."""

    def __init__(self, clock: Clock, failure_threshold: int = 3,
                 cooldown_s: float = 5.0):
        self.clock = clock
        self.failure_threshold = failure_threshold
        self.cooldown_s = cooldown_s
        self._breakers: Dict[str, CircuitBreaker] = {}

    def _get(self, target: str) -> CircuitBreaker:
        b = self._breakers.get(target)
        if b is None:
            b = self._breakers[target] = CircuitBreaker(
                self.clock, self.failure_threshold, self.cooldown_s)
        return b

    def allow(self, target: str) -> bool:
        return self._get(target).allow()

    def record(self, target: str, ok: bool) -> None:
        self._get(target).record(ok)

    def reset(self, target: str) -> None:
        b = self._breakers.get(target)
        if b is not None:
            b.reset()

    def state(self, target: str) -> str:
        b = self._breakers.get(target)
        return b.state if b is not None else CLOSED

    def snapshot(self) -> Dict[str, str]:
        return {t: b.state for t, b in self._breakers.items()}
