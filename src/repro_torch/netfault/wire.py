"""Deterministic unreliable-transport layer for the control plane.

A :class:`LossyChannel` wraps any request/response endpoint — the northbound
``NorthboundGateway.handle_json`` (str → str) or an east-west
``DomainController`` peer endpoint (message → message) — and injects a
seeded per-link fault schedule driven by the shared
:class:`~repro_torch.core.clock.VirtualClock`:

* **drop (request)** — the request never reaches the server; the caller
  burns ``timeout_s`` of (virtual) time and sees :class:`TransportTimeout`.
* **drop (response)** — the server *does* process the request (its state
  mutates!) but the reply is lost: the classic lost-COMMIT. The caller
  times out and must retry idempotently.
* **delay** — the round trip takes extra time off the caller's deadline
  budget without failing.
* **duplicate** — the request is delivered twice back-to-back
  (at-least-once delivery); the server must be idempotent.
* **reorder** — a stale copy of the *previous* request arrives immediately
  before the current one (late retransmission overtaking the window).
* **corrupt** — the frame is mangled in flight and discarded by the link
  layer (CRC failure): surfaces as a retryable :class:`TransportError`,
  never as a malformed frame handed to the server.
* **partition** — one-way windows ``(start_s, end_s, direction)`` during
  which every message in that direction is dropped.

Determinism: all draws come from ``random.Random(plan.seed)`` in a fixed
per-message order, so a fault schedule replays bit-identically from its
seed — the property tests and the netfault bench rely on this.
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

from repro_torch.core.clock import Clock


class TransportError(Exception):
    """A retryable link-layer delivery failure (lost/corrupted frame)."""


class TransportTimeout(TransportError):
    """No reply within ``timeout_s`` — the caller cannot tell whether the
    server processed the request (the defining 2PC ambiguity)."""


#: partition directions
REQUEST = "request"
RESPONSE = "response"
BOTH = "both"


@dataclass(frozen=True)
class FaultPlan:
    """A seeded per-link fault schedule. All probabilities are per-message
    and independent; ``uniform(rate)`` gives the bench's single-knob form.
    """
    seed: int = 0
    p_drop_request: float = 0.0
    p_drop_response: float = 0.0
    p_duplicate: float = 0.0
    p_reorder: float = 0.0
    p_corrupt: float = 0.0
    p_delay: float = 0.0
    delay_ms: Tuple[float, float] = (1.0, 20.0)
    #: how long a caller waits before concluding the message died
    timeout_s: float = 0.05
    #: one-way partition windows (start_s, end_s, direction) on the
    #: VirtualClock timeline
    partitions: Tuple[Tuple[float, float, str], ...] = ()

    @classmethod
    def uniform(cls, rate: float, seed: int = 0, **kw) -> "FaultPlan":
        """Equal per-fault rate — the bench's loss-rate knob."""
        return cls(seed=seed, p_drop_request=rate, p_drop_response=rate,
                   p_duplicate=rate, p_reorder=rate, p_corrupt=rate,
                   p_delay=rate, **kw)

    def validate(self) -> None:
        for name in ("p_drop_request", "p_drop_response", "p_duplicate",
                     "p_reorder", "p_corrupt", "p_delay"):
            p = getattr(self, name)
            if not 0.0 <= p <= 1.0:
                raise ValueError(f"{name}={p} outside [0, 1]")
        for start, end, direction in self.partitions:
            if end < start:
                raise ValueError(f"partition window ({start}, {end}) inverted")
            if direction not in (REQUEST, RESPONSE, BOTH):
                raise ValueError(f"unknown partition direction {direction!r}")


class LossyChannel:
    """Wrap ``endpoint`` (request → response) with a seeded fault schedule.

    The channel is itself callable with the same signature, so it drops in
    wherever the reliable endpoint was wired: ``SessionClient(transport=...)``
    or ``DomainController.connect(..., endpoint=LossyChannel(...))``.
    """

    def __init__(self, endpoint: Callable[[Any], Any], clock: Clock,
                 plan: FaultPlan, name: str = "link"):
        plan.validate()
        self.endpoint = endpoint
        self.clock = clock
        self.plan = plan
        self.name = name
        self._rng = random.Random(plan.seed)
        self._held: Optional[Any] = None     # previous payload for reorder
        self.stats: Dict[str, int] = {
            "sent": 0, "delivered": 0, "drop_request": 0,
            "drop_response": 0, "duplicate": 0, "reorder": 0,
            "corrupt": 0, "delay": 0, "partition": 0,
        }

    # -- internals ------------------------------------------------------
    def _partitioned(self, direction: str) -> bool:
        now = self.clock.now()
        for start, end, d in self.plan.partitions:
            if start <= now < end and (d == BOTH or d == direction):
                return True
        return False

    def _timeout(self, kind: str) -> "TransportTimeout":
        # waiting for a reply that never comes consumes real budget
        advance = getattr(self.clock, "advance", None)
        if advance is not None:
            advance(self.plan.timeout_s)
        self.stats[kind] += 1
        return TransportTimeout(
            f"[{self.name}] {kind} (timeout {self.plan.timeout_s * 1e3:.0f}ms)")

    # -- the wire -------------------------------------------------------
    def __call__(self, payload: Any) -> Any:
        plan, rng = self.plan, self._rng
        self.stats["sent"] += 1
        # fixed draw order per message → deterministic replay from the seed
        r_corrupt = rng.random()
        r_drop_req = rng.random()
        r_delay = rng.random()
        delay_s = rng.uniform(*plan.delay_ms) / 1e3
        r_reorder = rng.random()
        r_dup = rng.random()
        r_drop_resp = rng.random()

        if self._partitioned(REQUEST):
            raise self._timeout("partition")
        if r_corrupt < plan.p_corrupt:
            # mangled in flight; the link layer discards the frame, so the
            # server never sees malformed bytes — the caller just times out
            raise self._timeout("corrupt")
        if r_drop_req < plan.p_drop_request:
            raise self._timeout("drop_request")
        if r_delay < plan.p_delay:
            self.stats["delay"] += 1
            advance = getattr(self.clock, "advance", None)
            if advance is not None:
                advance(delay_s)
        if r_reorder < plan.p_reorder and self._held is not None:
            # a stale retransmission of the previous request overtakes the
            # window and lands first; its response is lost to history
            self.stats["reorder"] += 1
            try:
                self.endpoint(self._held)
            except Exception:
                pass                     # stale delivery outcome is moot
        if r_dup < plan.p_duplicate:
            # at-least-once: deliver twice, the caller sees the second reply
            self.stats["duplicate"] += 1
            try:
                self.endpoint(payload)
            except Exception:
                pass                     # first copy's fate is invisible
        response = self.endpoint(payload)
        self._held = payload
        if self._partitioned(RESPONSE):
            raise self._timeout("partition")
        if r_drop_resp < plan.p_drop_response:
            # the server processed the request; only the reply died
            raise self._timeout("drop_response")
        self.stats["delivered"] += 1
        return response
