"""QoS-aware continuous-batching scheduler — the transport-contract
enforcement point inside the serving plane.

Maps AIS QoS flows onto decode-slot scheduling:

* **Priority classes** mirror the QFI classes (premium / assured /
  best-effort): admission to the next decode round drains queues in strict
  class order, FIFO within a class (weighted-fair would starve tails the
  ASP measures, so strict+reservation is the enforceable choice).
* **Reserved share**: a fraction of slots only premium flows may hold —
  this is what a confirmed QoS lease actually buys at the engine.
* **Deadline-aware cutoffs** (straggler mitigation, serving side): a request
  whose ASP T_max would expire before its predicted completion is failed
  FAST with DEADLINE_EXPIRY instead of occupying a slot to produce a
  late-useless answer ("served-and-failed" accounting in the §V sense).
"""

from __future__ import annotations

import collections
import itertools
from dataclasses import dataclass, field
from typing import Callable, Deque, Dict, List, Optional, Union

from repro_torch.core.clock import Clock
from repro_torch.core.failures import FailureCause

_CLASS_ORDER = ("premium", "assured", "best-effort")


@dataclass
class Request:
    request_id: str
    session_id: str
    klass: str                  # premium | assured | best-effort
    prompt_tokens: int
    gen_tokens: int
    t_max_ms: float
    submitted_at: float = 0.0
    started_at: Optional[float] = None
    finished_at: Optional[float] = None
    failed: Optional[FailureCause] = None
    #: optional service-time hints (per-request predictor output); consumed
    #: by SimulatedEngine backends and by deadline fast-fail when present
    hint_ttfb_ms: Optional[float] = None
    hint_total_ms: Optional[float] = None
    #: optional caller-supplied prompt tokens (real-engine backends); when
    #: None the backend synthesizes a deterministic prompt
    prompt: Optional[object] = None
    #: continue a bound (parked / hibernated) session's generation instead
    #: of superseding its state with a fresh prefill
    resume: bool = False
    #: tenant adapter the session is bound to ("" = base model); consumed
    #: by real-engine backends at prefill admission
    adapter_id: str = ""

    def wait_ms(self, now: float) -> float:
        return (now - self.submitted_at) * 1e3


@dataclass
class SchedulerStats:
    submitted: int = 0
    admitted: int = 0
    completed: int = 0
    fast_failed: int = 0
    rejected: int = 0           # plane-level admission denials (loss systems)
    per_class_wait_ms: Dict[str, List[float]] = field(
        default_factory=lambda: collections.defaultdict(list))

    def p_wait_ms(self, klass: str, q: float) -> float:
        """Order-statistic quantile of admission wait for one class."""
        waits = sorted(self.per_class_wait_ms.get(klass, ()))
        if not waits:
            return 0.0
        idx = min(len(waits) - 1, int(q * (len(waits) - 1) + 0.5))
        return waits[idx]


class QoSScheduler:
    def __init__(self, clock: Clock, *, slots: int,
                 premium_reserved_frac: float = 0.25):
        self.clock = clock
        self.slots = slots
        self.premium_reserved = max(1, int(slots * premium_reserved_frac)) \
            if slots > 1 and premium_reserved_frac > 0 else 0
        self.queues: Dict[str, Deque[Request]] = {
            k: collections.deque() for k in _CLASS_ORDER}
        self.running: Dict[str, Request] = {}
        self.stats = SchedulerStats()
        self._ids = itertools.count()

    # ------------------------------------------------------------------
    def submit(self, req: Request) -> None:
        req.submitted_at = self.clock.now()
        self.stats.submitted += 1
        self.queues[req.klass].append(req)

    def _slots_usable(self, klass: str) -> int:
        """Best-effort/assured may not dip into the premium reservation."""
        in_use = len(self.running)
        free = self.slots - in_use
        if klass == "premium":
            return free
        premium_running = sum(1 for r in self.running.values()
                              if r.klass == "premium")
        reserve_hold = max(0, self.premium_reserved - premium_running)
        return max(0, free - reserve_hold)

    def _deadline_hopeless(self, req: Request,
                           predicted_service_ms: float) -> bool:
        waited_ms = (self.clock.now() - req.submitted_at) * 1e3
        return waited_ms + predicted_service_ms > req.t_max_ms

    # ------------------------------------------------------------------
    def next_batch(self, *,
                   predicted_service_ms: Union[float,
                                               Callable[[Request], float]]
                   = 0.0,
                   skip: Optional[Callable[[Request], bool]] = None,
                   on_fast_fail: Optional[Callable[[Request], None]] = None
                   ) -> List[Request]:
        """Admit requests to the next decode round in class order.

        ``predicted_service_ms`` may be a scalar or a per-request predictor
        (the serving plane passes the backend's estimate so deadline fast-fail
        accounts for each request's own work). ``skip`` defers a request
        without consuming it (e.g. its session already holds an engine slot) —
        FIFO order within the class is preserved by stopping at the first
        skipped head. ``on_fast_fail`` lets the plane record DEADLINE_EXPIRY
        drops as served-and-failed results.
        """
        admitted: List[Request] = []
        for klass in _CLASS_ORDER:
            q = self.queues[klass]
            while q and self._slots_usable(klass) > 0:
                if skip is not None and skip(q[0]):
                    break               # head-of-line blocked; next class
                req = q.popleft()
                svc = predicted_service_ms(req) \
                    if callable(predicted_service_ms) else predicted_service_ms
                if svc and self._deadline_hopeless(req, svc):
                    req.failed = FailureCause.DEADLINE_EXPIRY
                    req.finished_at = self.clock.now()
                    self.stats.fast_failed += 1
                    if on_fast_fail is not None:
                        on_fast_fail(req)
                    continue
                req.started_at = self.clock.now()
                self.running[req.request_id] = req
                self.stats.admitted += 1
                self.stats.per_class_wait_ms[klass].append(
                    (req.started_at - req.submitted_at) * 1e3)
                admitted.append(req)
        return admitted

    def complete(self, request_id: str) -> None:
        req = self.running.pop(request_id, None)
        if req:
            req.finished_at = self.clock.now()
            self.stats.completed += 1

    # ------------------------------------------------------------------
    # make-before-break handover (migration data plane)
    # ------------------------------------------------------------------
    def detach(self, request_id: str) -> Optional[Request]:
        """Remove a running request WITHOUT completion accounting: the
        request is being handed over to another plane's scheduler (its slot
        here frees immediately; the occupancy follows the session)."""
        return self.running.pop(request_id, None)

    def attach(self, req: Request) -> None:
        """Install an in-flight request admitted on another plane. The slot
        is occupied immediately; admission-wait was already measured at the
        original admission, so no wait statistics are recorded here."""
        self.running[req.request_id] = req

    def take_queued(self, session_id: str) -> List[Request]:
        """Remove and return this session's queued (not yet admitted)
        requests, preserving FIFO order within each class — they follow
        the session to its new anchor instead of being served here."""
        taken: List[Request] = []
        for q in self.queues.values():
            if any(r.session_id == session_id for r in q):
                taken.extend(r for r in q if r.session_id == session_id)
                kept = [r for r in q if r.session_id != session_id]
                q.clear()
                q.extend(kept)
        return taken

    def put_queued(self, reqs: List[Request]) -> None:
        """Enqueue requests handed over from another plane, preserving
        their original submit times (no resubmission accounting)."""
        for r in reqs:
            self.queues[r.klass].append(r)

    def queue_depth(self) -> int:
        return sum(len(q) for q in self.queues.values())

    def queue_depths(self) -> Dict[str, int]:
        return {k: len(q) for k, q in self.queues.items()}
