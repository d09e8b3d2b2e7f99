"""Per-site ServingPlane: the single path every request takes to an anchor.

The paper's AIS contract binds transport QoS to execution placement with
enforceable tail-latency semantics; this module is where the enforcement
actually happens. One plane per execution site owns

* a :class:`QoSScheduler` — class-ordered slot admission (premium slot
  reservation, deadline fast-fail with served-and-failed accounting), and
* a backend behind a common interface:
    - :class:`RealEngineBackend` — the continuous-batching
      :class:`~repro_torch.serving.engine.InferenceEngine` (decode rounds across
      sessions, not per-request loops), or
    - :class:`SimulatedEngine` — service times drawn from a sampler
      (predictor output or the §V ``LatencyModel``) under a
      :class:`~repro_torch.core.clock.VirtualClock`, which is what lets the
      control-plane tests and the Monte-Carlo scenarios exercise the *same*
      queueing machinery the real engine runs behind.

Request lifecycle (event-driven)::

    submit ──► class queue ──► slot admission ──► decode rounds ──► complete
                  │   (premium reservation,          (real engine) │
                  │    deadline fast-fail)    or completion event  │
                  └────────── rejected (loss-system planes) ───────┘

The plane is also the congestion sensor for the NWDAF-style analytics loop:
``load()`` exposes measured queue depth per slot and the arrival rate, which
``Orchestrator.heartbeat`` feeds into ``Analytics.observe_site`` so paging
(Eq. 9) and migration triggers (Eq. 14) react to real load.
"""

from __future__ import annotations

import collections
import dataclasses
import heapq
import itertools
import zlib
from dataclasses import dataclass
from typing import Callable, Deque, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.clock import Clock, VirtualClock
from repro_torch.core.failures import FailureCause
from repro_torch.serving.scheduler import QoSScheduler, Request


@dataclass
class PlaneResult:
    """Boundary-observable outcome of one request through the plane."""
    request_id: str
    session_id: str
    klass: str
    ttfb_ms: float
    latency_ms: float            # submit → completion (includes queue wait)
    queue_wait_ms: float
    tokens: int
    completed: bool              # finished within the request's T_max
    failed: Optional[FailureCause] = None
    token_ids: Optional[List[int]] = None   # real-engine backends only
    prompt_tokens: int = 0       # context consumed (sizes migration payload)


@dataclass
class PlaneLoad:
    """Congestion snapshot ξ-side: what analytics ingests per heartbeat."""
    queue_depth: float           # waiting requests per slot
    arrival_rate: float          # submits / s over the recent window
    running: int
    slots: int
    utilization: float
    #: session-tier occupancy (real-engine backends with hibernation):
    #: bound = resident + hibernated; page_util feeds the Eq. 14 memory-
    #: pressure term so migration triggers see pool exhaustion coming
    resident_sessions: int = 0
    hibernated_sessions: int = 0
    bound_sessions: int = 0
    page_util: float = 0.0
    #: refused hibernation puts (capacity-bounded store): back-pressure the
    #: supervisor reads instead of the tick crashing with MemoryError
    store_full: int = 0


@dataclass
class Admission:
    """Backend's answer to 'start serving this request now'."""
    ttfb_ms: float
    finish_at: Optional[float]   # absolute clock time (simulated backends)
    first_token: Optional[int] = None
    #: the request continues an existing bound session (no prefill ran, so
    #: there is no first token — generation resumes at the next round)
    resumed: bool = False


@dataclass
class SessionHandoff:
    """A session's in-flight work detached from one plane for
    make-before-break handover to another: the running request keeps
    streaming on the target, queued requests re-queue there."""
    session_id: str
    request: Optional[object]              # scheduler Request, if in flight
    tokens: int = 0                        # generated so far
    token_ids: Optional[List[int]] = None  # real-engine backends
    finish_at: Optional[float] = None      # pending event (simulated)
    queued: List[object] = dataclasses.field(default_factory=list)

    def empty(self) -> bool:
        return self.request is None and not self.queued


class RealEngineBackend:
    """Continuous-batching decode rounds on a real ``InferenceEngine``.

    Requests from different sessions share decode rounds; a request finishes
    when its token budget is generated. Service-time prediction for deadline
    fast-fail comes from a measured per-token EWMA (no static assumption).
    Sessions are exclusive: the engine keys slots by session id, so at most
    one request per session is in flight (the plane defers the rest).
    """

    exclusive_sessions = True
    #: real engines measure their own service times (per-token EWMA) — the
    #: control plane never needs to supply predictor hints
    needs_service_hints = False

    def __init__(self, engine, clock: Clock, *, seed: int = 0,
                 retain_sessions: Optional[bool] = None,
                 free_page_watermark: float = 0.25,
                 hibernate_idle_s: Optional[float] = None):
        """``retain_sessions`` keeps a session's engine state bound after its
        request completes (parked, then hibernated under pressure or after
        ``hibernate_idle_s`` of idleness) so a later ``resume=True`` request
        continues the generation; defaults to on exactly when the engine has
        a hibernation store. ``free_page_watermark`` is the free-page
        fraction below which ``ensure_capacity`` starts hibernating coldest
        parked sessions pre-emptively."""
        self.engine = engine
        self.clock = clock
        if getattr(engine, "clock", None) is None:
            # thread the plane clock through so the engine's own hibernation
            # paths (page reclaim) stamp records with real times too
            engine.clock = clock
        self._ms_per_token: float = 0.0       # measured EWMA (per decode step)
        self._seed = seed
        self.retain_sessions = (
            getattr(engine, "hibernation", None) is not None
            if retain_sessions is None else bool(retain_sessions))
        self.free_page_watermark = free_page_watermark
        self.hibernate_idle_s = hibernate_idle_s
        self._parked_at: Dict[str, float] = {}

    # -- plane interface -------------------------------------------------
    def predicted_service_ms(self, req: Request) -> float:
        if req.hint_total_ms is not None:
            return req.hint_total_ms
        return self._ms_per_token * req.gen_tokens

    def _store(self):
        """Engine hibernation store, or None (also for duck-typed stubs)."""
        return getattr(self.engine, "hibernation", None)

    def _page_pressure(self) -> bool:
        eng = self.engine
        if not getattr(eng, "paged", False):
            return False
        return eng.free_pages() < self.free_page_watermark * eng.total_pages()

    def _coldest_parked(self, exclude) -> Optional[str]:
        best, victim = None, None
        for s in self.engine._slots:
            if s is not None and s.parked and s.session_id not in exclude \
                    and (best is None or s.last_used < best):
                best, victim = s.last_used, s.session_id
        return victim

    def ensure_capacity(self, active_sessions) -> None:
        """Make room for the next admission instead of refusing it: while
        there is no free slot or the page pool sits below its free-page
        watermark, hibernate (or, storeless, release) the coldest parked
        session. Falls back to the legacy orphan-slot reclaim — state
        imported by migration whose session is now submitting fresh
        requests is superseded, never left to block admission forever."""
        eng = self.engine
        for _ in range(eng.slots + 1):
            if eng.free_slots() > 0 and not self._page_pressure():
                return
            victim = self._coldest_parked(active_sessions)
            if victim is None:
                break
            if self._store() is not None:
                if not eng.hibernate_slot(victim):
                    break       # store full: fall through to orphan reclaim
            else:
                eng.release_slot(victim)
            self._parked_at.pop(victim, None)
        if eng.free_slots() == 0:
            for sid in list(eng._slot_map):
                if sid not in active_sessions:
                    eng.release_slot(sid)
                    return

    def admit(self, req: Request, now: float) -> Admission:
        eng = self.engine
        if getattr(req, "resume", False) and (
                eng.has_slot(req.session_id)
                or eng.has_hibernated(req.session_id)):
            # transparent resume: unpark is free, hibernated state
            # re-imports through the same admission path migration uses
            # (ensure_capacity already made room)
            t0 = self.clock.now()
            eng.resume_session(req.session_id)
            self._parked_at.pop(req.session_id, None)
            return Admission(ttfb_ms=(self.clock.now() - t0) * 1e3,
                             finish_at=None, resumed=True)
        if req.session_id in self.engine._slot_map:
            # stale slot from a migrated/abandoned generation: superseded
            self.engine.release_slot(req.session_id)
        elif self._store() is not None:
            self._store().drop(req.session_id)      # superseded cold state
        self._parked_at.pop(req.session_id, None)
        prompt = req.prompt
        if prompt is None:
            # crc32, not hash(): hash() varies per process under
            # PYTHONHASHSEED, which would break reproducible traces and
            # cross-process migration fingerprint checks
            rng = np.random.default_rng(
                (zlib.crc32(req.session_id.encode())
                 ^ zlib.crc32(req.request_id.encode()) ^ self._seed)
                % 2**31)
            prompt = rng.integers(
                0, self.engine.cfg.vocab_size,
                size=max(req.prompt_tokens, 1)).astype(np.int32)
        aid = getattr(req, "adapter_id", "")
        if aid:
            out = self.engine.prefill_session(req.session_id, prompt,
                                              adapter_id=aid)
        else:
            out = self.engine.prefill_session(req.session_id, prompt)
        return Admission(ttfb_ms=out["ttfb_ms"], finish_at=None,
                         first_token=out["first_token"])

    def decode_round(self, steps: Optional[int] = None):
        """One decode chunk. ``steps=None`` keeps the legacy single-step
        {session: token} form; ``steps=K`` returns {session: [K tokens]}
        from one fused dispatch.

        The service-time EWMA normalises by the tokens each active session
        emitted in the chunk (= the number of decode steps) — NOT by the
        number of sessions or calls — so ``predicted_service_ms`` (per-token
        EWMA × requested tokens) stays calibrated for deadline fast-fail
        whatever the chunk size: a request's G tokens always take G steps,
        however many sessions share each step."""
        t0 = self.clock.now()
        out = self.engine.decode_round(steps=steps)
        dt_ms = (self.clock.now() - t0) * 1e3
        if out:
            per_tok = dt_ms / max(steps or 1, 1)
            self._ms_per_token = per_tok if self._ms_per_token == 0.0 \
                else 0.8 * self._ms_per_token + 0.2 * per_tok
        return out

    def release(self, session_id: str) -> None:
        if self.retain_sessions and self.engine.has_slot(session_id):
            # keep the session bound: park now (state frozen in place),
            # hibernate later under page pressure or the idle-TTL tick
            self.engine.park_slot(session_id)
            self._parked_at[session_id] = self.clock.now()
        else:
            self.engine.release_slot(session_id)

    def tick(self, now: Optional[float] = None) -> int:
        """Idle-TTL policy (the AIS lease-expiry analogue): hibernate
        sessions parked longer than ``hibernate_idle_s``. Returns the
        number hibernated; the plane calls this from ``load()`` so the
        policy advances with every heartbeat."""
        if self.hibernate_idle_s is None or self._store() is None:
            return 0
        now = self.clock.now() if now is None else now
        n = 0
        for sid, t in list(self._parked_at.items()):
            if not self.engine.is_parked(sid):
                self._parked_at.pop(sid, None)      # reclaimed elsewhere
            elif now - t >= self.hibernate_idle_s:
                if not self.engine.hibernate_slot(sid, now=now):
                    continue    # store full: stays parked, retried next tick
                self._parked_at.pop(sid, None)
                n += 1
        return n

    def occupancy(self) -> Dict[str, float]:
        eng = self.engine
        if not hasattr(eng, "resident_sessions"):   # duck-typed stubs
            return {}
        store = self._store()
        return {"resident_sessions": eng.resident_sessions(),
                "hibernated_sessions": eng.hibernated_sessions(),
                "bound_sessions": eng.bound_sessions(),
                "page_util": eng.page_util(),
                # `is not None`, not truthiness: an EMPTY store is falsy
                # (__len__) yet its refusal count is exactly what matters
                "store_full": getattr(store, "store_full", 0)
                if store is not None else 0}

    # -- migration data plane (engine slot protocol) ---------------------
    def has_slot(self, session_id: str) -> bool:
        return self.engine.has_slot(session_id)

    def export_slot(self, session_id: str):
        return self.engine.export_slot(session_id)

    def import_slot(self, session_id: str, payload) -> None:
        self.engine.import_slot(session_id, payload)

    def release_slot(self, session_id: str) -> None:
        self.engine.release_slot(session_id)


class SimulatedEngine:
    """Predictor/sampler-backed backend driven by (virtual) clock events.

    ``service_sampler(req) -> (ttfb_ms, total_ms)`` supplies each request's
    service time; per-request hints on the ``Request`` override it (the
    orchestrator passes predictor output, the §V scenarios pass
    ``LatencyModel`` draws). A request occupies its decode slot from
    admission until ``finish_at`` — queueing, class ordering, and premium
    reservation all come from the shared ``QoSScheduler``, not from any
    closed-form queue model.

    The backend also keeps a **serializable per-session state** that evolves
    deterministically with every admitted request (a small state vector plus
    the context position), speaking the same ``export_slot`` / ``import_slot``
    / ``release_slot`` protocol as the real engine — so the §V simulation arm
    migrates sessions through :mod:`repro_torch.serving.state_transfer` under
    ``VirtualClock``, with real fingerprint verification and real abort paths.
    ``import_capacity`` bounds how many migrated-in sessions the backend will
    hold (None = unbounded); exhaustion raises — target admission denial.
    """

    exclusive_sessions = False   # per-request slots never collide per session

    STATE_DIM = 8

    def __init__(self, clock: Clock, *,
                 service_sampler: Optional[
                     Callable[[Request], Tuple[float, float]]] = None,
                 default_service_ms: float = 50.0,
                 import_capacity: Optional[int] = None):
        self.clock = clock
        self.service_sampler = service_sampler
        self.default_service_ms = default_service_ms
        self.import_capacity = import_capacity
        self._sessions: Dict[str, dict] = {}

    @property
    def needs_service_hints(self) -> bool:
        """Without a sampler the backend has no service-time source of its
        own — callers must pass predictor hints on each request."""
        return self.service_sampler is None

    # -- plane interface -------------------------------------------------
    def predicted_service_ms(self, req: Request) -> float:
        if req.hint_total_ms is not None:
            return req.hint_total_ms
        return self.default_service_ms

    def ensure_capacity(self, active_sessions) -> None:
        pass

    def _touch_state(self, req: Request) -> None:
        """Deterministic session-state evolution (crc32-seeded so two runs
        of the same trace produce byte-identical states and fingerprints)."""
        st = self._sessions.get(req.session_id)
        if st is None:
            st = {"cache": {"sim": np.zeros(self.STATE_DIM, np.float64)},
                  "position": 0, "last_token": 0}
            self._sessions[req.session_id] = st
        mix = (zlib.crc32(req.session_id.encode())
               + 31 * req.prompt_tokens + 7 * req.gen_tokens) % 1_000_003
        vec = st["cache"]["sim"]
        vec[1:] = vec[:-1]
        vec[0] = 0.5 * vec[0] + float(mix)
        st["position"] += req.prompt_tokens + req.gen_tokens
        st["last_token"] = int(mix % 50_257)

    def admit(self, req: Request, now: float) -> Admission:
        self._touch_state(req)
        if req.hint_total_ms is not None:
            ttfb = req.hint_ttfb_ms if req.hint_ttfb_ms is not None else 0.0
            total = req.hint_total_ms
        elif self.service_sampler is not None:
            ttfb, total = self.service_sampler(req)
        else:
            ttfb, total = 0.0, self.default_service_ms
        return Admission(ttfb_ms=ttfb, finish_at=now + total / 1e3)

    def decode_round(self, steps: Optional[int] = None) -> Dict[str, int]:
        return {}

    def release(self, session_id: str) -> None:
        # per-request slot release: session state persists across requests
        pass

    # -- migration data plane (engine slot protocol) ---------------------
    def has_slot(self, session_id: str) -> bool:
        return session_id in self._sessions

    def export_slot(self, session_id: str):
        st = self._sessions[session_id]
        return {"cache": {"sim": np.array(st["cache"]["sim"], copy=True)},
                "position": st["position"],
                "last_token": st["last_token"]}

    def import_slot(self, session_id: str, payload) -> None:
        if self.import_capacity is not None and \
                session_id not in self._sessions and \
                len(self._sessions) >= self.import_capacity:
            from repro_torch.serving.state_transfer import AdmissionDenied
            raise AdmissionDenied(
                f"target admission denied: no free session slots for "
                f"{session_id}")
        self._sessions[session_id] = {
            "cache": {"sim": np.array(payload["cache"]["sim"], copy=True)},
            "position": int(payload["position"]),
            "last_token": int(payload["last_token"])}

    def release_slot(self, session_id: str) -> None:
        self._sessions.pop(session_id, None)


#: default fused-decode chunk sizes per QoS class: the chunk is the
#: preemption granularity — admission (and therefore premium TTFT) can only
#: happen between chunks, so the premium chunk stays small while best-effort
#: amortises dispatch overhead over longer runs
DEFAULT_DECODE_CHUNK = {"premium": 4, "assured": 8, "best-effort": 32}


class ServingPlane:
    """QoS-scheduled serving plane of ONE execution site."""

    def __init__(self, clock: Clock, backend, *, slots: int,
                 premium_reserved_frac: float = 0.25,
                 max_queue: Optional[int] = None,
                 site_id: str = "",
                 arrival_window: int = 128,
                 decode_chunk: Optional[Dict[str, int]] = None):
        self.clock = clock
        self.backend = backend
        self.site_id = site_id
        self.decode_chunk = dict(DEFAULT_DECODE_CHUNK)
        if decode_chunk:
            self.decode_chunk.update(decode_chunk)
        self.scheduler = QoSScheduler(
            clock, slots=slots, premium_reserved_frac=premium_reserved_frac)
        #: None = unbounded queue; N = loss system once running+queued
        #: exceeds slots+N (admission control for the §V scenarios)
        self.max_queue = max_queue
        self._events: List[Tuple[float, int, Request]] = []   # finish heap
        self._seq = itertools.count()
        self._tokens: Dict[str, int] = {}          # request_id -> generated
        self._tok_ids: Dict[str, List[int]] = {}   # real backends: token ids
        self._active_sessions: set = set()         # sessions with a running req
        self._by_request: Dict[str, Request] = {}
        self._done: Dict[str, PlaneResult] = {}
        self._outbox: List[PlaneResult] = []
        self._arrivals: Deque[float] = collections.deque(maxlen=arrival_window)
        self._req_ids = itertools.count()
        #: plane-level migration failure injection (tests): export-side hooks
        #: fire when this plane is the SOURCE, import-side when it is the
        #: TARGET (see state_transfer.TransferInjections)
        self.migration_inject = None
        #: supervisor readiness gate: a draining/dead site stops admitting —
        #: submits reject (accounted) while in-flight work keeps streaming
        self.admitting = True

    # ------------------------------------------------------------------
    # submission
    # ------------------------------------------------------------------
    def submit(self, *, session_id: str, klass: str, prompt_tokens: int,
               gen_tokens: int, t_max_ms: float,
               request_id: Optional[str] = None,
               hint_ttfb_ms: Optional[float] = None,
               hint_total_ms: Optional[float] = None,
               prompt=None, resume: bool = False,
               adapter_id: str = "") -> Optional[Request]:
        """Enqueue one request; returns None when admission control rejects
        it (bounded-queue planes, or a plane gated closed by its
        supervisor), after accounting the rejection."""
        if not self.admitting:
            self.scheduler.stats.rejected += 1
            return None
        now = self.clock.now()
        self._arrivals.append(now)
        if self.max_queue is not None and \
                (len(self.scheduler.running) + self.scheduler.queue_depth()
                 >= self.scheduler.slots + self.max_queue):
            self.scheduler.stats.rejected += 1
            return None
        req = Request(
            request_id=request_id or f"{self.site_id}/req-{next(self._req_ids)}",
            session_id=session_id, klass=klass,
            prompt_tokens=prompt_tokens, gen_tokens=gen_tokens,
            t_max_ms=t_max_ms, hint_ttfb_ms=hint_ttfb_ms,
            hint_total_ms=hint_total_ms, prompt=prompt, resume=resume,
            adapter_id=adapter_id)
        self._by_request[req.request_id] = req
        self.scheduler.submit(req)
        self._admit()
        return req

    # ------------------------------------------------------------------
    # internal machinery
    # ------------------------------------------------------------------
    def _skip(self, req: Request) -> bool:
        """Engine backends key slots by session: a session with a plane
        request already in flight must wait for it (per-slot cache
        positions). Slots held OUTSIDE the plane (e.g. migrated-in state)
        do not block — the backend reclaims them at admission."""
        return self.backend.exclusive_sessions and \
            req.session_id in self._active_sessions

    def _fast_fail(self, req: Request) -> None:
        self._finish(req, ttfb_ms=0.0, completed=False,
                     failed=FailureCause.DEADLINE_EXPIRY)

    def _admit(self) -> None:
        batch = self.scheduler.next_batch(
            predicted_service_ms=self.backend.predicted_service_ms,
            skip=self._skip, on_fast_fail=self._fast_fail)
        for req in batch:
            # the admitting request's own session must never be the reclaim
            # victim — a resume=True request's parked state is exactly what
            # it is about to continue
            self.backend.ensure_capacity(
                self._active_sessions | {req.session_id})
            try:
                adm = self.backend.admit(req, self.clock.now())
            except Exception as e:
                # the request is already in scheduler.running — a backend
                # refusal (oversized prompt, engine failure) must free that
                # slot and surface as a failed result, never wedge the site
                self.scheduler.detach(req.request_id)
                cause = (FailureCause.NO_FEASIBLE_BINDING
                         if isinstance(e, ValueError)   # infeasible request
                         else FailureCause.COMPUTE_SCARCITY)
                self._finish(req, ttfb_ms=0.0, completed=False, failed=cause)
                continue
            self._active_sessions.add(req.session_id)
            req.hint_ttfb_ms = adm.ttfb_ms            # measured/known TTFB
            if adm.finish_at is not None:
                # event-driven backend: the whole generation completes at
                # finish_at, so the token budget is accounted up front
                self._tokens[req.request_id] = req.gen_tokens
                heapq.heappush(self._events,
                               (adm.finish_at, next(self._seq), req))
            elif adm.resumed:
                # no prefill ran: generation continues from the bound
                # state at the next decode round
                self._tokens[req.request_id] = 0
                self._tok_ids[req.request_id] = []
            else:
                self._tokens[req.request_id] = 1      # prefill's first token
                if adm.first_token is not None:
                    self._tok_ids[req.request_id] = [adm.first_token]

    def _finish(self, req: Request, *, ttfb_ms: float, completed: bool,
                failed: Optional[FailureCause] = None) -> None:
        now = self.clock.now()
        latency_ms = (now - req.submitted_at) * 1e3
        started = req.started_at if req.started_at is not None else now
        wait_ms = (started - req.submitted_at) * 1e3
        res = PlaneResult(
            request_id=req.request_id, session_id=req.session_id,
            klass=req.klass, ttfb_ms=ttfb_ms, latency_ms=latency_ms,
            queue_wait_ms=wait_ms,
            tokens=self._tokens.pop(req.request_id, 0),
            completed=completed and failed is None, failed=failed,
            token_ids=self._tok_ids.pop(req.request_id, None),
            prompt_tokens=req.prompt_tokens)
        self._done[req.request_id] = res
        self._outbox.append(res)
        self._by_request.pop(req.request_id, None)

    def _complete(self, req: Request) -> None:
        self.scheduler.complete(req.request_id)
        self.backend.release(req.session_id)
        self._active_sessions.discard(req.session_id)
        latency_ms = (self.clock.now() - req.submitted_at) * 1e3
        self._finish(req, ttfb_ms=req.hint_ttfb_ms or 0.0,
                     completed=latency_ms <= req.t_max_ms)
        self._admit()               # freed slot: admit from the queue

    def _chunk_steps(self) -> int:
        """Fused-decode chunk size for the next round: bounded by (a) the
        smallest remaining token budget among running requests — no slot
        ever overshoots its request, so per-request accounting stays exact —
        and (b) the chunk cap of the highest QoS class present (running OR
        queued: a queued premium request must not wait out a long
        best-effort chunk for its admission slot). The bound is then rounded
        DOWN to a power of two so the engine compiles O(log max_chunk) fused
        scans total (request tails would otherwise trace a fresh scan for
        every distinct remaining count)."""
        remaining = [
            req.gen_tokens - self._tokens.get(req.request_id, 0)
            for req in self.scheduler.running.values()]
        if not remaining:
            return 1
        cap = max(self.decode_chunk.values())
        classes = {r.klass for r in self.scheduler.running.values()}
        classes |= {k for k, d in self.scheduler.queues.items() if d}
        for k in classes:
            cap = min(cap, self.decode_chunk.get(k, 1))
        bound = max(1, min(min(remaining), cap))
        return 1 << (bound.bit_length() - 1)     # pow2 floor

    def _round(self) -> bool:
        """One continuous-batching decode chunk (real backends): K fused
        decode steps in one dispatch, K picked per QoS mix. Returns False
        when the round made no progress (nothing active, or a simulated
        backend whose progress is event-driven)."""
        if not self.scheduler.running:
            return False
        steps = self._chunk_steps()
        out = self.backend.decode_round(steps=steps)
        if not out:
            return False
        finished = []
        for req in list(self.scheduler.running.values()):
            if req.session_id in out:
                block = out[req.session_id]
                self._tokens[req.request_id] = \
                    self._tokens.get(req.request_id, 0) + len(block)
                if req.request_id in self._tok_ids:
                    self._tok_ids[req.request_id].extend(block)
                if self._tokens[req.request_id] >= req.gen_tokens:
                    finished.append(req)
        for req in finished:
            self._complete(req)
        return True

    # ------------------------------------------------------------------
    # make-before-break handover (migration data plane)
    # ------------------------------------------------------------------
    def detach_session(self, session_id: str) -> SessionHandoff:
        """Detach a session's in-flight work (running request + token
        accounting AND its queued requests) for handover to another plane.
        Backend slot state is NOT touched — the transfer path exports/
        releases it under two-phase ordering. The freed scheduler slot is
        immediately available to other queued work."""
        queued = self.scheduler.take_queued(session_id)
        for r in queued:
            self._by_request.pop(r.request_id, None)
        req = next((r for r in self.scheduler.running.values()
                    if r.session_id == session_id), None)
        if req is None:
            return SessionHandoff(session_id, None, queued=queued)
        self.scheduler.detach(req.request_id)
        self._active_sessions.discard(session_id)
        self._by_request.pop(req.request_id, None)
        finish_at = None
        for i, (t, _seq, r) in enumerate(self._events):
            if r.request_id == req.request_id:
                finish_at = t
                self._events[i] = self._events[-1]
                self._events.pop()
                heapq.heapify(self._events)
                break
        return SessionHandoff(
            session_id, req,
            tokens=self._tokens.pop(req.request_id, 0),
            token_ids=self._tok_ids.pop(req.request_id, None),
            finish_at=finish_at, queued=queued)

    def attach_session(self, handoff: SessionHandoff) -> None:
        """Install work handed over from another plane: the running request
        occupies a slot here and keeps streaming from where the source left
        off, queued requests join this plane's class queues with their
        original submit times (the QoS occupancy follows the session)."""
        req = handoff.request
        if req is not None:
            self.scheduler.attach(req)
            self._active_sessions.add(req.session_id)
            self._by_request[req.request_id] = req
            self._tokens[req.request_id] = handoff.tokens
            if handoff.token_ids is not None:
                self._tok_ids[req.request_id] = handoff.token_ids
            if handoff.finish_at is not None:
                heapq.heappush(self._events,
                               (handoff.finish_at, next(self._seq), req))
        for r in handoff.queued:
            self._by_request[r.request_id] = r
        self.scheduler.put_queued(handoff.queued)
        if handoff.queued:
            self._admit()

    def fail_all(self, cause: FailureCause) -> int:
        """Crash semantics: every running AND queued request fails with
        ``cause`` through the normal served-and-failed accounting (results
        land in the outbox so telemetry attributes them), pending completion
        events are dropped, and the plane stops admitting. Returns the
        number of requests failed. The backend is NOT consulted — a crashed
        engine cannot be asked to release anything."""
        self.admitting = False
        n = 0
        for req in list(self.scheduler.running.values()):
            self.scheduler.detach(req.request_id)
            self._active_sessions.discard(req.session_id)
            self._finish(req, ttfb_ms=req.hint_ttfb_ms or 0.0,
                         completed=False, failed=cause)
            n += 1
        for q in self.scheduler.queues.values():
            while q:
                req = q.popleft()
                self._finish(req, ttfb_ms=0.0, completed=False, failed=cause)
                n += 1
        self._events.clear()
        return n

    # ------------------------------------------------------------------
    # driving
    # ------------------------------------------------------------------
    def run_until(self, t: float) -> None:
        """Process completion events up to absolute clock time ``t``;
        advances a virtual clock through each event in order."""
        while self._events and self._events[0][0] <= t:
            finish_at, _, req = heapq.heappop(self._events)
            now = self.clock.now()
            if finish_at > now:
                self.clock.sleep(finish_at - now)
            self._complete(req)
        now = self.clock.now()
        if t > now and isinstance(self.clock, VirtualClock):
            self.clock.advance(t - now)
        self._admit()

    def drain(self, *, max_rounds: int = 1_000_000) -> None:
        """Run until every queued/running request has completed."""
        rounds = 0
        while self.scheduler.running or self.scheduler.queue_depth():
            rounds += 1
            if rounds > max_rounds:
                raise RuntimeError("serving plane failed to drain")
            if self._events:
                finish_at, _, req = heapq.heappop(self._events)
                now = self.clock.now()
                if finish_at > now:
                    self.clock.sleep(finish_at - now)
                self._complete(req)
                continue
            if not self._round():
                # nothing active and no events: only queued work remains —
                # admission must be blocked; admit or bail
                before = self.scheduler.queue_depth()
                self._admit()
                if self.scheduler.queue_depth() == before and \
                        not self.scheduler.running:
                    break

    def serve(self, *, session_id: str, klass: str, prompt_tokens: int,
              gen_tokens: int, t_max_ms: float,
              request_id: Optional[str] = None,
              hint_ttfb_ms: Optional[float] = None,
              hint_total_ms: Optional[float] = None,
              prompt=None, resume: bool = False,
              adapter_id: str = "") -> PlaneResult:
        """Unary convenience: submit and drive the plane until THIS request
        completes (other in-flight sessions make progress too — decode
        rounds are shared)."""
        req = self.submit(
            session_id=session_id, klass=klass, prompt_tokens=prompt_tokens,
            gen_tokens=gen_tokens, t_max_ms=t_max_ms, request_id=request_id,
            hint_ttfb_ms=hint_ttfb_ms, hint_total_ms=hint_total_ms,
            prompt=prompt, resume=resume, adapter_id=adapter_id)
        if req is None:
            return PlaneResult(
                request_id="rejected", session_id=session_id, klass=klass,
                ttfb_ms=0.0, latency_ms=0.0, queue_wait_ms=0.0, tokens=0,
                completed=False, failed=FailureCause.COMPUTE_SCARCITY)
        guard = 0
        while req.request_id not in self._done:
            guard += 1
            if guard > 10_000_000:
                raise RuntimeError("request failed to complete")
            if self._events:
                finish_at, _, r = heapq.heappop(self._events)
                now = self.clock.now()
                if finish_at > now:
                    self.clock.sleep(finish_at - now)
                self._complete(r)
            elif not self._round():
                self._admit()
                if req.request_id not in self._done and \
                        req.request_id not in self.scheduler.running and \
                        not self._events:
                    # neither running nor done after an admission pass —
                    # fast-failed, or admission is blocked for good
                    break
        res = self._done.get(req.request_id)
        if res is None:
            raise RuntimeError(
                f"request {req.request_id} cannot progress "
                "(engine slot held outside the plane?)")
        return res

    # ------------------------------------------------------------------
    # results + telemetry surface
    # ------------------------------------------------------------------
    def pop_results(self) -> List[PlaneResult]:
        """Drain completed results (the orchestrator records telemetry and
        metering from these exactly once)."""
        out, self._outbox = self._outbox, []
        return out

    def result(self, request_id: str) -> Optional[PlaneResult]:
        return self._done.get(request_id)

    def load(self) -> PlaneLoad:
        """Measured congestion ξ for the analytics loop. Also drives the
        backend's idle-TTL tick (parked → hibernated), so tiering policy
        advances at heartbeat cadence without a separate timer."""
        tick = getattr(self.backend, "tick", None)
        if callable(tick):
            tick()
        occ_fn = getattr(self.backend, "occupancy", None)
        occ = occ_fn() if callable(occ_fn) else {}
        slots = max(self.scheduler.slots, 1)
        rate = 0.0
        if len(self._arrivals) >= 2:
            span = self.clock.now() - self._arrivals[0]
            if span > 0:
                rate = len(self._arrivals) / span
        return PlaneLoad(
            queue_depth=self.scheduler.queue_depth() / slots,
            arrival_rate=rate,
            running=len(self.scheduler.running),
            slots=slots,
            utilization=len(self.scheduler.running) / slots,
            **occ)
