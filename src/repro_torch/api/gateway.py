"""NorthboundGateway — the single CAPIF-style entry point to the AIS
lifecycle.

Everything an invoker can do goes through :meth:`handle` (typed messages)
or :meth:`handle_json` (the actual wire): DISCOVER / AI-PAGING / PREPARE /
COMMIT stepwise, streaming or async SERVE, HEARTBEAT (with Eq. 14 trigger
overrides), COMPLIANCE, RELEASE, and per-invoker event subscriptions that
surface state transitions and migration outcomes as
:class:`~repro_torch.api.messages.SessionEvent` notifications.

Gateway guarantees on top of the orchestrator:

* **schema-version negotiation** — messages (and the embedded ASP record)
  whose major version disagrees with the gateway's are refused with
  ``E_SCHEMA_VERSION`` before touching any lifecycle state;
* **idempotent PREPARE/COMMIT** — a retried request with the same
  ``idempotency_key`` returns the original outcome (success *or* error)
  instead of reserving twice; the same key with a different payload is an
  ``E_IDEMPOTENCY_CONFLICT``;
* **structured failure semantics** — every ``SessionError`` maps onto its
  distinct Eq. (12) error code (:data:`~repro_torch.api.messages.ERROR_CODE_TABLE`);
  gateway-layer refusals use disjoint codes;
* **deadline budgets** — a request carrying ``deadline_ms`` (the shrinking
  remaining budget, relative so clock skew cannot corrupt it) is refused
  with ``E_DEADLINE_EXCEEDED`` when the budget cannot cover the phase's
  Eq. (11) floor — the gateway never queues doomed work. The refusal does
  NOT fail the session: the invoker may re-issue with a larger budget;
* **orphan reaping** — ``reap_orphans()`` (run on every pump/drain cycle)
  aborts prepared-but-never-committed establishments once
  τ_prep + τ_com + hold has passed, so a COMMIT lost in flight can never
  strand provisional leases;
* **idempotency-window eviction** is attributable: a retry whose key aged
  out of the bounded window gets ``E_IDEMPOTENCY_EVICTED`` (we can no
  longer prove what the original outcome was) instead of silently
  re-reserving or tripping the state machine.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import json
from typing import Callable, Deque, Dict, Iterator, List, Optional, Tuple, Union

from repro_torch.api import messages as m
from repro_torch.core.asp import SchemaVersionError
from repro_torch.core.failures import FailureCause, SessionError
from repro_torch.core.migration import MigrationTriggers
from repro_torch.core.orchestrator import Orchestrator
from repro_torch.core.session import AISession, SessionState

Reply = Union[m.Message, List[m.Message]]


@dataclasses.dataclass
class _Pending:
    """Establishment state between stepwise procedures. The stored
    responses make keyless PAGE/PREPARE retries replay-safe: a duplicate
    (response lost in transport) returns the original outcome instead of
    tripping the state machine into FAILED."""
    session: AISession
    candidates: Optional[list] = None
    chosen: object = None
    prepared: object = None
    page_response: Optional[m.PageResponse] = None
    prepare_response: Optional[m.PrepareResponse] = None
    #: gateway-clock timestamp of the successful PREPARE — the orphan
    #: reaper's horizon base (works for local and federated prepares alike)
    prepared_at: Optional[float] = None


class NorthboundGateway:
    def __init__(self, orch: Optional[Orchestrator] = None, *, clock=None,
                 event_queue_len: int = 1024,
                 completion_buffer_len: int = 1 << 20,
                 idempotency_window: int = 4096,
                 establishment_window: int = 4096):
        # a federation DomainController is accepted in place of its core:
        # the gateway contract is unchanged, establishment just becomes
        # home-routed (home first, then east-west offers)
        if orch is not None and hasattr(orch, "core") and \
                isinstance(orch.core, Orchestrator):
            orch = orch.core
        self.orch = orch if orch is not None else Orchestrator(clock=clock)
        self.orch.result_sinks.append(self._on_result)
        self.orch.split_event_sinks.append(self._on_split_event)
        self._pending: Dict[str, _Pending] = {}
        self._prepared_refs: Dict[str, str] = {}     # ref -> session_id
        #: bounded retry window: oldest keys age out so a long-lived
        #: gateway does not grow with total session count
        self._idem: "collections.OrderedDict[str, Tuple[str, Reply]]" = \
            collections.OrderedDict()
        self._idempotency_window = idempotency_window
        #: keys aged out of the window — a retry under one of these gets a
        #: clean E_IDEMPOTENCY_EVICTED (the original outcome is gone, so
        #: replay safety can no longer be proven). Bounded like the window.
        self._idem_evicted: "collections.OrderedDict[str, bool]" = \
            collections.OrderedDict()
        #: abandoned-handshake bound: oldest in-flight establishments are
        #: evicted past the window (their provisional 2PC leases expire by
        #: TTL on the resource planes regardless)
        self._establishment_window = establishment_window
        self._subs: Dict[str, Deque[m.SessionEvent]] = {}
        #: async completions are buffered ONLY for requests that entered
        #: through submit() — unary serves (gateway or direct orchestrator
        #: callers) return their result inline and must not reappear here
        self._async_pending: set = set()
        self._completions: Deque[m.ServeComplete] = collections.deque(
            maxlen=completion_buffer_len)
        self._refs = itertools.count(1)
        self._event_queue_len = event_queue_len

    # ------------------------------------------------------------------
    # wire entry points
    # ------------------------------------------------------------------
    def handle_json(self, payload: str) -> Union[str, List[str]]:
        """The actual northbound wire: JSON in, JSON out (a streaming
        request returns a list of JSON frames, chunks then completion)."""
        try:
            msg = m.from_json(payload)
        except SchemaVersionError as e:
            return m.ErrorResponse("E_SCHEMA_VERSION",
                                   detail=str(e)).to_json()
        except ValueError as e:
            return m.ErrorResponse("E_BAD_REQUEST",
                                   detail=str(e)).to_json()
        except (TypeError, KeyError) as e:
            return m.ErrorResponse("E_BAD_REQUEST",
                                   detail=repr(e)).to_json()
        out = self.handle(msg)
        if isinstance(out, list):
            return [o.to_json() for o in out]
        return out.to_json()

    def handle(self, msg: m.Message) -> Reply:
        """Typed dispatch (the JSON path normalizes into here)."""
        ver = getattr(msg, "schema_version", m.SCHEMA_VERSION)
        if str(ver).split(".")[0] != m.SCHEMA_VERSION.split(".")[0]:
            return m.ErrorResponse(
                "E_SCHEMA_VERSION",
                detail=f"protocol {ver!r} incompatible with gateway "
                       f"{m.SCHEMA_VERSION!r}")
        handler = self._DISPATCH.get(type(msg))
        if handler is None:
            return m.ErrorResponse(
                "E_BAD_REQUEST",
                detail=f"{msg.TYPE!r} is not an invoker-initiated message")
        try:
            return handler(self, msg)
        except _Unknown as e:
            return m.ErrorResponse("E_UNKNOWN_SESSION", detail=str(e),
                                   session_id=e.session_id)
        except SessionError as e:
            return m.ErrorResponse.from_session_error(
                e, session_id=getattr(msg, "session_id", None))
        except Exception as e:                       # noqa: BLE001
            return m.ErrorResponse(
                "E_INTERNAL", detail=f"{type(e).__name__}: {e}",
                session_id=getattr(msg, "session_id", None))

    # ------------------------------------------------------------------
    # helpers
    # ------------------------------------------------------------------
    def _session(self, session_id: str) -> AISession:
        s = self.orch.sessions.get(session_id)
        if s is None:
            raise _Unknown(session_id)
        return s

    def _emit(self, session: AISession, event: str, *,
              state: Optional[str] = None, detail: Optional[dict] = None
              ) -> None:
        q = self._subs.get(session.invoker)
        if q is None:
            return
        q.append(m.SessionEvent(
            session_id=session.session_id, event=event,
            state=state if state is not None else session.state.value,
            detail=detail or {}, at_s=self.orch.clock.now()))

    def _on_split_event(self, session_id: str, event: str,
                        detail: dict) -> None:
        """SplitManager sink: split quality-tier transitions (degrade to
        edge-only, verify recovery, collapse, verify migration) surface to
        the invoker as explicit tier-change SessionEvents — an airplane
        -mode session is DEGRADED, never silently worse and never failed."""
        session = self.orch.sessions.get(session_id)
        if session is None:
            return
        self._emit(session, "tier-change",
                   detail={"event": event, **(detail or {})})

    def subscribe(self, invoker: str) -> None:
        """Open (or reset) the invoker's event subscription."""
        self._subs[invoker] = collections.deque(
            maxlen=self._event_queue_len)

    def poll_events(self, invoker: str) -> List[m.SessionEvent]:
        q = self._subs.get(invoker)
        if q is None:
            return []
        out = list(q)
        q.clear()
        return out

    @staticmethod
    def _fingerprint(req: m.Message) -> str:
        """Payload identity for idempotency conflict detection. The
        shrinking ``deadline_ms`` budget is excluded: an at-least-once
        re-send legitimately carries less remaining budget than the
        original, and that must read as the SAME request."""
        wire = req.to_wire()
        wire.pop("deadline_ms", None)
        return json.dumps(wire, sort_keys=True)

    def _idempotent(self, key: Optional[str], req: m.Message,
                    fn: Callable[[], Reply]) -> Reply:
        if key is not None and key in self._idem:
            fingerprint, reply = self._idem[key]
            if fingerprint != self._fingerprint(req):
                return m.ErrorResponse(
                    "E_IDEMPOTENCY_CONFLICT",
                    detail=f"key {key!r} was used for a different request",
                    session_id=getattr(req, "session_id", None))
            return reply
        if key is not None and key in self._idem_evicted:
            # the original outcome aged out of the bounded window: running
            # fn() again could double-reserve, so refuse attributably —
            # the invoker must start a fresh procedure (fresh key)
            return m.ErrorResponse(
                "E_IDEMPOTENCY_EVICTED",
                detail=f"[gateway] key {key!r} aged out of the idempotency "
                       f"window ({self._idempotency_window}); the original "
                       f"outcome is no longer known",
                session_id=getattr(req, "session_id", None))
        reply = fn()
        if key is not None:
            self._idem[key] = (self._fingerprint(req), reply)
            while len(self._idem) > self._idempotency_window:
                evicted_key, _ = self._idem.popitem(last=False)
                self._idem_evicted[evicted_key] = True
                while len(self._idem_evicted) > self._idempotency_window:
                    self._idem_evicted.popitem(last=False)
        return reply

    def _check_deadline(self, deadline_ms: Optional[float], floor_s: float,
                        phase: str,
                        session: Optional[AISession] = None) -> None:
        """Refuse work the remaining budget cannot cover (Eq. 11 floor for
        the phase). Attribution is per hop — this one is ``[gateway]``; a
        visited domain rejecting the forwarded remainder says
        ``[visited:<domain>]``. The budget is relative ms on the wire
        (gRPC-style), so client/server clock skew cannot corrupt it."""
        if deadline_ms is None:
            return
        floor_ms = max(floor_s, 0.0) * 1e3
        if deadline_ms <= floor_ms:
            raise SessionError(
                FailureCause.DEADLINE_EXCEEDED,
                f"[gateway] {phase}: {deadline_ms:.1f}ms remaining cannot "
                f"cover the {floor_ms:.0f}ms phase floor")
        if session is not None:
            session.deadline_at = self.orch.clock.now() + deadline_ms / 1e3

    def _drop_establishment_state(self, session_id: str) -> None:
        self._pending.pop(session_id, None)
        for ref in [r for r, sid in self._prepared_refs.items()
                    if sid == session_id]:
            del self._prepared_refs[ref]

    def _refailed(self, session: AISession) -> Optional[Reply]:
        """A lost-response retry against an already-failed session must
        re-report the ORIGINAL failure cause, not a bogus out-of-order
        ``E_BAD_REQUEST`` — the pending establishment state was dropped
        when the session failed, but the cause (and its retryability
        class) survives on the session itself."""
        if session.failure is None:
            return None
        return m.ErrorResponse.from_session_error(
            SessionError(session.failure,
                         f"establishment already failed "
                         f"({session.failure.value}); this retry re-reports "
                         f"the original outcome"),
            session_id=session.session_id)

    def _establishment_step(self, session: AISession,
                            fn: Callable[[], Reply]) -> Reply:
        """Run one establishment procedure; a SessionError fails the session
        (mirror of Orchestrator.establish) and maps to its error code."""
        try:
            return fn()
        except SessionError as e:
            session.fail(e.cause, str(e))
            self._drop_establishment_state(session.session_id)
            self._emit(session, "state-transition", state="failed",
                       detail={"cause": e.cause.value})
            return m.ErrorResponse.from_session_error(
                e, session_id=session.session_id)

    # ------------------------------------------------------------------
    # lifecycle procedures
    # ------------------------------------------------------------------
    def discover(self, msg: m.DiscoverRequest) -> Reply:
        self._check_deadline(msg.deadline_ms, self.orch.timers.tau_disc,
                             "DISCOVER")
        try:
            session = self.orch.begin_session(msg.asp, msg.invoker,
                                              msg.zone)
        except ValueError as e:
            # contract refused before any lifecycle state exists (invalid
            # ASP, or objectives incompatible with this gateway's Eq. 11
            # timer configuration) — an input refusal, not an internal error
            return m.ErrorResponse("E_BAD_REQUEST", detail=str(e))
        while len(self._pending) >= self._establishment_window:
            oldest = next(iter(self._pending))
            self._drop_establishment_state(oldest)
        self._pending[session.session_id] = _Pending(session)

        def run():
            cands = self.orch.discover_for(session)
            self._pending[session.session_id].candidates = cands
            self._emit(session, "state-transition")
            wire = [c.to_wire() for c in cands]
            return m.DiscoverResponse(session_id=session.session_id,
                                      candidates=wire)
        return self._establishment_step(session, run)

    def page(self, msg: m.PageRequest) -> Reply:
        session = self._session(msg.session_id)
        self._check_deadline(msg.deadline_ms, self.orch.timers.tau_page,
                             "AI-PAGING", session)
        pending = self._pending.get(msg.session_id)
        if pending is None or pending.candidates is None:
            return self._refailed(session) or m.ErrorResponse(
                "E_BAD_REQUEST", detail="PAGE before DISCOVER",
                session_id=msg.session_id)
        if pending.page_response is not None:
            return pending.page_response         # lost-response retry

        def run():
            chosen = self.orch.page_for(session, pending.candidates,
                                        tuple(msg.exclude_sites))
            pending.chosen = chosen
            self._emit(session, "state-transition")
            pending.page_response = m.PageResponse(
                session_id=session.session_id,
                model_id=chosen.model.model_id,
                model_version=chosen.model.version,
                site_id=chosen.site_id, klass=chosen.klass.name,
                predicted_cost_per_1k=chosen.prediction.cost_per_1k,
                domain=chosen.domain)
            return pending.page_response
        return self._establishment_step(session, run)

    def prepare(self, msg: m.PrepareRequest) -> Reply:
        session = self._session(msg.session_id)
        self._check_deadline(msg.deadline_ms, self.orch.timers.tau_prep,
                             "PREPARE", session)
        pending = self._pending.get(msg.session_id)
        if pending is None or pending.chosen is None:
            return self._refailed(session) or m.ErrorResponse(
                "E_BAD_REQUEST", detail="PREPARE before PAGE",
                session_id=msg.session_id)
        if pending.prepare_response is not None:
            return pending.prepare_response      # lost-response retry

        def run():
            def do():
                prepared = self.orch.prepare_for(session, pending.chosen)
                pending.prepared = prepared
                pending.prepared_at = self.orch.clock.now()
                ref = f"prep-{next(self._refs):06d}"
                self._prepared_refs[ref] = session.session_id
                self._emit(session, "state-transition")
                pending.prepare_response = m.PrepareResponse(
                    session_id=session.session_id, prepared_ref=ref,
                    site_id=prepared.site_id, qfi=prepared.qfi)
                return pending.prepare_response
            return self._establishment_step(session, do)
        return self._idempotent(msg.idempotency_key, msg, run)

    def commit(self, msg: m.CommitRequest) -> Reply:
        session = self._session(msg.session_id)
        self._check_deadline(msg.deadline_ms, self.orch.timers.tau_com,
                             "COMMIT", session)

        def run():
            pending = self._pending.get(msg.session_id)
            if self._prepared_refs.get(msg.prepared_ref) != msg.session_id \
                    or pending is None or pending.prepared is None:
                return self._refailed(session) or m.ErrorResponse(
                    "E_BAD_REQUEST",
                    detail=f"no commitable PREPARE under ref "
                           f"{msg.prepared_ref!r}",
                    session_id=msg.session_id)

            def do():
                self.orch.commit_for(session, pending.chosen,
                                     pending.prepared)
                self._pending.pop(msg.session_id, None)
                self._prepared_refs.pop(msg.prepared_ref, None)
                self._emit(session, "state-transition")
                return m.CommitResponse(
                    session_id=session.session_id, record=session.record(),
                    lease_s=self.orch.timers.lease_s,
                    at_s=self.orch.clock.now())
            return self._establishment_step(session, do)
        return self._idempotent(msg.idempotency_key, msg, run)

    # ------------------------------------------------------------------
    # serving
    # ------------------------------------------------------------------
    def _handle_serve(self, msg: m.ServeRequest) -> Reply:
        self._check_deadline(msg.deadline_ms, 0.0, "SERVE")
        if msg.stream:
            return list(self.serve_stream(msg))
        return self.submit(msg)

    def serve_stream(self, msg: m.ServeRequest) -> Iterator[m.Message]:
        """Unary-streaming serve: one ServeChunk per generated token, then
        a ServeComplete with the boundary-observable timings."""
        try:
            session = self._session(msg.session_id)
            prompt = None
            if msg.prompt is not None:
                import numpy as np
                prompt = np.asarray(msg.prompt, np.int32)
            res = self.orch.serve(
                session, prompt_tokens=msg.prompt_tokens,
                gen_tokens=msg.gen_tokens, prompt=prompt,
                request_id=msg.request_id, deadline_ms=msg.deadline_ms)
        except SessionError as e:
            yield m.ErrorResponse.from_session_error(
                e, session_id=msg.session_id)
            return
        for i in range(res.text_tokens):
            yield m.ServeChunk(
                session_id=msg.session_id, request_id=res.request_id, seq=i,
                token_id=res.token_ids[i] if res.token_ids else None)
        yield m.ServeComplete(
            session_id=msg.session_id, request_id=res.request_id,
            klass=res.klass, tokens=res.text_tokens,
            prompt_tokens=msg.prompt_tokens,
            ttfb_ms=res.ttfb_ms, latency_ms=res.latency_ms,
            queue_wait_ms=res.queue_wait_ms, completed=res.completed,
            error_code=m.code_for_cause(res.failed) if res.failed else None,
            token_ids=res.token_ids, at_s=self.orch.clock.now())

    def submit(self, msg: m.ServeRequest) -> Reply:
        """Async serve: enqueue on the anchor plane, acknowledge admission;
        the completion arrives through ``drain()`` / ``pump()``."""
        session = self._session(msg.session_id)
        prompt = None
        if msg.prompt is not None:
            import numpy as np
            prompt = np.asarray(msg.prompt, np.int32)
        req = self.orch.submit(
            session, prompt_tokens=msg.prompt_tokens,
            gen_tokens=msg.gen_tokens, prompt=prompt,
            request_id=msg.request_id, deadline_ms=msg.deadline_ms)
        if req is not None:
            self._async_pending.add(req.request_id)
        return m.SubmitAck(
            session_id=msg.session_id,
            request_id=req.request_id if req is not None else msg.request_id,
            accepted=req is not None, at_s=self.orch.clock.now())

    def _on_result(self, site, res) -> None:
        """Orchestrator result sink: every async-submitted request's
        PlaneResult becomes a buffered ServeComplete, whichever path
        (heartbeat/pump/drain) popped it; unary serves already returned
        their result inline and are not re-announced."""
        if res.request_id not in self._async_pending:
            return
        self._async_pending.discard(res.request_id)
        self._completions.append(m.ServeComplete(
            session_id=res.session_id, request_id=res.request_id,
            klass=res.klass, tokens=res.tokens,
            prompt_tokens=res.prompt_tokens, ttfb_ms=res.ttfb_ms,
            latency_ms=res.latency_ms, queue_wait_ms=res.queue_wait_ms,
            completed=res.completed,
            error_code=m.code_for_cause(res.failed) if res.failed else None,
            token_ids=res.token_ids, at_s=self.orch.clock.now()))

    def reap_orphans(self, now: Optional[float] = None) -> int:
        """Abort every prepared-but-never-committed establishment whose
        decision window (τ_prep + τ_com + hold) has passed — the COMMIT
        (or the client) was lost in flight, and nothing will re-drive it.

        Rollback is idempotent with the coordinator's own
        :meth:`~repro_torch.core.twophase.TwoPhaseCoordinator.reap` (whichever
        sweep runs first wins; the other is a no-op); federated prepares
        abort east-west, where EWAbort degenerates to release if the
        visited COMMIT had actually landed. Runs on every pump/drain
        cycle, i.e. the plane-heartbeat cadence."""
        orch = self.orch
        now = orch.clock.now() if now is None else now
        horizon = orch.timers.tau_prep + orch.timers.tau_com
        reaped = 0
        for sid in list(self._pending):
            p = self._pending.get(sid)
            if p is None or p.prepared is None or p.prepared_at is None:
                continue
            hold = getattr(p.prepared, "hold_s", 0.0)
            if now - p.prepared_at <= horizon + hold:
                continue
            try:
                if getattr(p.prepared, "is_federated", False):
                    orch.federation.abort_remote(p.prepared,
                                                 reason="orphan-reap")
                else:
                    orch.coordinator.abort(p.prepared)
            except Exception:                        # noqa: BLE001
                pass         # provisional leases expire by TTL regardless
            session = p.session
            self._drop_establishment_state(sid)
            if session.state is SessionState.PREPARED:
                session.fail(FailureCause.DEADLINE_EXPIRY,
                             "orphaned PREPARE reaped "
                             "(COMMIT lost in flight)")
                self._emit(session, "state-transition", state="failed",
                           detail={"cause":
                                   FailureCause.DEADLINE_EXPIRY.value,
                                   "detail": "orphan-reap"})
            reaped += 1
        return reaped

    def pump(self, until_s: float) -> None:
        """Advance every site plane to absolute time ``until_s`` (virtual
        clocks) and record the completions that fell due."""
        for site in self.orch.sites.values():
            if site.plane is not None:
                site.plane.run_until(until_s)
                self.orch.record_results(site)
        self.reap_orphans()

    def drain(self) -> List[m.ServeComplete]:
        """Run every plane to completion and return ALL completions
        recorded since the last drain (async submits + heartbeat pickups)."""
        for site in self.orch.sites.values():
            if site.plane is not None:
                site.plane.drain()
                self.orch.record_results(site)
        self.reap_orphans()
        out = list(self._completions)
        self._completions.clear()
        return out

    def poll_completions(self, invoker: str) -> List[m.ServeComplete]:
        """Wire counterpart of ``drain()`` for ONE invoker: hand over (and
        remove) the buffered async completions of that invoker's sessions.
        Does not force the planes forward — completions appear as serves,
        heartbeats, and pump/drain cycles record them."""
        mine, keep = [], []
        for c in self._completions:
            s = self.orch.sessions.get(c.session_id)
            if s is not None and s.invoker == invoker:
                mine.append(c)
            else:
                keep.append(c)
        self._completions = collections.deque(
            keep, maxlen=self._completions.maxlen)
        return mine

    def _handle_completion_poll(self, msg: m.CompletionPoll) -> Reply:
        return list(self.poll_completions(msg.invoker))

    # ------------------------------------------------------------------
    # tenant adapter lifecycle
    # ------------------------------------------------------------------
    def register_adapter(self, msg: m.RegisterAdapterRequest) -> Reply:
        """Publish a versioned adapter into the domain catalog (weights
        materialised deterministically from the seed — the stand-in for
        a tenant upload). Duplicate keys and unknown base models are
        input refusals, not lifecycle failures."""
        from repro_torch.adapters.catalog import AdapterSpec
        spec = AdapterSpec(
            adapter_id=msg.adapter_id, version=msg.version,
            base_model_id=msg.base_model_id,
            base_model_version=msg.base_model_version,
            rank=int(msg.rank), regions=tuple(msg.regions),
            scale=float(msg.scale), seed=int(msg.seed))
        try:
            stored = self.orch.catalog.register_adapter(spec)
        except ValueError as e:
            return m.ErrorResponse("E_BAD_REQUEST", detail=str(e))
        return m.RegisterAdapterResponse(
            adapter_id=stored.adapter_id, version=stored.version,
            base_model_id=stored.base_model_id,
            weight_fingerprint=stored.weight_fingerprint,
            at_s=self.orch.clock.now())

    def _adapter_site(self, site_id: str):
        site = self.orch.sites.get(site_id)
        if site is None:
            return None, m.ErrorResponse(
                "E_BAD_REQUEST", detail=f"unknown site {site_id!r}")
        return site, None

    def load_adapter(self, msg: m.LoadAdapterRequest) -> Reply:
        site, err = self._adapter_site(msg.site_id)
        if err is not None:
            return err
        adapters = self.orch.catalog.adapters
        try:
            spec = adapters.get(msg.adapter_id, msg.version or None)
        except KeyError:
            raise SessionError(
                FailureCause.MODEL_UNAVAILABLE,
                f"adapter {msg.adapter_id!r} is not registered") from None
        if site.spec.region not in spec.regions:
            raise SessionError(
                FailureCause.SOVEREIGNTY_VIOLATION,
                f"adapter {spec.key} not licensed for region "
                f"{site.spec.region!r}")
        engine_loaded = False
        backend = self.orch.plane_for(site).backend
        eng = getattr(backend, "engine", None)
        if eng is not None and getattr(eng, "adapters", None) is not None:
            a, b = adapters.weights(spec.adapter_id, spec.version)
            eng.load_adapter(spec.adapter_id, a, b)
            engine_loaded = True
        adapters.mark_loaded(spec.adapter_id, msg.site_id)
        return m.LoadAdapterResponse(
            adapter_id=spec.adapter_id, site_id=msg.site_id, loaded=True,
            engine_loaded=engine_loaded, at_s=self.orch.clock.now())

    def unload_adapter(self, msg: m.UnloadAdapterRequest) -> Reply:
        site, err = self._adapter_site(msg.site_id)
        if err is not None:
            return err
        adapters = self.orch.catalog.adapters
        try:
            spec = adapters.get(msg.adapter_id)
        except KeyError:
            raise SessionError(
                FailureCause.MODEL_UNAVAILABLE,
                f"adapter {msg.adapter_id!r} is not registered") from None
        live = (SessionState.PREPARED, SessionState.COMMITTED,
                SessionState.MIGRATING)
        bound = [s.session_id for s in self.orch.sessions.values()
                 if s.state in live and s.binding is not None
                 and s.binding.site_id == msg.site_id
                 and s.asp.adapter_id == spec.adapter_id]
        if bound:
            return m.ErrorResponse(
                "E_BAD_REQUEST", session_id=None,
                detail=f"adapter {spec.adapter_id!r} still bound at "
                       f"{msg.site_id} by live sessions {bound[:3]}")
        backend = self.orch.plane_for(site).backend
        eng = getattr(backend, "engine", None)
        if eng is not None and getattr(eng, "adapters", None) is not None \
                and eng.adapters.is_loaded(spec.adapter_id):
            try:
                eng.unload_adapter(spec.adapter_id)
            except RuntimeError as e:     # engine slots still bound
                return m.ErrorResponse("E_BAD_REQUEST", detail=str(e),
                                       session_id=None)
        adapters.mark_unloaded(spec.adapter_id, msg.site_id)
        return m.UnloadAdapterResponse(
            adapter_id=spec.adapter_id, site_id=msg.site_id, unloaded=True,
            at_s=self.orch.clock.now())

    # ------------------------------------------------------------------
    # continuity + teardown
    # ------------------------------------------------------------------
    def heartbeat(self, msg: m.HeartbeatReport) -> Reply:
        session = self._session(msg.session_id)
        self._check_deadline(msg.deadline_ms, 0.0, "HEARTBEAT", session)
        trig = None
        if msg.trigger_l99 is not None or msg.trigger_ttfb is not None:
            base = MigrationTriggers()
            trig = MigrationTriggers(
                delta_l99=msg.trigger_l99 if msg.trigger_l99 is not None
                else base.delta_l99,
                delta_ttfb=msg.trigger_ttfb if msg.trigger_ttfb is not None
                else base.delta_ttfb)
        outcome = self.orch.heartbeat(session, trig)
        wire = None
        if outcome is not None:
            wire = m.outcome_to_wire(outcome)
            self._emit(session, "migration", detail=wire)
        return m.HeartbeatAck(
            session_id=msg.session_id, committed=session.committed(),
            lease_s=self.orch.timers.lease_s, migration=wire,
            at_s=self.orch.clock.now())

    def compliance(self, msg: m.ComplianceRequest) -> Reply:
        session = self._session(msg.session_id)
        rep = self.orch.compliance(session)
        tele = self.orch.telemetry.get(msg.session_id)
        if rep is None:
            return m.ComplianceReport(session_id=msg.session_id)
        return m.ComplianceReport(
            session_id=msg.session_id, in_compliance=rep.in_compliance,
            z=dataclasses.asdict(rep.z), n=len(tele) if tele else 0)

    def release(self, msg: m.ReleaseRequest) -> Reply:
        session = self._session(msg.session_id)
        tokens, cost = 0, 0.0
        if session.charging_ref is not None:
            rec = self.orch.policy.charging(session.charging_ref)
            tokens, cost = rec.tokens, rec.cost
        self.orch.release(session)
        self._drop_establishment_state(msg.session_id)
        self._emit(session, "state-transition")
        return m.ReleaseAck(session_id=msg.session_id,
                            state=session.state.value,
                            tokens=tokens, total_cost=cost)

    def _handle_event_poll(self, msg: m.EventPoll) -> Reply:
        return list(self.poll_events(msg.invoker))

    # ------------------------------------------------------------------
    _DISPATCH: Dict[type, Callable] = {
        m.DiscoverRequest: discover,
        m.PageRequest: page,
        m.PrepareRequest: prepare,
        m.CommitRequest: commit,
        m.ServeRequest: _handle_serve,
        m.HeartbeatReport: heartbeat,
        m.ComplianceRequest: compliance,
        m.ReleaseRequest: release,
        m.EventPoll: _handle_event_poll,
        m.CompletionPoll: _handle_completion_poll,
        m.RegisterAdapterRequest: register_adapter,
        m.LoadAdapterRequest: load_adapter,
        m.UnloadAdapterRequest: unload_adapter,
    }


class _Unknown(Exception):
    """Unknown session id — a gateway-layer refusal (``E_UNKNOWN_SESSION``),
    deliberately NOT a SessionError: no Eq. (12) cause applies because the
    request never reached the lifecycle machinery."""

    def __init__(self, session_id: str):
        super().__init__(f"unknown session {session_id!r}")
        self.session_id = session_id
