"""NE-AIaaS orchestrator: the end-to-end lifecycle facade (Fig. 1).

    establish(asp) = consent → DISCOVER → AI-PAGING → PREPARE → COMMIT
    serve(session, request)   — boundary telemetry + metering per request
    heartbeat(session)        — lease renewal + Eq. 14 migration triggers
    release(session)

Every phase runs under its Eq. (11) deadline and failures carry Eq. (12)
causes. The orchestrator owns the role composition (exposure/catalog/
execution/transport/analytics) but no business logic of its own — each
procedure lives in its module and is individually testable.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

from repro_torch.core.analytics import Analytics
from repro_torch.core.asp import ASP
from repro_torch.core.catalog import Catalog, default_catalog
from repro_torch.core.clock import Clock
from repro_torch.core.discovery import discover
from repro_torch.core.failures import FailureCause, SessionError, Timers
from repro_torch.core.migration import (MigrationController, MigrationOutcome,
                                  MigrationTriggers, PlaneTransferPath)
from repro_torch.core.paging import page
from repro_torch.core.policy import PolicyControl
from repro_torch.core.predictors import Predictors
from repro_torch.core.qos import QoSFlowManager
from repro_torch.core.session import AISession, SessionState
from repro_torch.core.sites import ExecutionSite, default_sites
from repro_torch.core.telemetry import BoundaryTelemetry, RequestRecord
from repro_torch.core.twophase import TwoPhaseCoordinator
from repro_torch.netfault.breaker import BreakerBoard


@dataclass
class ServeResult:
    text_tokens: int
    ttfb_ms: float
    latency_ms: float
    completed: bool
    queue_wait_ms: float = 0.0
    failed: Optional[FailureCause] = None
    request_id: str = ""
    klass: str = ""                    # QoS class the request rode
    token_ids: Optional[list] = None   # real-engine backends only


@dataclass
class ReanchorOutcome:
    """Result of one crash-recovery re-anchoring (supervisor path)."""
    ok: bool
    from_site: str
    to_site: Optional[str] = None
    #: the new anchor resumed the session's state from the hibernation
    #: store (host memory survives an engine crash); False = fresh context
    restored: bool = False
    cause: Optional[FailureCause] = None


class Orchestrator:
    def __init__(self, clock: Optional[Clock] = None,
                 catalog: Optional[Catalog] = None,
                 sites: Optional[Dict[str, ExecutionSite]] = None,
                 timers: Optional[Timers] = None):
        self.clock = clock or Clock()
        self.catalog = catalog or default_catalog()
        hosted = self.catalog.keys()
        self.sites = sites or default_sites(self.clock, hosted)
        self.qos = QoSFlowManager(self.clock)
        self.policy = PolicyControl(self.clock)
        self.analytics = Analytics(self.clock)
        self.predictors = Predictors(self.analytics)
        self.timers = timers or Timers()
        self.coordinator = TwoPhaseCoordinator(self.clock, self.sites,
                                               self.qos, self.timers)
        #: per-site circuit breakers (closed → open → half-open): fed by
        #: the site supervisors' probe outcomes; DISCOVER excludes open
        #: targets with the attributable reason ``circuit-open`` and the
        #: half-open transition probes them back in
        self.breakers = BreakerBoard(self.clock)
        self.migrations = MigrationController(
            self.clock, self.coordinator, self.catalog, self.sites,
            self.predictors, self.timers, analytics=self.analytics)
        # migration rides the REAL serving-plane data plane by default:
        # export/import between the sites' backends with fingerprint
        # verification and mid-stream handover (real engines and the
        # SimulatedEngine §V arm speak the same slot protocol)
        self.migrations.transfer_fn = PlaneTransferPath(
            self.plane_for, clock=self.clock)
        self.telemetry: Dict[str, BoundaryTelemetry] = {}
        self.sessions: Dict[str, AISession] = {}
        #: callables ``(site, PlaneResult)`` notified for every result the
        #: single recorder drains — the northbound gateway subscribes here
        #: so async completions reach the invoker whichever path pops them
        self.result_sinks: list = []
        #: set by a federation DomainController: this orchestrator becomes
        #: the HOME core of that domain — DISCOVER merges east-west offers
        #: (home-first) and PREPARE/COMMIT route cross-domain for remote
        #: candidates. None ⇒ single-domain behaviour, unchanged.
        self.federation = None
        #: set by a splitserve SplitManager: establishment may realize an
        #: ASP as a TWO-anchor split (edge draft + verify) when the ASP's
        #: split_policy allows it. None ⇒ single-anchor only, unchanged.
        self.splits = None
        #: callables ``(session_id, event, detail)`` notified on split
        #: quality-tier transitions (established/degraded/recovered/
        #: collapsed/verify-migrated) — the gateway subscribes here so
        #: tier changes reach the invoker as SessionEvents
        self.split_event_sinks: list = []

    # ------------------------------------------------------------------
    # stepwise lifecycle procedures — each northbound-drivable on its own;
    # establish() composes them under the Eq. (11) deadline chain
    # ------------------------------------------------------------------
    def begin_session(self, asp: ASP, invoker: str, zone: str) -> AISession:
        """Create the AIS record and bind consent (R7) before any
        reservation is attempted."""
        self.timers.validate(asp.objectives.t_max_ms / 1e3)
        session = AISession(asp, invoker, zone, self.clock,
                            sites=self.sites, qos=self.qos,
                            policy=self.policy)
        self.sessions[session.session_id] = session
        session.authz_ref = self.policy.grant_consent(
            invoker, asp.allowed_regions)
        return session

    def discover_for(self, session: AISession) -> list:
        """DISCOVER (Eq. 7/8): annotated candidate set under τ_disc. With
        a federation attached, this is home-routed: local candidates first,
        east-west offers merged in (per the domain's solicit policy) with
        exclusion reasons prefixed by the owning domain."""
        t0 = self.clock.now()
        cands = discover(session.asp, self.catalog, self.sites,
                         self.predictors, session.zone,
                         analytics=self.analytics, breakers=self.breakers)
        if self.federation is not None:
            cands = self.federation.augment(session, cands)
        if self.clock.now() - t0 > self.timers.tau_disc:
            raise SessionError(FailureCause.DEADLINE_EXPIRY,
                               "DISCOVER exceeded τ_disc")
        session.mark_discovered()
        return cands

    def page_for(self, session: AISession, cands: list,
                 exclude_sites: tuple = ()):
        """AI-PAGING (Eq. 9) + policy admission against the chosen anchor."""
        chosen = page(session.asp, cands, exclude_sites=exclude_sites)
        session.mark_anchored()
        # cost-envelope admission (policy role)
        self.policy.admit_cost(session.asp, chosen.prediction.cost_per_1k)
        # sovereignty re-check against the concrete site (consent scope);
        # east-west offers carry the region — the remote site table doesn't
        # exist here
        region = chosen.region or self.sites[chosen.site_id].spec.region
        self.policy.check_region(session.authz_ref, region)
        return chosen

    def prepare_for(self, session: AISession, chosen):
        """PREPARE: provisional co-reservation on both planes (2PC stage 1).
        A remote candidate routes the compute half east-west; the home
        domain keeps only its transport share."""
        self._check_adapter_binding(session, chosen)
        session.mark_preparing()
        if self.federation is not None and self.federation.is_remote(chosen):
            prepared = self.federation.prepare_remote(session, chosen)
        else:
            prepared = self.coordinator.prepare(
                chosen.model, chosen.site_id, session.zone, chosen.klass,
                slots=1, cache_bytes=chosen.model.session_state_bytes(2048))
        session.mark_prepared()
        return prepared

    def _check_adapter_binding(self, session: AISession, chosen) -> None:
        """Fail fast at PREPARE when the ASP names an adapter this
        catalog cannot resolve, or one whose base does not match the
        chosen model (outside the declared fallback ladder). Without
        this the unknown id would ride all the way to the engine bind
        and surface as an opaque serve failure."""
        aid = session.asp.adapter_id
        if not aid:
            return
        try:
            spec = self.catalog.adapters.get(aid)
        except KeyError:
            raise SessionError(
                FailureCause.NO_FEASIBLE_BINDING,
                f"unknown adapter {aid!r}: not registered in the "
                f"catalog") from None
        ladder = {m for m, _ in session.asp.fallback_ladder}
        if chosen.model.model_id != spec.base_model_id \
                and chosen.model.model_id not in ladder:
            raise SessionError(
                FailureCause.NO_FEASIBLE_BINDING,
                f"adapter {aid!r} targets base {spec.base_model_id!r}; "
                f"chosen model {chosen.model.model_id!r} is not its base "
                f"and not on the fallback ladder")

    def commit_for(self, session: AISession, chosen, prepared) -> AISession:
        """COMMIT: confirm both leases, bind, open charging + telemetry.
        For a cross-domain PREPARE the visited half stays provisional until
        this home COMMIT lands; failure on either side rolls both back."""
        if getattr(prepared, "is_federated", False):
            binding = self.federation.commit_remote(session, chosen,
                                                    prepared)
        else:
            binding = self.coordinator.commit(prepared, chosen.model)
        session.charging_ref = self.policy.open_charging(session.session_id)
        session.bind(binding)
        self.telemetry[session.session_id] = BoundaryTelemetry()
        return session

    def establish(self, asp: ASP, invoker: str, zone: str) -> AISession:
        """DISCOVER → PAGING → PREPARE/COMMIT under Eq. (11) deadlines."""
        session = self.begin_session(asp, invoker, zone)
        try:
            # split establishment first when the ASP consents: "require"
            # propagates any refusal; "auto" falls through to the normal
            # single-anchor path when no feasible split exists
            if self.splits is not None \
                    and asp.split_policy != "never" \
                    and self.splits.try_establish(session):
                return session
            cands = self.discover_for(session)
            chosen = self.page_for(session, cands)
            prepared = self.prepare_for(session, chosen)
            self.commit_for(session, chosen, prepared)
            return session
        except SessionError as e:
            session.fail(e.cause, str(e))
            raise

    # ------------------------------------------------------------------
    # serving plane plumbing
    # ------------------------------------------------------------------
    def plane_for(self, site) -> "ServingPlane":
        """The QoS-scheduled serving plane of one site. Real-engine planes
        are attached by AIaaSServer / launch.serve; absent those, a
        predictor-backed SimulatedEngine plane is created lazily so the
        control plane ALWAYS serves through the same scheduled path."""
        if getattr(site, "is_guest_view", False):
            return site.plane        # ensured by the owning domain's core
        if site.plane is None:
            from repro_torch.serving.plane import ServingPlane, SimulatedEngine
            site.attach_plane(ServingPlane(
                self.clock, SimulatedEngine(self.clock),
                slots=site.spec.decode_slots,
                site_id=site.spec.site_id))
        return site.plane

    def qos_class(self, session: AISession):
        """TransportClass of the session's committed QoS flow — derived from
        the binding's QFI lease, not re-guessed from the tier."""
        from repro_torch.core.qos import PREMIUM, BEST_EFFORT
        lease = self.qos.get(session.binding.qos_lease_id)
        if lease is not None:
            return lease.klass
        return PREMIUM if session.asp.tier >= 2 else BEST_EFFORT

    def record_results(self, site) -> list:
        """Drain the site plane's completed requests into boundary telemetry
        and charging — exactly once per request, for every session; returns
        the drained PlaneResults. This is the ONLY recorder: AIaaSServer
        and heartbeat both delegate here, so a request is billed identically
        whichever path pops it first. A guest view delegates to the OWNING
        domain's recorder (which meters wholesale and forwards roaming
        results home) so two domains never race on one plane's results."""
        if getattr(site, "is_guest_view", False):
            return site.record_results()
        plane = site.plane
        if plane is None:
            return []
        popped = plane.pop_results()
        for res in popped:
            self._record_one(site, res)
        return popped

    def _record_one(self, site, res, *, price_override=None) -> None:
        """Record ONE drained PlaneResult: telemetry, context accounting,
        charging, result sinks. ``price_override`` replaces the catalog
        price for roaming sessions whose model lives in another domain's
        catalog (the retail price from the accepted east-west offer)."""
        session = self.sessions.get(res.session_id)
        if session is None:
            return
        tele = self.telemetry.get(res.session_id)
        if tele is not None:
            tele.record(RequestRecord(
                t_submit=self.clock.now() - res.latency_ms / 1e3,
                ttfb_ms=res.ttfb_ms, latency_ms=res.latency_ms,
                completed=res.completed, tokens=res.tokens,
                queue_ms=res.queue_wait_ms))
        # context accounting: the session's actual served context sizes
        # any later migration payload / PREPARE cache reservation
        if res.tokens:
            session.note_context(res.prompt_tokens + res.tokens)
        if session.charging_ref is not None and res.tokens:
            b = session.binding
            if price_override is not None:
                price = price_override
            else:
                model = self._model_entry(b)
                price = model.price_per_1k_tokens if model else 0.0
            # chip time = slot occupancy only; queue wait is not billed
            service_s = max(res.latency_ms - res.queue_wait_ms, 0.0) / 1e3
            self.policy.meter(
                session.charging_ref, tokens=res.tokens,
                chip_s=service_s * site.spec.chips
                / max(site.spec.decode_slots, 1),
                unit_price=price)
        for sink in self.result_sinks:
            sink(site, res)

    # ------------------------------------------------------------------
    def _model_entry(self, binding):
        """The binding's ModelEntry, or None when the session roams on a
        model this domain's catalog does not carry (predictor hints and
        catalog pricing degrade gracefully; the visited domain holds the
        authoritative entry)."""
        if binding is None:
            return None
        try:
            return self.catalog.get(binding.model_id, binding.model_version)
        except KeyError:
            return None

    # ------------------------------------------------------------------
    def _service_hints(self, session: AISession, plane, model, site, klass,
                       prompt_tokens: int, gen_tokens: int):
        """Predictor-supplied (ttfb, total) service-time hints, only for
        backends that declare they need them (capability check, not
        type-sniffing of serving internals)."""
        if model is None or \
                not getattr(plane.backend, "needs_service_hints", False):
            return None, None
        pred = self.predictors.predict(session.asp, model, site,
                                       session.zone, klass,
                                       prompt_tokens=prompt_tokens,
                                       gen_tokens=gen_tokens)
        return (pred.t_ff_ms,
                pred.t_ff_ms + gen_tokens * pred.decode_ms_per_token)

    def _serve_checked(self, session: AISession):
        """Common serve-side admission: Eq. (6) consent + committed domain;
        returns (site, model, plane, klass) for the session's anchor."""
        if not session.serve_allowed():
            if not session.v_sigma():
                raise SessionError(FailureCause.CONSENT_VIOLATION,
                                   "consent revoked ⇒ ServeDisabled (Eq. 6)")
            raise SessionError(FailureCause.DEADLINE_EXPIRY,
                               "session not in committed domain")
        b = session.binding
        site = self.sites[b.site_id]
        return (site, self._model_entry(b), self.plane_for(site),
                self.qos_class(session))

    # ------------------------------------------------------------------
    def _effective_t_max(self, session: AISession,
                         deadline_ms: Optional[float]) -> float:
        """Per-request deadline for the plane's fast-fail admission: the
        ASP bound, shrunk to the caller's remaining ``deadline_ms`` budget
        when one was propagated — a hop never queues work it cannot
        finish in the budget that is actually left."""
        t_max = session.asp.objectives.t_max_ms
        if deadline_ms is not None:
            t_max = min(t_max, deadline_ms)
        return t_max

    def submit(self, session: AISession, *, prompt_tokens: int = 512,
               gen_tokens: int = 64, prompt=None,
               request_id: Optional[str] = None,
               deadline_ms: Optional[float] = None):
        """Async path: enqueue one request on the anchor plane without
        driving it (batched serving / open-loop simulation); returns the
        scheduler Request, or None when admission control rejects it.
        Completions surface through ``record_results`` → ``result_sinks``."""
        site, model, plane, klass = self._serve_checked(session)
        hint_ttfb, hint_total = self._service_hints(
            session, plane, model, site, klass, prompt_tokens, gen_tokens)
        return plane.submit(
            session_id=session.session_id, klass=klass.name,
            prompt_tokens=prompt_tokens, gen_tokens=gen_tokens,
            t_max_ms=self._effective_t_max(session, deadline_ms),
            hint_ttfb_ms=hint_ttfb, hint_total_ms=hint_total,
            request_id=request_id, prompt=prompt,
            adapter_id=session.asp.adapter_id)

    # ------------------------------------------------------------------
    def serve(self, session: AISession, *, prompt_tokens: int = 512,
              gen_tokens: int = 64, prompt=None,
              request_id: Optional[str] = None,
              deadline_ms: Optional[float] = None) -> ServeResult:
        """One request through the anchor site's ServingPlane.

        The QoS class comes from the binding's QFI; admission is
        class-ordered with premium reservation and deadline fast-fail. With
        a real engine behind the plane this runs actual prefill/decode
        rounds (examples/); otherwise the SimulatedEngine backend uses
        predictor service times (control-plane tests). Either way the
        boundary telemetry and metering are identical — that's the
        falsifiability point.
        """
        site, model, plane, klass = self._serve_checked(session)
        hint_ttfb, hint_total = self._service_hints(
            session, plane, model, site, klass, prompt_tokens, gen_tokens)
        res = plane.serve(
            session_id=session.session_id, klass=klass.name,
            prompt_tokens=prompt_tokens, gen_tokens=gen_tokens,
            t_max_ms=self._effective_t_max(session, deadline_ms),
            request_id=request_id,
            hint_ttfb_ms=hint_ttfb, hint_total_ms=hint_total, prompt=prompt,
            adapter_id=session.asp.adapter_id)
        self.record_results(site)
        return ServeResult(res.tokens, res.ttfb_ms, res.latency_ms,
                           res.completed, queue_wait_ms=res.queue_wait_ms,
                           failed=res.failed, request_id=res.request_id,
                           klass=res.klass, token_ids=res.token_ids)

    # ------------------------------------------------------------------
    def heartbeat(self, session: AISession,
                  triggers: Optional[MigrationTriggers] = None
                  ) -> Optional[MigrationOutcome]:
        """Renew leases; fire Eq. (14) migration when risk crosses δ."""
        # heartbeat cadence doubles as the orphan sweep: provisional 2PC
        # leases whose COMMIT/ABORT was lost in flight are aborted once
        # their τ_prep + τ_com + hold window passes (timers are enforced)
        self.coordinator.reap()
        if session.state not in (SessionState.COMMITTED,
                                 SessionState.MIGRATING):
            return None
        session.renew(self.timers.lease_s)
        # consent is a bounded authorization with a sliding window: an
        # actively heartbeating session keeps its grant alive through the
        # same northbound surface that renews the leases; revoked grants
        # and sessions that stop heartbeating lapse (Eq. 6)
        self.policy.renew_consent(session.authz_ref)
        # a split session's SECOND (verify) anchor renews through the same
        # beat: lease lapse degrades to edge-only, collapsed acceptance
        # un-splits (both emit quality-tier events, never failures)
        if self.splits is not None:
            self.splits.heartbeat(session)
        site = self.sites[session.binding.site_id]
        # live congestion from the site's serving plane (NWDAF loop): queue
        # depth per slot and arrival rate are MEASURED, not assumed — this is
        # what makes paging (Eq. 9) and migration triggers (Eq. 14) react to
        # real load instead of static zeros.
        plane = site.plane
        load = plane.load() if plane is not None else None
        self.analytics.observe_site(
            site.spec.site_id, utilization=site.utilization(),
            queue_depth=load.queue_depth if load else 0.0,
            arrival_rate=load.arrival_rate if load else 0.0,
            page_util=getattr(load, "page_util", 0.0) if load else 0.0)
        if plane is not None:
            self.record_results(site)   # pick up async completions
        tele = self.telemetry.get(session.session_id)
        if tele and len(tele) >= 8:
            z = tele.snapshot()
            self.analytics.observe_latency(
                site.spec.site_id,
                f"{session.binding.model_id}@{session.binding.model_version}",
                z.q99_ms)
        trig = triggers or MigrationTriggers()
        if session.asp.continuity_required() and \
                self.migrations.check_trigger(session, session.zone, trig):
            return self.migrations.migrate(session, session.zone)
        return None

    # ------------------------------------------------------------------
    def reanchor(self, session: AISession, *, exclude_sites: tuple = (),
                 state_source=None) -> ReanchorOutcome:
        """AI-PAGING re-anchoring for a session orphaned by a site crash.

        Unlike ``migrations.migrate`` this never touches the old anchor —
        there is nothing to export from a dead engine. The session
        re-discovers (the dead site is excluded via the analytics
        ``site-dead`` verdict), re-prepares at a paged-in site under
        τ_mig, and binds; make-before-break degenerates to plain re-anchor
        because the old leases are already void. ``state_source`` is a
        surviving :class:`HibernationStore` (host memory outlives the
        engine process): when it holds the session's state, the new
        anchor's backend re-imports it so generation resumes bit-exactly;
        a corrupt or refused restore degrades to a fresh context rather
        than failing the re-anchor. On failure the session FAILs with the
        Eq. 12 cause (NO_FEASIBLE_BINDING / COMPUTE_SCARCITY /
        DEADLINE_EXPIRY), which is the attributable loss accounting the
        recovery bench measures."""
        src = session.binding.site_id if session.binding else ""
        excl = tuple(exclude_sites) or ((src,) if src else ())
        t0 = self.clock.now()
        try:
            if session.state is SessionState.COMMITTED:
                session.mark_migrating()
            elif session.state is not SessionState.MIGRATING:
                raise SessionError(
                    FailureCause.POLICY_DENIAL,
                    f"re-anchor from state {session.state.value}")
            if self.federation is not None:
                cands = self.federation.merged_discover(
                    session, session.zone, exclude_sites=excl)
            else:
                cands = discover(session.asp, self.catalog, self.sites,
                                 self.predictors, session.zone,
                                 analytics=self.analytics,
                                 breakers=self.breakers)
            target = page(session.asp, cands, exclude_sites=excl)
            region = target.region or self.sites[target.site_id].spec.region
            self.policy.check_region(session.authz_ref, region)
            ctx = self.migrations.context_tokens(session)
            remote = self.federation is not None \
                and self.federation.is_remote(target)
            if remote:
                prepared = self.federation.prepare_remote(
                    session, target, hold_s=self.timers.tau_mig,
                    context_tokens=ctx)
                binding = self.federation.commit_remote(session, target,
                                                        prepared)
            else:
                prepared = self.coordinator.prepare(
                    target.model, target.site_id, session.zone,
                    target.klass, slots=1,
                    cache_bytes=target.model.session_state_bytes(ctx),
                    hold_s=self.timers.tau_mig)
                binding = self.coordinator.commit(prepared, target.model)
            if self.clock.now() - t0 > self.timers.tau_mig:
                raise SessionError(FailureCause.DEADLINE_EXPIRY,
                                   "re-anchor deadline expired (τ_mig)")
            session.bind(binding)    # old leases void: release is a no-op
            restored = False
            if state_source is not None and not remote \
                    and state_source.has(session.session_id):
                restored = self._restore_state(session, target,
                                               state_source)
            session.history.append(
                (self.clock.now(), f"re-anchored:{src}->{target.site_id}"))
            return ReanchorOutcome(True, src, target.site_id, restored)
        except SessionError as e:
            session.fail(e.cause, str(e))
            return ReanchorOutcome(False, src, cause=e.cause)

    def _restore_state(self, session: AISession, target,
                       state_source) -> bool:
        """Best-effort state resume at the new anchor: verified restore →
        backend import → drop the store copy (only after the import holds
        it). Corruption (IOError) or target admission refusal leaves the
        session re-anchored with a fresh context."""
        backend = self.plane_for(self.sites[target.site_id]).backend
        if not hasattr(backend, "import_slot"):
            return False
        try:
            payload = state_source.restore(session.session_id)
            backend.import_slot(session.session_id, payload)
        except Exception:
            return False
        state_source.drop(session.session_id)
        return True

    # ------------------------------------------------------------------
    def compliance(self, session: AISession):
        tele = self.telemetry.get(session.session_id)
        return tele.compliance(session.asp) if tele else None

    def release(self, session: AISession) -> None:
        # free the anchor's data-plane session state (migrated-in slots,
        # SimulatedEngine serialized state) along with the leases — the
        # backend store must not grow with released sessions
        b = session.binding
        if b is not None:
            site = self.sites.get(b.site_id)
            plane = site.plane if site is not None else None
            if plane is not None and hasattr(plane.backend, "release_slot"):
                plane.backend.release_slot(session.session_id)
        # a split session also holds a verify half: free its leases too
        if self.splits is not None:
            self.splits.on_release(session)
        session.release()
