"""DomainController — one administrative domain of a federated NE-AIaaS
deployment.

The previous single-domain :class:`~repro_torch.core.orchestrator.Orchestrator`
becomes the **per-domain core**: it still owns that domain's catalog,
sites, policy, analytics and 2PC coordinator, and the controller adds the
*federation* role on top:

* **visited side** — a typed east-west endpoint
  (:meth:`handle_eastwest_json`) serving DISCOVER solicitations under a
  decomposed SLA budget, the visited half of cross-domain PREPARE (held
  provisionally until the home COMMIT arrives), idempotent COMMIT, and
  ABORT/RENEW/RELEASE with explicit rollback semantics. Charging for a
  roaming guest is opened at COMMIT, never at PREPARE — an aborted
  handshake leaves no billable trace.
* **home side** — solicitation of offers from peered domains
  (merged into the annotated candidate set with exclusion reasons prefixed
  by the owning domain), the home half of the cross-domain 2PC (a
  transport-share QoS lease via
  :meth:`~repro_torch.core.twophase.TwoPhaseCoordinator.prepare_transport`), and
  the roaming state of sessions anchored abroad.

Control plane vs user plane: every *lifecycle* verb crosses the boundary
as a versioned JSON message (:mod:`repro_torch.federation.eastwest`); the *user
plane* — serving through the visited site's ServingPlane and the
make-before-break state transfer — rides direct object references via
:class:`GuestSiteView`, exactly as a home-routed N9 tunnel carries traffic
the control plane only set up.
"""

from __future__ import annotations

import itertools
from collections import OrderedDict
from dataclasses import dataclass, field, replace
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.core.clock import Clock
from repro_torch.core.discovery import Candidate, discover
from repro_torch.core.failures import FailureCause, SessionError
from repro_torch.core.orchestrator import Orchestrator
from repro_torch.core.predictors import Prediction
from repro_torch.core.qos import ASSURED, BEST_EFFORT, PREMIUM
from repro_torch.core.session import Binding
from repro_torch.federation import eastwest as ew
from repro_torch.federation.registry import (CapabilityDigest, FederationRegistry,
                                       digest_of)
from repro_torch.netfault.breaker import BreakerBoard
from repro_torch.netfault.retry import RetryPolicy
from repro_torch.netfault.wire import TransportError

_KLASS = {c.name: c for c in (PREMIUM, ASSURED, BEST_EFFORT)}

#: east-west verbs that are safe to re-send verbatim: COMMIT/ABORT/RENEW/
#: RELEASE are idempotent by protocol contract, PREPARE only when it
#: carries its ``prepare_key`` (checked at send time)
_IDEMPOTENT_EW = (ew.EWPrepare, ew.EWCommit, ew.EWAbort, ew.EWRenew,
                  ew.EWRelease)


# ----------------------------------------------------------------------
# home-side records
# ----------------------------------------------------------------------
@dataclass(frozen=True)
class RemoteModelRef:
    """Identity of a model offered by another domain — the home domain
    ranks and binds it WITHOUT holding the peer's ModelEntry (weights,
    footprint and price stay behind the east-west boundary)."""
    model_id: str
    version: str


@dataclass
class FederatedPrepared:
    """Home-side handle of one cross-domain PREPARE: the home transport
    lease plus the visited domain's ``prepared_ref``. Quacks enough like
    :class:`~repro_torch.core.twophase.Prepared` for the callers that branch on
    ``is_federated``."""
    domain: str
    session_ref: str
    prepared_ref: str
    site_id: str                 # domain-qualified ("<domain>/<site>")
    qfi: int
    home_qos_lease_id: str
    prepared_at: float
    hold_s: float = 0.0
    cache_bytes: float = 0.0
    price_per_1k: float = 0.0

    is_federated = True


@dataclass
class _RemoteRef:
    """Roaming bookkeeping keyed by the visited compute-lease id the home
    Binding carries."""
    domain: str
    prepared_ref: str
    session_ref: str
    visited_charging_ref: str
    price_per_1k: float


# ----------------------------------------------------------------------
# visited-side records
# ----------------------------------------------------------------------
@dataclass
class _GuestLease:
    """One provisional-or-committed reservation held for a roaming home
    session (lease-scoped: a roaming re-anchor creates a new record)."""
    session_ref: str
    home_domain: str
    model: object                # local ModelEntry
    prepared: object             # twophase.Prepared
    site_id: str
    committed: bool = False
    charging_ref: Optional[str] = None
    response: Optional[ew.EWCommitted] = None


class _GuestSessionAdapter:
    """Registered in the visited core's session table so the single
    recorder meters a guest's served requests against the visited
    (wholesale) charging ref — same path as a native session."""

    def __init__(self, session_ref: str, binding: Binding,
                 charging_ref: str):
        self.session_id = session_ref
        self.binding = binding
        self.charging_ref = charging_ref
        self.context_tokens = 0

    def note_context(self, tokens: int) -> None:
        self.context_tokens += max(int(tokens), 0)


# ----------------------------------------------------------------------
# the home-domain façade of a visited site
# ----------------------------------------------------------------------
class GuestSiteView:
    """A visited-domain ExecutionSite as the home domain sees it.

    Registered in the home site table under the qualified id
    ``<domain>/<site>`` so the whole single-domain machinery (bind-time
    lease validation, serve routing, heartbeat congestion sensing, the
    PlaneTransferPath) works unchanged on roaming sessions. Reads
    (lease validity, utilization, the serving plane) are direct
    user-plane references; writes with contract meaning (renew, release)
    fan out as typed east-west messages through the home controller.
    """

    is_guest_view = True

    def __init__(self, domain_id: str, site, owner_core: Orchestrator,
                 federation: "DomainController"):
        self.domain_id = domain_id
        self._site = site
        self._core = owner_core          # the VISITED domain's orchestrator
        self._fed = federation           # the HOME domain's controller
        self.spec = replace(site.spec,
                            site_id=f"{domain_id}/{site.spec.site_id}")

    # -- user plane (direct) --------------------------------------------
    @property
    def plane(self):
        return self._core.plane_for(self._site)

    def record_results(self) -> list:
        """The OWNING domain's recorder drains this plane (wholesale
        metering); guest results are forwarded home by its result sink."""
        return self._core.record_results(self._site)

    def lease_valid(self, lease_id: str) -> bool:
        return self._site.lease_valid(lease_id)

    def utilization(self) -> float:
        return self._site.utilization()

    def slots_in_use(self) -> int:
        return self._site.slots_in_use()

    def hosts(self, model_key: str) -> bool:
        return self._site.hosts(model_key)

    def attach_plane(self, plane) -> None:
        self._site.attach_plane(plane)

    # -- control plane (east-west) --------------------------------------
    def renew(self, lease_id: str, lease_s: float) -> bool:
        return self._fed._renew_remote(self.domain_id, lease_id, lease_s)

    def release(self, lease_id: str) -> None:
        self._fed._release_remote_lease(self.domain_id, lease_id)


# ----------------------------------------------------------------------
class DomainController:
    def __init__(self, domain_id: str,
                 registry: Optional[FederationRegistry] = None, *,
                 clock: Optional[Clock] = None,
                 orchestrator: Optional[Orchestrator] = None,
                 catalog=None, sites=None, timers=None,
                 solicit: str = "fallback",
                 default_transit_ms: float = 20.0,
                 home_cost_share: float = 0.15):
        """``solicit`` policy: ``"fallback"`` solicits east-west offers
        only when the home annotated set has no admissible candidate left
        (home-first routing); ``"always"`` merges offers into every
        DISCOVER; ``"never"`` disables federation for this domain."""
        if solicit not in ("fallback", "always", "never"):
            raise ValueError(f"unknown solicit policy {solicit!r}")
        self.domain_id = domain_id
        self.core = orchestrator or Orchestrator(
            clock=clock, catalog=catalog, sites=sites, timers=timers)
        self.registry = registry or FederationRegistry(self.core.clock)
        self.solicit = solicit
        self.default_transit_ms = default_transit_ms
        self.home_cost_share = home_cost_share
        self.transit_ms: Dict[str, float] = {}     # per-peer override
        #: east-west control-plane endpoints: domain -> JSON callable
        self.peers: Dict[str, Callable[[str], str]] = {}
        #: user-plane references (GuestSiteView construction, result
        #: forwarding) — in-process federation only
        self._peer_objects: Dict[str, "DomainController"] = {}
        #: per-peer circuit breakers over the east-west control path:
        #: repeated solicitation timeouts open the circuit and DISCOVER
        #: skips the peer with the attributable note ``circuit-open``
        #: until the half-open probe succeeds
        self.peer_breakers = BreakerBoard(self.core.clock)
        #: at-least-once retry policy for the idempotent east-west verbs
        self.retry = RetryPolicy()
        # home side
        self._views: Dict[str, GuestSiteView] = {}
        self._remote_bindings: Dict[str, _RemoteRef] = {}
        # visited side
        self._guest_by_ref: Dict[str, _GuestLease] = {}
        self._guest_sessions: Dict[str, _GuestLease] = {}
        #: EWPrepare replay cache (prepare_key → original EWPrepared):
        #: a re-sent PREPARE whose reply was lost must not double-reserve
        self._prepare_replays: "OrderedDict[str, ew.EWPrepared]" = \
            OrderedDict()
        self._prepare_replay_window = 256
        #: supervisor/chaos verdict: domains declared dead are skipped in
        #: solicitation (note ``domain-dead``) and their providers dropped —
        #: a partitioned peer must not stall every DISCOVER on timeouts
        self._dead_domains: set = set()
        self._refs = itertools.count(1)
        self._epochs = itertools.count(1)
        # wire the core into the federation
        self.core.federation = self
        self.core.migrations.federation = self
        self.core.result_sinks.append(self._forward_guest_result)
        self.registry.advertise(self.digest())
        self.registry.register_provider(self.domain_id, self.digest)

    # ------------------------------------------------------------------
    # peering + advertisement
    # ------------------------------------------------------------------
    def digest(self) -> CapabilityDigest:
        local = {sid: s for sid, s in self.core.sites.items()
                 if not getattr(s, "is_guest_view", False)}
        return digest_of(self.domain_id, self.core.catalog, local,
                         self.core.clock, next(self._epochs))

    def advertise(self) -> None:
        """Refresh this domain's capability digest (epoch bump)."""
        self.registry.advertise(self.digest())

    def connect(self, other: "DomainController", *,
                transit_ms: Optional[float] = None) -> None:
        """Peer two domains bidirectionally: exchange east-west endpoints,
        user-plane references, and fresh digests."""
        self.peers[other.domain_id] = other.handle_eastwest_json
        other.peers[self.domain_id] = self.handle_eastwest_json
        self._peer_objects[other.domain_id] = other
        other._peer_objects[self.domain_id] = self
        if transit_ms is not None:
            self.transit_ms[other.domain_id] = transit_ms
            other.transit_ms[self.domain_id] = transit_ms
        regs = [self.registry]
        if other.registry is not self.registry:
            regs.append(other.registry)
        for reg in regs:
            reg.advertise(self.digest())
            reg.advertise(other.digest())
            reg.register_provider(self.domain_id, self.digest)
            reg.register_provider(other.domain_id, other.digest)

    def transit_ms_for(self, domain: str) -> float:
        return self.transit_ms.get(domain, self.default_transit_ms)

    def mark_domain_dead(self, domain: str) -> None:
        """Fleet-ops verdict on a peer (partition, mass site failure): stop
        soliciting it and stop re-pulling its digest. Existing roamed
        sessions are not torn down here — their guest leases TTL-expire on
        the visited side and re-anchoring is the home core's job."""
        self._dead_domains.add(domain)
        self.registry.drop_provider(domain)

    def mark_domain_alive(self, domain: str) -> None:
        """Partition healed: solicit again; the peer re-registers its
        provider on the next ``connect``/``advertise``. The heal verdict
        also closes the peer's circuit breaker — waiting out the cooldown
        would leave the first post-heal establishes excluded as
        ``circuit-open`` despite an explicit operator decision."""
        self._dead_domains.discard(domain)
        self.peer_breakers.reset(domain)

    # ==================================================================
    # HOME SIDE
    # ==================================================================
    def is_remote(self, candidate) -> bool:
        return bool(getattr(candidate, "domain", ""))

    def _send(self, domain: str, msg: ew.EWMessage) -> ew.EWMessage:
        """One east-west exchange, with at-least-once re-send of the
        idempotent verbs under jittered backoff. The ultimate loss still
        maps to DEADLINE_EXPIRY — the exchange window expired and the
        provisional state (if any) is the reaper's/TTL's to clean up."""
        endpoint = self.peers.get(domain)
        if endpoint is None:
            raise SessionError(FailureCause.NO_FEASIBLE_BINDING,
                               f"no east-west peering with {domain!r}")
        attempts = 1
        if isinstance(msg, _IDEMPOTENT_EW) and not (
                isinstance(msg, ew.EWPrepare) and not msg.prepare_key):
            attempts = self.retry.max_attempts
        for attempt in range(1, attempts + 1):
            try:
                reply = ew.from_json(endpoint(msg.to_json()))
            except (ew.EWTimeout, TransportError) as e:
                if attempt < attempts:
                    self.core.clock.sleep(self.retry.backoff_s(
                        attempt, key=f"{domain}:{msg.TYPE}"))
                    continue
                self.peer_breakers.record(domain, False)
                raise SessionError(
                    FailureCause.DEADLINE_EXPIRY,
                    f"east-west {msg.TYPE} to {domain} timed out: {e}")
            self.peer_breakers.record(domain, True)
            return reply

    # -- DISCOVER solicitation ------------------------------------------
    def augment(self, session, cands: List[Candidate], *,
                exclude_sites: Tuple[str, ...] = ()) -> List[Candidate]:
        """Home-routed DISCOVER: merge east-west offers into the local
        annotated set. Under the ``fallback`` policy the federation is
        consulted only when no local candidate remains admissible (the
        home-first rule); exclusion reasons in the merged set are prefixed
        with the owning domain so a NO_FEASIBLE_BINDING is attributable
        per domain (Eq. 12)."""
        if self.solicit == "never" or not self.peers:
            return cands
        local_ok = any(c.admissible and c.site_id not in exclude_sites
                       for c in cands)
        if self.solicit == "fallback" and local_ok:
            return cands
        merged = [replace(c, exclusion_reason=
                          f"{self.domain_id}:{c.exclusion_reason}")
                  if c.exclusion_reason else c for c in cands]
        offers, notes = self.solicit_offers(
            session.asp, session.zone,
            deadline_at=getattr(session, "deadline_at", None))
        merged.extend(offers)
        for dom, why in notes:
            merged.append(Candidate(
                model=RemoteModelRef("*", "*"), site_id=f"{dom}/*",
                prediction=None, slack=float("-inf"), klass=BEST_EFFORT,
                admissible=False, exclusion_reason=f"{dom}:{why}",
                domain=dom))
        merged.sort(key=lambda c: c.slack, reverse=True)
        return merged

    def merged_discover(self, session, zone: str, *,
                        exclude_sites: Tuple[str, ...] = ()
                        ) -> List[Candidate]:
        """Full federated candidate set (used by roaming migration)."""
        cands = discover(session.asp, self.core.catalog, self.core.sites,
                         self.core.predictors, zone,
                         analytics=self.core.analytics)
        return self.augment(session, cands, exclude_sites=exclude_sites)

    def solicit_offers(self, asp, zone: str, *,
                       exclude: Tuple[str, ...] = (),
                       deadline_at: Optional[float] = None
                       ) -> Tuple[List[Candidate], List[Tuple[str, str]]]:
        """Query every fresh, digest-compatible peer; returns the offered
        candidates plus per-domain exclusion notes for peers that could
        not offer (stale digest, infeasible budget, timeout, circuit open,
        exhausted deadline, refusal)."""
        offers: List[Candidate] = []
        notes: List[Tuple[str, str]] = []
        for dom in self.registry.domains(
                exclude=(self.domain_id,) + tuple(exclude)):
            endpoint = self.peers.get(dom)
            if endpoint is None:
                continue
            if dom in self._dead_domains:
                notes.append((dom, "domain-dead"))
                continue
            if not self.peer_breakers.allow(dom):
                # consecutive exchange failures opened this peer's circuit:
                # skip it attributably instead of stalling every DISCOVER
                # on its timeout window until the half-open probe re-admits
                notes.append((dom, "circuit-open"))
                continue
            if not self.registry.ensure_fresh(dom):
                notes.append((dom, "registry-stale"))
                continue
            deadline_ms = None
            if deadline_at is not None:
                deadline_ms = (deadline_at - self.core.clock.now()) * 1e3 \
                    - self.transit_ms_for(dom)
                if deadline_ms <= 0.0:
                    # the remaining budget cannot even cover the transit
                    # leg — don't ask the peer to promise the impossible
                    notes.append((dom, "deadline-exceeded"))
                    continue
            digest = self.registry.get(dom)
            if asp.modality.value not in digest.modalities:
                notes.append((dom, "modality-not-advertised"))
                continue
            if set(digest.regions).isdisjoint(asp.allowed_regions):
                notes.append((dom, "sovereignty"))
                continue
            try:
                budget = ew.decompose_budget(
                    asp, self.transit_ms_for(dom),
                    home_cost_share=self.home_cost_share)
            except SessionError:
                notes.append((dom, "budget-infeasible"))
                continue
            # the wire carries the budget-applied contract, never the raw
            # home objectives/cost envelope — a peer sees only the share
            # it is being asked to meet (the SLABudget trust boundary)
            query = ew.DiscoverQuery(
                home_domain=self.domain_id,
                query_id=f"{self.domain_id}/q-{next(self._refs):06d}",
                zone=zone, asp=ew.apply_budget(asp, budget).to_wire(),
                budget=budget.to_wire(), deadline_ms=deadline_ms)
            try:
                reply = ew.from_json(endpoint(query.to_json()))
            except ew.EWTimeout:
                self.peer_breakers.record(dom, False)
                notes.append((dom, "offer-timeout"))
                continue
            except Exception:
                # an unreachable peer is indistinguishable from a timeout
                self.peer_breakers.record(dom, False)
                notes.append((dom, "offer-timeout"))
                continue
            self.peer_breakers.record(dom, True)
            if isinstance(reply, ew.EWError):
                notes.append((dom, reply.cause or reply.code))
                continue
            offers.extend(self._offer_candidate(dom, e, budget)
                          for e in reply.candidates)
        return offers, notes

    def _offer_candidate(self, dom: str, e: dict,
                         budget: ew.SLABudget) -> Candidate:
        """One offer entry → a home-rankable Candidate: the home transport
        share is re-added to the offered latencies and the home cost share
        to the offered price, so the merged ranking compares end-to-end
        boundary quantities."""
        pred = None
        if e.get("prediction"):
            pred = Prediction(**e["prediction"])
            pred = replace(
                pred,
                t_ff_ms=pred.t_ff_ms + budget.home_transport_ms,
                l95_ms=pred.l95_ms + budget.home_transport_ms,
                l99_ms=pred.l99_ms + budget.home_transport_ms,
                cost_per_1k=pred.cost_per_1k + budget.home_cost_per_1k)
        reason = e.get("exclusion_reason", "")
        return Candidate(
            model=RemoteModelRef(e["model_id"], e["model_version"]),
            site_id=f"{dom}/{e['site_id']}", prediction=pred,
            slack=float("-inf") if e.get("slack") is None else e["slack"],
            klass=_KLASS.get(e.get("klass", ""), BEST_EFFORT),
            admissible=bool(e["admissible"]),
            exclusion_reason=f"{dom}:{reason}" if reason else "",
            domain=dom, region=e.get("region", ""))

    def _remaining_ms(self, session, dom: str) -> Optional[float]:
        """Shrinking end-to-end budget as seen at the visited ingress:
        what is left of the session's establishment deadline minus the
        inter-domain transit this exchange will spend."""
        deadline_at = getattr(session, "deadline_at", None)
        if deadline_at is None:
            return None
        return (deadline_at - self.core.clock.now()) * 1e3 \
            - self.transit_ms_for(dom)

    # -- cross-domain 2PC (home half) -----------------------------------
    def prepare_remote(self, session, chosen, *, hold_s: float = 0.0,
                       context_tokens: int = 2048) -> FederatedPrepared:
        """Stage 1 across the boundary: the home transport-share QoS lease
        plus the visited domain's provisional co-reservation — both or
        neither, exactly like the single-domain PREPARE."""
        dom = chosen.domain
        budget = ew.decompose_budget(session.asp, self.transit_ms_for(dom),
                                     home_cost_share=self.home_cost_share)
        timers = self.core.timers
        deadline_ms = self._remaining_ms(session, dom)
        if deadline_ms is not None and deadline_ms <= timers.tau_prep * 1e3:
            # reject BEFORE reserving anything: the budget cannot cover
            # transit + the visited PREPARE floor, and this hop says so
            raise SessionError(
                FailureCause.DEADLINE_EXCEEDED,
                f"[home:{self.domain_id}] cross-domain PREPARE to {dom}: "
                f"{deadline_ms:.1f}ms remaining cannot cover the "
                f"{timers.tau_prep * 1e3:.0f}ms phase floor")
        ttl_s = timers.tau_prep + timers.tau_com + hold_s
        qos_lease = self.core.coordinator.prepare_transport(
            (session.zone, f"ew:{dom}"), chosen.klass, ttl_s=ttl_s)
        site_local = chosen.site_id.split("/", 1)[1]
        req = ew.EWPrepare(
            home_domain=self.domain_id, session_ref=session.session_id,
            model_id=chosen.model.model_id,
            model_version=chosen.model.version,
            site_id=site_local, klass=chosen.klass.name, zone=session.zone,
            slots=1, context_tokens=int(context_tokens), hold_s=hold_s,
            budget=budget.to_wire(), deadline_ms=deadline_ms,
            prepare_key=f"{self.domain_id}/{session.session_id}"
                        f"/pk-{next(self._refs):06d}")
        try:
            reply = self._send(dom, req)
        except BaseException:
            self.core.qos.release(qos_lease.lease_id)
            raise
        if isinstance(reply, ew.EWError):
            self.core.qos.release(qos_lease.lease_id)
            raise reply.to_session_error()
        self.ensure_view(dom, site_local)
        return FederatedPrepared(
            domain=dom, session_ref=session.session_id,
            prepared_ref=reply.prepared_ref, site_id=chosen.site_id,
            qfi=reply.qfi, home_qos_lease_id=qos_lease.lease_id,
            prepared_at=self.core.clock.now(), hold_s=hold_s,
            cache_bytes=reply.cache_bytes,
            price_per_1k=chosen.prediction.cost_per_1k
            if chosen.prediction else 0.0)

    def commit_remote(self, session, chosen,
                      prepared: FederatedPrepared) -> Binding:
        """Stage 2: confirm the home transport lease, then the visited
        half. A failure on either side rolls BOTH back — the visited
        PREPARE was held provisionally exactly for this window."""
        try:
            self.core.qos.confirm(prepared.home_qos_lease_id,
                                  lease_s=self.core.timers.lease_s)
        except BaseException:
            self.abort_remote(prepared, reason="home transport confirm")
            raise
        try:
            reply = self._send(prepared.domain, ew.EWCommit(
                home_domain=self.domain_id,
                session_ref=prepared.session_ref,
                prepared_ref=prepared.prepared_ref,
                deadline_ms=self._remaining_ms(session, prepared.domain)))
        except BaseException:
            # the COMMIT may have landed with the reply lost — EWAbort
            # degenerates to release on the visited side, re-driving it to
            # a clean (unbilled) state either way
            self.abort_remote(prepared, reason="home commit exchange lost")
            raise
        if isinstance(reply, ew.EWError):
            self.abort_remote(prepared, reason=reply.code)
            raise reply.to_session_error()
        self.ensure_view(prepared.domain, reply.site_id)
        binding = Binding(
            model_id=chosen.model.model_id,
            model_version=chosen.model.version,
            site_id=prepared.site_id, endpoint=reply.endpoint,
            qfi=reply.qfi,
            steering_handle=f"steer/ew/{prepared.domain}/qfi{reply.qfi}",
            compute_lease_id=reply.compute_lease_id,
            qos_lease_id=prepared.home_qos_lease_id)
        self._remote_bindings[reply.compute_lease_id] = _RemoteRef(
            domain=prepared.domain, prepared_ref=prepared.prepared_ref,
            session_ref=prepared.session_ref,
            visited_charging_ref=reply.charging_ref,
            price_per_1k=reply.price_per_1k
            if reply.price_per_1k is not None else prepared.price_per_1k)
        return binding

    def abort_remote(self, prepared: FederatedPrepared, *,
                     reason: str = "") -> None:
        """Idempotent rollback of both halves. The east-west ABORT is
        best-effort: the visited provisional leases expire by TTL even if
        the peer is unreachable."""
        self.core.qos.release(prepared.home_qos_lease_id)
        try:
            self._send(prepared.domain, ew.EWAbort(
                home_domain=self.domain_id,
                session_ref=prepared.session_ref,
                prepared_ref=prepared.prepared_ref, reason=reason))
        except Exception:
            pass

    # -- roaming session plumbing ---------------------------------------
    def ensure_view(self, domain: str, site_local: str) -> GuestSiteView:
        key = f"{domain}/{site_local}"
        view = self._views.get(key)
        if view is None:
            peer = self._peer_objects.get(domain)
            if peer is None:
                raise SessionError(
                    FailureCause.NO_FEASIBLE_BINDING,
                    f"no user-plane reference for domain {domain!r}")
            view = GuestSiteView(domain, peer.core.sites[site_local],
                                 peer.core, self)
            self._views[key] = view
            self.core.sites[key] = view
        return view

    def _renew_remote(self, domain: str, compute_lease_id: str,
                      lease_s: float) -> bool:
        ref = self._remote_bindings.get(compute_lease_id)
        if ref is None:
            return False
        try:
            reply = self._send(domain, ew.EWRenew(
                home_domain=self.domain_id, prepared_ref=ref.prepared_ref,
                lease_s=lease_s))
        except SessionError:
            return False
        return isinstance(reply, ew.EWRenewAck) and reply.renewed

    def _release_remote_lease(self, domain: str,
                              compute_lease_id: str) -> None:
        ref = self._remote_bindings.pop(compute_lease_id, None)
        if ref is None:
            return
        try:
            self._send(domain, ew.EWRelease(
                home_domain=self.domain_id,
                prepared_ref=ref.prepared_ref))
        except Exception:
            pass    # visited leases expire by TTL regardless

    def _on_guest_result(self, domain: str, site_id: str, res) -> None:
        """A roaming session's completion, forwarded by the visited
        domain: record home-side telemetry, context, and retail charging,
        and fan out to the home result sinks (async completions)."""
        view = self._views.get(f"{domain}/{site_id}")
        if view is None:
            return
        session = self.core.sessions.get(res.session_id)
        if session is None:
            return
        price = None
        if session.binding is not None:
            ref = self._remote_bindings.get(session.binding.compute_lease_id)
            if ref is not None:
                price = ref.price_per_1k
        self.core._record_one(view, res, price_override=price)

    # ==================================================================
    # VISITED SIDE — the typed east-west endpoint
    # ==================================================================
    def handle_eastwest_json(self, payload: str) -> str:
        return self.handle_eastwest_msg(payload).to_json()

    def handle_eastwest_msg(self, payload: str) -> ew.EWMessage:
        try:
            msg = ew.from_json(payload)
        except (ValueError, TypeError, KeyError) as e:
            return ew.EWError(visited_domain=self.domain_id,
                              code="E_EW_BAD_REQUEST", detail=repr(e))
        ver = str(getattr(msg, "schema_version", ew.EW_SCHEMA_VERSION))
        if ver.split(".")[0] != ew.EW_SCHEMA_VERSION.split(".")[0]:
            return ew.EWError(
                visited_domain=self.domain_id, code="E_EW_SCHEMA",
                detail=f"east-west {ver!r} incompatible with "
                       f"{ew.EW_SCHEMA_VERSION!r}")
        handler = self._EW_DISPATCH.get(type(msg))
        if handler is None:
            return ew.EWError(
                visited_domain=self.domain_id, code="E_EW_BAD_REQUEST",
                detail=f"{msg.TYPE!r} is not a visited-side message")
        try:
            return handler(self, msg)
        except SessionError as e:
            return ew.EWError.from_session_error(self.domain_id, e)
        except Exception as e:                        # noqa: BLE001
            return ew.EWError(visited_domain=self.domain_id,
                              code="E_EW_INTERNAL",
                              detail=f"{type(e).__name__}: {e}")

    def _ew_discover(self, q: ew.DiscoverQuery) -> ew.EWMessage:
        from repro_torch.core.asp import ASP
        self._gc_guests()
        budget = ew.SLABudget.from_wire(q.budget)
        # the HOME owns the budget application (the wire never carries the
        # raw objectives); the visited side only verifies the contract it
        # received stays inside the declared visited share
        vasp = ASP.from_wire(q.asp)
        o = vasp.objectives
        if o.ttfb_ms > budget.ttfb_ms or o.p99_ms > budget.p99_ms or \
                o.t_max_ms > budget.t_max_ms or \
                vasp.max_cost_per_1k_tokens > budget.max_cost_per_1k:
            return ew.EWError(
                visited_domain=self.domain_id, code="E_EW_BAD_REQUEST",
                detail="solicited contract exceeds its declared "
                       "visited budget share")
        if q.deadline_ms is not None and \
                q.deadline_ms <= self.core.timers.tau_disc * 1e3:
            raise SessionError(
                FailureCause.DEADLINE_EXCEEDED,
                f"[visited:{self.domain_id}] DISCOVER: {q.deadline_ms:.1f}ms "
                f"remaining cannot cover the "
                f"{self.core.timers.tau_disc * 1e3:.0f}ms phase floor")
        cands = discover(vasp, self.core.catalog, self.core.sites,
                         self.core.predictors, q.zone,
                         analytics=self.core.analytics)
        entries = [c.to_wire(include_prediction=True) for c in cands]
        digest = self.registry.get(self.domain_id)
        return ew.DiscoverOffer(
            visited_domain=self.domain_id, query_id=q.query_id,
            candidates=entries,
            digest_epoch=digest.epoch if digest else 0,
            at_s=self.core.clock.now())

    def _ew_prepare(self, req: ew.EWPrepare) -> ew.EWMessage:
        self._gc_guests()
        if req.prepare_key and req.prepare_key in self._prepare_replays:
            # at-least-once delivery: the home re-sent a PREPARE whose
            # reply was lost — return the original instead of reserving a
            # second set of provisional leases for the same establishment
            return self._prepare_replays[req.prepare_key]
        if req.deadline_ms is not None and \
                req.deadline_ms <= self.core.timers.tau_prep * 1e3:
            raise SessionError(
                FailureCause.DEADLINE_EXCEEDED,
                f"[visited:{self.domain_id}] PREPARE: "
                f"{req.deadline_ms:.1f}ms remaining cannot cover the "
                f"{self.core.timers.tau_prep * 1e3:.0f}ms phase floor")
        # session_ref namespace guard: ids are only unique per home
        # domain, so a ref that names a NATIVE session here — or another
        # home's guest — must be refused, never clobbered
        existing = self.core.sessions.get(req.session_ref)
        guest = self._guest_sessions.get(req.session_ref)
        if existing is not None and guest is None:
            raise SessionError(
                FailureCause.POLICY_DENIAL,
                f"session ref {req.session_ref!r} collides with a native "
                f"session of domain {self.domain_id!r}")
        if guest is not None and guest.home_domain != req.home_domain:
            raise SessionError(
                FailureCause.POLICY_DENIAL,
                f"session ref {req.session_ref!r} already roams here from "
                f"{guest.home_domain!r}")
        try:
            model = self.core.catalog.get(req.model_id, req.model_version)
        except KeyError:
            raise SessionError(
                FailureCause.MODEL_UNAVAILABLE,
                f"{req.model_id}@{req.model_version} not in catalog")
        klass = _KLASS.get(req.klass)
        if klass is None:
            return ew.EWError(visited_domain=self.domain_id,
                              code="E_EW_BAD_REQUEST",
                              detail=f"unknown QoS class {req.klass!r}")
        # ONE sizing for both the local reservation and the wire reply —
        # the home uses cache_bytes as the roaming-migration payload size,
        # so it must equal what the coordinator actually holds
        cache_bytes = float(model.session_state_bytes(
            max(int(req.context_tokens), 1)))
        prepared = self.core.coordinator.prepare(
            model, req.site_id, req.zone, klass, slots=req.slots,
            cache_bytes=cache_bytes, hold_s=req.hold_s)
        ref = f"{self.domain_id}/ewp-{next(self._refs):06d}"
        self._guest_by_ref[ref] = _GuestLease(
            session_ref=req.session_ref, home_domain=req.home_domain,
            model=model, prepared=prepared, site_id=req.site_id)
        timers = self.core.timers
        reply = ew.EWPrepared(
            visited_domain=self.domain_id, session_ref=req.session_ref,
            prepared_ref=ref, site_id=req.site_id, qfi=prepared.qfi,
            cache_bytes=cache_bytes,
            expires_at=prepared.prepared_at + timers.tau_prep
            + timers.tau_com + req.hold_s)
        if req.prepare_key:
            self._prepare_replays[req.prepare_key] = reply
            while len(self._prepare_replays) > self._prepare_replay_window:
                self._prepare_replays.popitem(last=False)
        return reply

    def _ew_commit(self, req: ew.EWCommit) -> ew.EWMessage:
        g = self._guest_by_ref.get(req.prepared_ref)
        if g is None:
            return ew.EWError(visited_domain=self.domain_id,
                              code="E_EW_UNKNOWN_REF",
                              detail=f"no PREPARE under "
                                     f"{req.prepared_ref!r}")
        if g.committed:
            return g.response            # duplicate COMMIT: idempotent
        if req.deadline_ms is not None and \
                req.deadline_ms <= self.core.timers.tau_com * 1e3:
            # refuse (rather than half-run) a COMMIT the budget cannot
            # cover; the home rolls the provisional PREPARE back on this
            # error, and the reaper/TTL covers a home that vanished
            raise SessionError(
                FailureCause.DEADLINE_EXCEEDED,
                f"[visited:{self.domain_id}] COMMIT: "
                f"{req.deadline_ms:.1f}ms remaining cannot cover the "
                f"{self.core.timers.tau_com * 1e3:.0f}ms phase floor")
        try:
            binding = self.core.coordinator.commit(g.prepared, g.model)
        except SessionError:
            # coordinator.commit already rolled both leases back
            self._guest_by_ref.pop(req.prepared_ref, None)
            raise
        g.charging_ref = self.core.policy.open_charging(req.session_ref)
        g.committed = True
        self._guest_sessions[req.session_ref] = g
        self.core.sessions[req.session_ref] = _GuestSessionAdapter(
            req.session_ref, binding, g.charging_ref)
        g.response = ew.EWCommitted(
            visited_domain=self.domain_id, session_ref=req.session_ref,
            prepared_ref=req.prepared_ref, site_id=g.site_id,
            endpoint=f"aiaas://{self.domain_id}/{g.site_id}"
                     f"/{g.model.model_id}",
            qfi=binding.qfi, compute_lease_id=binding.compute_lease_id,
            qos_lease_id=binding.qos_lease_id,
            charging_ref=g.charging_ref,
            lease_s=self.core.timers.lease_s,
            price_per_1k=g.model.price_per_1k_tokens,
            at_s=self.core.clock.now())
        return g.response

    def _ew_abort(self, req: ew.EWAbort) -> ew.EWMessage:
        g = self._guest_by_ref.pop(req.prepared_ref, None)
        if g is None:
            return ew.EWAbortAck(visited_domain=self.domain_id,
                                 prepared_ref=req.prepared_ref,
                                 released=False)
        if g.committed:
            self._teardown_guest(g)      # late abort degenerates to release
        else:
            self.core.coordinator.abort(g.prepared)
        return ew.EWAbortAck(visited_domain=self.domain_id,
                             prepared_ref=req.prepared_ref, released=True)

    def _ew_renew(self, req: ew.EWRenew) -> ew.EWMessage:
        g = self._guest_by_ref.get(req.prepared_ref)
        renewed = False
        if g is not None:
            site = self.core.sites[g.site_id]
            ok1 = site.renew(g.prepared.compute_lease_id, req.lease_s)
            ok2 = self.core.qos.renew(g.prepared.qos_lease_id, req.lease_s)
            renewed = ok1 and ok2
        return ew.EWRenewAck(visited_domain=self.domain_id,
                             prepared_ref=req.prepared_ref,
                             renewed=renewed)

    def _ew_release(self, req: ew.EWRelease) -> ew.EWMessage:
        g = self._guest_by_ref.pop(req.prepared_ref, None)
        if g is None:
            return ew.EWReleaseAck(visited_domain=self.domain_id,
                                   prepared_ref=req.prepared_ref,
                                   released=False)
        tokens, cost = self._teardown_guest(g)
        return ew.EWReleaseAck(visited_domain=self.domain_id,
                               prepared_ref=req.prepared_ref,
                               released=True, tokens=tokens, cost=cost)

    def tick(self) -> int:
        """Visited-side orphan sweep, on the plane-heartbeat cadence: reap
        outstanding coordinator PREPAREs past their decision window, then
        collect guest leases whose underlying leases both TTL-expired (a
        lost COMMIT, a vanished home). Returns guest records reaped."""
        before = len(self._guest_by_ref)
        self.core.coordinator.reap()
        self._gc_guests()
        return before - len(self._guest_by_ref)

    def _gc_guests(self) -> None:
        """Reap guest leases whose home domain vanished: once BOTH
        underlying leases expired by TTL (never renewed, never committed
        or released), the bookkeeping — and for committed guests the
        session adapter and backend slot — must not outlive them."""
        dead = []
        for ref, g in self._guest_by_ref.items():
            site = self.core.sites.get(g.site_id)
            cmp_live = site is not None and \
                site.lease_valid(g.prepared.compute_lease_id)
            qos_live = self.core.qos.lease_valid(g.prepared.qos_lease_id)
            if not cmp_live and not qos_live:
                dead.append(ref)
        for ref in dead:
            self._teardown_guest(self._guest_by_ref.pop(ref))

    def _teardown_guest(self, g: _GuestLease) -> Tuple[int, float]:
        """Release this guest lease's compute + QoS (idempotent), free the
        backend slot when it was the session's current anchor here, and
        settle the wholesale charge."""
        site = self.core.sites.get(g.site_id)
        current = self._guest_sessions.get(g.session_ref) is g
        if site is not None:
            site.release(g.prepared.compute_lease_id)
            plane = site.plane
            if current and plane is not None and \
                    hasattr(plane.backend, "release_slot"):
                plane.backend.release_slot(g.session_ref)
        self.core.qos.release(g.prepared.qos_lease_id)
        if current:
            del self._guest_sessions[g.session_ref]
            if isinstance(self.core.sessions.get(g.session_ref),
                          _GuestSessionAdapter):
                self.core.sessions.pop(g.session_ref, None)
        tokens, cost = 0, 0.0
        if g.charging_ref is not None:
            rec = self.core.policy.charging(g.charging_ref)
            tokens, cost = rec.tokens, rec.cost
        return tokens, cost

    def _forward_guest_result(self, site, res) -> None:
        """Visited result sink: a drained completion that belongs to a
        roaming home session is forwarded to its home controller."""
        g = self._guest_sessions.get(res.session_id)
        if g is None:
            return
        home = self._peer_objects.get(g.home_domain)
        if home is not None:
            home._on_guest_result(self.domain_id, site.spec.site_id, res)

    # ------------------------------------------------------------------
    _EW_DISPATCH: Dict[type, Callable] = {
        ew.DiscoverQuery: _ew_discover,
        ew.EWPrepare: _ew_prepare,
        ew.EWCommit: _ew_commit,
        ew.EWAbort: _ew_abort,
        ew.EWRenew: _ew_renew,
        ew.EWRelease: _ew_release,
    }
