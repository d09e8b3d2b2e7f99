"""Make-before-break MIGRATION (Section IV-B, Eq. 14).

Protocol (continuity invariant: the session never leaves the domain where
Committed(t) holds):

  1. trigger  — predicted violation risk (Eq. 14) or measured non-compliance
  2. re-DISCOVER + re-PAGE excluding the current anchor
  3. PREPARE on the target while the current binding stays committed —
     the source keeps decoding (tokens flow) through this whole window
  4. transfer session state (KV cache / recurrent state) within τ_mig:
     the data plane exports the source slot between decode steps, installs
     it into the target backend, and verifies the fingerprint
  5. COMMIT target  →  bind() swaps bindings atomically  →  release source
     slot and leases; an in-flight stream resumes on the TARGET plane

Aborts at any step preserve the existing committed service: the target's
provisional leases AND any provisionally imported state are rolled back,
the source slot is untouched, and a detached in-flight stream is
re-attached to the source plane (STATE_TRANSFER_FAILURE / DEADLINE_EXPIRY /
COMPUTE_SCARCITY are diagnosable causes, not session teardown).

The data plane is pluggable through ``transfer_fn``:

* a plain callable ``(session, from_site, to_site) -> seconds`` models wire
  time only (closed-form; the §V mobility baseline injects failures here);
* an object with ``begin/commit/abort`` — :class:`PlaneTransferPath` — moves
  REAL state through the sites' ServingPlanes via
  :mod:`repro_torch.serving.state_transfer`, with two-phase ordering aligned to
  the control plane's PREPARE/COMMIT.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

from repro_torch.core.asp import ASP
from repro_torch.core.clock import Clock
from repro_torch.core.discovery import discover
from repro_torch.core.failures import FailureCause, SessionError, Timers
from repro_torch.core.paging import page
from repro_torch.core.session import AISession
from repro_torch.core.twophase import TwoPhaseCoordinator


@dataclass
class MigrationOutcome:
    migrated: bool
    aborted: bool
    cause: Optional[FailureCause]
    from_site: str
    to_site: Optional[str]
    interruption_ms: float       # contract-gap time (0 for successful MBB)
    transfer_ms: float = 0.0
    transfer_bytes: int = 0      # actual payload moved by the data plane
    fingerprint: Optional[str] = None   # verified state fingerprint
    mid_stream: bool = False     # an in-flight request followed the session


@dataclass
class MigrationTriggers:
    """Eq. (14) thresholds δ, δ'."""
    delta_l99: float = 0.35
    delta_ttfb: float = 0.35

    def should_migrate(self, p_l99: float, p_ttfb: float) -> bool:
        return p_l99 >= self.delta_l99 or p_ttfb >= self.delta_ttfb


@dataclass
class TransferTicket:
    """Provisional state of one data-plane transfer (begin → commit/abort)."""
    session_id: str
    src_plane: object
    dst_plane: object
    handoff: object = None       # SessionHandoff (in-flight stream), if any
    moved_state: bool = False    # destination holds a provisional import
    wire_s: float = 0.0
    nbytes: int = 0
    fingerprint: Optional[str] = None


class PlaneTransferPath:
    """Two-phase migration data plane over the per-site ServingPlanes.

    ``begin`` exports the session's slot from the source plane's backend,
    installs it into the target's (fingerprint-verified), and detaches any
    in-flight request — the source slot itself stays allocated, so an abort
    is a pure rollback. ``commit`` releases the source slot and re-attaches
    the stream on the target (the break of make-before-break); ``abort``
    rolls the provisional import back and resumes streaming on the source.

    Failure injection is read from each plane's ``migration_inject``
    (:class:`repro_torch.serving.state_transfer.TransferInjections`): export-side
    hooks from the SOURCE plane, import-side hooks from the TARGET plane.
    """

    def __init__(self, plane_for: Callable[[object], object], *,
                 link_bw: float = 5e9, verify: bool = True,
                 overlap_rounds: int = 1, clock: Optional[Clock] = None,
                 ew_link_bw: float = 1.25e9):
        self.plane_for = plane_for
        self.link_bw = link_bw
        self.verify = verify
        #: source decode rounds run inside ``begin`` before the swap point —
        #: the source literally keeps producing tokens while the target
        #: prepares (set 0 to disable for pure control-plane callers)
        self.overlap_rounds = overlap_rounds
        self.clock = clock
        #: inter-domain (east-west) link: roaming state crosses operator
        #: boundaries over a peering link, not the intra-domain DCN
        self.ew_link_bw = ew_link_bw

    @staticmethod
    def _boundary_scrub(payload: dict) -> dict:
        """Exposure boundary for roaming transfers: only the slot-essential
        state (cache tensors, position, last token) crosses the domain
        boundary — any auxiliary per-request bookkeeping a backend attaches
        stays home (§ federation trust boundary)."""
        keep = ("cache", "position", "last_token", "adapter_id")
        return {k: v for k, v in payload.items() if k in keep}

    # ------------------------------------------------------------------
    def _injections(self, src_plane, dst_plane):
        from repro_torch.serving.state_transfer import TransferInjections
        src = getattr(src_plane, "migration_inject", None)
        dst = getattr(dst_plane, "migration_inject", None)
        if src is None and dst is None:
            return None
        return TransferInjections(
            on_export=src.on_export if src else None,
            corrupt=src.corrupt if src else None,
            on_import=dst.on_import if dst else None,
            deny_admission=dst.deny_admission if dst else False,
            extra_wire_s=(src.extra_wire_s if src else 0.0)
            + (dst.extra_wire_s if dst else 0.0))

    # ------------------------------------------------------------------
    def begin(self, session: AISession, src_site, dst_site, *,
              payload_bytes: Optional[int] = None) -> TransferTicket:
        from repro_torch.serving import state_transfer
        src_plane = self.plane_for(src_site)
        dst_plane = self.plane_for(dst_site)
        sid = session.session_id
        backend = src_plane.backend
        cross_domain = getattr(src_site, "domain_id", None) != \
            getattr(dst_site, "domain_id", None)
        link_bw = self.ew_link_bw if cross_domain else self.link_bw
        # source keeps streaming while the target prepares: run decode
        # rounds up to the swap point (tokens produced here are accounted
        # to the source plane's in-flight request as usual)
        for _ in range(self.overlap_rounds):
            if not src_plane._round():
                break
        if not (hasattr(backend, "has_slot") and backend.has_slot(sid)):
            # no data-plane state yet: nothing to export, but any queued
            # requests still follow the session to its new anchor; model
            # the wire time of the declared payload
            handoff = src_plane.detach_session(sid)
            wire = (payload_bytes or 0) / link_bw
            inj = self._injections(src_plane, dst_plane)
            if inj is not None:
                wire += inj.extra_wire_s
            return TransferTicket(sid, src_plane, dst_plane, handoff=handoff,
                                  wire_s=wire, nbytes=int(payload_bytes or 0))
        handoff = src_plane.detach_session(sid)
        try:
            meta = state_transfer.transfer(
                backend, dst_plane.backend, sid,
                link_bw=link_bw, verify=self.verify,
                inject=self._injections(src_plane, dst_plane),
                scrub=self._boundary_scrub if cross_domain else None,
                clock=self.clock)
        except SessionError:
            src_plane.attach_session(handoff)
            raise
        except state_transfer.AdmissionDenied as e:
            # resume streaming on the source; admission denial maps to
            # COMPUTE_SCARCITY in the Eq. (12) cause partition
            src_plane.attach_session(handoff)
            raise SessionError(FailureCause.COMPUTE_SCARCITY, str(e))
        except Exception as e:
            src_plane.attach_session(handoff)
            raise SessionError(FailureCause.STATE_TRANSFER_FAILURE, str(e))
        wire_bytes = max(meta["bytes"], int(payload_bytes or 0))
        extra = meta["wire_s_at_link"] - meta["bytes"] / link_bw
        return TransferTicket(
            sid, src_plane, dst_plane, handoff=handoff, moved_state=True,
            wire_s=wire_bytes / link_bw + extra,
            nbytes=meta["bytes"], fingerprint=meta["fingerprint"])

    def commit(self, ticket: TransferTicket) -> None:
        """The break: source slot released only after the target committed;
        the detached in-flight stream and queued requests resume on the
        target plane."""
        if ticket.moved_state:
            ticket.src_plane.backend.release_slot(ticket.session_id)
        if ticket.handoff is not None and not ticket.handoff.empty():
            ticket.dst_plane.attach_session(ticket.handoff)

    def abort(self, ticket: TransferTicket) -> None:
        """Rollback: drop the provisional import, resume on the source."""
        if ticket.moved_state:
            ticket.dst_plane.backend.release_slot(ticket.session_id)
        if ticket.handoff is not None and not ticket.handoff.empty():
            ticket.src_plane.attach_session(ticket.handoff)


class MigrationController:
    def __init__(self, clock: Clock, coordinator: TwoPhaseCoordinator,
                 catalog, sites, predictors, timers: Timers,
                 *, transfer_fn: Optional[Callable] = None,
                 analytics=None):
        """``transfer_fn`` is either a plain callable
        ``(session, from_site, to_site) -> transfer_seconds`` (closed-form
        wire model), or a two-phase :class:`PlaneTransferPath`-style object
        with ``begin/commit/abort`` that moves real state. The default
        models the wire time of the cache payload over the inter-site link
        (5 GB/s DCN per DESIGN.md)."""
        self.clock = clock
        self.coord = coordinator
        self.catalog = catalog
        self.sites = sites
        self.predictors = predictors
        self.timers = timers
        self.transfer_fn = transfer_fn or self._default_transfer
        self.analytics = analytics
        #: set by a federation DomainController: re-paging then considers
        #: east-west offers, and a remote target drives the cross-domain
        #: 2PC — roaming make-before-break through the same transfer path
        self.federation = None

    # ------------------------------------------------------------------
    def context_tokens(self, session: AISession) -> int:
        """The session's ACTUAL context length (prompt + generated tokens
        served so far) — sizes the PREPARE cache reservation and the
        transfer payload. Floor of 1 keeps never-served sessions movable."""
        return max(int(getattr(session, "context_tokens", 0)), 1)

    def _default_transfer(self, session: AISession, from_site, to_site,
                          *, context_tokens: Optional[int] = None) -> float:
        model = self.catalog.get(session.binding.model_id,
                                 session.binding.model_version)
        ctx = context_tokens if context_tokens is not None \
            else self.context_tokens(session)
        payload = model.session_state_bytes(ctx)
        dcn_bw = 5e9  # inter-site link, bytes/s
        return payload / dcn_bw

    # ------------------------------------------------------------------
    def check_trigger(self, session: AISession, zone: str,
                      triggers: MigrationTriggers) -> bool:
        """Eq. (14) evaluated against the *current* anchor."""
        if not session.committed():
            return False
        b = session.binding
        try:
            model = self.catalog.get(b.model_id, b.model_version)
        except KeyError:
            # roaming on a model this domain does not carry: no local
            # prediction basis — triggers come from the visited side
            return False
        site = self.sites[b.site_id]
        from repro_torch.core.qos import PREMIUM, BEST_EFFORT
        klass = PREMIUM if session.asp.tier >= 2 else BEST_EFFORT
        pred = self.predictors.predict(session.asp, model, site, zone, klass)
        return triggers.should_migrate(pred.p_violate_l99,
                                       pred.p_violate_ttfb)

    # ------------------------------------------------------------------
    def migrate(self, session: AISession, zone: str) -> MigrationOutcome:
        if not session.committed():
            raise SessionError(FailureCause.POLICY_DENIAL,
                               "migration requires a committed session")
        src = session.binding.site_id
        t0 = self.clock.now()
        session.mark_migrating()
        prepared = None
        ticket: Optional[TransferTicket] = None
        two_phase = hasattr(self.transfer_fn, "begin")
        fed = self.federation
        try:
            if fed is not None:
                cands = fed.merged_discover(session, zone,
                                            exclude_sites=(src,))
            else:
                cands = discover(session.asp, self.catalog, self.sites,
                                 self.predictors, zone,
                                 analytics=self.analytics)
            target = page(session.asp, cands, exclude_sites=(src,))
            remote = fed is not None and fed.is_remote(target)
            ctx = self.context_tokens(session)
            if remote:
                # roaming handshake: visited PREPARE held through τ_mig
                prepared = fed.prepare_remote(
                    session, target, hold_s=self.timers.tau_mig,
                    context_tokens=ctx)
                payload = int(prepared.cache_bytes)
            else:
                model = target.model
                payload = model.session_state_bytes(ctx)
                prepared = self.coord.prepare(
                    model, target.site_id, zone, target.klass, slots=1,
                    cache_bytes=payload, hold_s=self.timers.tau_mig)
            # ---- state transfer under τ_mig, source still committed -----
            if two_phase:
                ticket = self.transfer_fn.begin(
                    session, self.sites[src], self.sites[target.site_id],
                    payload_bytes=payload)
                transfer_s = ticket.wire_s
            else:
                transfer_s = float(self.transfer_fn(
                    session, self.sites[src], self.sites[target.site_id]))
            if transfer_s > self.timers.tau_mig:
                raise SessionError(
                    FailureCause.STATE_TRANSFER_FAILURE,
                    f"transfer {transfer_s:.3f}s exceeds τ_mig="
                    f"{self.timers.tau_mig}s")
            self.clock.sleep(transfer_s)
            if self.clock.now() - t0 > self.timers.tau_mig:
                raise SessionError(FailureCause.DEADLINE_EXPIRY,
                                   "migration deadline expired")
            # ---- commit target, THEN the old binding is released ---------
            if remote:
                binding = fed.commit_remote(session, target, prepared)
            else:
                binding = self.coord.commit(prepared, model)
            session.bind(binding)   # make-before-break swap (session.bind)
            if ticket is not None:
                # data-plane break: source slot released, stream resumes on
                # the target plane (QoS occupancy follows the session)
                self.transfer_fn.commit(ticket)
            return MigrationOutcome(
                migrated=True, aborted=False, cause=None, from_site=src,
                to_site=target.site_id, interruption_ms=0.0,
                transfer_ms=transfer_s * 1e3,
                transfer_bytes=ticket.nbytes if ticket else 0,
                fingerprint=ticket.fingerprint if ticket else None,
                mid_stream=bool(ticket and ticket.handoff
                                and ticket.handoff.request is not None))
        except SessionError as e:
            # abort: roll back the target (leases AND provisional state),
            # keep serving on the source
            if ticket is not None:
                self.transfer_fn.abort(ticket)
            if prepared is not None:
                if getattr(prepared, "is_federated", False):
                    fed.abort_remote(prepared, reason=e.cause.value)
                else:
                    self.coord.abort(prepared)
            if session.state.value == "migrating":
                # still committed on the source ⇒ fall back without teardown
                session.state = type(session.state).COMMITTED
                session.history.append((self.clock.now(),
                                        f"migration-aborted:{e.cause.value}"))
            return MigrationOutcome(
                migrated=False, aborted=True, cause=e.cause, from_site=src,
                to_site=None, interruption_ms=0.0)
