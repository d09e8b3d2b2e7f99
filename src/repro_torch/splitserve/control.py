"""SplitManager: control-plane lifecycle of split sessions.

One manager attaches to an Orchestrator (``orch.splits``) and owns the
second (verify) anchor of every split session. Design invariants:

* **The session's own binding is the EDGE draft anchor** — the
  interactive data-plane path the invoker streams from. The verify
  anchor's leases live in :class:`SplitState`. Losing the verify anchor
  therefore never orphans the session or its in-flight requests: the
  split *degrades* to edge-only (explicit quality-tier event), never
  fails.
* **Atomic dual-anchor 2PC**: establishment PREPAREs both anchors
  provisionally and COMMITs both or rolls BOTH back — a half-reserved
  split is not representable, exactly like the single-anchor Eq. 4/10
  coupling.
* **Vocab compatibility is a PREPARE-time check**: a draft/target token
  -space mismatch raises ``NO_FEASIBLE_BINDING`` before any lease is
  taken, never a mid-stream decode fault.
* **Acceptance accounting**: the data plane reports per-round
  draft/accept counts (``note_round``); the heartbeat folds them into an
  EWMA and collapses the split (make-before-break re-anchor onto the
  verify tier) when the Eq. 14-style predictor says spec-decode stopped
  paying for itself.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

from repro_torch.configs.registry import draft_compatible
from repro_torch.core.failures import FailureCause, SessionError
from repro_torch.core.session import AISession, Binding, SessionState
from repro_torch.core.telemetry import BoundaryTelemetry
from repro_torch.splitserve.placement import (DEFAULT_GAMMA, SplitPlacement,
                                        propose_split, reverify)
from repro_torch.splitserve.runtime import expected_round_tokens

#: EWMA weight of the newest acceptance sample
_EWMA = 0.3
#: collapse the split when predicted tokens/round drops below this —
#: at that point the per-round verify RTT amortization that justified
#: the split is gone (Eq. 14 reasoning on the acceptance predictor)
_MIN_ROUND_TOKENS = 1.25


@dataclass
class SplitState:
    """Book-keeping for one split session."""
    placement: SplitPlacement
    verify_binding: Optional[Binding]    # None ⇒ degraded (edge-only)
    gamma: int = DEFAULT_GAMMA
    accept_ewma: Optional[float] = None  # None until first round report
    rounds: int = 0
    drafted: int = 0
    accepted: int = 0
    degraded: bool = False
    low_streak: int = 0

    @property
    def acceptance(self) -> float:
        return self.accepted / self.drafted if self.drafted else 0.0

    def predicted_round_tokens(self) -> float:
        a = self.accept_ewma if self.accept_ewma is not None \
            else self.acceptance
        return expected_round_tokens(a, self.gamma)


class SplitManager:
    def __init__(self, orch, *, gamma: int = DEFAULT_GAMMA,
                 collapse_after: int = 2):
        self.orch = orch
        self.gamma = int(gamma)
        self.collapse_after = int(collapse_after)
        self.states: Dict[str, SplitState] = {}
        orch.splits = self

    # ------------------------------------------------------------------
    def _emit(self, session: AISession, event: str,
              detail: Optional[dict] = None) -> None:
        for sink in self.orch.split_event_sinks:
            sink(session.session_id, event, dict(detail or {}))

    def is_split(self, session_id: str) -> bool:
        return session_id in self.states

    def state_of(self, session_id: str) -> Optional[SplitState]:
        return self.states.get(session_id)

    # ------------------------------------------------------------------
    # establishment
    # ------------------------------------------------------------------
    def try_establish(self, session: AISession) -> bool:
        """Policy-gated split establishment. ``auto`` falls back to the
        single-anchor path when no feasible split EXISTS (pre-lease
        failure leaves the session state machine untouched); ``require``
        propagates the refusal. Returns True when the session committed
        as a split."""
        policy = session.asp.split_policy
        if policy == "never":
            return False
        try:
            placement = propose_split(
                session.asp, self.orch.catalog, self.orch.sites,
                self.orch.predictors, session.zone,
                analytics=self.orch.analytics, gamma=self.gamma)
        except SessionError:
            if policy == "require":
                raise
            return False                 # auto: single-anchor fallback
        self.establish_split(session, placement)
        return True

    def establish_split(self, session: AISession,
                        placement: SplitPlacement) -> None:
        """Atomic dual-anchor establishment: PREPARE both anchors,
        COMMIT both, bind the session at the EDGE draft anchor. Any
        failure rolls back every lease taken so far."""
        orch = self.orch
        session.mark_discovered()
        session.mark_anchored()
        # admission: the split's cost is the SUM of both legs
        orch.policy.admit_cost(
            session.asp, placement.draft.prediction.cost_per_1k
            + placement.verify.prediction.cost_per_1k)
        for cand in (placement.draft, placement.verify):
            region = cand.region or orch.sites[cand.site_id].spec.region
            orch.policy.check_region(session.authz_ref, region)
        # PREPARE-time draft compatibility (mid-stream is too late)
        if not draft_compatible(placement.draft.model.cfg,
                                placement.verify.model.cfg):
            raise SessionError(
                FailureCause.NO_FEASIBLE_BINDING,
                f"split PREPARE refused: draft "
                f"{placement.draft.model.model_id} vocab "
                f"{placement.draft.model.cfg.vocab_size} != target "
                f"{placement.verify.model.model_id} vocab "
                f"{placement.verify.model.cfg.vocab_size}")
        session.mark_preparing()
        coord = orch.coordinator
        prep_e = coord.prepare(
            placement.draft.model, placement.draft.site_id, session.zone,
            placement.draft.klass, slots=1,
            cache_bytes=placement.draft.model.session_state_bytes(2048))
        try:
            prep_v = coord.prepare(
                placement.verify.model, placement.verify.site_id,
                session.zone, placement.verify.klass, slots=1,
                cache_bytes=placement.verify.model.session_state_bytes(
                    2048))
        except BaseException:
            coord.abort(prep_e)          # co-reservation: both or neither
            raise
        session.mark_prepared()
        try:
            edge_b = coord.commit(prep_e, placement.draft.model)
        except BaseException:
            coord.abort(prep_e)          # idempotent belt-and-braces
            coord.abort(prep_v)
            raise
        try:
            verify_b = coord.commit(prep_v, placement.verify.model)
        except BaseException:
            coord.abort(prep_v)
            self._release_binding(edge_b)
            raise
        session.charging_ref = orch.policy.open_charging(
            session.session_id)
        session.bind(edge_b)             # data plane = the edge anchor
        orch.telemetry[session.session_id] = BoundaryTelemetry()
        self.states[session.session_id] = SplitState(
            placement=placement, verify_binding=verify_b,
            gamma=placement.gamma)
        self._emit(session, "split-established", {
            "draft": f"{placement.draft.model.model_id}"
                     f"@{placement.draft.site_id}",
            "verify": f"{placement.verify.model.model_id}"
                      f"@{placement.verify.site_id}",
            "gamma": placement.gamma,
            "verify_budget_p99_ms": placement.verify_budget.p99_ms,
            "draft_budget_p99_ms": placement.draft_budget.p99_ms,
        })

    # ------------------------------------------------------------------
    # data-plane accounting
    # ------------------------------------------------------------------
    def note_round(self, session_id: str, drafted: int,
                   accepted: int) -> None:
        """Per-round acceptance report from the serving plane."""
        st = self.states.get(session_id)
        if st is None or drafted <= 0:
            return
        st.rounds += 1
        st.drafted += int(drafted)
        st.accepted += int(accepted)
        sample = accepted / drafted
        st.accept_ewma = sample if st.accept_ewma is None else \
            (1 - _EWMA) * st.accept_ewma + _EWMA * sample

    # ------------------------------------------------------------------
    # heartbeat: renew the verify half + Eq. 14-style collapse trigger
    # ------------------------------------------------------------------
    def heartbeat(self, session: AISession) -> None:
        st = self.states.get(session.session_id)
        if st is None:
            return
        vb = st.verify_binding
        if vb is not None:
            site = self.orch.sites.get(vb.site_id)
            lease_s = self.orch.timers.lease_s
            ok = site is not None and not site.dead \
                and site.renew(vb.compute_lease_id, lease_s) \
                and self.orch.qos.renew(vb.qos_lease_id, lease_s)
            if not ok:
                self.degrade(session, reason="verify-lease-lapsed")
                return
        if st.accept_ewma is not None and not st.degraded:
            if st.predicted_round_tokens() < _MIN_ROUND_TOKENS:
                st.low_streak += 1
            else:
                st.low_streak = 0
            if st.low_streak >= self.collapse_after:
                self.collapse(session)

    # ------------------------------------------------------------------
    # degrade / recover / collapse / verify migration
    # ------------------------------------------------------------------
    def on_site_dead(self, site_id: str) -> None:
        """Supervisor crash hook, called BEFORE the orphan census. A dead
        VERIFY anchor degrades its sessions to edge-only (they stay bound
        and serving at the edge — zero orphans, zero failed in-flight); a
        dead EDGE anchor dissolves the split and leaves the session to
        the supervisor's normal re-anchoring."""
        for sid, st in list(self.states.items()):
            session = self.orch.sessions.get(sid)
            if session is None:
                continue
            vb = st.verify_binding
            if vb is not None and vb.site_id == site_id:
                self.degrade(session,
                             reason=f"verify anchor {site_id} dead")
            elif session.binding is not None \
                    and session.binding.site_id == site_id:
                self._drop_verify(st)
                del self.states[sid]
                self._emit(session, "split-dissolved",
                           {"reason": f"edge anchor {site_id} dead"})

    def degrade(self, session: AISession, *, reason: str) -> None:
        """Airplane mode: release the verify half (a dead site's release
        is a no-op) and keep streaming edge-only. The session never
        leaves the committed domain — this is a QUALITY event, not a
        failure."""
        st = self.states[session.session_id]
        if st.degraded:
            return
        self._drop_verify(st)
        st.degraded = True
        st.low_streak = 0
        self._emit(session, "split-degraded",
                   {"reason": reason, "mode": "edge-only",
                    "quality": "draft-tier"})

    def recover(self, session: AISession) -> None:
        """Re-attach a verify anchor to a degraded split: re-page the
        verify half (crashed sites are excluded by the supervisor's
        analytics verdict), PREPARE/COMMIT it, restore full quality."""
        st = self.states[session.session_id]
        if not st.degraded:
            return
        placement = reverify(
            st.placement, session.asp, self.orch.catalog, self.orch.sites,
            self.orch.predictors, session.zone,
            analytics=self.orch.analytics)
        vb = self._reserve_verify(session, placement)
        st.placement = placement
        st.verify_binding = vb
        st.degraded = False
        self._emit(session, "split-recovered", {
            "verify": f"{placement.verify.model.model_id}"
                      f"@{placement.verify.site_id}",
            "quality": "full"})

    def migrate_verify(self, session: AISession,
                       exclude_sites: tuple = ()) -> str:
        """Make-before-break re-anchor of the VERIFY tier only: the new
        verify anchor is reserved while the old one still holds, then the
        old leases release — the edge draft keeps streaming throughout.
        Returns the new verify site id."""
        st = self.states[session.session_id]
        if st.verify_binding is None:
            raise SessionError(FailureCause.NO_FEASIBLE_BINDING,
                               "cannot migrate a degraded split's verify "
                               "anchor; recover() it instead")
        excl = tuple(exclude_sites) or (st.verify_binding.site_id,)
        placement = reverify(
            st.placement, session.asp, self.orch.catalog, self.orch.sites,
            self.orch.predictors, session.zone,
            analytics=self.orch.analytics, exclude_verify_sites=excl)
        new_vb = self._reserve_verify(session, placement)
        old_vb = st.verify_binding
        st.placement = placement
        st.verify_binding = new_vb       # break only after make
        self._release_binding(old_vb)
        self._emit(session, "verify-migrated", {
            "from": old_vb.site_id, "to": new_vb.site_id})
        return new_vb.site_id

    def collapse(self, session: AISession) -> None:
        """Un-split: acceptance collapsed, so spec-decode costs more than
        it saves. Re-anchor the session onto its verify binding
        (make-before-break — bind() releases the edge half only after the
        verify binding is committed as the primary) and drop the split."""
        st = self.states.pop(session.session_id)
        vb = st.verify_binding
        if vb is None:
            self.states[session.session_id] = st
            raise SessionError(FailureCause.NO_FEASIBLE_BINDING,
                               "cannot collapse a degraded split")
        if session.state is SessionState.COMMITTED:
            session.mark_migrating()
        session.bind(vb)                 # MBB: edge leases release here
        self._emit(session, "split-collapsed", {
            "anchor": vb.site_id,
            "acceptance": round(st.acceptance, 4),
            "predicted_round_tokens":
                round(st.predicted_round_tokens(), 3)})

    # ------------------------------------------------------------------
    def on_release(self, session: AISession) -> None:
        """Session teardown: free the verify half's leases and state."""
        st = self.states.pop(session.session_id, None)
        if st is not None:
            self._drop_verify(st)

    # ------------------------------------------------------------------
    # internals
    # ------------------------------------------------------------------
    def _reserve_verify(self, session: AISession,
                        placement: SplitPlacement) -> Binding:
        """PREPARE/COMMIT only the verify half (edge half already
        committed and serving)."""
        orch = self.orch
        cand = placement.verify
        orch.policy.check_region(
            session.authz_ref,
            cand.region or orch.sites[cand.site_id].spec.region)
        prep = orch.coordinator.prepare(
            cand.model, cand.site_id, session.zone, cand.klass, slots=1,
            cache_bytes=cand.model.session_state_bytes(
                max(session.context_tokens, 2048)))
        return orch.coordinator.commit(prep, cand.model)

    def _drop_verify(self, st: SplitState) -> None:
        if st.verify_binding is not None:
            self._release_binding(st.verify_binding)
            st.verify_binding = None

    def _release_binding(self, b: Binding) -> None:
        site = self.orch.sites.get(b.site_id)
        if site is not None:
            site.release(b.compute_lease_id)
        self.orch.qos.release(b.qos_lease_id)

    # ------------------------------------------------------------------
    def stats(self) -> dict:
        """Fleet-level split accounting (benches + supervisors)."""
        return {
            "sessions": len(self.states),
            "degraded": sum(1 for s in self.states.values() if s.degraded),
            "rounds": sum(s.rounds for s in self.states.values()),
            "acceptance": (
                sum(s.accepted for s in self.states.values())
                / max(sum(s.drafted for s in self.states.values()), 1)),
        }
