"""Two-phase PREPARE/COMMIT — atomic co-reservation of compute and QoS.

Correctness requirements implemented here (Section IV-B):

* **No partial allocation is representable**: PREPARE obtains *provisional*
  leases on both planes; if either PREPARE fails, the other is rolled back
  before the error propagates. COMMIT confirms both or releases both.
* **Explicit deadlines** (Eq. 11): each phase runs under its τ; expiry maps
  to FailureCause.DEADLINE_EXPIRY, scarcity maps to COMPUTE_SCARCITY /
  QOS_SCARCITY — never conflated (Eq. 12).
* **Idempotent rollback**: release on both planes tolerates repeats, so a
  crashed coordinator can always be re-driven to a clean state.
* **Orphan reaping**: every PREPARE is tracked until its COMMIT/ABORT
  arrives; :meth:`TwoPhaseCoordinator.reap` aborts the ones whose decision
  was lost in flight once τ_prep + τ_com + hold has passed — the timers
  are enforced, not advisory.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

from repro_torch.core.catalog import ModelEntry
from repro_torch.core.clock import Clock
from repro_torch.core.failures import FailureCause, SessionError, Timers
from repro_torch.core.qos import QoSFlowManager, TransportClass
from repro_torch.core.session import Binding


@dataclass
class Prepared:
    """Result of a successful PREPARE: both provisional leases."""
    compute_lease_id: str
    qos_lease_id: str
    site_id: str
    qfi: int
    prepared_at: float
    #: extra seconds the provisional leases stay committable beyond τ_com —
    #: make-before-break migration holds the target through the τ_mig
    #: transfer window while the source keeps serving
    hold_s: float = 0.0


class TwoPhaseCoordinator:
    def __init__(self, clock: Clock, sites, qos: QoSFlowManager,
                 timers: Timers):
        self.clock = clock
        self.sites = sites
        self.qos = qos
        self.timers = timers
        self.log: list = []    # coordinator write-ahead log (audit + tests)
        #: PREPAREs whose COMMIT/ABORT has not arrived, by compute lease id
        #: — the reaper's work queue when a decision is lost in flight
        self.outstanding: Dict[str, Prepared] = {}

    def _deadline_guard(self, t0: float, tau: float, phase: str) -> None:
        if self.clock.now() - t0 > tau:
            raise SessionError(FailureCause.DEADLINE_EXPIRY,
                               f"{phase} exceeded τ={tau}s")

    # ------------------------------------------------------------------
    def prepare(self, model: ModelEntry, site_id: str, zone: str,
                klass: TransportClass, *, slots: int,
                cache_bytes: float, hold_s: float = 0.0) -> Prepared:
        """Stage 1: obtain BOTH provisional leases or none. ``hold_s``
        extends the provisional TTL and the COMMIT window (migration holds
        the target across the τ_mig state-transfer window)."""
        t0 = self.clock.now()
        site = self.sites[site_id]
        ttl_s = self.timers.tau_prep + self.timers.tau_com + hold_s
        self.log.append(("prepare.begin", t0, site_id))
        cmp_lease = site.prepare(model, slots=slots, cache_bytes=cache_bytes,
                                 ttl_s=ttl_s)
        try:
            self._deadline_guard(t0, self.timers.tau_prep, "PREPARE(compute)")
            qos_lease = self.qos.prepare(
                (zone, site_id), klass, ttl_s=ttl_s)
        except BaseException:
            # roll back the compute side before surfacing the QoS failure —
            # partial allocation must never escape this function
            site.release(cmp_lease.lease_id)
            self.log.append(("prepare.rollback", self.clock.now(), site_id))
            raise
        try:
            self._deadline_guard(t0, self.timers.tau_prep, "PREPARE")
        except BaseException:
            site.release(cmp_lease.lease_id)
            self.qos.release(qos_lease.lease_id)
            self.log.append(("prepare.rollback", self.clock.now(), site_id))
            raise
        self.log.append(("prepare.ok", self.clock.now(), site_id))
        prepared = Prepared(compute_lease_id=cmp_lease.lease_id,
                            qos_lease_id=qos_lease.lease_id,
                            site_id=site_id, qfi=qos_lease.qfi,
                            prepared_at=self.clock.now(), hold_s=hold_s)
        self.outstanding[prepared.compute_lease_id] = prepared
        return prepared

    # ------------------------------------------------------------------
    def prepare_transport(self, path, klass: TransportClass, *,
                          ttl_s: float):
        """Home-side half of a CROSS-DOMAIN prepare: only the transport
        plane is reserved locally (the access + inter-domain leg) — the
        compute half is the visited domain's own coordinator, driven over
        the east-west wire. Logged in the same WAL so a federated 2PC is
        auditable end to end; returns the provisional QoS lease."""
        t0 = self.clock.now()
        self.log.append(("prepare_transport.begin", t0, path))
        lease = self.qos.prepare(path, klass, ttl_s=ttl_s)
        self.log.append(("prepare_transport.ok", self.clock.now(), path))
        return lease

    # ------------------------------------------------------------------
    def commit(self, prepared: Prepared, model: ModelEntry) -> Binding:
        """Stage 2: confirm both leases; on ANY failure release both."""
        t0 = self.clock.now()
        site = self.sites[prepared.site_id]
        self.outstanding.pop(prepared.compute_lease_id, None)
        try:
            self._deadline_guard(prepared.prepared_at,
                                 self.timers.tau_com + prepared.hold_s,
                                 "COMMIT")
            site.confirm(prepared.compute_lease_id,
                         lease_s=self.timers.lease_s)
            self.qos.confirm(prepared.qos_lease_id,
                             lease_s=self.timers.lease_s)
        except BaseException:
            self.abort(prepared)
            raise
        self.log.append(("commit.ok", self.clock.now(), prepared.site_id))
        return Binding(
            model_id=model.model_id, model_version=model.version,
            site_id=prepared.site_id,
            endpoint=f"aiaas://{prepared.site_id}/{model.model_id}",
            qfi=prepared.qfi,
            steering_handle=f"steer/{prepared.site_id}/qfi{prepared.qfi}",
            compute_lease_id=prepared.compute_lease_id,
            qos_lease_id=prepared.qos_lease_id)

    # ------------------------------------------------------------------
    def abort(self, prepared: Prepared) -> None:
        """Idempotent rollback of both provisional leases."""
        self.outstanding.pop(prepared.compute_lease_id, None)
        self.sites[prepared.site_id].release(prepared.compute_lease_id)
        self.qos.release(prepared.qos_lease_id)
        self.log.append(("abort", self.clock.now(), prepared.site_id))

    # ------------------------------------------------------------------
    def reap(self, now: Optional[float] = None) -> List[Prepared]:
        """Abort every outstanding PREPARE whose decision window has
        passed (τ_prep + τ_com + hold) — the COMMIT/ABORT was lost in
        flight and no caller will ever re-drive it. Idempotent; called on
        the plane-heartbeat cadence."""
        now = self.clock.now() if now is None else now
        horizon = self.timers.tau_prep + self.timers.tau_com
        orphans = [p for p in self.outstanding.values()
                   if now - p.prepared_at > horizon + p.hold_s]
        for p in orphans:
            self.log.append(("reap", now, p.site_id))
            self.abort(p)
        return orphans
