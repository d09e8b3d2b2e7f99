"""Per-site supervisor: health, graceful drain, crash re-anchoring.

Production serving is mostly what happens when things die. This module is
the fleet-ops layer over one ServingPlane/engine pair — modeled on
config-driven process supervision (liveness/readiness probes, explicit
exit-behavior semantics) — that converts the paper's Eq. 12 failure-cause
taxonomy from a table into measured behavior:

* **probe** — liveness is "the heartbeat tick completes" (``plane.load()``,
  the exact path ``Orchestrator.heartbeat`` drives, including the
  hibernation idle-TTL tick); readiness is "live AND admitting". Probe
  results feed ``Analytics.observe_site`` so the ξ loop sees supervisor
  cadence even for sessions that stopped heartbeating. A probe never
  raises: ``miss_threshold`` consecutive failed probes escalate
  SUSPECT → DEAD and fire the crash path.
* **drain** — graceful exit: stop admitting (submits reject, accounted) →
  finish every in-flight and queued request (zero failed) → migrate bound
  sessions out via the existing make-before-break ``PlaneTransferPath`` →
  hibernate what cannot move (host store survives the exiting process) →
  deny the site in analytics.
* **crash** — abrupt death: the lease table and device state are gone.
  In-flight and queued requests fail attributably (COMPUTE_SCARCITY: the
  anchor's compute vanished mid-contract), the site is marked dead
  everywhere (leases void ⇒ v_cmp False, DISCOVER exclusion ``site-dead``),
  and every orphaned session re-anchors through
  ``Orchestrator.reanchor`` — resuming from the hibernation store when it
  holds a copy, fresh-context re-prepare otherwise.

Eq. 12 attribution for supervisor-detected failures:

====================================  =============================
event                                 cause
====================================  =============================
in-flight request on crashed site     COMPUTE_SCARCITY
queued request on crashed site        COMPUTE_SCARCITY
re-anchor: no live candidate          NO_FEASIBLE_BINDING
re-anchor: all candidates saturated   COMPUTE_SCARCITY
re-anchor: exceeded τ_mig             DEADLINE_EXPIRY
corrupt hibernated copy on restore    (none — degrades to fresh context)
====================================  =============================
"""

from __future__ import annotations

import enum
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from repro_torch.core.failures import FailureCause
from repro_torch.core.session import SessionState
from repro_torch.serving.plane import PlaneLoad


class SiteHealth(enum.Enum):
    HEALTHY = "healthy"
    SUSPECT = "suspect"          # missed probes, below the death threshold
    DRAINING = "draining"
    DRAINED = "drained"
    DEAD = "dead"


@dataclass
class ProbeResult:
    site_id: str
    live: bool                   # heartbeat tick completed
    ready: bool                  # live AND admitting (not draining/dead)
    state: SiteHealth
    load: Optional[PlaneLoad] = None
    error: str = ""
    misses: int = 0


@dataclass
class DrainReport:
    site_id: str
    migrated: int = 0            # moved out make-before-break
    hibernated: int = 0          # parked to the host store (couldn't move)
    stranded: int = 0            # neither migrated nor hibernated
    failed_inflight: int = 0     # in-flight requests failed during drain
    completed: int = 0           # requests finished while draining
    sessions: int = 0            # bound sessions at drain start


@dataclass
class CrashReport:
    site_id: str
    orphaned: int = 0            # sessions anchored here at crash
    reanchored: int = 0
    restored: int = 0            # re-anchored AND state resumed from store
    lost: int = 0                # re-anchor failed (session FAILED)
    failed_inflight: int = 0     # running+queued requests attributed
    causes: Dict[str, int] = field(default_factory=dict)
    recovery_ms: List[float] = field(default_factory=list)  # per session

    @property
    def survival_frac(self) -> float:
        return self.reanchored / self.orphaned if self.orphaned else 1.0


def _percentile(xs: List[float], q: float) -> float:
    if not xs:
        return 0.0
    ys = sorted(xs)
    return ys[min(int(q * (len(ys) - 1) + 0.999), len(ys) - 1)]


class SiteSupervisor:
    """Supervises ONE execution site of an orchestrator."""

    def __init__(self, orch, site_id: str, *, miss_threshold: int = 3):
        self.orch = orch
        self.site_id = site_id
        self.site = orch.sites[site_id]
        self.state = SiteHealth.HEALTHY
        self.miss_threshold = miss_threshold
        self._misses = 0

    # ------------------------------------------------------------------
    # health
    # ------------------------------------------------------------------
    def probe(self) -> ProbeResult:
        """One liveness/readiness probe. Never raises — a backend that dies
        on its own heartbeat tick IS the crash signal, not a supervisor
        crash. ``miss_threshold`` consecutive failures declare the site
        dead and fire the full crash path (attribution + re-anchoring)."""
        if self.state is SiteHealth.DEAD:
            return ProbeResult(self.site_id, False, False, self.state,
                               error="site is dead", misses=self._misses)
        plane = self.site.plane
        if plane is None:
            # control-plane-only site: the lease table is process-local,
            # live by definition; readiness tracks supervisor state
            return ProbeResult(self.site_id, True,
                               self.state is SiteHealth.HEALTHY, self.state)
        breakers = getattr(self.orch, "breakers", None)
        try:
            load = plane.load()
        except Exception as e:                      # noqa: BLE001
            self._misses += 1
            if breakers is not None:
                breakers.record(self.site_id, False)
            if self._misses >= self.miss_threshold:
                self.crash(detail=f"probe: {type(e).__name__}: {e}")
            elif self.state is SiteHealth.HEALTHY:
                self.state = SiteHealth.SUSPECT
            return ProbeResult(self.site_id, False, False, self.state,
                               error=f"{type(e).__name__}: {e}",
                               misses=self._misses)
        self._misses = 0
        if breakers is not None:
            # a completed heartbeat tick is the half-open probe success that
            # re-closes this site's circuit for DISCOVER
            breakers.record(self.site_id, True)
        if self.state is SiteHealth.SUSPECT:
            self.state = SiteHealth.HEALTHY
        # supervisor cadence feeds the ξ loop: site health is observed even
        # when no session heartbeat lands on this site
        self.orch.analytics.observe_site(
            self.site_id, utilization=self.site.utilization(),
            queue_depth=load.queue_depth, arrival_rate=load.arrival_rate,
            page_util=load.page_util)
        ready = self.state is SiteHealth.HEALTHY \
            and getattr(plane, "admitting", True)
        return ProbeResult(self.site_id, True, ready, self.state, load=load)

    # ------------------------------------------------------------------
    # session census
    # ------------------------------------------------------------------
    def _anchored_sessions(self) -> list:
        """Sessions whose binding anchors them to this site, in a state
        worth recovering. Checks the state machine, NOT ``committed()`` —
        a crashed site has already voided v_cmp for exactly the sessions
        we must recover."""
        out = []
        for s in self.orch.sessions.values():
            b = getattr(s, "binding", None)
            state = getattr(s, "state", None)
            if b is not None and b.site_id == self.site_id and \
                    state in (SessionState.COMMITTED, SessionState.MIGRATING):
                out.append(s)
        return out

    # ------------------------------------------------------------------
    # graceful drain
    # ------------------------------------------------------------------
    def drain(self) -> DrainReport:
        """Graceful exit. In-flight work finishes (never fails), then every
        bound session leaves: make-before-break migration out first,
        hibernation to the surviving host store for whatever cannot move.
        The site ends DRAINED and analytics-denied (discovery steers away),
        with its lease table intact — drain is an exit, not a crash."""
        self.state = SiteHealth.DRAINING
        plane = self.site.plane
        report = DrainReport(self.site_id)
        # steer new placements away while we move sessions out
        self.orch.analytics.deny_site(self.site_id)
        if plane is not None:
            plane.admitting = False
            plane.drain()                 # in-flight + queued all complete
            for res in self.orch.record_results(self.site):
                if res.failed is not None:
                    report.failed_inflight += 1
                else:
                    report.completed += 1
        sessions = self._anchored_sessions()
        report.sessions = len(sessions)
        backend = plane.backend if plane is not None else None
        engine = getattr(backend, "engine", None)
        for session in sessions:
            out = self.orch.migrations.migrate(session, session.zone)
            if out.migrated:
                report.migrated += 1
                continue
            sid = session.session_id
            if engine is not None and \
                    getattr(engine, "hibernation", None) is not None:
                if engine.has_hibernated(sid):
                    report.hibernated += 1      # already in the host tier
                    continue
                if engine.has_slot(sid) and engine.hibernate_slot(sid):
                    report.hibernated += 1
                    continue
            report.stranded += 1
        self.state = SiteHealth.DRAINED
        return report

    # ------------------------------------------------------------------
    # crash
    # ------------------------------------------------------------------
    def crash(self, detail: str = "site crashed") -> CrashReport:
        """Abrupt site death. Device state and the lease table are gone;
        the hibernation store (host memory) survives. Attribution first,
        then AI-PAGING re-anchoring for every orphan — per-session recovery
        wall time is what the recovery bench reports as p50/p99."""
        plane = self.site.plane
        # split sessions first, while the lease table is still intact: a
        # dead VERIFY anchor degrades its splits to edge-only (they keep
        # their edge binding and never appear in the orphan census below);
        # a dead EDGE anchor dissolves the split and falls through to the
        # normal re-anchoring path
        splits = getattr(self.orch, "splits", None)
        if splits is not None:
            splits.on_site_dead(self.site_id)
        # the census must run BEFORE leases are voided: these sessions stop
        # being distinguishable once the lease table clears
        orphans = self._anchored_sessions()
        store = None
        if plane is not None:
            backend = plane.backend
            store_fn = getattr(backend, "_store", None)
            store = store_fn() if callable(store_fn) else None
        self.state = SiteHealth.DEAD
        self.site.mark_dead(detail)
        self.orch.analytics.mark_site_dead(self.site_id)
        report = CrashReport(self.site_id, orphaned=len(orphans))
        if plane is not None:
            report.failed_inflight = plane.fail_all(
                FailureCause.COMPUTE_SCARCITY)
            self.orch.record_results(self.site)   # attribution → telemetry
        for session in orphans:
            t0 = time.perf_counter()
            out = self.orch.reanchor(session, state_source=store)
            if out.ok:
                report.reanchored += 1
                report.restored += int(out.restored)
                report.recovery_ms.append((time.perf_counter() - t0) * 1e3)
            else:
                report.lost += 1
                key = out.cause.value if out.cause else "unknown"
                report.causes[key] = report.causes.get(key, 0) + 1
        return report

    def revive(self) -> None:
        """Recovered process: fresh lease table, admission reopens, the
        site returns to DISCOVER. Sessions do NOT return — they re-anchored
        elsewhere; new establishes may land here again."""
        self.site.mark_alive()
        self.orch.analytics.mark_site_alive(self.site_id)
        self.orch.analytics.allow_site(self.site_id)
        if self.site.plane is not None:
            self.site.plane.admitting = True
        self.state = SiteHealth.HEALTHY
        self._misses = 0


class FleetSupervisor:
    """One SiteSupervisor per local site of an orchestrator — the sweep a
    deployment runs at health-check cadence, plus named drain/crash entry
    points for operations and chaos harnesses."""

    def __init__(self, orch, *, miss_threshold: int = 3):
        self.orch = orch
        self.supervisors: Dict[str, SiteSupervisor] = {
            sid: SiteSupervisor(orch, sid, miss_threshold=miss_threshold)
            for sid, site in orch.sites.items()
            if not getattr(site, "is_guest_view", False)}

    def __getitem__(self, site_id: str) -> SiteSupervisor:
        return self.supervisors[site_id]

    def probe_all(self) -> Dict[str, ProbeResult]:
        return {sid: sup.probe() for sid, sup in self.supervisors.items()}

    def ready(self) -> Dict[str, bool]:
        return {sid: r.ready for sid, r in self.probe_all().items()}

    def drain(self, site_id: str) -> DrainReport:
        return self.supervisors[site_id].drain()

    def crash(self, site_id: str, detail: str = "site crashed") -> CrashReport:
        return self.supervisors[site_id].crash(detail)

    def revive(self, site_id: str) -> None:
        self.supervisors[site_id].revive()
