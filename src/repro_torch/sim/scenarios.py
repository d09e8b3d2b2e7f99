"""§V scenarios: endpoint AIaaS baseline vs NE-AIaaS (Figs. 2 and 3), plus
the serving-plane workloads the unified scheduler unlocks (multi-class
mixes, bursty arrivals, load + mobility at 10k+ concurrent sessions).

* **Endpoint baseline** — fixed cloud endpoint over best-effort transport;
  ALL requests are accepted and accumulate in the server queue (Lindley
  recursion); violation probability is computed over all requests (queueing
  is part of the user-perceived service).
* **NE-AIaaS** — session-oriented AND network-exposed: the arm establishes
  its session through the :class:`~repro_torch.api.gateway.NorthboundGateway`
  (DISCOVER → PAGE → PREPARE/COMMIT wire messages) and submits every
  request northbound, so the queueing machinery it measures is the REAL
  :class:`~repro_torch.serving.plane.ServingPlane` + ``QoSScheduler`` under a
  ``VirtualClock`` — slot admission with a bounded queue rejects offered
  load past the committed capacity (the 2PC admission cap at session
  granularity; a rejected ``SubmitAck`` IS the loss event), admitted
  requests occupy decode slots for a service time sampled from
  ``LatencyModel`` (its ONLY remaining role on this arm), heartbeats renew
  the leases across the run, and transport rides the QoS-provisioned
  class. Violation probability is "served-and-failed" over admitted
  requests (Eq. 16 semantics). There is no parallel closed-form queue
  model on this arm.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.clock import VirtualClock
from repro_torch.serving.plane import ServingPlane, SimulatedEngine
from repro_torch.sim.latency import LatencyModel, SimConfig


@dataclass
class LoadPointResult:
    rho: float
    p50_ms: float
    p95_ms: float
    p99_ms: float
    violation_prob: float
    admitted_frac: float = 1.0
    decomposition: dict = field(default_factory=dict)   # mean Wq / infer / net


def _eval(latency: np.ndarray, ell99: float, t_max: float) -> float:
    """Eq. (16): violation ⟺ (L > ℓ99) ∨ (L > T_max)."""
    return float(np.mean((latency > ell99) | (latency > t_max)))


def simulate_endpoint(rho: float, model: LatencyModel, *, ell99: float,
                      t_max: float, seed: int = 0) -> LoadPointResult:
    rng = np.random.default_rng(seed * 7919 + int(rho * 1000))
    n = model.cfg.n_requests
    infer = model.infer_times(rng, n)
    wq = model.queue_wait(rng, n, rho, infer)
    net = model.transport_best_effort(rng, n)
    lat = wq + infer + net
    return LoadPointResult(
        rho=rho,
        p50_ms=float(np.quantile(lat, 0.5)),
        p95_ms=float(np.quantile(lat, 0.95)),
        p99_ms=float(np.quantile(lat, 0.99)),
        violation_prob=_eval(lat, ell99, t_max),
        admitted_frac=1.0,
        decomposition={"wq": float(wq.mean()), "infer": float(infer.mean()),
                       "net": float(net.mean())})


# ----------------------------------------------------------------------
# gateway-driven NE-AIaaS arm
# ----------------------------------------------------------------------
def _drive_plane(plane: ServingPlane, clock: VirtualClock,
                 arrivals_s: np.ndarray, submit_kwargs) -> None:
    """Feed a Poisson-arrival open loop through the plane under virtual
    time: completions interleave with arrivals event-by-event."""
    for i, t in enumerate(arrivals_s):
        plane.run_until(float(t))
        plane.submit(**submit_kwargs(i))
    plane.drain()


def _neaiaas_gateway(clock: VirtualClock, cap: int, sampler, t_max: float):
    """One committed-capacity execution site fronted by the northbound
    gateway: the bounded-queue plane (the 2PC admission point) is attached
    to the site BEFORE establishment, so the session's serve path runs the
    exact scheduler the Monte-Carlo measures."""
    import dataclasses as _dc

    from repro_torch.api.client import SessionClient
    from repro_torch.api.gateway import NorthboundGateway
    from repro_torch.core import Orchestrator, default_asp
    from repro_torch.core.asp import QualityTier
    from repro_torch.core.catalog import Catalog, default_catalog
    from repro_torch.core.failures import Timers
    from repro_torch.core.sites import ExecutionSite, SiteSpec

    cat = Catalog()
    cat.register(default_catalog().get("edge-tiny"))
    spec = SiteSpec("neaiaas", "edge", "eu", chips=16,
                    hbm_bytes_total=16 * 16e9, peak_flops=16 * 197e12,
                    hbm_bw=16 * 819e9, decode_slots=cap,
                    rtt_ms={"zone-a": 2.0},
                    hosted_models=("edge-tiny@1.0",),
                    price_per_chip_s=2.0e-4)
    sites = {"neaiaas": ExecutionSite(spec, clock)}
    t_max_s = t_max / 1e3
    orch = Orchestrator(clock=clock, catalog=cat, sites=sites,
                        timers=Timers(tau_mig=min(2.0, 0.9 * t_max_s)))
    plane = ServingPlane(
        clock, SimulatedEngine(clock, service_sampler=sampler),
        slots=cap, premium_reserved_frac=0.0, max_queue=0,
        site_id="neaiaas")
    sites["neaiaas"].attach_plane(plane)
    gw = NorthboundGateway(orch)
    # BASIC tier admits the edge-tiny entry; with zero premium reservation
    # and a single class the admission order is class-independent
    asp = default_asp(tier=QualityTier.BASIC)
    asp = _dc.replace(asp, objectives=_dc.replace(
        asp.objectives, ttfb_ms=0.3 * t_max, p95_ms=0.6 * t_max,
        p99_ms=0.9 * t_max, t_max_ms=t_max, nu_min=0.0))
    client = SessionClient(gw, asp, invoker="asp-0", zone="zone-a",
                           subscribe_events=False).establish()
    return gw, client


def simulate_neaiaas(rho: float, model: LatencyModel, *, ell99: float,
                     t_max: float, target_util: float = 0.75,
                     seed: int = 0, slots: int = 64) -> LoadPointResult:
    rng = np.random.default_rng(seed * 104729 + int(rho * 1000))
    n = model.cfg.n_requests
    clock = VirtualClock()

    # committed capacity: PREPARE/COMMIT admits sessions only up to
    # target_util × slots concurrent decode slots; the plane's scheduler IS
    # that admission point (bounded queue ⇒ loss past the committed share)
    cap = max(1, int(slots * target_util))
    infer = model.infer_times(rng, n)            # service-time sampler only
    idx = {"i": 0}

    def sampler(req):
        i = idx["i"]
        idx["i"] += 1
        return 0.0, float(infer[i % n])

    gw, client = _neaiaas_gateway(clock, cap, sampler, t_max)

    # offered load ρ is measured against the site's FULL slot capacity, the
    # same normalisation as the endpoint arm
    lam_per_ms = rho * slots / float(infer.mean())
    arrivals_s = np.cumsum(rng.exponential(1.0 / lam_per_ms, size=n)) / 1e3
    for t in arrivals_s:
        gw.pump(float(t))
        # the SDK's auto-renew keeps both leases valid across the span
        client.submit(prompt_tokens=128, gen_tokens=16)
    completions = gw.drain()

    results = [r for r in completions if r.error_code is None]
    admitted = len(results)
    if admitted == 0:
        return LoadPointResult(rho, 0.0, 0.0, 0.0, 1.0, 0.0)
    wq = np.array([r.queue_wait_ms for r in results])
    svc = np.array([r.latency_ms - r.queue_wait_ms for r in results])
    net = model.transport_qos(rng, admitted)
    lat = wq + svc + net
    return LoadPointResult(
        rho=rho,
        p50_ms=float(np.quantile(lat, 0.5)),
        p95_ms=float(np.quantile(lat, 0.95)),
        p99_ms=float(np.quantile(lat, 0.99)),
        violation_prob=_eval(lat, ell99, t_max),   # served-and-failed
        admitted_frac=admitted / n,
        decomposition={"wq": float(wq.mean()), "infer": float(svc.mean()),
                       "net": float(net.mean())})


# ----------------------------------------------------------------------
# new workloads unlocked by the unified plane
# ----------------------------------------------------------------------
@dataclass
class ClassStats:
    klass: str
    n: int
    share_offered: float
    p50_wait_ms: float
    p99_wait_ms: float
    p99_latency_ms: float
    fast_failed: int


@dataclass
class MixResult:
    rho: float
    per_class: Dict[str, ClassStats]
    total_fast_failed: int


def simulate_multiclass(rho: float, model: LatencyModel, *,
                        mix=(("premium", 0.2), ("assured", 0.3),
                             ("best-effort", 0.5)),
                        t_max: float = 1000.0, slots: int = 64,
                        n_requests: Optional[int] = None,
                        seed: int = 0) -> MixResult:
    """Mixed-class traffic through ONE plane: premium keeps its reserved
    share and strict ordering, best-effort absorbs the queueing, hopeless
    requests fast-fail instead of wasting slots."""
    rng = np.random.default_rng(seed * 7 + int(rho * 1000))
    n = n_requests or model.cfg.n_requests
    clock = VirtualClock()
    infer = model.infer_times(rng, n)
    idx = {"i": 0}

    def sampler(req):
        i = idx["i"]
        idx["i"] += 1
        return 0.0, float(infer[i % n])

    plane = ServingPlane(
        clock, SimulatedEngine(clock, service_sampler=sampler,
                               default_service_ms=float(infer.mean())),
        slots=slots, premium_reserved_frac=0.25, site_id="mix")
    names = [k for k, _ in mix]
    probs = np.array([w for _, w in mix], float)
    probs /= probs.sum()
    classes = rng.choice(len(names), size=n, p=probs)
    lam_per_ms = rho * slots / float(infer.mean())
    arrivals_s = np.cumsum(rng.exponential(1.0 / lam_per_ms, size=n)) / 1e3
    _drive_plane(plane, clock, arrivals_s,
                 lambda i: dict(session_id=f"s{i}",
                                klass=names[classes[i]],
                                prompt_tokens=128, gen_tokens=16,
                                t_max_ms=t_max))

    per_class: Dict[str, ClassStats] = {}
    results = plane.pop_results()
    for j, name in enumerate(names):
        rs = [r for r in results if r.klass == name]
        ok = [r for r in rs if r.failed is None]
        waits = np.array([r.queue_wait_ms for r in ok]) if ok else np.zeros(1)
        lats = np.array([r.latency_ms for r in ok]) if ok else np.zeros(1)
        per_class[name] = ClassStats(
            klass=name, n=len(rs), share_offered=float(probs[j]),
            p50_wait_ms=float(np.quantile(waits, 0.5)),
            p99_wait_ms=float(np.quantile(waits, 0.99)),
            p99_latency_ms=float(np.quantile(lats, 0.99)),
            fast_failed=sum(1 for r in rs if r.failed is not None))
    return MixResult(rho=rho, per_class=per_class,
                     total_fast_failed=plane.scheduler.stats.fast_failed)


@dataclass
class BurstResult:
    burst_factor: float
    p99_wait_ms: float
    p99_wait_calm_ms: float
    fast_fail_frac: float
    completed_frac: float


def simulate_bursty(model: LatencyModel, *, burst_factor: float = 5.0,
                    base_rho: float = 0.45, duty: float = 0.15,
                    period_s: float = 2.0, t_max: float = 1000.0,
                    slots: int = 64, n_requests: Optional[int] = None,
                    seed: int = 0) -> BurstResult:
    """Markov-modulated arrivals: calm at base_rho, bursts at
    burst_factor × base_rho for ``duty`` of each period. The scheduler's
    deadline fast-fail is what keeps served-and-failed low through bursts."""
    rng = np.random.default_rng(seed * 31 + int(burst_factor * 10))
    n = n_requests or model.cfg.n_requests
    clock = VirtualClock()
    infer = model.infer_times(rng, n)
    idx = {"i": 0}

    def sampler(req):
        i = idx["i"]
        idx["i"] += 1
        return 0.0, float(infer[i % n])

    plane = ServingPlane(
        clock, SimulatedEngine(clock, service_sampler=sampler,
                               default_service_ms=float(infer.mean())),
        slots=slots, premium_reserved_frac=0.0, site_id="burst")

    lam_base = base_rho * slots / float(infer.mean())          # per ms
    t_ms, arrivals_ms, in_burst_flags = 0.0, [], []
    period_ms, burst_ms = period_s * 1e3, duty * period_s * 1e3
    for _ in range(n):
        phase = t_ms % period_ms
        in_burst = phase < burst_ms
        lam = lam_base * (burst_factor if in_burst else 1.0)
        t_ms += rng.exponential(1.0 / lam)
        arrivals_ms.append(t_ms)
        in_burst_flags.append(in_burst)
    arrivals_s = np.asarray(arrivals_ms) / 1e3
    flags = {}

    def submit_kwargs(i):
        flags[f"s{i}"] = in_burst_flags[i]
        return dict(session_id=f"s{i}", klass="premium",
                    prompt_tokens=128, gen_tokens=16, t_max_ms=t_max)

    _drive_plane(plane, clock, arrivals_s, submit_kwargs)

    results = plane.pop_results()
    ok = [r for r in results if r.failed is None]
    waits = np.array([r.queue_wait_ms for r in ok]) if ok else np.zeros(1)
    calm = [r.queue_wait_ms for r in ok if not flags.get(r.session_id)]
    return BurstResult(
        burst_factor=burst_factor,
        p99_wait_ms=float(np.quantile(waits, 0.99)),
        p99_wait_calm_ms=float(np.quantile(np.asarray(calm), 0.99))
        if calm else 0.0,
        fast_fail_frac=plane.scheduler.stats.fast_failed / max(len(results), 1),
        completed_frac=sum(1 for r in ok if r.completed) / max(len(results), 1))


@dataclass
class LoadMobilityResult:
    n_sessions: int
    handovers: int
    completed_frac: float
    p99_wait_ms: float
    per_site_served: Dict[str, int]


def simulate_load_mobility(*, n_sessions: int = 10_000,
                           requests_per_session: int = 2,
                           handover_prob: float = 0.15,
                           rho: float = 0.7, t_max: float = 2000.0,
                           seed: int = 0,
                           sim: Optional[SimConfig] = None
                           ) -> LoadMobilityResult:
    """Load + mobility at 10k+ concurrent sessions across the default
    4-site topology: each session anchors on a site-local plane; between a
    session's requests a handover may re-anchor it to a neighbour site, so
    later requests land on a DIFFERENT plane's queue — the scheduling
    consequences of mobility, not just the lease mechanics."""
    cfg = sim or SimConfig()
    model = LatencyModel(cfg)
    rng = np.random.default_rng(seed)
    clock = VirtualClock()
    # slot counts mirror repro_torch.core.sites.default_sites
    topo = {"edge-a": 64, "edge-b": 64, "regional-1": 384, "central-1": 2048}
    total_slots = sum(topo.values())
    n_req = n_sessions * requests_per_session
    infer = model.infer_times(rng, n_req)
    idx = {"i": 0}

    def sampler(req):
        i = idx["i"]
        idx["i"] += 1
        return 0.0, float(infer[i % n_req])

    planes = {
        sid: ServingPlane(clock,
                          SimulatedEngine(clock, service_sampler=sampler,
                                          default_service_ms=float(infer.mean())),
                          slots=nslots, premium_reserved_frac=0.25,
                          site_id=sid)
        for sid, nslots in topo.items()}
    site_ids = list(topo)
    weights = np.array([topo[s] for s in site_ids], float)
    anchor = rng.choice(len(site_ids), size=n_sessions,
                        p=weights / weights.sum())

    lam_per_ms = rho * total_slots / float(infer.mean())
    arrivals_s = np.cumsum(
        rng.exponential(1.0 / lam_per_ms, size=n_req)) / 1e3
    klasses = np.array(["premium", "assured", "best-effort"])
    sess_klass = klasses[rng.integers(0, 3, size=n_sessions)]
    handover_draws = rng.random(n_req)
    handovers = 0

    for i, t in enumerate(arrivals_s):
        sess = i % n_sessions
        if i >= n_sessions and handover_draws[i] < handover_prob:
            # re-anchor to a random other site before this request
            anchor[sess] = (anchor[sess] + 1 +
                            int(handover_draws[i] * 1000) % (len(site_ids) - 1)
                            ) % len(site_ids)
            handovers += 1
        sid = site_ids[anchor[sess]]
        planes[sid].run_until(float(t))
        planes[sid].submit(session_id=f"s{sess}", klass=str(sess_klass[sess]),
                           prompt_tokens=128, gen_tokens=16, t_max_ms=t_max)
    for plane in planes.values():
        plane.drain()

    all_results = [r for p in planes.values() for r in p.pop_results()]
    ok = [r for r in all_results if r.failed is None]
    waits = np.array([r.queue_wait_ms for r in ok]) if ok else np.zeros(1)
    per_site = {sid: p.scheduler.stats.completed for sid, p in planes.items()}
    return LoadMobilityResult(
        n_sessions=n_sessions, handovers=handovers,
        completed_frac=sum(1 for r in ok if r.completed)
        / max(len(all_results), 1),
        p99_wait_ms=float(np.quantile(waits, 0.99)),
        per_site_served=per_site)


# ----------------------------------------------------------------------
# migration under load: the LIVE data plane under VirtualClock
# ----------------------------------------------------------------------
@dataclass
class MigrationLoadResult:
    """Aggregate of driving real make-before-break migrations (through the
    sites' SimulatedEngine planes and ``state_transfer``) under load."""
    n_sessions: int
    n_attempts: int
    migrated: int
    aborted: int
    abort_rate: float
    causes: Dict[str, int]
    max_interruption_ms: float
    mean_transfer_ms: float
    bytes_moved: int
    outcomes: List[object] = field(default_factory=list)  # MigrationOutcome


def simulate_migration_under_load(*, n_sessions: int = 40, rounds: int = 3,
                                  handover_prob: float = 0.35,
                                  target_pressure: float = 0.0,
                                  export_fail_prob: float = 0.0,
                                  seed: int = 0) -> MigrationLoadResult:
    """Sessions are established northbound (gateway wire messages) and
    serve through the sites' planes (their SimulatedEngine state evolves
    per request) while a mobility process triggers LIVE migrations via
    heartbeats whose Eq. (14) thresholds are tightened to zero: each one
    exports the session's sim state, fingerprint-verifies it into the
    target plane's backend, and swaps the binding make-before-break — the
    §V arm exercising the exact abort paths the real engines hit, with the
    outcomes observed exactly as an invoker would (HeartbeatAck.migration).

    ``target_pressure`` pre-occupies that fraction of every site's decode
    slots with confirmed leases, so re-paging hits COMPUTE_SCARCITY
    (at full pressure, DISCOVER already sees every candidate site
    saturated; below it, the race surfaces at PREPARE — either way the
    abort is target-side admission pressure).
    ``export_fail_prob`` injects export failures at the source plane.
    """
    from repro_torch.api import messages as wire
    from repro_torch.api.gateway import NorthboundGateway
    from repro_torch.core import Orchestrator, default_asp
    from repro_torch.core.asp import MobilityClass
    from repro_torch.serving.state_transfer import TransferInjections

    rng = np.random.default_rng(seed)
    clock = VirtualClock()
    orch = Orchestrator(clock=clock)
    gw = NorthboundGateway(orch)
    sessions = []
    for i in range(n_sessions):
        disc = gw.handle(wire.DiscoverRequest(
            invoker=f"ue-{i}", zone="zone-a",
            asp=default_asp(mobility=MobilityClass.VEHICULAR)))
        gw.handle(wire.PageRequest(session_id=disc.session_id))
        prep = gw.handle(wire.PrepareRequest(session_id=disc.session_id))
        gw.handle(wire.CommitRequest(session_id=disc.session_id,
                                     prepared_ref=prep.prepared_ref))
        sessions.append(orch.sessions[disc.session_id])

    if target_pressure > 0.0:
        model = orch.catalog.get(sessions[0].binding.model_id,
                                 sessions[0].binding.model_version)
        for site in orch.sites.values():
            free = site.spec.decode_slots - site.slots_in_use()
            take = min(int(site.spec.decode_slots * target_pressure), free)
            if take > 0:
                lease = site.prepare(model, slots=take, cache_bytes=0.0,
                                     ttl_s=1e9)
                site.confirm(lease.lease_id, lease_s=1e9)

    if export_fail_prob > 0.0:
        draws = iter(rng.random(4 * n_sessions * rounds + 64))

        def flaky_export(payload):
            if next(draws) < export_fail_prob:
                raise IOError("injected export failure")

        inj = TransferInjections(on_export=flaky_export)
        for site in orch.sites.values():
            orch.plane_for(site).migration_inject = inj

    outcomes = []
    handover_draws = rng.random(rounds * n_sessions)
    for r in range(rounds):
        for i, s in enumerate(sessions):
            if not s.committed():
                continue
            clock.advance(0.005)
            # renew leases under virtual time — northbound heartbeat
            gw.handle(wire.HeartbeatReport(session_id=s.session_id))
            frames = gw.handle(wire.ServeRequest(
                session_id=s.session_id, prompt_tokens=64, gen_tokens=16))
            if isinstance(frames, wire.ErrorResponse) or \
                    isinstance(frames[0], wire.ErrorResponse):
                continue
            if handover_draws[r * n_sessions + i] < handover_prob:
                # mobility event: tightened Eq. (14) thresholds force the
                # migration check to fire on this heartbeat
                ack = gw.handle(wire.HeartbeatReport(
                    session_id=s.session_id,
                    trigger_l99=0.0, trigger_ttfb=0.0))
                if isinstance(ack, wire.HeartbeatAck) and ack.migration:
                    outcomes.append(wire.outcome_from_wire(ack.migration))

    migrated = sum(1 for o in outcomes if o.migrated)
    aborted = sum(1 for o in outcomes if o.aborted)
    causes: Dict[str, int] = {}
    for o in outcomes:
        if o.cause is not None:
            causes[o.cause.value] = causes.get(o.cause.value, 0) + 1
    ok = [o for o in outcomes if o.migrated]
    return MigrationLoadResult(
        n_sessions=n_sessions, n_attempts=len(outcomes),
        migrated=migrated, aborted=aborted,
        abort_rate=aborted / max(len(outcomes), 1), causes=causes,
        max_interruption_ms=max((o.interruption_ms for o in outcomes),
                                default=0.0),
        mean_transfer_ms=float(np.mean([o.transfer_ms for o in ok]))
        if ok else 0.0,
        bytes_moved=sum(o.transfer_bytes for o in ok),
        outcomes=outcomes)


# ----------------------------------------------------------------------
# federation: roaming across an operator boundary + overload spillover
# ----------------------------------------------------------------------
def _fed_catalog():
    """Single-model catalog (edge-tiny) shared by the federation and chaos
    scenarios: DISCOVER stays O(sites), not O(sites × catalog)."""
    from repro_torch.core.catalog import Catalog, default_catalog

    c = Catalog()
    c.register(default_catalog().get("edge-tiny"))
    return c


def _fed_site(clock: VirtualClock, site_id: str, rtt: dict, slots: int,
              *, kind: str = "edge"):
    from repro_torch.core.sites import ExecutionSite, SiteSpec

    v5e_flops, v5e_bw, hbm = 197e12, 819e9, 16e9
    return ExecutionSite(SiteSpec(
        site_id, kind, "eu", chips=16, hbm_bytes_total=16 * hbm,
        peak_flops=16 * v5e_flops, hbm_bw=16 * v5e_bw,
        decode_slots=slots, rtt_ms=dict(rtt),
        hosted_models=("edge-tiny@1.0",),
        price_per_chip_s=2.0e-4), clock)


def _federation_pair(clock: VirtualClock, *, home_slots: int,
                     visited_slots: int, transit_ms: float = 5.0,
                     solicit: str = "fallback"):
    """Two peered single-site domains sharing one VirtualClock: the home
    edge is close to zone-a and hopeless from zone-b, the visited edge the
    reverse — crossing the zone boundary is crossing the domain boundary."""
    from repro_torch.core import Orchestrator
    from repro_torch.federation import DomainController, FederationRegistry

    registry = FederationRegistry(clock)
    home = DomainController(
        "home", registry, solicit=solicit,
        orchestrator=Orchestrator(
            clock=clock, catalog=_fed_catalog(),
            sites={"h-edge": _fed_site(clock, "h-edge",
                                       {"zone-a": 2.0, "zone-b": 400.0},
                                       home_slots)}))
    visited = DomainController(
        "visited", registry, solicit=solicit,
        orchestrator=Orchestrator(
            clock=clock, catalog=_fed_catalog(),
            sites={"v-edge": _fed_site(clock, "v-edge",
                                       {"zone-a": 25.0, "zone-b": 2.0},
                                       visited_slots)}))
    home.connect(visited, transit_ms=transit_ms)
    return home, visited


@dataclass
class FederatedRoamingResult:
    n_sessions: int
    roamed: int
    aborted: int
    causes: Dict[str, int]
    mean_transfer_ms: float
    bytes_moved: int
    max_interruption_ms: float
    p99_pre_ms: float            # serve latency while anchored home
    p99_post_ms: float           # serve latency after roaming abroad


def simulate_federated_roaming(*, n_sessions: int = 24,
                               pre_requests: int = 2,
                               post_requests: int = 2) -> FederatedRoamingResult:
    """A fleet of vehicular sessions establishes at the home operator,
    serves, then a mobility trace carries every invoker across the domain
    boundary (zone-a → zone-b): the next heartbeat's Eq. (14) check finds
    the home anchor infeasible from the new zone, solicits east-west
    offers, and live-migrates the session make-before-break into the
    visited operator through the typed handshake — tokens before and after
    the boundary come from the same session, observed through the same
    northbound contract."""
    from repro_torch.api.client import SessionClient
    from repro_torch.api.gateway import NorthboundGateway
    from repro_torch.core import default_asp
    from repro_torch.core.asp import MobilityClass, QualityTier

    clock = VirtualClock()
    home, visited = _federation_pair(
        clock, home_slots=2 * n_sessions, visited_slots=2 * n_sessions)
    gw = NorthboundGateway(home)
    asp = default_asp(tier=QualityTier.BASIC,
                      mobility=MobilityClass.VEHICULAR)
    clients = [SessionClient(gw, asp, invoker=f"car-{i}", zone="zone-a",
                             subscribe_events=False).establish()
               for i in range(n_sessions)]

    pre, post = [], []
    for c in clients:
        for _ in range(pre_requests):
            clock.advance(0.002)
            stream = c.generate(prompt_tokens=64, gen_tokens=16)
            stream.tokens()
            pre.append(stream.complete.latency_ms)

    outcomes = []
    for c in clients:
        # boundary crossing: the invoker's access zone flips domains
        home.core.sessions[c.session_id].zone = "zone-b"
        clock.advance(0.002)
        ack = c.heartbeat(trigger_l99=0.0, trigger_ttfb=0.0)
        if ack.migration is not None:
            from repro_torch.api.messages import outcome_from_wire
            outcomes.append(outcome_from_wire(ack.migration))

    for c in clients:
        for _ in range(post_requests):
            clock.advance(0.002)
            stream = c.generate(prompt_tokens=64, gen_tokens=16)
            stream.tokens()
            post.append(stream.complete.latency_ms)
    for c in clients:
        c.release()

    ok = [o for o in outcomes if o.migrated]
    causes: Dict[str, int] = {}
    for o in outcomes:
        if o.cause is not None:
            causes[o.cause.value] = causes.get(o.cause.value, 0) + 1
    return FederatedRoamingResult(
        n_sessions=n_sessions, roamed=len(ok),
        aborted=sum(1 for o in outcomes if o.aborted), causes=causes,
        mean_transfer_ms=float(np.mean([o.transfer_ms for o in ok]))
        if ok else 0.0,
        bytes_moved=sum(o.transfer_bytes for o in ok),
        max_interruption_ms=max((o.interruption_ms for o in outcomes),
                                default=0.0),
        p99_pre_ms=float(np.quantile(np.asarray(pre), 0.99)) if pre else 0.0,
        p99_post_ms=float(np.quantile(np.asarray(post), 0.99))
        if post else 0.0)


@dataclass
class SpilloverResult:
    federated: bool
    n_offered: int
    established_home: int
    established_visited: int
    failed: int
    served: int
    p99_ms: float
    admitted_frac: float


def simulate_home_overload_spillover(*, n_sessions: int = 48,
                                     home_slots: int = 16,
                                     visited_slots: int = 256,
                                     requests_per_session: int = 2,
                                     federated: bool = True) -> SpilloverResult:
    """Offered establishes exceed the home operator's committed capacity.
    Single-domain, the overflow fails with COMPUTE_SCARCITY at DISCOVER
    (every home site saturated); federated, the home-first gateway solicits
    east-west offers and the overflow anchors in the visited domain — same
    client contract, measured against the same p99."""
    from repro_torch.api.client import NorthboundError, SessionClient
    from repro_torch.api.gateway import NorthboundGateway
    from repro_torch.core import default_asp
    from repro_torch.core.asp import QualityTier

    clock = VirtualClock()
    home, visited = _federation_pair(
        clock, home_slots=home_slots, visited_slots=visited_slots)
    if not federated:
        home.peers.clear()           # sever the east-west peering
    gw = NorthboundGateway(home)
    asp = default_asp(tier=QualityTier.BASIC)

    clients, at_home, abroad, failed = [], 0, 0, 0
    for i in range(n_sessions):
        clock.advance(0.001)
        c = SessionClient(gw, asp, invoker=f"asp-{i}", zone="zone-a",
                          subscribe_events=False)
        try:
            c.establish()
        except NorthboundError:
            failed += 1
            continue
        clients.append(c)
        if c.anchor.startswith("visited/"):
            abroad += 1
        else:
            at_home += 1

    lats = []
    for _ in range(requests_per_session):
        for c in clients:
            clock.advance(0.001)
            stream = c.generate(prompt_tokens=64, gen_tokens=16)
            stream.tokens()
            if stream.complete.completed:
                lats.append(stream.complete.latency_ms)
    for c in clients:
        c.release()
    return SpilloverResult(
        federated=federated, n_offered=n_sessions,
        established_home=at_home, established_visited=abroad,
        failed=failed, served=len(lats),
        p99_ms=float(np.quantile(np.asarray(lats), 0.99)) if lats else 0.0,
        admitted_frac=(at_home + abroad) / max(n_sessions, 1))


# ----------------------------------------------------------------------
# payload asymmetry: dense KV vs O(1) SSM state under τ_mig
# ----------------------------------------------------------------------
@dataclass
class PayloadAsymmetryRow:
    model_id: str
    family: str
    context_tokens: int
    payload_bytes: int
    transfer_ms: float
    migrated: bool
    cause: Optional[str]


def simulate_payload_asymmetry(*, context_tokens: Tuple[int, ...] =
                               (4_096, 32_768, 131_072),
                               models: Tuple[str, ...] =
                               ("minitron-8b", "recurrentgemma-2b",
                                "mamba2-1.3b"),
                               seed: int = 0) -> List[PayloadAsymmetryRow]:
    """Migrate long-lived sessions of each payload family at growing context
    lengths: dense KV grows linearly and blows τ_mig on the inter-site link,
    hybrid RG-LRU sits in between, SSM state is O(1) in context and always
    fits — the continuity argument for state-space anchors (§IV-B)."""
    from repro_torch.core import Orchestrator, default_asp
    from repro_torch.core.asp import MobilityClass, QualityTier
    from repro_torch.core.catalog import Catalog, default_catalog

    full = default_catalog()
    rows: List[PayloadAsymmetryRow] = []
    for model_id in models:
        entry = full.get(model_id)
        for ctx in context_tokens:
            cat = Catalog()
            cat.register(entry)
            orch = Orchestrator(clock=VirtualClock(), catalog=cat)
            asp = default_asp(mobility=MobilityClass.VEHICULAR,
                              tier=QualityTier.BASIC)
            s = orch.establish(asp, invoker=f"ue-{model_id}", zone="zone-a")
            orch.serve(s, prompt_tokens=64, gen_tokens=16)  # live state
            s.context_tokens = ctx        # long-lived session fast-forward
            out = orch.migrations.migrate(s, "zone-a")
            rows.append(PayloadAsymmetryRow(
                model_id=model_id, family=entry.cfg.family,
                context_tokens=ctx,
                payload_bytes=entry.session_state_bytes(ctx),
                transfer_ms=out.transfer_ms, migrated=out.migrated,
                cause=out.cause.value if out.cause else None))
    return rows


# ----------------------------------------------------------------------
# chaos: site crash, graceful drain, domain partition, registry storms
# ----------------------------------------------------------------------
def _chaos_sites(clock: VirtualClock, n_sessions: int):
    """Federation-scale 3-site topology sized so a crashed edge's orphans
    always FIT elsewhere: each edge holds half the fleet, the regional tier
    holds all of it — survival shortfalls are supervisor bugs, not
    capacity artifacts. RTTs mirror ``default_sites``."""
    edge_slots = max(64, (2 * n_sessions) // 4)
    regional_slots = max(256, n_sessions)
    return {
        "edge-a": _fed_site(clock, "edge-a",
                            {"zone-a": 2.0, "zone-b": 9.0, "zone-c": 18.0},
                            edge_slots),
        "edge-b": _fed_site(clock, "edge-b",
                            {"zone-a": 9.0, "zone-b": 2.0, "zone-c": 10.0},
                            edge_slots),
        "regional-1": _fed_site(clock, "regional-1",
                                {"zone-a": 12.0, "zone-b": 12.0,
                                 "zone-c": 12.0},
                                regional_slots, kind="regional"),
    }


@dataclass
class SiteCrashResult:
    n_sessions: int
    orphaned: int                  # anchored on the crash site at T0
    reanchored: int
    lost: int
    survival_frac: float
    failed_inflight: int           # in-flight+queued attributed COMPUTE_SCARCITY
    recovery_ms_p50: float         # wall-clock per-session re-anchor time
    recovery_ms_p99: float
    causes: Dict[str, int]         # Eq. 12 causes of the lost sessions
    reanchor_sites: Dict[str, int]  # where the orphans landed
    serve_ok_after: int            # sampled re-anchored sessions that serve
    post_crash_establish_ok: bool  # new establishes avoid the dead site


def simulate_site_crash(*, n_sessions: int = 10_000,
                        crash_site: str = "edge-a",
                        inflight: int = 256,
                        serve_sample: int = 64,
                        seed: int = 0) -> SiteCrashResult:
    """Site crash mid-stream at federation scale: ``n_sessions`` AIS
    establish across a 3-site topology, ``inflight`` requests are queued on
    the doomed site's plane, then the supervisor declares it dead. Every
    in-flight request must fail attributably (COMPUTE_SCARCITY — the
    anchor's compute vanished mid-contract) and every orphaned session
    re-anchors via AI-PAGING onto a surviving site, with per-session
    wall-clock recovery time measured — the acceptance bar is ≥99%
    survival, which the recovery bench guards in CI."""
    from repro_torch.core import Orchestrator, default_asp
    from repro_torch.core.asp import QualityTier
    from repro_torch.serving.supervisor import FleetSupervisor

    rng = np.random.default_rng(seed)
    clock = VirtualClock()
    orch = Orchestrator(clock=clock, catalog=_fed_catalog(),
                        sites=_chaos_sites(clock, n_sessions))
    asp = default_asp(tier=QualityTier.BASIC)
    zones = ("zone-a", "zone-b", "zone-c")
    sessions = []
    for i in range(n_sessions):
        sessions.append(orch.establish(asp, invoker=f"ue-{i}",
                                       zone=zones[i % 3]))
    on_site = [s for s in sessions
               if s.binding is not None and s.binding.site_id == crash_site]
    # queue live work on the doomed plane — these are the requests the
    # crash must attribute, not silently drop
    targets = [on_site[int(j)] for j in
               rng.integers(0, len(on_site), size=min(inflight,
                                                      len(on_site)))]
    for s in targets:
        orch.submit(s, prompt_tokens=64, gen_tokens=16)

    sup = FleetSupervisor(orch)
    report = sup.crash(crash_site, detail="chaos: simulated site crash")

    landed: Dict[str, int] = {}
    for s in on_site:
        if s.committed() and s.binding is not None:
            landed[s.binding.site_id] = landed.get(s.binding.site_id, 0) + 1
    # continuity: a sample of the re-anchored fleet keeps serving
    survivors = [s for s in on_site if s.committed()]
    serve_ok = 0
    for s in survivors[:serve_sample]:
        clock.advance(0.001)
        res = orch.serve(s, prompt_tokens=64, gen_tokens=16)
        serve_ok += int(res.completed)
    # the dead site is DISCOVER-excluded: a fresh establish still lands
    try:
        fresh = orch.establish(asp, invoker="ue-post", zone="zone-a")
        post_ok = fresh.binding is not None \
            and fresh.binding.site_id != crash_site
    except Exception:               # noqa: BLE001
        post_ok = False

    ms = sorted(report.recovery_ms)
    return SiteCrashResult(
        n_sessions=n_sessions, orphaned=report.orphaned,
        reanchored=report.reanchored, lost=report.lost,
        survival_frac=report.survival_frac,
        failed_inflight=report.failed_inflight,
        recovery_ms_p50=float(np.quantile(np.asarray(ms), 0.50))
        if ms else 0.0,
        recovery_ms_p99=float(np.quantile(np.asarray(ms), 0.99))
        if ms else 0.0,
        causes=dict(report.causes), reanchor_sites=landed,
        serve_ok_after=serve_ok, post_crash_establish_ok=post_ok)


@dataclass
class DrainUnderLoadResult:
    n_sessions: int
    on_site: int                   # sessions anchored at the drain site
    migrated: int
    hibernated: int
    stranded: int
    failed_inflight: int           # MUST be zero: drain is graceful
    completed_during_drain: int
    post_serve_ok: int             # migrated sessions serving elsewhere
    rejects_after_drain: bool      # drained plane refuses new admissions


def simulate_drain_under_load(*, n_sessions: int = 120,
                              drain_site: str = "edge-a",
                              inflight: int = 32,
                              seed: int = 0) -> DrainUnderLoadResult:
    """Graceful drain with live traffic: sessions serve (so their engine
    state exists to export), more requests sit queued on the draining
    site, then the supervisor drains it. Every in-flight request finishes
    — zero failures — and every bound session leaves make-before-break
    (hibernation is the fallback for state that cannot move)."""
    from repro_torch.core import Orchestrator, default_asp
    from repro_torch.core.asp import QualityTier
    from repro_torch.serving.supervisor import FleetSupervisor

    rng = np.random.default_rng(seed)
    clock = VirtualClock()
    orch = Orchestrator(clock=clock)
    asp = default_asp(tier=QualityTier.BASIC)
    sessions = []
    for i in range(n_sessions):
        s = orch.establish(asp, invoker=f"ue-{i}", zone="zone-a")
        clock.advance(0.001)
        orch.serve(s, prompt_tokens=64, gen_tokens=16)   # live engine state
        sessions.append(s)
    on_site = [s for s in sessions
               if s.binding is not None and s.binding.site_id == drain_site]
    targets = [on_site[int(j)] for j in
               rng.integers(0, len(on_site), size=min(inflight,
                                                      len(on_site)))]
    for s in targets:
        orch.submit(s, prompt_tokens=64, gen_tokens=16)

    sup = FleetSupervisor(orch)
    report = sup.drain(drain_site)

    # continuity on the new anchors — and the drained plane stays closed
    post_ok = 0
    for s in on_site:
        if not s.committed():
            continue
        clock.advance(0.001)
        res = orch.serve(s, prompt_tokens=64, gen_tokens=16)
        post_ok += int(res.completed)
    plane = orch.sites[drain_site].plane
    rejected = plane is None or plane.submit(
        session_id="drain-probe", klass="best-effort", prompt_tokens=8,
        gen_tokens=8, t_max_ms=2000.0) is None
    return DrainUnderLoadResult(
        n_sessions=n_sessions, on_site=len(on_site),
        migrated=report.migrated, hibernated=report.hibernated,
        stranded=report.stranded, failed_inflight=report.failed_inflight,
        completed_during_drain=report.completed,
        post_serve_ok=post_ok, rejects_after_drain=rejected)


@dataclass
class PartitionResult:
    established_home: int
    established_visited: int
    partition_failures: int        # zone-b establishes during the partition
    partition_causes: Dict[str, int]
    timeout_notes: int             # solicit notes while the link black-holes
    dead_notes: int                # solicit notes after domain marked dead
    home_serve_ok_during: int      # home-anchored continuity under partition
    healed_established: int        # zone-b establishes after the heal


def simulate_domain_partition(*, n_sessions: int = 24,
                              heal_establishes: int = 4) -> PartitionResult:
    """East-west partition between two peered domains: zone-b traffic that
    spilled to the visited operator loses its path home. During the
    partition new zone-b establishes fail attributably (the peer reads as
    offer-timeout until the supervisor marks the domain dead, then as
    domain-dead without burning the timeout), home-anchored sessions are
    untouched, and healing the link restores spillover."""
    from repro_torch.core import default_asp
    from repro_torch.core.asp import QualityTier
    from repro_torch.core.session import SessionError

    clock = VirtualClock()
    home, visited = _federation_pair(
        clock, home_slots=n_sessions, visited_slots=2 * n_sessions)
    asp = default_asp(tier=QualityTier.BASIC)
    at_home, abroad = [], []
    for i in range(n_sessions):
        clock.advance(0.001)
        zone = "zone-a" if i % 2 == 0 else "zone-b"
        s = home.core.establish(asp, invoker=f"ue-{i}", zone=zone)
        (abroad if s.binding.site_id.startswith("visited/")
         else at_home).append(s)

    # partition: the east-west link black-holes (any send raises)
    endpoint = home.peers["visited"]

    def _severed(_msg: str) -> str:
        raise ConnectionError("east-west link partitioned")

    home.peers["visited"] = _severed
    _, notes = home.solicit_offers(asp, "zone-b")
    timeout_notes = sum(1 for _, why in notes if why == "offer-timeout")

    failures, causes = 0, {}
    for i in range(n_sessions // 2):
        clock.advance(0.001)
        try:
            home.core.establish(asp, invoker=f"part-{i}", zone="zone-b")
        except SessionError as e:
            failures += 1
            causes[e.cause.value] = causes.get(e.cause.value, 0) + 1

    # supervisor verdict: stop probing the corpse — fast-fail via the
    # dead-domain list instead of eating a timeout per solicit
    home.mark_domain_dead("visited")
    _, notes = home.solicit_offers(asp, "zone-b")
    dead_notes = sum(1 for _, why in notes if why == "domain-dead")

    serve_ok = 0
    for s in at_home:
        clock.advance(0.001)
        res = home.core.serve(s, prompt_tokens=64, gen_tokens=16)
        serve_ok += int(res.completed)

    # heal: link back, domain alive, re-peer (re-registers the provider
    # that mark_domain_dead dropped) — spillover resumes
    home.peers["visited"] = endpoint
    home.mark_domain_alive("visited")
    home.connect(visited)
    healed = 0
    for i in range(heal_establishes):
        clock.advance(0.001)
        s = home.core.establish(asp, invoker=f"heal-{i}", zone="zone-b")
        healed += int(s.binding.site_id.startswith("visited/"))
    return PartitionResult(
        established_home=len(at_home), established_visited=len(abroad),
        partition_failures=failures, partition_causes=causes,
        timeout_notes=timeout_notes, dead_notes=dead_notes,
        home_serve_ok_during=serve_ok, healed_established=healed)


def _federation_star(clock: VirtualClock, *, n_domains: int,
                     home_slots: int, peer_slots: int):
    """One home domain peered with ``n_domains`` visited domains on a
    SHARED registry: the home edge is only good from zone-a, every peer is
    only good from zone-b — zone-b traffic exists solely as east-west
    spillover, so registry health IS admission health for that zone."""
    from repro_torch.core import Orchestrator
    from repro_torch.federation import DomainController, FederationRegistry

    registry = FederationRegistry(clock)
    home = DomainController(
        "home", registry, solicit="fallback",
        orchestrator=Orchestrator(
            clock=clock, catalog=_fed_catalog(),
            sites={"h-edge": _fed_site(clock, "h-edge",
                                       {"zone-a": 2.0, "zone-b": 400.0},
                                       home_slots)}))
    peers = []
    for k in range(n_domains):
        dom = DomainController(
            f"op-{k}", registry, solicit="fallback",
            orchestrator=Orchestrator(
                clock=clock, catalog=_fed_catalog(),
                sites={f"edge-{k}": _fed_site(
                    clock, f"edge-{k}",
                    {"zone-a": 25.0, "zone-b": 2.0 + 0.1 * k},
                    peer_slots)}))
        home.connect(dom)
        peers.append(dom)
    return home, peers


@dataclass
class StalenessStormResult:
    n_domains: int
    established_pre: int           # zone-b spillover before the storm
    stale_notes: int               # per-domain registry-stale exclusions
    storm_failures: int            # zone-b establishes during the storm
    storm_causes: Dict[str, int]
    established_post_recovery: int  # after ONE provider re-registers


def simulate_registry_staleness_storm(*, n_domains: int = 6,
                                      n_sessions: int = 60,
                                      seed: int = 0) -> StalenessStormResult:
    """Registry-staleness storm: every peer's capability digest ages past
    ``max_age_s`` with its re-pull provider gone (the failure mode of a
    crashed federation registry sync). All zone-b admission collapses with
    per-domain ``registry-stale`` notes — attributable, not mysterious —
    and recovering a single provider restores spillover through that
    domain alone."""
    from repro_torch.core import default_asp
    from repro_torch.core.asp import QualityTier
    from repro_torch.core.session import SessionError

    clock = VirtualClock()
    home, peers = _federation_star(
        clock, n_domains=n_domains, home_slots=4,
        peer_slots=max(4, (2 * n_sessions) // n_domains))
    asp = default_asp(tier=QualityTier.BASIC)

    pre = 0
    for i in range(n_sessions):
        clock.advance(0.001)
        s = home.core.establish(asp, invoker=f"ue-{i}", zone="zone-b")
        pre += int(s.binding.site_id.startswith("op-"))

    # the storm: providers vanish, then every digest ages out at once
    for dom in peers:
        home.registry.drop_provider(dom.domain_id)
    clock.advance(home.registry.max_age_s + 1.0)
    _, notes = home.solicit_offers(asp, "zone-b")
    stale_notes = sum(1 for _, why in notes if why == "registry-stale")

    failures, causes = 0, {}
    for i in range(n_domains):
        clock.advance(0.001)
        try:
            home.core.establish(asp, invoker=f"storm-{i}", zone="zone-b")
        except SessionError as e:
            failures += 1
            causes[e.cause.value] = causes.get(e.cause.value, 0) + 1

    # recovery: ONE domain's provider re-registers → its digest re-pulls
    # fresh on the next solicit and spillover resumes through it
    survivor = peers[0]
    home.registry.register_provider(survivor.domain_id, survivor.digest)
    post = 0
    for i in range(4):
        clock.advance(0.001)
        try:
            s = home.core.establish(asp, invoker=f"rec-{i}", zone="zone-b")
            post += int(s.binding.site_id.startswith(
                f"{survivor.domain_id}/"))
        except SessionError:
            pass
    return StalenessStormResult(
        n_domains=n_domains, established_pre=pre, stale_notes=stale_notes,
        storm_failures=failures, storm_causes=causes,
        established_post_recovery=post)


# ----------------------------------------------------------------------
# split serving: verify-anchor crash degrades to edge-only, then recovers
# ----------------------------------------------------------------------
def _split_topology(clock: VirtualClock, n_sessions: int):
    """Two edge sites hosting the draft model plus TWO verify-capable
    regional sites (so recovery after a verify crash has somewhere to
    land). regional-2 is RTT-worse than regional-1, making the initial
    verify paging deterministic."""
    from repro_torch.core.catalog import Catalog, default_catalog

    full = default_catalog()
    cat = Catalog()
    cat.register(full.get("recurrentgemma-2b"))   # edge draft (vocab 256k)
    cat.register(full.get("minitron-8b"))         # verify (vocab 256k)

    from repro_torch.core.sites import ExecutionSite, SiteSpec
    v5e_flops, v5e_bw, hbm = 197e12, 819e9, 16e9

    def mk(sid, kind, rtt, slots, hosted):
        return ExecutionSite(SiteSpec(
            sid, kind, "eu", chips=16, hbm_bytes_total=16 * hbm,
            peak_flops=16 * v5e_flops, hbm_bw=16 * v5e_bw,
            decode_slots=slots, rtt_ms=dict(rtt), hosted_models=hosted,
            price_per_chip_s=2.0e-4), clock)

    edge_slots = max(64, n_sessions)
    verify_slots = max(128, n_sessions)
    draft_host = ("recurrentgemma-2b@1.0",)
    verify_host = ("minitron-8b@1.0",)
    return cat, {
        "edge-a": mk("edge-a", "edge",
                     {"zone-a": 2.0, "zone-b": 9.0}, edge_slots, draft_host),
        "edge-b": mk("edge-b", "edge",
                     {"zone-a": 9.0, "zone-b": 2.0}, edge_slots, draft_host),
        "regional-1": mk("regional-1", "regional",
                         {"zone-a": 12.0, "zone-b": 12.0}, verify_slots,
                         verify_host),
        "regional-2": mk("regional-2", "regional",
                         {"zone-a": 30.0, "zone-b": 30.0}, verify_slots,
                         verify_host),
    }


@dataclass
class VerifyCrashResult:
    n_sessions: int
    split_established: int         # sessions that committed as splits
    verify_site: str               # where the verify anchors landed
    failed_inflight: int           # MUST be 0: in-flight rides the edge
    orphaned: int                  # MUST be 0: edge bindings survive
    degraded: int                  # splits degraded to edge-only
    still_committed: int           # sessions still COMMITTED post-crash
    serve_ok_degraded: int         # sampled serves while degraded
    recovered: int                 # verify anchors re-attached
    recovered_sites: Dict[str, int]  # where recovery landed
    serve_ok_after: int            # sampled serves at full quality
    events: Dict[str, int]         # tier-change event histogram


def simulate_verify_crash_degrade(*, n_sessions: int = 48,
                                  inflight: int = 64,
                                  serve_sample: int = 16,
                                  seed: int = 0) -> VerifyCrashResult:
    """Chaos for split serving: every AIS establishes as a TWO-anchor
    split (edge draft + regional verify, ``split_policy="require"``), live
    work is queued on the EDGE data plane, then the verify site crashes.
    The acceptance bar is the airplane-mode contract: ZERO failed
    in-flight requests and ZERO orphans (the interactive path never
    touched the dead site), every split emits an explicit quality-tier
    degrade event, and after re-attachment every session is back at full
    quality on a surviving verify site."""
    from dataclasses import replace as _dc_replace

    from repro_torch.core import Orchestrator, default_asp
    from repro_torch.core.asp import QualityTier
    from repro_torch.serving.supervisor import FleetSupervisor
    from repro_torch.splitserve import SplitManager

    rng = np.random.default_rng(seed)
    clock = VirtualClock()
    cat, sites = _split_topology(clock, n_sessions)
    orch = Orchestrator(clock=clock, catalog=cat, sites=sites)
    mgr = SplitManager(orch)
    events: Dict[str, int] = {}
    orch.split_event_sinks.append(
        lambda sid, ev, d: events.update({ev: events.get(ev, 0) + 1}))

    # the split's cost envelope covers BOTH anchors (each leg gets a
    # share), so the profile pays for two reservations explicitly
    asp = _dc_replace(default_asp(tier=QualityTier.STANDARD),
                      split_policy="require", max_cost_per_1k_tokens=4.0)
    zones = ("zone-a", "zone-b")
    sessions = []
    for i in range(n_sessions):
        sessions.append(orch.establish(asp, invoker=f"ue-{i}",
                                       zone=zones[i % 2]))
    split_states = [mgr.states[s.session_id] for s in sessions]
    verify_site = split_states[0].verify_binding.site_id
    established = sum(1 for st in split_states
                      if st.verify_binding is not None)

    # live work rides the EDGE data plane — the crash must not touch it
    targets = [sessions[int(j)] for j in
               rng.integers(0, n_sessions, size=inflight)]
    for s in targets:
        orch.submit(s, prompt_tokens=64, gen_tokens=16)

    sup = FleetSupervisor(orch)
    report = sup.crash(verify_site, detail="chaos: verify anchor crash")

    degraded = sum(1 for st in split_states if st.degraded)
    still = sum(1 for s in sessions if s.committed())
    # degraded sessions keep serving (edge-only quality rung)
    serve_deg = 0
    for s in sessions[:serve_sample]:
        clock.advance(0.001)
        serve_deg += int(orch.serve(s, prompt_tokens=64,
                                    gen_tokens=16).completed)

    # recovery: re-attach a verify anchor on a surviving regional site
    recovered, landed = 0, {}
    for s in sessions:
        clock.advance(0.001)
        mgr.recover(s)
        st = mgr.states[s.session_id]
        if st.verify_binding is not None and not st.degraded:
            recovered += 1
            landed[st.verify_binding.site_id] = \
                landed.get(st.verify_binding.site_id, 0) + 1
    serve_ok = 0
    for s in sessions[:serve_sample]:
        clock.advance(0.001)
        serve_ok += int(orch.serve(s, prompt_tokens=64,
                                   gen_tokens=16).completed)
    return VerifyCrashResult(
        n_sessions=n_sessions, split_established=established,
        verify_site=verify_site, failed_inflight=report.failed_inflight,
        orphaned=report.orphaned, degraded=degraded,
        still_committed=still, serve_ok_degraded=serve_deg,
        recovered=recovered, recovered_sites=landed,
        serve_ok_after=serve_ok, events=dict(events))


# ----------------------------------------------------------------------
# unreliable control plane: lossy wire + retries + reaping, end to end
# ----------------------------------------------------------------------
@dataclass
class LossyControlPlaneResult:
    loss: float                     # per-fault rate on every control link
    n_offered: int
    established: int
    established_visited: int        # spilled east-west under loss
    failed: int
    causes: Dict[str, int]          # error code → count, for the failures
    goodput: float                  # established / offered
    p50_establish_ms: float         # virtual wall time, retries included
    p99_establish_ms: float
    serve_ok: int                   # sampled post-establish serves
    orphaned_after_sweep: int       # MUST be 0 (lease invariant)
    charging_open: int              # MUST be 0 (no billing without commit)
    wire: Dict[str, int]            # aggregated channel fault counters


def simulate_lossy_control_plane(*, n_sessions: int = 64,
                                 loss: float = 0.05,
                                 spill: bool = True,
                                 deadline_ms: float = 30_000.0,
                                 serve_sample: int = 16,
                                 seed: int = 0) -> LossyControlPlaneResult:
    """Full AIS establishment over an unreliable control plane, on BOTH
    paths: every northbound client rides its own seeded
    :class:`~repro_torch.netfault.wire.LossyChannel` around the gateway, and the
    east-west peering between the two domains is lossy too. ``spill``
    undersizes the home edge so a share of the fleet must establish
    cross-domain (lossy EWPrepare/EWCommit with at-least-once re-sends).

    The run measures what the retry stack delivers (goodput, p50/p99
    establish latency including retries and backoff) and then asserts the
    paper's safety invariant the hard way: after the orphan sweeps, every
    lease belongs to an established session (no stranded provisional
    state) and no failed establishment left a charging record open."""
    from repro_torch.api.client import NorthboundError, SessionClient
    from repro_torch.api.gateway import NorthboundGateway
    from repro_torch.core import default_asp
    from repro_torch.core.asp import QualityTier
    from repro_torch.netfault import (FaultPlan, LossyChannel, RetryPolicy,
                                TransportError)

    clock = VirtualClock()
    home_slots = max(n_sessions // 4, 1) if spill else 2 * n_sessions
    home, visited = _federation_pair(clock, home_slots=home_slots,
                                     visited_slots=2 * n_sessions)
    # the east-west peering is just another unreliable wire
    home.peers[visited.domain_id] = LossyChannel(
        visited.handle_eastwest_json, clock,
        FaultPlan.uniform(loss, seed=seed * 7919 + 1), name="ew:h->v")
    visited.peers[home.domain_id] = LossyChannel(
        home.handle_eastwest_json, clock,
        FaultPlan.uniform(loss, seed=seed * 7919 + 2), name="ew:v->h")
    gw = NorthboundGateway(home)
    asp = default_asp(tier=QualityTier.BASIC)

    channels: List[LossyChannel] = []
    clients, causes = [], {}
    establish_ms: List[float] = []
    established = failed = 0
    for i in range(n_sessions):
        chan = LossyChannel(
            gw.handle_json, clock,
            FaultPlan.uniform(loss, seed=seed * 100_003 + i),
            name=f"nb:{i}")
        channels.append(chan)
        client = SessionClient(
            gw, asp, invoker=f"ue-{i}", zone="zone-a",
            subscribe_events=False, transport=chan, clock=clock,
            retry=RetryPolicy(seed=seed * 31 + i),
            deadline_ms=deadline_ms)
        t0 = clock.now()
        try:
            client.establish()
            established += 1
            clients.append(client)
        except (NorthboundError, TransportError) as e:
            failed += 1
            code = getattr(e, "code", None) or "E_TRANSPORT"
            causes[code] = causes.get(code, 0) + 1
        establish_ms.append((clock.now() - t0) * 1e3)
        # the heartbeat cadence runs between arrivals: planes advance,
        # sweeps fire (gateway + home coordinator + visited guest GC)
        gw.pump(clock.now())
        visited.tick()

    serve_ok = 0
    for c in clients[:serve_sample]:
        clock.advance(0.001)
        stream = c.generate(prompt_tokens=64, gen_tokens=16)
        stream.tokens()
        serve_ok += int(stream.complete.completed)

    # let every decision window lapse, then run the sweeps one final time:
    # whatever provisional state a lost COMMIT stranded must now be reaped
    timers = home.core.timers
    clock.advance(timers.tau_prep + timers.tau_com + 1.0)
    gw.reap_orphans()
    home.core.coordinator.reap()
    visited.core.coordinator.reap()
    visited.tick()

    established_visited = sum(
        1 for c in clients
        if c.record.get("anchor", "").startswith(f"{visited.domain_id}/"))
    slots_in_use = sum(
        s.slots_in_use() for s in
        list(home.core.sites.values()) + list(visited.core.sites.values())
        if not getattr(s, "is_guest_view", False))
    guest_provisional = sum(1 for g in visited._guest_by_ref.values()
                            if not g.committed)
    orphaned = (len(home.core.coordinator.outstanding)
                + len(visited.core.coordinator.outstanding)
                + guest_provisional
                + max(slots_in_use - established, 0))
    charging_open = sum(
        1 for s in home.core.sessions.values()
        if getattr(s, "failure", None) is not None
        and getattr(s, "charging_ref", None) is not None)

    wire: Dict[str, int] = {}
    for chan in channels + [home.peers[visited.domain_id],
                            visited.peers[home.domain_id]]:
        for k, v in chan.stats.items():
            wire[k] = wire.get(k, 0) + v
    ms = np.asarray(sorted(establish_ms)) if establish_ms else np.zeros(1)
    return LossyControlPlaneResult(
        loss=loss, n_offered=n_sessions, established=established,
        established_visited=established_visited, failed=failed,
        causes=causes, goodput=established / max(n_sessions, 1),
        p50_establish_ms=float(np.quantile(ms, 0.50)),
        p99_establish_ms=float(np.quantile(ms, 0.99)),
        serve_ok=serve_ok, orphaned_after_sweep=orphaned,
        charging_open=charging_open, wire=wire)
