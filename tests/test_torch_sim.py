"""The port's copy of the §V scenarios (``repro_torch.sim``) against the
reference package's, on the CPU at the reference tests' small sizes.

* A scenario that builds its own sites (``_neaiaas_gateway``,
  ``_fed_site``, ``_chaos_sites``, ``_split_topology``) or none gives the
  reference's result field for field, both packages' session-id counters
  pinned to the same start. Only a field the scenario measures on the
  host's wall clock is left out.
* A scenario that reads ``core.sites.default_sites`` runs on the port's
  copy of it, which states H100 figures where the reference states TPU
  ones, so its numbers may differ: it is held to the claims its reference
  test asserts (``test_sim_benchmarks.py``, ``test_migration_plane.py``,
  ``test_plane.py``, ``test_supervisor.py``).
"""

import dataclasses
import enum
import itertools

import pytest

import repro.core.session as jax_session
import repro.sim.mobility as jax_mobility
import repro.sim.scenarios as jax_scenarios
import repro_torch.core.session as port_session
from repro_torch.sim import (LatencyModel, SimConfig, simulate_bursty,
                             simulate_endpoint, simulate_load_mobility,
                             simulate_mobility, simulate_neaiaas)
from repro_torch.sim import mobility, scenarios
from repro_torch.sim.scenarios import (simulate_drain_under_load,
                                       simulate_migration_under_load,
                                       simulate_payload_asymmetry)

#: fields measured on the host's wall clock, not the scenario's clock
WALL_CLOCK = {"recovery_ms_p50", "recovery_ms_p99"}


def _plain(x):
    """A result as plain data: the two packages' dataclasses and enums
    compare by their fields and values."""
    if dataclasses.is_dataclass(x):
        return {k: _plain(v) for k, v in dataclasses.asdict(x).items()
                if k not in WALL_CLOCK}
    if isinstance(x, dict):
        return {_plain(k): _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, enum.Enum):
        return x.value
    return x


def _model(sc):
    return sc.LatencyModel(sc.SimConfig(n_requests=4000))


OWN_SITES = {
    "endpoint": lambda sc: sc.simulate_endpoint(
        0.95, _model(sc), ell99=400, t_max=1000),
    "neaiaas": lambda sc: sc.simulate_neaiaas(
        0.95, _model(sc), ell99=400, t_max=1000),
    "multiclass": lambda sc: sc.simulate_multiclass(
        0.95, _model(sc), n_requests=2000),
    "bursty": lambda sc: sc.simulate_bursty(
        _model(sc), burst_factor=5.0, n_requests=2000),
    "federated_roaming": lambda sc: sc.simulate_federated_roaming(
        n_sessions=8),
    "spillover_federated": lambda sc: sc.simulate_home_overload_spillover(
        n_sessions=24, home_slots=8, federated=True),
    "spillover_single": lambda sc: sc.simulate_home_overload_spillover(
        n_sessions=24, home_slots=8, federated=False),
    "domain_partition": lambda sc: sc.simulate_domain_partition(
        n_sessions=8),
    "registry_staleness_storm": lambda sc:
        sc.simulate_registry_staleness_storm(n_domains=3, n_sessions=12),
    "site_crash": lambda sc: sc.simulate_site_crash(
        n_sessions=200, inflight=16, serve_sample=8),
    "verify_crash_degrade": lambda sc: sc.simulate_verify_crash_degrade(
        n_sessions=8),
    "lossy_control_plane": lambda sc: sc.simulate_lossy_control_plane(
        n_sessions=16, serve_sample=4),
}


@pytest.mark.parametrize("name", sorted(OWN_SITES))
def test_scenarios_on_their_own_sites_equal_the_reference(name,
                                                         monkeypatch):
    run = OWN_SITES[name]
    monkeypatch.setattr(jax_session, "_ids", itertools.count(50_000))
    want = _plain(run(jax_scenarios))
    monkeypatch.setattr(port_session, "_ids", itertools.count(50_000))
    assert _plain(run(scenarios)) == want


def test_mobility_equals_the_reference(monkeypatch):
    """It reads ``default_sites``, but none of the figures that differ
    there enters its result."""
    monkeypatch.setattr(jax_session, "_ids", itertools.count(50_000))
    want = _plain(jax_mobility.simulate_mobility(90, "mbb", n_sessions=20))
    monkeypatch.setattr(port_session, "_ids", itertools.count(50_000))
    assert _plain(mobility.simulate_mobility(90, "mbb",
                                             n_sessions=20)) == want


# -- default_sites scenarios: the reference tests' claims -----------------
def test_paper_figure_claims():
    """Figs. 2-4: the tail collapse is delayed, NE-AIaaS keeps violations
    low by refusing load, make-before-break does not interrupt."""
    model = LatencyModel(SimConfig(n_requests=4000))
    e = simulate_endpoint(0.95, model, ell99=400, t_max=1000)
    n = simulate_neaiaas(0.95, model, ell99=400, t_max=1000)
    assert e.p99_ms > 1.5 * n.p99_ms
    assert e.violation_prob > 0.15 and n.violation_prob < 0.05
    assert n.admitted_frac < 1.0
    t = simulate_mobility(90, "teardown", n_sessions=20)
    b = simulate_mobility(90, "mbb", n_sessions=20)
    assert t.interruption_prob > 0.5 and b.interruption_prob <= 0.1
    assert b.mean_gap_ms <= t.mean_gap_ms
    assert simulate_mobility(0, "teardown",
                             n_sessions=10).interruption_prob == 0.0
    r = simulate_mobility(90, "mbb-plane", n_sessions=6,
                          transfer_fail_prob=0.2)
    assert r.interruption_prob == 0.0
    flat = simulate_bursty(model, burst_factor=1.0, n_requests=2000)
    burst = simulate_bursty(model, burst_factor=5.0, n_requests=2000)
    assert burst.p99_wait_ms > flat.p99_wait_ms
    assert burst.completed_frac > 0.9


def test_migration_under_load_claims():
    r = simulate_migration_under_load(n_sessions=24, rounds=2,
                                      handover_prob=0.5, seed=0)
    assert r.n_attempts > 5 and r.abort_rate == 0.0
    assert r.max_interruption_ms == 0.0 and r.bytes_moved > 0
    r = simulate_migration_under_load(n_sessions=10, rounds=2,
                                      handover_prob=0.9,
                                      target_pressure=1.0, seed=1)
    assert r.n_attempts > 0 and r.abort_rate == 1.0
    assert set(r.causes) == {"compute scarcity"}
    assert r.max_interruption_ms == 0.0


def test_payload_asymmetry_claims():
    rows = simulate_payload_asymmetry(
        context_tokens=(4_096, 131_072),
        models=("minitron-8b", "mamba2-1.3b"))
    dense = [r for r in rows if r.family == "dense"]
    ssm = [r for r in rows if r.family == "ssm"]
    assert dense[0].migrated and not dense[1].migrated
    assert dense[1].cause == "state transfer failure"
    assert all(r.migrated for r in ssm)
    assert ssm[0].payload_bytes == ssm[1].payload_bytes


def test_drain_under_load_claims():
    r = simulate_drain_under_load(n_sessions=48, inflight=12)
    assert r.failed_inflight == 0 and r.stranded == 0
    assert r.migrated + r.hibernated == r.on_site
    assert r.rejects_after_drain


def test_load_mobility_at_scale_claims():
    r = simulate_load_mobility(n_sessions=10_000, requests_per_session=2)
    assert r.n_sessions == 10_000 and r.handovers > 100
    assert r.completed_frac > 0.95
    assert sum(r.per_site_served.values()) > 15_000
