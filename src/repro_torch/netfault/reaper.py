"""Orphan-lease reaper: one periodic sweep over every lease-holding plane.

A COMMIT lost in flight leaves provisional compute/QoS leases (and, cross
domain, guest reservations) that no caller will ever confirm or abort.
Each plane owns its own sweep — ``TwoPhaseCoordinator.reap`` (home
provisional leases past τ_prep + τ_com + hold), ``NorthboundGateway.
reap_orphans`` (prepared-but-never-committed gateway sessions) and
``DomainController.tick`` (visited-side guest reservations) — and the
reaper is the thin aggregator that runs them on the plane-heartbeat cadence
so τ-timers are enforced, not advisory.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple


class OrphanReaper:
    """Aggregate per-plane sweeps; each returns how many orphans it reaped."""

    def __init__(self):
        self._sweeps: List[Tuple[str, Callable[[], int]]] = []
        self.total_reaped = 0

    def register(self, name: str, sweep: Callable[[], int]) -> None:
        self._sweeps.append((name, sweep))

    def sweep(self) -> Dict[str, int]:
        """Run every registered sweep once; returns per-plane reap counts."""
        out: Dict[str, int] = {}
        for name, fn in self._sweeps:
            reaped = fn()
            try:
                n = len(reaped)        # sweeps may return the reaped items
            except TypeError:
                n = int(reaped or 0)
            out[name] = out.get(name, 0) + n
            self.total_reaped += n
        return out


def attach(gateway=None, coordinator=None, domains=()) -> OrphanReaper:
    """Wire the standard sweeps for a deployment in one call."""
    r = OrphanReaper()
    if coordinator is not None:
        r.register("coordinator", coordinator.reap)
    if gateway is not None:
        r.register("gateway", gateway.reap_orphans)
    for d in domains:
        r.register(f"domain:{d.domain_id}", d.tick)
    return r
