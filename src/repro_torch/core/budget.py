"""Tier-decomposed SLA budgets — shared by east-west federation and
split (device–RAN–cloud) placement.

One ASP carries END-TO-END objectives; any placement that spans more than
one leg (a visited operator behind a transit link, or a split session
whose draft and verify anchors sit at different tiers) must hand each leg
an explicit share of those objectives, never the raw bounds::

    ℓ_leg = ℓ − t_leg           for ℓ ∈ {ℓ_TTFB, ℓ_0.95, ℓ_0.99, T_max}
    γ_leg = γ · s_leg           with Σ s_leg ≤ 1

A decomposition with any non-positive execution share is *infeasible
before any traffic is generated* and maps to ``NO_FEASIBLE_BINDING``
(Eq. 12) — a leg is never asked to promise what its transport already
consumed. ``decompose_budget`` is the two-party (home/visited) form the
federation wire speaks; ``decompose_tiers`` generalizes it to N named
tiers for split placement (edge draft + regional/central verify).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, replace
from typing import Dict, Mapping, Optional

from repro_torch.core.asp import ASP
from repro_torch.core.failures import FailureCause, SessionError


@dataclass(frozen=True)
class SLABudget:
    """Per-leg split of one ASP's objectives (all ms except cost)."""
    ttfb_ms: float              # execution share of ℓ_TTFB
    p95_ms: float
    p99_ms: float               # execution share of ℓ_0.99
    t_max_ms: float
    max_cost_per_1k: float      # execution share of γ
    home_transport_ms: float    # the transport share withheld (audit)
    home_cost_per_1k: float     # withheld transit/retail cost share (audit)

    def to_wire(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_wire(cls, d: dict) -> "SLABudget":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: float(v) for k, v in d.items() if k in names})


def decompose_budget(asp: ASP, home_transport_ms: float, *,
                     home_cost_share: float = 0.15) -> SLABudget:
    """Split the ASP objectives between the withheld transport leg and the
    execution leg. Raises ``NO_FEASIBLE_BINDING`` when the transport share
    alone exhausts any bound — the infeasibility is attributable *before*
    any east-west (or split-PREPARE) traffic is generated."""
    o = asp.objectives
    visited = {
        "ttfb_ms": o.ttfb_ms - home_transport_ms,
        "p95_ms": o.p95_ms - home_transport_ms,
        "p99_ms": o.p99_ms - home_transport_ms,
        "t_max_ms": o.t_max_ms - home_transport_ms,
    }
    if min(visited.values()) <= 0.0:
        raise SessionError(
            FailureCause.NO_FEASIBLE_BINDING,
            f"SLA budget infeasible after decomposition: home transport "
            f"share {home_transport_ms:.1f}ms exhausts "
            f"{min(visited, key=visited.get)}")
    if not (0.0 <= home_cost_share < 1.0):
        raise ValueError("home_cost_share must be in [0, 1)")
    home_cost = asp.max_cost_per_1k_tokens * home_cost_share
    return SLABudget(
        ttfb_ms=visited["ttfb_ms"], p95_ms=visited["p95_ms"],
        p99_ms=visited["p99_ms"], t_max_ms=visited["t_max_ms"],
        max_cost_per_1k=asp.max_cost_per_1k_tokens - home_cost,
        home_transport_ms=home_transport_ms, home_cost_per_1k=home_cost)


def decompose_tiers(asp: ASP, transport_ms: Mapping[str, float], *,
                    cost_shares: Optional[Mapping[str, float]] = None
                    ) -> Dict[str, SLABudget]:
    """Tier-generalized decomposition: each named tier keeps its OWN
    transport leg (edge RTT for the draft anchor, backhaul RTT for the
    verify anchor) and receives ``ℓ − t_tier`` of every latency bound plus
    its cost share of γ (equal split unless ``cost_shares`` says
    otherwise). Any tier whose transport exhausts a bound makes the whole
    split infeasible — raised as ``NO_FEASIBLE_BINDING`` naming the tier,
    so DISCOVER can fall back to single-anchor placement attributably."""
    if not transport_ms:
        raise ValueError("decompose_tiers needs at least one tier")
    shares = dict(cost_shares or {})
    unnamed = [t for t in transport_ms if t not in shares]
    remaining = 1.0 - sum(shares.values())
    if remaining < -1e-9 or any(s < 0.0 for s in shares.values()):
        raise ValueError("tier cost shares must be >= 0 and sum to <= 1")
    for t in unnamed:
        shares[t] = remaining / len(unnamed) if unnamed else 0.0
    out: Dict[str, SLABudget] = {}
    for tier, t_ms in transport_ms.items():
        try:
            out[tier] = decompose_budget(
                asp, float(t_ms),
                home_cost_share=min(max(1.0 - shares[tier], 0.0),
                                    1.0 - 1e-9))
        except SessionError as e:
            raise SessionError(
                FailureCause.NO_FEASIBLE_BINDING,
                f"tier {tier!r}: {e.detail}") from None
    return out


def apply_budget(asp: ASP, budget: SLABudget) -> ASP:
    """The executing leg's view of the contract: the same constraint part
    (modality, sovereignty, mobility, ladder) under its execution share of
    the objectives and cost envelope."""
    return replace(
        asp,
        objectives=replace(asp.objectives, ttfb_ms=budget.ttfb_ms,
                           p95_ms=budget.p95_ms, p99_ms=budget.p99_ms,
                           t_max_ms=budget.t_max_ms),
        max_cost_per_1k_tokens=budget.max_cost_per_1k)
