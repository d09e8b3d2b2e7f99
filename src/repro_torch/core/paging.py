"""AI PAGING (Eq. 9): context-aware anchoring.

Selects (m*, e*) ∈ 𝒦 minimising predicted contract-violation risk

    w1·P̂[L99 > ℓ99 | m,e,ξ] + w2·P̂[Tff > ℓff | m,e,ξ]
                             + w3·P̂[migration required | m,e,ξ]

subject to the hard constraints already enforced in discovery. The risk
events are written in the exact boundary quantities the ASP constrains, so
every anchoring decision is falsifiable against Z(t) after the fact.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

from repro_torch.core.asp import ASP
from repro_torch.core.discovery import Candidate, admissible_set
from repro_torch.core.failures import FailureCause, SessionError


@dataclass(frozen=True)
class PagingWeights:
    w1: float = 1.0     # tail-latency violation risk
    w2: float = 1.0     # TTFB violation risk
    w3: float = 0.5     # migration risk (continuity classes weight higher)
    #: home-routing bias: anchoring in another administrative domain costs
    #: an east-west handshake on every later lifecycle verb, so a visited
    #: anchor must beat the best home anchor by at least this much risk
    w_domain: float = 0.05


def risk(c: Candidate, w: PagingWeights) -> float:
    p = c.prediction
    return w.w1 * p.p_violate_l99 + w.w2 * p.p_violate_ttfb \
        + w.w3 * p.p_migration \
        + (w.w_domain if getattr(c, "domain", "") else 0.0)


def page(asp: ASP, candidates: List[Candidate], *,
         weights: Optional[PagingWeights] = None,
         exclude_sites: Tuple[str, ...] = ()) -> Candidate:
    """Pick the anchor. ``exclude_sites`` lets migration re-page away from
    the current (degraded) anchor."""
    w = weights or PagingWeights(
        w3=1.5 if asp.continuity_required() else 0.25)
    k = [c for c in admissible_set(candidates)
         if c.site_id not in exclude_sites]
    if not k:
        raise SessionError(FailureCause.NO_FEASIBLE_BINDING,
                           "admissible set empty after exclusions")
    return min(k, key=lambda c: risk(c, w))
