"""SplitPlacement: DISCOVER/PAGE for a two-anchor (edge draft + verify)
session.

The placement problem is the paper's Eq. 7/9 run twice under a
tier-decomposed budget: the VERIFY anchor is a normal ASP-admissible
candidate judged against the backhaul leg's share of the objectives
(``ℓ − t_verify``); the DRAFT anchor is an edge-tier model judged against
the access leg's share (``ℓ − t_edge``) and additionally constrained to
be draft-compatible with the chosen verify model (identical token space —
greedy spec-decode compares token ids, so a vocab mismatch is
structurally wrong, not merely low-acceptance). Every exclusion along the
way lands in ``notes`` so a refused split stays attributable (Eq. 12).
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import List, Tuple

from repro_torch.configs.registry import arch_tier, draft_compatible
from repro_torch.core.asp import ASP
from repro_torch.core.budget import SLABudget, apply_budget, decompose_tiers
from repro_torch.core.discovery import Candidate, discover
from repro_torch.core.failures import FailureCause, SessionError
from repro_torch.core.paging import page

#: default draft window: tokens proposed per round. γ+1 verify steps
#: commit between 1 and γ+1 tokens per round depending on agreement.
DEFAULT_GAMMA = 4


@dataclass
class SplitPlacement:
    """A proposed two-anchor realization of one ASP."""
    draft: Candidate             # edge draft anchor (data-plane path)
    verify: Candidate            # regional/central verify anchor
    draft_budget: SLABudget      # access leg's share of the objectives
    verify_budget: SLABudget     # backhaul leg's share
    gamma: int = DEFAULT_GAMMA
    #: exclusion notes collected while proposing — the Eq. 12 audit trail
    #: of every (model, site) the split considered and rejected
    notes: Tuple[str, ...] = ()

    def to_wire(self) -> dict:
        return {
            "draft": self.draft.to_wire(),
            "verify": self.verify.to_wire(),
            "draft_budget": self.draft_budget.to_wire(),
            "verify_budget": self.verify_budget.to_wire(),
            "gamma": self.gamma,
            "notes": list(self.notes),
        }


def _zone_rtt(site, zone: str) -> float:
    rtt = site.spec.rtt_ms
    if zone in rtt:
        return rtt[zone]
    return max(rtt.values()) if rtt else 50.0


def propose_split(asp: ASP, catalog, sites, predictors, zone: str, *,
                  analytics=None, gamma: int = DEFAULT_GAMMA,
                  exclude_verify_sites: Tuple[str, ...] = ()
                  ) -> SplitPlacement:
    """Propose a SplitPlacement or raise ``SessionError`` with an
    attributable cause (no edge tier, infeasible tier budget, no
    draft-compatible model, empty admissible set on either leg).

    ``exclude_verify_sites`` lets verify-tier migration/recovery re-page
    away from the current (or crashed) verify anchor while keeping the
    edge leg untouched."""
    notes: List[str] = []
    local = {sid: s for sid, s in sites.items()
             if not getattr(s, "is_guest_view", False)}
    edge_sites = {sid: s for sid, s in local.items()
                  if s.spec.kind == "edge" and not s.dead}
    verify_sites = {sid: s for sid, s in local.items()
                    if s.spec.kind != "edge" and not s.dead
                    and sid not in exclude_verify_sites}
    if not edge_sites:
        raise SessionError(FailureCause.NO_FEASIBLE_BINDING,
                           "split: no live edge-tier site for the draft "
                           "anchor")
    if not verify_sites:
        raise SessionError(FailureCause.NO_FEASIBLE_BINDING,
                           "split: no live regional/central site for the "
                           "verify anchor")
    # ---- tier budget decomposition (Eq. 11 shares per leg) ------------
    t_edge = min(_zone_rtt(s, zone) for s in edge_sites.values())
    t_verify = min(_zone_rtt(s, zone) for s in verify_sites.values())
    budgets = decompose_tiers(asp, {"edge": t_edge, "verify": t_verify})
    draft_asp = apply_budget(asp, budgets["edge"])
    verify_asp = apply_budget(asp, budgets["verify"])

    # ---- verify anchor: normal ASP admissibility on its budget share --
    vcands = discover(verify_asp, catalog, sites, predictors, zone,
                      analytics=analytics)
    v_kept: List[Candidate] = []
    for c in vcands:
        site = local.get(c.site_id)
        if site is not None and site.spec.kind == "edge":
            notes.append(f"verify {c.model.model_id}@{c.site_id}: "
                         f"wrong-tier:edge")
            continue
        if site is not None and site.dead:
            # the site table's own liveness flag, independent of whether
            # the analytics verdict has landed yet
            notes.append(f"verify {c.model.model_id}@{c.site_id}: "
                         f"site-dead")
            continue
        if not c.admissible and c.exclusion_reason:
            notes.append(f"verify {c.model.model_id}@{c.site_id}: "
                         f"{c.exclusion_reason}")
        v_kept.append(c)
    verify = page(verify_asp, v_kept,
                  exclude_sites=tuple(exclude_verify_sites))

    # ---- draft anchor: edge-tier models compatible with the verifier --
    draft_models = []
    for entry in catalog.entries():
        if entry.model_id == verify.model.model_id:
            continue
        if arch_tier(entry.model_id) != "edge":
            notes.append(f"draft {entry.model_id}: "
                         f"wrong-tier:{arch_tier(entry.model_id)}")
            continue
        if not draft_compatible(entry.cfg, verify.model.cfg):
            notes.append(
                f"draft {entry.model_id}: vocab-mismatch "
                f"({entry.cfg.vocab_size} != "
                f"{verify.model.cfg.vocab_size})")
            continue
        draft_models.append(entry)
    if not draft_models:
        raise SessionError(
            FailureCause.NO_FEASIBLE_BINDING,
            f"split: no draft-compatible edge model for "
            f"{verify.model.model_id} ({'; '.join(notes) or 'none'})")
    dcands = discover(draft_asp, catalog, sites, predictors, zone,
                      analytics=analytics, models=draft_models)
    d_kept: List[Candidate] = []
    for c in dcands:
        site = local.get(c.site_id)
        if site is None or site.spec.kind != "edge":
            notes.append(f"draft {c.model.model_id}@{c.site_id}: "
                         f"wrong-tier:{site.spec.kind if site else 'remote'}")
            continue
        if site.dead:
            notes.append(f"draft {c.model.model_id}@{c.site_id}: "
                         f"site-dead")
            continue
        if not c.admissible and c.exclusion_reason:
            notes.append(f"draft {c.model.model_id}@{c.site_id}: "
                         f"{c.exclusion_reason}")
        d_kept.append(c)
    draft = page(draft_asp, d_kept)
    return SplitPlacement(draft=draft, verify=verify,
                          draft_budget=budgets["edge"],
                          verify_budget=budgets["verify"],
                          gamma=int(gamma), notes=tuple(notes))


def reverify(placement: SplitPlacement, asp: ASP, catalog, sites,
             predictors, zone: str, *, analytics=None,
             exclude_verify_sites: Tuple[str, ...] = ()) -> SplitPlacement:
    """Re-propose only the VERIFY half (recovery / verify-tier
    migration): the edge draft anchor stays as placed."""
    fresh = propose_split(asp, catalog, sites, predictors, zone,
                          analytics=analytics, gamma=placement.gamma,
                          exclude_verify_sites=exclude_verify_sites)
    return replace(placement, verify=fresh.verify,
                   verify_budget=fresh.verify_budget,
                   notes=placement.notes + fresh.notes)
