"""DISCOVER (Eq. 7/8): ASP → ranked admissible (model, site) candidates.

Membership in 𝒦 is determined by *hard* constraints (sovereignty, privacy
scope, quality tier, hardware residency); ranking by the compliance-margin
slack score

    Δ(m,e) = min(ℓ99 − L̂99(m,e), ℓ_ff − T̂ff(m,e)) − λ·Γ̂(m,e)      (Eq. 8)

Candidates with Δ < 0 are predicted to violate at least one bound after cost
policy and are excluded from the admissible set (they remain visible in the
annotated output for diagnosability — "no feasible binding" must be
attributable, Eq. 12).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import List

from repro_torch.core.asp import ASP
from repro_torch.core.catalog import Catalog, ModelEntry
from repro_torch.core.failures import FailureCause, SessionError
from repro_torch.core.predictors import Prediction, Predictors
from repro_torch.core.qos import TransportClass, PREMIUM, BEST_EFFORT


@dataclass
class Candidate:
    model: ModelEntry
    site_id: str
    prediction: Prediction
    slack: float                 # Δ(m, e)
    klass: TransportClass
    admissible: bool
    exclusion_reason: str = ""
    #: owning administrative domain of an east-west offer; "" = local.
    #: In a merged federated set, exclusion reasons are prefixed with the
    #: owning domain so NO_FEASIBLE_BINDING stays attributable (Eq. 12).
    domain: str = ""
    region: str = ""             # site region (sovereignty check w/o sites)

    def to_wire(self, *, include_prediction: bool = False) -> dict:
        """Annotated-candidate wire entry — the ONE shape both the
        northbound ``DiscoverResponse`` and the east-west
        ``DiscoverOffer`` carry (offers add the predicted boundary
        quantities; the northbound surface exposes only the slack)."""
        out = {
            "model_id": self.model.model_id,
            "model_version": self.model.version,
            "site_id": self.site_id, "klass": self.klass.name,
            "admissible": self.admissible,
            "slack": self.slack if self.prediction is not None else None,
            "exclusion_reason": self.exclusion_reason,
            "domain": self.domain, "region": self.region,
        }
        if include_prediction:
            out["prediction"] = dataclasses.asdict(self.prediction) \
                if self.prediction is not None else None
        return out


def discover(asp: ASP, catalog: Catalog, sites, predictors: Predictors,
             zone: str, *, lam: float = 0.05, prompt_tokens: int = 512,
             gen_tokens: int = 256, analytics=None,
             models=None, breakers=None) -> List[Candidate]:
    """Materialise the annotated candidate set 𝒦 (Eq. 7).

    ``models`` overrides the catalog's ASP-admissible entries with an
    explicit candidate list — the split-placement path scores DRAFT
    models this way, because a draft runs below the ASP's quality tier
    by construction (the verifier carries the tier; the draft only has
    to be latency/cost-feasible on its leg's budget share)."""
    asp.validate()
    if models is None:
        models = catalog.admissible(asp)
    if not models:
        raise SessionError(FailureCause.MODEL_UNAVAILABLE,
                           f"no catalog entry admits modality="
                           f"{asp.modality.value} tier≥{int(asp.tier)}")
    # tenant adapter binding: resolve once; unknown ids exclude every
    # candidate (PREPARE re-checks and raises NO_FEASIBLE_BINDING)
    adapter = None
    adapter_known = True
    if asp.adapter_id:
        adapters = getattr(catalog, "adapters", None)
        try:
            adapter = adapters.get(asp.adapter_id) if adapters else None
        except KeyError:
            adapter = None
        adapter_known = adapter is not None
    ladder_models = {m for m, _ in asp.fallback_ladder}
    klass = PREMIUM if asp.tier >= 2 else BEST_EFFORT
    # breaker verdicts are memoised per discover() call: allow() mutates
    # the open → half-open probe state, and one DISCOVER must not burn
    # several probe admissions (or give the same site both answers)
    breaker_ok: dict = {}
    out: List[Candidate] = []
    for model in models:
        key = f"{model.model_id}@{model.version}"
        for site_id, site in sites.items():
            # guest views of other domains' sites are reached through the
            # east-west DISCOVER solicitation, never as local candidates
            if getattr(site, "is_guest_view", False):
                continue
            region = site.spec.region

            def _excl(reason: str) -> Candidate:
                return Candidate(model, site_id, None, float("-inf"),
                                 klass, False, reason, region=region)

            # ---- hard constraints (membership in 𝒦) -----------------
            if region not in asp.allowed_regions:
                out.append(_excl("sovereignty"))
                continue
            if set(model.regions).isdisjoint({region}):
                out.append(_excl("model-region-license"))
                continue
            if not site.hosts(key):
                out.append(_excl("not-resident"))
                continue
            # ---- tenant adapter admissibility ------------------------
            if asp.adapter_id:
                if not adapter_known:
                    out.append(_excl("adapter-unknown"))
                    continue
                if model.model_id == adapter.base_model_id:
                    # "base+adapter at the edge": the adapter's own
                    # sovereignty tags gate the site, on top of the
                    # base model's license
                    if model.version != adapter.base_model_version:
                        out.append(_excl("adapter-base-mismatch"))
                        continue
                    if region not in adapter.regions:
                        out.append(_excl("adapter-region"))
                        continue
                elif model.model_id not in ladder_models:
                    # a non-base model is only admissible as a declared
                    # "full model in region" rung of the fallback ladder
                    out.append(_excl("adapter-base-mismatch"))
                    continue
            if site.slots_in_use() >= site.spec.decode_slots:
                # current occupancy IS a feasibility signal: a saturated
                # site would only fail later at PREPARE with
                # COMPUTE_SCARCITY — surfacing it here lets home-first
                # federation spill the establish instead
                out.append(_excl("compute-saturated"))
                continue
            if analytics is not None:
                ctx = analytics.site_context(site_id)
                if not ctx.alive:
                    # supervisor crash verdict: distinct from policy denial
                    # so the Eq. 12 detail string names the real cause
                    out.append(_excl("site-dead"))
                    continue
                if not ctx.healthy:
                    out.append(_excl("a1-denied"))
                    continue
            if breakers is not None:
                ok = breaker_ok.get(site_id)
                if ok is None:
                    ok = breaker_ok[site_id] = breakers.allow(site_id)
                if not ok:
                    # circuit open after consecutive control-plane failures:
                    # the site may be fine — we are backing off the *path*
                    # until the half-open probe readmits it
                    out.append(_excl("circuit-open"))
                    continue
            # ---- annotate with predicted boundary quantities ----------
            pred = predictors.predict(asp, model, site, zone, klass,
                                      prompt_tokens=prompt_tokens,
                                      gen_tokens=gen_tokens)
            slack = min(asp.objectives.p99_ms - pred.l99_ms,
                        asp.objectives.ttfb_ms - pred.t_ff_ms) \
                - lam * pred.cost_per_1k
            admissible = slack >= 0 and \
                pred.cost_per_1k <= asp.max_cost_per_1k_tokens
            reason = "" if admissible else (
                "cost-envelope" if pred.cost_per_1k > asp.max_cost_per_1k_tokens
                else "negative-slack")
            out.append(Candidate(model, site_id, pred, slack, klass,
                                 admissible, reason, region=region))
    out.sort(key=lambda c: c.slack, reverse=True)
    return out


def admissible_set(candidates: List[Candidate]) -> List[Candidate]:
    k = [c for c in candidates if c.admissible]
    if not k:
        reasons = {c.exclusion_reason for c in candidates}
        # strip federation domain prefixes for the cause decision — the
        # full (domain-qualified) reasons stay in the detail string
        bare = {r.split(":", 1)[-1] for r in reasons}
        if bare and bare <= {"compute-saturated", "site-dead", "circuit-open",
                             "offer-timeout", "domain-dead"}:
            # every candidate exists and would bind — the anchors are just
            # full (crashed, breaker-isolated, or unreachable over a lossy
            # east-west wire) right now. Eq. (12) keeps this distinct
            # from "no feasible binding": the remediation is retry/backoff
            # on an alternate anchor (or east-west spillover), not
            # relaxing the objectives.
            raise SessionError(
                FailureCause.COMPUTE_SCARCITY,
                f"all candidate sites saturated "
                f"({', '.join(sorted(reasons))})")
        raise SessionError(
            FailureCause.NO_FEASIBLE_BINDING,
            f"all candidates excluded ({', '.join(sorted(reasons))})")
    return k
