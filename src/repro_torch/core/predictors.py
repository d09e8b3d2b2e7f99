"""Feasibility predictors: T̂ff(m,e,ξ), L̂99(m,e,ξ), Γ̂(m,e) — Eq. (7)–(9).

The paper deliberately leaves predictor internals as "competitive space";
this implementation ties them to the systems substrate:

* **Execution side** — service time from the roofline model of the target
  hardware (FLOPs/token vs peak FLOP/s, bytes/token vs HBM bandwidth; the
  same constants as EXPERIMENTS.md §Roofline), queue wait from an M/M/c
  approximation driven by the analytics ξ (measured utilization), and a
  lognormal execution-tail assumption calibrated by measured p99 when
  boundary telemetry exists.
* **Transport side** — per-QoS-class latency classes (repro_torch.core.qos).

Every predicted quantity is in the same units as the ASP objectives, so
anchoring risk (Eq. 9) and migration triggers (Eq. 14) are falsifiable
against Z(t) (Eq. 13).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from repro_torch.core.analytics import Analytics, SiteContext
from repro_torch.core.asp import ASP
from repro_torch.core.catalog import ModelEntry
from repro_torch.core.qos import TransportClass

#: lognormal sigma for execution-time variability (calibrated vs §V sim)
_EXEC_SIGMA = 0.35
#: z-scores
_Z95, _Z99 = 1.645, 2.326


def _lognormal_quantile(median: float, sigma: float, z: float) -> float:
    return median * math.exp(sigma * z)


@dataclass
class Prediction:
    t_ff_ms: float          # T̂ff
    l99_ms: float           # L̂99
    l95_ms: float
    cost_per_1k: float      # Γ̂ (per 1k tokens)
    decode_ms_per_token: float
    queue_wait_ms: float
    p_violate_l99: float
    p_violate_ttfb: float
    p_migration: float


class Predictors:
    #: memo bound: cleared wholesale past this size (establish storms over
    #: many ASPs; the epoch key already retires stale entries naturally)
    _MEMO_MAX = 65_536

    def __init__(self, analytics: Analytics, *, mfu: float = 0.4,
                 bw_eff: float = 0.6):
        self.analytics = analytics
        self.mfu = mfu          # achievable fraction of peak FLOP/s
        self.bw_eff = bw_eff    # achievable fraction of HBM bandwidth
        # memoized predictions keyed on (ASP digest, model, site, zone,
        # class, request shape, site load-epoch): DISCOVER evaluates the
        # full model×site cross product on EVERY establish, and federated
        # discovery multiplies that by the number of solicited domains —
        # identical ξ must not recompute the roofline/queue math
        self._memo: dict = {}
        self.memo_hits = 0
        self.memo_misses = 0

    # -- execution-side service times ------------------------------------
    def prefill_ms(self, model: ModelEntry, site, prompt_tokens: int) -> float:
        flops = model.prefill_flops_per_token() * prompt_tokens
        return 1e3 * flops / (site.spec.peak_flops * self.mfu)

    def decode_ms_per_token(self, model: ModelEntry, site, context: int) -> float:
        """Decode is memory-bound: per-token bytes / effective bandwidth."""
        byts = model.decode_bytes_per_token(context)
        t_mem = byts / (site.spec.hbm_bw * self.bw_eff)
        t_cmp = model.decode_flops_per_token() / (site.spec.peak_flops * self.mfu)
        return 1e3 * max(t_mem, t_cmp)

    def queue_wait_ms(self, site, ctx: SiteContext, service_ms: float) -> float:
        """M/M/c wait with c = free decode slots; driven by measured ξ."""
        rho = min(ctx.utilization, 0.999)
        c = max(site.spec.decode_slots, 1)
        # Sakasegawa approximation: Wq ≈ (ρ^(√(2(c+1)))/ (c(1-ρ))) · service
        wq = (rho ** math.sqrt(2 * (c + 1))) / (c * (1 - rho)) * service_ms
        wq *= c  # scale back to per-request units
        # measured backlog (serving-plane queue depth, per slot): each queued
        # request ahead contributes ~one service time per slot — this is the
        # term that makes Eq. (14) triggers fire under real congestion
        wq += ctx.queue_depth * service_ms
        # KV page-pool pressure (paged engines): near-full pools force
        # hibernate/resume churn on admission, so expected wait grows
        # sharply as page_util -> 1; exactly zero when unreported (0.0)
        if ctx.page_util > 0.0:
            wq += (ctx.page_util ** 4) / max(1.0 - ctx.page_util, 1.0 / 16.0) \
                * service_ms
        return wq

    # -- headline predictions ------------------------------------------------
    def predict(self, asp: ASP, model: ModelEntry, site, zone: str,
                klass: TransportClass, *, prompt_tokens: int = 512,
                gen_tokens: int = 256) -> Prediction:
        # memo hit ⟺ same contract, placement, shape AND unchanged ξ —
        # every heartbeat observation bumps the site's load epoch, so
        # cached predictions can never outlive the evidence behind them
        key = (asp.digest(), f"{model.model_id}@{model.version}",
               site.spec.site_id, zone, klass.name,
               prompt_tokens, gen_tokens,
               self.analytics.load_epoch(site.spec.site_id))
        cached = self._memo.get(key)
        if cached is not None:
            self.memo_hits += 1
            return cached
        self.memo_misses += 1
        pred = self._predict(asp, model, site, zone, klass,
                             prompt_tokens=prompt_tokens,
                             gen_tokens=gen_tokens)
        if len(self._memo) >= self._MEMO_MAX:
            self._memo.clear()
        self._memo[key] = pred
        return pred

    def _predict(self, asp: ASP, model: ModelEntry, site, zone: str,
                 klass: TransportClass, *, prompt_tokens: int = 512,
                 gen_tokens: int = 256) -> Prediction:
        rtt = site.spec.rtt_ms.get(zone, 60.0)
        transport_ms = rtt + klass.base_ms
        transport_p99 = rtt + min(
            klass.p999_cap_ms,
            klass.base_ms + _Z99 * klass.jitter_ms * 3)

        ctx = self.analytics.site_context(site.spec.site_id)
        prefill = self.prefill_ms(model, site, prompt_tokens)
        dms = self.decode_ms_per_token(model, site, prompt_tokens + gen_tokens)
        wq = self.queue_wait_ms(site, ctx, prefill + gen_tokens * dms)

        t_ff_med = transport_ms + wq + prefill
        # completion latency: full generation
        l_med = transport_ms + wq + prefill + gen_tokens * dms
        measured = self.analytics.measured_p99(
            site.spec.site_id, f"{model.model_id}@{model.version}")
        l99 = _lognormal_quantile(l_med, _EXEC_SIGMA, _Z99) + transport_p99 - transport_ms
        if measured is not None:  # calibrate on boundary evidence
            l99 = 0.5 * l99 + 0.5 * measured
        l95 = _lognormal_quantile(l_med, _EXEC_SIGMA, _Z95)

        # violation probabilities under the lognormal tail
        def p_exceed(bound_ms: float, med: float) -> float:
            if med <= 0:
                return 0.0
            z = math.log(max(bound_ms, 1e-9) / med) / _EXEC_SIGMA
            return 0.5 * math.erfc(z / math.sqrt(2))

        p_l99 = p_exceed(asp.objectives.p99_ms, l_med)
        p_ttfb = p_exceed(asp.objectives.ttfb_ms, t_ff_med)

        # migration likelihood over the session horizon: mobility-driven RTT
        # drift away from edge sites — central sites rarely need re-anchoring
        ho_rate = 0.0
        if asp.continuity_required():
            # defaulted: unknown site kinds (new deployments, federated
            # guests) predict like a regional anchor instead of 500-ing
            # DISCOVER with a KeyError
            base = {"edge": 0.8, "regional": 0.3,
                    "central": 0.05}.get(site.spec.kind, 0.3)
            ho_rate = base
        p_mig = 1.0 - math.exp(-ho_rate)

        # cost: chip-seconds per 1k tokens × price + model license price
        chip_s_per_1k = (1000 * dms / 1e3) * site.spec.chips * \
            (1.0 / max(site.spec.decode_slots, 1))
        cost = model.price_per_1k_tokens + chip_s_per_1k * site.spec.price_per_chip_s * 1e3
        return Prediction(
            t_ff_ms=t_ff_med, l99_ms=l99, l95_ms=l95, cost_per_1k=cost,
            decode_ms_per_token=dms, queue_wait_ms=wq,
            p_violate_l99=p_l99, p_violate_ttfb=p_ttfb, p_migration=p_mig)
