"""Boundary telemetry Z(t) (Eq. 13) + compliance evaluation (Eq. 5/16).

Maintains a sliding window of per-request boundary observations and exposes

    Z(t) = (T̂ff, Q̂_L(0.95), Q̂_L(0.99), ρ̂, q̂, ν̂)

Everything is measured at the invoker–service boundary; nothing depends on
internal state — this is what keeps the ASP falsifiable (Section III-C).
Quantiles use exact order statistics over the window (windows are ≤ O(10⁴)
requests; P² isn't needed and exactness simplifies the property tests).
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from repro_torch.core.asp import ASP


@dataclass
class RequestRecord:
    t_submit: float
    ttfb_ms: float
    latency_ms: float
    completed: bool           # finished within T_max
    tokens: int = 0
    queue_ms: float = 0.0


@dataclass
class ZSnapshot:
    """Eq. (13)."""
    t_ff_ms: float
    q95_ms: float
    q99_ms: float
    rho: float                # completion probability under T_max
    queue_proxy_ms: float
    nu_tokens_per_s: float
    n: int


@dataclass
class ComplianceReport:
    in_compliance: bool
    ttfb_ok: bool
    p95_ok: bool
    p99_ok: bool
    rho_ok: bool
    nu_ok: bool
    z: ZSnapshot


class BoundaryTelemetry:
    def __init__(self, window: int = 2048):
        self.window = window
        self._records: List[RequestRecord] = []

    def record(self, rec: RequestRecord) -> None:
        self._records.append(rec)
        if len(self._records) > self.window:
            self._records = self._records[-self.window:]

    def __len__(self):
        return len(self._records)

    # ------------------------------------------------------------------
    def snapshot(self) -> Optional[ZSnapshot]:
        if not self._records:
            return None
        rs = self._records
        lat = np.array([r.latency_ms for r in rs if r.completed])
        ttfb = np.array([r.ttfb_ms for r in rs if r.completed])
        if lat.size == 0:
            lat = np.array([float("inf")])
            ttfb = np.array([float("inf")])
        tok = sum(r.tokens for r in rs)
        dur_s = max(sum(r.latency_ms for r in rs) / 1e3, 1e-9)
        return ZSnapshot(
            t_ff_ms=float(np.median(ttfb)),
            q95_ms=float(np.quantile(lat, 0.95)),
            q99_ms=float(np.quantile(lat, 0.99)),
            rho=float(np.mean([r.completed for r in rs])),
            queue_proxy_ms=float(np.mean([r.queue_ms for r in rs])),
            nu_tokens_per_s=tok / dur_s,
            n=len(rs))

    def compliance(self, asp: ASP) -> Optional[ComplianceReport]:
        """Eq. (5)/(16): evaluate Z(t) against the ASP bounds."""
        z = self.snapshot()
        if z is None:
            return None
        o = asp.objectives
        ttfb_ok = z.t_ff_ms <= o.ttfb_ms
        p95_ok = z.q95_ms <= o.p95_ms
        p99_ok = z.q99_ms <= o.p99_ms
        rho_ok = z.rho >= o.rho_min
        nu_ok = z.nu_tokens_per_s >= o.nu_min or z.nu_tokens_per_s == 0.0
        return ComplianceReport(
            in_compliance=ttfb_ok and p95_ok and p99_ok and rho_ok and nu_ok,
            ttfb_ok=ttfb_ok, p95_ok=p95_ok, p99_ok=p99_ok, rho_ok=rho_ok,
            nu_ok=nu_ok, z=z)

    def violation_rate(self, asp: ASP) -> float:
        """Per-request ASP violation frequency (Eq. 16 semantics): a served
        request is non-compliant iff L > ℓ99 or L > T_max."""
        if not self._records:
            return 0.0
        o = asp.objectives
        bad = sum(1 for r in self._records
                  if (not r.completed) or r.latency_ms > o.p99_ms
                  or r.latency_ms > o.t_max_ms)
        return bad / len(self._records)
