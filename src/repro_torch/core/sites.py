"""Execution sites (the "execution role"): edge / regional / central anchors.

A site models a group of NVIDIA H100 SXM cards: chips, HBM,
peak FLOP/s, access RTT per zone, hosted models, and a **compute lease
table**. Leases are the v_cmp(t) side of the commitment coupling (Eq. 4/10):
a lease is provisional until confirmed, carries an expiry, and releasing it
is idempotent (two-phase rollback must never partially free).

Capacity model (what PREPARE reserves):
* decode slots — concurrent sequences the site's continuous batcher admits;
* HBM bytes    — weights (shared, refcounted) + per-session cache bytes.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

from repro_torch.core.clock import Clock
from repro_torch.core.failures import FailureCause, SessionError
from repro_torch.core.catalog import ModelEntry


@dataclass
class ComputeLease:
    lease_id: str
    site_id: str
    model_key: str
    slots: int
    hbm_bytes: float
    expires_at: float
    confirmed: bool = False

    def valid(self, now: float) -> bool:
        return now < self.expires_at


@dataclass
class SiteSpec:
    site_id: str
    kind: str                   # edge | regional | central
    region: str                 # sovereignty region tag
    chips: int
    hbm_bytes_total: float
    peak_flops: float           # aggregate bf16
    hbm_bw: float               # aggregate bytes/s
    decode_slots: int
    #: RTT (ms) from each access zone to this site
    rtt_ms: Dict[str, float] = field(default_factory=dict)
    #: models with weights resident (model_key = "id@version")
    hosted_models: Tuple[str, ...] = ()
    #: price per chip-second (feeds Γ̂)
    price_per_chip_s: float = 1e-4


class ExecutionSite:
    """Reservation + telemetry surface of one anchor."""

    def __init__(self, spec: SiteSpec, clock: Clock):
        self.spec = spec
        self.clock = clock
        self._leases: Dict[str, ComputeLease] = {}
        self._ids = itertools.count()
        # smoothed occupancy signals (fed to analytics/NWDAF role)
        self._queue_depth = 0.0
        self._engine = None  # optional real InferenceEngine (migration plane)
        self._plane = None   # QoS-scheduled ServingPlane (repro_torch.serving.plane)
        #: supervisor crash verdict: a dead site holds no leases (v_cmp is
        #: False for every session anchored here) and refuses PREPARE
        self.dead = False

    # ------------------------------------------------------------------
    # capacity accounting
    # ------------------------------------------------------------------
    def _gc(self) -> None:
        now = self.clock.now()
        dead = [k for k, l in self._leases.items() if not l.valid(now)]
        for k in dead:
            del self._leases[k]

    def slots_in_use(self) -> int:
        self._gc()
        return sum(l.slots for l in self._leases.values())

    def hbm_in_use(self) -> float:
        self._gc()
        return sum(l.hbm_bytes for l in self._leases.values())

    def utilization(self) -> float:
        return self.slots_in_use() / max(self.spec.decode_slots, 1)

    def hosts(self, model_key: str) -> bool:
        return model_key in self.spec.hosted_models

    # ------------------------------------------------------------------
    # lease lifecycle (v_cmp side of Eq. 4/10)
    # ------------------------------------------------------------------
    def prepare(self, model: ModelEntry, *, slots: int, cache_bytes: float,
                ttl_s: float) -> ComputeLease:
        """Provisional reservation. Raises COMPUTE_SCARCITY when the site
        cannot hold the new session without breaking existing leases."""
        self._gc()
        if self.dead:
            raise SessionError(FailureCause.COMPUTE_SCARCITY,
                               f"{self.spec.site_id}: site is dead")
        key = f"{model.model_id}@{model.version}"
        if not self.hosts(key):
            raise SessionError(FailureCause.MODEL_UNAVAILABLE,
                               f"{key} not resident on {self.spec.site_id}")
        if self.slots_in_use() + slots > self.spec.decode_slots:
            raise SessionError(FailureCause.COMPUTE_SCARCITY,
                               f"{self.spec.site_id}: decode slots exhausted")
        if self.hbm_in_use() + cache_bytes > self.spec.hbm_bytes_total:
            raise SessionError(FailureCause.COMPUTE_SCARCITY,
                               f"{self.spec.site_id}: HBM exhausted")
        lease = ComputeLease(
            lease_id=f"{self.spec.site_id}/cmp-{next(self._ids)}",
            site_id=self.spec.site_id, model_key=key, slots=slots,
            hbm_bytes=cache_bytes,
            expires_at=self.clock.now() + ttl_s)
        self._leases[lease.lease_id] = lease
        return lease

    def confirm(self, lease_id: str, *, lease_s: float) -> None:
        lease = self._leases.get(lease_id)
        if lease is None or not lease.valid(self.clock.now()):
            raise SessionError(FailureCause.DEADLINE_EXPIRY,
                               f"compute lease {lease_id} expired before COMMIT")
        lease.confirmed = True
        lease.expires_at = self.clock.now() + lease_s

    def renew(self, lease_id: str, lease_s: float) -> bool:
        lease = self._leases.get(lease_id)
        if lease is None or not lease.valid(self.clock.now()):
            return False
        lease.expires_at = self.clock.now() + lease_s
        return True

    def release(self, lease_id: str) -> None:
        """Idempotent: releasing an unknown/expired lease is a no-op."""
        self._leases.pop(lease_id, None)

    def lease_valid(self, lease_id: str) -> bool:
        lease = self._leases.get(lease_id)
        return bool(lease and lease.valid(self.clock.now()))

    # ------------------------------------------------------------------
    # supervisor lifecycle
    # ------------------------------------------------------------------
    def mark_dead(self, detail: str = "") -> None:
        """Crash: the lease table dies with the process. Every session
        anchored here instantly loses v_cmp — exactly the Eq. 4 coupling
        the supervisor's re-anchoring restores at a live site."""
        self.dead = True
        self._leases.clear()

    def mark_alive(self) -> None:
        """Recovered process: fresh lease table (nothing survives a crash);
        sessions must re-PREPARE."""
        self.dead = False
        self._leases.clear()

    # ------------------------------------------------------------------
    # service-time primitives (feed predictors)
    # ------------------------------------------------------------------
    def flops_per_chip(self) -> float:
        return self.spec.peak_flops / max(self.spec.chips, 1)

    def attach_engine(self, engine) -> None:
        self._engine = engine

    @property
    def engine(self):
        return self._engine

    def attach_plane(self, plane) -> None:
        """Every request to this site is served through this plane — the
        QoS-contract enforcement point (class ordering, premium reservation,
        deadline fast-fail) and the congestion sensor for analytics."""
        self._plane = plane

    @property
    def plane(self):
        return self._plane


def default_sites(clock: Clock, hosted: Tuple[str, ...]) -> Dict[str, ExecutionSite]:
    """A 3-tier deployment: edge (close, small), regional, central (far, big).

    Each chip is one H100 SXM card. Per-card figures from NVIDIA's H100
    data sheet (SXM, dense, no sparsity): 989e12 bf16 FLOP/s on the tensor
    cores, 3.35e12 B/s of HBM3 bandwidth, 80e9 B of HBM."""
    mk = lambda s: ExecutionSite(s, clock)
    gpu_flops, gpu_bw, hbm = 989e12, 3.35e12, 80e9
    sites = [
        SiteSpec("edge-a", "edge", "eu", chips=16,
                 hbm_bytes_total=16 * hbm, peak_flops=16 * gpu_flops,
                 hbm_bw=16 * gpu_bw, decode_slots=64,
                 rtt_ms={"zone-a": 2.0, "zone-b": 9.0, "zone-c": 18.0},
                 hosted_models=hosted, price_per_chip_s=2.0e-4),
        SiteSpec("edge-b", "edge", "eu", chips=16,
                 hbm_bytes_total=16 * hbm, peak_flops=16 * gpu_flops,
                 hbm_bw=16 * gpu_bw, decode_slots=64,
                 rtt_ms={"zone-a": 9.0, "zone-b": 2.0, "zone-c": 10.0},
                 hosted_models=hosted, price_per_chip_s=2.0e-4),
        SiteSpec("regional-1", "regional", "eu", chips=64,
                 hbm_bytes_total=64 * hbm, peak_flops=64 * gpu_flops,
                 hbm_bw=64 * gpu_bw, decode_slots=384,
                 rtt_ms={"zone-a": 12.0, "zone-b": 12.0, "zone-c": 12.0},
                 hosted_models=hosted, price_per_chip_s=1.2e-4),
        SiteSpec("central-1", "central", "us", chips=256,
                 hbm_bytes_total=256 * hbm, peak_flops=256 * gpu_flops,
                 hbm_bw=256 * gpu_bw, decode_slots=2048,
                 rtt_ms={"zone-a": 55.0, "zone-b": 55.0, "zone-c": 55.0},
                 hosted_models=hosted, price_per_chip_s=0.8e-4),
    ]
    return {s.site_id: mk(s) for s in sites}
