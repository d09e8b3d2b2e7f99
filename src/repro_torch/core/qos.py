"""Transport role: QoS flows (QFI) + steering — the v_qos(t) side of Eq. 4/10.

Models the 5G enforcement plane at the semantic level the paper requires:
finite per-path premium-flow budgets, leases with expiry, idempotent release,
and per-QFI latency classes that the simulator and predictors consume. The
mapping to a real UPF/PCF is in DESIGN.md §2; here the *contractual*
behaviour is what matters — premium treatment is a reservable, exhaustible
resource whose scarcity is a distinct failure cause (QOS_SCARCITY ≠
COMPUTE_SCARCITY, Eq. 12).
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

from repro_torch.core.clock import Clock
from repro_torch.core.failures import FailureCause, SessionError


@dataclass(frozen=True)
class TransportClass:
    """Latency model of one QoS class on one path (ms)."""
    name: str                   # premium | assured | best-effort
    base_ms: float              # propagation + forwarding floor
    jitter_ms: float            # lognormal sigma-scale of the variable part
    p999_cap_ms: float          # enforced delay budget (premium classes)


PREMIUM = TransportClass("premium", base_ms=1.0, jitter_ms=0.3, p999_cap_ms=8.0)
ASSURED = TransportClass("assured", base_ms=1.5, jitter_ms=1.0, p999_cap_ms=25.0)
BEST_EFFORT = TransportClass("best-effort", base_ms=2.0, jitter_ms=6.0,
                             p999_cap_ms=float("inf"))


@dataclass
class QoSLease:
    lease_id: str
    qfi: int
    path: Tuple[str, str]       # (access zone, site id)
    klass: TransportClass
    expires_at: float
    confirmed: bool = False

    def valid(self, now: float) -> bool:
        return now < self.expires_at


class QoSFlowManager:
    """Per-path premium budget + QFI allocation."""

    def __init__(self, clock: Clock, *, premium_flows_per_path: int = 32,
                 assured_flows_per_path: int = 128):
        self.clock = clock
        self._budget = {"premium": premium_flows_per_path,
                        "assured": assured_flows_per_path}
        self._leases: Dict[str, QoSLease] = {}
        self._ids = itertools.count()
        self._qfis = itertools.count(1)

    def _gc(self) -> None:
        now = self.clock.now()
        for k in [k for k, l in self._leases.items() if not l.valid(now)]:
            del self._leases[k]

    def in_use(self, path: Tuple[str, str], klass: str) -> int:
        self._gc()
        return sum(1 for l in self._leases.values()
                   if l.path == path and l.klass.name == klass)

    def prepare(self, path: Tuple[str, str], klass: TransportClass,
                *, ttl_s: float) -> QoSLease:
        """Provisional QoS-flow binding. Best-effort never blocks; premium /
        assured classes draw from the finite per-path budget."""
        self._gc()
        if klass.name != "best-effort":
            if self.in_use(path, klass.name) >= self._budget[klass.name]:
                raise SessionError(
                    FailureCause.QOS_SCARCITY,
                    f"no {klass.name} flows left on path {path}")
        lease = QoSLease(
            lease_id=f"qos-{next(self._ids)}", qfi=next(self._qfis),
            path=path, klass=klass,
            expires_at=self.clock.now() + ttl_s)
        self._leases[lease.lease_id] = lease
        return lease

    def confirm(self, lease_id: str, *, lease_s: float) -> None:
        lease = self._leases.get(lease_id)
        if lease is None or not lease.valid(self.clock.now()):
            raise SessionError(FailureCause.DEADLINE_EXPIRY,
                               f"QoS lease {lease_id} expired before COMMIT")
        lease.confirmed = True
        lease.expires_at = self.clock.now() + lease_s

    def renew(self, lease_id: str, lease_s: float) -> bool:
        lease = self._leases.get(lease_id)
        if lease is None or not lease.valid(self.clock.now()):
            return False
        lease.expires_at = self.clock.now() + lease_s
        return True

    def release(self, lease_id: str) -> None:
        self._leases.pop(lease_id, None)  # idempotent

    def lease_valid(self, lease_id: str) -> bool:
        lease = self._leases.get(lease_id)
        return bool(lease and lease.valid(self.clock.now()))

    def get(self, lease_id: str) -> Optional[QoSLease]:
        return self._leases.get(lease_id)
