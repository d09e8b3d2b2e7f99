"""netfault: deterministic unreliable-transport layer + the machinery that
makes the control plane correct under at-least-once delivery.

* :mod:`repro_torch.netfault.wire` — seeded per-link fault injection
  (:class:`FaultPlan` / :class:`LossyChannel`) over the VirtualClock.
* :mod:`repro_torch.netfault.retry` — budget-aware capped-backoff
  :class:`RetryPolicy` keyed off the FailureCause remediation classes.
* :mod:`repro_torch.netfault.breaker` — per-site/per-domain
  :class:`CircuitBreaker` / :class:`BreakerBoard` (closed → open →
  half-open) consulted by DISCOVER/PAGING/solicitation.
* :mod:`repro_torch.netfault.reaper` — :class:`OrphanReaper`, the heartbeat-
  cadence sweep that enforces τ_prep/τ_com/hold on provisional leases.
"""

from repro_torch.netfault.breaker import (CLOSED, HALF_OPEN, OPEN, BreakerBoard,
                                    CircuitBreaker)
from repro_torch.netfault.reaper import OrphanReaper, attach
from repro_torch.netfault.retry import RetryPolicy
from repro_torch.netfault.wire import (BOTH, REQUEST, RESPONSE, FaultPlan,
                                 LossyChannel, TransportError,
                                 TransportTimeout)

__all__ = [
    "FaultPlan", "LossyChannel", "TransportError", "TransportTimeout",
    "REQUEST", "RESPONSE", "BOTH",
    "RetryPolicy",
    "CircuitBreaker", "BreakerBoard", "CLOSED", "OPEN", "HALF_OPEN",
    "OrphanReaper", "attach",
]
