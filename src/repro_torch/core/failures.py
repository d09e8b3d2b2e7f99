"""Failure semantics: Eq. (12) cause partition + Eq. (11) deadline ordering.

The cause set extends the paper's nine-element partition with the two causes
an *unreliable control plane* forces into the contract: at-least-once
transports fail (TRANSPORT_FAILURE) and budgets shrink hop by hop until work
becomes infeasible (DEADLINE_EXCEEDED).  Each element implies a distinct
remediation path and must not be conflated with others; RETRYABLE partitions
the set into the causes a caller may retry against the same contract versus
those that require a changed request.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass


class FailureCause(enum.Enum):
    """Eq. (12): the compact semantic partition sufficient for diagnosis.

    The first nine members are the paper's partition verbatim; the last two
    are the unreliable-transport extension (lost/failed delivery, and a
    propagated deadline budget that no hop could meet).
    """
    CONSENT_VIOLATION = "consent violation"
    POLICY_DENIAL = "policy denial"
    SOVEREIGNTY_VIOLATION = "sovereignty violation"
    MODEL_UNAVAILABLE = "model unavailable"
    NO_FEASIBLE_BINDING = "no feasible binding"
    COMPUTE_SCARCITY = "compute scarcity"
    QOS_SCARCITY = "QoS scarcity"
    STATE_TRANSFER_FAILURE = "state transfer failure"
    DEADLINE_EXPIRY = "deadline expiry"
    TRANSPORT_FAILURE = "transport failure"
    DEADLINE_EXCEEDED = "deadline exceeded"


#: remediation class per cause — used by the orchestrator's retry logic and
#: asserted distinct in tests (causes must not be conflated).
REMEDIATION = {
    FailureCause.CONSENT_VIOLATION: "re-acquire resource-owner authorization",
    FailureCause.POLICY_DENIAL: "revise ASP cost envelope / tier",
    FailureCause.SOVEREIGNTY_VIOLATION: "restrict discovery to allowed regions",
    FailureCause.MODEL_UNAVAILABLE: "fall back along the ASP ladder",
    FailureCause.NO_FEASIBLE_BINDING: "relax objectives or widen fallback ladder",
    FailureCause.COMPUTE_SCARCITY: "retry with backoff on alternate anchor",
    FailureCause.QOS_SCARCITY: "retry with best-effort consent or new path",
    FailureCause.STATE_TRANSFER_FAILURE: "abort migration, keep source anchor",
    FailureCause.DEADLINE_EXPIRY: "abort phase, roll back provisional leases",
    FailureCause.TRANSPORT_FAILURE:
        "retry same target with backoff (at-least-once delivery)",
    FailureCause.DEADLINE_EXCEEDED:
        "stop retrying; re-issue with a larger deadline budget",
}


#: Causes a caller may retry without changing the request: the contract is
#: intact, only the attempt failed.  Everything else is terminal for the
#: request as issued — retrying verbatim would deterministically fail again
#: (policy/consent/sovereignty) or waste the remaining budget
#: (DEADLINE_EXCEEDED means the budget itself is what ran out).
RETRYABLE = frozenset({
    FailureCause.COMPUTE_SCARCITY,
    FailureCause.QOS_SCARCITY,
    FailureCause.DEADLINE_EXPIRY,
    FailureCause.TRANSPORT_FAILURE,
})


def is_retryable(cause: FailureCause) -> bool:
    """True when a fresh attempt at the same request can still succeed."""
    return cause in RETRYABLE


class SessionError(Exception):
    def __init__(self, cause: FailureCause, detail: str = ""):
        self.cause = cause
        self.detail = detail
        super().__init__(f"{cause.value}: {detail}" if detail else cause.value)


@dataclass(frozen=True)
class Timers:
    """Eq. (11): phase deadlines (seconds).

    Ordering constraint: τ_disc ≤ τ_page ≤ τ_prep ≤ τ_com and
    τ_mig ≤ min(T_max, lease).
    """
    tau_disc: float = 0.05
    tau_page: float = 0.05
    tau_prep: float = 0.20
    tau_com: float = 0.20
    tau_mig: float = 2.0
    lease_s: float = 30.0       # validity lease for both commitments

    def validate(self, t_max_s: float) -> None:
        if not (self.tau_disc <= self.tau_page <= self.tau_prep <= self.tau_com):
            raise ValueError(
                f"Eq.(11) violated: need τ_disc ≤ τ_page ≤ τ_prep ≤ τ_com, "
                f"got {self.tau_disc}, {self.tau_page}, {self.tau_prep}, "
                f"{self.tau_com}")
        if self.tau_mig > min(t_max_s, self.lease_s):
            raise ValueError(
                f"Eq.(11) violated: τ_mig={self.tau_mig} must be ≤ "
                f"min(T_max={t_max_s}, lease={self.lease_s})")
