"""AI Session (AIS) — the paper's lifecycle object (Section III-B).

The binding record stores exactly the identifiers Section III-B lists:
session id, ASP digest, model/version, anchor site, routable endpoint,
QoS-flow handle (QFI) + steering handle, validity lease, authorization/
consent reference, charging reference.

State machine::

    IDLE → DISCOVERED → ANCHORED → PREPARING → PREPARED → COMMITTED
                                                          ↕ (serving)
                                                       MIGRATING
    any → FAILED(cause) / RELEASED

Invariants enforced *by construction*:

* Eq. (4)/(10): ``committed(t) ⟺ v_cmp(t) ∧ v_qos(t)`` — the only path into
  COMMITTED is ``bind()`` which requires both confirmed leases; ``committed``
  re-evaluates lease validity at call time, so an expired lease on either
  side immediately removes the session from the committed domain. Partial
  allocation is not representable: there is no API that stores a single
  confirmed lease on a session.
* Eq. (6): ``¬v_σ(t) ⟹ ServeDisabled(t⁺)`` — ``serve_allowed`` checks the
  consent reference's validity on every call.
"""

from __future__ import annotations

import enum
import itertools
from dataclasses import dataclass, field
from typing import Optional

from repro_torch.core.asp import ASP
from repro_torch.core.clock import Clock
from repro_torch.core.failures import FailureCause, SessionError


class SessionState(enum.Enum):
    IDLE = "idle"
    DISCOVERED = "discovered"
    ANCHORED = "anchored"
    PREPARING = "preparing"
    PREPARED = "prepared"
    COMMITTED = "committed"
    MIGRATING = "migrating"
    RELEASED = "released"
    FAILED = "failed"


_LEGAL = {
    SessionState.IDLE: {SessionState.DISCOVERED, SessionState.FAILED},
    SessionState.DISCOVERED: {SessionState.ANCHORED, SessionState.FAILED},
    SessionState.ANCHORED: {SessionState.PREPARING, SessionState.FAILED},
    SessionState.PREPARING: {SessionState.PREPARED, SessionState.FAILED},
    SessionState.PREPARED: {SessionState.COMMITTED, SessionState.FAILED},
    SessionState.COMMITTED: {SessionState.MIGRATING, SessionState.RELEASED,
                             SessionState.FAILED},
    SessionState.MIGRATING: {SessionState.COMMITTED, SessionState.RELEASED,
                             SessionState.FAILED},
    SessionState.RELEASED: set(),
    SessionState.FAILED: set(),
}


@dataclass
class Binding:
    """One committed (model, anchor, transport) binding with its leases."""
    model_id: str
    model_version: str
    site_id: str
    endpoint: str               # routable service endpoint at the site
    qfi: int
    steering_handle: str
    compute_lease_id: str
    qos_lease_id: str


_ids = itertools.count(1)


class AISession:
    def __init__(self, asp: ASP, invoker: str, zone: str, clock: Clock,
                 *, sites, qos, policy):
        asp.validate()
        self.session_id = f"ais-{next(_ids):06d}"
        self.asp = asp
        self.asp_digest = asp.digest()
        self.invoker = invoker
        self.zone = zone
        self.clock = clock
        self._sites = sites          # site registry (site_id -> ExecutionSite)
        self._qos = qos              # QoSFlowManager
        self._policy = policy        # consent/charging (v_σ)
        self.state = SessionState.IDLE
        self.binding: Optional[Binding] = None
        self.failure: Optional[FailureCause] = None
        self.authz_ref: Optional[str] = None
        self.charging_ref: Optional[str] = None
        self.history: list = []      # (t, state) audit trail
        #: served context length (prompt + generated tokens across requests);
        #: sizes the migration payload and PREPARE cache reservation
        self.context_tokens: int = 0
        #: absolute (clock.now()-domain) establishment deadline, set when a
        #: request carried a shrinking ``deadline_ms`` budget; None = no
        #: enforcement. Later hops reject work they cannot finish by this.
        self.deadline_at: Optional[float] = None

    # ------------------------------------------------------------------
    # state machine
    # ------------------------------------------------------------------
    def _to(self, new: SessionState) -> None:
        if new not in _LEGAL[self.state]:
            raise SessionError(
                FailureCause.POLICY_DENIAL,
                f"illegal transition {self.state.value} → {new.value}")
        self.state = new
        self.history.append((self.clock.now(), new.value))

    def mark_discovered(self):
        self._to(SessionState.DISCOVERED)

    def mark_anchored(self):
        self._to(SessionState.ANCHORED)

    def mark_preparing(self):
        self._to(SessionState.PREPARING)

    def mark_prepared(self):
        self._to(SessionState.PREPARED)

    def mark_migrating(self):
        self._to(SessionState.MIGRATING)

    def note_context(self, tokens: int) -> None:
        """Account served tokens (prompt + generated) into the session's
        context length — the actual migration payload size (not a constant)."""
        self.context_tokens += max(int(tokens), 0)

    def fail(self, cause: FailureCause, detail: str = "") -> None:
        # release any leases this session still references (idempotent)
        if self.binding:
            self._release_binding(self.binding)
            self.binding = None
        self.failure = cause
        self.state = SessionState.FAILED
        self.history.append((self.clock.now(), f"failed:{cause.value}"))

    # ------------------------------------------------------------------
    # commitment coupling — Eq. (4)/(10)
    # ------------------------------------------------------------------
    def bind(self, binding: Binding) -> None:
        """The ONLY path into COMMITTED. Requires both leases confirmed and
        currently valid — checked against the resource planes, not cached."""
        site = self._sites[binding.site_id]
        if not site.lease_valid(binding.compute_lease_id):
            raise SessionError(FailureCause.DEADLINE_EXPIRY,
                               "compute lease invalid at bind()")
        if not self._qos.lease_valid(binding.qos_lease_id):
            raise SessionError(FailureCause.DEADLINE_EXPIRY,
                               "QoS lease invalid at bind()")
        old = self.binding
        self.binding = binding
        if self.state == SessionState.MIGRATING:
            # make-before-break: release the OLD binding only after the new
            # one is committed (continuity without contract gaps)
            self._to(SessionState.COMMITTED)
            if old is not None:
                self._release_binding(old)
        else:
            self._to(SessionState.COMMITTED)

    def v_cmp(self, now: Optional[float] = None) -> bool:
        if self.binding is None:
            return False
        return self._sites[self.binding.site_id].lease_valid(
            self.binding.compute_lease_id)

    def v_qos(self, now: Optional[float] = None) -> bool:
        if self.binding is None:
            return False
        return self._qos.lease_valid(self.binding.qos_lease_id)

    def v_sigma(self) -> bool:
        """Authorization/consent scope validity (Eq. 6)."""
        return self._policy.consent_valid(self.authz_ref)

    def committed(self) -> bool:
        """Eq. (4)/(10): Committed(t) ⟺ v_cmp(t) ∧ v_qos(t)."""
        return (self.state in (SessionState.COMMITTED, SessionState.MIGRATING)
                and self.v_cmp() and self.v_qos())

    def serve_allowed(self) -> bool:
        """Eq. (6): revocation disables service regardless of resources."""
        return self.committed() and self.v_sigma()

    def renew(self, lease_s: float) -> bool:
        """Heartbeat: extend both leases atomically (both or neither)."""
        if self.binding is None:
            return False
        site = self._sites[self.binding.site_id]
        if not (site.lease_valid(self.binding.compute_lease_id)
                and self._qos.lease_valid(self.binding.qos_lease_id)):
            return False
        ok1 = site.renew(self.binding.compute_lease_id, lease_s)
        ok2 = self._qos.renew(self.binding.qos_lease_id, lease_s)
        return ok1 and ok2

    # ------------------------------------------------------------------
    # teardown
    # ------------------------------------------------------------------
    def _release_binding(self, b: Binding) -> None:
        self._sites[b.site_id].release(b.compute_lease_id)
        self._qos.release(b.qos_lease_id)

    def release(self) -> None:
        if self.binding:
            self._release_binding(self.binding)
            self.binding = None
        self._to(SessionState.RELEASED)

    # ------------------------------------------------------------------
    def record(self) -> dict:
        """The auditable binding record (Section III-B)."""
        b = self.binding
        return {
            "session_id": self.session_id,
            "asp_digest": self.asp_digest,
            "state": self.state.value,
            "model": f"{b.model_id}@{b.model_version}" if b else None,
            "anchor": b.site_id if b else None,
            "endpoint": b.endpoint if b else None,
            "qfi": b.qfi if b else None,
            "steering": b.steering_handle if b else None,
            "authz_ref": self.authz_ref,
            "charging_ref": self.charging_ref,
            "failure": self.failure.value if self.failure else None,
        }
