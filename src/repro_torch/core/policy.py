"""Policy role (PCC-style): consent/authorization scope (R7), session-scoped
charging (R8), cost-envelope admission, and A1-style steering constraints.

Consent (resource-owner authorization, CAPIF RNAA direction): an authz grant
names the invoker, the data classes the session may process, and the regions
processing may occur in. Revocation takes effect immediately — the session's
``serve_allowed`` consults this registry on every call (Eq. 6).

Charging: every served request is metered against the session's charging
reference, giving deterministic attribution (R8) and enforcement of the ASP
cost envelope.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

from repro_torch.core.asp import ASP
from repro_torch.core.clock import Clock
from repro_torch.core.failures import FailureCause, SessionError


@dataclass
class ConsentGrant:
    authz_ref: str
    invoker: str
    allowed_regions: Tuple[str, ...]
    data_classes: Tuple[str, ...] = ("prompt", "generated")
    revoked: bool = False
    #: absolute lapse time (clock domain of PolicyControl). Consent is a
    #: *bounded* authorization: a grant that outlives its TTL lapses
    #: exactly like a revocation — the serve path's Eq. (6) re-check maps
    #: it to CONSENT_VIOLATION mid-session.
    expires_at: float = float("inf")

    def valid(self, now: float) -> bool:
        return not self.revoked and now < self.expires_at


@dataclass
class ChargingRecord:
    charging_ref: str
    session_id: str
    tokens: int = 0
    chip_s: float = 0.0
    cost: float = 0.0
    events: list = field(default_factory=list)


class PolicyControl:
    #: default consent TTL (seconds) — every grant is clock-bounded unless
    #: the caller passes an explicit ttl_s
    DEFAULT_CONSENT_TTL_S = 3600.0

    def __init__(self, clock: Clock, *,
                 consent_ttl_s: Optional[float] = None):
        self.clock = clock
        self.consent_ttl_s = consent_ttl_s if consent_ttl_s is not None \
            else self.DEFAULT_CONSENT_TTL_S
        self._grants: Dict[str, ConsentGrant] = {}
        self._charges: Dict[str, ChargingRecord] = {}
        self._ids = itertools.count(1)

    # -- consent (v_σ) ----------------------------------------------------
    def grant_consent(self, invoker: str, regions: Tuple[str, ...],
                      ttl_s: Optional[float] = None) -> str:
        ref = f"authz-{next(self._ids):06d}"
        ttl = ttl_s if ttl_s is not None else self.consent_ttl_s
        self._grants[ref] = ConsentGrant(
            ref, invoker, tuple(regions),
            expires_at=self.clock.now() + ttl)
        return ref

    def revoke(self, authz_ref: str) -> None:
        g = self._grants.get(authz_ref)
        if g:
            g.revoked = True

    def renew_consent(self, authz_ref: str,
                      ttl_s: Optional[float] = None) -> bool:
        """Re-authorize (extend) a live grant; a revoked or lapsed grant
        cannot be renewed — the invoker must re-acquire authorization."""
        g = self._grants.get(authz_ref)
        if g is None or not g.valid(self.clock.now()):
            return False
        g.expires_at = self.clock.now() + \
            (ttl_s if ttl_s is not None else self.consent_ttl_s)
        return True

    def consent_valid(self, authz_ref: Optional[str]) -> bool:
        if authz_ref is None:
            return False
        g = self._grants.get(authz_ref)
        return bool(g and g.valid(self.clock.now()))

    def check_region(self, authz_ref: str, region: str) -> None:
        g = self._grants.get(authz_ref)
        if g is None or not g.valid(self.clock.now()):
            raise SessionError(FailureCause.CONSENT_VIOLATION,
                               "no valid consent grant")
        if region not in g.allowed_regions:
            raise SessionError(
                FailureCause.SOVEREIGNTY_VIOLATION,
                f"region {region!r} outside consented scope {g.allowed_regions}")

    # -- admission policy ------------------------------------------------
    def admit_cost(self, asp: ASP, predicted_cost_per_1k: float) -> None:
        if predicted_cost_per_1k > asp.max_cost_per_1k_tokens:
            raise SessionError(
                FailureCause.POLICY_DENIAL,
                f"predicted cost {predicted_cost_per_1k:.3f}/1k exceeds "
                f"envelope {asp.max_cost_per_1k_tokens:.3f}/1k")

    # -- charging (R8) --------------------------------------------------------
    def open_charging(self, session_id: str) -> str:
        ref = f"chg-{next(self._ids):06d}"
        self._charges[ref] = ChargingRecord(ref, session_id)
        return ref

    def meter(self, charging_ref: str, *, tokens: int, chip_s: float,
              unit_price: float) -> None:
        rec = self._charges.get(charging_ref)
        if rec is None:
            raise SessionError(FailureCause.POLICY_DENIAL,
                               f"unknown charging ref {charging_ref}")
        rec.tokens += tokens
        rec.chip_s += chip_s
        rec.cost += tokens / 1000.0 * unit_price
        rec.events.append((self.clock.now(), tokens, chip_s))

    def charging(self, charging_ref: str) -> ChargingRecord:
        return self._charges[charging_ref]
