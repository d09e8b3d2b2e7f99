"""East-west (inter-domain) wire protocol — the federation counterpart of
:mod:`repro_torch.api.messages`.

Where the northbound protocol exposes the AIS lifecycle to *invokers*, this
protocol exposes it between *administrative domains* (operators): DISCOVER
solicitation with per-domain SLA budgets, the visited half of a cross-domain
PREPARE/COMMIT/ABORT, lease renewal, and release. Every type is a flat
dataclass with JSON-native fields and the same round-trip invariant as the
northbound wire::

    m == from_json(m.to_json())        for every east-west message m

**SLA budget decomposition.** A home domain never forwards the raw ASP
objectives: it splits each latency bound between the *home transport share*
(the access + inter-domain transit leg it keeps) and the *visited execution
share* (what the visited domain must meet end-to-end on its own leg), and
splits the cost envelope between the home (transit/retail) share and the
visited (execution/wholesale) share::

    ℓ_visited = ℓ − t_home          for ℓ ∈ {ℓ_TTFB, ℓ_0.95, ℓ_0.99, T_max}
    γ_visited = γ · (1 − c_home)

A decomposition with any non-positive visited share is *infeasible before
solicitation* and maps to ``NO_FEASIBLE_BINDING`` (Eq. 12) — the visited
domain is never asked to promise what the transit budget already consumed.

**Error semantics.** Visited-side ``SessionError``s cross the boundary as
:class:`EWError` carrying the Eq. (12) cause code from the northbound
``ERROR_CODE_TABLE`` — the home domain re-raises them as the *same* cause,
so an inter-domain failure is diagnosable with the single-domain taxonomy.
Protocol-layer refusals (schema mismatch, unknown ref, internal) use
disjoint ``E_EW_*`` codes, mirroring the northbound gateway codes.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import ClassVar, Dict, List, Optional

from repro_torch.api.messages import cause_for_code, code_for_cause
from repro_torch.core.failures import FailureCause, SessionError

#: wire-schema version of the east-west protocol; majors must match between
#: peered domains (minor additions are backward-compatible)
#: 1.1: + deadline_ms budgets (DiscoverQuery/EWPrepare/EWCommit) and
#:      EWPrepare.prepare_key at-least-once idempotency
EW_SCHEMA_VERSION = "1.1"

#: protocol-layer codes with no Eq. (12) counterpart (the request never
#: reached the visited domain's lifecycle machinery)
EW_PROTOCOL_CODES = ("E_EW_SCHEMA", "E_EW_BAD_REQUEST", "E_EW_UNKNOWN_REF",
                     "E_EW_INTERNAL")

_REGISTRY: Dict[str, type] = {}


class EWTimeout(Exception):
    """An east-west exchange did not complete within the solicitation
    window. Raised by transports; the home domain maps it to an
    ``offer-timeout`` exclusion (DISCOVER) or ``DEADLINE_EXPIRY``
    (PREPARE/COMMIT, where provisional state must be rolled back)."""


def _registered(cls):
    _REGISTRY[cls.TYPE] = cls
    return cls


@dataclass
class EWMessage:
    """Base: a typed east-west message with a version envelope."""

    TYPE: ClassVar[str] = ""

    def to_wire(self) -> dict:
        out = {"type": self.TYPE}
        for f in dataclasses.fields(self):
            out[f.name] = getattr(self, f.name)
        return out

    def to_json(self) -> str:
        return json.dumps(self.to_wire(), sort_keys=True)

    @classmethod
    def _decode(cls, kw: dict) -> "EWMessage":
        # minor-version forward compatibility, same as the northbound wire
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in kw.items() if k in names})


def from_wire(d: dict) -> EWMessage:
    if not isinstance(d, dict):
        raise ValueError(
            f"east-west frame must be a JSON object, got {type(d).__name__}")
    kind = d.get("type")
    cls = _REGISTRY.get(kind)
    if cls is None:
        raise ValueError(f"unknown east-west message type {kind!r}")
    return cls._decode({k: v for k, v in d.items() if k != "type"})


def from_json(s: str) -> EWMessage:
    return from_wire(json.loads(s))


def message_types() -> Dict[str, type]:
    """The full east-west registry (exhaustiveness tests + README table)."""
    return dict(_REGISTRY)


# ----------------------------------------------------------------------
# SLA budget decomposition — shared with split placement; the canonical
# implementation lives in repro_torch.core.budget and is re-exported here so
# the east-west wire surface is unchanged.
# ----------------------------------------------------------------------
from repro_torch.core.budget import (SLABudget, apply_budget,  # noqa: E402,F401
                               decompose_budget, decompose_tiers)


# ----------------------------------------------------------------------
# DISCOVER solicitation
# ----------------------------------------------------------------------
@_registered
@dataclass
class DiscoverQuery(EWMessage):
    """Home → visited: solicit offers for one ASP under a decomposed
    budget. The visited domain answers with its OWN annotated candidate
    set evaluated against the visited execution share."""
    TYPE: ClassVar[str] = "ew_discover_query"
    home_domain: str
    query_id: str
    zone: str
    asp: dict                    # ASP.to_wire()
    budget: dict                 # SLABudget.to_wire()
    #: remaining end-to-end establishment budget at the visited ingress
    #: (the home already subtracted its transit estimate); None = unbounded
    deadline_ms: Optional[float] = None
    schema_version: str = EW_SCHEMA_VERSION


@_registered
@dataclass
class DiscoverOffer(EWMessage):
    """Visited → home: annotated candidates under the visited budget.

    Each entry is {model_id, model_version, site_id, region, klass,
    admissible, slack, exclusion_reason, prediction} — *predicted boundary
    quantities* of a concrete offer, never raw site state (lease tables,
    queue contents, per-session occupancy stay behind the boundary)."""
    TYPE: ClassVar[str] = "ew_discover_offer"
    visited_domain: str
    query_id: str
    candidates: List[dict] = field(default_factory=list)
    digest_epoch: int = 0
    at_s: float = 0.0
    schema_version: str = EW_SCHEMA_VERSION


# ----------------------------------------------------------------------
# cross-domain 2PC: the visited half of PREPARE/COMMIT/ABORT
# ----------------------------------------------------------------------
@_registered
@dataclass
class EWPrepare(EWMessage):
    """Home → visited: provisional co-reservation on the visited planes.
    ``hold_s`` keeps the provisional leases committable past τ_com — the
    home COMMIT (or a roaming migration's τ_mig window) arrives later."""
    TYPE: ClassVar[str] = "ew_prepare"
    home_domain: str
    session_ref: str             # home session id — the roaming anchor key
    model_id: str
    model_version: str
    site_id: str                 # visited-local site id (unqualified)
    klass: str
    zone: str
    slots: int = 1
    context_tokens: int = 2048   # sizes the visited cache reservation
    hold_s: float = 0.0
    budget: dict = field(default_factory=dict)
    #: at-least-once idempotency: a re-sent PREPARE with the same key
    #: returns the original EWPrepared instead of double-reserving
    prepare_key: Optional[str] = None
    deadline_ms: Optional[float] = None
    schema_version: str = EW_SCHEMA_VERSION


@_registered
@dataclass
class EWPrepared(EWMessage):
    TYPE: ClassVar[str] = "ew_prepared"
    visited_domain: str
    session_ref: str
    prepared_ref: str            # the handle every later 2PC verb names
    site_id: str
    qfi: int
    cache_bytes: float = 0.0     # visited-computed reservation size
    expires_at: float = 0.0      # provisional-lease horizon (visited clock)
    schema_version: str = EW_SCHEMA_VERSION


@_registered
@dataclass
class EWCommit(EWMessage):
    """Home → visited: confirm the provisional leases. Idempotent — a
    duplicate COMMIT for the same ``prepared_ref`` returns the original
    response and reserves nothing twice."""
    TYPE: ClassVar[str] = "ew_commit"
    home_domain: str
    session_ref: str
    prepared_ref: str
    deadline_ms: Optional[float] = None
    schema_version: str = EW_SCHEMA_VERSION


@_registered
@dataclass
class EWCommitted(EWMessage):
    TYPE: ClassVar[str] = "ew_committed"
    visited_domain: str
    session_ref: str
    prepared_ref: str
    site_id: str
    endpoint: str
    qfi: int
    compute_lease_id: str
    qos_lease_id: str
    charging_ref: str            # visited wholesale charging (opened HERE,
    lease_s: float = 0.0         # never at PREPARE)
    #: visited retail price; None (unstated) is distinct from a free tier's
    #: legitimate 0.0 — the home falls back to the offer price only for None
    price_per_1k: Optional[float] = None
    at_s: float = 0.0
    schema_version: str = EW_SCHEMA_VERSION


@_registered
@dataclass
class EWAbort(EWMessage):
    """Home → visited: roll back a provisional PREPARE. Idempotent; an
    abort after COMMIT degenerates to release (leases freed, charging
    closed), so a crashed home coordinator can always re-drive the visited
    domain to a clean state."""
    TYPE: ClassVar[str] = "ew_abort"
    home_domain: str
    session_ref: str
    prepared_ref: str
    reason: str = ""
    schema_version: str = EW_SCHEMA_VERSION


@_registered
@dataclass
class EWAbortAck(EWMessage):
    TYPE: ClassVar[str] = "ew_abort_ack"
    visited_domain: str
    prepared_ref: str
    released: bool = False       # False ⇒ the ref was already clean
    schema_version: str = EW_SCHEMA_VERSION


# ----------------------------------------------------------------------
# continuity + teardown for committed roaming sessions
# ----------------------------------------------------------------------
@_registered
@dataclass
class EWRenew(EWMessage):
    """Home heartbeat fan-out: renew BOTH visited leases (compute + QoS)
    atomically, mirroring the single-domain ``AISession.renew``."""
    TYPE: ClassVar[str] = "ew_renew"
    home_domain: str
    prepared_ref: str
    lease_s: float
    schema_version: str = EW_SCHEMA_VERSION


@_registered
@dataclass
class EWRenewAck(EWMessage):
    TYPE: ClassVar[str] = "ew_renew_ack"
    visited_domain: str
    prepared_ref: str
    renewed: bool = False
    schema_version: str = EW_SCHEMA_VERSION


@_registered
@dataclass
class EWRelease(EWMessage):
    TYPE: ClassVar[str] = "ew_release"
    home_domain: str
    prepared_ref: str
    schema_version: str = EW_SCHEMA_VERSION


@_registered
@dataclass
class EWReleaseAck(EWMessage):
    """Final visited-side accounting for the settled roaming leg."""
    TYPE: ClassVar[str] = "ew_release_ack"
    visited_domain: str
    prepared_ref: str
    released: bool = False
    tokens: int = 0
    cost: float = 0.0
    schema_version: str = EW_SCHEMA_VERSION


# ----------------------------------------------------------------------
# structured errors
# ----------------------------------------------------------------------
@_registered
@dataclass
class EWError(EWMessage):
    TYPE: ClassVar[str] = "ew_error"
    visited_domain: str
    code: str
    cause: Optional[str] = None      # FailureCause.value, when applicable
    detail: str = ""
    schema_version: str = EW_SCHEMA_VERSION

    @classmethod
    def from_session_error(cls, domain: str, e: SessionError) -> "EWError":
        return cls(visited_domain=domain, code=code_for_cause(e.cause),
                   cause=e.cause.value, detail=e.detail or str(e))

    def to_session_error(self, *, fallback: FailureCause =
                         FailureCause.POLICY_DENIAL) -> SessionError:
        """Re-raise an inter-domain failure under the Eq. (12) taxonomy:
        lifecycle causes round-trip exactly; protocol-layer refusals map to
        the fallback cause (the visited domain refused to participate)."""
        cause = cause_for_code(self.code) or fallback
        return SessionError(cause, f"[{self.visited_domain}] {self.detail}")
