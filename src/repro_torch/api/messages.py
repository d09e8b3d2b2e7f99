"""Northbound wire protocol: versioned, JSON-round-trippable messages.

Every type here is a flat dataclass whose fields are JSON-native (str, int,
float, bool, None, list, dict) except the embedded :class:`~repro_torch.core.asp.ASP`
intent contract, which carries its own versioned wire codec. The invariant
the property tests pin down is

    m == from_json(m.to_json())        for every message type m

so a message can cross any transport (HTTP body, SBI service operation,
Kafka record) without the two sides disagreeing about its meaning.

Error semantics: :class:`ErrorResponse` carries a structured ``code`` whose
mapping onto the paper's Eq. (12) nine-cause partition is exhaustive and
bijective (``code_for_cause`` / ``cause_for_code``); gateway-level codes
(schema mismatch, unknown session, idempotency conflict, malformed request)
are disjoint from the cause codes by construction.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import ClassVar, Dict, List, Optional

from repro_torch.core.asp import ASP
from repro_torch.core.failures import FailureCause, SessionError

#: wire-schema version of the northbound protocol; majors must match
#: between invoker and gateway (minor additions are backward-compatible).
#: 1.1: federation — candidate entries and PageResponse carry the owning
#: ``domain`` (and candidate ``region``); "" means the home domain.
#: 1.2: tenant adapters — RegisterAdapter/LoadAdapter/UnloadAdapter
#: lifecycle messages; ``ASP.adapter_id`` rides the existing ASP codec.
#: 1.3: unreliable control plane — optional ``deadline_ms`` budget on
#: lifecycle/serve/heartbeat requests (relative milliseconds remaining,
#: gRPC-style, shrinking per hop); new causes TRANSPORT_FAILURE /
#: DEADLINE_EXCEEDED (E_TRANSPORT / E_DEADLINE_EXCEEDED) and gateway code
#: E_IDEMPOTENCY_EVICTED for retries arriving after window eviction.
SCHEMA_VERSION = "1.3"

_REGISTRY: Dict[str, type] = {}


def _registered(cls):
    _REGISTRY[cls.TYPE] = cls
    return cls


@dataclass
class Message:
    """Base: a typed wire message with a version envelope."""

    TYPE: ClassVar[str] = ""

    def to_wire(self) -> dict:
        out = {"type": self.TYPE}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, ASP):
                v = v.to_wire()
            out[f.name] = v
        return out

    def to_json(self) -> str:
        return json.dumps(self.to_wire(), sort_keys=True)

    @classmethod
    def _decode(cls, kw: dict) -> "Message":
        # minor-version forward compatibility: fields added by a newer 1.x
        # peer are ignored, exactly like ASP.from_wire (majors are checked
        # by the gateway envelope negotiation)
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in kw.items() if k in names})


def from_wire(d: dict) -> Message:
    if not isinstance(d, dict):
        raise ValueError(
            f"northbound frame must be a JSON object, got {type(d).__name__}")
    kind = d.get("type")
    cls = _REGISTRY.get(kind)
    if cls is None:
        raise ValueError(f"unknown northbound message type {kind!r}")
    return cls._decode({k: v for k, v in d.items() if k != "type"})


def from_json(s: str) -> Message:
    return from_wire(json.loads(s))


def message_types() -> Dict[str, type]:
    """The full registry (used by the exhaustiveness tests and README)."""
    return dict(_REGISTRY)


# ----------------------------------------------------------------------
# lifecycle: DISCOVER → PAGE → PREPARE → COMMIT
# ----------------------------------------------------------------------
@_registered
@dataclass
class DiscoverRequest(Message):
    TYPE: ClassVar[str] = "discover_request"
    invoker: str
    zone: str
    asp: ASP
    #: remaining deadline budget in ms (relative, gRPC-style — skew-safe);
    #: None = no enforcement (pre-1.3 peers)
    deadline_ms: Optional[float] = None
    schema_version: str = SCHEMA_VERSION

    @classmethod
    def _decode(cls, kw: dict) -> "DiscoverRequest":
        kw = dict(kw)
        if isinstance(kw.get("asp"), dict):
            kw["asp"] = ASP.from_wire(kw["asp"])
        return super()._decode(kw)


@_registered
@dataclass
class DiscoverResponse(Message):
    TYPE: ClassVar[str] = "discover_response"
    session_id: str
    #: annotated candidate set 𝒦 — each entry {model_id, model_version,
    #: site_id, klass, admissible, slack, exclusion_reason, domain,
    #: region}; federated candidates carry domain-qualified site ids and
    #: exclusion reasons prefixed with the owning domain
    candidates: List[dict] = field(default_factory=list)
    schema_version: str = SCHEMA_VERSION


@_registered
@dataclass
class PageRequest(Message):
    TYPE: ClassVar[str] = "page_request"
    session_id: str
    exclude_sites: List[str] = field(default_factory=list)
    deadline_ms: Optional[float] = None
    schema_version: str = SCHEMA_VERSION


@_registered
@dataclass
class PageResponse(Message):
    TYPE: ClassVar[str] = "page_response"
    session_id: str
    model_id: str
    model_version: str
    site_id: str
    klass: str
    predicted_cost_per_1k: float = 0.0
    #: administrative domain of the anchor ("" = the home domain) — the
    #: client contract is otherwise unchanged by federation
    domain: str = ""
    schema_version: str = SCHEMA_VERSION


@_registered
@dataclass
class PrepareRequest(Message):
    TYPE: ClassVar[str] = "prepare_request"
    session_id: str
    #: retry-safety: a repeated PREPARE with the same key returns the
    #: original outcome instead of reserving twice
    idempotency_key: Optional[str] = None
    deadline_ms: Optional[float] = None
    schema_version: str = SCHEMA_VERSION


@_registered
@dataclass
class PrepareResponse(Message):
    TYPE: ClassVar[str] = "prepare_response"
    session_id: str
    prepared_ref: str
    site_id: str
    qfi: int
    schema_version: str = SCHEMA_VERSION


@_registered
@dataclass
class CommitRequest(Message):
    TYPE: ClassVar[str] = "commit_request"
    session_id: str
    prepared_ref: str
    idempotency_key: Optional[str] = None
    deadline_ms: Optional[float] = None
    schema_version: str = SCHEMA_VERSION


@_registered
@dataclass
class CommitResponse(Message):
    TYPE: ClassVar[str] = "commit_response"
    session_id: str
    #: the auditable AIS binding record (Section III-B)
    record: dict = field(default_factory=dict)
    lease_s: float = 0.0
    at_s: float = 0.0            # server clock — drives client auto-renew
    schema_version: str = SCHEMA_VERSION


# ----------------------------------------------------------------------
# serving: unary-streaming and async submit
# ----------------------------------------------------------------------
@_registered
@dataclass
class ServeRequest(Message):
    TYPE: ClassVar[str] = "serve_request"
    session_id: str
    prompt_tokens: int = 512
    gen_tokens: int = 64
    #: explicit prompt token ids (real-engine backends); None = synthetic
    prompt: Optional[List[int]] = None
    #: stream=True → ServeChunk per token then ServeComplete;
    #: stream=False → async enqueue acknowledged by SubmitAck
    stream: bool = True
    request_id: Optional[str] = None
    deadline_ms: Optional[float] = None
    schema_version: str = SCHEMA_VERSION


@_registered
@dataclass
class SubmitAck(Message):
    TYPE: ClassVar[str] = "submit_ack"
    session_id: str
    request_id: Optional[str]
    accepted: bool
    at_s: float = 0.0
    schema_version: str = SCHEMA_VERSION


@_registered
@dataclass
class ServeChunk(Message):
    TYPE: ClassVar[str] = "serve_chunk"
    session_id: str
    request_id: str
    seq: int
    token_id: Optional[int] = None
    schema_version: str = SCHEMA_VERSION


@_registered
@dataclass
class ServeComplete(Message):
    TYPE: ClassVar[str] = "serve_complete"
    session_id: str
    request_id: str
    klass: str = ""
    tokens: int = 0
    prompt_tokens: int = 0
    ttfb_ms: float = 0.0
    latency_ms: float = 0.0
    queue_wait_ms: float = 0.0
    completed: bool = False
    #: Eq. (12) error code when the request was served-and-failed
    error_code: Optional[str] = None
    token_ids: Optional[List[int]] = None
    at_s: float = 0.0
    schema_version: str = SCHEMA_VERSION


# ----------------------------------------------------------------------
# continuity: heartbeat, events, release, compliance
# ----------------------------------------------------------------------
@_registered
@dataclass
class HeartbeatReport(Message):
    TYPE: ClassVar[str] = "heartbeat_report"
    session_id: str
    #: optional Eq. (14) threshold overrides (δ, δ') for this evaluation —
    #: tightening to 0.0 forces a migration check to fire (ops/testing)
    trigger_l99: Optional[float] = None
    trigger_ttfb: Optional[float] = None
    deadline_ms: Optional[float] = None
    schema_version: str = SCHEMA_VERSION


@_registered
@dataclass
class HeartbeatAck(Message):
    TYPE: ClassVar[str] = "heartbeat_ack"
    session_id: str
    committed: bool
    lease_s: float = 0.0
    #: wire form of a MigrationOutcome when the heartbeat triggered one
    migration: Optional[dict] = None
    at_s: float = 0.0
    schema_version: str = SCHEMA_VERSION


@_registered
@dataclass
class SessionEvent(Message):
    """Notification pushed to the invoker's subscription: state transitions
    and migration outcomes (the CAPIF event-exposure direction)."""
    TYPE: ClassVar[str] = "session_event"
    session_id: str
    event: str                   # state-transition | migration
    state: Optional[str] = None
    detail: dict = field(default_factory=dict)
    at_s: float = 0.0
    schema_version: str = SCHEMA_VERSION


@_registered
@dataclass
class EventPoll(Message):
    TYPE: ClassVar[str] = "event_poll"
    invoker: str
    schema_version: str = SCHEMA_VERSION


@_registered
@dataclass
class CompletionPoll(Message):
    """Retrieve the async (``stream=False``) completions for this invoker's
    sessions — the wire counterpart of the in-process ``gateway.drain()``."""
    TYPE: ClassVar[str] = "completion_poll"
    invoker: str
    schema_version: str = SCHEMA_VERSION


@_registered
@dataclass
class ReleaseRequest(Message):
    TYPE: ClassVar[str] = "release_request"
    session_id: str
    schema_version: str = SCHEMA_VERSION


@_registered
@dataclass
class ReleaseAck(Message):
    TYPE: ClassVar[str] = "release_ack"
    session_id: str
    state: str = "released"
    tokens: int = 0
    total_cost: float = 0.0
    schema_version: str = SCHEMA_VERSION


@_registered
@dataclass
class ComplianceRequest(Message):
    TYPE: ClassVar[str] = "compliance_request"
    session_id: str
    schema_version: str = SCHEMA_VERSION


@_registered
@dataclass
class ComplianceReport(Message):
    TYPE: ClassVar[str] = "compliance_report"
    session_id: str
    in_compliance: Optional[bool] = None
    #: boundary snapshot Z(t) (Eq. 5/13) as a flat dict
    z: dict = field(default_factory=dict)
    n: int = 0
    schema_version: str = SCHEMA_VERSION


# ----------------------------------------------------------------------
# tenant adapter lifecycle: register (catalog) / load / unload (engine)
# ----------------------------------------------------------------------
@_registered
@dataclass
class RegisterAdapterRequest(Message):
    """Publish a versioned tenant adapter into the domain catalog. The
    gateway materialises deterministic weights from ``seed`` against the
    base model's d_model (the stand-in for a tenant weight upload) and
    answers with the resulting weight fingerprint — the value migration
    and federation advertisement key on."""
    TYPE: ClassVar[str] = "register_adapter_request"
    adapter_id: str
    base_model_id: str
    version: str = "1.0"
    base_model_version: str = "1.0"
    rank: int = 8
    #: sovereignty tags of the adapter weights themselves
    regions: List[str] = field(default_factory=lambda: ["eu", "us", "apac"])
    scale: float = 1.0
    seed: int = 0
    schema_version: str = SCHEMA_VERSION


@_registered
@dataclass
class RegisterAdapterResponse(Message):
    TYPE: ClassVar[str] = "register_adapter_response"
    adapter_id: str
    version: str
    base_model_id: str = ""
    weight_fingerprint: str = ""
    at_s: float = 0.0
    schema_version: str = SCHEMA_VERSION


@_registered
@dataclass
class LoadAdapterRequest(Message):
    """Make a registered adapter hot at one site. On a real engine this
    installs A/B rows into the device tables; on simulated backends only
    the control-plane residency record advances (discovery admissibility
    is control-plane either way)."""
    TYPE: ClassVar[str] = "load_adapter_request"
    adapter_id: str
    site_id: str
    version: str = ""            # "" = highest registered version
    schema_version: str = SCHEMA_VERSION


@_registered
@dataclass
class LoadAdapterResponse(Message):
    TYPE: ClassVar[str] = "load_adapter_response"
    adapter_id: str
    site_id: str
    loaded: bool = False
    #: True when weights landed in a real engine's device tables (False:
    #: simulated backend — control-plane record only)
    engine_loaded: bool = False
    at_s: float = 0.0
    schema_version: str = SCHEMA_VERSION


@_registered
@dataclass
class UnloadAdapterRequest(Message):
    TYPE: ClassVar[str] = "unload_adapter_request"
    adapter_id: str
    site_id: str
    schema_version: str = SCHEMA_VERSION


@_registered
@dataclass
class UnloadAdapterResponse(Message):
    TYPE: ClassVar[str] = "unload_adapter_response"
    adapter_id: str
    site_id: str
    unloaded: bool = False
    at_s: float = 0.0
    schema_version: str = SCHEMA_VERSION


# ----------------------------------------------------------------------
# structured errors: exhaustive Eq. (12) cause ↔ code mapping
# ----------------------------------------------------------------------
#: the cause partition (paper's nine + the unreliable-transport pair), each
#: with a distinct documented code — remediation per cause lives in
#: repro_torch.core.failures.REMEDIATION, retryability in failures.RETRYABLE
ERROR_CODE_TABLE: Dict[FailureCause, str] = {
    FailureCause.CONSENT_VIOLATION: "E_CONSENT",
    FailureCause.POLICY_DENIAL: "E_POLICY",
    FailureCause.SOVEREIGNTY_VIOLATION: "E_SOVEREIGNTY",
    FailureCause.MODEL_UNAVAILABLE: "E_MODEL_UNAVAILABLE",
    FailureCause.NO_FEASIBLE_BINDING: "E_NO_FEASIBLE_BINDING",
    FailureCause.COMPUTE_SCARCITY: "E_COMPUTE_SCARCITY",
    FailureCause.QOS_SCARCITY: "E_QOS_SCARCITY",
    FailureCause.STATE_TRANSFER_FAILURE: "E_STATE_TRANSFER",
    FailureCause.DEADLINE_EXPIRY: "E_DEADLINE",
    FailureCause.TRANSPORT_FAILURE: "E_TRANSPORT",
    FailureCause.DEADLINE_EXCEEDED: "E_DEADLINE_EXCEEDED",
}

#: gateway-layer failures with no Eq. (12) counterpart (the request never
#: reached the lifecycle machinery)
GATEWAY_CODES = ("E_SCHEMA_VERSION", "E_BAD_REQUEST", "E_UNKNOWN_SESSION",
                 "E_IDEMPOTENCY_CONFLICT", "E_IDEMPOTENCY_EVICTED",
                 "E_INTERNAL")

_CODE_TO_CAUSE = {v: k for k, v in ERROR_CODE_TABLE.items()}


def code_for_cause(cause: FailureCause) -> str:
    return ERROR_CODE_TABLE[cause]


def cause_for_code(code: str) -> Optional[FailureCause]:
    """Inverse mapping; None for gateway-layer codes."""
    return _CODE_TO_CAUSE.get(code)


@_registered
@dataclass
class ErrorResponse(Message):
    TYPE: ClassVar[str] = "error"
    code: str
    cause: Optional[str] = None      # FailureCause.value, when applicable
    detail: str = ""
    session_id: Optional[str] = None
    schema_version: str = SCHEMA_VERSION

    @classmethod
    def from_session_error(cls, e: SessionError,
                           session_id: Optional[str] = None
                           ) -> "ErrorResponse":
        return cls(code=code_for_cause(e.cause), cause=e.cause.value,
                   detail=e.detail or str(e), session_id=session_id)


# ----------------------------------------------------------------------
# MigrationOutcome wire helpers (HeartbeatAck.migration / SessionEvent.detail)
# ----------------------------------------------------------------------
def outcome_to_wire(o) -> dict:
    return {
        "migrated": o.migrated, "aborted": o.aborted,
        "cause": o.cause.value if o.cause else None,
        "from_site": o.from_site, "to_site": o.to_site,
        "interruption_ms": o.interruption_ms,
        "transfer_ms": o.transfer_ms, "transfer_bytes": o.transfer_bytes,
        "fingerprint": o.fingerprint, "mid_stream": o.mid_stream,
    }


def outcome_from_wire(d: dict):
    from repro_torch.core.migration import MigrationOutcome
    return MigrationOutcome(
        migrated=d["migrated"], aborted=d["aborted"],
        cause=FailureCause(d["cause"]) if d["cause"] else None,
        from_site=d["from_site"], to_site=d["to_site"],
        interruption_ms=d["interruption_ms"],
        transfer_ms=d.get("transfer_ms", 0.0),
        transfer_bytes=d.get("transfer_bytes", 0),
        fingerprint=d.get("fingerprint"),
        mid_stream=d.get("mid_stream", False))
