"""Northbound session API (CAPIF-style exposure, Section VI).

The paper's contract is *network-exposed*: DISCOVER / AI-PAGING /
PREPARE-COMMIT / SERVE / MIGRATION are protocol-grade procedures an
application-service-provider invokes over a versioned wire protocol, not
Python calls on internal objects. This package is that exposure surface:

* :mod:`repro_torch.api.messages` — versioned, JSON-round-trippable message types
  for the full lifecycle plus the structured error partition (every
  ``FailureCause`` has a distinct documented error code);
* :mod:`repro_torch.api.gateway` — :class:`NorthboundGateway`, the single entry
  point wrapping the Orchestrator: schema-version negotiation, idempotent
  PREPARE/COMMIT, per-invoker event subscriptions, streaming serve;
* :mod:`repro_torch.api.client` — :class:`SessionClient`, the invoker-side SDK
  (context-managed establish→serve→release, token streaming, automatic
  lease renewal, typed exceptions).
"""

from repro_torch.api.messages import (  # noqa: F401
    SCHEMA_VERSION, Message, from_json, from_wire,
    DiscoverRequest, DiscoverResponse, PageRequest, PageResponse,
    PrepareRequest, PrepareResponse, CommitRequest, CommitResponse,
    ServeRequest, SubmitAck, ServeChunk, ServeComplete,
    HeartbeatReport, HeartbeatAck, SessionEvent,
    ReleaseRequest, ReleaseAck, ComplianceRequest, ComplianceReport,
    EventPoll, CompletionPoll, ErrorResponse, code_for_cause, cause_for_code,
    ERROR_CODE_TABLE, GATEWAY_CODES)
from repro_torch.api.gateway import NorthboundGateway  # noqa: F401
from repro_torch.api.client import (  # noqa: F401
    SessionClient, TokenStream, NorthboundError, SchemaMismatch,
    ConsentRevoked, ScarcityError, DeadlineExpired, PolicyDenied)
