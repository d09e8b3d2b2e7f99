"""SessionClient — the invoker-side SDK over the northbound wire.

The client NEVER touches orchestrator objects: every interaction is a JSON
message through :meth:`NorthboundGateway.handle_json`, exactly what a remote
ASP would put on the wire. It provides

* context-managed establish → serve → release
  (``with SessionClient(gw, asp=...) as c: ...``),
* a streaming token iterator over ``ServeChunk`` frames,
* automatic lease renewal — a heartbeat fires whenever the server clock
  (read from response timestamps) passes the renewal margin, early by a
  configurable skew allowance so client/server clock drift cannot let a
  lease lapse between "should have renewed" and "renewed",
* at-least-once delivery over an unreliable wire: ``transport=`` accepts
  any ``json-str → json-str`` callable (e.g. a ``netfault.LossyChannel``
  around ``gateway.handle_json``); lost or garbled messages are retried
  with capped exponential backoff + full jitter under the optional
  end-to-end ``deadline_ms`` establishment budget,
* typed exceptions, one per error-code family, so callers can branch on
  remediation (Eq. 12) without string matching.
"""

from __future__ import annotations

import itertools
import uuid
from typing import Callable, Iterator, List, Optional

from repro_torch.api import messages as m
from repro_torch.core.asp import ASP
from repro_torch.core.clock import Clock
from repro_torch.core.failures import FailureCause
from repro_torch.netfault.retry import RetryPolicy
from repro_torch.netfault.wire import TransportError


# ----------------------------------------------------------------------
# typed exceptions
# ----------------------------------------------------------------------
class NorthboundError(Exception):
    """Base: any ErrorResponse surfaced by the gateway."""

    def __init__(self, err: m.ErrorResponse):
        super().__init__(f"{err.code}: {err.detail}")
        self.code = err.code
        self.cause: Optional[FailureCause] = m.cause_for_code(err.code)
        self.detail = err.detail
        self.session_id = err.session_id


class SchemaMismatch(NorthboundError):
    """Protocol or ASP schema version refused (E_SCHEMA_VERSION)."""


class ConsentRevoked(NorthboundError):
    """Eq. (6): serve disabled by consent revocation (E_CONSENT)."""


class PolicyDenied(NorthboundError):
    """Policy / sovereignty / idempotency refusals."""


class ScarcityError(NorthboundError):
    """Compute or QoS scarcity, no feasible binding, model unavailable."""


class DeadlineExpired(NorthboundError):
    """Eq. (11) phase deadline or state-transfer failure."""


class TransportFailure(NorthboundError):
    """Control message lost/garbled in flight (E_TRANSPORT) — retryable."""


class DeadlineExceeded(NorthboundError):
    """End-to-end budget exhausted (E_DEADLINE_EXCEEDED): stop retrying,
    re-issue with a larger ``deadline_ms``."""


class LeaseLapsed(NorthboundError):
    """Auto-renewal ultimately failed (after retries): the session's leases
    may have expired server-side; re-establish rather than keep serving."""


_ERROR_FAMILY = {
    "E_SCHEMA_VERSION": SchemaMismatch,
    "E_CONSENT": ConsentRevoked,
    "E_POLICY": PolicyDenied,
    "E_SOVEREIGNTY": PolicyDenied,
    "E_IDEMPOTENCY_CONFLICT": PolicyDenied,
    "E_MODEL_UNAVAILABLE": ScarcityError,
    "E_NO_FEASIBLE_BINDING": ScarcityError,
    "E_COMPUTE_SCARCITY": ScarcityError,
    "E_QOS_SCARCITY": ScarcityError,
    "E_STATE_TRANSFER": DeadlineExpired,
    "E_DEADLINE": DeadlineExpired,
    "E_TRANSPORT": TransportFailure,
    "E_DEADLINE_EXCEEDED": DeadlineExceeded,
    "E_IDEMPOTENCY_EVICTED": PolicyDenied,
}


def raise_for(err: m.ErrorResponse) -> None:
    raise _ERROR_FAMILY.get(err.code, NorthboundError)(err)


# ----------------------------------------------------------------------
# streaming handle
# ----------------------------------------------------------------------
class TokenStream:
    """Iterator over one streamed generation; ``complete`` holds the final
    ServeComplete after exhaustion (timings, queue wait, error code)."""

    def __init__(self, frames: List[m.Message]):
        self._frames = frames
        self.complete: Optional[m.ServeComplete] = None

    def __iter__(self) -> Iterator[m.ServeChunk]:
        for frame in self._frames:
            if isinstance(frame, m.ErrorResponse):
                raise_for(frame)
            if isinstance(frame, m.ServeComplete):
                self.complete = frame
                if frame.error_code is not None:
                    raise_for(m.ErrorResponse(
                        code=frame.error_code,
                        detail="request served-and-failed",
                        session_id=frame.session_id))
                return
            yield frame

    def tokens(self) -> List[Optional[int]]:
        """Drain the stream, returning the token ids (None when the backend
        is simulated and produces counts, not ids)."""
        return [c.token_id for c in self]


# ----------------------------------------------------------------------
# the SDK handle
# ----------------------------------------------------------------------
class SessionClient:
    """One AI Session as the invoker sees it, over the JSON wire."""

    def __init__(self, gateway, asp: ASP, *, invoker: str = "ue-0",
                 zone: str = "zone-a", subscribe_events: bool = True,
                 auto_renew: bool = True, renew_margin: float = 0.5,
                 transport: Optional[Callable[[str], object]] = None,
                 clock: Optional[Clock] = None,
                 retry: Optional[RetryPolicy] = None,
                 deadline_ms: Optional[float] = None,
                 renew_skew_s: float = 0.5):
        self._gw = gateway
        #: the wire: any json-str → json-str(s) callable. Defaults to the
        #: gateway's own handler; tests/simulations wrap it in a
        #: ``netfault.LossyChannel`` to inject drops/delays/duplicates.
        self._transport = transport if transport is not None \
            else gateway.handle_json
        self._clock = clock if clock is not None else \
            getattr(getattr(gateway, "orch", None), "clock", None) or Clock()
        self._retry = retry if retry is not None else RetryPolicy()
        self.deadline_ms = deadline_ms
        self._deadline_at: Optional[float] = None  # live establish budget
        self.asp = asp
        self.invoker = invoker
        self.zone = zone
        self.auto_renew = auto_renew
        self.renew_margin = renew_margin
        #: renew this many seconds EARLY: tolerated client/server clock skew
        #: plus one retry storm must fit before the lease actually expires
        self.renew_skew_s = renew_skew_s
        self.session_id: Optional[str] = None
        self.record: dict = {}
        self.candidates: List[dict] = []
        self.anchor: Optional[str] = None
        self._lease_s = 0.0
        self._renewed_at = 0.0       # server clock of last confirm/renew
        self._now = 0.0              # latest server clock seen in responses
        self._reqs = itertools.count(1)
        if subscribe_events:
            gateway.subscribe(invoker)

    # -- wire plumbing ---------------------------------------------------
    def _remaining_s(self) -> Optional[float]:
        if self._deadline_at is None:
            return None
        return max(self._deadline_at - self._clock.now(), 0.0)

    def _rpc(self, msg: m.Message) -> m.Message:
        """At-least-once send: transport losses are retried with jittered
        backoff; each (re)send re-stamps the shrinking ``deadline_ms`` so
        every hop downstream sees the budget that is actually left.
        Idempotency keys on the message make the retries safe."""
        attempt = 0
        while True:
            attempt += 1
            remaining = self._remaining_s()
            if remaining is not None:
                if remaining <= 0.0:
                    raise DeadlineExceeded(m.ErrorResponse(
                        code="E_DEADLINE_EXCEEDED",
                        detail=f"[client] {msg.TYPE}: establishment budget "
                               f"exhausted before send",
                        session_id=self.session_id))
                if hasattr(msg, "deadline_ms"):
                    msg.deadline_ms = remaining * 1e3
            try:
                out = self._transport(msg.to_json())
            except TransportError as err:
                if not self._retry.should_retry(err, attempt,
                                                remaining_s=remaining):
                    raise
                self._clock.sleep(self._retry.backoff_s(attempt, key=msg.TYPE))
                continue
            reply = m.from_json(out) if isinstance(out, str) \
                else [m.from_json(o) for o in out]
            if isinstance(reply, m.ErrorResponse):
                raise_for(reply)
            self._observe_time(reply)
            return reply

    def _observe_time(self, reply) -> None:
        frames = reply if isinstance(reply, list) else [reply]
        for f in frames:
            at = getattr(f, "at_s", 0.0)
            if at:
                self._now = max(self._now, at)

    # -- establishment ---------------------------------------------------
    def _establish_once(self) -> "SessionClient":
        """DISCOVER → PAGE → PREPARE → COMMIT, each its own wire message;
        PREPARE/COMMIT carry idempotency keys so retries are safe."""
        disc = self._rpc(m.DiscoverRequest(
            invoker=self.invoker, zone=self.zone, asp=self.asp))
        self.session_id = disc.session_id
        self.candidates = disc.candidates
        paged = self._rpc(m.PageRequest(session_id=self.session_id))
        self.anchor = paged.site_id
        key = uuid.uuid4().hex
        prep = self._rpc(m.PrepareRequest(
            session_id=self.session_id, idempotency_key=f"prep-{key}"))
        com = self._rpc(m.CommitRequest(
            session_id=self.session_id, prepared_ref=prep.prepared_ref,
            idempotency_key=f"commit-{key}"))
        self.record = com.record
        self._lease_s = com.lease_s
        self._renewed_at = com.at_s
        return self

    def establish(self) -> "SessionClient":
        """Establish under the (optional) end-to-end ``deadline_ms`` budget.

        Transport losses retry in ``_rpc`` (same message, same idempotency
        key); *session-level* retryable failures — scarcity, a tripped
        phase timer — re-run the whole establishment from a fresh DISCOVER,
        because the failed session object is terminal server-side. Each
        retry backs off with full jitter and fits inside whatever budget
        remains; a non-retryable cause (or an exhausted budget) surfaces
        as the typed family exception."""
        if self.deadline_ms is not None:
            self._deadline_at = self._clock.now() + self.deadline_ms / 1e3
        try:
            attempt = 0
            while True:
                attempt += 1
                try:
                    return self._establish_once()
                except NorthboundError as err:
                    if err.cause is None or not self._retry.should_retry(
                            err.cause, attempt,
                            remaining_s=self._remaining_s()):
                        raise
                    self._clock.sleep(
                        self._retry.backoff_s(attempt, key="establish"))
        finally:
            # the budget bounds establishment only — serving and renewal
            # run on the lease clock, not the establish deadline
            self._deadline_at = None

    def __enter__(self) -> "SessionClient":
        return self.establish()

    def __exit__(self, exc_type, exc, tb) -> None:
        try:
            self.release()
        except NorthboundError:
            pass                     # already failed/released server-side

    # -- serving ---------------------------------------------------------
    def _maybe_renew(self) -> None:
        if not self.auto_renew or not self._lease_s:
            return
        # renew early by renew_skew_s: the client only sees the server clock
        # through response timestamps, so its view lags by up to one RTT plus
        # any drift — the skew allowance keeps "late renewal because our
        # clock ran slow" from becoming a lapsed lease
        due = max(self.renew_margin * self._lease_s - self.renew_skew_s, 0.0)
        if self._now - self._renewed_at >= due:
            try:
                self.heartbeat()
            except (TransportError, DeadlineExpired) as err:
                # _rpc already retried with jittered backoff; an ultimate
                # loss here means the lease may expire before the next
                # serve — surface that as its own typed condition instead
                # of a generic transport error mid-generate()
                raise LeaseLapsed(m.ErrorResponse(
                    code="E_DEADLINE",
                    detail=f"[client] lease renewal failed after retries "
                           f"({err}); session may have lapsed server-side",
                    session_id=self.session_id)) from err

    def generate(self, *, prompt_tokens: int = 512, gen_tokens: int = 64,
                 prompt: Optional[List[int]] = None) -> TokenStream:
        """Streaming serve: iterate the returned TokenStream chunk by
        chunk; ``.complete`` carries the boundary timings afterwards."""
        self._maybe_renew()
        frames = self._rpc(m.ServeRequest(
            session_id=self.session_id, prompt_tokens=prompt_tokens,
            gen_tokens=gen_tokens, prompt=prompt, stream=True))
        return TokenStream(frames if isinstance(frames, list) else [frames])

    def submit(self, *, prompt_tokens: int = 512, gen_tokens: int = 64,
               prompt: Optional[List[int]] = None) -> Optional[str]:
        """Async serve: returns the request id, or None when admission
        control rejected the request (bounded-queue planes)."""
        self._maybe_renew()
        ack = self._rpc(m.ServeRequest(
            session_id=self.session_id, prompt_tokens=prompt_tokens,
            gen_tokens=gen_tokens, prompt=prompt, stream=False,
            request_id=f"{self.session_id}/c{next(self._reqs)}"))
        return ack.request_id if ack.accepted else None

    def completions(self) -> List[m.ServeComplete]:
        """Retrieve (and consume) the async completions of this invoker's
        sessions — pairs with ``submit()``."""
        out = self._rpc(m.CompletionPoll(invoker=self.invoker))
        return out if isinstance(out, list) else [out]

    # -- continuity ------------------------------------------------------
    def heartbeat(self, *, trigger_l99: Optional[float] = None,
                  trigger_ttfb: Optional[float] = None) -> m.HeartbeatAck:
        ack = self._rpc(m.HeartbeatReport(
            session_id=self.session_id, trigger_l99=trigger_l99,
            trigger_ttfb=trigger_ttfb))
        if ack.committed:
            self._lease_s = ack.lease_s
            self._renewed_at = ack.at_s
        if ack.migration and ack.migration.get("migrated"):
            self.anchor = ack.migration["to_site"]
        return ack

    def events(self) -> List[m.SessionEvent]:
        """Drain this invoker's event subscription (state transitions,
        migration notifications)."""
        out = self._rpc(m.EventPoll(invoker=self.invoker))
        return out if isinstance(out, list) else [out]

    def compliance(self) -> m.ComplianceReport:
        return self._rpc(m.ComplianceRequest(session_id=self.session_id))

    # -- teardown --------------------------------------------------------
    def release(self) -> m.ReleaseAck:
        ack = self._rpc(m.ReleaseRequest(session_id=self.session_id))
        self._lease_s = 0.0
        return ack
