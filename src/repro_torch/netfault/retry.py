"""Budget-aware retry engine: capped exponential backoff + full jitter.

Retryability keys off the :data:`repro_torch.core.failures.RETRYABLE` remediation
classes — a :class:`~repro_torch.netfault.wire.TransportError` is always
retryable (the request may never have arrived), a ``SessionError`` only
when its cause is in the retryable partition, and every retry first checks
the remaining deadline budget so a caller never sleeps past its own
deadline (retry amplification is bounded by the budget, not just the
attempt cap).

Backoff draws are deterministic per ``(seed, key, attempt)`` so a fault
schedule replays bit-identically; "full jitter" (uniform in ``[0, cap]``)
is the AWS-style scheme that decorrelates synchronized retry storms.
"""

from __future__ import annotations

import random
import zlib
from dataclasses import dataclass
from typing import Optional, Union

from repro_torch.core.failures import RETRYABLE, FailureCause, SessionError
from repro_torch.netfault.wire import TransportError


@dataclass(frozen=True)
class RetryPolicy:
    """Capped exponential backoff with full jitter and a deadline budget."""
    max_attempts: int = 5
    base_s: float = 0.01
    cap_s: float = 0.5
    seed: int = 0

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        if self.base_s <= 0 or self.cap_s < self.base_s:
            raise ValueError("need 0 < base_s <= cap_s")

    def retryable(self, err: Union[BaseException, FailureCause]) -> bool:
        """Is this failure class worth another attempt at all?"""
        if isinstance(err, FailureCause):
            return err in RETRYABLE
        if isinstance(err, TransportError):
            return True
        if isinstance(err, SessionError):
            return err.cause in RETRYABLE
        return False

    def backoff_s(self, attempt: int, key: str = "") -> float:
        """Jittered sleep before retry ``attempt`` (1-based). Deterministic
        per (seed, key, attempt); crc32 keeps it stable across processes
        (str hash() is salted)."""
        cap = min(self.cap_s, self.base_s * (2 ** max(0, attempt - 1)))
        mix = zlib.crc32(f"{self.seed}:{key}:{attempt}".encode())
        return random.Random(mix).uniform(0.0, cap)

    def should_retry(self, err: Union[BaseException, FailureCause],
                     attempt: int,
                     remaining_s: Optional[float] = None) -> bool:
        """True when attempt ``attempt`` (1-based, just failed) should be
        followed by another; budget-aware — the next backoff must fit in
        the remaining deadline."""
        if not self.retryable(err):
            return False
        if attempt >= self.max_attempts:
            return False
        if remaining_s is not None:
            if remaining_s <= 0:
                return False
            if self.backoff_s(attempt) >= remaining_s:
                return False
        return True
