"""Host-memory hibernation tier for idle session state.

A bound AI Session whose lease is idle costs no device memory: the engine
exports its slot state (the same canonical payload make-before-break
migration moves — see ``repro_torch.serving.state_transfer``), parks the
bytes here as host (CPU) tensors under the payload's fingerprint, and frees
the slot and its KV pages. The next ``serve()`` re-imports transparently.

Every restore re-fingerprints the stored payload before handing it back, so
host-side corruption surfaces as the same IOError the migration wire check
raises, never as silently wrong tokens.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

from repro_torch.bridge import to_torch, tree_map
from repro_torch.serving import state_transfer


def _to_host(payload) -> dict:
    """Deep-copy a slot payload to host tensors (device buffers must not be
    pinned by the store — freeing the pages is the whole point). CPU
    tensors keep bf16 as it is, so the bytes — and the fingerprint — are
    the device payload's."""
    return {"cache": tree_map(lambda l: to_torch(l, "cpu").clone(),
                              payload["cache"]),
            "position": int(payload["position"]),
            "last_token": int(payload["last_token"]),
            "adapter_id": str(payload.get("adapter_id", ""))}


@dataclass
class HibernationRecord:
    payload: dict                 # host slot payload
    fingerprint: str              # sha256 over cache leaves + position
    nbytes: int
    position: int
    hibernated_at: float = 0.0    # store clock; TTL policy lives in callers


class HibernationStore:
    """Host-memory session-state store keyed by session id."""

    def __init__(self, capacity_bytes: Optional[int] = None):
        self.capacity_bytes = capacity_bytes
        self._records: Dict[str, HibernationRecord] = {}
        self.puts = 0
        self.restores = 0
        self.verify_failures = 0
        #: refused puts on a capacity-bounded store — the heartbeat tick
        #: reads this through PlaneLoad as back-pressure, never as a crash
        self.store_full = 0

    # ------------------------------------------------------------------
    def put(self, session_id: str, payload, *, now: float = 0.0
            ) -> HibernationRecord:
        host = _to_host(payload)
        nbytes = state_transfer.payload_bytes(host)
        if self.capacity_bytes is not None:
            held = self.bytes() - (self._records[session_id].nbytes
                                   if session_id in self._records else 0)
            if held + nbytes > self.capacity_bytes:
                self.store_full += 1
                raise MemoryError(
                    f"hibernation store full: {held + nbytes} > "
                    f"{self.capacity_bytes} bytes for {session_id}")
        rec = HibernationRecord(host, state_transfer.fingerprint(host),
                                nbytes, host["position"], now)
        self._records[session_id] = rec
        self.puts += 1
        return rec

    def restore(self, session_id: str) -> dict:
        """Verified copy of the stored payload. The record stays until the
        caller ``drop``s it — resume must not lose the only copy when the
        re-import is refused (no slot / no pages)."""
        rec = self._records[session_id]
        fp = state_transfer.fingerprint(rec.payload)
        if fp != rec.fingerprint:
            self.verify_failures += 1
            raise IOError(f"hibernated state corruption for {session_id}: "
                          f"{rec.fingerprint} != {fp}")
        self.restores += 1
        return _to_host(rec.payload)

    def drop(self, session_id: str) -> bool:
        return self._records.pop(session_id, None) is not None

    # ------------------------------------------------------------------
    def has(self, session_id: str) -> bool:
        return session_id in self._records

    def record(self, session_id: str) -> Optional[HibernationRecord]:
        return self._records.get(session_id)

    def sessions(self):
        return list(self._records)

    def bytes(self) -> int:
        return sum(r.nbytes for r in self._records.values())

    def __len__(self) -> int:
        return len(self._records)
