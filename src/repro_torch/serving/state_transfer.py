"""Session-state transfer: the data plane of make-before-break migration.

``transfer(src_backend, dst_backend, session_id)`` exports the slot state on
the source anchor, verifies integrity, and installs it into a destination
slot while the source keeps serving. Only after the destination confirms
does the caller release the source slot (MigrationController drives the
ordering). The destination's ``import_slot`` moves the payload onto its own
device.

Both sides speak the engine slot protocol (``export_slot`` / ``import_slot``
/ ``release_slot``): a raw :class:`~repro_torch.serving.engine.InferenceEngine`,
a plane backend wrapping one (``RealEngineBackend``), or the stateful
``SimulatedEngine`` of the simulation arm.

Failure injection (``TransferInjections``) exposes every stage of the data
plane to tests: export failure, wire corruption (fingerprint mismatch),
import failure, target admission denial, and extra wire time that blows
τ_mig mid-transfer. Import-side failures roll the provisional destination
slot back before propagating, so an abort can never leak target state.
"""

from __future__ import annotations

import hashlib
import time
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.bridge import leaves


class AdmissionDenied(RuntimeError):
    """Target refused the migrated-in session (no free slot / injected
    refusal) — the caller maps this to COMPUTE_SCARCITY, distinct from
    STATE_TRANSFER_FAILURE in the Eq. (12) cause partition."""


@dataclass
class TransferInjections:
    """Plane-level failure-injection points for the migration data plane.

    Attach to ``ServingPlane.migration_inject``: export-side hooks fire on
    the SOURCE plane's injector, import-side hooks on the TARGET plane's.
    """
    #: called with the exported payload; raise to fail the export stage
    on_export: Optional[Callable[[dict], None]] = None
    #: called after the destination installed the payload; raise to fail the
    #: import stage (the provisional destination slot is rolled back)
    on_import: Optional[Callable[[dict], None]] = None
    #: payload -> payload applied "on the wire" (fingerprint corruption)
    corrupt: Optional[Callable[[dict], dict]] = None
    #: target refuses the session outright (admission denial)
    deny_admission: bool = False
    #: extra modeled wire seconds (τ_mig expiry mid-transfer)
    extra_wire_s: float = 0.0


def _raw_bytes(leaf) -> bytes:
    """A leaf's bytes in memory order: torch tensors of any dtype (bf16
    included) hash the same bytes as the reference's arrays of that dtype."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().contiguous().cpu()
        return t.reshape(-1).view(torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(np.asarray(leaf)).tobytes()


def _nbytes(leaf) -> int:
    if isinstance(leaf, torch.Tensor):
        return leaf.numel() * leaf.element_size()
    return int(np.asarray(leaf).nbytes)


def payload_bytes(payload) -> int:
    return int(sum(_nbytes(l) for l in leaves(payload["cache"])))


def fingerprint(payload) -> str:
    h = hashlib.sha256()
    for leaf in leaves(payload["cache"]):
        h.update(_raw_bytes(leaf))
    h.update(str(payload["position"]).encode())
    # adapter identity is part of the session contract: the same cache
    # under a different tenant adapter is a DIFFERENT session state.
    # Absent/empty contributes no bytes.
    h.update(str(payload.get("adapter_id", "")).encode())
    return h.hexdigest()[:16]


def transfer(src_engine, dst_engine, session_id: str, *,
             dst_shardings=None, link_bw: float = 5e9, verify: bool = True,
             fail_injector=None,
             inject: Optional[TransferInjections] = None,
             scrub: Optional[Callable[[dict], dict]] = None,
             clock=None) -> dict:
    """Move one session between engines/backends. Returns transfer metadata.

    ``dst_shardings``: None, or a pair ``(mesh, specs)`` (a ``DeviceMesh``
    and a ``Spec`` tree of the payload's cache, e.g. the decode plan's
    ``cache_plan``): the wire payload's cache is laid out as DTensors on
    that mesh before the import, as the reference ``device_put``s it.
    ``fail_injector``: test hook — callable that may raise after the export
    to exercise the abort path (source must stay intact).
    ``inject``: staged :class:`TransferInjections`.
    ``scrub``: payload -> payload applied at the export boundary, BEFORE
    fingerprinting (roaming migration redacts everything but the
    slot-essential state, so the fingerprint covers exactly what crossed).
    ``clock``: when given, wall time is measured on it.
    """
    _now = clock.now if clock is not None else time.perf_counter
    t0 = _now()
    payload = src_engine.export_slot(session_id)
    if scrub is not None:
        payload = scrub(payload)
    if inject is not None and inject.on_export is not None:
        inject.on_export(payload)
    nbytes = payload_bytes(payload)
    src_fp = fingerprint(payload) if verify else None

    if fail_injector is not None:
        fail_injector(payload)

    wire_payload = payload
    if dst_shardings is not None:
        from repro_torch.sharding.planner import distribute_tree
        mesh, specs = dst_shardings
        wire_payload = dict(payload)
        wire_payload["cache"] = distribute_tree(payload["cache"], specs,
                                                mesh)
    if inject is not None and inject.corrupt is not None:
        wire_payload = inject.corrupt(dict(wire_payload))
    if inject is not None and inject.deny_admission:
        raise AdmissionDenied(
            f"target admission denied: {session_id} refused by injector")

    dst_engine.import_slot(session_id, wire_payload)
    try:
        if inject is not None and inject.on_import is not None:
            inject.on_import(wire_payload)
        if verify:
            dst_payload = dst_engine.export_slot(session_id)
            dst_fp = fingerprint(dst_payload)
            if dst_fp != src_fp:
                raise IOError(
                    f"state transfer corruption: {src_fp} != {dst_fp}")
    except BaseException:
        # provisional destination slot must never survive a failed import
        dst_engine.release_slot(session_id)
        raise
    wall_s = _now() - t0
    extra = inject.extra_wire_s if inject is not None else 0.0
    return {"bytes": nbytes, "wall_s": wall_s,
            "wire_s_at_link": nbytes / link_bw + extra,
            "fingerprint": src_fp}
