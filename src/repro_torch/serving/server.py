"""NE-AIaaS serving front: binds the control plane to real engines at the
execution sites, behind QoS-scheduled serving planes, and exposes them
northbound.

``AIaaSServer`` owns per-(site, model) engines, wraps each in a
:class:`~repro_torch.serving.plane.ServingPlane` attached to the
ExecutionSite — so every serve goes through class-ordered slot admission
with premium reservation and deadline fast-fail — and fronts the whole
deployment with a :class:`~repro_torch.api.gateway.NorthboundGateway`: the
server's own submit / request / drain paths are gateway message flows.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from repro_torch import resolve_device
from repro_torch.api import messages as wire
from repro_torch.api.gateway import NorthboundGateway
from repro_torch.core.catalog import Catalog
from repro_torch.core.orchestrator import Orchestrator
from repro_torch.core.session import AISession
from repro_torch.serving.engine import InferenceEngine
from repro_torch.serving.plane import (RealEngineBackend, ServingPlane,
                                       PlaneResult)


class EngineFleet:
    """Per-site engines for one model. The sites share ONE set of weight
    tensors on the device (at minitron-8b width one copy is ~20 GB in bf16);
    each engine owns only its KV cache."""

    def __init__(self, catalog: Catalog, model_id: str, *, slots: int = 8,
                 max_len: int = 256, device=None, params=None):
        entry = catalog.get(model_id)
        self.entry = entry
        self.cfg = entry.cfg
        self.slots = slots
        self.max_len = max_len
        self.device = resolve_device(device)
        self._engines: Dict[str, InferenceEngine] = {}
        self._params = params

    def engine_for(self, site_id: str) -> InferenceEngine:
        if site_id not in self._engines:
            eng = InferenceEngine(self.cfg, params=self._params,
                                  slots=self.slots, max_len=self.max_len,
                                  device=self.device)
            self._params = eng.params   # weights shared across sites
            self._engines[site_id] = eng
        return self._engines[site_id]


class AIaaSServer:
    def __init__(self, orch: Orchestrator, model_id: str = "edge-tiny",
                 *, slots: int = 8, max_len: int = 256,
                 premium_reserved_frac: float = 0.25,
                 gateway: Optional[NorthboundGateway] = None,
                 decode_chunk: Optional[Dict[str, int]] = None,
                 device=None, params=None):
        """``device`` defaults to the CUDA card; ``params`` (optional)
        are weights already on it, shared by every site's engine."""
        self.orch = orch
        self.fleet = EngineFleet(orch.catalog, model_id, slots=slots,
                                 max_len=max_len, device=device,
                                 params=params)
        self.planes: Dict[str, ServingPlane] = {}
        for site_id, site in orch.sites.items():
            eng = self.fleet.engine_for(site_id)
            site.attach_engine(eng)     # migration data plane + direct access
            plane = ServingPlane(
                orch.clock, RealEngineBackend(eng, orch.clock),
                slots=slots, premium_reserved_frac=premium_reserved_frac,
                site_id=site_id, decode_chunk=decode_chunk)
            site.attach_plane(plane)
            self.planes[site_id] = plane
        # the northbound exposure point: sessions established through it and
        # sessions established directly on the orchestrator serve identically
        self.gateway = gateway if gateway is not None \
            else NorthboundGateway(orch)
        # fleet-ops layer: per-site liveness/readiness, graceful drain,
        # crash detection + re-anchoring
        from repro_torch.serving.supervisor import FleetSupervisor
        self.supervisor = FleetSupervisor(orch)

    # ------------------------------------------------------------------
    def submit(self, session: AISession, *, prompt_tokens: int = 16,
               gen_tokens: int = 16,
               prompt: Optional[np.ndarray] = None) -> Optional[str]:
        """Async path through the gateway: enqueue on the anchor site's
        plane; drive with ``drain()``. Returns the request id, or None when
        admission control rejects."""
        ack = self.gateway.submit(wire.ServeRequest(
            session_id=session.session_id,
            prompt_tokens=len(prompt) if prompt is not None else prompt_tokens,
            gen_tokens=gen_tokens,
            prompt=[int(t) for t in prompt] if prompt is not None else None,
            stream=False))
        return ack.request_id if ack.accepted else None

    def drain(self) -> Dict[str, PlaneResult]:
        """Run every plane to completion through the gateway; telemetry +
        charging recorded by the orchestrator's single recorder."""
        out: Dict[str, PlaneResult] = {}
        for res in self.gateway.drain():
            out[res.request_id] = PlaneResult(
                request_id=res.request_id, session_id=res.session_id,
                klass=res.klass, ttfb_ms=res.ttfb_ms,
                latency_ms=res.latency_ms, queue_wait_ms=res.queue_wait_ms,
                tokens=res.tokens, completed=res.completed,
                failed=wire.cause_for_code(res.error_code)
                if res.error_code else None,
                token_ids=res.token_ids, prompt_tokens=res.prompt_tokens)
        return out

    # ------------------------------------------------------------------
    def request(self, session: AISession, prompt: np.ndarray,
                gen_tokens: int = 16) -> dict:
        """Unary path: one streamed serve through the gateway on the
        CALLER's prompt, returning the engine's generated token ids and
        timings."""
        frames = list(self.gateway.serve_stream(wire.ServeRequest(
            session_id=session.session_id,
            prompt_tokens=len(prompt), gen_tokens=gen_tokens,
            prompt=[int(t) for t in np.asarray(prompt)])))
        done = frames[-1]
        if isinstance(done, wire.ErrorResponse):
            from repro_torch.api.client import raise_for
            raise_for(done)
        return {"tokens": done.token_ids or [], "ttfb_ms": done.ttfb_ms,
                "latency_ms": done.latency_ms}
