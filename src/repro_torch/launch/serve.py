"""NE-AIaaS serving launcher on the port: real engines behind QoS-scheduled
serving planes, driven END-TO-END through the northbound session API.

    PYTHONPATH=src python -m repro_torch.launch.serve --model minitron-8b \
        --sessions 4 --requests 8 --max-len 2048 --gen-tokens 16

Every session is established, served, and released by a
:class:`~repro_torch.api.client.SessionClient` speaking JSON to the
:class:`~repro_torch.api.gateway.NorthboundGateway`. The engines run on the
CUDA card (``device=None``) through the hand-written kernels (flash
attention at prefill and decode attention for the full-attention models;
the grouped expert GEMMs for ``qwen3-moe-30b-a3b``; the RG-LRU scan for
``recurrentgemma-2b`` and the SSD chunked scan for ``mamba2-1.3b`` at
prefill); ``device="cpu"`` runs their plain PyTorch versions instead.
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np

from repro_torch.api.client import SessionClient
from repro_torch.configs import ARCH_IDS
from repro_torch.core import Orchestrator, default_asp
from repro_torch.core.asp import QualityTier
from repro_torch.core.clock import Clock
from repro_torch.serving.server import AIaaSServer


def serve(model: str = "edge-tiny", *, sessions: int = 4, requests: int = 12,
          slots: int = 8, max_len: int = 192, gen_tokens: int = 8,
          t_max_ms: float = 300_000.0, seed: int = 0, quiet: bool = False,
          decode_chunk: int = 0, device=None, params=None):
    """Returns (served, reports). ``params`` (optional) are weights already
    on ``device``, shared by every site's engine."""
    clock = Clock()
    orch = Orchestrator(clock=clock)
    # decode_chunk > 0 overrides the per-class fused-chunk caps uniformly;
    # 0 keeps the QoS-adaptive defaults
    chunks = ({k: decode_chunk for k in ("premium", "assured", "best-effort")}
              if decode_chunk > 0 else None)
    server = AIaaSServer(orch, model, slots=slots, max_len=max_len,
                         decode_chunk=chunks, device=device, params=params)
    rng = np.random.default_rng(seed)

    clients = []
    for i in range(sessions):
        tier = QualityTier.PREMIUM if i % 2 == 0 else QualityTier.BASIC
        asp = default_asp(tier=tier)
        asp = dataclasses.replace(
            asp, objectives=dataclasses.replace(
                asp.objectives, ttfb_ms=t_max_ms / 10, p95_ms=t_max_ms / 3,
                p99_ms=t_max_ms / 2, t_max_ms=t_max_ms, nu_min=0.0))
        c = SessionClient(server.gateway, asp, invoker=f"ue-{i}",
                          zone="zone-a").establish()
        clients.append(c)
        if not quiet:
            print(f"AIS {c.session_id} tier={tier.name} "
                  f"anchor={c.record['anchor']} qfi={c.record['qfi']}")

    # submit everything through the northbound API — admission order
    # (premium first, reserved share, fast-fail) is the site planes' job
    for r in range(requests):
        c = clients[r % len(clients)]
        c.submit(prompt_tokens=int(rng.integers(8, 32)),
                 gen_tokens=gen_tokens)
    results = server.drain()
    served = sum(1 for res in results.values()
                 if res.failed is None)
    fast_failed = sum(p.scheduler.stats.fast_failed
                      for p in server.planes.values())

    reports = {}
    for c in clients:
        rep = c.compliance()
        reports[c.session_id] = rep
        ack = c.release()
        if not quiet and rep.n:
            z = rep.z
            print(f"{c.session_id} q99={z['q99_ms']:9.1f}ms ρ̂={z['rho']:.2f} "
                  f"ν̂={z['nu_tokens_per_s']:7.1f} tok/s "
                  f"compliant={rep.in_compliance} cost={ack.total_cost:.4f}")
    if not quiet:
        print(f"served {served}/{requests} "
              f"(fast-failed {fast_failed} on deadline)")
    return served, reports


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="edge-tiny", choices=ARCH_IDS)
    ap.add_argument("--sessions", type=int, default=4)
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--max-len", type=int, default=192)
    ap.add_argument("--gen-tokens", type=int, default=8)
    ap.add_argument("--decode-chunk", type=int, default=0,
                    help="uniform fused-decode chunk size "
                         "(0 = QoS-adaptive per-class defaults)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    a = ap.parse_args()
    serve(a.model, sessions=a.sessions, requests=a.requests, slots=a.slots,
          max_len=a.max_len, gen_tokens=a.gen_tokens,
          decode_chunk=a.decode_chunk, device=a.device)


if __name__ == "__main__":
    main()
