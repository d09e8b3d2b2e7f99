"""Split device–RAN–cloud serving: two-anchor sessions with edge-draft
greedy speculative decode.

A split session holds TWO co-reserved anchors under one ASP: an edge
DRAFT anchor (small model, access-RTT close, the interactive data-plane
path the invoker streams from) and a regional/central VERIFY anchor (the
quality-tier model that grades each γ-token draft round in one fused
forward and keeps the committed stream bitwise identical to target-only
greedy decode). Each anchor gets its own share of the ASP latency/cost
budget via the tier-generalized decomposition in
:mod:`repro_torch.core.budget`.

Modules:

* :mod:`~repro_torch.splitserve.placement` — DISCOVER/PAGE for the pair
  (SplitPlacement: per-tier budgets, per-role candidates, exclusion
  notes).
* :mod:`~repro_torch.splitserve.runtime` — SpecDecoder: the real two-engine
  draft/verify/accept loop over :class:`InferenceEngine` spec rounds,
  plus degraded edge-only operation and verify re-attachment.
* :mod:`~repro_torch.splitserve.control` — SplitManager: atomic dual-anchor
  2PC, heartbeat lease renewal + acceptance accounting, verify-tier
  make-before-break migration, crash degrade/recover, event emission.
"""

from repro_torch.splitserve.placement import (DEFAULT_GAMMA, SplitPlacement,
                                        propose_split)
from repro_torch.splitserve.runtime import (SpecDecoder, SpecStats,
                                      expected_round_tokens, spec_speedup)
from repro_torch.splitserve.control import SplitManager, SplitState

__all__ = [
    "DEFAULT_GAMMA", "SplitPlacement", "propose_split",
    "SpecDecoder", "SpecStats", "expected_round_tokens", "spec_speedup",
    "SplitManager", "SplitState",
]
