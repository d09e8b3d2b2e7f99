"""Analytics role (NWDAF-style): measured feasibility signals ξ.

Maintains exponentially-smoothed load / queue / latency observations per
(site, model) and mobility risk per invoker, and exposes the coarse context
summary ξ that conditions anchoring (Eq. 9) and migration triggers (Eq. 14).
Nothing here is a static assumption: every field is updated from telemetry
(serving) or from the simulator's generated load — "admission ... derived
from measured feasibility rather than static assumptions" (§II-A).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Tuple

from repro_torch.core.clock import Clock


class EWMA:
    def __init__(self, alpha: float = 0.2, init: float = 0.0):
        self.alpha = alpha
        self.value = init
        self.n = 0

    def update(self, x: float) -> float:
        self.n += 1
        a = self.alpha if self.n > 1 else 1.0
        self.value = (1 - a) * self.value + a * x
        return self.value


@dataclass
class SiteContext:
    """ξ restricted to one site: coarse, privacy-preserving summaries."""
    utilization: float = 0.0        # decode-slot occupancy [0, 1]
    queue_depth: float = 0.0        # waiting requests per slot
    arrival_rate: float = 0.0       # admitted sessions / s
    p99_infer_ms: float = 0.0       # measured execution-side p99
    page_util: float = 0.0          # KV page-pool occupancy [0, 1]
    healthy: bool = True
    alive: bool = True              # supervisor liveness (dead = crashed)


class Analytics:
    def __init__(self, clock: Clock):
        self.clock = clock
        self._util: Dict[str, EWMA] = {}
        self._queue: Dict[str, EWMA] = {}
        self._rate: Dict[str, EWMA] = {}
        self._mem: Dict[str, EWMA] = {}        # site -> KV page-pool util
        self._p99: Dict[Tuple[str, str], EWMA] = {}
        self._mobility: Dict[str, EWMA] = {}   # invoker -> handover rate /s
        self._deny: set = set()                # A1-style site deny list
        self._dead: set = set()                # supervisor-declared crashes
        #: per-site load epoch: bumped whenever NEW evidence about a site
        #: arrives (heartbeat load, measured latency, A1 policy) — the
        #: invalidation key for predictor memoization
        self._epochs: Dict[str, int] = {}

    def _bump(self, site_id: str) -> None:
        self._epochs[site_id] = self._epochs.get(site_id, 0) + 1

    def load_epoch(self, site_id: str) -> int:
        """Monotone counter of ξ updates for one site. Predictions cached
        at epoch k are valid until the next observation arrives."""
        return self._epochs.get(site_id, 0)

    # -- ingestion -------------------------------------------------------
    def observe_site(self, site_id: str, *, utilization: float,
                     queue_depth: float, arrival_rate: float,
                     page_util: float = 0.0) -> None:
        self._util.setdefault(site_id, EWMA()).update(utilization)
        self._queue.setdefault(site_id, EWMA()).update(queue_depth)
        self._rate.setdefault(site_id, EWMA()).update(arrival_rate)
        self._mem.setdefault(site_id, EWMA()).update(page_util)
        self._bump(site_id)

    def observe_latency(self, site_id: str, model_key: str, p99_ms: float) -> None:
        self._p99.setdefault((site_id, model_key), EWMA()).update(p99_ms)
        self._bump(site_id)

    def observe_handover(self, invoker: str, rate_per_s: float) -> None:
        self._mobility.setdefault(invoker, EWMA(alpha=0.3)).update(rate_per_s)

    def deny_site(self, site_id: str) -> None:
        """A1-style policy guidance: steer away from this site."""
        self._deny.add(site_id)
        self._bump(site_id)

    def allow_site(self, site_id: str) -> None:
        self._deny.discard(site_id)
        self._bump(site_id)

    def mark_site_dead(self, site_id: str) -> None:
        """Supervisor crash verdict: the site is excluded from DISCOVER
        (reason ``site-dead``) until marked alive again."""
        self._dead.add(site_id)
        self._bump(site_id)

    def mark_site_alive(self, site_id: str) -> None:
        self._dead.discard(site_id)
        self._bump(site_id)

    def site_alive(self, site_id: str) -> bool:
        return site_id not in self._dead

    # -- ξ exposure ---------------------------------------------------------
    def site_context(self, site_id: str) -> SiteContext:
        return SiteContext(
            utilization=self._util.get(site_id, EWMA()).value,
            queue_depth=self._queue.get(site_id, EWMA()).value,
            arrival_rate=self._rate.get(site_id, EWMA()).value,
            p99_infer_ms=self._p99.get((site_id, "*"), EWMA()).value,
            page_util=self._mem.get(site_id, EWMA()).value,
            healthy=site_id not in self._deny and site_id not in self._dead,
            alive=site_id not in self._dead,
        )

    def measured_p99(self, site_id: str, model_key: str) -> float | None:
        e = self._p99.get((site_id, model_key))
        return e.value if e and e.n > 3 else None

    def handover_rate(self, invoker: str) -> float:
        e = self._mobility.get(invoker)
        return e.value if e else 0.0
