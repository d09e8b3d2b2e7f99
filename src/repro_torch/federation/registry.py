"""Federation registry: where administrative domains advertise what they
are *willing to host for roamers* — and nothing more.

The unit of advertisement is the :class:`CapabilityDigest`, a coarse,
versioned summary deliberately weaker than the domain's real state:

* hosted **model keys** and modalities/tiers — yes;
* sovereignty **regions** — yes;
* a **load bucket** (low/medium/high) and a **price floor** — yes;
* lease tables, per-site queue depths, per-session occupancy — **never**.

This is the inter-operator trust boundary: a peer can pre-screen "is it
even worth soliciting domain X for this ASP" from the digest, but every
binding quantity (predicted TTFB/p99/cost of a concrete candidate) only
exists in a :class:`~repro_torch.federation.eastwest.DiscoverOffer`, produced by
the visited domain against a decomposed budget at solicitation time.

Digests carry an epoch and an advertisement timestamp. A digest older than
``max_age_s`` is *stale*: the home domain skips the peer and records a
``registry-stale`` exclusion, which aggregates into ``NO_FEASIBLE_BINDING``
(Eq. 12) when nothing else admits — staleness is diagnosable, not silent.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

from repro_torch.core.clock import Clock


@dataclass(frozen=True)
class CapabilityDigest:
    """One domain's coarse east-west advertisement."""
    domain_id: str
    epoch: int
    advertised_at: float         # registry clock
    model_keys: Tuple[str, ...]  # "model_id@version" hosted for roamers
    modalities: Tuple[str, ...]
    regions: Tuple[str, ...]
    load_bucket: str             # low | medium | high (coarse, not raw util)
    min_price_per_1k: float = 0.0
    #: tenant adapters ("adapter_id@version") this domain hosts for
    #: roamers — a peer can pre-screen "does domain X even carry my
    #: adapter" before soliciting, same coarseness rules as model_keys
    adapter_keys: Tuple[str, ...] = ()

    def to_wire(self) -> dict:
        return {
            "domain_id": self.domain_id, "epoch": self.epoch,
            "advertised_at": self.advertised_at,
            "model_keys": list(self.model_keys),
            "modalities": list(self.modalities),
            "regions": list(self.regions),
            "load_bucket": self.load_bucket,
            "min_price_per_1k": self.min_price_per_1k,
            "adapter_keys": list(self.adapter_keys),
        }

    @classmethod
    def from_wire(cls, d: dict) -> "CapabilityDigest":
        return cls(domain_id=d["domain_id"], epoch=int(d["epoch"]),
                   advertised_at=float(d["advertised_at"]),
                   model_keys=tuple(d["model_keys"]),
                   modalities=tuple(d["modalities"]),
                   regions=tuple(d["regions"]),
                   load_bucket=d["load_bucket"],
                   min_price_per_1k=float(d.get("min_price_per_1k", 0.0)),
                   adapter_keys=tuple(d.get("adapter_keys", ())))


def load_bucket(mean_utilization: float) -> str:
    """Coarse load signal: bucketed so the digest leaks ordering, not the
    actual occupancy."""
    if mean_utilization < 0.3:
        return "low"
    if mean_utilization < 0.7:
        return "medium"
    return "high"


def digest_of(domain_id: str, catalog, sites, clock: Clock,
              epoch: int) -> CapabilityDigest:
    """Build a digest from one domain's catalog + sites (what the
    DomainController advertises)."""
    entries = catalog.entries()
    modalities = sorted({m.value for e in entries for m in e.modalities})
    regions = sorted({s.spec.region for s in sites.values()})
    utils = [s.utilization() for s in sites.values()]
    mean_util = sum(utils) / max(len(utils), 1)
    adapters = getattr(catalog, "adapters", None)
    return CapabilityDigest(
        domain_id=domain_id, epoch=epoch, advertised_at=clock.now(),
        model_keys=tuple(sorted(catalog.keys())),
        modalities=tuple(modalities), regions=tuple(regions),
        load_bucket=load_bucket(mean_util),
        min_price_per_1k=min((e.price_per_1k_tokens for e in entries),
                             default=0.0),
        adapter_keys=tuple(adapters.keys()) if adapters is not None else ())


class FederationRegistry:
    """Shared (or replicated) digest directory of a federation.

    In this repro the registry is an in-process object the peered domains
    share; in a deployment it is the CAPIF interconnection / GSMA roaming
    hub equivalent. Either way the *content* is only digests.
    """

    def __init__(self, clock: Clock, *, max_age_s: float = 30.0):
        self.clock = clock
        self.max_age_s = max_age_s
        self._digests: Dict[str, CapabilityDigest] = {}
        #: live re-advertisement hooks (the CAPIF heartbeat direction): a
        #: domain that registers a provider gets its digest re-pulled when
        #: it ages out; staleness then MEANS the provider is gone/broken,
        #: not merely that time passed
        self._providers: Dict[str, object] = {}

    # -- advertisement ---------------------------------------------------
    def advertise(self, digest: CapabilityDigest) -> None:
        """Upsert one domain's digest (newest epoch wins)."""
        cur = self._digests.get(digest.domain_id)
        if cur is None or digest.epoch >= cur.epoch:
            self._digests[digest.domain_id] = digest

    def register_provider(self, domain_id: str, fn) -> None:
        """``fn() -> CapabilityDigest`` used to refresh a stale digest."""
        self._providers[domain_id] = fn

    def drop_provider(self, domain_id: str) -> None:
        self._providers.pop(domain_id, None)

    # -- lookup ----------------------------------------------------------
    def get(self, domain_id: str) -> Optional[CapabilityDigest]:
        return self._digests.get(domain_id)

    def fresh(self, domain_id: str) -> bool:
        d = self._digests.get(domain_id)
        return bool(d and self.clock.now() - d.advertised_at
                    <= self.max_age_s)

    def ensure_fresh(self, domain_id: str) -> bool:
        """Freshness with one re-pull attempt: a stale digest whose domain
        registered a provider is refreshed in place; False (⇒ the caller's
        ``registry-stale`` exclusion) only when no live provider answers."""
        if self.fresh(domain_id):
            return True
        fn = self._providers.get(domain_id)
        if fn is None:
            return False
        try:
            self.advertise(fn())
        except Exception:
            return False
        return self.fresh(domain_id)

    def domains(self, *, exclude: Tuple[str, ...] = ()) -> Tuple[str, ...]:
        """Advertised domain ids (stale ones included — the *caller* must
        classify staleness so the exclusion is attributable)."""
        return tuple(d for d in sorted(self._digests) if d not in exclude)
