"""AI Service Profile (ASP) — the paper's intent contract (Section III-A).

The objective part is exactly Eq. (3):

    (ℓ_TTFB, ℓ_0.95, ℓ_0.99, ρ_min, T_max, ν_min)

— every term falsifiable from boundary telemetry (Eq. 5/13). The constraint
part restricts admissible realizations: modality/interaction mode, quality
tier, privacy/sovereignty scope, mobility class, cost envelope, and the
ordered fallback ladder (the ONLY admissible degradation path — prevents
silent model/anchor switches that would make compliance non-identifiable).
"""

from __future__ import annotations

import enum
import hashlib
import json
from dataclasses import dataclass, field, asdict
from typing import Tuple


#: wire-schema version of the ASP record. Bound into ``digest()`` so two
#: parties hashing the same intent under different field sets can never
#: collide silently; the northbound gateway refuses mismatched majors.
#: 1.1: adds ``adapter_id`` (tenant LoRA adapter binding; "" = base).
#: 1.2: adds ``split_policy`` (tiered split-serving consent; "never" =
#: single-anchor, the pre-1.2 behaviour).
ASP_SCHEMA_VERSION = "1.2"

#: admissible values of :attr:`ASP.split_policy`
SPLIT_POLICIES = ("never", "auto", "require")


class SchemaVersionError(ValueError):
    """Incompatible wire-schema major — distinct from malformed input so
    the gateway can classify it structurally, not by message text."""


class Modality(enum.Enum):
    TEXT_GEN = "text-generation"
    CODE_GEN = "code-generation"
    VISION_TEXT = "vision-language"
    SPEECH_TRANSLATION = "speech-translation"
    EMBEDDING = "embedding"


class InteractionMode(enum.Enum):
    STREAMING = "streaming"   # TTFB == time-to-first-token
    UNARY = "unary"           # TTFB == time-to-first-response


class MobilityClass(enum.Enum):
    STATIC = "static"         # continuity provisioning not required
    NOMADIC = "nomadic"       # occasional re-anchoring
    VEHICULAR = "vehicular"   # frequent handover; MBB migration mandatory


class QualityTier(enum.IntEnum):
    BASIC = 1
    STANDARD = 2
    PREMIUM = 3


@dataclass(frozen=True)
class Objectives:
    """Eq. (3) — all milliseconds except ρ (probability) and ν (tokens/s)."""
    ttfb_ms: float           # ℓ_TTFB
    p95_ms: float            # ℓ_0.95
    p99_ms: float            # ℓ_0.99
    rho_min: float           # minimum completion probability under T_max
    t_max_ms: float          # hard timeout fixing success semantics
    nu_min: float            # sustained rate proxy (tokens/s or frames/s)

    def validate(self) -> None:
        if not (0 < self.ttfb_ms <= self.p99_ms):
            raise ValueError("need 0 < ℓ_TTFB ≤ ℓ_0.99")
        if not (self.p95_ms <= self.p99_ms <= self.t_max_ms):
            raise ValueError("need ℓ_0.95 ≤ ℓ_0.99 ≤ T_max")
        if not (0.0 < self.rho_min <= 1.0):
            raise ValueError("ρ_min must be a probability in (0, 1]")
        if self.nu_min < 0:
            raise ValueError("ν_min ≥ 0")


@dataclass(frozen=True)
class ASP:
    # (a) task modality + interaction mode → admissible model families
    modality: Modality
    interaction: InteractionMode
    # measurable service objectives, Eq. (3)
    objectives: Objectives
    # (b) resolvable quality tier
    tier: QualityTier = QualityTier.STANDARD
    # (c) privacy / sovereignty scope: admissible execution regions,
    #     telemetry granularity, and whether state may cross regions
    allowed_regions: Tuple[str, ...] = ("eu", "us", "apac")
    telemetry_scope: str = "aggregate"       # aggregate | per-request | none
    state_transfer_allowed: bool = True
    # (d) mobility class → continuity provisioning
    mobility: MobilityClass = MobilityClass.STATIC
    # (e) cost envelope (currency-units per 1k tokens, and per session)
    max_cost_per_1k_tokens: float = 1.0
    max_session_cost: float = 100.0
    # (f) ordered fallback ladder: the only admissible degradation path,
    #     as (model_id, tier) pairs, most-preferred first
    fallback_ladder: Tuple[Tuple[str, int], ...] = ()
    # (g) tenant adapter binding: a LoRA adapter id multiplexed over the
    #     base model ("" = the bare base). Part of the digest, so the
    #     tenant-model contract is one identity across DISCOVER
    #     admissibility, federation advertisement, and migration
    #     fingerprints. The fallback ladder may still name full models —
    #     that is the "base+adapter at edge" vs. "full model in region"
    #     degradation choice.
    adapter_id: str = ""
    # (h) split-serving consent: whether execution may be split across
    #     tiers (edge draft + anchored verify, token-identical greedy
    #     spec-decode). "never" = single anchor only (pre-1.2 default);
    #     "auto" = split when DISCOVER finds a feasible tier budget;
    #     "require" = refuse establishment unless a split is feasible.
    split_policy: str = "never"

    def validate(self) -> None:
        self.objectives.validate()
        if not self.allowed_regions:
            raise ValueError("empty sovereignty scope admits no site")
        if self.telemetry_scope not in ("aggregate", "per-request", "none"):
            raise ValueError("unknown telemetry scope")
        if self.max_cost_per_1k_tokens <= 0:
            raise ValueError("cost envelope needs max_cost_per_1k_tokens > 0")
        if self.max_session_cost <= 0:
            raise ValueError("cost envelope needs max_session_cost > 0")
        for model_id, tier in self.fallback_ladder:
            try:
                QualityTier(int(tier))
            except (ValueError, TypeError):
                raise ValueError(
                    f"fallback ladder entry ({model_id!r}, {tier!r}) names "
                    f"no valid QualityTier") from None
        if self.split_policy not in SPLIT_POLICIES:
            raise ValueError(
                f"split_policy must be one of {SPLIT_POLICIES}, "
                f"got {self.split_policy!r}")

    # ------------------------------------------------------------------
    # wire codec (northbound exposure) + versioned digest
    # ------------------------------------------------------------------
    def to_wire(self) -> dict:
        """JSON-able record of the full intent contract, with an explicit
        ``schema_version`` so the digest stays comparable across future
        field additions (absent-vs-default is disambiguated by version)."""
        return {
            "schema_version": ASP_SCHEMA_VERSION,
            "modality": self.modality.value,
            "interaction": self.interaction.value,
            "objectives": asdict(self.objectives),
            "tier": int(self.tier),
            "allowed_regions": list(self.allowed_regions),
            "telemetry_scope": self.telemetry_scope,
            "state_transfer_allowed": self.state_transfer_allowed,
            "mobility": self.mobility.value,
            "max_cost_per_1k_tokens": self.max_cost_per_1k_tokens,
            "max_session_cost": self.max_session_cost,
            "fallback_ladder": [[m, int(t)] for m, t in self.fallback_ladder],
            "adapter_id": self.adapter_id,
            "split_policy": self.split_policy,
        }

    @classmethod
    def from_wire(cls, d: dict) -> "ASP":
        ver = str(d.get("schema_version", ""))
        if ver.split(".")[0] != ASP_SCHEMA_VERSION.split(".")[0]:
            raise SchemaVersionError(
                f"ASP schema version {ver!r} incompatible with "
                f"{ASP_SCHEMA_VERSION!r}")
        asp = cls(
            modality=Modality(d["modality"]),
            interaction=InteractionMode(d["interaction"]),
            objectives=Objectives(**d["objectives"]),
            tier=QualityTier(int(d["tier"])),
            allowed_regions=tuple(d["allowed_regions"]),
            telemetry_scope=d["telemetry_scope"],
            state_transfer_allowed=bool(d["state_transfer_allowed"]),
            mobility=MobilityClass(d["mobility"]),
            max_cost_per_1k_tokens=float(d["max_cost_per_1k_tokens"]),
            max_session_cost=float(d["max_session_cost"]),
            fallback_ladder=tuple((m, int(t))
                                  for m, t in d["fallback_ladder"]),
            # minor-version tolerance: pre-1.1/1.2 peers omit the fields
            adapter_id=str(d.get("adapter_id", "")),
            split_policy=str(d.get("split_policy", "never")),
        )
        asp.validate()
        return asp

    def digest(self) -> str:
        """Stable digest bound into the AIS record (Section III-B); hashes
        the versioned wire form, so the schema version is part of identity.
        Cached on the (frozen) instance — the digest keys every memoized
        prediction, so it must not cost a JSON dump per lookup."""
        cached = self.__dict__.get("_digest_cache")
        if cached is None:
            body = json.dumps(self.to_wire(), sort_keys=True)
            cached = hashlib.sha256(body.encode()).hexdigest()[:16]
            object.__setattr__(self, "_digest_cache", cached)
        return cached

    def continuity_required(self) -> bool:
        return self.mobility is not MobilityClass.STATIC


def default_asp(model_hint: str = "", *, tier: QualityTier = QualityTier.STANDARD,
                mobility: MobilityClass = MobilityClass.STATIC) -> ASP:
    """A reasonable interactive text-generation profile (used by examples)."""
    return ASP(
        modality=Modality.TEXT_GEN,
        interaction=InteractionMode.STREAMING,
        objectives=Objectives(ttfb_ms=300.0, p95_ms=600.0, p99_ms=900.0,
                              rho_min=0.99, t_max_ms=2000.0, nu_min=20.0),
        tier=tier,
        mobility=mobility,
        fallback_ladder=((model_hint, int(tier)),) if model_hint else (),
    )
