"""Model catalog (the "catalog role", Section IV-A): resolvable model
identity + admissibility constraints, so discovery outputs are auditable and
never degenerate to opaque endpoint lists.

Each entry carries the *measured* hardware footprint used by the predictors:
FLOPs/bytes per token come from the analytic model or, when a dry-run
artifact exists for the arch, from the compiled cost analysis — tying
discovery ranking (Eq. 7/8) to the roofline numbers in EXPERIMENTS.md.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

from repro_torch.adapters.catalog import AdapterCatalog, AdapterSpec, version_key
from repro_torch.core.asp import ASP, Modality, QualityTier
from repro_torch.models.config import ModelConfig
from repro_torch.models.kvcache import cache_bytes


#: modality → admissible model families (constraint (a) of the ASP)
MODALITY_FAMILIES = {
    Modality.TEXT_GEN: ("dense", "moe", "hybrid", "ssm"),
    Modality.CODE_GEN: ("dense", "moe"),
    Modality.VISION_TEXT: ("dense",),          # + frontend == vision
    Modality.SPEECH_TRANSLATION: ("encdec",),
    Modality.EMBEDDING: ("dense", "encdec"),
}


@dataclass(frozen=True)
class ModelEntry:
    model_id: str
    version: str
    cfg: ModelConfig
    tier: QualityTier
    modalities: Tuple[Modality, ...]
    #: sovereignty tags: regions whose data this model is licensed to process
    regions: Tuple[str, ...] = ("eu", "us", "apac")
    #: price (currency-units) per 1k generated tokens at this tier
    price_per_1k_tokens: float = 0.5

    # -- hardware footprint (per token unless noted) ---------------------
    @property
    def active_params(self) -> int:
        return self.cfg.active_param_count()

    @property
    def param_bytes(self) -> int:
        return self.cfg.param_count() * 2  # bf16 serving weights

    def decode_flops_per_token(self) -> float:
        return 2.0 * self.active_params

    def prefill_flops_per_token(self) -> float:
        return 2.0 * self.active_params

    def decode_bytes_per_token(self, context: int, batch_hint: int = 8) -> float:
        """HBM traffic per generated token ≈ params + this session's share of
        the KV/state read (decode is memory-bound; the batch amortises
        weights)."""
        kv = cache_bytes(self.cfg, 1, context)
        return self.param_bytes / max(batch_hint, 1) + kv

    def session_state_bytes(self, context: int) -> int:
        """Migration payload size (make-before-break transfer)."""
        return cache_bytes(self.cfg, 1, context)

    def matches(self, asp: ASP) -> bool:
        if asp.modality not in self.modalities:
            return False
        if self.tier < asp.tier:
            return False
        fams = MODALITY_FAMILIES[asp.modality]
        if self.cfg.family not in fams:
            return False
        if asp.modality is Modality.VISION_TEXT and self.cfg.frontend != "vision":
            return False
        return True


class Catalog:
    def __init__(self):
        self._entries: Dict[str, ModelEntry] = {}
        #: versioned LoRA adapters registered against base models here
        self.adapters = AdapterCatalog()

    def register(self, entry: ModelEntry) -> None:
        key = f"{entry.model_id}@{entry.version}"
        if key in self._entries:
            raise ValueError(f"duplicate catalog entry {key}")
        self._entries[key] = entry

    def register_adapter(self, spec: AdapterSpec, weights=None) -> AdapterSpec:
        """Register a tenant adapter against its base model. The base
        must already be registered; deterministic weights are
        materialised from the base's d_model when none are supplied."""
        try:
            base = self.get(spec.base_model_id, spec.base_model_version)
        except KeyError:
            raise ValueError(
                f"adapter {spec.key} targets unregistered base "
                f"{spec.base_key()}")
        return self.adapters.register(
            spec, weights, d_model=base.cfg.d_model)

    def get(self, model_id: str, version: Optional[str] = None) -> ModelEntry:
        if version:
            return self._entries[f"{model_id}@{version}"]
        matches = [e for e in self._entries.values() if e.model_id == model_id]
        if not matches:
            raise KeyError(model_id)
        # numeric-aware: "10.0" must outrank "9.0" deterministically
        return sorted(matches, key=lambda e: version_key(e.version))[-1]

    def keys(self):
        """All registered model keys ("model_id@version")."""
        return tuple(self._entries.keys())

    def entries(self):
        """All registered ModelEntry records."""
        return tuple(self._entries.values())

    def admissible(self, asp: ASP):
        """All entries whose constraints admit this ASP (hard filter of
        Eq. 7 — ranking happens in discovery)."""
        out = [e for e in self._entries.values() if e.matches(asp)]
        # honour the fallback ladder ordering when given
        if asp.fallback_ladder:
            order = {m: i for i, (m, _) in enumerate(asp.fallback_ladder)}
            out.sort(key=lambda e: order.get(e.model_id, len(order)))
        return out

    def __len__(self):
        return len(self._entries)


def default_catalog() -> Catalog:
    """Catalog with all assigned architectures registered at sensible tiers."""
    from repro_torch.configs import ARCH_IDS, get_config

    tiers = {
        "qwen2-vl-72b": QualityTier.PREMIUM,
        "command-r-35b": QualityTier.PREMIUM,
        "qwen3-moe-30b-a3b": QualityTier.PREMIUM,
        "phi3-medium-14b": QualityTier.STANDARD,
        "mixtral-8x7b": QualityTier.STANDARD,
        "minitron-8b": QualityTier.STANDARD,
        "codeqwen1.5-7b": QualityTier.STANDARD,
        "recurrentgemma-2b": QualityTier.BASIC,
        "mamba2-1.3b": QualityTier.BASIC,
        "seamless-m4t-medium": QualityTier.STANDARD,
        "edge-tiny": QualityTier.BASIC,
    }
    mods = {
        "qwen2-vl-72b": (Modality.VISION_TEXT, Modality.TEXT_GEN),
        "seamless-m4t-medium": (Modality.SPEECH_TRANSLATION,),
        "codeqwen1.5-7b": (Modality.CODE_GEN, Modality.TEXT_GEN),
    }
    cat = Catalog()
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        price = 0.05 + 0.05 * (cfg.active_param_count() / 1e9)
        cat.register(ModelEntry(
            model_id=arch, version="1.0", cfg=cfg, tier=tiers[arch],
            modalities=mods.get(arch, (Modality.TEXT_GEN,)),
            price_per_1k_tokens=round(price, 3)))
    return cat
