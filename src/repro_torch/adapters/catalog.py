"""Versioned LoRA adapter catalog (control plane).

An adapter is a low-rank delta on the final hidden state of its base
model: ``h' = h + (h @ A) @ B`` with ``A: [d_model, rank]`` and
``B: [rank, d_model]`` (the registration scale is folded into B). The
KV cache is untouched, so adapter identity never changes payload
shapes — it travels as a string alongside the cache in migration and
hibernation exports.

The catalog is the single source of truth the whole tenant-model
contract hangs off: DISCOVER admissibility reads sovereignty tags and
base-model bindings from here, PREPARE fails fast on unknown ids, the
federation capability digest advertises ``keys()``, and engines load
weights from ``weights()``.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

#: the one target-matrix set supported today: the post-final-norm
#: hidden state feeding the LM head
ADAPTER_TARGET = "hidden"

DEFAULT_REGIONS = ("eu", "us", "apac")


def version_key(version: str):
    """Numeric-aware sort key so "10.0" outranks "9.0" (lexicographic
    string sort gets this wrong)."""
    parts = []
    for p in str(version).split("."):
        parts.append((0, int(p), "") if p.isdigit() else (1, 0, p))
    return tuple(parts)


def weight_fingerprint(a: np.ndarray, b: np.ndarray) -> str:
    h = hashlib.sha256()
    h.update(np.ascontiguousarray(np.asarray(a, np.float32)).tobytes())
    h.update(np.ascontiguousarray(np.asarray(b, np.float32)).tobytes())
    return h.hexdigest()[:16]


@dataclass(frozen=True)
class AdapterSpec:
    """Immutable descriptor of one versioned tenant adapter."""

    adapter_id: str
    version: str
    base_model_id: str
    base_model_version: str
    rank: int
    target: str = ADAPTER_TARGET
    #: sovereignty tags — the adapter may only be anchored at sites in
    #: these regions (tenant weights can carry their own residency law)
    regions: Tuple[str, ...] = DEFAULT_REGIONS
    scale: float = 1.0
    seed: int = 0
    weight_fingerprint: str = ""

    @property
    def key(self) -> str:
        return f"{self.adapter_id}@{self.version}"

    def base_key(self) -> str:
        return f"{self.base_model_id}@{self.base_model_version}"


def init_adapter_weights(spec: AdapterSpec, d_model: int):
    """Deterministic A/B weights for a spec (stand-in for a tenant
    upload; same spec always materialises bit-identical weights, so
    fingerprints agree across domains)."""
    if spec.rank < 1:
        raise ValueError(f"adapter rank must be >= 1, got {spec.rank}")
    seed = int.from_bytes(
        hashlib.sha256(spec.key.encode()).digest()[:8], "little"
    ) ^ (spec.seed & 0xFFFFFFFF)
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((d_model, spec.rank)).astype(np.float32)
    a *= 1.0 / np.sqrt(d_model)
    b = rng.standard_normal((spec.rank, d_model)).astype(np.float32)
    b *= spec.scale * 0.05 / np.sqrt(spec.rank)
    return a, b


class AdapterCatalog:
    """Registry of versioned adapters keyed ``adapter_id@version``."""

    def __init__(self) -> None:
        self._entries: Dict[str, AdapterSpec] = {}
        self._weights: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
        #: control-plane record of which sites hold each adapter hot
        self._loaded_at: Dict[str, Set[str]] = {}

    def register(
        self,
        spec: AdapterSpec,
        weights: Optional[Tuple[np.ndarray, np.ndarray]] = None,
        *,
        d_model: Optional[int] = None,
    ) -> AdapterSpec:
        """Register a spec with explicit weights, or materialise
        deterministic ones from the seed when ``d_model`` is given.
        Returns the stored spec with its weight fingerprint filled in.
        """
        if spec.key in self._entries:
            raise ValueError(f"duplicate adapter {spec.key}")
        if spec.target != ADAPTER_TARGET:
            raise ValueError(f"unsupported adapter target {spec.target!r}")
        if weights is None:
            if d_model is None:
                raise ValueError("register needs weights or d_model")
            weights = init_adapter_weights(spec, d_model)
        a = np.asarray(weights[0], np.float32)
        b = np.asarray(weights[1], np.float32)
        if a.shape[1] != spec.rank or b.shape[0] != spec.rank:
            raise ValueError(
                f"weights rank {a.shape[1]}x{b.shape[0]} != spec rank {spec.rank}"
            )
        stored = replace(spec, weight_fingerprint=weight_fingerprint(a, b))
        self._entries[stored.key] = stored
        self._weights[stored.key] = (a, b)
        self._loaded_at[stored.key] = set()
        return stored

    def get(self, adapter_id: str, version: Optional[str] = None) -> AdapterSpec:
        """Resolve an adapter, deterministically picking the highest
        registered version when none is pinned."""
        if version:
            return self._entries[f"{adapter_id}@{version}"]
        matches = [
            e for e in self._entries.values() if e.adapter_id == adapter_id
        ]
        if not matches:
            raise KeyError(adapter_id)
        return sorted(matches, key=lambda e: version_key(e.version))[-1]

    def has(self, adapter_id: str, version: Optional[str] = None) -> bool:
        try:
            self.get(adapter_id, version)
            return True
        except KeyError:
            return False

    def weights(
        self, adapter_id: str, version: Optional[str] = None
    ) -> Tuple[np.ndarray, np.ndarray]:
        return self._weights[self.get(adapter_id, version).key]

    def keys(self) -> List[str]:
        return sorted(self._entries)

    def entries(self) -> List[AdapterSpec]:
        return [self._entries[k] for k in self.keys()]

    def for_base(self, model_id: str) -> List[AdapterSpec]:
        return [e for e in self.entries() if e.base_model_id == model_id]

    # -- control-plane load bookkeeping (data plane lives in runtime) --

    def mark_loaded(self, adapter_id: str, site_id: str) -> None:
        self._loaded_at[self.get(adapter_id).key].add(site_id)

    def mark_unloaded(self, adapter_id: str, site_id: str) -> None:
        self._loaded_at[self.get(adapter_id).key].discard(site_id)

    def loaded_sites(self, adapter_id: str) -> Tuple[str, ...]:
        return tuple(sorted(self._loaded_at[self.get(adapter_id).key]))
