"""Architecture registry: arch-id -> ModelConfig."""

from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

ARCH_IDS = (
    "phi3-medium-14b",
    "command-r-35b",
    "codeqwen1.5-7b",
    "minitron-8b",
    "qwen2-vl-72b",
    "qwen3-moe-30b-a3b",
    "mixtral-8x7b",
    "recurrentgemma-2b",
    "mamba2-1.3b",
    "seamless-m4t-medium",
    # the paper's own demo model (used by examples/serving tests)
    "edge-tiny",
)


def _module(arch_id: str):
    mod = arch_id.replace("-", "_").replace(".", "_")
    return importlib.import_module(f"repro_torch.configs.{mod}")


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    return _module(arch_id).CONFIG


def get_smoke_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).smoke_config()


# ----------------------------------------------------------------------
# Split-serving metadata: which archs can draft for which targets, and
# which tier of the device–RAN–cloud ladder each arch naturally lives on.
# ----------------------------------------------------------------------

#: draft arch -> target archs it may draft for. A pairing is only usable
#: when ``draft_compatible`` also holds for the concrete configs (greedy
#: spec-decode needs an identical token space; enforced at PREPARE so a
#: mismatch is a placement-time NO_FEASIBLE_BINDING, never a mid-stream
#: decode fault). Smoke configs all share vocab 512, so every pairing is
#: exercisable in tests; the full-size lists pair within the
#: vocab-256000 tokenizer family.
DRAFT_PAIRINGS = {
    "recurrentgemma-2b": ("command-r-35b", "minitron-8b"),
    "mamba2-1.3b": (),        # vocab 50280 matches no full-size target
    "edge-tiny": (),          # full edge-tiny vocab (2048) pairs with no
                              # full-size target; smoke-form pairs freely
}

#: arch -> placement tier it is sized for ("edge" drafts on-device /
#: on-RAN; "region"/"central" verify). Discovery uses this to partition
#: split candidates by role.
ARCH_TIERS = {
    "edge-tiny": "edge",
    "recurrentgemma-2b": "edge",
    "mamba2-1.3b": "edge",
    "minitron-8b": "region",
    "phi3-medium-14b": "region",
    "codeqwen1.5-7b": "region",
    "seamless-m4t-medium": "region",
    "command-r-35b": "central",
    "qwen2-vl-72b": "central",
    "qwen3-moe-30b-a3b": "central",
    "mixtral-8x7b": "central",
}


def draft_targets(draft_arch: str) -> tuple:
    """Declared full-size targets for ``draft_arch`` (may be empty)."""
    return tuple(DRAFT_PAIRINGS.get(draft_arch, ()))


def arch_tier(arch_id: str) -> str:
    """The device–RAN–cloud tier this arch is sized for."""
    return ARCH_TIERS.get(arch_id, "central")


def draft_compatible(draft_cfg: ModelConfig, target_cfg: ModelConfig) -> bool:
    """True iff greedy spec-decode between the two configs is well-typed:
    the draft's proposals index the target's token space bijectively
    (same vocab size — the argmax comparison is over token ids, so any
    mismatch is structurally wrong, not just low-acceptance)."""
    return int(draft_cfg.vocab_size) == int(target_cfg.vocab_size)
