"""Assigned-architecture configs (``--arch <id>``) + the paper's demo model.

Every module exposes ``CONFIG`` (full production config) and
``smoke_config()`` (reduced same-family config for CPU
tests). ``registry.get_config(arch_id)`` resolves dashed arch ids.
"""

from repro_torch.configs.registry import ARCH_IDS, get_config, get_smoke_config  # noqa: F401
