"""Multi-tenant LoRA adapter fleet: the control-plane catalog.

The data-plane runtime (stacked A/B tables inside the fused decode) is not
ported yet: ROADMAP.md queue 1, item 2.
"""

from repro_torch.adapters.catalog import (  # noqa: F401
    AdapterCatalog,
    AdapterSpec,
    init_adapter_weights,
    version_key,
    weight_fingerprint,
)
