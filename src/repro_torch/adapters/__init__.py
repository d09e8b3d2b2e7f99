"""Multi-tenant LoRA adapter fleet.

`catalog` holds the control-plane view: versioned adapter specs
(rank, target matrices, sovereignty tags, weight fingerprints)
registered against base models. `runtime` holds the data-plane view:
stacked per-engine A/B device tables indexed by a per-slot int32
adapter table inside the fused decode.
"""

from repro_torch.adapters.catalog import (  # noqa: F401
    AdapterCatalog,
    AdapterSpec,
    init_adapter_weights,
    version_key,
    weight_fingerprint,
)
from repro_torch.adapters.runtime import (  # noqa: F401
    AdapterRuntime,
    lora_apply_rows,
    lora_delta,
)
