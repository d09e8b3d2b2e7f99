"""PyTorch/CUDA port of the NE-AIaaS serving stack.

A second package beside the JAX reference ``repro``: the same control plane
(copied, not imported), the dense GQA, MoE, hybrid (RG-LRU + local
attention), SSM (Mamba-2) and encoder-decoder model families, per-session
LoRA adapters, the continuous-batching engine and the serving front, with
hand-written Hopper kernels for whole-sequence (flash) attention, decode
attention, the grouped expert GEMMs, the RG-LRU scan and the SSD chunked
scan. It imports ``torch`` and numpy and nothing of the reference package.

Entry points run on the CUDA card unless the caller asks for the CPU
(``device="cpu"``, as the tests do); with no card and no explicit device they
raise instead of carrying on quietly on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA card; raises when there is none."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run the plain PyTorch path")
        return torch.device("cuda")
    return torch.device(device)
