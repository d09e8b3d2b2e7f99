"""Weight-only int8 quantisation for serving: dequantise on read.

Quantised matrix params are ``{"q": int8, "s": f32 per-output-channel
scales}`` (as the reference's ``quantize_weight`` makes them);
``as_weight`` dequantises at the matmul call site, so at rest the weights
cost half the memory while every consumer still sees a dense matrix.

Every weight consumer calls ``as_weight`` (no-op for plain tensors), so the
same model code serves bf16/f32 and int8 checkpoints.
"""

from __future__ import annotations

import torch


def is_quantized(p) -> bool:
    return isinstance(p, dict) and set(p.keys()) == {"q", "s"}


def as_weight(p, dtype=torch.bfloat16):
    """Dequantise-on-read hook used at every matmul call site."""
    if is_quantized(p):
        return (p["q"].float() * p["s"]).to(dtype)
    return p
