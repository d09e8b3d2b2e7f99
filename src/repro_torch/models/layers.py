"""Shared neural-net layers (plain functions on tensors, dict params).

Conventions follow the reference package: weights are stored in
``cfg.dtype`` (bf16 by default), norm scales in f32; normalisation and
rotary embeddings compute in f32 and cast back; matmuls run in the working
dtype (cuBLAS accumulates bf16 products in f32 and rounds the result once).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.quant import as_weight

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def matmul(x: torch.Tensor, w) -> torch.Tensor:
    """``x @ w`` for a plain or int8-quantised weight, in ``x``'s dtype
    (int8 dequantises to bf16 first, as the reference does)."""
    return torch.matmul(x, as_weight(w).to(x.dtype))


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rmsnorm_apply(p, x: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps) * p["scale"]
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# rotary embeddings (RoPE + M-RoPE), half-split rotation
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float,
                     device=None) -> torch.Tensor:
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)  # [head_dim//2]


def _rotate(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    cos = torch.cos(angles)[..., None, :]  # broadcast over heads
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Rotate pairs. x: [..., seq, heads, head_dim]; positions: [..., seq]."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)
    angles = positions[..., None].float() * freqs  # [..., seq, hd/2]
    return _rotate(x, angles)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, theta: float,
                sections: tuple) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE. positions: [3, ..., seq]; section i of the
    half-dim takes its rotation angle from position stream i. The angles
    are built section by section from slices, so no section index tensor
    crosses to the device (a host sync on a card)."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)  # [half]
    pos = positions.float()
    parts, start = [], 0
    for i, n in enumerate(sections):
        parts.append(pos[i][..., None] * freqs[start:start + n])
        start += n
    angles = torch.cat(parts, dim=-1)                        # [..., seq, half]
    return _rotate(x, angles)


def rope_for(cfg: ModelConfig, x: torch.Tensor,
             positions: torch.Tensor) -> torch.Tensor:
    """Dispatch RoPE vs M-RoPE. positions: [b, s] or [3, b, s] for mrope."""
    if cfg.mrope_sections:
        if positions.ndim == 2:  # text-only: duplicate stream
            positions = positions[None].expand((3,) + positions.shape)
        return apply_mrope(x, positions, cfg.rope_theta, cfg.mrope_sections)
    if positions.ndim == 3:
        positions = positions[0]
    return apply_rope(x, positions, cfg.rope_theta)


# ---------------------------------------------------------------------------
# gated MLP (SwiGLU)
# ---------------------------------------------------------------------------

def mlp_apply(p, x: torch.Tensor) -> torch.Tensor:
    gate = matmul(x, p["w_gate"]).float()
    up = matmul(x, p["w_up"]).float()
    h = (F.silu(gate) * up).to(x.dtype)
    return matmul(h, p["w_down"])


# ---------------------------------------------------------------------------
# softcap
# ---------------------------------------------------------------------------

def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if not cap:
        return x
    return torch.tanh(x / cap) * cap
