"""Mamba-2 SSD layer (state-space duality, arXiv:2405.21060).

The sequence path (prefill, and the training forward) runs the chunked SSD
scan through the hand-written ``ssd_chunk`` kernels (on a CPU tensor, their
plain version: the reference's ``_ssd_chunked``, its decay masked before
the exponent), starting from a carried state and returning the final one;
while autograd records, through ``SSDChunk``, whose backward is three
hand-written kernels, so the layer trains on the card. Decode is the exact single-step recurrence in plain PyTorch,
as in the reference: session state is O(1) in the sequence length. Layouts
and dtypes are the reference's (``repro.models.ssd``): ``A_log``, ``D``,
``dt_bias``, the norm scale and the SSM state are f32; the conv state and
the projections are in ``cfg.dtype``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd_chunk.ssd_chunk import ssd_chunk
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.models.rglru import causal_conv


def ssd_init(cfg: ModelConfig, normal, uniform):
    """One layer's params with the reference's shapes, scales and dtypes:
    ``normal(shape, scale, dtype)`` and ``uniform(shape, lo, hi)`` draw from
    the caller's generator."""
    dt = L.dtype_of(cfg)
    d, di, n = cfg.d_model, cfg.d_inner, cfg.ssm_state
    g, nh, K = cfg.ssm_ngroups, cfg.ssm_nheads, cfg.conv_width
    proj_out = 2 * di + 2 * g * n + nh
    # dt bias such that softplus(dt_bias) spans [1e-3, 1e-1] (mamba default)
    dt_bias = torch.exp(uniform((nh,), math.log(1e-3), math.log(1e-1)))
    dt_bias = dt_bias + torch.log(-torch.expm1(-dt_bias))   # inverse softplus
    dev = dt_bias.device
    return {
        "in_proj": normal((d, proj_out), 1.0 / math.sqrt(d), dt),
        "conv": normal((K, di + 2 * g * n), 1.0 / math.sqrt(K), dt),
        "out_proj": normal((di, d), 1.0 / math.sqrt(di), dt),
        "A_log": torch.log(torch.arange(1, nh + 1, dtype=torch.float32,
                                        device=dev)),
        "D": torch.ones((nh,), dtype=torch.float32, device=dev),
        "dt_bias": dt_bias,
        "norm": {"scale": torch.ones((di,), dtype=torch.float32, device=dev)},
    }


def _split_proj(cfg: ModelConfig, zxbcdt):
    di, n, g = cfg.d_inner, cfg.ssm_state, cfg.ssm_ngroups
    return (zxbcdt[..., :di], zxbcdt[..., di: 2 * di],
            zxbcdt[..., 2 * di: 2 * di + g * n],
            zxbcdt[..., 2 * di + g * n: 2 * di + 2 * g * n],
            zxbcdt[..., 2 * di + 2 * g * n:])


def _conv(p, xbc, state=None, length=None):
    """Causal depthwise conv over [b, l, conv_dim], then SiLU in f32, back
    in xbc's dtype; the carried state is taken at ``length``."""
    y, new_state = causal_conv(p["conv"], xbc, state, length)
    return F.silu(y.float()).to(xbc.dtype), new_state


def _gated_out(p, cfg: ModelConfig, y, z, x_dtype):
    """rmsnorm(y · silu(z)) then the output projection."""
    y = L.rmsnorm_apply(p["norm"],
                        y * F.silu(z.float()).to(x_dtype), cfg.norm_eps)
    return L.matmul(y, p["out_proj"])


def ssd_apply(p, cfg: ModelConfig, x, conv_state=None, ssm_state=None,
              length=None):
    """Sequence path. x: [b, l, d] -> (y [b, l, d], (conv_state, ssm_state)).

    ``length`` marks the true prompt length of a right-padded bucket:
    padded steps get dt = 0, which makes the recurrence an exact identity
    there, so the carried state is the state at ``length``."""
    b, l, _ = x.shape
    di, nh, hp = cfg.d_inner, cfg.ssm_nheads, cfg.ssm_headdim
    g, n = cfg.ssm_ngroups, cfg.ssm_state
    z, xs, B, C, dt = _split_proj(cfg, L.matmul(x, p["in_proj"]))
    xbc, conv_state = _conv(p, torch.cat([xs, B, C], dim=-1), conv_state,
                            length)
    xs = xbc[..., :di].reshape(b, l, nh, hp)
    B = xbc[..., di: di + g * n].reshape(b, l, g, n)
    C = xbc[..., di + g * n:].reshape(b, l, g, n)
    dt = F.softplus(dt.float() + p["dt_bias"])
    if length is not None and length < l:
        valid = (torch.arange(l, device=x.device) < length)[None, :, None]
        dt = torch.where(valid, dt, torch.zeros_like(dt))
    # the train step's bf16 copy of A_log: exp in bf16 as the reference's,
    # then f32, as its product with dt promotes it (the kernel takes f32)
    A = (-torch.exp(p["A_log"])).float()
    if ssm_state is None:
        ssm_state = torch.zeros((b, nh, hp, n), dtype=torch.float32,
                                device=x.device)
    y, S = ssd_chunk(xs, dt.contiguous(), A, B, C, ssm_state, cfg.ssm_chunk)
    y = y + xs.float() * p["D"][None, None, :, None]
    y = y.reshape(b, l, di).to(x.dtype)
    return _gated_out(p, cfg, y, z, x.dtype), (conv_state, S)


def ssd_decode(p, cfg: ModelConfig, x, conv_state, ssm_state):
    """Single-token recurrence. x: [b, 1, d]; conv_state [b, K-1, conv_dim];
    ssm_state [b, nh, hp, n] f32."""
    b = x.shape[0]
    di, nh, hp = cfg.d_inner, cfg.ssm_nheads, cfg.ssm_headdim
    g, n = cfg.ssm_ngroups, cfg.ssm_state
    z, xs, B, C, dt = _split_proj(cfg, L.matmul(x, p["in_proj"]))
    xbc, conv_state = _conv(p, torch.cat([xs, B, C], dim=-1), conv_state)
    xs = xbc[:, 0, :di].reshape(b, nh, hp)
    hpg = nh // g
    Bh = xbc[:, 0, di: di + g * n].reshape(b, g, n).repeat_interleave(
        hpg, dim=1).float()                               # [b, nh, n]
    Ch = xbc[:, 0, di + g * n:].reshape(b, g, n).repeat_interleave(
        hpg, dim=1).float()
    dt = F.softplus(dt[:, 0].float() + p["dt_bias"])      # [b, nh]
    dA = torch.exp(dt * -torch.exp(p["A_log"]))
    upd = torch.einsum("bh,bhp,bhn->bhpn", dt, xs.float(), Bh)
    S = ssm_state * dA[..., None, None] + upd
    y = torch.einsum("bhpn,bhn->bhp", S, Ch)
    y = y + xs.float() * p["D"][None, :, None]
    y = y.reshape(b, 1, di).to(x.dtype)
    return _gated_out(p, cfg, y, z, x.dtype), (conv_state, S)


def ssd_state_shapes(cfg: ModelConfig, batch: int):
    conv_dim = cfg.d_inner + 2 * cfg.ssm_ngroups * cfg.ssm_state
    return {"conv": (batch, cfg.conv_width - 1, conv_dim),
            "ssm": (batch, cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_state)}
