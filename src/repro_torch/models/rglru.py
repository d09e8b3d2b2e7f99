"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427).

    y1  = conv1d(W_x · x)            (depthwise causal, width 4)
    h   = RG-LRU(y1)                 (gated diagonal linear recurrence)
    y2  = GeLU(W_gate · x)
    out = W_out · (h ⊙ y2)

RG-LRU:
    r_t = σ(BlockDiag_a(x_t)),  i_t = σ(BlockDiag_i(x_t))
    log a_t = -c · softplus(Λ) ⊙ r_t   (c = 8)
    h_t = a_t ⊙ h_{t-1} + sqrt(1 - a_t²) ⊙ (i_t ⊙ x_t)

The sequence paths (prefill, and the training forward) run the recurrence
through the hand-written ``rglru_scan`` kernel (on a CPU tensor, its plain
version: the reference's chunked scan); while autograd records, through
``RGLRUScan``, whose backward is the same kernel run in reverse, so the
block trains on the card. The single-token decode step stays plain
PyTorch, as in the reference. Layouts and dtypes are the reference's (``repro.models.rglru``):
the gates, Λ and the recurrent state ``h`` are f32; the conv state and the
projections are in ``cfg.dtype``.

Under a mesh (DTensors inside ``use_mesh``) the block runs on every rank's
columns of w, with the planner's layout: ``w_x`` and ``w_gate`` split on
their w columns, the conv, Λ and the states on w, ``w_out`` on its w rows.
Everything between the two products is elementwise over w but the gates'
block-diagonal products, which stay local where a rank's columns are whole
blocks (``_block_diag_sharded``: one block of 160 a rank at 16-way); the
scan runs on the rank's columns (``rglru_scan``'s DTensor route, no
collective); ``w_out``'s product is a partial sum over the model axis,
reduced at the block's residual (``models.transformer``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import sharded as SH
from repro_torch.kernels.rglru_scan.rglru_scan import rglru_scan
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig

_C = 8.0
_NBLOCKS = 16  # block-diagonal gate heads


def rglru_init(cfg: ModelConfig, normal, uniform):
    """One layer's params with the reference's shapes, scales and dtypes:
    ``normal(shape, scale, dtype)`` and ``uniform(shape, lo, hi)`` draw from
    the caller's generator."""
    dt = L.dtype_of(cfg)
    d, w, K = cfg.d_model, cfg.lru_width or cfg.d_model, cfg.conv_width
    bs = w // _NBLOCKS
    u = uniform((w,), 0.9, 0.999)
    # Λ such that a = σ(Λ)^c spans (0.9, 0.999): softplus^-1(-log u / c)
    lam = torch.log(torch.expm1(-torch.log(u) / _C))
    return {
        "w_x": normal((d, w), 1.0 / math.sqrt(d), dt),
        "w_gate": normal((d, w), 1.0 / math.sqrt(d), dt),
        "w_out": normal((w, d), 1.0 / math.sqrt(w), dt),
        "conv": normal((K, w), 1.0 / math.sqrt(K), dt),
        "gate_a": normal((_NBLOCKS, bs, bs), 1.0 / math.sqrt(bs),
                         torch.float32),
        "gate_i": normal((_NBLOCKS, bs, bs), 1.0 / math.sqrt(bs),
                         torch.float32),
        "lambda": lam,
    }


def _block_diag(w, x):
    """x: [..., width] -> block-diagonal linear in f32, blocks w
    [nb, bs, bs] (nb bs = width: _NBLOCKS of them, or a rank's own). The
    train step's bf16 copy of w is read in f32, as the reference's einsum
    promotes it."""
    if SH.is_dtensor(x):
        return _block_diag_sharded(w, x)
    shape = x.shape
    xb = x.reshape(shape[:-1] + (w.shape[0], shape[-1] // w.shape[0])).float()
    return torch.einsum("...nb,nbc->...nc", xb, w.float()).reshape(shape)


def _block_diag_sharded(w, x):
    """``_block_diag`` of a DTensor x on every rank's shards
    (``local_map``), mesh dim by mesh dim: where x's width splits into
    whole blocks (the axis divides _NBLOCKS) each rank multiplies its
    columns by its own blocks of w (w split on its blocks); a split of the
    leading dims keeps w whole, its gradient then a partial sum; any other
    layout of x (a width split into parts of blocks, a partial sum) is
    taken whole first, explicitly."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = x.device_mesh
    last = x.dim() - 1
    R = Replicate()
    xp, wp, wg = [], [], []
    for i, pl in enumerate(x.placements):
        size = mesh.size(i)
        if size > 1 and pl.is_shard(last) and _NBLOCKS % size == 0:
            row = (Shard(last), Shard(0), Shard(0))
        elif size > 1 and pl.is_shard() and pl.dim < last:
            row = (pl, R, Partial())
        else:
            row = (R, R, R)
        for col, v in zip((xp, wp, wg), row):
            col.append(v)
    x = SH.redistribute(x, mesh, xp)
    w = SH.redistribute(w, mesh, wp)
    return local_map(_block_diag, out_placements=xp, in_placements=(wp, xp),
                     in_grad_placements=(wg, xp), device_mesh=mesh)(w, x)


def _gates(p, x):
    """a_t and the sqrt(1 - a²)·i_t multiplier, f32. x: [..., w]."""
    r = torch.sigmoid(_block_diag(p["gate_a"], x))
    i = torch.sigmoid(_block_diag(p["gate_i"], x))
    a = torch.exp(-_C * F.softplus(p["lambda"]) * r)
    mult = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * i
    return a, mult


def causal_conv(w, x, state=None, length=None):
    """Depthwise causal conv of width K (``w``: [K, c]) over x [b, l, c], as
    the reference's sum of shifted products (not ``F.conv1d``, which cuDNN
    would run in TF32). ``state`` [b, K-1, c]: carried inputs for decode.
    ``length``: true length of a right-padded bucket — the carried state is
    the last K-1 *real* inputs, ``xp[:, length:length+K-1]``. Returns
    (y in x's dtype, new_state)."""
    K = w.shape[0]
    if state is None:
        pad = x.new_zeros((x.shape[0], K - 1, x.shape[2]))
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    y = sum(xp[:, i: i + x.shape[1]] * w[i] for i in range(K))
    start = xp.shape[1] - (K - 1) if length is None else int(length)
    return y.to(x.dtype), xp[:, start: start + K - 1]


def _gate_branch(p, x):
    """GeLU(W_gate · x) in f32 (tanh form, as ``jax.nn.gelu``)."""
    return F.gelu(L.matmul(x, p["w_gate"]).float(), approximate="tanh")


def rglru_block_prefill(p, cfg: ModelConfig, x, length=None):
    """Sequence path of one block. x: [b, l, d] -> (out [b, l, d],
    conv_state [b, K-1, w], h [b, w] f32). On a right-padded bucket
    (``length`` < l) the padded steps get a = 1, b = 0, the identity, so
    the returned ``h`` is the state at ``length``."""
    xw = L.matmul(x, p["w_x"])
    xw, conv_state = causal_conv(p["conv"], xw, length=length)
    a, mult = _gates(p, xw)
    b = mult * xw.float()
    if length is not None and length < x.shape[1]:
        valid = (torch.arange(x.shape[1], device=x.device)
                 < length)[None, :, None]
        a = torch.where(valid, a, torch.ones_like(a))
        b = torch.where(valid, b, torch.zeros_like(b))
    h0 = torch.zeros((x.shape[0], xw.shape[-1]), dtype=torch.float32,
                     device=x.device)
    hs = rglru_scan(a.contiguous(), b.contiguous(), h0)
    out = (hs * _gate_branch(p, x)).to(x.dtype)
    return L.matmul(out, p["w_out"]), conv_state, hs[:, -1]


def rglru_block_apply(p, cfg: ModelConfig, x):
    """Sequence path of one block for the full-sequence forward (training):
    x [b, l, d] -> [b, l, d]. As the reference's ``rglru_block_apply``, the
    scanned state is rounded to x's dtype before the gate product (the
    prefill path keeps it in f32, as the reference's ``_block_prefill``
    does)."""
    xw = L.matmul(x, p["w_x"])
    xw, _ = causal_conv(p["conv"], xw)
    a, mult = _gates(p, xw)
    b = mult * xw.float()
    h0 = torch.zeros((x.shape[0], xw.shape[-1]), dtype=torch.float32,
                     device=x.device)
    h = rglru_scan(a.contiguous(), b.contiguous(), h0).to(x.dtype)
    out = (h.float() * _gate_branch(p, x)).to(x.dtype)
    return L.matmul(out, p["w_out"])


def rglru_block_decode(p, cfg: ModelConfig, x, conv_state, h_state):
    """Single-token path. x: [b, 1, d]; conv_state: [b, K-1, w]; h_state:
    [b, w] f32. Returns (out, conv_state, h_state)."""
    xw = L.matmul(x, p["w_x"])
    xw, conv_state = causal_conv(p["conv"], xw, conv_state)
    a, mult = _gates(p, xw)
    h = a[:, 0] * h_state + (mult * xw.float())[:, 0]
    out = (h[:, None] * _gate_branch(p, x)).to(x.dtype)
    return L.matmul(out, p["w_out"]), conv_state, h


def rglru_state_shapes(cfg: ModelConfig, batch: int):
    w = cfg.lru_width or cfg.d_model
    return {"conv": (batch, cfg.conv_width - 1, w), "h": (batch, w)}
