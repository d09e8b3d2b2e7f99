"""Shared neural-net layers (plain functions on tensors, dict params).

Conventions follow the reference package: weights are stored in
``cfg.dtype`` (bf16 by default), norm scales in f32; normalisation and
rotary embeddings compute in f32 and cast back; matmuls run in the working
dtype (cuBLAS accumulates bf16 products in f32 and rounds the result once).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import sharded as SH
from repro_torch.models.config import ModelConfig
from repro_torch.models.quant import as_weight
from repro_torch.sharding.ctx import constrain, pin

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def gathered(w, x):
    """``w`` ready for a product with ``x``: on DTensors, ``w``'s shards
    over the mesh dims that split ``x``'s batch, and over the data axes
    where a batch too small to split leaves ``x`` whole (the data axes:
    training's ZeRO-3 layout, weight-gathered serving), are gathered
    first, as GSPMD gathers them in the reference; autograd turns the
    gather into the gradient's reduce-scatter. Left to itself, DTensor
    would rather split the activations' sequence over those dims. Plain
    tensors pass."""
    if not (SH.is_dtensor(w) and SH.is_dtensor(x)):
        return w
    from torch.distributed.tensor import Replicate
    mesh = w.device_mesh
    names = mesh.mesh_dim_names or ()
    data = {i for i, a in enumerate(names) if a in ("pod", "data")}
    pls = [Replicate() if pw.is_shard() and (
        px.is_shard(0) or (i in data and px.is_replicate())) else pw
        for i, (pw, px) in enumerate(zip(w.placements, x.placements))]
    return SH.redistribute(w, mesh, pls)


def matmul(x: torch.Tensor, w) -> torch.Tensor:
    """``x @ w`` for a plain or int8-quantised weight, in ``x``'s dtype
    (int8 dequantises to bf16 first, as the reference does)."""
    return torch.matmul(x, gathered(as_weight(w).to(x.dtype), x))


def embedding(table, tokens) -> torch.Tensor:
    """Rows ``tokens`` of ``table`` [V, d] (``F.embedding``). On a DTensor
    table split over the vocabulary (the planner's rule), each rank looks
    up the tokens that fall in its own rows and zeros the rest, and the
    ranks that split the vocabulary sum their parts: the reference's
    vocab-parallel gather, with no gather of the table. Written out with
    ``local_map`` rather than left to DTensor's masked-partial embedding,
    whose reduction fails once the tokens are also split over the batch;
    the sum is taken inside, so the gradient of the (replicated) result
    reaches each rank's rows as it is."""
    if not SH.is_dtensor(table):
        return F.embedding(tokens, table)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = table.device_mesh
    tokens = SH.as_dtensor(tokens, mesh)
    t_pl, k_pl, o_pl, g_pl, groups = [], [], [], [], []
    for i, (tp, kp) in enumerate(zip(table.placements, tokens.placements)):
        if tp.is_shard(0):                  # this dim splits the vocabulary
            t_pl.append(Shard(0))
            k_pl.append(Replicate())
            o_pl.append(Replicate())
            g_pl.append(Shard(0))
            if mesh.size(i) > 1:
                groups.append(mesh.get_group(i))
        else:
            t_pl.append(Replicate())
            k_pl.append(Shard(0) if kp.is_shard(0) else Replicate())
            o_pl.append(k_pl[-1])
            g_pl.append(Partial() if kp.is_shard(0) else Replicate())
    table = SH.redistribute(table, mesh, t_pl)
    tokens = SH.redistribute(tokens, mesh, k_pl)
    v0, rows = SH.shard_span(mesh, t_pl, 0, table.shape[0])

    def local(tl, kl):
        hit = (kl >= v0) & (kl < v0 + rows)
        e = F.embedding(torch.where(hit, kl - v0, torch.zeros_like(kl)), tl)
        return SH.sum_over(torch.where(hit[..., None], e,
                                       torch.zeros_like(e)), groups)

    return local_map(local, out_placements=o_pl, in_placements=(t_pl, k_pl),
                     in_grad_placements=(g_pl, k_pl),
                     device_mesh=mesh)(table, tokens)


def logsumexp_gold(logits, labels):
    """(log-sum-exp over the vocabulary, the logit at ``labels``) of
    ``logits`` [..., V], both [...]; ``labels`` >= 0. On DTensor logits
    split over the vocabulary this is the vocab-parallel cross-entropy's
    reduction, written out with ``local_map``: each rank takes the max,
    the sum of exponentials and the gold logit over its own columns, and
    the ranks combine them (a max all-reduce, then the sums' partial
    results, which DTensor resolves): no rank ever holds a whole row of
    the vocabulary. Where no mesh dim of more than one rank splits the
    vocabulary, every rank runs the plain ops on its rows."""
    idx = labels.long()
    if not SH.is_dtensor(logits):
        return (torch.logsumexp(logits, dim=-1),
                torch.gather(logits, -1, idx[..., None])[..., 0])
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = logits.device_mesh
    last = logits.dim() - 1
    l_pl, o_pl, p_pl, groups = [], [], [], []
    for i, p in enumerate(logits.placements):
        if p.is_shard(last) and mesh.size(i) > 1:
            l_pl.append(Shard(last))
            o_pl.append(Replicate())
            p_pl.append(Partial())
            groups.append(mesh.get_group(i))
        elif p.is_shard(0):
            l_pl.append(Shard(0))
            o_pl.append(Shard(0))
            p_pl.append(Shard(0))
        else:
            l_pl.append(Replicate())
            o_pl.append(Replicate())
            p_pl.append(Replicate())
    logits = SH.redistribute(logits, mesh, l_pl)
    idx = SH.redistribute(idx, mesh, o_pl)
    if not groups:
        return local_map(lambda lg, ix: (
            torch.logsumexp(lg, dim=-1),
            torch.gather(lg, -1, ix[..., None])[..., 0]),
            out_placements=(o_pl, o_pl), in_placements=(l_pl, o_pl),
            in_grad_placements=(l_pl, o_pl), device_mesh=mesh)(logits, idx)
    v0, cols = SH.shard_span(mesh, l_pl, last, logits.shape[-1])

    def local(lg, ix):
        m = lg.detach().amax(dim=-1)
        for grp in groups:
            m = funcol.all_reduce(m, "max", grp)
        m = m.wait() if hasattr(m, "wait") else m
        se = torch.exp(lg - m[..., None]).sum(dim=-1)
        hit = (ix >= v0) & (ix < v0 + cols)
        g = torch.gather(lg, -1, torch.where(hit, ix - v0,
                                             torch.zeros_like(ix))[..., None])
        return m, se, torch.where(hit, g[..., 0], torch.zeros_like(m))

    m, se, gold = local_map(local, out_placements=(o_pl, p_pl, p_pl),
                            in_placements=(l_pl, o_pl),
                            in_grad_placements=(l_pl, o_pl),
                            device_mesh=mesh)(logits, idx)
    return m + torch.log(se), gold


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rmsnorm_apply(p, x: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm over the last dim, in f32. On a DTensor split over that dim
    (the SSD's head-split output) the mean square is a partial mean, and
    it is all-reduced here, explicitly and in both directions, a [..., 1]
    tensor: DTensor would rather settle it by splitting the sequence."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    if SH.is_dtensor(var) and any(p_.is_partial() for p_ in var.placements):
        from torch.distributed.tensor import Replicate
        var = pin(var, [Replicate() if p_.is_partial() else p_
                        for p_ in var.placements])
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
    h = constrain(h, *(["dp"] + [None] * (h.dim() - 2) + ["model"]))
    return matmul(h, p["w_down"])


# ---------------------------------------------------------------------------
# softcap
# ---------------------------------------------------------------------------

def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if not cap:
        return x
    return torch.tanh(x / cap) * cap
