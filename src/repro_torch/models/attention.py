"""Attention layers: projections, whole-sequence attention (causal
prefill, the encoder's bidirectional self attention, cross attention) and
cached single-token decode (dense, paged and sliding-window ring KV, and
cross attention over the cached encoder K/V).

Whole-sequence attention without a window or a logit softcap goes through
the hand-written kernel of ``repro_torch.kernels.flash_attention`` (the
reference runs its jnp ``blocked_attention`` there, attention.py:283-304 and
:323-336); the plain blocked loop beside that kernel keeps the windowed and
softcapped cases, and a sliding window's prefill runs ``banded_attention``,
the port of the reference's banded form (one KV band per query block).
Decode over a linear buffer always goes through the hand-written kernels of
``repro_torch.kernels.decode_attention``. On a CUDA tensor the kernels
launch, on a CPU tensor their plain versions run. Decode over a ring buffer
(sliding window) and decode cross attention stay plain PyTorch, as the
reference keeps them on its jnp path (attention.py:385, :503-518).
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels.decode_attention.decode_attention import (
    decode_attention, paged_decode_attention)
from repro_torch.kernels.flash_attention.flash_attention import (
    blocked_attention, flash_attention, pad_to)
from repro_torch.models.config import ModelConfig
from repro_torch.models import layers as L

NEG_INF = -1e30


def _project_q(p, cfg: ModelConfig, x, positions):
    b, s, _ = x.shape
    q = L.matmul(x, p["w_q"]).reshape(b, s, cfg.num_heads, cfg.head_dim)
    if cfg.use_qk_norm:
        q = L.rmsnorm_apply(p["q_norm"], q, cfg.norm_eps)
    if positions is not None:
        q = L.rope_for(cfg, q, positions)
    return q


def _project_kv(p, cfg: ModelConfig, x, positions):
    b, s, _ = x.shape
    k = L.matmul(x, p["w_k"]).reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
    v = L.matmul(x, p["w_v"]).reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
    if cfg.use_qk_norm:
        k = L.rmsnorm_apply(p["k_norm"], k, cfg.norm_eps)
    if positions is not None:
        k = L.rope_for(cfg, k, positions)
    return k, v


def _out_proj(p, cfg: ModelConfig, o, x):
    b, s = o.shape[0], o.shape[1]
    return L.matmul(o.reshape(b, s, cfg.q_dim).to(x.dtype), p["w_o"])


# ---------------------------------------------------------------------------
# whole-sequence attention
# ---------------------------------------------------------------------------

def banded_attention(q, k, v, q_positions, k_positions, *, window: int,
                     block_q: int, softcap: float = 0.0):
    """Sliding-window causal attention with O(s·window) work. A query block
    starting at position p can only see the KV band
    ``[p + block_q - band, p + block_q)``, ``band = window + block_q``; each
    block attends its band in one softmax. q: [b, sq, hq, d]; k/v:
    [b, skv, kh, d]. Probabilities are normalised in f32 and rounded to v's
    dtype before the PV product, as in the reference."""
    b, sq, hq, d = q.shape
    kh = k.shape[2]
    g = hq // kh
    scale = 1.0 / math.sqrt(d)
    band = window + block_q
    qp = pad_to(q, 1, block_q)
    qpos = pad_to(q_positions, 0, block_q)
    skv = k.shape[1]
    # left-pad KV by the band so every band slice stays in range; both pads
    # (left band, right round-up) read as invalid positions
    kz = k.new_zeros((b, band, kh, d))
    kp = pad_to(torch.cat([kz, k], dim=1), 1, block_q)
    vp = pad_to(torch.cat([kz, v], dim=1), 1, block_q)
    kpos = pad_to(torch.cat([k_positions.new_full((band,), -1),
                              k_positions]), 0, block_q, value=-1)
    outs = []
    for iq in range(qp.shape[1] // block_q):
        start = iq * block_q
        qblk = qp[:, start:start + block_q].reshape(b, block_q, kh, g, d)
        qpb = qpos[start:start + block_q]
        kb = kp[:, start:start + band + block_q]
        vb = vp[:, start:start + band + block_q]
        kpb = kpos[start:start + band + block_q]
        s = torch.einsum("bqhgd,bkhd->bhgqk", qblk.float(), kb.float()) \
            * scale
        if softcap:
            s = L.softcap(s, softcap)
        valid = (kpb[None, :] >= 0) & (kpb[None, :] <= qpb[:, None]) \
            & (kpb[None, :] > qpb[:, None] - window)
        s = torch.where(valid, s, torch.full_like(s, NEG_INF))
        p = torch.exp(s - s.amax(dim=-1, keepdim=True))
        p = p / torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-37)
        o = torch.einsum("bhgqk,bkhd->bhgqd", p.to(vb.dtype).float(),
                         vb.float())
        outs.append(o.permute(0, 3, 1, 2, 4).reshape(b, block_q, hq, d)
                    .to(q.dtype))
    return torch.cat(outs, dim=1)[:, :sq]


def full_attention(q, k, v, qpos, kpos, cfg: ModelConfig, *, causal=True):
    """Dispatch: the banded path for a causal sliding window, the plain
    blocked loop for any other window or a logit softcap, and otherwise the
    ``flash_attention`` kernel (the rule the reference applies to its Pallas
    decode, attention.py:385)."""
    if cfg.sliding_window and causal:
        return banded_attention(q, k, v, qpos, kpos,
                                window=cfg.sliding_window,
                                block_q=cfg.attn_block_q,
                                softcap=cfg.attn_logits_softcap)
    if cfg.sliding_window or cfg.attn_logits_softcap:
        return blocked_attention(q, k, v, qpos, kpos, causal=causal,
                                 window=cfg.sliding_window,
                                 block_q=cfg.attn_block_q,
                                 block_kv=cfg.attn_block_kv,
                                 softcap=cfg.attn_logits_softcap)
    return flash_attention(q, k, v, qpos, kpos, causal=causal,
                           block_q=cfg.attn_block_q,
                           block_kv=cfg.attn_block_kv)


def project_cross_kv(p, cfg: ModelConfig, memory):
    """The encoder side's K/V [b, src, kh, hd], projected once per session
    (no RoPE on memory)."""
    return _project_kv(p, cfg, memory, None)


def cross_attention(p, cfg: ModelConfig, x, memory, mem_positions):
    """Decoder -> encoder attention of ``x`` [b, sq, d] over ``memory``
    [b, src, d] at ``mem_positions`` [src] int32: no causal mask, no RoPE.
    Through the ``flash_attention`` kernel, as the reference runs its
    ``blocked_attention`` with no window or softcap."""
    q = _project_q(p, cfg, x, None)
    k, v = project_cross_kv(p, cfg, memory)
    qpos = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    o = flash_attention(q, k, v, qpos, mem_positions, causal=False,
                        block_q=cfg.attn_block_q, block_kv=cfg.attn_block_kv)
    return _out_proj(p, cfg, o, x)


# ---------------------------------------------------------------------------
# decode: one new token per row against the cache
# ---------------------------------------------------------------------------

def _check_decode(cfg: ModelConfig) -> None:
    if cfg.attn_logits_softcap:
        raise NotImplementedError(
            "softcapped attention logits are not in the decode kernels yet "
            "(ROADMAP.md queue 1)")


def _write_row(cache_k, cache_v, k_new, v_new, slot, active):
    """Write each row's new K/V at its ``slot``, IN PLACE. The reference
    writes with a masked select over all S rows (one fused op in XLA); here
    it is an indexed write of the b new rows, and an inactive row writes
    back the value it already holds, so the step moves b rows of the cache,
    not the whole layer."""
    b = k_new.shape[0]
    rows = torch.arange(b, device=k_new.device)
    k_row, v_row = k_new[:, 0], v_new[:, 0]
    if active is not None:
        act = active[:, None, None]
        k_row = torch.where(act, k_row, cache_k[rows, slot])
        v_row = torch.where(act, v_row, cache_v[rows, slot])
    cache_k[rows, slot] = k_row.to(cache_k.dtype)
    cache_v[rows, slot] = v_row.to(cache_v.dtype)


def _ring_attention(cfg: ModelConfig, q, cache_k, cache_v, position,
                    window: int):
    """One query per row against a ring buffer of S slots: slot i holds the
    latest position ≡ i (mod S) at or before ``position``; keys older than
    the window are masked. Plain PyTorch, as in the reference. q:
    [b, 1, hq, hd] -> [b, 1, hq, hd] in q's dtype."""
    b, S = cache_k.shape[0], cache_k.shape[1]
    kh, hd = cfg.num_kv_heads, cfg.head_dim
    g = cfg.num_heads // kh
    idx = torch.arange(S, dtype=torch.int32, device=q.device)
    pos = position[:, None]
    kpos = pos - torch.remainder(pos - idx[None, :], S)
    valid = (kpos >= 0) & (kpos > pos - window)                 # [b, S]
    qh = q.reshape(b, 1, kh, g, hd).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qh, cache_k.float()) \
        / math.sqrt(hd)
    if cfg.attn_logits_softcap:
        s = L.softcap(s, cfg.attn_logits_softcap)
    s = torch.where(valid[:, None, None, None, :], s,
                    torch.full_like(s, NEG_INF))
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bhgqd", w.to(cache_v.dtype).float(),
                     cache_v.float())
    return o.permute(0, 3, 1, 2, 4).reshape(b, 1, cfg.num_heads, hd) \
        .to(q.dtype)


def decode_self_attention(p, cfg: ModelConfig, x, cache_k, cache_v, position,
                          *, window: int = 0, active=None):
    """Single-token decode against a linear KV buffer or, with ``window``,
    a ring buffer of S slots (position p lives in slot p % S).

    x: [b, 1, d]; cache_k/v: [b, S, kh, hd] (this layer's view of the
    engine cache, updated IN PLACE); position: [b] int32 absolute position
    of each row's new token. ``active`` ([b] bool, optional) suppresses the
    cache write of inactive rows. Returns (out, cache_k, cache_v).
    """
    if not window:
        _check_decode(cfg)
    b = x.shape[0]
    S = cache_k.shape[1]
    position = position.to(torch.int32).expand(b)
    q = _project_q(p, cfg, x, position[:, None])
    k_new, v_new = _project_kv(p, cfg, x, position[:, None])
    if window:
        _write_row(cache_k, cache_v, k_new, v_new,
                   torch.remainder(position, S).long(), active)
        o = _ring_attention(cfg, q, cache_k, cache_v, position, window)
        return _out_proj(p, cfg, o, x), cache_k, cache_v

    _write_row(cache_k, cache_v, k_new, v_new,
               torch.clamp(position, max=S - 1).long(), active)
    # clamp at the buffer: past position S-1 the linear cache holds exactly
    # S valid rows
    lengths = torch.clamp(position + 1, max=S).to(torch.int32)
    o = decode_attention(q[:, 0], cache_k.transpose(1, 2),
                         cache_v.transpose(1, 2), lengths)
    return _out_proj(p, cfg, o[:, None], x), cache_k, cache_v


def paged_decode_self_attention(p, cfg: ModelConfig, x, k_pages, v_pages,
                                block, position, *, active=None):
    """Single-token decode against a block-table paged KV pool.

    x: [b, 1, d]; k_pages/v_pages: [P, page, kh, hd] — this layer's slice of
    the global pool, updated IN PLACE; block: [b, PPS] int32 page ids per
    slot (page 0 is the shared scratch page); position: [b].

    Writes of inactive rows (and positions past the table) go to the scratch
    page, which is never read. The paged kernel does the dense kernel's
    arithmetic in the same row order, so dense and paged engines stay
    token-identical.
    """
    _check_decode(cfg)
    b = x.shape[0]
    page = k_pages.shape[1]
    S = block.shape[1] * page
    position = position.to(torch.int32).expand(b)
    q = _project_q(p, cfg, x, position[:, None])
    k_new, v_new = _project_kv(p, cfg, x, position[:, None])

    posc = torch.clamp(position, max=S - 1).long()
    pid = torch.gather(block, 1, (posc // page)[:, None])[:, 0].long()
    if active is not None:
        pid = torch.where(active, pid, torch.zeros_like(pid))
    off = posc % page
    k_pages[pid, off] = k_new[:, 0].to(k_pages.dtype)
    v_pages[pid, off] = v_new[:, 0].to(v_pages.dtype)

    lengths = torch.clamp(position + 1, max=S).to(torch.int32)
    o = paged_decode_attention(q[:, 0], k_pages, v_pages, lengths, block)
    return _out_proj(p, cfg, o[:, None], x), k_pages, v_pages


def decode_cross_attention(p, cfg: ModelConfig, x, mem_k, mem_v,
                           mem_positions):
    """One query per row against the cached encoder K/V ``mem_k``/``mem_v``
    [b, src, kh, hd] (keys at ``mem_positions`` < 0 masked). Plain
    PyTorch, as in the reference: f32 scores and softmax, the weights
    rounded to v's dtype before the PV product. x: [b, 1, d] -> [b, 1, d]."""
    b = x.shape[0]
    kh, hd = cfg.num_kv_heads, cfg.head_dim
    g = cfg.num_heads // kh
    q = _project_q(p, cfg, x, None)
    qh = q.reshape(b, 1, kh, g, hd).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qh, mem_k.float()) / math.sqrt(hd)
    s = torch.where(mem_positions >= 0, s, torch.full_like(s, NEG_INF))
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bhgqd", w.to(mem_v.dtype).float(),
                     mem_v.float())
    o = o.permute(0, 3, 1, 2, 4).reshape(b, 1, cfg.num_heads, hd)
    return _out_proj(p, cfg, o.to(x.dtype), x)
