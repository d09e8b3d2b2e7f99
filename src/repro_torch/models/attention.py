"""Attention layers: projections, causal prefill attention, and cached
single-token decode (dense, paged and sliding-window ring KV).

Prefill runs ``blocked_attention``, a plain-PyTorch port of the reference's
blocked online-softmax (its scan becomes a loop over blocks), or, for a
sliding window, ``banded_attention``, the port of the reference's banded
form (one KV band per query block). Decode over a linear buffer always goes
through the hand-written kernels of ``repro_torch.kernels.decode_attention``:
on a CUDA tensor they launch, on a CPU tensor their plain versions run.
Decode over a ring buffer (sliding window) stays plain PyTorch, as the
reference keeps it on its jnp path (attention.py:385).

Cross attention (encdec) is not ported yet: ROADMAP.md queue 1.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels.decode_attention.decode_attention import (
    decode_attention, paged_decode_attention)
from repro_torch.models.config import ModelConfig
from repro_torch.models import layers as L

NEG_INF = -1e30

_OTHER_FAMILIES = "ROADMAP.md queue 1 (encdec and frontends)"


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
# prefill: blocked online-softmax attention
# ---------------------------------------------------------------------------

def _pad_to(x, dim, multiple, value=0):
    n = x.shape[dim]
    pad = (-n) % multiple
    if pad == 0:
        return x
    shape = list(x.shape)
    shape[dim] = pad
    return torch.cat([x, x.new_full(shape, value)], dim=dim)


def blocked_attention(q, k, v, q_positions, k_positions, *, causal: bool,
                      window: int, block_q: int, block_kv: int,
                      softcap: float = 0.0):
    """Flash-style attention. q: [b, sq, hq, d]; k/v: [b, skv, kh, d];
    ``q_positions``/``k_positions``: [sq] / [skv] absolute positions (padding
    rows carry -1 keys). Scores and the running (m, l, o) statistics are
    f32; probabilities are rounded to v's dtype before the PV product, as in
    the reference."""
    b, sq, hq, d = q.shape
    kh = k.shape[2]
    g = hq // kh
    scale = 1.0 / math.sqrt(d)

    qp = _pad_to(q, 1, block_q)
    qpos = _pad_to(q_positions, 0, block_q)
    kp = _pad_to(k, 1, block_kv)
    vp = _pad_to(v, 1, block_kv)
    kpos = _pad_to(k_positions, 0, block_kv, value=-1)
    nq, nk = qp.shape[1] // block_q, kp.shape[1] // block_kv

    outs = []
    for iq in range(nq):
        qs = slice(iq * block_q, (iq + 1) * block_q)
        qblk = qp[:, qs].reshape(b, block_q, kh, g, d).float()
        qpb = qpos[qs]
        m = qblk.new_full((b, kh, g, block_q), NEG_INF)
        l = qblk.new_zeros((b, kh, g, block_q))
        o = qblk.new_zeros((b, kh, g, block_q, d))
        for ik in range(nk):
            ks = slice(ik * block_kv, (ik + 1) * block_kv)
            vblk = vp[:, ks]
            kpb = kpos[ks]
            s = torch.einsum("bqhgd,bkhd->bhgqk", qblk,
                             kp[:, ks].float()) * scale
            if softcap:
                s = L.softcap(s, softcap)
            valid = (kpb[None, :] >= 0)
            if causal:
                valid = valid & (kpb[None, :] <= qpb[:, None])
            if window:
                valid = valid & (kpb[None, :] > qpb[:, None] - window)
            s = torch.where(valid, s, torch.full_like(s, NEG_INF))
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            pv = torch.einsum("bhgqk,bkhd->bhgqd",
                              p.to(vblk.dtype).float(), vblk.float())
            o = o * alpha[..., None] + pv
            m = m_new
        o = o / torch.clamp(l[..., None], min=1e-37)
        # [b, kh, g, bq, d] -> [b, bq, kh*g, d]
        outs.append(o.permute(0, 3, 1, 2, 4).reshape(b, block_q, hq, d)
                    .to(q.dtype))
    return torch.cat(outs, dim=1)[:, :sq]


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
    qp = _pad_to(q, 1, block_q)
    qpos = _pad_to(q_positions, 0, block_q)
    skv = k.shape[1]
    # left-pad KV by the band so every band slice stays in range; both pads
    # (left band, right round-up) read as invalid positions
    kz = k.new_zeros((b, band, kh, d))
    kp = _pad_to(torch.cat([kz, k], dim=1), 1, block_q)
    vp = _pad_to(torch.cat([kz, v], dim=1), 1, block_q)
    kpos = _pad_to(torch.cat([k_positions.new_full((band,), -1),
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
    """Dispatch between the banded (sliding window) and blocked paths."""
    if cfg.sliding_window and causal:
        return banded_attention(q, k, v, qpos, kpos,
                                window=cfg.sliding_window,
                                block_q=cfg.attn_block_q,
                                softcap=cfg.attn_logits_softcap)
    return blocked_attention(q, k, v, qpos, kpos, causal=causal,
                             window=cfg.sliding_window,
                             block_q=cfg.attn_block_q,
                             block_kv=cfg.attn_block_kv,
                             softcap=cfg.attn_logits_softcap)


def cross_attention(p, cfg: ModelConfig, x, memory, mem_positions):
    raise NotImplementedError(
        f"cross attention (encdec) is not ported yet: {_OTHER_FAMILIES}")


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
