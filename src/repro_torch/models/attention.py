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

On DTensors (inside ``use_mesh``) the kernels take every rank's shards
through their wrappers' ``local_map``; the banded prefill does the same
(``banded_sharded``), and ring decode reads each rank's own slots of the
ring and merges the ranks' (o, lse) where the ring splits on S
(``_masked_decode_sharded``), as ``seq_sharded_decode`` does for a linear
cache; decode cross attention reads each rank's rows and heads of the
cross cache, or its own source slots, through the same route.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import sharded as SH
from repro_torch.kernels.decode_attention.decode_attention import (
    decode_attention, paged_decode_attention)
from repro_torch.kernels.flash_attention.flash_attention import (
    blocked_attention, flash_attention, pad_to)
from repro_torch.models.config import ModelConfig
from repro_torch.models import layers as L
from repro_torch.sharding.ctx import constrain, current_mesh

NEG_INF = -1e30


def _project_q(p, cfg: ModelConfig, x, positions):
    b, s, _ = x.shape
    q = L.matmul(x, p["w_q"]).reshape(b, s, cfg.num_heads, cfg.head_dim)
    q = constrain(q, "dp", None, "model", None)
    if cfg.use_qk_norm:
        q = L.rmsnorm_apply(p["q_norm"], q, cfg.norm_eps)
    if positions is not None:
        q = L.rope_for(cfg, q, positions)
    return q


def _project_kv(p, cfg: ModelConfig, x, positions):
    b, s, _ = x.shape
    k = L.matmul(x, p["w_k"]).reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
    v = L.matmul(x, p["w_v"]).reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
    k = constrain(k, "dp", None, "model", None)
    v = constrain(v, "dp", None, "model", None)
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


def banded_sharded(q, k, v, q_positions, k_positions, *, window: int,
                   block_q: int, softcap: float = 0.0):
    """``banded_attention`` on DTensors: every rank runs it on its batch
    rows and query heads through ``local_map``, in the layout
    ``kernels.sharded.attention_layout`` picks for the flash kernel (K/V
    split with the query heads where the KV heads divide the model axis,
    else replicated, each rank handed the KV heads of its own query heads;
    their gradient then a partial sum). The positions are taken whole."""
    from torch.distributed.tensor.experimental import local_map
    mesh = q.device_mesh
    k, v = SH.as_dtensor(k, mesh), SH.as_dtensor(v, mesh)
    lay = SH.attention_layout(q, k, batch=0, q_heads=2, q_rows=None,
                              kv_heads_dim=2, hq=q.shape[2], kh=k.shape[2])
    q = SH.redistribute(q, mesh, lay.q)
    k = SH.redistribute(k, mesh, lay.kv)
    v = SH.redistribute(v, mesh, lay.kv)
    qpos = SH.replicated_value(q_positions)
    kpos = SH.replicated_value(k_positions)

    def local(ql, kl, vl):
        return banded_attention(ql, SH.select_kv_heads(kl, lay, 2),
                                SH.select_kv_heads(vl, lay, 2), qpos, kpos,
                                window=window, block_q=block_q,
                                softcap=softcap)

    qp, kvp, kvg = list(lay.q), list(lay.kv), list(lay.kv_grad)
    return local_map(local, out_placements=qp, in_placements=(qp, kvp, kvp),
                     in_grad_placements=(qp, kvg, kvg),
                     device_mesh=mesh)(q, k, v)


def qwhole_attention(q, k, v, q_positions, k_positions, *, causal: bool,
                     window: int, block_kv: int, softcap: float = 0.0):
    """Sequence-parallel attention, the port of the reference's
    ``qwhole_attention`` (its attention.py:247): q kept whole, its seq dim
    carrying the model axis's split, one online softmax over KV blocks of
    ``block_kv``. Used when the head counts don't divide the model axis
    (phi3-medium-14b's 40 heads on a 16-way axis): head-split tiles would
    be replicated, so each rank takes its rows of q against the whole
    K/V instead.

    This is the ``flash_attention`` kernel with one query block: on a
    DTensor q split on its rows, every rank's kernel takes its own rows at
    their own positions (``kernels.sharded``); on the CPU its plain
    version is the reference's scan. A window or a softcap (which the
    kernel does not take) runs the plain blocked loop with the same one
    query block."""
    if window or softcap:
        return blocked_attention(q, k, v, q_positions, k_positions,
                                 causal=causal, window=window,
                                 block_q=q.shape[1], block_kv=block_kv,
                                 softcap=softcap)
    return flash_attention(q, k, v, q_positions, k_positions, causal=causal,
                           block_q=q.shape[1], block_kv=block_kv)


def _heads_shardable(cfg: ModelConfig) -> bool:
    """Whether the query heads split evenly over the ambient mesh's model
    axis (always, outside a mesh)."""
    from repro_torch.sharding.planner import axis_sizes
    mesh = current_mesh()
    if mesh is None or "model" not in axis_sizes(mesh):
        return True
    return cfg.num_heads % axis_sizes(mesh)["model"] == 0


def full_attention(q, k, v, qpos, kpos, cfg: ModelConfig, *, causal=True):
    """Dispatch, as the reference's (its attention.py:276-297): the banded
    path for a causal sliding window; ``qwhole_attention`` inside a mesh
    whose model axis the query heads do not divide; the plain blocked loop
    for any other window or a logit softcap; and otherwise the
    ``flash_attention`` kernel (the rule the reference applies to its
    Pallas decode, attention.py:385)."""
    if cfg.sliding_window and causal:
        band = banded_sharded if SH.is_dtensor(q) else banded_attention
        return band(q, k, v, qpos, kpos, window=cfg.sliding_window,
                    block_q=cfg.attn_block_q,
                    softcap=cfg.attn_logits_softcap)
    if not _heads_shardable(cfg):
        q = constrain(q, "dp", "model", None, None)
        o = qwhole_attention(q, k, v, qpos, kpos, causal=causal,
                             window=cfg.sliding_window,
                             block_kv=cfg.attn_block_kv,
                             softcap=cfg.attn_logits_softcap)
        # the rows back together before the output projection: a product
        # over [b, s] flattened with s split and b split too is a layout
        # DTensor can plan only by reading data
        return constrain(o, "dp", None, None, None)
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
    if SH.is_dtensor(cache_k):
        return _ring_attention_sharded(cfg, q, cache_k, cache_v, position,
                                       window)
    return _masked_decode(cfg, q, cache_k, cache_v,
                          _ring_valid(position, 0, cache_k.shape[1],
                                      cache_k.shape[1], window))


def _ring_valid(position, s0: int, n: int, S: int, window: int):
    """[b, n] which of the ring's slots ``[s0, s0 + n)`` of S hold a key
    inside the window of each row's ``position``: slot i holds the latest
    position ≡ i (mod S) at or before it."""
    idx = torch.arange(s0, s0 + n, dtype=torch.int32, device=position.device)
    pos = position[:, None]
    kpos = pos - torch.remainder(pos - idx[None, :], S)
    return (kpos >= 0) & (kpos > pos - window)


def _ring_attention_sharded(cfg: ModelConfig, q, cache_k, cache_v, position,
                            window: int):
    """``_ring_attention`` over a DTensor ring [b, S, kh, hd]: each rank
    masks its own slots of S by its rows' ``position``
    (``_masked_decode_sharded``). -> [b, 1, hq, hd] in q's dtype."""
    S = cache_k.shape[1]
    return _masked_decode_sharded(
        cfg, q, cache_k, cache_v,
        lambda pos, s0, n: _ring_valid(pos, s0, n, S, window), position)


def _masked_decode_sharded(cfg: ModelConfig, q, cache_k, cache_v, valid,
                           position=None):
    """``_masked_decode`` over a DTensor cache [b, S, kh, hd] on every
    rank's shards (``local_map``): each rank takes its batch rows and its
    KV heads with their query heads, where the cache splits them, and its
    own slots ``[s0, s0 + n)`` of S, masked by ``valid(pos, s0, n)``
    ([rows or 1, n] bool; ``pos`` is the rank's rows of ``position`` [b],
    None without it). Where S is split, each rank's masked softmax over its
    slots gives (o, lse), and the ranks merge them with a max and a sum
    all-reduce over the mesh dims that split S (the cache is never
    gathered); a rank holding no valid slot of a row gives lse -inf and
    weight 0. Any other layout (a split head_dim, a partial sum, an uneven
    split) raises. -> [b, 1, hq, hd] in q's dtype."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = cache_k.device_mesh
    pls = list(cache_k.placements)
    b, S, kh = cache_k.shape[:3]
    hq = q.shape[2]
    q_pl = []
    for i, pl in enumerate(pls):
        n = mesh.size(i)
        if pl.is_shard(0) and b % n == 0:
            q_pl.append(Shard(0))
        elif pl.is_shard(2) and kh % n == 0 and hq % n == 0:
            q_pl.append(Shard(2))
        elif pl.is_replicate() or (pl.is_shard(1) and S % n == 0):
            q_pl.append(Replicate())
        else:
            raise ValueError(
                f"masked decode: the cache's placement {pl} on mesh dim {i} "
                f"({n} ranks) splits none of its batch, KV heads or slots "
                f"evenly")
    p_pl = [Shard(0) if p.is_shard(0) else Replicate() for p in pls]
    args, in_pl = [SH.redistribute(q, mesh, q_pl), cache_k, cache_v], \
        [q_pl, pls, pls]
    if position is not None:
        args.append(SH.redistribute(position, mesh, p_pl))
        in_pl.append(p_pl)
    s0, n = SH.shard_span(mesh, pls, 1, S)
    groups = [mesh.get_group(i) for i, p in enumerate(pls) if p.is_shard(1)]

    def local(ql, ck, cv, pos=None):
        mask = valid(pos, s0, n)
        if not groups:
            return _masked_decode(cfg, ql, ck, cv, mask)
        o, lse = _masked_decode(cfg, ql, ck, cv, mask, return_lse=True)
        return _merge_partials(o, lse, groups)

    return local_map(local, out_placements=q_pl, in_placements=tuple(in_pl),
                     device_mesh=mesh)(*args)


def _linear_attention(cfg: ModelConfig, q, cache_k, cache_v, position):
    """One query per row against a linear buffer, slot i holding position
    i, keys after ``position`` masked: the reference's plain decode, which
    it keeps for softcapped logits (its attention.py:385, :483-500)."""
    S = cache_k.shape[1]
    idx = torch.arange(S, dtype=torch.int32, device=q.device)
    return _masked_decode(cfg, q, cache_k, cache_v,
                          idx[None, :] <= position[:, None])


def _masked_decode(cfg: ModelConfig, q, cache_k, cache_v, valid,
                   return_lse: bool = False):
    """The reference's plain masked-softmax decode of q [b, 1, hq, hd]
    over cache_k/v [b, S, kh, hd] where ``valid`` [b, S]: f32 scores, the
    logit softcap, softmax, weights rounded to v's dtype before the PV
    product. -> [b, 1, hq, hd] in q's dtype (the head counts are the
    tensors'); with ``return_lse`` also each head's log-sum-exp of its
    valid scores [b, 1, hq] f32, -inf where none is valid."""
    b, hq = q.shape[0], q.shape[2]
    kh, hd = cache_k.shape[2], cfg.head_dim
    g = hq // kh
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
    o = o.permute(0, 3, 1, 2, 4).reshape(b, 1, hq, hd).to(q.dtype)
    if not return_lse:
        return o
    lse = torch.logsumexp(s, dim=-1)                        # [b, kh, g, 1]
    lse = torch.where(valid.any(-1)[:, None, None, None], lse,
                      torch.full_like(lse, -math.inf))
    return o, lse.permute(0, 3, 1, 2).reshape(b, 1, hq)


def decode_self_attention(p, cfg: ModelConfig, x, cache_k, cache_v, position,
                          *, window: int = 0, active=None):
    """Single-token decode against a linear KV buffer or, with ``window``,
    a ring buffer of S slots (position p lives in slot p % S).

    x: [b, 1, d]; cache_k/v: [b, S, kh, hd] (this layer's view of the
    engine cache, updated IN PLACE); position: [b] int32 absolute position
    of each row's new token. ``active`` ([b] bool, optional) suppresses the
    cache write of inactive rows. Returns (out, cache_k, cache_v).
    """
    b = x.shape[0]
    S = cache_k.shape[1]
    position = position.to(torch.int32).expand(b)
    q = _project_q(p, cfg, x, position[:, None])
    k_new, v_new = _project_kv(p, cfg, x, position[:, None])
    write = _write_row_sharded if SH.is_dtensor(cache_k) else _write_row
    if window:
        write(cache_k, cache_v, k_new, v_new,
              torch.remainder(position, S).long(), active)
        o = _ring_attention(cfg, q, cache_k, cache_v, position, window)
        return _out_proj(p, cfg, o, x), cache_k, cache_v

    write(cache_k, cache_v, k_new, v_new,
          torch.clamp(position, max=S - 1).long(), active)
    if cfg.attn_logits_softcap:      # the kernels take no softcap
        o = _linear_attention(cfg, q, cache_k, cache_v, position)
        return _out_proj(p, cfg, o, x), cache_k, cache_v
    # clamp at the buffer: past position S-1 the linear cache holds exactly
    # S valid rows
    lengths = torch.clamp(position + 1, max=S).to(torch.int32)
    if SH.is_dtensor(cache_k) and any(pl.is_shard(1)
                                      for pl in cache_k.placements):
        o = seq_sharded_decode(q[:, 0], cache_k, cache_v, lengths)
    else:
        o = decode_attention(q[:, 0], cache_k.transpose(1, 2),
                             cache_v.transpose(1, 2), lengths)
    return _out_proj(p, cfg, o[:, None], x), cache_k, cache_v


def _write_row_sharded(cache_k, cache_v, k_new, v_new, slot, active):
    """``_write_row`` on a DTensor cache [b, S, kh, hd], rank by rank on
    the local shards: each rank writes the new rows of its own batch rows
    (and KV heads) whose slot falls in its own rows of S; the others keep
    their bits. The new K/V take the cache's layout first (S whole)."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = cache_k.device_mesh
    pls = tuple(cache_k.placements)
    row_pl = tuple(Replicate() if p.is_shard(1) else p for p in pls)
    b_pl = tuple(Shard(0) if p.is_shard(0) else Replicate() for p in pls)
    kn = SH.redistribute(k_new, mesh, row_pl).to_local()
    vn = SH.redistribute(v_new, mesh, row_pl).to_local()
    sl = SH.redistribute(slot, mesh, b_pl).to_local()
    act = None if active is None else \
        SH.redistribute(active, mesh, b_pl).to_local()
    ck, cv = cache_k.to_local(), cache_v.to_local()
    s0, S_l = SH.shard_span(mesh, pls, 1, cache_k.shape[1])
    own = (sl >= s0) & (sl < s0 + S_l)
    _write_row(ck, cv, kn, vn, torch.clamp(sl - s0, 0, S_l - 1),
               own if act is None else own & act)


def _merge_partials(o, lse, groups):
    """The softmax over every rank's keys from each rank's own (o [..., hd],
    its lse [...] f32, -inf where the rank holds no valid key): a max and
    a sum all-reduce over ``groups``, the ranks that split the keys; a
    rank with lse -inf weighs 0 and its o is never read. -> in o's
    dtype."""
    from torch.distributed import _functional_collectives as funcol
    m = lse
    for grp in groups:
        m = funcol.all_reduce(m, "max", grp)
    live = lse > -math.inf
    w = torch.where(live, torch.exp(lse - torch.where(live, m, 0.0)),
                    torch.zeros_like(lse))
    num = torch.where(live[..., None], o.float() * w[..., None],
                      torch.zeros_like(o, dtype=torch.float32))
    for grp in groups:
        num = funcol.all_reduce(num, "sum", grp)
        w = funcol.all_reduce(w, "sum", grp)
    den = torch.where(w > 0, w, torch.ones_like(w))
    return (num / den[..., None]).to(o.dtype)


def seq_sharded_decode(q, cache_k, cache_v, lengths):
    """Decode attention over a cache split on S (the planner's layout when
    the KV heads do not divide the model axis): each rank runs the decode
    kernel over its own rows of S, with ``return_lse``, and the ranks
    merge their partial (o, lse) with a max and a sum all-reduce over the
    mesh dims that split S (the distributed softmax GSPMD forms in the
    reference). A rank holding no valid row of a batch row gives lse -inf
    and weight 0, never NaN. q [b, hq, hd]; cache_k/v [b, S, kh, hd]
    DTensors; lengths [b] int32 -> [b, hq, hd] in q's dtype."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = cache_k.device_mesh
    pls = list(cache_k.placements)
    q_pl = [Shard(0) if p.is_shard(0) else Replicate() for p in pls]
    q = SH.redistribute(q, mesh, q_pl)
    lengths = SH.redistribute(lengths, mesh, q_pl)
    s0, S_l = SH.shard_span(mesh, pls, 1, cache_k.shape[1])
    groups = [mesh.get_group(i) for i, p in enumerate(pls) if p.is_shard(1)]

    def local(ql, ck, cv, ll):
        ll = torch.clamp(ll - s0, 0, S_l).to(torch.int32)
        o, lse = decode_attention(ql, ck.transpose(1, 2), cv.transpose(1, 2),
                                  ll, return_lse=True)
        return _merge_partials(o, lse, groups)

    return local_map(local, out_placements=q_pl,
                     in_placements=(q_pl, pls, pls, q_pl),
                     device_mesh=mesh)(q, cache_k, cache_v, lengths)


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

    if cfg.attn_logits_softcap:      # the kernels take no softcap
        kh, hd = cfg.num_kv_heads, cfg.head_dim
        tbl = block.long()
        k = k_pages[tbl].reshape(b, S, kh, hd)
        v = v_pages[tbl].reshape(b, S, kh, hd)
        o = _linear_attention(cfg, q, k, v, position)
        return _out_proj(p, cfg, o, x), k_pages, v_pages
    lengths = torch.clamp(position + 1, max=S).to(torch.int32)
    o = paged_decode_attention(q[:, 0], k_pages, v_pages, lengths, block)
    return _out_proj(p, cfg, o[:, None], x), k_pages, v_pages


def decode_cross_attention(p, cfg: ModelConfig, x, mem_k, mem_v,
                           mem_positions):
    """One query per row against the cached encoder K/V ``mem_k``/``mem_v``
    [b, src, kh, hd] (keys at ``mem_positions`` < 0 masked). Plain
    PyTorch, as in the reference: ``_masked_decode`` (encdec has no
    softcap), on every rank's shards of a DTensor cache
    (``_masked_decode_sharded``). x: [b, 1, d] -> [b, 1, d]."""
    q = _project_q(p, cfg, x, None)
    if SH.is_dtensor(mem_k):
        mpos = SH.replicated_value(mem_positions)
        o = _masked_decode_sharded(
            cfg, q, mem_k, mem_v,
            lambda _, s0, n: (mpos[s0:s0 + n] >= 0)[None])
    else:
        o = _masked_decode(cfg, q, mem_k, mem_v, (mem_positions >= 0)[None])
    return _out_proj(p, cfg, o, x)
