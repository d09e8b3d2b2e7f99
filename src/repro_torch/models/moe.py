"""Mixture-of-Experts FFN.

Three interchangeable implementations (``cfg.moe_impl``), as in the
reference package:

* ``einsum``  — GShard-style capacity-buffer dispatch/combine as one-hot
  products, chunked over the sequence so the dispatch tensor stays
  ``O(chunk · E · C_chunk)``. The default.
* ``scatter`` — dispatch by scatter-add into the capacity buffer and combine
  by gather.
* ``dense``   — every expert on every token, weighted combine, in f32. Only
  sane at smoke sizes; kept as the correctness oracle.

The expert FFN over the ``[E, C, d]`` capacity buffers runs the hand-written
grouped kernels of ``repro_torch.kernels.moe_gemm``: ``moe_ffn_fused`` for
gate and up, ``moe_gemm`` for down (their plain versions on the CPU), on
bf16 or int8 expert weights.
Routing is f32, on an f32 router, as in the reference.

Under a mesh (DTensor tokens inside ``use_mesh``) dispatch, the expert FFN
and combine run as one ``local_map`` region on every rank's shards, laid
out by ``kernels.sharded.expert_layout``: each rank routes the tokens of
its data shard (whole over the model axis), keeps the assignments to its
own experts (expert parallelism) or runs every expert on its f columns
(expert-TP), and its combine is a partial sum over the model axis that the
residual's ``constrain`` all-reduces, as GSPMD does in the reference. No
token leaves its data shard. The flattened group (decode) spans the global
batch: its capacity comes from the global token count, and each rank's
positions in an expert's group start after those of the data ranks before
it (an all-gather of the per-expert counts), so the same assignments drop
as in an unsharded run; its buffers hold its own tokens only. The kernels
only see local tensors; without a mesh nothing changes.

Expert weights are stored stacked: ``w_gate/w_up: [E, d, f]``,
``w_down: [E, f, d]`` (or int8 ``{q, s}`` of those shapes with
``[E, 1, f]`` f32 scales), ``router: [d, E]`` (f32).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import sharded as SH
from repro_torch.kernels.moe_gemm.moe_gemm import moe_ffn_fused, moe_gemm
from repro_torch.models.config import ModelConfig
from repro_torch.models.quant import as_weight, stacked_init


def moe_init(cfg: ModelConfig, normal, layers: int, dt, dev,
             int8: bool = False):
    """Stacked expert weights for ``layers`` layers with the reference's
    shapes and scales. ``normal(shape, scale, dtype)`` returns seeded
    N(0, 1) * scale draws made in f32 and rounded to ``dtype``; matrices
    are drawn one ``[E, d, f]`` tensor at a time (805 MB in f32 at
    qwen3-moe width, 1.88 GB at mixtral's) and stored in ``dt``, or with
    ``int8`` quantised as they are drawn into ``{q: int8 [L, E, d, f],
    s: f32 [L, E, 1, f]}``; the router stays f32."""
    E, d, f = cfg.num_experts, cfg.d_model, cfg.moe_d_ff

    def stacked(shape, scale, dtype, q8=int8):
        return stacked_init((layers,) + shape, dtype, dev,
                            lambda: normal(shape, scale, dtype), q8)

    return {
        "router": stacked((d, E), 1.0 / math.sqrt(d), torch.float32, False),
        "w_gate": stacked((E, d, f), 1.0 / math.sqrt(d), dt),
        "w_up": stacked((E, d, f), 1.0 / math.sqrt(d), dt),
        "w_down": stacked((E, f, d), 1.0 / math.sqrt(f), dt),
    }


def _one_hot(idx, n: int, dtype):
    """``F.one_hot`` by scatter: no bounds check, so no device->host sync
    inside the fused decode (ids come from ``topk`` and are in range)."""
    out = torch.zeros(idx.shape + (n,), dtype=dtype, device=idx.device)
    return out.scatter_(-1, idx[..., None], 1)


def _route(p, cfg: ModelConfig, x, lay=None, flat: bool = False):
    """Router: returns (weights [T, k], expert ids [T, k], aux loss). f32
    on the router's values, whatever its dtype (the train step's compute
    copy is bf16: the reference's einsum promotes it to f32).

    Under a mesh (``lay``, an ``ExpertLayout``): the aux loss's gradient
    counts on the first rank of the model split only (every rank of it
    computes the same loss); in the flattened group (``flat``) its means
    are over the global batch, summed over the data ranks."""
    logits = x.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = torch.topk(probs, cfg.num_experts_per_tok, dim=-1)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    # load-balancing aux loss (Switch-style): E * sum_e f_e * P_e
    E = cfg.num_experts
    hits = _one_hot(top_i, E, torch.float32).sum(1)
    if lay is not None and not lay.aux_grad:
        probs = SH.grad_if(probs, False)
    if lay is not None and flat and lay.token_groups:
        n = probs.shape[0] * lay.token_parts
        me = SH.sum_over(probs.sum(0), lay.token_groups) / n
        ce = SH.sum_over(hits.sum(0), lay.token_groups) / n
    else:
        me = probs.mean(0)
        ce = hits.mean(0)
    aux = E * torch.sum(me * ce) / cfg.num_experts_per_tok
    return top_p, top_i, aux


def _expert_ffn(p, h):
    """h: [E, C, d] capacity buffers -> per-expert SwiGLU, in h's dtype.

    bf16 buffers hand an int8 weight ``{q, s}`` to the kernels as it is: on
    the card the int8 variant dequantises each int8 tile straight into the
    registers of ``wgmma``'s A operand, on the CPU the plain version runs
    ``as_weight`` first. Other dtypes dequantise
    here, to bf16 and then h's dtype, as the reference's einsums do."""
    wg, wu, wd = p["w_gate"], p["w_up"], p["w_down"]
    if h.dtype != torch.bfloat16:
        wg, wu, wd = (as_weight(w).to(h.dtype) for w in (wg, wu, wd))
    return moe_gemm(moe_ffn_fused(h, wg, wu), wd)


def _capacity(cfg: ModelConfig, tokens: int) -> int:
    c = int(math.ceil(tokens * cfg.num_experts_per_tok
                      * cfg.moe_capacity_factor / cfg.num_experts))
    return max(8, int(math.ceil(c / 8) * 8))


def _positions(cfg: ModelConfig, top_i, T: int):
    """Position of each (token, slot) assignment within its expert buffer,
    counted token-major over the [T·k, E] assignment matrix: [T, k]."""
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    flat = _one_hot(top_i, E, torch.int64).reshape(T * k, E)
    pos = torch.cumsum(flat, dim=0) * flat - 1                 # [T*k, E]
    return pos.reshape(T, k, E).gather(2, top_i[..., None])[..., 0]


def _group_positions(cfg: ModelConfig, top_i, pos, lay=None,
                     flat: bool = False):
    """Each assignment's position among the whole group's, which decides
    whether it drops: ``pos`` itself, but in the flattened group under a
    mesh, which spans the global batch. There each expert's positions start
    after the assignments of the data ranks before this one (an all-gather
    of the per-expert counts), while this rank's buffers hold its own
    tokens at ``pos``."""
    if lay is None or not flat or not lay.token_groups:
        return pos
    hits = _one_hot(top_i, cfg.num_experts, torch.int64).sum((0, 1))
    counts = SH.gather_over(hits[None], lay.token_groups)
    return pos + counts[:lay.token_rank].sum(0)[top_i]


def _group(cfg: ModelConfig, T: int, lay, flat: bool):
    """(capacity, buffer rows, first expert, experts) of a group of T
    local tokens: the capacity from the group's global token count, which
    decides the drops; the rows of this rank's buffers, which hold its own
    tokens only (at most T an expert, so a group wider than the rank's
    tokens needs no more); the experts this rank runs."""
    if lay is None:
        C = _capacity(cfg, T)
        return C, C, 0, cfg.num_experts
    C = _capacity(cfg, T * lay.token_parts if flat else T)
    rows = C if not flat else min(C, max(8, -(-T // 8) * 8))
    return C, rows, lay.e0, lay.experts


def _dispatch_chunk_einsum(p, cfg: ModelConfig, xt, lay=None, flat=False):
    """xt: [T, d] one chunk of tokens -> (out [T, d], aux).

    The dispatch tensor ``disp`` (ones) and the combine tensor ``comb``
    (router weights) are [T, E, C], built by scatter rather than as the
    reference's sum of [T, k, E, C] one-hots. That is exact: ``top_k``
    picks distinct experts, so at most one of the k terms of each (t, e) is
    non-zero. Dropped assignments scatter into one spare cell past the end,
    so no boolean mask (and no device->host sync) is needed. Under a mesh
    only this rank's experts get buffers, of its own tokens: [T, E/m, Cb]
    (``_group``'s buffer rows)."""
    T, d = xt.shape
    C, Cb, e0, El = _group(cfg, T, lay, flat)
    top_p, top_i, aux = _route(p, cfg, xt, lay, flat)
    pos = _positions(cfg, top_i, T)                            # [T, k]
    gpos = _group_positions(cfg, top_i, pos, lay, flat)
    t_ids = torch.arange(T, device=xt.device)[:, None]
    keep = gpos < C
    if El != cfg.num_experts:
        top_i = top_i - e0
        keep = keep & (top_i >= 0) & (top_i < El)
    cell = torch.where(keep, (t_ids * El + top_i) * Cb + pos, T * El * Cb)
    disp = torch.zeros(T * El * Cb + 1, dtype=xt.dtype, device=xt.device)
    disp[cell] = 1
    comb = torch.zeros(T * El * Cb + 1, dtype=torch.float32,
                       device=xt.device)
    comb[cell] = top_p
    disp, comb = disp[:-1].view(T, El, Cb), comb[:-1].view(T, El, Cb)

    buf = torch.einsum("tec,td->ecd", disp, xt)
    out_buf = _expert_ffn(p, buf)
    out = torch.einsum("tec,ecd->td", comb.to(xt.dtype), out_buf)
    return out, aux


def _dispatch_chunk_scatter(p, cfg: ModelConfig, xt, lay=None, flat=False):
    """Scatter/gather dispatch: no one-hot products."""
    T, d = xt.shape
    k = cfg.num_experts_per_tok
    C, Cb, e0, El = _group(cfg, T, lay, flat)
    top_p, top_i, aux = _route(p, cfg, xt, lay, flat)
    pos = _positions(cfg, top_i, T)                            # [T, k]
    gpos = _group_positions(cfg, top_i, pos, lay, flat)
    in_cap = (pos >= 0) & (gpos < C)
    if El != cfg.num_experts:
        top_i = top_i - e0
        in_cap = in_cap & (top_i >= 0) & (top_i < El)
    slot = top_i * Cb + torch.clamp(pos, 0, Cb - 1)            # [T, k]
    slot = torch.where(in_cap, slot, torch.full_like(slot, El * Cb))

    buf = torch.zeros((El * Cb + 1, d), dtype=xt.dtype, device=xt.device)
    src = xt[:, None].expand(T, k, d).reshape(T * k, d)
    buf.index_add_(0, slot.reshape(-1), src)
    out_buf = _expert_ffn(p, buf[:-1].reshape(El, Cb, d)).reshape(El * Cb, d)
    out_buf = torch.cat([out_buf, out_buf.new_zeros((1, d))], dim=0)
    gathered = out_buf[slot.reshape(-1)].reshape(T, k, d)
    w = (top_p * in_cap).float()
    out = torch.einsum("tkd,tk->td", gathered.float(), w)
    return out.to(xt.dtype), aux


def _dense_moe(p, cfg: ModelConfig, xt, lay=None, flat=False):
    """Correctness oracle: every expert on every token, all in f32 (under
    a mesh, every expert of this rank's)."""
    _, _, e0, El = _group(cfg, xt.shape[0], lay, flat)
    top_p, top_i, aux = _route(p, cfg, xt, lay, flat)
    xf = xt.float()
    wg = as_weight(p["w_gate"], torch.float32).float()
    wu = as_weight(p["w_up"], torch.float32).float()
    wd = as_weight(p["w_down"], torch.float32).float()
    gate = torch.einsum("td,edf->tef", xf, wg)
    up = torch.einsum("td,edf->tef", xf, wu)
    act = F.silu(gate) * up
    yo = torch.einsum("tef,efd->ted", act, wd)                 # [T, E, d]
    w = (_one_hot(top_i, cfg.num_experts, torch.float32)
         * top_p[..., None]).sum(1)                            # [T, E]
    if El != cfg.num_experts:
        w = w[:, e0:e0 + El]
    out = torch.einsum("ted,te->td", yo, w).to(xt.dtype)
    return out, aux


def flattens(cfg: ModelConfig, seq: int) -> bool:
    """Whether the MoE layer routes a batch of ``seq``-token rows as one
    group, so a row's output depends on the other rows (the reference's
    rule: ``s < 64``, not ``dense``)."""
    return cfg.is_moe and seq < 64 and cfg.moe_impl != "dense"


def moe_apply(p, cfg: ModelConfig, x):
    """x: [b, s, d] -> (out [b, s, d], aux_loss), with the reference's
    grouping rule:

    * ``s < 64`` (decode, short prompts; not ``dense``): the batch is
      flattened to one ``[b·s, d]`` group;
    * otherwise each row is its own group (the reference vmaps over rows),
      chunked over the sequence by ``cfg.moe_chunk`` — rounded down to a
      divisor of ``s`` — and ``aux`` is the mean over rows and chunks.

    DTensor tokens (inside ``use_mesh``) run ``_sharded``."""
    if SH.is_dtensor(x):
        return _sharded(p, cfg, x)
    return _apply(p, cfg, x)


def _apply(p, cfg: ModelConfig, x, lay=None):
    """``moe_apply`` on plain tensors: the whole layer, or under a mesh
    one rank's part of it (``lay``): its rows, its experts or f columns,
    the output a partial sum over the model split."""
    b, s, d = x.shape
    impl = {"einsum": _dispatch_chunk_einsum,
            "scatter": _dispatch_chunk_scatter,
            "dense": _dense_moe}[cfg.moe_impl]
    if flattens(cfg, s):
        out, aux = impl(p, cfg, x.reshape(b * s, d), lay, True)
        return out.reshape(b, s, d), aux
    chunk_s = max(1, min(s, cfg.moe_chunk))
    if s % chunk_s:
        chunk_s = next(c for c in range(chunk_s, 0, -1) if s % c == 0)
    nchunks = s // chunk_s
    out = torch.empty_like(x)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for j in range(nchunks):
        sl = slice(j * chunk_s, (j + 1) * chunk_s)
        row_aux = []
        for r in range(b):
            out[r, sl], a = impl(p, cfg, x[r, sl], lay)
            row_aux.append(a)
        mean = torch.stack(row_aux).mean()
        if lay is not None and lay.token_groups:   # over every data rank
            mean = SH.sum_over(mean, lay.token_groups) / lay.token_parts
        aux = aux + mean
    return out, aux / nchunks


def _sharded(p, cfg: ModelConfig, x):
    """``moe_apply`` on DTensors: the tokens and weights laid out by
    ``kernels.sharded.expert_layout`` (whatever does not match is
    redistributed explicitly: a sequence-split input, the weights' ZeRO-3
    shards, gathered here as at any product), then ``_apply`` on every
    rank's shards in one ``local_map`` region, its kernels on local
    tensors. Returns the output, a partial sum over the model split, and
    the aux loss (replicated)."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map
    mesh = x.device_mesh

    def q(w):
        return w["q"] if isinstance(w, dict) else w

    lay = SH.expert_layout(x, q(p["w_gate"]), q(p["w_down"]),
                           cfg.num_experts)
    x = SH.redistribute(x, mesh, lay.x)
    names, args, pls, grads = [], [], [], []
    for name in ("router", "w_gate", "w_up", "w_down"):
        w = p[name]
        parts = sorted(w.items()) if isinstance(w, dict) else [(None, w)]
        for part, t in parts:
            if name == "router":
                pl, gp = (Replicate(),) * mesh.ndim, lay.router_grad
            elif name != "w_down":
                pl, gp = lay.w_in, lay.w_in_grad
            elif part == "s":
                pl, gp = lay.s_out, lay.s_out
            else:
                pl, gp = lay.w_out, lay.w_out_grad
            names.append((name, part))
            args.append(SH.redistribute(t, mesh, pl))
            pls.append(list(pl))
            grads.append(list(gp))

    def local(xl, *ws):
        lp = {}
        for (name, part), t in zip(names, ws):
            if part is None:
                lp[name] = t
            else:
                lp.setdefault(name, {})[part] = t
        return _apply(lp, cfg, xl, lay)

    return local_map(local, out_placements=(list(lay.out),
                                            [Replicate()] * mesh.ndim),
                     in_placements=(list(lay.x), *pls),
                     in_grad_placements=(list(lay.out), *grads),
                     device_mesh=mesh)(x, *args)
