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

Expert weights are stored stacked: ``w_gate/w_up: [E, d, f]``,
``w_down: [E, f, d]`` (or int8 ``{q, s}`` of those shapes with
``[E, 1, f]`` f32 scales), ``router: [d, E]`` (f32).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

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


def _route(p, cfg: ModelConfig, x):
    """Router: returns (weights [T, k], expert ids [T, k], aux loss). f32
    on the router's values, whatever its dtype (the train step's compute
    copy is bf16: the reference's einsum promotes it to f32)."""
    logits = x.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = torch.topk(probs, cfg.num_experts_per_tok, dim=-1)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    # load-balancing aux loss (Switch-style): E * sum_e f_e * P_e
    E = cfg.num_experts
    me = probs.mean(0)
    ce = _one_hot(top_i, E, torch.float32).sum(1).mean(0)
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


def _dispatch_chunk_einsum(p, cfg: ModelConfig, xt):
    """xt: [T, d] one chunk of tokens -> (out [T, d], aux).

    The dispatch tensor ``disp`` (ones) and the combine tensor ``comb``
    (router weights) are [T, E, C], built by scatter rather than as the
    reference's sum of [T, k, E, C] one-hots. That is exact: ``top_k``
    picks distinct experts, so at most one of the k terms of each (t, e) is
    non-zero. Dropped assignments scatter into one spare cell past the end,
    so no boolean mask (and no device->host sync) is needed."""
    T, d = xt.shape
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    C = _capacity(cfg, T)
    top_p, top_i, aux = _route(p, cfg, xt)
    pos = _positions(cfg, top_i, T)                            # [T, k]
    t_ids = torch.arange(T, device=xt.device)[:, None]
    cell = torch.where(pos < C, (t_ids * E + top_i) * C + pos, T * E * C)
    disp = torch.zeros(T * E * C + 1, dtype=xt.dtype, device=xt.device)
    disp[cell] = 1
    comb = torch.zeros(T * E * C + 1, dtype=torch.float32, device=xt.device)
    comb[cell] = top_p
    disp, comb = disp[:-1].view(T, E, C), comb[:-1].view(T, E, C)

    buf = torch.einsum("tec,td->ecd", disp, xt)
    out_buf = _expert_ffn(p, buf)
    out = torch.einsum("tec,ecd->td", comb.to(xt.dtype), out_buf)
    return out, aux


def _dispatch_chunk_scatter(p, cfg: ModelConfig, xt):
    """Scatter/gather dispatch: no one-hot products."""
    T, d = xt.shape
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    C = _capacity(cfg, T)
    top_p, top_i, aux = _route(p, cfg, xt)
    pos = _positions(cfg, top_i, T)                            # [T, k]
    in_cap = (pos >= 0) & (pos < C)
    slot = top_i * C + torch.clamp(pos, 0, C - 1)              # [T, k]
    slot = torch.where(in_cap, slot, torch.full_like(slot, E * C))

    buf = torch.zeros((E * C + 1, d), dtype=xt.dtype, device=xt.device)
    src = xt[:, None].expand(T, k, d).reshape(T * k, d)
    buf.index_add_(0, slot.reshape(-1), src)
    out_buf = _expert_ffn(p, buf[:-1].reshape(E, C, d)).reshape(E * C, d)
    out_buf = torch.cat([out_buf, out_buf.new_zeros((1, d))], dim=0)
    gathered = out_buf[slot.reshape(-1)].reshape(T, k, d)
    w = (top_p * in_cap).float()
    out = torch.einsum("tkd,tk->td", gathered.float(), w)
    return out.to(xt.dtype), aux


def _dense_moe(p, cfg: ModelConfig, xt):
    """Correctness oracle: every expert on every token, all in f32."""
    top_p, top_i, aux = _route(p, cfg, xt)
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
    out = torch.einsum("ted,te->td", yo, w).to(xt.dtype)
    return out, aux


def moe_apply(p, cfg: ModelConfig, x):
    """x: [b, s, d] -> (out [b, s, d], aux_loss), with the reference's
    grouping rule:

    * ``s < 64`` (decode, short prompts; not ``dense``): the batch is
      flattened to one ``[b·s, d]`` group;
    * otherwise each row is its own group (the reference vmaps over rows),
      chunked over the sequence by ``cfg.moe_chunk`` — rounded down to a
      divisor of ``s`` — and ``aux`` is the mean over rows and chunks.
    """
    b, s, d = x.shape
    impl = {"einsum": _dispatch_chunk_einsum,
            "scatter": _dispatch_chunk_scatter,
            "dense": _dense_moe}[cfg.moe_impl]
    if s < 64 and cfg.moe_impl != "dense":
        out, aux = impl(p, cfg, x.reshape(b * s, d))
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
            out[r, sl], a = impl(p, cfg, x[r, sl])
            row_aux.append(a)
        aux = aux + torch.stack(row_aux).mean()
    return out, aux / nchunks
