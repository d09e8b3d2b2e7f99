"""LM of the dense GQA, MoE, hybrid (RG-LRU + local attention), SSM
(Mamba-2) and encoder-decoder (audio frontend) families.

Params are nested dicts of tensors shaped like the reference package's
pytree, so the bridge moves weights between the two packages leaf for leaf:
homogeneous stacks (dense, MoE, SSM) keep layer weights stacked on a
leading [L] axis; the hybrid's heterogeneous stack is a tuple of per-layer
dicts in ``cfg._pattern()`` order. The layer stack is a Python loop (over
per-layer views of the stacked tensors); the decode cache is updated in
place.

Public surface:
    init(seed, device)                     -> params
    prefill(params, batch, max_len, adapter=None)
                                           -> (last_logits [b, V], cache)
      (encdec: ``batch["frames"]`` [b, src, d_model] feeds the encoder;
      vision: ``batch["vision_embeds"]`` [b, nv, d_model] is spliced over
      the first nv token slots; M-RoPE: ``batch["positions"]`` [3, b, s])
    decode_step(params, cache, tokens [b, 1], active=None, adapter=None)
                                           -> (logits [b, 1, V], cache)
    forward(params, batch)                 -> (logits [b, s, V] f32, aux)
    forward_hidden(params, batch)          -> (hidden [b, s, d], aux)
    loss(params, batch, ce_chunk=512)      -> (ce + 0.01 aux, metrics)
    param_specs()                          -> init's tree on ``meta``

The full-sequence forward (training) runs every block through
``_block_seq`` under ``cfg.remat``: "full" checkpoints each block
(non-reentrant ``torch.utils.checkpoint``), "dots" keeps only the matrix
products' outputs (selective checkpointing), stacks of 48 layers or more
also checkpoint √L groups whole, as the reference's two-level scan; the
cross-entropy runs in chunks of positions, each recomputed in the backward.

Block kinds: ``attn`` (attention + MLP), ``attn_moe`` (attention, then
``models.moe`` in place of the MLP), ``attn_cross`` (the encdec decoder's
block: causal self attention, cross attention over the encoder's output,
MLP), ``rec`` (the RG-LRU block of ``models.rglru`` + MLP) and ``ssm``
(norm + the SSD layer of ``models.ssd``, no MLP). The encdec encoder is a
stack of ``attn`` blocks with bidirectional attention over the frames.
Sliding-window attention layers (the hybrid's local attention, every layer
of a windowed dense or MoE model such as mixtral) prefill through
``banded_attention`` and decode against a ring buffer. The vision frontend
is the reference's stub: patch embeddings given as input pass through
``vision_adapter`` into the first token slots; M-RoPE rotates each
half-dim section by its own position stream (``layers.rope_for``).

Weights may be int8 (``models.quant``): every consumer dequantises on read,
and ``init`` draws an int8 tree directly when ``cfg.serve_weight_dtype`` is
"int8".
"""

from __future__ import annotations

import functools
import math
from typing import Any, Dict, Optional

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch import resolve_device
from repro_torch.adapters.runtime import lora_apply_rows, lora_delta
from repro_torch.models.config import ModelConfig, validate
from repro_torch.models import attention as A
from repro_torch.models import kvcache as KV
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import quant as Q
from repro_torch.models import rglru as RG
from repro_torch.models import ssd as SSD
from repro_torch.kernels import sharded as SH
from repro_torch.sharding.ctx import constrain
from repro_torch.sharding.planner import placements, zeros


def layer_params(tree, i: int):
    """View of layer ``i`` of a stacked param (or cache) tree."""
    if isinstance(tree, dict):
        return {k: layer_params(v, i) for k, v in tree.items()}
    return tree[i]


def _stack(trees):
    """Per-layer param trees -> one tree with leaves stacked on axis 0."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _keep_active(old, new, active) -> None:
    """Write a recurrent state leaf IN PLACE, frozen for inactive rows:
    parked sessions share the fused decode batch but their state must not
    advance — recurrent updates, unlike position-indexed KV writes, touch
    every row. On a DTensor state the new value takes the state's layout
    first (and ``active`` its batch rows), and every rank writes its own
    shard."""
    if SH.is_dtensor(old):
        from torch.distributed.tensor import Replicate, Shard
        mesh = old.device_mesh
        new = SH.redistribute(new.to(old.dtype), mesh,
                              old.placements).to_local()
        if active is not None:
            active = SH.redistribute(active, mesh, [
                Shard(0) if p.is_shard(0) else Replicate()
                for p in old.placements]).to_local()
        old = old.to_local()
    new = new.to(old.dtype)
    if active is not None:
        a = active.reshape(active.shape + (1,) * (new.dim() - 1))
        new = torch.where(a, new, old)
    old.copy_(new)


def _ring_rows(x, s0: int, n: int, S: int, length: Optional[int]):
    """Slots ``[s0, s0 + n)`` of a sliding-window ring of S slots built
    from prefill K or V [b, s, kh, hd]: the token at position p lives in
    slot p % S, and only positions in ``[m - S, m)`` (m = ``length``, the
    true prompt length of a right-padded bucket, or s) may land there, so
    slot j holds the latest such p ≡ j (mod S), and a slot none reaches
    (a prompt shorter than the ring) stays zero. -> [b, n, kh, hd]."""
    m = x.shape[1] if length is None else int(length)
    j = torch.arange(s0, s0 + n, device=x.device)
    pos = (m - 1) - torch.remainder(m - 1 - j, S)
    rows = x.index_select(1, torch.clamp(pos, min=0))
    live = (pos >= 0).reshape((1, n) + (1,) * (x.dim() - 2))
    return torch.where(live, rows, torch.zeros_like(rows))


def _ring_buffer(x, S: int, length: Optional[int]):
    """The whole ring of S slots (``_ring_rows``) [b, S, kh, hd]."""
    return _ring_rows(x, 0, S, S, length)


def _kv_buffer(cfg: ModelConfig, shape, x):
    """A zeroed stacked K or V buffer [L, b, S, kh, hd] in x's dtype: on
    x's device or, for a DTensor x, a DTensor on x's mesh laid out by the
    planner's cache rule (batch over the data axes, KV heads or else S
    over the model axis), as the reference's prefill hands its cache out
    (its dry run's out_shardings)."""
    if not SH.is_dtensor(x):
        return torch.zeros(shape, dtype=x.dtype, device=x.device)
    from repro_torch.sharding.planner import cache_plan, zeros
    mesh = x.device_mesh
    spec = cache_plan(cfg, {"layers": {"k": torch.empty(shape,
                                                        device="meta")}},
                      mesh, shape[1], [])["layers"]["k"]
    return zeros(shape, x.dtype, spec, mesh)


def _layer_placements(buf, i: Optional[int]):
    """The placements of layer ``i`` of a stacked DTensor buffer [L, ...]
    (of the buffer itself where ``i`` is None)."""
    if i is None:
        return list(buf.placements)
    return [type(p)(p.dim - 1) if p.is_shard() else p
            for p in buf.placements]


def _put_layer(buf, i: int, t) -> None:
    """``buf[i] = t`` on a stacked state or cache buffer [L, ...]: on a
    DTensor buffer t takes the layer's layout and every rank copies its
    own shard."""
    if not SH.is_dtensor(buf):
        buf[i] = t
        return
    t = SH.redistribute(t.to(buf.dtype), buf.device_mesh,
                        _layer_placements(buf, i))
    buf.to_local()[i].copy_(t.to_local())


def _fill_layer(buf, i: int, k, n: int) -> None:
    """``buf[i, :, :n] = k[:, :n]`` on a DTensor buffer [L, b, S, kh, hd],
    shard by shard: k's first n rows, padded with zeros to S, take the
    layer's layout and every rank copies its own part."""
    S = buf.shape[2]
    rows = k[:, :n]
    if n < S:
        rows = torch.cat([rows, rows.new_zeros((rows.shape[0], S - n)
                                               + tuple(rows.shape[2:]))],
                         dim=1)
    _put_layer(buf, i, rows)


def _fill_ring(buf, i: Optional[int], k, length: Optional[int]) -> None:
    """``buf[i] = _ring_buffer(k, S, length)`` on a DTensor ring [L, b, S,
    kh, hd] (``buf = ...`` on a layer's own ring [b, S, kh, hd] where
    ``i`` is None: the hybrid's), shard by shard: each rank fills its own
    slots of S (its batch rows and KV heads where the ring splits them)
    from k [b, s, kh, hd] taken whole along its sequence."""
    from torch.distributed.tensor import Replicate
    mesh = buf.device_mesh
    layer = _layer_placements(buf, i)
    src = [Replicate() if p.is_shard(1) else p for p in layer]
    kl = SH.redistribute(k, mesh, src).to_local()
    S = buf.shape[-3]
    s0, S_l = SH.shard_span(mesh, layer, 1, S)
    dst = buf.to_local() if i is None else buf.to_local()[i]
    dst.copy_(_ring_rows(kl, s0, S_l, S, length))


def _cache_specs(cfg: ModelConfig, b: int, max_len: int, mesh):
    """(the decode cache's layers for b rows of max_len on ``meta``, their
    specs by the planner's cache rule, ``planner.cache_plan``), as the
    reference's prefill hands its cache out."""
    from repro_torch.sharding.planner import cache_plan
    meta = KV.init_cache(cfg, b, max_len, device="meta")
    return meta["layers"], cache_plan(cfg, meta, mesh, b, [])["layers"]


def _mask_positions(positions):
    """The [s] int32 positions the attention mask reads: stream 0 of row 0
    of RoPE positions [s], [b, s] or M-RoPE's [3, b, s], as the
    reference's ``_block_prefill`` takes them."""
    while positions.dim() > 1:
        positions = positions[0]
    return positions.to(torch.int32).contiguous()


def _attn_half(p, cfg: ModelConfig, x, positions, memory=None,
               mem_positions=None, causal=True):
    """The attention half of an attention block: x after its self
    attention and, with ``memory`` (the encoder's output, encdec), the
    cross attention over it; also the self attention's K/V [b, s, kh, hd].
    ``positions`` rotate q and k (all of them); the mask reads
    ``_mask_positions`` of them."""
    h = L.rmsnorm_apply(p["norm1"], x, cfg.norm_eps)
    k, v = A._project_kv(p["attn"], cfg, h, positions)
    q = A._project_q(p["attn"], cfg, h, positions)
    mpos = _mask_positions(positions)
    o = A.full_attention(q, k, v, mpos, mpos, cfg, causal=causal)
    # on DTensors the projection is a partial sum over the model axis;
    # pin the residual's layout, or DTensor settles the sum by splitting
    # the sequence over that axis for the rest of the block
    x = constrain(x + A._out_proj(p["attn"], cfg, o, x), "dp", None, None)
    if memory is not None:
        hx = L.rmsnorm_apply(p["norm_x"], x, cfg.norm_eps)
        x = x + A.cross_attention(p["xattn"], cfg, hx, memory, mem_positions)
    return x, k, v


def _attn_prefill(p, cfg: ModelConfig, x, positions, memory=None,
                  mem_positions=None):
    """Sequence pass of one attention layer; also returns its K/V
    [b, s, kh, hd].

    With a right-padded prompt, padded keys sit strictly after every real
    query (causality); decode masks a linear buffer's tail by position and
    a ring is built from the real positions only, so the cache equals the
    exact-length cache where it is ever read."""
    x = constrain(x, "dp", None, None)
    x, k, v = _attn_half(p, cfg, x, positions, memory, mem_positions)
    return x + _ffn(p, cfg, x), k, v


def _block_seq(p, cfg: ModelConfig, kind: str, x, positions, memory=None,
               mem_positions=None, causal=True):
    """Full-sequence block (the training forward, the encoder): returns
    (x, aux), aux the MoE layer's load-balancing loss (zero for the other
    kinds)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    x = constrain(x, "dp", None, None)
    if kind in ("ssm", "rec"):
        h = L.rmsnorm_apply(p["norm1"], x, cfg.norm_eps)
        if kind == "ssm":
            return constrain(x + SSD.ssd_apply(p["ssd"], cfg, h)[0], "dp",
                             None, None), aux
        # w_out's product is a partial sum over the model axis on
        # DTensors: reduced here, as the attention half's
        x = constrain(x + RG.rglru_block_apply(p["rec"], cfg, h), "dp",
                      None, None)
    else:
        x, _, _ = _attn_half(p, cfg, x, positions, memory, mem_positions,
                             causal)
    y, moe_aux = _ffn_aux(p, cfg, x)
    return constrain(x + y, "dp", None, None), \
        aux if moe_aux is None else moe_aux


def _dots(ctx, op, *args, **kwargs):
    """Selective checkpointing's policy for ``remat="dots"`` (the
    reference's ``checkpoint_dots``): keep the matrix products' outputs,
    recompute everything else."""
    if op in _DOT_OPS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


_DOT_OPS = frozenset((torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
                      torch.ops.aten.addmm.default,
                      torch.ops.aten.baddbmm.default))


def _maybe_remat(fn, cfg: ModelConfig):
    """``fn`` under activation checkpointing by ``cfg.remat`` ("none",
    "dots": only matrix products' outputs saved, "full": only the inputs),
    non-reentrant, and only while autograd records (under ``no_grad`` the
    plain call). Remat changes memory, never values."""
    if cfg.remat == "none":
        return fn
    kw = {"use_reentrant": False}
    if cfg.remat == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _dots)

    def run(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return checkpoint(fn, *args, **kw)
    return run


def _scan_groups(cfg: ModelConfig) -> int:
    """Two-level checkpoint group count: deep stacks checkpoint √L
    boundaries."""
    if cfg.remat == "none" or cfg.num_layers < 48:
        return 1
    for g in (8, 6, 4, 3, 2):
        if cfg.num_layers % g == 0:
            return g
    return 1


def _unstack(tree, n: int):
    """A layer-stacked tree as n per-layer trees (``unbind``: one backward
    node that stacks the layers' gradients, not n full-size scatters)."""
    if isinstance(tree, dict):
        per = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: per[k][i] for k in per} for i in range(n)]
    return list(tree.unbind(0))


def _attn_decode(p, cfg: ModelConfig, x, k_layer, v_layer, position,
                 active=None, block=None, cross=None):
    """Single-token pass of one attention layer; ``block`` selects the
    paged pool; ``cross`` (encdec) is the layer's cached encoder K/V
    ``(cross_k, cross_v)`` [b, src, kh, hd], attended after the self
    attention and never written."""
    x = constrain(x, "dp", None, None)
    h = L.rmsnorm_apply(p["norm1"], x, cfg.norm_eps)
    if block is not None:
        y, _, _ = A.paged_decode_self_attention(
            p["attn"], cfg, h, k_layer, v_layer, block, position,
            active=active)
    else:
        y, _, _ = A.decode_self_attention(
            p["attn"], cfg, h, k_layer, v_layer, position,
            window=cfg.sliding_window, active=active)
    x = x + y
    if cross is not None:
        ck, cv = cross
        hx = L.rmsnorm_apply(p["norm_x"], x, cfg.norm_eps)
        src = torch.arange(ck.shape[1], dtype=torch.int32, device=x.device)
        x = x + A.decode_cross_attention(p["xattn"], cfg, hx, ck, cv, src)
    return x + _ffn(p, cfg, x)


def _rec_prefill(p, cfg: ModelConfig, x, length):
    """Sequence pass of one RG-LRU block; returns (x, its cache layer)."""
    x = constrain(x, "dp", None, None)
    h = L.rmsnorm_apply(p["norm1"], x, cfg.norm_eps)
    y, conv, hs = RG.rglru_block_prefill(p["rec"], cfg, h, length)
    x = constrain(x + y, "dp", None, None)
    return x + _ffn(p, cfg, x), {"conv": conv, "h": hs}


def _rec_decode(p, cfg: ModelConfig, x, cache_layer, active=None):
    x = constrain(x, "dp", None, None)
    h = L.rmsnorm_apply(p["norm1"], x, cfg.norm_eps)
    y, conv, hs = RG.rglru_block_decode(p["rec"], cfg, h, cache_layer["conv"],
                                        cache_layer["h"])
    _keep_active(cache_layer["conv"], conv, active)
    _keep_active(cache_layer["h"], hs, active)
    x = constrain(x + y, "dp", None, None)
    return x + _ffn(p, cfg, x)


def _ffn_aux(p, cfg: ModelConfig, x):
    """The block's second half on ``norm2(x)``: (the MoE layer's output and
    its aux loss) for an ``attn_moe`` block, (the dense MLP's, None)
    otherwise."""
    h2 = L.rmsnorm_apply(p["norm2"], x, cfg.norm_eps)
    if "moe" in p:
        return MOE.moe_apply(p["moe"], cfg, h2)
    return L.mlp_apply(p["mlp"], h2), None


def _ffn(p, cfg: ModelConfig, x):
    """``_ffn_aux``'s output alone (decode and prefill: the aux loss is a
    training term)."""
    return _ffn_aux(p, cfg, x)[0]


class LM:
    """Functional language model: holds only the config."""

    def __init__(self, cfg: ModelConfig):
        validate(cfg)
        # the reference's pairings: audio and an encoder with encdec,
        # the vision frontend and M-RoPE with dense (qwen2-vl)
        encdec, dense = cfg.family == "encdec", cfg.family == "dense"
        allowed = ("audio",) if encdec else ("", "vision") if dense else ("",)
        if cfg.frontend not in allowed \
                or (cfg.mrope_sections and not dense) \
                or bool(cfg.encoder_layers) != encdec:
            raise NotImplementedError(
                f"{cfg.name}: no config of the reference pairs this frontend "
                f"({cfg.frontend!r}) or M-RoPE with the {cfg.family} family; "
                f"see ROADMAP.md queue 1")
        self.cfg = cfg

    # -- param init -----------------------------------------------------
    def init(self, seed: int = 0, device=None) -> Dict[str, Any]:
        """Random weights with the reference's shapes, scales and dtypes:
        normal matrices scaled by 1/sqrt(fan_in), embeddings by 0.02, norm
        scales one, the recurrent families' f32 leaves as the reference
        draws them. Drawn from a ``torch.Generator`` seeded with ``seed``
        on the target device, one layer at a time (f32 draws, stored in
        ``cfg.dtype`` unless the reference keeps the leaf in f32).

        With ``cfg.serve_weight_dtype == "int8"`` the same draws, in the
        same order, pass through ``quant.quantize_tree``'s rule (its name,
        ndim, dtype and the default ``min_size``) as they are made: a
        layer-stacked matrix is filled one layer's draw at a time into an
        int8 stack and its f32 scales, never held whole in ``cfg.dtype``,
        so the tree equals ``quantize_tree`` of the bf16 init bit for bit
        and a model whose bf16 weights exceed the card (mixtral-8x7b, 93
        GB) is drawn on it at 47 GB. The reference's ``LM.init`` ignores
        this field (its int8 trees come from ``quantize_tree`` after init,
        as ``launch/dryrun.py`` serves them); here it is the way to draw
        an int8 model too large to draw in bf16 first.

        The vision frontend's ``vision_adapter`` [d, d] is drawn after
        every other leaf, so no other leaf's draw depends on the frontend
        (the reference draws it from a key of its own)."""
        cfg = self.cfg
        dev = resolve_device(device)
        dt = L.dtype_of(cfg)
        gen = None if dev.type == "meta" else \
            torch.Generator(device=dev).manual_seed(seed)
        nl, d = cfg.num_layers, cfg.d_model
        int8 = cfg.serve_weight_dtype == "int8"

        def quantized(tree):
            return Q.quantize_tree(tree) if int8 else tree

        def normal(shape, scale, dtype=dt):
            return torch.randn(shape, generator=gen, device=dev,
                               dtype=torch.float32).mul_(scale).to(dtype)

        def uniform(shape, lo, hi):
            return torch.rand(shape, generator=gen, device=dev,
                              dtype=torch.float32) * (hi - lo) + lo

        def dense(fan_in, fan_out):
            return normal((fan_in, fan_out), 1.0 / math.sqrt(fan_in))

        def stacked(fan_in, fan_out, n=nl):
            return Q.stacked_init((n, fan_in, fan_out), dt, dev,
                                  lambda: normal((fan_in, fan_out),
                                                 1.0 / math.sqrt(fan_in)),
                                  int8)

        def ones(*shape):
            return torch.ones(shape, dtype=torch.float32, device=dev)

        def attention(mat, norm):
            p = {"w_q": mat(d, cfg.q_dim), "w_k": mat(d, cfg.kv_dim),
                 "w_v": mat(d, cfg.kv_dim), "w_o": mat(cfg.q_dim, d)}
            if cfg.use_qk_norm:
                p["q_norm"] = {"scale": norm(cfg.head_dim)}
                p["k_norm"] = {"scale": norm(cfg.head_dim)}
            return p

        def mlp(mat):
            return {"w_gate": mat(d, cfg.d_ff), "w_up": mat(d, cfg.d_ff),
                    "w_down": mat(cfg.d_ff, d)}

        params: Dict[str, Any] = {
            "embed": normal((cfg.padded_vocab, d), 0.02),
            "final_norm": {"scale": ones(d)},
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = normal((d, cfg.padded_vocab),
                                       1.0 / math.sqrt(d))
        if cfg.family == "hybrid":
            layers = []
            for kind in cfg._pattern():
                p = {"norm1": {"scale": ones(d)}}
                if kind == "rec":
                    p["rec"] = RG.rglru_init(cfg, normal, uniform)
                else:
                    p["attn"] = attention(dense, ones)
                p["norm2"] = {"scale": ones(d)}
                p["mlp"] = mlp(dense)
                layers.append(quantized(p))
            params["layers"] = tuple(layers)
        elif cfg.family == "ssm":
            params["layers"] = quantized(_stack([
                {"norm1": {"scale": ones(d)},
                 "ssd": SSD.ssd_init(cfg, normal, uniform)}
                for _ in range(nl)]))
        else:
            def attn_stack(n):
                mat = functools.partial(stacked, n=n)
                return {"norm1": {"scale": ones(n, d)},
                        "attn": attention(mat, lambda m: ones(n, m)),
                        "norm2": {"scale": ones(n, d)}}, mat

            params["layers"], mat = attn_stack(nl)
            if cfg.is_moe:
                params["layers"]["moe"] = MOE.moe_init(cfg, normal, nl, dt,
                                                       dev, int8)
            else:
                params["layers"]["mlp"] = mlp(mat)
            if cfg.family == "encdec":
                params["layers"]["norm_x"] = {"scale": ones(nl, d)}
                params["layers"]["xattn"] = attention(
                    mat, lambda m: ones(nl, m))
                enc, enc_mat = attn_stack(cfg.encoder_layers)
                enc["mlp"] = mlp(enc_mat)
                params["enc_layers"] = enc
                params["enc_norm"] = {"scale": ones(d)}
                params["adapter"] = quantized({"adapter": dense(d, d)})[
                    "adapter"]
        if cfg.frontend == "vision":       # after every other leaf
            params["vision_adapter"] = quantized(
                {"vision_adapter": dense(d, d)})["vision_adapter"]
        return params

    def param_specs(self):
        """The tree ``init`` draws, as tensors on the ``meta`` device:
        shapes and dtypes without weights."""
        return self.init(0, device="meta")

    # -- heads ----------------------------------------------------------
    def _head(self, params, h):
        """The LM head [d, V'] in h's dtype, ready for h (``L.gathered``)."""
        head = params["embed"].T if self.cfg.tie_embeddings \
            else params["lm_head"]
        return L.gathered(head.to(h.dtype), h)

    def _logits(self, params, h, head=None):
        """Logits [..., V'] f32 of the final hidden states ``h``; ``head``
        the LM head from ``_head`` (made here if None)."""
        cfg = self.cfg
        if head is None:
            head = self._head(params, h)
        logits = torch.matmul(h, head).float()
        logits = constrain(logits, *(["dp"] + [None] * (logits.dim() - 2)
                                     + ["model"]))
        if cfg.padded_vocab != cfg.vocab_size:   # mask the padding tail
            pad = torch.arange(cfg.padded_vocab, device=h.device) \
                >= cfg.vocab_size
            logits = logits.masked_fill(pad, -1e30)
        return L.softcap(logits, cfg.logits_softcap)

    # -- input embedding ------------------------------------------------
    def _embed(self, params, batch):
        """Token embeddings [b, s, d]; for the vision frontend,
        ``batch["vision_embeds"]`` [b, nv, d] (in the working dtype)
        through ``vision_adapter`` with f32 accumulation, cast back, over
        the first nv token slots."""
        x = L.embedding(params["embed"], batch["tokens"].long())
        x = constrain(x, "dp", None, None)
        if self.cfg.frontend == "vision" and "vision_embeds" in batch:
            ve = batch["vision_embeds"].to(x.dtype).float()
            w = L.gathered(Q.as_weight(params["vision_adapter"]).float(), ve)
            # out of place: x may be a view a sharding constraint made
            x = torch.cat([torch.matmul(ve, w).to(x.dtype),
                           x[:, ve.shape[1]:]], dim=1)
        return x

    def _positions(self, batch, s: int, device):
        """``batch["positions"]`` as given, else ``arange(s)`` int32: [s],
        or under M-RoPE its three equal streams [3, 1, s]."""
        if "positions" in batch:
            return batch["positions"]
        pos = torch.arange(s, dtype=torch.int32, device=device)
        if self.cfg.mrope_sections:
            return pos[None, None].expand(3, 1, s)
        return pos

    # -- encoder ----------------------------------------------------------
    def _encode(self, params, frames):
        """frames [b, src, d_model] -> the encoder's output [b, src,
        d_model]: the frames in the working dtype through ``adapter``, then
        the encoder's blocks with bidirectional attention, then
        ``enc_norm``."""
        cfg = self.cfg
        x = L.matmul(frames.to(L.dtype_of(cfg)), params["adapter"])
        pos = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
        block = _maybe_remat(lambda lp, h: _block_seq(
            lp, cfg, "attn", h, pos, causal=False), cfg)
        for lp in _unstack(params["enc_layers"], cfg.encoder_layers):
            x, _ = block(lp, x)
        return L.rmsnorm_apply(params["enc_norm"], x, cfg.norm_eps)

    # -- full-sequence forward (training) ---------------------------------
    def forward(self, params, batch):
        """(logits [b, s, V'] f32, aux)."""
        h, aux = self.forward_hidden(params, batch)
        return self._logits(params, h), aux

    def forward_hidden(self, params, batch):
        """(final-normed hidden states [b, s, d], aux): every block over the
        whole sequence, each under ``cfg.remat`` (deep stacks in √L groups
        checkpointed as wholes too, as the reference's two-level scan).
        ``batch`` as ``prefill`` reads it (tokens; frames for encdec;
        vision embeds and positions for the vision frontend); aux sums the
        MoE layers' losses in layer order."""
        cfg = self.cfg
        x = self._embed(params, batch)
        pos = self._positions(batch, x.shape[1], x.device)
        memory = mem_pos = None
        if cfg.family == "encdec":
            memory = self._encode(params, batch["frames"])
            mem_pos = torch.arange(memory.shape[1], dtype=torch.int32,
                                   device=x.device)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        if cfg.family == "hybrid":
            for lp, kind in zip(params["layers"], cfg._pattern()):
                kk = "rec" if kind == "rec" else "attn"
                x, a = _maybe_remat(lambda lp_, h, kk=kk: _block_seq(
                    lp_, cfg, kk, h, pos), cfg)(lp, x)
                aux = aux + a
        else:
            kind = ("attn_cross" if cfg.family == "encdec"
                    else "ssm" if cfg.family == "ssm"
                    else "attn_moe" if cfg.is_moe else "attn")
            block = _maybe_remat(lambda lp, h: _block_seq(
                lp, cfg, kind, h, pos, memory, mem_pos), cfg)

            def run(layers, h, ax):
                for lp in layers:
                    h, a = block(lp, h)
                    ax = ax + a
                return h, ax

            layers = _unstack(params["layers"], cfg.num_layers)
            groups = _scan_groups(cfg)
            if groups > 1:
                # two-level checkpointing: only group boundaries are saved
                # in the forward; one group's layer inputs come back at a
                # time in the backward
                per = cfg.num_layers // groups
                group = _maybe_remat(run, cfg)
                for gi in range(groups):
                    x, aux = group(layers[gi * per:(gi + 1) * per], x, aux)
            else:
                x, aux = run(layers, x, aux)
        return L.rmsnorm_apply(params["final_norm"], x, cfg.norm_eps), aux

    def loss(self, params, batch, *, ce_chunk: int = 512):
        """(ce + 0.01 aux, {"ce", "aux", "ntok"}) over ``batch["labels"]``
        [b, s] (-1: no target). Cross-entropy in chunks of ``ce_chunk``
        positions (rounded down to a divisor of s), each chunk's logits
        [b, chunk, V'] f32 made and dropped in turn and, unless
        ``cfg.remat`` is "none", recomputed in the backward: the [b, s, V']
        slab never lives whole."""
        cfg = self.cfg
        h, aux = self.forward_hidden(params, batch)
        labels = batch["labels"]
        s = h.shape[1]
        cs = min(ce_chunk, s)
        if s % cs:
            cs = next(c for c in range(cs, 0, -1) if s % c == 0)

        head = self._head(params, h)     # gathered once for every chunk

        def chunk_ce(hc, lc, head):
            logits = self._logits(params, hc, head)    # [b, cs, V'] f32
            mask = (lc >= 0).float()
            lse, gold = L.logsumexp_gold(logits, torch.clamp(lc, min=0))
            nll = (lse - gold) * mask
            return nll.sum(), mask.sum()

        if cfg.remat != "none" and s > cs and torch.is_grad_enabled():
            ce_fn = functools.partial(checkpoint, chunk_ce,
                                      use_reentrant=False)
        else:
            ce_fn = chunk_ce
        tot = ntok = torch.zeros((), dtype=torch.float32, device=h.device)
        for j in range(0, s, cs):
            tt, nn = ce_fn(h[:, j:j + cs], labels[:, j:j + cs], head)
            tot, ntok = tot + tt, ntok + nn
        ntok = torch.clamp(ntok, min=1.0)
        ce = tot / ntok
        return ce + 0.01 * aux, {"ce": ce, "aux": aux, "ntok": ntok}

    # -- prefill --------------------------------------------------------
    def prefill(self, params, batch, max_len: int, adapter=None):
        """Build the decode cache for one prompt batch.

        ``batch["tokens"]``: [b, s] ints; ``batch["length"]`` (optional int)
        is the true prompt length when the tokens are right-padded to a
        bucket: the cache position, the final logits and every family's
        carried state are taken at ``length``. encdec reads
        ``batch["frames"]`` [b, src, d_model]: its cross K/V have src rows,
        whatever ``cfg.source_len`` is. The vision frontend reads
        ``batch["vision_embeds"]`` [b, nv, d_model] if given (``_embed``);
        ``batch["positions"]`` (optional: [s], or [3, b, s] under M-RoPE)
        rotate q and k, and the mask reads stream 0 of row 0. Returns
        (logits [b, V] f32, cache) with the cache in the family's layout
        (``models.kvcache``).

        ``adapter`` (optional ``(A [d, r], B [r, d])``): per-session LoRA
        delta applied to the final hidden state before the LM head; the
        cache stays adapter-free.
        """
        cfg = self.cfg
        x = self._embed(params, batch)
        b, s = x.shape[0], x.shape[1]
        S = KV.kv_buffer_len(cfg, max_len)
        pos = self._positions(batch, s, x.device)
        length: Optional[int] = batch.get("length")
        last = s if length is None else int(length)
        cross = {}                # encdec: the cross K/V, top-level leaves
        # under a mesh the recurrent families' caches take the planner's
        # cache layout, filled shard by shard
        meta, specs = _cache_specs(cfg, b, max_len, x.device_mesh) \
            if SH.is_dtensor(x) and cfg.family in ("hybrid", "ssm") \
            else (None, None)
        if cfg.family == "hybrid":
            layers = []
            for lp, kind, sp, meta_l in zip(
                    params["layers"], cfg._pattern(),
                    specs or [None] * cfg.num_layers,
                    meta or [None] * cfg.num_layers):
                if kind == "rec":
                    x, cl = _rec_prefill(lp, cfg, x, length)
                    if sp is not None:
                        cl = {k: SH.redistribute(t, x.device_mesh,
                                                 placements(sp[k],
                                                            x.device_mesh))
                              for k, t in cl.items()}
                else:
                    x, k, v = _attn_prefill(lp, cfg, x, pos)
                    if sp is None:
                        cl = {"k": _ring_buffer(k, S, length),
                              "v": _ring_buffer(v, S, length)}
                    else:
                        cl = {}
                        for key, t in (("k", k), ("v", v)):
                            cl[key] = zeros(meta_l[key].shape, t.dtype,
                                            sp[key], x.device_mesh)
                            _fill_ring(cl[key], None, t, length)
                layers.append(cl)
            cache_layers = tuple(layers)
        elif cfg.family == "ssm":
            if specs is None:
                cache_layers = KV.init_cache(cfg, b, max_len,
                                             device=x.device)["layers"]
            else:
                cache_layers = {
                    k: zeros(t.shape, t.dtype, specs[k], x.device_mesh)
                    for k, t in meta.items()}
            for i in range(cfg.num_layers):
                lp = layer_params(params["layers"], i)
                x = constrain(x, "dp", None, None)
                h = L.rmsnorm_apply(lp["norm1"], x, cfg.norm_eps)
                y, (conv, ssm) = SSD.ssd_apply(lp["ssd"], cfg, h,
                                               length=length)
                x = constrain(x + y, "dp", None, None)
                _put_layer(cache_layers["conv"], i, conv)
                _put_layer(cache_layers["ssm"], i, ssm)
        else:
            shape = (cfg.num_layers, b, S, cfg.num_kv_heads, cfg.head_dim)
            ck, cv = _kv_buffer(cfg, shape, x), _kv_buffer(cfg, shape, x)
            n = min(s, S)
            ring = functools.partial(_ring_buffer, S=S, length=length)
            memory = mem_pos = None
            if cfg.family == "encdec":
                memory = self._encode(params, batch["frames"])
                src = memory.shape[1]
                mem_pos = torch.arange(src, dtype=torch.int32,
                                       device=x.device)
                cross = {key: torch.empty((cfg.num_layers, b, src) + shape[3:],
                                          dtype=x.dtype, device=x.device)
                         for key in ("cross_k", "cross_v")}
            for i in range(cfg.num_layers):
                lp = layer_params(params["layers"], i)
                x, k, v = _attn_prefill(lp, cfg, x, pos, memory, mem_pos)
                if cfg.sliding_window and SH.is_dtensor(ck):
                    _fill_ring(ck, i, k, length)
                    _fill_ring(cv, i, v, length)
                elif cfg.sliding_window:
                    ck[i], cv[i] = ring(k), ring(v)
                elif SH.is_dtensor(ck):
                    _fill_layer(ck, i, k, n)
                    _fill_layer(cv, i, v, n)
                else:
                    ck[i, :, :n] = k[:, :n]
                    cv[i, :, :n] = v[:, :n]
                if memory is not None:
                    cross["cross_k"][i], cross["cross_v"][i] = \
                        A.project_cross_kv(lp["xattn"], cfg, memory)
            cache_layers = {"k": ck, "v": cv}
        cache = {"layers": cache_layers,
                 "pos": torch.full((b,), last, dtype=torch.int32,
                                   device=x.device), **cross}
        x_last = L.rmsnorm_apply(params["final_norm"], x[:, last - 1],
                                 cfg.norm_eps)
        if adapter is not None:
            x_last = x_last + lora_apply_rows(x_last, adapter[0], adapter[1])
        return self._logits(params, x_last), cache

    # -- decode ---------------------------------------------------------
    def decode_step(self, params, cache, tokens, active=None, adapter=None):
        """tokens: [b, 1] -> (logits [b, 1, V], cache).

        The cache's tensors are updated in place; the returned dict shares
        them and carries ``pos + 1``. ``active`` ([b] bool) rows whose state
        may advance: inactive rows still flow through the batch but every
        cache leaf they own is left bit-identical. A cache with a
        ``"block"`` entry selects the paged layout.

        ``adapter`` (optional ``(A [E, d, r], B [E, r, d], idx [b],
        route)``): stacked LoRA tables plus the per-slot int32 adapter
        index. Each row's delta is added to the final hidden state before
        the LM head; index 0 is the null adapter (exact zero delta).

        encdec: the cache's ``cross_k``/``cross_v`` are read by every layer
        and returned unchanged."""
        cfg = self.cfg
        position = cache["pos"]
        block = cache.get("block")
        x = L.embedding(params["embed"], tokens.long())
        if cfg.family == "hybrid":
            for lp, cl, kind in zip(params["layers"], cache["layers"],
                                    cfg._pattern()):
                if kind == "rec":
                    x = _rec_decode(lp, cfg, x, cl, active=active)
                else:
                    x = _attn_decode(lp, cfg, x, cl["k"], cl["v"], position,
                                     active=active)
        elif cfg.family == "ssm":
            C = cache["layers"]
            for i in range(cfg.num_layers):
                lp = layer_params(params["layers"], i)
                h = L.rmsnorm_apply(lp["norm1"], x, cfg.norm_eps)
                y, (conv, ssm) = SSD.ssd_decode(lp["ssd"], cfg, h,
                                                C["conv"][i], C["ssm"][i])
                _keep_active(C["conv"][i], conv, active)
                _keep_active(C["ssm"][i], ssm, active)
                x = constrain(x + y, "dp", None, None)
        else:
            K, V = cache["layers"]["k"], cache["layers"]["v"]
            CK, CV = cache.get("cross_k"), cache.get("cross_v")
            for i in range(cfg.num_layers):
                x = _attn_decode(layer_params(params["layers"], i), cfg, x,
                                 K[i], V[i], position, active=active,
                                 block=block,
                                 cross=None if CK is None else (CK[i], CV[i]))
        new_cache = dict(cache)
        new_cache["pos"] = position + 1
        x = L.rmsnorm_apply(params["final_norm"], x, cfg.norm_eps)
        if adapter is not None:
            adp_a, adp_b, adp_idx, route = adapter
            delta = lora_delta(x[:, 0], adp_a, adp_b, adp_idx, route=route)
            x = x + delta[:, None]
        return self._logits(params, x), new_cache

    # -- cache helpers ----------------------------------------------------
    def init_cache(self, batch: int, max_len: int, *, device=None):
        return KV.init_cache(self.cfg, batch, max_len,
                             device=resolve_device(device))

    def init_paged_cache(self, slots: int, max_len: int, num_pages: int,
                         page_size: int, *, device=None):
        return KV.init_paged_cache(self.cfg, slots, max_len, num_pages,
                                   page_size, device=resolve_device(device))
