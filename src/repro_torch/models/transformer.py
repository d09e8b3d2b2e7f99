"""Decoder-only LM of the dense GQA and MoE families.

Params are nested dicts of tensors shaped like the reference package's
pytree (layer weights stacked on a leading [L] axis), so the bridge moves
weights between the two packages leaf for leaf. The layer stack is a Python
loop over per-layer views of the stacked tensors; the decode cache is
updated in place.

Public surface:
    init(seed, device)                     -> params
    prefill(params, batch, max_len, adapter=None)
                                           -> (last_logits [b, V], cache)
    decode_step(params, cache, tokens [b, 1], active=None, adapter=None)
                                           -> (logits [b, 1, V], cache)

MoE layers (``attn_moe`` blocks: attention, then ``models.moe`` in place of
the MLP) serve configs of family ``moe`` without a sliding window. The
sliding-window, hybrid, SSM and encoder-decoder families are not ported yet
(ROADMAP.md queue 1, item 4).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch

from repro_torch import resolve_device
from repro_torch.adapters.runtime import lora_apply_rows, lora_delta
from repro_torch.models.config import ModelConfig, validate
from repro_torch.models import attention as A
from repro_torch.models import kvcache as KV
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE


def layer_params(tree, i: int):
    """View of layer ``i`` of a stacked param (or cache) tree."""
    if isinstance(tree, dict):
        return {k: layer_params(v, i) for k, v in tree.items()}
    return tree[i]


def _block_prefill(p, cfg: ModelConfig, x, positions):
    """Sequence pass of one layer; also returns its K/V [b, s, kh, hd].

    With a right-padded prompt, padded keys sit strictly after every real
    query (causality) and decode masks the buffer tail by position, so the
    cache equals the exact-length cache where it is ever read."""
    h = L.rmsnorm_apply(p["norm1"], x, cfg.norm_eps)
    k, v = A._project_kv(p["attn"], cfg, h, positions)
    q = A._project_q(p["attn"], cfg, h, positions)
    o = A.full_attention(q, k, v, positions, positions, cfg, causal=True)
    x = x + A._out_proj(p["attn"], cfg, o, x)
    return x + _ffn(p, cfg, x), k, v


def _block_decode(p, cfg: ModelConfig, x, k_layer, v_layer, position,
                  active=None, block=None):
    """Single-token pass of one layer; ``block`` selects the paged pool."""
    h = L.rmsnorm_apply(p["norm1"], x, cfg.norm_eps)
    if block is not None:
        y, _, _ = A.paged_decode_self_attention(
            p["attn"], cfg, h, k_layer, v_layer, block, position,
            active=active)
    else:
        y, _, _ = A.decode_self_attention(
            p["attn"], cfg, h, k_layer, v_layer, position, active=active)
    x = x + y
    return x + _ffn(p, cfg, x)


def _ffn(p, cfg: ModelConfig, x):
    """The block's second half on ``norm2(x)``: the MoE layer of an
    ``attn_moe`` block (its aux loss is a training term, unused here) or
    the dense MLP."""
    h2 = L.rmsnorm_apply(p["norm2"], x, cfg.norm_eps)
    if "moe" in p:
        return MOE.moe_apply(p["moe"], cfg, h2)[0]
    return L.mlp_apply(p["mlp"], h2)


class LM:
    """Functional language model: holds only the config."""

    def __init__(self, cfg: ModelConfig):
        validate(cfg)
        if cfg.family not in ("dense", "moe") or cfg.sliding_window \
                or cfg.encoder_layers or cfg.frontend:
            raise NotImplementedError(
                f"{cfg.name}: only the dense GQA and MoE families without a "
                f"window or frontend are ported; see ROADMAP.md queue 1, "
                f"item 4 (the other families)")
        self.cfg = cfg

    # -- param init -----------------------------------------------------
    def init(self, seed: int = 0, device=None) -> Dict[str, Any]:
        """Random weights with the reference's shapes and scales: normal
        matrices scaled by 1/sqrt(fan_in), embeddings by 0.02, norm scales
        one. Drawn from a ``torch.Generator`` seeded with ``seed`` on the
        target device, one layer at a time (f32 draws, stored in
        ``cfg.dtype``)."""
        cfg = self.cfg
        dev = resolve_device(device)
        dt = L.dtype_of(cfg)
        gen = torch.Generator(device=dev).manual_seed(seed)
        nl, d = cfg.num_layers, cfg.d_model

        def normal(shape, scale, out=None):
            w = torch.randn(shape, generator=gen, device=dev,
                            dtype=torch.float32).mul_(scale)
            if out is None:
                return w.to(dt)
            out.copy_(w)
            return out

        def stacked(fan_in, fan_out):
            w = torch.empty((nl, fan_in, fan_out), dtype=dt, device=dev)
            for i in range(nl):
                normal((fan_in, fan_out), 1.0 / math.sqrt(fan_in), out=w[i])
            return w

        def ones(*shape):
            return torch.ones(shape, dtype=torch.float32, device=dev)

        params: Dict[str, Any] = {
            "embed": normal((cfg.padded_vocab, d), 0.02),
            "final_norm": {"scale": ones(d)},
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = normal((d, cfg.padded_vocab),
                                       1.0 / math.sqrt(d))
        attn = {"w_q": stacked(d, cfg.q_dim), "w_k": stacked(d, cfg.kv_dim),
                "w_v": stacked(d, cfg.kv_dim), "w_o": stacked(cfg.q_dim, d)}
        if cfg.use_qk_norm:
            attn["q_norm"] = {"scale": ones(nl, cfg.head_dim)}
            attn["k_norm"] = {"scale": ones(nl, cfg.head_dim)}
        params["layers"] = {
            "norm1": {"scale": ones(nl, d)},
            "attn": attn,
            "norm2": {"scale": ones(nl, d)},
        }
        if cfg.is_moe:
            params["layers"]["moe"] = MOE.moe_init(cfg, normal, nl, dt, dev)
        else:
            params["layers"]["mlp"] = {"w_gate": stacked(d, cfg.d_ff),
                                       "w_up": stacked(d, cfg.d_ff),
                                       "w_down": stacked(cfg.d_ff, d)}
        return params

    # -- heads ----------------------------------------------------------
    def _logits(self, params, h):
        cfg = self.cfg
        head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
        logits = torch.matmul(h, head.to(h.dtype)).float()
        if cfg.padded_vocab != cfg.vocab_size:   # mask the padding tail
            pad = torch.arange(cfg.padded_vocab, device=h.device) \
                >= cfg.vocab_size
            logits = logits.masked_fill(pad, -1e30)
        return L.softcap(logits, cfg.logits_softcap)

    # -- prefill --------------------------------------------------------
    def prefill(self, params, batch, max_len: int, adapter=None):
        """Build the decode cache for one prompt batch.

        ``batch["tokens"]``: [b, s] ints; ``batch["length"]`` (optional int)
        is the true prompt length when the tokens are right-padded to a
        bucket: the cache position and the final logits are taken at
        ``length``. Returns (logits [b, V] f32, cache) with the cache in the
        dense layout ``{"layers": {"k", "v": [L, b, S, kh, hd]}, "pos"}``.

        ``adapter`` (optional ``(A [d, r], B [r, d])``): per-session LoRA
        delta applied to the final hidden state before the LM head; the KV
        cache stays adapter-free.
        """
        cfg = self.cfg
        tokens = batch["tokens"]
        x = params["embed"][tokens.long()]
        b, s = x.shape[0], x.shape[1]
        S = KV.kv_buffer_len(cfg, max_len)
        pos = batch.get("positions")
        if pos is None:
            pos = torch.arange(s, dtype=torch.int32, device=x.device)
        length: Optional[int] = batch.get("length")
        shape = (cfg.num_layers, b, S, cfg.num_kv_heads, cfg.head_dim)
        ck = torch.zeros(shape, dtype=x.dtype, device=x.device)
        cv = torch.zeros(shape, dtype=x.dtype, device=x.device)
        n = min(s, S)
        for i in range(cfg.num_layers):
            x, k, v = _block_prefill(layer_params(params["layers"], i), cfg,
                                     x, pos)
            ck[i, :, :n] = k[:, :n]
            cv[i, :, :n] = v[:, :n]
        last = s if length is None else int(length)
        cache = {"layers": {"k": ck, "v": cv},
                 "pos": torch.full((b,), last, dtype=torch.int32,
                                   device=x.device)}
        x_last = L.rmsnorm_apply(params["final_norm"], x[:, last - 1],
                                 cfg.norm_eps)
        if adapter is not None:
            x_last = x_last + lora_apply_rows(x_last, adapter[0], adapter[1])
        return self._logits(params, x_last), cache

    # -- decode ---------------------------------------------------------
    def decode_step(self, params, cache, tokens, active=None, adapter=None):
        """tokens: [b, 1] -> (logits [b, 1, V], cache).

        The cache's K/V tensors are updated in place; the returned dict
        shares them and carries ``pos + 1``. ``active`` ([b] bool) rows
        whose state may advance: inactive rows still flow through the batch
        but their K/V rows are left bit-identical. A cache with a
        ``"block"`` entry selects the paged layout.

        ``adapter`` (optional ``(A [E, d, r], B [E, r, d], idx [b],
        route)``): stacked LoRA tables plus the per-slot int32 adapter
        index. Each row's delta is added to the final hidden state before
        the LM head; index 0 is the null adapter (exact zero delta)."""
        cfg = self.cfg
        position = cache["pos"]
        block = cache.get("block")
        x = params["embed"][tokens.long()]
        K, V = cache["layers"]["k"], cache["layers"]["v"]
        for i in range(cfg.num_layers):
            x = _block_decode(layer_params(params["layers"], i), cfg, x,
                              K[i], V[i], position, active=active,
                              block=block)
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
