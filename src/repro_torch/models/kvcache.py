"""Decode-state (cache) construction per architecture family.

The cache dict is *the* session state that AIS migration transfers between
execution anchors (see ``repro_torch.serving.state_transfer``). Its size —
reported by ``cache_bytes`` — feeds the discovery cost predictor and the
migration deadline feasibility check.

Layouts (the same trees the reference package builds):

* dense/moe : ``{"layers": {"k", "v": [L, b, S, kh, hd]}, "pos": [b]
  int32}``, S = context, or a sliding-window ring (S = window)
* paged     : ``{"layers": {"k", "v": [L, P, page, kh, hd]},
  "block": [slots, pages_per_slot] int32, "pos": [slots] int32}``
* ssm       : ``{"layers": {"conv": [L, b, K-1, conv_dim], "ssm":
  [L, b, nh, hp, n] f32}, "pos"}`` — O(1) in context length
* hybrid    : ``{"layers": (per-layer dicts, slot-first: {"conv":
  [b, K-1, w], "h": [b, w] f32} for RG-LRU layers, {"k", "v":
  [b, S, kh, hd]} rings for attention layers), "pos"}``
* encdec    : the dense layout of the decoder's self attention plus
  ``"cross_k"``, ``"cross_v"``: [L, b, src, kh, hd], the encoder side's
  K/V projected once at prefill and read, never written, by decode
"""

from __future__ import annotations

import torch

from repro_torch.models.config import ModelConfig

_ITEMSIZE = {"bfloat16": 2, "float16": 2, "float32": 4}


def kv_buffer_len(cfg: ModelConfig, max_len: int) -> int:
    if cfg.sliding_window:
        return min(cfg.sliding_window, max_len)
    return max_len


def _cache_shapes(cfg: ModelConfig, batch: int, max_len: int):
    """[(shape, itemsize)] of every leaf of the reference decode cache."""
    it = _ITEMSIZE[cfg.dtype]
    out = [((batch,), 4)]                                   # pos
    L = cfg.num_layers
    if cfg.family == "ssm":
        nh, hp, ns = cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_state
        conv_dim = cfg.d_inner + 2 * cfg.ssm_ngroups * ns
        out.append(((L, batch, cfg.conv_width - 1, conv_dim), it))
        out.append(((L, batch, nh, hp, ns), 4))
        return out
    S = kv_buffer_len(cfg, max_len)
    kv = (batch, S, cfg.num_kv_heads, cfg.head_dim)
    if cfg.family == "hybrid":
        w = cfg.lru_width or cfg.d_model
        for kind in cfg._pattern():
            if kind == "rec":
                out.append(((batch, cfg.conv_width - 1, w), it))
                out.append(((batch, w), 4))
            else:
                out += [(kv, it), (kv, it)]
        return out
    out += [((L,) + kv, it), ((L,) + kv, it)]
    if cfg.family == "encdec":
        cross = (L, batch, cfg.source_len, cfg.num_kv_heads, cfg.head_dim)
        out += [(cross, it), (cross, it)]
    return out


def cache_bytes(cfg: ModelConfig, batch: int, max_len: int) -> int:
    """Total bytes of the decode cache (the migration payload size)."""
    total = 0
    for shape, it in _cache_shapes(cfg, batch, max_len):
        n = 1
        for d in shape:
            n *= d
        total += n * it
    return int(total)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device=None) -> dict:
    """Zeroed decode cache in the reference's layout for the family."""
    from repro_torch.models.layers import dtype_of
    dt = dtype_of(cfg)

    def zeros(shape, dtype=dt):
        return torch.zeros(shape, dtype=dtype, device=device)

    pos = zeros((batch,), torch.int32)
    L = cfg.num_layers
    if cfg.family == "ssm":
        from repro_torch.models.ssd import ssd_state_shapes
        shp = ssd_state_shapes(cfg, batch)
        return {"layers": {"conv": zeros((L,) + shp["conv"]),
                           "ssm": zeros((L,) + shp["ssm"], torch.float32)},
                "pos": pos}
    kv = (batch, kv_buffer_len(cfg, max_len), cfg.num_kv_heads, cfg.head_dim)
    if cfg.family == "hybrid":
        from repro_torch.models.rglru import rglru_state_shapes
        shp = rglru_state_shapes(cfg, batch)
        return {"layers": tuple(
            {"conv": zeros(shp["conv"]), "h": zeros(shp["h"], torch.float32)}
            if kind == "rec" else {"k": zeros(kv), "v": zeros(kv)}
            for kind in cfg._pattern()), "pos": pos}
    cache = {"layers": {"k": zeros((L,) + kv), "v": zeros((L,) + kv)},
             "pos": pos}
    if cfg.family == "encdec":
        cross = (L, batch, cfg.source_len, cfg.num_kv_heads, cfg.head_dim)
        cache["cross_k"], cache["cross_v"] = zeros(cross), zeros(cross)
    return cache


# ---------------------------------------------------------------------------
# paged layout (block-table KV)
# ---------------------------------------------------------------------------
#
# K/V live in a global page pool of ``num_pages`` fixed-size pages shared by
# every slot, and each slot owns a block table of page ids. A slot holding
# ``n`` tokens costs ``ceil(n / page_size)`` pages instead of a full
# ``max_len`` reservation.
#
# Layout invariant: **page 0 is the shared scratch/null page.** Unallocated
# block-table entries point at it, and decode routes the writes of inactive
# slots there. It is never read: attention reads only rows below each row's
# length, and positions never reach unallocated pages.

#: default page length in tokens (pow2; clamped to the context by page_len)
DEFAULT_PAGE_SIZE = 128


def supports_paging(cfg: ModelConfig) -> bool:
    """Only full-attention stacked-KV families page: their cache grows
    linearly in context."""
    return cfg.family in ("dense", "moe") and not cfg.sliding_window


def page_len(cfg: ModelConfig, max_len: int, page_size: int = DEFAULT_PAGE_SIZE
             ) -> int:
    """Effective page length: requested pow2 size clamped so a page never
    exceeds the context (a single oversized page would re-reserve max_len)."""
    if page_size <= 0 or page_size & (page_size - 1):
        raise ValueError(f"page_size must be a power of two, got {page_size}")
    p = page_size
    while p > 1 and p > max_len:
        p //= 2
    return p


def pages_per_slot(max_len: int, page_size: int) -> int:
    return -(-max_len // page_size)


def _check_paging(cfg: ModelConfig) -> None:
    if not supports_paging(cfg):
        raise ValueError(f"family {cfg.family} (window={cfg.sliding_window}) "
                         "does not support the paged KV layout")


def init_paged_cache(cfg: ModelConfig, slots: int, max_len: int,
                     num_pages: int, page_size: int, *, device=None) -> dict:
    """Paged decode cache: global page pool + per-slot block tables.

    ``"block" in cache`` is how ``LM.decode_step`` detects the paged layout.
    """
    _check_paging(cfg)
    from repro_torch.models.layers import dtype_of
    shape = (cfg.num_layers, num_pages, page_size, cfg.num_kv_heads,
             cfg.head_dim)
    pps = pages_per_slot(max_len, page_size)
    return {"layers": {"k": torch.zeros(shape, dtype=dtype_of(cfg),
                                        device=device),
                       "v": torch.zeros(shape, dtype=dtype_of(cfg),
                                        device=device)},
            "block": torch.zeros((slots, pps), dtype=torch.int32,
                                 device=device),
            "pos": torch.zeros((slots,), dtype=torch.int32, device=device)}


def page_bytes(cfg: ModelConfig, page_size: int) -> int:
    """Bytes of ONE page across all layers (the allocation granule)."""
    return int(2 * cfg.num_layers * page_size * cfg.num_kv_heads
               * cfg.head_dim * _ITEMSIZE[cfg.dtype])


def paged_cache_bytes(cfg: ModelConfig, slots: int, max_len: int,
                      num_pages: int, page_size: int) -> int:
    """Total bytes of the paged cache (pool + block tables + positions)."""
    _check_paging(cfg)
    pps = pages_per_slot(max_len, page_size)
    pool = (cfg.num_layers * num_pages * page_size * cfg.num_kv_heads
            * cfg.head_dim * _ITEMSIZE[cfg.dtype])
    return int(2 * pool + 4 * slots * pps + 4 * slots)
