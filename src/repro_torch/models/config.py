"""Model configuration for the NE-AIaaS execution substrate.

One ``ModelConfig`` describes any of the assigned architecture families:

* ``dense``  — decoder-only transformer with GQA (phi3, command-r, codeqwen,
               minitron, qwen2-vl backbone).
* ``moe``    — decoder-only with mixture-of-experts FFN (qwen3-moe, mixtral).
* ``hybrid`` — RG-LRU recurrent blocks interleaved with local attention
               (recurrentgemma / Griffin pattern).
* ``ssm``    — attention-free Mamba-2 (SSD) stack.
* ``encdec`` — encoder-decoder (seamless-m4t backbone; audio frontend stubbed).

The config is a frozen dataclass so it can be hashed and carried inside AIS
catalog entries.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class ModelConfig:
    # -- identity ---------------------------------------------------------
    name: str
    family: str  # dense | moe | hybrid | ssm | encdec
    # -- trunk ------------------------------------------------------------
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    # -- attention --------------------------------------------------------
    sliding_window: int = 0          # 0 => full causal attention
    rope_theta: float = 10_000.0
    mrope_sections: Tuple[int, ...] = ()   # qwen2-vl M-RoPE (t,h,w) half-dims
    use_qk_norm: bool = False
    attn_logits_softcap: float = 0.0
    # -- MoE ----------------------------------------------------------------
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_d_ff: int = 0
    moe_capacity_factor: float = 1.25
    moe_impl: str = "einsum"        # einsum | scatter | dense
    moe_chunk: int = 2048            # tokens per dispatch chunk (einsum impl)
    # -- hybrid (RG-LRU) ----------------------------------------------------
    block_pattern: Tuple[str, ...] = ()   # e.g. ("rec", "rec", "attn")
    lru_width: int = 0
    conv_width: int = 4
    # -- SSM (Mamba-2 / SSD) -------------------------------------------------
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 128
    ssm_ngroups: int = 1
    # -- encoder-decoder ------------------------------------------------------
    encoder_layers: int = 0
    source_len: int = 1536           # stubbed frontend frames/patches
    # -- frontend stubs -------------------------------------------------------
    frontend: str = ""               # "" | "vision" | "audio"
    num_frontend_tokens: int = 0     # vision tokens prepended to the stream
    # -- numerics / structure ---------------------------------------------
    norm_eps: float = 1e-6
    use_bias: bool = False
    tie_embeddings: bool = False
    logits_softcap: float = 0.0
    dtype: str = "bfloat16"
    remat: str = "full"              # none | dots | full
    scan_layers: bool = True
    attn_block_q: int = 256
    attn_block_kv: int = 1024
    # -- distribution levers (kept for config parity with the reference
    #    package; the port's serving path does not read them yet) ----------
    kv_shard: str = "auto"           # auto | heads | seq — decode cache axis
    serve_embed_replicated: bool = False
    serve_fsdp_mode: str = "auto"    # auto | on | off — weight-gathered serve
    serve_weight_dtype: str = "bfloat16"  # bfloat16 | int8 (weight-only quant)
    train_microbatches: int = 0      # 0 = auto (planner memory budget)

    # ------------------------------------------------------------------
    # derived quantities
    # ------------------------------------------------------------------
    @property
    def padded_vocab(self) -> int:
        """Embedding/unembedding table rows padded so the vocab dim shards
        over any reasonable model axis (non-divisible vocabs like 50280 /
        256206 otherwise force replicated lm_heads and unsharded logits).
        The tail logits are masked to -inf; tokens never map there."""
        m = 256
        return ((self.vocab_size + m - 1) // m) * m

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def d_inner(self) -> int:
        """SSM inner width."""
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.d_inner // self.ssm_headdim

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def decode_state_kind(self) -> str:
        """What session-state migration must transfer (see DESIGN.md §4)."""
        if self.family == "ssm":
            return "recurrent"
        if self.family == "hybrid":
            return "recurrent+window"
        if self.sliding_window > 0:
            return "window"
        return "kv_full"

    @property
    def sub_quadratic(self) -> bool:
        """True when long_500k decode is admissible (bounded decode state)."""
        return self.family in ("ssm", "hybrid") or self.sliding_window > 0

    @property
    def has_decode(self) -> bool:
        """Encoder-only archs would return False; all assigned archs decode."""
        return True

    def param_count(self) -> int:
        """Analytic parameter count (embedding + trunk), used by predictors
        and the roofline MODEL_FLOPS term."""
        d, L = self.d_model, self.num_layers
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        if self.family == "ssm":
            di, ns = self.d_inner, self.ssm_state
            nh = self.ssm_nheads
            conv_dim = di + 2 * self.ssm_ngroups * ns
            per = (
                d * (2 * di + 2 * self.ssm_ngroups * ns + nh)   # in_proj
                + conv_dim * self.conv_width                      # conv1d
                + di * d                                          # out_proj
                + 2 * nh + di                                     # A, D, norm
                + d
            )
            return emb + L * per
        attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
        if self.is_moe:
            ffn = self.num_experts * 3 * d * self.moe_d_ff + d * self.num_experts
        else:
            ffn = 3 * d * self.d_ff
        norms = 2 * d
        per = attn + ffn + norms
        if self.family == "hybrid":
            n_attn = sum(1 for k in self._pattern() if k == "attn")
            n_rec = L - n_attn
            w = self.lru_width or d
            rec = 2 * d * w + w * self.conv_width + w * d + 2 * w * w // 8 + 4 * w
            # rec block: in/gate proj, conv, out proj, (block-diag a/i gates), lru params
            per_attn = attn + 3 * d * self.d_ff + 2 * d
            per_rec = rec + 3 * d * self.d_ff + 2 * d
            return emb + n_attn * per_attn + n_rec * per_rec
        if self.family == "encdec":
            enc = self.encoder_layers * (attn + 3 * d * self.d_ff + 2 * d)
            dec = L * (attn + attn + 3 * d * self.d_ff + 3 * d)  # + cross attn
            return emb + enc + dec
        return emb + L * per

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top-k experts only)."""
        if not self.is_moe:
            return self.param_count()
        d, L = self.d_model, self.num_layers
        total = self.param_count()
        all_experts = L * self.num_experts * 3 * d * self.moe_d_ff
        active = L * self.num_experts_per_tok * 3 * d * self.moe_d_ff
        return total - all_experts + active

    def _pattern(self) -> Tuple[str, ...]:
        """Expanded per-layer block pattern for hybrid models."""
        if self.family != "hybrid":
            return tuple("attn" for _ in range(self.num_layers))
        pat = self.block_pattern or ("rec", "rec", "attn")
        out = []
        while len(out) < self.num_layers:
            out.extend(pat)
        return tuple(out[: self.num_layers])

    def smoke(self) -> "ModelConfig":
        """Reduced same-family config for CPU smoke tests."""
        kw = dict(
            name=self.name + "-smoke",
            num_layers=min(self.num_layers, 4 if self.family == "hybrid" else 2),
            d_model=64,
            num_heads=4,
            num_kv_heads=max(1, min(self.num_kv_heads, 2)),
            head_dim=16,
            d_ff=128,
            vocab_size=512,
            source_len=24,
            moe_chunk=32,
            attn_block_q=16,
            attn_block_kv=32,
            remat="none",
        )
        if self.family == "hybrid":
            kw["num_layers"] = 4  # rec, rec, attn, rec
            kw["lru_width"] = 64
            kw["sliding_window"] = 16
        if self.sliding_window:
            kw["sliding_window"] = 16
        if self.is_moe:
            kw["num_experts"] = 4
            kw["num_experts_per_tok"] = min(self.num_experts_per_tok, 2)
            kw["moe_d_ff"] = 64
            # drop-free capacity so prefill/decode exactly match forward
            kw["moe_capacity_factor"] = 4.0
        if self.family == "ssm":
            kw["ssm_state"] = 16
            kw["ssm_headdim"] = 16
            kw["ssm_chunk"] = 16
            kw["num_heads"] = 0
            kw["num_kv_heads"] = 0
            kw["head_dim"] = 0
            kw["d_ff"] = 0
        if self.family == "encdec":
            kw["encoder_layers"] = 2
        if self.mrope_sections:
            kw["mrope_sections"] = (4, 2, 2)
        if self.num_frontend_tokens:
            kw["num_frontend_tokens"] = 8
        return dataclasses.replace(self, **kw)


def validate(cfg: ModelConfig) -> None:
    if cfg.family not in ("dense", "moe", "hybrid", "ssm", "encdec"):
        raise ValueError(f"unknown family {cfg.family}")
    if cfg.family != "ssm":
        if cfg.num_heads % max(cfg.num_kv_heads, 1):
            raise ValueError("num_heads must be a multiple of num_kv_heads")
    if cfg.is_moe and cfg.num_experts_per_tok > cfg.num_experts:
        raise ValueError("top-k exceeds expert count")
    if cfg.mrope_sections and sum(cfg.mrope_sections) != cfg.head_dim // 2:
        raise ValueError("mrope sections must sum to head_dim//2")
    if cfg.family == "ssm" and cfg.d_inner % cfg.ssm_headdim:
        raise ValueError("d_inner must divide into ssm heads")
