"""mixtral-8x7b — 8-expert top-2 MoE with sliding-window attention
[arXiv:2401.04088].

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000, SWA window 4096.
The sliding window bounds the decode cache, so long_500k is admissible.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=32000,
    rope_theta=1_000_000.0,
    sliding_window=4096,
    num_experts=8,
    num_experts_per_tok=2,
    moe_d_ff=14336,
)


def smoke_config() -> ModelConfig:
    return CONFIG.smoke()
