"""qwen3-moe-30b-a3b — 128-expert top-8 MoE [hf:Qwen/Qwen3-30B-A3B].

48L d_model=2048 32H (GQA kv=4) moe_d_ff=768 vocab=151936, 128e top-8,
qk-norm (qwen3 family).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=768,
    vocab_size=151936,
    rope_theta=1_000_000.0,
    use_qk_norm=True,
    num_experts=128,
    num_experts_per_tok=8,
    moe_d_ff=768,
)


def smoke_config() -> ModelConfig:
    return CONFIG.smoke()
