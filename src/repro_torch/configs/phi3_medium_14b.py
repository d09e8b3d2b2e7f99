"""phi3-medium-14b — dense GQA decoder [arXiv:2404.14219; unverified].

40L d_model=5120 40H (GQA kv=10) d_ff=17920 vocab=100352 — RoPE SwiGLU GQA.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi3-medium-14b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=40,
    num_kv_heads=10,
    head_dim=128,
    d_ff=17920,
    vocab_size=100352,
    rope_theta=10_000.0,
)


def smoke_config() -> ModelConfig:
    return CONFIG.smoke()
