"""mamba2-1.3b — attention-free SSD (state-space duality) [arXiv:2405.21060].

48L d_model=2048, ssm_state=128, headdim 64, expand 2, vocab 50280.
Decode state is O(1) in sequence length — the best case for AIS migration
and the canonical long_500k architecture.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=0,
    num_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_headdim=64,
    ssm_expand=2,
    ssm_chunk=128,
    tie_embeddings=True,
)


def smoke_config() -> ModelConfig:
    return CONFIG.smoke()
