"""minitron-8b — pruned nemotron dense GQA [arXiv:2407.14679; hf].

32L d_model=4096 32H (GQA kv=8) d_ff=16384 vocab=256000.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="minitron-8b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=256000,
    rope_theta=10_000.0,
)


def smoke_config() -> ModelConfig:
    return CONFIG.smoke()
