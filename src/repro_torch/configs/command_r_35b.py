"""command-r-35b — dense GQA, no-bias [hf:CohereForAI/c4ai-command-r-v01].

40L d_model=8192 64H (GQA kv=8) d_ff=22528 vocab=256000.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="command-r-35b",
    family="dense",
    num_layers=40,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=22528,
    vocab_size=256000,
    rope_theta=8_000_000.0,
    tie_embeddings=True,  # command-r ties input/output embeddings
)


def smoke_config() -> ModelConfig:
    return CONFIG.smoke()
