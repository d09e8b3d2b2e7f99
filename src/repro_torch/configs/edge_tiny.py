"""edge-tiny — the paper's demo model: a small dense LM that executes for
real on CPU in the examples and serving tests (the AIS contract machinery is
model-agnostic; this keeps the end-to-end demos fast)."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="edge-tiny",
    family="dense",
    num_layers=4,
    d_model=256,
    num_heads=8,
    num_kv_heads=4,
    head_dim=32,
    d_ff=1024,
    vocab_size=2048,
    remat="none",
    attn_block_q=64,
    attn_block_kv=128,
)


def smoke_config() -> ModelConfig:
    return CONFIG.smoke()
