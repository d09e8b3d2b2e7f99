"""recurrentgemma-2b — RG-LRU + local attention, pattern (rec, rec, attn)
[arXiv:2402.19427; hf].

26L d_model=2560 10H (MQA kv=1, head_dim 256) d_ff=7680 vocab=256000,
local window 2048, logits softcap 30. Decode state = RG-LRU states +
2048-token rings: bounded, so long_500k is admissible.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    num_layers=26,
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256000,
    rope_theta=10_000.0,
    sliding_window=2048,
    block_pattern=("rec", "rec", "attn"),
    lru_width=2560,
    conv_width=4,
    logits_softcap=30.0,
    tie_embeddings=True,
)


def smoke_config() -> ModelConfig:
    return CONFIG.smoke()
