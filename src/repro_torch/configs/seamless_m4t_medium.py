"""seamless-m4t-medium — encoder-decoder multimodal backbone
[arXiv:2308.11596; hf].

12L enc + 12L dec, d_model=1024 16H (MHA kv=16) d_ff=4096 vocab=256206.
The audio frontend is a STUB per the assignment: input_specs() provides
precomputed frame embeddings [b, src, d_model] fed through the encoder
adapter. source_len=1536 frames (~30 s of speech after downsampling).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="encdec",
    num_layers=12,
    encoder_layers=12,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=256206,
    frontend="audio",
    source_len=1536,
)


def smoke_config() -> ModelConfig:
    return CONFIG.smoke()
