"""qwen2-vl-72b — VLM backbone with M-RoPE [arXiv:2409.12191; hf].

80L d_model=8192 64H (GQA kv=8) d_ff=29568 vocab=152064. The vision frontend
is a STUB per the assignment: input_specs() provides precomputed patch
embeddings [b, n_img, d_model] spliced over the first n_img token slots and
passed through a learned adapter. M-RoPE uses (t, h, w) position streams
with half-dim sections (16, 24, 24).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b",
    family="dense",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=29568,
    vocab_size=152064,
    rope_theta=1_000_000.0,
    mrope_sections=(16, 24, 24),
    frontend="vision",
    num_frontend_tokens=256,
)


def smoke_config() -> ModelConfig:
    return CONFIG.smoke()
