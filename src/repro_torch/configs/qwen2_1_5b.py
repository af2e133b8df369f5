"""qwen2-1.5b [dense] — GQA with QKV bias [arXiv:2407.10671]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-1.5b",
    family="dense",
    num_layers=28,
    d_model=1536,
    num_heads=12,
    num_kv_heads=2,
    d_ff=8960,
    vocab_size=151936,
    qkv_bias=True,
    rope_theta=1000000.0,
    tie_embeddings=True,
    dtype="bfloat16",
    citation="arXiv:2407.10671 (28L d1536 12H kv2 ff8960 vocab151936, QKV bias)",
)
