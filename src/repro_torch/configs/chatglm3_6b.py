"""chatglm3-6b [dense] — 2d/partial RoPE, GQA [arXiv:2406.12793]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b",
    family="dense",
    num_layers=28,
    d_model=4096,
    num_heads=32,
    num_kv_heads=2,
    d_ff=13696,
    vocab_size=65024,
    rope_fraction=0.5,          # 2d RoPE: rotate half the head dim
    qkv_bias=True,              # chatglm uses QKV bias
    dtype="bfloat16",
    citation="arXiv:2406.12793 (28L d4096 32H kv2 ff13696 vocab65024, "
             "partial rotary)",
)
