"""rwkv6-7b [ssm] — Finch, data-dependent decay, attention-free [arXiv:2404.05892]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b",
    family="ssm",
    attn_free=True,
    num_layers=32,
    d_model=4096,
    num_heads=64,               # wkv heads = d_model/64
    num_kv_heads=64,
    d_ff=14336,
    vocab_size=65536,
    norm_style="layernorm",
    rope_fraction=0.0,
    dtype="bfloat16",
    citation="arXiv:2404.05892 (32L d4096 attn-free ff14336 vocab65536)",
)
