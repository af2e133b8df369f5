"""qwen3-moe-235b-a22b [moe] — 128 experts top-8 [hf:Qwen/Qwen3-30B-A3B scaled per assignment]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    num_layers=94,
    d_model=4096,
    num_heads=64,
    num_kv_heads=4,
    d_ff=1536,                  # per-expert FFN width
    vocab_size=151936,
    num_experts=128,
    experts_per_token=8,
    rope_theta=1000000.0,
    dtype="bfloat16",
    citation="hf:Qwen/Qwen3-30B-A3B (assignment: 94L d4096 64H kv4 ff1536 "
             "vocab151936, 128e top-8)",
)
