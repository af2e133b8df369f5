"""mixtral-8x22b [moe] — 8 experts top-2, sliding-window attention [arXiv:2401.04088]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    num_layers=56,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=16384,
    vocab_size=32768,
    num_experts=8,
    experts_per_token=2,
    sliding_window=4096,        # per model card → long_500k runs windowed
    rope_theta=1000000.0,
    dtype="bfloat16",
    citation="arXiv:2401.04088 (56L d6144 48H kv8 ff16384 vocab32768, "
             "8e top-2, SWA 4096)",
)
