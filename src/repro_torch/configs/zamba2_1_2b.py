"""zamba2-1.2b [hybrid] — Mamba2 trunk + shared attention blocks [arXiv:2411.15242]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    num_layers=38,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,            # shared block is MHA
    d_ff=8192,
    vocab_size=32000,
    ssm_state=64,
    attn_every=19,              # shared block applied after each 19-layer segment
    dtype="bfloat16",
    citation="arXiv:2411.15242 (38L d2048 32H kv32 ff8192 vocab32000, "
             "ssm_state 64, Mamba2 + shared attn)",
)
