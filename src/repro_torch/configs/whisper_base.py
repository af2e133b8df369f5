"""whisper-base [audio] — enc-dec; mel+conv frontend STUBBED [arXiv:2212.04356]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="audio",
    is_encoder_decoder=True,
    encoder_layers=6,
    num_layers=6,               # decoder layers
    d_model=512,
    num_heads=8,
    num_kv_heads=8,
    d_ff=2048,
    vocab_size=51865,
    encoder_seq=1500,           # 30 s of audio → 1500 frames
    max_decoder_len=448,        # model-card cap (decode shapes exceed family
                                # range; lowered mechanically, see DESIGN.md)
    mlp_style="gelu",
    norm_style="layernorm",
    qkv_bias=True,
    rope_fraction=0.0,          # learned/sinusoidal absolute positions
    tie_embeddings=True,
    dtype="bfloat16",
    citation="arXiv:2212.04356 (6L enc + 6L dec, d512 8H ff2048 vocab51865)",
)
