"""llava-next-34b [vlm] — anyres tiling; vision tower STUBBED
[hf:llava-hf/llava-v1.6-mistral-7b-hf family, 34B dims per assignment]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b",
    family="vlm",
    num_layers=60,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    d_ff=20480,
    vocab_size=64000,
    frontend="vision",
    num_prefix_tokens=576,      # one anyres base tile of patch embeddings
    dtype="bfloat16",
    citation="hf:llava-hf/llava-v1.6 (60L d7168 56H kv8 ff20480 vocab64000; "
             "ViT+projector stubbed per spec)",
)
