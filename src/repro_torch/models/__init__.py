"""Model zoo of the port: the dense, MoE and VLM decoders, the
attention-free rwkv6, the mamba2 hybrid and the encoder-decoder (forward,
loss and the serve path); ``build_model`` picks the family's model."""
from repro_torch.models.config import ModelConfig, smoke_variant
from repro_torch.models.transformer import (DecodeState, TransformerModel,
                                            build_model)

__all__ = ["DecodeState", "ModelConfig", "smoke_variant", "TransformerModel",
           "build_model"]
