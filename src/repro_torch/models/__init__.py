"""Model zoo of the port: the dense, MoE and VLM decoders (forward, loss
and the serve path)."""
from repro_torch.models.config import ModelConfig, smoke_variant
from repro_torch.models.transformer import (DecodeState, TransformerModel,
                                            build_model)

__all__ = ["DecodeState", "ModelConfig", "smoke_variant", "TransformerModel",
           "build_model"]
