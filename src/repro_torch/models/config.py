"""Architecture configuration of the dense decoder family.

The fields of the reference's ``repro/models/config.py`` that the dense
decode path and ``param_count`` read, with ``torch_dtype`` in place of
``jdtype``. The other families' fields (MoE, SSM, encoder-decoder,
frontends) come with the slice that ports them (ROADMAP Queue 1 item 13).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                            # only 'dense' is ported
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None

    # attention flavour
    rope_fraction: float = 1.0        # chatglm3: 0.5 (2d/partial rotary)
    rope_theta: float = 10000.0
    sliding_window: Optional[int] = None   # mixtral: 4096
    qkv_bias: bool = False                 # qwen2: True
    mlp_style: str = "swiglu"              # 'swiglu' | 'gelu' (whisper)
    norm_style: str = "rmsnorm"            # 'rmsnorm' | 'layernorm'

    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "float32"                 # 'float32' on the CPU, 'bfloat16' on the card
    citation: str = ""

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def param_count(self) -> int:
        """Total parameters N of the dense decoder (analytic)."""
        D, F, V, L = self.d_model, self.d_ff, self.vocab_size, self.num_layers
        H, KV, hd = self.num_heads, self.num_kv_heads, self.hd
        emb = V * D * (1 if self.tie_embeddings else 2)
        attn = D * H * hd + 2 * D * KV * hd + H * hd * D
        mlp = 3 * D * F if self.mlp_style == "swiglu" else 2 * D * F
        return int(emb + L * (attn + mlp))


def smoke_variant(cfg: ModelConfig) -> ModelConfig:
    """Reduced config for CPU smoke tests: ≤2 layers, d_model≤256."""
    d = min(cfg.d_model, 256)
    heads = min(cfg.num_heads, 4)
    kv = max(1, min(cfg.num_kv_heads, heads))
    while heads % kv:
        kv -= 1
    return dataclasses.replace(
        cfg,
        num_layers=2,
        d_model=d,
        num_heads=heads,
        num_kv_heads=kv,
        head_dim=d // heads,
        d_ff=min(cfg.d_ff, 512),
        vocab_size=min(cfg.vocab_size, 512),
        sliding_window=min(cfg.sliding_window, 64) if cfg.sliding_window else None,
        dtype="float32",
    )
