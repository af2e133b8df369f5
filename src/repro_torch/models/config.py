"""Architecture configuration of the dense decoder family, the MoE
family (the decoder with a routed expert layer in place of its MLP) and
the VLM family (the dense decoder behind stub prefix embeddings).

The fields of the reference's ``repro/models/config.py`` that these
paths and ``param_count`` read, with ``torch_dtype`` in place of
``jdtype``. The MoE fields (``num_experts``, ``experts_per_token``,
``router_aux_coef``, ``moe_capacity_factor``) are read by
:mod:`repro_torch.models.moe`. The SSM, hybrid and encoder-decoder
fields come with ROADMAP Queue 1 items 13e and 13f.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                            # 'dense' | 'moe' | 'vlm' are ported
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None

    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    router_aux_coef: float = 0.01
    moe_capacity_factor: float = 1.25

    # attention flavour
    rope_fraction: float = 1.0        # chatglm3: 0.5 (2d/partial rotary)
    rope_theta: float = 10000.0
    sliding_window: Optional[int] = None   # mixtral: 4096
    qkv_bias: bool = False                 # qwen2: True
    mlp_style: str = "swiglu"              # 'swiglu' | 'gelu' (whisper)
    norm_style: str = "rmsnorm"            # 'rmsnorm' | 'layernorm'

    # modality frontend STUB (vlm): prefix embeddings provided
    frontend: Optional[str] = None         # 'vision' | 'audio'
    num_prefix_tokens: int = 0             # llava anyres patch tokens

    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "float32"                 # 'float32' on the CPU, 'bfloat16' on the card
    remat: bool = False                    # checkpoint each layer (training)
    citation: str = ""

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    def param_count(self) -> int:
        """Total parameters N of the decoder stack (analytic)."""
        D, F, V, L = self.d_model, self.d_ff, self.vocab_size, self.num_layers
        H, KV, hd = self.num_heads, self.num_kv_heads, self.hd
        emb = V * D * (1 if self.tie_embeddings else 2)
        attn = D * H * hd + 2 * D * KV * hd + H * hd * D
        if self.is_moe:
            mlp = self.num_experts * 3 * D * F
        else:
            mlp = 3 * D * F if self.mlp_style == "swiglu" else 2 * D * F
        return int(emb + L * (attn + mlp))

    def active_param_count(self) -> int:
        """N_active: the parameters one token passes through."""
        if not self.is_moe:
            return self.param_count()
        D, F, L = self.d_model, self.d_ff, self.num_layers
        all_experts = L * self.num_experts * 3 * D * F
        active = L * self.experts_per_token * 3 * D * F
        return int(self.param_count() - all_experts + active)


def smoke_variant(cfg: ModelConfig) -> ModelConfig:
    """Reduced config for CPU smoke tests: ≤2 layers, d_model≤256, ≤4
    experts at capacity factor 8 (no token dropped), 4 prefix tokens for
    a frontend."""
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
        num_experts=min(cfg.num_experts, 4) if cfg.is_moe else 0,
        experts_per_token=min(cfg.experts_per_token, 2) if cfg.is_moe else 0,
        moe_capacity_factor=8.0 if cfg.is_moe else cfg.moe_capacity_factor,
        sliding_window=min(cfg.sliding_window, 64) if cfg.sliding_window else None,
        num_prefix_tokens=4 if cfg.frontend else 0,
        dtype="float32",
    )
