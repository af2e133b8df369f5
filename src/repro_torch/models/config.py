"""Architecture configuration: one schema for every family of the
reference's ``repro/models/config.py`` (dense / moe / vlm decoders, the
attention-free ssm family, the mamba2 + shared attention hybrid and the
audio encoder-decoder), field for field, with ``torch_dtype`` in place
of ``jdtype``. The MoE fields are read by :mod:`repro_torch.models.moe`,
the SSM ones by :mod:`~repro_torch.models.mamba2` and
:mod:`~repro_torch.models.rwkv6`, the encoder-decoder ones by
:mod:`~repro_torch.models.encdec`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str        # 'dense' | 'moe' | 'ssm' | 'hybrid' | 'vlm' | 'audio'
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

    # SSM / RWKV
    attn_free: bool = False                # rwkv6
    ssm_state: int = 0                     # mamba2 d_state (zamba2: 64)
    ssm_conv: int = 4
    attn_every: int = 0                    # hybrid: shared attn block period

    # encoder-decoder (whisper)
    is_encoder_decoder: bool = False
    encoder_layers: int = 0
    encoder_seq: int = 1500                # whisper-base 30 s → 1500 frames
    max_decoder_len: int = 448             # whisper model-card cap

    # modality frontend STUB (vlm/audio): prefix embeddings provided
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
        """Total parameters N (analytic; the reference's count, which
        leaves out norms, biases and small per-head vectors)."""
        D, F, V, L = self.d_model, self.d_ff, self.vocab_size, self.num_layers
        H, KV, hd = self.num_heads, self.num_kv_heads, self.hd
        emb = V * D * (1 if self.tie_embeddings else 2)
        attn = D * H * hd + 2 * D * KV * hd + H * hd * D
        if self.attn_free:                        # rwkv6: timemix + channelmix
            # time: r,k,v,g,o (5·D²) + low-rank decay; channel: k,v,r
            per_layer = 5 * D * D + 2 * D * 64 + 2 * D * F + D * D
        elif self.family in ("ssm", "hybrid"):
            dssm = 2 * D                              # mamba2 d_inner = 2*D
            per_layer = D * (2 * dssm + 2 * self.ssm_state +
                             self.num_heads) + dssm * D
        elif self.is_moe:
            per_layer = attn + self.num_experts * 3 * D * F
        else:
            per_layer = attn + (3 * D * F if self.mlp_style == "swiglu"
                                else 2 * D * F)
        total = emb + L * per_layer
        if self.family == "hybrid" and self.attn_every:
            total += attn + 3 * D * F                 # the shared block
        if self.is_encoder_decoder:
            total += self.encoder_layers * (attn + 2 * D * F)
            total += L * attn                         # cross-attention
        return int(total)

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
    experts at capacity factor 8 (no token dropped), d_state ≤ 16, a
    shared block every 2 layers, 2 encoder layers over 16 frames, 4
    prefix tokens for a frontend."""
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
        ssm_state=min(cfg.ssm_state, 16) if cfg.ssm_state else 0,
        attn_every=2 if cfg.attn_every else 0,
        encoder_layers=2 if cfg.is_encoder_decoder else 0,
        encoder_seq=16 if cfg.is_encoder_decoder else cfg.encoder_seq,
        num_prefix_tokens=4 if cfg.frontend else 0,
        dtype="float32",
    )
