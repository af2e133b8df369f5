"""Analytic cost model per architecture family, ported from
``repro/launch/costs.py``: the whole step's FLOPs and HBM bytes from exact
per-op formulas (the MaxText/MFU convention), over the port's
``ModelConfig`` and its own ``rwkv6`` / ``mamba2`` constants.

All counts are GLOBAL (the whole step, all ranks); divide by the ranks
and a device's peak at report time. The backward pass ≈ 2× the forward;
the attention and SSM sequence terms are counted explicitly. The shapes
are :class:`repro_torch.launch.steps.InputShape` s (anything with
``kind``, ``seq_len`` and ``global_batch``).
"""
from __future__ import annotations

import dataclasses

from repro_torch.models.config import ModelConfig


def _attn_flops(cfg: ModelConfig, B: int, S: int, kv_len: int,
                causal: bool) -> float:
    """QKᵀ + PV flops for one layer, forward. Causal halves the area."""
    H, hd = cfg.num_heads, cfg.hd
    area = S * kv_len * (0.5 if causal and S == kv_len else 1.0)
    if cfg.sliding_window and kv_len > cfg.sliding_window:
        area = S * cfg.sliding_window  # banded
    return 2.0 * B * H * hd * area * 2.0          # QK^T and P·V


def _proj_flops(cfg: ModelConfig, B: int, S: int) -> float:
    D, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd
    return 2.0 * B * S * D * (H * hd + 2 * KV * hd + H * hd)


def _mlp_flops(cfg: ModelConfig, B: int, S: int) -> float:
    D, F = cfg.d_model, cfg.d_ff
    mats = 3 if cfg.mlp_style == "swiglu" else 2
    return 2.0 * B * S * D * F * mats


def _moe_flops(cfg: ModelConfig, B: int, S: int) -> float:
    D, F = cfg.d_model, cfg.d_ff
    tokens = B * S * cfg.experts_per_token * cfg.moe_capacity_factor
    router = 2.0 * B * S * D * cfg.num_experts
    return router + 2.0 * tokens * D * F * 3


def _rwkv_layer_flops(cfg: ModelConfig, B: int, S: int) -> float:
    from repro_torch.models.rwkv6 import CHUNK
    D, F = cfg.d_model, cfg.d_ff
    proj = 2.0 * B * S * D * D * 5 + 2.0 * B * S * (D * 64 + 64 * D)
    Q = min(CHUNK, S)
    # chunked GLA: A=(Q,Q) scores + A@V + state read/write per chunk
    per_chunk = 2.0 * B * (D * Q * Q) * 2 + 2.0 * B * D * 64 * Q * 2
    wkv = per_chunk * (S // Q if S >= Q else 1)
    cmix = 2.0 * B * S * (D * F + F * D + D * D)
    out = 2.0 * B * S * D * D
    return proj + wkv + cmix + out


def _mamba_layer_flops(cfg: ModelConfig, B: int, S: int) -> float:
    from repro_torch.models.mamba2 import CHUNK, HEADDIM, ssm_dims
    d_inner, nh, N = ssm_dims(cfg)
    D = cfg.d_model
    proj = 2.0 * B * S * D * (2 * d_inner + 2 * N + nh)
    conv = 2.0 * B * S * (d_inner + 2 * N) * cfg.ssm_conv
    Q = min(CHUNK, S)
    nc = S // Q if S >= Q else 1
    per_chunk = (2.0 * B * Q * Q * N          # C·B
                 + 2.0 * B * Q * Q * nh * HEADDIM   # W @ x
                 + 2.0 * B * Q * nh * HEADDIM * N * 2)  # state read + inject
    out = 2.0 * B * S * d_inner * D
    return proj + conv + per_chunk * nc + out


def _logits_flops(cfg: ModelConfig, B: int, S: int) -> float:
    return 2.0 * B * S * cfg.d_model * cfg.vocab_size


def _embed_bytes(cfg: ModelConfig) -> float:
    mult = 1 if cfg.tie_embeddings else 2
    return cfg.vocab_size * cfg.d_model * mult * cfg.torch_dtype.itemsize


def forward_flops(cfg: ModelConfig, B: int, S: int, kv_len: int = 0,
                  causal: bool = True) -> float:
    """One forward pass over B sequences of S tokens (kv_len for decode)."""
    kv = kv_len or S
    L = cfg.num_layers
    total = _logits_flops(cfg, B, S)
    if cfg.attn_free:
        return total + L * _rwkv_layer_flops(cfg, B, S)
    if cfg.family == "hybrid":
        n_shared = L // cfg.attn_every if cfg.attn_every else 0
        total += L * _mamba_layer_flops(cfg, B, S)
        total += n_shared * (_proj_flops(cfg, B, S) +
                             _attn_flops(cfg, B, S, kv, causal) +
                             _mlp_flops(cfg, B, S))
        return total
    if cfg.is_encoder_decoder:
        Te = cfg.encoder_seq
        enc = cfg.encoder_layers * (_proj_flops(cfg, B, Te) +
                                    _attn_flops(cfg, B, Te, Te, False) +
                                    _mlp_flops(cfg, B, Te))
        dec = L * (_proj_flops(cfg, B, S) +
                   _attn_flops(cfg, B, S, kv, causal) +
                   _proj_flops(cfg, B, S) +            # cross proj (q + kv on Te)
                   _attn_flops(cfg, B, S, Te, False) +
                   _mlp_flops(cfg, B, S))
        return total + enc + dec
    mlp = _moe_flops(cfg, B, S) if cfg.is_moe else _mlp_flops(cfg, B, S)
    per_layer = _proj_flops(cfg, B, S) + \
        _attn_flops(cfg, B, S, kv, causal) + mlp
    return total + L * per_layer


def step_flops(cfg: ModelConfig, shape) -> float:
    """Whole-step FLOPs: train = fwd + 2×bwd (+remat refwd ≈ +1×fwd)."""
    B, S = shape.global_batch, shape.seq_len
    if cfg.frontend == "vision":
        pass  # prefix tokens included in S already
    if shape.kind == "train":
        S_eff = min(S, cfg.max_decoder_len) if cfg.is_encoder_decoder else S
        f = forward_flops(cfg, B, S_eff)
        return 4.0 * f       # fwd + 2×bwd + remat re-forward (remat is on)
    if shape.kind == "prefill":
        S_eff = min(S, cfg.max_decoder_len) if cfg.is_encoder_decoder else S
        return forward_flops(cfg, B, S_eff)
    # decode: 1 token, cache depth = S
    return forward_flops(cfg, B, 1, kv_len=S, causal=False)


def param_bytes(cfg: ModelConfig) -> float:
    return cfg.param_count() * cfg.torch_dtype.itemsize


def step_hbm_bytes(cfg: ModelConfig, shape) -> float:
    """Analytic HBM traffic for one step (global, all chips).

    train: params read (fwd+bwd+remat ≈ 3×) + grads written+read +
           opt m/v read+write (f32) + params written + activations
           (≈ c·tokens·D·L·itemsize with c≈12 r/w passes per layer).
    decode: params read once + cache read+write.
    """
    P = param_bytes(cfg)
    B, S = shape.global_batch, shape.seq_len
    D, L = cfg.d_model, max(cfg.num_layers, 1)
    it = cfg.torch_dtype.itemsize
    if shape.kind == "train":
        S_eff = min(S, cfg.max_decoder_len) if cfg.is_encoder_decoder else S
        opt = 4 * (cfg.param_count() * 4)      # m,v read+write f32
        grads = 2 * P
        act = 12.0 * B * S_eff * D * L * it
        return 3 * P + grads + opt + P + act
    if shape.kind == "prefill":
        S_eff = min(S, cfg.max_decoder_len) if cfg.is_encoder_decoder else S
        act = 8.0 * B * S_eff * D * L * it
        cache = 0.0
        if not cfg.attn_free and cfg.family != "hybrid":
            ck = min(S_eff, cfg.sliding_window or S_eff)
            cache = 2.0 * B * ck * cfg.num_kv_heads * cfg.hd * L * it
        return P + act + cache
    # decode: weights once + full cache read + state write
    cache = 0.0
    if cfg.attn_free:
        from repro_torch.models.rwkv6 import HEADDIM, rwkv_heads
        cache = 2.0 * B * rwkv_heads(cfg) * HEADDIM * HEADDIM * L * 4
    elif cfg.family == "hybrid":
        from repro_torch.models.mamba2 import HEADDIM, ssm_dims
        d_inner, nh, N = ssm_dims(cfg)
        cache = 2.0 * B * nh * HEADDIM * N * L * 4
        n_shared = L // cfg.attn_every if cfg.attn_every else 0
        ck = min(S, cfg.sliding_window or S)
        cache += 2.0 * B * ck * cfg.num_kv_heads * cfg.hd * n_shared * it
    else:
        ck = min(S, cfg.sliding_window or S)
        kvh = cfg.num_kv_heads
        Lk = cfg.num_layers
        cache = (1.0 + 1.0 / max(ck, 1)) * 2.0 * B * ck * kvh * cfg.hd * Lk * it
        if cfg.is_encoder_decoder:
            cache += 2.0 * B * cfg.encoder_seq * kvh * cfg.hd * Lk * it
    return P + cache + 2.0 * B * D * L * it


@dataclasses.dataclass(frozen=True)
class AnalyticCosts:
    flops: float
    hbm_bytes: float


def analytic_costs(cfg: ModelConfig, shape) -> AnalyticCosts:
    return AnalyticCosts(flops=step_flops(cfg, shape),
                         hbm_bytes=step_hbm_bytes(cfg, shape))
