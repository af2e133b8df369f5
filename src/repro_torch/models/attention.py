"""GQA attention: full-sequence (prefill, forward, cross-attention),
query-chunked as the reference's, and single-token decode against a
(optionally sliding-window) KV cache.

``kv_repeat``: KV heads may be physically duplicated r× (the reference
does so when its tensor-parallel degree exceeds num_kv_heads); the
caches then hold KV·r heads.

The full-sequence ``attention`` has no Pallas kernel in the reference:
it is its chunked masked softmax in plain PyTorch, rounded where the
reference rounds.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import ops
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import PSpec, apply_rope

_NEG_INF = -1e30
_Q_CHUNK = 512


def attn_template(cfg: ModelConfig, d_in: Optional[int] = None) -> Dict[str, PSpec]:
    d = d_in or cfg.d_model
    hd, H, KV = cfg.hd, cfg.num_heads, cfg.num_kv_heads
    t = {
        "wq": PSpec((d, H, hd), ("embed", "heads", "head_dim"), "normal", d),
        "wk": PSpec((d, KV, hd), ("embed", "kv_heads", "head_dim"),
                    "normal", d),
        "wv": PSpec((d, KV, hd), ("embed", "kv_heads", "head_dim"),
                    "normal", d),
        "wo": PSpec((H, hd, d), ("heads", "head_dim", "embed"), "normal",
                    H * hd),
    }
    if cfg.qkv_bias:
        t["bq"] = PSpec((H, hd), ("heads", "head_dim"), "zeros")
        t["bk"] = PSpec((KV, hd), ("kv_heads", "head_dim"), "zeros")
        t["bv"] = PSpec((KV, hd), ("kv_heads", "head_dim"), "zeros")
    return t


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (B, S, d) · w (d, heads, hd) → (B, S, heads, hd) in x's dtype
    (the reference's ``preferred_element_type=x.dtype``)."""
    d, heads, hd = w.shape
    return (x @ w.reshape(d, heads * hd)).reshape(*x.shape[:-1], heads, hd)


def _project_qkv(p, x, kv_x, cfg: ModelConfig, kv_repeat: int):
    q = _proj(x, p["wq"])
    k = _proj(kv_x, p["wk"])
    v = _proj(kv_x, p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    if kv_repeat > 1:
        k = torch.repeat_interleave(k, kv_repeat, dim=2)
        v = torch.repeat_interleave(v, kv_repeat, dim=2)
    return q, k, v


def _grouped_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q (B, Sq, H, hd), k (B, Sk, KVr, hd) → scores (B, KVr, G, Sq, Sk)
    in the activation dtype, over √hd rounded to it (the reference's
    ``jnp.sqrt(hd).astype(q.dtype)``)."""
    B, Sq, H, hd = q.shape
    KVr = k.shape[2]
    qg = q.reshape(B, Sq, KVr, H // KVr, hd)
    root = torch.tensor(math.sqrt(hd), dtype=q.dtype, device=q.device)
    return torch.einsum("bskgh,btkh->bkgst", qg, k) / root


def _grouped_out(probs: torch.Tensor, v: torch.Tensor, H: int) -> torch.Tensor:
    """probs (B, KVr, G, Sq, Sk), v (B, Sk, KVr, hd) → (B, Sq, H, hd)."""
    B, KVr, G, Sq, Sk = probs.shape
    out = torch.einsum("bkgst,btkh->bskgh", probs, v)
    return out.reshape(B, Sq, KVr * G, out.shape[-1])


def attention(p, x: torch.Tensor, cfg: ModelConfig, *,
              positions: torch.Tensor, kv_repeat: int = 1,
              causal: bool = True, kv_x: Optional[torch.Tensor] = None,
              kv_positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full-sequence attention (forward / prefill / cross), as
    ``repro/models/attention.py:78-137``.

    x: (B, S, D); positions: (B, S) on x's device. ``kv_x`` switches to
    cross-attention over ``kv_positions`` (no RoPE). Queries go in
    blocks of 512 when S > 512 and S % 512 == 0, else as one block, so
    the f32 scores never exceed (B, heads, 512, Sk). The scores and
    their 1/√hd scale are in the activation dtype, then widened; masked
    scores are −1e30; the softmax is f32, cast back before the PV
    product.
    """
    B, S, _ = x.shape
    H, hd = cfg.num_heads, cfg.hd
    self_attn = kv_x is None
    kv_x = x if self_attn else kv_x
    kv_pos = positions if self_attn else kv_positions
    q, k, v = _project_qkv(p, x, kv_x, cfg, kv_repeat)
    if self_attn and cfg.rope_fraction > 0:
        q = apply_rope(q, positions, cfg.rope_fraction, cfg.rope_theta)
        k = apply_rope(k, kv_pos, cfg.rope_fraction, cfg.rope_theta)
    window = cfg.sliding_window

    def block_attend(q_blk, qpos_blk):
        scores = _grouped_scores(q_blk, k).float()
        mask = torch.ones((B, q_blk.shape[1], k.shape[1]), dtype=torch.bool,
                          device=x.device)
        if causal:
            mask &= qpos_blk[:, :, None] >= kv_pos[:, None, :]
        if window is not None:
            mask &= qpos_blk[:, :, None] - kv_pos[:, None, :] < window
        scores = torch.where(mask[:, None, None], scores, _NEG_INF)
        probs = torch.softmax(scores, dim=-1).to(x.dtype)
        return _grouped_out(probs, v, H)

    if S > _Q_CHUNK and S % _Q_CHUNK == 0:
        out = torch.cat([block_attend(q[:, c:c + _Q_CHUNK],
                                      positions[:, c:c + _Q_CHUNK])
                         for c in range(0, S, _Q_CHUNK)], dim=1)
    else:
        out = block_attend(q, positions)
    return out.reshape(B, S, H * hd) @ p["wo"].reshape(H * hd, -1)


class LayerKVCache(NamedTuple):
    k: torch.Tensor          # (B, KVr, S_cache, hd)
    v: torch.Tensor          # (B, KVr, S_cache, hd)


def init_layer_cache(cfg: ModelConfig, batch: int, seq_len: int,
                     kv_repeat: int, dtype: torch.dtype,
                     device=None) -> LayerKVCache:
    S = min(seq_len, cfg.sliding_window) if cfg.sliding_window else seq_len
    KVr = cfg.num_kv_heads * kv_repeat
    shape = (batch, KVr, S, cfg.hd)
    return LayerKVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                        v=torch.zeros(shape, dtype=dtype, device=device))


def cache_slot_positions(cfg: ModelConfig, cache_len: int,
                         pos: torch.Tensor) -> torch.Tensor:
    """Absolute position held by each ring-buffer slot at decode step ``pos``.

    Full cache: slot j holds position j (valid if j <= pos).
    Sliding window W: slot j holds the largest p ≤ pos with p % W == j.
    """
    slots = torch.arange(cache_len, device=pos.device)
    if not cfg.sliding_window:
        return slots
    W = cache_len
    cur = pos % W
    return torch.where(slots <= cur, pos - cur + slots,
                       pos - cur + slots - W)


def attention_decode_step(p, x: torch.Tensor, cache: LayerKVCache,
                          pos: torch.Tensor, cfg: ModelConfig,
                          kv_repeat: int = 1,
                          use_kernel: bool = False) -> Tuple[torch.Tensor,
                                                             LayerKVCache]:
    """x: (B, 1, D); pos: () int32 tensor on x's device, the current
    absolute position. → (y (B, 1, D), cache).

    The cache is written in place, at slot ``pos % S_cache`` through a
    device index (the reference returns an updated copy); the returned
    cache holds the same tensors. ``use_kernel`` routes the cache
    attention through :func:`repro_torch.kernels.ops.decode_attention`
    (the ``flash_decode`` kernel on the card), as the reference's
    ``use_pallas``; it needs a full (non-ring) cache, and a
    sliding-window config keeps the ring route. Nothing here waits for
    the device.
    """
    B = x.shape[0]
    H, hd = cfg.num_heads, cfg.hd
    q, k, v = _project_qkv(p, x, x, cfg, kv_repeat)      # (B,1,·,hd)
    posb = pos.expand(B)[:, None]                         # (B,1)
    if cfg.rope_fraction > 0:
        q = apply_rope(q, posb, cfg.rope_fraction, cfg.rope_theta)
        k = apply_rope(k, posb, cfg.rope_fraction, cfg.rope_theta)

    S_cache = cache.k.shape[2]
    slot = (pos % S_cache).reshape(1).long()
    cache.k.index_copy_(2, slot, k.transpose(1, 2))
    cache.v.index_copy_(2, slot, v.transpose(1, 2))

    if use_kernel and not cfg.sliding_window:
        out = ops.decode_attention(q[:, 0].contiguous(), cache.k, cache.v,
                                   (pos + 1).to(torch.int32))
        out = out.reshape(B, 1, H, hd)
    else:
        slot_pos = cache_slot_positions(cfg, S_cache, pos)    # (S_cache,)
        valid = (slot_pos >= 0) & (slot_pos <= pos)
        KVr = cache.k.shape[1]
        qg = q.reshape(B, KVr, H // KVr, hd)
        # the scores einsum rounds to the activation dtype, then widens
        scores = torch.einsum("bkgh,bkth->bkgt", qg, cache.k).float()
        scores = scores / math.sqrt(hd)
        scores = torch.where(valid, scores, _NEG_INF)
        probs = torch.softmax(scores, dim=-1).to(x.dtype)
        out = torch.einsum("bkgt,bkth->bkgh", probs, cache.v)
        out = out.reshape(B, 1, H, hd)
    y = out.reshape(B, 1, H * hd) @ p["wo"].reshape(H * hd, -1)
    return y, cache
