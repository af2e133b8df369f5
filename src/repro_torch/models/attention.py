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

import functools
import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch import compat
from repro_torch.kernels import ops
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (PSpec, apply_rope, gather_data,
                                       local_like, model_shard,
                                       parallel_input, row_sum,
                                       sharded_matmul, split_dim)

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


@functools.lru_cache(maxsize=None)
def _root(hd: int, dtype: torch.dtype) -> float:
    """√hd rounded to ``dtype``, as a host number (a device constant would
    be a host→device copy a call)."""
    return torch.tensor(math.sqrt(hd), dtype=dtype).item()


def _keys_t(k: torch.Tensor) -> torch.Tensor:
    """k (B, Sk, KVr, hd) → (B·KVr, hd, Sk), contiguous: the right-hand
    side of :func:`_grouped_scores`, made once for every query block."""
    B, Sk, KVr, hd = k.shape
    return k.permute(0, 2, 3, 1).reshape(B * KVr, hd, Sk)


def _grouped_scores(q: torch.Tensor, kt: torch.Tensor) -> torch.Tensor:
    """q (B, Sq, H, hd), kt (B·KVr, hd, Sk) (:func:`_keys_t`) → scores
    (B, KVr, G, Sq, Sk) in the activation dtype, over √hd rounded to it
    (the reference's ``jnp.sqrt(hd).astype(q.dtype)``). One batched
    product over (B, KVr) of the group's G·Sq query rows, the layout
    ``einsum`` gives it (einsum itself costs ~10× the ops to trace in
    the dry run)."""
    B, Sq, H, hd = q.shape
    KVr, Sk = kt.shape[0] // B, kt.shape[2]
    G = H // KVr
    qg = q.reshape(B, Sq, KVr, G, hd).permute(0, 2, 3, 1, 4).reshape(
        B * KVr, G * Sq, hd)
    return torch.bmm(qg, kt).view(B, KVr, G, Sq, Sk) / _root(hd, q.dtype)


def _values_t(v: torch.Tensor) -> torch.Tensor:
    """v (B, Sk, KVr, hd) → (B·KVr, Sk, hd), contiguous: the right-hand
    side of :func:`_grouped_out`, made once for every query block."""
    B, Sk, KVr, hd = v.shape
    return v.permute(0, 2, 1, 3).reshape(B * KVr, Sk, hd)


def _grouped_out(probs: torch.Tensor, vt: torch.Tensor, H: int) -> torch.Tensor:
    """probs (B, KVr, G, Sq, Sk), vt (B·KVr, Sk, hd) (:func:`_values_t`)
    → (B, Sq, H, hd). The rows in (Sq, G) order, as ``einsum`` lays them
    out: v's gradient then sums them in its order (the (G, Sq) order
    moved a float32 training trajectory held to JAX's at 1e-5)."""
    B, KVr, G, Sq, Sk = probs.shape
    rows = probs.permute(0, 1, 3, 2, 4).reshape(B * KVr, Sq * G, Sk)
    out = torch.bmm(rows, vt)
    return out.view(B, KVr, Sq, G, -1).permute(0, 2, 1, 3, 4).reshape(
        B, Sq, KVr * G, out.shape[-1])


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
    out = _attend(q, k, v, cfg, positions, kv_pos, causal,
                  rope=self_attn)
    return out.reshape(B, S, H * hd) @ p["wo"].reshape(H * hd, -1)


def _attend(q, k, v, cfg: ModelConfig, positions, kv_pos, causal: bool,
            rope: bool = True) -> torch.Tensor:
    """RoPE (``rope`` and a rotary config), then the query-chunked masked
    softmax of :func:`attention`: q (B, S, H, hd), k and v (B, Sk, KVr,
    hd) → (B, S, H, hd)."""
    B, S, H, _ = q.shape
    if rope and cfg.rope_fraction > 0:
        q = apply_rope(q, positions, cfg.rope_fraction, cfg.rope_theta)
        k = apply_rope(k, kv_pos, cfg.rope_fraction, cfg.rope_theta)
    window = cfg.sliding_window
    kt, vt = _keys_t(k), _values_t(v)

    def block_attend(q_blk, qpos_blk):
        scores = _grouped_scores(q_blk, kt).float()
        mask = None
        if causal:
            mask = qpos_blk[:, :, None] >= kv_pos[:, None, :]
        if window is not None:
            near = qpos_blk[:, :, None] - kv_pos[:, None, :] < window
            mask = near if mask is None else mask & near
        if mask is not None:
            scores = torch.where(mask[:, None, None], scores, _NEG_INF)
        probs = torch.softmax(scores, dim=-1).to(q.dtype)
        return _grouped_out(probs, vt, H)

    if S > _Q_CHUNK and S % _Q_CHUNK == 0:
        return torch.cat([block_attend(q[:, c:c + _Q_CHUNK],
                                       positions[:, c:c + _Q_CHUNK])
                          for c in range(0, S, _Q_CHUNK)], dim=1)
    return block_attend(q, positions)


def heads_split(place) -> bool:
    """Whether an attention's query heads are split over model."""
    return place["wq"][1:2] == ("model",)


def _kv_block(w: torch.Tensor, place: tuple, kv_repeat: int, dim: int,
              mesh) -> torch.Tensor:
    """A K or V projection (or bias) of every KV head (``kv_heads`` are
    replicated), its data dim gathered, its heads (dim ``dim``) repeated
    r× and cut to this rank's block of the KV·r."""
    if split_dim(place, "model", mesh) is not None:
        raise NotImplementedError(
            f"KV projections placed over model ({place}): the rules "
            "replicate kv_heads and repeat them instead")
    w = gather_data(w, place, mesh)
    if kv_repeat > 1:
        w = torch.repeat_interleave(w, kv_repeat, dim=dim)
    if w.shape[dim] % mesh.shape["model"]:
        raise NotImplementedError(
            f"{w.shape[dim]} KV heads (repeated {kv_repeat}×) do not split "
            f"over {mesh.shape['model']} model ranks beside split query "
            "heads")
    return model_shard(w, dim, mesh)


def attention_sharded(p, place, x: torch.Tensor, cfg: ModelConfig, *,
                      positions: torch.Tensor, kv_repeat: int, mesh,
                      seq_split: bool = False) -> torch.Tensor:
    """:func:`attention` (causal self-attention) on a rank's shards: with
    the query heads split over model each rank attends with its heads
    over its block of the KV·r heads (the K and V projections of every
    KV head repeated r× and cut, as ``kv_repeat_for`` makes them divide)
    and the output projection's partial products are summed over the
    model group; heads that the fallback replicated attend whole on
    every rank. x: (B, S, D), or with ``seq_split`` the rank's block of
    the sequence, gathered whole before the projections (the sum, or
    the replicated heads' output, then cut back to the block);
    positions: (B, S), the whole sequence's."""
    if not heads_split(place):
        if seq_split:
            x = compat.gather_shards(x, mesh.groups_of("model"), 1,
                                     partial=False)
        whole = {k: gather_data(w, place[k], mesh) for k, w in p.items()}
        y = attention(whole, x, cfg, positions=positions,
                      kv_repeat=kv_repeat)
        return model_shard(y, 1, mesh) if seq_split else y
    x = parallel_input(x, mesh, seq_split)
    B, S, _ = x.shape
    q, _ = sharded_matmul(x, p["wq"], place["wq"], mesh)
    k = _proj(x, _kv_block(p["wk"], place["wk"], kv_repeat, 1, mesh))
    v = _proj(x, _kv_block(p["wv"], place["wv"], kv_repeat, 1, mesh))
    if cfg.qkv_bias:
        q = q + local_like(p["bq"], place["bq"], mesh, 0)
        k = k + _kv_block(p["bk"], place["bk"], kv_repeat, 0, mesh)
        v = v + _kv_block(p["bv"], place["bv"], kv_repeat, 0, mesh)
    if q.shape[2] % k.shape[2]:
        raise NotImplementedError(
            f"this rank's {q.shape[2]} query heads do not group over its "
            f"{k.shape[2]} KV heads")
    out = _attend(q, k, v, cfg, positions, positions, True)
    y, _ = sharded_matmul(out, p["wo"], place["wo"], mesh, nk=2,
                          x_split=True, reduce=row_sum(mesh, seq_split))
    return y


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


def _project_qkv_sharded(p, place, x, cfg: ModelConfig, kv_repeat: int,
                         mesh, cache_heads: int):
    """The decode step's projections on a rank's shards (see
    :mod:`repro_torch.models.layers`' mesh section): q over this rank's
    query heads (all of them where the fallback replicated the heads),
    K and V for every KV head (``kv_heads`` → replicated), repeated r×
    and cut to the rank's ``cache_heads`` of the KV·r. → (q, k, v, q
    split over model)."""
    q, qs = sharded_matmul(x, p["wq"], place["wq"], mesh)
    k, ks = sharded_matmul(x, p["wk"], place["wk"], mesh)
    v, vs = sharded_matmul(x, p["wv"], place["wv"], mesh)
    if ks is not None or vs is not None:
        raise NotImplementedError(
            f"KV projections placed over model ({place['wk']}): the rules "
            "replicate kv_heads and repeat them for the cache instead")
    if cfg.qkv_bias:
        q = q + local_like(p["bq"], place["bq"], mesh, qs)
        k = k + local_like(p["bk"], place["bk"], mesh, None)
        v = v + local_like(p["bv"], place["bv"], mesh, None)
    if kv_repeat > 1:
        k = torch.repeat_interleave(k, kv_repeat, dim=2)
        v = torch.repeat_interleave(v, kv_repeat, dim=2)
    kv_split = cache_heads != k.shape[2]
    if kv_split:
        if cache_heads * mesh.shape["model"] != k.shape[2]:
            raise ValueError(f"a cache of {cache_heads} heads is no model "
                             f"block of {k.shape[2]}")
        k, v = model_shard(k, 2, mesh), model_shard(v, 2, mesh)
    q_split = qs == 0
    if q_split != kv_split or q.shape[2] % cache_heads:
        raise NotImplementedError(
            f"this rank's {q.shape[2]} query heads do not map onto its "
            f"{cache_heads} cache heads (query heads "
            f"{'split' if q_split else 'whole'}, cache "
            f"{'split' if kv_split else 'whole'} over model); the cache "
            "is not gathered")
    return q, k, v, q_split


def attention_decode_step(p, x: torch.Tensor, cache: LayerKVCache,
                          pos: torch.Tensor, cfg: ModelConfig,
                          kv_repeat: int = 1,
                          use_kernel: bool = False, mesh=None,
                          place=None) -> Tuple[torch.Tensor, LayerKVCache]:
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

    On a rank ``mesh`` (``p`` the rank's shards, ``place`` their
    placements, x and the cache the rank's batch rows): the rank attends
    with its query heads over its cache heads (the KV·r heads split over
    model, or all of them), and the output projection's partial products
    over its heads are summed over the model group.
    """
    B = x.shape[0]
    hd = cfg.hd
    if mesh is None:
        q, k, v = _project_qkv(p, x, x, cfg, kv_repeat)  # (B,1,·,hd)
        q_split = False
    else:
        q, k, v, q_split = _project_qkv_sharded(p, place, x, cfg, kv_repeat,
                                                mesh, cache.k.shape[1])
    H = q.shape[2]
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
    if mesh is None:
        y = out.reshape(B, 1, H * hd) @ p["wo"].reshape(H * hd, -1)
    else:
        y, _ = sharded_matmul(out, p["wo"], place["wo"], mesh, nk=2,
                              x_split=q_split)
    return y, cache
