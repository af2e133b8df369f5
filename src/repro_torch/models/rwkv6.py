"""RWKV-6 "Finch" block (arXiv:2404.05892): token shift and
data-dependent per-channel decay, ported from ``repro/models/rwkv6.py``.

Per head (k/v head dim 64), with data-dependent decay w_t ∈ (0,1)^hd:

    S_t = diag(w_t) · S_{t-1} + k_t v_tᵀ
    y_t = r_tᵀ (S_{t-1} + diag(u) k_t v_tᵀ)

The forward is the reference's chunked gated linear attention: within a
chunk of ``CHUNK`` the decay products become a masked (Q, Q) product in
float32, with each token's log-decay clamped to ≥ ``LOG_W_MIN``; across
chunks a Python loop carries the (hd, hd) state. Under autograd each
chunk is checkpointed, as the reference's. Decode is the O(1)
recurrence. The reference has no Pallas kernel for either: this is
plain PyTorch.

A quirk kept from the reference: a single chunk longer than about 73
tokens (T not a multiple of 32, so the whole sequence is one chunk)
overflows exp(−cum) in float32, and the output is NaN (T = 100); the
port computes the same function, NaN included.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import PSpec, chunk_step, silu

CHUNK = 32
HEADDIM = 64
LOG_W_MIN = -1.2   # per-token decay floor: w ≥ e^-1.2 ≈ 0.30; |Σ over chunk| ≤ 38.4


def rwkv_heads(cfg: ModelConfig) -> int:
    return cfg.d_model // HEADDIM


def rwkv6_template(cfg: ModelConfig) -> Dict[str, PSpec]:
    D, F = cfg.d_model, cfg.d_ff
    H = rwkv_heads(cfg)
    return {
        "time": {
            # token-shift interpolation weights (r,k,v,w,g)
            "mu": PSpec((5, D), (None, "embed"), "zeros"),
            "w_r": PSpec((D, D), ("embed", "heads_flat")),
            "w_k": PSpec((D, D), ("embed", "heads_flat")),
            "w_v": PSpec((D, D), ("embed", "heads_flat")),
            "w_g": PSpec((D, D), ("embed", "heads_flat")),
            # data-dependent decay (low-rank: D → 64 → D) + base
            "w_dec1": PSpec((D, 64), ("embed", None)),
            "w_dec2": PSpec((64, D), (None, "heads_flat")),
            "dec_base": PSpec((D,), ("heads_flat",), "zeros"),
            "u_bonus": PSpec((H, HEADDIM), (None, None), "zeros"),
            "w_o": PSpec((D, D), ("heads_flat", "embed")),
            "ln_scale": PSpec((D,), ("embed",), "ones"),   # per-head groupnorm
        },
        "channel": {
            "mu": PSpec((2, D), (None, "embed"), "zeros"),
            "w_k": PSpec((D, F), ("embed", "ffn")),
            "w_v": PSpec((F, D), ("ffn", "embed")),
            "w_r": PSpec((D, D), ("embed", "embed_out")),
        },
    }


def _token_shift(x: torch.Tensor, x_prev: torch.Tensor) -> torch.Tensor:
    """shift(x)[t] = x[t-1]; x_prev fills t=0. x: (B,T,D), x_prev: (B,1,D)."""
    return torch.cat([x_prev, x[:, :-1, :]], dim=1)


def _decay(tp, xw: torch.Tensor) -> torch.Tensor:
    """Data-dependent log-decay, clamped. → (B,T,D) float32, ≤ 0."""
    raw = tp["dec_base"] + torch.tanh(xw @ tp["w_dec1"]) @ tp["w_dec2"]
    # w = exp(-exp(raw)) ⇒ log w = -exp(raw); clamped for the chunk math
    return torch.clamp(-torch.exp(raw.float()), LOG_W_MIN, -1e-4)


def _mixes(mu: torch.Tensor, x: torch.Tensor, x_prev: torch.Tensor):
    """The token-shift interpolations x + (shift(x) − x)·σ(μ_i), one for
    each row of ``mu``."""
    xs = _token_shift(x, x_prev)
    return [x + (xs - x) * torch.sigmoid(m)[None, None, :] for m in mu]


def _project(tp, x, x_prev):
    xr, xk, xv, xw, xg = _mixes(tp["mu"], x, x_prev)
    r = xr @ tp["w_r"]
    k = xk @ tp["w_k"]
    v = xv @ tp["w_v"]
    logw = _decay(tp, xw)
    g = silu(xg @ tp["w_g"])
    return r, k, v, logw, g


def _group_norm(y: torch.Tensor, scale: torch.Tensor, H: int) -> torch.Tensor:
    """Per-head LayerNorm of the wkv output (RWKV's GroupNorm); the
    population variance, as ``jnp.var``."""
    B, T, D = y.shape
    yh = y.reshape(B, T, H, D // H).float()
    mu = yh.mean(-1, keepdim=True)
    var = yh.var(-1, keepdim=True, unbiased=False)
    yh = (yh - mu) * torch.rsqrt(var + 1e-5)
    return (yh.reshape(B, T, D) * scale).to(y.dtype)


class RWKVState(NamedTuple):
    S: torch.Tensor         # (B, H, hd, hd) wkv state (f32)
    x_prev_t: torch.Tensor  # (B, 1, D) last token for time-mix shift
    x_prev_c: torch.Tensor  # (B, 1, D) last token for channel-mix shift


def init_rwkv_state(cfg: ModelConfig, batch: int, dtype: torch.dtype,
                    device=None) -> RWKVState:
    H = rwkv_heads(cfg)
    return RWKVState(
        S=torch.zeros((batch, H, HEADDIM, HEADDIM), dtype=torch.float32,
                      device=device),
        x_prev_t=torch.zeros((batch, 1, cfg.d_model), dtype=dtype,
                             device=device),
        x_prev_c=torch.zeros((batch, 1, cfg.d_model), dtype=dtype,
                             device=device))


def _chunk(S, rc, kc, vc, lw, u, tril_strict):
    """One chunk of the wkv scan, float32. S (B, H, hd, hd); rc, kc, vc,
    lw (B, H, Q, hd) → (S', y (B, H, Q, hd))."""
    cum = lw.cumsum(2)                      # (B,H,Q,hd) ≤ 0, ↓ in t
    cum_prev = cum - lw                     # Σ_{u<t} log w
    # intra (s<t): A_ts = Σ_c r_tc·exp(cum_prev_t − cum_s)_c·k_sc
    q_ = rc * torch.exp(cum_prev)           # r ⊙ exp(cum_{t-1})
    k_ = kc * torch.exp(-cum)               # k ⊙ exp(−cum_s)
    A = q_ @ k_.transpose(-1, -2)
    A = torch.where(tril_strict, A, 0.0)
    # current-token bonus: (r_t ⊙ u ⊙ k_t)·v_t
    diag = (rc * u[None, :, None, :] * kc).sum(-1)
    y = A @ vc + diag[..., None] * vc
    # carried state read: y_t += (r_t ⊙ exp(cum_prev_t)) S
    y = y + q_ @ S
    # S' = diag(exp(cum_Q)) S + Σ_s diag(exp(cum_Q−cum_s)) k_s v_sᵀ
    wS = torch.exp(cum[:, :, -1:, :] - cum)
    S_new = torch.exp(cum[:, :, -1, :])[..., None] * S + \
        (kc * wS).transpose(-1, -2) @ vc
    return S_new, y


def _wkv_chunked(r, k, v, logw, u, H):
    """Chunked GLA. r,k,v: (B,T,D); logw: (B,T,D) ≤ 0; u: (H,hd) →
    (y (B,T,D) float32, the final state). Chunks of CHUNK when T is a
    multiple of it larger than it, else one chunk of T."""
    B, T, D = r.shape
    hd = HEADDIM
    Q = CHUNK if (T % CHUNK == 0 and T > CHUNK) else T

    def heads(x):  # (B,T,D) → (B,H,T,hd) f32
        return x.reshape(B, T, H, hd).transpose(1, 2).float()

    rq, kq, vq, lwq = heads(r), heads(k), heads(v), heads(logw)
    tril_strict = torch.ones((Q, Q), dtype=torch.bool,
                             device=r.device).tril(-1)
    S = torch.zeros((B, H, hd, hd), dtype=torch.float32, device=r.device)
    ys = []
    for c0 in range(0, T, Q):
        sl = slice(c0, c0 + Q)
        S, y = chunk_step(_chunk, S, rq[:, :, sl], kq[:, :, sl],
                          vq[:, :, sl], lwq[:, :, sl], u, tril_strict)
        ys.append(y)
    y = torch.cat(ys, 2).transpose(1, 2).reshape(B, T, D)
    return y, S


def apply_rwkv_time(tp, x: torch.Tensor, cfg: ModelConfig,
                    x_prev: torch.Tensor) -> torch.Tensor:
    """Time mix (the wkv stand-in for attention), training/prefill."""
    H = rwkv_heads(cfg)
    r, k, v, logw, g = _project(tp, x, x_prev)
    y, _ = _wkv_chunked(r, k, v, logw, tp["u_bonus"].float(), H)
    y = _group_norm(y.to(x.dtype), tp["ln_scale"], H)
    return (y * g) @ tp["w_o"]


def apply_rwkv_channel(cp, x: torch.Tensor,
                       x_prev: torch.Tensor) -> torch.Tensor:
    xk, xr = _mixes(cp["mu"], x, x_prev)
    k = torch.square(torch.relu(xk @ cp["w_k"]))
    return torch.sigmoid(xr @ cp["w_r"]) * (k @ cp["w_v"])


def rwkv_time_decode_step(tp, x: torch.Tensor, S: torch.Tensor,
                          x_prev: torch.Tensor, cfg: ModelConfig,
                          S_out: Optional[torch.Tensor] = None):
    """One-token time mix. x: (B,1,D); S: (B,H,hd,hd) → (y, S'). ``S``
    is left as it was: S' is written into ``S_out`` when given, else
    into a new tensor."""
    B, _, D = x.shape
    H = rwkv_heads(cfg)
    hd = HEADDIM
    r, k, v, logw, g = _project(tp, x, x_prev)
    rh = r.reshape(B, H, hd).float()
    kh = k.reshape(B, H, hd).float()
    vh = v.reshape(B, H, hd).float()
    w = torch.exp(logw.reshape(B, H, hd))
    u = tp["u_bonus"].float()
    # y = r·(S + u ⊙ k vᵀ), without the (hd, hd) sum: r·S + (r·(u ⊙ k)) v
    y = (rh[:, :, None, :] @ S)[:, :, 0] + \
        (rh * u[None] * kh).sum(-1, keepdim=True) * vh
    S_new = torch.mul(w[..., None], S,
                      out=torch.empty_like(S) if S_out is None else S_out)
    S_new.addcmul_(kh[..., :, None], vh[..., None, :])
    y = y.reshape(B, 1, D).to(x.dtype)
    y = _group_norm(y, tp["ln_scale"], H)
    return (y * g) @ tp["w_o"], S_new
