"""Mamba-2 SSD block (Dao & Gu 2024), ported from
``repro/models/mamba2.py``.

State-space recurrence per head (scalar decay a_t = exp(-Δt·A)):

    h_t = a_t · h_{t-1} + Δt · x_t ⊗ B_t          h ∈ (P, N)
    y_t = h_t · C_t + D_skip · x_t

The forward uses the reference's chunked SSD form: the sequence is cut
into chunks of ``CHUNK``; within a chunk the recurrence is a masked
(Q, Q) product, across chunks a Python loop carries the (P, N) state.
The chunk math is float32, as the reference's. Under autograd each
chunk is checkpointed (the reference's ``jax.checkpoint`` of its scan
body): the backward recomputes the chunk's (B, Q, Q, nh) transients
instead of keeping them for every chunk. Without grad nothing is
checkpointed.

Decode is the O(1) single-step recurrence. The reference has no Pallas
kernel for either: this is plain PyTorch, rounded where the reference
rounds.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import PSpec, chunk_step, silu, softplus

CHUNK = 128
HEADDIM = 64   # P


def ssm_dims(cfg: ModelConfig) -> Tuple[int, int, int]:
    """(d_inner, num_heads, d_state)."""
    d_inner = 2 * cfg.d_model
    return d_inner, d_inner // HEADDIM, cfg.ssm_state


def mamba2_template(cfg: ModelConfig) -> Dict[str, PSpec]:
    D = cfg.d_model
    d_inner, nh, N = ssm_dims(cfg)
    return {
        # projections: z (gate), x, B, C, dt
        "w_in": PSpec((D, 2 * d_inner + 2 * N + nh), ("embed", "ffn")),
        "conv": PSpec((cfg.ssm_conv, d_inner + 2 * N), (None, "ffn"), "normal"),
        "a_log": PSpec((nh,), (None,), "zeros"),       # A = -exp(a_log)
        "d_skip": PSpec((nh,), (None,), "ones"),
        "dt_bias": PSpec((nh,), (None,), "zeros"),
        "norm_scale": PSpec((d_inner,), ("ffn",), "ones"),
        "w_out": PSpec((d_inner, D), ("ffn", "embed")),
    }


def _split_proj(p, u: torch.Tensor, cfg: ModelConfig):
    """u @ w_in split into z (d_inner), xBC (d_inner + 2N) and dt (nh):
    the reference's ``jnp.split`` at indices [d_inner, 2·d_inner + 2N]."""
    d_inner, nh, N = ssm_dims(cfg)
    zxbcdt = u @ p["w_in"]
    return torch.split(zxbcdt, [d_inner, d_inner + 2 * N, nh], dim=-1)


def _split_xbc(xBC: torch.Tensor, cfg: ModelConfig):
    """xBC → x (d_inner), B (N), C (N)."""
    d_inner, _, N = ssm_dims(cfg)
    return torch.split(xBC, [d_inner, N, N], dim=-1)


def _causal_conv(xBC: torch.Tensor, conv_w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over time, then SiLU. xBC: (B, T, Cdim).
    The K taps are summed in the reference's order, each product and sum
    rounded to xBC's dtype."""
    K = conv_w.shape[0]
    T = xBC.shape[1]
    pad = torch.nn.functional.pad(xBC, (0, 0, K - 1, 0))
    out = pad[:, 0:T, :] * conv_w[0]
    for i in range(1, K):
        out = out + pad[:, i:i + T, :] * conv_w[i]
    return silu(out)


def _gated_rmsnorm(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
                   eps: float = 1e-5) -> torch.Tensor:
    y = y * silu(z)
    yf = y.float()
    var = yf.square().mean(-1, keepdim=True)
    return (yf * torch.rsqrt(var + eps) * scale).to(y.dtype)


class Mamba2State(NamedTuple):
    h: torch.Tensor          # (B, nh, P, N) SSM state, float32
    conv_buf: torch.Tensor   # (B, K-1, d_inner + 2N) causal-conv tail


def init_mamba2_state(cfg: ModelConfig, batch: int, dtype: torch.dtype,
                      device=None) -> Mamba2State:
    d_inner, nh, N = ssm_dims(cfg)
    return Mamba2State(
        h=torch.zeros((batch, nh, HEADDIM, N), dtype=torch.float32,
                      device=device),
        conv_buf=torch.zeros((batch, cfg.ssm_conv - 1, d_inner + 2 * N),
                             dtype=dtype, device=device))


def _chunk(h, xc, Bt, Ct, dtc, lac, tril):
    """One chunk of the SSD scan, float32. h (B, nh, P, N); xc (B, Q,
    nh, P); Bt, Ct (B, Q, N); dtc, lac (B, Q, nh) → (h', y (B, Q, nh,
    P))."""
    cum = lac.cumsum(1)                                   # (B,Q,nh) ≤ 0, ↓
    # intra: y_t = Σ_{s≤t} (C_t·B_s)·exp(cum_t−cum_s)·Δt_s·x_s
    decay = cum[:, :, None, :] - cum[:, None, :, :]       # (B,t,s,nh)
    # masked BEFORE exp: above the diagonal the decay is positive and
    # would overflow to inf, and the backward would turn 0·inf into NaN
    decay = torch.where(tril[None, :, :, None], decay, -1e9)
    M = torch.exp(decay)
    CB = torch.einsum("btn,bsn->bts", Ct, Bt)
    W = CB[..., None] * M * dtc[:, None, :, :]            # (B,t,s,nh)
    y_intra = torch.einsum("btsh,bshp->bthp", W, xc)
    # inter: read the carried state
    y_inter = torch.einsum("bhpn,btn->bthp", h, Ct) * torch.exp(cum)[..., None]
    # h' = exp(cum_Q)·h + Σ_s exp(cum_Q−cum_s)·Δt_s·x_s⊗B_s
    wS = torch.exp(cum[:, -1:, :] - cum) * dtc            # (B,Q,nh)
    inj = torch.einsum("bshp,bsn->bhpn", xc * wS[..., None], Bt)
    h_new = torch.exp(cum[:, -1, :])[:, :, None, None] * h + inj
    return h_new, y_intra + y_inter


def apply_mamba2(p, u: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Training/prefill. u: (B, T, D) → (B, T, D). Chunks of CHUNK when
    T is a multiple of it larger than it, else one chunk of T (the
    reference's rule)."""
    B, T, D = u.shape
    d_inner, nh, N = ssm_dims(cfg)
    z, xBC, dt = _split_proj(p, u, cfg)
    xBC = _causal_conv(xBC, p["conv"])
    x, Bc, Cc = _split_xbc(xBC, cfg)
    x = x.reshape(B, T, nh, HEADDIM)

    dt = softplus(dt.float() + p["dt_bias"])                      # (B,T,nh)
    A = -torch.exp(p["a_log"].float())                            # (nh,)
    loga = dt * A[None, None, :]                                  # ≤ 0

    Q = CHUNK if (T % CHUNK == 0 and T > CHUNK) else T
    tril = torch.ones((Q, Q), dtype=torch.bool, device=u.device).tril()
    xf, Bf, Cf = x.float(), Bc.float(), Cc.float()
    h = torch.zeros((B, nh, HEADDIM, N), dtype=torch.float32, device=u.device)
    ys = []
    for c0 in range(0, T, Q):
        sl = slice(c0, c0 + Q)
        h, y = chunk_step(_chunk, h, xf[:, sl], Bf[:, sl], Cf[:, sl],
                          dt[:, sl], loga[:, sl], tril)
        ys.append(y)
    y = torch.cat(ys, 1)                                          # (B,T,nh,P)
    y = y + p["d_skip"].float()[None, None, :, None] * xf
    y = y.reshape(B, T, d_inner).to(u.dtype)
    y = _gated_rmsnorm(y, z, p["norm_scale"])
    return y @ p["w_out"]


def mamba2_decode_step(p, u: torch.Tensor, state: Mamba2State,
                       cfg: ModelConfig, out: Optional[Mamba2State] = None
                       ) -> Tuple[torch.Tensor, Mamba2State]:
    """u: (B, 1, D) → (y (B, 1, D), new state). O(1) a token. ``state``
    is left as it was: the new state is written into ``out`` (tensors of
    the state's shapes, e.g. a layer's slice of a stacked state) when
    given, else into new tensors."""
    B = u.shape[0]
    d_inner, nh, N = ssm_dims(cfg)
    if out is None:
        out = Mamba2State(torch.empty_like(state.h),
                          torch.empty_like(state.conv_buf))
    z, xBC, dt = _split_proj(p, u, cfg)                    # (B,1,·)
    # causal conv through the rolling buffer
    window = torch.cat([state.conv_buf, xBC], dim=1)       # (B,K,·)
    conv_out = silu(torch.einsum("bkc,kc->bc", window, p["conv"]))
    out.conv_buf.copy_(window[:, 1:, :])
    x, Bc, Cc = _split_xbc(conv_out, cfg)
    x = x.reshape(B, nh, HEADDIM).float()

    dt1 = softplus(dt[:, 0, :].float() + p["dt_bias"])
    A = -torch.exp(p["a_log"].float())
    a = torch.exp(dt1 * A[None, :])                        # (B,nh)
    # h' = a·h + Δt·x ⊗ B, written into out.h
    h = torch.mul(a[:, :, None, None], state.h, out=out.h)
    h.addcmul_((dt1[:, :, None] * x)[..., None],
               Bc.float()[:, None, None, :])
    y = torch.einsum("bhpn,bn->bhp", h, Cc.float()) + \
        p["d_skip"].float()[None, :, None] * x
    y = y.reshape(B, 1, d_inner).to(u.dtype)
    y = _gated_rmsnorm(y, z, p["norm_scale"])
    return y @ p["w_out"], out
