"""Common building blocks and the parameter-template machinery.

Parameters are nested dicts of tensors. Every leaf is declared once as a
``PSpec(shape, axes)`` whose ``axes`` are the reference's logical axis
names ("vocab", "embed", "ffn", "heads", "layers", ...); one template
gives the parameters' names, shapes and init. Layer stacks keep their
weights with a leading "layers" dim, as in the reference, and the model
walks them in a Python loop.

The losses (``chunked_lm_loss``, ``cross_entropy_loss``) are forward
only: nothing takes a gradient until LM training is ported (ROADMAP
Queue 1 item 13c).
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F


class PSpec(NamedTuple):
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]   # logical names, len == len(shape)
    init: str = "normal"              # 'normal' | 'zeros' | 'ones' | 'embed'
    fan_in: Optional[int] = None      # explicit fan-in when shape[-2] lies
                                      # (e.g. (D,H,hd) projections)


def tree_map(fn: Callable, tree: Any) -> Any:
    """``fn`` on every non-dict leaf of a nested dict, keys in sorted
    order (the order ``jax.tree`` flattens a dict in)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k]) for k in sorted(tree)}
    return fn(tree)


def template_init(tpl, gen: torch.Generator, dtype: torch.dtype) -> Any:
    """Template → parameters on ``gen``'s device (fan-in scaled normal
    init; ``embed`` rows 1/√d_model), drawn leaf by leaf in sorted key
    order from the one generator. A stacked leaf (leading "layers" axis)
    is drawn one layer's slice at a time, in float32, into the output:
    the transient is one slice, not two float32 copies of the whole leaf
    (llava-next-34b's ``w_gate`` is 8.8 G values). The reference's
    ``jax.random`` gives other numbers from the same seed: tests hand
    both packages the same arrays instead."""
    def init(p: PSpec) -> torch.Tensor:
        if p.init == "zeros":
            return torch.zeros(p.shape, dtype=dtype, device=gen.device)
        if p.init == "ones":
            return torch.ones(p.shape, dtype=dtype, device=gen.device)
        if p.init == "embed":
            # 1/√d_model rows (not fan-in = vocab): with the × √D of
            # embed_tokens the residual stream starts at unit rms.
            std = 1.0 / math.sqrt(max(p.shape[-1], 1))
        else:
            fan_in = p.fan_in or (p.shape[-2] if len(p.shape) >= 2
                                  else p.shape[-1])
            std = 1.0 / math.sqrt(max(fan_in, 1))
        out = torch.empty(p.shape, dtype=dtype, device=gen.device)
        slices = out if p.axes[:1] == ("layers",) else out[None]
        for part in slices:
            part.copy_(torch.randn(part.shape, generator=gen,
                                   device=gen.device).mul_(std))
        return out
    return tree_map(init, tpl)


# ---------------------------------------------------------------------------
# Norms (f32 inside, cast back to the activation dtype as the reference)
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, unbiased=False)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * scale + bias).to(x.dtype)


def apply_norm(x, p, style: str, eps: float):
    if style == "rmsnorm":
        return rmsnorm(x, p["scale"], eps)
    return layernorm(x, p["scale"], p["bias"], eps)


def norm_template(d: int, style: str) -> Dict[str, PSpec]:
    t = {"scale": PSpec((d,), ("embed",), "ones")}
    if style == "layernorm":
        t["bias"] = PSpec((d,), ("embed",), "zeros")
    return t


# ---------------------------------------------------------------------------
# RoPE (standard + partial/2d fraction à la chatglm3)
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, fraction: float, theta: float,
                     device=None):
    rot = int(head_dim * fraction) // 2 * 2
    exps = torch.arange(0, rot, 2, dtype=torch.float32, device=device) / rot
    return 1.0 / (theta ** exps), rot


def apply_rope(x: torch.Tensor, positions: torch.Tensor, fraction: float,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S), on
    x's device (a device tensor: no host round trip)."""
    hd = x.shape[-1]
    inv, rot = rope_frequencies(hd, fraction, theta, x.device)
    if rot == 0:
        return x
    ang = positions[..., :, None, None].float() * inv     # (...,S,1,rot/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    xr = x[..., :rot].float()
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    r1 = x1 * cos - x2 * sin
    r2 = x1 * sin + x2 * cos
    rotated = torch.stack([r1, r2], dim=-1).reshape(xr.shape)
    return torch.cat([rotated.to(x.dtype), x[..., rot:]], dim=-1)


# ---------------------------------------------------------------------------
# MLPs (torch.matmul: the reference leaves these to XLA, outside Pallas)
# ---------------------------------------------------------------------------

def mlp_template(d: int, f: int, style: str) -> Dict[str, PSpec]:
    if style == "swiglu":
        return {"w_gate": PSpec((d, f), ("embed", "ffn")),
                "w_up": PSpec((d, f), ("embed", "ffn")),
                "w_down": PSpec((f, d), ("ffn", "embed"))}
    return {"w_in": PSpec((d, f), ("embed", "ffn")),
            "b_in": PSpec((f,), ("ffn",), "zeros"),
            "w_out": PSpec((f, d), ("ffn", "embed")),
            "b_out": PSpec((d,), ("embed",), "zeros")}


def apply_mlp(x: torch.Tensor, p, style: str) -> torch.Tensor:
    if style == "swiglu":
        g = F.silu(x @ p["w_gate"])
        return (g * (x @ p["w_up"])) @ p["w_down"]
    # jax.nn.gelu defaults to the tanh approximation
    h = F.gelu(x @ p["w_in"] + p["b_in"], approximate="tanh")
    return h @ p["w_out"] + p["b_out"]


# ---------------------------------------------------------------------------
# Embedding / LM head
# ---------------------------------------------------------------------------

def embed_template(vocab: int, d: int, tie: bool) -> Dict[str, PSpec]:
    t = {"embedding": PSpec((vocab, d), ("vocab", "embed"), "embed")}
    if not tie:
        t["lm_head"] = PSpec((d, vocab), ("embed", "vocab"))
    return t


def embed_tokens(p, tokens: torch.Tensor) -> torch.Tensor:
    """Lookup × √D (T5/Gemma convention), as the reference. √D is first
    rounded to the table's dtype, as JAX's weakly typed scalar is."""
    E = p["embedding"]
    root = torch.tensor(math.sqrt(E.shape[-1]), dtype=E.dtype).item()
    return E[tokens] * root


def lm_logits(p, x: torch.Tensor, tie: bool) -> torch.Tensor:
    if tie:
        return x @ p["embedding"].T
    return x @ p["lm_head"]


# ---------------------------------------------------------------------------
# LM losses (forward only; f32 reductions as the reference)
# ---------------------------------------------------------------------------

def chunked_lm_loss(embed_params, h: torch.Tensor, labels: torch.Tensor,
                    tie: bool, mask: Optional[torch.Tensor] = None,
                    chunk: int = 8192) -> torch.Tensor:
    """Mean next-token CE over h (B, S, D) with labels (B, S), computed
    in token-major chunks of ``chunk`` rows so that only (chunk, V) f32
    logits exist at a time, as ``repro/models/layers.py:178``. The last
    chunk is padded with rows of mask 0; the mean is over
    max(Σ mask, 1)."""
    B, S, D = h.shape
    T = B * S
    if T <= chunk:
        return cross_entropy_loss(lm_logits(embed_params, h, tie), labels,
                                  mask)
    pad = (-T) % chunk
    hf = F.pad(h.reshape(T, D), (0, 0, 0, pad))
    lf = F.pad(labels.reshape(T), (0, pad))
    mf = F.pad(torch.ones((T,), dtype=torch.float32, device=h.device)
               if mask is None else mask.reshape(T).float(), (0, pad))
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for c0 in range(0, T + pad, chunk):
        sl = slice(c0, c0 + chunk)
        logits = lm_logits(embed_params, hf[sl], tie).float()
        lse = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, lf[sl, None].long())[:, 0]
        tot = tot + ((lse - gold) * mf[sl]).sum()
        cnt = cnt + mf[sl].sum()
    return tot / cnt.clamp(min=1.0)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean next-token CE in f32 (logits (B, S, V), labels (B, S)); with
    a mask, Σ nll·mask / max(Σ mask, 1)."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    gold = lf.gather(-1, labels[..., None].long())[..., 0]
    nll = lse - gold
    if mask is not None:
        m = mask.float()
        return (nll * m).sum() / m.sum().clamp(min=1.0)
    return nll.mean()
