"""Common building blocks and the parameter-template machinery.

Parameters are nested dicts of tensors. Every leaf is declared once as a
``PSpec(shape, axes)`` whose ``axes`` are the reference's logical axis
names ("vocab", "embed", "ffn", "heads", "layers", ...); one template
gives the parameters' names, shapes and init. Layer stacks keep their
weights with a leading "layers" dim, as in the reference, and the model
walks them in a Python loop.

The losses (``chunked_lm_loss``, ``cross_entropy_loss``) are
differentiable: the train step takes their gradients with autograd.
"""
from __future__ import annotations

import math
from typing import (Any, Callable, Dict, NamedTuple, Optional, Sequence,
                    Tuple)

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import compat


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


def tree_leaves(tree: Any) -> list:
    """The non-dict leaves of a nested dict in :func:`tree_map`'s order."""
    out: list = []
    tree_map(out.append, tree)
    return out


def tree_unflatten(like: Any, leaves) -> Any:
    """``leaves`` (in :func:`tree_leaves` order) in the structure of
    ``like``."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def template_init(tpl, gen: torch.Generator, dtype: torch.dtype,
                  placements=None, mesh=None) -> Any:
    """Template → parameters on ``gen``'s device (fan-in scaled normal
    init; ``embed`` rows 1/√d_model), drawn leaf by leaf in sorted key
    order from the one generator. A stacked leaf (leading "layers" axis)
    is drawn one layer's slice at a time, in float32, into the output:
    the transient is one slice, not two float32 copies of the whole leaf
    (llava-next-34b's ``w_gate`` is 8.8 G values). The reference's
    ``jax.random`` gives other numbers from the same seed: tests hand
    both packages the same arrays instead.

    With ``placements`` (the template's tree of them) and a rank
    ``mesh``, each leaf is this rank's shard: every slice is drawn whole,
    as above, and only the rank's part of it kept, so that every rank
    holds the slices of the same weights as one process, with a
    transient of one slice's float32 draw."""
    def init(p: PSpec, place: tuple = ()) -> torch.Tensor:
        shape = local_shape(p.shape, place, mesh) if place else p.shape
        if p.init == "zeros":
            return torch.zeros(shape, dtype=dtype, device=gen.device)
        if p.init == "ones":
            return torch.ones(shape, dtype=dtype, device=gen.device)
        if p.init == "embed":
            # 1/√d_model rows (not fan-in = vocab): with the × √D of
            # embed_tokens the residual stream starts at unit rms.
            std = 1.0 / math.sqrt(max(p.shape[-1], 1))
        else:
            fan_in = p.fan_in or (p.shape[-2] if len(p.shape) >= 2
                                  else p.shape[-1])
            std = 1.0 / math.sqrt(max(fan_in, 1))
        out = torch.empty(shape, dtype=dtype, device=gen.device)
        stacked = p.axes[:1] == ("layers",)
        slices = out if stacked else out[None]
        part_place = place[1:] if stacked else place
        part_shape = p.shape[1:] if stacked else p.shape
        for part in slices:
            draw = torch.randn(part_shape, generator=gen,
                               device=gen.device).mul_(std)
            part.copy_(local_shard(draw, part_place, mesh) if part_place
                       else draw)
        return out
    if placements is None:
        return tree_map(init, tpl)
    return tree_map2(init, tpl, placements)


def tree_map2(fn: Callable, tree: Any, other: Any) -> Any:
    """``fn(leaf, other_leaf)`` over two nested dicts of one structure,
    in :func:`tree_map`'s order."""
    if isinstance(tree, dict):
        return {k: tree_map2(fn, tree[k], other[k]) for k in sorted(tree)}
    return fn(tree, other)


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


def chunk_step(fn: Callable, *args):
    """``fn(*args)`` of one chunk of a scan; checkpointed (the
    reference's ``jax.checkpoint`` of its scan body) when autograd
    records it, so that the backward recomputes the chunk's transients
    instead of keeping them for every chunk."""
    if torch.is_grad_enabled() and any(
            isinstance(a, torch.Tensor) and a.requires_grad for a in args):
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


# ---------------------------------------------------------------------------
# Activations rounded as XLA rounds them
# ---------------------------------------------------------------------------

def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu`` as XLA computes it, x · 1/(1 + e^(−x)), each step
    rounded to x's dtype (``F.silu`` rounds once: 61 % of bf16 outputs
    equal)."""
    return x * (1 / (1 + torch.exp(-x)))


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu`` (the tanh approximation, its default) as XLA
    computes it on the CPU: x · ½(1 + tanh(√(2/π)(x + 0.044715 x³))),
    each constant and each step rounded to x's dtype. In bf16 it matched
    jitted JAX 0.9.0 on all of 2²⁰ N(0, 9) inputs (``F.gelu(x,
    approximate="tanh")`` rounds once: 57 % of bf16 outputs equal)."""
    def k(v):                     # a constant rounded to x's dtype
        return torch.tensor(v, dtype=torch.float32).to(x.dtype)
    inner = k(math.sqrt(2 / math.pi)) * (x + k(0.044715) * (x * x * x))
    return x * (k(0.5) * (k(1.0) + torch.tanh(inner)))


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``, log(1 + eˣ) as ``logaddexp(x, 0)``: no
    threshold past which it returns x (``F.softplus`` has one at 20)."""
    return x.clamp_min(0) + torch.log1p(torch.exp(-x.abs()))


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


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with one rounding of the float32 sums to a's dtype, as
    XLA's dot with ``preferred_element_type`` = the inputs' dtype: on
    the CPU the 2-byte products go through float32 (torch's bf16 CPU
    gemm rounded 0.3 % of an MLP's outputs otherwise), on the card
    cuBLAS accumulates in float32."""
    if a.is_cuda or a.dtype == torch.float32:
        return a @ b
    return (a.float() @ b.float()).to(a.dtype)


def mlp_activation(h: torch.Tensor, style: str) -> torch.Tensor:
    """The MLP's activation, silu ("swiglu") or the tanh gelu: in a
    2-byte dtype :func:`silu` / :func:`gelu`, each step rounded as XLA
    rounds ``jax.nn.silu`` / ``jax.nn.gelu``; in float32 ``F.silu`` /
    ``F.gelu(approximate="tanh")``, within an ulp of them, whose fused
    backward the float32 training checks against JAX were set with."""
    if h.element_size() >= 4:
        return F.silu(h) if style == "swiglu" \
            else F.gelu(h, approximate="tanh")
    return silu(h) if style == "swiglu" else gelu(h)


def apply_mlp(x: torch.Tensor, p, style: str) -> torch.Tensor:
    if style == "swiglu":
        g = mlp_activation(_mm(x, p["w_gate"]), style)
        return _mm(g * _mm(x, p["w_up"]), p["w_down"])
    h = mlp_activation(_mm(x, p["w_in"]) + p["b_in"], style)
    return _mm(h, p["w_out"]) + p["b_out"]


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
    rounded to the table's dtype, as JAX's weakly typed scalar is. The
    lookup is ``F.embedding``: its backward sums a token's rows in f32
    before one rounding to the table's dtype, where indexing's
    (``index_put_``) rounds a bf16 table after every row."""
    E = p["embedding"]
    root = torch.tensor(math.sqrt(E.shape[-1]), dtype=E.dtype).item()
    return F.embedding(tokens, E) * root


def lm_logits(p, x: torch.Tensor, tie: bool) -> torch.Tensor:
    if tie:
        return x @ p["embedding"].T
    return x @ p["lm_head"]


# ---------------------------------------------------------------------------
# The layers on a mesh of ranks (the sharded decode step)
# ---------------------------------------------------------------------------
#
# Each rank holds the shard of every leaf that its placement gives it: a
# tuple with a mesh-axis name (or a tuple of them, or None) a dim, which
# launch.sharding reckons and hands to the model. The collectives follow
# the placements: a dim split over "data" (FSDP) is gathered over the
# data group just before the layer uses the leaf, and freed after; a
# product that contracts a dim split over "model" sums its partial
# products over the model group (an all-reduce, in float32); a dim that
# the fallback replicated is contracted whole on every rank, no
# all-reduce. An axis of size 1 splits nothing.


def _axes(entry) -> tuple:
    return (entry,) if isinstance(entry, str) else tuple(entry or ())


def shard_count(entry, mesh) -> int:
    """Ranks a dim placed as ``entry`` is split over."""
    return math.prod(mesh.shape[a] for a in _axes(entry))


def local_shape(shape: Sequence[int], placement: tuple, mesh) -> tuple:
    """The shape of one rank's shard of a tensor of ``shape``."""
    out = list(shape)
    for dim, entry in enumerate(placement):
        n = shard_count(entry, mesh)
        if out[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(shape)} does not split "
                             f"over {n} ranks")
        out[dim] //= n
    return tuple(out)


def local_shard(t: torch.Tensor, placement: tuple, mesh) -> torch.Tensor:
    """The slice of the full tensor ``t`` that this rank of ``mesh`` holds
    under ``placement``: along each placed dim, block i of n, i this
    rank's index over the dim's axes (row-major, in the order named). A
    contiguous tensor of its own storage (``t`` itself when nothing is
    split)."""
    out = t
    for dim, entry in enumerate(placement):
        axes = _axes(entry)
        if not axes:
            continue
        n, i = 1, 0
        for a in axes:
            n, i = n * mesh.shape[a], i * mesh.shape[a] + mesh.index(a)
        if n > 1:
            size = t.shape[dim] // n
            out = out.narrow(dim, i * size, size)
    return t if out is t else out.clone(memory_format=torch.contiguous_format)


def split_dim(place: tuple, axis: str, mesh) -> Optional[int]:
    """The dim ``place`` splits over ``axis`` when it has more than one
    rank, else None."""
    if mesh is None or mesh.shape.get(axis, 1) == 1 or axis not in place:
        return None
    return place.index(axis)


def gather_data(w: torch.Tensor, place: tuple, mesh) -> torch.Tensor:
    """``w`` whole along the dim its placement splits over ``data``: the
    shards all-gathered over the data group, in rank order."""
    dim = split_dim(place, "data", mesh)
    if dim is None:
        return w
    parts = compat.all_gather_groups(w, mesh.groups_of("data"))
    return torch.cat(parts.unbind(0), dim=dim)


def model_sum(y: torch.Tensor, mesh) -> torch.Tensor:
    """The partial products ``y`` summed over the model group, in
    float32, rounded once to y's dtype."""
    return compat.psum(y.float(), mesh.groups_of("model")).to(y.dtype)


def model_shard(t: torch.Tensor, dim: int, mesh) -> torch.Tensor:
    """This rank's block of ``t`` along ``dim`` over the model ranks."""
    n = mesh.shape["model"]
    size = t.shape[dim] // n
    return t.narrow(dim, mesh.index("model") * size, size)


def sharded_matmul(x: torch.Tensor, w: torch.Tensor, place: tuple, mesh, *,
                   nk: int = 1, x_split: bool = False):
    """x (..., K₁, …, K_nk) · w (K₁, …, K_nk, N…) over w's first ``nk``
    dims, w a rank's shard placed as ``place``: its data dim gathered
    first. ``x_split``: x holds this rank's model block of K₁. Where x and
    w hold the same block of K₁ the partial products are summed over the
    model group; where one of them is whole, it is cut to the other's
    block first; where both are whole, no all-reduce. → (y (..., N…) in
    x's dtype, the dim of N… split over model or None)."""
    w = gather_data(w, place, mesh)
    mdim = split_dim(place, "model", mesh)
    if mdim is not None and 0 < mdim < nk:
        raise NotImplementedError(
            f"a contracted dim {mdim} placed over model ({place})")
    w_split = mdim == 0
    if x_split and not w_split:
        w = model_shard(w, 0, mesh)
    elif w_split and not x_split:
        x = model_shard(x, x.dim() - nk, mesh)
    lead = x.shape[:x.dim() - nk]
    K = math.prod(w.shape[:nk])
    y = (x.reshape(*lead, K) @ w.reshape(K, -1)).reshape(*lead,
                                                         *w.shape[nk:])
    if x_split or w_split:
        y = model_sum(y, mesh)
    return y, (mdim - nk if mdim is not None and mdim >= nk else None)


def local_like(t: torch.Tensor, place: tuple, mesh,
               want: Optional[int]) -> torch.Tensor:
    """A leaf (a bias) laid out as an activation whose dim ``want`` is
    split over model (None: whole): its data dim gathered, cut to this
    rank's block where the activation is split and the leaf is not."""
    t = gather_data(t, place, mesh)
    have = split_dim(place, "model", mesh)
    if have == want:
        return t
    if have is None:
        return model_shard(t, want, mesh)
    raise NotImplementedError(
        f"a leaf placed {place} beside an activation split on dim {want}")


def apply_norm_sharded(x, p, place, style: str, eps: float, mesh):
    """:func:`apply_norm` with the scale (and bias) gathered over data."""
    return apply_norm(x, {k: gather_data(v, place[k], mesh)
                          for k, v in p.items()}, style, eps)


def apply_mlp_sharded(x: torch.Tensor, p, place, style: str,
                      mesh) -> torch.Tensor:
    """:func:`apply_mlp` on a rank's shards: the ffn dim as the leaves
    place it (over model: each rank its block of the hidden units, the
    down product summed over the model group)."""
    if style == "swiglu":
        g, gs = sharded_matmul(x, p["w_gate"], place["w_gate"], mesh)
        u, us = sharded_matmul(x, p["w_up"], place["w_up"], mesh)
        if gs != us:
            raise NotImplementedError("w_gate and w_up placed apart")
        y, _ = sharded_matmul(mlp_activation(g, style) * u, p["w_down"],
                              place["w_down"], mesh, x_split=gs == 0)
        return y
    h, hs = sharded_matmul(x, p["w_in"], place["w_in"], mesh)
    h = mlp_activation(h + local_like(p["b_in"], place["b_in"], mesh, hs),
                       style)
    y, _ = sharded_matmul(h, p["w_out"], place["w_out"], mesh,
                          x_split=hs == 0)
    return y + local_like(p["b_out"], place["b_out"], mesh, None)


def embed_tokens_sharded(p, place, tokens: torch.Tensor,
                         mesh) -> torch.Tensor:
    """:func:`embed_tokens` on a rank's shard of the table: over a
    vocabulary split over model, each rank looks up the tokens in its
    block of rows (zeros for the others), and the rows are summed over
    the model group (one rank holds each token: the sum is exact)."""
    E = gather_data(p["embedding"], place["embedding"], mesh)
    vdim = split_dim(place["embedding"], "model", mesh)
    root = torch.tensor(math.sqrt(E.shape[-1]), dtype=E.dtype).item()
    if vdim is None:
        return F.embedding(tokens, E) * root
    if vdim != 0:
        raise NotImplementedError(
            f"an embedding placed {place['embedding']}")
    rows = E.shape[0]
    local = tokens - mesh.index("model") * rows
    inside = (local >= 0) & (local < rows)
    x = F.embedding(local.clamp(0, rows - 1), E) * root
    return model_sum(torch.where(inside[..., None], x, 0), mesh)


def lm_logits_sharded(p, place, x: torch.Tensor, tie: bool,
                      mesh) -> torch.Tensor:
    """:func:`lm_logits` on a rank's shard of the head: a vocabulary
    split over model gives each rank its block of the logits, gathered
    over the model group in rank order (the argmax then sees the whole
    vocabulary, ties to the first index)."""
    if tie:
        w = p["embedding"].transpose(0, 1)
        wp = tuple(reversed(place["embedding"]
                            + (None,) * (2 - len(place["embedding"]))))
    else:
        w, wp = p["lm_head"], place["lm_head"]
    logits, vs = sharded_matmul(x, w, wp, mesh)
    if vs is None:
        return logits
    parts = compat.all_gather_groups(logits, mesh.groups_of("model"))
    return torch.cat(parts.unbind(0), dim=-1)


# ---------------------------------------------------------------------------
# LM losses (f32 reductions as the reference)
# ---------------------------------------------------------------------------

def _chunk_nll(embed_params, hc: torch.Tensor, lc: torch.Tensor,
               mc: torch.Tensor, tie: bool) -> torch.Tensor:
    """Σ masked next-token CE of one chunk's rows, f32."""
    logits = lm_logits(embed_params, hc, tie).float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, lc[:, None].long())[:, 0]
    return ((lse - gold) * mc).sum()


def chunked_lm_loss(embed_params, h: torch.Tensor, labels: torch.Tensor,
                    tie: bool, mask: Optional[torch.Tensor] = None,
                    chunk: int = 8192) -> torch.Tensor:
    """Mean next-token CE over h (B, S, D) with labels (B, S), computed
    in token-major chunks of ``chunk`` rows so that only (chunk, V) f32
    logits exist at a time, as ``repro/models/layers.py:178``. Each chunk
    is checkpointed (the reference's ``jax.checkpoint``): the backward
    recomputes its logits instead of keeping every chunk's. The last
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
        tot = tot + checkpoint(_chunk_nll, embed_params, hf[sl], lf[sl],
                               mf[sl], tie, use_reentrant=False)
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
