"""AdamW + cosine schedule + global-norm clipping, ported from
``repro/optim/adamw.py``.

States mirror the params tree (nested dicts of tensors, walked in sorted
key order as ``jax.tree`` walks them), with float32 moments whatever the
params' dtype, and the reference's arithmetic: the grad cast to f32, the
moments updated in f32, bias-corrected by ``1 − β^step`` in f32, the
decay added to the update, ``p − lr·delta`` in f32 cast back to the
param dtype. ``torch.optim.AdamW`` would keep the moments in the param
dtype and order the decay differently.

:func:`apply_updates` updates the params and the moments in place (the
reference's train step donates both, ``donate_argnums=(0, 1)``) with at
most two float32 temporaries of a leaf alive at a time; ``lr``, the bias
corrections and the clip scale stay 0-d tensors on the params' device,
so a step never waits for the device.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple, Optional, Tuple

import torch

from repro_torch.models.layers import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    betas: Tuple[float, float] = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1


class OptState(NamedTuple):
    mu: Any               # first moment (tree like params), float32
    nu: Any               # second moment, float32
    step: torch.Tensor    # () int32 on the params' device


def init(params) -> OptState:
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
    device = tree_leaves(params)[0].device
    return OptState(mu=tree_map(zeros, params), nu=tree_map(zeros, params),
                    step=torch.zeros((), dtype=torch.int32, device=device))


def schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup → cosine decay to min_lr_ratio·lr (f32, on step's
    device)."""
    s = step.float()
    warm = s / max(cfg.warmup_steps, 1)
    frac = ((s - cfg.warmup_steps)
            / max(cfg.total_steps - cfg.warmup_steps, 1)).clamp(0, 1)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * frac))
    return cfg.lr * torch.where(s < cfg.warmup_steps, warm, cos)


def global_norm(tree, place=None, mesh=None) -> torch.Tensor:
    """√(Σ leaf²) over every leaf. With ``place`` (the leaves'
    placements) and a rank ``mesh`` the leaves are this rank's shards:
    each leaf's squares are summed over the ranks of the axes it is split
    over (one all-reduce an axis, of the (axis sets,) partial sums), a
    replicated leaf counted once; every rank gets the same norm."""
    leaves = tree_leaves(tree)
    if place is None or mesh is None or mesh.size == 1:
        return torch.sqrt(sum(l.float().square().sum() for l in leaves))
    from repro_torch import compat
    from repro_torch.models.layers import split_axes
    live = [a for a in mesh.axis_names if mesh.shape[a] > 1]
    sets: dict = {}
    for l, pl in zip(leaves, tree_leaves(place)):
        key = split_axes(pl, mesh)
        sq = l.float().square().sum()
        sets[key] = sets[key] + sq if key in sets else sq
    keys = list(sets)
    v = torch.stack([sets[k] for k in keys])
    for a in live:
        mask = [a in k for k in keys]
        if any(mask):
            on = torch.tensor(mask, device=v.device)
            v = torch.where(on, compat.psum(torch.where(on, v, 0.0),
                                            mesh.groups_of(a)), v)
    return torch.sqrt(v.sum())


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return (max_norm / norm.clamp(min=1e-9)).clamp(max=1.0)


def clip_by_global_norm(grads, max_norm: float, place=None, mesh=None):
    """→ (grads scaled to a global norm ≤ max_norm, the norm before). The
    scale is cast to each grad's dtype first, as the reference's. With
    ``place`` and a rank ``mesh``, the norm is over the shards
    (:func:`global_norm`)."""
    norm = global_norm(grads, place, mesh)
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda g: g * scale.to(g.dtype), grads), norm


@torch.no_grad()
def apply_updates(params, grads, state: OptState, cfg: OptConfig,
                  place=None, mesh=None) -> Tuple[Any, OptState, dict]:
    """One AdamW step → (params, state, {"lr", "grad_norm"}). The params
    and the moments are written in place (the returned trees hold the
    same tensors); ``grads`` are left as they are. With ``place`` and a
    rank ``mesh`` every tree holds this rank's shards: the clip's norm is
    the global one (:func:`global_norm`), the update elementwise on the
    shards, the step counter replicated."""
    gnorm = global_norm(grads, place, mesh)
    scale = _clip_scale(gnorm, cfg.clip_norm) \
        if cfg.clip_norm is not None else None
    step = state.step + 1
    lr = schedule(cfg, step)
    b1, b2 = cfg.betas
    bc1 = 1 - torch.pow(b1, step.float())
    bc2 = 1 - torch.pow(b2, step.float())

    for p, g, m, v in zip(*(tree_leaves(t) for t in
                            (params, grads, state.mu, state.nu))):
        if scale is not None:
            g = g * scale.to(g.dtype)
        gf = g.float()
        del g
        m.mul_(b1).add_(gf, alpha=1 - b1)
        v.mul_(b2).addcmul_(gf, gf, value=1 - b2)
        del gf
        denom = (v / bc2).sqrt_().add_(cfg.eps)
        delta = (m / bc1).div_(denom)
        del denom
        pf = p.float()           # p itself when p is f32
        delta.add_(pf, alpha=cfg.weight_decay).mul_(lr)
        pf.sub_(delta)
        del delta
        if pf is not p:
            p.copy_(pf)
    return params, OptState(mu=state.mu, nu=state.nu, step=step), \
        {"lr": lr, "grad_norm": gnorm}


def abstract_state(abstract_params) -> OptState:
    """The state of ``abstract_params`` (tensors of any device, ``meta``
    included) as ``meta`` tensors."""
    f32 = lambda p: torch.empty(p.shape, dtype=torch.float32, device="meta")
    return OptState(mu=tree_map(f32, abstract_params),
                    nu=tree_map(f32, abstract_params),
                    step=torch.empty((), dtype=torch.int32, device="meta"))
