"""Mixture-of-Experts layer: top-k router and capacity-bounded sorted
dispatch into (experts, capacity, d) blocks, as ``repro/models/moe.py``.

    y, aux = apply_moe(p, x, cfg)                       # one rank
    y, aux = apply_moe_sharded(p_shard, x_shard, cfg, mesh)   # a rank grid

Dispatch is sort-based: the T·K (token, expert) assignments are sorted
stably by expert, the first C of each expert kept (C =
``capacity(T, cfg)``), and the expert MLPs run as batched matmuls over
the (E, C, D) blocks in the activation dtype (the reference's plain
``einsum``s, outside any Pallas kernel). Gates are renormalised over the
top-k; a dropped assignment adds nothing. ``aux`` is the Switch
load-balance loss.

Where the two libraries differ, the port does what the reference does:

* top-k is a stable descending sort: among equal probabilities the lower
  expert index comes first, as ``jax.lax.top_k`` (``torch.topk`` does
  not promise an order);
* the argsort of the assignments is stable (``jnp.argsort``'s default);
* the router logits are f32 sums of the products, as XLA computes the
  reference's ``(xf @ router).astype(f32)`` (it folds the cast into the
  dot), and silu rounds each of its steps in the activation dtype, as
  XLA computes ``jax.nn.silu``;
* the combine adds a token's K contributions one after another in the
  order of their sorted positions (ascending expert), the order XLA's
  scatter-add takes, by a gather and K sequential adds: no atomics, so
  the bf16 sums are the reference's bits and the same on every run;
* nothing waits for the device: each expert's first sorted position
  comes from ``searchsorted`` on the sorted keys (no ``bincount``,
  which reads the input's max on a card), the token of an assignment is
  its flat index // K, and C is a Python int of the shapes.

The dispatch gathers each slot's token (a slot holds at most one
assignment); the reference adds every assignment's row times its keep
flag into its slot, so that a dropped token's row, times 0, lands in
its expert's last slot. The two agree bit for bit on finite rows; a
dropped row holding NaN or ±Inf turns that slot's input NaN in the
reference and adds nothing here (ROADMAP Queue 3, NaN notes).

:func:`apply_moe_sharded` is the reference's ``shard_map`` version over a
(data × model) grid of ``torch.distributed`` ranks (:func:`moe_mesh`):
each rank holds its data shard of the tokens and its shard of the
weights as the reference's ``in_specs`` lay them out
(:func:`shard_moe_params`), gathers the weights over data (and, with
experts on the model axis, the router over model), dispatches locally
and sums ``y`` over model; ``aux`` is the mean over the data ranks of
each shard's loss.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch import compat
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import PSpec, local_shard, silu


def moe_template(cfg: ModelConfig) -> Dict[str, PSpec]:
    D, F_, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    return {
        "router": PSpec((D, E), ("embed", "experts")),
        "w_gate": PSpec((E, D, F_), ("experts", "embed", "ffn")),
        "w_up": PSpec((E, D, F_), ("experts", "embed", "ffn")),
        "w_down": PSpec((E, F_, D), ("experts", "ffn", "embed")),
    }


def capacity(tokens: int, cfg: ModelConfig,
             capacity_factor: Optional[float] = None) -> int:
    """Slots an expert has for ``tokens`` tokens: max(1, ⌊T·K·cf / E⌋),
    cf the config's unless given."""
    cf = cfg.moe_capacity_factor if capacity_factor is None \
        else capacity_factor
    return max(1, int(tokens * cfg.experts_per_token * cf / cfg.num_experts))


def route(xf: torch.Tensor, router: torch.Tensor, cfg: ModelConfig):
    """xf (T, D) → (probs (T, E) f32, gates (T, K) f32 renormalised over
    the top-k, expert_idx (T, K) int64 in descending probability, ties
    to the lower index). The logits are f32 sums of the products: XLA
    folds the reference's cast to f32 into its bf16 dot, so they are
    not rounded to bf16 first."""
    probs = torch.softmax(xf.float() @ router.float(), dim=-1)
    top = torch.sort(probs, dim=-1, descending=True, stable=True)
    K = cfg.experts_per_token
    gates, expert_idx = top.values[:, :K], top.indices[:, :K]
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    return probs, gates, expert_idx


def load_balance_loss(probs: torch.Tensor, expert_idx: torch.Tensor,
                      cfg: ModelConfig) -> torch.Tensor:
    """Switch eq. 4, E · Σ_e f_e · P_e times ``router_aux_coef``: f_e the
    share of the T·K assignments on expert e times K, P_e its mean
    router probability. () f32."""
    T, E = probs.shape
    K = expert_idx.shape[1]
    counts = torch.zeros(E, dtype=torch.float32, device=probs.device)
    counts.scatter_add_(0, expert_idx.reshape(-1),
                        torch.ones(T * K, dtype=torch.float32,
                                   device=probs.device))
    assign_frac = counts / (T * K) * K
    return cfg.router_aux_coef * E * (assign_frac * probs.mean(0)).sum()


class DispatchPlan(NamedTuple):
    """Where each of the T·K assignments goes, in sorted order (by local
    expert, stably): its token, its gate in the activation dtype, 1 if
    it holds a slot else 0, and its slot ``expert · C + position``
    (clamped to the expert's last slot when dropped); and for each of
    the e_count · C slots, the sorted position of the assignment it
    holds and whether it holds one."""
    order: torch.Tensor      # (T·K,) flat (token, k) index of each
    token: torch.Tensor
    gate: torch.Tensor
    keep: torch.Tensor
    dest: torch.Tensor
    slot_src: torch.Tensor   # (e_count · C,)
    slot_used: torch.Tensor


def dispatch_plan(gates: torch.Tensor, expert_idx: torch.Tensor, C: int,
                  e_base: int, e_count: int,
                  dtype: torch.dtype) -> DispatchPlan:
    """The plan of the experts ``e_base … e_base + e_count − 1``, C slots
    each; assignments to other experts sort after theirs and are
    dropped."""
    T, K = expert_idx.shape
    dev = expert_idx.device
    local = expert_idx.reshape(T * K) - e_base
    key = torch.where((local >= 0) & (local < e_count), local, e_count)
    e_sorted, order = torch.sort(key, stable=True)
    experts = torch.arange(e_count, device=dev)
    starts = torch.searchsorted(e_sorted, experts)
    ends = torch.searchsorted(e_sorted, experts, right=True)
    safe_e = e_sorted.clamp(max=e_count - 1)
    pos = torch.arange(T * K, device=dev) - starts[safe_e]
    keep = ((e_sorted < e_count) & (pos < C)).to(dtype)
    src = starts[:, None] + torch.arange(C, device=dev)
    return DispatchPlan(order, order // K,
                        gates.reshape(T * K).to(dtype)[order], keep,
                        safe_e * C + pos.clamp(0, C - 1),
                        src.clamp(max=T * K - 1).reshape(-1),
                        (src < ends[:, None]).reshape(-1))


def _experts(xf: torch.Tensor, plan: DispatchPlan, wg: torch.Tensor,
             wu: torch.Tensor, wd: torch.Tensor, C: int) -> torch.Tensor:
    """The experts of ``wg``, ``wu`` (e, D, F) and ``wd`` (e, F, D) on
    the tokens ``plan`` gives them, gate-weighted and summed into (T,
    D)."""
    T, D = xf.shape
    K = plan.order.shape[0] // T
    e_count = wg.shape[0]
    dt, dev = xf.dtype, xf.device
    xin = torch.where(plan.slot_used[:, None], xf[plan.token[plan.slot_src]],
                      0).reshape(e_count, C, D)
    h = silu(torch.bmm(xin, wg)) * torch.bmm(xin, wu)
    yout = torch.bmm(h, wd).reshape(e_count * C, D)
    # a token's K contributions, added in ascending sorted position
    sorted_pos = torch.empty_like(plan.order).scatter_(
        0, plan.order, torch.arange(T * K, device=dev))
    slots = sorted_pos.reshape(T, K).sort(dim=-1).values
    contrib = yout[plan.dest[slots]] \
        * (plan.keep * plan.gate)[slots][..., None]
    y = torch.zeros((T, D), dtype=dt, device=dev)
    for j in range(K):
        y = y + contrib[:, j]
    return y


def apply_moe(p, x: torch.Tensor, cfg: ModelConfig,
              capacity_factor: Optional[float] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) → (y (B, S, D) in x's dtype, aux () f32). Assignments
    past an expert's capacity are dropped (Switch); the capacity factor
    is the config's unless given."""
    B, S, D = x.shape
    T = B * S
    xf = x.reshape(T, D)
    probs, gates, expert_idx = route(xf, p["router"], cfg)
    aux = load_balance_loss(probs, expert_idx, cfg)
    C = capacity(T, cfg, capacity_factor)
    plan = dispatch_plan(gates, expert_idx, C, 0, cfg.num_experts, x.dtype)
    y = _experts(xf, plan, p["w_gate"], p["w_up"], p["w_down"], C)
    return y.reshape(B, S, D), aux


# ---------------------------------------------------------------------------
# Expert parallelism over a (data × model) grid of ranks
# ---------------------------------------------------------------------------

def moe_mesh(data: int, model: int) -> compat.Mesh:
    """The (data × model) grid over the default group's data · model
    ranks (``compat.rank_mesh``): rank r at data index r // model, model
    index r % model, as ``jax.make_mesh((data, model), ("data",
    "model"))`` lays out its devices. Every rank calls it, in the same
    order (it makes the subgroups)."""
    return compat.rank_mesh(("data", "model"), (data, model))


def expert_parallel(cfg: ModelConfig, model_size: int) -> bool:
    """Experts split over the model ranks (E % model == 0); otherwise
    every rank holds every expert and the FFN dim splits over model
    (tensor parallelism inside each expert)."""
    E = cfg.num_experts
    return E % model_size == 0 and E >= model_size


def sharded_param_specs(cfg: ModelConfig, model_size: int
                        ) -> Dict[str, Tuple[Optional[str], ...]]:
    """The mesh axis that splits each dim of each weight: the reference's
    ``in_specs`` (``repro/models/moe.py:133-140``)."""
    if expert_parallel(cfg, model_size):
        w = ("model", "data", None)
        return {"router": ("data", "model"), "w_gate": w, "w_up": w,
                "w_down": w}
    w = (None, "data", "model")
    return {"router": ("data", None), "w_gate": w, "w_up": w,
            "w_down": (None, "model", "data")}


def shard_moe_params(p, cfg: ModelConfig, mesh: compat.Mesh) -> dict:
    """This rank's shard (contiguous copies) of the full weights ``p``
    (any of its leaves), by :func:`sharded_param_specs`."""
    specs = sharded_param_specs(cfg, mesh.shape["model"])
    return {name: local_shard(t, specs[name], mesh).contiguous()
            for name, t in p.items()}


def shard_tokens(x: torch.Tensor, mesh: compat.Mesh) -> torch.Tensor:
    """This rank's data shard of x (B, S, D): the batch split over data."""
    return local_shard(x, ("data",), mesh)


def _gather(t: torch.Tensor, groups: compat.Groups, dim: int) -> torch.Tensor:
    """The group's shards of ``t`` concatenated along ``dim``."""
    return torch.cat(compat.all_gather_groups(t, groups).unbind(0), dim=dim)


def apply_moe_sharded(p, x: torch.Tensor, cfg: ModelConfig, mesh: compat.Mesh,
                      capacity_factor: Optional[float] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """On each rank of ``mesh``: ``p`` its weight shard
    (:func:`shard_moe_params`), x (B / data, S, D) its data shard → (its
    y shard, aux () f32 equal on every rank). C comes from the rank's
    own T tokens; ``aux`` is each data shard's load-balance loss,
    averaged over the data ranks (the reference's ``pmean``)."""
    E = cfg.num_experts
    m = mesh.shape["model"]
    data, model = mesh.groups_of("data"), mesh.groups_of("model")
    ep = expert_parallel(cfg, m)
    router = _gather(p["router"], data, 0)
    if ep:
        router = _gather(router, model, 1)
    wg, wu = _gather(p["w_gate"], data, 1), _gather(p["w_up"], data, 1)
    if ep:
        wd = _gather(p["w_down"], data, 1)              # (E / m, F, D)
        e_count = E // m
        e_base = mesh.index("model") * e_count
    else:
        wd = _gather(p["w_down"], data, 2)              # (E, F / m, D)
        e_base, e_count = 0, E
    Bl, S, D = x.shape
    T = Bl * S
    xf = x.reshape(T, D)
    probs, gates, expert_idx = route(xf, router, cfg)
    aux = load_balance_loss(probs, expert_idx, cfg).reshape(1)
    aux = compat.psum(aux, data)[0] / mesh.shape["data"]
    C = capacity(T, cfg, capacity_factor or None)
    plan = dispatch_plan(gates, expert_idx, C, e_base, e_count, x.dtype)
    y = compat.psum(_experts(xf, plan, wg, wu, wd, C), model)
    return y.reshape(Bl, S, D), aux
