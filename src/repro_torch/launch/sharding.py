"""Logical-axis → mesh placement rules with divisibility fallbacks,
ported from ``repro/launch/sharding.py``.

A *placement* is the port's counterpart of a ``PartitionSpec``: a plain
tuple with one entry per leading dim of a tensor, each a mesh-axis name,
a tuple of names (the batch over ``("pod", "data")``) or None
(replicated). :func:`pspec_for` drops trailing Nones, as the reference's
does; the batch and decode-state placements keep them, as the
reference's ``PartitionSpec`` s do, so that ``tuple(spec)`` of the
reference's equals the port's placement entry for entry. A mesh is a
``compat.Mesh``: a grid of ``torch.distributed`` ranks
(``launch.mesh.make_host_mesh``), or a shape-only mesh
(``make_production_mesh``) that reckons placements without ranks. The
models take the placements reckoned here (``build_model(..., mesh=,
place=)``, ``init_decode_state(..., place=)``; ``launch.steps.
build_serve_step`` hands them over) and cut and sum by them
(``models/layers.py``' mesh section, where ``local_shard`` is).

Baseline policy (the reference's):

  vocab     → model      (vocabulary-parallel embedding and logits)
  ffn       → model      (Megatron column / row)
  heads     → model      (attention heads)
  experts   → model      (expert parallel; falls back when E < model)
  embed     → data       (FSDP: params sharded over data)
  kv_heads  → replicated (the cache shards over model via kv_repeat)
  batch     → (pod, data)

A rule is skipped when the dim does not divide the mesh axis or the
axis is already used by another dim of the same tensor: the fallback
chain takes the next candidate, ending at replication.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import tree_map

# Ordered mesh-axis candidates per logical axis.
DEFAULT_RULES: Dict[Optional[str], Tuple[str, ...]] = {
    "vocab": ("model",),
    "embed": ("data",),
    "embed_out": ("model",),
    "ffn": ("model", "data"),
    "heads": ("model",),
    "heads_flat": ("model",),
    "kv_heads": (),
    "head_dim": (),
    "experts": ("model",),
    "layers": (),
    None: (),
}


def pspec_for(shape: Sequence[int], axes: Sequence[Optional[str]],
              mesh, rules: Optional[Dict] = None) -> tuple:
    """The placement of one tensor, honoring divisibility and one mesh
    axis a tensor."""
    rules = rules or DEFAULT_RULES
    used = set()
    out = []
    for dim, ax in zip(shape, axes):
        choice = None
        for cand in rules.get(ax, ()):            # ordered candidates
            if cand in mesh.axis_names and cand not in used \
                    and dim % mesh.shape[cand] == 0:
                choice = cand
                break
        if choice:
            used.add(choice)
        out.append(choice)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def param_pspecs(model, mesh, rules: Optional[Dict] = None):
    """The model's template → a tree of placements (its leaves' names)."""
    return tree_map(lambda p: pspec_for(p.shape, p.axes, mesh, rules),
                    model.template())


def kv_repeat_for(cfg: ModelConfig, mesh) -> int:
    """Duplicate KV heads so that the KV cache shards over ``model``.

    r is the smallest factor with (KV·r) % model == 0 and (KV·r) | H;
    r = 1 when impossible (the cache is replicated over model instead)."""
    m = mesh.shape.get("model", 1)
    KV, H = cfg.num_kv_heads, cfg.num_heads
    if cfg.attn_free or m == 1 or KV % m == 0:
        return 1
    r = m // math.gcd(KV, m)
    if (KV * r) % m == 0 and H % (KV * r) == 0:
        return r
    return 1


def batch_pspec(mesh, batch_size: int) -> tuple:
    """The batch over (pod, data) when it divides, else replicated."""
    axes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    dp = math.prod(mesh.shape[a] for a in axes)
    if axes and batch_size % dp == 0:
        return (axes if len(axes) > 1 else axes[0],)
    return (None,)


def leading_batch_specs(tree_abstract, mesh, batch_size: int):
    """Dim 0 (the batch) of every leaf of a dict tree placed by
    :func:`batch_pspec`; the rest replicated."""
    bp = batch_pspec(mesh, batch_size)

    def spec(a):
        return bp + (None,) * (len(a.shape) - 1) if bp != (None,) else ()
    return tree_map(spec, tree_abstract)


def _axis_if_divisible(mesh, axis: str, dim: int) -> Optional[str]:
    return axis if (axis in mesh.axis_names
                    and dim % mesh.shape[axis] == 0) else None


def _state_spec(name: str, shape, mesh, b: tuple) -> tuple:
    md = lambda dim: _axis_if_divisible(mesh, "model", dim)  # noqa: E731
    if len(shape) == 0:
        return ()
    if name in ("k", "v", "cross_k", "cross_v"):      # (L, B, KVr, S, hd)
        return (None, *b, md(shape[2]), None, None)
    if name == "S":                                   # (L, B, H, hd, hd)
        return (None, *b, md(shape[2]), None, None)
    if name == "h":                       # (nseg, slen, B, nh, P, N)
        return (None, None, *b, md(shape[3]), None, None)
    if name == "conv_buf":                # (nseg, slen, B, K, C)
        return (None, None, *b, None, md(shape[4]))
    if name.startswith("x_prev"):         # (L, B, 1, D)
        return (None, *b, None, None)
    return ()


def decode_state_pspecs(model, state_abstract, mesh, batch_size: int):
    """Placements of a decode state (any family's: ``DecodeState``,
    ``RWKVDecodeState``, ``HybridDecodeState``, ``EncDecDecodeState``),
    keyed on the leaves' field names as the reference's:

      caches.k/v, shared_cache.*, cross_k/v : (L|nseg, B, KVr, S, hd)
                                               → B→batch, KVr→model
      S (RWKV wkv state)   : (L, B, H, hd, hd) → B→batch, H→model
      ssm.h (Mamba2)       : (nseg, slen, B, nh, P, N) → B→batch, nh→model
      ssm.conv_buf         : (nseg, slen, B, K, C) → B→batch, C→model
      x_prev_*             : (L, B, 1, D) → B→batch
      pos                  : () replicated

    → the state's structure (its NamedTuple types) with a placement in
    place of each tensor."""
    bp = batch_pspec(mesh, batch_size)
    b = bp if bp != (None,) else (None,)

    def walk(node, name):
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*(walk(getattr(node, f), f)
                                for f in node._fields))
        return _state_spec(name, node.shape, mesh, b)
    return walk(state_abstract, "")


__all__ = ["DEFAULT_RULES", "batch_pspec", "decode_state_pspecs",
           "kv_repeat_for", "leading_batch_specs", "param_pspecs",
           "pspec_for"]
