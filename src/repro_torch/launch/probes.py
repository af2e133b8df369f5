"""Single-layer probes, ported from ``repro/launch/probes.py``.

XLA prints the body of a scan once, so the reference compiles one layer
on its own to learn a trip's collectives and adds ``(trips − 1) ×`` the
probe to the full program's count (``hlo_analysis.combine_with_layer``).
The port's probes are the same single layers run shape-only on a rank
of the dry run's fake group (:func:`measure_probes`): each returns the
reference's ``{"extra_trips", "collectives"}`` (plus its FLOPs). The
port records every collective of every trip of its Python layer loop,
so a full step's record already holds ``trips ×`` the probe: the dry
run reports the probes and adds nothing through ``combine_with_layer``.
The probe then checks that arithmetic instead: the full step's count of
each kind is the probe's × trips plus what runs outside the layers.

Probes exist where a step runs on a mesh: the dense and VLM families'
decode layer, and their full-sequence layer (the reference's "layer"
probe: the forward for prefill, its gradients by autograd for train).
The MoE, SSM, hybrid and encoder-decoder layers under a mesh raise with
the step itself (ROADMAP Queue 1 item 13g-c).
"""
from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.launch import sharding as shd
from repro_torch.launch.steps import InputShape, StepBundle
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import tree_map


class Probe(NamedTuple):
    name: str
    fn: Any
    args: Tuple               # global inputs, ``meta`` tensors
    in_shardings: Tuple       # their placements
    extra_trips: int          # the reference's multiplier of the probe


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def build_probes(cfg: ModelConfig, mesh, shape: InputShape,
                 rules: Optional[dict] = None,
                 bundle: Optional[StepBundle] = None) -> List[Probe]:
    """The probes of ``cfg``'s step at ``shape`` on ``mesh``: for the
    decode step of a dense or VLM decoder, one layer's decode
    (``TransformerModel.layer_decode_sharded``) over its slice of the
    cache; ``bundle`` is the step's (built here when not given), whose
    model and placements the probe shares."""
    from repro_torch.launch.steps import build_serve_step, build_step
    from repro_torch.models import attention as attn_lib
    from repro_torch.models.transformer import MESH_ITEM, _inner
    if cfg.family not in ("dense", "vlm"):
        raise NotImplementedError(
            f"the {shape.kind} layer of the {cfg.family} family under a "
            f"mesh is not ported to repro_torch yet ({MESH_ITEM})")
    if shape.kind != "decode":
        return [_layer_probe(cfg, mesh, shape,
                             bundle or build_step(cfg, mesh, shape, rules))]
    bundle = bundle or build_serve_step(cfg, mesh, shape, rules)
    model = bundle.model
    params_abs, state_abs, _ = bundle.args
    pspecs, state_specs, _ = bundle.in_shardings
    B = shape.global_batch
    # a layer's slice of each stacked leaf and of the stacked caches
    layer_abs = tree_map(lambda a: _meta(a.shape[1:], a.dtype),
                         params_abs["layers"])
    layer_spec = _inner(pspecs["layers"])
    cache_abs = attn_lib.LayerKVCache(
        *(_meta(t.shape[1:], t.dtype) for t in state_abs.caches))
    kv_spec = state_specs.caches.k[1:]
    bp = shd.batch_pspec(mesh, B)
    h_spec = (bp + (None, None)) if bp != (None,) else ()
    h_abs = _meta((B, 1, cfg.d_model), cfg.torch_dtype)
    pos_abs = _meta((), torch.int32)

    def fn(h, lp, cache, pos):
        return model.layer_decode_sharded(lp, layer_spec, h, cache, pos)
    return [Probe("layer_decode", fn, (h_abs, layer_abs, cache_abs, pos_abs),
                  (h_spec, layer_spec,
                   attn_lib.LayerKVCache(kv_spec, kv_spec), ()),
                  cfg.num_layers - 1)]


def _layer_probe(cfg: ModelConfig, mesh, shape: InputShape,
                 bundle: StepBundle) -> Probe:
    """One full-sequence layer of the train or prefill step on the
    rank's shards (``TransformerModel._layer_fwd_sharded``), its input
    the residual as the step holds it between layers (the rank's block
    of the sequence where ``seq_parallel``); for train the gradients of
    the output's sum with respect to the input and the layer's leaves,
    as the reference's probe takes them."""
    from repro_torch.models.layers import tree_leaves
    from repro_torch.models.transformer import _inner
    model = bundle.model
    B, S = shape.global_batch, shape.seq_len
    if cfg.is_encoder_decoder:
        S = min(S, cfg.max_decoder_len)
    sp = model.seq_parallel(S)
    layer_abs = tree_map(lambda a: _meta(a.shape[1:], a.dtype),
                         bundle.args[0]["layers"])
    layer_spec = _inner(bundle.in_shardings[0]["layers"])
    bp = shd.batch_pspec(mesh, B)
    h_spec = (bp if bp != (None,) else (None,)) + (
        "model" if sp else None, None)
    h_abs = _meta((B, S, cfg.d_model), cfg.torch_dtype)
    grad = shape.kind == "train"

    def fn(h, lp):
        pos = torch.arange(S, device=h.device)[None].expand(h.shape[0], S)
        if not grad:
            return model._layer_fwd_sharded(lp, h, pos, sp)
        with torch.enable_grad():
            h = h.detach().requires_grad_()
            lp = tree_map(lambda w: w.detach().requires_grad_(), lp)
            out = model._layer_fwd_sharded(lp, h, pos, sp)
            return torch.autograd.grad(out.sum().float(),
                                       [h] + tree_leaves(lp))
    return Probe("layer", fn, (h_abs, layer_abs), (h_spec, layer_spec),
                 cfg.num_layers - 1)


def measure_probes(probes: List[Probe], mesh) -> Dict[str, dict]:
    """Run each probe once, shape-only, on this rank of the rank
    ``mesh`` (its inputs this rank's shards, as fake tensors): →
    ``{name: {"extra_trips", "collectives", "per_device_flops"}}``, the
    collectives by ``hlo_analysis.collective_stats``, the FLOPs
    ``FlopCounterMode``'s plus the kernels' (their shape rules')."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch import compat
    from repro_torch.kernels import ops
    from repro_torch.launch.dryrun import fake_like
    from repro_torch.launch.hlo_analysis import collective_stats
    from repro_torch.launch.steps import local_abstract
    out = {}
    for p in probes:
        local = local_abstract(p.args, p.in_shardings, mesh)
        with FakeTensorMode(), torch.no_grad():
            args = fake_like(local)
            with compat.record_collectives() as rec, \
                    ops.record_kernel_work() as work, \
                    FlopCounterMode(display=False) as flops:
                p.fn(*args)
        out[p.name] = {
            "extra_trips": p.extra_trips,
            "collectives": collective_stats(rec),
            "per_device_flops": float(flops.get_total_flops()
                                      + sum(w.flops * (w.epochs or 1)
                                            for w in work)),
        }
    return out
