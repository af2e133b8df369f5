"""Step builders, ported from ``repro/launch/steps.py``: the training,
prefill and decode steps of every LM family (dense, MoE, VLM, the
attention-free ssm, the hybrid and the encoder-decoder), with their
abstract inputs as ``meta`` tensors.

Input-shape suite (the reference's):
    train_4k     seq=4096    global_batch=256   (training)
    prefill_32k  seq=32768   global_batch=32    (inference-prefill)
    decode_32k   seq=32768   global_batch=128   (decode: 1 token, KV=seq)
    long_500k    seq=524288  global_batch=1     (long-context decode)

A step runs on whatever device its tensors are on. The serve step also
runs on a mesh of ranks (:func:`build_serve_step` with a
``launch.mesh.Mesh``; dense and VLM decoders): each rank then holds the
shards that the bundle's ``in_shardings`` place on it, as the
reference's ``build_serve_step(cfg, mesh)`` under SPMD. The train and
prefill steps are for one process: ``mesh`` and ``rules`` must be
``None`` (their sharded forms are ROADMAP Queue 1 item 13g-c; the
svm-tfidf steps item 13g-b), and their ``in_shardings`` and
``out_shardings`` are ``None``. The train step updates the params and
the optimizer state in place, the serve step the caches:
``donate_argnums`` names them, as the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch import optim
from repro_torch.launch import sharding as shd
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (lm_logits, tree_leaves,
                                       tree_unflatten, tree_map)
from repro_torch.models.transformer import build_model


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    kind: str          # 'train' | 'prefill' | 'decode'
    seq_len: int
    global_batch: int


INPUT_SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", "train", 4096, 256),
    "prefill_32k": InputShape("prefill_32k", "prefill", 32768, 32),
    "decode_32k": InputShape("decode_32k", "decode", 32768, 128),
    "long_500k": InputShape("long_500k", "decode", 524288, 1),
}


def applicability(cfg: ModelConfig, shape: InputShape) -> Optional[str]:
    """None if the (arch, shape) pair runs; else a skip reason."""
    if shape.name == "long_500k":
        sub_quadratic = (cfg.attn_free or cfg.family == "hybrid"
                         or cfg.sliding_window is not None)
        if cfg.is_encoder_decoder:
            return ("SKIP: encoder-decoder with architecturally capped "
                    "decoder context (448) — long_500k out of family range")
        if not sub_quadratic:
            return ("SKIP: pure full-attention arch — long_500k requires "
                    "sub-quadratic attention (no SWA variant in model card)")
    return None


def _single_process(mesh, rules) -> None:
    if mesh is not None or rules is not None:
        raise NotImplementedError(
            "sharded train and prefill steps (mesh=, rules=) are not "
            "ported to repro_torch yet (ROADMAP Queue 1 item 13g-c); pass "
            "mesh=None")


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def train_batch_abstract(cfg: ModelConfig, shape: InputShape):
    """The train batch of ``shape`` as ``meta`` tensors."""
    B, S = shape.global_batch, shape.seq_len
    i32 = lambda s: _meta(s, torch.int32)
    if cfg.is_encoder_decoder:
        S_dec = min(S, cfg.max_decoder_len)
        return {"frames": _meta((B, cfg.encoder_seq, cfg.d_model),
                                cfg.torch_dtype),
                "tokens": i32((B, S_dec)), "labels": i32((B, S_dec))}
    if cfg.frontend == "vision":
        P = cfg.num_prefix_tokens
        return {"prefix_embeds": _meta((B, P, cfg.d_model), cfg.torch_dtype),
                "tokens": i32((B, S - P)), "labels": i32((B, S - P))}
    return {"tokens": i32((B, S)), "labels": i32((B, S))}


class StepBundle(NamedTuple):
    fn: Callable
    args: Tuple
    in_shardings: Any
    out_shardings: Any
    donate_argnums: Tuple[int, ...]
    model: Any


def build_train_step(cfg: ModelConfig, mesh, shape: InputShape,
                     opt_cfg: Optional[optim.OptConfig] = None,
                     rules: Optional[dict] = None,
                     remat: bool = True) -> StepBundle:
    """→ ``train_step(params, opt_state, batch)`` returning ``(params,
    opt_state, {"loss", "ce", "aux", "lr", "grad_norm"})``: the loss and
    its gradients by autograd (each layer checkpointed when ``remat``),
    then one AdamW step written into ``params`` and ``opt_state`` in
    place. The metrics are 0-d tensors on the device: nothing in the step
    waits for it."""
    _single_process(mesh, rules)
    if remat and not cfg.remat:
        cfg = dataclasses.replace(cfg, remat=True)
    model = build_model(cfg)
    opt_cfg = opt_cfg or optim.OptConfig()

    def train_step(params, opt_state, batch):
        with torch.enable_grad():
            # aliases of the params' storage that autograd may track
            wrt = tree_map(lambda p: p.detach().requires_grad_(), params)
            loss, metrics = model.loss(wrt, batch)
            grads = torch.autograd.grad(loss, tree_leaves(wrt))
        params, opt_state, om = optim.apply_updates(
            params, tree_unflatten(params, grads), opt_state, opt_cfg)
        return params, opt_state, {
            "loss": loss.detach(),
            **{k: v.detach() for k, v in metrics.items()}, **om}

    params_abs = model.abstract()
    return StepBundle(
        fn=train_step,
        args=(params_abs, optim.abstract_state(params_abs),
              train_batch_abstract(cfg, shape)),
        in_shardings=None, out_shardings=None,
        donate_argnums=(0, 1), model=model)


def build_prefill_step(cfg: ModelConfig, mesh, shape: InputShape,
                       rules: Optional[dict] = None) -> StepBundle:
    """→ ``prefill_step(params, batch)``: the full-context forward, then
    the last position's logits (B, 1, V) only (the production prefill
    result; full logits would be B·S·V)."""
    _single_process(mesh, rules)
    model = build_model(cfg)

    @torch.no_grad()
    def prefill_step(params, batch):
        if cfg.is_encoder_decoder:
            enc = model.encode(params, batch["frames"])
            h, _ = model.hidden_states(params, batch["tokens"], enc)
        else:
            h, _ = model.hidden_states(params, batch["tokens"],
                                       batch.get("prefix_embeds"))
        return lm_logits(params["embed"], h[:, -1:, :], cfg.tie_embeddings)

    batch_abs = train_batch_abstract(cfg, shape)
    batch_abs.pop("labels")
    return StepBundle(
        fn=prefill_step, args=(model.abstract(), batch_abs),
        in_shardings=None, out_shardings=None, donate_argnums=(),
        model=model)


def make_serve_step(model) -> Callable[..., Tuple[torch.Tensor, Any]]:
    """→ ``serve_step(params, state, tokens (B, 1))`` of ``model``
    returning the next tokens (B,) int32 (argmax of the last logits; ties
    go to the first index, as ``jnp.argmax``) and the new state; the
    caches are written in place."""
    def serve_step(params, state, tokens: torch.Tensor):
        logits, state = model.decode_step(params, state, tokens)
        next_tok = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
        return next_tok, state
    return serve_step


def build_serve_step(cfg: ModelConfig, mesh, shape: InputShape,
                     rules: Optional[dict] = None) -> StepBundle:
    """One decode step (:func:`make_serve_step` of ``cfg``'s model) for
    a seq_len-deep cache of global_batch sequences.

    With a ``mesh`` the bundle is the reference's: the model's KV heads
    repeated ``kv_repeat_for(cfg, mesh)`` times, ``in_shardings`` = (the
    params' placements under ``rules``, the state's, the tokens'),
    ``out_shardings`` = (the next tokens', the state's); on a rank mesh
    its ``fn`` runs on this rank's shards (a shape-only mesh reckons the
    placements only). ``args`` are the whole (global) inputs as ``meta``
    tensors."""
    if mesh is None:
        if rules is not None:
            raise ValueError("rules place a step on a mesh; pass mesh=")
        model = build_model(cfg)
    else:
        r = shd.kv_repeat_for(cfg, mesh)
        pspecs = shd.param_pspecs(build_model(cfg, r), mesh, rules)
        model = build_model(cfg, r, mesh=mesh, place=pspecs)
    B = shape.global_batch
    state_abs = model.decode_state_abstract(B, shape.seq_len)
    args = (model.abstract(), state_abs, _meta((B, 1), torch.int32))
    if mesh is None:
        return StepBundle(fn=make_serve_step(model), args=args,
                          in_shardings=None, out_shardings=None,
                          donate_argnums=(1,), model=model)
    state_specs = shd.decode_state_pspecs(model, state_abs, mesh, B)
    bp = shd.batch_pspec(mesh, B)
    tok_spec = bp + (None,) if bp != (None,) else ()
    out_tok_spec = bp if bp != (None,) else ()
    return StepBundle(
        fn=make_serve_step(model), args=args,
        in_shardings=(pspecs, state_specs, tok_spec),
        out_shardings=(out_tok_spec, state_specs),
        donate_argnums=(1,), model=model)


def build_step(cfg: ModelConfig, mesh, shape: InputShape,
               rules: Optional[dict] = None, **kw) -> StepBundle:
    if shape.kind == "train":
        return build_train_step(cfg, mesh, shape, rules=rules, **kw)
    if shape.kind == "prefill":
        return build_prefill_step(cfg, mesh, shape, rules=rules)
    return build_serve_step(cfg, mesh, shape, rules=rules)
