"""Decoder-only transformer stack, dense, MoE and VLM families (moe =
the decoder with a routed expert layer in place of its MLP; vlm = the
dense decoder consuming stub prefix embeddings):

    model = build_model(cfg, kv_repeat=r)
    params = model.init(torch.Generator(device).manual_seed(0))
    shapes = model.abstract()            # the same tree on the meta device
    h, aux = model.hidden_states(params, tokens, prefix_embeds)
    logits, aux = model.forward(params, tokens, prefix_embeds)
    loss, metrics = model.loss(params, batch)
    state = model.init_decode_state(batch_size, cache_len, device)
    logits, state = model.decode_step(params, state, tokens)

Layer weights are stacked on a leading "layers" dim, as in the
reference's template; a Python loop walks the layers where the
reference scans, each stacked leaf taken apart once (``unbind``), so
that autograd stacks the layers' gradients once instead of writing a
whole-stack zero tensor for every layer's slice. ``cfg.remat``
checkpoints each layer, as the reference's ``jax.checkpoint`` of its
scan body: the backward recomputes a layer from its input. The train
step (``repro_torch.launch.steps.build_train_step``) differentiates
``loss`` with autograd. A MoE layer's load-balance loss is summed over
the layers into ``aux``, which ``loss`` adds to the CE; the decode step
routes each token as the forward does, at the config's capacity factor
over the step's B tokens. :func:`build_model` also builds the other
families' models (``rwkv6_model``, ``hybrid``, ``encdec``), which keep
this API.

On a mesh of ranks (``build_model(cfg, kv_repeat, mesh=, place=)``, a
``compat.Mesh`` of more than one rank and the placements of the
parameters, which ``launch.sharding.param_pspecs`` reckons and
``launch.steps.build_serve_step`` hands over) the dense and VLM decoders decode sharded, as the reference's
``build_serve_step(cfg, mesh)`` under SPMD: each rank holds the shard of
every weight that its placement gives it and its slice of the cache
(``init_decode_state(..., place=)``, the placements that
``launch.sharding.decode_state_pspecs`` gives: the batch over data, the
KV·r heads over model); ``init`` draws the same weights as one process
and keeps the rank's shards, ``init_decode_state`` takes the global batch
and makes the rank's slice, ``decode_step`` takes the rank's tokens and
gives its rows' logits over the whole vocabulary. The collectives follow
the placements (``models/layers.py``, the mesh section). The forward,
the loss and the other families under such a mesh are not ported
(ROADMAP Queue 1 item 13g-c) and raise.
"""
from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as attn_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (PSpec, apply_mlp, apply_mlp_sharded,
                                       apply_norm, apply_norm_sharded,
                                       chunked_lm_loss, embed_template,
                                       embed_tokens, embed_tokens_sharded,
                                       lm_logits, lm_logits_sharded,
                                       local_shape, mlp_template,
                                       norm_template, template_init,
                                       tree_map)

MESH_ITEM = "ROADMAP Queue 1 item 13g-c"


def sharded(mesh) -> bool:
    """Whether ``mesh`` spans more than one rank."""
    return mesh is not None and mesh.size > 1


def no_mesh_yet(what: str, mesh) -> None:
    """Raise for ``what`` under a mesh of more than one rank."""
    if sharded(mesh):
        raise NotImplementedError(
            f"{what} under a mesh of {mesh.size} ranks is not ported to "
            f"repro_torch yet ({MESH_ITEM})")


def stack_template(tpl, n: int):
    """Prepend a stacked 'layers' dim to every leaf of a layer template."""
    return tree_map(lambda p: PSpec((n,) + p.shape, ("layers",) + p.axes,
                                    p.init, p.fan_in), tpl)


def unstack_layers(stacked, n: int) -> List[Any]:
    """A stacked layer tree → n per-layer trees, each leaf unbound once."""
    parts = tree_map(lambda w: w.unbind(0), stacked)
    return [tree_map(lambda ws: ws[i], parts) for i in range(n)]


class DecodeState(NamedTuple):
    caches: attn_lib.LayerKVCache   # stacked (L, B, KVr, S, hd)
    pos: torch.Tensor               # () int32 on the device — next write position


class TemplateModel:
    """What every family's model shares: the parameters its
    ``template()`` declares, and its layers' checkpointing."""

    cfg: ModelConfig
    mesh = None
    place = None

    def init(self, gen: torch.Generator):
        """Random parameters on ``gen``'s device, in the config's dtype;
        on a mesh, this rank's shards of them."""
        return template_init(self.template(), gen, self.cfg.torch_dtype,
                             self.place, self.mesh)

    def abstract(self):
        """The parameters' shapes and dtype as ``meta`` tensors."""
        return tree_map(lambda p: torch.empty(p.shape,
                                              dtype=self.cfg.torch_dtype,
                                              device="meta"),
                        self.template())

    def decode_state_abstract(self, batch: int, cache_len: int):
        """The whole (global) decode state of ``batch`` sequences as
        ``meta`` tensors."""
        return self.init_decode_state(batch, cache_len, device="meta")

    def _run(self, fn, *args):
        """``fn(*args)``, one layer; checkpointed under ``cfg.remat``."""
        if self.cfg.remat:
            return checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)


class TransformerModel(TemplateModel):
    """Decoder (dense, moe and vlm families). ``decode_kernel`` routes each layer's cache
    attention through the ``flash_decode`` kernel when the cache is full
    (the reference's ``use_pallas``); False keeps the plain route.
    ``mesh`` (more than one rank: dense and vlm only) and ``place`` (the
    parameters' placements, a tree of the template's structure) make it
    decode sharded (the module's docstring)."""

    def __init__(self, cfg: ModelConfig, kv_repeat: int = 1,
                 decode_kernel: bool = True, mesh=None, place=None):
        self.cfg = cfg
        self.kv_repeat = kv_repeat
        self.decode_kernel = decode_kernel
        if sharded(mesh):
            if cfg.is_moe:
                no_mesh_yet("the MoE family", mesh)
            if place is None:
                raise ValueError("a model on a mesh needs its parameters' "
                                 "placements (launch.sharding.param_pspecs)")
            self.mesh, self.place = mesh, place

    # -- parameters -----------------------------------------------------
    def layer_template(self) -> Dict[str, Any]:
        cfg = self.cfg
        return {
            "attn_norm": norm_template(cfg.d_model, cfg.norm_style),
            "attn": attn_lib.attn_template(cfg),
            "mlp_norm": norm_template(cfg.d_model, cfg.norm_style),
            "mlp": (moe_lib.moe_template(cfg) if cfg.is_moe else
                    mlp_template(cfg.d_model, cfg.d_ff, cfg.mlp_style)),
        }

    def template(self) -> Dict[str, Any]:
        cfg = self.cfg
        return {
            "embed": embed_template(cfg.vocab_size, cfg.d_model,
                                    cfg.tie_embeddings),
            "layers": stack_template(self.layer_template(), cfg.num_layers),
            "final_norm": norm_template(cfg.d_model, cfg.norm_style),
        }

    # -- forward ----------------------------------------------------------
    def _mlp(self, lp, m_in: torch.Tensor):
        """→ (the MLP or expert layer's output, its aux loss or None)."""
        cfg = self.cfg
        if cfg.is_moe:
            return moe_lib.apply_moe(lp["mlp"], m_in, cfg)
        return apply_mlp(m_in, lp["mlp"], cfg.mlp_style), None

    def _layer_fwd(self, lp, h: torch.Tensor, positions: torch.Tensor):
        cfg = self.cfg
        a_in = apply_norm(h, lp["attn_norm"], cfg.norm_style, cfg.norm_eps)
        h = h + attn_lib.attention(lp["attn"], a_in, cfg, positions=positions,
                                   kv_repeat=self.kv_repeat)
        m_in = apply_norm(h, lp["mlp_norm"], cfg.norm_style, cfg.norm_eps)
        y, aux = self._mlp(lp, m_in)
        return h + y, aux

    def hidden_states(self, params, tokens: torch.Tensor,
                      prefix_embeds: Optional[torch.Tensor] = None):
        """tokens (B, S_text) → (hidden (B, S_total, D), aux ()). S_total
        = P + S_text with ``prefix_embeds`` (B, P, D) in front; aux () f32
        on the device is the layers' load-balance losses summed (zero
        without experts)."""
        no_mesh_yet("the forward pass", self.mesh)
        cfg = self.cfg
        h = embed_tokens(params["embed"], tokens)
        if prefix_embeds is not None:
            h = torch.cat([prefix_embeds.to(h.dtype), h], dim=1)
        B, S, _ = h.shape
        positions = torch.arange(S, device=h.device)[None].expand(B, S)
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
        for lp in unstack_layers(params["layers"], cfg.num_layers):
            h, a = self._run(self._layer_fwd, lp, h, positions)
            if a is not None:
                aux = aux + a
        h = apply_norm(h, params["final_norm"], cfg.norm_style, cfg.norm_eps)
        return h, aux

    def forward(self, params, tokens: torch.Tensor,
                prefix_embeds: Optional[torch.Tensor] = None):
        """→ (logits (B, S_total, V) in the activation dtype, aux)."""
        h, aux = self.hidden_states(params, tokens, prefix_embeds)
        return lm_logits(params["embed"], h, self.cfg.tie_embeddings), aux

    def loss(self, params, batch: Dict[str, torch.Tensor]):
        """batch: tokens, labels (B, S_text), optional prefix_embeds and
        loss_mask → (ce + aux, {"ce", "aux"}); the CE covers the text
        positions only."""
        h, aux = self.hidden_states(params, batch["tokens"],
                                    batch.get("prefix_embeds"))
        P = h.shape[1] - batch["labels"].shape[1]
        if P > 0:
            h = h[:, P:, :]
        ce = chunked_lm_loss(params["embed"], h, batch["labels"],
                             self.cfg.tie_embeddings, batch.get("loss_mask"))
        return ce + aux, {"ce": ce, "aux": aux}

    # -- decode -----------------------------------------------------------
    def init_decode_state(self, batch: int, cache_len: int,
                          device=None, place=None) -> DecodeState:
        """Zero caches of ``batch`` sequences at position 0; with
        ``place`` (the whole state's placements, a ``DecodeState`` of
        them) this rank's slice of them."""
        cfg = self.cfg
        one = attn_lib.init_layer_cache(cfg, batch, cache_len, self.kv_repeat,
                                        cfg.torch_dtype, device="meta")
        shape = (cfg.num_layers,) + tuple(one.k.shape)
        if place is not None:
            shape = local_shape(shape, place.caches.k, self.mesh)
        caches = attn_lib.LayerKVCache(
            *(torch.zeros(shape, dtype=cfg.torch_dtype, device=device)
              for _ in range(2)))
        return DecodeState(caches=caches,
                           pos=torch.zeros((), dtype=torch.int32,
                                           device=device))

    def decode_step(self, params, state: DecodeState, tokens: torch.Tensor):
        """tokens: (B, 1) → (logits (B, 1, V), new state).

        The caches are updated in place: the returned state holds the
        same cache tensors as ``state`` and a new ``pos``. On a mesh, B
        is this rank's batch rows and V the whole vocabulary.
        """
        if self.mesh is not None:
            return self._decode_step_sharded(params, state, tokens)
        cfg = self.cfg
        h = embed_tokens(params["embed"], tokens)
        pos = state.pos
        for i, lp in enumerate(unstack_layers(params["layers"],
                                              cfg.num_layers)):
            cache = attn_lib.LayerKVCache(state.caches.k[i],
                                          state.caches.v[i])
            a_in = apply_norm(h, lp["attn_norm"], cfg.norm_style,
                              cfg.norm_eps)
            a_out, _ = attn_lib.attention_decode_step(
                lp["attn"], a_in, cache, pos, cfg, self.kv_repeat,
                use_kernel=self.decode_kernel)
            h = h + a_out
            m_in = apply_norm(h, lp["mlp_norm"], cfg.norm_style, cfg.norm_eps)
            h = h + self._mlp(lp, m_in)[0]
        h = apply_norm(h, params["final_norm"], cfg.norm_style, cfg.norm_eps)
        logits = lm_logits(params["embed"], h, cfg.tie_embeddings)
        return logits, DecodeState(caches=state.caches, pos=pos + 1)

    def _decode_step_sharded(self, params, state: DecodeState,
                             tokens: torch.Tensor):
        """:meth:`decode_step` on a rank's shards: a layer's leaves
        gathered over data as it runs, its products summed over model
        where they contract a split dim, the logits gathered over
        model."""
        cfg, mesh, place = self.cfg, self.mesh, self.place
        mesh.index("model")               # a shape-only mesh runs nothing
        lplace = _inner(place["layers"])
        h = embed_tokens_sharded(params["embed"], place["embed"], tokens,
                                 mesh)
        pos = state.pos
        for i, lp in enumerate(unstack_layers(params["layers"],
                                              cfg.num_layers)):
            cache = attn_lib.LayerKVCache(state.caches.k[i],
                                          state.caches.v[i])
            h = self.layer_decode_sharded(lp, lplace, h, cache, pos)
        h = apply_norm_sharded(h, params["final_norm"], place["final_norm"],
                               cfg.norm_style, cfg.norm_eps, mesh)
        logits = lm_logits_sharded(params["embed"], place["embed"], h,
                                   cfg.tie_embeddings, mesh)
        return logits, DecodeState(caches=state.caches, pos=pos + 1)


    def layer_decode_sharded(self, lp, lplace, h: torch.Tensor, cache,
                             pos: torch.Tensor) -> torch.Tensor:
        """One layer of :meth:`decode_step` on a rank's shards: ``lp`` the
        layer's leaves, ``lplace`` their placements (a layer's, without
        the stacked "layers" entry), ``cache`` its ``LayerKVCache``,
        written in place. → the new hidden state."""
        cfg, mesh = self.cfg, self.mesh
        a_in = apply_norm_sharded(h, lp["attn_norm"], lplace["attn_norm"],
                                  cfg.norm_style, cfg.norm_eps, mesh)
        a_out, _ = attn_lib.attention_decode_step(
            lp["attn"], a_in, cache, pos, cfg, self.kv_repeat,
            use_kernel=self.decode_kernel, mesh=mesh, place=lplace["attn"])
        h = h + a_out
        m_in = apply_norm_sharded(h, lp["mlp_norm"], lplace["mlp_norm"],
                                  cfg.norm_style, cfg.norm_eps, mesh)
        return h + apply_mlp_sharded(m_in, lp["mlp"], lplace["mlp"],
                                     cfg.mlp_style, mesh)


def _inner(place_tree):
    """The placements of one layer's slices: a stacked tree's without
    its leading "layers" entry (never split)."""
    return tree_map(lambda pl: pl[1:], place_tree)


def build_model(cfg: ModelConfig, kv_repeat: int = 1,
                decode_kernel: bool = True, mesh=None, place=None):
    """Family dispatcher, as ``repro/models/transformer.py:202-215``
    (deferred imports avoid the cycle). ``decode_kernel`` routes the
    cache attention of the families that have one through
    ``ops.decode_attention``. ``mesh`` (a ``compat.Mesh``) and ``place``
    (the parameters' placements) put a dense or VLM decoder on ranks;
    the other families under a mesh of more than one rank raise (ROADMAP
    Queue 1 item 13g-c)."""
    if cfg.family in ("dense", "moe", "vlm"):
        return TransformerModel(cfg, kv_repeat, decode_kernel, mesh, place)
    no_mesh_yet(f"the {cfg.family} family", mesh)
    if cfg.family == "ssm" and cfg.attn_free:
        from repro_torch.models.rwkv6_model import RWKV6Model
        return RWKV6Model(cfg)
    if cfg.family == "hybrid":
        from repro_torch.models.hybrid import HybridModel
        return HybridModel(cfg, kv_repeat, decode_kernel)
    if cfg.family == "audio" and cfg.is_encoder_decoder:
        from repro_torch.models.encdec import EncDecModel
        return EncDecModel(cfg, kv_repeat, decode_kernel)
    raise ValueError(f"unknown family {cfg.family!r} for {cfg.name}")
