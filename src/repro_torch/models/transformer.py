"""Decoder-only transformer stack, dense family: the decode path.

    model = build_model(cfg, kv_repeat=r)
    params = model.init(torch.Generator(device).manual_seed(0))
    state = model.init_decode_state(batch_size, cache_len, device)
    logits, state = model.decode_step(params, state, tokens)

Layer weights are stacked on a leading "layers" dim, as in the
reference's template; a Python loop walks the layers where the
reference scans. The other families, ``hidden_states``, ``forward`` and
``loss`` are not ported yet (ROADMAP Queue 1 item 13).
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple

import torch

from repro_torch.models import attention as attn_lib
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (PSpec, apply_mlp, apply_norm,
                                       embed_template, embed_tokens,
                                       lm_logits, mlp_template,
                                       norm_template, template_init,
                                       tree_map)


def stack_template(tpl, n: int):
    """Prepend a stacked 'layers' dim to every leaf of a layer template."""
    return tree_map(lambda p: PSpec((n,) + p.shape, ("layers",) + p.axes,
                                    p.init, p.fan_in), tpl)


class DecodeState(NamedTuple):
    caches: attn_lib.LayerKVCache   # stacked (L, B, KVr, S, hd)
    pos: torch.Tensor               # () int32 on the device — next write position


class TransformerModel:
    """Dense decoder. ``decode_kernel`` routes each layer's cache
    attention through the ``flash_decode`` kernel when the cache is full
    (the reference's ``use_pallas``); False keeps the plain route."""

    def __init__(self, cfg: ModelConfig, kv_repeat: int = 1,
                 decode_kernel: bool = True):
        self.cfg = cfg
        self.kv_repeat = kv_repeat
        self.decode_kernel = decode_kernel

    # -- parameters -----------------------------------------------------
    def layer_template(self) -> Dict[str, Any]:
        cfg = self.cfg
        return {
            "attn_norm": norm_template(cfg.d_model, cfg.norm_style),
            "attn": attn_lib.attn_template(cfg),
            "mlp_norm": norm_template(cfg.d_model, cfg.norm_style),
            "mlp": mlp_template(cfg.d_model, cfg.d_ff, cfg.mlp_style),
        }

    def template(self) -> Dict[str, Any]:
        cfg = self.cfg
        return {
            "embed": embed_template(cfg.vocab_size, cfg.d_model,
                                    cfg.tie_embeddings),
            "layers": stack_template(self.layer_template(), cfg.num_layers),
            "final_norm": norm_template(cfg.d_model, cfg.norm_style),
        }

    def init(self, gen: torch.Generator):
        """Random parameters on ``gen``'s device, in the config's dtype."""
        return template_init(self.template(), gen, self.cfg.torch_dtype)

    # -- decode -----------------------------------------------------------
    def init_decode_state(self, batch: int, cache_len: int,
                          device=None) -> DecodeState:
        cfg = self.cfg
        one = attn_lib.init_layer_cache(cfg, batch, cache_len, self.kv_repeat,
                                        cfg.torch_dtype, device="meta")
        shape = (cfg.num_layers,) + tuple(one.k.shape)
        caches = attn_lib.LayerKVCache(
            *(torch.zeros(shape, dtype=cfg.torch_dtype, device=device)
              for _ in range(2)))
        return DecodeState(caches=caches,
                           pos=torch.zeros((), dtype=torch.int32,
                                           device=device))

    def decode_step(self, params, state: DecodeState, tokens: torch.Tensor):
        """tokens: (B, 1) → (logits (B, 1, V), new state).

        The caches are updated in place: the returned state holds the
        same cache tensors as ``state`` and a new ``pos``.
        """
        cfg = self.cfg
        h = embed_tokens(params["embed"], tokens)
        pos = state.pos
        for i in range(cfg.num_layers):
            lp = tree_map(lambda w: w[i], params["layers"])
            cache = attn_lib.LayerKVCache(state.caches.k[i],
                                          state.caches.v[i])
            a_in = apply_norm(h, lp["attn_norm"], cfg.norm_style,
                              cfg.norm_eps)
            a_out, _ = attn_lib.attention_decode_step(
                lp["attn"], a_in, cache, pos, cfg, self.kv_repeat,
                use_kernel=self.decode_kernel)
            h = h + a_out
            m_in = apply_norm(h, lp["mlp_norm"], cfg.norm_style, cfg.norm_eps)
            h = h + apply_mlp(m_in, lp["mlp"], cfg.mlp_style)
        h = apply_norm(h, params["final_norm"], cfg.norm_style, cfg.norm_eps)
        logits = lm_logits(params["embed"], h, cfg.tie_embeddings)
        return logits, DecodeState(caches=state.caches, pos=pos + 1)


def build_model(cfg: ModelConfig, kv_repeat: int = 1,
                decode_kernel: bool = True) -> TransformerModel:
    """The dense family; every other family raises."""
    if cfg.family == "dense":
        return TransformerModel(cfg, kv_repeat, decode_kernel)
    raise NotImplementedError(
        f"{cfg.name}: the {cfg.family!r} family is not ported to repro_torch "
        "yet (ROADMAP Queue 1 item 13)")
