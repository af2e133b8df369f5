"""Decoder-only transformer stack, dense and VLM families (vlm = the
dense decoder consuming stub prefix embeddings):

    model = build_model(cfg, kv_repeat=r)
    params = model.init(torch.Generator(device).manual_seed(0))
    h, aux = model.hidden_states(params, tokens, prefix_embeds)
    logits, aux = model.forward(params, tokens, prefix_embeds)
    loss, metrics = model.loss(params, batch)
    state = model.init_decode_state(batch_size, cache_len, device)
    logits, state = model.decode_step(params, state, tokens)

Layer weights are stacked on a leading "layers" dim, as in the
reference's template; a Python loop walks the layers where the
reference scans. Nothing here takes a gradient (LM training is ROADMAP
Queue 1 item 13c). The MoE, SSM, hybrid and audio families raise
(items 13d, 13e, 13f).
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import torch

from repro_torch.models import attention as attn_lib
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (PSpec, apply_mlp, apply_norm,
                                       chunked_lm_loss, embed_template,
                                       embed_tokens, lm_logits,
                                       mlp_template, norm_template,
                                       template_init, tree_map)


def stack_template(tpl, n: int):
    """Prepend a stacked 'layers' dim to every leaf of a layer template."""
    return tree_map(lambda p: PSpec((n,) + p.shape, ("layers",) + p.axes,
                                    p.init, p.fan_in), tpl)


class DecodeState(NamedTuple):
    caches: attn_lib.LayerKVCache   # stacked (L, B, KVr, S, hd)
    pos: torch.Tensor               # () int32 on the device — next write position


class TransformerModel:
    """Dense decoder (dense and vlm families). ``decode_kernel`` routes each layer's cache
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

    # -- forward ----------------------------------------------------------
    def _layer_fwd(self, lp, h: torch.Tensor, positions: torch.Tensor):
        cfg = self.cfg
        a_in = apply_norm(h, lp["attn_norm"], cfg.norm_style, cfg.norm_eps)
        h = h + attn_lib.attention(lp["attn"], a_in, cfg, positions=positions,
                                   kv_repeat=self.kv_repeat)
        m_in = apply_norm(h, lp["mlp_norm"], cfg.norm_style, cfg.norm_eps)
        return h + apply_mlp(m_in, lp["mlp"], cfg.mlp_style)

    def hidden_states(self, params, tokens: torch.Tensor,
                      prefix_embeds: Optional[torch.Tensor] = None):
        """tokens (B, S_text) → (hidden (B, S_total, D), aux ()). S_total
        = P + S_text with ``prefix_embeds`` (B, P, D) in front; aux is a
        f32 zero on the device (no router loss in these families)."""
        cfg = self.cfg
        h = embed_tokens(params["embed"], tokens)
        if prefix_embeds is not None:
            h = torch.cat([prefix_embeds.to(h.dtype), h], dim=1)
        B, S, _ = h.shape
        positions = torch.arange(S, device=h.device)[None].expand(B, S)
        for i in range(cfg.num_layers):
            h = self._layer_fwd(tree_map(lambda w: w[i], params["layers"]),
                                h, positions)
        h = apply_norm(h, params["final_norm"], cfg.norm_style, cfg.norm_eps)
        return h, torch.zeros((), dtype=torch.float32, device=h.device)

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


#: the roadmap item that ports each family not ported yet
UNPORTED_FAMILIES = {"moe": "13d", "ssm": "13e", "hybrid": "13e",
                     "audio": "13f"}


def build_model(cfg: ModelConfig, kv_repeat: int = 1,
                decode_kernel: bool = True) -> TransformerModel:
    """The dense and vlm families; every other family raises."""
    if cfg.family in ("dense", "vlm"):
        return TransformerModel(cfg, kv_repeat, decode_kernel)
    item = UNPORTED_FAMILIES.get(cfg.family, "13")
    raise NotImplementedError(
        f"{cfg.name}: the {cfg.family!r} family is not ported to repro_torch "
        f"yet (ROADMAP Queue 1 item {item})")
