"""RWKV-6 full model (the attention-free ``ssm`` family), ported from
``repro/models/rwkv6_model.py``: layernorm everywhere, each layer a time
mix and a channel mix, the forward's token shift from a zero token.

    model = RWKV6Model(cfg)
    params = model.init(torch.Generator(device).manual_seed(0))
    logits, aux = model.forward(params, tokens)
    loss, metrics = model.loss(params, batch)
    state = model.init_decode_state(batch_size, cache_len, device)
    logits, state = model.decode_step(params, state, tokens)

Decode carries an O(1) state a layer (no KV cache at any context
length). ``decode_step`` leaves the given state as it was and returns
a new one.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.models import rwkv6
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (apply_norm, chunked_lm_loss,
                                       embed_template, embed_tokens,
                                       lm_logits, norm_template)
from repro_torch.models.transformer import (TemplateModel, stack_template,
                                            unstack_layers)


class RWKVDecodeState(NamedTuple):
    S: torch.Tensor         # (L, B, H, hd, hd) f32 wkv states
    x_prev_t: torch.Tensor  # (L, B, 1, D)
    x_prev_c: torch.Tensor  # (L, B, 1, D)
    pos: torch.Tensor       # () int32 on the device


class RWKV6Model(TemplateModel):
    def __init__(self, cfg: ModelConfig, kv_repeat: int = 1):
        self.cfg = cfg
        self.kv_repeat = kv_repeat   # unused (attention-free); kept for API

    def layer_template(self):
        cfg = self.cfg
        t = rwkv6.rwkv6_template(cfg)
        return {
            "ln1": norm_template(cfg.d_model, "layernorm"),
            "time": t["time"],
            "ln2": norm_template(cfg.d_model, "layernorm"),
            "channel": t["channel"],
        }

    def template(self):
        cfg = self.cfg
        return {
            "embed": embed_template(cfg.vocab_size, cfg.d_model,
                                    cfg.tie_embeddings),
            "layers": stack_template(self.layer_template(), cfg.num_layers),
            "final_norm": norm_template(cfg.d_model, "layernorm"),
        }

    # -- forward ----------------------------------------------------------
    def _layer_fwd(self, lp, h, zero_prev):
        cfg = self.cfg
        x = apply_norm(h, lp["ln1"], "layernorm", cfg.norm_eps)
        h = h + rwkv6.apply_rwkv_time(lp["time"], x, cfg, zero_prev)
        x = apply_norm(h, lp["ln2"], "layernorm", cfg.norm_eps)
        return h + rwkv6.apply_rwkv_channel(lp["channel"], x, zero_prev)

    def hidden_states(self, params, tokens, prefix_embeds=None):
        """tokens (B, S) → (hidden (B, S, D), aux () f32 zero)."""
        cfg = self.cfg
        h = embed_tokens(params["embed"], tokens)
        zero_prev = torch.zeros((h.shape[0], 1, cfg.d_model), dtype=h.dtype,
                                device=h.device)
        for lp in unstack_layers(params["layers"], cfg.num_layers):
            h = self._run(self._layer_fwd, lp, h, zero_prev)
        h = apply_norm(h, params["final_norm"], "layernorm", cfg.norm_eps)
        return h, torch.zeros((), dtype=torch.float32, device=h.device)

    def forward(self, params, tokens, prefix_embeds=None):
        h, aux = self.hidden_states(params, tokens)
        return lm_logits(params["embed"], h, self.cfg.tie_embeddings), aux

    def loss(self, params, batch):
        h, aux = self.hidden_states(params, batch["tokens"])
        ce = chunked_lm_loss(params["embed"], h, batch["labels"],
                             self.cfg.tie_embeddings, batch.get("loss_mask"))
        return ce + aux, {"ce": ce, "aux": aux}

    # -- decode (O(1) state a token: no KV cache at any context length) --
    def init_decode_state(self, batch: int, cache_len: int,
                          device=None) -> RWKVDecodeState:
        cfg = self.cfg
        L, D = cfg.num_layers, cfg.d_model
        H = rwkv6.rwkv_heads(cfg)
        hd = rwkv6.HEADDIM
        return RWKVDecodeState(
            S=torch.zeros((L, batch, H, hd, hd), dtype=torch.float32,
                          device=device),
            x_prev_t=torch.zeros((L, batch, 1, D), dtype=cfg.torch_dtype,
                                 device=device),
            x_prev_c=torch.zeros((L, batch, 1, D), dtype=cfg.torch_dtype,
                                 device=device),
            pos=torch.zeros((), dtype=torch.int32, device=device))

    def decode_step(self, params, state: RWKVDecodeState, tokens):
        """tokens (B, 1) → (logits (B, 1, V), new state); ``state`` is
        left as it was."""
        cfg = self.cfg
        h = embed_tokens(params["embed"], tokens)   # (B, 1, D)
        new = RWKVDecodeState(torch.empty_like(state.S),
                              torch.empty_like(state.x_prev_t),
                              torch.empty_like(state.x_prev_c),
                              state.pos + 1)
        for i, lp in enumerate(unstack_layers(params["layers"],
                                              cfg.num_layers)):
            x = apply_norm(h, lp["ln1"], "layernorm", cfg.norm_eps)
            y, _ = rwkv6.rwkv_time_decode_step(
                lp["time"], x, state.S[i], state.x_prev_t[i], cfg,
                S_out=new.S[i])
            h = h + y
            x2 = apply_norm(h, lp["ln2"], "layernorm", cfg.norm_eps)
            h = h + rwkv6.apply_rwkv_channel(lp["channel"], x2,
                                             state.x_prev_c[i])
            new.x_prev_t[i].copy_(x)
            new.x_prev_c[i].copy_(x2)
        h = apply_norm(h, params["final_norm"], "layernorm", cfg.norm_eps)
        return lm_logits(params["embed"], h, cfg.tie_embeddings), new
