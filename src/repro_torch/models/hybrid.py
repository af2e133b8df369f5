"""Zamba2-style hybrid (arXiv:2411.15242), ported from
``repro/models/hybrid.py``: a Mamba-2 trunk and one SHARED attention +
MLP block applied after every ``attn_every`` mamba layers. The mamba
layers are stacked twice, (n_seg, seg_len, …); the shared block's
weights are reused at each application, and each application keeps its
own KV cache during decode, (n_seg, B, KVr, S, hd).

``decode_kernel`` routes the shared block's cache attention through
``ops.decode_attention`` (the ``flash_decode`` kernel on the card), as
the dense family's; False keeps the plain route. In ``decode_step`` the
KV caches are written in place and the mamba states come back as new
tensors (the given state's are left as they were).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.models import attention as attn_lib
from repro_torch.models import mamba2
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (apply_mlp, apply_norm,
                                       chunked_lm_loss, embed_template,
                                       embed_tokens, lm_logits, mlp_template,
                                       norm_template)
from repro_torch.models.transformer import (TemplateModel, stack_template,
                                            unstack_layers)


class HybridDecodeState(NamedTuple):
    ssm: mamba2.Mamba2State              # leaves stacked (n_seg, seg_len, B, ...)
    shared_cache: attn_lib.LayerKVCache  # (n_seg, B, KVr, S, hd)
    pos: torch.Tensor                    # () int32 on the device


class HybridModel(TemplateModel):
    def __init__(self, cfg: ModelConfig, kv_repeat: int = 1,
                 decode_kernel: bool = True):
        if cfg.attn_every <= 0 or cfg.num_layers % cfg.attn_every:
            raise ValueError("hybrid needs attn_every | num_layers")
        self.cfg = cfg
        self.kv_repeat = kv_repeat
        self.decode_kernel = decode_kernel
        self.n_seg = cfg.num_layers // cfg.attn_every
        self.seg_len = cfg.attn_every

    # -- parameters -------------------------------------------------------
    def template(self):
        cfg = self.cfg
        mamba_layer = {
            "norm": norm_template(cfg.d_model, cfg.norm_style),
            "mamba": mamba2.mamba2_template(cfg),
        }
        shared = {
            "attn_norm": norm_template(cfg.d_model, cfg.norm_style),
            "attn": attn_lib.attn_template(cfg),
            "mlp_norm": norm_template(cfg.d_model, cfg.norm_style),
            "mlp": mlp_template(cfg.d_model, cfg.d_ff, cfg.mlp_style),
        }
        return {
            "embed": embed_template(cfg.vocab_size, cfg.d_model,
                                    cfg.tie_embeddings),
            "mamba_layers": stack_template(
                stack_template(mamba_layer, self.seg_len), self.n_seg),
            "shared": shared,
            "final_norm": norm_template(cfg.d_model, cfg.norm_style),
        }

    def _segments(self, params):
        """params["mamba_layers"] → n_seg lists of seg_len layer trees."""
        return [unstack_layers(seg, self.seg_len)
                for seg in unstack_layers(params["mamba_layers"], self.n_seg)]

    # -- forward ------------------------------------------------------------
    def _mamba_layer(self, lp, h):
        cfg = self.cfg
        x = apply_norm(h, lp["norm"], cfg.norm_style, cfg.norm_eps)
        return h + mamba2.apply_mamba2(lp["mamba"], x, cfg)

    def _shared_block(self, sp, h, positions):
        cfg = self.cfg
        a_in = apply_norm(h, sp["attn_norm"], cfg.norm_style, cfg.norm_eps)
        h = h + attn_lib.attention(sp["attn"], a_in, cfg, positions=positions,
                                   kv_repeat=self.kv_repeat)
        m_in = apply_norm(h, sp["mlp_norm"], cfg.norm_style, cfg.norm_eps)
        return h + apply_mlp(m_in, sp["mlp"], cfg.mlp_style)

    def hidden_states(self, params, tokens, prefix_embeds=None):
        """tokens (B, S) → (hidden (B, S, D), aux () f32 zero).
        ``cfg.remat`` checkpoints each mamba layer and each application
        of the shared block."""
        cfg = self.cfg
        h = embed_tokens(params["embed"], tokens)
        B, S, _ = h.shape
        positions = torch.arange(S, device=h.device)[None].expand(B, S)
        for seg in self._segments(params):
            for lp in seg:
                h = self._run(self._mamba_layer, lp, h)
            h = self._run(self._shared_block, params["shared"], h, positions)
        h = apply_norm(h, params["final_norm"], cfg.norm_style, cfg.norm_eps)
        return h, torch.zeros((), dtype=torch.float32, device=h.device)

    def forward(self, params, tokens, prefix_embeds=None):
        h, aux = self.hidden_states(params, tokens)
        return lm_logits(params["embed"], h, self.cfg.tie_embeddings), aux

    def loss(self, params, batch):
        h, aux = self.hidden_states(params, batch["tokens"])
        ce = chunked_lm_loss(params["embed"], h, batch["labels"],
                             self.cfg.tie_embeddings, batch.get("loss_mask"))
        return ce + aux, {"ce": ce, "aux": aux}

    # -- decode ---------------------------------------------------------------
    def init_decode_state(self, batch: int, cache_len: int,
                          device=None) -> HybridDecodeState:
        cfg = self.cfg
        lead = (self.n_seg, self.seg_len)
        one = mamba2.init_mamba2_state(cfg, batch, cfg.torch_dtype, "meta")
        ssm = mamba2.Mamba2State(*(
            torch.zeros(lead + tuple(a.shape), dtype=a.dtype, device=device)
            for a in one))
        kv = attn_lib.init_layer_cache(cfg, batch, cache_len, self.kv_repeat,
                                       cfg.torch_dtype, device="meta")
        shared = attn_lib.LayerKVCache(*(
            torch.zeros((self.n_seg,) + tuple(a.shape), dtype=a.dtype,
                        device=device) for a in kv))
        return HybridDecodeState(
            ssm=ssm, shared_cache=shared,
            pos=torch.zeros((), dtype=torch.int32, device=device))

    def decode_step(self, params, state: HybridDecodeState, tokens):
        """tokens (B, 1) → (logits (B, 1, V), new state)."""
        cfg = self.cfg
        h = embed_tokens(params["embed"], tokens)
        pos = state.pos
        ssm = mamba2.Mamba2State(*(torch.empty_like(a) for a in state.ssm))
        sp = params["shared"]
        for s, seg in enumerate(self._segments(params)):
            for i, lp in enumerate(seg):
                x = apply_norm(h, lp["norm"], cfg.norm_style, cfg.norm_eps)
                y, _ = mamba2.mamba2_decode_step(
                    lp["mamba"], x,
                    mamba2.Mamba2State(*(a[s, i] for a in state.ssm)), cfg,
                    out=mamba2.Mamba2State(*(a[s, i] for a in ssm)))
                h = h + y
            cache = attn_lib.LayerKVCache(state.shared_cache.k[s],
                                          state.shared_cache.v[s])
            a_in = apply_norm(h, sp["attn_norm"], cfg.norm_style,
                              cfg.norm_eps)
            a_out, _ = attn_lib.attention_decode_step(
                sp["attn"], a_in, cache, pos, cfg, self.kv_repeat,
                use_kernel=self.decode_kernel)
            h = h + a_out
            m_in = apply_norm(h, sp["mlp_norm"], cfg.norm_style, cfg.norm_eps)
            h = h + apply_mlp(m_in, sp["mlp"], cfg.mlp_style)
        h = apply_norm(h, params["final_norm"], cfg.norm_style, cfg.norm_eps)
        logits = lm_logits(params["embed"], h, cfg.tie_embeddings)
        return logits, HybridDecodeState(ssm=ssm,
                                         shared_cache=state.shared_cache,
                                         pos=pos + 1)
