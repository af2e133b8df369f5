"""Whisper-style encoder-decoder (the audio family), ported from
``repro/models/encdec.py``.

The mel-spectrogram and conv feature extractor is a stub, as in the
reference: the caller hands in frame embeddings (B, encoder_seq,
d_model). The transformer is whole: a bidirectional encoder (sinusoidal
positions), a causal decoder with cross-attention (learned positions,
``dec_pos``), GELU MLPs, LayerNorms, biased projections.

    model = EncDecModel(cfg)
    enc = model.encode(params, frames)
    h, aux = model.hidden_states(params, tokens, enc)
    logits, aux = model.forward(params, tokens, frames)
    loss, metrics = model.loss(params, {"frames", "tokens", "labels"})
    state = model.init_decode_state(B, cache_len, device, frames=, params=)
    logits, state = model.decode_step(params, state, tokens)

``decode_kernel`` routes the decoder's self-attention over its cache
through ``ops.decode_attention`` (the ``flash_decode`` kernel on the
card); the cross-attention step over the encoder's K/V has no kernel in
the reference and is plain PyTorch here. The self-attention caches are
written in place.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from repro_torch.models import attention as attn_lib
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (PSpec, apply_mlp, apply_norm,
                                       chunked_lm_loss, embed_template,
                                       embed_tokens, lm_logits, mlp_template,
                                       norm_template)
from repro_torch.models.transformer import (TemplateModel, stack_template,
                                            unstack_layers)


def sinusoidal_positions(length: int, d: int, device=None) -> torch.Tensor:
    """(length, d) float32: sin over the first d/2 columns, cos over the
    rest, at angles pos / 10000^(2i/d)."""
    pos = torch.arange(length, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / torch.pow(10000.0, 2 * dim / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


class EncDecDecodeState(NamedTuple):
    self_cache: attn_lib.LayerKVCache  # (L, B, KVr, S, hd)
    cross_k: torch.Tensor              # (L, B, KVr, T_enc, hd)
    cross_v: torch.Tensor
    pos: torch.Tensor                  # () int32 on the device


class EncDecModel(TemplateModel):
    def __init__(self, cfg: ModelConfig, kv_repeat: int = 1,
                 decode_kernel: bool = True):
        self.cfg = cfg
        self.kv_repeat = kv_repeat
        self.decode_kernel = decode_kernel

    # -- parameters -----------------------------------------------------------
    def template(self):
        cfg = self.cfg
        enc_layer = {
            "attn_norm": norm_template(cfg.d_model, "layernorm"),
            "attn": attn_lib.attn_template(cfg),
            "mlp_norm": norm_template(cfg.d_model, "layernorm"),
            "mlp": mlp_template(cfg.d_model, cfg.d_ff, "gelu"),
        }
        dec_layer = {
            "self_norm": norm_template(cfg.d_model, "layernorm"),
            "self_attn": attn_lib.attn_template(cfg),
            "cross_norm": norm_template(cfg.d_model, "layernorm"),
            "cross_attn": attn_lib.attn_template(cfg),
            "mlp_norm": norm_template(cfg.d_model, "layernorm"),
            "mlp": mlp_template(cfg.d_model, cfg.d_ff, "gelu"),
        }
        return {
            "embed": embed_template(cfg.vocab_size, cfg.d_model,
                                    cfg.tie_embeddings),
            "dec_pos": PSpec((cfg.max_decoder_len, cfg.d_model),
                             (None, "embed"), "normal"),
            "enc_layers": stack_template(enc_layer, cfg.encoder_layers),
            "enc_norm": norm_template(cfg.d_model, "layernorm"),
            "dec_layers": stack_template(dec_layer, cfg.num_layers),
            "final_norm": norm_template(cfg.d_model, "layernorm"),
        }

    # -- encoder ---------------------------------------------------------------
    def _enc_layer(self, lp, h, positions):
        cfg = self.cfg
        a_in = apply_norm(h, lp["attn_norm"], "layernorm", cfg.norm_eps)
        h = h + attn_lib.attention(lp["attn"], a_in, cfg, positions=positions,
                                   causal=False, kv_repeat=self.kv_repeat)
        m_in = apply_norm(h, lp["mlp_norm"], "layernorm", cfg.norm_eps)
        return h + apply_mlp(m_in, lp["mlp"], "gelu")

    def encode(self, params, frames: torch.Tensor) -> torch.Tensor:
        """frames: (B, T_enc, D) stub embeddings → encoder states, the
        bidirectional encoder over sinusoidal positions."""
        cfg = self.cfg
        B, T, D = frames.shape
        h = frames + sinusoidal_positions(T, D, frames.device)[None].to(
            frames.dtype)
        positions = torch.arange(T, device=h.device)[None].expand(B, T)
        for lp in unstack_layers(params["enc_layers"], cfg.encoder_layers):
            h = self._run(self._enc_layer, lp, h, positions)
        return apply_norm(h, params["enc_norm"], "layernorm", cfg.norm_eps)

    # -- decoder (training / scoring) -------------------------------------------
    def _dec_layer(self, lp, h, positions, enc_out, enc_pos):
        cfg = self.cfg
        a_in = apply_norm(h, lp["self_norm"], "layernorm", cfg.norm_eps)
        h = h + attn_lib.attention(lp["self_attn"], a_in, cfg,
                                   positions=positions,
                                   kv_repeat=self.kv_repeat)
        c_in = apply_norm(h, lp["cross_norm"], "layernorm", cfg.norm_eps)
        h = h + attn_lib.attention(lp["cross_attn"], c_in, cfg,
                                   positions=positions, causal=False,
                                   kv_x=enc_out, kv_positions=enc_pos,
                                   kv_repeat=self.kv_repeat)
        m_in = apply_norm(h, lp["mlp_norm"], "layernorm", cfg.norm_eps)
        return h + apply_mlp(m_in, lp["mlp"], "gelu")

    def hidden_states(self, params, tokens, enc_out):
        """tokens (B, S ≤ max_decoder_len), enc_out (B, T_enc, D) →
        (hidden (B, S, D), aux () f32 zero)."""
        cfg = self.cfg
        B, S = tokens.shape
        h = embed_tokens(params["embed"], tokens)
        h = h + params["dec_pos"][:S][None].to(h.dtype)
        positions = torch.arange(S, device=h.device)[None].expand(B, S)
        T_enc = enc_out.shape[1]
        enc_pos = torch.arange(T_enc, device=h.device)[None].expand(B, T_enc)
        for lp in unstack_layers(params["dec_layers"], cfg.num_layers):
            h = self._run(self._dec_layer, lp, h, positions, enc_out, enc_pos)
        h = apply_norm(h, params["final_norm"], "layernorm", cfg.norm_eps)
        return h, torch.zeros((), dtype=torch.float32, device=h.device)

    def forward(self, params, tokens, frames):
        """Encode ``frames``, then the decoder over ``tokens`` → (logits
        (B, S, V), aux)."""
        h, aux = self.hidden_states(params, tokens,
                                    self.encode(params, frames))
        return lm_logits(params["embed"], h, self.cfg.tie_embeddings), aux

    def loss(self, params, batch):
        enc_out = self.encode(params, batch["frames"])
        h, aux = self.hidden_states(params, batch["tokens"], enc_out)
        ce = chunked_lm_loss(params["embed"], h, batch["labels"],
                             self.cfg.tie_embeddings, batch.get("loss_mask"))
        return ce + aux, {"ce": ce, "aux": aux}

    # -- decode ---------------------------------------------------------------
    def _cross_kv(self, params, enc_out):
        """Each decoder layer's cross K/V of the encoder states → (k, v),
        each (L, B, KVr, T_enc, hd)."""
        cfg = self.cfg
        ks, vs = [], []
        for lp in unstack_layers(params["dec_layers"], cfg.num_layers):
            ca = lp["cross_attn"]
            k = attn_lib._proj(enc_out, ca["wk"])          # (B,T,KV,hd)
            v = attn_lib._proj(enc_out, ca["wv"])
            if cfg.qkv_bias:
                k, v = k + ca["bk"], v + ca["bv"]
            if self.kv_repeat > 1:
                k = torch.repeat_interleave(k, self.kv_repeat, dim=2)
                v = torch.repeat_interleave(v, self.kv_repeat, dim=2)
            ks.append(k.transpose(1, 2))
            vs.append(v.transpose(1, 2))
        return torch.stack(ks), torch.stack(vs)

    def init_decode_state(self, batch: int, cache_len: int, device=None,
                          frames: Optional[torch.Tensor] = None,
                          params=None) -> EncDecDecodeState:
        """Zero self-attention caches at position 0, and the cross K/V of
        ``frames`` encoded with ``params`` (zeros without them)."""
        cfg = self.cfg
        one = attn_lib.init_layer_cache(cfg, batch, cache_len, self.kv_repeat,
                                        cfg.torch_dtype, device="meta")
        caches = attn_lib.LayerKVCache(*(
            torch.zeros((cfg.num_layers,) + tuple(a.shape), dtype=a.dtype,
                        device=device) for a in one))
        if frames is not None and params is not None:
            ck, cv = self._cross_kv(params, self.encode(params, frames))
        else:
            KVr = cfg.num_kv_heads * self.kv_repeat
            shape = (cfg.num_layers, batch, KVr, cfg.encoder_seq, cfg.hd)
            ck, cv = (torch.zeros(shape, dtype=cfg.torch_dtype, device=device)
                      for _ in range(2))
        return EncDecDecodeState(
            self_cache=caches, cross_k=ck, cross_v=cv,
            pos=torch.zeros((), dtype=torch.int32, device=caches.k.device))

    def _cross_step(self, lp, x, ck, cv):
        """Single-token cross-attention against precomputed encoder K/V:
        scores in the activation dtype, widened, softmax in f32 over
        scores / √hd, cast back before the PV product."""
        cfg = self.cfg
        B = x.shape[0]
        H, hd = cfg.num_heads, cfg.hd
        q = attn_lib._proj(x, lp["cross_attn"]["wq"])       # (B,1,H,hd)
        if cfg.qkv_bias:
            q = q + lp["cross_attn"]["bq"]
        KVr = ck.shape[1]
        qg = q.reshape(B, KVr, H // KVr, hd)
        scores = torch.einsum("bkgh,bkth->bkgt", qg, ck).float()
        probs = torch.softmax(scores / math.sqrt(hd), dim=-1).to(x.dtype)
        out = torch.einsum("bkgt,bkth->bkgh", probs, cv).reshape(B, 1, H * hd)
        return out @ lp["cross_attn"]["wo"].reshape(H * hd, -1)

    def decode_step(self, params, state: EncDecDecodeState, tokens):
        """tokens (B, 1) → (logits (B, 1, V), new state). ``dec_pos`` is
        read at min(pos, max_decoder_len − 1), on the device."""
        cfg = self.cfg
        pos = state.pos
        h = embed_tokens(params["embed"], tokens)
        row = pos.clamp(max=cfg.max_decoder_len - 1).reshape(1).long()
        h = h + params["dec_pos"].index_select(0, row)[None].to(h.dtype)
        for i, lp in enumerate(unstack_layers(params["dec_layers"],
                                              cfg.num_layers)):
            cache = attn_lib.LayerKVCache(state.self_cache.k[i],
                                          state.self_cache.v[i])
            a_in = apply_norm(h, lp["self_norm"], "layernorm", cfg.norm_eps)
            a_out, _ = attn_lib.attention_decode_step(
                lp["self_attn"], a_in, cache, pos, cfg, self.kv_repeat,
                use_kernel=self.decode_kernel)
            h = h + a_out
            c_in = apply_norm(h, lp["cross_norm"], "layernorm", cfg.norm_eps)
            h = h + self._cross_step(lp, c_in, state.cross_k[i],
                                     state.cross_v[i])
            m_in = apply_norm(h, lp["mlp_norm"], "layernorm", cfg.norm_eps)
            h = h + apply_mlp(m_in, lp["mlp"], "gelu")
        h = apply_norm(h, params["final_norm"], "layernorm", cfg.norm_eps)
        logits = lm_logits(params["embed"], h, cfg.tie_embeddings)
        return logits, state._replace(pos=pos + 1)
