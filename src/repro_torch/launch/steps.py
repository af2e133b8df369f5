"""Step builders. Only the serve step is ported: one greedy decode
step of the dense decoder (``repro/launch/steps.py:160-170``).

The reference's shape suite names ``decode_32k`` (seq 32768, global
batch 128); the train and prefill steps wait for ROADMAP Queue 1 item
13c, shardings and abstract inputs for 13g.
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch

from repro_torch.models.transformer import DecodeState, TransformerModel


def make_serve_step(model: TransformerModel) -> Callable[
        ..., Tuple[torch.Tensor, DecodeState]]:
    """→ ``serve_step(params, state, tokens (B, 1))`` returning the next
    tokens (B,) int32 (argmax of the last logits; ties go to the first
    index, as ``jnp.argmax``) and the new state."""
    def serve_step(params, state: DecodeState, tokens: torch.Tensor):
        logits, state = model.decode_step(params, state, tokens)
        next_tok = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
        return next_tok, state
    return serve_step
