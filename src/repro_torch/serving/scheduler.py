"""Wave-based batch scheduler for the decode path, ported from
``repro/serving/scheduler.py``.

The decode API keeps one shared position per batch, so the scheduler
batches at wave granularity:

  queue → admit ≤ B requests → right-align prompts into the wave →
  teacher-forced prefill through ``decode_step`` → greedy decode until
  every slot hits EOS or its token budget → emit, admit the next wave.

Right-alignment (pad LEFT) lets one shared position serve ragged
prompts: every prompt ends at the same step, so generation starts at
once for all slots (the pads do enter the cache: the reference's
static-batching approximation). Each step runs the model's
``decode_step`` directly, its cache attention in the ``flash_decode``
kernel on the card, and takes the greedy token by ``argmax`` there; the
host reads the wave's tokens once a step, to stop slots at their EOS.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.layers import tree_map


@dataclasses.dataclass
class Request:
    uid: int
    prompt: List[int]
    max_new_tokens: int = 32
    eos_id: Optional[int] = None
    # filled by the scheduler:
    output: Optional[List[int]] = None
    latency_s: float = 0.0


@dataclasses.dataclass
class WaveStats:
    wave: int
    batch: int
    prompt_steps: int
    decode_steps: int
    wall_s: float

    @property
    def tokens_per_s(self) -> float:
        return self.batch * self.decode_steps / max(self.wall_s, 1e-9)


class BatchScheduler:
    """Drives ``model.decode_step`` over a queue of requests on
    ``device`` (default ``cuda``; raises without a card). ``params``
    are moved there if they are elsewhere. An encoder-decoder's
    ``frames`` (batch_size, encoder_seq, D) are encoded into each wave's
    cross K/V, as the reference's."""

    def __init__(self, model, params, batch_size: int, cache_len: int,
                 pad_id: int = 0, frames: Optional[torch.Tensor] = None,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.model = model
        self.params = tree_map(lambda w: w.to(self.device), params)
        self.frames = None if frames is None else frames.to(self.device)
        self.B = batch_size
        self.cache_len = cache_len
        self.pad_id = pad_id
        self.queue: List[Request] = []
        self.done: List[Request] = []
        self.stats: List[WaveStats] = []

    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def run(self) -> List[Request]:
        wave = 0
        while self.queue:
            batch = self.queue[: self.B]
            self.queue = self.queue[self.B:]
            self._run_wave(wave, batch)
            wave += 1
        return self.done

    # ------------------------------------------------------------------
    def _greedy(self, logits: torch.Tensor) -> torch.Tensor:
        """(B, 1) int32 argmax of the last logits, on the card (ties to
        the first index, as ``jnp.argmax``)."""
        return torch.argmax(logits[:, -1:, :], dim=-1).to(torch.int32)

    def _run_wave(self, wave: int, batch: List[Request]) -> None:
        t0 = time.perf_counter()
        B = self.B
        max_prompt = max(len(r.prompt) for r in batch)
        max_new = max(r.max_new_tokens for r in batch)
        if max_prompt + max_new > self.cache_len:
            raise ValueError(f"wave needs {max_prompt + max_new} cache "
                             f"slots, the cache holds {self.cache_len}")

        # right-aligned prompt matrix (left pad)
        toks = np.full((B, max_prompt), self.pad_id, np.int32)
        for j, r in enumerate(batch):
            toks[j, max_prompt - len(r.prompt):] = r.prompt
        toks = torch.from_numpy(toks).to(self.device)

        if self.frames is not None:
            state = self.model.init_decode_state(
                B, self.cache_len, self.device, frames=self.frames,
                params=self.params)
        else:
            state = self.model.init_decode_state(B, self.cache_len,
                                                 self.device)
        # prefill (teacher forced through the decode path)
        logits = None
        for t in range(max_prompt):
            logits, state = self.model.decode_step(self.params, state,
                                                   toks[:, t:t + 1])

        # greedy decode with per-slot completion tracking
        out = [[] for _ in batch]
        live = np.array([True] * B)
        live[len(batch):] = False
        done_at: List[Optional[float]] = [None] * B  # a slot's EOS step
        tok = self._greedy(logits)
        steps = 0
        while live.any() and steps < max_new:
            tok_np = tok[:, 0].cpu().numpy()
            now = time.perf_counter()
            for j, r in enumerate(batch):
                if live[j]:
                    out[j].append(int(tok_np[j]))
                    if (r.eos_id is not None and tok_np[j] == r.eos_id) \
                            or len(out[j]) >= r.max_new_tokens:
                        live[j] = False
                        done_at[j] = now
            if not live.any():
                break
            logits, state = self.model.decode_step(self.params, state, tok)
            tok = self._greedy(logits)
            steps += 1

        wall = time.perf_counter() - t0
        for j, r in enumerate(batch):
            r.output = out[j]
            # per-slot latency: a request is done at its own EOS step, not
            # when the whole wave drains
            r.latency_s = wall if done_at[j] is None else done_at[j] - t0
            self.done.append(r)
        self.stats.append(WaveStats(wave=wave, batch=len(batch),
                                    prompt_steps=max_prompt,
                                    decode_steps=steps + 1, wall_s=wall))

    def throughput_report(self) -> Dict[str, float]:
        total_tok = sum(len(r.output or []) for r in self.done)
        total_s = sum(s.wall_s for s in self.stats)
        lats = [r.latency_s for r in self.done]
        return {"requests": len(self.done), "tokens": total_tok,
                "wall_s": round(total_s, 3),
                "tok_per_s": round(total_tok / max(total_s, 1e-9), 1),
                "mean_latency_s": (round(float(np.mean(lats)), 4)
                                   if lats else 0.0),
                "waves": len(self.stats)}
