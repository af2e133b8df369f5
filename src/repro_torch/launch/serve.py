"""Serving entry point, LM mode: the greedy single-token decode loop.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \\
        --smoke --batch 4 --tokens 16                      # on the card
    PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \\
        --smoke --tokens 4 --batch 2 --cache-len 64 --device cpu

The loop starts from a zero cache and token 0 and feeds each step's
argmax back in, as ``repro/launch/serve.py:188-218``. Every step stays
on the device: the tokens are copied to the host once, after the loop.
The svm family's streaming serve mode is not ported yet (ROADMAP Queue 1
item 8).
"""
from __future__ import annotations

import argparse
import time
from typing import NamedTuple, Optional, Sequence

import torch

from repro_torch.configs import get_config
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.launch.steps import make_serve_step
from repro_torch.models.config import ModelConfig, smoke_variant
from repro_torch.models.transformer import DecodeState, build_model


class ServeResult(NamedTuple):
    tokens: torch.Tensor      # (steps, B) int32 on the CPU
    seconds: float            # host clock over the loop, to the last token
    tok_per_s: float          # steps · B / seconds
    state: DecodeState        # after the last step (caches on the device)


def serve_lm(cfg: ModelConfig, *, batch: int, cache_len: int, tokens: int,
             device: DeviceLike = None, params=None,
             state: Optional[DecodeState] = None) -> ServeResult:
    """Greedy decode of ``tokens`` steps for ``batch`` sequences.

    ``params`` default to random ones from ``torch.Generator`` seed 0 on
    the device, ``state`` to a zero cache of ``cache_len`` at position 0
    (a given state is advanced and its caches written in place). Runs on
    ``cuda`` unless ``device`` says otherwise; raises without a card.
    """
    dev = resolve_device(device)
    model = build_model(cfg)
    if params is None:
        params = model.init(torch.Generator(device=dev).manual_seed(0))
    if state is None:
        state = model.init_decode_state(batch, cache_len, dev)
    step = make_serve_step(model)
    tok = torch.zeros((batch, 1), dtype=torch.int32, device=dev)
    out = torch.empty((tokens, batch), dtype=torch.int32, device=dev)
    t0 = time.perf_counter()
    for i in range(tokens):
        nxt, state = step(params, state, tok)
        out[i] = nxt
        tok = nxt[:, None]
    out = out.cpu()                    # waits for the last step
    dt = time.perf_counter() - t0
    return ServeResult(out, dt, tokens * batch / dt, state)


def main(argv: Optional[Sequence[str]] = None) -> ServeResult:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--cache-len", type=int, default=256)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' runs the "
                         "plain versions of the kernels)")
    args = ap.parse_args(argv)
    cfg = get_config(args.arch)
    if getattr(cfg, "family", None) == "svm":
        raise NotImplementedError(
            "the svm family's streaming serve mode is not ported to "
            "repro_torch yet (ROADMAP Queue 1 item 8)")
    if args.smoke:
        cfg = smoke_variant(cfg)
    res = serve_lm(cfg, batch=args.batch, cache_len=args.cache_len,
                   tokens=args.tokens, device=args.device)
    print(f"{cfg.name}: {args.tokens} tokens × {args.batch} seqs "
          f"in {res.seconds:.2f}s → {res.tok_per_s:,.1f} tok/s")
    return res


if __name__ == "__main__":
    main()
