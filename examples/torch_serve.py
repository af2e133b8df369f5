"""Batched serving demo on the PyTorch port: prefill a batch of prompts,
then decode with the KV-cache serve path (greedy), reporting tokens/s,
as examples/serve.py.

    PYTHONPATH=src python examples/torch_serve.py --arch llama3-8b      # cuda
    PYTHONPATH=src python examples/torch_serve.py --device cpu --tokens 8
(archs run as REDUCED smoke variants; full widths run through
``python -m repro_torch.launch.serve --arch ...`` on the card.)
"""
import argparse
import time

import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.models import build_model, smoke_variant


def main(arch: str = "tinyllama-1.1b", batch: int = 4, prompt_len: int = 16,
         tokens: int = 32, cache_len: int = 128, device=None) -> dict:
    """→ the generated tokens (B, tokens) on the CPU and tok/s."""
    dev = resolve_device(device)
    cfg = smoke_variant(get_config(arch))
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    B = batch
    print(f"serving {cfg.name} (reduced) batch={B} cache={cache_len} on {dev}")

    prompts = torch.randint(0, cfg.vocab_size, (B, prompt_len),
                            generator=torch.Generator(device=dev).manual_seed(1),
                            device=dev, dtype=torch.int32)
    if cfg.family == "audio":
        raise NotImplementedError(
            "encoder frames (the audio family) are not ported to repro_torch "
            "yet (ROADMAP Queue 1 item 13f)")
    state = model.init_decode_state(B, cache_len, dev)

    # teacher-forced prefill through the decode path, as the reference
    for t in range(prompt_len):
        logits, state = model.decode_step(params, state, prompts[:, t:t + 1])

    tok = logits[:, -1:, :].argmax(-1).to(torch.int32)
    out = [tok]
    t0 = time.perf_counter()
    for _ in range(tokens - 1):
        logits, state = model.decode_step(params, state, tok)
        tok = logits[:, -1:, :].argmax(-1).to(torch.int32)
        out.append(tok)
    gen = torch.cat(out, dim=1).cpu()        # waits for the last step
    dt = time.perf_counter() - t0
    print(f"generated {tokens} tokens × {B} seqs in {dt:.2f}s "
          f"→ {tokens * B / dt:,.0f} tok/s")
    print("sample token ids:", gen[0, :16].tolist())
    assert int(state.pos) == prompt_len + tokens - 1
    return dict(tokens=gen, tok_per_s=tokens * B / dt)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--cache-len", type=int, default=128)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    a = ap.parse_args()
    main(a.arch, a.batch, a.prompt_len, a.tokens, a.cache_len, a.device)
