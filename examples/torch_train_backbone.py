"""End-to-end training driver on the PyTorch port, as
examples/train_backbone.py: data pipeline → train step → checkpointing
→ metrics. Train a ~100M model for a few hundred steps.

The same presets, flags, checkpoint (``{"params", "opt"}`` at
``<ckpt-dir>/<name>.npz``, in the reference's file format: each package
resumes the other's), metrics JSONL (``<ckpt-dir>/<name>_metrics.jsonl``)
and final check as the reference's; ``--device`` (default cuda) picks
where it runs.

    PYTHONPATH=src python examples/torch_train_backbone.py --preset 100m --steps 300
    PYTHONPATH=src python examples/torch_train_backbone.py --steps 20 --batch 2 --seq 32 --device cpu
"""
import argparse
import os
import tempfile
import time

import torch

from repro_torch import optim
from repro_torch.ckpt import latest_step, restore, save
from repro_torch.data import DataConfig, lm_batch_at
from repro_torch.device import resolve_device
from repro_torch.launch.steps import InputShape, build_train_step
from repro_torch.metrics import MetricsLogger
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import tree_leaves

PRESETS = {
    # ~20M params: CPU-demo scale
    "20m": ModelConfig(name="demo-20m", family="dense", num_layers=6,
                       d_model=384, num_heads=6, num_kv_heads=2, d_ff=1024,
                       vocab_size=8192, tie_embeddings=True),
    # ~100M params: the deliverable scale (llama-style)
    "100m": ModelConfig(name="demo-100m", family="dense", num_layers=10,
                        d_model=640, num_heads=10, num_kv_heads=2, d_ff=2560,
                        vocab_size=32000, tie_embeddings=False),
}


def main(argv=None) -> dict:
    """→ the run's start step, first and final logged loss, tok/s, and
    its final params and optimizer state."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="20m", choices=list(PRESETS))
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(), "repro_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' runs there)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = PRESETS[args.preset]
    ocfg = optim.OptConfig(lr=args.lr, warmup_steps=20,
                           total_steps=args.steps)
    bundle = build_train_step(cfg, None,
                              InputShape("backbone", "train", args.seq,
                                         args.batch),
                              opt_cfg=ocfg, remat=False)
    n_params = sum(x.numel() for x in tree_leaves(bundle.args[0]))
    print(f"model={cfg.name} params={n_params / 1e6:.1f}M device={dev}")

    params = bundle.model.init(torch.Generator(device=dev).manual_seed(0))
    opt_state = optim.init(params)
    dcfg = DataConfig(batch_size=args.batch, seq_len=args.seq, seed=0)
    start = 0
    ckpt_path = os.path.join(args.ckpt_dir, f"{cfg.name}.npz")
    if args.resume and os.path.exists(ckpt_path):
        state = restore(ckpt_path, {"params": params, "opt": opt_state},
                        device=dev)
        params, opt_state = state["params"], state["opt"]
        start = latest_step(args.ckpt_dir) or 0
        print(f"resumed from step {start}")

    t0 = time.time()
    first_loss = None
    mlog = MetricsLogger(args.ckpt_dir, f"{cfg.name}_metrics")
    for step in range(start, start + args.steps):
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in lm_batch_at(dcfg, cfg, step).items()}
        params, opt_state, m = bundle.fn(params, opt_state, batch)
        mlog.log(step, loss=float(m["loss"]), lr=float(m["lr"]),
                 grad_norm=float(m["grad_norm"]))
        if step % 20 == 0 or step == start + args.steps - 1:
            loss = float(m["loss"])
            first_loss = first_loss if first_loss is not None else loss
            tok_s = (step - start + 1) * args.batch * args.seq / \
                (time.time() - t0)
            print(f"step {step:5d}  loss {loss:.4f}  "
                  f"lr {float(m['lr']):.2e}  gnorm {float(m['grad_norm']):.2f}  "
                  f"tok/s {tok_s:,.0f}")
        if args.ckpt_every and (step + 1) % args.ckpt_every == 0:
            save(ckpt_path, {"params": params, "opt": opt_state},
                 step=step + 1)
    final_loss = float(m["loss"])
    save(ckpt_path, {"params": params, "opt": opt_state},
         step=start + args.steps)
    mlog.flush()
    secs = time.time() - t0
    print(f"done: loss {first_loss:.3f} → {final_loss:.3f} "
          f"({secs:.0f}s); ckpt at {ckpt_path}; "
          f"metrics {mlog.summary('loss')}")
    assert final_loss < first_loss, "training did not reduce loss"
    return {"start": start, "first_loss": first_loss,
            "final_loss": final_loss,
            "tok_s": args.steps * args.batch * args.seq / secs,
            "ckpt": ckpt_path, "params": params, "opt": opt_state}


if __name__ == "__main__":
    main()
