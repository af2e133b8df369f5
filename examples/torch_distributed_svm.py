"""The paper's system in its production form on the PyTorch port:
MapReduce-SVM rounds with the dataset rows sharded over W ranks of a
``torch.distributed`` group (one process a rank) and the SV merge as a
collective (the "shuffle"): all-gather, the ring, or the two-level hier
transport.

    PYTHONPATH=src python examples/torch_distributed_svm.py          # cuda
    PYTHONPATH=src python examples/torch_distributed_svm.py --device cpu
    PYTHONPATH=src python examples/torch_distributed_svm.py --device cpu \\
        --ranks 4 --shuffle ring

With one card the ranks share it over gloo; NCCL is used when each rank
has a card of its own (``repro_torch.compat.choose_backend``).
"""
import argparse

import numpy as np
import torch

import repro_torch.core as T
from repro_torch import compat
from repro_torch.launch.sharded import fit_sharded
from repro_torch.text import CorpusConfig, fit_transform, generate, vectorize


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ranks", type=int, default=8)
    ap.add_argument("--shuffle", default="allgather",
                    choices=T.SHUFFLE_IMPLS)
    args = ap.parse_args()
    corpus = generate(CorpusConfig(num_messages=2048, classes=(-1, 1)))
    X, _ = fit_transform(vectorize(corpus.texts, 2048), device="cpu")
    X = X.numpy()
    y = np.asarray(corpus.labels, np.float32)
    n, d = X.shape
    W = args.ranks
    print(f"{n} rows × {d} features over {W} ranks ({n // W} rows/rank, "
          f"{args.device}, {args.shuffle} merge)")

    cfg = T.MRSVMConfig(sv_capacity=256, gamma=1e-4, max_rounds=6,
                        shuffle_impl=args.shuffle,
                        hier_num_hosts=2 if args.shuffle == "hier" else None,
                        svm=T.SVMConfig(C=1.0, max_epochs=15))
    out = compat.spawn(fit_sharded, W, (X, y, cfg), device=args.device)[0]
    hist = out["history"]
    for h in hist:
        print(f"round {h['round']}: R_emp={h['risk']:.4f} "
              f"|SV|={h['sv_count']} (merged {W} reducers)")
    if len(hist) < cfg.max_rounds:
        print("eq. 8 convergence")
    w = torch.from_numpy(out["w"])
    acc = float(((torch.from_numpy(X) @ w + out["b"]).sign()
                 == torch.from_numpy(y)).float().mean())
    print(f"best-reducer hypothesis accuracy: {acc:.3f}")


if __name__ == "__main__":
    main()
