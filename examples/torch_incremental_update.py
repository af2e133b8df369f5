"""The paper's stated future work (§SONUÇ) on the PyTorch port: keep the
classifier current as message content drifts, by retraining on (new
batch ∪ old SVs) only, as examples/incremental_update.py.

    PYTHONPATH=src python examples/torch_incremental_update.py      # cuda
    PYTHONPATH=src python examples/torch_incremental_update.py --device cpu
"""
import argparse

import torch

from repro_torch.core import (MRSVMConfig, SVMConfig, fit_mapreduce, predict,
                              update_mapreduce)
from repro_torch.text import (CorpusConfig, fit_transform, generate,
                              transform, vectorize)


def _acc(model, X, y, cfg) -> float:
    return float((predict(model, X, cfg) == y).float().mean())


def main(initial_messages: int = 1500, month_messages: int = 1000,
         num_features: int = 4096, device=None) -> dict:
    """The example at the reference's sizes by default; → the month-0
    accuracy and each month's (stale, updated) accuracies."""
    cfg = MRSVMConfig(sv_capacity=256, gamma=1e-4, max_rounds=4,
                      svm=SVMConfig(C=1.0, max_epochs=15))

    print("month 0: train on the initial corpus")
    c0 = generate(CorpusConfig(num_messages=initial_messages,
                               classes=(-1, 1), seed=0))
    X0, idf = fit_transform(vectorize(c0.texts, num_features), device=device)
    y0 = torch.tensor(c0.labels, dtype=torch.float32, device=X0.device)
    model = fit_mapreduce(X0, y0, 8, cfg)
    acc0 = _acc(model, X0, y0, cfg)
    print(f"  acc={acc0:.3f} |SV|={int(model.sv.mask.sum())}")

    months = []
    for month in (1, 2):
        cm = generate(CorpusConfig(num_messages=month_messages,
                                   classes=(-1, 1), seed=100 + month))
        Xm = transform(vectorize(cm.texts, num_features), idf,
                       device=X0.device)
        ym = torch.tensor(cm.labels, dtype=torch.float32, device=X0.device)
        stale = _acc(model, Xm, ym, cfg)
        model = update_mapreduce(model, Xm, ym, 8, cfg)
        fresh = _acc(model, Xm, ym, cfg)
        months.append((stale, fresh))
        print(f"month {month}: stale acc={stale:.3f} → updated acc={fresh:.3f} "
              f"(update saw {Xm.shape[0]} new rows + "
              f"{int(model.sv.mask.sum())} carried SVs, not the old corpus)")
    return dict(initial=acc0, months=months)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    main(device=ap.parse_args().device)
