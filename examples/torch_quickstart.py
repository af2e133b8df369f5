"""Quickstart on the PyTorch port: the paper's pipeline in ~40 lines.

Synthetic Turkish-tweet corpus → Tablo-4 stopword removal → hashed
TF×IDF (eq. 10-11) → iterative MapReduce SVM (Tablo 1-2) → polarity,
as examples/quickstart.py.

    PYTHONPATH=src python examples/torch_quickstart.py             # cuda
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu
"""
import argparse

import numpy as np
import torch

from repro_torch.core import (MRSVMConfig, SVMConfig, confusion_matrix,
                              fit_mapreduce, predict)
from repro_torch.text import CorpusConfig, fit_transform, generate, vectorize


def main(num_messages: int = 2000, num_features: int = 4096,
         device=None) -> dict:
    """The example at the reference's sizes by default; → accuracy and
    the confusion matrix (global %)."""
    print("1) generating synthetic corpus (paper data is 2014 Twitter)...")
    corpus = generate(CorpusConfig(num_messages=num_messages,
                                   classes=(-1, 1)))
    print(f"   {len(corpus.texts)} messages, e.g.: {corpus.texts[0][:70]}...")

    print(f"2) TF×IDF vector space (hashed, {num_features} dims)...")
    X, _ = fit_transform(vectorize(corpus.texts, num_features=num_features),
                         device=device)
    y = torch.tensor(corpus.labels, dtype=torch.float32, device=X.device)

    print("3) iterative MapReduce SVM over 8 partitions...")
    cfg = MRSVMConfig(sv_capacity=256, gamma=1e-4, max_rounds=5,
                      svm=SVMConfig(C=1.0, max_epochs=15))
    model = fit_mapreduce(X, y, num_partitions=8, cfg=cfg, verbose=True)

    pred = predict(model, X, cfg)
    acc = float((pred == y).float().mean())
    cm = confusion_matrix(y, pred, [-1, 1])
    print(f"4) accuracy={acc:.3f}  (paper Tablo 6 diagonal: 85.9%)")
    print("   confusion matrix (global %, rows=truth -1/+1):")
    print(np.round(cm, 2))
    return dict(accuracy=acc, confusion=cm)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    main(device=ap.parse_args().device)
