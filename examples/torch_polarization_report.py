"""The paper's full application on the PyTorch port: university polarity
report (Tablo 6-9), as examples/polarization_report.py.

Trains both the 2-class and 3-class models and prints paper-style
tables: confusion matrices + top-10 university rankings by message
count, positive rate, and negative rate.

    PYTHONPATH=src python examples/torch_polarization_report.py     # cuda
    PYTHONPATH=src python examples/torch_polarization_report.py --device cpu
"""
import argparse

import numpy as np
import torch

from repro_torch.core import (MRSVMConfig, SVMConfig, confusion_matrix,
                              fit_mapreduce, fit_one_vs_rest, predict)
from repro_torch.text import CorpusConfig, fit_transform, generate, vectorize


def _features(corpus, num_features: int, device):
    X, _ = fit_transform(vectorize(corpus.texts, num_features), device=device)
    return X, torch.tensor(corpus.labels, dtype=torch.float32,
                           device=X.device)


def report_two_class(num_messages: int = 3000, num_features: int = 4096,
                     device=None):
    """→ (corpus, predictions (numpy), confusion matrix (global %))."""
    print("=" * 64)
    print("İki Sınıflı Model (2-class: Olumlu/Olumsuz)")
    print("=" * 64)
    corpus = generate(CorpusConfig(num_messages=num_messages,
                                   classes=(-1, 1)))
    X, y = _features(corpus, num_features, device)
    cfg = MRSVMConfig(sv_capacity=256, gamma=1e-4, max_rounds=4,
                      svm=SVMConfig(C=1.0, max_epochs=15))
    model = fit_mapreduce(X, y, num_partitions=8, cfg=cfg)
    pred = predict(model, X, cfg).cpu().numpy()
    cm = confusion_matrix(y, pred, [-1, 1])
    print("\nTablo 6 analogue — confusion (global %):")
    print("            pred -1   pred +1")
    for i, c in enumerate([-1, 1]):
        print(f"  true {c:+d}   {cm[i, 0]:7.2f}   {cm[i, 1]:7.2f}")
    print(f"  diagonal: {np.trace(cm):.2f}%  (paper: 85.92%)")

    print("\nTablo 7 analogue — top-10 universities by message count:")
    _ranking(corpus, pred, two_class=True)
    return corpus, pred, cm


def report_three_class(num_messages: int = 3000, num_features: int = 4096,
                       device=None):
    """→ (corpus, predictions (numpy), confusion matrix (global %))."""
    print("\n" + "=" * 64)
    print("Üç Sınıflı Model (3-class: Olumlu/Olumsuz/Nötr)")
    print("=" * 64)
    corpus = generate(CorpusConfig(num_messages=num_messages,
                                   classes=(-1, 0, 1), seed=1))
    X, y = _features(corpus, num_features, device)
    cfg = MRSVMConfig(sv_capacity=256, max_rounds=3,
                      svm=SVMConfig(C=1.0, max_epochs=15))
    ovr = fit_one_vs_rest(X, y, [-1, 0, 1], 8, cfg)
    pred = ovr.predict(X).cpu().numpy()
    cm = confusion_matrix(y, pred, [-1, 0, 1])
    print("\nTablo 8 analogue — confusion (global %):")
    print("            pred -1   pred  0   pred +1")
    for i, c in enumerate([-1, 0, 1]):
        print(f"  true {c:+d}   {cm[i, 0]:7.2f}   {cm[i, 1]:7.2f}"
              f"   {cm[i, 2]:7.2f}")
    print(f"  diagonal: {np.trace(cm):.2f}%  (paper: 68.38%)")
    print("\nTablo 9 analogue — top-10 universities:")
    _ranking(corpus, pred, two_class=False)
    return corpus, pred, cm


def _ranking(corpus, pred, two_class: bool):
    rows = []
    for u, name in enumerate(corpus.university_names):
        sel = corpus.universities == u
        n = int(sel.sum())
        if n == 0:
            continue
        kind = "devlet" if corpus.university_kinds[u] == 0 else "vakıf"
        pos = float((pred[sel] > 0).mean())
        neg = float((pred[sel] < 0).mean())
        neu = float((pred[sel] == 0).mean()) if not two_class else None
        rows.append((n, name, kind, pos, neu, neg))
    rows.sort(key=lambda r: -r[0])
    hdr = f"  {'university':<28} {'kind':<7} {'n':>4}  {'pos':>5}"
    hdr += f"  {'neu':>5}" if not two_class else ""
    hdr += f"  {'neg':>5}"
    print(hdr)
    for n, name, kind, pos, neu, neg in rows[:10]:
        line = f"  {name[:28]:<28} {kind:<7} {n:>4}  {pos:5.2f}"
        line += f"  {neu:5.2f}" if neu is not None else ""
        line += f"  {neg:5.2f}"
        print(line)


def main(num_messages: int = 3000, num_features: int = 4096,
         device=None) -> dict:
    """Both reports; → their confusion matrices (global %)."""
    two = report_two_class(num_messages, num_features, device)[2]
    three = report_three_class(num_messages, num_features, device)[2]
    return dict(two_class=two, three_class=three)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    main(device=ap.parse_args().device)
