"""Model selection the paper's way, batched, on the PyTorch port: train
many (C, tol) SVM variants over the TF×IDF polarization pipeline as one
sweep (one solve launch a round for every config and partition,
repro_torch.core.sweep), then pick the config with the lowest empirical
risk and report its Tablo-6-style confusion matrix.

    PYTHONPATH=src python examples/torch_sweep_select.py            # cuda
    PYTHONPATH=src python examples/torch_sweep_select.py --device cpu
"""
import argparse

import numpy as np
import torch

import repro_torch.core as T
from repro_torch.text import CorpusConfig, fit_transform, generate, vectorize


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    corpus = generate(CorpusConfig(num_messages=2048, classes=(-1, 1)))
    X, _ = fit_transform(vectorize(corpus.texts, 2048), device=args.device)
    y = torch.tensor(corpus.labels, dtype=torch.float32, device=X.device)
    n_train = int(0.75 * X.shape[0])
    X_tr, y_tr = X[:n_train], y[:n_train]
    X_te, y_te = X[n_train:], y[n_train:]

    cfg = T.MRSVMConfig(sv_capacity=256, gamma=1e-4, max_rounds=5,
                        svm=T.SVMConfig(max_epochs=15))
    params = T.sweep_grid(cfg.svm, C=np.logspace(-3, 1, 5), tol=[1e-3, 1e-2])
    S = params.C.shape[0]
    print(f"sweeping {S} (C, tol) configs as one batch ({n_train} train "
          f"rows, {X.shape[1]} features, {X.device})")

    res = T.fit_mapreduce_sweep(X_tr, y_tr, 8, cfg, params, verbose=True)
    preds = T.predict_sweep(res, X_te, cfg)
    accs = (preds == y_te[None, :]).float().mean(1).cpu().numpy()
    for s in range(S):
        tag = " ← selected" if s == res.best else ""
        print(f"  C={float(params.C[s]):<9.4g} tol={float(params.tol[s]):<7.0e}"
              f" R_emp={float(res.risks[s]):.4f} "
              f"held-out acc={accs[s]:.3f} rounds={int(res.rounds[s])}{tag}")

    cm = T.confusion_matrix(y_te, preds[res.best], [-1, 1])
    print("\nconfusion matrix of the selected config "
          "(global %, Tablo 6 convention):")
    print(np.round(cm, 2))
    print("\nrow-normalized (per-class recall %):")
    print(np.round(T.confusion_matrix(y_te, preds[res.best], [-1, 1],
                                      normalize="true"), 2))


if __name__ == "__main__":
    main()
