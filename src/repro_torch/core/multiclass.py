"""Multi-class wrappers over the binary MapReduce SVM.

The paper builds a 2-class (Olumlu/Olumsuz) and a 3-class
(Olumlu/Olumsuz/Nötr, labels {-1, 0, +1}) model. Binary SVMs extend to
k classes via one-vs-rest (default) or one-vs-one voting.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.mapreduce_svm import (MapReduceSVM, MRSVMConfig,
                                            decision_values, fit_mapreduce)
from repro_torch.device import DeviceLike, as_tensor, resolve_device


@dataclasses.dataclass
class OneVsRestSVM:
    classes: Tuple[int, ...]
    models: Dict[int, MapReduceSVM]
    cfg: MRSVMConfig

    def decision_matrix(self, X, device: DeviceLike = None) -> torch.Tensor:
        cols = [decision_values(self.models[c], X, self.cfg, device=device)
                for c in self.classes]
        return torch.stack(cols, 1)                           # (n, k)

    def predict(self, X, device: DeviceLike = None) -> torch.Tensor:
        dm = self.decision_matrix(X, device=device)
        idx = torch.argmax(dm, 1)              # first maximum, as jnp.argmax
        return torch.tensor(self.classes, dtype=torch.int32,
                            device=dm.device)[idx]


def fit_one_vs_rest(X, y, classes: Sequence[int], num_partitions: int,
                    cfg: MRSVMConfig, verbose: bool = False,
                    device: DeviceLike = None) -> OneVsRestSVM:
    dev = resolve_device(device, like=X)
    X = as_tensor(X, dev)
    y = as_tensor(y, dev)
    models = {}
    for c in classes:
        yc = torch.where(y == c, 1.0, -1.0)
        if verbose:
            print(f"[ovr] training class {c} vs rest")
        models[c] = fit_mapreduce(X, yc, num_partitions, cfg, verbose=verbose)
    return OneVsRestSVM(classes=tuple(int(c) for c in classes),
                        models=models, cfg=cfg)


@dataclasses.dataclass
class OneVsOneSVM:
    classes: Tuple[int, ...]
    models: Dict[Tuple[int, int], MapReduceSVM]
    cfg: MRSVMConfig

    def predict(self, X, device: DeviceLike = None) -> torch.Tensor:
        dev = resolve_device(device, like=X)
        X = as_tensor(X, dev)
        votes = torch.zeros((X.shape[0], len(self.classes)), device=dev)
        for (i, j), model in self.models.items():
            s = decision_values(model, X, self.cfg)
            win_i = (s >= 0).float()
            votes[:, self.classes.index(i)] += win_i
            votes[:, self.classes.index(j)] += 1.0 - win_i
        idx = torch.argmax(votes, 1)
        return torch.tensor(self.classes, dtype=torch.int32, device=dev)[idx]


def fit_one_vs_one(X, y, classes: Sequence[int], num_partitions: int,
                   cfg: MRSVMConfig, verbose: bool = False,
                   device: DeviceLike = None) -> OneVsOneSVM:
    dev = resolve_device(device, like=X)
    X = as_tensor(X, dev)
    y = as_tensor(y, dev)
    models = {}
    for i, j in itertools.combinations(classes, 2):
        sel = (y == i) | (y == j)
        yi = torch.where(y[sel] == i, 1.0, -1.0)
        if verbose:
            print(f"[ovo] training {i} vs {j} on {int(sel.sum())} rows")
        models[(int(i), int(j))] = fit_mapreduce(X[sel], yi, num_partitions,
                                                 cfg, verbose=verbose)
    return OneVsOneSVM(classes=tuple(int(c) for c in classes),
                       models=models, cfg=cfg)


def confusion_matrix(y_true, y_pred, classes: Sequence[int],
                     normalize: str = "all") -> np.ndarray:
    """Percentage confusion matrix like Tablo 6 / Tablo 8.

    ``normalize="all"`` (default) divides by the global count so the
    whole matrix sums to 100 — the convention the paper's tables use.
    ``normalize="true"`` row-normalizes: each true-class row sums to 100.
    """
    if normalize not in ("all", "true"):
        raise ValueError(f"normalize must be 'all' or 'true', "
                         f"got {normalize!r}")
    to_np = lambda a: a.cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)  # noqa: E731
    yt, yp = to_np(y_true), to_np(y_pred)
    k = len(classes)
    cm = np.zeros((k, k))
    for a, ca in enumerate(classes):
        for b, cb in enumerate(classes):
            cm[a, b] = np.sum((yt == ca) & (yp == cb))
    if normalize == "true":
        row = np.maximum(cm.sum(axis=1, keepdims=True), 1.0)
        return 100.0 * cm / row
    return 100.0 * cm / max(cm.sum(), 1.0)  # paper reports global percentages
