"""χ² feature selection (the paper cites Yang & Pedersen 1997 for
"nitelik seçimi" — feature selection on the vector space), on dense
rows as in the reference (``repro/text/feature_select.py``)."""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

from repro_torch.device import DeviceLike, as_tensor, resolve_device


def chi2_scores(X, y, classes: Sequence[int],
                device: DeviceLike = None) -> torch.Tensor:
    """Per-feature χ² statistic for non-negative features (counts or
    TF×IDF), X (n, d): observed class-conditional feature mass against
    its expectation under independence; 0 for features of zero mass.
    Numpy inputs go to ``device`` (default ``cuda``)."""
    dev = resolve_device(device, like=X)
    X = as_tensor(X, dev)
    y = as_tensor(y, dev)
    Y = torch.stack([(y == c).to(X.dtype) for c in classes], 1)   # (n, k)
    observed = Y.T @ X                                             # (k, d)
    feature_mass = X.sum(0)                                        # (d,)
    class_prob = Y.mean(0)                                         # (k,)
    expected = class_prob[:, None] * feature_mass[None, :]
    chi2 = ((observed - expected) ** 2
            / torch.clamp(expected, min=1e-12)).sum(0)
    return torch.where(feature_mass > 0, chi2, 0.0)


def select_top_k(X, y, classes: Sequence[int], k: int,
                 device: DeviceLike = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(X[:, top_idx], top_idx) of the k best χ² scores. A stable
    descending sort puts the lower feature first on ties, as
    ``lax.top_k`` does (features of zero mass all score 0 and tie)."""
    dev = resolve_device(device, like=X)
    X = as_tensor(X, dev)
    scores = chi2_scores(X, y, classes)
    idx = torch.sort(scores, descending=True, stable=True).indices[:k]
    return X[:, idx], idx
