"""TF×IDF weighting (paper eq. 10-11) on dense count rows.

    idf_t     = log(N / df_t)                      (eq. 10)
    tfidf_t,d = tf_t,d × idf_t                     (eq. 11)

Numpy counts go to ``device`` (default ``cuda``); tensors stay where
they are. Sparse rows wait for a later slice of the port.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.device import DeviceLike, as_tensor, resolve_device


class TfidfModel(NamedTuple):
    idf: torch.Tensor        # (d,)
    num_docs: torch.Tensor   # ()


def fit_idf(counts, smooth: bool = True,
            device: DeviceLike = None) -> TfidfModel:
    """idf from a training count matrix (n, d).

    ``smooth`` uses log((1+N)/(1+df)) + 1 so unseen terms stay finite —
    the standard safe variant of eq. 10 (hashed spaces always contain
    empty buckets).
    """
    counts = as_tensor(counts, resolve_device(device, like=counts))
    n = counts.shape[0]
    df = (counts > 0).to(counts.dtype).sum(0)
    if smooth:
        idf = torch.log((1.0 + n) / (1.0 + df)) + 1.0
    else:
        idf = torch.log(n / torch.clamp(df, min=1.0))
    return TfidfModel(idf=idf, num_docs=torch.tensor(n))


def transform(counts, model: TfidfModel, l2_normalize: bool = True,
              device: DeviceLike = None) -> torch.Tensor:
    """tf × idf, optionally L2-row-normalized (standard for linear SVM)."""
    X = as_tensor(counts, resolve_device(device, like=counts)) \
        * model.idf[None, :]
    if l2_normalize:
        norm = torch.sqrt((X * X).sum(1, keepdim=True))
        X = X / torch.clamp(norm, min=1e-12)
    return X


def fit_transform(counts, smooth: bool = True, l2_normalize: bool = True,
                  device: DeviceLike = None):
    counts = as_tensor(counts, resolve_device(device, like=counts))
    model = fit_idf(counts, smooth)
    return transform(counts, model, l2_normalize), model
