"""TF×IDF weighting (paper eq. 10-11).

    idf_t     = log(N / df_t)                      (eq. 10)
    tfidf_t,d = tf_t,d × idf_t                     (eq. 11)

Both entry points take dense ``(n, d)`` counts or blocked-CSR
:class:`~repro_torch.sparse.SparseRows` counts; the sparse overloads
never densify. Numpy counts go to ``device`` (default ``cuda``);
tensors and ``SparseRows`` stay where they are.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import sparse as sparse_rows
from repro_torch.device import DeviceLike, as_tensor, resolve_device


class TfidfModel(NamedTuple):
    idf: torch.Tensor        # (d,)
    num_docs: torch.Tensor   # ()


def fit_idf(counts, smooth: bool = True,
            device: DeviceLike = None) -> TfidfModel:
    """idf from a training count matrix (n, d), dense or ``SparseRows``.

    ``smooth`` uses log((1+N)/(1+df)) + 1 so unseen terms stay finite —
    the standard safe variant of eq. 10 (hashed spaces always contain
    empty buckets).
    """
    counts = as_tensor(counts, resolve_device(device, like=counts))
    n = counts.shape[0]
    if sparse_rows.is_sparse(counts):
        # df by scatter-add of the live slots; in-row indices are
        # distinct by the featurizer contract.
        live = (counts.values > 0).to(torch.float32).reshape(-1)
        df = torch.zeros((counts.d,), dtype=torch.float32,
                         device=counts.device).index_add_(
            0, counts.indices.reshape(-1).long(), live)
    else:
        df = (counts > 0).to(counts.dtype).sum(0)
    if smooth:
        idf = torch.log((1.0 + n) / (1.0 + df)) + 1.0
    else:
        idf = torch.log(n / torch.clamp(df, min=1.0))
    return TfidfModel(idf=idf, num_docs=torch.tensor(n))


def transform(counts, model: TfidfModel, l2_normalize: bool = True,
              device: DeviceLike = None):
    """tf × idf, optionally L2-row-normalized (standard for linear SVM).

    ``SparseRows`` counts come back as ``SparseRows`` with the same
    indices; a padding slot (value 0) stays exactly 0 although the
    smoothed idf of its column 0 is not.
    """
    counts = as_tensor(counts, resolve_device(device, like=counts))
    if sparse_rows.is_sparse(counts):
        scale = model.idf[counts.indices.long()].to(counts.dtype)
        vals = torch.where(counts.values != 0, counts.values * scale, 0.0)
        if l2_normalize:
            norm = torch.sqrt((vals * vals).sum(-1, keepdim=True))
            vals = vals / torch.clamp(norm, min=1e-12)
        return sparse_rows.SparseRows(counts.indices, vals, counts.d,
                                      counts.ids_in_range)
    X = counts * model.idf[None, :]
    if l2_normalize:
        norm = torch.sqrt((X * X).sum(1, keepdim=True))
        X = X / torch.clamp(norm, min=1e-12)
    return X


def fit_transform(counts, smooth: bool = True, l2_normalize: bool = True,
                  device: DeviceLike = None):
    counts = as_tensor(counts, resolve_device(device, like=counts))
    model = fit_idf(counts, smooth)
    return transform(counts, model, l2_normalize), model
