"""Kernel functions for the (soft-margin) SVM dual.

All kernels take ``X (n, d)`` and ``Z (m, d)`` — dense tensors or
blocked-CSR :class:`~repro_torch.sparse.SparseRows`, in any mix — and
return ``K (n, m)``.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

import torch

from repro_torch import sparse as sparse_rows

KernelName = Literal["linear", "rbf", "poly"]


@dataclasses.dataclass(frozen=True)
class KernelConfig:
    name: KernelName = "linear"
    gamma: float = 1.0      # rbf / poly scale
    degree: int = 3         # poly
    coef0: float = 0.0      # poly


def linear_kernel(X: torch.Tensor, Z: torch.Tensor) -> torch.Tensor:
    return X @ Z.T


def rbf_kernel(X: torch.Tensor, Z: torch.Tensor, gamma: float) -> torch.Tensor:
    # ||x - z||^2 = ||x||^2 + ||z||^2 - 2 x.z ; numerically clamped at 0.
    xx = (X * X).sum(-1, keepdim=True)
    zz = (Z * Z).sum(-1, keepdim=True)
    sq = torch.clamp(xx + zz.T - 2.0 * (X @ Z.T), min=0.0)
    return torch.exp(-gamma * sq)


def poly_kernel(X: torch.Tensor, Z: torch.Tensor, gamma: float, degree: int,
                coef0: float) -> torch.Tensor:
    return (gamma * (X @ Z.T) + coef0) ** degree


def apply_kernel(X, Z, *, cfg: KernelConfig, gamma=None,
                 coef0=None) -> torch.Tensor:
    """k(X, Z) under ``cfg``; ``gamma``/``coef0`` override the config's."""
    g = cfg.gamma if gamma is None else gamma
    c0 = cfg.coef0 if coef0 is None else coef0
    if sparse_rows.is_sparse(X) or sparse_rows.is_sparse(Z):
        # one gather/segment-sum dot-product build, then the same
        # transforms as dense
        dots = sparse_rows.cross_dots(X, Z)
        if cfg.name == "linear":
            return dots
        if cfg.name == "rbf":
            xx = sparse_rows.row_sq_norms(X)[:, None]
            zz = sparse_rows.row_sq_norms(Z)[None, :]
            return torch.exp(-g * torch.clamp(xx + zz - 2.0 * dots, min=0.0))
        if cfg.name == "poly":
            return (g * dots + c0) ** cfg.degree
        raise ValueError(f"unknown kernel {cfg.name!r}")
    if cfg.name == "linear":
        return linear_kernel(X, Z)
    if cfg.name == "rbf":
        return rbf_kernel(X, Z, g)
    if cfg.name == "poly":
        return poly_kernel(X, Z, g, cfg.degree, c0)
    raise ValueError(f"unknown kernel {cfg.name!r}")
