"""Kernel functions for the (soft-margin) SVM dual, dense rows.

All kernels take ``X (n, d)`` and ``Z (m, d)`` and return ``K (n, m)``.
Sparse rows wait for a later slice of the port.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

import torch

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


def apply_kernel(X: torch.Tensor, Z: torch.Tensor, *, cfg: KernelConfig,
                 gamma=None, coef0=None) -> torch.Tensor:
    """k(X, Z) under ``cfg``; ``gamma``/``coef0`` override the config's."""
    if X.is_sparse or Z.is_sparse:
        raise NotImplementedError("sparse rows: ROADMAP Queue 1 #5")
    g = cfg.gamma if gamma is None else gamma
    c0 = cfg.coef0 if coef0 is None else coef0
    if cfg.name == "linear":
        return linear_kernel(X, Z)
    if cfg.name == "rbf":
        return rbf_kernel(X, Z, g)
    if cfg.name == "poly":
        return poly_kernel(X, Z, g, cfg.degree, c0)
    raise ValueError(f"unknown kernel {cfg.name!r}")
