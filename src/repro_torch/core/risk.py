"""Empirical risk, losses, and the paper's stopping rule (eq. 6-8)."""
from __future__ import annotations

from typing import Optional

import torch


def hinge_loss(scores: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """ℓ(h(x), y) = max(0, 1 - y·f(x)) per example."""
    return torch.clamp(1.0 - y * scores, min=0.0)


def zero_one_loss(scores: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """ℓ(h(x), y) = 1[h(x) ≠ y] with the served decision convention:
    a boundary score of 0 predicts +1, as ``predict_sign`` does."""
    pred = torch.where(scores >= 0.0, 1.0, -1.0).to(scores.dtype)
    return (pred != torch.sign(y)).to(scores.dtype)


def empirical_risk(scores: torch.Tensor, y: torch.Tensor,
                   mask: Optional[torch.Tensor] = None,
                   loss: str = "hinge") -> torch.Tensor:
    """R_emp(h) = (1/n) Σ ℓ(h(x_i), y_i)  (paper eq. 6)."""
    per_ex = hinge_loss(scores, y) if loss == "hinge" \
        else zero_one_loss(scores, y)
    if mask is None:
        return per_ex.mean()
    m = mask.to(per_ex.dtype)
    return (per_ex * m).sum() / torch.clamp(m.sum(), min=1.0)


def converged(risk_prev, risk_curr, gamma: float):
    """|R_emp(h^{t-1}) - R_emp(h^t)| <= γ  (paper eq. 8)."""
    return abs(risk_prev - risk_curr) <= gamma
