"""Plain PyTorch versions of the hand-written kernels.

The CPU tests run these, and ``chip_smoke.py`` holds each CUDA kernel
against its plain version on the card. They compute exactly what the
kernels compute, in float32, with the rows in the same order.
"""
from __future__ import annotations

import math

import torch


def _rows(xh: torch.Tensor, xs: torch.Tensor, i: int) -> torch.Tensor:
    """Row ``i`` of every job's augmented partition, as (L, d) float32:
    home row ``xh[:, i]`` for ``i < per``, else shared row ``xs[i-per]``."""
    L, per, d = xh.shape
    x = xh[:, i] if i < per else xs[i - per].expand(L, d)
    return x.float()


def _cd_epoch(xh, xs, y, m, alpha, w, b, C: float, active):
    """One sequential dual-CD epoch over every job, in place.

    Jobs whose ``active`` is 0 keep their state. → max projected-gradient
    violation of the epoch per job (L,).
    """
    n = y.shape[1]
    viol = torch.zeros_like(b)
    for i in range(n):
        x = _rows(xh, xs, i)
        wx = (w * x).sum(-1)
        xx = (x * x).sum(-1)
        yi, mi, ai = y[:, i], m[:, i], alpha[:, i]
        g = yi * (wx + b) - 1.0                       # ∂/∂α_i of dual obj
        pg = torch.where(ai <= 0.0, g.clamp(max=0.0),
                         torch.where(ai >= C, g.clamp(min=0.0), g))
        q = torch.where(mi > 0, xx + 1.0, 1.0)        # Q_ii, bias augment
        a_new = (ai - g / q).clamp(0.0, C)
        delta = (a_new - ai) * mi * active
        alpha[:, i] = ai + delta
        coef = delta * yi
        w += coef[:, None] * x
        b += coef
        viol = torch.maximum(viol, pg.abs() * mi)
    return viol


def cd_solve_ref(xh: torch.Tensor, xs: torch.Tensor, y: torch.Tensor,
                 m: torch.Tensor, *, C: float, tol: float, max_epochs: int):
    """The whole dual-CD solve of L jobs (the plain ``cd_solve``).

    xh (L, per, d) home rows, xs (S, d) rows shared by every job; job l
    solves over the augmented rows ``[xh[l]; xs]`` with labels/mask
    y, m (L, per + S). Each job runs at least one epoch (when
    ``max_epochs`` > 0) and stops once its own violation ≤ ``tol`` —
    a job that stops is frozen while the others go on, as ``vmap`` of
    the reference's ``while_loop`` behaves.

    → alpha (L, n) f32, w (L, d) f32, b (L,) f32, epochs (L,) int32,
    viol (L,) f32.
    """
    L, per, d = xh.shape
    dev = xh.device
    y, m = y.float(), m.float()
    alpha = torch.zeros(y.shape, dtype=torch.float32, device=dev)
    w = torch.zeros((L, d), dtype=torch.float32, device=dev)
    b = torch.zeros((L,), dtype=torch.float32, device=dev)
    viol = torch.full((L,), math.inf, dtype=torch.float32, device=dev)
    t = torch.zeros((L,), dtype=torch.int32, device=dev)
    while True:
        active = (t < max_epochs) & ((t == 0) | (viol > tol))
        if not bool(active.any()):
            break
        ep = _cd_epoch(xh, xs, y, m, alpha, w, b, C, active.float())
        viol = torch.where(active, ep, viol)
        t += active.int()
    return alpha, w, b, t, viol


def cd_epoch_ref(X: torch.Tensor, *, alpha, w, b, y, mask, C: float = 1.0):
    """One dual-CD epoch of one job from a given state (X (n, d)).

    → (alpha (n,), w (d,), b ()) updated, all float32.
    """
    a = alpha.float().clone()[None]
    wv = w.float().clone()[None]
    bv = torch.as_tensor(b, dtype=torch.float32, device=X.device).reshape(1).clone()
    xs = X.new_zeros((0, X.shape[1]))
    one = torch.ones((1,), dtype=torch.float32, device=X.device)
    _cd_epoch(X[None], xs, y.float()[None], mask.float()[None], a, wv, bv,
              C, one)
    return a[0], wv[0], bv[0]


def hinge_scores_ref(X: torch.Tensor, W: torch.Tensor, b: torch.Tensor,
                     y: torch.Tensor, mask: torch.Tensor,
                     chunk_rows: int = 4096):
    """Fused risk evaluation (paper eq. 6/7).

    X (n, d), W (L, d), b (L,), y (n,), mask (n,) →
      losses (L,): Σ_i mask_i · max(0, 1 − y_i·(x_i·w_l + b_l))
      count (): Σ mask
    Rows go through in chunks so a bf16 X is never copied whole to f32.
    """
    Wf = W.float()
    bf = b.float()
    losses = torch.zeros(W.shape[0], dtype=torch.float32, device=X.device)
    for i in range(0, X.shape[0], chunk_rows):
        s = X[i:i + chunk_rows].float() @ Wf.T + bf[None, :]
        h = torch.clamp(1.0 - y[i:i + chunk_rows].float()[:, None] * s,
                        min=0.0)
        losses += (h * mask[i:i + chunk_rows].float()[:, None]).sum(0)
    return losses, mask.float().sum()
