"""Public wrappers of the hand-written kernels, with launch counts.

A wrapper checks device, dtype, shape and contiguity. For tensors on
the CPU it runs the plain PyTorch version (:mod:`repro_torch.kernels.
ref`); for CUDA tensors it launches the kernel, or raises. There is no
fallback from one to the other.

``LAUNCHES`` counts the kernel launches of each wrapper, so that a run
can show that its main path went through the kernels.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels import ref

LAUNCHES: Dict[str, int] = {"cd_solve": 0, "hinge_scores": 0}

_ROW_DTYPES = (torch.float32, torch.bfloat16)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _on_card(*ts: torch.Tensor) -> bool:
    """True for CUDA tensors, False for CPU ones; raises on a mix or on
    any other device."""
    kinds = {t.device.type for t in ts}
    _check(len({t.device for t in ts}) == 1,
           f"tensors on different devices: {[str(t.device) for t in ts]}")
    kind = kinds.pop()
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device type {kind!r}")
    return kind == "cuda"


def _check_cuda_layout(named: Dict[str, torch.Tensor]) -> None:
    for name, t in named.items():
        _check(t.is_contiguous(), f"{name} must be contiguous")


def cd_solve(xh: torch.Tensor, xs: torch.Tensor, y: torch.Tensor,
             m: torch.Tensor, *, C: float, tol: float, max_epochs: int):
    """Dual-CD solve of L jobs (see :func:`ref.cd_solve_ref`).

    xh (L, per, d) and xs (S, d) rows (f32 or bf16, one dtype); y, m
    (L, per + S) f32. → alpha (L, n), w (L, d), b (L,), epochs (L,)
    int32, viol (L,).
    """
    _check(xh.dim() == 3 and xs.dim() == 2,
           f"xh must be (L, per, d) and xs (S, d), got {tuple(xh.shape)} "
           f"and {tuple(xs.shape)}")
    L, per, d = xh.shape
    n = per + xs.shape[0]
    _check(xs.shape[1] == d, f"xs has {xs.shape[1]} features, xh {d}")
    _check(xh.dtype in _ROW_DTYPES and xs.dtype == xh.dtype,
           f"rows must be one of {_ROW_DTYPES}, got {xh.dtype}/{xs.dtype}")
    _check(tuple(y.shape) == (L, n) and tuple(m.shape) == (L, n),
           f"y and m must be {(L, n)}, got {tuple(y.shape)}/{tuple(m.shape)}")
    if not _on_card(xh, xs, y, m):
        return ref.cd_solve_ref(xh, xs, y, m, C=C, tol=tol,
                                max_epochs=max_epochs)
    _check(y.dtype == torch.float32 and m.dtype == torch.float32,
           "y and m must be float32")
    _check_cuda_layout({"xh": xh, "xs": xs, "y": y, "m": m})
    from repro_torch.kernels.svm_step import launch_cd_solve
    out = launch_cd_solve(xh, xs, y, m, float(C), float(tol), int(max_epochs))
    LAUNCHES["cd_solve"] += 1
    return out


def hinge_scores(X: torch.Tensor, W: torch.Tensor, b: torch.Tensor,
                 y: torch.Tensor, m: torch.Tensor):
    """Eq. 7 hinge-loss sums of L hypotheses (see
    :func:`ref.hinge_scores_ref`). X (n, d) f32/bf16, W (L, d), b (L,),
    y, m (n,) f32. → (losses (L,), count ())."""
    _check(X.dim() == 2 and W.dim() == 2 and W.shape[1] == X.shape[1],
           f"X must be (n, d) and W (L, d), got {tuple(X.shape)} and "
           f"{tuple(W.shape)}")
    n = X.shape[0]
    L = W.shape[0]
    _check(tuple(b.shape) == (L,) and tuple(y.shape) == (n,)
           and tuple(m.shape) == (n,),
           "b must be (L,) and y, m (n,)")
    _check(X.dtype in _ROW_DTYPES, f"X must be one of {_ROW_DTYPES}")
    if not _on_card(X, W, b, y, m):
        return ref.hinge_scores_ref(X, W, b, y, m)
    _check(all(t.dtype == torch.float32 for t in (W, b, y, m)),
           "W, b, y and m must be float32")
    _check_cuda_layout({"X": X, "W": W, "b": b, "y": y, "m": m})
    from repro_torch.kernels.hinge_score import (launch_hinge_scores,
                                                 max_hypotheses)
    step = max_hypotheses()
    losses, count = [], None
    for l0 in range(0, L, step):
        loss, count = launch_hinge_scores(X, W[l0:l0 + step],
                                          b[l0:l0 + step], y, m)
        LAUNCHES["hinge_scores"] += 1
        losses.append(loss)
    return (losses[0] if len(losses) == 1 else torch.cat(losses)), count
