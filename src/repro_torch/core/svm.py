"""Soft-margin binary SVM trained in the dual (paper eq. 1-2).

The reducer's solver is dual coordinate descent (Hsieh et al. 2008,
L1-loss) on the linear path: it keeps the primal ``w = Σ α_i y_i x_i``,
O(n·d) per epoch, no Gram matrix. The solve runs in the hand-written
kernel ``cd_solve`` (:mod:`repro_torch.kernels.ops`), one CTA per job,
so a MapReduce round solves all its partitions in one launch.

The bias is LIBLINEAR's regularized bias: ``Q_ii = ||x_i||² + 1`` and
``b = Σ α_i y_i``. Masked rows get ``Q_ii = 1`` and their updates are
multiplied by 0, so their α stays exactly 0. α, w and b are float32
even when the rows are bf16.

The kernel (rbf/poly, or ``use_gram``) path waits for ROADMAP Queue 1 #5.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import torch

from repro_torch.core.kernel_fns import KernelConfig
from repro_torch.device import DeviceLike, as_tensor, resolve_device
from repro_torch.kernels import ops

_GRAM_PATH = "kernel (Gram) path: ROADMAP Queue 1 #5"


class SolverParams(NamedTuple):
    """Value-like solver hyper-parameters, as plain floats.

    ``max_epochs`` is a cutoff: the solve stops at
    ``min(cfg.max_epochs, params.max_epochs)`` epochs.
    """
    C: float
    tol: float
    sv_threshold: float
    gamma: float
    coef0: float
    max_epochs: float


@dataclasses.dataclass(frozen=True)
class SVMConfig:
    """Reducer-level solver configuration (paper eq. 2 hyper-params)."""
    C: float = 1.0
    max_epochs: int = 30
    tol: float = 1e-3            # max projected-gradient violation to stop
    kernel: KernelConfig = KernelConfig()
    sv_threshold: float = 1e-6   # α above this counts as a support vector
    use_gram: bool = False       # force the Gram path even for linear
    gram_impl: str = "xla"       # 'xla' | 'pallas' | 'pallas_sparse'
    row_format: str = "dense"    # 'dense' | 'sparse_csr' (blocked CSR/ELL)
    nnz_cap: int = 0             # slots per sparse row; required if sparse

    def __post_init__(self):
        if self.row_format not in ("dense", "sparse_csr"):
            raise ValueError(
                f"row_format must be 'dense' or 'sparse_csr', "
                f"got {self.row_format!r}")
        if self.gram_impl not in ("xla", "pallas", "pallas_sparse"):
            raise ValueError(
                f"gram_impl must be 'xla' | 'pallas' | 'pallas_sparse', "
                f"got {self.gram_impl!r}")
        if self.row_format == "sparse_csr" and self.nnz_cap < 1:
            raise ValueError(
                "row_format='sparse_csr' requires nnz_cap >= 1 (the "
                "static slot count of the blocked-CSR rows)")
        if self.gram_impl == "pallas_sparse" and self.row_format != \
                "sparse_csr":
            raise ValueError(
                "gram_impl='pallas_sparse' requires row_format="
                "'sparse_csr' (it consumes index/value blocks)")
        if self.gram_impl == "pallas" and self.row_format == "sparse_csr":
            raise ValueError(
                "the dense Pallas Gram kernel cannot consume sparse_csr "
                "rows; use gram_impl='pallas_sparse' or 'xla'")

    def params(self) -> SolverParams:
        """The value-like hyper-params as a :class:`SolverParams`."""
        return SolverParams(C=float(self.C), tol=float(self.tol),
                            sv_threshold=float(self.sv_threshold),
                            gamma=float(self.kernel.gamma),
                            coef0=float(self.kernel.coef0),
                            max_epochs=float(self.max_epochs))

    @property
    def is_linear(self) -> bool:
        """True where the solve runs on the primal ``w`` (the port's path)."""
        return self.kernel.name == "linear" and not self.use_gram


class BinarySVM(NamedTuple):
    """Trained reducer output: dual coefs + primal view (linear path).

    Batched solves carry a leading job axis on every field.
    """
    alpha: torch.Tensor          # (n,) dual variables in [0, C]
    b: torch.Tensor              # () bias (regularized-bias convention)
    w: torch.Tensor              # (d,) primal weights
    epochs_run: torch.Tensor     # () epochs run before tol hit
    max_violation: torch.Tensor  # () final max projected-gradient violation


def support_mask(alpha: torch.Tensor, threshold: float = 1e-6) -> torch.Tensor:
    """Boolean mask of support vectors (α > 0 up to threshold)."""
    return alpha > threshold


def epoch_cap(cfg: SVMConfig, p: SolverParams) -> int:
    """Epochs the solve may run: ``t < min(cfg, params)`` as an int."""
    return max(0, math.ceil(min(float(cfg.max_epochs), float(p.max_epochs))))


def solve_linear_jobs(xh: torch.Tensor, xs: torch.Tensor, y: torch.Tensor,
                      m: torch.Tensor, cfg: SVMConfig,
                      params: Optional[SolverParams] = None) -> BinarySVM:
    """Solve L jobs at once: job l trains on rows ``[xh[l]; xs]`` with
    labels/mask ``y[l]``, ``m[l]`` (L, per + S). One ``cd_solve``
    launch on the card. → :class:`BinarySVM` with a leading (L,) axis."""
    p = cfg.params() if params is None else params
    alpha, w, b, t, viol = ops.cd_solve(
        xh, xs, y.float().contiguous(), m.float().contiguous(),
        C=p.C, tol=p.tol, max_epochs=epoch_cap(cfg, p))
    return BinarySVM(alpha=alpha, b=b, w=w, epochs_run=t, max_violation=viol)


def fit_binary_linear(X: torch.Tensor, y: torch.Tensor,
                      mask: Optional[torch.Tensor], cfg: SVMConfig,
                      params: Optional[SolverParams] = None) -> BinarySVM:
    """Dual CD on the primal ``w`` for one job; X (n, d) dense."""
    if X.is_sparse:
        raise NotImplementedError("sparse rows: ROADMAP Queue 1 #5")
    n, d = X.shape
    m = torch.ones((n,), dtype=torch.float32, device=X.device) \
        if mask is None else mask
    res = solve_linear_jobs(X[None], X.new_zeros((0, d)), y[None], m[None],
                            cfg, params)
    return BinarySVM(*(f[0] for f in res))


def fit_binary_kernel(X, y, mask, cfg: SVMConfig, params=None) -> BinarySVM:
    raise NotImplementedError(_GRAM_PATH)


def fit_binary(X, y, mask=None, cfg: SVMConfig = SVMConfig(),
               params: Optional[SolverParams] = None,
               device: DeviceLike = None) -> BinarySVM:
    """Train one reducer's soft-margin binary SVM. y ∈ {-1, +1}.

    Numpy inputs go to ``device`` (default ``cuda``); tensors stay
    where they are unless ``device`` is given.
    """
    dev = resolve_device(device, like=X)
    X = as_tensor(X, dev)
    y = as_tensor(y, dev)
    mask = None if mask is None else as_tensor(mask, dev)
    if cfg.is_linear:
        return fit_binary_linear(X, y, mask, cfg, params=params)
    return fit_binary_kernel(X, y, mask, cfg, params=params)


def decision_linear(w: torch.Tensor, b: torch.Tensor, X: torch.Tensor,
                    chunk_rows: int = 8192) -> torch.Tensor:
    """f(X) = X w + b in w's dtype; rows go through in chunks so a bf16
    X is never copied whole to float32."""
    if X.is_sparse:
        raise NotImplementedError("sparse rows: ROADMAP Queue 1 #5")
    out = torch.empty(X.shape[:-1], dtype=w.dtype, device=X.device)
    for i in range(0, X.shape[0], chunk_rows):
        out[i:i + chunk_rows] = X[i:i + chunk_rows].to(w.dtype) @ w
    return out + b


def predict_sign(scores: torch.Tensor) -> torch.Tensor:
    """±1 labels; ties (score==0) resolve to +1 like the paper's tables."""
    return torch.where(scores >= 0.0, 1.0, -1.0)
