"""Soft-margin binary SVM trained in the dual (paper eq. 1-2).

The reducer's solver is dual coordinate descent (Hsieh et al. 2008,
L1-loss), on two paths:

* **linear** (dense or blocked-CSR rows): keeps the primal
  ``w = Σ α_i y_i x_i``, no Gram matrix, in the hand-written kernel
  ``cd_solve``: O(n·d) per epoch on dense rows, O(n·nnz_cap) on
  ``SparseRows`` (its ``cd_solve/sparse`` route gathers w at a row's
  column ids and scatter-adds the update). α, w and b are float32 even
  when the rows are bf16.
* **kernel** (rbf/poly, or ``use_gram``; dense or blocked-CSR rows):
  builds the Gram matrix (``gram_impl``: ``"pallas"`` → the ``gram``
  kernel, ``"pallas_sparse"`` → ``sparse_gram``, ``"xla"`` → plain
  PyTorch :func:`apply_kernel`) and runs Gram dual CD in the kernel
  ``cd_solve_gram``, O(n²) per epoch. As in the reference, K, y, the
  mask, α and the gradient are kept in the rows' dtype.

Both solve all partitions of a MapReduce round in one launch, and all
S·L jobs of a sweep round (:mod:`repro_torch.core.sweep`), whose
hyper-parameters may be per job. The bias is LIBLINEAR's regularized
bias: ``K ← K + 1`` / ``Q_ii = ||x_i||² + 1`` and ``b = Σ α_i y_i``.
Masked rows get ``Q_ii = 1`` and their updates are multiplied by 0, so
their α stays exactly 0.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import torch

from repro_torch import sparse as sparse_rows
from repro_torch.core.kernel_fns import KernelConfig, apply_kernel
from repro_torch.device import DeviceLike, as_tensor, resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels.gram import JobRows

#: K entries one chunk of a decision may hold (~1 GB of float32)
_CHUNK_ELEMS = 1 << 28


class SolverParams(NamedTuple):
    """Value-like solver hyper-parameters: plain floats, or a leading
    (S,) axis on every field (numpy float32 arrays or 1-D tensors of one
    length; a sweep's configs, :mod:`repro_torch.core.sweep`). The
    solves also take (jobs,) tensors, one value a job.

    ``max_epochs`` is a cutoff: the solve stops at
    ``min(cfg.max_epochs, params.max_epochs)`` epochs (0 allowed).
    """
    C: object
    tol: object
    sv_threshold: object
    gamma: object
    coef0: object
    max_epochs: object


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
        """True where the solve runs on the primal ``w``, False on the
        Gram path."""
        return self.kernel.name == "linear" and not self.use_gram


class BinarySVM(NamedTuple):
    """Trained reducer output: dual coefs + primal view (zeros on the
    Gram path unless the kernel is linear).

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


def epoch_cap(cfg: SVMConfig, p: SolverParams):
    """Epochs the solve may run: ``t < min(cfg, params)`` as a whole
    number, ``ceil(min(cfg.max_epochs, p.max_epochs))`` and at least 0:
    an int, or an int32 tensor of ``p.max_epochs``'s shape."""
    if isinstance(p.max_epochs, torch.Tensor):
        cap = torch.ceil(torch.clamp(p.max_epochs.float(),
                                     max=float(cfg.max_epochs)))
        return torch.clamp(cap, min=0).to(torch.int32)
    return max(0, math.ceil(min(float(cfg.max_epochs), float(p.max_epochs))))


def solve_linear_jobs(xh, xs, y: torch.Tensor, m: torch.Tensor,
                      cfg: SVMConfig,
                      params: Optional[SolverParams] = None) -> BinarySVM:
    """Solve L jobs at once: job l trains on rows ``[xh[l % n_home];
    xs]`` (dense or ``SparseRows``; xs a (B, S, d) stack gives job l its
    block l // (L / B)) with labels/mask ``y[l]``, ``m[l]`` (L, per + S)
    and ``params`` whose fields are numbers or (L,) tensors. One
    ``cd_solve`` launch on the card. → :class:`BinarySVM` with a
    leading (L,) axis."""
    p = cfg.params() if params is None else params
    alpha, w, b, t, viol = ops.cd_solve(
        xh, xs, y.float().contiguous(), m.float().contiguous(),
        C=p.C, tol=p.tol, max_epochs=epoch_cap(cfg, p))
    return BinarySVM(alpha=alpha, b=b, w=w, epochs_run=t, max_violation=viol)


def fit_binary_linear(X, y: torch.Tensor, mask: Optional[torch.Tensor],
                      cfg: SVMConfig,
                      params: Optional[SolverParams] = None) -> BinarySVM:
    """Dual CD on the primal ``w`` for one job; X (n, d) dense or
    ``SparseRows``."""
    n = X.shape[0]
    m = torch.ones((n,), dtype=torch.float32, device=X.device) \
        if mask is None else mask
    res = solve_linear_jobs(X[None], X[:0], y[None], m[None], cfg, params)
    return BinarySVM(*(f[0] for f in res))


def _side_sparse(side) -> bool:
    return sparse_rows.is_sparse(side[0] if isinstance(side, tuple)
                                 else side)


def kernel_matrix(X, Z, cfg: SVMConfig,
                  params: Optional[SolverParams] = None) -> torch.Tensor:
    """k(X, Zᵀ) routed by ``cfg.gram_impl``: ``"pallas"`` → the ``gram``
    kernel (which refuses ``SparseRows``), ``"pallas_sparse"`` →
    ``sparse_gram`` (which refuses two dense sides), and plain PyTorch
    :func:`apply_kernel` for ``"xla"`` and for the mixed dense × sparse
    pair under ``"pallas_sparse"``, which the reference also sends to
    ``cross_dots`` (``gram.py:178``).

    Sides are row batches, ``(home, shared)`` pairs or ``(home, shared
    stack, jobs_per_shared)`` triples (see
    :func:`repro_torch.kernels.ops.gram`); γ and coef0 numbers or one
    a job. → (n, m), or (jobs, n, m) when a side is a pair; float32
    from the kernels, the rows' dtype from ``apply_kernel``.
    """
    p = cfg.params() if params is None else params
    kc = cfg.kernel
    kw = dict(kind=kc.name, gamma=p.gamma, coef0=p.coef0, degree=kc.degree)
    if cfg.gram_impl == "pallas":
        return ops.gram(X, Z, **kw)
    if cfg.gram_impl == "pallas_sparse" and \
            _side_sparse(X) == _side_sparse(Z):
        return ops.sparse_gram(X, Z, **kw)
    return ops.per_job(apply_kernel, X, Z, cfg=kc, gamma=p.gamma,
                       coef0=p.coef0)


def solve_kernel_jobs(xh, xs, y: torch.Tensor, m: torch.Tensor,
                      cfg: SVMConfig,
                      params: Optional[SolverParams] = None) -> BinarySVM:
    """Solve L jobs on the Gram path: job l trains on rows as in
    :func:`solve_linear_jobs`, with its own params. One Gram build over
    the L jobs and one ``cd_solve_gram`` launch on the card. The state
    is in the rows' dtype (``K.astype(X.dtype)``, ``svm.py:248``). →
    :class:`BinarySVM` with a leading (L,) axis."""
    p = cfg.params() if params is None else params
    dt = xh.dtype
    L = y.shape[0]
    jps = L if len(xs.shape) == 2 else L // xs.shape[0]
    side = (xh, xs) if len(xs.shape) == 2 else (xh, xs, jps)
    K = kernel_matrix(side, side, cfg, p).to(dt)
    y, m = y.to(dt).contiguous(), m.to(dt).contiguous()
    alpha, t, viol = ops.cd_solve_gram(K.contiguous(), y, m, C=p.C,
                                       tol=p.tol,
                                       max_epochs=epoch_cap(cfg, p))
    coef = alpha * y * m
    d = xh.shape[-1]
    if cfg.kernel.name == "linear":
        rows = JobRows(*side)
        w = torch.stack([sparse_rows.weighted_row_sum(rows.rows(j),
                                                      coef[j]).to(dt)
                         for j in range(L)])
    else:
        w = torch.zeros((L, d), dtype=dt, device=coef.device)
    # b = Σ α·y·m in blocks of the jobs of one shared block: a block sums
    # as a lone round's jobs do, so a sweep's job gets that fit's bits
    # (a reduction's order on the card depends on the rows it is given)
    b = torch.cat([coef[j:j + jps].sum(1) for j in range(0, L, jps)])
    return BinarySVM(alpha=alpha, b=b, w=w, epochs_run=t,
                     max_violation=viol)


def fit_binary_kernel(X, y: torch.Tensor, mask: Optional[torch.Tensor],
                      cfg: SVMConfig,
                      params: Optional[SolverParams] = None) -> BinarySVM:
    """Gram dual CD for one job; X (n, d) dense or ``SparseRows``."""
    n = X.shape[0]
    m = torch.ones((n,), dtype=X.dtype, device=X.device) if mask is None \
        else mask
    res = solve_kernel_jobs(X[None], X[:0], y[None], m[None], cfg, params)
    return BinarySVM(*(f[0] for f in res))


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


def decision_linear(w: torch.Tensor, b: torch.Tensor, X,
                    chunk_rows: int = 8192) -> torch.Tensor:
    """f(X) = X w + b in w's dtype; rows go through in chunks so a bf16
    X is never copied whole to float32. ``SparseRows`` rows gather w at
    their column ids (``SparseRows.__matmul__``), as the reference's
    ``X @ w``."""
    sparse = sparse_rows.is_sparse(X)
    out = torch.empty(X.shape[:-1], dtype=w.dtype, device=X.device)
    for i in range(0, X.shape[0], chunk_rows):
        rows = X[i:i + chunk_rows]
        out[i:i + chunk_rows] = (rows if sparse else rows.to(w.dtype)) @ w
    return out + b


def decision_kernel(Z, coef: torch.Tensor, b, X, cfg: SVMConfig,
                    params: Optional[SolverParams] = None) -> torch.Tensor:
    """f(x) = Σ_j coef_j k(x, z_j) + b, coef = α·y (masked). ``Z`` is a
    row batch or a ``(home (1, ·), shared)`` pair; ``coef`` (m,) or
    (m, L) with ``b`` () or (L,).

    Under ``gram_impl="pallas_sparse"`` with blocked-CSR rows on both
    sides, one ``sparse_gram_scores`` launch computes all query rows and
    K never goes to memory. Otherwise K comes from :func:`kernel_matrix`
    in chunks of query rows of at most ~1 GB of K.
    → (n,) or (n, L) in ``coef``'s dtype."""
    if cfg.gram_impl == "pallas_sparse" and _side_sparse(X) \
            and _side_sparse(Z):
        p = cfg.params() if params is None else params
        C = (coef.T if coef.dim() == 2 else coef[None]).contiguous()
        bL = torch.as_tensor(b, dtype=coef.dtype, device=coef.device) \
            .reshape(-1).expand(C.shape[0]).contiguous()
        out = ops.sparse_gram_scores(X, Z, C, bL, kind=cfg.kernel.name,
                                     gamma=p.gamma, coef0=p.coef0,
                                     degree=cfg.kernel.degree)
        return out if coef.dim() == 2 else out[:, 0]
    nz = Z[0].shape[1] + Z[1].shape[0] if isinstance(Z, tuple) \
        else Z.shape[0]
    n = X.shape[0]
    step = max(1, _CHUNK_ELEMS // max(nz, 1))
    out = torch.empty((n,) + tuple(coef.shape[1:]), dtype=coef.dtype,
                      device=coef.device)
    for q0 in range(0, n, step):
        K = kernel_matrix(X[q0:q0 + step], Z, cfg, params)
        out[q0:q0 + step] = K.reshape(-1, nz).to(coef.dtype) @ coef
    return out + b


def predict_sign(scores: torch.Tensor) -> torch.Tensor:
    """±1 labels; ties (score==0) resolve to +1 like the paper's tables."""
    return torch.where(scores >= 0.0, 1.0, -1.0)
