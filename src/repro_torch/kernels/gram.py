"""Launch of the Gram kernels ``csrc/gram.cu`` (dense rows) and
``csrc/sparse_gram.cu`` (blocked-CSR rows).

The counterparts of ``repro/kernels/gram.py: gram`` and ``sparse_gram``.
Callers go through :func:`repro_torch.kernels.ops.gram` and
:func:`~repro_torch.kernels.ops.sparse_gram`, which check the inputs,
count launches and take the plain versions for CPU tensors.

Both take each side as :class:`JobRows`: job ``l``'s rows are its home
block ``home[l]`` followed by the ``shared`` rows, so a MapReduce
round's augmented partitions ``[X_l; SV_global]`` go in without a copy.
A home block with one job is used by every job.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import build

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float

KINDS = {"linear": 0, "poly": 1, "rbf": 2}


class JobRows(NamedTuple):
    """Rows of each job: ``home`` (J, per, ·) then ``shared`` (S, ·);
    dense tensors or ``SparseRows``."""
    home: object
    shared: object

    @property
    def jobs(self) -> int:
        return self.home.shape[0]

    @property
    def per(self) -> int:
        return self.home.shape[1]

    @property
    def n(self) -> int:
        return self.home.shape[1] + self.shared.shape[0]


def _gram_fn():
    fn = build.load("gram").gram
    fn.argtypes = [_P, _LL, _I, _LL, _P, _I, _P, _LL, _I, _LL, _P, _I, _I, _I,
                   _I, _I, _I, _F, _F, _I, _P, _P, _P, _P, _P]
    fn.restype = _I
    return fn


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _norm_scratch(side: JobRows, dev) -> torch.Tensor:
    return torch.empty((side.jobs * side.per + side.shared.shape[0],),
                       dtype=torch.float32, device=dev)


def launch_gram(X: JobRows, Z: JobRows, jobs: int, kind: str, gamma: float,
                coef0: float, degree: int, symmetric: bool):
    """Launch on the current stream; inputs already checked (CUDA,
    contiguous, one row dtype, job counts 1 or ``jobs``). ``symmetric``:
    Z's rows are X's (see ``ops.same_rows``), so the bf16 route computes
    only the tiles holding a pair r ≤ c and mirrors them. → (K (jobs, X.n, Z.n) float32, route):
    route "tensor_core" (bf16 rows) or "simt" (f32 rows), as the library
    reports it."""
    dev = X.home.device
    d = X.home.shape[-1]
    K = torch.empty((jobs, X.n, Z.n), dtype=torch.float32, device=dev)
    xn = _norm_scratch(X, dev)
    zn = xn if symmetric else _norm_scratch(Z, dev)
    route = ctypes.c_int(-1)
    err = _gram_fn()(
        X.home.data_ptr(), X.per if X.jobs > 1 else 0, X.per,
        X.jobs * X.per, X.shared.data_ptr(), X.shared.shape[0],
        Z.home.data_ptr(), Z.per if Z.jobs > 1 else 0, Z.per,
        Z.jobs * Z.per, Z.shared.data_ptr(), Z.shared.shape[0],
        jobs, d, int(X.home.dtype == torch.bfloat16), int(symmetric),
        KINDS[kind], float(gamma), float(coef0), int(degree), xn.data_ptr(),
        zn.data_ptr(), K.data_ptr(), ctypes.addressof(route), _stream(dev))
    if err != 0:
        raise RuntimeError(f"gram kernel launch failed: cudaError {err}")
    return K, ("tensor_core" if route.value == 1 else "simt")


def _sparse_fn():
    fn = build.load("sparse_gram").sparse_gram
    fn.argtypes = [_P, _P, _LL, _I, _LL, _P, _P, _I, _I, _I, _I, _P, _LL, _P,
                   _P, _P, _LL, _I, _LL, _P, _I, _I, _I, _F, _F, _I, _P, _P,
                   _P, _P]
    fn.restype = _I
    return fn


def csc_view(Z: JobRows, d: int):
    """Z's nonzero slots in column-major order, per job: ``off``
    (Jz·d + 1,) int64 list bounds by (job, column), ``zrow`` int32 (the
    Z row of each entry) and ``zval``. A stable sort keeps each
    column's entries in row order; zero-valued (padding) slots drop,
    which changes no sum."""
    Jz, per, cap = Z.home.indices.shape
    S = Z.shared.indices.shape[0]
    dev = Z.home.indices.device
    idx = torch.cat([Z.home.indices,
                     Z.shared.indices.expand(Jz, S, cap)], 1)
    val = torch.cat([Z.home.values, Z.shared.values.expand(Jz, S, cap)], 1)
    n = per + S
    key = (torch.arange(Jz, device=dev)[:, None, None] * d
           + idx.long()).reshape(-1)
    row = torch.arange(n, dtype=torch.int32, device=dev)[None, :, None] \
        .expand(Jz, n, cap).reshape(-1)
    live = val.reshape(-1) != 0
    key, row, val = key[live], row[live], val.reshape(-1)[live]
    order = torch.sort(key, stable=True).indices
    off = torch.zeros((Jz * d + 1,), dtype=torch.int64, device=dev)
    off[1:] = torch.cumsum(torch.bincount(key, minlength=Jz * d), 0)
    return off, row[order].contiguous(), val[order].contiguous()


def launch_sparse_gram(X: JobRows, Z: JobRows, jobs: int, kind: str,
                       gamma: float, coef0: float, degree: int):
    """Launch on the current stream; inputs already checked (CUDA,
    ``SparseRows`` of one nnz_cap and value dtype, indices in [0, d),
    job counts 1 or ``jobs``). → K (jobs, X.n, Z.n) float32."""
    dev = X.home.values.device
    d = X.home.d
    cap = X.home.nnz_cap
    off, zrow, zval = csc_view(Z, d)
    K = torch.empty((jobs, X.n, Z.n), dtype=torch.float32, device=dev)
    xn, zn = _norm_scratch(X, dev), _norm_scratch(Z, dev)
    err = _sparse_fn()(
        X.home.indices.data_ptr(), X.home.values.data_ptr(),
        X.per if X.jobs > 1 else 0, X.per, X.jobs * X.per,
        X.shared.indices.data_ptr(), X.shared.values.data_ptr(),
        X.shared.shape[0], cap, jobs, Z.n, off.data_ptr(),
        d if Z.jobs > 1 else 0, zrow.data_ptr(), zval.data_ptr(),
        Z.home.values.data_ptr(), Z.per if Z.jobs > 1 else 0, Z.per,
        Z.jobs * Z.per, Z.shared.values.data_ptr(), Z.shared.shape[0],
        int(X.home.dtype == torch.bfloat16), KINDS[kind], float(gamma),
        float(coef0), int(degree), xn.data_ptr(), zn.data_ptr(),
        K.data_ptr(), _stream(dev))
    if err != 0:
        raise RuntimeError(
            f"sparse_gram kernel launch failed: cudaError {err}")
    return K
