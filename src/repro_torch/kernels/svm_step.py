"""Launch of the dual-CD solve kernels ``csrc/cd_solve.cu`` and
``csrc/cd_solve_sparse.cu``.

The counterpart of ``repro/kernels/svm_step.py: cd_epoch``: each job's
whole solve, every epoch with the reference's stop rule, runs on one
CTA (the single route) or on one thread-block cluster of c CTAs that
split the columns (the cluster route; c from
:func:`repro_torch.kernels.ops.cd_solve_cluster_size`); blocked-CSR
rows run on one CTA a job of ``cd_solve_sparse.cu`` (the sparse
route). Callers go through :func:`repro_torch.kernels.ops.cd_solve`,
which checks the inputs, counts launches by route and takes the plain
version for CPU tensors.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def _lib():
    lib = build.load("cd_solve")
    lib.cd_solve.argtypes = [_P, _P, _I, _P, _P, _I, _I, _I, _I, _F, _F, _I,
                             _P, _P, _P, _P, _P, _P]
    lib.cd_solve_cluster.argtypes = [_P, _P, _I, _P, _P, _I, _I, _I, _I, _F,
                                     _F, _I, _I, _P, _P, _P, _P, _P, _P]
    lib.cd_solve_cluster_occupancy.argtypes = [_I, _I, _I, _I, _P]
    for fn in (lib.cd_solve, lib.cd_solve_cluster,
               lib.cd_solve_cluster_occupancy, lib.cd_solve_cluster_vectors,
               lib.cd_solve_cluster_max_threads,
               lib.cd_solve_cluster_max_size, lib.cd_solve_cluster_stages):
        fn.restype = _I
    from repro_torch.kernels import ops
    if (lib.cd_solve_cluster_vectors(), lib.cd_solve_cluster_max_threads(),
            lib.cd_solve_cluster_max_size(), lib.cd_solve_cluster_stages()) \
            != (ops.CLUSTER_VECTORS, ops.CLUSTER_MAX_THREADS,
                ops.CLUSTER_MAX, ops.CLUSTER_STAGES):
        raise RuntimeError("cd_solve.cu and ops.cd_solve_cluster_size "
                           "disagree on the cluster route's limits")
    return lib


def max_active_clusters(dtype: torch.dtype, d: int, n: int, c: int) -> int:
    """Clusters of c CTAs of the cluster route for n rows of width d
    that can be resident on the current card at once
    (``cudaOccupancyMaxActiveClusters``)."""
    out = ctypes.c_int(0)
    err = _lib().cd_solve_cluster_occupancy(int(dtype == torch.bfloat16), d,
                                            n, c, ctypes.byref(out))
    if err != 0:
        raise RuntimeError(f"cd_solve cluster occupancy query failed: "
                           f"cudaError {err}")
    return out.value


def cluster_slice_cols(d: int, cluster: int, dtype: torch.dtype) -> int:
    """Columns each CTA of the cluster route owns, a contiguous slice
    (rank r: [r·W, (r + 1)·W) ∩ [0, d)): whole warps of threads, each
    with ``ops.CLUSTER_VECTORS`` 16-byte vectors."""
    from repro_torch.kernels import ops
    vec = 16 // (2 if dtype == torch.bfloat16 else 4)
    return ops.cluster_threads(d, cluster, dtype) * ops.CLUSTER_VECTORS * vec


def emulate_cluster(xh: torch.Tensor, xs: torch.Tensor, y: torch.Tensor,
                    m: torch.Tensor, *, C: float, tol: float,
                    max_epochs: int, cluster: int):
    """The cluster route's arithmetic in plain PyTorch: each row's
    (w·x, x·x) as ``cluster`` partials over the ranks' column slices
    (:func:`cluster_slice_cols`), added in rank order; otherwise the
    plain solve. → as :func:`ref.cd_solve_ref`."""
    d = xh.shape[2]
    W = cluster_slice_cols(d, cluster, xh.dtype)
    bounds = [(r * W, min((r + 1) * W, d)) for r in range(cluster)]

    def dots(w, x):
        wx = torch.zeros(x.shape[0], dtype=torch.float32, device=x.device)
        xx = torch.zeros_like(wx)
        for a, e in bounds:
            wx = wx + (w[:, a:e] * x[:, a:e]).sum(-1)
            xx = xx + (x[:, a:e] * x[:, a:e]).sum(-1)
        return wx, xx

    return ref.solve_with(xh, xs, y, m, C=C, tol=tol,
                          max_epochs=max_epochs, dots=dots)


def launch_cd_solve(xh: torch.Tensor, xs: torch.Tensor, y: torch.Tensor,
                    m: torch.Tensor, C: float, tol: float, max_epochs: int,
                    cluster: int):
    """Launch on the current stream; inputs already checked (CUDA,
    contiguous, rows bf16/f32, y/m f32); ``cluster`` CTAs a job (1: the
    single route; :func:`ops.cd_solve` passes its rule's size). A size
    the route does not take, or that the card cannot schedule, raises.
    → alpha, w, b, epochs, viol."""
    L, per, d = xh.shape
    S = xs.shape[0]
    dev = xh.device
    alpha = torch.empty((L, per + S), dtype=torch.float32, device=dev)
    w = torch.empty((L, d), dtype=torch.float32, device=dev)
    b = torch.empty((L,), dtype=torch.float32, device=dev)
    epochs = torch.empty((L,), dtype=torch.int32, device=dev)
    viol = torch.empty((L,), dtype=torch.float32, device=dev)
    head = (xh.data_ptr(), xs.data_ptr(), int(xh.dtype == torch.bfloat16),
            y.data_ptr(), m.data_ptr(), L, per, S, d, C, tol, max_epochs)
    tail = (w.data_ptr(), b.data_ptr(), epochs.data_ptr(), viol.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if cluster == 1:
        err = _lib().cd_solve(*head, alpha.data_ptr(), *tail)
    else:
        err = _lib().cd_solve_cluster(*head, cluster, alpha.data_ptr(),
                                      *tail)
    if err != 0:
        what = " (no cluster of that size can be resident)" if err == 9 \
            else ""
        raise RuntimeError(f"cd_solve kernel launch ({cluster} CTAs a job) "
                           f"failed: cudaError {err}{what}")
    return alpha, w, b, epochs, viol


def _sparse_lib():
    lib = build.load("cd_solve_sparse")
    lib.cd_solve_sparse.argtypes = [_P, _P, _P, _P, _I, _P, _P, _I, _I, _I,
                                    _I, _I, _F, _F, _I, _P, _P, _P, _P, _P,
                                    _P, _P]
    for fn in (lib.cd_solve_sparse, lib.cd_solve_sparse_max_cap):
        fn.restype = _I
    return lib


def launch_cd_solve_sparse(xh, xs, y: torch.Tensor, m: torch.Tensor,
                           C: float, tol: float, max_epochs: int):
    """Launch the sparse route on the current stream; inputs already
    checked (CUDA, contiguous leaves, one nnz_cap, int32 ids in [0, d),
    values bf16/f32 of one dtype, y/m f32). An nnz_cap above the
    kernel's limit raises. → alpha, w, b, epochs, viol."""
    lib = _sparse_lib()
    L, per, d = xh.shape
    S = xs.shape[0]
    cap = xh.nnz_cap
    limit = lib.cd_solve_sparse_max_cap()
    if cap > limit:
        raise ValueError(f"cd_solve on SparseRows takes nnz_cap up to "
                         f"{limit}, got {cap}")
    dev = y.device
    alpha = torch.empty((L, per + S), dtype=torch.float32, device=dev)
    q = torch.empty((L, per + S), dtype=torch.float32, device=dev)
    w = torch.zeros((L, d), dtype=torch.float32, device=dev)
    b = torch.empty((L,), dtype=torch.float32, device=dev)
    epochs = torch.empty((L,), dtype=torch.int32, device=dev)
    viol = torch.empty((L,), dtype=torch.float32, device=dev)
    err = lib.cd_solve_sparse(
        xh.indices.data_ptr(), xh.values.data_ptr(), xs.indices.data_ptr(),
        xs.values.data_ptr(), int(xh.dtype == torch.bfloat16), y.data_ptr(),
        m.data_ptr(), L, per, S, cap, d, C, tol, max_epochs, q.data_ptr(),
        alpha.data_ptr(), w.data_ptr(), b.data_ptr(), epochs.data_ptr(),
        viol.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"cd_solve_sparse kernel launch failed: "
                           f"cudaError {err}")
    return alpha, w, b, epochs, viol
