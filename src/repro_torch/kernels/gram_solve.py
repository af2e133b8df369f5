"""Launch of the Gram dual-CD solve kernel ``csrc/cd_solve_gram.cu``.

The counterpart of the row loop of ``repro/core/svm.py:
fit_binary_kernel``, which the JAX package leaves to XLA: one
thread-block cluster of c CTAs per job (c from
:func:`repro_torch.kernels.ops.cd_solve_gram_cluster_size`; 1 is the
single route) runs the whole solve with the reference's stop rule, rows
in tiles of ``ops.GRAM_SOLVE_TILE``. Callers go through
:func:`repro_torch.kernels.ops.cd_solve_gram`, which checks the inputs,
counts launches by route and takes the plain version for CPU tensors.
:func:`emulate_tiled` is the kernel's arithmetic in plain PyTorch.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def _lib():
    lib = build.load("cd_solve_gram")
    lib.cd_solve_gram.argtypes = [_P, _I, _P, _P, _I, _I, _I, _P, _P, _P, _P,
                                  _P, _P, _P]
    lib.cd_solve_gram_occupancy.argtypes = [_I, _I, _I, _P]
    for fn in (lib.cd_solve_gram, lib.cd_solve_gram_occupancy,
               lib.cd_solve_gram_tile, lib.cd_solve_gram_max_cluster,
               lib.cd_solve_gram_max_rows_per_cta):
        fn.restype = _I
    from repro_torch.kernels import ops
    if (lib.cd_solve_gram_tile(), lib.cd_solve_gram_max_cluster(),
            lib.cd_solve_gram_max_rows_per_cta()) != \
            (ops.GRAM_SOLVE_TILE, ops.GRAM_SOLVE_MAX_CLUSTER,
             ops.GRAM_SOLVE_MAX_ROWS_PER_CTA):
        raise RuntimeError("cd_solve_gram.cu and ops.cd_solve_gram_cluster_"
                           "size disagree on the kernel's limits")
    return lib


def max_active_clusters(dtype: torch.dtype, n: int, c: int) -> int:
    """Clusters of c CTAs for n rows a job that can be resident on the
    current card at once (``cudaOccupancyMaxActiveClusters``)."""
    out = ctypes.c_int(0)
    err = _lib().cd_solve_gram_occupancy(int(dtype == torch.bfloat16), n, c,
                                         ctypes.byref(out))
    if err != 0:
        raise RuntimeError(f"cd_solve_gram occupancy query failed: "
                           f"cudaError {err}")
    return out.value


def launch_cd_solve_gram(K: torch.Tensor, y: torch.Tensor, m: torch.Tensor,
                         C: torch.Tensor, tol: torch.Tensor,
                         max_epochs: torch.Tensor, cluster: int):
    """Launch on the current stream with ``cluster`` CTAs a job; inputs
    already checked (CUDA, contiguous, K (L, n, n) and y, m (L, n) of one
    dtype, f32 or bf16; C, tol (L,) f32 and max_epochs (L,) int32 on the
    card). A size the kernel does not take, or that the
    card cannot schedule, raises. → alpha (L, n), epochs (L,) int32,
    viol (L,)."""
    L, n, _ = K.shape
    dev = K.device
    alpha = torch.empty((L, n), dtype=K.dtype, device=dev)
    epochs = torch.empty((L,), dtype=torch.int32, device=dev)
    viol = torch.empty((L,), dtype=K.dtype, device=dev)
    err = _lib().cd_solve_gram(
        K.data_ptr(), int(K.dtype == torch.bfloat16), y.data_ptr(),
        m.data_ptr(), L, n, int(cluster), C.data_ptr(), tol.data_ptr(),
        max_epochs.data_ptr(), alpha.data_ptr(), epochs.data_ptr(),
        viol.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        what = " (no cluster of that size can be resident)" if err == 9 \
            else ""
        raise RuntimeError(f"cd_solve_gram kernel launch ({cluster} CTAs a "
                           f"job) failed: cudaError {err}{what}")
    return alpha, epochs, viol


def emulate_tiled(K: torch.Tensor, y: torch.Tensor, m: torch.Tensor, *,
                  C: float, tol: float, max_epochs: int, tile: int,
                  cluster: int):
    """The kernel's arithmetic in plain PyTorch, in the state dtype (K's):
    per job, rows in tiles of ``tile`` owned by ``cluster`` ranks of
    :func:`repro_torch.kernels.ops.gram_solve_rows_per_cta` rows each;
    each tile's chain (Δ_k, then Δ_k·Q_jk into the tile's own g, k in
    order), then the rank-``tile`` update of every rank's other rows, k
    in order, skipping Δ = 0; the epoch's violation as the maximum of
    the ranks' maxima. Each job runs its own stop rule. → as
    :func:`repro_torch.kernels.ref.cd_solve_gram_ref`."""
    from repro_torch.kernels import ops
    L, n, _ = K.shape
    dt, dev = K.dtype, K.device
    W = ops.gram_solve_rows_per_cta(n, cluster, tile)
    owned = [(r * W, min((r + 1) * W, n)) for r in range(cluster)]
    Cv = torch.tensor(C, dtype=dt)
    tolv = torch.tensor(tol, dtype=dt)
    zero = torch.zeros((), dtype=dt)
    alpha = torch.zeros((L, n), dtype=dt, device=dev)
    epochs = torch.zeros((L,), dtype=torch.int32, device=dev)
    viols = torch.full((L,), math.inf, dtype=dt, device=dev)
    for job in range(L):
        yj, mj = y[job].to(dt), m[job].to(dt)
        Q = (yj[:, None] * yj[None, :]) * (K[job] + 1.0)
        Q = Q * (mj[:, None] * mj[None, :])
        qd = torch.where(mj > 0, torch.diagonal(Q),
                         torch.ones((), dtype=dt))
        a = torch.zeros((n,), dtype=dt)
        g = -torch.ones((n,), dtype=dt) * mj
        viol = torch.tensor(math.inf, dtype=dt)
        t = 0
        while t < max_epochs and (t == 0 or bool(viol > tolv)):
            rank_max = [zero] * cluster
            for i0 in range(0, n, tile):
                rows = range(i0, min(i0 + tile, n))
                own = i0 // W
                deltas = []
                for i in rows:                        # the chain
                    gi, ao = g[i], a[i]
                    pg = torch.where(ao <= 0, torch.minimum(gi, zero),
                                     torch.where(ao >= Cv,
                                                 torch.maximum(gi, zero), gi))
                    an = torch.clamp(ao - gi / qd[i], min=zero, max=Cv)
                    d = (an - ao) * mj[i]
                    a[i] = ao + d
                    rank_max[own] = torch.maximum(rank_max[own],
                                                  pg.abs() * mj[i])
                    if d != 0:
                        g[i0:i0 + tile] = g[i0:i0 + tile] + d * Q[i0:i0 + tile,
                                                                  i]
                    deltas.append((i, d))
                for lo, hi in owned:                  # the rank update
                    for i, d in deltas:
                        if d == 0:
                            continue
                        for a0, a1 in ((lo, min(hi, i0)),
                                       (max(lo, i0 + tile), hi)):
                            if a0 < a1:
                                g[a0:a1] = g[a0:a1] + d * Q[a0:a1, i]
            viol = torch.stack(rank_max).max()
            t += 1
        alpha[job], epochs[job], viols[job] = a, t, viol
    return alpha, epochs, viols
