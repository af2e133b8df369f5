"""Launch of the dual-CD solve kernels ``csrc/cd_solve.cu`` and
``csrc/cd_solve_sparse.cu``.

The counterpart of ``repro/kernels/svm_step.py: cd_epoch``: each job's
whole solve, every epoch with the reference's stop rule, runs on one
CTA (the single route) or on one thread-block cluster of c CTAs that
split the columns (the cluster route; c from
:func:`repro_torch.kernels.ops.cd_solve_cluster_size`); blocked-CSR
rows run on one warp a job of ``cd_solve_sparse.cu`` (the sparse
route; :func:`emulate_sparse_lookahead` repeats its pipeline). Callers
go through :func:`repro_torch.kernels.ops.cd_solve`,
which checks the inputs, counts launches by route and takes the plain
version for CPU tensors.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build, ref

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def _lib():
    lib = build.load("cd_solve")
    head = [_P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P]
    lib.cd_solve.argtypes = head + [_P, _P, _P, _P, _P, _P]
    lib.cd_solve_cluster.argtypes = head + [_I, _P, _P, _P, _P, _P, _P]
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
                    m: torch.Tensor, *, C, tol, max_epochs, cluster: int):
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
                    m: torch.Tensor, C: torch.Tensor, tol: torch.Tensor,
                    max_epochs: torch.Tensor, cluster: int, layout=None):
    """Launch on the current stream; inputs already checked (CUDA,
    contiguous, rows bf16/f32, y/m f32; C, tol (L,) f32 and max_epochs
    (L,) int32 on the card); ``cluster`` CTAs a job (1: the single route;
    :func:`ops.cd_solve` passes its rule's size); ``layout`` as
    ``ops.job_layout`` gives it (default: that of xh and xs). A size
    the route does not take, or that the card cannot schedule, raises.
    → alpha, w, b, epochs, viol."""
    from repro_torch.kernels import ops
    L = y.shape[0]
    _, per, d = xh.shape
    S = xs.shape[-2]
    n_home, jps = layout or ops.job_layout(xh, xs, L)
    dev = xh.device
    alpha = torch.empty((L, per + S), dtype=torch.float32, device=dev)
    w = torch.empty((L, d), dtype=torch.float32, device=dev)
    b = torch.empty((L,), dtype=torch.float32, device=dev)
    epochs = torch.empty((L,), dtype=torch.int32, device=dev)
    viol = torch.empty((L,), dtype=torch.float32, device=dev)
    head = (xh.data_ptr(), xs.data_ptr(), int(xh.dtype == torch.bfloat16),
            y.data_ptr(), m.data_ptr(), L, per, S, d, n_home, jps,
            C.data_ptr(), tol.data_ptr(), max_epochs.data_ptr())
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


#: the sparse route's look-ahead depth: row i's gather of w is issued
#: min(SPARSE_AHEAD, n − 1) row steps early (``cd_solve_sparse.cu``'s
#: ``kAhead``); its table codes are δ << SPARSE_SLOT_BITS | slot
SPARSE_AHEAD = 2
SPARSE_SLOT_BITS = 11
#: the sparse route's consumer warps a CTA, at most
SPARSE_MAX_WARPS = 8


def _sparse_lib():
    lib = build.load("cd_solve_sparse")
    lib.cd_solve_sparse.argtypes = [_P, _P, _P, _P, _I, _P, _P, _I, _I, _I,
                                    _I, _I, _I, _P, _P, _P, _P, _P, _P, _I,
                                    _P, _P, _P, _P]
    lib.cd_solve_sparse_block_bytes.argtypes = [_I]
    for fn in (lib.cd_solve_sparse, lib.cd_solve_sparse_max_cap,
               lib.cd_solve_sparse_ahead, lib.cd_solve_sparse_max_warps,
               lib.cd_solve_sparse_block_bytes):
        fn.restype = _I
    if (lib.cd_solve_sparse_ahead(), lib.cd_solve_sparse_max_warps()) != \
            (SPARSE_AHEAD, SPARSE_MAX_WARPS):
        raise RuntimeError("cd_solve_sparse.cu and svm_step.py disagree on "
                           "the look-ahead depth or the warps a CTA")
    return lib


def sparse_lookahead(n: int, ahead: int = SPARSE_AHEAD) -> int:
    """Row steps by which the sparse route issues a row's gather early
    for n rows a job: at least 1 (the gather is issued after a step's
    barrier), and never so many that a row is in its own window unless
    n = 1 (where the row's step before is its only window)."""
    return max(1, min(ahead, n - 1))


def lookahead_table(ids: torch.Tensor, live: torch.Tensor,
                    k: int) -> torch.Tensor:
    """The sparse route's look-ahead table of one job's n rows (ids (n,
    cap), live (n, cap) bool), as ``cds_prep_kernel`` builds it: for a
    live slot of row i, the nearest δ ∈ 1..k such that row (i − δ) mod n
    (the row δ steps before, across the epoch's end) holds the same
    column in a live slot s', coded δ << ``SPARSE_SLOT_BITS`` | s'; 0
    where none does. → (n, cap) int64."""
    n, cap = ids.shape
    code = torch.zeros((n, cap), dtype=torch.int64, device=ids.device)
    slot = torch.arange(cap, device=ids.device)
    for delta in range(k, 0, -1):
        ids_p, live_p = ids.roll(delta, 0), live.roll(delta, 0)
        match = (ids[:, :, None] == ids_p[:, None, :]) \
            & live[:, :, None] & live_p[:, None, :]           # (n, cap, cap)
        hit = match.any(-1)
        src = (match * (slot + 1)).amax(-1) - 1               # the one match
        code = torch.where(hit, (delta << SPARSE_SLOT_BITS) | src, code)
    return code


def _kernel_order_sum(p: torch.Tensor, live: torch.Tensor) -> torch.Tensor:
    """Σ over the last axis (nnz_cap slots) as the sparse route's CTA adds
    it: W = min(8, ⌈cap / 32⌉) warps of 32 threads, thread t adding its
    live slots t, t + 32W in turn (value-0 slots skipped), a warp's lanes
    paired as xor shuffles 16, 8, 4, 2, 1, then the warps' sums added in
    warp order from 0."""
    cap = p.shape[-1]
    warps = min(SPARSE_MAX_WARPS, -(-cap // 32))
    threads = 32 * warps
    pad = -cap % threads
    p = torch.nn.functional.pad(p, (0, pad)).unflatten(-1, (-1, warps, 32))
    live = torch.nn.functional.pad(live, (0, pad)).unflatten(
        -1, (-1, warps, 32))
    acc = torch.zeros(p.shape[:-3] + (warps, 32), dtype=p.dtype,
                      device=p.device)
    for j in range(p.shape[-3]):
        acc = torch.where(live[..., j, :, :], acc + p[..., j, :, :], acc)
    while acc.shape[-1] > 1:
        half = acc.shape[-1] // 2
        acc = acc[..., :half] + acc[..., half:]
    total = torch.zeros(acc.shape[:-2], dtype=p.dtype, device=p.device)
    for q in range(warps):
        total = total + acc[..., q, 0]
    return total


def emulate_sparse_lookahead(xh, xs, y: torch.Tensor, m: torch.Tensor, *,
                             C, tol, max_epochs,
                             ahead: int = SPARSE_AHEAD,
                             order: str = "kernel", correct: bool = True):
    """The ``cd_solve/sparse`` kernel's pipeline in plain PyTorch: w lives
    in a "memory" that a row step writes at its live slots when its Δ ≠
    0; the gather for step g + k is taken from that memory at step g,
    after the stores of steps ≤ g − 1 (k = :func:`sparse_lookahead`);
    at step g a live slot with a :func:`lookahead_table` entry δ (δ ≤ g)
    takes the value that step g − δ left at the matching slot (its read,
    plus Δy·v) instead of the value gathered; ``correct=False`` skips
    that and keeps the stale read. ``order="kernel"`` sums w·x as the
    kernel's CTA does (:func:`_kernel_order_sum`), ``"plain"`` as
    ``ref.cd_solve_sparse_ref`` does, with which it is then equal bit for
    bit. The jobs go in step, as in the plain version; a stopped job
    changes nothing. → alpha, w, b, epochs, viol as
    :func:`ref.cd_solve_sparse_ref`."""
    L, per, d = xh.shape
    S, cap = xs.shape[0], xh.nnz_cap
    n = per + S
    dev = y.device
    ids = torch.cat([xh.indices.long(),
                     xs.indices.long().expand(L, S, cap)], 1)   # (L, n, cap)
    vals = torch.cat([xh.values.float(),
                      xs.values.float().expand(L, S, cap)], 1)
    live = vals != 0
    k = sparse_lookahead(n, ahead)
    tab = torch.stack([lookahead_table(ids[l], live[l], k)
                       for l in range(L)]) if n else ids
    q = torch.cat([ref.sparse_sq_norms(xh.values),
                   ref.sparse_sq_norms(xs.values).expand(L, -1)], 1)
    y, m = y.float(), m.float()
    q = torch.where(m > 0, q + 1.0, 1.0)
    alpha = torch.zeros((L, n), dtype=torch.float32, device=dev)
    memory = torch.zeros((L, d), dtype=torch.float32, device=dev)
    b = torch.zeros((L,), dtype=torch.float32, device=dev)
    viol = torch.full((L,), math.inf, dtype=torch.float32, device=dev)
    t = torch.zeros((L,), dtype=torch.int32, device=dev)
    jobs = torch.arange(L, device=dev)[:, None].expand(L, cap)
    reads, records = {}, {}

    def issue(step):
        reads[step] = memory.gather(1, ids[:, step % n])

    for step in range(k if n else 0):
        issue(step)
    g = 0
    while True:
        active = (t < max_epochs) & ((t == 0) | (viol > tol))
        if not bool(active.any()):
            break
        ep = torch.zeros_like(b)
        for i in range(n):
            issue(g + k)
            x = reads.pop(g)
            lv, v = live[:, i], vals[:, i]
            if correct:
                back = tab[:, i] >> SPARSE_SLOT_BITS
                src = tab[:, i] & ((1 << SPARSE_SLOT_BITS) - 1)
                for delta in range(1, min(k, g) + 1):
                    sel = lv & (back == delta)
                    x = torch.where(sel, records[g - delta].gather(1, src), x)
            x = torch.where(lv, x, 0.0)
            wx = (x * v).sum(-1) if order == "plain" \
                else _kernel_order_sum(x * v, lv)
            coef, v_i = ref._cd_step(wx, q[:, i], y, m, alpha, i, b, C,
                                     active.float())
            out = x + coef[:, None] * v
            st = lv | torch.isnan(coef)[:, None]  # a NaN step writes all
            memory[jobs[st], ids[:, i][st]] = out[st]
            records[g] = out
            records.pop(g - k - 1, None)
            ep = torch.maximum(ep, v_i)
            g += 1
        viol = torch.where(active, ep, viol)
        t += active.int()
    return alpha, memory, b, t, viol


def launch_cd_solve_sparse(xh, xs, y: torch.Tensor, m: torch.Tensor,
                           C: torch.Tensor, tol: torch.Tensor,
                           max_epochs: torch.Tensor, layout=None):
    """Launch the sparse route on the current stream; inputs already
    checked (CUDA, contiguous leaves, one nnz_cap, int32 ids in [0, d),
    values bf16/f32 of one dtype, y/m f32; C, tol (L,) f32 and
    max_epochs (L,) int32 on the card; ``layout`` as for
    :func:`launch_cd_solve`). An nnz_cap above the kernel's limit
    raises. w comes back as the (L, d) view of a (d, 8⌈L/8⌉) array,
    hypotheses adjacent, which the ``hinge_scores/sparse`` kernel reads
    in chunks of 8 without a copy. → alpha, w, b, epochs, viol."""
    from repro_torch.kernels import ops
    lib = _sparse_lib()
    L = y.shape[0]
    _, per, d = xh.shape
    S = xs.shape[-2]
    n_home, jps = layout or ops.job_layout(xh, xs, L)
    cap = xh.nnz_cap
    limit = lib.cd_solve_sparse_max_cap()
    if cap > limit:
        raise ValueError(f"cd_solve on SparseRows takes nnz_cap up to "
                         f"{limit}, got {cap}")
    bf16 = int(xh.dtype == torch.bfloat16)
    dev = y.device
    ldw = -(-L // 8) * 8
    blocks = torch.empty(((per + S) * L * lib.cd_solve_sparse_block_bytes(
        cap),), dtype=torch.uint8, device=dev)
    alpha = torch.empty((L, per + S), dtype=torch.float32, device=dev)
    w = torch.zeros((d, ldw), dtype=torch.float32, device=dev)
    b = torch.empty((L,), dtype=torch.float32, device=dev)
    epochs = torch.empty((L,), dtype=torch.int32, device=dev)
    viol = torch.empty((L,), dtype=torch.float32, device=dev)
    err = lib.cd_solve_sparse(
        xh.indices.data_ptr(), xh.values.data_ptr(), xs.indices.data_ptr(),
        xs.values.data_ptr(), bf16, y.data_ptr(), m.data_ptr(), L, per, S,
        n_home, jps, cap, C.data_ptr(), tol.data_ptr(), max_epochs.data_ptr(),
        blocks.data_ptr(), alpha.data_ptr(),
        w.data_ptr(), ldw, b.data_ptr(), epochs.data_ptr(), viol.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"cd_solve_sparse kernel launch failed: "
                           f"cudaError {err}")
    return alpha, w[:, :L].T, b, epochs, viol
