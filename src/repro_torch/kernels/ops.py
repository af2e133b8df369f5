"""Public wrappers of the hand-written kernels, with launch counts.

A wrapper checks device, dtype, shape and contiguity. For tensors on
the CPU it runs the plain PyTorch version (:mod:`repro_torch.kernels.
ref`); for CUDA tensors it launches the kernel, or raises. There is no
fallback from one to the other.

``LAUNCHES`` counts the kernel launches of each wrapper, so that a run
can show that its main path went through the kernels; ``ROUTE_LAUNCHES``
splits the launches by route: for ``gram``, ``hinge_scores`` and
``flash_decode`` the bf16 tensor-core kernel or the SIMT one, for
``cd_solve`` and ``cd_solve_gram`` one CTA or one thread-block cluster
per job, for ``sparse_gram`` the Gram or the fused decision scores
(:func:`sparse_gram_scores`); ``cd_solve/sparse`` and
``hinge_scores/sparse`` are the blocked-CSR kernels of the linear
path. The rules that pick a route
(:func:`decode_route`, :func:`cd_solve_cluster_size`,
:func:`cd_solve_gram_cluster_size`) are plain functions of shapes and
dtypes.

Each wrapper records its call's signature at its entry, on either
device (:func:`repro_torch.analysis.retrace.note_signature`): the first
call of a signature in the process is a compile event of the retrace
rule. Recording counts no launch. The linter's rules read a plain
version as one op (:func:`repro_torch.analysis.base.run_plain`).

Shape-only tensors (``meta`` tensors, and the fake tensors of
``FakeTensorMode`` that the dry run traces a rank's step with,
:mod:`repro_torch.launch.dryrun`) take a wrapper's shape rule
(:func:`shape_only`), the counterpart of ``pallas_call(out_shape=...)``:
the kernel's outputs, and its workspaces for as long as the launch holds
them, as empty tensors of the kernel's shapes and dtypes on the inputs'
device, and, under :func:`record_kernel_work`, its FLOPs and bytes by
the formulas of its bound in PERF.md §6. A real tensor never takes it:
a CUDA tensor still launches the kernel or raises, a CPU tensor runs
the plain version. A rule counts no launch. The rules cover the
kernels of the dry run's steps: ``cd_solve`` and ``hinge_scores`` on
dense and ``SparseRows`` rows, and ``decode_attention``.

The solve and Gram wrappers take their hyper-parameters (C, tol and
the epoch cutoff; γ and coef0) as a number for every job or as a
(jobs,) tensor, one value a job (:func:`job_values`), and run a sweep's
jobs in one launch. Their rows come as home blocks (n_home, per, ·) and
shared rows (S, ·), or a stack of shared blocks (B, S, ·): job l reads
home block l % n_home and shared block l // jobs_per_shared, with
jobs_per_shared = jobs / B (:func:`job_layout`).
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, NamedTuple, Optional

import torch

from repro_torch import sparse as sparse_rows
from repro_torch.analysis.base import run_plain
from repro_torch.analysis.retrace import note_signature
from repro_torch.kernels import ref

LAUNCHES: Dict[str, int] = {"cd_solve": 0, "hinge_scores": 0, "gram": 0,
                            "sparse_gram": 0, "cd_solve_gram": 0,
                            "flash_decode": 0}
ROUTE_LAUNCHES: Dict[str, int] = {"gram/tensor_core": 0, "gram/simt": 0,
                                  "hinge_scores/tensor_core": 0,
                                  "hinge_scores/simt": 0,
                                  "flash_decode/tensor_core": 0,
                                  "flash_decode/simt": 0,
                                  "cd_solve/cluster": 0,
                                  "cd_solve/single": 0,
                                  "cd_solve_gram/cluster": 0,
                                  "cd_solve_gram/single": 0,
                                  "cd_solve/sparse": 0,
                                  "sparse_gram/gram": 0,
                                  "sparse_gram/scores": 0,
                                  "hinge_scores/sparse": 0}

_ROW_DTYPES = (torch.float32, torch.bfloat16)


def reset_launches() -> None:
    for counts in (LAUNCHES, ROUTE_LAUNCHES):
        for k in counts:
            counts[k] = 0


# ---------------------------------------------------------------------------
# Shape rules: a kernel's outputs and work on shape-only tensors
# ---------------------------------------------------------------------------

class KernelWork(NamedTuple):
    """A kernel launch's work as its shape rule reckons it (one a launch
    the wrapper would count, under the route it would count): FLOPs and
    bytes (each input read once, each output written once) by the
    formulas of its bound in PERF.md §6. The solves' are an epoch's,
    ``epochs`` the call's epoch cutoff (None when the cutoff is a
    tensor, whose value a shape-only run cannot read); the others'
    ``epochs`` is 1. Work that depends on the data (rows whose α moves,
    live slots, valid cache positions) is counted at its most."""
    name: str
    route: str
    flops: float
    nbytes: float
    epochs: Optional[int]


_WORK: Optional[List[KernelWork]] = None


@contextlib.contextmanager
def record_kernel_work():
    """Record the :class:`KernelWork` of every shape rule run inside the
    block; yields the list, in call order."""
    global _WORK
    prev, _WORK = _WORK, []
    try:
        yield _WORK
    finally:
        _WORK = prev


def _note_work(name: str, route: str, flops: float, nbytes: float,
               epochs: Optional[int] = 1) -> None:
    if _WORK is not None:
        _WORK.append(KernelWork(name, route, float(flops), float(nbytes),
                                epochs))


def _is_shape_only(t) -> bool:
    if sparse_rows.is_sparse(t):
        return _is_shape_only(t.values) or _is_shape_only(t.indices)
    if not isinstance(t, torch.Tensor):
        return False
    if t.is_meta:
        return True
    from torch._subclasses.fake_tensor import is_fake
    return is_fake(t)


def shape_only(*ts) -> bool:
    """Whether any of ``ts`` (tensors or ``SparseRows``) is shape-only:
    a ``meta`` tensor or a fake tensor. A mix of shape-only and real
    tensors raises."""
    flags = [_is_shape_only(t) for t in ts
             if isinstance(t, torch.Tensor) or sparse_rows.is_sparse(t)]
    _check(all(flags) or not any(flags),
           "a kernel call mixes shape-only and real tensors")
    return bool(flags) and flags[0]


def _empty(like: torch.Tensor, shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device=like.device)


def _epochs_of(max_epochs) -> Optional[int]:
    """The epoch cutoff as a number when it is one (a tensor's value is
    not readable on shape-only inputs)."""
    return None if isinstance(max_epochs, torch.Tensor) else int(max_epochs)


def _solve_outputs(like, L: int, n: int, d: int, w=None):
    f32 = torch.float32
    return (_empty(like, (L, n), f32),
            _empty(like, (L, d), f32) if w is None else w,
            _empty(like, (L,), f32), _empty(like, (L,), torch.int32),
            _empty(like, (L,), f32))


def _rule_cd_solve(xh, xs, y, m, max_epochs):
    """``cd_solve``'s outputs on dense rows; an epoch's work: the home
    and shared rows, y and m read, α, w, b, epochs and viol written;
    2·L·n·d FLOPs for w·x and 2·L·n·d for the updates of rows whose α
    moves (every row, at most)."""
    L, n = y.shape
    d = xh.shape[-1]
    rows = (xh.numel() + xs.numel()) * xh.element_size()
    route = "cluster" if cd_solve_cluster_size(n, d, xh.dtype) > 1 \
        else "single"
    _note_work("cd_solve", route, 4.0 * L * n * d,
               rows + 2 * L * n * 4 + L * n * 4 + L * d * 4 + 3 * L * 4,
               _epochs_of(max_epochs))
    return _solve_outputs(y, L, n, d)


#: ``csrc/cd_solve_sparse.cu``'s row-block bytes for nnz_cap slots
#: (``block_bytes``): the prep kernel's staged copy of every row of
#: every job, which the launch holds
def sparse_block_bytes(cap: int) -> int:
    return cap * 16 + 16


def _rule_cd_solve_sparse(xh, xs, y, m, max_epochs):
    """``cd_solve/sparse``'s outputs, w as the (L, d) view of a (d,
    8⌈L/8⌉) array, and the prep kernel's row blocks held for the
    launch; an epoch's work as the dense rule's over the slots (every
    slot live, at most)."""
    L, n = y.shape
    d, cap = xh.shape[-1], xh.nnz_cap
    blocks = _empty(y, (n * L * sparse_block_bytes(cap),), torch.uint8)
    w = torch.zeros((d, -(-L // 8) * 8), dtype=torch.float32,
                    device=y.device)
    slots = (xh.values.numel() + xs.values.numel()) \
        * (4 + xh.values.element_size())
    _note_work("cd_solve", "sparse", 4.0 * L * n * cap,
               slots + 2 * L * n * 4 + L * n * 4 + L * d * 4 + 3 * L * 4,
               _epochs_of(max_epochs))
    out = _solve_outputs(y, L, n, d, w[:, :L].T)
    del blocks
    return out


def _rule_hinge_scores(X, W, b, y, m):
    """``hinge_scores``' outputs, launched in chunks of
    ``MAX_HYPOTHESES`` as the kernel is, each chunk's workspace held for
    its launch (bf16 rows: the W planes and the slab partials; f32
    rows: the tile partials; blocked-CSR rows: W packed and the tile
    partials, 64 rows a tile); a launch's work: X, its W, b, y and m
    read, its sums written, 2·n·d·L FLOPs (2·n·nnz_cap·L on blocked-CSR
    rows)."""
    from repro_torch.kernels.hinge_score import (MAX_HYPOTHESES, PLANES,
                                                 SLAB_COLS)
    n, d = X.shape
    f32 = torch.float32
    sparse = sparse_rows.is_sparse(X)
    if sparse:
        route, rows = "sparse", X.values.numel() * (
            4 + X.values.element_size())
        width = X.nnz_cap
    else:
        route = "tensor_core" if X.dtype == torch.bfloat16 else "simt"
        rows, width = X.numel() * X.element_size(), d
    losses = []
    for l0 in range(0, W.shape[0], MAX_HYPOTHESES):
        L = min(MAX_HYPOTHESES, W.shape[0] - l0)
        if sparse:
            work = [_empty(W, (d, MAX_HYPOTHESES), f32),
                    _empty(W, (max(1, -(-n // 64)), MAX_HYPOTHESES + 1),
                           f32)]
        elif route == "tensor_core":
            dp = max(1, -(-d // SLAB_COLS)) * SLAB_COLS
            work = [_empty(W, (PLANES, MAX_HYPOTHESES, dp), torch.bfloat16),
                    _empty(W, (dp // SLAB_COLS, n, MAX_HYPOTHESES), f32)]
        else:
            work = [_empty(W, (-(-n // 64), L), f32)]
        losses.append(_empty(W, (L,), f32))
        del work
        _note_work("hinge_scores", route, 2.0 * n * width * L,
                   rows + L * d * 4 + L * 4 + 2 * n * 4 + L * 4 + 4)
    return (losses[0] if len(losses) == 1 else torch.cat(losses)), \
        _empty(W, (), f32)


#: ``csrc/flash_decode.cu``'s cache positions a CTA on the SIMT route
#: (``kChunk``); the tensor-core route picks its chunk from the card's
#: SMs at run time, so the rule reckons the workspace at this one
FLASH_DECODE_CHUNK = 512


def _rule_decode_attention(q, k, v):
    """``flash_decode``'s output and its split partials; the work: K and
    V read (every position: valid_len is not readable), q read, the
    output written, 4·B·H·S·hd FLOPs at the bf16 tensor-core rate."""
    B, H, hd = q.shape
    KV, S = k.shape[1], k.shape[2]
    splits = -(-S // FLASH_DECODE_CHUNK)
    work = [_empty(q, (B, H, splits), torch.float32) for _ in range(2)] \
        + [_empty(q, (B, H, splits, hd), torch.float32)]
    out = _empty(q, q.shape, q.dtype)
    del work
    _note_work("flash_decode", decode_route(q.dtype, hd),
               4.0 * B * H * S * hd,
               2 * B * KV * S * hd * k.element_size()
               + 2 * B * H * hd * q.element_size() + 4)
    return out


def _plain(fn, *args, **kwargs):
    """A kernel's plain version on CPU tensors; the linter's rules read
    it as one op (:func:`repro_torch.analysis.base.run_plain`)."""
    name = getattr(args[0], "__name__", "") if fn is per_job else ""
    return run_plain(name or fn.__name__, fn, *args, **kwargs)


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


def job_values(value, jobs: int, device, dtype=torch.float32
               ) -> torch.Tensor:
    """A hyper-parameter as a (jobs,) tensor on ``device``: a number for
    every job, a 0-dim tensor likewise, or a (jobs,) tensor as it is
    (cast to ``dtype``)."""
    if not isinstance(value, torch.Tensor):
        return torch.full((jobs,), value, dtype=dtype, device=device)
    _check(value.dim() == 0 or tuple(value.shape) == (jobs,),
           f"a per-job value must be a number or ({jobs},), got "
           f"{tuple(value.shape)}")
    _check(value.device == torch.device(device),
           f"per-job values on {value.device}, rows on {device}")
    return value.to(dtype).expand(jobs).contiguous()


def _epoch_cutoffs(max_epochs, jobs: int, device) -> torch.Tensor:
    """Epoch cutoffs (whole numbers) as (jobs,) int32."""
    if not isinstance(max_epochs, torch.Tensor):
        max_epochs = int(max_epochs)
    return job_values(max_epochs, jobs, device, torch.int32)


def job_layout(home, shared, jobs: int):
    """The job axis of home rows (n_home, per, ·) and shared rows (S,
    ·) or (B, S, ·): job l reads home block l % n_home and shared block
    l // jobs_per_shared. → (n_home, jobs_per_shared)."""
    n_home = home.shape[0]
    B = shared.shape[0] if len(shared.shape) == 3 else 1
    _check(n_home >= 1 and jobs % n_home == 0,
           f"{jobs} jobs do not cycle over {n_home} home blocks")
    _check(B >= 1 and jobs % B == 0,
           f"{jobs} jobs do not split over {B} shared blocks")
    return n_home, jobs // B


#: the cluster route's limits (``csrc/cd_solve.cu``, namespace ``cl``):
#: the largest cluster, threads a CTA, 16-byte column vectors a thread,
#: rows in its ring, dynamic shared memory a CTA
CLUSTER_MAX = 16
CLUSTER_MAX_THREADS = 512
CLUSTER_VECTORS = 4
CLUSTER_STAGES = 4
CLUSTER_SMEM = 232448


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def cluster_threads(d: int, c: int, dtype: torch.dtype) -> int:
    """Threads of a CTA of the cluster route: whole warps owning, with
    ``CLUSTER_VECTORS`` 16-byte vectors each, a c-th of d's columns."""
    vec = 16 // (2 if dtype == torch.bfloat16 else 4)
    vectors = _ceil_div(d // vec, c)
    return _ceil_div(_ceil_div(vectors, CLUSTER_VECTORS), 32) * 32


def cluster_smem(d: int, n: int, c: int, dtype: torch.dtype) -> int:
    """Shared memory of a CTA of the cluster route: the ring of row
    slices, the partials' slots and the CTA's copy of α."""
    t = cluster_threads(d, c, dtype)
    return CLUSTER_STAGES * CLUSTER_VECTORS * t * 16 + 2 * c * (t // 32) * 8 \
        + 4 * n


def cd_solve_cluster_size(n: int, d: int, dtype: torch.dtype) -> int:
    """CTAs per job of ``cd_solve`` on the card for n rows of width d; 1
    is the single route.

    The smallest power of two whose CTAs hold w's slice in the registers
    of at most ``CLUSTER_MAX_THREADS`` threads (``CLUSTER_VECTORS``
    16-byte vectors each), doubled until a CTA's shared memory
    (:func:`cluster_smem`, which grows with the n rows' α) fits. 1 when
    rows are not whole 16-byte vectors, when there are no rows, or when
    no cluster of up to ``CLUSTER_MAX`` CTAs fits (the single route
    keeps w in global memory). At d = 131072 bf16 this gives 8, which
    ran faster than 16 (PERF.md §6); at the golden d = 1024, 1.
    """
    vec = 16 // (2 if dtype == torch.bfloat16 else 4)
    if n < 1 or d % vec:
        return 1
    c = 1
    while c * CLUSTER_MAX_THREADS * CLUSTER_VECTORS * vec < d:
        c *= 2
    while 1 < c <= CLUSTER_MAX and cluster_smem(d, n, c, dtype) > CLUSTER_SMEM:
        c *= 2
    return c if c <= CLUSTER_MAX else 1


def cd_solve(xh, xs, y: torch.Tensor, m: torch.Tensor, *, C, tol,
             max_epochs):
    """Dual-CD solve of L jobs (see :func:`ref.cd_solve_ref`).

    xh (n_home, per, d) and xs (S, d) or (B, S, d) rows (f32 or bf16,
    one dtype), dense or both ``SparseRows`` of one nnz_cap (the
    ``cd_solve/sparse`` route); job l trains on ``[xh[l % n_home];
    its shared block]`` (:func:`job_layout`); y, m (L, per + S) f32. C,
    tol and max_epochs (whole) are numbers or (L,) tensors
    (:func:`job_values`). → alpha (L, n), w (L, d), b (L,), epochs (L,)
    int32, viol (L,). On the card, dense rows run on
    :func:`cd_solve_cluster_size` CTAs a job; a size the card cannot
    schedule raises.
    """
    note_signature("cd_solve", xh, xs, y, m, C=C, tol=tol,
                   max_epochs=max_epochs)
    _check(len(xh.shape) == 3 and len(xs.shape) in (2, 3),
           f"xh must be (n_home, per, d) and xs (S, d) or (B, S, d), got "
           f"{tuple(xh.shape)} and {tuple(xs.shape)}")
    _, per, d = xh.shape
    L = y.shape[0]
    n = per + xs.shape[-2]
    _check(xs.shape[-1] == d, f"xs has {xs.shape[-1]} features, xh {d}")
    _check(tuple(y.shape) == (L, n) and tuple(m.shape) == (L, n),
           f"y and m must be {(L, n)}, got {tuple(y.shape)}/{tuple(m.shape)}")
    layout = job_layout(xh, xs, L)
    kw = dict(C=job_values(C, L, y.device), tol=job_values(tol, L, y.device),
              max_epochs=_epoch_cutoffs(max_epochs, L, y.device))
    if sparse_rows.is_sparse(xh) or sparse_rows.is_sparse(xs):
        return _cd_solve_sparse(xh, xs, y, m, layout, max_epochs, **kw)
    _check(xh.dtype in _ROW_DTYPES and xs.dtype == xh.dtype,
           f"rows must be one of {_ROW_DTYPES}, got {xh.dtype}/{xs.dtype}")
    if shape_only(xh, xs, y, m):
        return _rule_cd_solve(xh, xs, y, m, max_epochs)
    if not _on_card(xh, xs, y, m):
        return _plain(ref.cd_solve_ref, xh, xs, y, m, **kw)
    _check(y.dtype == torch.float32 and m.dtype == torch.float32,
           "y and m must be float32")
    _check_cuda_layout({"xh": xh, "xs": xs, "y": y, "m": m})
    c = cd_solve_cluster_size(n, d, xh.dtype)
    from repro_torch.kernels.svm_step import launch_cd_solve
    out = launch_cd_solve(xh, xs, y, m, kw["C"], kw["tol"], kw["max_epochs"],
                          c, layout)
    LAUNCHES["cd_solve"] += 1
    ROUTE_LAUNCHES["cd_solve/" + ("cluster" if c > 1 else "single")] += 1
    return out


def _cd_solve_sparse(xh, xs, y, m, layout, cutoff, *, C: torch.Tensor,
                     tol: torch.Tensor, max_epochs: torch.Tensor):
    """:func:`cd_solve` on blocked-CSR rows (see
    :func:`ref.cd_solve_sparse_ref`); ``cutoff`` the epoch cutoff as the
    caller gave it (for the shape rule). A call of the route launches
    two kernels, the prep of the row blocks and the solve, and counts
    one."""
    parts, leaves = _sparse_parts((xh, xs), "cd_solve on SparseRows")
    check_column_ids(*parts)
    kw = dict(C=C, tol=tol, max_epochs=max_epochs)
    if shape_only(*leaves, y, m):
        return _rule_cd_solve_sparse(xh, xs, y, m, cutoff)
    if not _on_card(*leaves, y, m):
        return _plain(ref.cd_solve_sparse_ref, xh, xs, y, m, **kw)
    _check(y.dtype == torch.float32 and m.dtype == torch.float32,
           "y and m must be float32")
    _check_cuda_layout({"y": y, "m": m,
                        **{f"leaf {i}": t for i, t in enumerate(leaves)}})
    from repro_torch.kernels.svm_step import launch_cd_solve_sparse
    out = launch_cd_solve_sparse(xh, xs, y, m, C, tol, max_epochs, layout)
    LAUNCHES["cd_solve"] += 1
    ROUTE_LAUNCHES["cd_solve/sparse"] += 1
    return out


def hinge_scores(X, W: torch.Tensor, b: torch.Tensor, y: torch.Tensor,
                 m: torch.Tensor):
    """Eq. 7 hinge-loss sums of L hypotheses (see
    :func:`ref.hinge_scores_ref`). X (n, d) f32/bf16 rows, dense or
    ``SparseRows`` (the ``hinge_scores/sparse`` route, which also takes W
    as the packed view ``cd_solve/sparse`` returns), W (L, d), b (L,), y,
    m (n,) f32. → (losses (L,), count ())."""
    note_signature("hinge_scores", X, W, b, y, m)
    _check(len(X.shape) == 2 and W.dim() == 2 and W.shape[1] == X.shape[1],
           f"X must be (n, d) and W (L, d), got {tuple(X.shape)} and "
           f"{tuple(W.shape)}")
    n = X.shape[0]
    L = W.shape[0]
    _check(tuple(b.shape) == (L,) and tuple(y.shape) == (n,)
           and tuple(m.shape) == (n,),
           "b must be (L,) and y, m (n,)")
    sparse = sparse_rows.is_sparse(X)
    if sparse:
        parts, rows = _sparse_parts((X,), "hinge_scores on SparseRows")
        check_column_ids(*parts)
    else:
        _check(X.dtype in _ROW_DTYPES, f"X must be one of {_ROW_DTYPES}")
        rows = [X]
    if shape_only(*rows, W, b, y, m):
        return _rule_hinge_scores(X, W, b, y, m)
    if not _on_card(*rows, W, b, y, m):
        return _plain(ref.hinge_scores_ref, X, W, b, y, m)
    _check(all(t.dtype == torch.float32 for t in (W, b, y, m)),
           "W, b, y and m must be float32")
    from repro_torch.kernels.hinge_score import (MAX_HYPOTHESES, is_packed,
                                                 launch_hinge_scores,
                                                 launch_hinge_scores_sparse)
    # the sparse route reads W packed as it is (cd_solve/sparse returns W
    # as a view of its (d, 8k) array) and packs a contiguous W
    _check_cuda_layout({"b": b, "y": y, "m": m,
                        **({} if sparse and is_packed(W) else {"W": W}),
                        **{f"X leaf {i}": t for i, t in enumerate(rows)}})
    launch = launch_hinge_scores_sparse if sparse else launch_hinge_scores
    losses, count = [], None
    for l0 in range(0, L, MAX_HYPOTHESES):
        sl = slice(l0, l0 + MAX_HYPOTHESES)
        loss, count, route = launch(X, W[sl], b[sl], y, m)
        LAUNCHES["hinge_scores"] += 1
        ROUTE_LAUNCHES[f"hinge_scores/{route}"] += 1
        losses.append(loss)
    return (losses[0] if len(losses) == 1 else torch.cat(losses)), count


def _job_rows(side):
    """A side of a Gram: a (n, ·) row batch (one job, no shared rows), a
    ``(home (J, per, ·), shared (S, ·))`` pair, or a ``(home, shared
    (B, S, ·), jobs_per_shared)`` triple, dense or sparse (see
    :class:`repro_torch.kernels.gram.JobRows`). → (JobRows, was_plain)."""
    from repro_torch.kernels.gram import JobRows
    if isinstance(side, tuple):
        _check(len(side) in (2, 3), "a side is (home, shared) or (home, "
               "shared, jobs_per_shared)")
        home, shared = side[:2]
        jps = side[2] if len(side) == 3 else None
        _check(len(home.shape) == 3 and (
            len(shared.shape) == 2 if jps is None else
            len(shared.shape) == 3 and int(jps) >= 1),
               "a side must be (home (J, per, d), shared (S, d)) or (home, "
               "shared (B, S, d), jobs_per_shared), got "
               f"{tuple(home.shape)}, {tuple(shared.shape)}, {jps}")
        rows = JobRows(home, shared, jps)
        _check(rows.jobs % home.shape[0] == 0,
               f"{rows.jobs} jobs do not cycle over {home.shape[0]} home "
               "blocks")
        return rows, False
    _check(len(side.shape) == 2, f"rows must be (n, d), got {side.shape}")
    return JobRows(side[None], side[:0]), True


def _same_storage(a: torch.Tensor, b: torch.Tensor) -> bool:
    return (a.device, a.dtype, a.data_ptr(), tuple(a.shape), a.stride()) == \
        (b.device, b.dtype, b.data_ptr(), tuple(b.shape), b.stride())


def same_rows(X, Z) -> bool:
    """Whether the two sides of a Gram are the same rows in memory: the
    same tensors, or views of equal address, shape and strides (for
    ``(home, shared)`` pairs, both parts). Equal values in other memory
    do not count: the kernel's symmetric route computes the upper
    triangle from X alone."""
    if isinstance(X, tuple) != isinstance(Z, tuple):
        return False
    if not isinstance(X, tuple):
        return _same_storage(X, Z)
    if len(X) != len(Z) or X[2:] != Z[2:]:
        return False
    return all(_same_storage(a, b) for a, b in zip(X[:2], Z[:2]))


def _gram_sides(X, Z, kind: str, degree: int):
    _check(kind in ("linear", "poly", "rbf"), f"unknown kernel {kind!r}")
    _check(int(degree) >= 0, f"degree must be >= 0, got {degree}")
    (xr, xp), (zr, zp) = _job_rows(X), _job_rows(Z)
    jobs = max(xr.jobs, zr.jobs)
    _check(xr.jobs in (1, jobs) and zr.jobs in (1, jobs),
           f"job counts {xr.jobs} and {zr.jobs} do not broadcast")
    d = {r.home.shape[-1] for r in (xr, zr)} | \
        {r.shared.shape[-1] for r in (xr, zr)}
    _check(len(d) == 1, f"feature dims differ: {sorted(d)}")
    return xr, zr, jobs, xp and zp


def per_job(fn, X, Z, **kw) -> torch.Tensor:
    """``fn(X_l, Z_l, **kw)`` on each job's concatenated rows (sides as
    in :func:`gram`), stacked; (n, m) for two plain sides. A 1-D tensor
    in ``kw`` holds one value a job: job l gets its own. The plain
    versions and the ``"xla"`` route run job rows this way."""
    (xr, xp), (zr, zp) = _job_rows(X), _job_rows(Z)
    jobs = max(xr.jobs, zr.jobs)
    K = torch.stack([fn(xr.rows(j), zr.rows(j), **{
        k: v[j] if isinstance(v, torch.Tensor) and v.dim() == 1 else v
        for k, v in kw.items()}) for j in range(jobs)])
    return K[0] if xp and zp else K


def gram(X, Z, *, kind: str = "linear", gamma=1.0, coef0=0.0,
         degree: int = 3) -> torch.Tensor:
    """Dense Gram K = k(X, Zᵀ) in float32 (see :func:`ref.gram_ref`).

    X and Z are (n, d) rows, ``(home (J, per, d), shared (S, d))`` pairs
    whose job ``l`` has the rows ``[home[l % J]; shared]``, or ``(home,
    shared (B, S, d), jobs_per_shared)`` triples whose job l has the
    rows ``[home[l % J]; shared[l // jobs_per_shared]]`` (a sweep's S·L
    jobs). Rows f32 or bf16, one dtype. γ and coef0 are numbers or
    (jobs,) tensors (:func:`job_values`). → (n, m) for two plain sides,
    else (jobs, n, m).
    """
    note_signature("gram", X, Z, kind=kind, gamma=gamma, coef0=coef0,
                   degree=degree)
    xr, zr, jobs, plain = _gram_sides(X, Z, kind, degree)
    leaves = (xr.home, xr.shared, zr.home, zr.shared)
    _check(all(not sparse_rows.is_sparse(t) for t in leaves),
           "gram takes dense rows; use sparse_gram for SparseRows")
    _check(xr.home.dtype in _ROW_DTYPES
           and all(t.dtype == xr.home.dtype for t in leaves),
           f"rows must be one of {_ROW_DTYPES}, all of one dtype")
    dev = xr.home.device
    gamma, coef0 = job_values(gamma, jobs, dev), job_values(coef0, jobs, dev)
    kw = dict(kind=kind, gamma=gamma, coef0=coef0, degree=degree)
    if not _on_card(*leaves):
        return _plain(per_job, ref.gram_ref, X, Z, **kw)
    _check_cuda_layout(dict(zip(("X home", "X shared", "Z home",
                                 "Z shared"), leaves)))
    from repro_torch.kernels.gram import launch_gram
    K, route = launch_gram(xr, zr, jobs, symmetric=same_rows(X, Z), **kw)
    LAUNCHES["gram"] += 1
    ROUTE_LAUNCHES[f"gram/{route}"] += 1
    return K[0] if plain else K


def _sparse_parts(parts, what: str):
    """``SparseRows`` parts, checked: one nnz_cap, one value dtype of
    ``_ROW_DTYPES``, int32 ids. → (parts, their index and value
    tensors)."""
    _check(all(sparse_rows.is_sparse(t) for t in parts),
           f"{what} takes SparseRows on both sides")
    _check(len({t.nnz_cap for t in parts}) == 1, "nnz_cap differs")
    _check(parts[0].dtype in _ROW_DTYPES
           and all(t.dtype == parts[0].dtype for t in parts),
           f"values must be one of {_ROW_DTYPES}, all of one dtype")
    _check(all(t.indices.dtype == torch.int32 for t in parts),
           "indices must be int32")
    return parts, [leaf for t in parts for leaf in (t.indices, t.values)]


def check_column_ids(*parts) -> None:
    """Refuse ``SparseRows`` parts with a column id outside [0, d) with
    ``ValueError``. Parts marked as checked (``SparseRows.ids_in_range``:
    checked before, or derived from checked rows) pass at no cost; the
    others are checked together in one device round trip and marked, so
    a batch of rows costs one round trip however many kernels it meets."""
    todo = [t for t in parts if not t.ids_in_range]
    # shape-only rows hold no ids to check (their kernels run as rules)
    live = [t for t in todo if t.indices.numel()
            and not _is_shape_only(t.indices)]
    if live:
        lo_hi = torch.stack([torch.stack([t.indices.min(), t.indices.max()])
                             for t in live]).tolist()
        for t, (lo, hi) in zip(live, lo_hi):
            _check(0 <= lo and hi < t.d, f"column ids outside [0, {t.d})")
    for t in todo:
        t.mark_ids_in_range()


def sparse_gram(X, Z, *, kind: str = "linear", gamma=1.0, coef0=0.0,
                degree: int = 3) -> torch.Tensor:
    """Gram of blocked-CSR rows in float32 (see :func:`ref.sparse_gram_ref`).

    X and Z are ``SparseRows`` of one nnz_cap and value dtype (f32 or
    bf16), or pairs or triples of them as in :func:`gram`; γ and coef0
    as there. Both sides must be sparse: the mixed dense × sparse Gram
    is not a kernel (it is
    :func:`repro_torch.core.kernel_fns.apply_kernel`). → (n, m) for two
    plain sides, else (jobs, n, m).
    """
    note_signature("sparse_gram", X, Z, kind=kind, gamma=gamma, coef0=coef0,
                   degree=degree)
    xr, zr, jobs, plain = _gram_sides(X, Z, kind, degree)
    parts, leaves = _sparse_parts((xr.home, xr.shared, zr.home, zr.shared),
                                  "sparse_gram")
    check_column_ids(*parts)
    dev = xr.home.device
    gamma, coef0 = job_values(gamma, jobs, dev), job_values(coef0, jobs, dev)
    kw = dict(kind=kind, gamma=gamma, coef0=coef0, degree=degree)
    if not _on_card(*leaves):
        return _plain(per_job, ref.sparse_gram_ref, X, Z, **kw)
    _check_cuda_layout({f"leaf {i}": t for i, t in enumerate(leaves)})
    from repro_torch.kernels.gram import launch_sparse_gram
    K = launch_sparse_gram(xr, zr, jobs, **kw)
    LAUNCHES["sparse_gram"] += 1
    ROUTE_LAUNCHES["sparse_gram/gram"] += 1
    return K[0] if plain else K


def sparse_gram_scores(X, Z, coef: torch.Tensor, b: torch.Tensor, *,
                       kind: str = "linear", gamma=1.0, coef0=0.0,
                       degree: int = 3) -> torch.Tensor:
    """Decision scores of blocked-CSR query rows against blocked-CSR
    rows, S = k(X, Zᵀ)·coefᵀ + b, without forming K (see
    :func:`ref.sparse_gram_scores_ref`).

    X is ``SparseRows`` (n, d) of query rows. Z is ``SparseRows`` or a
    ``(home (1, per, d), shared)`` pair of rows ``[home[0]; shared]``,
    of X's nnz_cap and value dtype. coef (L, Z's rows) and b (L,) of one
    dtype, f32 or bf16. γ and coef0 are one job's: numbers, or 0-dim or
    (1,) tensors (a sweep launches this once a config). A hypothesis
    skips the tiles of Z where its coefficients are all 0 (eq. 7's are 0
    off their job's rows). → (n, L) in coef's dtype.
    """
    note_signature("sparse_gram_scores", X, Z, coef, b, kind=kind,
                   gamma=gamma, coef0=coef0, degree=degree)
    _check(sparse_rows.is_sparse(X) and len(X.shape) == 2,
           "sparse_gram_scores takes (n, d) SparseRows query rows")
    xr, zr, _, _ = _gram_sides(X, Z, kind, degree)
    parts, leaves = _sparse_parts((xr.home, xr.shared, zr.home, zr.shared),
                                  "sparse_gram_scores")
    _check(coef.dim() == 2 and coef.shape[1] == zr.n and zr.n > 0,
           f"coef must be (L, {zr.n}), got {tuple(coef.shape)}")
    L = coef.shape[0]
    _check(zr.jobs == 1, f"Z must be one job of rows, got {zr.jobs}")
    _check(tuple(b.shape) == (L,) and coef.dtype in _ROW_DTYPES
           and b.dtype == coef.dtype,
           f"b must be ({L},) and coef, b one dtype of {_ROW_DTYPES}")
    check_column_ids(*parts)
    gamma, coef0 = (job_values(gamma, 1, coef.device),
                    job_values(coef0, 1, coef.device))
    kw = dict(kind=kind, gamma=gamma, coef0=coef0, degree=degree)
    if not _on_card(*leaves, coef, b):
        return _plain(ref.sparse_gram_scores_ref, X, Z, coef, b, **dict(
            kw, gamma=gamma[0], coef0=coef0[0]))
    _check_cuda_layout({"coef": coef, "b": b,
                        **{f"leaf {i}": t for i, t in enumerate(leaves)}})
    from repro_torch.kernels.gram import launch_sparse_scores
    out = launch_sparse_scores(xr, zr, coef, b, **kw)
    LAUNCHES["sparse_gram"] += 1
    ROUTE_LAUNCHES["sparse_gram/scores"] += 1
    return out


#: the Gram solve's limits (``csrc/cd_solve_gram.cu``): rows a tile,
#: the largest cluster, rows of state a CTA's shared memory holds; and
#: the rule's target of rows a CTA, so that a tile's rank update spreads
#: its K rows over the cluster's SMs
GRAM_SOLVE_TILE = 32
GRAM_SOLVE_MAX_CLUSTER = 16
GRAM_SOLVE_MAX_ROWS_PER_CTA = 11552
GRAM_SOLVE_ROWS_PER_CTA = 2048


def gram_solve_rows_per_cta(n: int, c: int, tile: int = GRAM_SOLVE_TILE) \
        -> int:
    """Rows each CTA of a c-CTA cluster owns for n rows: whole tiles."""
    return _ceil_div(_ceil_div(n, c), tile) * tile


def cd_solve_gram_cluster_size(L: int, n: int) -> int:
    """CTAs per job of ``cd_solve_gram`` on the card for L jobs of n rows;
    1 is the single route.

    The smallest power of two up to 16 whose CTAs own at most
    ``GRAM_SOLVE_ROWS_PER_CTA`` rows each: 8 at the full-width reducers
    (8 jobs × 10240 rows), 1 at the golden 224 rows and the final fit's
    2048. Raises where 16 CTAs' shared memory cannot hold the rows' state
    (20 bytes a row): past 16 × ``GRAM_SOLVE_MAX_ROWS_PER_CTA`` rows. The
    state is float32 in shared memory whatever K's dtype, and the jobs
    run in as many waves of clusters as the card needs, so neither the
    dtype nor L enters.
    """
    c = 1
    while gram_solve_rows_per_cta(n, c) > GRAM_SOLVE_ROWS_PER_CTA \
            and c < GRAM_SOLVE_MAX_CLUSTER:
        c *= 2
    _check(gram_solve_rows_per_cta(n, c) <= GRAM_SOLVE_MAX_ROWS_PER_CTA,
           f"cd_solve_gram holds at most {GRAM_SOLVE_MAX_CLUSTER} × "
           f"{GRAM_SOLVE_MAX_ROWS_PER_CTA} rows of solver state per job, "
           f"got {n}")
    return c


def cd_solve_gram(K: torch.Tensor, y: torch.Tensor, m: torch.Tensor, *,
                  C, tol, max_epochs):
    """Gram dual-CD solve of L jobs (see :func:`ref.cd_solve_gram_ref`).

    K (L, n, n) symmetric, without the bias +1; y, m (L, n); all one
    dtype, f32 or bf16 (the solver state's dtype). C, tol and max_epochs
    (whole) are numbers or (L,) tensors (:func:`job_values`); C and tol
    are rounded to the state dtype. → alpha (L, n), epochs (L,) int32,
    viol (L,). On the card,
    :func:`cd_solve_gram_cluster_size` CTAs run each job; a size the
    card cannot schedule raises.
    """
    note_signature("cd_solve_gram", K, y, m, C=C, tol=tol,
                   max_epochs=max_epochs)
    _check(K.dim() == 3 and K.shape[1] == K.shape[2],
           f"K must be (L, n, n), got {tuple(K.shape)}")
    L, n, _ = K.shape
    _check(tuple(y.shape) == (L, n) and tuple(m.shape) == (L, n),
           f"y and m must be {(L, n)}, got {tuple(y.shape)}/{tuple(m.shape)}")
    _check(K.dtype in _ROW_DTYPES and y.dtype == m.dtype == K.dtype,
           f"K, y and m must share one dtype of {_ROW_DTYPES}")
    kw = dict(C=job_values(C, L, K.device), tol=job_values(tol, L, K.device),
              max_epochs=_epoch_cutoffs(max_epochs, L, K.device))
    if not _on_card(K, y, m):
        return _plain(ref.cd_solve_gram_ref, K, y, m, **kw)
    _check_cuda_layout({"K": K, "y": y, "m": m})
    c = cd_solve_gram_cluster_size(L, n)
    from repro_torch.kernels.gram_solve import launch_cd_solve_gram
    out = launch_cd_solve_gram(K, y, m, kw["C"], kw["tol"], kw["max_epochs"],
                               c)
    LAUNCHES["cd_solve_gram"] += 1
    ROUTE_LAUNCHES["cd_solve_gram/" + ("cluster" if c > 1 else "single")] \
        += 1
    return out


#: head dims the tensor-core flash_decode takes: multiples of 16 up to
#: this (its output tile stays in registers)
TC_DECODE_MAX_HEAD_DIM = 128


def decode_route(dtype: torch.dtype, hd: int) -> str:
    """``flash_decode``'s route on the card: "tensor_core" for bf16 rows
    whose head dim is a multiple of 16 up to ``TC_DECODE_MAX_HEAD_DIM``,
    else "simt"."""
    if dtype == torch.bfloat16 and hd % 16 == 0 \
            and 16 <= hd <= TC_DECODE_MAX_HEAD_DIM:
        return "tensor_core"
    return "simt"


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     valid_len: torch.Tensor) -> torch.Tensor:
    """Single-token GQA attention over the KV cache (see
    :func:`ref.decode_attention_ref`): q (B, H, hd), k, v (B, KV, S, hd),
    one dtype of f32/bf16; valid_len () int32 on q's device (read there:
    no host round trip). → (B, H, hd) in q's dtype."""
    note_signature("decode_attention", q, k, v, valid_len)
    _check(q.dim() == 3 and k.dim() == 4 and tuple(v.shape) == tuple(k.shape),
           f"q must be (B, H, hd) and k, v (B, KV, S, hd), got "
           f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, H, hd = q.shape
    _check(k.shape[0] == B and k.shape[3] == hd and k.shape[2] >= 1,
           f"k {tuple(k.shape)} does not match q {tuple(q.shape)}")
    _check(H % k.shape[1] == 0, f"{H} query heads do not group over "
           f"{k.shape[1]} KV heads")
    _check(q.dtype in _ROW_DTYPES and k.dtype == v.dtype == q.dtype,
           f"q, k and v must share one dtype of {_ROW_DTYPES}")
    _check(valid_len.dim() == 0 and valid_len.dtype == torch.int32,
           "valid_len must be an int32 scalar tensor")
    if shape_only(q, k, v, valid_len):
        return _rule_decode_attention(q, k, v)
    if not _on_card(q, k, v, valid_len):
        return _plain(ref.decode_attention_ref, q, k, v, valid_len)
    _check_cuda_layout({"q": q, "k": k, "v": v})
    _check(all(t.data_ptr() % 16 == 0 for t in (q, k, v)),
           "q, k and v must be 16-byte aligned")
    from repro_torch.kernels.decode_attention import (launch_flash_decode,
                                                      max_head_dim)
    limit = max_head_dim(q.dtype)
    _check(hd * q.element_size() % 16 == 0 and hd <= limit,
           f"flash_decode takes head dims of whole 16-byte vectors up to "
           f"{limit}, got {hd} in {q.dtype}")
    route = decode_route(q.dtype, hd)
    out = launch_flash_decode(q, k, v, valid_len, route)
    LAUNCHES["flash_decode"] += 1
    ROUTE_LAUNCHES[f"flash_decode/{route}"] += 1
    return out
