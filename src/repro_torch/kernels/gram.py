"""Launch of the Gram kernels ``csrc/gram.cu`` (dense rows) and
``csrc/sparse_gram.cu`` (blocked-CSR rows).

The counterparts of ``repro/kernels/gram.py: gram`` and ``sparse_gram``.
Callers go through :func:`repro_torch.kernels.ops.gram`,
:func:`~repro_torch.kernels.ops.sparse_gram` and
:func:`~repro_torch.kernels.ops.sparse_gram_scores` (the fused decision
scores of blocked-CSR rows, which never form K), which check the
inputs, count launches and take the plain versions for CPU tensors.

Both take each side as :class:`JobRows`: job ``l``'s rows are its home
block ``home[l % J]`` followed by its shared rows, so a MapReduce
round's augmented partitions ``[X_l; SV_global]`` go in without a copy,
and a sweep's ``[X_l; SV_s]`` too. A home block with one job is used by
every job. γ and coef0 go in as (jobs,) float32 tensors on the card.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from repro_torch import sparse as sparse_rows
from repro_torch.kernels import build

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float

KINDS = {"linear": 0, "poly": 1, "rbf": 2}


class JobRows(NamedTuple):
    """Rows of each job: ``home`` (J, per, ·) then ``shared`` (S, ·), or
    a stack of shared blocks (B, S, ·) with ``jps`` jobs a block; dense
    tensors or ``SparseRows``. Job l has the rows ``[home[l % J];
    shared[l // jps]]``: J jobs with one shared block, B·jps with B."""
    home: object
    shared: object
    jps: Optional[int] = None

    @property
    def stacked(self) -> bool:
        return len(self.shared.shape) == 3

    @property
    def jobs(self) -> int:
        return self.shared.shape[0] * self.jps if self.stacked \
            else self.home.shape[0]

    @property
    def per(self) -> int:
        return self.home.shape[1]

    @property
    def n_shared(self) -> int:
        """Rows a shared block."""
        return self.shared.shape[-2]

    @property
    def n(self) -> int:
        return self.per + self.n_shared

    @property
    def home_total(self) -> int:
        return self.home.shape[0] * self.per

    @property
    def shared_total(self) -> int:
        return (self.shared.shape[0] if self.stacked else 1) * self.n_shared

    def jobs_per_shared(self, jobs: int) -> int:
        """Jobs a shared block in a launch of ``jobs`` jobs."""
        return self.jps if self.stacked else max(jobs, 1)

    def rows(self, job: int):
        """Job ``job``'s rows, concatenated."""
        shared = self.shared[job // self.jps] if self.stacked else self.shared
        return sparse_rows.rows_concat(self.home[job % self.home.shape[0]],
                                       shared)


def _gram_fn():
    fn = build.load("gram").gram
    side = [_P, _I, _I, _LL, _P, _I, _I, _LL]
    fn.argtypes = side + side + [_I, _I, _I, _I, _I, _P, _P, _I, _P, _P, _P,
                                 _P, _P]
    fn.restype = _I
    return fn


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _norm_scratch(side: JobRows, dev) -> torch.Tensor:
    return torch.empty((side.home_total + side.shared_total,),
                       dtype=torch.float32, device=dev)


def _side_args(side: JobRows, jobs: int, home_ptr, shared_ptr):
    """A side's rows and job layout as the kernels take them: home
    pointer, home blocks, rows a home block, home rows in all; shared
    pointer, rows a shared block, jobs a shared block, shared rows in
    all."""
    return (home_ptr, side.home.shape[0], side.per, side.home_total,
            shared_ptr, side.n_shared, side.jobs_per_shared(jobs),
            side.shared_total)


def launch_gram(X: JobRows, Z: JobRows, jobs: int, kind: str,
                gamma: torch.Tensor, coef0: torch.Tensor, degree: int,
                symmetric: bool):
    """Launch on the current stream; inputs already checked (CUDA,
    contiguous, one row dtype, job counts 1 or ``jobs``; γ and coef0
    (jobs,) float32 on the card). ``symmetric``:
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
        *_side_args(X, jobs, X.home.data_ptr(), X.shared.data_ptr()),
        *_side_args(Z, jobs, Z.home.data_ptr(), Z.shared.data_ptr()),
        jobs, d, int(X.home.dtype == torch.bfloat16), int(symmetric),
        KINDS[kind], gamma.data_ptr(), coef0.data_ptr(), int(degree),
        xn.data_ptr(), zn.data_ptr(), K.data_ptr(), ctypes.addressof(route),
        _stream(dev))
    if err != 0:
        raise RuntimeError(f"gram kernel launch failed: cudaError {err}")
    return K, ("tensor_core" if route.value == 1 else "simt")


#: Z rows a tile of the sparse kernel (a warp's shared-memory segment);
#: must not exceed ``sparse_gram.cu``'s kMaxTile
SPARSE_TILE = 2048


def sparse_tile(nz: int) -> int:
    """Z rows a tile of ``sparse_gram`` for Z jobs of nz rows: nz rounded
    up to whole warps, at most :data:`SPARSE_TILE`."""
    return min(SPARSE_TILE, -(-max(nz, 1) // 32) * 32)


def _sparse_lib():
    lib = build.load("sparse_gram")
    head = [_P, _P, _I, _I, _LL, _P, _P, _I, _I, _LL, _I, _I, _I, _I, _P, _P,
            _LL, _P, _P, _I, _I, _LL, _P, _I, _I, _LL, _I, _I, _P, _P, _I,
            _P, _P]
    lib.sparse_gram.argtypes = head + [_I, _P, _P]
    lib.sparse_gram_scores.argtypes = head + [_P, _P, _P, _I, _I, _P, _P, _P]
    for fn in (lib.sparse_gram, lib.sparse_gram_scores,
               lib.sparse_gram_max_tile):
        fn.restype = _I
    if lib.sparse_gram_max_tile() < SPARSE_TILE:
        raise RuntimeError("sparse_gram.cu takes tiles of at most "
                           f"{lib.sparse_gram_max_tile()} rows, "
                           f"SPARSE_TILE is {SPARSE_TILE}")
    return lib


def csc_view(Z: JobRows, d: int, tile: int, chunk_slots: int = 1 << 22):
    """Z's nonzero slots in column-major order by (job, Z tile, column)
    over Z's ``Jz = Z.jobs`` jobs (each its rows ``[home[l % J];
    its shared block]``):
    list bounds ``start`` and ``end`` (Jz · tiles · d,) int32 and ``ent``
    (E, 2) int32, each entry the Z row (in its job) and the float32 bits
    of its value, where a tile is ``tile`` consecutive rows of a job. A
    stable sort keeps each list in row order, so with ``tile`` ≥ Z.n
    this is the untiled view by (job, column), and the tiles of a column
    are consecutive pieces of its list. Zero-valued (padding) slots sort
    past every list, which changes no sum. The rows go through in
    chunks of whole tiles of about ``chunk_slots`` slots, each sorted on
    its own, so the scratch beside the view stays that small; no step
    waits for the device."""
    _, per, cap = Z.home.indices.shape
    Jz, J, S = Z.jobs, Z.home.shape[0], Z.n_shared
    dev = Z.home.indices.device
    n = per + S
    _check_int32(Jz * n * cap, "slots")
    step = max(1, chunk_slots // (cap * tile)) * tile
    starts, ends, ents = [], [], []
    base = 0
    for j in range(Jz):
        home = Z.home[j % J]
        shared = Z.shared[j // Z.jps] if Z.stacked else Z.shared
        for r0 in range(0, n, step):
            r1 = min(n, r0 + step)
            h0, h1 = min(r0, per), min(r1, per)
            s0, s1 = max(r0 - per, 0), max(r1 - per, 0)
            idx = torch.cat([home.indices[h0:h1],
                             shared.indices[s0:s1]]).long()
            val = torch.cat([home.values[h0:h1],
                             shared.values[s0:s1]]).reshape(-1)
            bins = -(-(r1 - r0) // tile) * d
            tile_of = (torch.arange(r1 - r0, device=dev) // tile * d)[:, None]
            key = torch.where(val != 0, (tile_of + idx).reshape(-1), bins)
            key, order = torch.sort(key, stable=True)
            bounds = torch.searchsorted(
                key, torch.arange(bins + 1, device=dev)).int() + base
            starts.append(bounds[:-1])
            ends.append(bounds[1:])
            ents.append(torch.stack([(order // cap + r0).int(),
                                     val[order].float().view(torch.int32)],
                                    1))
            base += key.numel()
    return torch.cat(starts), torch.cat(ends), torch.cat(ents)


def _check_int32(count: int, what: str) -> None:
    if count >= 2 ** 31:
        raise ValueError(f"sparse_gram indexes its {what} with int32; "
                         f"{count} is too many")


def _sparse_args(X: JobRows, Z: JobRows, jobs: int, tile: int, kind: str,
                 gamma: torch.Tensor, coef0: torch.Tensor, degree: int):
    """The arguments the two routes share, and the buffers they keep
    alive (the CSC view, the norms' scratch)."""
    dev = X.home.values.device
    d = X.home.d
    start, end, ent = csc_view(Z, d, tile)
    xn, zn = _norm_scratch(X, dev), _norm_scratch(Z, dev)
    x_home = X.home.indices.data_ptr(), X.home.values.data_ptr()
    x_shared = X.shared.indices.data_ptr(), X.shared.values.data_ptr()
    _, x_nh, x_per, x_ht, _, x_ns, x_jps, x_st = _side_args(X, jobs, 0, 0)
    _, z_nh, z_per, z_ht, _, z_ns, z_jps, z_st = _side_args(Z, jobs, 0, 0)
    args = (
        *x_home, x_nh, x_per, x_ht, *x_shared, x_ns, x_jps, x_st,
        X.home.nnz_cap, d, Z.n, tile, start.data_ptr(), end.data_ptr(),
        (-(-Z.n // tile)) * d if Z.jobs > 1 else 0, ent.data_ptr(),
        Z.home.values.data_ptr(), z_nh, z_per, z_ht,
        Z.shared.values.data_ptr(), z_ns, z_jps, z_st,
        int(X.home.dtype == torch.bfloat16), KINDS[kind], gamma.data_ptr(),
        coef0.data_ptr(), int(degree), xn.data_ptr(), zn.data_ptr())
    return args, (start, end, ent, xn, zn)


def launch_sparse_gram(X: JobRows, Z: JobRows, jobs: int, kind: str,
                       gamma: torch.Tensor, coef0: torch.Tensor, degree: int):
    """The Gram route on the current stream; inputs already checked
    (CUDA, ``SparseRows`` of one nnz_cap and value dtype, indices in
    [0, d), job counts 1 or ``jobs``; γ and coef0 (jobs,) float32 on the
    card). → K (jobs, X.n, Z.n) float32."""
    dev = X.home.values.device
    args, _bufs = _sparse_args(X, Z, jobs, sparse_tile(Z.n), kind, gamma,
                               coef0, degree)
    K = torch.empty((jobs, X.n, Z.n), dtype=torch.float32, device=dev)
    err = _sparse_lib().sparse_gram(*args, jobs, K.data_ptr(), _stream(dev))
    if err != 0:
        raise RuntimeError(
            f"sparse_gram kernel launch failed: cudaError {err}")
    return K


def launch_sparse_scores(X: JobRows, Z: JobRows, coef: torch.Tensor,
                         b: torch.Tensor, kind: str, gamma: torch.Tensor,
                         coef0: torch.Tensor, degree: int):
    """The scores route on the current stream; inputs already checked
    (as :func:`launch_sparse_gram`; X and Z one job each, γ and coef0
    (1,); coef (L, Z.n) and b (L,) contiguous, f32 or bf16). → (X.n, L)
    in coef's dtype; K is never formed."""
    dev = X.home.values.device
    L = coef.shape[0]
    tile = sparse_tile(Z.n)
    tiles = -(-Z.n // tile)
    args, _bufs = _sparse_args(X, Z, 1, tile, kind, gamma, coef0, degree)
    live = torch.nn.functional.pad(coef != 0, (0, tiles * tile - Z.n)) \
        .view(L, tiles, tile).any(-1).to(torch.uint8)
    partial = torch.empty((X.n, L, tiles), dtype=torch.float32, device=dev)
    out = torch.empty((X.n, L), dtype=coef.dtype, device=dev)
    err = _sparse_lib().sparse_gram_scores(
        *args, coef.data_ptr(), live.data_ptr(), b.data_ptr(),
        int(coef.dtype == torch.bfloat16), L, partial.data_ptr(),
        out.data_ptr(), _stream(dev))
    if err != 0:
        raise RuntimeError(
            f"sparse_gram scores kernel launch failed: cudaError {err}")
    return out


def emulate_scores(X, Z, coef: torch.Tensor, b: torch.Tensor, *,
                   kind: str = "linear", gamma: float = 1.0,
                   coef0: float = 0.0, degree: int = 3) -> torch.Tensor:
    """The scores route's arithmetic in plain PyTorch (arguments as
    ``ops.sparse_gram_scores``): k(X, Z) from :func:`ref.sparse_gram_ref`
    cut into :func:`sparse_tile` column tiles; each k rounded to coef's
    dtype; per tile and hypothesis a float32 sum of k·coef, 0 where the
    hypothesis's coefficients of the tile are all 0; the tiles' sums
    added in tile order, rounded to coef's dtype, plus b. → (n, L) in
    coef's dtype."""
    from repro_torch import sparse as sparse_rows
    from repro_torch.kernels import ref
    Zr = sparse_rows.rows_concat(Z[0][0], Z[1]) if isinstance(Z, tuple) \
        else Z
    nz = Zr.shape[0]
    tile = sparse_tile(nz)
    k = ref.sparse_gram_ref(X, Zr, kind, gamma, coef0, degree) \
        .to(coef.dtype).float()
    c = coef.float()
    s = torch.zeros((X.shape[0], coef.shape[0]))
    for c0 in range(0, nz, tile):
        part = k[:, c0:c0 + tile] @ c[:, c0:c0 + tile].T
        s = s + torch.where(c[:, c0:c0 + tile].ne(0).any(1), part, 0.0)
    return s.to(coef.dtype) + b
