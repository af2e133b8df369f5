"""Launch of the eq. 7 scoring kernels ``csrc/hinge_scores.cu``.

The counterpart of ``repro/kernels/hinge_score.py: hinge_scores``.
Callers go through :func:`repro_torch.kernels.ops.hinge_scores`, which
checks the inputs, counts launches and takes the plain version for CPU
tensors.

Two routes: bf16 rows go to the tensor-core kernel, which takes W as
three bf16 planes (made on the card by :func:`tc_planes`; the plain
version is :func:`split_planes`) and sums its products slab by slab
(:func:`emulate_tc` repeats that arithmetic in plain PyTorch); float32
rows go to the SIMT kernel. Blocked-CSR rows go to a third kernel of
the same library (:func:`launch_hinge_scores_sparse`), a warp a row
gathering W's column at each of the row's ids (:func:`emulate_sparse`
repeats its arithmetic).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong

#: hypotheses one launch scores (the n = 8 of mma.sync.m16n8k16)
MAX_HYPOTHESES = 8
#: columns of W one CTA of the tensor-core route holds (split-K slab)
SLAB_COLS = 2048
#: bf16 planes W is split into
PLANES = 3


def split_planes(W: torch.Tensor) -> torch.Tensor:
    """W (L, d) float32 → (3, L, d) bf16 planes whose float32 sum
    ``(hi + mid) + lo`` is W exactly (each plane is the bf16 rounding of
    what the planes before it leave; a float32 significand of 24 bits
    fits three of 8, while the residuals stay normal in bf16)."""
    planes, rest = [], W.float()
    for _ in range(PLANES):
        p = rest.to(torch.bfloat16)
        planes.append(p)
        rest = rest - p.float()
    return torch.stack(planes)


def fragment_columns() -> torch.Tensor:
    """The order in which one 32-column step's columns enter the two
    MMAs of the tensor-core route: MMA h, logical k (16 a step) of lane
    t reads column 8t + 4h + 2·(k ≥ 8) + k % 2, where t = (k % 8) // 2.
    X's and W's fragments follow the same order, so the dot product is
    unchanged. → (32,) int64, a permutation of 0..31."""
    k = torch.arange(16)
    t, upper, e = (k % 8) // 2, k // 8, k % 2
    return torch.cat([8 * t + 4 * h + 2 * upper + e for h in (0, 1)])


def emulate_tc(X: torch.Tensor, W: torch.Tensor, b: torch.Tensor,
               y: torch.Tensor, m: torch.Tensor):
    """The tensor-core route's arithmetic in plain PyTorch: the three
    planes, each 32-column step's columns in fragment order, per-plane
    products summed in float32 within each ``SLAB_COLS`` slab, the slabs'
    partial scores summed in slab order, then the bias, the hinge and
    the mask. → (losses (L,), count ()), as ``ref.hinge_scores_ref``."""
    n, d = X.shape
    planes = split_planes(W).float()
    steps = -(-d // 32)
    pad = steps * 32 - d
    order = (torch.arange(steps)[:, None] * 32
             + fragment_columns()).reshape(-1)
    Xp = torch.nn.functional.pad(X.float(), (0, pad))[:, order]
    Pp = torch.nn.functional.pad(planes, (0, pad))[:, :, order]
    scores = torch.zeros((n, W.shape[0]), dtype=torch.float32)
    for k0 in range(0, d, SLAB_COLS):
        cols = slice(k0, k0 + SLAB_COLS)
        part = sum(Xp[:, cols] @ Pp[p, :, cols].T for p in range(PLANES))
        scores = scores + part
    h = torch.clamp(1.0 - y.float()[:, None] * (scores + b.float()), min=0.0)
    return (h * m.float()[:, None]).sum(0), m.float().sum()


def _lib():
    lib = build.load("hinge_scores")
    lib.hinge_scores.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P,
                                 _P, _P, _P]
    lib.hinge_scores_tc.argtypes = [_P, _P, _I, _P, _P, _P, _I, _I, _I, _P,
                                    _I, _P, _P, _P, _P, _P]
    lib.hinge_tc_planes.argtypes = [_P, _I, _I, _I, _P, _P]
    lib.hinge_scores_sparse.argtypes = [_P, _P, _I, _I, _P, _L, _P, _P, _P,
                                        _I, _I, _I, _P, _P, _P, _P, _P]
    for fn in (lib.hinge_scores, lib.hinge_scores_tc, lib.hinge_tc_planes,
               lib.hinge_scores_sparse, lib.hinge_tile_rows,
               lib.hinge_sparse_tile_rows, lib.hinge_sparse_partial_cols,
               lib.hinge_max_hypotheses,
               lib.hinge_tc_slab_cols, lib.hinge_tc_finish_rows):
        fn.restype = _I
    if (lib.hinge_max_hypotheses(), lib.hinge_tc_slab_cols()) != \
            (MAX_HYPOTHESES, SLAB_COLS):
        raise RuntimeError("hinge_scores.cu and hinge_score.py disagree on "
                           "the hypotheses a launch or the slab width")
    return lib


def tc_planes(W: torch.Tensor) -> torch.Tensor:
    """The tensor-core route's planes of W (L, d) f32 on the card, made
    by the library's planes kernel: (3, 8, dp) bf16 with d rounded up to
    whole slabs in dp, :func:`split_planes` in the top-left (L, d)
    corner, zero elsewhere."""
    L, d = W.shape
    dp = max(1, -(-d // SLAB_COLS)) * SLAB_COLS
    planes = torch.empty((PLANES, MAX_HYPOTHESES, dp), dtype=torch.bfloat16,
                         device=W.device)
    err = _lib().hinge_tc_planes(W.data_ptr(), L, d, dp, planes.data_ptr(),
                                 torch.cuda.current_stream(W.device)
                                 .cuda_stream)
    if err != 0:
        raise RuntimeError(f"hinge_tc_planes launch failed: cudaError {err}")
    return planes


def launch_hinge_scores(X: torch.Tensor, W: torch.Tensor, b: torch.Tensor,
                        y: torch.Tensor, m: torch.Tensor):
    """Launch on the current stream; inputs already checked (CUDA,
    contiguous, X bf16/f32, the rest f32, 1 ≤ L ≤ ``MAX_HYPOTHESES``).
    → (losses (L,), count (), route): route "tensor_core" for bf16 rows,
    "simt" for float32 rows."""
    lib = _lib()
    n, d = X.shape
    L = W.shape[0]
    dev = X.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    loss = torch.empty((L,), dtype=torch.float32, device=dev)
    cnt = torch.empty((), dtype=torch.float32, device=dev)
    if X.dtype == torch.bfloat16:
        route = "tensor_core"
        planes = tc_planes(W)
        dp = planes.shape[-1]
        part = torch.empty((dp // SLAB_COLS, n, MAX_HYPOTHESES),
                           dtype=torch.float32, device=dev)
        blocks = -(-n // lib.hinge_tc_finish_rows())
        part_loss = torch.empty((blocks, L), dtype=torch.float32, device=dev)
        part_cnt = torch.empty((blocks,), dtype=torch.float32, device=dev)
        err = lib.hinge_scores_tc(
            X.data_ptr(), planes.data_ptr(), dp, b.data_ptr(),
            y.data_ptr(), m.data_ptr(), n, d, L, part.data_ptr(), blocks,
            part_loss.data_ptr(), part_cnt.data_ptr(), loss.data_ptr(),
            cnt.data_ptr(), stream)
    else:
        route = "simt"
        tiles = -(-n // lib.hinge_tile_rows())
        part_loss = torch.empty((tiles, L), dtype=torch.float32, device=dev)
        part_cnt = torch.empty((tiles,), dtype=torch.float32, device=dev)
        err = lib.hinge_scores(
            X.data_ptr(), W.data_ptr(), b.data_ptr(), y.data_ptr(),
            m.data_ptr(), n, d, L, tiles, part_loss.data_ptr(),
            part_cnt.data_ptr(), loss.data_ptr(), cnt.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(
            f"hinge_scores kernel launch failed: cudaError {err}")
    return loss, cnt, route


#: slots a lane of the sparse route takes from each 256-slot chunk of a row
SPARSE_LANE_SLOTS = 8


def _butterfly(p: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis (32 lanes) as xor shuffles 16, 8, 4, 2, 1
    pair them: lane l with l ^ 16, then ^ 8, and so on."""
    while p.shape[-1] > 1:
        half = p.shape[-1] // 2
        p = p[..., :half] + p[..., half:]
    return p[..., 0]


def emulate_sparse(X, W: torch.Tensor, b: torch.Tensor, y: torch.Tensor,
                   m: torch.Tensor):
    """The ``hinge_scores/sparse`` kernel's arithmetic in plain PyTorch,
    rounding for rounding: lane l of a row's warp adds v·W[h, id] over
    its slots c + 8l + j of each 256-slot chunk c (chunk by chunk, j in
    order, value-0 slots skipped); the lanes pair up as xor shuffles 16,
    8, 4, 2, 1; then the bias, the hinge and the mask; a warp adds its
    rows (r = 0..7 of rows 64t + 8r + warp) in order, a CTA its 8 warps
    in order; the partials of the tiles are added by lanes j (tiles j, j +
    32, ...) and the lanes paired as before. X ``SparseRows`` (n, d),
    W (L ≤ 8, d). → (losses (L,), count ())."""
    n, cap = X.values.shape
    L = W.shape[0]
    lane_slots = 32 * SPARSE_LANE_SLOTS
    chunks = -(-cap // lane_slots)
    pad = chunks * lane_slots - cap
    ids = torch.nn.functional.pad(X.indices.long(), (0, pad))
    v = torch.nn.functional.pad(X.values.float(), (0, pad))
    # (n, chunk, lane, j) → (n, lane, chunk · j): each lane's slots in order
    def order(t):
        return t.reshape(n, chunks, 32, SPARSE_LANE_SLOTS).transpose(1, 2) \
            .reshape(n, 32, chunks * SPARSE_LANE_SLOTS)

    ids, v = order(ids), order(v)
    acc = torch.zeros((n, 32, L), dtype=torch.float32, device=W.device)
    Wf = W.float()
    for k in range(ids.shape[-1]):
        live = (v[..., k] != 0)[..., None]
        prod = v[..., k, None] * Wf.T[ids[..., k]]
        acc = torch.where(live, acc + prod, acc)
    dot = _butterfly(acc.transpose(1, 2))                     # (n, L)
    hinge = torch.clamp(1.0 - y.float()[:, None] * (dot + b.float()),
                        min=0.0) * m.float()[:, None]
    tile_rows = 64
    tiles = max(1, -(-n // tile_rows))
    rows = torch.nn.functional.pad(torch.cat([hinge, m.float()[:, None]], 1),
                                   (0, 0, 0, tiles * tile_rows - n))
    # row 64t + 8r + w: (tile, r, warp); zero rows past n add nothing
    rows = rows.reshape(tiles, 8, 8, L + 1)
    warp = torch.zeros((tiles, 8, L + 1), dtype=torch.float32,
                       device=W.device)
    for r in range(8):
        warp = warp + rows[:, r]
    part = torch.zeros((tiles, L + 1), dtype=torch.float32, device=W.device)
    for w in range(8):
        part = part + warp[:, w]
    lanes = -(-tiles // 32) * 32
    part = torch.nn.functional.pad(part, (0, 0, 0, lanes - tiles))
    lane_sum = torch.zeros((32, L + 1), dtype=torch.float32, device=W.device)
    for t0 in range(0, lanes, 32):
        lane_sum = lane_sum + part[t0:t0 + 32]
    total = _butterfly(lane_sum.T)
    return total[:L], total[L]


def is_packed(W: torch.Tensor) -> bool:
    """Whether W (L, d)'s 8 hypotheses of a column can be read as two
    16-byte loads: hypotheses adjacent, columns 16-byte aligned and 8
    floats readable at every column (``cd_solve/sparse``'s output)."""
    L, d = W.shape
    sl, sd = W.stride()
    end = W.storage_offset() + (d - 1) * sd + MAX_HYPOTHESES
    return (sl == 1 or L == 1) and sd % 4 == 0 and W.data_ptr() % 16 == 0 \
        and end * 4 <= W.untyped_storage().nbytes()


def pack(W: torch.Tensor) -> torch.Tensor:
    """W (L ≤ 8, d) as the (L, d) view of a zeroed (d, 8) array, the
    layout :func:`is_packed` accepts."""
    L, d = W.shape
    Wp = torch.zeros((d, MAX_HYPOTHESES), dtype=W.dtype, device=W.device)
    Wp[:, :L] = W.T
    return Wp[:, :L].T


def launch_hinge_scores_sparse(X, W: torch.Tensor, b: torch.Tensor,
                               y: torch.Tensor, m: torch.Tensor):
    """Launch the blocked-CSR route on the current stream; inputs
    already checked (CUDA, contiguous leaves, ids in [0, d), values
    bf16/f32, the rest f32, 1 ≤ L ≤ ``MAX_HYPOTHESES``; W packed or
    contiguous). A ``cd_solve/sparse`` output is read as it is, any
    other W is packed first. → (losses (L,), count (), route "sparse")."""
    lib = _lib()
    n = X.shape[0]
    L = W.shape[0]
    dev = W.device
    if not is_packed(W):
        W = pack(W)
    tiles = max(1, -(-n // lib.hinge_sparse_tile_rows()))
    loss = torch.empty((L,), dtype=torch.float32, device=dev)
    cnt = torch.empty((), dtype=torch.float32, device=dev)
    part = torch.empty((tiles, lib.hinge_sparse_partial_cols()),
                       dtype=torch.float32, device=dev)
    counter = torch.empty((1,), dtype=torch.int32, device=dev)
    err = lib.hinge_scores_sparse(
        X.indices.data_ptr(), X.values.data_ptr(),
        int(X.dtype == torch.bfloat16), X.nnz_cap, W.data_ptr(),
        W.stride(1), b.data_ptr(), y.data_ptr(), m.data_ptr(), n, L, tiles,
        part.data_ptr(), counter.data_ptr(), loss.data_ptr(),
        cnt.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"hinge_scores_sparse kernel launch failed: cudaError {err}")
    return loss, cnt, "sparse"
