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
gathering Wᵀ at the row's ids.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_P = ctypes.c_void_p
_I = ctypes.c_int

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
    lib.hinge_scores_sparse.argtypes = [_P, _P, _I, _I, _P, _P, _P, _P, _I,
                                        _I, _I, _P, _P, _P, _P, _P]
    for fn in (lib.hinge_scores, lib.hinge_scores_tc, lib.hinge_tc_planes,
               lib.hinge_scores_sparse, lib.hinge_tile_rows,
               lib.hinge_sparse_tile_rows, lib.hinge_max_hypotheses,
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


def launch_hinge_scores_sparse(X, W: torch.Tensor, b: torch.Tensor,
                               y: torch.Tensor, m: torch.Tensor):
    """Launch the blocked-CSR route on the current stream; inputs
    already checked (CUDA, contiguous leaves, int32 ids in [0, d),
    values bf16/f32, the rest f32, 1 ≤ L ≤ ``MAX_HYPOTHESES``).
    → (losses (L,), count (), route "sparse")."""
    lib = _lib()
    n = X.shape[0]
    L = W.shape[0]
    dev = W.device
    # Wᵀ padded to 8 hypotheses: a column id's weights are one 32-byte row
    wt = torch.zeros((W.shape[1], MAX_HYPOTHESES), dtype=torch.float32,
                     device=dev)
    wt[:, :L] = W.T
    tiles = -(-n // lib.hinge_sparse_tile_rows())
    loss = torch.empty((L,), dtype=torch.float32, device=dev)
    cnt = torch.empty((), dtype=torch.float32, device=dev)
    part_loss = torch.empty((tiles, L), dtype=torch.float32, device=dev)
    part_cnt = torch.empty((tiles,), dtype=torch.float32, device=dev)
    err = lib.hinge_scores_sparse(
        X.indices.data_ptr(), X.values.data_ptr(),
        int(X.dtype == torch.bfloat16), X.nnz_cap, wt.data_ptr(),
        b.data_ptr(), y.data_ptr(), m.data_ptr(), n, L, tiles,
        part_loss.data_ptr(), part_cnt.data_ptr(), loss.data_ptr(),
        cnt.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"hinge_scores_sparse kernel launch failed: cudaError {err}")
    return loss, cnt, "sparse"
