"""Launch of the eq. 7 scoring kernel ``csrc/hinge_scores.cu``.

The counterpart of ``repro/kernels/hinge_score.py: hinge_scores``.
Callers go through :func:`repro_torch.kernels.ops.hinge_scores`, which
checks the inputs, counts launches and takes the plain version for CPU
tensors.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_P = ctypes.c_void_p


def _lib():
    lib = build.load("hinge_scores")
    fn = lib.hinge_scores
    fn.argtypes = [_P, ctypes.c_int, _P, _P, _P, _P, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, _P, _P, _P, _P,
                   _P]
    fn.restype = ctypes.c_int
    lib.hinge_tile_rows.restype = ctypes.c_int
    lib.hinge_max_hypotheses.restype = ctypes.c_int
    return lib


def max_hypotheses() -> int:
    """Hypotheses one launch scores (the kernel keeps them in registers)."""
    return _lib().hinge_max_hypotheses()


def launch_hinge_scores(X: torch.Tensor, W: torch.Tensor, b: torch.Tensor,
                        y: torch.Tensor, m: torch.Tensor):
    """Launch on the current stream; inputs already checked (CUDA,
    contiguous, X bf16/f32, the rest f32, L ≤ :func:`max_hypotheses`).
    → (losses (L,), count ())."""
    lib = _lib()
    n, d = X.shape
    L = W.shape[0]
    dev = X.device
    tiles = -(-n // lib.hinge_tile_rows())
    part_loss = torch.empty((tiles, L), dtype=torch.float32, device=dev)
    part_cnt = torch.empty((tiles,), dtype=torch.float32, device=dev)
    loss = torch.empty((L,), dtype=torch.float32, device=dev)
    cnt = torch.empty((), dtype=torch.float32, device=dev)
    err = lib.hinge_scores(
        X.data_ptr(), int(X.dtype == torch.bfloat16), W.data_ptr(),
        b.data_ptr(), y.data_ptr(), m.data_ptr(), n, d, L, tiles,
        part_loss.data_ptr(), part_cnt.data_ptr(), loss.data_ptr(),
        cnt.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"hinge_scores kernel launch failed: cudaError {err}")
    return loss, cnt
