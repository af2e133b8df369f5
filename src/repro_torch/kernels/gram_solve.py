"""Launch of the Gram dual-CD solve kernel ``csrc/cd_solve_gram.cu``.

The counterpart of the row loop of ``repro/core/svm.py:
fit_binary_kernel``, which the JAX package leaves to XLA: one CTA per
job runs the whole solve with the reference's stop rule. Callers go
through :func:`repro_torch.kernels.ops.cd_solve_gram`, which checks the
inputs, counts launches and takes the plain version for CPU tensors.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def _lib():
    lib = build.load("cd_solve_gram")
    lib.cd_solve_gram.argtypes = [_P, _I, _P, _P, _I, _I, _F, _F, _I, _P, _P,
                                  _P, _P]
    lib.cd_solve_gram.restype = _I
    lib.cd_solve_gram_max_rows.restype = _I
    return lib


def max_rows() -> int:
    """Rows per job whose solver state fits the kernel's shared memory."""
    return _lib().cd_solve_gram_max_rows()


def launch_cd_solve_gram(K: torch.Tensor, y: torch.Tensor, m: torch.Tensor,
                         C: float, tol: float, max_epochs: int):
    """Launch on the current stream; inputs already checked (CUDA,
    contiguous, K (L, n, n) and y, m (L, n) of one dtype, f32 or bf16,
    n ≤ :func:`max_rows`). → alpha (L, n), epochs (L,) int32, viol (L,)."""
    L, n, _ = K.shape
    dev = K.device
    alpha = torch.empty((L, n), dtype=K.dtype, device=dev)
    epochs = torch.empty((L,), dtype=torch.int32, device=dev)
    viol = torch.empty((L,), dtype=K.dtype, device=dev)
    err = _lib().cd_solve_gram(
        K.data_ptr(), int(K.dtype == torch.bfloat16), y.data_ptr(),
        m.data_ptr(), L, n, float(C), float(tol), int(max_epochs),
        alpha.data_ptr(), epochs.data_ptr(), viol.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"cd_solve_gram kernel launch failed: cudaError {err}")
    return alpha, epochs, viol
