"""Launch of the dual-CD solve kernel ``csrc/cd_solve.cu``.

The counterpart of ``repro/kernels/svm_step.py: cd_epoch``: one CTA per
job runs every epoch of the job's solve with the reference's stop rule.
Callers go through :func:`repro_torch.kernels.ops.cd_solve`, which
checks the inputs, counts launches and takes the plain version for CPU
tensors.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_P = ctypes.c_void_p


def _fn():
    fn = build.load("cd_solve").cd_solve
    fn.argtypes = [_P, _P, ctypes.c_int, _P, _P, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_float,
                   ctypes.c_float, ctypes.c_int, _P, _P, _P, _P, _P, _P]
    fn.restype = ctypes.c_int
    return fn


def launch_cd_solve(xh: torch.Tensor, xs: torch.Tensor, y: torch.Tensor,
                    m: torch.Tensor, C: float, tol: float, max_epochs: int):
    """Launch on the current stream; inputs already checked (CUDA,
    contiguous, rows bf16/f32, y/m f32). → alpha, w, b, epochs, viol."""
    L, per, d = xh.shape
    S = xs.shape[0]
    dev = xh.device
    alpha = torch.empty((L, per + S), dtype=torch.float32, device=dev)
    w = torch.empty((L, d), dtype=torch.float32, device=dev)
    b = torch.empty((L,), dtype=torch.float32, device=dev)
    epochs = torch.empty((L,), dtype=torch.int32, device=dev)
    viol = torch.empty((L,), dtype=torch.float32, device=dev)
    err = _fn()(xh.data_ptr(), xs.data_ptr(),
                int(xh.dtype == torch.bfloat16), y.data_ptr(), m.data_ptr(),
                L, per, S, d, C, tol, max_epochs, alpha.data_ptr(),
                w.data_ptr(), b.data_ptr(), epochs.data_ptr(),
                viol.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"cd_solve kernel launch failed: cudaError {err}")
    return alpha, w, b, epochs, viol
