"""Launch of the flash-decode kernel ``csrc/flash_decode.cu``.

The counterpart of ``repro/kernels/decode_attention.py: flash_decode``.
Callers go through :func:`repro_torch.kernels.ops.decode_attention`,
which checks the inputs, counts launches and takes the plain version
for CPU tensors.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib():
    lib = build.load("flash_decode")
    fn = lib.flash_decode
    fn.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, ctypes.c_float,
                   _P, _P, _P, _P, _P]
    fn.restype = _I
    lib.flash_decode_splits.argtypes = [_I]
    lib.flash_decode_splits.restype = _I
    lib.flash_decode_max_hd.argtypes = [_I]
    lib.flash_decode_max_hd.restype = _I
    return lib


def max_head_dim(dtype: torch.dtype) -> int:
    """Largest head dim the kernel takes in ``dtype``."""
    return _lib().flash_decode_max_hd(int(dtype == torch.bfloat16))


def launch_flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        valid_len: torch.Tensor) -> torch.Tensor:
    """Launch on the current stream; inputs already checked (CUDA,
    contiguous, 16-byte aligned, one dtype of f32/bf16, valid_len an
    int32 scalar on the same card). → (B, H, hd) in q's dtype."""
    lib = _lib()
    B, H, hd = q.shape
    KV, S = k.shape[1], k.shape[2]
    dev = q.device
    splits = lib.flash_decode_splits(S)
    pm = torch.empty((B, H, splits), dtype=torch.float32, device=dev)
    pl = torch.empty_like(pm)
    pacc = torch.empty((B, H, splits, hd), dtype=torch.float32, device=dev)
    out = torch.empty_like(q)
    err = lib.flash_decode(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), valid_len.data_ptr(),
        int(q.dtype == torch.bfloat16), B, H, KV, S, hd, 1.0 / hd ** 0.5,
        pm.data_ptr(), pl.data_ptr(), pacc.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_decode kernel launch failed: cudaError {err}")
    return out
