"""Launch of the flash-decode kernel ``csrc/flash_decode.cu``.

The counterpart of ``repro/kernels/decode_attention.py: flash_decode``.
Callers go through :func:`repro_torch.kernels.ops.decode_attention`,
which checks the inputs, picks the route (:func:`repro_torch.kernels.
ops.decode_route`), counts launches and takes the plain version for CPU
tensors.

Two routes: bf16 rows whose head dim is a multiple of 16 (up to 128) go
to the tensor-core kernel, which feeds the f32 probabilities to the
tensor cores as two bf16 planes (:func:`split_p`); :func:`emulate_tc`
repeats its arithmetic in plain PyTorch. Other rows go to the SIMT
kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_P = ctypes.c_void_p
_I = ctypes.c_int


#: cache positions one CTA of the tensor-core route reads at most
#: (kChunkTc; fewer when the grid would not fill the card)
CHUNK = 4096


def split_p(p: torch.Tensor):
    """f32 probabilities → (hi, lo) bf16 planes as the tensor-core route
    makes them: hi = bf16(p), lo = bf16(p − hi), so that
    |p − (hi + lo)| ≤ 2⁻¹⁶·p while lo is normal in bf16."""
    p = p.float()
    hi = p.to(torch.bfloat16)
    return hi, (p - hi.float()).to(torch.bfloat16)


def emulate_tc(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               valid_len: torch.Tensor, chunk: int = CHUNK) -> torch.Tensor:
    """The tensor-core route's arithmetic in plain PyTorch: f32 scores
    of the bf16 rows with the scale applied after the dot, ``chunk``-row
    partials (m, l, acc) whose P · V takes P as the two planes of
    :func:`split_p`, combined in chunk order; the same masking as
    :func:`ref.decode_attention_ref`. → (B, H, hd) in q's dtype."""
    B, H, hd = q.shape
    KV, S = k.shape[1], k.shape[2]
    vl = int(valid_len)
    hi_pos = S if vl <= 0 else min(vl, S)
    qg = q.float().reshape(B, KV, H // KV, hd)
    ms, ls, accs = [], [], []
    for t0 in range(0, S, chunk):
        t1 = min(t0 + chunk, hi_pos)
        if t1 <= t0:
            continue
        s = torch.einsum("bkgh,bkth->bkgt", qg, k[:, :, t0:t1].float()) \
            * (1.0 / hd ** 0.5)
        if vl <= 0:
            s = torch.full_like(s, -1e30)
        m = s.amax(-1, keepdim=True)
        hi, lo = split_p(torch.exp(s - m))
        vv = v[:, :, t0:t1].float()
        acc = torch.einsum("bkgt,bkth->bkgh", hi.float(), vv) \
            + torch.einsum("bkgt,bkth->bkgh", lo.float(), vv)
        ms.append(m)
        ls.append(torch.exp(s - m).sum(-1, keepdim=True))
        accs.append(acc)
    M = torch.stack(ms).amax(0)
    L = sum(l * torch.exp(m - M) for m, l in zip(ms, ls))
    out = sum(a * torch.exp(m - M) for m, a in zip(ms, accs))
    return (out / L.clamp_min(1e-30)).reshape(B, H, hd).to(q.dtype)


def _lib():
    lib = build.load("flash_decode")
    for fn in (lib.flash_decode, lib.flash_decode_tc):
        fn.restype = _I
    lib.flash_decode.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                 ctypes.c_float, _P, _P, _P, _P, _P]
    lib.flash_decode_tc.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I,
                                    ctypes.c_float, _P, _P, _P, _P, _P]
    lib.flash_decode_tc_max_hd.restype = _I
    from repro_torch.kernels import ops
    if lib.flash_decode_tc_max_hd() != ops.TC_DECODE_MAX_HEAD_DIM:
        raise RuntimeError("flash_decode.cu and ops.decode_route disagree "
                           "on the tensor-core route's largest head dim")
    lib.flash_decode_chunk.argtypes = [_I, _I, _I, _I, _I]
    lib.flash_decode_chunk.restype = _I
    lib.flash_decode_max_hd.argtypes = [_I]
    lib.flash_decode_max_hd.restype = _I
    return lib


def max_head_dim(dtype: torch.dtype) -> int:
    """Largest head dim the kernel takes in ``dtype``."""
    return _lib().flash_decode_max_hd(int(dtype == torch.bfloat16))


def launch_flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        valid_len: torch.Tensor, route: str) -> torch.Tensor:
    """Launch ``route`` ("tensor_core" or "simt") on the current stream;
    inputs already checked (CUDA, contiguous, 16-byte aligned, one dtype
    of f32/bf16, valid_len an int32 scalar on the same card, the route
    one that takes them). → (B, H, hd) in q's dtype."""
    lib = _lib()
    B, H, hd = q.shape
    KV, S = k.shape[1], k.shape[2]
    dev = q.device
    chunk = lib.flash_decode_chunk(int(route == "tensor_core"), B, H, KV, S)
    splits = -(-S // chunk)
    pm = torch.empty((B, H, splits), dtype=torch.float32, device=dev)
    pl = torch.empty_like(pm)
    pacc = torch.empty((B, H, splits, hd), dtype=torch.float32, device=dev)
    out = torch.empty_like(q)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), valid_len.data_ptr())
    tail = (B, H, KV, S, hd, 1.0 / hd ** 0.5, pm.data_ptr(), pl.data_ptr(),
            pacc.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if route == "tensor_core":
        err = lib.flash_decode_tc(*ptrs, *tail)
    else:
        err = lib.flash_decode(*ptrs, int(q.dtype == torch.bfloat16), *tail)
    if err != 0:
        raise RuntimeError(f"flash_decode kernel ({route}) launch failed: "
                           f"cudaError {err}")
    return out
