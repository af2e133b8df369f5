"""Where the port's entry points run.

Numpy inputs go to ``cuda`` unless the caller names a device; tensors
and :class:`~repro_torch.sparse.SparseRows` stay where they are.
Without a card a ``cuda`` request raises — the port never falls back to
the CPU on its own.
"""
from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from repro_torch.sparse import SparseRows

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None, like=None) -> torch.device:
    """The device an entry point runs on: ``device`` if given, else the
    device of tensor or ``SparseRows`` ``like``, else ``cuda``."""
    if device is not None:
        dev = torch.device(device)
    elif isinstance(like, (torch.Tensor, SparseRows)):
        return like.device
    else:
        dev = torch.device("cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions of the kernels")
    return dev


def as_tensor(x, device: torch.device,
              dtype: Optional[torch.dtype] = None):
    """``x`` (numpy, tensor or ``SparseRows``) on ``device``, optionally
    cast (a ``SparseRows`` moves both leaves and casts its values)."""
    if isinstance(x, SparseRows):
        return x.to(device=device, dtype=dtype)
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    else:
        x = torch.as_tensor(x)
    return x.to(device=device, dtype=dtype or x.dtype)
