"""Carry solver state between the JAX reference and the port.

The ``*_from_numpy`` functions take the fields of the reference's
``SVBuffer`` / ``BinarySVM`` / ``MapReduceSVM`` as numpy arrays (for
example ``np.asarray`` of each JAX field) and build the port's
structures on ``device``; :func:`to_numpy` goes back. A JAX round's
SV_global can so seed the port's next round, and a model trained by
the reference — linear or Gram path, dense or blocked-CSR rows — can be
served by the port. Blocked-CSR feature rows travel as the triple
``(indices, values, d)`` of the reference's ``SparseRows``.

:func:`solver_params_from_numpy` takes the reference's ``SolverParams``
(scalars, or a sweep's (S,) arrays) and gives the port's, so that both
packages run the same grid.

:func:`lm_params_from_jax` takes the parameters of the reference's
``TransformerModel`` (a nested dict of arrays, stacked ``layers``) and
gives the port's, under the same names and layout, so that both
packages compute the same model.

bfloat16 numpy arrays (the ``ml_dtypes`` type JAX hands out) are read
by their bits. :func:`to_numpy` widens bfloat16 to float32, which is
exact.
"""
from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch

from repro_torch import sparse as sparse_rows
from repro_torch.core.mapreduce_svm import MapReduceSVM, SVBuffer
from repro_torch.core.svm import BinarySVM, SolverParams
from repro_torch.device import DeviceLike
from repro_torch.models.layers import tree_map


def tensor_from_numpy(a, device: DeviceLike = "cpu") -> torch.Tensor:
    """A tensor with ``a``'s values and dtype (bfloat16 included)."""
    a = np.array(a)            # a writable, contiguous copy
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def rows_from_numpy(x, device: DeviceLike = "cpu"):
    """Feature rows: an array, or ``(indices, values, d)`` of
    blocked-CSR rows → ``SparseRows``."""
    if isinstance(x, tuple):
        indices, values, d = x
        return sparse_rows.SparseRows(
            tensor_from_numpy(np.asarray(indices, np.int32), device),
            tensor_from_numpy(values, device), d)
    return tensor_from_numpy(x, device)


def sv_buffer_from_numpy(x, y, alpha, ids, mask,
                         device: DeviceLike = "cpu") -> SVBuffer:
    """``x`` as for :func:`rows_from_numpy`."""
    return SVBuffer(rows_from_numpy(x, device),
                    *(tensor_from_numpy(a, device)
                      for a in (y, alpha, ids, mask)))


def binary_svm_from_numpy(alpha, b, w, epochs_run, max_violation,
                          device: DeviceLike = "cpu") -> BinarySVM:
    return BinarySVM(*(tensor_from_numpy(a, device)
                       for a in (alpha, b, w, epochs_run, max_violation)))


def mapreduce_model_from_numpy(w, b, sv: Sequence, final: Sequence, risk,
                               rounds: int,
                               history: Sequence[Mapping] = (),
                               device: DeviceLike = "cpu") -> MapReduceSVM:
    """``sv`` and ``final`` are the fields of the reference's SVBuffer
    and BinarySVM, in their order."""
    return MapReduceSVM(
        w=tensor_from_numpy(w, device), b=tensor_from_numpy(b, device),
        sv=sv_buffer_from_numpy(*sv, device=device),
        final=binary_svm_from_numpy(*final, device=device),
        risk=tensor_from_numpy(risk, device), rounds=int(rounds),
        history=tuple(dict(h) for h in history))


def solver_params_from_numpy(params, device: DeviceLike = "cpu"
                             ) -> SolverParams:
    """The reference's ``SolverParams`` (fields as numpy arrays or
    scalars, e.g. ``np.asarray`` of each JAX field) → the port's: 0-dim
    fields as floats, (S,) fields as float32 tensors on ``device``."""
    fields = [np.asarray(f, np.float32) for f in params]
    return SolverParams(*(float(f) if f.ndim == 0
                          else tensor_from_numpy(f, device) for f in fields))


def lm_params_from_jax(params: Mapping, device: DeviceLike = "cpu"):
    """The reference LM's parameters (nested dict of arrays, e.g.
    ``jax.tree.map(np.asarray, params)``) → the port's, on ``device``."""
    return tree_map(lambda a: tensor_from_numpy(a, device), dict(params))


def to_numpy(obj):
    """Tensors (also inside NamedTuples, tuples and lists) → numpy;
    ``SparseRows`` → ``(indices, values, d)``; everything else
    unchanged."""
    if sparse_rows.is_sparse(obj):
        return (to_numpy(obj.indices), to_numpy(obj.values), obj.d)
    if isinstance(obj, torch.Tensor):
        t = obj.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(to_numpy(v) for v in obj))
    if isinstance(obj, (tuple, list)):
        return type(obj)(to_numpy(v) for v in obj)
    return obj
