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

:func:`lm_params_from_jax` takes the parameters of any of the
reference's LM families (a nested dict of arrays: stacked ``layers``,
the hybrid's twice-stacked ``mamba_layers``, the encoder-decoder's
``enc_layers`` / ``dec_layers``) and gives the port's, under the same
names and layout, so that both packages compute the same model;
:func:`opt_state_from_jax` does the same for the reference's AdamW
state, :func:`decode_state_from_jax` for a decode state. Given a rank
mesh and the placements (``launch.sharding.param_pspecs``,
``decode_state_pspecs``), each gives this rank's shards instead, as the
reference's ``device_put`` at a step's ``in_shardings`` places them;
:func:`shard_params` cuts the port's own full parameters so.

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
from repro_torch.models.layers import local_shard, tree_map, tree_map2
from repro_torch.optim import OptState


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


def _shard(t: torch.Tensor, placement, mesh) -> torch.Tensor:
    return t if mesh is None else local_shard(t, placement, mesh)


def shard_params(params, placements, mesh):
    """Full parameters (the port's nested dict) → this rank's shards under
    ``placements`` (their tree, ``launch.sharding.param_pspecs``)."""
    return tree_map2(lambda t, pl: _shard(t, pl, mesh), params, placements)


def lm_params_from_jax(params: Mapping, device: DeviceLike = "cpu", *,
                       mesh=None, placements=None):
    """The reference LM's parameters (nested dict of arrays, e.g.
    ``jax.tree.map(np.asarray, params)``) → the port's, on ``device``;
    with a rank ``mesh`` and the ``placements`` tree, this rank's shards
    (each leaf cut before it moves to the device)."""
    if mesh is None:
        return tree_map(lambda a: tensor_from_numpy(a, device), dict(params))
    return tree_map2(lambda a, pl: _shard(tensor_from_numpy(a), pl,
                                          mesh).to(device),
                     dict(params), placements)


def decode_state_from_jax(state, like, placements=None, mesh=None):
    """The reference's decode state (``DecodeState``, ``RWKVDecodeState``,
    ``HybridDecodeState`` with its nested ``Mamba2State`` and
    ``LayerKVCache``, ``EncDecDecodeState``; arrays, e.g.
    ``jax.tree.map(np.asarray, state)``) → the port's, of ``like``'s
    type field by field, on ``like``'s devices; with a rank ``mesh`` and
    the state's ``placements`` (``launch.sharding.decode_state_pspecs``),
    this rank's slice of each leaf."""
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(decode_state_from_jax(
            getattr(state, f), getattr(like, f),
            None if placements is None else getattr(placements, f), mesh)
            for f in like._fields))
    return _shard(tensor_from_numpy(np.asarray(state)), placements,
                  mesh).to(like.device)


def opt_state_from_jax(state, device: DeviceLike = "cpu") -> OptState:
    """The reference's ``OptState`` (``mu``, ``nu`` trees and ``step``,
    e.g. ``jax.tree.map(np.asarray, state)``) → the port's, on
    ``device``: both packages then step from the same state."""
    mu, nu, step = state
    return OptState(mu=lm_params_from_jax(mu, device),
                    nu=lm_params_from_jax(nu, device),
                    step=tensor_from_numpy(np.asarray(step, np.int32),
                                           device))


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
