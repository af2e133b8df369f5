"""Drive the sharded MapReduce round on the ranks of a spawn.

Rank targets for :func:`repro_torch.compat.spawn` (the functions whose
first argument is a :class:`repro_torch.compat.Rank`). Each takes its
own rows of a dataset that is given whole as numpy arrays (rank r holds
global rows [r·per, (r+1)·per), as the reference's mesh shards them),
builds the round with :func:`repro_torch.core.build_sharded_round` on
the rank's device and returns numpy results, which the parent holds
against a reference. They import neither JAX nor any test module.

* :func:`run_cases` runs a list of :class:`Case` (each a config, rows
  and a number of rounds) and returns every round's outputs, and with
  ``chaos_seeds`` also the transport chaos scenarios
  (:func:`repro_torch.faults.chaos.transport_rank`) in the same spawn;
* :func:`fit_sharded` drives the sharded round with ``fit_mapreduce``'s
  driver (:func:`repro_torch.core.mapreduce_svm.drive_rounds`): rounds
  until eq. 8 fires or ``max_rounds``, with the transport seams, which
  fire on every rank at the same round before its first collective.

    from repro_torch import compat
    from repro_torch.launch.sharded import fit_sharded
    out = compat.spawn(fit_sharded, 8, (X, y, cfg), device="cpu")
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import faults
from repro_torch import sparse as sparse_rows
from repro_torch.convert import rows_from_numpy, tensor_from_numpy, to_numpy
from repro_torch.core.mapreduce_svm import (MRSVMConfig, build_sharded_round,
                                            drive_rounds, init_sv_buffer)
from repro_torch.kernels import ops


@dataclasses.dataclass(frozen=True)
class Case:
    """One run of ``rounds`` sharded rounds from an empty SV buffer.

    ``X`` (n, d) numpy rows, or blocked-CSR rows as ``(indices, values,
    d)``; ``y`` and ``mask`` (n,) (mask default ones). The rows go to
    the rank as ``dtype``; the empty buffer's feature rows are
    ``sv_dtype`` (default ``dtype``; the wire dtype, to start a packed
    transport as it goes on). On a CUDA rank, round
    ``sync_check_round`` runs under
    ``torch.cuda.set_sync_debug_mode("error")``: a host sync in it
    raises. With ``garble = (r, seed)`` round 0 runs under
    ``FaultPlan.single("ring_garble", seed)`` armed on rank r alone, so
    one rank's received message is garbled and the others' are not."""
    name: str
    cfg: MRSVMConfig
    X: object
    y: np.ndarray
    mask: Optional[np.ndarray] = None
    rounds: int = 3
    dtype: str = "float32"
    sv_dtype: Optional[str] = None
    sync_check_round: Optional[int] = None
    garble: Optional[Tuple[int, int]] = None


@contextlib.contextmanager
def no_host_sync(device, on: bool = True):
    """``torch.cuda.set_sync_debug_mode("error")`` around the block on a
    CUDA ``device`` when ``on``."""
    if not on or torch.device(device).type != "cuda":
        yield
        return
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(0)


def _rows(X, rows: slice, device, dtype: torch.dtype):
    if isinstance(X, tuple):
        indices, values, d = X
        return rows_from_numpy((indices[rows], values[rows], d), device) \
            .to(dtype=dtype)
    return tensor_from_numpy(X[rows], device).to(dtype)


def shard_of(rank, X, y, mask=None, dtype: str = "float32"):
    """This rank's (Xl, yl, ml, per) of whole numpy rows ``X`` (dense or
    ``(indices, values, d)``), labels and mask."""
    n = y.shape[0]
    if n % rank.world_size:
        raise ValueError(f"{n} rows do not split over {rank.world_size} "
                         "ranks")
    per = n // rank.world_size
    rows = slice(rank.rank * per, (rank.rank + 1) * per)
    dt = getattr(torch, dtype)
    Xl = _rows(X, rows, rank.device, dt)
    yl = tensor_from_numpy(np.asarray(y, np.float32)[rows], rank.device)
    ml = (torch.ones_like(yl) if mask is None else
          tensor_from_numpy(np.asarray(mask, np.float32)[rows], rank.device))
    return Xl, yl, ml, per


def run_case(rank, case: Case) -> dict:
    """``case.rounds`` rounds on this rank. → per-round lists of numpy
    ``risks``, ``ids``, ``mask``, ``alpha``, ``y``, ``x`` (the buffer's
    rows; ``(indices, values, d)`` when blocked-CSR), ``w``, ``b``."""
    Xl, yl, ml, per = shard_of(rank, case.X, case.y, case.mask, case.dtype)
    cfg = case.cfg
    fn = build_sharded_round(cfg, per, device=rank.device)
    nnz_cap = Xl.nnz_cap if sparse_rows.is_sparse(Xl) else None
    sv = init_sv_buffer(cfg.sv_capacity, Xl.shape[1],
                        getattr(torch, case.sv_dtype or case.dtype),
                        rank.device, nnz_cap=nnz_cap)
    garble = (faults.inject(faults.FaultPlan.single("ring_garble",
                                                    case.garble[1]))
              if case.garble and case.garble[0] == rank.rank else None)
    rounds = []
    for t in range(case.rounds):
        with no_host_sync(rank.device, t == case.sync_check_round), \
                (garble if garble and t == 0 else contextlib.nullcontext()):
            sv, risks, w, b = fn(Xl, yl, ml, sv)
        rounds.append((risks, sv.ids, sv.mask, sv.alpha, sv.y, sv.x, w, b))
    # read back once, after the rounds: a copy to the host waits for the
    # card, which ranks sharing one card pay for in turns
    keys = ("risks", "ids", "mask", "alpha", "y", "x", "w", "b")
    return {k: [to_numpy(r[i]) for r in rounds] for i, k in enumerate(keys)}


def run_cases(rank, cases: Sequence[Case], chaos_seeds: Sequence[int] = (),
              fit: Optional[tuple] = None) -> dict:
    """:func:`repro_torch.compat.probe`, every case on this rank, then
    the transport chaos scenarios of ``chaos_seeds`` and, with ``fit``
    (the arguments after the rank), :func:`fit_sharded`. → ``{"probe":
    …, "cases": [run_case results], "chaos": rows of
    :func:`repro_torch.faults.chaos.transport_rank`, "fit": its result
    or None, "routes": launches by route of the cases on this rank,
    "backend": the group's, "modules": whether JAX or the reference
    package was imported on this rank}``."""
    import sys
    from repro_torch import compat
    from repro_torch.faults import chaos
    probe = compat.probe(rank)
    before = dict(ops.ROUTE_LAUNCHES)
    results = [run_case(rank, c) for c in cases]
    routes = {k: v - before.get(k, 0) for k, v in ops.ROUTE_LAUNCHES.items()}
    rows = chaos.transport_rank(rank, list(chaos_seeds)) \
        if chaos_seeds else []
    return {"probe": probe, "cases": results, "chaos": rows,
            "fit": fit_sharded(rank, *fit) if fit else None,
            "routes": routes, "backend": rank.backend,
            "modules": sorted(m for m in ("jax", "repro") if m in sys.modules)}


def fit_sharded(rank, X, y, cfg: MRSVMConfig, mask=None,
                dtype: str = "float32", verbose: bool = False) -> dict:
    """The sharded fit on this rank: :func:`drive_rounds` over the
    sharded round, from an empty SV buffer. → ``{"history": [{round,
    risk, reducer, sv_count, ms}], "w", "b"}`` (the best hypothesis,
    numpy), the same on every rank."""
    Xl, yl, ml, per = shard_of(rank, X, y, mask, dtype)
    fn = build_sharded_round(cfg, per, device=rank.device)
    sv = init_sv_buffer(cfg.sv_capacity, Xl.shape[1], Xl.dtype, rank.device,
                        nnz_cap=Xl.nnz_cap if sparse_rows.is_sparse(Xl)
                        else None)

    def step(t):
        nonlocal sv
        sv, risks, w, b = fn(Xl, yl, ml, sv)
        return risks, lambda _l: (w, b), sv.mask.sum()

    best, history = drive_rounds(step, cfg, label="sharded",
                                 verbose=verbose and rank.rank == 0)
    return {"history": history, "w": to_numpy(best[1]),
            "b": float(best[2])}
