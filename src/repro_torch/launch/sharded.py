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
  fire on every rank at the same round before its first collective;
* the sharded sweep: :class:`SweepCase` runs (in the same spawn as the
  cases, ``run_cases(..., sweep_cases=…)``) through
  :func:`repro_torch.core.run_sharded_sweep` and round by round, with a
  round state saved and resumed from its checkpoint;
  :func:`fit_sharded_sweep` is the train mode's ``--sweep S``: C =
  logspace(-2, 1, S), each config's R_emp and accuracy on the rank's
  shard;
* :func:`run_moe_cases` runs expert layers (:class:`MoECase`) through
  :func:`repro_torch.models.moe.apply_moe_sharded` on a (data × model)
  grid of the ranks, each rank on its shards of the weights and tokens;
* :func:`run_lm_cases` serves dense and VLM decoders (:class:`LMCase`)
  through the sharded decode step of :func:`repro_torch.launch.steps.
  build_serve_step` on a (data × model) mesh of the ranks;
* :func:`run_train_cases` trains them (:class:`TrainCase`) through the
  sharded :func:`repro_torch.launch.steps.build_train_step` and runs
  the sharded prefill step, each rank on its shards and batch rows
  (:func:`run_train_case` gives the tensors, for a caller on the rank).

    from repro_torch import compat
    from repro_torch.launch.sharded import fit_sharded
    out = compat.spawn(fit_sharded, 8, (X, y, cfg), device="cpu")
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import shutil
import tempfile
import time
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import compat, faults
from repro_torch import sparse as sparse_rows
from repro_torch.analysis.hostsync import no_implicit_host_sync
from repro_torch.convert import rows_from_numpy, tensor_from_numpy, to_numpy
from repro_torch.core.mapreduce_svm import (MRSVMConfig, build_sharded_round,
                                            decision_linear, drive_rounds,
                                            init_sv_buffer)
from repro_torch.core.svm import SolverParams
from repro_torch.core.sweep import (build_sharded_sweep_round,
                                    expand_sweep_sv, restore_sweep_state,
                                    run_sharded_sweep, save_sweep_state,
                                    sweep_grid)
from repro_torch.kernels import ops
from repro_torch.models import moe
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class Case:
    """One run of ``rounds`` sharded rounds from an empty SV buffer.

    ``X`` (n, d) numpy rows, or blocked-CSR rows as ``(indices, values,
    d)``; ``y`` and ``mask`` (n,) (mask default ones). The rows go to
    the rank as ``dtype``; the empty buffer's feature rows are
    ``sv_dtype`` (default ``dtype``; the wire dtype, to start a packed
    transport as it goes on). On a CUDA rank, round
    ``sync_check_round`` runs under :func:`no_host_sync`: a host sync in
    it raises. With ``garble = (r, seed)`` round 0 runs under
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


def no_host_sync(device, on: bool = True):
    """:func:`repro_torch.analysis.no_implicit_host_sync` around the block
    on a CUDA ``device`` when ``on`` (the mode found is restored)."""
    if not on or torch.device(device).type != "cuda":
        return contextlib.nullcontext()
    return no_implicit_host_sync()


def _rows(X, rows: slice, device, dtype: torch.dtype):
    if isinstance(X, tuple):
        indices, values, d = X
        return rows_from_numpy((indices[rows], values[rows], d), device) \
            .to(dtype=dtype)
    return tensor_from_numpy(X[rows], device).to(dtype)


def shard_of(rank, X, y, mask=None, dtype: str = "float32"):
    """This rank's (Xl, yl, ml, per) of whole numpy rows ``X`` (dense or
    ``(indices, values, d)``), labels and mask; with a leading (S,) axis
    on all three (a sweep's per-stream rows), the rank's rows of each."""
    n = y.shape[-1]
    if n % rank.world_size:
        raise ValueError(f"{n} rows do not split over {rank.world_size} "
                         "ranks")
    per = n // rank.world_size
    rows = (Ellipsis, slice(rank.rank * per, (rank.rank + 1) * per))
    rows_x = rows + (slice(None),)     # the row axis is -2 of the rows
    dt = getattr(torch, dtype)
    Xl = _rows(X, rows_x, rank.device, dt)
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


@dataclasses.dataclass(frozen=True)
class SweepCase:
    """One sharded sweep (:func:`repro_torch.core.run_sharded_sweep`)
    from an empty state, and ``rounds`` rounds more driven one by one.

    ``X`` (n, d) numpy rows or ``(indices, values, d)``, ``y`` and
    ``mask`` (n,); with ``per_config_data`` a leading (S,) axis on all
    three (per-stream rows). ``params`` the (S,) grid
    (:func:`repro_torch.core.sweep_grid`). The rows go to the rank as
    ``dtype``. ``drive=False`` skips the driven sweep. The rounds driven
    one by one take ``params`` as they are (no eq. 8 mask); on a CUDA
    rank round ``sync_check_round`` runs under :func:`no_host_sync`; with
    ``resume_round`` the state after that round is saved
    (:func:`save_sweep_state`), restored (:func:`restore_sweep_state`)
    and driven on to ``rounds`` beside the uninterrupted run."""
    name: str
    cfg: MRSVMConfig
    X: object
    y: np.ndarray
    params: SolverParams
    mask: Optional[np.ndarray] = None
    per_config_data: bool = False
    dtype: str = "float32"
    drive: bool = True
    rounds: int = 0
    sync_check_round: Optional[int] = None
    resume_round: Optional[int] = None


def _round_outputs(state, risks, w, b) -> dict:
    """A driven round's state (as the per-config buffer, in the rows'
    dtype) and outputs as numpy."""
    sv = expand_sweep_sv(state, state.y.dtype)
    return {"ids": to_numpy(sv.ids), "alpha": to_numpy(sv.alpha),
            "mask": to_numpy(sv.mask), "x": to_numpy(sv.x),
            "risks": to_numpy(risks), "w": to_numpy(w), "b": to_numpy(b),
            "ptr": (to_numpy(state.ptr) if hasattr(state, "ptr")
                    else None)}


def run_sweep_case(rank, case: SweepCase) -> dict:
    """``case`` on this rank. → ``{"sweep": the driven sweep's risks,
    ws, bs, rounds, best, per-round risks and reducers and SV buffer (or
    None), "rounds": per-round :func:`_round_outputs` of the rounds
    driven one by one, "resumed": those of the resumed run from
    ``resume_round + 1`` on (or None), "state": the round state's type
    name, "ms": the driven sweep's ms, "fault": the layer and cause of a
    ``FaultDetected`` the driven sweep raised (then nothing else ran),
    or None}``."""
    Xl, yl, ml, per = shard_of(rank, case.X, case.y, case.mask, case.dtype)
    cfg = case.cfg
    fn = build_sharded_sweep_round(cfg, per, device=rank.device,
                                   per_config_data=case.per_config_data)
    S, d = int(np.shape(case.params.C)[0]), Xl.shape[-1]
    state = fn.init_sv(S, d, Xl.dtype)
    out = {"sweep": None, "rounds": [], "resumed": None, "ms": None,
           "fault": None, "state": type(state).__name__}
    if case.drive:
        t0 = time.perf_counter()
        try:
            res = run_sharded_sweep(fn, Xl, yl, ml, cfg, case.params)
        except faults.FaultDetected as e:   # every rank at the same round
            out["fault"] = {"layer": e.layer, "cause": e.cause}
            return out
        out["ms"] = 1e3 * (time.perf_counter() - t0)
        out["sweep"] = {
            "risks": to_numpy(res.risks), "ws": to_numpy(res.ws),
            "bs": to_numpy(res.bs), "rounds": res.rounds, "best": res.best,
            "history": [h["risks"] for h in res.history],
            "reducers": [h["reducers"] for h in res.history],
            "sv": to_numpy(res.sv)}
    # the grid on the device once, so that no round copies it there
    params = SolverParams(*(tensor_from_numpy(np.asarray(f, np.float32),
                                              rank.device)
                            for f in case.params))
    ckdir = tempfile.mkdtemp(prefix="sweep_state_") \
        if case.resume_round is not None else None
    try:
        for t in range(case.rounds):
            with no_host_sync(rank.device, t == case.sync_check_round):
                state, risks, w, b = fn(Xl, yl, ml, state, params)
            out["rounds"].append(_round_outputs(state, risks, w, b))
            if t == case.resume_round:
                path = os.path.join(ckdir, f"sweep_{t}.npz")
                save_sweep_state(path, state, step=t)
                saved_at = path
        if ckdir is not None:
            state = restore_sweep_state(
                saved_at, cfg, S, d, rank.world_size, per, Xl.dtype,
                per_config_data=case.per_config_data, device=rank.device)
            out["resumed"] = []
            for _ in range(case.resume_round + 1, case.rounds):
                state, risks, w, b = fn(Xl, yl, ml, state, params)
                out["resumed"].append(_round_outputs(state, risks, w, b))
    finally:
        if ckdir is not None:
            shutil.rmtree(ckdir, ignore_errors=True)
    return out


def _recorded(rank, run, cases):
    """``run(rank, case)`` for each case with its collectives recorded.
    → (results, each case's schedule), each schedule checked valid."""
    from repro_torch import analysis, compat
    results, schedules = [], []
    for c in cases:
        with compat.record_collectives() as rec:
            results.append(run(rank, c))
        analysis.check_schedule(rec, program=c.name)
        schedules.append(analysis.collective_schedule(rec))
    return results, schedules


def run_cases(rank, cases: Sequence[Case], chaos_seeds: Sequence[int] = (),
              fit: Optional[tuple] = None,
              sweep_cases: Sequence[SweepCase] = ()) -> dict:
    """:func:`repro_torch.compat.probe`, every case on this rank, then
    the sweep cases, the transport chaos scenarios of ``chaos_seeds``
    and, with ``fit`` (the arguments after the rank), :func:`fit_sharded`.
    → ``{"probe": …, "cases": [run_case results], "sweeps":
    [run_sweep_case results], "chaos": rows of
    :func:`repro_torch.faults.chaos.transport_rank`, "fit": its result
    or None, "routes" / "sweep_routes": launches by route of the cases /
    the sweep cases on this rank, "backend": the group's, "modules":
    whether JAX or the reference package was imported on this rank,
    "schedules" / "sweep_schedules": each case's collective schedule on
    this rank (:func:`repro_torch.analysis.collective_schedule`), checked
    valid here; the parent holds them equal across ranks}``."""
    import sys
    from repro_torch import compat
    from repro_torch.faults import chaos
    probe = compat.probe(rank)
    before = dict(ops.ROUTE_LAUNCHES)
    results, schedules = _recorded(rank, run_case, cases)
    mid = dict(ops.ROUTE_LAUNCHES)
    sweeps, sweep_schedules = _recorded(rank, run_sweep_case, sweep_cases)
    routes = {k: mid[k] - before.get(k, 0) for k in mid}
    sweep_routes = {k: v - mid.get(k, 0)
                    for k, v in ops.ROUTE_LAUNCHES.items()}
    rows = chaos.transport_rank(rank, list(chaos_seeds)) \
        if chaos_seeds else []
    return {"probe": probe, "cases": results, "sweeps": sweeps,
            "chaos": rows, "fit": fit_sharded(rank, *fit) if fit else None,
            "routes": routes, "sweep_routes": sweep_routes,
            "schedules": schedules, "sweep_schedules": sweep_schedules,
            "backend": rank.backend,
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


def fit_sharded_sweep(rank, X, y, cfg: MRSVMConfig, sweep: int = 4,
                      mask=None, dtype: str = "float32",
                      verbose: bool = False) -> dict:
    """The train mode's ``--sweep S`` on this rank (the reference's
    ``repro/launch/train.py:97-113``): the grid C = logspace(-2, 1, S)
    through :func:`run_sharded_sweep`, then each config's best
    hypothesis's accuracy on this rank's shard (it is replicated, so no
    collective). ``X`` is whole numpy rows (dense or ``(indices,
    values, d)``) of which this rank takes its own, or this rank's own
    rows as a tensor or ``SparseRows`` (``y`` alike). → ``{"C", "risks",
    "acc", "rounds", "best", "history": per-round risks, "reducers",
    "ids", "alpha" (the converged SV buffers), "ms"}``, numpy, the same
    on every rank but ``acc``."""
    if isinstance(X, (torch.Tensor, sparse_rows.SparseRows)):
        Xl, yl = X, torch.as_tensor(y, device=X.device).to(X.dtype)
        ml = (torch.ones_like(yl) if mask is None
              else torch.as_tensor(mask, device=X.device).to(X.dtype))
        per = Xl.shape[0]
    else:
        Xl, yl, ml, per = shard_of(rank, X, y, mask, dtype)
    params = sweep_grid(cfg.svm, C=np.logspace(-2, 1, sweep)
                        .astype(np.float32))
    fn = build_sharded_sweep_round(cfg, per, device=rank.device)
    t0 = time.perf_counter()
    res = run_sharded_sweep(fn, Xl, yl, ml, cfg, params,
                            verbose=verbose and rank.rank == 0)
    ms = 1e3 * (time.perf_counter() - t0)
    yf = yl.float()
    # in row chunks: a float32 copy of a full-width rank's rows is 4.3 GB
    acc = [float(((decision_linear(res.ws[s], res.bs[s], Xl,
                                   chunk_rows=1024) >= 0)
                  .float() * 2 - 1 == yf).float().mean())
           for s in range(sweep)]
    if verbose and rank.rank == 0:
        for s in range(sweep):
            print(f"  config C={float(params.C[s]):<8.4g} "
                  f"R_emp={float(res.risks[s]):.4f} acc={acc[s]:.3f} "
                  f"rounds={int(res.rounds[s])}")
        print(f"sweep selected C={float(params.C[res.best]):.4g} "
              f"({sweep} configs, {ms / 1e3:.1f}s)")
    return {"C": params.C, "risks": to_numpy(res.risks), "acc": acc,
            "rounds": res.rounds, "best": res.best,
            "history": [h["risks"] for h in res.history],
            "reducers": [h["reducers"] for h in res.history],
            "ids": to_numpy(res.sv.ids), "alpha": to_numpy(res.sv.alpha),
            "ms": ms}


@dataclasses.dataclass(frozen=True)
class MoECase:
    """One expert layer on a (data × model) ``grid`` of the spawn's
    ranks: the config, the full weights (numpy, by name) and tokens
    ``x`` (B, S, D), of which each rank takes its shards
    (:func:`repro_torch.models.moe.shard_moe_params`, ``shard_tokens``);
    ``capacity_factor`` None is the config's."""
    cfg: ModelConfig
    params: dict
    x: np.ndarray
    grid: Tuple[int, int] = (2, 4)
    capacity_factor: Optional[float] = None


def run_moe_cases(rank, cases: Sequence[MoECase]) -> list:
    """Each case through ``apply_moe_sharded`` on this rank. → per case
    (this rank's y shard (B / data, S, D) as numpy, aux)."""
    out = []
    for c in cases:
        mesh = moe.moe_mesh(*c.grid)
        p = moe.shard_moe_params(
            {k: tensor_from_numpy(v, rank.device)
             for k, v in c.params.items()}, c.cfg, mesh)
        x = moe.shard_tokens(tensor_from_numpy(c.x, rank.device), mesh)
        y, aux = moe.apply_moe_sharded(p, x, c.cfg, mesh, c.capacity_factor)
        out.append((to_numpy(y), float(aux)))
    return out


@dataclasses.dataclass
class LMCase:
    """A dense or VLM decoder served on a (data × model) ``grid`` of the
    spawn's ranks: the config, the full weights (numpy, the reference's
    nested dict) and the first tokens ``prompts`` (B, 1), greedy for
    ``steps`` steps from a zero cache of ``cache_len``."""
    cfg: ModelConfig
    params: dict
    prompts: np.ndarray
    grid: Tuple[int, int] = (1, 2)
    steps: int = 4
    cache_len: int = 16


def run_lm_cases(rank, cases: Sequence[LMCase]) -> list:
    """Each case on ``make_host_mesh(*grid)``: the rank's shards of the
    weights (``convert.lm_params_from_jax`` at the bundle's
    ``in_shardings``), its slice of a zero cache and its rows of the
    prompts; ``steps`` greedy decode steps, recording the collectives,
    then the bundle's ``fn`` as many steps from a new cache. → per case
    {"logits": (steps, B_rank, V) f32 numpy, "tokens": (steps, B_rank),
    "fn_tokens": the bundle's, "schedule": the collectives'
    signatures, "kv_repeat", "heads": (query, cache) heads of the rank}."""
    from repro_torch.analysis.schedule import collective_schedule
    from repro_torch.convert import lm_params_from_jax
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import InputShape, build_serve_step
    from repro_torch.models.layers import local_shard
    out = []
    for c in cases:
        mesh = make_host_mesh(*c.grid)
        B = c.prompts.shape[0]
        bundle = build_serve_step(c.cfg, mesh,
                                  InputShape("case", "decode", c.cache_len, B))
        model = bundle.model
        params = lm_params_from_jax(c.params, rank.device, mesh=mesh,
                                    placements=bundle.in_shardings[0])
        first = local_shard(tensor_from_numpy(c.prompts.astype(np.int32)),
                            bundle.in_shardings[2], mesh).to(rank.device)
        place = bundle.in_shardings[1]
        state = model.init_decode_state(B, c.cache_len, rank.device,
                                        place=place)
        logits, tokens, tok = [], [], first
        with compat.record_collectives() as rec:
            for _ in range(c.steps):
                lg, state = model.decode_step(params, state, tok)
                tok = torch.argmax(lg[:, -1], -1).to(torch.int32)[:, None]
                logits.append(to_numpy(lg[:, -1].float()))
                tokens.append(to_numpy(tok[:, 0]))
        state = model.init_decode_state(B, c.cache_len, rank.device,
                                        place=place)
        fn_tokens, tok = [], first
        for _ in range(c.steps):
            nxt, state = bundle.fn(params, state, tok)
            fn_tokens.append(to_numpy(nxt))
            tok = nxt[:, None]
        out.append({"logits": np.stack(logits), "tokens": np.stack(tokens),
                    "fn_tokens": np.stack(fn_tokens),
                    "schedule": collective_schedule(rec),
                    "kv_repeat": model.kv_repeat,
                    "heads": (params["layers"]["attn"]["wq"].shape[2],
                              state.caches.k.shape[2])})
    return out


@dataclasses.dataclass
class TrainCase:
    """A dense or VLM decoder trained on a (data × model) ``grid`` of the
    spawn's ranks: the config, the full weights (numpy, the reference's
    nested dict; None: ``model.init`` from ``seed`` on the rank's device,
    the same weights as one process draws), the global batch (numpy,
    ``data.lm_batch_at``'s keys), ``steps`` train steps of
    ``build_train_step`` at ``opt`` (None: ``OptConfig()``) and
    ``remat``; with ``prefill`` the prefill step first, on the initial
    weights; with ``forward`` the forward's logits before it; with
    ``gather`` the final weights gathered whole. A batch without labels
    runs no train step and takes no gradient."""
    cfg: ModelConfig
    params: Optional[dict]
    batch: dict
    grid: Tuple[int, int] = (1, 2)
    steps: int = 2
    opt: Optional[object] = None
    remat: bool = True
    prefill: bool = True
    seed: int = 0
    forward: bool = False
    gather: bool = True


def run_train_case(rank, c: TrainCase) -> dict:
    """One :class:`TrainCase` on this rank of ``make_host_mesh(*grid)``:
    the rank's shards (``convert.lm_params_from_jax`` at the bundle's
    placements, or ``model.init``) and batch rows (``steps.local_batch``);
    the prefill step's logits; ``steps`` train steps, the first taken as
    the bundle's step in its two halves (``steps.loss_and_grads``, whose
    gradients at the initial weights are kept and gathered whole, then
    ``optim.apply_updates``), its collectives recorded; the final
    weights gathered. With ``steps`` 0 the gradients only. → a
    dict of tensors and numbers: ``logits`` (the rank's rows (B_rank, 1,
    V)), ``loss0``, ``grads`` (whole, ``tree_leaves`` order),
    ``metrics`` (a dict of floats a step), ``step_s`` (host seconds a
    step, to a device sync), ``coll_s`` (a step's seconds inside the
    collectives, where ``compat.timed_collectives`` is armed, else 0),
    ``params`` (whole, with ``gather``), ``record`` (the first step's
    ``CollectiveEntry`` s), ``seq_parallel``, ``bundle``, and the rank's
    ``model``, ``local_params`` (after the steps) and ``batch``."""
    from repro_torch import optim
    from repro_torch.convert import lm_params_from_jax
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.layers import tree_leaves, tree_unflatten
    mesh = make_host_mesh(*c.grid)
    B, S = c.batch["tokens"].shape
    S += c.cfg.num_prefix_tokens if c.cfg.frontend == "vision" else 0
    shape = steps.InputShape("case", "train", S, B)
    bundle = steps.build_train_step(c.cfg, mesh, shape, opt_cfg=c.opt,
                                    remat=c.remat)
    model, place = bundle.model, bundle.in_shardings[0]
    dev = torch.device(rank.device)
    if c.params is None:
        params = model.init(torch.Generator(device=dev).manual_seed(c.seed))
    else:
        params = lm_params_from_jax(c.params, dev, mesh=mesh,
                                    placements=place)
    batch = steps.local_batch(c.batch, bundle.in_shardings[2], mesh, dev)
    out = {"seq_parallel": model.seq_parallel(S), "bundle": bundle,
           "model": model, "batch": batch}
    if c.forward:
        with torch.no_grad():
            out["forward"] = model.forward(params, batch["tokens"],
                                           batch.get("prefix_embeds"))[0]
    if c.prefill:
        pre = steps.build_prefill_step(
            c.cfg, mesh, steps.InputShape("case", "prefill", S, B))
        out["logits"] = pre.fn(params, {k: v for k, v in batch.items()
                                        if k != "labels"})
    if "labels" not in batch:
        return {**out, "local_params": params}
    state = optim.init(params)
    metrics, secs, coll, record = [], [], [], []
    for i in range(max(c.steps, 1)):
        _sync(dev)
        c0 = compat.collective_clock()
        t0 = time.perf_counter()
        with (compat.record_collectives() if i == 0
              else contextlib.nullcontext()) as rec:
            if i == 0:
                # step 1 is the bundle's train step in its two halves:
                # the gradients, kept, then the update
                loss, m, grads = steps.loss_and_grads(model, params, batch)
                out["loss0"] = float(loss)
                out["grads"] = grads
                if c.steps:
                    params, state, om = optim.apply_updates(
                        params, tree_unflatten(params, grads), state,
                        c.opt or optim.OptConfig(), place=place,
                        mesh=mesh)
                    m = {"loss": loss, **m, **om}
            else:
                params, state, m = bundle.fn(params, state, batch)
            if c.steps:
                metrics.append({k: float(v) for k, v in m.items()})
        _sync(dev)
        secs.append(time.perf_counter() - t0)
        coll.append(compat.collective_clock() - c0)
        if i == 0:
            record = list(rec)
    out["grads"] = tree_leaves(steps.gather_tree(
        tree_unflatten(params, out["grads"]), place, mesh))
    out.update(metrics=metrics, step_s=secs, coll_s=coll, record=record,
               local_params=params)
    if c.gather:
        out["params"] = tree_leaves(steps.gather_tree(params, place, mesh))
    return out


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_train_cases(rank, cases: Sequence[TrainCase]) -> list:
    """Each case through :func:`run_train_case` on this rank. → per case
    numpy: ``logits``, ``forward``, ``loss0``, ``grads`` and ``params``
    (whole, leaf order), ``metrics``, ``schedule`` (the first step's
    collective signatures), ``kinds`` (its collectives' kinds),
    ``seq_parallel``, as far as the case ran them."""
    from repro_torch.analysis.schedule import collective_schedule
    out = []
    for c in cases:
        r = run_train_case(rank, c)
        out.append({
            "seq_parallel": r["seq_parallel"],
            **{k: to_numpy(r[k].float()) for k in ("logits", "forward")
               if k in r},
            **({"loss0": r["loss0"],
                "grads": [to_numpy(g.float()) for g in r["grads"]],
                "params": [to_numpy(p.float()) for p in r["params"]],
                "metrics": r["metrics"],
                "schedule": collective_schedule(r["record"]),
                "kinds": [e.kind for e in r["record"]]}
               if "grads" in r else {})})
    return out
