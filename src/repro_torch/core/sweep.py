"""Batched multi-config hyper-parameter sweeps (functional mode).

The paper selects between polarization models by training several SVM
variants and comparing their confusion matrices (Tablo 6/8). S (C, tol,
epoch cutoff, kernel-scale) configurations are independent jobs, so
instead of S sequential ``fit_mapreduce`` calls the sweep puts the
configs on the kernels' job axis: a round is one solve launch for all
S·L (config, partition) jobs, each with its own C, tol and epoch cutoff
(and on the Gram path one Gram build, each job with its own γ and
coef0), as :func:`repro_torch.core.mapreduce_svm.sweep_round` runs it.

Per-config convergence (eq. 8) is masked, not synchronized: a finished
config gets tol = +inf and an epoch cutoff of 0 (its jobs run no epoch
and leave α, w and b at 0), its SV buffer and best hypothesis are kept
as they were, and the loop exits when every config has converged. Each
config's trajectory is that of a sequential ``fit_mapreduce`` with its
params and data.

One-vs-rest multiclass folds into the same axis: k classes × S configs
are k·S binary jobs (:func:`fit_one_vs_rest_sweep`).

A non-finite risk of an active config at a round's readback raises
``FaultDetected("core")`` (``faults.check_finite_risks``), as the
reference's.

The sharded sweep (:func:`build_sharded_sweep_round`,
:func:`run_sharded_sweep`) runs the S configs' round on the ranks of a
``torch.distributed`` group, one partition a rank, as
:func:`repro_torch.core.mapreduce_svm.build_sharded_round` runs one
config: a rank's S reducers are one solve launch of S jobs, and the
merge moves the S configs' chunks at once: ``allgather`` one
collective per leaf of the stacked chunk; ``ring`` and ``hier`` one
packed message a hop over the shared hop engine, whose rows on
shared-data sweeps are the rank's unique candidate rows
(:class:`DedupChunk`, shipped and stored once however many configs
picked them). The eq. 8 readback of all S configs is one collective.
A streaming wave's per-stream rows (``per_config_data``) run the same
program with a leading (S,) axis on the rows. :func:`save_sweep_state`
and :func:`restore_sweep_state` checkpoint a round state in the
reference's file format.
"""
from __future__ import annotations

import contextlib
import time
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import compat, faults
from repro_torch import sparse as sparse_rows
from repro_torch.analysis.hostsync import allowed_host_sync
from repro_torch.analysis.retrace import no_retrace
from repro_torch.core.mapreduce_svm import (PACKED_SHUFFLES, MRSVMConfig,
                                            RoundResult, SVBuffer,
                                            _device_risks,
                                            _float_dtype, _hop_plan,
                                            _merge_hops, _partials,
                                            _round_candidates,
                                            init_sv_buffer, pack_wire_rows,
                                            resolve_topology, sweep_round,
                                            unpack_wire_rows)
from repro_torch.core.svm import (BinarySVM, SolverParams, SVMConfig,
                                  decision_kernel, decision_linear,
                                  predict_sign, solve_kernel_jobs,
                                  solve_linear_jobs)
from repro_torch.device import DeviceLike, as_tensor, resolve_device
from repro_torch.kernels import ops


class SweepResult(NamedTuple):
    """Converged state of every config in the sweep (leading axis S)."""
    params: SolverParams   # (S,) float32 tensors on the sweep's device
    risks: torch.Tensor    # (S,) best R_emp per config over its rounds
    ws: torch.Tensor       # (S, d) best linear hypothesis per config
    bs: torch.Tensor       # (S,)
    sv: SVBuffer           # (S, cap, …) converged SV_global per config
    final: BinarySVM       # (S, …) models retrained on SV_global alone
    rounds: np.ndarray     # (S,) rounds each config ran before eq. 8
    history: Tuple[dict, ...]

    @property
    def num_configs(self) -> int:
        return int(self.risks.shape[0])

    @property
    def best(self) -> int:
        """Index of the sweep-selected config (min empirical risk)."""
        return int(np.argmin(self.risks.cpu().numpy()))


# ---------------------------------------------------------------------------
# Building batched SolverParams.
# ---------------------------------------------------------------------------

def stack_params(params_list: Sequence[SolverParams]) -> SolverParams:
    """Stack per-config params into one (S,)-batched set of float32
    numpy arrays."""
    if not params_list:
        raise ValueError("empty sweep")
    return SolverParams(*(np.asarray([float(v) for v in field], np.float32)
                          for field in zip(*params_list)))


def sweep_grid(cfg: SVMConfig,
               C: Optional[Sequence[float]] = None,
               gamma: Optional[Sequence[float]] = None,
               tol: Optional[Sequence[float]] = None,
               sv_threshold: Optional[Sequence[float]] = None,
               coef0: Optional[Sequence[float]] = None,
               max_epochs: Optional[Sequence[int]] = None) -> SolverParams:
    """Cartesian grid over the value-like hyper-params, defaults from
    ``cfg``: (S,) float32 numpy arrays with S = Π len(axis), C-major, as
    ``itertools.product(C, gamma, tol, sv_threshold, coef0,
    max_epochs)``. ``max_epochs`` entries are cutoffs: they can only
    tighten ``cfg.max_epochs``."""
    base = cfg.params()
    axes = [np.atleast_1d(np.asarray(v, np.float32)) if v is not None
            else np.asarray([float(dflt)], np.float32)
            for v, dflt in ((C, base.C), (gamma, base.gamma),
                            (tol, base.tol),
                            (sv_threshold, base.sv_threshold),
                            (coef0, base.coef0),
                            (max_epochs, base.max_epochs))]
    c, g, t, s, c0, me = (a.reshape(-1) for a in
                          np.meshgrid(*axes, indexing="ij"))
    return SolverParams(C=c, tol=t, sv_threshold=s, gamma=g, coef0=c0,
                        max_epochs=me)


def _num_configs(params: SolverParams) -> int:
    shapes = [tuple(np.shape(f)) for f in params]
    S = shapes[0][0] if shapes[0] else None
    if S is None or any(s != (S,) for s in shapes):
        raise ValueError("sweep params must share one leading (S,) axis; "
                         f"got shapes {shapes}")
    return int(S)


def _params_on(params: SolverParams, dev: torch.device) -> SolverParams:
    return SolverParams(*(as_tensor(f, dev, torch.float32) for f in params))


def _freeze(done: torch.Tensor, old, new):
    """Per-config select: keep ``old`` where ``done`` (leading S), for
    tensors, ``SparseRows`` and NamedTuples of them."""
    if isinstance(new, tuple):
        return type(new)(*(_freeze(done, o, n) for o, n in zip(old, new)))
    if sparse_rows.is_sparse(new):
        return sparse_rows.SparseRows(
            _freeze(done, old.indices, new.indices),
            _freeze(done, old.values, new.values), new.d,
            old.ids_in_range and new.ids_in_range)
    return torch.where(done.reshape((-1,) + (1,) * (new.dim() - 1)), old, new)


def _config_part(tree, s: int):
    """A copy of config ``s``'s slice of a per-config tree (leading S),
    in host memory: tensors, ``SparseRows`` and NamedTuples of them."""
    if isinstance(tree, tuple):
        return type(tree)(*(_config_part(f, s) for f in tree))
    if sparse_rows.is_sparse(tree):
        return sparse_rows.SparseRows(tree.indices[s].to("cpu", copy=True),
                                      tree.values[s].to("cpu", copy=True),
                                      tree.d, tree.ids_in_range)
    return tree[s].to("cpu", copy=True)


def _put_config(tree, s: int, part) -> None:
    """Write :func:`_config_part`'s ``part`` back as config ``s`` of
    ``tree``, in place (the column-id mark kept when both had it)."""
    if isinstance(tree, tuple):
        for f, p in zip(tree, part):
            _put_config(f, s, p)
    elif sparse_rows.is_sparse(tree):
        marked = tree.ids_in_range and part.ids_in_range
        tree.indices[s].copy_(part.indices)
        tree.values[s].copy_(part.values)
        if marked:
            tree.mark_ids_in_range()
    else:
        tree[s].copy_(part)


def _on_card(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A host mask on the card without a host sync (a copy of it is
    staged at the call)."""
    return torch.tensor(a).to(dev, non_blocking=True)


def masked_step(step, svb: SVBuffer, params: SolverParams,
                done: np.ndarray, freeze: bool = True):
    """A round's device work with eq. 8's mask: configs ``done`` get
    tol = +inf and an epoch cutoff of 0 and (with ``freeze``) keep their
    SV buffer. No host sync. → (svb, picks (2, S): each config's best
    reducer's risk and index, ws (S, d), bs (S,))."""
    dmask = _on_card(done, params.C.device)
    eff = params._replace(
        tol=torch.where(dmask, torch.inf, params.tol),
        max_epochs=torch.where(dmask, 0.0, params.max_epochs))
    sv_new, r_star, l_star, ws, bs = step(svb, eff)
    return (_freeze(dmask, svb, sv_new) if freeze else sv_new,
            torch.stack([r_star.float(), l_star.float()]), ws, bs)


def _run_rounds(step, svb, d: int, cfg: MRSVMConfig,
                params: SolverParams, verbose: bool, tag: str,
                snapshot=None, fail_on_retrace: bool = False):
    """The eq. 8-masked host round loop.

    ``step(svb, eff_params) -> (sv_new, r_star (S,), l_star (S,), ws (S,
    d), bs (S,))`` with r_star/ws/bs reduced to each config's best
    reducer l_star on the card. Finished configs get tol = +inf and an
    epoch cutoff of 0 and keep their SV buffer and best hypothesis. The
    host reads the (S,) risks and picks (eq. 8's sync point); the
    improved hypotheses are selected on the card, where they stay. Each
    history entry records the round's host-clock ``ms``, to that
    readback.

    ``snapshot`` handles round states that are not per-config buffers
    (the packed transports' shared-row :class:`DedupChunk`): the state
    threads through ``step`` unfrozen (a finished config runs 0 epochs,
    so its candidates die and it can neither claim a unique slot nor
    change an active config's result), and ``snapshot(state)`` makes the
    per-config (S, cap, …) buffer only on a round where a config
    converges and on the last round; of the first only the converged
    configs' slices are kept, in host memory until the last round (at
    svm-tfidf width a config's slice is 0.54 GB a rank, which 8 ranks
    sharing one card cannot hold beside a round).

    Invariant hooks (:mod:`repro_torch.analysis`): the per-round
    readback of the risks and picks is the loop's designed sync point
    and runs under ``allowed_host_sync``, as does the copy of a
    converged config's slice to host memory, so a caller-armed
    ``no_implicit_host_sync`` passes them and catches any other sync.
    ``fail_on_retrace`` arms the retrace rule on every round past the
    first: a steady-state round meets no new kernel library or wrapper
    signature (round 0 meets them; a convergence round's ``snapshot``
    is off the hot path and stays outside the guard, as in the
    reference).
    """
    S = _num_configs(params)
    dev = params.C.device
    done = np.zeros(S, bool)
    prev = np.full(S, np.inf)
    best_risk = np.full(S, np.inf)
    best_w = torch.zeros((S, d), dtype=torch.float32, device=dev)
    best_b = torch.zeros((S,), dtype=torch.float32, device=dev)
    rounds = np.zeros(S, np.int64)
    history = []
    frozen = None if snapshot is not None else svb
    parts = {}            # snapshot: each converged config's frozen slice
    for t in range(cfg.max_rounds):
        t0 = time.perf_counter()
        guard = (no_retrace(f"[{tag}] steady-state round {t}")
                 if fail_on_retrace and t >= 1
                 else contextlib.nullcontext())
        with guard:
            sv_new, picks, ws, bs = masked_step(step, svb, params, done,
                                                freeze=snapshot is None)
            svb = sv_new
            if snapshot is None:
                frozen = svb
            with allowed_host_sync("eq. 8 convergence readback"):
                r_star, l_star = picks.cpu().numpy()
        ms = 1e3 * (time.perf_counter() - t0)
        act = ~done
        faults.check_finite_risks(r_star, where=f"{tag} round {t}", mask=act)
        improved = act & (r_star < best_risk)
        if improved.any():
            imp = _on_card(improved, dev)
            best_w = torch.where(imp[:, None], ws.float(), best_w)
            best_b = torch.where(imp, bs.float(), best_b)
            best_risk = np.where(improved, r_star, best_risk)
        rounds[act] += 1
        history.append({"round": t, "risks": np.where(act, r_star, np.nan),
                        "reducers": np.where(act, l_star, -1).astype(int),
                        "active": int(act.sum()), "ms": ms})
        if verbose:
            print(f"[{tag}] round={t} active={int(act.sum())}/{S} "
                  f"best_R_emp={np.nanmin(np.where(act, r_star, np.nan)):.5f}"
                  f" ms={ms:.1f}")
        newly = act & (t > 0) & (np.abs(prev - r_star) <= cfg.gamma)  # eq. 8
        if snapshot is not None and (newly.any()
                                     or t == cfg.max_rounds - 1):
            exp = snapshot(sv_new)
            if t == cfg.max_rounds - 1 or (done | newly).all():
                for s, part in parts.items():
                    _put_config(exp, s, part)
                frozen = exp
            else:
                with allowed_host_sync("a converged config's slice to "
                                       "host memory"):
                    for s in np.flatnonzero(newly):
                        parts[int(s)] = _config_part(exp, int(s))
            del exp
        done |= newly
        prev = np.where(act, r_star, prev)
        if done.all():
            break
    return frozen, best_risk, best_w, best_b, rounds, tuple(history)


# ---------------------------------------------------------------------------
# Functional sweep driver.
# ---------------------------------------------------------------------------

def _stack_sv(sv: SVBuffer, S: int) -> SVBuffer:
    def stack(f):
        if sparse_rows.is_sparse(f):
            return sparse_rows.SparseRows(stack(f.indices), stack(f.values),
                                          f.d, f.ids_in_range)
        return f[None].expand(S, *f.shape).contiguous()
    return SVBuffer(*(stack(f) for f in sv))


def _retrain(svb: SVBuffer, params: SolverParams,
             cfg: MRSVMConfig) -> BinarySVM:
    """Each config's final model on its SV_global alone: one S-job
    solve (job s on buffer s, with config s's params; each job its own
    empty shared block, as a lone final fit has)."""
    solve = solve_linear_jobs if cfg.svm.is_linear else solve_kernel_jobs
    return solve(svb.x, svb.x[:, :0], svb.y, svb.mask, cfg.svm, params)


def best_reducers(out):
    """Each config's best reducer (eq. 7) of a :func:`sweep_round`
    output (or of a sharded sweep round's risks (S, ndev) and
    hypotheses), picked on the card as the first minimum. → (r (S,), l
    (S,), w (S, d), b (S,))."""
    l_star = out.risks.argmin(1)
    configs = torch.arange(l_star.shape[0], device=l_star.device)
    return (out.risks[configs, l_star], l_star, out.ws[configs, l_star],
            out.bs[configs, l_star])


def fit_mapreduce_sweep(X, y, num_partitions: int, cfg: MRSVMConfig,
                        params: SolverParams, mask=None,
                        verbose: bool = False,
                        device: DeviceLike = None,
                        fail_on_retrace: bool = False) -> SweepResult:
    """Run S MapReduce-SVM jobs in one batched computation.

    Every data input is either shared or carries a leading (S,) job
    axis: ``X`` is ``(n, d)`` (shared) or ``(S, n, d)`` (per-job rows),
    dense or ``SparseRows``; ``y`` is ``(n,)`` or ``(S, n)`` (per-job
    labels, as the one-vs-rest fold gives); ``mask`` is ``None``,
    ``(n,)`` or ``(S, n)``. ``params`` has (S,) fields (numpy or
    tensors). Each config's trajectory is that of a sequential
    ``fit_mapreduce`` with its params and data slice. Numpy inputs go
    to ``device`` (default ``cuda``). ``fail_on_retrace`` arms the
    retrace rule on every round past the first (:func:`_run_rounds`).
    """
    S = _num_configs(params)
    dev = resolve_device(device, like=X)
    X = as_tensor(X, dev)
    if sparse_rows.is_sparse(X):
        ops.check_column_ids(X)      # once, so that no round waits on it
    params = _params_on(params, dev)
    n, d = X.shape[-2], X.shape[-1]
    L = num_partitions
    per = -(-n // L)
    pad = L * per - n
    if len(X.shape) == 3 and X.shape[0] != S:
        raise ValueError(f"per-job X has leading axis {X.shape[0]}, "
                         f"expected S={S}")
    Xp = sparse_rows.pad_rows(X, pad).reshape(*X.shape[:-2], L, per, d)
    pad_jobs = lambda v: torch.nn.functional.pad(  # noqa: E731
        v, (0, pad)).reshape(*v.shape[:-1], L, per)
    y = as_tensor(y, dev, X.dtype)
    if y.dim() == 2 and y.shape[0] != S:
        raise ValueError(f"per-job y has leading axis {y.shape[0]}, "
                         f"expected S={S}")
    yp = pad_jobs(y)
    base_mask = torch.ones((n,), dtype=X.dtype, device=dev) if mask is None \
        else as_tensor(mask, dev, X.dtype)
    maskp = pad_jobs(base_mask)

    svb = _stack_sv(init_sv_buffer(
        cfg.sv_capacity, d, X.dtype, dev,
        nnz_cap=X.nnz_cap if sparse_rows.is_sparse(X) else None), S)

    def step(sv_b, eff):
        out = sweep_round(Xp, yp, maskp, sv_b, cfg, eff)
        return (out.sv, *best_reducers(out))

    svb, best_risk, best_w, best_b, rounds, history = _run_rounds(
        step, svb, d, cfg, params, verbose, "sweep",
        fail_on_retrace=fail_on_retrace)
    final = _retrain(svb, params, cfg)
    return SweepResult(params=params,
                       risks=torch.as_tensor(best_risk, dtype=torch.float32),
                       ws=best_w, bs=best_b, sv=svb, final=final,
                       rounds=rounds, history=history)


def sweep_decision_values(res: SweepResult, X, cfg: MRSVMConfig,
                          device: DeviceLike = None) -> torch.Tensor:
    """(S, n) decision values of every config's final model on ``X``."""
    dev = resolve_device(device, like=res.bs)
    X = as_tensor(X, dev)
    final = res.final
    if cfg.svm.is_linear:
        return torch.stack([decision_linear(final.w[s], final.b[s], X)
                            for s in range(res.num_configs)])
    sv = res.sv
    coef = final.alpha * sv.y.to(final.alpha.dtype) \
        * sv.mask.to(final.alpha.dtype)
    return torch.stack([decision_kernel(
        sv.x[s], coef[s], final.b[s], X, cfg.svm,
        SolverParams(*(f[s] for f in res.params)))
        for s in range(res.num_configs)])


def predict_sweep(res: SweepResult, X, cfg: MRSVMConfig,
                  device: DeviceLike = None) -> torch.Tensor:
    """(S, n) ±1 predictions of every config's final model."""
    return predict_sign(sweep_decision_values(res, X, cfg, device))


# ---------------------------------------------------------------------------
# One-vs-rest folded into the batch axis.
# ---------------------------------------------------------------------------

class SweepOneVsRest(NamedTuple):
    """k classes × S configs trained as one k·S-job batch.

    Job ``j`` is (config ``j // k``, class ``classes[j % k]``).
    """
    classes: Tuple[int, ...]
    num_configs: int
    result: SweepResult
    cfg: MRSVMConfig

    def decision_tensor(self, X) -> torch.Tensor:
        """(S, k, n) one-vs-rest decision values."""
        k = len(self.classes)
        dm = sweep_decision_values(self.result, X, self.cfg)   # (k*S, n)
        return dm.reshape(self.num_configs, k, dm.shape[-1])

    def predict(self, X) -> torch.Tensor:
        """(S, n) class labels per config (argmax over the k scores)."""
        idx = torch.argmax(self.decision_tensor(X), dim=1)
        return torch.as_tensor(self.classes, device=idx.device)[idx]

    def risks(self) -> np.ndarray:
        """(S,) mean over the k binary jobs' best risks — the sweep's
        per-config model-selection score."""
        k = len(self.classes)
        return self.result.risks.cpu().numpy().reshape(
            self.num_configs, k).mean(axis=1)

    @property
    def best(self) -> int:
        return int(np.argmin(self.risks()))


def fit_one_vs_rest_sweep(X, y, classes: Sequence[int], num_partitions: int,
                          cfg: MRSVMConfig, params: SolverParams,
                          verbose: bool = False,
                          device: DeviceLike = None) -> SweepOneVsRest:
    """One-vs-rest multiclass × hyper-param sweep as a single batch."""
    k = len(classes)
    S = _num_configs(params)
    dev = resolve_device(device, like=X)
    X = as_tensor(X, dev)
    y = as_tensor(y, dev)
    y1 = torch.stack([torch.where(y == c, 1.0, -1.0).to(X.dtype)
                      for c in classes])                     # (k, n)
    pj = SolverParams(*(f.repeat_interleave(k)
                        for f in _params_on(params, dev)))
    res = fit_mapreduce_sweep(X, y1.repeat(S, 1), num_partitions, cfg, pj,
                              verbose=verbose, device=dev)
    return SweepOneVsRest(classes=tuple(int(c) for c in classes),
                          num_configs=S, result=res, cfg=cfg)


# ---------------------------------------------------------------------------
# Cross-config SV dedup: the packed sweep's wire format and round state.
# ---------------------------------------------------------------------------

class DedupChunk(NamedTuple):
    """A rank's deduplicated candidate chunk of a sweep round.

    S configs solving the SAME sharded data pick overlapping support
    sets, so shipping every config's (k, d) candidate rows moves each
    shared row S times. The dedup layout is the chunk's unique home rows
    plus per-config sidebands:

      x (U, d)      unique feature rows (wire dtype, dense or
                    ``SparseRows``), each shipped once
      y (U,)        labels of the unique rows
      ids (U,)      global row ids (-1 on dead slots)
      ptr (S, k)    each config's j-th candidate → its unique slot (-1
                    when dead or evicted)
      alpha (S, k)  per-config α columns (never shared)
      mask (S, k)   per-config live flags

    With ``U = min(S·k, per)`` (the default) no live row is ever
    evicted, so :func:`expand_chunk` ∘ :func:`dedup_candidates` is
    lossless; a smaller ``dedup_max_unique`` evicts the unique rows of
    least evidence. The sharded sweep's round state on the packed
    transports is the same layout over all ranks' chunks, ``ptr`` on
    the global slot axis (block o's slots offset by o·U).
    """
    x: object
    y: torch.Tensor
    ids: torch.Tensor
    ptr: torch.Tensor
    alpha: torch.Tensor
    mask: torch.Tensor


def dedup_unique_cap(cfg: MRSVMConfig, num_configs: int, k: int,
                     per: int) -> int:
    """Unique-row slots a rank ships a round (see :class:`DedupChunk`)."""
    if cfg.dedup_max_unique is not None:
        return max(1, min(cfg.dedup_max_unique, num_configs * k, per))
    return min(num_configs * k, per)


def dedup_candidates(cand: SVBuffer, Xl, yl: torch.Tensor, idx: int,
                     per: int, unique_cap: int,
                     wire_dtype=torch.bfloat16) -> DedupChunk:
    """Collapse (S, k) candidate chunks to unique home rows + sidebands.

    Every id of ``cand`` points into THIS rank's home rows ``[idx·per,
    (idx+1)·per)``, so a (per,)-slot scoreboard of the max α over the
    configs (the eviction priority; a ``scatter_reduce("amax")`` on
    zeros) finds the unique set. Its ``unique_cap`` best slots come from
    a stable descending sort: the lower row first on ties, as
    ``lax.top_k`` orders them (``torch.topk`` promises no order), and a
    tie at the cut decides which rows are evicted. Live candidates have
    α > 0 (``sv_threshold ≥ 0``).
    """
    live = cand.mask > 0
    r = torch.where(live, cand.ids.long() - idx * per, 0)   # local row ids
    score = torch.zeros((per,), dtype=torch.float32,
                        device=cand.alpha.device).scatter_reduce_(
        0, r.reshape(-1),
        torch.where(live, cand.alpha.float(), 0.0).reshape(-1), "amax",
        include_self=True)
    top_score, top_r = torch.sort(score, descending=True, stable=True)
    top_score, top_r = top_score[:unique_cap], top_r[:unique_cap]
    live_u = top_score > 0
    slot = torch.where(live_u, torch.arange(unique_cap, dtype=torch.int32,
                                            device=r.device), -1)
    inv = torch.full((per,), -1, dtype=torch.int32,
                     device=r.device).scatter_(0, top_r, slot)
    wire_dtype = (_float_dtype(wire_dtype) if isinstance(wire_dtype, str)
                  else wire_dtype)
    return DedupChunk(
        x=(Xl[top_r] * live_u[:, None].to(Xl.dtype)).to(dtype=wire_dtype),
        y=yl[top_r] * live_u.to(yl.dtype),
        ids=torch.where(live_u, (idx * per + top_r).to(torch.int32), -1),
        ptr=torch.where(live, inv[r], -1),
        alpha=cand.alpha,
        mask=cand.mask)


def expand_chunk(chunk: DedupChunk, buf_dtype=torch.float32) -> SVBuffer:
    """Inverse of :func:`dedup_candidates`: per-config (…, k) chunks.

    A candidate whose unique row was evicted (``ptr == -1``) comes back
    dead; at the lossless default capacity that never happens and the
    round trip gives the chunks back exactly (up to the wire dtype of
    ``x``)."""
    safe = torch.clamp(chunk.ptr, min=0).long()
    valid = (chunk.ptr >= 0) & (chunk.mask > 0)
    vf = valid.to(buf_dtype)
    x = chunk.x[safe]
    if sparse_rows.is_sparse(x):
        x = x.to(dtype=buf_dtype) * vf[..., None]
    else:
        # the 0/1 mask in place before the cast (exact in either order):
        # one copy of the (…, k, d) rows fewer
        x = x.mul_(vf[..., None].to(x.dtype)).to(dtype=buf_dtype)
    return SVBuffer(
        x=x,
        y=chunk.y[safe].to(buf_dtype) * vf,
        alpha=chunk.alpha.to(buf_dtype) * vf,
        ids=torch.where(valid, chunk.ids[safe], -1),
        mask=vf)


# ---------------------------------------------------------------------------
# Sharded sweep: S configs a round on the ranks of a torch.distributed group.
# ---------------------------------------------------------------------------

def uses_dedup_state(cfg: MRSVMConfig, per_config_data: bool) -> bool:
    """True when the sharded sweep's round state IS the dedup wire
    format: the packed transports (ring and hier) on shared rows with
    ``sweep_dedup``. Per-stream rows (``per_config_data``) keep
    per-config buffers: their ids index different datasets, so there
    are no shared rows to collapse."""
    return (cfg.shuffle_impl in PACKED_SHUFFLES and cfg.sweep_dedup
            and not per_config_data)


def init_sharded_sweep_sv(cfg: MRSVMConfig, num_configs: int, d: int,
                          num_devices: int, rows_per_device: int,
                          dtype=torch.float32, per_config_data: bool = False,
                          device: DeviceLike = None):
    """Empty round-0 state of the sharded sweep, with the reference's
    shapes and dtypes, on ``device`` (default ``cuda``; ``"meta"`` gives
    a shape-only tree).

    Allgather carries the (S, cap, …) :class:`SVBuffer`; the dedup
    packed transports carry the shared-row :class:`DedupChunk` over all
    ranks' unique slots (``num_devices · U`` rows); per-stream packed
    rounds keep per-config buffers with wire-dtype feature rows.
    Blocked-CSR rows (``cfg.svm.row_format == "sparse_csr"``) are
    ``SparseRows`` of ``cfg.svm.nnz_cap`` slots."""
    dev = (torch.device(device) if str(device) == "meta"
           else resolve_device(device))
    cap = cfg.sv_capacity
    nnzc = (cfg.svm.nnz_cap if cfg.svm.row_format == "sparse_csr"
            else None)
    wire_dt = _float_dtype(cfg.shuffle_wire_dtype)
    if uses_dedup_state(cfg, per_config_data):
        k = cap // num_devices
        U = dedup_unique_cap(cfg, num_configs, k, rows_per_device)
        R = num_devices * U
        x0 = (torch.zeros((R, d), dtype=wire_dt, device=dev) if nnzc is None
              else sparse_rows.SparseRows(
                  torch.zeros((R, nnzc), dtype=torch.int32, device=dev),
                  torch.zeros((R, nnzc), dtype=wire_dt, device=dev), d,
                  ids_in_range=True))
        side = lambda fill, dt: torch.full(  # noqa: E731
            (num_configs, cap), fill, dtype=dt, device=dev)
        return DedupChunk(
            x=x0, y=torch.zeros((R,), dtype=dtype, device=dev),
            ids=torch.full((R,), -1, dtype=torch.int32, device=dev),
            ptr=side(-1, torch.int32), alpha=side(0, dtype),
            mask=side(0, dtype))
    sv0 = init_sv_buffer(cap, d, dtype, dev, nnz_cap=nnzc)
    if cfg.shuffle_impl in PACKED_SHUFFLES:
        sv0 = sv0._replace(x=sv0.x.to(dtype=wire_dt))
    return _stack_sv(sv0, num_configs)


def _state_views(state: DedupChunk, buf_dt) -> SVBuffer:
    """The S configs' (S, cap, …) SV buffers of the shared-row state, as
    the solve reads them: the sidebands are per config, the feature rows
    gathered from the shared unique rows (in the wire dtype). They live
    for one solve; the round frees them before the merge."""
    safe = torch.clamp(state.ptr, min=0).long()
    valid = (state.ptr >= 0) & (state.mask > 0)
    vf = valid.to(buf_dt)
    x = state.x[safe]
    if sparse_rows.is_sparse(x):
        x = x * vf[..., None]
    else:
        x.mul_(vf[..., None].to(x.dtype))
    return SVBuffer(x=x, y=state.y[safe].to(buf_dt) * vf,
                    alpha=state.alpha.to(buf_dt) * vf,
                    ids=torch.where(valid, state.ids[safe], -1),
                    mask=vf)


def _rows_map(x, fn):
    """``fn`` over a row batch's leading axes: a dense tensor, or both
    leaves of ``SparseRows`` (whose last axis, slots, ``fn`` keeps)."""
    if sparse_rows.is_sparse(x):
        return sparse_rows.SparseRows(fn(x.indices), fn(x.values), x.d)
    return fn(x)


def _config_major(a, ndev: int, S: int, k: int):
    """(ndev, S, k, …) chunks in rank order → (S, ndev·k, …) per-config
    columns."""
    return a.transpose(0, 1).reshape(S, ndev * k, *a.shape[3:])


def _config_partials(Xl, yl, ml, W: torch.Tensor, B: torch.Tensor,
                     loss: str, per_config_data: bool) -> torch.Tensor:
    """This rank's eq. 7 loss sums of hypotheses W (m, S, d), B (m, S):
    on shared rows ONE ``hinge_scores`` call over the m·S hypotheses; on
    per-stream rows one call a config, on its rows. → (m, S)."""
    m, S, d = W.shape
    if per_config_data:
        return torch.stack([_partials(Xl[s], yl[s], ml[s], W[:, s], B[:, s],
                                      loss) for s in range(S)], 1)
    return _partials(Xl, yl, ml, W.reshape(m * S, d), B.reshape(m * S),
                     loss).reshape(m, S)


def _assemble_chunks(xs, M: torch.Tensor, o_x: int, dedup: bool, ndev: int,
                     U: int, k: int, S: int, buf_dt):
    """The round state from the rank-ordered messages.

    ``xs`` is the unpacked wire-dtype rows already in rank order —
    (ndev·U, …) for dedup chunks, (S, ndev·k, …) for plain chunks — and
    ``M`` the (ndev, ·) message lanes in rank order with the sidebands
    from column ``o_x``. Dedup chunks: the per-config ptr columns are
    rebased onto the global slot axis (block o adds o·U). Plain chunks
    (per-stream waves): the sideband leaves become (S, ndev·k) columns.
    y, α and the mask come back in the rows' dtype, as the reference's
    state holds them."""
    cap = ndev * k
    sides = M[:, o_x:]
    per_cfg = lambda a: a.reshape(ndev, S, k).transpose(0, 1) \
        .reshape(S, cap)   # noqa: E731
    if dedup:
        def col(a, b):
            return sides[:, a:b]
        ptr = col(2 * U, 2 * U + S * k).reshape(ndev, S, k)
        base = torch.arange(ndev, dtype=torch.float32,
                            device=M.device)[:, None, None] * U
        ptr = torch.where(ptr >= 0, ptr + base, -1.0)
        return DedupChunk(
            x=xs,
            y=col(0, U).reshape(ndev * U).to(buf_dt),
            ids=col(U, 2 * U).reshape(ndev * U).to(torch.int32),
            ptr=per_cfg(ptr).to(torch.int32),
            alpha=per_cfg(col(2 * U + S * k, 2 * U + 2 * S * k)).to(buf_dt),
            mask=per_cfg(col(2 * U + 2 * S * k, 2 * U + 3 * S * k))
            .to(buf_dt))

    def col(i):
        return sides[:, i * S * k:(i + 1) * S * k]
    return SVBuffer(
        x=xs,
        y=per_cfg(col(0)).to(buf_dt),
        alpha=per_cfg(col(1)).to(buf_dt),
        ids=per_cfg(col(3)).to(torch.int32),
        mask=per_cfg(col(2)).to(buf_dt))


def _make_packed_sweep_body(cfg: MRSVMConfig, group, ndev: int, per: int,
                            per_config_data: bool):
    """The packed-wire sweep round: one transport for all S configs.

    The S configs' solve and top-k (:func:`_round_candidates`, one solve
    launch of S jobs) are followed by ONE pass of the shared hop engine
    (:func:`repro_torch.core.mapreduce_svm._merge_hops`) over the
    round's wire payload: while a stage's shift is in flight, the S
    hypotheses of each arrived message are scored (eq. 7, one
    ``hinge_scores`` call a stage on shared rows). The hop schedule is
    the transport's (ring: ndev one-message stages; hier: host-stages
    of ndev/hosts messages); the wire format is the same. ONE coalesced
    f32 message a hop: the wire-dtype rows (:func:`pack_wire_rows`),
    then the sidebands and hypotheses; per-leaf permutes would pay the
    collective's fixed cost per leaf a stage. The reference's sweep body
    adds no integrity lane, and neither does this. Each arrived block is
    written once: its row lanes into the new state's rows (config-major
    on per-stream rows), its sidebands into the rank-ordered matrix the
    state is assembled from after the last hop (the reference's one
    roll of the arrivals gives the same matrix, at two more copies).

    On shared rows the state IS the dedup format (:class:`DedupChunk`):
    unique rows are shipped AND stored once; the (S, cap, d) per-config
    buffer exists only as the solve's views (:func:`_state_views`).
    Per-stream rows keep per-config buffers and ship plain chunks with
    wire-dtype rows. The host groups of hier are made here, so every
    rank of ``group`` must build the round.
    """
    cap = cfg.sv_capacity
    k = cap // ndev
    wire_dt = _float_dtype(cfg.shuffle_wire_dtype)
    dedup = uses_dedup_state(cfg, per_config_data)
    hosts = resolve_topology(cfg, ndev)
    idx = compat.axis_index(group)
    plan = _hop_plan(cfg, group, ndev, idx, hosts)
    f32 = torch.float32

    def sweep_body(Xl, yl, ml, state, params: SolverParams):
        S = int(params.C.shape[0])
        buf_dt = Xl.dtype
        d = Xl.shape[-1]
        sv = _state_views(state, buf_dt) if dedup else state
        cand, w_b, b_b = _round_candidates(Xl, yl, ml, sv, cfg, group, idx,
                                           k, per, params)
        del sv                           # the views go before the merge
        nnzc = Xl.nnz_cap if sparse_rows.is_sparse(Xl) else None
        if dedup:
            U = dedup_unique_cap(cfg, S, k, per)
            chunk0 = dedup_candidates(cand, Xl, yl, idx, per, U, wire_dt)
            xf, wslots = pack_wire_rows(chunk0.x, wire_dt)
            n_rows = U
            side0 = torch.cat([
                xf, chunk0.y.to(f32), chunk0.ids.to(f32),
                chunk0.ptr.to(f32).reshape(-1),
                chunk0.alpha.to(f32).reshape(-1),
                chunk0.mask.to(f32).reshape(-1),
                w_b.to(f32).reshape(-1), b_b.to(f32)])
            o_w = U * wslots + 2 * U + 3 * S * k
            del chunk0
        else:
            U = k
            xf, wslots = pack_wire_rows(cand.x.reshape(S * k, d), wire_dt)
            n_rows = S * k
            side0 = torch.cat([
                xf, cand.y.to(f32).reshape(-1),
                cand.alpha.to(f32).reshape(-1),
                cand.mask.to(f32).reshape(-1),
                cand.ids.to(f32).reshape(-1),
                w_b.to(f32).reshape(-1), b_b.to(f32)])
            o_w = S * k * wslots + 4 * S * k
        del cand, xf
        o_x = n_rows * wslots

        def consume(blk):            # (m, L) arrived → (m, S) loss sums
            m = blk.shape[0]
            return _config_partials(
                Xl, yl, ml, blk[:, o_w:o_w + S * d].reshape(m, S, d),
                blk[:, o_w + S * d:], cfg.risk_loss, per_config_data)

        # each arrived block's row lanes go straight to their place in
        # the new state (config-major for plain chunks): the state's rows
        # are a view of this buffer, not a copy made after the last hop
        R = torch.empty((ndev, n_rows * wslots) if dedup
                        else (S, ndev, k * wslots), dtype=f32,
                        device=side0.device)

        def place(origin, lanes):
            if dedup:
                R[origin] = lanes
            else:
                R[:, origin] = lanes.reshape(-1, S, k * wslots) \
                    .transpose(0, 1)

        M, part = _merge_hops(side0, plan, consume, rows=(o_x, place))
        del side0
        xs = unpack_wire_rows(R.reshape(-1), ndev * n_rows, d, wire_dt,
                              wslots, nnz_cap=nnzc)
        del R
        if not dedup:
            xs = _rows_map(xs, lambda a: a.reshape(S, ndev * k, a.shape[-1]))
        acc = _assemble_chunks(xs, M, 0, dedup, ndev, U, k, S, buf_dt)
        o_h = o_w - o_x                  # M holds the lanes from o_x on
        W = M[:, o_h:o_h + S * d].reshape(ndev, S, d).transpose(0, 1)
        B = M[:, o_h + S * d:].T                          # (S, ndev)
        risks = _device_risks(part.T, ml.float().sum(-1),
                              torch.zeros((), device=M.device), cfg, group,
                              ndev)
        *_, w_sel, b_sel = best_reducers(RoundResult(acc, risks, W, B, None))
        return acc, risks, w_sel, b_sel

    return sweep_body


def _gather_configs(a, group, ndev: int, S: int, k: int):
    """A stacked (S, k, …) candidate leaf from every rank as (S, ndev·k,
    …) per-config columns: ONE all-gather (two for ``SparseRows``)."""
    if sparse_rows.is_sparse(a):
        return _rows_map(a, lambda t: _config_major(
            compat.all_gather(t, group), ndev, S, k))
    return _config_major(compat.all_gather(a, group), ndev, S, k)


def make_sharded_sweep_round(cfg: MRSVMConfig, group, num_devices: int,
                             rows_per_device: int,
                             per_config_data: bool = False):
    """The per-rank body of one sweep round: S local subproblems a round.

    ``body(Xl, yl, ml, state, params)`` runs on ONE rank's shard (Xl
    (per, d), or (S, per, d) with ``per_config_data``; dense or
    ``SparseRows``; yl, ml alike in Xl's dtype), ``state`` the round
    state of :func:`init_sharded_sweep_sv`, ``params`` (S,) tensors on
    the rank's device; → ``(state', risks (S, ndev), ws (S, d), bs
    (S,))``, the same on every rank.

    ``"allgather"`` gathers each leaf of the stacked (S, k, …) candidate
    chunk in ONE collective, exact dtype, and scores the S·ndev
    gathered hypotheses on the rank's rows; ``"ring"`` / ``"hier"`` run
    :func:`_make_packed_sweep_body`. The round state keeps
    :func:`init_sharded_sweep_sv`'s dtypes (α in the rows' dtype), so a
    saved state restores into that tree.
    """
    cap = cfg.sv_capacity
    if cap % num_devices != 0:
        raise ValueError("sv_capacity must divide the data-parallel size")
    if cfg.shuffle_impl in PACKED_SHUFFLES:
        return _make_packed_sweep_body(cfg, group, num_devices,
                                       rows_per_device, per_config_data)
    k = cap // num_devices
    per = rows_per_device
    resolve_topology(cfg, num_devices)
    idx = compat.axis_index(group)

    def sweep_body(Xl, yl, ml, sv: SVBuffer, params: SolverParams):
        cand, w, b = _round_candidates(Xl, yl, ml, sv, cfg, group, idx, k,
                                       per, params)
        S = w.shape[0]
        gather = lambda a: _gather_configs(  # noqa: E731
            a, group, num_devices, S, k)
        buf_dt = Xl.dtype
        new_sv = SVBuffer(x=gather(cand.x), y=gather(cand.y),
                          alpha=gather(cand.alpha).to(buf_dt),
                          ids=gather(cand.ids), mask=gather(cand.mask))
        W = compat.all_gather(w, group)                      # (ndev, S, d)
        B = compat.all_gather(b, group)                      # (ndev, S)
        part = _config_partials(Xl, yl, ml, W, B, cfg.risk_loss,
                                len(Xl.shape) == 3)          # (ndev, S)
        risks = _device_risks(part.T, ml.float().sum(-1),
                              torch.zeros((), device=w.device), cfg, group,
                              num_devices)
        *_, w_sel, b_sel = best_reducers(RoundResult(
            new_sv, risks, W.transpose(0, 1), B.T, None))
        return new_sv, risks, w_sel, b_sel

    return sweep_body


def expand_sweep_sv(state, buf_dtype=torch.float32) -> SVBuffer:
    """The per-config (S, cap, …) ``SVBuffer`` of a round state: the
    buffer itself (feature rows cast to ``buf_dtype``) for per-config
    states, one gather for the dedup state (its ``ptr`` is on the global
    slot axis). The sharded round loop calls it only when a config converges
    and on the last round."""
    if isinstance(state, DedupChunk):
        return expand_chunk(state, buf_dtype)
    if state.x.dtype != buf_dtype:
        return state._replace(x=state.x.to(dtype=buf_dtype))
    return state


def build_sharded_sweep_round(cfg: MRSVMConfig, rows_per_device: int,
                              group=None, device: DeviceLike = None,
                              per_config_data: bool = False):
    """One batched sweep round on this rank's shard of ``group`` (default
    the world group; one partition a rank, rank r holding global rows
    [r·per, (r+1)·per)). Call it on every rank of ``group``.

    → ``f(Xl, yl, ml, state, params) -> (state', risks (S, ndev), ws (S,
    d), bs (S,))``, every output the same on every rank; ``params`` has
    (S,) fields (numpy or tensors). With ``per_config_data`` the rows,
    labels and mask carry a leading (S,) axis (a streaming wave's
    streams). Inputs go to ``device`` (default ``cuda``; without a card
    it raises unless ``device="cpu"``); labels and mask are cast to the
    rows' dtype. On the packed transports with shared rows ``state`` is
    the shared-row :class:`DedupChunk`.

    The callable carries ``.init_sv(S, d, dtype)`` (the empty round-0
    state), ``.expand_sv`` (:func:`expand_sweep_sv` when the state is
    the dedup format, else None: the per-config buffer is the state) and
    ``.device``.
    """
    dev = resolve_device(device)
    ndev = compat.axis_size(group)
    body = make_sharded_sweep_round(cfg, group, ndev, rows_per_device,
                                    per_config_data=per_config_data)

    def f(Xl, yl, ml, state, params: SolverParams):
        Xl = as_tensor(Xl, dev)
        if Xl.shape[-2] != rows_per_device:
            raise ValueError(f"this rank holds {Xl.shape[-2]} rows, the "
                             f"round was built for {rows_per_device}")
        if (len(Xl.shape) == 3) != per_config_data:
            raise ValueError(
                f"rows of shape {tuple(Xl.shape)}: the round was built "
                f"with per_config_data={per_config_data}")
        return body(Xl, as_tensor(yl, dev, Xl.dtype),
                    as_tensor(ml, dev, Xl.dtype),
                    type(state)(*(as_tensor(f, dev) for f in state)),
                    _params_on(params, dev))

    f.init_sv = lambda S, d, dtype=torch.float32: init_sharded_sweep_sv(
        cfg, S, d, ndev, rows_per_device, dtype,
        per_config_data=per_config_data, device=dev)
    f.expand_sv = (expand_sweep_sv if uses_dedup_state(cfg, per_config_data)
                   else None)
    f.device = dev
    return f


class ShardedSweep(NamedTuple):
    """Host round-loop output of :func:`run_sharded_sweep`."""
    risks: torch.Tensor   # (S,) best R_emp per config
    ws: torch.Tensor      # (S, d)
    bs: torch.Tensor      # (S,)
    sv: SVBuffer          # (S, cap, …)
    rounds: np.ndarray    # (S,)
    history: Tuple[dict, ...]

    @property
    def best(self) -> int:
        return int(np.argmin(self.risks.cpu().numpy()))


def run_sharded_sweep(round_fn, X, y, mask, cfg: MRSVMConfig,
                      params: SolverParams, verbose: bool = False,
                      fail_on_retrace: bool = False) -> ShardedSweep:
    """Host round loop over :func:`build_sharded_sweep_round` on this
    rank's rows, with :func:`fit_mapreduce_sweep`'s per-config eq. 8
    masking. With ``per_config_data`` pass ``X (S, per, d)``, ``y (S,
    per)``, ``mask (S, per)``. Every rank reads the same risks, so every
    rank stops at the same round.

    On the dedup transports the shared-row state threads through the
    rounds unfrozen and the per-config buffer is made only when a config
    converges and on the last round (:func:`_run_rounds`); the result
    always carries the (S, cap, …) ``SVBuffer``, its rows in the rows'
    dtype. ``fail_on_retrace`` arms the retrace rule on every round
    past the first (:func:`_run_rounds`).
    """
    S = _num_configs(params)
    dev = round_fn.device
    params = _params_on(params, dev)
    X = as_tensor(X, dev)
    if sparse_rows.is_sparse(X):
        ops.check_column_ids(X)      # once, so that no round waits on it
    d = X.shape[-1]
    y = as_tensor(y, dev, X.dtype)
    mask = (torch.ones(X.shape[:-1], dtype=X.dtype, device=dev)
            if mask is None else as_tensor(mask, dev, X.dtype))

    def step(sv_b, eff):
        sv_new, risks, ws, bs = round_fn(X, y, mask, sv_b, eff)
        r_star, l_star = risks.min(1)        # each config's best reducer
        return sv_new, r_star, l_star, ws, bs

    # the per-config buffer of a dedup state in the rows' dtype (the
    # reference's in f32): its values are the same, and at svm-tfidf width
    # S = 4 configs' f32 buffer is 4.3 GB a rank, which 8 ranks sharing
    # one card cannot hold beside a round
    snapshot = (None if round_fn.expand_sv is None else
                lambda state: round_fn.expand_sv(state, X.dtype))
    # the round-0 state is handed over, not kept here: held for the whole
    # loop it would be one more state a rank (2.15 GB at svm-tfidf width)
    svb, best_risk, best_w, best_b, rounds, history = _run_rounds(
        step, round_fn.init_sv(S, d, X.dtype), d, cfg, params, verbose,
        "sharded-sweep", snapshot=snapshot,
        fail_on_retrace=fail_on_retrace)
    return ShardedSweep(risks=torch.as_tensor(best_risk, dtype=torch.float32),
                        ws=best_w, bs=best_b, sv=svb, rounds=rounds,
                        history=history)


# ---------------------------------------------------------------------------
# Round-state checkpoints: the sharded sweep's resume point.
# ---------------------------------------------------------------------------

def save_sweep_state(path: str, state, step: Optional[int] = None) -> None:
    """Durably write a sharded-sweep round state (the allgather or
    per-stream ``SVBuffer``, or the shared-row :class:`DedupChunk`) as
    the reference's flat npz (:mod:`repro_torch.ckpt`): the same leaf
    keys, so either package restores the other's file. With ``step``
    the directory's meta pointer advances atomically."""
    from repro_torch.ckpt import checkpoint as ckpt
    ckpt.save(path, state, step=step)


def restore_sweep_state(path: str, cfg: MRSVMConfig, num_configs: int,
                        d: int, num_devices: int, rows_per_device: int,
                        dtype=torch.float32, per_config_data: bool = False,
                        device: DeviceLike = None):
    """A round state saved by :func:`save_sweep_state`, on ``device``
    (default ``cuda``).

    The ``like`` tree is rebuilt by :func:`init_sharded_sweep_sv` (shapes
    only) from the same facts that shaped the original, so a different
    sweep width, capacity, transport layout or wire dtype raises
    ``ValueError`` ("shape mismatch" / "dtype mismatch") instead of
    resuming a wrong sweep."""
    from repro_torch.ckpt import checkpoint as ckpt
    dev = resolve_device(device)
    like = init_sharded_sweep_sv(cfg, num_configs, d, num_devices,
                                 rows_per_device, dtype,
                                 per_config_data=per_config_data,
                                 device="meta")
    return ckpt.restore(path, like, device=dev)
