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

The reference's sharded sweep (``build_sharded_sweep_round``,
``run_sharded_sweep``, ``DedupChunk``) waits for the sharded mode, and
its ``faults.check_finite_risks`` seam for the fault seams (ROADMAP
Queue 1, items 7 and 4a.3).
"""
from __future__ import annotations

import time
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import sparse as sparse_rows
from repro_torch.core.mapreduce_svm import (MRSVMConfig, SVBuffer,
                                            init_sv_buffer, sweep_round)
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


def _on_card(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A host mask on the card without a host sync (a copy of it is
    staged at the call)."""
    return torch.tensor(a).to(dev, non_blocking=True)


def masked_step(step, svb: SVBuffer, params: SolverParams,
                done: np.ndarray):
    """A round's device work with eq. 8's mask: configs ``done`` get
    tol = +inf and an epoch cutoff of 0 and keep their SV buffer. No
    host sync. → (svb, picks (2, S): each config's best reducer's risk
    and index, ws (S, d), bs (S,))."""
    dmask = _on_card(done, params.C.device)
    eff = params._replace(
        tol=torch.where(dmask, torch.inf, params.tol),
        max_epochs=torch.where(dmask, 0.0, params.max_epochs))
    sv_new, r_star, l_star, ws, bs = step(svb, eff)
    return (_freeze(dmask, svb, sv_new),
            torch.stack([r_star.float(), l_star.float()]), ws, bs)


def _run_rounds(step, svb: SVBuffer, d: int, cfg: MRSVMConfig,
                params: SolverParams, verbose: bool, tag: str):
    """The eq. 8-masked host round loop.

    ``step(svb, eff_params) -> (sv_new, r_star (S,), l_star (S,), ws (S,
    d), bs (S,))`` with r_star/ws/bs reduced to each config's best
    reducer l_star on the card. Finished configs get tol = +inf and an
    epoch cutoff of 0 and keep their SV buffer and best hypothesis. The
    host reads the (S,) risks and picks (eq. 8's sync point); the
    improved hypotheses are selected on the card, where they stay. Each
    history entry records the round's host-clock ``ms``, to that
    readback.
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
    for t in range(cfg.max_rounds):
        t0 = time.perf_counter()
        svb, picks, ws, bs = masked_step(step, svb, params, done)
        r_star, l_star = picks.cpu().numpy()     # eq. 8's sync point
        ms = 1e3 * (time.perf_counter() - t0)
        act = ~done
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
        done |= newly
        prev = np.where(act, r_star, prev)
        if done.all():
            break
    return svb, best_risk, best_w, best_b, rounds, tuple(history)


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
    output, picked on the card as the first minimum. → (r (S,), l (S,),
    w (S, d), b (S,))."""
    l_star = out.risks.argmin(1)
    configs = torch.arange(l_star.shape[0], device=l_star.device)
    return (out.risks[configs, l_star], l_star, out.ws[configs, l_star],
            out.bs[configs, l_star])


def fit_mapreduce_sweep(X, y, num_partitions: int, cfg: MRSVMConfig,
                        params: SolverParams, mask=None,
                        verbose: bool = False,
                        device: DeviceLike = None) -> SweepResult:
    """Run S MapReduce-SVM jobs in one batched computation.

    Every data input is either shared or carries a leading (S,) job
    axis: ``X`` is ``(n, d)`` (shared) or ``(S, n, d)`` (per-job rows),
    dense or ``SparseRows``; ``y`` is ``(n,)`` or ``(S, n)`` (per-job
    labels, as the one-vs-rest fold gives); ``mask`` is ``None``,
    ``(n,)`` or ``(S, n)``. ``params`` has (S,) fields (numpy or
    tensors). Each config's trajectory is that of a sequential
    ``fit_mapreduce`` with its params and data slice. Numpy inputs go
    to ``device`` (default ``cuda``).
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
        step, svb, d, cfg, params, verbose, "sweep")
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
