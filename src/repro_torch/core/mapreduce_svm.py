"""The paper's contribution: iterative MapReduce SVM with global
support-vector exchange (Çatak 2014, Tablo 1-2, eq. 6-9), functional
mode on one card.

Algorithm (one *round* = one MapReduce job):

  map    : D_l^t ← D_l ∪ SV_global^t          (augment partitions)
  reduce : (SV_l, h_l^t) ← binarySvm(D_l^t)   (local dual solve)
  merge  : SV_global^{t+1} ← ∪_l SV_l          (the "shuffle")
  driver : h^t = argmin_l R_emp(h_l^t);  stop when
           |R_emp(h^{t-1}) − R_emp(h^t)| ≤ γ  (eq. 8)

SV_global is a capacity-bounded, mask-padded buffer; each partition
contributes its top ``capacity // L`` rows by α (a balanced union), and
a row's evidence is the max of α over all its copies.

On the linear path a round is two kernel launches on the card:
``cd_solve`` solves all L partitions at once, reading each partition's
home rows and the shared SV buffer through two pointers (the L
augmented partitions are never copied), and ``hinge_scores`` scores the
L hypotheses on the full data (eq. 7); dense rows and blocked-CSR rows
each have their own route of both kernels. On the Gram path (rbf/poly or
``use_gram``, dense or blocked-CSR rows) the reducers' Gram matrices
come from one ``gram`` / ``sparse_gram`` launch over the L jobs, the
solve is one ``cd_solve_gram`` launch, and eq. 7 scores every
hypothesis through the same Gram kernel in chunks of query rows; on
blocked-CSR rows, through one fused ``sparse_gram_scores`` launch that
never forms K. The
incremental :func:`update_mapreduce` retrains on new rows ∪ the carried
SV_global. :func:`sweep_round` runs the round of S configs at once
(the sweep axis, :mod:`repro_torch.core.sweep`): one solve launch for
all S·L jobs; :func:`mapreduce_round` is its one-config case. The
sharded mode and the fault seams of the reference wait for later
slices (ROADMAP Queue 1).
"""
from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch import sparse as sparse_rows
from repro_torch.core import risk as risk_lib
from repro_torch.core.svm import (BinarySVM, SolverParams, SVMConfig,
                                  decision_kernel, decision_linear,
                                  solve_kernel_jobs, solve_linear_jobs)
from repro_torch.device import DeviceLike, as_tensor, resolve_device
from repro_torch.kernels import ops

# The merge transports and eq. 8 readback collectives of the sharded
# mode; the port validates against the same names as the reference.
SHUFFLE_IMPLS = ("allgather", "ring", "hier")
CONVERGE_IMPLS = ("psum", "tree")


class SVBuffer(NamedTuple):
    """Capacity-bounded global support-vector set SV_global^t."""
    x: object            # (cap, d) feature rows: tensor or SparseRows
    y: torch.Tensor      # (cap,)   labels in {-1, +1} (0 on padding)
    alpha: torch.Tensor  # (cap,)   dual coefficient evidence (max over copies)
    ids: torch.Tensor    # (cap,)   stable global row ids (int32, -1 padding)
    mask: torch.Tensor   # (cap,)   1.0 where the slot holds a real SV


class RoundResult(NamedTuple):
    """A round's output; :func:`sweep_round` adds a leading (S,) axis to
    every field."""
    sv: SVBuffer
    risks: torch.Tensor     # (L,) empirical risk of every reducer hypothesis
    ws: torch.Tensor        # (L, d) reducer primal hypotheses (Gram path:
    #                         zeros unless the kernel is linear)
    bs: torch.Tensor        # (L,)
    sv_count: torch.Tensor  # () live slots in the new buffer


def _float_dtype(name: str) -> torch.dtype:
    dt = getattr(torch, str(name), None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


@dataclasses.dataclass(frozen=True)
class MRSVMConfig:
    """Driver configuration for the iterative MapReduce SVM.

    The transport fields (``shuffle_impl`` … ``shuffle_wire_check``)
    configure the reference's sharded mode; they are validated here as
    there and are not read by the functional mode.
    """
    sv_capacity: int = 256
    svm: SVMConfig = SVMConfig()
    gamma: float = 1e-3          # eq. 8 convergence tolerance on R_emp
    max_rounds: int = 10
    risk_loss: str = "hinge"     # 'hinge' (used in eq. 6) or 'zero_one'
    shuffle_impl: str = "allgather"       # one of SHUFFLE_IMPLS
    shuffle_wire_dtype: str = "bfloat16"  # packed: feature-row wire dtype
    sweep_dedup: bool = True              # packed sweep: cross-config dedup
    dedup_max_unique: Optional[int] = None  # unique slots/chunk; None=lossless
    hier_num_hosts: Optional[int] = None  # hier: host groups; None=processes
    converge_impl: str = "psum"           # one of CONVERGE_IMPLS
    shuffle_wire_check: bool = False

    def __post_init__(self):
        if self.shuffle_impl not in SHUFFLE_IMPLS:
            raise ValueError(
                f"shuffle_impl must be one of {SHUFFLE_IMPLS}, "
                f"got {self.shuffle_impl!r}")
        if self.converge_impl not in CONVERGE_IMPLS:
            raise ValueError(
                f"converge_impl must be one of {CONVERGE_IMPLS}, "
                f"got {self.converge_impl!r}")
        if self.hier_num_hosts is not None and self.hier_num_hosts < 1:
            raise ValueError(
                f"hier_num_hosts must be >= 1, got {self.hier_num_hosts}")
        wdt = _float_dtype(self.shuffle_wire_dtype)
        if wdt.itemsize not in (2, 4) or not wdt.is_floating_point:
            raise ValueError(
                "shuffle_wire_dtype must be a 2- or 4-byte float "
                f"(bf16/f16/f32), got {self.shuffle_wire_dtype!r}")


def init_sv_buffer(capacity: int, d: int, dtype=torch.float32,
                   device: DeviceLike = None,
                   nnz_cap: Optional[int] = None) -> SVBuffer:
    """SV_global^0 = ∅ (empty, mask-padded buffer) on ``device``
    (default ``cuda``, as every entry point). With ``nnz_cap`` the
    feature rows are blocked-CSR ``SparseRows`` (index 0 / value 0
    padding ≡ the empty row; ids in range by construction)."""
    dev = resolve_device(device)
    zeros = lambda *s: torch.zeros(s, dtype=dtype, device=dev)  # noqa: E731
    x = zeros(capacity, d) if nnz_cap is None else sparse_rows.SparseRows(
        torch.zeros((capacity, nnz_cap), dtype=torch.int32, device=dev),
        zeros(capacity, nnz_cap), d, ids_in_range=True)
    return SVBuffer(x=x, y=zeros(capacity),
                    alpha=zeros(capacity),
                    ids=torch.full((capacity,), -1, dtype=torch.int32,
                                   device=dev),
                    mask=zeros(capacity))


def _risks(Xflat, yflat, mflat, ws, bs, loss: str) -> torch.Tensor:
    """Eq. 7 on the linear path: R_emp of every hypothesis on the full
    data, dense or ``SparseRows`` rows (``hinge_scores`` for the hinge,
    :func:`decision_linear` for the 0-1 loss)."""
    if loss == "hinge":
        losses, count = ops.hinge_scores(Xflat, ws, bs, yflat.float(),
                                         mflat.float())
        return losses / torch.clamp(count, min=1.0)
    scores = torch.stack([decision_linear(w, b, Xflat)
                          for w, b in zip(ws, bs)], 1)        # (n, L)
    return torch.stack([risk_lib.empirical_risk(scores[:, l], yflat, mflat,
                                                loss)
                        for l in range(scores.shape[1])])


def _kernel_risks(Xp, sv: SVBuffer, yp, maskp, res: BinarySVM, y_aug,
                  m_aug, cfg: MRSVMConfig, p: SolverParams) -> torch.Tensor:
    """Eq. 7 on the Gram path: hypothesis l scores the full data with
    ``K(Xflat, [X_l; SV_global]) @ (α·y·m)_l + b_l``. The union of the L
    augmented partitions is ``[Xflat; SV_global]``, so K against those
    rows, times a coefficient matrix that is zero off each job's own
    rows, scores all L hypotheses: through the fused
    ``sparse_gram_scores`` (one launch, no K) on blocked-CSR rows under
    ``gram_impl="pallas_sparse"``, else in chunks of query rows."""
    L, per, d = Xp.shape
    dt = res.alpha.dtype
    coef = res.alpha * y_aug.to(dt) * m_aug.to(dt)              # (L, n)
    Coef = torch.zeros((L * per + sv.y.shape[0], L), dtype=dt,
                       device=coef.device)
    jobs = torch.arange(L, device=coef.device)
    Coef[:L * per].view(L, per, L)[jobs, :, jobs] = coef[:, :per]
    Coef[L * per:] = coef[:, per:].T
    Xflat = Xp.reshape(L * per, d)
    scores = decision_kernel((Xp.reshape(1, L * per, d), sv.x), Coef,
                             res.b, Xflat, cfg.svm, p)           # (N, L)
    yflat, mflat = yp.reshape(L * per), maskp.reshape(L * per)
    return torch.stack([risk_lib.empirical_risk(scores[:, l], yflat, mflat,
                                                cfg.risk_loss)
                        for l in range(L)])


def config_params(p: SolverParams, s: int) -> SolverParams:
    """Config ``s``'s params of (S,)-batched ``p`` (numbers stay)."""
    return SolverParams(*(f[s] if isinstance(f, torch.Tensor) else f
                          for f in p))


def job_params(p: SolverParams, L: int) -> SolverParams:
    """(S,)-batched params as (S·L,) per job, config-major (job s·L + l
    is config s, partition l); numbers stay."""
    return SolverParams(*(f[:, None].expand(-1, L).reshape(-1)
                          if isinstance(f, torch.Tensor) else f for f in p))


def mapreduce_round(Xp, yp: torch.Tensor, maskp: torch.Tensor,
                    sv: SVBuffer, cfg: MRSVMConfig,
                    params: Optional[SolverParams] = None) -> RoundResult:
    """One full MapReduce round over stacked partitions: the one-config
    case of :func:`sweep_round`.

    Xp: (L, per, d) dense or ``SparseRows``; rows are ordered so global
    id of (l, i) = l*per + i.
    """
    out = sweep_round(Xp, yp, maskp, SVBuffer(*(f[None] for f in sv)), cfg,
                      params)
    return RoundResult(SVBuffer(*(f[0] for f in out.sv)),
                       *(f[0] for f in out[1:]))


def sweep_round(Xp, yp: torch.Tensor, maskp: torch.Tensor, sv: SVBuffer,
                cfg: MRSVMConfig,
                params: Optional[SolverParams] = None) -> RoundResult:
    """One MapReduce round of S configs at once.

    Xp (L, per, d) rows shared by the configs or (S, L, per, d) per
    config, dense or ``SparseRows``; yp and maskp (L, per) or (S, L,
    per); sv the configs' SV buffers, (S, cap, …); params numbers or
    (S,) tensors. Job s·L + l trains config s's reducer l on
    ``[X_l; SV_s]`` with config s's C, tol and epoch cutoff: one solve
    launch for all S·L jobs (and on the Gram path one Gram build). The
    fold, the top-k merge (with config s's ``sv_threshold``) and eq. 7
    run per config, eq. 7 on the linear path in one ``hinge_scores``
    call when the rows and labels are shared. → :class:`RoundResult`
    with a leading (S,) axis.
    """
    S, cap = sv.y.shape
    L, per, d = Xp.shape[-3:]
    per_config_x = len(Xp.shape) == 4
    p = cfg.svm.params() if params is None else params
    if cap % L != 0:
        raise ValueError(f"sv_capacity {cap} must divide by partitions {L}")
    k = cap // L
    yS, mS = yp.expand(S, L, per), maskp.expand(S, L, per)

    # --- map + reduce: all S·L jobs in one solve ----------------------------
    y_aug = torch.cat([yS, sv.y[:, None].expand(S, L, cap)], 2) \
        .reshape(S * L, per + cap)
    m_aug = torch.cat([mS, sv.mask[:, None].expand(S, L, cap)], 2) \
        .reshape(S * L, per + cap)
    xh = Xp.reshape(S * L, per, d) if per_config_x else Xp
    solve = solve_linear_jobs if cfg.svm.is_linear else solve_kernel_jobs
    res: BinarySVM = solve(xh, sv.x, y_aug, m_aug, cfg.svm, job_params(p, L))
    alpha = res.alpha.reshape(S, L, per + cap)
    home_alpha = alpha[:, :, :per].reshape(S, L * per)  # by global id
    copy_alpha = alpha[:, :, per:]                      # appended copies

    # --- union semantics: α_eff(row) = max over all copies ------------------
    buf_alpha = copy_alpha.max(1).values * sv.mask                # (S, cap)
    live_id = sv.ids >= 0
    safe_ids = torch.where(live_id, sv.ids, 0).long()
    folded = torch.zeros_like(home_alpha).scatter_reduce_(
        1, safe_ids, torch.where(live_id, buf_alpha, 0.0).to(home_alpha.dtype),
        "amax", include_self=True)
    home_alpha = torch.maximum(home_alpha, folded).reshape(S, L, per) * mS

    # --- merge: balanced top-k per partition, concatenated -------------------
    # A stable descending sort puts the lower index first on ties, as
    # lax.top_k does (torch.topk does not); bound SVs tie exactly at α = C.
    topv, topi = torch.sort(home_alpha, dim=2, descending=True, stable=True)
    topv, topi = topv[..., :k], topi[..., :k]                    # (S, L, k)
    dev = yp.device
    configs = torch.arange(S, device=dev)[:, None, None]
    parts = torch.arange(L, device=dev)[None, :, None]
    new_x = (Xp[configs, parts, topi] if per_config_x
             else Xp[parts, topi]).reshape(S, cap, d)
    new_y = yS[configs, parts, topi].reshape(S, cap)
    thr = p.sv_threshold
    if isinstance(thr, torch.Tensor):
        thr = thr.reshape(S, 1, 1)
    live = (topv > thr).to(Xp.dtype).reshape(S, cap)
    base_ids = (torch.arange(L, dtype=torch.int32, device=dev) * per
                )[None, :, None] + topi.to(torch.int32)
    new_sv = SVBuffer(
        x=new_x * live[..., None],
        y=new_y * live,
        alpha=topv.reshape(S, cap) * live,
        ids=torch.where(live > 0, base_ids.reshape(S, cap), -1)
        .to(torch.int32),
        mask=live,
    )

    # --- driver: risk of every reducer hypothesis on the FULL data (eq. 7) --
    ws = res.w.reshape(S, L, d)
    bs = res.b.reshape(S, L)
    if cfg.svm.is_linear:
        shared = not per_config_x and yp.dim() == 2 and maskp.dim() == 2
        if shared:
            risks = _risks(Xp.reshape(L * per, d), yp.reshape(L * per),
                           maskp.reshape(L * per), res.w, res.b,
                           cfg.risk_loss).reshape(S, L)
        else:
            risks = torch.stack([_risks(
                (Xp[s] if per_config_x else Xp).reshape(L * per, d),
                yS[s].reshape(L * per), mS[s].reshape(L * per), ws[s], bs[s],
                cfg.risk_loss) for s in range(S)])
    else:
        y_aug = y_aug.reshape(S, L, per + cap)
        m_aug = m_aug.reshape(S, L, per + cap)
        risks = torch.stack([_kernel_risks(
            Xp[s] if per_config_x else Xp, SVBuffer(*(f[s] for f in sv)),
            yS[s], mS[s], BinarySVM(*(f.reshape(S, L, *f.shape[1:])[s]
                                      for f in res)),
            y_aug[s], m_aug[s], cfg, config_params(p, s)) for s in range(S)])
    return RoundResult(sv=new_sv, risks=risks, ws=ws, bs=bs,
                       sv_count=new_sv.mask.sum(1))


class MapReduceSVM(NamedTuple):
    """Driver output: best reducer hypothesis (eq. 7) + final SV model."""
    w: torch.Tensor          # (d,) best linear hypothesis
    b: torch.Tensor
    sv: SVBuffer             # converged SV_global
    final: BinarySVM         # model retrained on SV_global alone
    risk: torch.Tensor       # R_emp(h^T) of the selected hypothesis
    rounds: int
    history: Tuple[dict, ...]


def fit_mapreduce(X, y, num_partitions: int, cfg: MRSVMConfig,
                  mask=None, params: Optional[SolverParams] = None,
                  verbose: bool = False,
                  device: DeviceLike = None) -> MapReduceSVM:
    """Iterative MapReduce SVM driver (functional mode).

    Pads ``X`` to a multiple of ``num_partitions`` and loops rounds on
    the host until eq. 8 fires or ``max_rounds`` is hit, then retrains
    on SV_global. Numpy inputs go to ``device`` (default ``cuda``).
    Each history entry also records the round's host-clock ``ms``
    (the round ends at the eq. 8 risk readback, which waits for the
    device).
    """
    dev = resolve_device(device, like=X)
    X = as_tensor(X, dev)
    if sparse_rows.is_sparse(X):
        ops.check_column_ids(X)      # once, so that no round waits on it
    n, d = X.shape
    L = num_partitions
    per = -(-n // L)
    pad = L * per - n
    Xp = sparse_rows.pad_rows(X, pad).reshape(L, per, d)
    yp = torch.nn.functional.pad(as_tensor(y, dev, X.dtype), (0, pad)
                                 ).reshape(L, per)
    base_mask = torch.ones((n,), dtype=X.dtype, device=dev) if mask is None \
        else as_tensor(mask, dev, X.dtype)
    maskp = torch.nn.functional.pad(base_mask, (0, pad)).reshape(L, per)

    sv = init_sv_buffer(
        cfg.sv_capacity, d, X.dtype, dev,
        nnz_cap=X.nnz_cap if sparse_rows.is_sparse(X) else None)
    best = (np.inf, None, None)
    prev_risk = np.inf
    history = []
    rounds_done = 0
    for t in range(cfg.max_rounds):
        t0 = time.perf_counter()
        out = mapreduce_round(Xp, yp, maskp, sv, cfg, params=params)
        sv = out.sv
        risks = out.risks.cpu().numpy()          # eq. 8's sync point
        ms = 1e3 * (time.perf_counter() - t0)
        l_star = int(np.argmin(risks))
        r_star = float(risks[l_star])
        if r_star < best[0]:
            best = (r_star, out.ws[l_star], out.bs[l_star])
        history.append({"round": t, "risk": r_star, "reducer": l_star,
                        "sv_count": int(out.sv_count), "ms": ms})
        rounds_done = t + 1
        if verbose:
            print(f"[mapreduce-svm] round={t} R_emp={r_star:.5f} "
                  f"|SV|={int(out.sv_count)} ms={ms:.1f}")
        if t > 0 and abs(prev_risk - r_star) <= cfg.gamma:   # eq. 8
            break
        prev_risk = r_star

    # Final consolidated model: retrain on SV_global alone (cascade-style).
    solve = solve_linear_jobs if cfg.svm.is_linear else solve_kernel_jobs
    res = solve(sv.x[None], sv.x[:0], sv.y[None], sv.mask[None], cfg.svm,
                params)
    final = BinarySVM(*(f[0] for f in res))
    return MapReduceSVM(w=best[1], b=best[2], sv=sv, final=final,
                        risk=torch.tensor(best[0], dtype=torch.float32),
                        rounds=rounds_done, history=tuple(history))


def predict(model: MapReduceSVM, X, cfg: MRSVMConfig, use_final: bool = True,
            params: Optional[SolverParams] = None,
            device: DeviceLike = None) -> torch.Tensor:
    """±1 predictions from the converged model (float32). The Gram
    path always scores with the final model, as the reference does;
    pass the ``params`` the model was trained with, if any."""
    dev = resolve_device(device, like=X)
    X = as_tensor(X, dev)
    if not cfg.svm.is_linear:
        s = decision_values(model, X, cfg, params=params)
    else:
        w, b = (model.final.w, model.final.b) if use_final \
            else (model.w, model.b)
        s = decision_linear(w.to(dev), b.to(dev), X)
    return torch.where(s >= 0, 1.0, -1.0)


def decision_values(model: MapReduceSVM, X, cfg: MRSVMConfig,
                    params: Optional[SolverParams] = None,
                    device: DeviceLike = None) -> torch.Tensor:
    """Decision scores of the final model: ``X w + b`` on the linear
    path, ``K(X, SV_global) @ (α·y·m) + b`` on the Gram path."""
    dev = resolve_device(device, like=X)
    X = as_tensor(X, dev)
    final = model.final
    if cfg.svm.is_linear:
        return decision_linear(final.w.to(dev), final.b.to(dev), X)
    sv = model.sv
    coef = final.alpha.to(dev) * sv.y.to(dev) * sv.mask.to(dev)
    return decision_kernel(as_tensor(sv.x, dev), coef, final.b.to(dev), X,
                           cfg.svm, params)


def update_mapreduce(model: MapReduceSVM, X_new, y_new, num_partitions: int,
                     cfg: MRSVMConfig,
                     params: Optional[SolverParams] = None,
                     verbose: bool = False,
                     device: DeviceLike = None) -> MapReduceSVM:
    """Incremental model update (the paper's stated future work): a new
    :func:`fit_mapreduce` on the new rows ∪ the model's SV_global, mask
    1 on the new rows and ``sv.mask`` on the carried ones. The converged
    SV set is the model's sufficient statistic, so old non-support rows
    never travel. Dense or ``SparseRows`` rows, of the model's format.

    Pass the ``params`` the model was trained with, if any: the carried
    α were solved at that scale. Numpy inputs go to ``device`` (default
    ``cuda``).
    """
    dev = resolve_device(device, like=X_new)
    X_new = as_tensor(X_new, dev)
    d_model = model.sv.x.shape[1]
    if X_new.shape[1] != d_model:
        raise ValueError(
            f"update batch has {X_new.shape[1]} features but the model's "
            f"SV buffer holds {d_model}-dim rows — vectorize new messages "
            "with the SAME featurizer (hash space / idf) as training")
    sv = model.sv
    X = sparse_rows.rows_concat(X_new, as_tensor(sv.x, dev), axis=0)
    n_new = X_new.shape[0]
    y = torch.cat([as_tensor(y_new, dev, X_new.dtype),
                   as_tensor(sv.y, dev, X_new.dtype)])
    mask = torch.cat([torch.ones((n_new,), dtype=X_new.dtype, device=dev),
                      as_tensor(sv.mask, dev, X_new.dtype)])
    return fit_mapreduce(X, y, num_partitions, cfg, mask=mask,
                         params=params, verbose=verbose, device=dev)
