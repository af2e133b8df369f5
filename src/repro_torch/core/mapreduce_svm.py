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
driver carries the reference's fault seams (:mod:`repro_torch.faults`):
a delayed round, a transiently failing merge retried with backoff, and
a non-finite risk at the eq. 8 readback raised as
``FaultDetected("core")``.

The sharded mode (:func:`build_sharded_round`) runs the round with one
partition a rank of a ``torch.distributed`` group: each rank solves its
reducer (one job of the same kernels), the SV merge runs over the
transport ``cfg.shuffle_impl`` names (``allgather``; ``ring`` and
``hier`` over the packed wire of :func:`pack_wire_rows`, with the
integrity lane under ``shuffle_wire_check``), and each rank scores eq. 7
on its own rows before the convergence collective (``psum`` or
``tree``) sums the partial risks. The sharded sweep
(:func:`repro_torch.core.sweep.build_sharded_sweep_round`) runs the
same rank-side pieces for S configs at once.
"""
from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch import compat
from repro_torch import faults
from repro_torch import sparse as sparse_rows
from repro_torch.analysis.hostsync import allowed_host_sync
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

# The transports whose wire is the coalesced packed f32 message; they
# share the hop engine (:func:`_merge_hops`).
PACKED_SHUFFLES = ("ring", "hier")


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
    configure the sharded mode (:func:`build_sharded_round`); the
    functional mode does not read them. ``sweep_dedup`` and
    ``dedup_max_unique`` shape the packed transports' round state in the
    sharded sweep (:mod:`repro_torch.core.sweep`).
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


def drive_rounds(step, cfg: MRSVMConfig, *, label: str,
                 verbose: bool = False):
    """The host driver of the rounds: rounds until eq. 8
    (|R_emp(h^{t-1}) − R_emp(h^t)| ≤ γ) fires or ``cfg.max_rounds``,
    keeping the best hypothesis of eq. 7. Shared by
    :func:`fit_mapreduce` and the sharded driver
    (:func:`repro_torch.launch.sharded.fit_sharded`), whose risks are
    the same on every rank, so every rank stops at the same round.

    ``step(t)`` runs round t and returns ``(risks, hypothesis,
    sv_count)``: the (L,) risks on the device, ``hypothesis(l) -> (w,
    b)`` of reducer l, and |SV_global|. Around it sit the transport
    seams: a delayed round completes late but exactly; a merge that
    fails transiently is retried with backoff. The injected fault
    raises before the round launches anything or joins a collective, so
    a retried round launches what a clean one does; real errors surface
    at once. A non-finite risk at the readback raises
    ``FaultDetected``. Each history entry records the round's host-clock
    ``ms`` (the round ends at the readback, which waits for the device).
    → ``((risk, w, b) of the best hypothesis, history)``.
    """
    best = (np.inf, None, None)
    prev_risk = np.inf
    history = []
    for t in range(cfg.max_rounds):
        t0 = time.perf_counter()
        faults.maybe_sleep("transport.round", when=t)

        def run_round():
            faults.maybe_raise("transport.merge", kinds=("transport_exc",),
                               when=t)
            return step(t)

        risks, hypothesis, sv_count = faults.retry_with_backoff(
            run_round, attempts=3, base_s=0.05,
            retry_on=faults.TransientFault, layer="transport",
            cause=f"merge collective at round {t}",
            action="check inter-host links; a persistent failure means "
                   "the mesh lost a member — restart from the last "
                   "checkpoint")
        # eq. 8's designed device→host sync point, sanctioned for the
        # host-sync rule by name where it happens
        with allowed_host_sync("eq. 8 risk readback"):
            risks = risks.cpu().numpy()
            sv_count = int(sv_count)
        ms = 1e3 * (time.perf_counter() - t0)
        faults.check_finite_risks(risks, where=f"{label} round {t}")
        l_star = int(np.argmin(risks))
        r_star = float(risks[l_star])
        if r_star < best[0]:
            best = (r_star, *hypothesis(l_star))
        history.append({"round": t, "risk": r_star, "reducer": l_star,
                        "sv_count": int(sv_count), "ms": ms})
        if verbose:
            print(f"[{label}-svm] round={t} R_emp={r_star:.5f} "
                  f"|SV|={int(sv_count)} ms={ms:.1f}")
        if t > 0 and abs(prev_risk - r_star) <= cfg.gamma:   # eq. 8
            break
        prev_risk = r_star
    return best, history


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

    def step(t):
        nonlocal sv
        out = mapreduce_round(Xp, yp, maskp, sv, cfg, params=params)
        sv = out.sv
        return out.risks, lambda l: (out.ws[l], out.bs[l]), out.sv_count

    best, history = drive_rounds(step, cfg, label="mapreduce",
                                 verbose=verbose)

    # Final consolidated model: retrain on SV_global alone (cascade-style).
    solve = solve_linear_jobs if cfg.svm.is_linear else solve_kernel_jobs
    res = solve(sv.x[None], sv.x[:0], sv.y[None], sv.mask[None], cfg.svm,
                params)
    final = BinarySVM(*(f[0] for f in res))
    return MapReduceSVM(w=best[1], b=best[2], sv=sv, final=final,
                        risk=torch.tensor(best[0], dtype=torch.float32),
                        rounds=len(history), history=tuple(history))


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


# ---------------------------------------------------------------------------
# Sharded mode: one partition a rank of a torch.distributed group.
# ---------------------------------------------------------------------------

def _round_candidates(Xl, yl, ml, sv: SVBuffer, cfg: MRSVMConfig, group,
                      idx: int, k: int, per: int,
                      params: Optional[SolverParams]):
    """map + reduce + union-fold + balanced top-k of ONE rank, for S
    configs at once (S = 1 in the round of one config).

    ``sv`` holds the S configs' SV buffers, (S, cap, …); ``Xl`` is the
    rank's rows, (per, d) shared by the configs or (S, per, d) per
    config (``yl``, ``ml`` (per,) or (S, per) alike); ``params`` None,
    numbers or (S,) tensors. The S reducers are ONE solve of S jobs
    (:func:`solve_linear_jobs` / :func:`solve_kernel_jobs`): job s reads
    the home rows and config s's SV block through the two pointers (the
    augmented rows are never copied), with config s's C, tol and epoch
    cutoff. SV rows that arrived in another dtype than the home rows
    (the wire dtype) are cast to it: they are copies of rows of that
    dtype, so the cast is exact. The union fold's max over the ranks is
    one collective for all S configs. → ``(cand, w, b)``: the (S, k)
    candidate chunks and the S reducer hypotheses (S, d), (S,).
    """
    p = cfg.svm.params() if params is None else params
    S = sv.y.shape[0]
    per_config_x = len(Xl.shape) == 3
    xs = sv.x if sv.x.dtype == Xl.dtype else sv.x.to(dtype=Xl.dtype)
    yS, mS = yl.expand(S, per), ml.expand(S, per)
    y_aug = torch.cat([yS, sv.y.to(yl.dtype)], 1)
    m_aug = torch.cat([mS, sv.mask.to(ml.dtype)], 1)
    solve = solve_linear_jobs if cfg.svm.is_linear else solve_kernel_jobs
    res = solve(Xl if per_config_x else Xl[None], xs, y_aug, m_aug, cfg.svm,
                params)
    home_alpha = res.alpha[:, :per]
    copy_alpha = res.alpha[:, per:] * sv.mask.to(res.alpha.dtype)

    # union semantics: fold the max appended-copy α back into the home
    # rows (buffer row with global id g lives on rank g // per)
    buf_alpha = compat.pmax(copy_alpha, group)                 # (S, cap)
    mine = (sv.ids >= 0) & (torch.div(sv.ids, per, rounding_mode="floor")
                            == idx)
    pos = torch.where(mine, sv.ids % per, 0).long()
    folded = torch.zeros_like(home_alpha).scatter_reduce_(
        1, pos, torch.where(mine, buf_alpha, 0.0).to(home_alpha.dtype),
        "amax", include_self=True)
    home_alpha = torch.maximum(home_alpha, folded) * mS.to(home_alpha.dtype)

    # balanced top-k: a stable descending sort keeps lax.top_k's order
    # on ties (the lower index first)
    topv, topi = torch.sort(home_alpha, dim=1, descending=True, stable=True)
    topv, topi = topv[:, :k], topi[:, :k]
    thr = p.sv_threshold
    if isinstance(thr, torch.Tensor) and thr.dim():
        thr = thr.reshape(S, 1)
    live = (topv > thr).to(Xl.dtype)
    cand_ids = (idx * per + topi).to(torch.int32)
    rows = (sparse_rows.take_rows_along(Xl, topi) if per_config_x
            else Xl[topi])
    cand = SVBuffer(x=rows * live[..., None], y=yS.gather(1, topi) * live,
                    alpha=topv * live,
                    ids=torch.where(live > 0, cand_ids, -1).to(torch.int32),
                    mask=live)
    return cand, res.w, res.b


def _partials(Xl, yl, ml, W, B, loss: str) -> torch.Tensor:
    """This rank's eq. 7 loss sums of hypotheses W (m, d), B (m,) over
    its own rows: ``hinge_scores`` for the hinge (as :func:`_risks`),
    :func:`decision_linear` for the 0-1 loss. → (m,) float32."""
    if loss == "hinge":
        return ops.hinge_scores(Xl, W.float().contiguous(),
                                B.float().contiguous(), yl.float(),
                                ml.float())[0]
    scores = torch.stack([decision_linear(w, b, Xl) for w, b in zip(W, B)],
                         1)                                      # (per, m)
    per_ex = risk_lib.zero_one_loss(scores, yl[:, None]).to(scores.dtype)
    return (per_ex * ml[:, None].to(scores.dtype)).sum(0).float()


def _device_risks(part: torch.Tensor, cnt: torch.Tensor, bad: torch.Tensor,
                  cfg: MRSVMConfig, group, ndev: int) -> torch.Tensor:
    """eq. 7 empirical risks from this rank's (…, ndev) loss sums and row
    counts (…) or (): the global (Σ loss)/(Σ count), the eq. 8 readback
    collective. The sums, the counts and ``bad`` ride ONE vector, so a
    sweep's S configs are one collective: ``"psum"`` is one all-reduce
    of it; ``"tree"`` is log2(ndev) recursive-doubling stages of
    XOR-partner :func:`compat.ppermute`. NaN passes on through either.

    ``bad`` is this rank's count of failed wire checks (0 without the
    integrity lane); it rides the same message, so a message garbled on
    its way to any rank makes every rank's risks +inf (the checksum's
    sentinel: the driver's readback raises ``FaultDetected
    ("transport")`` everywhere), though the rank it came from kept a
    clean copy."""
    n_part, n_cnt = part.numel(), cnt.numel()
    vec = torch.cat([part.float().reshape(-1), cnt.float().reshape(-1),
                     bad.reshape(1).float()])
    if cfg.converge_impl == "tree":
        s = 1
        while s < ndev:                  # power of two: build-time checked
            vec = vec + compat.ppermute(
                vec, [(i, i ^ s) for i in range(ndev)], group)
            s <<= 1
    else:
        vec = compat.psum(vec, group)
    sums = vec[:n_part].reshape(part.shape)
    cnts = vec[n_part:n_part + n_cnt].reshape(cnt.shape)
    risks = sums / torch.clamp(cnts, min=1.0)[..., None]
    return torch.where(vec[-1] > 0, torch.full_like(risks, float("inf")),
                       risks)


# the reference's names; the lanes live beside the blocked-CSR wire
_pack_lanes = sparse_rows.pack_lanes
_unpack_lanes = sparse_rows.unpack_lanes


def pack_wire_rows(x, wire_dt):
    """Flatten feature rows into f32 lanes for the coalesced packed
    message. → ``(flat, wslots)`` with ``wslots`` f32 lanes a row.

    Dense rows ship all ``d`` features in the wire dtype, 2-byte values
    in pairs a lane (:func:`_pack_lanes`). Blocked-CSR rows
    (``SparseRows``) ship only their ``nnz_cap`` (index, value) pairs a
    row (:func:`repro_torch.sparse.pack_wire`), so the payload scales
    with ``nnz_cap``, not ``d``. The lanes equal the reference's
    ``pack_wire_rows`` bit for bit."""
    wire_dt = _float_dtype(wire_dt) if isinstance(wire_dt, str) else wire_dt
    if sparse_rows.is_sparse(x):
        lanes, wslots = sparse_rows.pack_wire(x, wire_dt)
        return lanes.reshape(-1), wslots
    n = x.shape[0]
    lanes, slots = _pack_lanes(x.to(wire_dt), wire_dt)
    return lanes.reshape(n * slots), slots


def unpack_wire_rows(flat: torch.Tensor, n: int, d: int, wire_dt,
                     wslots: int, nnz_cap: Optional[int] = None):
    """Inverse of :func:`pack_wire_rows`: f32 lanes → (n, d) wire-dtype
    rows, or with ``nnz_cap`` the ``SparseRows`` the sparse pack shipped
    (whose ids the next kernel checks: they carry no mark)."""
    wire_dt = _float_dtype(wire_dt) if isinstance(wire_dt, str) else wire_dt
    arr = flat.reshape(n, wslots)
    if nnz_cap is not None:
        return sparse_rows.unpack_wire(arr, d, nnz_cap, wire_dt)
    return _unpack_lanes(arr, d, wire_dt)


def _wire_sum(lanes: torch.Tensor) -> torch.Tensor:
    """The int32 wrap-sum of f32 lanes' bits along the last axis (the
    integrity lane). The sum runs in int64, then wraps to int32, as
    the reference's int32 sum does."""
    s = lanes.contiguous().view(torch.int32).sum(-1, dtype=torch.int64)
    return (torch.remainder(s + 2 ** 31, 2 ** 32) - 2 ** 31).to(torch.int32)


class _HopPlan(NamedTuple):
    """Transport parameterization of the hop engine (:func:`_merge_hops`):
    ``num_stages`` hops of the ``shift`` permutation (started, waited
    later), each expanded by the ``expand`` group collective into ``m``
    arrived messages; ``gi`` is this rank's origin-group index."""
    num_stages: int   # hops of the merge (ring: ndev, hier: num_hosts)
    m: int            # messages consumed a stage (ring: 1, hier: ndev/H)
    gi: int           # this rank's origin-group index
    shift: object     # (L,) msg → compat.Pending of the next group's msg
    expand: object    # (L,) msg → (m, L) arrived block


def resolve_topology(cfg: MRSVMConfig, num_devices: int) -> int:
    """Build-time topology facts: the hier host-group count, with the
    checks the collectives need.

    ``cfg.hier_num_hosts`` pins the host count; ``None`` reads the
    launched processes (:func:`compat.process_count`, 1 under
    ``compat.spawn`` alone), as the reference does: the ranks of a
    cluster launch are process-major (global rank = process · k +
    local), so a host is a process's k ranks. One host is a single
    grouped all-gather; hosts == ranks is the flat ring. Tree needs a
    power-of-two rank count.
    """
    if cfg.converge_impl == "tree" and (num_devices & (num_devices - 1)):
        raise ValueError(
            "converge_impl='tree' (recursive doubling) needs a "
            f"power-of-two device count, got {num_devices}")
    if cfg.shuffle_impl != "hier":
        return 1
    hosts = cfg.hier_num_hosts or compat.process_count()
    if num_devices % hosts:
        raise ValueError(
            f"hier shuffle needs the device count ({num_devices}) "
            f"divisible by the host count ({hosts}); pin "
            "MRSVMConfig.hier_num_hosts for simulated topologies")
    return hosts


def _hop_plan(cfg: MRSVMConfig, group, ndev: int, idx: int,
              hosts: int) -> _HopPlan:
    """The (group collective, hop permutation, messages a hop) of each
    packed transport.

    * ``ring``: ndev stages of the ring shift, one message a stage, no
      group collective.
    * ``hier``: ``hosts`` host-stages. Rank (h, l) = h·Dl + l forwards
      its message to rank (h+1, l), so each stage every pair crosses a
      host boundary and only the bytes the next host has not seen move
      between hosts; the grouped all-gather within a host then gives the
      arrived host's Dl messages. The shift forwards the gather's input,
      so stage t+1's transfer overlaps stage t's gather and scoring.
      The host groups are made here, once, on every rank.
    """
    if cfg.shuffle_impl == "ring":
        perm = compat.ring_perm(ndev)
        return _HopPlan(num_stages=ndev, m=1, gi=idx,
                        shift=lambda c: compat.ppermute_start(c, perm,
                                                              group),
                        expand=lambda c: c[None, :])
    Dl = ndev // hosts
    groups = compat.new_groups(
        [[h * Dl + l for l in range(Dl)] for h in range(hosts)], group)
    perm = [(h * Dl + l, ((h + 1) % hosts) * Dl + l)
            for h in range(hosts) for l in range(Dl)]
    return _HopPlan(num_stages=hosts, m=Dl, gi=idx // Dl,
                    shift=lambda c: compat.ppermute_start(c, perm, group),
                    expand=lambda c: compat.all_gather_groups(c, groups))


def _merge_hops(side: torch.Tensor, plan: _HopPlan, consume, rows=None):
    """The hop engine of the packed transports: ``plan.num_stages``
    stages, each starting the NEXT stage's shift before it expands the
    current message into the (m, L) block that arrived this stage and
    hands it to ``consume`` (the eq. 7 work), so the transfer runs
    behind the scoring. The message received at hop t passes the
    ``faults.garble_wire`` seam.

    Stage t carries origin group ``(gi - t) mod num_stages``, so each
    arrived block is written once into its origin ranks' rows of the
    rank-ordered message matrix, allocated before the first hop: the
    reference's reversed-arrival concat and one roll give the same
    matrix, at two more copies of it. With ``rows = (lanes, place)``
    the first ``lanes`` lanes of each arrived block go to
    ``place(origin_rows, block_lanes)`` instead, which writes them
    where its caller keeps them (the sweep's feature rows: no copy of
    them is made after the last hop), and the matrix holds the rest.
    → ``(M, ordered)``: the (ndev, L) message matrix (or its lanes from
    ``lanes`` on) in rank order and the ``consume`` outputs in rank
    order along their leading (m,) axis.
    """
    L = side.shape[0]
    ns, m = plan.num_stages, plan.m
    skip, place = rows if rows is not None else (0, None)
    M = torch.empty((ns * m, L - skip), dtype=side.dtype, device=side.device)
    ordered = None
    cur = side
    for t in range(ns):
        pending = plan.shift(cur) if t < ns - 1 else None
        blk = plan.expand(cur)                 # (m, L) arrived messages
        origin = slice(((plan.gi - t) % ns) * m,
                       ((plan.gi - t) % ns + 1) * m)
        if place is not None:
            place(origin, blk[:, :skip])
        M[origin] = blk[:, skip:]
        part = consume(blk)
        if ordered is None:
            ordered = part.new_empty((ns * m,) + tuple(part.shape[1:]))
        ordered[origin] = part
        del blk
        cur = (faults.garble_wire(pending.wait(), hop=t)
               if pending is not None else None)
    return M, ordered


def _packed_merge(cand: SVBuffer, w, b, Xl, yl, ml, cfg: MRSVMConfig,
                  ndev: int, k: int, plan: _HopPlan):
    """Packed-wire merge and eq. 7 scoring, the ring and hier transports
    over the shared hop engine.

    One coalesced f32 message a hop: the wire-dtype feature rows
    (:func:`pack_wire_rows`) then the sideband ``[y | α | mask | ids | w
    | b]`` in f32 (ids are exact in f32 below 2^24 rows). Every rank
    applies the same wire round trip to every chunk, its own included,
    so the assembled buffer is the same on every rank. Its feature rows
    stay in the wire dtype; y and the mask come back in the rows' dtype,
    α and the hypotheses in f32.

    With ``cfg.shuffle_wire_check`` the message carries one more lane,
    the int32 wrap-sum of its bits (:func:`_wire_sum`); every arrived
    message is summed again after assembly, and a mismatch on this rank
    makes ``wire_ok`` False (which :func:`_device_risks` shares with
    every rank). → ``(sv, W, B, part, wire_ok)``.
    """
    d = Xl.shape[-1]
    wire_dt = _float_dtype(cfg.shuffle_wire_dtype)
    f32 = torch.float32
    nnzc = cand.x.nnz_cap if sparse_rows.is_sparse(cand.x) else None
    xf, wslots = pack_wire_rows(cand.x, wire_dt)
    side = torch.cat([xf, cand.y.to(f32), cand.alpha.to(f32),
                      cand.mask.to(f32), cand.ids.to(f32), w.to(f32),
                      b.reshape(1).to(f32)])
    o_x = k * wslots
    o_w = o_x + 4 * k
    if cfg.shuffle_wire_check:
        side = torch.cat([side, _wire_sum(side).reshape(1).view(f32)])
    L = side.shape[0]

    def consume(blk):                    # (m, L) arrived → (m,) loss sums
        return _partials(Xl, yl, ml, blk[:, o_w:o_w + d],
                         blk[:, o_w + d], cfg.risk_loss)

    M, part = _merge_hops(side, plan, consume)

    def col(a, b2):                      # sideband lanes [a·k, b2·k)
        return M[:, o_x + a * k:o_x + b2 * k].reshape(ndev * k)

    dt = Xl.dtype
    sv = SVBuffer(
        x=unpack_wire_rows(M[:, :o_x].reshape(-1), ndev * k, d, wire_dt,
                           wslots, nnz_cap=nnzc),
        y=col(0, 1).to(dt), alpha=col(1, 2).to(cand.alpha.dtype),
        ids=col(3, 4).to(torch.int32), mask=col(2, 3).to(dt))
    wire_ok = None
    if cfg.shuffle_wire_check:
        got = M[:, L - 1].contiguous().view(torch.int32)
        wire_ok = torch.all(got == _wire_sum(M[:, :L - 1]))
    return sv, M[:, o_w:o_w + d], M[:, o_w + d], part, wire_ok


def _gather_leaf(a, group):
    """A candidate leaf from every rank, concatenated in rank order, in
    its exact dtype (``SparseRows`` leaf by leaf)."""
    if sparse_rows.is_sparse(a):
        return sparse_rows.SparseRows(
            compat.all_gather(a.indices, group, tiled=True),
            compat.all_gather(a.values, group, tiled=True), a.d)
    return compat.all_gather(a, group, tiled=True)


def make_sharded_round(cfg: MRSVMConfig, group, num_devices: int,
                       rows_per_device: int):
    """The per-rank body of one MapReduce round.

    The returned function runs on ONE rank's shard: Xl (per, d) dense
    or ``SparseRows``, yl, ml (per,) in Xl's dtype, sv (replicated
    SVBuffer), optional ``params``; and returns (new_sv, risks (ndev,),
    best_w (d,), best_b ()), the same on every rank.

    ``cfg.shuffle_impl`` picks the merge:

    * ``"allgather"``: each candidate leaf all-gathered in its exact
      dtype, then eq. 7 over the all-gathered hypotheses (one
      ``hinge_scores`` call);
    * ``"ring"`` / ``"hier"``: :func:`_packed_merge` over the hop plan of
      :func:`_hop_plan`, scoring each stage's hypotheses as they arrive.

    With ``shuffle_wire_dtype`` equal to the rows' dtype the packed
    transports give allgather's SV buffer and hypothesis bit for bit.
    The host groups of hier are made here, so every rank of ``group``
    must build the round.
    """
    cap = cfg.sv_capacity
    if cap % num_devices != 0:
        raise ValueError("sv_capacity must divide the data-parallel size")
    k = cap // num_devices
    per = rows_per_device
    hosts = resolve_topology(cfg, num_devices)
    idx = compat.axis_index(group)
    packed = cfg.shuffle_impl in PACKED_SHUFFLES
    plan = _hop_plan(cfg, group, num_devices, idx, hosts) if packed else None

    def round_body(Xl, yl, ml, sv: SVBuffer,
                   params: Optional[SolverParams] = None):
        cand, w, b = _round_candidates(Xl, yl, ml,
                                       SVBuffer(*(f[None] for f in sv)),
                                       cfg, group, idx, k, per, params)
        cand, w, b = SVBuffer(*(f[0] for f in cand)), w[0], b[0]
        cnt = ml.float().sum()
        if packed:
            new_sv, W, B, part, wire_ok = _packed_merge(
                cand, w, b, Xl, yl, ml, cfg, num_devices, k, plan)
        else:
            new_sv = SVBuffer(*(_gather_leaf(f, group) for f in cand))
            W = compat.all_gather(w, group)                  # (ndev, d)
            B = compat.all_gather(b.reshape(1), group, tiled=True)
            part = _partials(Xl, yl, ml, W, B, cfg.risk_loss)
            wire_ok = None
        bad = (torch.zeros((), device=cnt.device) if wire_ok is None
               else (~wire_ok).float())
        risks = _device_risks(part, cnt, bad, cfg, group, num_devices)
        l_star = torch.argmin(risks).reshape(1)
        return (new_sv, risks, W.index_select(0, l_star)[0],
                B.index_select(0, l_star)[0])

    return round_body


def build_sharded_round(cfg: MRSVMConfig, rows_per_device: int, group=None,
                        device: DeviceLike = None):
    """One MapReduce round on this rank's shard of ``group`` (default the
    world group; one partition a rank, rank r holding global rows
    [r·per, (r+1)·per)). Call it on every rank of ``group``.

    → ``f(Xl, yl, ml, sv) -> (sv', risks, w_best, b_best)``, every output
    the same on every rank. Inputs go to ``device`` (default ``cuda``;
    without a card it raises unless ``device="cpu"``); labels and mask
    are cast to the rows' dtype, as :func:`fit_mapreduce` does.
    """
    dev = resolve_device(device)
    ndev = compat.axis_size(group)
    body = make_sharded_round(cfg, group, ndev, rows_per_device)

    def f(Xl, yl, ml, sv: SVBuffer, params: Optional[SolverParams] = None):
        Xl = as_tensor(Xl, dev)
        if Xl.shape[0] != rows_per_device:
            raise ValueError(f"this rank holds {Xl.shape[0]} rows, the "
                             f"round was built for {rows_per_device}")
        sv = SVBuffer(as_tensor(sv.x, dev),
                      *(as_tensor(a, dev) for a in sv[1:]))
        return body(Xl, as_tensor(yl, dev, Xl.dtype),
                    as_tensor(ml, dev, Xl.dtype), sv, params)

    return f
