"""The port's sweep axis (``repro_torch.core.sweep``, functional mode)
against the JAX reference and against its own sequential fits: the same
numpy inputs go to ``repro.core.fit_mapreduce_sweep`` and to the port.

Tolerances: risks and hypotheses within rtol 1e-4 / atol 1e-5 of the
reference (``tests/test_sweep.py``'s), rounds and predictions equal. A
config of the port's sweep reads exactly the rows and parameters of the
sequential fit with that config, so their risks agree to 1e-6 and
their hypotheses to float32 rounding of the sums (1e-6).

The per-job wrappers are held to one call per job on materialised
rows with scalar parameters; a job with epoch cutoff 0 keeps α, w and
b at 0 in the plain versions."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
import repro_torch.core as T
from repro import sparse as jsp
from repro.data import svm_rows
from repro_torch import convert
from repro_torch import sparse as tsp
from repro_torch.kernels import ops, ref
from torch_threads import one_thread  # noqa: F401

RTOL, ATOL = 1e-4, 1e-5


def _problem(n=256, d=10, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    w = rng.normal(size=d).astype(np.float32)
    return X, np.sign(X @ w + 0.05).astype(np.float32)


def _cfgs(svm=None, **mr):
    svm = dict(C=1.0, max_epochs=10) if svm is None else svm
    kernel = svm.pop("kernel", None)
    jk = {} if kernel is None else dict(kernel=J.KernelConfig(**kernel))
    tk = {} if kernel is None else dict(kernel=T.KernelConfig(**kernel))
    return (J.MRSVMConfig(svm=J.SVMConfig(**svm, **jk), **mr),
            T.MRSVMConfig(svm=T.SVMConfig(**svm, **tk), **mr))


def _grids(jcfg, tcfg, **axes):
    jp = J.sweep_grid(jcfg.svm, **axes)
    tp = T.sweep_grid(tcfg.svm, **axes)
    return jp, tp


def _config(tp, s):
    return T.SolverParams(*(float(f[s]) for f in tp))


def _sequential(X, y, L, tcfg, tp, mask=None):
    """The port's sequential fit of every config."""
    S = len(tp.C)
    return [T.fit_mapreduce(X if X.ndim == 2 else X[s], y if y.ndim == 1
                            else y[s], L, tcfg, device="cpu",
                            mask=None if mask is None else
                            (mask if mask.ndim == 1 else mask[s]),
                            params=_config(tp, s)) for s in range(S)]


def _same_as_sequential(res, seqs, alpha=False):
    """Each config of the sweep ≡ its sequential fit."""
    for s, seq in enumerate(seqs):
        assert int(res.rounds[s]) == seq.rounds, s
        np.testing.assert_allclose(float(res.risks[s]), float(seq.risk),
                                   rtol=0, atol=1e-6)
        torch.testing.assert_close(res.ws[s], seq.w.float(), rtol=0,
                                   atol=1e-6)
        torch.testing.assert_close(res.final.b[s], seq.final.b, rtol=0,
                                   atol=1e-6)
        assert torch.equal(res.sv.ids[s], seq.sv.ids)
        if alpha:
            torch.testing.assert_close(res.sv.alpha[s], seq.sv.alpha,
                                       rtol=0, atol=1e-6)


def _same_as_reference(tres, jres, X_te_t, X_te_j, tcfg, jcfg,
                       ws=True):
    np.testing.assert_allclose(tres.risks.numpy(), np.asarray(jres.risks),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(tres.rounds, np.asarray(jres.rounds))
    if ws:
        np.testing.assert_allclose(tres.ws.numpy(), np.asarray(jres.ws),
                                   rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(
        T.predict_sweep(tres, X_te_t, tcfg).numpy(),
        np.asarray(J.predict_sweep(jres, X_te_j, jcfg)))
    assert tres.best == jres.best


# --- building the grid -------------------------------------------------------

def test_sweep_grid_and_stack_params_match_reference():
    jcfg, tcfg = _cfgs(dict(C=2.0, tol=1e-4, max_epochs=10))
    jp, tp = _grids(jcfg, tcfg, C=[0.1, 1.0, 10.0], gamma=[0.5, 2.0],
                    max_epochs=[3, 7])
    assert len(tp.C) == 12
    for a, b in zip(jp, tp):
        assert b.dtype == np.float32 and b.shape == (12,)
        np.testing.assert_array_equal(b, np.asarray(a))
    cfgs = [T.SVMConfig(C=c) for c in (0.1, 1.0, 10.0)]
    st = T.stack_params([c.params() for c in cfgs])
    sj = J.stack_params([J.SVMConfig(C=c).params() for c in (0.1, 1.0, 10.0)])
    for a, b in zip(sj, st):
        np.testing.assert_array_equal(b, np.asarray(a))
    back = convert.solver_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jp))
    for a, b in zip(tp, back):
        np.testing.assert_array_equal(b.numpy(), a)
    one = convert.solver_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jcfg.svm.params()))
    assert one == tuple(float(np.float32(f)) for f in tcfg.svm.params())
    with pytest.raises(ValueError, match="empty"):
        T.stack_params([])


def test_sweep_rejects_ragged_params():
    X, y = _problem(n=64, d=4)
    _, tcfg = _cfgs(dict(max_epochs=2), sv_capacity=16, max_rounds=1)
    bad = T.SolverParams(C=np.ones(3, np.float32),
                         tol=np.ones(2, np.float32),
                         sv_threshold=np.ones(3, np.float32),
                         gamma=np.ones(3, np.float32),
                         coef0=np.ones(3, np.float32),
                         max_epochs=np.ones(3, np.float32))
    with pytest.raises(ValueError, match="leading"):
        T.fit_mapreduce_sweep(X, y, 4, tcfg, bad, device="cpu")
    with pytest.raises(ValueError, match="leading"):
        T.fit_mapreduce_sweep(X, y, 4, tcfg, tcfg.svm.params(), device="cpu")
    good = T.sweep_grid(tcfg.svm, C=[1.0, 2.0])
    with pytest.raises(ValueError, match="leading axis 3"):
        T.fit_mapreduce_sweep(np.stack([X] * 3), y, 4, tcfg, good,
                              device="cpu")


# --- the linear path ---------------------------------------------------------

def _rows(fmt, X, cap=6):
    """X as dense rows or as blocked-CSR rows in both packages."""
    if fmt == "dense":
        return X, jnp.asarray(X)
    Xj = jsp.from_dense(jnp.asarray(X), cap)
    Xt = tsp.SparseRows(torch.from_numpy(np.array(Xj.indices)),
                        torch.from_numpy(np.array(Xj.values)), X.shape[1])
    return Xt, Xj


@pytest.mark.parametrize("fmt", ["dense", "sparse_csr"])
def test_linear_sweep_matches_sequential_and_reference(fmt):
    """C × tol (S = 8): batched ≡ sequential in the port ≡ the
    reference's batched sweep."""
    if fmt == "dense":
        X, y = _problem()
        svm = dict(C=1.0, max_epochs=10)
    else:
        X, y = svm_rows(256, 48, seed=3, nnz=6)
        svm = dict(C=1.0, max_epochs=10, row_format="sparse_csr", nnz_cap=6)
    jcfg, tcfg = _cfgs(svm, sv_capacity=32, gamma=1e-4, max_rounds=3)
    jp, tp = _grids(jcfg, tcfg, C=[0.01, 0.1, 1.0, 10.0], tol=[1e-3, 1e-2])
    Xt, Xj = _rows(fmt, X)
    tres = T.fit_mapreduce_sweep(Xt, y, 4, tcfg, tp, device="cpu")
    jres = J.fit_mapreduce_sweep(Xj, jnp.asarray(y), 4, jcfg, jp)
    assert tres.ws.shape == (8, X.shape[1]) and tres.sv.y.shape == (8, 32)
    _same_as_reference(tres, jres, Xt, Xj, tcfg, jcfg)
    _same_as_sequential(tres, _sequential(Xt, y, 4, tcfg, tp))


def test_per_config_eq8_masking_stops_every_config_at_round_2():
    X, y = _problem(n=128, d=6, seed=2)
    jcfg, tcfg = _cfgs(sv_capacity=32, gamma=1.0, max_rounds=8)
    jp, tp = _grids(jcfg, tcfg, C=[0.1, 1.0, 10.0])
    tres = T.fit_mapreduce_sweep(X, y, 4, tcfg, tp, device="cpu")
    jres = J.fit_mapreduce_sweep(jnp.asarray(X), jnp.asarray(y), 4, jcfg, jp)
    assert (tres.rounds == 2).all()
    np.testing.assert_array_equal(tres.rounds, np.asarray(jres.rounds))
    assert [h["active"] for h in tres.history] == [3, 3]


def test_mixed_convergence_does_not_disturb_active_configs():
    """A config that converges early freezes (tol = +inf, cutoff 0)
    while the other keeps its sequential trajectory: SV α as its
    sequential run, and as the reference's."""
    X, y = _problem(n=192, d=8, seed=3)
    jcfg, tcfg = _cfgs(dict(C=1.0, max_epochs=12), sv_capacity=32,
                       gamma=5e-3, max_rounds=6)
    jp, tp = _grids(jcfg, tcfg, C=[1e-4, 1.0])
    tres = T.fit_mapreduce_sweep(X, y, 4, tcfg, tp, device="cpu")
    jres = J.fit_mapreduce_sweep(jnp.asarray(X), jnp.asarray(y), 4, jcfg, jp)
    assert tres.rounds[0] < tres.rounds[1]
    _same_as_sequential(tres, _sequential(X, y, 4, tcfg, tp), alpha=True)
    np.testing.assert_array_equal(tres.rounds, np.asarray(jres.rounds))
    np.testing.assert_allclose(tres.sv.alpha.numpy(),
                               np.asarray(jres.sv.alpha), rtol=RTOL,
                               atol=ATOL)


def test_epoch_cutoff_grid_matches_reference_and_sequential():
    X, y = _problem(n=160, d=8, seed=4)
    jcfg, tcfg = _cfgs(dict(C=1.0, max_epochs=20, tol=1e-6),
                       sv_capacity=16, gamma=1e-4, max_rounds=3)
    jp, tp = _grids(jcfg, tcfg, max_epochs=[2, 5, 20])
    tres = T.fit_mapreduce_sweep(X, y, 4, tcfg, tp, device="cpu")
    jres = J.fit_mapreduce_sweep(jnp.asarray(X), jnp.asarray(y), 4, jcfg, jp)
    _same_as_reference(tres, jres, X, jnp.asarray(X), tcfg, jcfg)
    _same_as_sequential(tres, _sequential(X, y, 4, tcfg, tp))
    np.testing.assert_array_equal(tres.final.epochs_run.numpy(),
                                  np.asarray(jres.final.epochs_run))
    assert int(tres.final.epochs_run[0]) <= 2


def _solve_jobs(fmt, L=3, per=20, S=6, d=24, seed=0):
    """Home blocks (L, per, d), 2 shared blocks (2, S, d), labels and
    masks of 2·L jobs (config-major), rows as ``fmt``."""
    rng = np.random.default_rng(seed)
    dense = rng.random((L * per + 2 * S, d)).astype(np.float32) \
        * (rng.random((L * per + 2 * S, d)) < 0.3)
    dense /= np.maximum(np.linalg.norm(dense, axis=1, keepdims=True), 1e-9)
    rows = torch.from_numpy(dense)
    if fmt == "sparse_csr":
        rows = tsp.from_dense(rows, 10)
    xh = rows[:L * per].reshape(L, per, d)
    xs = rows[L * per:].reshape(2, S, d)
    w = rng.normal(size=d)
    ys = np.where(dense @ w >= 0, 1.0, -1.0).astype(np.float32)
    jobs = np.arange(2 * L)
    y = np.concatenate([ys[:L * per].reshape(L, per)[jobs % L],
                        ys[L * per:].reshape(2, S)[jobs // L]], 1)
    m = (rng.random((2 * L, per + S)) > 0.15).astype(np.float32)
    return xh, xs, torch.from_numpy(y), torch.from_numpy(m)


@pytest.mark.parametrize("fmt", ["dense", "sparse_csr"])
def test_cd_solve_per_job_values_and_mapping_equal_one_call_a_job(fmt):
    """``ops.cd_solve`` with (jobs,) C, tol and cutoffs over home blocks
    and a stack of shared blocks ≡ one call per job with scalars on the
    job's own rows; a job with cutoff 0 keeps α, w and b at 0."""
    xh, xs, y, m = _solve_jobs(fmt)
    jobs, L = y.shape[0], xh.shape[0]
    C = torch.tensor([0.5, 1.0, 2.0, 0.1, 1.0, 4.0])
    tol = torch.tensor([1e-3, 1e-2, 1e-3, 1e-4, 1e-3, 1e-3])
    cut = torch.tensor([3, 0, 8, 5, 1, 8], dtype=torch.int32)
    out = ops.cd_solve(xh, xs, y, m, C=C, tol=tol, max_epochs=cut)
    for j in range(jobs):
        one = ops.cd_solve(xh[j % L][None], xs[j // L], y[j:j + 1],
                           m[j:j + 1], C=float(C[j]), tol=float(tol[j]),
                           max_epochs=int(cut[j]))
        for a, b in zip(out, one):
            assert torch.equal(a[j], b[0]), j
    assert int(out[3][1]) == 0
    assert not out[0][1].any() and not out[1][1].any() and out[2][1] == 0


def test_cd_solve_gram_per_job_values_equal_one_call_a_job():
    rng = np.random.default_rng(1)
    X = torch.from_numpy(rng.normal(size=(4, 30, 5)).astype(np.float32))
    K = torch.exp(-0.5 * torch.cdist(X, X) ** 2)
    y = torch.from_numpy(np.sign(rng.normal(size=(4, 30))).astype(np.float32))
    m = torch.from_numpy((rng.random((4, 30)) > 0.1).astype(np.float32))
    C = torch.tensor([1.0, 10.0, 0.3, 1.0])
    tol = torch.tensor([1e-3, 1e-3, 1e-2, 1e-3])
    cut = torch.tensor([6, 6, 2, 0], dtype=torch.int32)
    for dt in (torch.float32, torch.bfloat16):
        out = ops.cd_solve_gram(K.to(dt), y.to(dt), m.to(dt), C=C, tol=tol,
                                max_epochs=cut)
        for j in range(4):
            one = ops.cd_solve_gram(K[j:j + 1].to(dt), y[j:j + 1].to(dt),
                                    m[j:j + 1].to(dt), C=float(C[j]),
                                    tol=float(tol[j]), max_epochs=int(cut[j]))
            for a, b in zip(out, one):
                assert torch.equal(a[j], b[0]), (dt, j)
        assert not out[0][3].any() and int(out[1][3]) == 0


@pytest.mark.parametrize("fmt", ["dense", "sparse_csr"])
def test_gram_per_job_values_and_mapping_equal_one_call_a_job(fmt):
    """``gram`` / ``sparse_gram`` of (home, shared stack, jobs a block)
    triples with (jobs,) γ and coef0 ≡ one call per job with scalars on
    the job's concatenated rows."""
    xh, xs, _, _ = _solve_jobs(fmt)
    jobs, L = 2 * xh.shape[0], xh.shape[0]
    fn = ops.gram if fmt == "dense" else ops.sparse_gram
    side = (xh, xs, L)
    for kind in ("rbf", "poly"):
        g = torch.linspace(0.2, 2.0, jobs)
        c0 = torch.linspace(-0.5, 0.5, jobs)
        K = fn(side, side, kind=kind, gamma=g, coef0=c0, degree=2)
        assert K.shape == (jobs, xh.shape[1] + xs.shape[1],
                           xh.shape[1] + xs.shape[1])
        for j in range(jobs):
            rows = tsp.rows_concat(xh[j % L], xs[j // L])
            one = fn(rows, rows, kind=kind, gamma=float(g[j]),
                     coef0=float(c0[j]), degree=2)
            assert torch.equal(K[j], one), (kind, j)
    with pytest.raises(ValueError, match="per-job"):
        fn(side, side, kind="rbf", gamma=torch.ones(3))


def test_plain_solves_keep_a_zero_cutoff_job_at_zero():
    xh, xs, y, m = _solve_jobs("dense")
    cut = torch.tensor([0, 4, 0, 4, 4, 0], dtype=torch.int32)
    for fn, rows in ((ref.cd_solve_ref, (xh, xs)),
                     (ref.cd_solve_sparse_ref, (tsp.from_dense(xh, 24),
                                                tsp.from_dense(xs, 24)))):
        a, w, b, t, _ = fn(*rows, y, m, C=1.0, tol=1e-3, max_epochs=cut)
        zero = cut == 0
        assert not a[zero].any() and not w[zero].any() and not b[zero].any()
        assert (t == cut).all() and a[~zero].any()


# --- one-vs-rest, per-job data -----------------------------------------------

def test_one_vs_rest_sweep_folds_into_the_job_axis():
    """k classes × S configs ≡ one k·S-job batch, job j = (config j // k,
    class j % k), as the reference's."""
    rng = np.random.default_rng(1)
    y = rng.integers(-1, 2, size=240)
    X = (rng.normal(0, 1, (240, 8)) + 2.0 * y[:, None]).astype(np.float32)
    jcfg, tcfg = _cfgs(dict(C=1.0, max_epochs=20), sv_capacity=64,
                       gamma=1e-4, max_rounds=4)
    jp, tp = _grids(jcfg, tcfg, C=[1e-3, 1.0])
    tovr = T.fit_one_vs_rest_sweep(X, y, [-1, 0, 1], 4, tcfg, tp,
                                   device="cpu")
    jovr = J.fit_one_vs_rest_sweep(jnp.asarray(X), jnp.asarray(y),
                                   [-1, 0, 1], 4, jcfg, jp)
    assert tovr.result.risks.shape == (6,)
    np.testing.assert_allclose(tovr.result.risks.numpy(),
                               np.asarray(jovr.result.risks), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(tovr.result.params.C.numpy(),
                               np.repeat(tp.C, 3))
    np.testing.assert_array_equal(tovr.predict(X).numpy(),
                                  np.asarray(jovr.predict(jnp.asarray(X))))
    np.testing.assert_allclose(tovr.risks(), jovr.risks(), rtol=RTOL,
                               atol=ATOL)
    assert tovr.best == jovr.best
    # job 4 is (config 1, class 0): the sequential fit of class 0 at C = 1
    seq = T.fit_mapreduce(X, np.where(y == 0, 1.0, -1.0), 4, tcfg,
                          params=_config(tp, 1), device="cpu")
    np.testing.assert_allclose(float(tovr.result.risks[4]), float(seq.risk),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("fmt", ["dense", "sparse_csr"])
def test_per_job_rows_and_mask_match_reference_and_sequential(fmt):
    """X (S, n, d) and mask (S, n) per job, as the streaming fold's."""
    S, n, d = 2, 128, 24
    rows, ys = zip(*(svm_rows(n, d, seed=10 + s, nnz=6) for s in range(S)))
    X = np.stack(rows)
    y = np.stack(ys)
    mask = (np.random.default_rng(5).random((S, n)) > 0.2).astype(np.float32)
    svm = dict(C=1.0, max_epochs=8)
    if fmt == "sparse_csr":
        svm.update(row_format="sparse_csr", nnz_cap=6)
    jcfg, tcfg = _cfgs(svm, sv_capacity=16, gamma=1e-4, max_rounds=3)
    jp, tp = _grids(jcfg, tcfg, C=[0.5, 2.0])
    Xt, Xj = _rows(fmt, X.reshape(S * n, d))
    Xt, Xj = Xt.reshape(S, n, d), Xj.reshape(S, n, d)
    tres = T.fit_mapreduce_sweep(Xt, y, 4, tcfg, tp, mask=mask, device="cpu")
    jres = J.fit_mapreduce_sweep(Xj, jnp.asarray(y), 4, jcfg, jp,
                                 mask=jnp.asarray(mask))
    np.testing.assert_allclose(tres.risks.numpy(), np.asarray(jres.risks),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(tres.rounds, np.asarray(jres.rounds))
    np.testing.assert_allclose(tres.ws.numpy(), np.asarray(jres.ws),
                               rtol=RTOL, atol=ATOL)
    _same_as_sequential(tres, _sequential(Xt, y, 4, tcfg, tp, mask=mask))


# --- the Gram path -----------------------------------------------------------

def _xor(n=128, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(0, 1, (n, 2)).astype(np.float32)
    return X, np.sign(X[:, 0] * X[:, 1]).astype(np.float32)


@pytest.mark.parametrize("impl", ["xla", "pallas", "pallas_sparse"])
def test_rbf_sweep_matches_sequential_and_reference(impl):
    """C × γ on the Gram path: γ per job in one Gram build (the Pallas
    Gram of the reference in interpret mode)."""
    svm = dict(C=10.0, max_epochs=8, use_gram=True, gram_impl=impl,
               kernel=dict(name="rbf", gamma=1.0))
    if impl == "pallas_sparse":
        X, y = svm_rows(128, 16, seed=2, nnz=4)
        svm.update(row_format="sparse_csr", nnz_cap=4)
        fmt = "sparse_csr"
    else:
        X, y = _xor()
        fmt = "dense"
    jcfg, tcfg = _cfgs(svm, sv_capacity=32, max_rounds=2, gamma=1e-3)
    jp, tp = _grids(jcfg, tcfg, C=[1.0, 10.0], gamma=[0.3, 3.0])
    Xt, Xj = _rows(fmt, X, cap=4)
    tres = T.fit_mapreduce_sweep(Xt, y, 4, tcfg, tp, device="cpu")
    jres = J.fit_mapreduce_sweep(Xj, jnp.asarray(y), 4, jcfg, jp)
    _same_as_reference(tres, jres, Xt, Xj, tcfg, jcfg, ws=False)
    np.testing.assert_allclose(tres.sv.alpha.numpy(),
                               np.asarray(jres.sv.alpha), rtol=RTOL,
                               atol=1e-4)
    seqs = _sequential(Xt, y, 4, tcfg, tp)
    for s, seq in enumerate(seqs):
        assert int(tres.rounds[s]) == seq.rounds
        np.testing.assert_allclose(float(tres.risks[s]), float(seq.risk),
                                   rtol=0, atol=1e-6)
        assert torch.equal(tres.sv.ids[s], seq.sv.ids)
        torch.testing.assert_close(tres.final.alpha[s], seq.final.alpha,
                                   rtol=0, atol=1e-6)
        dv = T.decision_values(seq, Xt, tcfg, params=_config(tp, s),
                               device="cpu")
        torch.testing.assert_close(
            T.sweep_decision_values(tres, Xt, tcfg)[s], dv, rtol=0,
            atol=1e-5)


def test_sweep_selected_config_beats_worst_on_held_out():
    """``tests/test_paper_pipeline.py``'s model selection on the golden
    data, on the port: the risk-ranked best of an rbf (C, γ) grid with a
    memorizing γ beats the worst on held-out rows."""
    from repro_torch import text as ttext
    corpus = ttext.generate(ttext.CorpusConfig(num_messages=1024,
                                               classes=(-1, 1), seed=0))
    X, _ = ttext.fit_transform(ttext.vectorize(corpus.texts, 1024),
                               device="cpu")
    y = torch.from_numpy(corpus.labels.astype(np.float32))
    tr, te = slice(0, 768), slice(768, None)
    _, cfg = _cfgs(dict(C=10.0, max_epochs=15,
                        kernel=dict(name="rbf", gamma=1.0)),
                   sv_capacity=128, gamma=1e-4, max_rounds=3)
    params = T.sweep_grid(cfg.svm, C=[1.0, 10.0], gamma=[0.5, 200.0])
    res = T.fit_mapreduce_sweep(X[tr], y[tr], 8, cfg, params)
    preds = T.predict_sweep(res, X[te], cfg)
    accs = (preds == y[te][None]).float().mean(1).numpy()
    worst = int(np.argmax(res.risks.numpy()))
    assert res.best != worst
    assert accs[res.best] > accs[worst] + 0.1
    assert accs[res.best] > 0.85
