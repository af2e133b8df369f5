"""Blocked-CSR rows on the port's linear path (the ``cd_solve/sparse``
and ``hinge_scores/sparse`` routes, whose plain versions run here),
``update_mapreduce`` and χ² feature selection, against the JAX
reference and against the port's own dense path on the same rows.

Tolerances: the sparse and dense solves sum w·x over other terms in
another order (the row's slots against all d columns), so α, w and b
agree to float32 rounding carried through the epochs (atol 1e-5);
risks between the packages to 1e-5 relative, as XLA and torch also sum
in other orders; SV ids and the reducer picks exactly."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
from repro.core.svm import fit_binary_linear as j_fit_binary_linear
import repro_torch.core as T
from repro import sparse as jsp
from repro.core.mapreduce_svm import update_mapreduce as j_update
from repro.data import svm_rows
from repro.text import feature_select as j_fs
from repro_torch import convert
from repro_torch import sparse as tsp
from repro_torch.kernels import ops, ref
from repro_torch import text as t_fs


def _pair(Xd: np.ndarray, cap: int):
    """The same rows as JAX and port ``SparseRows`` (top-|value| slots,
    padding (0, 0))."""
    Xj = jsp.from_dense(jnp.asarray(Xd), cap)
    Xt = tsp.SparseRows(torch.from_numpy(np.array(Xj.indices)),
                        torch.from_numpy(np.array(Xj.values)), Xd.shape[1])
    return Xj, Xt


def _matched_problem(n=256, d=64, cap=16, seed=3):
    """tests/test_sparse.py's matched problem: 8 nonzeros a row in 16
    slots, so every row has padding."""
    Xd, y = svm_rows(n, d, seed=seed, nnz=8)
    return (*_pair(Xd, cap), Xd, y)


def _cfgs(cap, **kw):
    svm = dict(C=1.0, max_epochs=8, row_format="sparse_csr", nnz_cap=cap)
    mr = dict(sv_capacity=32, max_rounds=2, **kw)
    return (J.MRSVMConfig(svm=J.SVMConfig(**svm), **mr),
            T.MRSVMConfig(svm=T.SVMConfig(**svm), **mr))


def _solve_case(L, per, S, d, cap, seed, dead=False):
    """Job rows with padding slots, a real column 0 in rows that also
    hold padding, masked rows, and (``dead``) shared rows whose values
    are 0 but whose ids stay, as SV_global's dead slots."""
    rng = np.random.default_rng(seed)
    n_rows = L * per + S
    dense = np.zeros((n_rows, d), np.float32)
    for i in range(n_rows):
        k = rng.integers(1, cap + 1)
        cols = rng.choice(d, k, replace=False)
        if i % 3 == 0:
            cols[0] = 0
        dense[i, cols] = rng.random(k) + 0.05
    dense /= np.linalg.norm(dense, axis=1, keepdims=True)
    Xt = tsp.from_dense(torch.from_numpy(dense), cap)
    if dead and S:
        live = torch.ones((n_rows, 1))
        live[L * per::2] = 0.0
        Xt = Xt * live
    xh = Xt[:L * per].reshape(L, per, d)
    xs = Xt[L * per:]
    w = rng.normal(size=d)
    y = np.where(dense @ w >= 0, 1.0, -1.0).astype(np.float32)
    y_aug = np.concatenate([y[:L * per].reshape(L, per),
                            np.broadcast_to(y[L * per:], (L, S))], 1)
    m_aug = (rng.random((L, per + S)) > 0.2).astype(np.float32)
    return xh, xs, torch.from_numpy(y_aug), torch.from_numpy(m_aug)


SOLVE_CASES = [dict(L=3, per=40, S=12, d=48, cap=6, seed=0),
               dict(L=2, per=30, S=0, d=40, cap=5, seed=1),
               dict(L=4, per=1, S=9, d=32, cap=3, seed=2, dead=True),
               dict(L=2, per=25, S=16, d=64, cap=1, seed=3, dead=True)]


@pytest.mark.parametrize("case", SOLVE_CASES, ids=str)
@pytest.mark.parametrize("max_epochs", [1, 15])
def test_plain_sparse_solve_matches_dense_solve(case, max_epochs):
    xh, xs, y, m = _solve_case(**case)
    kw = dict(C=1.0, tol=1e-3, max_epochs=max_epochs)
    ops.reset_launches()
    sp = ops.cd_solve(xh, xs, y, m, **kw)
    de = ref.cd_solve_ref(tsp.to_dense(xh), tsp.to_dense(xs), y, m, **kw)
    assert not any(ops.LAUNCHES.values())          # the plain version
    assert torch.equal(sp[3], de[3])
    for a, b in zip(sp[:3], de[:3]):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0)
    torch.testing.assert_close(sp[4], de[4], atol=1e-5, rtol=0)
    assert not sp[0][m == 0].any()          # masked rows keep α = 0


def _bf16(Xj, Xt):
    """The same rows with bf16 values in both packages."""
    return (jsp.SparseRows(Xj.indices, Xj.values.astype(jnp.bfloat16), Xj.d),
            Xt.to(dtype=torch.bfloat16))


@pytest.mark.parametrize("seed", [5, 6])
def test_sparse_solve_with_bf16_values_matches_reference(seed):
    """bf16 values as the reference's jitted solve takes them
    (``svm.py:165``, ``:183-185``): w·x and the update in float32,
    Q_ii = Σ v² + 1 with Σ v² rounded to bf16. α, w and b within 1e-5 of
    ``J.fit_binary_linear`` (other sum orders), the epochs equal; a
    Σ v² kept in float32 moves α by more than 1e-4 on these rows."""
    rng = np.random.default_rng(seed)
    Xd, y = svm_rows(160, 48, seed=seed, nnz=7)
    Xj, Xt = _bf16(*_pair(Xd, 10))
    m = (rng.random(160) > 0.15).astype(np.float32)
    svm = dict(C=1.0, max_epochs=12, tol=1e-3)
    fit = jax.jit(j_fit_binary_linear, static_argnums=3)  # as fit_mapreduce
    jr = fit(Xj, jnp.asarray(y), jnp.asarray(m), J.SVMConfig(**svm))
    tr = T.fit_binary_linear(Xt, torch.from_numpy(y), torch.from_numpy(m),
                             T.SVMConfig(**svm))
    assert tr.w.dtype == torch.float32
    assert int(tr.epochs_run) == int(jr.epochs_run)
    for a, b in ((tr.alpha, jr.alpha), (tr.w, jr.w), (tr.b, jr.b),
                 (tr.max_violation, jr.max_violation)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5,
                                   rtol=0)
    Xf = Xt.to(dtype=torch.float32)           # the same values, Σ v² in f32
    f32q = ref.cd_solve_sparse_ref(Xf[None], Xf[:0], torch.from_numpy(y)[None],
                                   torch.from_numpy(m)[None], C=1.0, tol=1e-3,
                                   max_epochs=12)
    assert float((f32q[0][0] - tr.alpha).abs().max()) > 1e-4


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("risk_loss", ["hinge", "zero_one"])
def test_fit_mapreduce_sparse_matches_reference(risk_loss, dtype):
    Xj, Xt, Xd, y = _matched_problem()
    if dtype == "bfloat16":
        Xj, Xt = _bf16(Xj, Xt)
    jcfg, tcfg = _cfgs(Xt.nnz_cap, risk_loss=risk_loss)
    jm = J.fit_mapreduce(Xj, jnp.asarray(y), 4, jcfg)
    tm = T.fit_mapreduce(Xt, y, 4, tcfg, device="cpu")
    assert tsp.is_sparse(tm.sv.x) and tm.rounds == jm.rounds
    for ht, hj in zip(tm.history, jm.history, strict=True):
        assert (ht["reducer"], ht["sv_count"]) == (hj["reducer"],
                                                   hj["sv_count"])
        assert ht["risk"] == pytest.approx(hj["risk"], rel=1e-5)
    assert float(tm.risk) == pytest.approx(float(jm.risk), rel=1e-5)
    np.testing.assert_array_equal(tm.sv.ids.numpy(), np.asarray(jm.sv.ids))
    np.testing.assert_allclose(tm.final.w.numpy(), np.asarray(jm.final.w),
                               atol=1e-5)
    # the serve side: dense and blocked-CSR queries
    qj, qt = _pair(Xd[:40], Xt.nnz_cap)
    for q_t, q_j in ((torch.from_numpy(Xd[:40]), jnp.asarray(Xd[:40])),
                     (qt, qj)):
        np.testing.assert_allclose(
            T.decision_values(tm, q_t, tcfg).numpy(),
            np.asarray(J.decision_values(jm, q_j, jcfg)), atol=1e-5)
    np.testing.assert_array_equal(
        T.predict(tm, qt, tcfg, use_final=False).numpy(),
        np.asarray(J.predict(jm, qj, jcfg, use_final=False)))


def test_fit_mapreduce_sparse_matches_dense_on_the_port():
    _, Xt, Xd, y = _matched_problem()
    _, tcfg = _cfgs(Xt.nnz_cap)
    dcfg = T.MRSVMConfig(sv_capacity=32, max_rounds=2,
                         svm=T.SVMConfig(C=1.0, max_epochs=8))
    ms = T.fit_mapreduce(Xt, y, 4, tcfg, device="cpu")
    md = T.fit_mapreduce(Xd, y, 4, dcfg, device="cpu")
    assert [(h["reducer"], h["sv_count"]) for h in ms.history] == \
        [(h["reducer"], h["sv_count"]) for h in md.history]
    assert float(ms.risk) == pytest.approx(float(md.risk), rel=1e-4,
                                           abs=1e-5)
    np.testing.assert_array_equal(ms.sv.ids.numpy(), md.sv.ids.numpy())
    torch.testing.assert_close(tsp.to_dense(ms.sv.x), md.sv.x)
    torch.testing.assert_close(ms.final.w, md.final.w, atol=1e-5, rtol=0)
    torch.testing.assert_close(ms.w, md.w, atol=1e-5, rtol=0)
    q = torch.from_numpy(Xd)
    assert torch.equal(T.predict(ms, q, tcfg), T.predict(md, q, dcfg))


@pytest.mark.parametrize("L", [1, 8, 9])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sparse_hinge_plain_matches_reference(L, dtype):
    """The plain ``hinge_scores/sparse`` against the reference's eq. 7 on
    ``SparseRows``: ``Xflat @ W.T + b`` and the hinge (rtol 1e-5: XLA
    and torch sum the slots in other orders)."""
    rng = np.random.default_rng(L)
    Xd, y = svm_rows(300, 80, seed=L, nnz=9)
    Xj, Xt = _pair(Xd, 12)
    if dtype == "bfloat16":
        Xj = jsp.SparseRows(Xj.indices, Xj.values.astype(jnp.bfloat16), Xj.d)
        Xt = Xt.to(dtype=torch.bfloat16)
    W = rng.normal(size=(L, 80)).astype(np.float32)
    b = rng.normal(size=L).astype(np.float32)
    m = (rng.random(300) > 0.2).astype(np.float32)
    s = np.asarray(Xj @ jnp.asarray(W).T + jnp.asarray(b)[None, :])
    want = (np.maximum(0.0, 1.0 - y[:, None] * s) * m[:, None]).sum(0)
    ops.reset_launches()
    loss, cnt = ops.hinge_scores(Xt, torch.from_numpy(W), torch.from_numpy(b),
                                 torch.from_numpy(y), torch.from_numpy(m))
    assert not any(ops.LAUNCHES.values())
    np.testing.assert_allclose(loss.numpy(), want, rtol=1e-5)
    assert float(cnt) == float(m.sum())
    dense = ref.hinge_scores_ref(tsp.to_dense(Xt), torch.from_numpy(W),
                                 torch.from_numpy(b), torch.from_numpy(y),
                                 torch.from_numpy(m))
    torch.testing.assert_close(loss, dense[0], rtol=1e-5, atol=0)


def _jax_model_to_port(jm):
    """A JAX ``MapReduceSVM`` carried across with ``convert.py``."""
    sv = jm.sv
    x = (np.asarray(sv.x.indices), np.asarray(sv.x.values), sv.x.d) \
        if jsp.is_sparse(sv.x) else np.asarray(sv.x)
    return convert.mapreduce_model_from_numpy(
        np.asarray(jm.w), np.asarray(jm.b),
        (x, *(np.asarray(f) for f in sv[1:])),
        tuple(np.asarray(f) for f in jm.final), np.asarray(jm.risk),
        jm.rounds, jm.history)


@pytest.mark.parametrize("fmt", ["dense", "sparse"])
def test_update_mapreduce_matches_reference(fmt):
    """A model fit in JAX, carried across, updated in both packages on a
    new batch: new rows ∪ the carried SVs."""
    X0, y0 = svm_rows(192, 64, seed=11, nnz=8)
    X1, y1 = svm_rows(96, 64, seed=12, nnz=8)
    if fmt == "sparse":
        (X0j, _), (X1j, X1t) = _pair(X0, 16), _pair(X1, 16)
        jcfg, tcfg = _cfgs(16)
    else:
        X0j, X1j, X1t = jnp.asarray(X0), jnp.asarray(X1), X1
        jcfg = J.MRSVMConfig(sv_capacity=32, max_rounds=2,
                             svm=J.SVMConfig(max_epochs=8))
        tcfg = T.MRSVMConfig(sv_capacity=32, max_rounds=2,
                             svm=T.SVMConfig(max_epochs=8))
    jm = J.fit_mapreduce(X0j, jnp.asarray(y0), 4, jcfg)
    tm = _jax_model_to_port(jm)
    ju = j_update(jm, X1j, jnp.asarray(y1), 4, jcfg)
    tu = T.update_mapreduce(tm, X1t, y1, 4, tcfg, device="cpu")
    assert tsp.is_sparse(tu.sv.x) == (fmt == "sparse")
    assert tu.rounds == ju.rounds
    for ht, hj in zip(tu.history, ju.history, strict=True):
        assert (ht["reducer"], ht["sv_count"]) == (hj["reducer"],
                                                   hj["sv_count"])
        assert ht["risk"] == pytest.approx(hj["risk"], rel=1e-5)
    np.testing.assert_array_equal(tu.sv.ids.numpy(), np.asarray(ju.sv.ids))
    np.testing.assert_allclose(tu.final.w.numpy(), np.asarray(ju.final.w),
                               atol=1e-5)
    np.testing.assert_allclose(
        T.decision_values(tu, X1t, tcfg, device="cpu").numpy(),
        np.asarray(J.decision_values(ju, X1j, jcfg)), atol=1e-5)


@pytest.mark.parametrize("fmt", ["dense", "sparse"])
def test_update_mapreduce_refuses_other_feature_dims(fmt):
    X0, y0 = svm_rows(64, 32, seed=1, nnz=4)
    X1, y1 = svm_rows(16, 40, seed=2, nnz=4)
    if fmt == "sparse":
        X0t, X1t = _pair(X0, 8)[1], _pair(X1, 8)[1]
        X1j = _pair(X1, 8)[0]
        jcfg, tcfg = _cfgs(8)
    else:
        X0t, X1t, X1j = X0, X1, jnp.asarray(X1)
        jcfg, tcfg = J.MRSVMConfig(sv_capacity=16, max_rounds=1), \
            T.MRSVMConfig(sv_capacity=16, max_rounds=1)
    tm = T.fit_mapreduce(X0t, y0, 4, tcfg, device="cpu")
    msg = "update batch has 40 features but the model's SV buffer holds 32"
    with pytest.raises(ValueError, match=msg):
        T.update_mapreduce(tm, X1t, y1, 4, tcfg, device="cpu")
    X0j = jnp.asarray(X0) if fmt == "dense" else _pair(X0, 8)[0]
    jm = J.fit_mapreduce(X0j, jnp.asarray(y0), 4, jcfg)
    with pytest.raises(ValueError, match=msg):
        j_update(jm, X1j, jnp.asarray(y1), 4, jcfg)


@pytest.mark.parametrize("classes", [(-1, 1), (-1, 0, 1)])
@pytest.mark.parametrize("k", [5, 30])
def test_chi2_selection_matches_reference(classes, k):
    """χ² scores to 1e-5 relative (XLA and torch sum in other orders);
    the selected features equal, including the ties at 0 of the 12
    features of zero mass when k reaches them (lower index first)."""
    rng = np.random.default_rng(len(classes) + k)
    X = (rng.random((120, 36)) * (rng.random((120, 36)) < 0.3)
         ).astype(np.float32)
    X[:, rng.choice(36, 12, replace=False)] = 0.0
    y = rng.choice(np.asarray(classes), 120)
    s_t = t_fs.chi2_scores(X, y, classes, device="cpu")
    s_j = j_fs.chi2_scores(jnp.asarray(X), jnp.asarray(y), classes)
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=1e-5)
    assert int((s_t == 0).sum()) >= 12
    Xk_t, idx_t = t_fs.select_top_k(X, y, classes, k, device="cpu")
    Xk_j, idx_j = j_fs.select_top_k(jnp.asarray(X), jnp.asarray(y), classes,
                                    k)
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    np.testing.assert_array_equal(Xk_t.numpy(), np.asarray(Xk_j))


def test_one_vs_rest_and_one_vs_one_on_sparse_linear_rows():
    """OvR 3-class on blocked-CSR rows equals the reference's; OvO runs
    on them too (the reference's takes dense rows only) and equals the
    port's OvO on the same rows dense."""
    Xd, y = svm_rows(240, 48, seed=7, nnz=6)
    y3 = np.where(y > 0, 1, np.where(np.arange(240) % 3 == 0, 0, -1))
    Xj, Xt = _pair(Xd, 8)
    jcfg, tcfg = _cfgs(8)
    jm = J.fit_one_vs_rest(Xj, jnp.asarray(y3), [-1, 0, 1], 4, jcfg)
    tm = T.fit_one_vs_rest(Xt, y3, [-1, 0, 1], 4, tcfg, device="cpu")
    np.testing.assert_array_equal(tm.predict(Xt).numpy(),
                                  np.asarray(jm.predict(Xj)))
    dcfg = T.MRSVMConfig(sv_capacity=32, max_rounds=2,
                         svm=T.SVMConfig(C=1.0, max_epochs=8))
    ovo_s = T.fit_one_vs_one(Xt, y3, [-1, 0, 1], 4, tcfg, device="cpu")
    ovo_d = T.fit_one_vs_one(Xd, y3, [-1, 0, 1], 4, dcfg, device="cpu")
    assert torch.equal(ovo_s.predict(Xt), ovo_d.predict(torch.from_numpy(Xd)))


def test_sparse_linear_wrappers_check_their_inputs():
    xh, xs, y, m = _solve_case(L=2, per=5, S=3, d=16, cap=4, seed=9)
    kw = dict(C=1.0, tol=1e-3, max_epochs=2)
    other_cap = tsp.SparseRows(xs.indices[:, :2], xs.values[:, :2], 16)
    with pytest.raises(ValueError, match="nnz_cap differs"):
        ops.cd_solve(xh, other_cap, y, m, **kw)
    with pytest.raises(ValueError, match="SparseRows on both sides"):
        ops.cd_solve(xh, tsp.to_dense(xs), y, m, **kw)
    wide = tsp.SparseRows(xh.indices.long(), xh.values, 16)
    with pytest.raises(ValueError, match="int32"):
        ops.cd_solve(wide, xs, y, m, **kw)
    with pytest.raises(ValueError, match="one dtype"):
        ops.cd_solve(xh, xs.to(dtype=torch.bfloat16), y, m, **kw)
    with pytest.raises(ValueError, match="y and m must be"):
        ops.cd_solve(xh, xs, y[:, :-1], m, **kw)
    X = xs.to(dtype=torch.float64)
    with pytest.raises(ValueError, match="values must be one of"):
        ops.hinge_scores(X, torch.ones((1, 16)), torch.zeros(1),
                         torch.ones(3), torch.ones(3))
