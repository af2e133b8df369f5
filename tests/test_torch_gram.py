"""The port's Gram path against the JAX reference: the plain versions
of ``gram``, ``sparse_gram`` and ``cd_solve_gram`` (the CUDA kernels
run only on a card; ``chip_smoke.py`` holds them against these), the
kernel-path MapReduce driver on dense and blocked-CSR rows, the golden
rbf pipeline and a JAX-trained sparse rbf model served by the port.
Pallas kernels run in interpret mode, as the reference's tests run
them."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
import repro_torch.core as T
from repro import sparse as jsp
from repro import text as jtext
from repro.core.svm import fit_binary_kernel as j_fit_binary_kernel
from repro.data import pipeline as jpipe
from repro.kernels import gram as jgram
from repro_torch import convert
from repro_torch import sparse as tsp
from repro_torch import text as ttext
from repro_torch.kernels import ops, ref

KINDS = [("linear", {}), ("rbf", dict(gamma=0.5)),
         ("poly", dict(gamma=0.5, coef0=1.0, degree=2))]


@pytest.mark.parametrize("n,m,d", [(64, 64, 32), (300, 200, 260)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gram_ref_matches_pallas_gram(n, m, d, dtype):
    """The tolerances of tests/test_kernels.py:26: 1e-4 in f32; 5e-2 in
    bf16, where both sides take products of the bf16 rows in f32."""
    rng = np.random.default_rng(n + d)
    X = rng.normal(size=(n, d)).astype(np.float32)
    Z = rng.normal(size=(m, d)).astype(np.float32)
    Xj, Zj = jnp.asarray(X, dtype), jnp.asarray(Z, dtype)
    Xt = convert.tensor_from_numpy(np.asarray(Xj))
    Zt = convert.tensor_from_numpy(np.asarray(Zj))
    tol = 1e-4 if dtype == "float32" else 5e-2
    for kind, kw in KINDS:
        K = jgram.gram(Xj, Zj, kind=kind, bm=128, bn=128, bk=128, **kw)
        np.testing.assert_allclose(ref.gram_ref(Xt, Zt, kind=kind, **kw),
                                   np.asarray(K), rtol=tol, atol=tol)


def _sparse_pair(n, d, nnz, cap, seed):
    rng = np.random.default_rng(seed)
    dense = np.zeros((n, d), np.float32)
    for i in range(n):
        dense[i, rng.choice(d, nnz, replace=False)] = rng.normal(0, 1, nnz)
    dense /= np.maximum(np.linalg.norm(dense, axis=1, keepdims=True), 1e-9)
    return dense, tsp.from_dense(torch.from_numpy(dense), cap), \
        jsp.from_dense(jnp.asarray(dense), cap)


@pytest.mark.parametrize("kind,kw", KINDS, ids=[k for k, _ in KINDS])
def test_sparse_gram_ref_matches_pallas_sparse_gram(kind, kw):
    """1e-5: float32 sums of a few matched products in another order;
    the mixed dense × sparse case goes through cross_dots on both
    sides."""
    dx, xt, xj = _sparse_pair(40, 300, 6, 8, 1)
    dz, zt, zj = _sparse_pair(70, 300, 6, 8, 2)
    K = jgram.sparse_gram(xj, zj, kind=kind, **kw)
    np.testing.assert_allclose(ref.sparse_gram_ref(xt, zt, kind=kind, **kw),
                               np.asarray(K), rtol=1e-5, atol=1e-5)
    Km = jgram.sparse_gram(jnp.asarray(dx), zj, kind=kind, **kw)
    np.testing.assert_allclose(
        ref.sparse_gram_ref(torch.from_numpy(dx), zt, kind=kind, **kw),
        np.asarray(Km), rtol=1e-5, atol=1e-5)


def test_gram_wrappers_take_home_and_shared_rows():
    """ops.gram / ops.sparse_gram on (home (J, per, ·), shared) pairs ≡
    the plain version on each job's concatenated rows [home[l]; shared]."""
    rng = np.random.default_rng(3)
    H = torch.from_numpy(rng.normal(size=(3, 10, 16)).astype(np.float32))
    S = torch.from_numpy(rng.normal(size=(4, 16)).astype(np.float32))
    Q = torch.from_numpy(rng.normal(size=(5, 16)).astype(np.float32))
    K = ops.gram((H, S), (H, S), kind="rbf", gamma=0.1)
    assert K.shape == (3, 14, 14)
    for j in range(3):
        Xa = torch.cat([H[j], S])
        torch.testing.assert_close(K[j], ref.gram_ref(Xa, Xa, "rbf", 0.1))
    Kq = ops.gram(Q, (H[:1], S), kind="linear")
    torch.testing.assert_close(Kq[0], Q @ torch.cat([H[0], S]).T)
    sH = tsp.from_dense(H.reshape(30, 16), 6).reshape(3, 10, 16)
    sS = tsp.from_dense(S, 6)
    Ks = ops.sparse_gram((sH, sS), (sH, sS), kind="poly", degree=3)
    for j in range(3):
        Xa = tsp.to_dense(tsp.rows_concat(sH[j], sS))
        torch.testing.assert_close(Ks[j], ref.gram_ref(Xa, Xa, "poly",
                                                       degree=3))


def test_gram_wrappers_check_inputs_and_count_no_launch_on_cpu():
    X = torch.zeros((4, 8))
    ops.reset_launches()
    with pytest.raises(ValueError, match="SparseRows on both sides"):
        ops.sparse_gram(X, tsp.from_dense(X, 2))
    with pytest.raises(ValueError, match="dense rows"):
        ops.gram(tsp.from_dense(X, 2), X)
    with pytest.raises(ValueError, match="do not broadcast"):
        ops.gram((torch.zeros((2, 3, 8)), X[:0]), (torch.zeros((3, 3, 8)),
                                                  X[:0]))
    with pytest.raises(ValueError, match="degree"):
        ops.gram(X, X, kind="poly", degree=-1)
    with pytest.raises(ValueError, match="unknown kernel"):
        ops.gram(X, X, kind="sigmoid")
    with pytest.raises(ValueError, match="one dtype"):
        ops.cd_solve_gram(torch.zeros((1, 4, 4)), torch.zeros((1, 4)),
                          torch.zeros((1, 4), dtype=torch.bfloat16), C=1.0,
                          tol=1e-3, max_epochs=1)
    ops.gram(X, X)
    ops.cd_solve_gram(torch.zeros((1, 4, 4)), torch.ones((1, 4)),
                      torch.ones((1, 4)), C=1.0, tol=1e-3, max_epochs=1)
    assert not any(ops.LAUNCHES.values())


def _gram_jobs(L, n, d, seed, kind="rbf"):
    rng = np.random.default_rng(seed)
    X = rng.random((L, n, d), dtype=np.float32) * (rng.random((L, n, d)) < 0.3)
    X /= np.maximum(np.linalg.norm(X, axis=2, keepdims=True), 1e-9)
    K = np.stack([np.asarray(jgram.gram(jnp.asarray(x), jnp.asarray(x),
                                        kind=kind)) for x in X])
    y = np.where(rng.random((L, n)) > 0.5, 1.0, -1.0).astype(np.float32)
    m = (rng.random((L, n)) > 0.1).astype(np.float32)
    return X, K, y * m, m


@pytest.mark.parametrize("L,n,C,max_epochs,kind", [
    (8, 60, 1.0, 15, "rbf"),      # a MapReduce round's jobs
    (3, 41, 0.5, 7, "linear"),    # use_gram linear, another C
    (1, 50, 1.0, 1, "poly"),      # one epoch
])
def test_cd_solve_gram_ref_matches_vmapped_fit_binary_kernel(L, n, C,
                                                            max_epochs,
                                                            kind):
    """Both sides solve on the same K. α, b and viol to 1e-5 in f32 (the
    same float32 operations in the same order), epochs equal."""
    X, K, y, m = _gram_jobs(L, n, 24, L * n, kind)
    cfg = J.SVMConfig(C=C, tol=1e-3, max_epochs=max_epochs,
                      kernel=J.KernelConfig(kind, degree=2), use_gram=True)
    jres = jax.vmap(lambda x, k, yy, mm: j_fit_binary_kernel(
        x, yy, mm, cfg, gram_fn=lambda a, b: k))(
        jnp.asarray(X), jnp.asarray(K), jnp.asarray(y), jnp.asarray(m))
    alpha, t, viol = ref.cd_solve_gram_ref(
        torch.from_numpy(K), torch.from_numpy(y), torch.from_numpy(m), C=C,
        tol=1e-3, max_epochs=max_epochs)
    np.testing.assert_allclose(alpha.numpy(), np.asarray(jres.alpha),
                               atol=1e-5)
    np.testing.assert_allclose((alpha * torch.from_numpy(y * m)).sum(1),
                               np.asarray(jres.b), atol=1e-5)
    np.testing.assert_allclose(viol.numpy(), np.asarray(jres.max_violation),
                               atol=1e-5)
    np.testing.assert_array_equal(t.numpy(), np.asarray(jres.epochs_run))


def test_cd_solve_gram_ref_bf16_state_follows_the_reference():
    """bf16 K, labels and mask: the state is bf16 on both sides
    (svm.py:248, :260-261). XLA may keep float32 between fused bf16
    operations where the port rounds after each, so α is held to 2
    bf16 steps at 1 (2⁻⁶) and the epochs run to equality."""
    X, K, y, m = _gram_jobs(4, 48, 16, 11)
    cfg = J.SVMConfig(C=1.0, tol=1e-3, max_epochs=10,
                      kernel=J.KernelConfig("rbf"), use_gram=True)
    Kb = jnp.asarray(K, jnp.bfloat16)
    jres = jax.vmap(lambda x, k, yy, mm: j_fit_binary_kernel(
        x, yy, mm, cfg, gram_fn=lambda a, b: k))(
        jnp.asarray(X, jnp.bfloat16), Kb, jnp.asarray(y, jnp.bfloat16),
        jnp.asarray(m, jnp.bfloat16))
    alpha, t, viol = ref.cd_solve_gram_ref(
        convert.tensor_from_numpy(np.asarray(Kb)),
        torch.from_numpy(y).to(torch.bfloat16),
        torch.from_numpy(m).to(torch.bfloat16), C=1.0, tol=1e-3,
        max_epochs=10)
    assert alpha.dtype == viol.dtype == torch.bfloat16
    np.testing.assert_allclose(alpha.float().numpy(),
                               np.asarray(jres.alpha, np.float32),
                               atol=2 ** -6)
    np.testing.assert_array_equal(t.numpy(), np.asarray(jres.epochs_run))


def _matched(n=256, d=64, cap=16):
    Xd, y = jpipe.svm_rows(n, d, seed=3, nnz=8)
    return Xd, y, cap


def _mr_cfgs(kernel, impl, fmt="dense", cap=0, **kw):
    base = dict(sv_capacity=32, max_rounds=3, gamma=1e-4)
    svm = dict(C=1.0, max_epochs=8, use_gram=True, gram_impl=impl,
               row_format=fmt, nnz_cap=cap)
    return (J.MRSVMConfig(svm=J.SVMConfig(kernel=J.KernelConfig(**kernel),
                                          **svm), **base, **kw),
            T.MRSVMConfig(svm=T.SVMConfig(kernel=T.KernelConfig(**kernel),
                                          **svm), **base, **kw))


def _round_for_round(jm, tm):
    assert tm.rounds == jm.rounds
    for ht, hj in zip(tm.history, jm.history, strict=True):
        assert (ht["round"], ht["reducer"], ht["sv_count"]) == \
            (hj["round"], hj["reducer"], hj["sv_count"])
        assert ht["risk"] == pytest.approx(hj["risk"], abs=1e-4)
    np.testing.assert_array_equal(tm.sv.ids.numpy(), np.asarray(jm.sv.ids))


@pytest.mark.parametrize("kernel,risk_loss", [
    (dict(name="rbf", gamma=1.0), "hinge"),
    (dict(name="poly", gamma=1.0, coef0=1.0, degree=2), "zero_one"),
    (dict(name="linear"), "hinge"),
])
def test_fit_mapreduce_dense_pallas_matches_reference(kernel, risk_loss):
    """Kernel-path driver on dense rows (gram_impl='pallas'; 252 rows so
    the last partition pads): rounds, reducer, |SV| and ids equal, risks
    1e-4; the linear use_gram model's w by weighted_row_sum."""
    Xd, y, _ = _matched(n=252)
    jcfg, tcfg = _mr_cfgs(kernel, "pallas", risk_loss=risk_loss)
    jm = J.fit_mapreduce(jnp.asarray(Xd), jnp.asarray(y), 4, jcfg)
    tm = T.fit_mapreduce(Xd, y, 4, tcfg, device="cpu")
    _round_for_round(jm, tm)
    np.testing.assert_allclose(tm.final.alpha.numpy(),
                               np.asarray(jm.final.alpha), atol=1e-4)
    np.testing.assert_allclose(tm.final.w.numpy(), np.asarray(jm.final.w),
                               atol=1e-4)
    q = Xd[:40]
    np.testing.assert_allclose(
        T.decision_values(tm, q, tcfg, device="cpu").numpy(),
        np.asarray(J.decision_values(jm, jnp.asarray(q), jcfg)), atol=1e-4)


@pytest.mark.parametrize("impl", ["pallas_sparse", "xla"])
def test_fit_mapreduce_sparse_matches_reference_and_dense(impl):
    """Blocked-CSR rbf driver ≡ the reference round for round, and ≡ the
    port's dense run at matched data (tests/test_sparse.py:309-328):
    risks 1e-4, decision values on dense queries 1e-4."""
    Xd, y, cap = _matched(n=128)
    kern = dict(name="rbf", gamma=1.0)
    jcfg, tcfg = _mr_cfgs(kern, impl, "sparse_csr", cap)
    Xs_j = jsp.from_dense(jnp.asarray(Xd), cap)
    Xs_t = tsp.from_dense(torch.from_numpy(Xd), cap)
    jm = J.fit_mapreduce(Xs_j, jnp.asarray(y), 4, jcfg)
    tm = T.fit_mapreduce(Xs_t, y, 4, tcfg)
    _round_for_round(jm, tm)
    assert tsp.is_sparse(tm.sv.x)
    np.testing.assert_array_equal(tm.sv.x.indices.numpy(),
                                  np.asarray(jm.sv.x.indices))
    _, dcfg = _mr_cfgs(kern, "pallas")
    dm = T.fit_mapreduce(Xd, y, 4, dcfg, device="cpu")
    assert float(tm.risk) == pytest.approx(float(dm.risk), abs=1e-4)
    q = torch.from_numpy(Xd[:24])
    np.testing.assert_allclose(T.decision_values(tm, q, tcfg).numpy(),
                               T.decision_values(dm, q, dcfg).numpy(),
                               atol=1e-4)
    np.testing.assert_allclose(
        T.decision_values(tm, Xs_t[:24], tcfg).numpy(),
        np.asarray(J.decision_values(jm, Xs_j[:24], jcfg)), atol=1e-4)


@pytest.mark.parametrize("impl,message", [
    ("pallas", "gram takes dense rows"),
    ("pallas_sparse", "SparseRows on both sides"),
])
def test_gram_route_refuses_rows_its_kernel_cannot_take(impl, message):
    """Rows of the other format than the route's kernel takes (blocked-CSR
    under 'pallas', dense under 'pallas_sparse') raise, on the CPU as
    on the card: no route hands them to plain apply_kernel. The reference
    raises for the first as well."""
    Xd, y, cap = _matched(n=32)
    rows = dict(row_format="sparse_csr", nnz_cap=cap) \
        if impl == "pallas_sparse" else {}
    svm = T.SVMConfig(kernel=T.KernelConfig("rbf"), use_gram=True,
                      gram_impl=impl, **rows)
    X = tsp.from_dense(torch.from_numpy(Xd), cap) if impl == "pallas" \
        else Xd
    with pytest.raises(ValueError, match=message):
        T.fit_mapreduce(X, y, 4, T.MRSVMConfig(sv_capacity=8, max_rounds=1,
                                               svm=svm), device="cpu")
    with pytest.raises(ValueError, match=message):
        T.fit_binary(X, y, None, svm, device="cpu")


def test_fit_binary_kernel_matches_reference():
    Xd, y, _ = _matched(n=64)
    cfg = dict(C=1.0, max_epochs=10, use_gram=True, gram_impl="pallas")
    jres = J.fit_binary(jnp.asarray(Xd), jnp.asarray(y), None,
                        J.SVMConfig(kernel=J.KernelConfig("rbf"), **cfg))
    tres = T.fit_binary(Xd, y, None, T.SVMConfig(
        kernel=T.KernelConfig("rbf"), **cfg), device="cpu")
    np.testing.assert_allclose(tres.alpha.numpy(), np.asarray(jres.alpha),
                               atol=1e-5)
    assert float(tres.b) == pytest.approx(float(jres.b), abs=1e-5)
    assert not tres.w.any() and int(tres.epochs_run) == int(jres.epochs_run)


# -- the golden pipeline on the Gram path ---------------------------------

N_MSG, N_FEAT, N_TRAIN = 1024, 1024, 768
CLASSES = {2: (-1, 1), 3: (-1, 0, 1)}
RBF = dict(name="rbf", gamma=1.0)


def _golden_cfgs(fmt):
    kw = dict(sv_capacity=128, gamma=1e-4, max_rounds=4)
    svm = dict(C=1.0, max_epochs=15, use_gram=True)
    if fmt == "sparse":
        svm.update(gram_impl="pallas_sparse", row_format="sparse_csr",
                   nnz_cap=32)
    else:
        svm.update(gram_impl="pallas")
    return (J.MRSVMConfig(svm=J.SVMConfig(kernel=J.KernelConfig(**RBF),
                                          **svm), **kw),
            T.MRSVMConfig(svm=T.SVMConfig(kernel=T.KernelConfig(**RBF),
                                          **svm), **kw))


@pytest.fixture(scope="module", params=["dense2", "dense3", "sparse2"])
def golden(request):
    fmt, k = request.param[:-1], int(request.param[-1])
    jcfg, tcfg = _golden_cfgs(fmt)
    corpus = ttext.generate(ttext.CorpusConfig(num_messages=N_MSG,
                                               classes=CLASSES[k], seed=0))
    y = corpus.labels.astype(np.float32)
    if fmt == "sparse":
        counts = ttext.vectorize_sparse(corpus.texts, N_FEAT, nnz_cap=32)
        jcounts = jax.tree_util.tree_map(
            jnp.asarray, jtext.tokenizer.vectorize_sparse(corpus.texts,
                                                          N_FEAT, nnz_cap=32))
    else:
        counts = ttext.vectorize(corpus.texts, N_FEAT)
        jcounts = jnp.asarray(counts)
    Xt, _ = ttext.fit_transform(counts, device="cpu")
    Xj, _ = jtext.fit_transform(jcounts)
    tr, te = slice(0, N_TRAIN), slice(N_TRAIN, None)
    if k == 2:
        jm = J.fit_mapreduce(Xj[tr], jnp.asarray(y[tr]), 8, jcfg)
        tm = T.fit_mapreduce(Xt[tr], y[tr], 8, tcfg)
        jpred = np.asarray(J.predict(jm, Xj[te], jcfg))
        tpred = T.predict(tm, Xt[te], tcfg).numpy()
    else:
        jm = J.fit_one_vs_rest(Xj[tr], jnp.asarray(y[tr]), list(CLASSES[k]),
                               8, jcfg)
        tm = T.fit_one_vs_rest(Xt[tr], y[tr], list(CLASSES[k]), 8, tcfg)
        jpred = np.asarray(jm.predict(Xj[te]))
        tpred = tm.predict(Xt[te]).numpy()
    return dict(k=k, fmt=fmt, y_te=y[te], jm=jm, tm=tm, jpred=jpred,
                tpred=tpred, Xt_te=Xt[te], cfgs=(jcfg, tcfg))


def test_golden_rbf_predictions_equal_the_reference(golden):
    """Held-out predictions equal JAX's; accuracy 0.8828 (2-class, dense
    and sparse) and 0.78125 (OvR 3-class), as the reference reaches."""
    np.testing.assert_array_equal(golden["tpred"], golden["jpred"])
    acc = float(np.mean(golden["tpred"] == golden["y_te"]))
    assert acc == pytest.approx({2: 0.8828125, 3: 0.78125}[golden["k"]])
    if golden["k"] == 2:
        _round_for_round(golden["jm"], golden["tm"])


def _carry(jm):
    x = jm.sv.x
    if jsp.is_sparse(x):
        x = (np.asarray(x.indices), np.asarray(x.values), x.d)
    sv = [x] + [np.asarray(f) for f in jm.sv[1:]]
    return convert.mapreduce_model_from_numpy(
        np.asarray(jm.w), np.asarray(jm.b), sv,
        [np.asarray(f) for f in jm.final], np.asarray(jm.risk), jm.rounds,
        jm.history)


def test_reference_kernel_model_served_by_the_port(golden):
    """A JAX-trained rbf model (dense or blocked-CSR SV_global; one
    binary model or OvR), carried across with convert.py, gives the
    reference's predictions."""
    _, tcfg = golden["cfgs"]
    jm = golden["jm"]
    if golden["k"] == 2:
        model = _carry(jm)
        pred = T.predict(model, golden["Xt_te"], tcfg).numpy()
    else:
        ovr = T.OneVsRestSVM(classes=jm.classes, cfg=tcfg,
                             models={c: _carry(m)
                                     for c, m in jm.models.items()})
        pred = ovr.predict(golden["Xt_te"]).numpy()
        model, jm = ovr.models[jm.classes[0]], jm.models[jm.classes[0]]
    assert tsp.is_sparse(model.sv.x) == (golden["fmt"] == "sparse")
    np.testing.assert_array_equal(pred, golden["jpred"])
    back = convert.to_numpy(model)
    np.testing.assert_array_equal(back.sv.ids, np.asarray(jm.sv.ids))


@pytest.mark.parametrize("fit", ["fit_one_vs_one", "fit_one_vs_rest"])
def test_multiclass_over_sparse_kernel_models_matches_reference(fit):
    """OvO / OvR over the port's blocked-CSR rbf models give the
    reference's predictions on a small 3-class problem. The reference's
    OvO takes dense rows only (it indexes ``np.asarray(X)``), so there
    it trains on the matched dense rows with the dense Pallas Gram."""
    Xd, y, cap = _matched(n=120)
    y3 = np.where(y > 0, 1, np.where(np.arange(120) % 3 == 0, 0, -1))
    kern = dict(name="rbf", gamma=1.0)
    sparse_ref = fit == "fit_one_vs_rest"
    jcfg, _ = _mr_cfgs(kern, *(("pallas_sparse", "sparse_csr", cap)
                               if sparse_ref else ("pallas",)))
    _, tcfg = _mr_cfgs(kern, "pallas_sparse", "sparse_csr", cap)
    jcfg = J.MRSVMConfig(sv_capacity=16, max_rounds=2, svm=jcfg.svm)
    tcfg = T.MRSVMConfig(sv_capacity=16, max_rounds=2, svm=tcfg.svm)
    Xj = jsp.from_dense(jnp.asarray(Xd), cap) if sparse_ref \
        else jnp.asarray(Xd)
    Xs_t = tsp.from_dense(torch.from_numpy(Xd), cap)
    jm = getattr(J, fit)(Xj, jnp.asarray(y3), [-1, 0, 1], 4, jcfg)
    tm = getattr(T, fit)(Xs_t, y3, [-1, 0, 1], 4, tcfg, device="cpu")
    pred = tm.predict(Xs_t)
    assert pred.dtype == torch.int32
    np.testing.assert_array_equal(pred.numpy(), np.asarray(jm.predict(Xj)))
