"""The port's core (risk, kernels, configs, the MapReduce round and
driver) against the JAX reference: the same numpy inputs go to both."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
import repro_torch.core as T
from repro_torch import convert

TOL_CFG = dict(sv_capacity=64, gamma=1e-4, max_rounds=4)


def _data(n=600, d=48, seed=0, noise=0.3):
    """Nonnegative L2-normalized rows, noisy linear labels."""
    rng = np.random.default_rng(seed)
    X = rng.random((n, d), dtype=np.float32) * (rng.random((n, d)) < 0.3)
    X = (X / np.maximum(np.linalg.norm(X, axis=1, keepdims=True), 1e-9)
         ).astype(np.float32)
    w = rng.normal(size=d).astype(np.float32)
    s = X @ w - np.median(X @ w) + noise * rng.normal(size=n)
    return X, np.where(s >= 0, 1.0, -1.0).astype(np.float32)


@pytest.mark.parametrize("loss", ["hinge", "zero_one"])
@pytest.mark.parametrize("with_mask", [False, True])
def test_empirical_risk_matches_reference(loss, with_mask):
    rng = np.random.default_rng(1)
    s = rng.normal(size=257).astype(np.float32)
    s[:5] = 0.0                                   # score 0 predicts +1
    y = np.sign(rng.normal(size=257)).astype(np.float32)
    m = (rng.random(257) > 0.3).astype(np.float32) if with_mask else None
    r_t = T.empirical_risk(torch.from_numpy(s), torch.from_numpy(y),
                           None if m is None else torch.from_numpy(m), loss)
    r_j = J.empirical_risk(jnp.asarray(s), jnp.asarray(y),
                           None if m is None else jnp.asarray(m), loss)
    assert float(r_t) == pytest.approx(float(r_j), rel=1e-6)
    np.testing.assert_array_equal(
        T.zero_one_loss(torch.from_numpy(s), torch.from_numpy(y)).numpy(),
        np.asarray(J.zero_one_loss(jnp.asarray(s), jnp.asarray(y))))
    assert T.converged(0.5, 0.5 + 1e-4, 1e-3) == bool(
        J.converged(0.5, 0.5 + 1e-4, 1e-3))


def test_empirical_risk_with_empty_mask_is_zero_not_nan():
    r = T.empirical_risk(torch.ones(4), torch.ones(4), torch.zeros(4))
    assert float(r) == 0.0


@pytest.mark.parametrize("name", ["linear", "rbf", "poly"])
def test_apply_kernel_matches_reference(name):
    rng = np.random.default_rng(2)
    X = rng.normal(size=(13, 7)).astype(np.float32)
    Z = rng.normal(size=(9, 7)).astype(np.float32)
    K_t = T.apply_kernel(torch.from_numpy(X), torch.from_numpy(Z),
                         cfg=T.KernelConfig(name, gamma=0.3, degree=2,
                                            coef0=0.5))
    K_j = J.apply_kernel(jnp.asarray(X), jnp.asarray(Z),
                         cfg=J.KernelConfig(name, gamma=0.3, degree=2,
                                            coef0=0.5))
    np.testing.assert_allclose(K_t.numpy(), np.asarray(K_j), rtol=1e-5,
                               atol=1e-5)


def test_sparse_operands_and_gram_path_wait_for_a_later_slice():
    """Sparse rows run on the linear, non-Gram path (the
    ``cd_solve/sparse`` and ``hinge_scores/sparse`` routes) and equal
    the dense result on the same rows; the Gram path takes them too.
    (The name is from when the linear path refused sparse rows; it is
    kept so that the test's record carries across that change.)"""
    from repro_torch import sparse as tsp
    X = tsp.from_dense(torch.eye(4), 2)
    y = torch.tensor([1.0, -1.0, 1.0, -1.0])
    sp = T.fit_binary(X, y, cfg=T.SVMConfig())
    de = T.fit_binary(torch.eye(4), y, cfg=T.SVMConfig())
    for a, b in zip(sp, de):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=0)
    cfg = T.MRSVMConfig(sv_capacity=2)
    ms, md = (T.fit_mapreduce(rows, y, 2, cfg) for rows in (X, torch.eye(4)))
    assert float(ms.risk) == pytest.approx(float(md.risk), abs=1e-6)
    assert torch.equal(ms.sv.ids, md.sv.ids)
    torch.testing.assert_close(tsp.to_dense(ms.sv.x), md.sv.x)
    torch.testing.assert_close(
        T.decision_linear(torch.arange(4.0), torch.ones(()), X),
        T.decision_linear(torch.arange(4.0), torch.ones(()), torch.eye(4)))
    K = T.apply_kernel(X, X, cfg=T.KernelConfig("rbf"))
    torch.testing.assert_close(K, T.apply_kernel(torch.eye(4), torch.eye(4),
                                                 cfg=T.KernelConfig("rbf")))
    res = T.fit_binary(X, y, cfg=T.SVMConfig(kernel=T.KernelConfig("rbf")))
    assert res.alpha.shape == (4,) and not res.w.any()


SVM_BAD = [dict(row_format="csr"), dict(gram_impl="triton"),
           dict(row_format="sparse_csr"),
           dict(gram_impl="pallas_sparse"),
           dict(gram_impl="pallas", row_format="sparse_csr", nnz_cap=4)]
MR_BAD = [dict(shuffle_impl="tree"), dict(converge_impl="ring"),
          dict(hier_num_hosts=0), dict(shuffle_wire_dtype="int8"),
          dict(shuffle_wire_dtype="float64")]


@pytest.mark.parametrize("kw", SVM_BAD + [{}], ids=str)
def test_svm_config_validation_matches_reference(kw):
    try:
        J.SVMConfig(**kw)
    except ValueError:
        with pytest.raises(ValueError):
            T.SVMConfig(**kw)
    else:
        assert kw == {}
        assert tuple(T.SVMConfig(**kw).params()) == pytest.approx(
            tuple(float(v) for v in J.SVMConfig(**kw).params()))


@pytest.mark.parametrize("kw", MR_BAD + [dict(shuffle_wire_dtype="float16"),
                                         dict(shuffle_impl="hier")], ids=str)
def test_mrsvm_config_validation_matches_reference(kw):
    try:
        J.MRSVMConfig(**kw)
    except ValueError:
        with pytest.raises(ValueError):
            T.MRSVMConfig(**kw)
    else:
        T.MRSVMConfig(**kw)


def _partitions(X, y, L):
    n, d = X.shape
    per = n // L
    return (X.reshape(L, per, d), y.reshape(L, per),
            np.ones((L, per), np.float32))


def test_round_from_a_shared_sv_buffer_matches_reference():
    """A JAX round's SV_global, carried across with convert.py, seeds
    one round in both packages."""
    X, y = _data()
    L = 8
    Xp, yp, mp = _partitions(X, y, L)
    jcfg = J.MRSVMConfig(svm=J.SVMConfig(max_epochs=10), **TOL_CFG)
    tcfg = T.MRSVMConfig(svm=T.SVMConfig(max_epochs=10), **TOL_CFG)
    jargs = tuple(jnp.asarray(a) for a in (Xp, yp, mp))
    sv0 = J.init_sv_buffer(64, X.shape[1])
    sv1 = J.mapreduce_round(*jargs, sv0, jcfg).sv
    ref = J.mapreduce_round(*jargs, sv1, jcfg)

    sv1_t = convert.sv_buffer_from_numpy(*(np.asarray(f) for f in sv1))
    out = T.mapreduce_round(*(torch.from_numpy(a) for a in (Xp, yp, mp)),
                            sv1_t, tcfg)
    np.testing.assert_array_equal(out.sv.ids.numpy(), np.asarray(ref.sv.ids))
    np.testing.assert_array_equal(out.sv.mask.numpy(),
                                  np.asarray(ref.sv.mask))
    np.testing.assert_array_equal(out.sv.x.numpy(), np.asarray(ref.sv.x))
    np.testing.assert_allclose(out.sv.alpha.numpy(), np.asarray(ref.sv.alpha),
                               atol=1e-5)
    np.testing.assert_allclose(out.risks.numpy(), np.asarray(ref.risks),
                               atol=1e-5)
    np.testing.assert_allclose(out.ws.numpy(), np.asarray(ref.ws), atol=1e-5)
    np.testing.assert_allclose(out.bs.numpy(), np.asarray(ref.bs), atol=1e-5)
    assert float(out.sv_count) == float(ref.sv_count)


@pytest.mark.parametrize("risk_loss", ["hinge", "zero_one"])
def test_fit_mapreduce_matches_reference_round_for_round(risk_loss):
    X, y = _data(n=596, seed=3)              # 596 rows: the last partition pads
    jcfg = J.MRSVMConfig(svm=J.SVMConfig(max_epochs=10), risk_loss=risk_loss,
                         **TOL_CFG)
    tcfg = T.MRSVMConfig(svm=T.SVMConfig(max_epochs=10), risk_loss=risk_loss,
                         **TOL_CFG)
    jm = J.fit_mapreduce(jnp.asarray(X), jnp.asarray(y), 8, jcfg)
    tm = T.fit_mapreduce(X, y, 8, tcfg, device="cpu")
    assert tm.rounds == jm.rounds
    for ht, hj in zip(tm.history, jm.history, strict=True):
        assert (ht["round"], ht["reducer"], ht["sv_count"]) == \
            (hj["round"], hj["reducer"], hj["sv_count"])
        assert ht["risk"] == pytest.approx(hj["risk"], abs=1e-4)
    np.testing.assert_array_equal(tm.sv.ids.numpy(), np.asarray(jm.sv.ids))
    np.testing.assert_allclose(tm.final.w.numpy(), np.asarray(jm.final.w),
                               atol=1e-4)
    assert float(tm.final.b) == pytest.approx(float(jm.final.b), abs=1e-4)
    np.testing.assert_array_equal(
        T.predict(tm, X, tcfg, device="cpu").numpy(),
        np.asarray(J.predict(jm, jnp.asarray(X), jcfg)))


def test_bf16_rows_keep_f32_solver_state():
    X, y = _data(n=256, d=32, seed=5)
    Xb = torch.from_numpy(X).to(torch.bfloat16)
    m = T.fit_mapreduce(Xb, torch.from_numpy(y), 4,
                        T.MRSVMConfig(sv_capacity=32, max_rounds=2))
    assert m.sv.x.dtype == torch.bfloat16 and m.sv.mask.dtype == torch.bfloat16
    assert m.final.w.dtype == m.final.alpha.dtype == torch.float32
    assert m.w.dtype == torch.float32


def test_one_vs_one_and_rest_predict_known_classes():
    X, y = _data(n=240, seed=7)
    y3 = np.where(y > 0, 1, np.where(np.arange(240) % 3 == 0, 0, -1))
    cfg = T.MRSVMConfig(sv_capacity=16, max_rounds=2,
                        svm=T.SVMConfig(max_epochs=3))
    for fit in (T.fit_one_vs_one, T.fit_one_vs_rest):
        model = fit(X, y3, [-1, 0, 1], 4, cfg, device="cpu")
        pred = model.predict(torch.from_numpy(X))
        assert pred.dtype == torch.int32 and pred.shape == (240,)
        assert set(pred.unique().tolist()) <= {-1, 0, 1}


@pytest.mark.parametrize("normalize", ["all", "true"])
def test_confusion_matrix_matches_reference(normalize):
    rng = np.random.default_rng(4)
    yt = rng.integers(-1, 2, 50)
    yp = rng.integers(-1, 2, 50)
    np.testing.assert_allclose(
        T.confusion_matrix(torch.from_numpy(yt), yp, [-1, 0, 1], normalize),
        J.confusion_matrix(jnp.asarray(yt), jnp.asarray(yp), [-1, 0, 1],
                           normalize))
    with pytest.raises(ValueError):
        T.confusion_matrix(yt, yp, [-1, 0, 1], "rows")
