"""The port's streaming polarization service (``repro_torch.serving.
svm_stream``) and its svm-tfidf serve mode, on the CPU, against the JAX
service and against the port's own ``update_mapreduce``: the same numpy
inputs, and the same initial models (trained by the reference and
carried across by ``convert``), go to both packages.

Tolerances: decision values within the reference's rtol = atol = 1e-4
of the JAX service, SV ids equal. A batched job of the port reads the
rows and parameters ``update_mapreduce`` builds for its stream, so the
two agree to float32 rounding of the plain versions' sums (1e-6, as
``tests/test_torch_sweep.py``), with the same rounds and SV ids."""
import dataclasses
import json
import os
import sys
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
import repro_torch.core as T
from repro import sparse as jsp
from repro.serving import StreamingSVMService as JService
from repro_torch import convert, faults
from repro_torch import sparse as tsp
from repro.launch import cluster as jcluster
from repro_torch.launch import cluster as tcluster
from repro_torch.launch import serve
from repro_torch.launch.cluster import Cluster
from repro_torch.serving import StreamingSVMService
from repro_torch.serving import svm_stream

RTOL = ATOL = 1e-4
L = 4


def _sep_data(seed, n, d=16, w_key=9):
    w = np.random.default_rng(w_key).normal(size=d).astype(np.float32)
    X = np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)
    return X, np.sign(X @ w).astype(np.float32)


def _sparse_data(seed, n, d=16, cap=8, w_key=9):
    """Rows with ``cap`` nonzeros (the largest |x|), blocked-CSR in both
    packages: (JAX rows, port rows, dense rows, labels)."""
    X, _ = _sep_data(seed, n, d, w_key)
    keep = np.argsort(-np.abs(X), axis=1, kind="stable")[:, :cap]
    Xs = np.zeros_like(X)
    np.put_along_axis(Xs, keep, np.take_along_axis(X, keep, 1), 1)
    w = np.random.default_rng(w_key).normal(size=d).astype(np.float32)
    y = np.sign(Xs @ w).astype(np.float32)
    idx = np.sort(keep, axis=1).astype(np.int32)
    vals = np.take_along_axis(Xs, idx, 1)
    return (jsp.SparseRows(jnp.asarray(idx), jnp.asarray(vals), d),
            tsp.SparseRows(torch.from_numpy(idx), torch.from_numpy(vals), d),
            Xs, y)


def _cfgs(**svm):
    kw = dict(sv_capacity=64, gamma=1e-4, max_rounds=3)
    return (J.MRSVMConfig(svm=J.SVMConfig(C=1.0, max_epochs=15, **svm), **kw),
            T.MRSVMConfig(svm=T.SVMConfig(C=1.0, max_epochs=15, **svm), **kw))


@pytest.fixture(scope="module")
def cfgs():
    return _cfgs()


@pytest.fixture(scope="module")
def sparse_cfgs():
    return _cfgs(row_format="sparse_csr", nnz_cap=8)


def _port_model(jm):
    """A model trained by the reference, as the port's (on the CPU)."""
    x = jm.sv.x
    rows = ((np.asarray(x.indices), np.asarray(x.values), x.d)
            if jsp.is_sparse(x) else np.asarray(x))
    sv = (rows,) + tuple(np.asarray(f) for f in jm.sv[1:])
    return convert.mapreduce_model_from_numpy(
        np.asarray(jm.w), np.asarray(jm.b), sv,
        [np.asarray(f) for f in jm.final], np.asarray(jm.risk), jm.rounds)


def _models(jcfg, data):
    """{stream: (JAX model, the same model in the port)}, each trained
    by the reference on its own rows."""
    out = {}
    for s, (Xj, y) in data.items():
        jm = J.fit_mapreduce(Xj, jnp.asarray(y), L, jcfg)
        out[s] = (jm, _port_model(jm))
    return out


def _services(jcfg, tcfg, models, **kw):
    jsvc = JService(jcfg, num_partitions=L, **kw)
    tsvc = StreamingSVMService(tcfg, num_partitions=L, device="cpu", **kw)
    for s, (jm, tm) in models.items():
        jsvc.register(s, jm)
        tsvc.register(s, tm)
    return jsvc, tsvc


def _np(x):
    return np.asarray(x, np.float32)


def _same_as_jax(jsvc, tsvc, streams, Xq_j, Xq_t):
    for s in streams:
        np.testing.assert_allclose(
            convert.to_numpy(tsvc.decision_values(s, Xq_t)),
            _np(jsvc.decision_values(s, Xq_j)), rtol=RTOL, atol=ATOL)
        np.testing.assert_array_equal(
            convert.to_numpy(tsvc.snapshot(s).model.sv.ids),
            np.asarray(jsvc.snapshot(s).model.sv.ids))


def _same_as_update(snap_model, ref):
    """A stream folded in a batched wave ≡ its own update_mapreduce."""
    assert snap_model.rounds == ref.rounds
    assert torch.equal(snap_model.sv.ids, ref.sv.ids)
    for a, b in ((snap_model.w, ref.w), (snap_model.b, ref.b),
                 (snap_model.final.w, ref.final.w),
                 (snap_model.final.b, ref.final.b),
                 (snap_model.final.alpha, ref.final.alpha)):
        torch.testing.assert_close(a.float(), b.float(), rtol=0, atol=1e-6)
    np.testing.assert_allclose([h["risk"] for h in snap_model.history],
                               [h["risk"] for h in ref.history],
                               rtol=0, atol=1e-6)
    assert [h["reducer"] for h in snap_model.history] == \
        [h["reducer"] for h in ref.history]


# ---------------------------------------------------------------------------
# batched waves against the JAX service and the port's update_mapreduce
# ---------------------------------------------------------------------------

def test_batched_wave_matches_reference_and_per_stream_updates(cfgs):
    jcfg, tcfg = cfgs
    init = {s: _sep_data(10 + i, 192, w_key=3 + i)
            for i, s in enumerate("ab")}
    models = _models(jcfg, {s: (jnp.asarray(X), y)
                            for s, (X, y) in init.items()})
    jsvc, tsvc = _services(jcfg, tcfg, models, max_batches_per_wave=2)
    new = {s: _sep_data(20 + i, 128, w_key=3 + i)
           for i, s in enumerate("ab")}
    for s, (X, y) in new.items():
        jsvc.submit(s, jnp.asarray(X), jnp.asarray(y))
        tsvc.submit(s, X, y)
    jst, tst = jsvc.run_wave(), tsvc.run_wave()
    assert tst.batched and jst.batched and tst.streams == 2
    assert tst.rows == 256 and tst.batches == 2
    Xq, _ = _sep_data(60, 256)
    _same_as_jax(jsvc, tsvc, "ab", jnp.asarray(Xq), Xq)
    for s, (X, y) in new.items():
        ref = T.update_mapreduce(models[s][1], X, y, L, tcfg, device="cpu")
        _same_as_update(tsvc.snapshot(s).model, ref)
        assert tsvc.snapshot(s).version == 1


def test_unequal_row_counts_pad_as_the_reference(cfgs):
    """New-row counts 128 and 80: each job is [new; SVs] zero-padded and
    masked to the longest, as the reference lays it out."""
    jcfg, tcfg = cfgs
    init = {s: _sep_data(30 + i, 192, w_key=5 + i)
            for i, s in enumerate("ab")}
    models = _models(jcfg, {s: (jnp.asarray(X), y)
                            for s, (X, y) in init.items()})
    jsvc, tsvc = _services(jcfg, tcfg, models)
    for (s, n), seed in zip((("a", 128), ("b", 80)), (40, 41)):
        X, y = _sep_data(seed, n, w_key=5 + "ab".index(s))
        jsvc.submit(s, jnp.asarray(X), jnp.asarray(y))
        tsvc.submit(s, X, y)
    jsvc.run_wave()
    assert tsvc.run_wave().batched
    Xq, _ = _sep_data(61, 256)
    _same_as_jax(jsvc, tsvc, "ab", jnp.asarray(Xq), Xq)


def test_bucket_padding_keeps_the_real_tenants(cfgs):
    """Three tenants fold at job width 4 with one all-masked job; the
    tenants equal the same wave folded at width 3."""
    _, tcfg = cfgs
    svcs = [StreamingSVMService(tcfg, num_partitions=L, device="cpu",
                                pad_wave_to_bucket=pad)
            for pad in (True, False)]
    assert [svcs[0]._bucket_width(n) for n in (1, 2, 3, 5, 8)] == \
        [1, 2, 4, 8, 8]
    assert svcs[1]._bucket_width(3) == 3
    for i, s in enumerate("abc"):
        m = T.fit_mapreduce(*_sep_data(10 + i, 192, w_key=3 + i), L, tcfg,
                            device="cpu")
        X, y = _sep_data(20 + i, 96, w_key=3 + i)
        for svc in svcs:
            svc.register(s, m)
            svc.submit(s, X, y)
    for svc in svcs:
        st = svc.run_wave()
        assert st.batched and st.streams == 3
    # the padded wave's stack held 4 jobs, the other 3
    assert {k[1][0][0] for k in svcs[0]._fold_signatures} == {4}
    assert {k[1][0][0] for k in svcs[1]._fold_signatures} == {3}
    for s in "abc":
        _same_as_update(svcs[0].snapshot(s).model,
                        svcs[1].snapshot(s).model)


def test_mixed_format_wave_folds_by_group(sparse_cfgs, cfgs):
    """Two blocked-CSR and two dense tenants in one wave: one sweep a
    format group, each against the JAX service."""
    jcfg, tcfg = sparse_cfgs
    jdense = cfgs[0]
    sp = {s: _sparse_data(6 + i, 192, w_key=3 + i)
          for i, s in enumerate(("sp0", "sp1"))}
    de = {s: _sep_data(8 + i, 192, w_key=5 + i)
          for i, s in enumerate(("de0", "de1"))}
    models = _models(jcfg, {s: (v[0], v[3]) for s, v in sp.items()})
    models.update(_models(jdense, {s: (jnp.asarray(X), y)
                                   for s, (X, y) in de.items()}))
    jsvc, tsvc = _services(jcfg, tcfg, models)
    for i, s in enumerate(sp):
        Xj, Xt, _, y = _sparse_data(16 + i, 96, w_key=3 + i)
        jsvc.submit(s, Xj, jnp.asarray(y))
        tsvc.submit(s, Xt, y)
    for i, s in enumerate(de):
        X, y = _sep_data(17 + i, 96, w_key=5 + i)
        jsvc.submit(s, jnp.asarray(X), jnp.asarray(y))
        tsvc.submit(s, X, y)
    jsvc.run_wave()
    st = tsvc.run_wave()
    assert st.batched and st.streams == 4 and st.rows == 384
    assert {k[0] for k in tsvc._fold_signatures} == {"batched"}
    assert len(tsvc._fold_signatures) == 2        # one sweep a group
    assert tsp.is_sparse(tsvc.snapshot("sp0").model.sv.x)
    Xj, Xt, _, _ = _sparse_data(53, 128)
    _same_as_jax(jsvc, tsvc, sp, Xj, Xt)
    Xq, _ = _sep_data(62, 128)
    _same_as_jax(jsvc, tsvc, de, jnp.asarray(Xq), Xq)
    with pytest.raises(ValueError, match="row format"):
        tsvc.submit("de0", Xt, np.ones(128, np.float32))


def test_drift_fold_beats_the_stale_model(cfgs):
    """The reference's drift scenario on the port: one tenant, two
    micro-batches of a rotated separator in one wave."""
    _, tcfg = cfgs
    svc = StreamingSVMService(tcfg, num_partitions=L, device="cpu")
    svc.register("t", T.fit_mapreduce(*_sep_data(1, 320, w_key=7), L, tcfg,
                                      device="cpu"))
    rng = np.random.default_rng(8)
    w_old = np.random.default_rng(7).normal(size=16)
    w_new = (w_old + 0.8 * rng.normal(size=16)).astype(np.float32)
    X2 = np.random.default_rng(2).normal(size=(320, 16)).astype(np.float32)
    y2 = np.sign(X2 @ w_new).astype(np.float32)
    yt = torch.from_numpy(y2)
    stale = float((svc.predict("t", X2) == yt).float().mean())
    svc.submit("t", X2[:160], y2[:160])
    svc.submit("t", X2[160:], y2[160:])
    st = svc.run_wave()
    assert st is not None and st.batches == 2 and st.rows == 320
    assert not st.batched
    folded = float((svc.predict("t", X2) == yt).float().mean())
    assert folded > 0.8 and folded > stale + 0.05
    assert svc.snapshot("t").version == 1


def test_sequential_folds_hold_to_the_reference_output(cfgs):
    """The port's counterpart of the reference's red
    ``test_sequential_folds_match_union_update``: three folds one at a
    time and one fold of their union, from the same start, each equal
    to what the reference computes on the same inputs (not held to the
    red test's thresholds)."""
    jcfg, tcfg = cfgs
    X0, y0 = _sep_data(0, 256)
    jm0 = J.fit_mapreduce(jnp.asarray(X0), jnp.asarray(y0), L, jcfg)
    tm0 = _port_model(jm0)
    batches = [_sep_data(i + 1, 96) for i in range(3)]
    jseq, tseq = jm0, tm0
    for X, y in batches:
        jseq = J.update_mapreduce(jseq, jnp.asarray(X), jnp.asarray(y), L,
                                  jcfg)
        tseq = T.update_mapreduce(tseq, X, y, L, tcfg, device="cpu")
    Xu = np.concatenate([b[0] for b in batches])
    yu = np.concatenate([b[1] for b in batches])
    jone = J.update_mapreduce(jm0, jnp.asarray(Xu), jnp.asarray(yu), L, jcfg)
    tone = T.update_mapreduce(tm0, Xu, yu, L, tcfg, device="cpu")
    Xt, _ = _sep_data(50, 400)
    for jm, tm in ((jseq, tseq), (jone, tone)):
        assert tm.rounds == jm.rounds
        assert tuple(tm.sv.x.shape) == (64, 16)
        np.testing.assert_array_equal(convert.to_numpy(tm.sv.ids),
                                      np.asarray(jm.sv.ids))
        np.testing.assert_allclose(
            convert.to_numpy(T.decision_values(tm, Xt, tcfg, device="cpu")),
            _np(J.decision_values(jm, jnp.asarray(Xt), jcfg)),
            rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# admission control, quarantine, submit checks
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def port_model(cfgs):
    return T.fit_mapreduce(*_sep_data(0, 256), L, cfgs[1], device="cpu")


def test_queue_cap_sheds_oldest_or_rejects(cfgs, port_model):
    tcfg = cfgs[1]
    svc = StreamingSVMService(tcfg, num_partitions=L, device="cpu",
                              max_queue_per_stream=2)
    svc.register("t", port_model)
    uids = [svc.submit("t", *_sep_data(i + 1, 32)) for i in range(3)]
    assert svc.pending() == 2                    # oldest shed, not grown
    assert [mb.uid for mb in svc._queues["t"]] == uids[1:]
    assert svc.shed[0].uid == uids[0] and svc.shed[0].X is None
    assert svc.throughput_report()["shed"] == 1

    rej = StreamingSVMService(tcfg, num_partitions=L, device="cpu",
                              max_queue_per_stream=1, shed_policy="reject")
    rej.register("t", port_model)
    first = rej.submit("t", *_sep_data(4, 32))
    with pytest.raises(RuntimeError, match="admission control"):
        rej.submit("t", *_sep_data(5, 32))
    assert rej.pending() == 1
    rej.run_wave()
    assert rej.submit("t", *_sep_data(6, 32)) == first + 1
    with pytest.raises(ValueError, match="shed_policy"):
        StreamingSVMService(tcfg, shed_policy="drop_newest", device="cpu")


def test_wave_width_bound_admits_oldest_first(cfgs, port_model):
    svc = StreamingSVMService(cfgs[1], num_partitions=L, device="cpu",
                              max_streams_per_wave=2, slo_s=0.0)
    for i, s in enumerate("cab"):            # c's batch is the oldest
        svc.register(s, port_model)
        svc.submit(s, *_sep_data(20 + i, 64))
    st = svc.run_wave()
    assert st.streams == 2 and st.batched
    assert svc.snapshot("c").version == 1 and svc.snapshot("a").version == 1
    assert svc.snapshot("b").version == 0        # width-bounded out
    st2 = svc.run_wave()
    assert st2.streams == 1 and not st2.batched
    assert svc.snapshot("b").version == 1
    rep = svc.throughput_report()
    assert rep["slo_violations"] == 3 and rep["batches"] == 3
    assert rep["waves"] == 2 and rep["rows"] == 192


@pytest.mark.parametrize("where", ["X", "y", "sparse"])
def test_non_finite_batch_is_quarantined(cfgs, sparse_cfgs, port_model,
                                         where):
    if where == "sparse":
        tcfg = sparse_cfgs[1]
        _, Xt, Xd, y = _sparse_data(3, 64)
        model = T.fit_mapreduce(Xt, y, L, tcfg, device="cpu")
        bad_X = tsp.SparseRows(Xt.indices, Xt.values.clone(), Xt.d)
        bad_X.values[5, 2] = float("nan")
        bad_y = y
    else:
        tcfg, model = cfgs[1], port_model
        bad_X, bad_y = _sep_data(3, 64)
        if where == "X":
            bad_X[7, 3] = np.inf
        else:
            bad_y = bad_y.copy()
            bad_y[0] = np.nan
    svc = StreamingSVMService(tcfg, num_partitions=L, device="cpu")
    svc.register("t", model)
    uid = svc.submit("t", bad_X, bad_y)
    assert uid == 1 and svc.pending() == 0
    assert svc.throughput_report()["quarantined"] == 1
    assert svc.run_wave() is None and svc.snapshot("t").version == 0
    off = StreamingSVMService(tcfg, num_partitions=L, device="cpu",
                              quarantine=False)
    off.register("t", model)
    off.submit("t", bad_X, bad_y)
    assert off.pending() == 1 and not off.quarantined


def test_submit_rejects_wrong_d_format_nnz_cap_or_ids(cfgs, sparse_cfgs,
                                                      port_model):
    svc = StreamingSVMService(cfgs[1], num_partitions=L, device="cpu")
    svc.register("t", port_model)
    with pytest.raises(ValueError, match="featurizer"):
        svc.submit("t", np.ones((16, 9), np.float32), np.ones(16))
    with pytest.raises(ValueError, match="row format"):
        svc.submit("t", _sparse_data(4, 16)[1], np.ones(16))
    with pytest.raises(ValueError, match=r"\(n, d\)"):
        svc.submit("t", np.ones((16, 16), np.float32), np.ones(15))
    with pytest.raises(KeyError, match="unregistered"):
        svc.submit("nope", *_sep_data(1, 8))
    _, Xt, _, y = _sparse_data(3, 64)
    sp = StreamingSVMService(sparse_cfgs[1], num_partitions=L, device="cpu")
    sp.register("s", T.fit_mapreduce(Xt, y, L, sparse_cfgs[1],
                                     device="cpu"))
    with pytest.raises(ValueError, match="nnz_cap"):
        sp.submit("s", tsp.from_dense(torch.ones((4, 16)), 4), np.ones(4))
    with pytest.raises(ValueError, match="row format"):
        sp.submit("s", *_sep_data(1, 8))
    bad = tsp.SparseRows(Xt.indices.clone(), Xt.values, Xt.d)
    bad.indices[0, 0] = 16
    with pytest.raises(ValueError, match="column ids"):
        sp.submit("s", bad, y)
    assert sp.pending() == 0
    sp.submit("s", *_sparse_data(5, 32)[1:4:2])
    assert sp._queues["s"][0].X.ids_in_range


# ---------------------------------------------------------------------------
# failures mid-wave and of the scheduler
# ---------------------------------------------------------------------------

def test_mid_wave_failure_requeues_all_unswapped(cfgs, port_model,
                                                 monkeypatch):
    svc = StreamingSVMService(cfgs[1], num_partitions=L, device="cpu")
    for i, s in enumerate("ab"):
        svc.register(s, port_model)
        svc.submit(s, *_sep_data(20 + i, 96))

    def boom(*a, **k):
        raise RuntimeError("worker lost mid-wave")
    monkeypatch.setattr(svm_stream, "fit_mapreduce_sweep", boom)
    with pytest.raises(RuntimeError, match="worker lost"):
        svc.run_wave()
    assert svc.pending() == 2                    # requeued, rows pinned
    for s in "ab":
        assert svc.snapshot(s).version == 0
        assert svc._queues[s][0].X is not None
    monkeypatch.undo()
    st = svc.run_wave()
    assert st.streams == 2 and st.batches == 2
    assert svc.pending() == 0 and len(svc.done) == 2
    assert all(svc.snapshot(s).version == 1 for s in "ab")
    assert svc.throughput_report()["requeued"] == 2


def test_mid_wave_failure_completes_swapped_streams(cfgs, monkeypatch):
    """Two singleton fold groups (d 16, then d 24): the first swaps, the
    second dies; only its batch is requeued."""
    tcfg = cfgs[1]
    svc = StreamingSVMService(tcfg, num_partitions=L, device="cpu")
    for s, d, seed in (("lo", 16, 1), ("hi", 24, 2)):
        svc.register(s, T.fit_mapreduce(*_sep_data(seed, 192, d=d), L,
                                        tcfg, device="cpu"))
        svc.submit(s, *_sep_data(20 + seed, 96, d=d))
    real = svm_stream.update_mapreduce

    def die_on_hi(model, *a, **k):
        if model.sv.x.shape[1] == 24:
            raise RuntimeError("worker lost mid-wave")
        return real(model, *a, **k)
    monkeypatch.setattr(svm_stream, "update_mapreduce", die_on_hi)
    with pytest.raises(RuntimeError, match="worker lost"):
        svc.run_wave()
    assert svc.snapshot("lo").version == 1       # published before loss
    assert svc.snapshot("hi").version == 0
    assert svc.pending() == 1 and len(svc.done) == 1
    monkeypatch.undo()
    st = svc.run_wave()
    assert st.streams == 1 and svc.snapshot("hi").version == 1


def test_dead_scheduler_surfaces_in_submit_wait_idle_and_stop():
    """sv_capacity 36 does not divide 8 partitions: the first fold raises
    in the scheduler thread."""
    bad = T.MRSVMConfig(sv_capacity=36, max_rounds=2,
                        svm=T.SVMConfig(C=1.0, max_epochs=5))
    X0, y0 = _sep_data(9, 128)
    svc = StreamingSVMService(bad, num_partitions=8, device="cpu")
    svc.register("t", T.fit_mapreduce(X0, y0, 4, bad, device="cpu"))
    svc.start(idle_poll_s=0.005)
    svc.submit("t", X0, y0)
    with pytest.raises(RuntimeError, match="scheduler died"):
        svc.wait_idle(timeout_s=60)
    assert isinstance(svc.scheduler_error, ValueError)
    with pytest.raises(RuntimeError, match="scheduler died"):
        svc.submit("t", X0, y0)
    with pytest.raises(RuntimeError, match="scheduler died"):
        svc.stop()
    idle = StreamingSVMService(bad, num_partitions=4, device="cpu")
    idle.register("t", T.fit_mapreduce(X0, y0, 4, bad, device="cpu"))
    idle.submit("t", X0, y0)
    with pytest.raises(RuntimeError, match="no scheduler is running"):
        idle.wait_idle(timeout_s=5)


def test_versions_rise_by_one_a_swap_under_interleaved_readers(cfgs,
                                                                port_model):
    """Readers racing the background scheduler each see the predictions
    of exactly one published version (three reader threads and a short
    switch interval, so that reads land all through the folds)."""
    tcfg = cfgs[1]
    svc = StreamingSVMService(tcfg, num_partitions=L, device="cpu",
                              max_batches_per_wave=1, keep_history=True)
    svc.register("t", port_model)
    Xq, _ = _sep_data(77, 64)
    seen, errors = [], []
    stop = threading.Event()

    def reader():
        try:
            while not stop.is_set():
                pred, ver = svc.predict("t", Xq, with_version=True)
                seen.append((ver, pred.numpy().copy()))
                time.sleep(0.001)
        except Exception as e:                    # pragma: no cover
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-4)
    try:
        threads = [threading.Thread(target=reader) for _ in range(3)]
        for th in threads:
            th.start()
        svc.start(idle_poll_s=0.005)
        for i in range(3):
            svc.submit("t", *_sep_data(100 + i, 96))
        assert svc.wait_idle(timeout_s=120)
        stop.set()
        svc.stop()
        for th in threads:
            th.join(timeout=30)
            assert not th.is_alive()
    finally:
        stop.set()
        sys.setswitchinterval(interval)
    assert not errors
    history = svc.history("t")
    assert sorted(history) == [0, 1, 2, 3]
    assert svc.snapshot("t").version == 3 and len(svc.stats) == 3
    expected = {v: T.predict(snap.model, Xq, tcfg, device="cpu").numpy()
                for v, snap in history.items()}
    assert len({ver for ver, _ in seen}) > 1     # reads across swaps
    for ver, pred in seen:
        np.testing.assert_array_equal(pred, expected[ver])


# ---------------------------------------------------------------------------
# what is left out, and the serve mode
# ---------------------------------------------------------------------------

_FIRES = []


@pytest.mark.parametrize("kw,item", [
    (dict(checkpoint_dir="ck"), 9),
    (dict(checkpoint_every_waves=2), 9), (dict(checkpoint_keep=1), 9),
    (dict(fold_deadline_s=1.0), 9), (dict(heartbeat_path="hb.json"), 9),
    (dict(watchdog_handler=_FIRES.append), 9),
    (dict(fail_on_retrace=True), 12),
    (dict(cluster=Cluster(process_index=1, process_count=2)), 10),
    (dict(shuffle_impl="ring"), 7)])
def test_left_out_arguments_raise_naming_their_item(cfgs, kw, item,
                                                    tmp_path):
    """The arguments of item 9 (checkpoints and the fold watchdog), item
    7 (``shuffle_impl``), item 10 (``cluster``) and item 12
    (``fail_on_retrace``), all ported, are accepted and take effect: the
    transport replaces the config's, as the reference's service takes
    it; on a process other than 0 the service refuses admission with the
    reference's message; under the retrace guard both services fold two
    waves of one shape with one fold program and no retrace."""
    if item == 12:
        Xr, yr = _sep_data(0, 96)
        models = _models(cfgs[0], {"t": (jnp.asarray(Xr), yr)})
        jsvc, tsvc = _services(cfgs[0], cfgs[1], models, **kw)
        for seed in (1, 2):
            X, y = _sep_data(seed, 64)
            jsvc.submit("t", jnp.asarray(X), jnp.asarray(y))
            tsvc.submit("t", X, y)
            jsvc.run_wave()
            tsvc.run_wave()
        jr, tr = jsvc.throughput_report(), tsvc.throughput_report()
        assert tr["retraces"] == jr["retraces"] == 0
        assert tr["fold_programs"] == jr["fold_programs"] == 1
        _same_as_jax(jsvc, tsvc, ["t"], jnp.asarray(Xr),
                     torch.from_numpy(Xr))
        return
    if item == 10:
        svc = StreamingSVMService(cfgs[1], device="cpu", **kw)
        jsvc = JService(cfgs[0], cluster=jcluster.Cluster(
            process_index=1, process_count=2))
        X, y = _sep_data(0, 64)
        with pytest.raises(RuntimeError) as te:
            svc.submit("t", X, y)
        with pytest.raises(RuntimeError) as je:
            jsvc.submit("t", jnp.asarray(X), jnp.asarray(y))
        assert str(te.value) == str(je.value)
        assert svc.run_wave() is None and jsvc.run_wave() is None
        return
    if item == 7:
        svc = StreamingSVMService(cfgs[1], device="cpu", **kw)
        want = JService(cfgs[0], **kw).cfg
        assert svc.cfg.shuffle_impl == want.shuffle_impl == "ring"
        assert dataclasses.asdict(svc.cfg) == dataclasses.asdict(want)
        return
    name = next(iter(kw))
    # every item-9 argument is exercised beside what it needs to act
    ck = str(tmp_path / "ck")
    extra = {"checkpoint_dir": {},
             "checkpoint_every_waves": {"checkpoint_dir": ck},
             "checkpoint_keep": {"checkpoint_dir": ck},
             "fold_deadline_s": {"watchdog_handler": _FIRES.append},
             "heartbeat_path": {"fold_deadline_s": 60.0},
             "watchdog_handler": {"fold_deadline_s": 1.0}}[name]
    kw = {k: str(tmp_path / v) if k in ("checkpoint_dir", "heartbeat_path")
          else v for k, v in kw.items()}
    svc = StreamingSVMService(cfgs[1], num_partitions=L, device="cpu",
                              **kw, **extra)
    X0, y0 = _sep_data(0, 128)
    svc.register("t", T.fit_mapreduce(X0, y0, L, cfgs[1], device="cpu"))
    _FIRES.clear()
    if name in ("fold_deadline_s", "watchdog_handler"):
        # a stalled fold trips the deadline; the fold still publishes
        svc.submit("t", *_sep_data(1, 64))
        with faults.inject(faults.FaultPlan.single("stall", 0)):
            with pytest.raises(faults.FaultDetected, match="wave 0 fold"):
                svc.run_wave()
        assert svc.snapshot("t").version == 1 and svc.pending() == 0
        assert len(_FIRES) == 1 and _FIRES[0]["layer"] == "serving"
        assert svc.throughput_report()["watchdog_fires"] == 1
        return
    for wave in (1, 2):
        svc.submit("t", *_sep_data(wave, 64))
        assert svc.run_wave() is not None
    assert svc.snapshot("t").version == 2
    man = (json.load(open(os.path.join(ck, "service_manifest.json")))
           if os.path.isdir(ck) else {})
    gens = [g["generation"] for g in man.get("generations", [])]
    files = sorted(os.listdir(ck)) if os.path.isdir(ck) else []
    if name == "checkpoint_dir":
        # register, then each wave; the default keeps all three
        assert gens == [0, 1, 2]
        r = StreamingSVMService.restore(cfgs[1], ck, device="cpu")
        assert r.snapshot("t").version == 2
    elif name == "checkpoint_every_waves":
        assert gens == [0, 1]                 # register, then wave 2 only
    elif name == "checkpoint_keep":
        assert files == ["gen000002_stream0.npz", "service_manifest.json"]
    else:
        hb = json.load(open(kw["heartbeat_path"]))
        assert hb["status"] == "alive" and hb["cause"] == "wave 1 fold"


def test_left_out_methods_and_flags_raise_naming_their_item(cfgs, tmp_path,
                                                            capsys,
                                                            monkeypatch):
    """checkpoint() and restore() are ported (ROADMAP Queue 1 item 9), as
    are the serve mode's checkpoint and watchdog flags: a smoke run with
    them, then one restored from its directory. ``--shuffle`` (item 7) is
    ported too: ``--shuffle hier`` sets the transport and the simulated
    host count of the 8 partitions, as the reference's launcher does. So
    are the cluster flags (item 10): an incomplete triple raises the
    reference's error before any side effect (the 2-process serve runs
    in ``tests/test_torch_launch_cluster.py``)."""
    svc = StreamingSVMService(cfgs[1], device="cpu")
    with pytest.raises(RuntimeError, match="without checkpoint_dir"):
        svc.checkpoint()
    with pytest.raises(FileNotFoundError, match="no service manifest"):
        StreamingSVMService.restore(cfgs[1], str(tmp_path / "none"))
    base = ["--arch", "svm-tfidf", "--smoke", "--device", "cpu",
            "--streams", "2", "--checkpoint-dir", str(tmp_path / "ck")]
    first = serve.main(base + ["--waves", "1", "--checkpoint-every", "1",
                               "--checkpoint-keep", "2",
                               "--fold-deadline", "120",
                               "--heartbeat", str(tmp_path / "hb.json"),
                               "--shuffle", "hier"])
    assert first.service.fold_deadline_s == 120.0
    assert first.cfg.shuffle_impl == "hier" and first.cfg.hier_num_hosts == 2
    assert json.load(open(tmp_path / "hb.json"))["status"] == "alive"
    again = serve.main(base + ["--waves", "1", "--restore"])
    out = capsys.readouterr().out
    assert "restored 2 streams" in out and out.count("folded acc=") == 2
    for s in range(2):
        a = first.service.snapshot(f"stream{s}")
        b = again.service.snapshot(f"stream{s}")
        assert b.version == a.version + 1
    with pytest.raises(SystemExit, match="--restore requires"):
        serve.main(["--arch", "svm-tfidf", "--smoke", "--device", "cpu",
                    "--restore"])
    def boom(*a, **k):
        raise AssertionError("a side effect before the triple was checked")
    monkeypatch.setattr(torch.distributed, "TCPStore", boom)
    for flags in (["--coordinator", "localhost:1"], ["--num-processes", "2"],
                  ["--coordinator", "localhost:1", "--process-id", "0"]):
        monkeypatch.setattr(tcluster, "_CLUSTER", None)
        with pytest.raises(ValueError, match="full triple"):
            serve.main(base + flags)


def test_serve_main_svm_smoke_runs_in_process(capsys):
    res = serve.main(["--arch", "svm-tfidf", "--smoke", "--streams", "2",
                      "--waves", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.count("folded acc=") == 2, out
    assert "'batches': 4" in out
    svc = res.service
    # the scheduler folds what has queued when it wakes, as the
    # reference's: a wave's first stream may fold alone
    assert sum(st.streams for st in svc.stats) == 4
    assert all(st.batched == (st.streams > 1) for st in svc.stats)
    assert [svc.snapshot(f"stream{s}").version for s in range(2)] == [2, 2]
    assert res.cfg.svm.max_epochs == 10 and res.cfg.max_rounds == 3
    for stale, fresh in zip(res.stale, res.fresh):
        assert sum(fresh) > sum(stale)           # folding adapted
    rep = svc.throughput_report()
    assert rep["rows"] == 1024
    assert rep["fold_programs"] == len({st.batched for st in svc.stats})


def test_stream_batch_drifts_and_is_seeded():
    X, y = serve.stream_batch(1, 2, 64, 16, torch.float32, "cpu")
    X2, y2 = serve.stream_batch(1, 2, 64, 16, torch.float32, "cpu")
    assert torch.equal(X, X2) and torch.equal(y, y2)
    assert tuple(X.shape) == (64, 16) and set(y.tolist()) <= {-1.0, 1.0}
    w0 = torch.randn(16, generator=torch.Generator().manual_seed(1))
    wd = torch.randn(16, generator=torch.Generator().manual_seed(501))
    assert torch.equal(y, torch.sign(X @ (w0 + 0.8 * wd)))
