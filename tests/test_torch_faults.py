"""The port's fault vocabulary and seams (``repro_torch.faults``), on the
CPU, against the JAX package's (``repro.faults``): the same seeds give
the same plans and draws, the same numpy inputs with a NaN feature make
both packages raise ``FaultDetected("core")`` at the same round, and the
plain solve and hinge let NaN through as the reference does (the same
NaN/finite pattern and epochs; finite entries within 1e-5, as
``tests/test_torch_kernels.py`` holds the finite solve). The chaos
scenarios run here on the plain versions."""
import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
import repro_torch.core as T
from repro import faults as jfaults
from repro import sparse as jsp
from repro.core.svm import SVMConfig as JSVMConfig
from repro.core.svm import fit_binary_linear as j_fit_binary_linear
from repro.kernels import ref as jref
from repro.serving import StreamingSVMService as JService
from repro_torch import faults
from repro_torch import sparse as tsp
from repro_torch.faults import chaos
from repro_torch.faults import plan as plan_mod
from repro_torch.kernels import ref
from repro_torch.serving import StreamingSVMService
from torch_threads import one_thread  # noqa: F401

L = 8


def _sep_data(seed, n, d=16, w_key=9):
    w = np.random.default_rng(w_key).normal(size=d).astype(np.float32)
    X = np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)
    return X, np.sign(X @ w).astype(np.float32)


def _cfgs(**svm):
    kw = dict(sv_capacity=64, gamma=1e-4, max_rounds=3)
    return (J.MRSVMConfig(svm=J.SVMConfig(C=1.0, max_epochs=10, **svm), **kw),
            T.MRSVMConfig(svm=T.SVMConfig(C=1.0, max_epochs=10, **svm), **kw))


def _same_pattern(got, want, tol=1e-5):
    """NaN/Inf/finite at the same places, finite entries within tol."""
    g, w = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
    np.testing.assert_array_equal(np.isinf(g), np.isinf(w))
    fin = np.isfinite(w)
    np.testing.assert_allclose(g[fin], w[fin], rtol=0, atol=tol)


# ---------------------------------------------------------------------------
# the plan: the reference's draws
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 7, 123])
def test_plans_and_their_draws_match_the_reference(seed):
    for kind in faults.KINDS:
        a = faults.FaultPlan.single(kind, seed)
        b = jfaults.FaultPlan.single(kind, seed)
        assert [(s.kind, s.when, s.count, s.param) for s in a.specs] == \
            [(s.kind, s.when, s.count, s.param) for s in b.specs]
        assert a.rng("delay", 3).uniform() == b.rng("delay", 3).uniform()
    a = faults.FaultPlan.from_seed(seed)
    b = jfaults.FaultPlan.from_seed(seed)
    assert [(s.kind, s.when, s.count, s.param) for s in a.specs] == \
        [(s.kind, s.when, s.count, s.param) for s in b.specs]
    assert faults.KINDS == jfaults.KINDS
    with pytest.raises(ValueError, match="unknown fault kind"):
        faults.FaultSpec("cosmic_ray")


@pytest.mark.parametrize("seed", [0, 1, 2, 5, 11])
@pytest.mark.parametrize("fmt", ["dense", "sparse"])
def test_poison_batch_hits_the_reference_entry(seed, fmt):
    X, y = _sep_data(seed, 40)
    if fmt == "sparse":
        idx = np.tile(np.arange(4, dtype=np.int32), (40, 1))
        xj = jsp.SparseRows(jnp.asarray(idx), jnp.asarray(X[:, :4]), 16)
        xt = tsp.SparseRows(torch.from_numpy(idx),
                            torch.from_numpy(X[:, :4].copy()), 16)
    else:
        xj, xt = jnp.asarray(X), torch.from_numpy(X.copy())
    plan = faults.FaultPlan.single("poison_rows", seed)
    jplan = jfaults.FaultPlan.single("poison_rows", seed)
    with faults.inject(plan), jfaults.inject(jplan):
        pt, _ = faults.poison_batch(xt, y, plan.specs[0])
        pj, _ = jfaults.poison_batch(xj, y, jplan.specs[0])
    vt = (pt.values if fmt == "sparse" else pt).numpy()
    vj = np.asarray(pj.values if fmt == "sparse" else pj)
    np.testing.assert_array_equal(vt, vj)            # NaN/Inf included
    assert (~np.isfinite(vt)).sum() == 1
    assert np.isfinite((xt.values if fmt == "sparse" else xt).numpy()).all()
    # garble_wire, the packed transports' seam, is ported: without an
    # armed plan it passes a message through untouched (its draws are
    # held to the reference's in tests/test_torch_sharded.py)
    msg = torch.arange(4, dtype=torch.float32)
    assert plan_mod.garble_wire(msg, 1) is msg
    assert "garble_wire" in faults.__all__


def test_fire_counts_when_and_error_types():
    plan = faults.FaultPlan(0, (faults.FaultSpec("delay_round", when=2),
                                faults.FaultSpec("transport_exc", count=2),
                                faults.FaultSpec("ckpt_write_fail"),
                                faults.FaultSpec("scheduler_kill")))
    with faults.inject(plan) as armed:
        assert faults.fire("s", ("delay_round",), when=1) is None
        assert faults.fire("s", ("delay_round",), when=2) is not None
        for _ in range(2):
            with pytest.raises(faults.TransientFault):
                faults.maybe_raise("s", ("transport_exc",))
        faults.maybe_raise("s", ("transport_exc",))          # exhausted
        with pytest.raises(OSError):
            faults.maybe_raise("s", ("ckpt_write_fail",))
        with pytest.raises(faults.InjectedFault):
            faults.maybe_raise("s", ("scheduler_kill",))
        assert sum(armed.remaining) == 0 and len(armed.fired) == 5
    assert faults.active() is None


def test_retry_absorbs_transients_and_exhaustion_is_typed():
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError("flaky")
        return "done"
    got = faults.retry_with_backoff(flaky, attempts=3, base_s=0.001,
                                    retry_on=OSError)
    assert got == "done" and len(calls) == 3
    with pytest.raises(faults.FaultDetected) as e:
        faults.retry_with_backoff(lambda: 1 / 0, attempts=2, base_s=0.001,
                                  retry_on=ZeroDivisionError, layer="ckpt")
    assert e.value.layer == "ckpt"
    assert isinstance(e.value.__cause__, ZeroDivisionError)
    with pytest.raises(KeyError):                # foreign errors pass
        faults.retry_with_backoff(lambda: {}["k"], retry_on=OSError)


def test_watchdog_fires_writes_heartbeat_and_check_raises(tmp_path):
    hb = str(tmp_path / "hb.json")
    fired = []
    with faults.CollectiveWatchdog(0.1, heartbeat_path=hb,
                                   on_timeout=fired.append) as wd:
        threading.Event().wait(0.4)
    assert fired and wd.fired
    assert json.load(open(hb))["status"] == "timeout"
    with pytest.raises(faults.FaultDetected, match="watchdog deadline"):
        wd.check()
    with faults.CollectiveWatchdog(0.3, on_timeout=fired.append) as quiet:
        for _ in range(4):
            threading.Event().wait(0.05)
            quiet.beat()
    quiet.check()
    assert faults.WATCHDOG_EXIT_CODE == 17
    with pytest.raises(ValueError):
        faults.CollectiveWatchdog(0)


def test_check_finite_risks_names_the_layer():
    faults.check_finite_risks(np.array([0.1, 0.2]))
    with pytest.raises(faults.FaultDetected) as e:
        faults.check_finite_risks(np.array([0.1, np.nan]), where="r 3")
    assert e.value.layer == "core" and "r 3" in e.value.cause
    with pytest.raises(faults.FaultDetected) as e:
        faults.check_finite_risks(np.array([np.inf, 0.2]))
    assert e.value.layer == "transport"
    faults.check_finite_risks(np.array([np.nan, 0.2]),
                              mask=np.array([False, True]))


# ---------------------------------------------------------------------------
# a NaN feature: both packages raise at the same round
# ---------------------------------------------------------------------------

def _raises_core(fn):
    with pytest.raises((faults.FaultDetected, jfaults.FaultDetected)) as e:
        fn()
    assert e.value.layer == "core"
    return e.value.cause


@pytest.mark.parametrize("fmt", ["dense", "sparse"])
def test_nan_feature_raises_core_at_the_same_round(fmt):
    X, y = _sep_data(0, 256)
    X[37, 5] = np.nan
    if fmt == "sparse":
        jcfg, tcfg = _cfgs(row_format="sparse_csr", nnz_cap=16)
        idx = np.tile(np.arange(16, dtype=np.int32), (256, 1))
        xj = jsp.SparseRows(jnp.asarray(idx), jnp.asarray(X), 16)
        xt = tsp.SparseRows(torch.from_numpy(idx), torch.from_numpy(X), 16)
    else:
        jcfg, tcfg = _cfgs()
        xj, xt = jnp.asarray(X), torch.from_numpy(X)
    cj = _raises_core(lambda: J.fit_mapreduce(xj, jnp.asarray(y), L, jcfg))
    ct = _raises_core(lambda: T.fit_mapreduce(xt, y, L, tcfg, device="cpu"))
    assert cj == ct and "mapreduce round 0" in ct


def test_nan_feature_raises_core_in_the_sweep_as_the_reference():
    X, y = _sep_data(0, 256)
    X[200, 3] = np.nan
    jcfg, tcfg = _cfgs()
    cj = _raises_core(lambda: J.fit_mapreduce_sweep(
        jnp.asarray(X), jnp.asarray(y), L, jcfg,
        J.sweep_grid(jcfg.svm, C=[0.1, 1.0])))
    ct = _raises_core(lambda: T.fit_mapreduce_sweep(
        X, y, L, tcfg, T.sweep_grid(tcfg.svm, C=[0.1, 1.0]), device="cpu"))
    assert cj == ct and "sweep round 0" in ct


def test_unquarantined_nan_batch_raises_and_requeues_as_the_reference():
    jcfg, tcfg = _cfgs()
    X0, y0 = _sep_data(0, 128)
    jm = J.fit_mapreduce(jnp.asarray(X0), jnp.asarray(y0), 4, jcfg)
    tm = T.fit_mapreduce(X0, y0, 4, tcfg, device="cpu")
    js = JService(jcfg, num_partitions=4, quarantine=False)
    ts = StreamingSVMService(tcfg, num_partitions=4, quarantine=False,
                             device="cpu")
    js.register("a", jm)
    js.register("b", jm)
    ts.register("a", tm)
    ts.register("b", tm)
    Xp, yp = _sep_data(1, 64)
    Xp[3, 2] = np.nan
    for svc, conv in ((js, jnp.asarray), (ts, torch.from_numpy)):
        svc.submit("a", conv(Xp), conv(yp))
        svc.submit("b", conv(_sep_data(2, 64)[0]), conv(yp))
    for svc in (js, ts):
        cause = _raises_core(svc.run_wave)
        assert "sweep round 0" in cause
    assert ts.pending() == js.pending() == 2
    assert ts.throughput_report()["requeued"] == 2
    assert [ts.snapshot(s).version for s in "ab"] == [0, 0]
    assert [js.snapshot(s).version for s in "ab"] == [0, 0]


# ---------------------------------------------------------------------------
# the plain versions let NaN through as the reference does
# ---------------------------------------------------------------------------

def _solve_case(rng, L_, per, S, d, where):
    xh = rng.normal(size=(L_, per, d)).astype(np.float32)
    xs = rng.normal(size=(S, d)).astype(np.float32)
    if where == "home":
        xh[0, 5, 2] = np.nan
        xh[1, 3, 1] = np.inf
    else:
        xs[2, 3] = np.nan
    y = np.sign(rng.normal(size=(L_, per + S))).astype(np.float32)
    m = (rng.random((L_, per + S)) > 0.1).astype(np.float32)
    return xh, xs, y, m


@pytest.mark.parametrize("where", ["home", "shared"])
def test_plain_solve_lets_nan_through_as_the_reference(where):
    xh, xs, y, m = _solve_case(np.random.default_rng(3), 3, 12, 4, 8, where)
    kw = dict(C=1.0, tol=1e-6, max_epochs=20)
    a, w, b, t, v = ref.cd_solve_ref(*map(torch.from_numpy, (xh, xs, y, m)),
                                     **kw)
    jcfg = JSVMConfig(**kw)
    Xa = np.concatenate([xh, np.broadcast_to(xs, (3, 4, 8))], 1)
    jr = jax.vmap(lambda X, yy, mm: j_fit_binary_linear(X, yy, mm, jcfg))(
        jnp.asarray(Xa), jnp.asarray(y), jnp.asarray(m))
    np.testing.assert_array_equal(t.numpy(), np.asarray(jr.epochs_run))
    for got, want in ((a, jr.alpha), (w, jr.w), (b, jr.b),
                      (v, jr.max_violation)):
        _same_pattern(got.numpy(), want)
    assert (t.numpy() == 1).sum() >= 1 and np.isnan(b.numpy()).any()


def test_plain_sparse_solve_lets_nan_through_as_the_reference():
    rng = np.random.default_rng(4)
    L_, per, S, d, cap = 3, 12, 4, 16, 6
    idx = np.sort(np.stack([rng.choice(d, cap, replace=False)
                            for _ in range(L_ * per + S)]), 1).astype(np.int32)
    val = rng.normal(size=idx.shape).astype(np.float32)
    val[4, 0] = np.nan
    val[-1] = 0.0                              # a dead shared slot row
    y = np.sign(rng.normal(size=(L_, per + S))).astype(np.float32)
    m = np.ones_like(y)
    kw = dict(C=1.0, tol=1e-6, max_epochs=20)
    xh = tsp.SparseRows(torch.from_numpy(idx[:L_ * per].reshape(L_, per, cap)),
                        torch.from_numpy(val[:L_ * per].reshape(L_, per, cap)),
                        d)
    xs = tsp.SparseRows(torch.from_numpy(idx[L_ * per:]),
                        torch.from_numpy(val[L_ * per:]), d)
    a, w, b, t, v = ref.cd_solve_sparse_ref(xh, xs, torch.from_numpy(y),
                                            torch.from_numpy(m), **kw)
    jcfg = JSVMConfig(**kw, row_format="sparse_csr", nnz_cap=cap)
    ia = np.concatenate([idx[:L_ * per].reshape(L_, per, cap),
                         np.broadcast_to(idx[L_ * per:], (L_, S, cap))], 1)
    va = np.concatenate([val[:L_ * per].reshape(L_, per, cap),
                         np.broadcast_to(val[L_ * per:], (L_, S, cap))], 1)
    jr = jax.vmap(lambda i, vv, yy, mm: j_fit_binary_linear(
        jsp.SparseRows(i, vv, d), yy, mm, jcfg))(
        jnp.asarray(ia), jnp.asarray(va), jnp.asarray(y), jnp.asarray(m))
    np.testing.assert_array_equal(t.numpy(), np.asarray(jr.epochs_run))
    for got, want in ((a, jr.alpha), (w, jr.w), (b, jr.b)):
        _same_pattern(got.numpy(), want)
    assert t.tolist()[0] == 1 and t.tolist()[1] > 1


@pytest.mark.parametrize("case", ["nan_row", "nan_hypothesis"])
def test_plain_hinge_lets_nan_through_as_the_reference(case):
    rng = np.random.default_rng(5)
    X = rng.normal(size=(40, 12)).astype(np.float32)
    W = rng.normal(size=(5, 12)).astype(np.float32)
    b = rng.normal(size=5).astype(np.float32)
    y = np.sign(rng.normal(size=40)).astype(np.float32)
    m = np.ones(40, np.float32)
    m[9] = 0.0
    if case == "nan_row":
        X[9, 4] = np.nan                       # a masked row still counts
    else:
        W[2] = np.nan
    lt, ct = ref.hinge_scores_ref(*map(torch.from_numpy, (X, W, b, y, m)))
    lj, cj = jref.hinge_scores_ref(*map(jnp.asarray, (X, W, b, y, m)))
    _same_pattern(lt.numpy(), lj, tol=1e-4)
    assert float(ct) == float(cj)
    assert np.isnan(lt.numpy()).sum() == (5 if case == "nan_row" else 1)


@pytest.mark.parametrize("cluster", [1, 2])
def test_gram_kernel_emulation_lets_zero_steps_meet_inf_as_plain(cluster):
    """``gram_solve.emulate_tiled`` (the Gram kernel's arithmetic) on a K
    with a NaN row and column and an Inf alone on a diagonal: a Δ = 0
    row's update still adds 0 · Inf = NaN there, as the plain version
    and the reference do; the same bits elsewhere, the same epochs."""
    from repro_torch.kernels import gram_solve
    g = torch.Generator().manual_seed(0)
    X = torch.randn((3, 40, 16), generator=g)
    K = X @ X.mT / 16
    K = (K.triu() + K.triu(1).mT).contiguous()
    K[0, 5, :] = np.nan
    K[0, :, 5] = np.nan
    K[1, 7, 7] = np.inf
    y = torch.where(torch.rand((3, 40), generator=g) > 0.5, 1.0, -1.0)
    m = torch.ones_like(y)
    m[2, 9] = 0.0
    kw = dict(C=1.0, tol=1e-6, max_epochs=20)
    a, t, v = ref.cd_solve_gram_ref(K, y, m, **kw)
    ea, et, ev = gram_solve.emulate_tiled(K, y, m, tile=32, cluster=cluster,
                                          **kw)
    assert t.tolist() == et.tolist() == [1, 2, 20]
    for got, want in ((ea, a), (ev, v)):
        assert torch.equal(torch.isnan(got), torch.isnan(want))
        assert torch.equal(got.nan_to_num(), want.nan_to_num())


# ---------------------------------------------------------------------------
# the service's typed failures and the chaos scenarios
# ---------------------------------------------------------------------------

def test_stop_raises_fault_detected_for_a_thread_that_will_not_end():
    _, tcfg = _cfgs()
    svc = StreamingSVMService(tcfg, num_partitions=4, device="cpu")
    release = threading.Event()
    svc._thread = threading.Thread(target=release.wait, daemon=True)
    svc._thread.start()                      # a stranded scheduler stub
    try:
        with pytest.raises(faults.FaultDetected, match="refused to die") as e:
            svc.stop(timeout_s=0.2)
        assert e.value.layer == "serving"
    finally:
        release.set()
        svc._thread.join(timeout=5)
        svc._thread = None


def test_stall_trips_the_fold_watchdog_after_the_fold_publishes(tmp_path):
    _, tcfg = _cfgs()
    X0, y0 = _sep_data(0, 128)
    fires = []
    hb = str(tmp_path / "hb.json")
    svc = StreamingSVMService(tcfg, num_partitions=4, fold_deadline_s=1.0,
                              heartbeat_path=hb, watchdog_handler=fires.append,
                              device="cpu")
    svc.register("t", T.fit_mapreduce(X0, y0, 4, tcfg, device="cpu"))
    svc.submit("t", *_sep_data(1, 64))
    with faults.inject(faults.FaultPlan.single("stall", seed=0)):
        with pytest.raises(faults.FaultDetected, match="fold"):
            svc.run_wave()
    assert fires and svc.throughput_report()["watchdog_fires"] == 1
    assert json.load(open(hb))["cause"] == "wave 0 fold"
    # the fold itself finished and published before the deadline check
    assert svc.pending() == 0 and svc.snapshot("t").version == 1
    # a healthy fold passes under a watchdog (a deadline no CPU fold nears)
    svc.fold_deadline_s = 60.0
    svc.submit("t", *_sep_data(2, 64))
    assert svc.run_wave() is not None and svc.snapshot("t").version == 2


@pytest.fixture(scope="module")
def ctx():
    c = chaos.Ctx("cpu")
    yield c
    c.close()


@pytest.mark.parametrize("name,expect,fn", chaos.SCENARIOS,
                         ids=[s[0] for s in chaos.SCENARIOS])
def test_chaos_scenario_meets_the_reference_outcome(ctx, name, expect, fn):
    detail = fn(0, ctx)
    assert isinstance(detail, str) and detail
    assert expect == dict((n, e) for n, e, _ in chaos.SCENARIOS)[name]


def test_chaos_main_lists_the_waiting_scenarios(capsys):
    """No scenario waits any more: ``handshake_flake`` (ROADMAP Queue 1
    item 10) runs and meets the reference's outcome."""
    assert chaos.main(["--seeds", "1", "--only", "stall",
                       "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "detected" in out and "[ok ]" in out and "not run" not in out
    assert chaos.main(["--seeds", "1", "--only", "handshake",
                       "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "handshake_flake" in out and "survived" in out and "[ok ]" in out
