"""The port's checkpointer (``repro_torch.ckpt``) and the streaming
service's durability, on the CPU, against the JAX package: the same
numpy inputs go to both, and each package restores the other's files.

Restores are exact (bit for bit, dtypes kept). A fold from a restored
snapshot is bit for bit the same package's fold from the same state
handed over in memory, and within the streaming tests' rtol = atol =
1e-4 of the other package's fold (the two packages sum in other
orders)."""
import json
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
import repro_torch.core as T
from repro import faults as jfaults
from repro import sparse as jsp
from repro.ckpt import checkpoint as jck
from repro.serving import StreamingSVMService as JService
from repro_torch import convert, faults
from repro_torch import sparse as tsp
from repro_torch.ckpt import checkpoint as ck
from repro_torch.serving import StreamingSVMService

L = 4
RTOL = ATOL = 1e-4


def _sep_data(seed, n, d=16, w_key=9):
    w = np.random.default_rng(w_key).normal(size=d).astype(np.float32)
    X = np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)
    return X, np.sign(X @ w).astype(np.float32)


def _rows(fmt, X):
    """numpy rows as (JAX rows, port rows) in ``fmt``: dense f32, dense
    bf16, or blocked-CSR with the 8 largest |x| of each row."""
    if fmt == "sparse":
        keep = np.sort(np.argsort(-np.abs(X), axis=1, kind="stable")[:, :8],
                       axis=1).astype(np.int32)
        vals = np.take_along_axis(X, keep, 1)
        return (jsp.SparseRows(jnp.asarray(keep), jnp.asarray(vals),
                               X.shape[1]),
                tsp.SparseRows(torch.from_numpy(keep),
                               torch.from_numpy(vals), X.shape[1]))
    if fmt == "bf16":
        return (jnp.asarray(X, jnp.bfloat16),
                torch.from_numpy(X).to(torch.bfloat16))
    return jnp.asarray(X), torch.from_numpy(X)


def _cfgs(fmt):
    kw = dict(sv_capacity=64, gamma=1e-4, max_rounds=3)
    svm = dict(C=1.0, max_epochs=10)
    if fmt == "sparse":
        svm.update(row_format="sparse_csr", nnz_cap=8)
    return (J.MRSVMConfig(svm=J.SVMConfig(**svm), **kw),
            T.MRSVMConfig(svm=T.SVMConfig(**svm), **kw))


def _np_leaf(a) -> np.ndarray:
    """A JAX or torch leaf as numpy, bf16 as its uint16 view."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy().view(np.uint16)
        return a.numpy()
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype == jnp.bfloat16 else a


def _model_leaves(m) -> dict:
    x = m.sv.x
    xs = (x.indices, x.values) if (jsp.is_sparse(x) or tsp.is_sparse(x)) \
        else (x,)
    leaves = {"w": m.w, "b": m.b, "risk": m.risk, "y": m.sv.y,
              "alpha": m.sv.alpha, "ids": m.sv.ids, "mask": m.sv.mask,
              **{f"x{i}": t for i, t in enumerate(xs)},
              **{f"final.{k}": v for k, v in m.final._asdict().items()}}
    return {k: _np_leaf(v) for k, v in leaves.items()}


def _assert_same_model(a, b):
    la, lb = _model_leaves(a), _model_leaves(b)
    assert la.keys() == lb.keys()
    for k in la:
        assert la[k].dtype == lb[k].dtype, k
        np.testing.assert_array_equal(la[k], lb[k], err_msg=k)
    assert int(a.rounds) == int(b.rounds)


def _port_model(jm):
    """A JAX model as the port's (on the CPU), bf16 leaves kept."""
    def arr(a):
        a = np.asarray(a)
        if a.dtype == jnp.bfloat16:
            return torch.from_numpy(a.view(np.int16).copy()).view(
                torch.bfloat16)
        return torch.from_numpy(np.array(a))
    x = jm.sv.x
    tx = (tsp.SparseRows(arr(x.indices), arr(x.values), x.d)
          if jsp.is_sparse(x) else arr(x))
    return T.MapReduceSVM(
        w=arr(jm.w), b=arr(jm.b), sv=T.SVBuffer(tx, *map(arr, jm.sv[1:])),
        final=T.BinarySVM(*map(arr, jm.final)), risk=arr(jm.risk),
        rounds=jm.rounds, history=())


def _jax_model(tm):
    """A port's model as the JAX package's (on the host)."""
    def arr(t):
        if t.dtype == torch.bfloat16:
            return jnp.asarray(_np_leaf(t)).view(jnp.bfloat16)
        return jnp.asarray(t.numpy())
    x = tm.sv.x
    jx = (jsp.SparseRows(arr(x.indices), arr(x.values), x.d)
          if tsp.is_sparse(x) else arr(x))
    return J.MapReduceSVM(
        w=arr(tm.w), b=arr(tm.b),
        sv=J.SVBuffer(jx, *(arr(f) for f in tm.sv[1:])),
        final=J.BinarySVM(*(arr(f) for f in tm.final)),
        risk=jnp.asarray(float(tm.risk), jnp.float32), rounds=tm.rounds,
        history=())


def _batch(fmt, seed, n=96):
    """A batch of ``fmt`` rows as ((JAX rows, labels), (port's))."""
    X, y = _sep_data(seed, n)
    Xj, Xt = _rows(fmt, X)
    if fmt == "bf16":
        return ((Xj, jnp.asarray(y, jnp.bfloat16)),
                (Xt, torch.from_numpy(y).to(torch.bfloat16)))
    return (Xj, jnp.asarray(y)), (Xt, torch.from_numpy(y))


def _decisions(svc, Xq_j, Xq_t) -> np.ndarray:
    """A service's decision values on the query rows, in its format."""
    if isinstance(svc, JService):
        return np.asarray(svc.decision_values("t", Xq_j), np.float32)
    return convert.to_numpy(svc.decision_values("t", Xq_t)
                            ).astype(np.float32)


# ---------------------------------------------------------------------------
# the checkpointer: the reference's file format
# ---------------------------------------------------------------------------

def _trees():
    x = np.arange(24, dtype=np.float32).reshape(4, 6) / 7
    idx = np.arange(8, dtype=np.int32).reshape(4, 2)
    jt = {"model": {"w": jnp.asarray(x),
                    "xb": jnp.asarray(x, jnp.bfloat16),
                    "sv": {"x": jsp.SparseRows(jnp.asarray(idx),
                                               jnp.asarray(x[:, :2]), 6),
                           "ids": jnp.asarray(idx[:, 0])}},
          "params": {"C": jnp.asarray(1.0), "tol": jnp.asarray(1e-3)}}
    tt = {"model": {"w": torch.from_numpy(x),
                    "xb": torch.from_numpy(x).to(torch.bfloat16),
                    "sv": {"x": tsp.SparseRows(torch.from_numpy(idx),
                                               torch.from_numpy(x[:, :2]), 6),
                           "ids": torch.from_numpy(idx[:, 0])}},
          "params": {"tol": torch.tensor(np.float32(1e-3)),
                     "C": torch.tensor(1.0)}}
    return jt, tt


def test_flat_keys_dtypes_checksums_and_files_match_reference(tmp_path):
    jt, tt = _trees()
    assert ck.leaf_dtypes(tt) == jck.leaf_dtypes(jt)
    assert ck.leaf_checksums(tt) == jck.leaf_checksums(jt)
    assert "['model']||['sv']||['x']||[<flat index 1>]" in ck.leaf_dtypes(tt)
    assert ck.leaf_dtypes(tt)["['model']||['xb']"] == "bfloat16"
    a, b = str(tmp_path / "a.npz"), str(tmp_path / "b.npz")
    assert ck.save(a, tt) == jck.save(b, jt)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    assert not any(p.name.endswith(".tmp.npz") for p in tmp_path.iterdir())


def test_each_package_restores_the_others_file(tmp_path):
    jt, tt = _trees()
    a, b = str(tmp_path / "port.npz"), str(tmp_path / "ref.npz")
    ck.save(a, tt)
    jck.save(b, jt)
    got = ck.restore(b, ck.with_dtypes(tt, jck.leaf_dtypes(jt)),
                     checksums=jck.leaf_checksums(jt))
    assert got["model"]["xb"].dtype == torch.bfloat16
    assert torch.equal(got["model"]["xb"], tt["model"]["xb"])
    assert torch.equal(got["model"]["sv"]["x"].indices,
                       tt["model"]["sv"]["x"].indices)
    back = jck.restore(a, jt, checksums=ck.leaf_checksums(tt))
    assert back["model"]["xb"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(back["model"]["w"]),
                                  tt["model"]["w"].numpy())


def test_restore_refuses_dtype_drift_and_shape_drift(tmp_path):
    _, tt = _trees()
    p = str(tmp_path / "t.npz")
    ck.save(p, tt)
    drift = ck.with_dtypes(tt, {"['model']||['xb']": "float32"})
    with pytest.raises(ValueError, match="dtype mismatch"):
        ck.restore(p, drift)
    wide = dict(tt, params={"C": torch.zeros(2), "tol": torch.tensor(0.0)})
    with pytest.raises(ValueError, match="shape mismatch"):
        ck.restore(p, wide)


def test_restore_verifies_leaf_checksums(tmp_path):
    _, tt = _trees()
    p = str(tmp_path / "t.npz")
    ck.save(p, tt)
    sums = ck.leaf_checksums(tt)
    sums["['model']||['w']"] ^= 1
    with pytest.raises(ck.CorruptCheckpointError, match="checksum"):
        ck.restore(p, tt, checksums=sums)


def test_generations_prune_gc_and_fall_back_past_corrupt(tmp_path):
    d = str(tmp_path)
    for step in range(4):
        ck.save(os.path.join(d, f"s{step}.npz"),
                {"w": torch.full((3,), float(step))}, step=step, keep=2)
    meta = json.load(open(os.path.join(d, "ckpt_meta.json")))
    assert [g["step"] for g in meta["generations"]] == [2, 3]
    assert sorted(f for f in os.listdir(d) if f.endswith(".npz")) == \
        ["s2.npz", "s3.npz"]
    assert ck.latest_step(d) == 3
    plan = faults.FaultPlan(0, (faults.FaultSpec("ckpt_corrupt", param=1),))
    with faults.inject(plan):
        ck.save(os.path.join(d, "s4.npz"), {"w": torch.ones(3)}, step=4,
                keep=2)
    before = faults.counters().get("ckpt_fallbacks", 0)
    assert ck.latest_path(d) == os.path.join(d, "s3.npz")
    assert faults.counters()["ckpt_fallbacks"] == before + 1
    # the reference reads the port's generations the same way
    assert jck.latest_path(d) == os.path.join(d, "s3.npz")


def test_atomic_write_json_retries_injected_write_failures(tmp_path):
    p = str(tmp_path / "m.json")
    retries = []
    plan = faults.FaultPlan(0, (faults.FaultSpec("ckpt_write_fail",
                                                 count=2),))
    with faults.inject(plan) as armed:
        ck.atomic_write_json(p, {"a": 1},
                             on_retry=lambda i, e: retries.append(i))
    assert sum(armed.remaining) == 0 and retries == [0, 1]
    assert json.load(open(p)) == {"a": 1}
    plan = faults.FaultPlan(0, (faults.FaultSpec("ckpt_write_fail",
                                                 count=3),))
    with faults.inject(plan), pytest.raises(faults.FaultDetected) as e:
        ck.atomic_write_json(p, {"a": 2})
    assert e.value.layer == "ckpt"
    assert json.load(open(p)) == {"a": 1}          # the old file stands


# ---------------------------------------------------------------------------
# the service: each package restores the other's checkpoints and folds on
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def trained():
    """{fmt: the JAX model trained on 256 rows, and the port's copy}."""
    out = {}
    X, y = _sep_data(0, 256)
    for fmt in ("f32", "bf16", "sparse"):
        jcfg, _ = _cfgs(fmt)
        Xj, _ = _rows(fmt, X)
        dt = jnp.bfloat16 if fmt == "bf16" else jnp.float32
        jm = J.fit_mapreduce(Xj, jnp.asarray(y, dt), L, jcfg)
        out[fmt] = (jm, _port_model(jm))
    return out


@pytest.mark.parametrize("fmt", ["f32", "bf16", "sparse"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_service_restores_the_other_packages_checkpoint_and_folds_on(
        trained, tmp_path, fmt, writer):
    jcfg, tcfg = _cfgs(fmt)
    jm, tm = trained[fmt]
    (Xj1, yj1), (Xt1, yt1) = _batch(fmt, 1)
    (Xj2, yj2), (Xt2, yt2) = _batch(fmt, 2)
    d = str(tmp_path / "ck")
    if writer == "jax":
        w = JService(jcfg, num_partitions=L, checkpoint_dir=d)
        w.register("t", jm)
        w.submit("t", Xj1, yj1)
        w.drain()
        r = StreamingSVMService.restore(tcfg, d, device="cpu")
        # the same state handed over in memory, as the reader's oracle
        twin = StreamingSVMService(tcfg, num_partitions=L, device="cpu")
        twin.register("t", _port_model(w.snapshot("t").model))
        batch2_w, batch2_r = (Xj2, yj2), (Xt2, yt2)
    else:
        w = StreamingSVMService(tcfg, num_partitions=L, checkpoint_dir=d,
                                device="cpu")
        w.register("t", tm)
        w.submit("t", Xt1, yt1)
        w.drain()
        r = JService.restore(jcfg, d)
        twin = JService(jcfg, num_partitions=L)
        twin.register("t", _jax_model(w.snapshot("t").model))
        batch2_w, batch2_r = (Xt2, yt2), (Xj2, yj2)
    assert r.snapshot("t").version == w.snapshot("t").version == 1
    _assert_same_model(r.snapshot("t").model, w.snapshot("t").model)
    # fold on: the reader from the file ≡ the reader from memory, bit for
    # bit; ≈ the writer's own fold
    for svc, batch in ((w, batch2_w), (r, batch2_r), (twin, batch2_r)):
        svc.submit("t", *batch)
        svc.drain()
    assert r.snapshot("t").version == 2
    _assert_same_model(r.snapshot("t").model, twin.snapshot("t").model)
    Xqj, Xqt = _rows(fmt, _sep_data(7, 64)[0])
    np.testing.assert_allclose(_decisions(r, Xqj, Xqt),
                               _decisions(w, Xqj, Xqt), rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(_np_leaf(r.snapshot("t").model.sv.ids),
                                  _np_leaf(w.snapshot("t").model.sv.ids))


def test_service_restore_falls_back_past_corrupt_generation(trained,
                                                            tmp_path):
    jcfg, tcfg = _cfgs("f32")
    d = str(tmp_path / "ck")
    svc = StreamingSVMService(tcfg, num_partitions=L, checkpoint_dir=d,
                              checkpoint_every_waves=1, checkpoint_keep=2,
                              device="cpu")
    svc.register("t", trained["f32"][1])                  # generation 0
    gen0 = svc.snapshot("t").model
    (_, _), (Xt, yt) = _batch("f32", 1)
    svc.submit("t", Xt, yt)
    assert svc.run_wave() is not None                     # generation 1
    man = json.load(open(os.path.join(d, "service_manifest.json")))
    assert man["format"] == 2 and len(man["generations"]) == 2
    assert man["generations"][-1]["streams"]["t"]["slot"] == 0
    newest = os.path.join(d, man["generations"][-1]["streams"]["t"]["file"])
    with open(newest, "r+b") as f:
        f.seek(os.path.getsize(newest) // 2)
        b = f.read(1)
        f.seek(-1, 1)
        f.write(bytes([b[0] ^ 0x20]))
    for restore in (lambda: StreamingSVMService.restore(tcfg, d,
                                                        device="cpu"),
                    lambda: JService.restore(jcfg, d)):
        r = restore()
        assert r.restore_fallbacks == 1
        assert r.snapshot("t").version == 0
        _assert_same_model(r.snapshot("t").model, gen0)
    # keep-2: a third generation removes the first one's file
    svc.submit("t", Xt, yt)
    svc.run_wave()
    files = sorted(f for f in os.listdir(d) if f.endswith(".npz"))
    assert files == ["gen000001_stream0.npz", "gen000002_stream0.npz"]
    # every generation corrupt → typed, named
    for fn in files:
        with open(os.path.join(d, fn), "r+b") as f:
            f.truncate(8)
    with pytest.raises(faults.FaultDetected) as e:
        StreamingSVMService.restore(tcfg, d, device="cpu")
    assert e.value.layer == "ckpt"
    assert "no intact snapshot generation" in str(e.value)


def test_service_reads_a_format_1_manifest(trained, tmp_path):
    jcfg, tcfg = _cfgs("f32")
    d = str(tmp_path / "ck")
    svc = StreamingSVMService(tcfg, num_partitions=L, checkpoint_dir=d,
                              device="cpu")
    svc.register("t", trained["f32"][1])
    path = os.path.join(d, "service_manifest.json")
    man = json.load(open(path))
    old = {k: man[k] for k in ("wave", "uid", "sv_capacity",
                               "num_partitions", "max_batches_per_wave",
                               "streams")}
    for m in old["streams"].values():          # format 1 had no crc32s
        del m["checksums"], m["file_crc32"]
    with open(path, "w") as f:
        json.dump(old, f)
    r = StreamingSVMService.restore(tcfg, d, device="cpu")
    _assert_same_model(r.snapshot("t").model, trained["f32"][1])
    with pytest.raises(ValueError, match="sv_capacity"):
        StreamingSVMService.restore(
            T.MRSVMConfig(sv_capacity=32, svm=tcfg.svm), d, device="cpu")
    shutil.rmtree(d)
    with pytest.raises(FileNotFoundError, match="no service manifest"):
        StreamingSVMService.restore(tcfg, d, device="cpu")


def test_restored_service_resumes_counters_and_params(trained, tmp_path):
    """Wave and uid counters resume from the manifest; a stream's
    SolverParams come back as host numbers, bit for bit the saved
    float32s; a new checkpoint does not reuse a kept generation's
    name."""
    _, tcfg = _cfgs("f32")
    d = str(tmp_path / "ck")
    svc = StreamingSVMService(tcfg, num_partitions=L, checkpoint_dir=d,
                              device="cpu")
    params = tcfg.svm.params()._replace(C=0.5)
    svc.register("a", trained["f32"][1], params=params)
    (_, _), (Xt, yt) = _batch("f32", 1)
    uid = svc.submit("a", Xt, yt)
    svc.drain()
    r = StreamingSVMService.restore(tcfg, d, device="cpu")
    got = r.snapshot("a").params
    assert got == tuple(float(np.float32(v)) for v in params)
    assert r.submit("a", Xt, yt) == uid + 1
    r.drain()
    assert r.stats[-1].wave == 1 and r.snapshot("a").version == 2
    man = json.load(open(os.path.join(d, "service_manifest.json")))
    assert [g["generation"] for g in man["generations"]] == [0, 1, 2]
    assert r.throughput_report()["retries"] == 0


def test_poison_and_kill_seams_of_the_service_match_the_reference(trained):
    """poison_rows at submit and scheduler_kill at a wave, the same plan
    in both services: both quarantine the batch, both requeue the dead
    wave's batch at the head and fold it once."""
    jcfg, tcfg = _cfgs("f32")
    jm, tm = trained["f32"]
    (Xj, yj), (Xt, yt) = _batch("f32", 3)
    js = JService(jcfg, num_partitions=L)
    ts = StreamingSVMService(tcfg, num_partitions=L, device="cpu")
    js.register("t", jm)
    ts.register("t", tm)
    plan = faults.FaultPlan.single("poison_rows", 4)
    jplan = jfaults.FaultPlan.single("poison_rows", 4)
    with faults.inject(plan), jfaults.inject(jplan):
        ts.submit("t", Xt, yt)
        js.submit("t", Xj, yj)
    assert len(ts.quarantined) == len(js.quarantined) == 1
    ts.submit("t", Xt, yt)
    js.submit("t", Xj, yj)
    with faults.inject(faults.FaultPlan.single("scheduler_kill", 1)), \
            pytest.raises(faults.InjectedFault):
        ts.run_wave()
    with jfaults.inject(jfaults.FaultPlan.single("scheduler_kill", 1)), \
            pytest.raises(jfaults.InjectedFault):
        js.run_wave()
    assert ts.pending() == js.pending() == 1
    assert ts.throughput_report()["requeued"] == 1
    ts.drain()
    js.drain()
    assert ts.snapshot("t").version == js.snapshot("t").version == 1
    np.testing.assert_array_equal(_np_leaf(ts.snapshot("t").model.sv.ids),
                                  _np_leaf(js.snapshot("t").model.sv.ids))
