"""The port's cluster launch (``repro_torch.launch.cluster``, the rest of
``launch/mesh.py``, ``launch/train.py``'s svm-tfidf mode, the serve
mode's cluster flags) against the reference's ``repro.launch.cluster``
and ``repro.launch.train``, on the CPU.

In-process: the counterparts of ``tests/test_cluster.py`` (the
1-process fast path opens no store and no group, environment
autodetect, the flags, an incomplete triple raising before any side
effect, ``simulated_topology``), the handshake's retry, the process-major
rank order (a process's rows are its ranks' rows), hier counting the
launched processes, and admission on process 0 only, held to the JAX
service on the same numpy inputs. Launched (one module-scoped set of OS
processes, all started at once): the train CLI's ``--smoke`` run, plain
and with ``--sweep 4``, as 2 processes × 4 gloo CPU ranks, held to the
reference's ``repro.launch.train`` in a child with 8 forced host devices
(R_emp per round within 1e-4, |SV| and the selected C equal), and the
serve mode as 2 processes (process 1 a read-only replica)."""
import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
import repro_torch.core as T
from conftest import subprocess_env
from repro.core import mapreduce_svm as jmr
from repro.data import svm_rows_shard as j_rows_shard
from repro.launch import cluster as jcl
from repro.launch import mesh as jmesh
from repro.serving import StreamingSVMService as JService
from repro_torch import compat, faults
from repro_torch.core import mapreduce_svm as tmr
from repro_torch.data import svm_rows_device, svm_rows_shard, svm_rows_sparse
from repro_torch.launch import cluster as cl
from repro_torch.launch import mesh, train
from repro_torch.launch.multihost import alive, launch, wait_all
from repro_torch.serving import StreamingSVMService

REPO = Path(__file__).resolve().parents[1]
ENV_VARS = ("REPRO_COORDINATOR", "JAX_COORDINATOR_ADDRESS",
            "REPRO_NUM_PROCESSES", "JAX_NUM_PROCESSES", "REPRO_PROCESS_ID",
            "JAX_PROCESS_ID")


@pytest.fixture(autouse=True)
def _fresh_runtime(monkeypatch):
    """init_cluster is process-global: isolate each test's view of it
    (both packages') and of the launch ``compat`` records."""
    monkeypatch.setattr(cl, "_CLUSTER", None)
    monkeypatch.setattr(jcl, "_CLUSTER", None)
    monkeypatch.setattr(compat, "_PROCESSES", 1)
    for var in ENV_VARS:
        monkeypatch.delenv(var, raising=False)


def _boom(*a, **k):
    raise AssertionError("a store or process group was opened")


def test_init_cluster_single_process_is_noop_fast_path(monkeypatch):
    """No coordinator anywhere → no store, no socket, no process group."""
    monkeypatch.setattr(torch.distributed, "TCPStore", _boom)
    monkeypatch.setattr(torch.distributed, "init_process_group", _boom)
    c = cl.init_cluster()
    assert c.process_count == 1 and c.process_index == 0
    assert not c.is_distributed and c.is_coordinator
    assert c.store is None and c.coordinator is None
    assert c.local_device_count == 1 and c.device_count == 1   # no card
    assert compat.process_count() == 1
    assert cl.init_cluster() is c                              # idempotent
    monkeypatch.setattr(cl, "_CLUSTER", None)
    c = cl.init_cluster(cl.ClusterConfig(local_device_count=4))
    assert c.local_ranks() == [0, 1, 2, 3] and not c.is_distributed


def test_cluster_config_env_autodetect(monkeypatch):
    """Both spellings, explicit arguments first: the reference's
    resolution field for field."""
    def both():
        t, j = cl.ClusterConfig().resolved(), jcl.ClusterConfig().resolved()
        return ((t.coordinator, t.num_processes, t.process_id,
                 t.is_multiprocess),
                (j.coordinator, j.num_processes, j.process_id,
                 j.is_multiprocess))
    monkeypatch.setenv("REPRO_COORDINATOR", "somehost:1234")
    monkeypatch.setenv("REPRO_NUM_PROCESSES", "4")
    monkeypatch.setenv("REPRO_PROCESS_ID", "2")
    got, want = both()
    assert got == want == ("somehost:1234", 4, 2, True)
    for var in ENV_VARS[::2]:
        monkeypatch.delenv(var)
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "other:9")
    monkeypatch.setenv("JAX_NUM_PROCESSES", "2")
    monkeypatch.setenv("JAX_PROCESS_ID", "1")
    got, want = both()
    assert got == want == ("other:9", 2, 1, True)
    assert cl.ClusterConfig(process_id=0).resolved().process_id == 0


def test_cluster_flags_roundtrip():
    ap, jap = argparse.ArgumentParser(), argparse.ArgumentParser()
    cl.add_cluster_flags(ap)
    jcl.add_cluster_flags(jap)
    assert ({a.dest for a in ap._actions}
            == {a.dest for a in jap._actions})
    argv = ["--coordinator", "localhost:9911", "--num-processes", "2",
            "--process-id", "1", "--local-devices", "4"]
    cfg = cl.cluster_config_from_args(ap.parse_args(argv))
    assert cfg == cl.ClusterConfig(coordinator="localhost:9911",
                                   num_processes=2, process_id=1,
                                   local_device_count=4)
    jcfg = jcl.cluster_config_from_args(jap.parse_args(argv))
    for f in ("coordinator", "num_processes", "process_id",
              "local_device_count", "initialization_timeout",
              "handshake_retries", "handshake_backoff_s"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    assert not cl.cluster_config_from_args(ap.parse_args([])).is_multiprocess


@pytest.mark.parametrize("kw,match", [
    (dict(coordinator="localhost:1"), "full triple"),
    (dict(num_processes=2), "full triple"),
    (dict(coordinator="localhost:1", process_id=0), "full triple"),
    (dict(coordinator="localhost:1", num_processes=2, process_id=2),
     "outside"),
    (dict(coordinator="localhost", num_processes=2, process_id=0),
     "host:port"),
    (dict(coordinator="localhost:1", num_processes=2, process_id=0),
     "local_device_count")])
def test_incomplete_multiprocess_config_raises(monkeypatch, kw, match):
    """Checked before any side effect: no store opened, no launch
    recorded; the missing triple with the reference's error."""
    monkeypatch.setattr(torch.distributed, "TCPStore", _boom)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError, match=match) as e:
        cl.init_cluster(cl.ClusterConfig(**kw))
    assert cl._CLUSTER is None and compat.process_count() == 1
    if match == "full triple":
        with pytest.raises(ValueError) as je:
            jcl.init_cluster(jcl.ClusterConfig(**kw))
        assert str(e.value).split(" (got")[0] == \
            str(je.value).split(" (got")[0]


def test_handshake_absorbs_a_flake_and_exhaustion_is_typed():
    """The real handshake of a 1-process cluster on a free port: 1-2
    armed flakes are retried away; one attempt against a flake raises
    ``FaultDetected("cluster")``."""
    port = cl.free_port()
    plan = faults.FaultPlan.single("handshake_flake", seed=0)
    before = faults.counters().get("retries", 0)
    with faults.inject(plan):
        c = cl.init_cluster(cl.ClusterConfig(
            coordinator=f"127.0.0.1:{port}", num_processes=1, process_id=0,
            local_device_count=3, handshake_backoff_s=0.01))
    assert faults.counters()["retries"] - before == plan.specs[0].count
    assert c.store is not None and c.local_ranks() == [0, 1, 2]
    assert json.loads(c.store.get("cluster/hello/0"))["k"] == 3
    assert cl.init_cluster() is c
    with faults.inject(plan), pytest.raises(faults.FaultDetected) as e:
        cl.join(cl.ClusterConfig(
            coordinator=f"127.0.0.1:{cl.free_port()}", num_processes=1,
            process_id=0, local_device_count=1, handshake_retries=1))
    assert e.value.layer == "cluster"


def test_simulated_topology():
    for n, dev in ((4, 256), (2, 8)):
        assert cl.simulated_topology(n, dev) == jcl.simulated_topology(n, dev)
    with pytest.raises(ValueError):
        cl.simulated_topology(3, 256)
    with pytest.raises(ValueError):
        jcl.simulated_topology(3, 256)


def test_ranks_are_process_major_and_a_process_shard_is_its_ranks_shards():
    """Global rank = process · k + i; a process's rows (the reference's
    ``svm_rows_shard`` of the process) are its ranks' rows, in order, for
    the numpy, the device and the blocked-CSR generators."""
    c = cl.Cluster(process_index=1, process_count=2, local_device_count=4)
    assert c.local_ranks() == [4, 5, 6, 7] and c.device_count == 8
    np.testing.assert_array_equal(mesh.rank_layout(c),
                                  np.arange(8).reshape(2, 4))
    n, d, P, k = 3000, 64, 2, 4
    for p in range(P):
        ranks = range(p * k, (p + 1) * k)
        Xp, yp = svm_rows_shard(n, d, seed=5, process_index=p,
                                process_count=P)
        Xj, yj = j_rows_shard(n, d, seed=5, process_index=p,
                              process_count=P)
        np.testing.assert_array_equal(Xp, np.asarray(Xj))
        np.testing.assert_array_equal(yp, np.asarray(yj))
        parts = [svm_rows_shard(n, d, seed=5, process_index=r,
                                process_count=P * k) for r in ranks]
        np.testing.assert_array_equal(Xp, np.concatenate([a for a, _ in
                                                          parts]))
        np.testing.assert_array_equal(yp, np.concatenate([b for _, b in
                                                          parts]))
        Xd, yd = svm_rows_device(n, d, seed=5, device="cpu",
                                 process_index=p, process_count=P)
        dparts = [svm_rows_device(n, d, seed=5, device="cpu",
                                  process_index=r, process_count=P * k)
                  for r in ranks]
        assert torch.equal(Xd, torch.cat([a for a, _ in dparts]))
        assert torch.equal(yd, torch.cat([b for _, b in dparts]))
        Sp, ys = svm_rows_sparse(n, d, 8, seed=5, process_index=p,
                                 process_count=P)
        sparts = [svm_rows_sparse(n, d, 8, seed=5, process_index=r,
                                  process_count=P * k) for r in ranks]
        assert torch.equal(Sp.indices, torch.cat([a.indices for a, _ in
                                                  sparts]))
        assert torch.equal(Sp.values, torch.cat([a.values for a, _ in
                                                 sparts]))
        np.testing.assert_array_equal(ys, np.concatenate([b for _, b in
                                                          sparts]))


def test_hier_counts_the_launched_processes():
    """One process: the simulated split and one host, as the reference's;
    a 2-process launch: ``simulated_hier_hosts`` is None and hier counts 2
    hosts (a process's ranks are one host's)."""
    t_cfg = T.MRSVMConfig(sv_capacity=64, shuffle_impl="hier")
    j_cfg = J.MRSVMConfig(sv_capacity=64, shuffle_impl="hier")
    assert mesh.simulated_hier_hosts(8) == jmesh.simulated_hier_hosts(8) == 2
    assert tmr.resolve_topology(t_cfg, 8) == jmr.resolve_topology(j_cfg, 8)
    compat.set_process_count(2)
    assert mesh.simulated_hier_hosts(8) is None
    assert tmr.resolve_topology(t_cfg, 8) == 2
    with pytest.raises(ValueError, match="divisible by the host count"):
        tmr.resolve_topology(t_cfg, 7)


def test_spawn_under_a_cluster_runs_its_own_ranks(monkeypatch):
    """A process starts its own k ranks; NCCL only when each of them has
    a card its process may give it (processes alone on their hosts)."""
    c = cl.Cluster(process_index=0, process_count=2, local_device_count=4,
                   coordinator="127.0.0.1:1")
    with pytest.raises(ValueError, match="runs 4 ranks"):
        compat.spawn(compat.rank_sum, 8, device="cpu", cluster=c)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    assert compat.choose_backend(4, "cuda", cards_per_process=0) == "gloo"
    assert compat.choose_backend(4, "cuda", cards_per_process=4) == "nccl"
    assert compat.choose_backend(4, "cpu", cards_per_process=4) == "gloo"


def test_streaming_service_admission_is_coordinator_only():
    """A process other than 0: snapshots readable, admission refused
    with the reference's message, start and run_wave no-ops; process 0
    admits and folds: the same versions and, to 1e-5, the same model as
    the JAX service on the same numpy inputs."""
    rng = np.random.default_rng(0)
    X = rng.normal(0, 1, (64, 8)).astype(np.float32)
    y = np.sign(X @ rng.normal(0, 1, 8).astype(np.float32) + 1e-3)
    kw = dict(sv_capacity=16, max_rounds=2)
    t_cfg = T.MRSVMConfig(svm=T.SVMConfig(C=1.0, max_epochs=8), **kw)
    j_cfg = J.MRSVMConfig(svm=J.SVMConfig(C=1.0, max_epochs=8), **kw)
    t_model = T.fit_mapreduce(X, y, 4, t_cfg, device="cpu")
    j_model = J.fit_mapreduce(jnp.asarray(X), jnp.asarray(y), 4, j_cfg)

    def services(index):
        svc = StreamingSVMService(t_cfg, num_partitions=4, device="cpu",
                                  cluster=cl.Cluster(index, 2))
        jsvc = JService(j_cfg, num_partitions=4,
                        cluster=jcl.Cluster(index, 2))
        svc.register("s0", t_model)
        jsvc.register("s0", j_model)
        return svc, jsvc

    svc, jsvc = services(1)
    assert svc.predict("s0", X).shape == (64,)
    assert svc.snapshot("s0").version == jsvc.snapshot("s0").version == 0
    with pytest.raises(RuntimeError, match="process 0") as te:
        svc.submit("s0", X, y)
    with pytest.raises(RuntimeError) as je:
        jsvc.submit("s0", jnp.asarray(X), jnp.asarray(y))
    assert str(te.value) == str(je.value)
    svc.start()
    assert svc._thread is None
    assert svc.run_wave() is None and jsvc.run_wave() is None

    svc0, jsvc0 = services(0)
    svc0.submit("s0", X, y)
    jsvc0.submit("s0", jnp.asarray(X), jnp.asarray(y))
    assert svc0.run_wave() is not None and jsvc0.run_wave() is not None
    assert svc0.snapshot("s0").version == jsvc0.snapshot("s0").version == 1
    np.testing.assert_allclose(
        svc0.snapshot("s0").model.w.numpy(),
        np.asarray(jsvc0.snapshot("s0").model.w), rtol=1e-5, atol=1e-5)


def test_lm_train_mode_trains_and_its_2_process_launch_exits(monkeypatch):
    """The LM mode trains on one process (--smoke, on the CPU); a
    2-process LM launch exits naming the svm family, as the reference's."""
    losses = train.main(["--arch", "tinyllama-1.1b", "--smoke", "--steps",
                         "2", "--batch", "2", "--seq", "32", "--device",
                         "cpu"])
    assert len(losses) == 2 and np.isfinite(losses).all()
    monkeypatch.setattr(train, "init_cluster",
                        lambda cfg: cl.Cluster(process_index=0,
                                               process_count=2))
    with pytest.raises(SystemExit, match="svm family"):
        train.main(["--arch", "tinyllama-1.1b", "--device", "cpu"])


def test_train_refuses_to_run_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--arch", "svm-tfidf", "--smoke"])


# ---------------------------------------------------------------------------
# launched: the train CLI and the serve mode as 2 processes × 4 ranks
# ---------------------------------------------------------------------------

MODES = {"plain": [], "sweep": ["--sweep", "4"]}


@pytest.fixture(scope="module")
def launched():
    """Every launch at once: the port's train CLI (plain, ``--sweep 4``)
    and serve mode as 2 processes each, and the reference's train CLI in
    a child with 8 forced host devices per mode. → (per mode: the port's
    return codes, outputs, report; the reference's output), the serve
    mode's (return codes, outputs)."""
    env = subprocess_env(PYTHONPATH=str(REPO / "src"))
    tmp = tempfile.mkdtemp(prefix="train_cli_")
    common = ["--arch", "svm-tfidf", "--smoke", "--device", "cpu"]
    port = {m: launch("repro_torch.launch.train", 2, 4,
                      common + ["--rows", "host", "--report",
                                os.path.join(tmp, f"{m}.json"), *a],
                      env=env)
            for m, a in MODES.items()}
    serve = launch("repro_torch.launch.serve", 2, 1,
                   common + ["--streams", "2", "--waves", "1"], env=env)
    ref = {m: subprocess.Popen(
        [sys.executable, "-m", "repro.launch.train", "--arch", "svm-tfidf",
         "--smoke", *a], cwd=str(REPO), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True,
        env=dict(env, XLA_FLAGS="--xla_force_host_platform_device_count=8"))
        for m, a in MODES.items()}
    out = {}
    for m in MODES:
        outs = [p.communicate(timeout=300)[0] for p in port[m]]
        rcs = wait_all(port[m], 10)
        rep = os.path.join(tmp, f"{m}.json")
        report = json.load(open(rep)) if os.path.exists(rep) else None
        out[m] = (rcs, outs, report, ref[m].communicate(timeout=300)[0])
    souts = [p.communicate(timeout=300)[0] for p in serve]
    return out, (wait_all(serve, 10), souts)


def _round_lines(text):
    return [(float(r), int(s)) for r, s in
            re.findall(r"round \d+: R_emp=([\d.]+) \|SV\|=(\d+)", text)]


def _config_lines(text):
    return [(float(c), float(r), int(n)) for c, r, n in re.findall(
        r"config C=([\d.e+-]+)\s+R_emp=([\d.]+) acc=[\d.]+ rounds=(\d+)",
        text)]


@pytest.mark.parametrize("mode", list(MODES))
def test_train_cli_matches_the_reference(launched, mode):
    """2 processes × 4 ranks ≡ the reference's 8-device run on the same
    rows: the same rounds, R_emp per round within 1e-4 and |SV| (plain);
    each config's R_emp within 1e-4 and rounds, and the selected C
    (sweep). Output on process 0 only; every rank on the same rounds;
    no rank outlives its process."""
    rcs, outs, report, ref = launched[0][mode]
    assert rcs == [0, 0], outs
    assert "R_emp" not in outs[1]
    if mode == "plain":
        got, want = _round_lines(outs[0]), _round_lines(ref)
        assert want and len(got) == len(want), (outs[0], ref)
        for (r, s), (rj, sj) in zip(got, want):
            assert abs(r - rj) <= 1e-4 and s == sj
        assert "(host-local shard)" in outs[0]
        ranks = report["ranks"]

        def picks(r):
            return [(x["risk"], x["sv"], x["ids"], x["alpha"])
                    for x in r["rounds"]]
        assert all(picks(r) == picks(ranks[0]) for r in ranks)
    else:
        got, want = _config_lines(outs[0]), _config_lines(ref)
        assert len(got) == len(want) == 4, (outs[0], ref)
        for (c, r, n), (cj, rj, nj) in zip(got, want):
            assert c == cj and abs(r - rj) <= 1e-4 and n == nj
        pick = r"sweep selected C=([\d.e+-]+)"
        assert re.findall(pick, outs[0]) == re.findall(pick, ref)
        ranks = report["ranks"]
        assert all(r["sweep"]["ids"] == ranks[0]["sweep"]["ids"]
                   for r in ranks)
    assert report["world"] == 8 and report["processes"] == 2
    assert sorted(r["rank"] for r in ranks) == list(range(8))
    assert [r["process"] for r in ranks] == [0] * 4 + [1] * 4
    assert report["routes"] == {}            # the plain versions here
    assert alive([r["pid"] for r in ranks]) == []


def test_serve_flags_run_process_0_and_a_replica(launched):
    """``launch.serve`` with the cluster flags: process 0 admits and folds
    the wave, process 1 registers the streams and serves them read-only,
    as the reference's replica."""
    rcs, outs = launched[1]
    assert rcs == [0, 0], outs
    assert "wave 1:" in outs[0] and "folded acc=" in outs[0]
    assert "process 1: read-only replica" in outs[1]
    assert "wave 1:" not in outs[1]
