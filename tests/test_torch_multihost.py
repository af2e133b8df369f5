"""The port's multi-process harness (``repro_torch.launch.multihost``, the
counterpart of ``tests/mp_worker.py``) as 2 OS processes × 4 gloo CPU
ranks, joined through ``init_cluster`` and the coordinator's store.

Two launches of the two processes, one after the other:

* ``rounds,crash`` — the sharded round on allgather, ring and hier
  (2 hosts, counted from the processes) on dense and blocked-CSR rows,
  3 rounds, each rank making only its own rows; then the dedup-ring
  sweep with a round state saved each round, until process 1 SIGKILLs
  itself after round 1 and process 0 exits with the watchdog's code 17;
* ``resume`` — through a flaky (retried) handshake, the sweep resumed
  from the newest generation and, after its medium is corrupted, from
  the one before: both bit for bit with an uninterrupted run.

The round legs are held to JAX's ``mapreduce_round`` on the same numpy
rows in this process, with ``tests/mp_worker.py``'s limits; no rank
outlives its process."""
import json
import os
import pickle
import shutil
import signal
import tempfile
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

import repro.core as J
from conftest import subprocess_env
from repro.core.mapreduce_svm import init_sv_buffer, mapreduce_round
from repro.data import svm_rows
from repro_torch import faults
from repro_torch.ckpt.checkpoint import latest_step
from repro_torch.launch import multihost as mh

REPO = Path(__file__).resolve().parents[1]
ROUNDS, KILL_ROUND, NDEV = 3, 2, 8
CASES = [f"{fmt}-{impl}" for fmt in ("dense", "sparse")
         for impl in ("allgather", "ring", "hier")]


def _launch(out, legs):
    procs = mh.launch("repro_torch.launch.multihost", 2, 4,
                      ["--out", out, "--legs", legs, "--device", "cpu",
                       "--rounds", str(ROUNDS), "--kill-round",
                       str(KILL_ROUND)],
                      env=subprocess_env(PYTHONPATH=str(REPO / "src")),
                      log_dir=out)
    return procs


def _jax_rounds():
    """JAX's functional rounds on the full rows (the harness's): per round
    the outputs mp_worker.py holds the sharded run to."""
    Xf, yf = svm_rows(mh.N_ROWS, mh.D, seed=mh.SEED)
    per = mh.N_ROWS // NDEV
    cfg = J.MRSVMConfig(sv_capacity=64, svm=J.SVMConfig(C=1.0,
                                                        max_epochs=15))
    Xp = jnp.asarray(Xf).reshape(NDEV, per, mh.D)
    yp = jnp.asarray(yf).reshape(NDEV, per)
    sv = init_sv_buffer(cfg.sv_capacity, mh.D)
    out = []
    for _ in range(ROUNDS):
        res = mapreduce_round(Xp, yp, jnp.ones((NDEV, per), jnp.float32),
                              sv, cfg)
        sv = res.sv
        out.append({k: np.asarray(v) for k, v in (
            ("risks", res.risks), ("ids", sv.ids), ("mask", sv.mask),
            ("alpha", sv.alpha), ("x", sv.x))})
    return out


@pytest.fixture(scope="module")
def mp():
    """Both launches; JAX's rounds computed while the first runs. → a
    dict of what each launch left."""
    out = tempfile.mkdtemp(prefix="multihost_")
    try:
        a = _launch(out, "rounds,crash")
        want = _jax_rounds()
        rc_a = mh.wait_all(a, 600)
        logs_a = [Path(out, f"p{i}.log").read_text() for i in range(2)]
        ckpt = os.path.join(out, "ckpt")
        hb = {p.name: json.loads(p.read_text())
              for p in Path(ckpt).glob("hb_r*.json")}
        step_a = latest_step(ckpt)
        pids_a = mh.rank_pids(out)
        with open(os.path.join(out, "rounds.pkl"), "rb") as f:
            rounds = pickle.load(f)
        for p in Path(out).glob("pid_r*"):
            p.unlink()
        b = _launch(out, "resume")
        rc_b = mh.wait_all(b, 600)
        logs_b = [Path(out, f"p{i}.log").read_text() for i in range(2)]
        results = []
        for i in range(2):
            path = os.path.join(out, f"result_p{i}.pkl")
            if os.path.exists(path):
                with open(path, "rb") as f:
                    results += pickle.load(f)
        pids_b = mh.rank_pids(out)
        yield dict(want=want, rc_a=rc_a, logs_a=logs_a, hb=hb,
                   step_a=step_a, rounds=rounds, rc_b=rc_b, logs_b=logs_b,
                   results=results, pids=pids_a + pids_b)
    finally:
        shutil.rmtree(out, ignore_errors=True)


@pytest.mark.parametrize("case", CASES)
def test_round_legs_match_jax_mapreduce_round(mp, case):
    """Every round of each leg ≡ JAX's functional round on the same rows:
    risks within 1e-4 / 1e-5, SV ids and mask equal, α within 1e-4 /
    1e-5, rows within 1e-5 / 1e-6 (mp_worker.py's limits); blocked-CSR
    rows against the same rows dense."""
    got = mp["rounds"][case]
    assert len(got["risks"]) == ROUNDS
    for t, want in enumerate(mp["want"]):
        np.testing.assert_allclose(got["risks"][t], want["risks"],
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_array_equal(got["ids"][t], want["ids"])
        np.testing.assert_array_equal(got["mask"][t], want["mask"])
        np.testing.assert_allclose(got["alpha"][t], want["alpha"],
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(got["x"][t], want["x"], rtol=1e-5,
                                   atol=1e-6)
        assert got["w"][t].shape == (mh.D,) and got["b"][t].shape == ()


def test_hier_counts_the_two_processes_as_hosts(mp):
    assert mp["rounds"]["hosts"] == 2
    np.testing.assert_array_equal(mp["rounds"]["dense-hier"]["ids"][-1],
                                  mp["rounds"]["dense-ring"]["ids"][-1])


def test_killed_peer_exits_17_with_a_typed_heartbeat(mp):
    """Process 1 died by SIGKILL; process 0 exited with the watchdog's
    code, its log naming the transport, a rank's heartbeat saying
    ``detected`` or ``timeout``; the newest generation is round
    ``KILL_ROUND`` − 1 (a round is saved only after it completes)."""
    assert mp["rc_a"] == [faults.WATCHDOG_EXIT_CODE, -signal.SIGKILL], \
        mp["logs_a"]
    assert "transport" in mp["logs_a"][0]
    status = [mp["hb"][f"hb_r{r}.json"]["status"]
              for r in range(4) if f"hb_r{r}.json" in mp["hb"]]
    assert set(status) <= {"alive", "detected", "timeout"}
    assert {"detected", "timeout"} & set(status), mp["hb"]
    assert mp["step_a"] == KILL_ROUND - 1


def test_resume_is_bit_for_bit_through_a_flaky_handshake_and_corruption(mp):
    assert mp["rc_b"] == [0, 0], mp["logs_b"]
    for log in mp["logs_b"]:
        assert "absorbed by the retry" in log and "MP_OK resume" in log
    assert len(mp["results"]) == NDEV
    for r in mp["results"]:
        assert r["resume"]["newest"] == KILL_ROUND - 1
        assert r["resume"]["fallback"] == KILL_ROUND - 2


def test_ranks_import_neither_jax_nor_the_reference(mp):
    assert all(r["modules"] == [] and r["backend"] == "gloo"
               and r["process_count"] == 2 for r in mp["results"])


def test_no_rank_outlives_its_process(mp):
    assert len(mp["pids"]) == 2 * NDEV
    assert mh.alive(mp["pids"]) == []
