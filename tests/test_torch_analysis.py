"""The port's invariant linter (``repro_torch.analysis``) against the
reference's (``repro.analysis``), on the CPU.

Each rule's seeded violation (the reference's ``run_self_test`` cases)
fires the same rule in both packages, each naming op and program; the
bf16 wire pack is allowed and recorded in both. The loops take the
guards: ``fit_mapreduce_sweep(fail_on_retrace=True)`` under
``no_implicit_host_sync`` gives the unguarded sweep bit for bit and
JAX's within ``tests/test_torch_sweep.py``'s limits; both streaming
services, given the same wave sequence under ``fail_on_retrace``, report
the same ``fold_programs`` and ``retraces``. ``python -m
repro_torch.analysis.lint`` (the matrix, 18 programs on 8 gloo ranks)
and ``--self-test`` exit 0 in subprocesses started when the module
starts, beside a child that counts the reference's compiled rounds'
collectives (``launch.hlo_analysis.collective_stats``), which the
matrix's recorded counts are held to."""
import json
import os
import re
import subprocess
import sys
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import repro.core as J
import repro_torch.core as T
from repro import analysis as ja
from repro.core.mapreduce_svm import pack_wire_rows as j_pack_wire_rows
from repro.serving import StreamingSVMService as JService
from repro_torch import analysis as ta
from repro_torch import compat
from repro_torch.analysis import hostsync, lint, retrace
from repro_torch.kernels import build, ops
from repro_torch.serving import StreamingSVMService
from repro_torch.serving import svm_stream

REPO = Path(__file__).resolve().parents[1]
RTOL, ATOL = 1e-4, 1e-5            # tests/test_torch_sweep.py's limits
MATRIX_S = 600

# the reference's compiled rounds' collective counts, in a child with 8
# host devices (the lint harness's shapes)
_HLO_CHILD = """
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
from repro.analysis import lint
from repro.launch.hlo_analysis import collective_stats
from repro.launch.mesh import make_host_mesh
mesh = make_host_mesh(data=8)
cfg = lint._lint_cfg("dense")
out = {}
for shuffle in ("allgather", "ring", "hier"):
    hlo = lint._compile(lint._build("round", cfg, mesh, shuffle),
                        mesh).as_text()
    out[shuffle] = {k: v["count"] for k, v in collective_stats(hlo).items()}
print("COUNTS " + json.dumps(out))
"""


def _env():
    from conftest import subprocess_env
    return subprocess_env(PYTHONPATH=str(REPO / "src"))


@pytest.fixture(scope="module", autouse=True)
def children():
    """The matrix, the self-test and the reference's collective counts,
    started when the module starts and read by the last tests."""
    procs = {
        "matrix": [sys.executable, "-m", "repro_torch.analysis.lint"],
        "self_test": [sys.executable, "-m", "repro_torch.analysis.lint",
                      "--self-test"],
        "hlo": [sys.executable, "-c", _HLO_CHILD],
    }
    started = {k: subprocess.Popen(v, cwd=str(REPO), env=_env(),
                                   stdout=subprocess.PIPE,
                                   stderr=subprocess.STDOUT, text=True)
               for k, v in procs.items()}
    results = {}

    def result(name):
        if name not in results:
            try:
                out, _ = started[name].communicate(timeout=MATRIX_S)
            except subprocess.TimeoutExpired:
                started[name].kill()
                raise
            results[name] = (started[name].returncode, out)
        return results[name]
    try:
        yield result
    finally:
        for p in started.values():
            if p.poll() is None:
                p.kill()
                p.wait()


# ---------------------------------------------------------------------------
# each rule: the seeded violation fires the same rule in both packages
# ---------------------------------------------------------------------------

_BAD_RING = """\
ENTRY %main () -> f32[8] {
  %p = f32[8]{0} parameter(0)
  ROOT %cp = f32[8]{0} collective-permute(%p), channel_id=1, source_target_pairs={{0,3},{1,2},{2,3}}
}
"""
_BAD_HIER = """\
ENTRY %main () -> f32[8] {
  %p = f32[8]{0} parameter(0)
  %cp = f32[8]{0} collective-permute(%p), channel_id=1, source_target_pairs={{0,4},{1,5},{2,6},{3,7},{4,0},{5,1},{6,2},{7,3}}
  ROOT %ag = f32[32]{0} all-gather(%cp), channel_id=2, replica_groups={{0,1,2,3},{3,4,5,6,7}}, dimensions={0}
}
"""
_GOOD = """\
ENTRY %main () -> f32[8] {
  %p = f32[8]{0} parameter(0)
  %ar = f32[8]{0} all-reduce(%p), replica_groups={{0,1,2,3}}
  ROOT %ag = f32[32]{0} all-gather(%ar), replica_groups={{0,1,2,3}}
}
"""


def _jax_cases():
    """The reference's seeded violations (its ``run_self_test``), in the
    order of :func:`repro_torch.analysis.lint.seeded_cases`."""
    d = lint.LINT_FEATURES
    good = ja.collective_schedule(_GOOD)

    def retrace_():
        with ja.no_retrace("self-test wave"):
            jax.jit(lambda x: x * 2.0)(jnp.float32(1.0))

    def leaky(x):
        jax.debug.callback(lambda v: None, x)
        return x * 2.0

    def densify(v):
        return (v[:, None] * jnp.ones((lint.LINT_ROWS_PER_DEVICE, d))).sum()

    def drift(alpha):
        return alpha.astype(jnp.bfloat16).sum()

    return [
        lambda: retrace_(),
        lambda: ja.check_schedule(_BAD_RING, "self-test ring"),
        lambda: ja.check_schedule(_BAD_HIER, "self-test hier"),
        lambda: ja.assert_schedules_agree(
            {"proc0": good, "proc1": good[:1]}, "self-test agreement"),
        lambda: ja.compare_collective_counts(
            {"all-reduce": {"count": 3}}, {"all-reduce": {"count": 2}},
            "self-test artifact"),
        lambda: ja.check_no_host_callbacks(leaky, (jnp.zeros((4,)),),
                                           "self-test hot loop"),
        lambda: ja.check_no_dense_materialization(
            densify, (jnp.zeros((lint.LINT_ROWS_PER_DEVICE,)),), d=d,
            program="self-test densify"),
        lambda: ja.check_no_dtype_drift(drift, (jnp.zeros((8,)),),
                                        taint=[True],
                                        program="self-test drift"),
    ]


CASES = ["retrace", "bad-ring", "overlapping-host-groups",
         "truncated-schedule", "count-mismatch", "host-sync", "densify",
         "bf16-cast-of-alpha"]


@pytest.mark.parametrize("i", range(len(CASES)), ids=CASES)
def test_seeded_violation_fires_the_same_rule_in_both_packages(i):
    rule, port_case = lint.seeded_cases("cpu")[i]
    with pytest.raises(ta.LintViolation) as te:
        port_case()
    with pytest.raises(ja.LintViolation) as je:
        _jax_cases()[i]()
    assert te.value.rule == je.value.rule == rule
    for e in (te.value, je.value):
        assert e.op and e.program
    assert te.value.program == je.value.program or CASES[i] == \
        "count-mismatch"


def test_wire_pack_is_allowed_and_recorded_in_both_packages():
    rep = lint.wire_pack_report("cpu")
    jrep = ja.check_no_dtype_drift(
        lambda a: j_pack_wire_rows(a.astype(jnp.bfloat16),
                                   jnp.bfloat16)[0],
        (jnp.zeros((8, 16), jnp.float32),), taint=[True],
        program="self-test wire pack")
    assert len(rep.allowed) == len(jrep.allowed) == 1
    assert rep.allowed[0].rule == jrep.allowed[0].rule == "dtype-drift"
    assert rep.allowed[0].reason == "bf16 wire pack"


# ---------------------------------------------------------------------------
# the rules' own mechanics
# ---------------------------------------------------------------------------

def test_static_host_sync_rule_names_each_kind_of_wait():
    x = torch.arange(8.0)
    for fn, op in ((lambda t: t[t > 3], "index[bool mask]"),
                   (lambda t: t.nonzero(), "nonzero"),
                   (lambda t: torch.unique(t), "_unique2"),
                   (lambda t: int(t[0]), "_local_scalar_dense")):
        with pytest.raises(ta.LintViolation) as e:
            ta.check_no_host_callbacks(fn, (x,), program="p")
        assert e.value.op == op and e.value.rule == "host-sync"

    def readback(t):
        with ta.allowed_host_sync("a designed readback"):
            return float(t.sum())
    rep = ta.check_no_host_callbacks(readback, (x,), program="p")
    assert [a.op for a in rep.allowed] == ["_local_scalar_dense"]
    with pytest.raises(ValueError):
        with ta.allowed_host_sync(""):
            pass


def test_a_host_sync_region_belongs_to_the_thread_that_armed_it():
    assert not ta.host_guards_enforced("cpu")
    errors = []
    with ta.no_implicit_host_sync():
        with ta.no_implicit_host_sync():            # nests
            assert not hostsync.armed_elsewhere()

        def other():
            errors.append(hostsync.armed_elsewhere())
            try:
                with ta.no_implicit_host_sync():
                    pass
            except RuntimeError as e:
                errors.append(str(e))
        t = threading.Thread(target=other)
        t.start()
        t.join()
    assert errors[0] is True and "another thread" in errors[1]
    assert not hostsync.armed_elsewhere()


def test_dtype_drift_taint_stops_at_comparisons_and_sees_in_place_writes():
    alpha = torch.rand(8)

    def mask_only(a):
        return (a > 0.5).to(torch.bfloat16)
    assert not ta.check_no_dtype_drift(mask_only, (alpha,),
                                       taint=[True]).allowed

    def into_bf16_buffer(a):
        buf = torch.zeros(8, dtype=torch.bfloat16)
        buf.copy_(a * 2)
        return buf
    with pytest.raises(ta.LintViolation) as e:
        ta.check_no_dtype_drift(into_bf16_buffer, (alpha,), taint=[True],
                                program="copy")
    assert e.value.op == "copy_"
    ta.check_no_dtype_drift(into_bf16_buffer, (alpha,), taint=[False])


def test_memory_ceiling_is_skipped_with_a_note_on_the_cpu():
    rep = ta.check_memory_ceiling(lambda x: x * 2, (torch.ones(4),),
                                  limit_bytes=1, program="p")
    assert rep.checked == 0 and rep.note == "skipped: no device memory stats"


def test_a_plain_kernel_is_one_op_to_the_rules():
    """On the CPU a wrapper runs its kernel's plain version, whose early
    exits read the device: the rules read it as the card's one launch."""
    xh = torch.randn(2, 16, 8)
    xs = torch.randn(4, 8)
    y = torch.sign(torch.randn(2, 20))
    m = torch.ones(2, 20)
    rep = ta.check_no_host_callbacks(
        lambda *a: ops.cd_solve(*a, C=1.0, tol=1e-3, max_epochs=5),
        (xh, xs, y, m), program="solve")
    assert rep.checked < 50 and not rep.allowed


def test_signatures_are_compile_events_and_count_no_launch():
    ops.reset_launches()
    X = torch.randn(5, 977)
    with ta.watch_compiles() as st:
        ops.gram(X, X)
        ops.gram(X, X)                       # met before: no event
        ops.gram(X, X, kind="rbf", gamma=0.5)
    assert len(st.events) == 2
    assert st.events[0].startswith("gram[plain:(float32[5, 977]")
    assert "kind='rbf'" in st.events[1]
    assert sum(ops.LAUNCHES.values()) == sum(ops.ROUTE_LAUNCHES.values()) \
        == 0
    with pytest.raises(ta.RetraceError) as e:
        with ta.no_retrace("steady", allow=0):
            ops.gram(torch.randn(5, 978), torch.randn(5, 978))
    assert e.value.rule == "retrace" and e.value.program == "steady"


def test_a_kernel_library_loaded_is_a_compile_event(monkeypatch, tmp_path):
    lib = tmp_path / "libfake.so"
    lib.write_bytes(b"")
    monkeypatch.setattr(build, "library_path", lambda name: lib)
    monkeypatch.setattr(build.ctypes, "CDLL", lambda path: object())
    monkeypatch.delitem(build._LIBS, "fake_kernel", raising=False)
    try:
        with ta.watch_compiles() as st:
            build.load("fake_kernel")
            build.load("fake_kernel")
        assert st.events == ["build:fake_kernel"]
    finally:
        build._LIBS.pop("fake_kernel", None)


def test_the_recorder_sees_every_collective_kind(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        x = torch.arange(6.0).reshape(2, 3)
        groups = compat.new_groups([[0]])
        with compat.record_collectives() as rec:
            compat.psum(x)
            compat.all_gather(x)
            compat.pmax(x)
            compat.all_gather_groups(x, groups)
            compat.ppermute(x, [(0, 0)])
        assert [e.kind for e in rec] == [
            "psum", "all_gather", "pmax", "all_gather_groups",
            "ppermute_start", "ppermute_wait"]
        assert rec[0].shapes == ((2, 3),) and rec[0].dtypes == ("float32",)
        assert rec[4].pairs == ((0, 0),) and rec[4].serial == rec[5].serial
        ta.check_schedule(rec, "one rank")
        with pytest.raises(ta.LintViolation, match="never waited"):
            ta.check_schedule(rec[:-1], "dangling")
        assert ta.collective_counts(rec)["ppermute_start"] == {"count": 1}
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the loops under the guards
# ---------------------------------------------------------------------------

def _problem(n=256, d=10, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    w = rng.normal(size=d).astype(np.float32)
    return X, np.sign(X @ w + 0.05).astype(np.float32)


def test_guarded_sweep_is_the_unguarded_one_and_jax_s():
    X, y = _problem()
    kw = dict(sv_capacity=32, gamma=5e-3, max_rounds=5)
    jcfg = J.MRSVMConfig(svm=J.SVMConfig(C=1.0, max_epochs=10), **kw)
    tcfg = T.MRSVMConfig(svm=T.SVMConfig(C=1.0, max_epochs=10), **kw)
    grid = dict(C=[1e-3, 0.1, 1.0, 4.0])
    off = T.fit_mapreduce_sweep(X, y, 4, tcfg, T.sweep_grid(tcfg.svm, **grid),
                                device="cpu")
    with ta.no_implicit_host_sync():
        on = T.fit_mapreduce_sweep(X, y, 4, tcfg,
                                   T.sweep_grid(tcfg.svm, **grid),
                                   device="cpu", fail_on_retrace=True)
    assert len(set(on.rounds.tolist())) > 1
    np.testing.assert_array_equal(on.rounds, off.rounds)
    for a, b in zip(on.sv + on.final, off.sv + off.final):
        assert torch.equal(a, b)
    for k in ("risks", "ws", "bs"):
        assert torch.equal(getattr(on, k), getattr(off, k)), k
    with ja.no_implicit_host_sync():
        jres = J.fit_mapreduce_sweep(jnp.asarray(X), jnp.asarray(y), 4, jcfg,
                                     J.sweep_grid(jcfg.svm, **grid),
                                     fail_on_retrace=True)
    np.testing.assert_allclose(on.risks.numpy(), np.asarray(jres.risks),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(on.ws.numpy(), np.asarray(jres.ws),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(on.rounds, np.asarray(jres.rounds))
    assert on.best == jres.best


def _stream_rows(seed, n, d=16):
    w = np.random.default_rng(9).normal(size=d).astype(np.float32)
    X = np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)
    return X, np.sign(X @ w).astype(np.float32)


def _stream_services(**kw):
    kw_cfg = dict(sv_capacity=32, gamma=1e-4, max_rounds=3)
    jcfg = J.MRSVMConfig(svm=J.SVMConfig(C=1.0, max_epochs=8), **kw_cfg)
    tcfg = T.MRSVMConfig(svm=T.SVMConfig(C=1.0, max_epochs=8), **kw_cfg)
    jsvc = JService(jcfg, num_partitions=4, fail_on_retrace=True, **kw)
    tsvc = StreamingSVMService(tcfg, num_partitions=4, fail_on_retrace=True,
                               device="cpu", **kw)
    for i, s in enumerate(("s0", "s1", "s2")):
        X, y = _stream_rows(i, 128)
        jsvc.register(s, J.fit_mapreduce(jnp.asarray(X), jnp.asarray(y), 4,
                                         jcfg))
        tsvc.register(s, T.fit_mapreduce(X, y, 4, tcfg, device="cpu"))
    return jsvc, tsvc


def test_services_report_the_same_fold_programs_and_retraces():
    """Two waves of one shape (2 streams), one wave in a new bucket (3
    streams: width 4), then the first shape again, under
    ``fail_on_retrace`` in both packages."""
    jsvc, tsvc = _stream_services()
    seed = 10
    for names in (("s0", "s1"), ("s0", "s1"), ("s0", "s1", "s2"),
                  ("s0", "s1")):
        for s in names:
            X, y = _stream_rows(seed, 64)
            seed += 1
            jsvc.submit(s, jnp.asarray(X), jnp.asarray(y))
            tsvc.submit(s, X, y)
        jst, tst = jsvc.run_wave(), tsvc.run_wave()
        assert jst.streams == tst.streams == len(names)
    jr, tr = jsvc.throughput_report(), tsvc.throughput_report()
    assert (tr["fold_programs"], tr["retraces"]) == \
        (jr["fold_programs"], jr["retraces"]) == (2, 0)


def test_a_fold_meeting_a_new_signature_under_a_warm_one_raises(
        monkeypatch):
    _, tsvc = _stream_services()
    update = svm_stream.update_mapreduce
    calls = []

    def update_meeting_a_new_shape(*a, **kw):
        calls.append(1)
        if len(calls) == 2:
            lint._fresh_gram("cpu")
        return update(*a, **kw)
    monkeypatch.setattr(svm_stream, "update_mapreduce",
                        update_meeting_a_new_shape)
    for wave in range(2):
        X, y = _stream_rows(20 + wave, 64)
        tsvc.submit("s0", X, y)
        if wave == 0:
            tsvc.run_wave()
    with pytest.raises(ta.RetraceError) as e:
        tsvc.run_wave()
    assert e.value.op.startswith("gram[plain:")
    assert "single-tenant fold s0" in e.value.program
    assert tsvc.throughput_report()["retraces"] == 1


# ---------------------------------------------------------------------------
# the linter's entry point
# ---------------------------------------------------------------------------

def test_artifacts_mode_names_the_roadmap_item(capsys):
    """The staleness gate runs on the port's own dry-run artifacts
    (``tests/test_torch_dryrun.py`` holds it to them); the reference's,
    counted from HLO, it skips, each naming why."""
    assert lint.main(["--artifacts", "benchmarks/artifacts"]) == 0
    out = capsys.readouterr().out
    names = [ln for ln in out.splitlines() if ln.startswith("skip dryrun_")]
    assert len(names) == 10
    assert all("not a record of the port's dry run" in ln for ln in names)


def test_self_test_exits_0(children):
    rc, out = children("self_test")
    assert rc == 0, out
    assert out.count("OK seeded") == len(CASES)
    assert "wire-pack allowlist absorbed" in out


def test_matrix_exits_0_on_8_ranks(children):
    rc, out = children("matrix")
    assert rc == 0, out
    programs = re.findall(r"^program (\w+/\w+/\w+)$", out, re.M)
    assert len(programs) == 18
    assert out.count("8 ranks agree") == 18
    assert "dynamic/streaming-wave" in out and "retraces=0" in out


# the port's collectives that stand for each of the reference's HLO kinds:
# one to one, except that pmax is gloo-side an all-gather and a local max
# where XLA lowers lax.pmax to an all-reduce
_KINDS = {"all-reduce": ("psum", "pmax"),
          "all-gather": ("all_gather", "all_gather_groups"),
          "collective-permute": ("ppermute_start",)}


@pytest.mark.parametrize("shuffle", ["allgather", "ring", "hier"])
def test_round_collective_counts_match_the_references_compiled_round(
        children, shuffle):
    rc, out = children("matrix")
    assert rc == 0, out
    prog = out.split(f"program round/{shuffle}/dense\n")[1]
    port = json.loads(re.search(r"counts (\{.*\})", prog).group(1))
    rc, hlo = children("hlo")
    assert rc == 0, hlo
    ref = json.loads(hlo.split("COUNTS ")[1])[shuffle]
    got = {k: sum(port.get(p, {}).get("count", 0) for p in kinds)
           for k, kinds in _KINDS.items()}
    assert {k: v for k, v in got.items() if v} == ref
