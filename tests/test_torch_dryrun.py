"""The dry-run family of the port (``launch/dryrun.py``, ``probes.py``,
``hlo_analysis.py``, ``analysis/hlo.py``, the svm step builders and
``per_host_abstract`` of ``launch/steps.py``, ``analysis.lint
--artifacts``, the kernels' shape rules) against the reference's.

The reference's dry run sets ``XLA_FLAGS`` when it is imported, and the
port's opens a ``fake`` process group of 256 or 512 ranks in its
process; so each runs in a child process, both started when the module
starts: the reference's child computes ``_model_flops``, the
``per_host_abstract`` shapes, ``_write``'s artifact names and the
collective stats of its compiled svm round on 8 host devices; the
port's child runs the twins of ``tests/test_dryrun.py`` through its CLI
and everything else that needs a fake group. The rest runs here.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp  # noqa: F401  (JAX on the CPU before torch work)
import pytest
import torch

from torch_threads import one_thread  # noqa: F401

from repro_torch import sparse as sparse_rows
from repro_torch.configs import PORTED_ARCHS, get_config
from repro_torch.kernels import ops
from repro_torch.launch import dryrun, steps
from repro_torch.launch import hlo_analysis as tha
from repro_torch.launch import mesh as tmesh

REPO = Path(__file__).resolve().parents[1]
CHILD_S = 300
LM_SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
SMALL = dict(num_features=512, rows_per_device=64, sv_capacity=32)
# the artifact records whose names both packages' _write give
RECORDS = [
    {"arch": "svm_tfidf", "shape": "svm_sweep", "mesh": "16x16",
     "rules": "baseline", "shuffle": "ring"},
    {"arch": "svm_tfidf", "shape": "svm_sweep", "mesh": "16x16",
     "rules": "baseline", "shuffle": "hier", "row_format": "sparse_csr",
     "nnz_cap": 256, "processes": 2},
    {"arch": "svm_tfidf", "shape": "svm", "mesh": "2x16x16",
     "rules": "baseline", "shuffle": "allgather", "row_format": "dense"},
    {"arch": "llama3_8b", "shape": "decode_32k", "mesh": "16x16",
     "rules": "baseline"},
    {"arch": "qwen2_1_5b", "shape": "train_4k", "mesh": "2x16x16",
     "rules": "fsdp", "processes": 4},
]

# (name, builder of the bundle of svm-tfidf config ``cfg`` on ``mesh``)
PER_HOST = (
    ("round_ring", "svm", "ring", "dense"),
    ("round_allgather", "svm", "allgather", "dense"),
    ("sweep_ring", "svm_sweep", "ring", "dense"),
    ("sweep_hier_sparse", "svm_sweep", "hier", "sparse_csr"),
    ("serve_ring", "svm_serve", "ring", "dense"),
    ("serve_allgather_sparse", "svm_serve", "allgather", "sparse_csr"),
)

_REF_CHILD = r"""
import dataclasses, json, os, sys, tempfile
from repro.launch import dryrun        # sets XLA_FLAGS: 512 host devices
import jax, numpy as np
from jax.sharding import Mesh
from repro import compat, sparse as sparse_rows
from repro.configs import ARCH_IDS, get_config
from repro.launch import steps
from repro.launch.hlo_analysis import collective_stats
from repro.launch.mesh import make_production_mesh
spec = json.loads(sys.argv[1])
out = {"model_flops": {}, "per_host": {}, "stats": {}}
for arch in ARCH_IDS:
    if arch != "svm_tfidf":
        cfg = get_config(arch)
        out["model_flops"][arch] = {
            s: dryrun._model_flops(cfg, steps.INPUT_SHAPES[s])
            for s in spec["lm_shapes"]}
mesh = make_production_mesh()
svm = get_config("svm-tfidf")
builders = {"svm": lambda c, sh: steps.build_svm_round_step(c, mesh, sh),
            "svm_sweep": lambda c, sh: steps.build_svm_sweep_step(
                c, mesh, 8, sh),
            "svm_serve": lambda c, sh: steps.build_svm_serve_step(
                c, mesh, 4, sh)}

def fmt(a):
    if sparse_rows.is_sparse(a):
        return (f"sparse_csr[d={a.d}] "
                f"idx={a.indices.dtype}{list(a.indices.shape)} "
                f"val={a.values.dtype}{list(a.values.shape)}")
    return f"{a.dtype}{list(a.shape)}"

bundles = [(name, builders[kind](dataclasses.replace(svm, row_format=fmt_),
                                 shuffle))
           for name, kind, shuffle, fmt_ in spec["per_host"]]
bundles.append(("decode_llama3_8b", steps.build_serve_step(
    get_config("llama3-8b"), mesh, steps.INPUT_SHAPES["decode_32k"])))
for name, b in bundles:
    for n in (2, 3, 4):
        try:
            v = jax.tree_util.tree_map(
                fmt, steps.per_host_abstract(b.args, b.in_shardings, mesh, n),
                is_leaf=sparse_rows.is_sparse)
        except ValueError as e:
            v = "ValueError: " + str(e)
        out["per_host"][f"{name}/{n}"] = json.loads(json.dumps(v))
d = tempfile.mkdtemp()
for r in spec["records"]:
    dryrun._write(r, d)
out["names"] = sorted(os.listdir(d))
small = dataclasses.replace(svm, **spec["small"])
mesh8 = Mesh(np.array(jax.devices()[:8]).reshape(8, 1), ("data", "model"))
for sh in ("allgather", "ring"):
    b = steps.build_svm_round_step(small, mesh8, sh)
    with compat.set_mesh(mesh8):
        c = jax.jit(b.fn,
                    in_shardings=compat.to_shardings(mesh8, b.in_shardings),
                    out_shardings=compat.to_shardings(mesh8,
                                                      b.out_shardings)
                    ).lower(*b.args).compile()
    out["stats"][sh] = collective_stats(c.as_text())
print("RESULT " + json.dumps(out))
"""

_PORT_CHILD = r"""
import dataclasses, json, os, sys
import torch
torch.set_num_threads(1)
from repro_torch import compat
from repro_torch.analysis import collective_schedule, lint
from repro_torch.configs import get_config
from repro_torch.launch import dryrun, steps
from repro_torch.launch.hlo_analysis import collective_stats
from repro_torch.launch.probes import build_probes, measure_probes
tmp, spec = sys.argv[1], json.loads(sys.argv[2])
out = {}
# the twins of tests/test_dryrun.py, through the CLI
for key, argv in (("decode", ["--arch", "qwen2-1.5b", "--shape",
                              "decode_32k"]),
                  ("skip", ["--arch", "llama3-8b", "--shape", "long_500k"]),
                  ("multipod", ["--arch", "tinyllama-1.1b", "--shape",
                                "decode_32k", "--multi-pod"]),
                  ("train", ["--arch", "llama3-8b", "--shape", "train_4k"])):
    d = os.path.join(tmp, key)
    rc = dryrun.main(argv + ["--device", "cpu", "--out", d])
    (name,) = os.listdir(d)
    with open(os.path.join(d, name)) as f:
        out[key] = {"rc": rc, "record": json.load(f)}
# the probe's arithmetic: qwen2-1.5b cut to one layer
one = dataclasses.replace(get_config("qwen2-1.5b"), num_layers=1)
shape = steps.INPUT_SHAPES["decode_32k"]
with dryrun.fake_group(256):
    mesh = compat.rank_mesh(("data", "model"), (16, 16))
    b = steps.build_serve_step(one, mesh, shape)
    full = collective_stats(dryrun.lower(b, mesh)["record"])
    probe = measure_probes(build_probes(one, mesh, shape, bundle=b), mesh)
out["one_layer"] = {"full": full,
                    "probe": probe["layer_decode"]["collectives"]}
# rank 0 and rank 5 of a shape-only svm round
svm = get_config("svm-tfidf")
for rank in (0, 5):
    for shuffle in ("ring", "hier"):
        with dryrun.fake_group(256, rank=rank):
            mesh = compat.rank_mesh(("data", "model"), (16, 16))
            rec = dryrun.lower(dryrun.build_bundle(svm, "svm", mesh,
                                                   shuffle=shuffle),
                               mesh)["record"]
        out[f"schedule/{shuffle}/{rank}"] = repr(collective_schedule(rec))
# the round's collectives at 8 ranks, the reference child's size
small = dataclasses.replace(svm, **spec["small"])
with dryrun.fake_group(8):
    mesh = compat.rank_mesh(("data", "model"), (8, 1))
    out["stats"] = {sh: collective_stats(dryrun.lower(
        steps.build_svm_round_step(small, mesh, sh), mesh)["record"])
        for sh in ("allgather", "ring")}
# lint --artifacts on fresh artifacts, then on one count edited
d = os.path.join(tmp, "artifacts")
for kind in ("svm", "svm_sweep"):
    dryrun.run_one("svm-tfidf", kind, False, out_dir=d, verbose=False,
                   device="cpu", shuffle="ring")
out["lint_ok"] = lint.main(["--artifacts", d])
path = os.path.join(d, "dryrun_svm_tfidf_svm_16x16_baseline_ring.json")
with open(path) as f:
    rec = json.load(f)
rec["collectives"]["collective-permute"]["count"] += 1
with open(path, "w") as f:
    json.dump(rec, f)
out["lint_stale"] = lint.main(["--artifacts", d])
# run_one in a process whose group is up
with dryrun.fake_group(4):
    try:
        dryrun.run_one("svm-tfidf", "svm", False, out_dir=d, verbose=False,
                       device="cpu")
        out["refused"] = None
    except RuntimeError as e:
        out["refused"] = str(e)
print("RESULT " + json.dumps(out))
"""


def _env():
    from conftest import subprocess_env
    return subprocess_env(PYTHONPATH=str(REPO / "src"))


def _spec():
    return json.dumps({"lm_shapes": LM_SHAPES, "per_host": PER_HOST,
                       "records": RECORDS, "small": SMALL})


@pytest.fixture(scope="module")
def children(tmp_path_factory):
    """The reference's and the port's children, started together when
    the module starts; ``result(name)`` is the child's JSON."""
    tmp = tmp_path_factory.mktemp("dryrun")
    started = {
        "ref": subprocess.Popen(
            [sys.executable, "-c", _REF_CHILD, _spec()], cwd=str(REPO),
            env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True),
        "port": subprocess.Popen(
            [sys.executable, "-c", _PORT_CHILD, str(tmp), _spec()],
            cwd=str(REPO), env=_env(), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)}
    results = {}

    def result(name):
        if name not in results:
            try:
                out, _ = started[name].communicate(timeout=CHILD_S)
            except subprocess.TimeoutExpired:
                started[name].kill()
                raise
            lines = [ln for ln in out.splitlines()
                     if ln.startswith("RESULT ")]
            assert started[name].returncode == 0 and lines, out[-4000:]
            results[name] = json.loads(lines[-1][len("RESULT "):])
        return results[name]
    try:
        yield result
    finally:
        for p in started.values():
            if p.poll() is None:
                p.kill()
                p.wait()


@pytest.fixture(scope="module")
def ref_child(children):
    return children("ref")


@pytest.fixture(scope="module")
def port_child(children):
    return children("port")


# ---------------------------------------------------------------------------
# twins of tests/test_dryrun.py
# ---------------------------------------------------------------------------

def test_dryrun_small_arch_decode(port_child):
    got = port_child["decode"]
    rec = got["record"]
    assert got["rc"] == 0, rec.get("error")
    assert rec["status"] == "ok"
    assert rec["chips"] == 256
    assert rec["roofline"]["memory_s"] > 0
    assert rec["dominant"] in ("compute_s", "memory_s", "collective_s")
    # rank 0 ran flash_decode's shape rule once a layer
    assert rec["kernels"]["flash_decode/tensor_core"]["launches"] == 28


def test_dryrun_skip_reason_recorded(port_child):
    got = port_child["skip"]
    assert got["rc"] == 0
    assert got["record"]["status"] == "skip"
    assert "sub-quadratic" in got["record"]["reason"]


def test_dryrun_multipod_mesh(port_child):
    got = port_child["multipod"]
    rec = got["record"]
    assert got["rc"] == 0, rec.get("error")
    assert rec["status"] == "ok"
    assert rec["chips"] == 512
    assert rec["mesh"] == "2x16x16"


def test_open_entries_record_the_item_that_names_them(port_child):
    got = port_child["train"]
    assert got["rc"] == 1
    assert got["record"]["status"] == "error"
    assert "13g-c" in got["record"]["error"]


# ---------------------------------------------------------------------------
# the reference's arithmetic
# ---------------------------------------------------------------------------

def test_model_flops_equal_the_references(ref_child):
    want = ref_child["model_flops"]
    lm = [a for a in PORTED_ARCHS if a != "svm_tfidf"]
    assert sorted(want) == sorted(lm)
    for arch in lm:
        cfg = get_config(arch)
        for s in LM_SHAPES:
            assert dryrun._model_flops(cfg, steps.INPUT_SHAPES[s]) \
                == want[arch][s], (arch, s)


def test_roofline_arithmetic_is_the_references(monkeypatch):
    """roofline_terms, dominant_term, combine_with_layer and
    total_collective_bytes: the reference's functions with the port's
    card constants in place of its TPU ones give the port's numbers."""
    from repro.launch import hlo_analysis as jha
    monkeypatch.setattr(jha, "PEAK_FLOPS_BF16", tmesh.PEAK_FLOPS_BF16)
    monkeypatch.setattr(jha, "HBM_BW", tmesh.HBM_BW)
    monkeypatch.setattr(jha, "ICI_BW", tmesh.LINK_BW)
    assert (tmesh.PEAK_FLOPS_BF16, tmesh.HBM_BW, tmesh.LINK_BW) == \
        (989.4e12, 3.35e12, 450e9)
    for args in ((2.1e15, 8.6e13, 4.1e9, 256), (3.0e12, 1.0e9, 0.0, 512),
                 (1.0, 5e12, 2e11, 1)):
        assert tha.roofline_terms(*args) == jha.roofline_terms(*args)
        terms = tha.roofline_terms(*args)
        assert tha.dominant_term(terms) == jha.dominant_term(terms)
    full = {"all-reduce": {"count": 3, "operand_bytes": 10.0,
                           "output_bytes": 10.0, "wire_bytes": 17.5},
            "all-gather": {"count": 1, "operand_bytes": 4.0,
                           "output_bytes": 64.0, "wire_bytes": 60.0}}
    layer = {"all-gather": {"count": 9, "operand_bytes": 2.5,
                            "output_bytes": 40.0, "wire_bytes": 37.5},
             "collective-permute": {"count": 2, "operand_bytes": 8.0,
                                    "output_bytes": 8.0,
                                    "wire_bytes": 8.0}}
    for trips in (0, 1, 31):
        assert tha.combine_with_layer(full, layer, trips) == \
            jha.combine_with_layer(full, layer, trips)
    for key in ("operand_bytes", "wire_bytes"):
        assert tha.total_collective_bytes(full, key) == \
            jha.total_collective_bytes(full, key)


def _port_bundle(kind, shuffle, fmt, mesh):
    cfg = dataclasses.replace(get_config("svm-tfidf"), row_format=fmt)
    return dryrun.build_bundle(cfg, kind, mesh, shuffle=shuffle)


def test_per_host_abstract_is_the_references(ref_child):
    """The inputs each of 2 and 4 processes makes, for the svm round,
    sweep and serve bundles and llama3-8b's decode bundle, equal the
    reference's; 3 processes raise the same ValueError."""
    mesh = tmesh.make_production_mesh()
    bundles = [(name, _port_bundle(kind, shuffle, fmt, mesh))
               for name, kind, shuffle, fmt in PER_HOST]
    bundles.append(("decode_llama3_8b", steps.build_serve_step(
        get_config("llama3-8b"), mesh, steps.INPUT_SHAPES["decode_32k"])))
    for name, b in bundles:
        for n in (2, 3, 4):
            try:
                got = json.loads(json.dumps(dryrun._fmt_tree(
                    steps.per_host_abstract(b.args, b.in_shardings, mesh,
                                            n))))
            except ValueError as e:
                got = "ValueError: " + str(e)
            assert got == ref_child["per_host"][f"{name}/{n}"], (name, n)
    assert ref_child["per_host"]["decode_llama3_8b/3"].startswith(
        "ValueError")


def test_artifact_names_are_the_references(ref_child, tmp_path):
    for r in RECORDS:
        dryrun._write(r, str(tmp_path))
    assert sorted(os.listdir(tmp_path)) == ref_child["names"]


# ---------------------------------------------------------------------------
# the port's records against the reference's compiled programs
# ---------------------------------------------------------------------------

def test_ranks_record_the_same_schedule(port_child):
    for shuffle in ("ring", "hier"):
        a = port_child[f"schedule/{shuffle}/0"]
        assert a and a == port_child[f"schedule/{shuffle}/5"]


def test_round_collectives_at_8_ranks_against_the_references(port_child,
                                                             ref_child):
    """The svm round at d 512, 64 rows and 32 SV slots on 8 ranks: the
    port's count of each kind equals XLA's for the compiled round, and
    the ring's permuted bytes equal. The port's all-reduce vector
    carries the eq. 7 sums, the row count and the wire-check lane (the
    reference's fewer: 8 bytes less); its all-gather moves the
    candidate rows, labels and mask in the rows' dtype (bf16), where the
    reference's promote them to f32 (4112 bytes more). The port's pmax
    gathers every rank's vector (its wire x·(g − 1))."""
    got, want = port_child["stats"], ref_child["stats"]
    for sh in ("allgather", "ring"):
        assert {k: v["count"] for k, v in got[sh].items()} == \
            {k: v["count"] for k, v in want[sh].items()}
    assert got["ring"]["collective-permute"] == \
        want["ring"]["collective-permute"]
    pinned = {"allgather": {"all-reduce": (2, 168.0),
                            "all-gather": (7, 6196.0)},
              "ring": {"all-reduce": (2, 168.0),
                       "collective-permute": (7, 43484.0)}}
    for sh, kinds in pinned.items():
        for kind, (count, nbytes) in kinds.items():
            assert (got[sh][kind]["count"],
                    got[sh][kind]["operand_bytes"]) == (count, nbytes)
    assert want["allgather"]["all-gather"]["operand_bytes"] == 6196.0 + 4112
    assert want["ring"]["all-reduce"]["operand_bytes"] == 168.0 - 8


def test_probe_times_trips_plus_the_rest_is_the_full_step(port_child):
    """The reference's scan correction, full = probe × trips + the part
    outside the layers, holds for the port's records as they are: the
    28-layer step's count of each kind is the probe's × 28 plus the
    one-layer step's count less one probe."""
    rec = port_child["decode"]["record"]
    probe = rec["probes"]["layer_decode"]
    assert probe["extra_trips"] == 27
    one = port_child["one_layer"]
    assert one["probe"] == probe["collectives"]
    for kind, s in rec["collectives"].items():
        layer = probe["collectives"].get(kind, {}).get("count", 0)
        rest = one["full"][kind]["count"] - layer
        assert s["count"] == layer * (probe["extra_trips"] + 1) + rest, kind
        assert layer > 0


def test_lint_artifacts_gate(port_child):
    assert port_child["lint_ok"] == 0
    assert port_child["lint_stale"] == 1        # one count edited: stale


def test_run_one_refuses_with_a_group_up(port_child):
    assert "already up" in port_child["refused"]


def test_run_one_raises_without_a_card():
    """No ``--device cpu`` and no card: the dry run raises before it
    opens a group (it never falls back to a shape-only run)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.run_one("svm-tfidf", "svm", False, verbose=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.main(["--arch", "svm-tfidf", "--shape", "svm"])


# ---------------------------------------------------------------------------
# the kernels' shape rules
# ---------------------------------------------------------------------------

def _sparse(lead, cap, d, dtype, gen):
    idx = torch.randint(0, d, (*lead, cap), generator=gen,
                        dtype=torch.int32)
    return sparse_rows.SparseRows(idx, torch.rand((*lead, cap),
                                                  generator=gen).to(dtype),
                                  d)


def _calls(gen):
    """Each wrapper on the path, with small real CPU inputs."""
    L, per, S, d = 3, 20, 6, 64
    out = []
    for dt in (torch.float32, torch.bfloat16):
        xh = torch.rand((1, per, d), generator=gen).to(dt)
        xs = torch.rand((L, S, d), generator=gen).to(dt)
        y = torch.where(torch.rand((L, per + S), generator=gen) < 0.5,
                        -1.0, 1.0)
        m = torch.ones((L, per + S))
        kw = dict(C=1.0, tol=1e-3, max_epochs=3)
        out.append(("cd_solve", (xh, xs, y, m), kw))
        X = xh[0]
        W = torch.randn((10, d), generator=gen)
        out.append(("hinge_scores", (X, W, torch.randn(10, generator=gen),
                                     y[0, :per], m[0, :per]), {}))
        q = torch.randn((2, 4, 16), generator=gen).to(dt)
        k = torch.randn((2, 2, 33, 16), generator=gen).to(dt)
        out.append(("decode_attention",
                    (q, k, torch.randn_like(k),
                     torch.tensor(20, dtype=torch.int32)), {}))
    xh = _sparse((1, per), 8, d, torch.bfloat16, gen)
    xs = _sparse((L, S), 8, d, torch.bfloat16, gen)
    out.append(("cd_solve", (xh, xs, y, m), dict(C=torch.ones(L) * 0.5,
                                                 tol=1e-3, max_epochs=2)))
    out.append(("hinge_scores", (xh[0], torch.randn((3, d), generator=gen),
                                 torch.zeros(3), y[0, :per], m[0, :per]),
                {}))
    return out


def _to_meta(a):
    if sparse_rows.is_sparse(a):
        return sparse_rows.SparseRows(_to_meta(a.indices),
                                      _to_meta(a.values), a.d)
    return a.to("meta") if isinstance(a, torch.Tensor) else a


def _sig(out):
    flat = out if isinstance(out, tuple) else (out,)
    return [(tuple(t.shape), t.dtype) for t in flat]


@pytest.mark.parametrize("mode", ["meta", "fake"])
def test_shape_rules_give_the_plain_versions_shapes(mode):
    """Each wrapper on meta and fake inputs returns its kernel's outputs
    with the shapes and dtypes its plain version returns on real CPU
    tensors, launches nothing, and records its work (a launch of the
    route it would count)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    gen = torch.Generator().manual_seed(0)
    for name, args, kw in _calls(gen):
        want = _sig(getattr(ops, name)(*args, **kw))
        ops.reset_launches()
        with ops.record_kernel_work() as work:
            if mode == "meta":
                got = getattr(ops, name)(*(_to_meta(a) for a in args), **{
                    k: _to_meta(v) for k, v in kw.items()})
            else:
                with FakeTensorMode() as fm:
                    fake = [dryrun.tree_map_tensors(fm.from_tensor, a)
                            for a in args]
                    fkw = {k: dryrun.tree_map_tensors(fm.from_tensor, v)
                           for k, v in kw.items()}
                    got = getattr(ops, name)(*fake, **fkw)
        assert _sig(got) == want, name
        assert sum(ops.ROUTE_LAUNCHES.values()) == 0
        wrapper = {"decode_attention": "flash_decode"}.get(name, name)
        assert work and all(w.name == wrapper and w.flops > 0
                            and w.nbytes > 0 for w in work), name
        if name == "cd_solve":
            assert work[0].epochs == (None if isinstance(
                kw["max_epochs"], torch.Tensor) else kw["max_epochs"])


def test_shape_rules_record_the_bound_formulas():
    """The rules' work is PERF.md's bound arithmetic: hinge_scores of 10
    hypotheses is two launches (8 + 2); flash_decode reads K and V
    once."""
    B, H, KV, S, hd = 2, 4, 2, 33, 16
    q = torch.empty((B, H, hd), dtype=torch.bfloat16, device="meta")
    k = torch.empty((B, KV, S, hd), dtype=torch.bfloat16, device="meta")
    valid = torch.empty((), dtype=torch.int32, device="meta")
    n, d = 20, 64
    X = torch.empty((n, d), dtype=torch.bfloat16, device="meta")
    W = torch.empty((10, d), device="meta")
    v = torch.empty((n,), device="meta")
    with ops.record_kernel_work() as work:
        ops.decode_attention(q, k, k, valid)
        ops.hinge_scores(X, W, torch.empty((10,), device="meta"), v, v)
    fd, h8, h2 = work
    assert (fd.flops, fd.nbytes) == (4.0 * B * H * S * hd,
                                     2 * B * KV * S * hd * 2
                                     + 2 * B * H * hd * 2 + 4)
    assert (h8.route, h8.flops, h2.flops) == ("tensor_core",
                                             2.0 * n * d * 8,
                                             2.0 * n * d * 2)
    assert h2.nbytes == n * d * 2 + 2 * d * 4 + 2 * 4 + 2 * n * 4 + 2 * 4 + 4


def test_shape_rules_refuse_a_mix_of_real_and_shape_only():
    X = torch.zeros((4, 8))
    with pytest.raises(ValueError, match="mixes shape-only and real"):
        ops.hinge_scores(X, torch.zeros((1, 8), device="meta"),
                         torch.zeros(1), torch.zeros(4), torch.ones(4))


def test_column_id_check_skips_only_shape_only_rows():
    gen = torch.Generator().manual_seed(1)
    bad = _sparse((4,), 3, 16, torch.float32, gen)
    bad.indices[0, 0] = 99
    meta = _to_meta(bad)
    ops.check_column_ids(meta)                   # nothing to read
    with pytest.raises(ValueError, match="column ids outside"):
        ops.check_column_ids(bad)
