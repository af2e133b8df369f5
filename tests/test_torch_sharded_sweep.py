"""The port's sharded sweep (``build_sharded_sweep_round`` /
``run_sharded_sweep`` on ``torch.distributed``) against the JAX
package, on the CPU.

One module-scoped spawn of 8 gloo ranks (``repro_torch.compat.spawn``,
the package's rank target ``repro_torch.launch.sharded.run_cases`` with
sweep cases only, so the ranks import neither JAX nor this module) runs
every case at the reference's golden size (n = 512, d = 12,
sv_capacity 64, its grids): the allgather, ring and hier transports on
shared rows (the ring and hier state is the shared-row ``DedupChunk``),
configs that converge at different rounds, per-stream rows (a
streaming wave), blocked-CSR rows beside the same rows dense, bf16 rows
on a bf16 wire, a NaN row, and a round state saved at round 1 and
resumed. While it runs, a child process runs the reference's own
``run_sharded_sweep`` on an 8-device CPU mesh for the f32 ring and the
per-stream wave, and ``repro.core``'s functional sweep of each case (in
a process of its own: in an xdist worker that had run other files the
in-process JAX sweep of the freeze cases once gave other SV ids). The
tests hold each case to that functional sweep with the reference's
limits (risks and ws rtol 1e-4 /
atol 1e-5; ids, rounds and best equal), to the port's functional sweep,
and the packed transports to allgather bit for bit. In-process tests
hold the dedup format, the round state's shapes and dtypes, the
checkpoints, ``simulated_hier_hosts`` and the service's transport to
the reference's, and count a round's solve launches and readbacks."""
import dataclasses
import json
import os
import re
import subprocess
import sys
import tempfile
import time
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import repro.core as J
import repro_torch.core as T
from repro import faults as jfaults
from repro.core import mapreduce_svm as jmr
from repro.core import sweep as jsw
from repro.data import svm_rows
from repro.launch import mesh as jmesh
from repro.serving import StreamingSVMService as JService
from repro_torch import compat
from repro_torch import sparse as tsp
from repro_torch.ckpt import checkpoint as tckpt
from repro_torch.core import sweep as tsw
from repro_torch.kernels import ops
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import serve
from repro_torch.launch.sharded import SweepCase, fit_sharded_sweep, run_cases
from repro_torch.serving import StreamingSVMService

REPO = Path(__file__).resolve().parents[1]
NDEV = 8
N, D = 512, 12
# the reference's own limits (tests/test_sweep.py)
RTOL, ATOL = 1e-4, 1e-5

GOLDEN = dict(sv_capacity=64, gamma=1e-4, max_rounds=3,
              svm=dict(C=1.0, max_epochs=15))
# an eq. 8 gamma that makes the configs converge at different rounds, so
# the frozen snapshots of the dedup state are exercised
FREEZE = dict(sv_capacity=64, gamma=5e-3, max_rounds=6,
              svm=dict(C=1.0, max_epochs=15))
GRIDS = {"golden": dict(C=[0.05, 0.5, 1.0, 5.0], tol=[1e-3, 1e-2]),
         "freeze": dict(C=[1e-4, 0.5, 1.0, 5.0]),
         "stream": dict(C=[0.1, 0.5, 1.0, 2.0])}
F32_WIRE = dict(shuffle_wire_dtype="float32")


def _cfgs(base, **kw):
    """The same config for both packages: (torch, JAX)."""
    svm = dict(base["svm"])
    svm.update(kw.pop("svm", {}))
    top = {k: v for k, v in base.items() if k != "svm"}
    top.update(kw)
    return (T.MRSVMConfig(svm=T.SVMConfig(**svm), **top),
            J.MRSVMConfig(svm=J.SVMConfig(**svm), **top))


def _bf16(X):
    return torch.from_numpy(X).bfloat16().float().numpy()


def _data():
    rng = np.random.default_rng(0)
    X = rng.normal(size=(N, D)).astype(np.float32)
    w = np.random.default_rng(1).normal(size=D).astype(np.float32)
    y = np.sign(X @ w).astype(np.float32)
    Xs = np.random.default_rng(3).normal(size=(4, N, D)).astype(np.float32)
    ws = np.random.default_rng(4).normal(size=(4, D)).astype(np.float32)
    ys = np.sign(np.einsum("snd,sd->sn", Xs, ws)).astype(np.float32)
    Xsp, ysp = svm_rows(N, 64, seed=3, nnz=8)
    Xsp, ysp = np.asarray(Xsp, np.float32), np.asarray(ysp, np.float32)
    sp = tsp.from_dense(torch.from_numpy(Xsp), 16)
    Xb = _bf16(X)
    yb = np.sign(Xb @ w).astype(np.float32)
    Xn = X.copy()
    Xn[37, 5] = np.nan
    return {"dense": (X, y), "stream": (Xs, ys),
            "sparse": ((sp.indices.numpy(), sp.values.numpy(), 64), ysp),
            "sparse_dense": (Xsp, ysp), "bf16": (Xb, yb), "nan": (Xn, y)}


SPARSE = dict(svm=dict(row_format="sparse_csr", nnz_cap=16))


def _specs():
    """name → (data key, grid, torch cfg, JAX cfg, SweepCase kwargs)."""
    specs = {
        "golden-allgather": ("dense", "golden", *_cfgs(GOLDEN), {}),
        "golden-ring": ("dense", "golden",
                        *_cfgs(GOLDEN, shuffle_impl="ring", **F32_WIRE), {}),
        "stream-allgather": ("stream", "stream", *_cfgs(FREEZE),
                             dict(per_config_data=True)),
        "stream-ring": ("stream", "stream",
                        *_cfgs(FREEZE, shuffle_impl="ring", **F32_WIRE),
                        dict(per_config_data=True, rounds=3)),
        "sparse-allgather": ("sparse", "freeze",
                             *_cfgs(FREEZE, **F32_WIRE, **SPARSE), {}),
        "sparse-ring": ("sparse", "freeze",
                        *_cfgs(FREEZE, shuffle_impl="ring", **F32_WIRE,
                               **SPARSE), {}),
        "sparse_dense-ring": ("sparse_dense", "freeze",
                              *_cfgs(FREEZE, shuffle_impl="ring",
                                     **F32_WIRE), {}),
        "bf16-ring": ("bf16", "freeze", *_cfgs(FREEZE, shuffle_impl="ring"),
                      dict(dtype="bfloat16")),
        "bf16-hier": ("bf16", "freeze",
                      *_cfgs(FREEZE, shuffle_impl="hier", hier_num_hosts=2),
                      dict(dtype="bfloat16")),
    }
    for impl, hosts in (("allgather", None), ("ring", None), ("hier", 2)):
        specs[f"freeze-{impl}"] = (
            "dense", "freeze", *_cfgs(FREEZE, shuffle_impl=impl,
                                      hier_num_hosts=hosts, **F32_WIRE),
            dict(rounds=3, resume_round=1))
    for impl in ("allgather", "ring"):
        specs[f"nan-{impl}"] = ("nan", "golden",
                                *_cfgs(GOLDEN, shuffle_impl=impl,
                                       **F32_WIRE), {})
    return specs


SPECS = _specs()
NAMES = list(SPECS)


def _grid(pkg, cfg, name):
    return pkg.sweep_grid(cfg.svm, **GRIDS[name])


def _cases(data):
    cases = []
    for name, (key, grid, t_cfg, _, kw) in SPECS.items():
        X, y = data[key]
        cases.append(SweepCase(name, t_cfg, X, y, _grid(tsw, t_cfg, grid),
                               **kw))
    return cases


# ---------------------------------------------------------------------------
# the reference's own sharded sweep, in a child process with 8 CPU devices
# ---------------------------------------------------------------------------

_CHILD = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import dataclasses as dc
import json
import jax, jax.numpy as jnp, numpy as np
# The reference's round loop hands its host ``done`` mask to jnp and then
# updates it in place (``done |= newly``); on the CPU ``jnp.asarray`` of
# a numpy array may share its memory, so under asynchronous dispatch a
# still-pending freeze select can read the updated mask and freeze a
# config one round early. Synchronous dispatch runs each call to its end
# before the host goes on: the loop's intended order, every run.
jax.config.update("jax_cpu_enable_async_dispatch", False)
from repro import compat
from repro.core import (MRSVMConfig, SVMConfig, sweep_grid,
                        build_sharded_sweep_round, fit_mapreduce_sweep,
                        run_sharded_sweep)

data = dict(np.load(sys.argv[1]))
X, y, Xs, ys = (jnp.asarray(data[k])
                for k in ("dense_X", "dense_y", "stream_X", "stream_y"))
n, d = X.shape
cfg_a = MRSVMConfig(sv_capacity=64, gamma=5e-3, max_rounds=6,
                    svm=SVMConfig(C=1.0, max_epochs=15))
cfg_r = dc.replace(cfg_a, shuffle_impl="ring", shuffle_wire_dtype="float32")
mesh = compat.make_mesh((8,), ("data",))
out = {}


def run(tag, fn, Xq, yq, mq, params, S):
    res = run_sharded_sweep(fn, Xq, yq, mq, cfg_r, params)
    for k in ("risks", "ws", "bs", "rounds"):
        out[f"{tag}/{k}"] = np.asarray(getattr(res, k))
    out[f"{tag}/ids"] = np.asarray(res.sv.ids)
    out[f"{tag}/alpha"] = np.asarray(res.sv.alpha, np.float32)
    out[f"{tag}/best"] = np.asarray(res.best)
    state = fn.init_sv(S, d)
    for t in range(3):
        state, risks, w, b = fn(Xq, yq, mq, state, params)
        sv = fn.expand_sv(state) if fn.expand_sv is not None else state
        out[f"{tag}/{t}/risks"] = np.asarray(risks)
        out[f"{tag}/{t}/ids"] = np.asarray(sv.ids)
        out[f"{tag}/{t}/alpha"] = np.asarray(sv.alpha, np.float32)
        if hasattr(state, "ptr"):
            out[f"{tag}/{t}/ptr"] = np.asarray(state.ptr)


# the functional sweeps the tests hold the port to, here in a process of
# their own: in a test process they can read state an earlier test file
# left in it (an xdist worker runs many files)
for tag, (key, grid, cfg_d, dt) in json.loads(sys.argv[3]).items():
    svm = SVMConfig(**cfg_d.pop("svm"))
    dt = jnp.dtype(dt)
    Xq, yq = (data[f"{key}_{k}"] for k in ("X", "y"))
    res = fit_mapreduce_sweep(jnp.asarray(Xq, dt), jnp.asarray(yq, dt), 8,
                              MRSVMConfig(svm=svm, **cfg_d),
                              sweep_grid(svm, **grid),
                              mask=jnp.ones(yq.shape, dt))
    for k in ("risks", "ws", "rounds", "best"):
        out[f"fn/{tag}/{k}"] = np.asarray(getattr(res, k))
    out[f"fn/{tag}/ids"] = np.asarray(res.sv.ids)
    out[f"fn/{tag}/alpha"] = np.asarray(res.sv.alpha, np.float32)

fr = build_sharded_sweep_round(mesh, ("data",), cfg_r, n // 8)
run("ring", fr, X, y, jnp.ones((n,)),
    sweep_grid(cfg_a.svm, C=[1e-4, 0.5, 1.0, 5.0]), 4)
fs = build_sharded_sweep_round(mesh, ("data",), cfg_r, n // 8,
                               per_config_data=True)
run("stream", fs, Xs, ys, jnp.ones((4, n)),
    sweep_grid(cfg_a.svm, C=[0.1, 0.5, 1.0, 2.0]), 4)
np.savez(sys.argv[2], **out)
print("CHILD_OK")
"""


@pytest.fixture(scope="module")
def data():
    return _data()


@pytest.fixture(scope="module")
def runs(data):
    """Every sweep case on 8 gloo ranks in one spawn, with the reference's
    sharded sweep running beside it in a child process. → (per rank the
    results of ``run_cases``, the child's outputs by key)."""
    from conftest import subprocess_env
    tmp = tempfile.mkdtemp(prefix="sharded_sweep_")
    inp, outp = os.path.join(tmp, "in.npz"), os.path.join(tmp, "out.npz")
    np.savez(inp, **{f"{key}_{k}": data[key][i]
                     for key in ("dense", "stream", "sparse_dense", "bf16")
                     for i, k in enumerate("Xy")})
    child = subprocess.Popen(
        [sys.executable, "-c", _CHILD, inp, outp,
         json.dumps(_functional_specs())], cwd=str(REPO),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=subprocess_env(PYTHONPATH=str(REPO / "src")))
    try:
        t0 = time.monotonic()
        out = compat.spawn(run_cases, NDEV, ([], (), None, _cases(data)),
                           device="cpu", timeout_s=120.0,
                           join_timeout_s=300.0)
        assert time.monotonic() - t0 < 300.0
        stdout, stderr = child.communicate(timeout=600)
    finally:
        if child.poll() is None:
            child.kill()
    assert "CHILD_OK" in stdout, stdout + stderr
    with np.load(outp) as f:
        ref = {k: f[k] for k in f.files}
    return out, ref


def _sweep(runs, name, rank=0):
    return runs[0][rank]["sweeps"][NAMES.index(name)]


def _functional_key(name):
    """The rows, grid, JAX config and dtype of ``repro.core.
    fit_mapreduce_sweep`` on case ``name``'s rows (dense for the
    blocked-CSR case; the transport fields do not enter it), as the tag
    of its result in the child process and its arguments there."""
    key, grid, _, j_cfg, kw = SPECS[name]
    key = "sparse_dense" if key == "sparse" else key
    cfg = dataclasses.replace(
        j_cfg, shuffle_impl="allgather", hier_num_hosts=None,
        shuffle_wire_dtype="float32",
        svm=dataclasses.replace(j_cfg.svm, row_format="dense", nnz_cap=0))
    assert cfg.svm.kernel == J.SVMConfig().kernel
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    fields["svm"] = {f.name: getattr(cfg.svm, f.name)
                     for f in dataclasses.fields(cfg.svm) if f.name != "kernel"}
    dt = kw.get("dtype", "float32")
    return f"{key}|{grid}|{dt}", (key, GRIDS[grid], fields, dt)


def _functional_specs():
    return dict(_functional_key(n) for n in NAMES
                if not n.startswith("nan"))


def _jax_sweep(runs, name):
    """``repro.core.fit_mapreduce_sweep`` on the case's rows, as the
    child process of ``runs`` computed it: its risks, ws, rounds, best
    and SV ids and α (float32)."""
    ref = runs[1]
    tag = _functional_key(name)[0]
    get = {k: ref[f"fn/{tag}/{k}"] for k in ("risks", "ws", "rounds",
                                             "best", "ids", "alpha")}
    return types.SimpleNamespace(
        risks=get["risks"], ws=get["ws"], rounds=get["rounds"],
        best=int(get["best"]),
        sv=types.SimpleNamespace(ids=get["ids"], alpha=get["alpha"]))


_PORT = {}


def _port_sweep(data, name):
    """The port's functional sweep on the case's rows, on the CPU."""
    key, grid, t_cfg, _, kw = SPECS[name]
    cfg = dataclasses.replace(t_cfg, shuffle_impl="allgather",
                              hier_num_hosts=None)
    jk = (key, grid, cfg, kw.get("dtype", "float32"))
    if jk not in _PORT:
        X, y = data[key]
        if isinstance(X, tuple):
            X = tsp.SparseRows(*(torch.from_numpy(a) for a in X[:2]), X[2])
        else:
            X = torch.from_numpy(X).to(getattr(torch, jk[3]))
        _PORT[jk] = T.fit_mapreduce_sweep(X, y, NDEV, cfg,
                                          _grid(tsw, cfg, grid),
                                          mask=np.ones(y.shape, np.float32),
                                          device="cpu")
    return _PORT[jk]


def _as_np(a):
    """A torch tensor or JAX array as numpy, bf16 as float32."""
    if isinstance(a, torch.Tensor):
        return (a.float() if a.dtype == torch.bfloat16 else a).numpy()
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype == jnp.bfloat16 else a


def _dense_x(x):
    """Feature rows as numpy dense rows; blocked-CSR ``(indices, values,
    d)`` scattered (a dead slot's column ids are whatever row it copied,
    its values 0)."""
    if isinstance(x, tuple):
        idx, vals, d = x
        out = np.zeros(idx.shape[:-1] + (d,), np.float32)
        np.put_along_axis(out, idx.astype(np.int64), 0.0, -1)
        lead = np.indices(idx.shape)
        np.add.at(out, tuple(lead[:-1]) + (idx,), vals.astype(np.float32))
        return out
    return np.asarray(x, np.float32)


def _same_on_every_rank(runs, name):
    ref = _sweep(runs, name)

    def leaves(v):
        if isinstance(v, dict):
            return [x for k in sorted(v) for x in leaves(v[k])]
        if isinstance(v, (list, tuple)):
            return [x for u in v for x in leaves(u)]
        return [v]
    want = leaves({k: v for k, v in ref.items() if k != "ms"})
    for r in range(1, NDEV):
        got = _sweep(runs, name, r)
        got = leaves({k: v for k, v in got.items() if k != "ms"})
        assert len(got) == len(want)
        for a, b in zip(want, got):
            if isinstance(a, np.ndarray):
                np.testing.assert_array_equal(a, b, err_msg=f"rank {r}")
            else:
                assert a == b, (name, r)


@pytest.mark.parametrize("name", NAMES)
def test_every_rank_reads_the_same_sweep(runs, name):
    """The driven sweep, the rounds driven one by one and a detected
    fault are the same on every rank, bit for bit."""
    _same_on_every_rank(runs, name)
    assert _sweep(runs, name)["state"] == (
        "DedupChunk" if T.uses_dedup_state(SPECS[name][2],
                                           SPECS[name][4].get(
                                               "per_config_data", False))
        else "SVBuffer")


@pytest.mark.parametrize("name", NAMES)
def test_every_rank_records_the_same_valid_schedule(runs, name):
    """Each sweep case's collectives as every rank recorded them
    (``compat.record_collectives``; ``run_cases`` checked each valid):
    the same ordered schedule on all 8 ranks."""
    from repro_torch import analysis
    i = NAMES.index(name)
    analysis.assert_schedules_agree(
        {f"rank{r}": res["sweep_schedules"][i]
         for r, res in enumerate(runs[0])}, program=name)
    assert len(runs[0][0]["sweep_schedules"][i]) > 0


REFERENCE_CASES = [n for n in NAMES if not n.startswith(("nan", "bf16"))]


@pytest.mark.parametrize("name", REFERENCE_CASES)
def test_sweep_matches_the_reference_functional_sweep(runs, data, name):
    """Each driven sweep ≡ ``repro.core.fit_mapreduce_sweep`` on the same
    rows with the reference's own limits: risks and ws within 1e-4 /
    1e-5, SV ids, rounds and the selected config equal."""
    got = _sweep(runs, name)["sweep"]
    want = _jax_sweep(runs, name)
    np.testing.assert_allclose(got["risks"], np.asarray(want.risks),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got["ws"], np.asarray(want.ws), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_array_equal(got["sv"].ids, np.asarray(want.sv.ids))
    np.testing.assert_array_equal(got["rounds"], want.rounds)
    assert got["best"] == want.best


@pytest.mark.parametrize("name", REFERENCE_CASES)
def test_sweep_matches_the_ports_functional_sweep(runs, data, name):
    """Each driven sweep ≡ the port's ``fit_mapreduce_sweep`` on the same
    rows on the CPU: rounds, per-round picks, SV ids and α (in the
    state's dtype) bit for bit, per-round risks within 1e-6."""
    got = _sweep(runs, name)["sweep"]
    want = _port_sweep(data, name)
    np.testing.assert_array_equal(got["rounds"], want.rounds)
    np.testing.assert_array_equal(got["sv"].ids, want.sv.ids.numpy())
    np.testing.assert_array_equal(got["sv"].alpha,
                                  want.sv.alpha.float().numpy())
    assert len(got["history"]) == len(want.history)
    for a, b, h in zip(got["history"], got["reducers"], want.history):
        np.testing.assert_allclose(a, h["risks"], rtol=1e-6, atol=0)
        np.testing.assert_array_equal(b, h["reducers"])


PACKED = [("golden-ring", "golden-allgather"),
          ("freeze-ring", "freeze-allgather"),
          ("freeze-hier", "freeze-allgather"),
          ("stream-ring", "stream-allgather"),
          ("sparse-ring", "sparse-allgather")]


@pytest.mark.parametrize("name,base", PACKED)
def test_packed_transport_equals_allgather(runs, name, base):
    """Ring and hier (f32 wire; the dedup state on shared rows, per-config
    buffers on per-stream rows) ≡ allgather: rounds, SV ids, α and rows
    bit for bit, risks within 1e-6; the configs converge at different
    rounds."""
    a, b = _sweep(runs, name)["sweep"], _sweep(runs, base)["sweep"]
    np.testing.assert_array_equal(a["rounds"], b["rounds"])
    for k in ("ids", "alpha", "mask"):
        np.testing.assert_array_equal(getattr(a["sv"], k),
                                      getattr(b["sv"], k), err_msg=k)
    np.testing.assert_array_equal(_dense_x(a["sv"].x), _dense_x(b["sv"].x))
    np.testing.assert_allclose(a["risks"], b["risks"], rtol=1e-6, atol=0)
    np.testing.assert_array_equal(a["ws"], b["ws"])
    assert a["best"] == b["best"]
    if name.startswith("freeze"):
        assert len(set(a["rounds"].tolist())) > 1


def test_per_stream_wave_matches_both_functional_sweeps(runs, data):
    """Per-stream rows (a streaming wave's program,
    ``per_config_data=True``): ring ≡ allgather (above), and both ≡ the
    port's and JAX's functional sweep on per-config rows (above); here
    the streams' SV ids index their own rows, and no config shares a
    state row with another."""
    got = _sweep(runs, "stream-ring")
    assert got["state"] == "SVBuffer" and got["rounds"][0]["ptr"] is None
    want = _jax_sweep(runs, "stream-ring")
    np.testing.assert_array_equal(got["sweep"]["sv"].ids,
                                  np.asarray(want.sv.ids))
    assert got["sweep"]["sv"].x.shape == (4, 64, D)


def test_blocked_csr_rows_equal_the_same_rows_dense(runs):
    """Blocked-CSR rows (``nnz_cap`` 16) on the ring ≡ the same rows dense:
    the same rounds, SV ids and picks."""
    a, b = (_sweep(runs, n)["sweep"] for n in ("sparse-ring",
                                                "sparse_dense-ring"))
    np.testing.assert_array_equal(a["rounds"], b["rounds"])
    np.testing.assert_array_equal(a["sv"].ids, b["sv"].ids)
    for u, v in zip(a["reducers"], b["reducers"]):
        np.testing.assert_array_equal(u, v)
    np.testing.assert_allclose(a["risks"], b["risks"], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", ["bf16-ring", "bf16-hier"])
def test_bf16_rows_on_a_bf16_wire_hold_to_jax(runs, data, name):
    """bf16 rows on the bf16 wire (the svm-tfidf config's) ≡ JAX's
    functional sweep on the same bf16 rows: rounds and SV ids equal,
    risks within 1e-4 / 1e-5, α within bf16's rounding (the state keeps
    α in the rows' dtype, as the reference's packed state does)."""
    got = _sweep(runs, name)["sweep"]
    want = _jax_sweep(runs, name)
    np.testing.assert_array_equal(got["rounds"], want.rounds)
    np.testing.assert_array_equal(got["sv"].ids, np.asarray(want.sv.ids))
    np.testing.assert_allclose(got["risks"], np.asarray(want.risks),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got["sv"].alpha,
                               np.asarray(want.sv.alpha, np.float32),
                               rtol=8e-3, atol=ATOL)


@pytest.mark.parametrize("impl", ["allgather", "ring", "hier"])
def test_a_saved_round_state_resumes_bit_for_bit(runs, impl):
    """The state after round 1, saved (``save_sweep_state``) and restored
    (``restore_sweep_state``), drives round 2 to the uninterrupted run's
    state and outputs bit for bit."""
    got = _sweep(runs, f"freeze-{impl}")
    assert len(got["resumed"]) == 1
    for a, b in zip(got["rounds"][2:], got["resumed"]):
        for k in ("ids", "alpha", "mask", "x", "risks", "w", "b", "ptr"):
            if a[k] is None:
                assert b[k] is None
            else:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("impl", ["allgather", "ring"])
def test_nan_row_raises_at_the_references_round(runs, data, impl):
    """A NaN feature: ``FaultDetected("core")`` on every rank at the round
    where JAX's functional sweep raises its own."""
    X, y = data["nan"]
    _, grid, _, j_cfg, _ = SPECS[f"nan-{impl}"]
    with pytest.raises(jfaults.FaultDetected) as e:
        J.fit_mapreduce_sweep(jnp.asarray(X), jnp.asarray(y), NDEV, j_cfg,
                              _grid(J, j_cfg, grid))
    want = int(re.search(r"round (\d+)", str(e.value)).group(1))
    for r in range(NDEV):
        fault = _sweep(runs, f"nan-{impl}", r)["fault"]
        assert fault is not None and fault["layer"] == "core"
        assert int(re.search(r"round (\d+)", fault["cause"]).group(1)) \
            == want


@pytest.mark.parametrize("tag,name", [("ring", "freeze-ring"),
                                      ("stream", "stream-ring")])
def test_matches_the_references_own_sharded_sweep(runs, tag, name):
    """JAX's ``run_sharded_sweep`` on an 8-device CPU mesh, f32 ring: the
    port's driven sweep has its rounds, SV ids and selected config, α
    within 1e-4 / 1e-5; each of 3 rounds driven one by one has its ids,
    ``ptr`` (the dedup state's, on the global slot axis) and per-config
    picks."""
    _, ref = runs
    got = _sweep(runs, name)
    sw = got["sweep"]
    np.testing.assert_array_equal(sw["rounds"], ref[f"{tag}/rounds"])
    np.testing.assert_array_equal(sw["sv"].ids, ref[f"{tag}/ids"])
    np.testing.assert_allclose(sw["sv"].alpha, ref[f"{tag}/alpha"],
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(sw["risks"], ref[f"{tag}/risks"], rtol=RTOL,
                               atol=ATOL)
    assert sw["best"] == int(ref[f"{tag}/best"])
    for t, rd in enumerate(got["rounds"]):
        np.testing.assert_array_equal(rd["ids"], ref[f"{tag}/{t}/ids"])
        np.testing.assert_array_equal(rd["risks"].argmin(1),
                                      ref[f"{tag}/{t}/risks"].argmin(1))
        np.testing.assert_allclose(rd["alpha"], ref[f"{tag}/{t}/alpha"],
                                   rtol=RTOL, atol=ATOL)
        if f"{tag}/{t}/ptr" in ref:
            np.testing.assert_array_equal(rd["ptr"], ref[f"{tag}/{t}/ptr"])
        else:
            assert rd["ptr"] is None


def test_ranks_import_neither_jax_nor_the_reference(runs):
    assert all(r["modules"] == [] and r["backend"] == "gloo"
               for r in runs[0])


# ---------------------------------------------------------------------------
# in-process: the dedup format, the round state, checkpoints, topology
# ---------------------------------------------------------------------------

def _cand(seed, S, k, per, idx, ties):
    """Seeded (S, k) candidate chunks over ``per`` home rows (the
    reference's property-test generator); ``ties`` draws α from two
    values, so scores tie across rows and at the unique cut."""
    rng = np.random.default_rng(seed)
    d = 5
    Xl = rng.normal(0, 1, (per, d)).astype(np.float32)
    yl = np.where(rng.random(per) < 0.5, -1.0, 1.0).astype(np.float32)
    topi = np.stack([rng.choice(per, size=k, replace=False)
                     for _ in range(S)])
    live = (rng.random((S, k)) < 0.8).astype(np.float32)
    alpha = (rng.choice([0.5, 1.0], (S, k)) if ties
             else rng.uniform(1e-3, 1.0, (S, k))).astype(np.float32) * live
    ids = np.where(live > 0, idx * per + topi, -1).astype(np.int32)
    leaves = dict(x=Xl[topi] * live[..., None], y=yl[topi] * live,
                  alpha=alpha, ids=ids, mask=live)
    return Xl, yl, leaves


@pytest.mark.parametrize("seed,ties,evict", [
    (s, ties, evict) for s in range(4) for ties in (False, True)
    for evict in (False, True)])
@pytest.mark.parametrize("wire", ["float32", "bfloat16"])
def test_dedup_candidates_and_expand_match_the_reference(seed, ties, evict,
                                                         wire):
    """``dedup_candidates`` / ``expand_chunk`` ≡ the reference's on seeded
    numpy chunks, with score ties and with ``unique_cap`` below the
    lossless S·k (eviction decided by the tie order); at the lossless
    cap the round trip gives every config's chunk back exactly."""
    S, k, per, idx = 3, 4, 10, 2
    Xl, yl, lv = _cand(seed, S, k, per, idx, ties)
    U = 5 if evict else min(S * k, per)
    jc = jsw.dedup_candidates(
        jmr.SVBuffer(**{f: jnp.asarray(v) for f, v in lv.items()}),
        jnp.asarray(Xl), jnp.asarray(yl), idx, per, U,
        wire_dtype=jnp.dtype(wire))
    tc = T.dedup_candidates(
        T.SVBuffer(**{f: torch.from_numpy(v) for f, v in lv.items()}),
        torch.from_numpy(Xl), torch.from_numpy(yl), idx, per, U,
        wire_dtype=getattr(torch, wire))
    for f in jsw.DedupChunk._fields:
        assert str(getattr(tc, f).dtype).removeprefix("torch.") == \
            str(getattr(jc, f).dtype), f
        np.testing.assert_array_equal(_as_np(getattr(tc, f)),
                                      _as_np(getattr(jc, f)), err_msg=f)
    jb, tb = jsw.expand_chunk(jc), T.expand_chunk(tc)
    for f in jmr.SVBuffer._fields:
        np.testing.assert_array_equal(getattr(tb, f).numpy(),
                                      np.asarray(getattr(jb, f)), err_msg=f)
    if not evict and wire == "float32":
        for f, v in lv.items():
            np.testing.assert_array_equal(getattr(tb, f).numpy(), v,
                                          err_msg=f)
        live_ids = tc.ids[tc.ids >= 0].tolist()
        assert len(live_ids) == len(set(live_ids))


def _tree_sig(leaves):
    return {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
            for k, v in leaves.items()}


def _jax_leaves(tree):
    return {"||".join(str(p) for p in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("impl", ["allgather", "ring", "hier"])
@pytest.mark.parametrize("per_config", [False, True])
@pytest.mark.parametrize("fmt", ["dense", "sparse"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_state_has_the_references_shapes_dtypes_and_keys(
        impl, per_config, fmt, dtype):
    """``init_sharded_sweep_sv`` ≡ the reference's: the same flat
    checkpoint keys, shapes and dtypes for every transport ×
    ``per_config_data`` × row format × dtype."""
    kw = dict(shuffle_impl=impl, hier_num_hosts=2 if impl == "hier"
              else None)
    if fmt == "sparse":
        kw.update(SPARSE)
    t_cfg, j_cfg = _cfgs(GOLDEN, **kw)
    args = (3, 40, 8, 16)
    tree = T.init_sharded_sweep_sv(t_cfg, *args, getattr(torch, dtype),
                                   per_config_data=per_config, device="cpu")
    jtree = jsw.init_sharded_sweep_sv(j_cfg, *args, jnp.dtype(dtype),
                                      per_config_data=per_config)
    want = _tree_sig(_jax_leaves(jtree))
    assert _tree_sig(tckpt._leaves(tree)) == want
    assert type(tree).__name__ == type(jtree).__name__


def _filled(tree, seed):
    """``tree``'s leaves filled with seeded values of their dtype."""
    rng = np.random.default_rng(seed)

    def fill(_, leaf):
        if leaf.dtype == torch.int32:
            return torch.from_numpy(rng.integers(-1, 30, leaf.shape,
                                                 dtype=np.int32))
        return torch.from_numpy(rng.normal(size=leaf.shape)
                                .astype(np.float32)).to(leaf.dtype)
    return tckpt._map(tree, fill)


KINDS = {"dedup-dense-f32": (dict(shuffle_impl="ring"), False, "float32"),
         "dedup-sparse-bf16": (dict(shuffle_impl="hier", hier_num_hosts=2,
                                    **SPARSE), False, "bfloat16"),
         "allgather-f32": (dict(), False, "float32"),
         "stream-ring-bf16": (dict(shuffle_impl="ring"), True, "bfloat16")}


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("writer", ["port", "reference"])
def test_round_state_checkpoints_move_across_packages(tmp_path, kind,
                                                      writer):
    """A round state saved by either package's ``save_sweep_state``
    restores in the other's ``restore_sweep_state`` bit for bit (bf16
    leaves as their uint16 view, blocked-CSR rows as their two
    children)."""
    kw, per_config, dtype = KINDS[kind]
    t_cfg, j_cfg = _cfgs(GOLDEN, **kw)
    args = (3, 40, 8, 16)
    tree = _filled(T.init_sharded_sweep_sv(
        t_cfg, *args, getattr(torch, dtype), per_config_data=per_config,
        device="cpu"), 7)
    path = str(tmp_path / "sweep_1.npz")
    if writer == "port":
        T.save_sweep_state(path, tree, step=1)
        back = J.restore_sweep_state(path, j_cfg, *args, jnp.dtype(dtype),
                                     per_config_data=per_config)
        got = _jax_leaves(back)
    else:
        jtree = jax.tree_util.tree_unflatten(
            jax.tree_util.tree_structure(jsw.init_sharded_sweep_sv(
                j_cfg, *args, jnp.dtype(dtype),
                per_config_data=per_config)),
            [jnp.asarray(_as_np(v)).astype(
                jnp.bfloat16 if v.dtype == torch.bfloat16 else _as_np(v)
                .dtype) for v in tckpt._leaves(tree).values()])
        J.save_sweep_state(path, jtree, step=1)
        back = T.restore_sweep_state(path, t_cfg, *args,
                                     getattr(torch, dtype),
                                     per_config_data=per_config,
                                     device="cpu")
        got = tckpt._leaves(back)
    want = tckpt._leaves(tree)
    assert list(got) == list(want)
    for k, v in want.items():
        assert str(got[k].dtype).removeprefix("torch.") == \
            str(v.dtype).removeprefix("torch."), k
        np.testing.assert_array_equal(_as_np(got[k]), _as_np(v), err_msg=k)


def test_round_state_drift_raises(tmp_path):
    """A state restored against another sweep width, or another wire
    dtype, raises the reference's ``shape mismatch`` / ``dtype
    mismatch`` instead of resuming a wrong sweep."""
    t_cfg, _ = _cfgs(GOLDEN, shuffle_impl="ring")
    tree = T.init_sharded_sweep_sv(t_cfg, 3, 40, 8, 16, device="cpu")
    path = str(tmp_path / "s.npz")
    T.save_sweep_state(path, tree)
    with pytest.raises(ValueError, match="shape mismatch"):
        T.restore_sweep_state(path, t_cfg, 4, 40, 8, 16, device="cpu")
    with pytest.raises(ValueError, match="dtype mismatch"):
        T.restore_sweep_state(path, dataclasses.replace(
            t_cfg, shuffle_wire_dtype="float32"), 3, 40, 8, 16,
            device="cpu")
    back = T.restore_sweep_state(path, t_cfg, 3, 40, 8, 16, device="cpu")
    assert isinstance(back, T.DedupChunk)


def test_simulated_hier_hosts_match_the_reference():
    """The launchers' hier host count ≡ the reference's on one host, for
    W = 1 … 16."""
    assert [tmesh.simulated_hier_hosts(w) for w in range(1, 17)] == \
        [jmesh.simulated_hier_hosts(w) for w in range(1, 17)]


def test_service_and_shuffle_flag_take_the_transport_as_the_reference():
    """``StreamingSVMService(shuffle_impl=…)`` replaces the config's
    transport as the reference's service does, and the serve mode's
    ``--shuffle hier`` sets ``hier_num_hosts`` from
    ``simulated_hier_hosts`` of the partitions, as the reference's
    launcher (``repro/launch/serve.py:54-58``)."""
    t_cfg, j_cfg = _cfgs(GOLDEN)
    for impl in ("ring", "hier", "allgather"):
        got = StreamingSVMService(t_cfg, shuffle_impl=impl,
                                  device="cpu").cfg
        want = JService(j_cfg, shuffle_impl=impl).cfg
        assert got.shuffle_impl == want.shuffle_impl == impl
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    res = serve.main(["--arch", "svm-tfidf", "--smoke", "--device", "cpu",
                      "--streams", "1", "--waves", "1", "--shuffle", "hier"])
    assert res.cfg.shuffle_impl == "hier"
    assert res.cfg.hier_num_hosts == jmesh.simulated_hier_hosts(8) == 2


@pytest.fixture
def one_rank(tmp_path):
    """A gloo world of one rank in this process."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        yield compat.Rank(0, 1, "cpu", "gloo")
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("impl", ["allgather", "ring"])
def test_a_ranks_configs_are_one_solve_and_one_readback(one_rank, data,
                                                        monkeypatch, impl):
    """A round of S configs is ONE solve call of S jobs and ONE eq. 8
    readback collective on each rank, and the number of collectives a
    round does not grow with S (W = 1 here, the counts are per rank)."""
    X, y = data["dense"]
    t_cfg, _ = _cfgs(GOLDEN, shuffle_impl=impl, **F32_WIRE)
    calls = {"jobs": [], "psum": 0, "all_gather": 0, "ppermute": 0}
    cd, psum, gather = ops.cd_solve, compat.psum, compat.all_gather

    def count_cd(*a, **kw):
        calls["jobs"].append(a[2].shape[0])
        return cd(*a, **kw)

    def count(name, f):
        def run(*a, **kw):
            calls[name] += 1
            return f(*a, **kw)
        return run
    monkeypatch.setattr(ops, "cd_solve", count_cd)
    monkeypatch.setattr(compat, "psum", count("psum", psum))
    monkeypatch.setattr(compat, "all_gather", count("all_gather", gather))
    seen = []
    for S in (2, 4):
        for f in calls:
            calls[f] = [] if f == "jobs" else 0
        fn = T.build_sharded_sweep_round(t_cfg, N, device="cpu")
        params = tsw.sweep_grid(t_cfg.svm, C=np.linspace(0.5, 2, S))
        state = fn.init_sv(S, D)
        state, risks, w, b = fn(X, y, np.ones(N, np.float32), state, params)
        assert tuple(risks.shape) == (S, 1) and tuple(w.shape) == (S, D)
        assert calls["jobs"] == [S] and calls["psum"] == 1
        seen.append(calls["all_gather"])
    assert seen[0] == seen[1]


def test_fit_sharded_sweep_is_the_train_modes_sweep(one_rank, data):
    """``fit_sharded_sweep`` (the train mode's ``--sweep S``: C =
    logspace(-2, 1, S)) at W = 1 ≡ the port's functional sweep with one
    partition, with each config's accuracy on the rank's rows."""
    X, y = data["dense"]
    t_cfg, _ = _cfgs(GOLDEN, shuffle_impl="ring", **F32_WIRE)
    out = fit_sharded_sweep(one_rank, X, y, t_cfg, sweep=3)
    params = tsw.sweep_grid(t_cfg.svm, C=np.logspace(-2, 1, 3)
                            .astype(np.float32))
    want = T.fit_mapreduce_sweep(X, y, 1, t_cfg, params, device="cpu")
    np.testing.assert_array_equal(out["C"], params.C)
    np.testing.assert_array_equal(out["rounds"], want.rounds)
    np.testing.assert_array_equal(out["ids"], want.sv.ids.numpy())
    np.testing.assert_allclose(out["risks"], want.risks.numpy(), rtol=1e-6)
    Xt, yt = torch.from_numpy(X), torch.from_numpy(y)
    acc = [float((T.predict_sign(T.decision_linear(want.ws[s], want.bs[s],
                                                   Xt)) == yt).float()
                 .mean()) for s in range(3)]
    np.testing.assert_allclose(out["acc"], acc, atol=1e-6)
    assert min(out["acc"]) > 0.8 and out["best"] == want.best


def test_run_sharded_sweep_takes_the_retrace_guard(one_rank, data):
    """``fail_on_retrace=True`` (the reference's guard on every round past
    the first) gives the sweep without it bit for bit, on the ring's
    dedup state with configs that converge at different rounds; a
    steady-state round that meets a wrapper signature new to the process
    raises ``RetraceError`` naming it."""
    from repro_torch.analysis import RetraceError
    from repro_torch.analysis.lint import _fresh_gram as fresh_gram
    X, y = data["dense"]
    t_cfg, _ = _cfgs(FREEZE, shuffle_impl="ring", **F32_WIRE)
    params = tsw.sweep_grid(t_cfg.svm, **GRIDS["freeze"])
    fn = T.build_sharded_sweep_round(t_cfg, N, device="cpu")
    mask = np.ones(N, np.float32)
    off = T.run_sharded_sweep(fn, X, y, mask, t_cfg, params)
    on = T.run_sharded_sweep(fn, X, y, mask, t_cfg, params,
                             fail_on_retrace=True)
    assert len(set(on.rounds.tolist())) > 1
    np.testing.assert_array_equal(on.rounds, off.rounds)
    for a, b in zip(on.sv, off.sv):
        assert torch.equal(a, b)
    for k in ("risks", "ws", "bs"):
        assert torch.equal(getattr(on, k), getattr(off, k)), k

    calls = []

    def new_shape_in_round_1(*a, **kw):
        calls.append(1)
        if len(calls) == 2:
            fresh_gram("cpu")
        return fn(*a, **kw)
    new_shape_in_round_1.init_sv, new_shape_in_round_1.device = (
        fn.init_sv, fn.device)
    new_shape_in_round_1.expand_sv = fn.expand_sv
    with pytest.raises(RetraceError, match=r"round 1") as e:
        T.run_sharded_sweep(new_shape_in_round_1, X, y, mask, t_cfg,
                            params, fail_on_retrace=True)
    assert e.value.rule == "retrace" and e.value.op.startswith("gram[")


def test_new_modules_import_neither_jax_nor_the_reference():
    """The slice's modules (the AST test of ``test_torch_kernels.py``
    walks every module of the package too)."""
    import ast
    files = [REPO / "src/repro_torch" / f for f in (
        "core/sweep.py", "core/mapreduce_svm.py", "launch/mesh.py",
        "launch/sharded.py", "launch/serve.py", "serving/svm_stream.py",
        "core/__init__.py")]
    for f in files:
        tree = ast.parse(f.read_text())
        mods = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
                for a in n.names] + \
            [n.module or "" for n in ast.walk(tree)
             if isinstance(n, ast.ImportFrom) and n.level == 0]
        assert not [m for m in mods if m.split(".")[0] in
                    ("jax", "jaxlib", "repro")], f
