"""The sharded LM train and prefill steps (``repro_torch.launch.steps.
build_train_step`` / ``build_prefill_step`` on a mesh of ranks, the
differentiable collectives of ``repro_torch.compat`` and ``models/
layers.py``' mesh section) against the reference's own sharded steps and
the port's one-process steps, on the CPU, float32 smoke variants.

One gloo spawn of 2 ranks runs tinyllama-1.1b and llava-next-34b (stub
prefix embeddings) on (1, 2); one of 4 runs qwen2-1.5b on (2, 2) (tied
vocabulary-parallel embedding and loss, FSDP gathers, the batch split,
sequence parallelism), again with an odd S (the all-reduce fallback) and
with batch 3 (the batch replicated), chatglm3-6b on (1, 4) (kv_repeat
2), and the twin of the reference's red ``tests/test_distributed_moe.py
::test_sequence_parallel_preserves_outputs`` (tinyllama's forward with
the residual split over 4 model ranks). Each case: the initial weights'
loss and gradients, the prefill step's logits and 2 train steps (loss,
grad_norm, the params after). A child process runs the reference's
``build_train_step`` / ``build_prefill_step`` for every case on 8 CPU
devices: jitted at the bundle's shardings on a mesh of ``Auto`` axes
under ``jax.set_mesh``, the inputs ``device_put`` there first (the
reference's ``compat.make_mesh`` makes ``Explicit`` axes, which reject
the params made outside their shardings; ROADMAP Queue 3). Every number
is held within 1e-5 of its leaf's largest entry, the tolerance of
``tests/test_torch_train.py``. The train CLI's ``--data-par 2
--model-par 2`` prints the one-process losses and saves the reference's
keys. The same two spawns hold ``compat.psum_scatter_bytes`` (every
bf16 reduce-scatter of the sharded step) to ``psum_scatter`` of the
float32 copy, and its record to the reduce-scatter it is."""
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import compat, convert, optim
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, lm_batch_at
from repro_torch.launch import steps, train
from repro_torch.launch.mesh import Mesh
from repro_torch.launch.sharded import TrainCase, run_train_cases
from repro_torch.models.config import smoke_variant
from repro_torch.models.layers import tree_leaves, tree_map
from repro_torch.models.transformer import build_model
from torch_threads import one_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
TOL = 1e-5
STEPS = 2
# eps 1e-3: AdamW moves an entry by up to lr whatever its gradient's size,
# so where |g| is near eps a rounding-level difference of the gradient
# (1e-7 here) becomes a difference of the step (at eps 1e-6, 2.8e-6 of a
# chatglm3 embedding entry after 2 steps, 1.03e-5 of the leaf's largest);
# with eps far above that rounding the step is at most lr/eps = 1 times
# the gradient's difference
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10, eps=1e-3)
# name: (arch, (data, model), batch, seq); the first two on 2 ranks
CASES = {
    "tinyllama-1x2": ("tinyllama-1.1b", (1, 2), 4, 32),
    "llava-1x2": ("llava-next-34b", (1, 2), 2, 32),
    "qwen2-2x2": ("qwen2-1.5b", (2, 2), 4, 32),
    "qwen2-2x2-odd-seq": ("qwen2-1.5b", (2, 2), 4, 33),
    "qwen2-2x2-batch3": ("qwen2-1.5b", (2, 2), 3, 32),
    "chatglm3-1x4": ("chatglm3-6b", (1, 4), 4, 32),
}
TWO = ("tinyllama-1x2", "llava-1x2")
# the twin of the reference's sequence-parallel test: its tinyllama smoke
# forward over 4 model ranks, tokens (4, 32)
TWIN = ("tinyllama-1.1b", (1, 4), 4, 32)


def _numpy_params(cfg, seed):
    """Fan-in scaled normal weights from numpy, norm scales 1 + N(0,
    0.1²) and biases N(0, 0.1²), so that every leaf matters."""
    rng = np.random.default_rng(seed)

    def draw(p):
        if p.init in ("ones", "zeros"):
            base = 1.0 if p.init == "ones" else 0.0
            return (base + 0.1 * rng.normal(size=p.shape)).astype(np.float32)
        if p.init == "embed":
            std = 1.0 / np.sqrt(p.shape[-1])
        else:
            std = 1.0 / np.sqrt(p.fan_in or (p.shape[-2] if len(p.shape) > 1
                                             else p.shape[-1]))
        return (std * rng.normal(size=p.shape)).astype(np.float32)
    return tree_map(draw, build_model(cfg).template())


def _case(i, arch, grid, B, S):
    cfg = smoke_variant(get_config(arch))
    batch = lm_batch_at(DataConfig(batch_size=B, seq_len=S, seed=3 + i),
                        cfg, 0)
    return TrainCase(cfg, _numpy_params(cfg, i), batch, grid, STEPS,
                     optim.OptConfig(**OPT))


def _twin():
    arch, grid, B, S = TWIN
    cfg = smoke_variant(get_config(arch))
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S),
                                               dtype=np.int32)
    return TrainCase(cfg, _numpy_params(cfg, 99), {"tokens": tokens}, grid,
                     steps=0, prefill=False, forward=True)


# psum_scatter_bytes' cases: (shape, dim, axis of the 2 × 2 mesh or None
# for every rank)
SCATTERS = (((8, 6), 0, None), ((3, 8, 5), 1, None), ((4, 12), 1, "model"),
            ((6, 4), 0, "data"))


def _cases_and_scatters(rank, cases):
    """A rank of the spawns: ``run_train_cases``, then each of SCATTERS
    through ``compat.psum_scatter_bytes`` and ``psum_scatter`` of the
    float32 copy (a mesh axis only on 4 ranks). → (the cases' results,
    per scatter (bytes' output, float32's rounded, the rank's record))."""
    from repro_torch.launch.mesh import make_host_mesh
    results = run_train_cases(rank, cases)
    mesh = make_host_mesh(2, 2) if rank.world_size == 4 else None
    gen = torch.Generator().manual_seed(11 + rank.rank)
    scatters = []
    for shape, dim, axis in SCATTERS:
        if axis is not None and mesh is None:
            continue
        group = None if axis is None else mesh.groups_of(axis)
        x = torch.randn(shape, generator=gen).to(torch.bfloat16)
        with compat.record_collectives() as rec:
            got = compat.psum_scatter_bytes(x, group, dim=dim)
        want = compat.psum_scatter(x.float(), group, dim=dim)
        scatters.append((got.float().numpy(),
                         want.to(torch.bfloat16).float().numpy(), list(rec)))
    return results, scatters


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


_CHILD = """
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
from repro import optim
from repro.configs import get_config
from repro.launch.steps import (InputShape, build_prefill_step,
                                build_train_step)
from repro.models.config import smoke_variant
from repro.models.transformer import build_model

data = dict(np.load(sys.argv[1]))
spec = json.loads(sys.argv[3])
out = {}


def tree(prefix):
    t = {}
    for key, v in data.items():
        if key.startswith(prefix):
            node = t
            *path, leaf = key[len(prefix):].split("/")
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = jnp.asarray(v)
    return t


def placed(mesh, specs):
    return jax.tree.map(lambda s: NamedSharding(mesh, s), specs,
                        is_leaf=lambda x: isinstance(x, P))


def mesh_of(d, m):
    # Auto axes: compat.make_mesh's Explicit ones reject the params
    return jax.make_mesh((d, m), ("data", "model"),
                         axis_types=(AxisType.Auto, AxisType.Auto),
                         devices=jax.devices()[:d * m])


for name, (arch, (d, m), B, S, steps) in spec["cases"].items():
    cfg = smoke_variant(get_config(arch))
    mesh = mesh_of(d, m)
    ocfg = optim.OptConfig(**spec["opt"])
    with jax.set_mesh(mesh):
        bundle = build_train_step(cfg, mesh, InputShape("t", "train", S, B),
                                  opt_cfg=ocfg)
        model = bundle.model
        sh, osh = placed(mesh, bundle.in_shardings), placed(
            mesh, bundle.out_shardings)
        params = jax.device_put(tree(name + "/"), sh[0])
        batch = jax.device_put(tree(name + ":batch/"), sh[2])
        (loss, _), grads = jax.jit(
            jax.value_and_grad(model.loss, has_aux=True),
            in_shardings=(sh[0], sh[2]))(params, batch)
        out[name + ":loss0"] = np.asarray(loss)
        for k, v in jax.tree_util.tree_leaves_with_path(grads):
            out[name + ":grad" + jax.tree_util.keystr(k)] = np.asarray(v)
        pre = build_prefill_step(cfg, mesh, InputShape("p", "prefill", S, B))
        psh = placed(mesh, pre.in_shardings)
        pbatch = jax.device_put({k: v for k, v in batch.items()
                                 if k != "labels"}, psh[1])
        out[name + ":logits"] = np.asarray(jax.jit(
            pre.fn, in_shardings=psh)(params, pbatch))
        step = jax.jit(bundle.fn, in_shardings=sh, out_shardings=osh,
                       donate_argnums=(0, 1))
        state = jax.device_put(optim.init(params), sh[1])
        for i in range(steps):
            params, state, met = step(params, state, batch)
            for k in ("loss", "grad_norm"):
                out[f"{name}:{k}{i}"] = np.asarray(met[k])
        for k, v in jax.tree_util.tree_leaves_with_path(params):
            out[name + ":param" + jax.tree_util.keystr(k)] = np.asarray(v)
        out[name + ":kv_repeat"] = np.asarray(model.kv_repeat)

# the reference's test_sequence_parallel_preserves_outputs, its forward on
# a (2, 4) mesh with the residual constrained to (batch, model, None)
arch, (d, m), B, S = spec["twin"]
cfg = smoke_variant(get_config(arch))
mesh = mesh_of(2, 4)
params = tree("twin/")
tokens = jnp.asarray(data["twin:batch/tokens"])
with jax.set_mesh(mesh):
    logits, _ = jax.jit(build_model(cfg, mesh=mesh).forward)(params, tokens)
out["twin:logits"] = np.asarray(logits)
np.savez(sys.argv[2], **out)
print("CHILD_OK")
"""


@pytest.fixture(scope="module")
def runs():
    """The reference's sharded steps in a child process for every case,
    beside one gloo spawn of 2 ranks and one of 4 of the port's. →
    (cases, per case the ranks' results, the child's outputs)."""
    from conftest import subprocess_env
    cases = {name: _case(i, *spec) for i, (name, spec)
             in enumerate(CASES.items())}
    twin = _twin()
    tmp = tempfile.mkdtemp(prefix="tp_train_")
    inp, outp = os.path.join(tmp, "in.npz"), os.path.join(tmp, "out.npz")
    arrays = {}
    for name, c in list(cases.items()) + [("twin", twin)]:
        arrays.update({f"{name}/{k}": v for k, v in _flat(c.params).items()})
        arrays.update({f"{name}:batch/{k}": v for k, v in c.batch.items()})
    np.savez(inp, **arrays)
    spec = {"cases": {n: (*CASES[n], STEPS) for n in CASES},
            "twin": TWIN, "opt": OPT}
    child = subprocess.Popen(
        [sys.executable, "-c", _CHILD, inp, outp, json.dumps(spec)],
        cwd=str(REPO), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=subprocess_env(PYTHONPATH=str(REPO / "src")))
    four = [n for n in CASES if n not in TWO]
    try:
        two = compat.spawn(_cases_and_scatters, 2,
                           ([cases[n] for n in TWO],),
                           device="cpu", timeout_s=120.0,
                           join_timeout_s=300.0)
        fours = compat.spawn(_cases_and_scatters, 4,
                             ([cases[n] for n in four] + [twin],),
                             device="cpu", timeout_s=120.0,
                             join_timeout_s=300.0)
        stdout, stderr = child.communicate(timeout=300)
    finally:
        if child.poll() is None:
            child.kill()
    assert "CHILD_OK" in stdout, stdout + stderr
    with np.load(outp) as f:
        ref = {k: f[k] for k in f.files}
    per_case = {n: [r[i] for r, _ in two] for i, n in enumerate(TWO)}
    per_case.update({n: [r[i] for r, _ in fours]
                     for i, n in enumerate(four)})
    per_case["twin"] = [r[-1] for r, _ in fours]
    per_case["scatter:2"] = [sc for _, sc in two]
    per_case["scatter:4"] = [sc for _, sc in fours]
    return cases, per_case, ref, twin


def _rows(case, results, key):
    """Per rank (B_rank, …) → (B, …): the model ranks of a data row
    equal, then the data rows in order (a batch that does not divide the
    data ranks is every rank's whole)."""
    d, m = case.grid
    for r in range(d * m):
        np.testing.assert_array_equal(results[r][key],
                                      results[r - r % m][key])
    B = case.batch["tokens"].shape[0]
    if B % d:
        for r in range(d * m):
            np.testing.assert_array_equal(results[r][key], results[0][key])
        return results[0][key]
    return np.concatenate([results[i * m][key] for i in range(d)])


def _close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))
    assert err <= TOL, f"{what}: off by {err:.2e} of its largest entry"


def _names(cfg):
    """The leaves' key paths in ``tree_leaves`` order, as JAX's keystr."""
    out = []

    def walk(t, pre):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], pre + f"['{k}']")
        else:
            out.append(pre)
    walk(build_model(cfg).template(), "")
    return out


def _same_on_every_rank(results, key):
    for r in results[1:]:
        for a, b in zip(r[key], results[0][key]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_train_matches_the_reference_sharded_step(runs, name):
    """The initial loss and every gradient leaf, the prefill logits, each
    step's loss and grad_norm and every parameter after 2 steps, each
    within 1e-5 of its largest entry of the reference's sharded steps';
    gathered whole, the same on every rank."""
    cases, per_case, ref, _ = runs
    case, res = cases[name], per_case[name]
    _same_on_every_rank(res, "grads")
    _same_on_every_rank(res, "params")
    _close(res[0]["loss0"], ref[name + ":loss0"], "loss")
    for leaf, g in zip(_names(case.cfg), res[0]["grads"]):
        _close(g, ref[f"{name}:grad{leaf}"], f"{name} grad {leaf}")
    _close(_rows(case, res, "logits"), ref[name + ":logits"],
           f"{name} logits")
    for i in range(STEPS):
        for k in ("loss", "grad_norm"):
            _close(res[0]["metrics"][i][k], ref[f"{name}:{k}{i}"],
                   f"{name} step {i} {k}")
    for leaf, p in zip(_names(case.cfg), res[0]["params"]):
        _close(p, ref[f"{name}:param{leaf}"], f"{name} param {leaf}")


def _one_process(case):
    """The port's one-process steps on the case: (loss0, grads, logits,
    metrics a step, params after)."""
    S = case.batch["tokens"].shape[1] + case.cfg.num_prefix_tokens
    B = case.batch["tokens"].shape[0]
    bundle = steps.build_train_step(case.cfg, None,
                                    steps.InputShape("t", "train", S, B),
                                    opt_cfg=case.opt)
    params = convert.lm_params_from_jax(case.params)
    batch = {k: torch.from_numpy(v) for k, v in case.batch.items()}
    loss, _, grads = steps.loss_and_grads(bundle.model, params, batch)
    pre = steps.build_prefill_step(case.cfg, None,
                                   steps.InputShape("p", "prefill", S, B))
    logits = pre.fn(params, {k: v for k, v in batch.items()
                             if k != "labels"})
    state, metrics = optim.init(params), []
    for _ in range(case.steps):
        params, state, m = bundle.fn(params, state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    return (float(loss), [g.numpy() for g in grads], logits.numpy(),
            metrics, [p.numpy() for p in tree_leaves(params)])


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_train_matches_one_process(runs, name):
    """The same numbers within 1e-5 of their largest entries of the
    port's one-process loss, gradients, prefill and 2 train steps."""
    cases, per_case, _, _ = runs
    case, res = cases[name], per_case[name]
    loss, grads, logits, metrics, params = _one_process(case)
    _close(res[0]["loss0"], loss, "loss")
    for leaf, a, b in zip(_names(case.cfg), res[0]["grads"], grads):
        _close(a, b, f"{name} grad {leaf}")
    _close(_rows(case, res, "logits"), logits, f"{name} logits")
    for i in range(STEPS):
        for k in ("loss", "ce", "grad_norm", "lr"):
            _close(res[0]["metrics"][i][k], metrics[i][k],
                   f"{name} step {i} {k}")
    for leaf, a, b in zip(_names(case.cfg), res[0]["params"], params):
        _close(a, b, f"{name} param {leaf}")


def _groups(grid, axis):
    d, m = grid
    if axis == "model":
        return tuple(tuple(i * m + j for j in range(m)) for i in range(d))
    return tuple(tuple(i * m + j for i in range(d)) for j in range(m))


@pytest.mark.parametrize("name", list(CASES))
def test_every_rank_issues_the_same_collectives(runs, name):
    """One schedule of a train step on every rank; the residual split
    over the sequence exactly where S divides the model ranks (a
    reduce-scatter over the model groups: the row-parallel sums), the
    FSDP gathers' reduce-scatters over the data groups exactly with
    data > 1, the vocabulary-parallel CE's row max over model."""
    cases, per_case, _, _ = runs
    case, res = cases[name], per_case[name]
    assert len({tuple(r["schedule"]) for r in res}) == 1, name
    sched = res[0]["schedule"]
    S = case.batch["tokens"].shape[1] + case.cfg.num_prefix_tokens
    sp = S % case.grid[1] == 0
    assert res[0]["seq_parallel"] == sp

    def has(kind, axis):
        return any(s[0] == kind and s[1] == _groups(case.grid, axis)
                   for s in sched)
    assert has("psum_scatter", "model") == sp
    assert has("psum_scatter", "data") == (case.grid[0] > 1)
    assert has("pmax", "model")


@pytest.mark.parametrize("n", [2, 4])
def test_psum_scatter_bytes_matches_the_float32_scatter(runs, n):
    """``compat.psum_scatter_bytes`` of bf16 tensors (dims 0 and 1, over
    every rank and, on 4 ranks, over the 2 × 2 mesh's model and data
    groups) gives ``psum_scatter`` of their float32 copies rounded to
    bf16: exactly on 2 ranks, within one bf16 rounding on more (gloo may
    add in another order). Each is recorded as one bf16
    ``psum_scatter`` of the input's shape over its groups, which
    ``collective_stats`` reckons as a reduce-scatter of 2 bytes an
    entry in, 1/g of them out, (g-1)/g on the wire."""
    from repro_torch.launch.hlo_analysis import collective_stats
    per_rank = runs[1][f"scatter:{n}"]
    cases = [c for c in SCATTERS if n == 4 or c[2] is None]
    for r, scatters in enumerate(per_rank):
        assert len(scatters) == len(cases)
        for (shape, dim, axis), (got, want, rec) in zip(cases, scatters):
            out = list(shape)
            g = n if axis is None else 2
            out[dim] //= g
            assert got.shape == tuple(out), (r, shape, axis)
            if g == 2:
                np.testing.assert_array_equal(got, want)
            else:
                np.testing.assert_allclose(got, want, rtol=2.0 ** -8,
                                           atol=0)
            assert len(rec) == 1
            e = rec[0]
            assert (e.kind, e.shapes, e.dtypes) == (
                "psum_scatter", (tuple(shape),), ("bfloat16",))
            groups = (((tuple(range(n)),) if axis is None
                       else _groups((2, 2), axis)))
            assert e.replica_groups == groups
            nbytes = 2.0 * np.prod(shape)
            stats = collective_stats(rec)
            assert list(stats) == ["reduce-scatter"]
            s = stats["reduce-scatter"]
            assert s["count"] == 1
            assert s["operand_bytes"] == nbytes
            assert s["output_bytes"] == nbytes / g
            assert s["wire_bytes"] == nbytes * (g - 1) / g


def test_sequence_parallel_twin_of_the_reference(runs):
    """The twin of ``tests/test_distributed_moe.py::
    test_sequence_parallel_preserves_outputs``: tinyllama's forward with
    the residual split over 4 model ranks gives the reference's
    constrained forward's logits (rtol = atol = 2e-4, its test's
    limits), and the port's one-process forward's within 1e-5."""
    _, per_case, ref, twin = runs
    res = per_case["twin"]
    assert all(r["seq_parallel"] for r in res)
    got = _rows(twin, res, "forward")
    np.testing.assert_allclose(got, ref["twin:logits"], rtol=2e-4,
                               atol=2e-4)
    with torch.no_grad():
        want, _ = build_model(twin.cfg).forward(
            convert.lm_params_from_jax(twin.params),
            torch.from_numpy(twin.batch["tokens"]))
    _close(got, want.numpy(), "forward")


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "llava-next-34b"])
def test_bundle_placements_equal_the_reference(arch):
    """build_train_step and build_prefill_step on a shape-only 2 × 2 mesh
    at train_4k / prefill_32k, and at a batch of 3 (replicated): every
    in_ and out_sharding entry for entry the reference's bundle's on an
    AbstractMesh, kv_repeat and donate_argnums the same."""
    import jax
    from jax.sharding import PartitionSpec as P
    from repro import compat as jcompat
    from repro.configs import get_config as j_get_config
    from repro.launch import steps as jsteps

    def specs(tree):
        return [tuple(s) for s in jax.tree.leaves(
            tree, is_leaf=lambda x: isinstance(x, P))]

    def mine(tree):
        if steps._is_placement(tree):
            return [tree]
        if isinstance(tree, dict):
            return [x for k in sorted(tree) for x in mine(tree[k])]
        return [x for t in tree for x in mine(t)]
    tm = Mesh(("data", "model"), (2, 2))
    jm = jcompat.make_abstract_mesh((2, 2), ("data", "model"))
    cfg, jcfg = get_config(arch), j_get_config(arch)
    for name, B in (("train_4k", None), ("prefill_32k", None),
                    ("train_4k", 3), ("prefill_32k", 3)):
        shape = steps.INPUT_SHAPES[name]
        jshape = jsteps.INPUT_SHAPES[name]
        if B:
            shape = dataclasses.replace(shape, global_batch=B)
            jshape = dataclasses.replace(jshape, global_batch=B)
        tb, jb = steps.build_step(cfg, tm, shape), jsteps.build_step(
            jcfg, jm, jshape)
        assert tb.model.kv_repeat == jb.model.kv_repeat
        assert tb.donate_argnums == jb.donate_argnums
        got = mine(tb.in_shardings) + mine(tb.out_shardings)
        want = specs(jb.in_shardings) + specs(jb.out_shardings)
        assert got == want, (arch, name, B)


def test_cli_trains_on_ranks_with_the_one_process_losses(tmp_path, capfd):
    """``--data-par 2 --model-par 2 --smoke --device cpu`` on qwen2:
    rank 0 prints the reference's lines with the one-process losses
    (within 1e-5), and ``--ckpt`` saves the gathered weights under the
    reference's keys, equal to the one-process run's within 1e-5 (the
    key bias: within the 2 steps of up to lr that AdamW may take on its
    rounding-level gradient)."""
    path, one_path = str(tmp_path / "tp.npz"), str(tmp_path / "one.npz")
    args = ["--arch", "qwen2-1.5b", "--smoke", "--steps", "2", "--batch",
            "4", "--seq", "64", "--device", "cpu"]
    losses = train.main(args + ["--data-par", "2", "--model-par", "2",
                                "--ckpt", path])
    out = capfd.readouterr().out
    assert "step    0 loss" in out and "(2 × 2 ranks)" in out \
        and f"saved {path}" in out
    one = train.main(args + ["--ckpt", one_path])
    np.testing.assert_allclose(losses, one, rtol=TOL, atol=TOL)
    lr = optim.OptConfig().lr
    with np.load(path) as f, np.load(one_path) as g:
        assert sorted(f.files) == sorted(g.files)
        for k in g.files:
            if k.endswith("['bk']"):
                # the key bias's gradient is 0 but for rounding (softmax
                # over keys ignores a shift of them all); AdamW at eps 1e-8
                # turns that into steps of up to lr in either run
                assert np.abs(f[k] - g[k]).max() <= 2 * 2 * lr, k
            else:
                _close(f[k], g[k], k)


def test_other_families_under_a_mesh_raise():
    """The MoE, SSM, hybrid and encoder-decoder train and prefill steps
    under a mesh of more than one rank raise naming item 13g-c, and so
    does the train CLI's --model-par 2 on a MoE arch."""
    grid = Mesh(("data", "model"), (1, 2))
    for arch in ("mixtral-8x22b", "rwkv6-7b", "zamba2-1.2b",
                 "whisper-base"):
        cfg = smoke_variant(get_config(arch))
        for build in (steps.build_train_step, steps.build_prefill_step):
            with pytest.raises(NotImplementedError, match="13g-c"):
                build(cfg, grid, steps.INPUT_SHAPES["train_4k"])
    with pytest.raises(NotImplementedError, match="13g-c"):
        train.main(["--arch", "qwen3-moe-235b-a22b", "--smoke", "--device",
                    "cpu", "--model-par", "2"])
