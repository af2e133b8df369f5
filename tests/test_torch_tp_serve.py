"""The sharded LM serve step (``repro_torch.launch.steps.
build_serve_step(cfg, mesh)``, ``models.transformer`` on a mesh of ranks)
against the reference's own sharded ``build_serve_step``, on the CPU.

One gloo spawn of 2 ranks and one of 4 run the smoke variants of
tinyllama-1.1b on (1, 2), chatglm3-6b on (1, 4) (kv_repeat 2), qwen2-1.5b
on (2, 2) (FSDP gathers, the batch split, tied vocabulary-parallel
logits; batch 3: the batch replicated) and a qwen2 variant with 6 heads
on (1, 4) (heads replicated, ffn and vocabulary split), each on the same
numpy weights and seeded, distinct first tokens. A child process runs
the reference's step on 8 CPU devices for every case: its bundle's
``fn`` and ``model.decode_step`` jitted at the bundle's ``in_shardings``,
on a mesh of ``Auto`` axes with the inputs ``device_put`` there (the
reference's serve CLI fails with a mesh on this JAX: ``compat.make_mesh``
makes ``Explicit`` axes, which reject the params made outside their
shardings). Each case is also held to the port's one-rank decode, and
its collectives must be the same on every rank. The CLI's
``--data-par 2 --model-par 2`` serves the one-rank tokens; a MoE arch
under ``--model-par 2`` raises."""
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

from repro_torch import compat, convert
from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.launch.mesh import Mesh
from repro_torch.launch.sharded import LMCase, run_lm_cases
from repro_torch.launch.sharding import param_pspecs
from repro_torch.models.config import smoke_variant
from repro_torch.models.layers import tree_map
from repro_torch.models.transformer import build_model
from torch_threads import one_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
TOL = 1e-5
STEPS, CACHE = 4, 16
# name: (arch, (data, model), batch, heads or None); the first runs on 2
# ranks, the others on 4
CASES = {
    "tinyllama-1x2": ("tinyllama-1.1b", (1, 2), 4, None),
    "chatglm3-1x4": ("chatglm3-6b", (1, 4), 4, None),
    "qwen2-2x2": ("qwen2-1.5b", (2, 2), 4, None),
    "qwen2-2x2-batch3": ("qwen2-1.5b", (2, 2), 3, None),
    "qwen2-6heads-1x4": ("qwen2-1.5b", (1, 4), 4, 6),
}


def _cfg(arch, heads):
    cfg = smoke_variant(get_config(arch))
    return dataclasses.replace(cfg, num_heads=heads, head_dim=64) \
        if heads else cfg


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


def _inputs():
    out = {}
    for i, (name, (arch, grid, B, heads)) in enumerate(CASES.items()):
        cfg = _cfg(arch, heads)
        prompts = np.random.default_rng(100 + i).permutation(
            cfg.vocab_size)[:B, None].astype(np.int32)
        out[name] = LMCase(cfg, _numpy_params(cfg, i), prompts, grid, STEPS,
                           CACHE)
    return out


def _flat(params, prefix=""):
    out = {}
    for k, v in params.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


_CHILD = """
import dataclasses, json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
from repro.configs import get_config
from repro.launch.steps import InputShape, build_serve_step
from repro.models.config import smoke_variant

data = dict(np.load(sys.argv[1]))
cases = json.loads(sys.argv[3])
out = {}
for name, (arch, (d, m), B, heads, steps, cache) in cases.items():
    cfg = smoke_variant(get_config(arch))
    if heads:
        cfg = dataclasses.replace(cfg, num_heads=heads, head_dim=64)
    # Auto axes: compat.make_mesh's Explicit ones reject the params
    mesh = jax.make_mesh((d, m), ("data", "model"),
                         axis_types=(AxisType.Auto, AxisType.Auto),
                         devices=jax.devices()[:d * m])
    bundle = build_serve_step(cfg, mesh, InputShape("t", "decode", cache, B))
    model = bundle.model
    sh = jax.tree.map(lambda s: NamedSharding(mesh, s), bundle.in_shardings,
                      is_leaf=lambda x: isinstance(x, P))
    params = {}
    for key, v in data.items():
        if key.startswith(name + "/"):
            node = params
            *path, leaf = key[len(name) + 1:].split("/")
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = jnp.asarray(v)
    params = jax.device_put(params, sh[0])
    step = jax.jit(bundle.fn, in_shardings=sh, donate_argnums=(1,))
    decode = jax.jit(model.decode_step, in_shardings=sh)
    first = jnp.asarray(data[name + ":prompts"])
    state = jax.device_put(model.init_decode_state(B, cache), sh[1])
    tok, logits, tokens = jax.device_put(first, sh[2]), [], []
    for _ in range(steps):
        lg, state = decode(params, state, tok)
        logits.append(np.asarray(lg[:, -1], np.float32))
        tok = jax.device_put(jnp.argmax(lg[:, -1], -1).astype(jnp.int32)
                             [:, None], sh[2])
    state = jax.device_put(model.init_decode_state(B, cache), sh[1])
    tok = jax.device_put(first, sh[2])
    for _ in range(steps):
        nxt, state = step(params, state, tok)
        tokens.append(np.asarray(nxt))
        tok = jax.device_put(nxt[:, None], sh[2])
    out[name + ":logits"] = np.stack(logits)
    out[name + ":tokens"] = np.stack(tokens)
    out[name + ":kv_repeat"] = np.asarray(model.kv_repeat)
np.savez(sys.argv[2], **out)
print("CHILD_OK")
"""


@pytest.fixture(scope="module")
def runs():
    """The reference's sharded step in a child process for every case,
    beside two gloo spawns (2 and 4 ranks) of the port's. → (cases,
    per case the ranks' results, the child's outputs by key)."""
    from conftest import subprocess_env
    cases = _inputs()
    tmp = tempfile.mkdtemp(prefix="tp_serve_")
    inp, outp = os.path.join(tmp, "in.npz"), os.path.join(tmp, "out.npz")
    arrays = {}
    for name, c in cases.items():
        arrays.update({f"{name}/{k}": v for k, v in _flat(c.params).items()})
        arrays[name + ":prompts"] = c.prompts
    np.savez(inp, **arrays)
    spec = {name: (arch, grid, B, heads, STEPS, CACHE)
            for name, (arch, grid, B, heads) in CASES.items()}
    child = subprocess.Popen(
        [sys.executable, "-c", _CHILD, inp, outp, json.dumps(spec)],
        cwd=str(REPO), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=subprocess_env(PYTHONPATH=str(REPO / "src")))
    names = list(CASES)
    try:
        two = compat.spawn(run_lm_cases, 2, ([cases[names[0]]],),
                           device="cpu", timeout_s=120.0,
                           join_timeout_s=300.0)
        four = compat.spawn(run_lm_cases, 4,
                            ([cases[n] for n in names[1:]],), device="cpu",
                            timeout_s=120.0, join_timeout_s=300.0)
        stdout, stderr = child.communicate(timeout=300)
    finally:
        if child.poll() is None:
            child.kill()
    assert "CHILD_OK" in stdout, stdout + stderr
    with np.load(outp) as f:
        ref = {k: f[k] for k in f.files}
    per_case = {names[0]: [r[0] for r in two]}
    per_case.update({n: [r[i] for r in four]
                     for i, n in enumerate(names[1:])})
    return cases, per_case, ref


def _assembled(case, results, key):
    """Per rank (steps, B_rank, …) → (steps, B, …): the model replicas
    of each data shard equal, then the data shards in order (a batch
    that does not divide the data ranks is every rank's whole)."""
    d, m = case.grid
    for r in range(d * m):
        np.testing.assert_array_equal(results[r][key],
                                      results[r - r % m][key])
    B = case.prompts.shape[0]
    if B % d:
        for r in range(d * m):
            np.testing.assert_array_equal(results[r][key], results[0][key])
        return results[0][key]
    return np.concatenate([results[i * m][key] for i in range(d)], axis=1)


def _one_rank(case):
    """The port's decode on one process: (logits (steps, B, V), tokens)."""
    model = build_model(case.cfg)
    params = convert.lm_params_from_jax(case.params)
    state = model.init_decode_state(case.prompts.shape[0], case.cache_len,
                                    "cpu")
    tok = torch.from_numpy(case.prompts)
    logits, tokens = [], []
    for _ in range(case.steps):
        lg, state = model.decode_step(params, state, tok)
        tok = torch.argmax(lg[:, -1], -1).to(torch.int32)[:, None]
        logits.append(lg[:, -1].numpy())
        tokens.append(tok[:, 0].numpy())
    return np.stack(logits), np.stack(tokens)


def _close(got, want, what):
    err = float(np.abs(got - want).max() / np.abs(want).max())
    assert err <= TOL, f"{what}: logits differ by {err:.2e} of max |logit|"


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_serve_matches_the_reference_sharded_step(runs, name):
    """Tokens equal the reference's bundle ``fn``'s, the f32 logits of
    every step within 1e-5 of their max |logit|, kv_repeat the same."""
    cases, per_case, ref = runs
    case, results = cases[name], per_case[name]
    logits = _assembled(case, results, "logits")
    np.testing.assert_array_equal(_assembled(case, results, "tokens"),
                                  ref[name + ":tokens"])
    _close(logits, ref[name + ":logits"], name)
    assert results[0]["kv_repeat"] == int(ref[name + ":kv_repeat"])
    # the steps start from distinct tokens and their rows differ
    assert len({tuple(r) for r in logits[0].round(3)}) == logits.shape[1]


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_serve_matches_one_rank(runs, name):
    """The same tokens and logits (within 1e-5) as the port's one-rank
    decode; the bundle's ``fn`` gives the same tokens as the steps."""
    cases, per_case, _ = runs
    case, results = cases[name], per_case[name]
    logits, tokens = _one_rank(case)
    np.testing.assert_array_equal(_assembled(case, results, "tokens"),
                                  tokens)
    np.testing.assert_array_equal(_assembled(case, results, "fn_tokens"),
                                  tokens)
    _close(_assembled(case, results, "logits"), logits, name)


@pytest.mark.parametrize("name", list(CASES))
def test_every_rank_issues_the_same_collectives(runs, name):
    """One schedule on every rank of a case; its all-reduces and
    gathers as the placements ask (a MLP and, with the heads split, an
    attention all-reduce a layer; with data > 1 the FSDP gathers)."""
    cases, per_case, _ = runs
    case, results = cases[name], per_case[name]
    scheds = {tuple(r["schedule"]) for r in results}
    assert len(scheds) == 1, name
    kinds = [s[0] for s in scheds.pop()]
    d, m = case.grid
    L, heads_split = case.cfg.num_layers, case.cfg.num_heads % m == 0
    # a step: the embedding's sum, a layer's MLP (and attention, with
    # the heads split) sums, the logits' gather; FSDP gathers with d > 1
    assert kinds.count("psum") == case.steps * (
        1 + L * (1 + heads_split))
    gathers = kinds.count("all_gather_groups")
    assert gathers >= case.steps and (gathers > case.steps) == (d > 1)


def test_kv_repeat_and_local_heads(runs):
    """chatglm3 on 4 model ranks repeats its 2 KV heads twice: each rank
    attends with 1 of 4 query heads over 1 of the 4 cache heads; the
    6-head variant keeps all heads and its 2-head cache whole."""
    _, per_case, _ = runs
    assert per_case["chatglm3-1x4"][0]["kv_repeat"] == 2
    assert {r["heads"] for r in per_case["chatglm3-1x4"]} == {(1, 1)}
    assert {r["heads"] for r in per_case["qwen2-6heads-1x4"]} == {(6, 2)}
    assert {r["heads"] for r in per_case["qwen2-2x2"]} == {(2, 1)}


def test_cli_serves_the_one_rank_tokens(capfd):
    """``--data-par 2 --model-par 2 --device cpu --smoke`` on chatglm3:
    rank 0 prints the reference's line, and the tokens are the one-rank
    serve's from the same seed-0 weights."""
    args = ["--arch", "chatglm3-6b", "--smoke", "--device", "cpu",
            "--batch", "4", "--cache-len", "16", "--tokens", "3"]
    res = serve.main(args + ["--data-par", "2", "--model-par", "2"])
    cfg = smoke_variant(get_config("chatglm3-6b"))
    one = serve.serve_lm(cfg, batch=4, cache_len=16, tokens=3, device="cpu")
    assert tuple(res.tokens.shape) == (3, 4)
    assert torch.equal(res.tokens, one.tokens)
    assert f"{cfg.name}: 3 tokens × 4 seqs" in capfd.readouterr().out


def test_other_families_under_a_mesh_raise():
    """A MoE arch under --model-par 2, and every family but the dense and
    VLM decoders under a mesh of more than one rank, name item 13g-c;
    so does a MoE decoder given its placements (the dense and VLM
    forward runs on a mesh: tests/test_torch_tp_train.py)."""
    with pytest.raises(NotImplementedError, match="13g-c"):
        serve.main(["--arch", "mixtral-8x22b", "--smoke", "--device", "cpu",
                    "--model-par", "2"])
    grid = Mesh(("data", "model"), (1, 2))
    for arch in ("qwen3-moe-235b-a22b", "rwkv6-7b", "zamba2-1.2b",
                 "whisper-base"):
        with pytest.raises(NotImplementedError, match="13g-c"):
            build_model(smoke_variant(get_config(arch)), mesh=grid)
    cfg = smoke_variant(get_config("mixtral-8x22b"))
    with pytest.raises(NotImplementedError, match="13g-c"):
        build_model(cfg, mesh=grid,
                    place=param_pspecs(build_model(cfg), grid))
