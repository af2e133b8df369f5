"""The port's MoE layer (``repro_torch.models.moe``) against the JAX
reference (``repro/models/moe.py``), on the CPU: ``apply_moe`` on the
same numpy weights and tokens, with and without capacity drops, in f32
and bit for bit in bf16; routing on a router whose columns repeat, so
that probabilities tie at the top-k boundary; the twins of the MoE
properties of ``tests/test_model_properties.py``; and
``apply_moe_sharded`` on 8 gloo ranks (2 data × 4 model) in both of its
modes, held to the port's ``apply_moe`` and to the reference's own
``apply_moe_sharded``, which runs in a child process on 8 CPU devices.

The reference's ``tests/test_distributed_moe.py`` fails on this JAX
(its mesh's ``Explicit`` axes reject ``with_sharding_constraint``); the
child builds the same (2, 4) mesh with ``Auto`` axes, under which the
reference's own script passes."""
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as jmoe
from repro.models.config import ModelConfig as JModelConfig
from repro_torch import compat, convert
from repro_torch.analysis.hostsync import check_no_host_callbacks
from repro_torch.launch.sharded import MoECase, run_moe_cases
from repro_torch.models import moe as tmoe
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import template_init

REPO = Path(__file__).resolve().parents[1]
T = convert.tensor_from_numpy
D, F = 32, 48


def _cfgs(E, K, cf, d=D, f=F):
    kw = dict(name="t", family="moe", num_layers=1, d_model=d, num_heads=4,
              num_kv_heads=2, d_ff=f, vocab_size=64, num_experts=E,
              experts_per_token=K, moe_capacity_factor=cf)
    return JModelConfig(**kw), ModelConfig(**kw)


def _inputs(E, seed, d=D, f=F, B=2, S=24, repeat=1):
    """Numpy weights (fan-in scaled normals) and tokens; with ``repeat``
    r, router column e is column e // r of an (d, E / r) draw, so the
    probabilities of each r experts tie exactly."""
    rng = np.random.default_rng(seed)
    p = {"router": rng.normal(size=(d, E // repeat)) / np.sqrt(d),
         "w_gate": rng.normal(size=(E, d, f)) / np.sqrt(d),
         "w_up": rng.normal(size=(E, d, f)) / np.sqrt(d),
         "w_down": rng.normal(size=(E, f, d)) / np.sqrt(f)}
    p["router"] = np.repeat(p["router"], repeat, axis=1)
    x = rng.normal(size=(B, S, d))
    return ({k: v.astype(np.float32) for k, v in p.items()},
            x.astype(np.float32))


def _both(p, x, dtype):
    """numpy → (JAX weights, tokens), (torch weights, tokens) holding the
    same ``dtype`` values."""
    pj = {k: jnp.asarray(v, dtype) for k, v in p.items()}
    xj = jnp.asarray(x, dtype)
    back = lambda a: T(np.asarray(a.astype(jnp.float32))).to(  # noqa: E731
        getattr(torch, jnp.dtype(dtype).name))
    return (pj, xj), ({k: back(v) for k, v in pj.items()}, back(xj))


def _np(x):
    return convert.to_numpy(x) if isinstance(x, torch.Tensor) \
        else np.asarray(jnp.asarray(x, jnp.float32))


def _reference(jcfg, cf=None):
    return jax.jit(lambda p, x: jmoe.apply_moe(p, x, jcfg, cf))


# ---------------------------------------------------------------------------
# apply_moe ≡ the reference's
# ---------------------------------------------------------------------------

CASES = {
    # E, K, capacity factor: 8.0 drops nothing; 0.25 drops ~3/4 of the
    # assignments; 1.25 is the configs' own, at qwen3-moe's top-8
    "no-drops": (4, 2, 8.0),
    "drops": (4, 2, 0.25),
    "top8-of-16": (16, 8, 1.25),
}


@pytest.mark.parametrize("case", list(CASES))
def test_apply_moe_matches_reference(case):
    """f32: y within 1e-5 (the expert products are sums of two
    libraries), aux within 1e-6 relative."""
    E, K, cf = CASES[case]
    jcfg, cfg = _cfgs(E, K, cf)
    (pj, xj), (pt, xt) = _both(*_inputs(E, seed=E + K), jnp.float32)
    y_j, aux_j = _reference(jcfg)(pj, xj)
    y_t, aux_t = tmoe.apply_moe(pt, xt, cfg)
    assert y_t.shape == xt.shape and y_t.dtype == torch.float32
    assert aux_t.shape == () and aux_t.dtype == torch.float32
    np.testing.assert_allclose(_np(y_t), _np(y_j), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(aux_t), float(aux_j), rtol=1e-6)
    if case == "drops":     # some tokens lost every assignment
        assert (np.abs(_np(y_t)).max(-1) == 0).any()


@pytest.mark.parametrize("cf", [1.25, 8.0])
def test_apply_moe_is_the_reference_bit_for_bit_in_bfloat16(cf):
    """bf16 at E 16, K 8, 48 tokens: y equal bit for bit. The combine
    adds a token's 8 contributions in the order XLA's scatter-add takes
    them (ascending sorted position); the reverse order, a control,
    differs in most rows."""
    jcfg, cfg = _cfgs(16, 8, cf)
    (pj, xj), (pt, xt) = _both(*_inputs(16, seed=7), jnp.bfloat16)
    y_j, aux_j = _reference(jcfg)(pj, xj)
    y_t, aux_t = tmoe.apply_moe(pt, xt, cfg)
    assert y_t.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(y_t), _np(y_j))
    np.testing.assert_allclose(float(aux_t), float(aux_j), rtol=1e-6)
    # the control: the same contributions summed in reverse order
    xf = xt.reshape(-1, D)
    _, gates, idx = tmoe.route(xf, pt["router"], cfg)
    C = tmoe.capacity(xf.shape[0], cfg)
    plan = tmoe.dispatch_plan(gates, idx, C, 0, 16, xf.dtype)
    flipped = plan._replace(order=plan.order.flip(0), token=plan.token.flip(0),
                            gate=plan.gate.flip(0), keep=plan.keep.flip(0),
                            dest=plan.dest.flip(0))
    rev = tmoe._experts(xf, flipped, pt["w_gate"], pt["w_up"], pt["w_down"],
                        C).reshape(y_t.shape)
    rows = (_np(rev) != _np(y_j)).any(-1).mean()
    assert rows > 0.5, rows


def _reference_plan(jcfg, cf):
    """The reference's routing and dispatch bookkeeping
    (``repro/models/moe.py:45-75``), jitted as in ``apply_moe``."""
    E, K = jcfg.num_experts, jcfg.experts_per_token

    @jax.jit
    def plan(router, xf):
        T_ = xf.shape[0]
        probs = jax.nn.softmax((xf @ router).astype(jnp.float32), axis=-1)
        _, expert_idx = jax.lax.top_k(probs, K)
        C = max(1, int(T_ * K * cf / E))
        flat_expert = expert_idx.reshape(T_ * K)
        order = jnp.argsort(flat_expert)
        e_sorted = flat_expert[order]
        t_sorted = jnp.repeat(jnp.arange(T_, dtype=jnp.int32), K)[order]
        counts = jnp.bincount(e_sorted, length=E)
        starts = jnp.concatenate([jnp.zeros((1,), counts.dtype),
                                  jnp.cumsum(counts)[:-1]])
        pos = jnp.arange(T_ * K) - starts[e_sorted]
        return (expert_idx, order, t_sorted, (pos < C).astype(jnp.int32),
                e_sorted * C + jnp.minimum(pos, C - 1))
    return plan


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tied_probabilities_route_as_the_reference(dtype):
    """Router columns in fours (E 16, K 6): every token's 6th and 7th
    experts tie, so the tie order decides the top-k, and at capacity
    factor 0.5 the stable sort decides which assignments keep a slot.
    The same expert_idx (lower index first), the same sorted order, kept
    slots and destinations; y bit for bit in bf16, within 1e-5 in f32."""
    E, K, cf = 16, 6, 0.5
    jcfg, cfg = _cfgs(E, K, cf)
    (pj, xj), (pt, xt) = _both(*_inputs(E, seed=11, repeat=4),
                               jnp.dtype(dtype))
    xf_j, xf_t = xj.reshape(-1, D), xt.reshape(-1, D)
    probs, gates, idx = tmoe.route(xf_t, pt["router"], cfg)
    srt = probs.sort(-1, descending=True).values
    assert bool((srt[:, K - 1] == srt[:, K]).all())        # real ties
    want = [np.asarray(a) for a in _reference_plan(jcfg, cf)(pj["router"],
                                                             xf_j)]
    np.testing.assert_array_equal(idx.numpy(), want[0])
    assert bool((idx[:, :4].remainder(4) == torch.arange(4)).all())
    C = tmoe.capacity(xf_t.shape[0], cfg)
    plan = tmoe.dispatch_plan(gates, idx, C, 0, E, xt.dtype)
    for got, w in zip((plan.order, plan.token, plan.keep, plan.dest),
                      want[1:]):
        np.testing.assert_array_equal(got.long().numpy(), w)
    assert 0 < float(plan.keep.float().mean()) < 1          # drops happen
    y_j, aux_j = _reference(jcfg)(pj, xj)
    y_t, aux_t = tmoe.apply_moe(pt, xt, cfg)
    if dtype == "bfloat16":
        np.testing.assert_array_equal(_np(y_t), _np(y_j))
    else:
        np.testing.assert_allclose(_np(y_t), _np(y_j), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(aux_t), float(aux_j), rtol=1e-6)


def test_apply_moe_waits_for_nothing():
    """Run once under the static host-sync rule: no op that reads device
    values on the host or sizes its output by the data (bincount's max,
    nonzero, a boolean mask, .item())."""
    _, cfg = _cfgs(16, 8, 1.25)
    p, x = _inputs(16, seed=2)
    rep = check_no_host_callbacks(
        lambda p, x: tmoe.apply_moe(p, x, cfg),
        ({k: T(v) for k, v in p.items()}, T(x)), program="apply_moe")
    assert rep.checked > 0 and not rep.allowed


# ---------------------------------------------------------------------------
# Twins of tests/test_model_properties.py's MoE properties
# ---------------------------------------------------------------------------

def _prop_cfg(E=4, K=2, cf=8.0):
    return ModelConfig(name="t", family="moe", num_layers=1, d_model=32,
                       num_heads=4, num_kv_heads=2, d_ff=48, vocab_size=64,
                       num_experts=E, experts_per_token=K,
                       moe_capacity_factor=cf)


def _prop_params(cfg):
    return template_init(tmoe.moe_template(cfg),
                         torch.Generator().manual_seed(0), torch.float32)


def _normal(shape, seed):
    return torch.randn(shape, generator=torch.Generator().manual_seed(seed))


def test_moe_is_token_permutation_equivariant():
    cfg = _prop_cfg()
    p = _prop_params(cfg)
    x = _normal((1, 16, 32), 1)
    y, _ = tmoe.apply_moe(p, x, cfg)
    perm = torch.randperm(16, generator=torch.Generator().manual_seed(2))
    y_perm, _ = tmoe.apply_moe(p, x[:, perm, :], cfg)
    np.testing.assert_allclose(y[:, perm, :].numpy(), y_perm.numpy(),
                               rtol=2e-4, atol=1e-5)


def test_moe_capacity_drops_are_bounded():
    cfg = _prop_cfg(E=4, K=1, cf=0.25)    # capacity T/16: heavy overflow
    p = _prop_params(cfg)
    x = _normal((1, 1, 32), 1).expand(1, 32, 32)   # one expert for all
    y, _ = tmoe.apply_moe(p, x, cfg)
    served = int((y[0].norm(dim=-1) > 1e-6).sum())
    assert served <= tmoe.capacity(32, cfg) == max(1, int(32 * 0.25 / 4))
    assert bool(torch.isfinite(y).all())


def test_moe_gates_convex_combination():
    cfg = _prop_cfg()
    p = _prop_params(cfg)
    x = _normal((1, 8, 32), 1)
    y1, _ = tmoe.apply_moe(p, x, cfg)
    y3, _ = tmoe.apply_moe(dict(p, w_down=p["w_down"] * 3.0), x, cfg)
    np.testing.assert_allclose(y3.numpy(), 3.0 * y1.numpy(), rtol=1e-4,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# apply_moe_sharded on 2 × 4 gloo ranks, both modes
# ---------------------------------------------------------------------------

# tests/test_distributed_moe.py's two cases: E 8 over 4 model ranks
# (experts split), E 2 < 4 (the FFN dim split inside each expert)
MODES = {"expert_parallel": (8, 2), "tp": (2, 1)}
SD, SF = 64, 96

_CHILD = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType
from repro import compat
from repro.models import moe as moe_lib
from repro.models.config import ModelConfig

data = dict(np.load(sys.argv[1]))
# the reference test's (2, 4) mesh, with Auto axes: under this JAX
# compat.make_mesh builds Explicit ones, which with_sharding_constraint
# rejects
mesh = jax.make_mesh((2, 4), ("data", "model"),
                     axis_types=(AxisType.Auto, AxisType.Auto))
out = {}
for mode, E, K in (("expert_parallel", 8, 2), ("tp", 2, 1)):
    cfg = ModelConfig(name="t", family="moe", num_layers=1, d_model=64,
                      num_heads=4, num_kv_heads=2, d_ff=96, vocab_size=64,
                      num_experts=E, experts_per_token=K,
                      moe_capacity_factor=8.0)
    p = {k: jnp.asarray(data[f"{mode}/{k}"])
         for k in ("router", "w_gate", "w_up", "w_down")}
    with compat.set_mesh(mesh):
        y, aux = jax.jit(lambda p, x: moe_lib.apply_moe_sharded(
            p, x, cfg, mesh, ("data",)))(p, jnp.asarray(data["x"]))
    out[f"{mode}/y"], out[f"{mode}/aux"] = np.asarray(y), np.asarray(aux)
np.savez(sys.argv[2], **out)
print("CHILD_OK")
"""


@pytest.fixture(scope="module")
def sharded():
    """Both modes on 8 gloo ranks in one spawn, the reference's sharded
    layer running beside it in a child process. → (per mode: numpy
    weights, config, per rank (y shard, aux)), the tokens, the child's
    outputs by key."""
    from conftest import subprocess_env
    x = np.random.default_rng(1).normal(size=(4, 16, SD)).astype(np.float32)
    modes = {}
    for mode, (E, K) in MODES.items():
        _, cfg = _cfgs(E, K, 8.0, SD, SF)
        modes[mode] = (_inputs(E, seed=E, d=SD, f=SF)[0], cfg)
    tmp = tempfile.mkdtemp(prefix="moe_sharded_")
    inp, outp = os.path.join(tmp, "in.npz"), os.path.join(tmp, "out.npz")
    np.savez(inp, x=x, **{f"{m}/{k}": v for m, (p, _) in modes.items()
                          for k, v in p.items()})
    child = subprocess.Popen(
        [sys.executable, "-c", _CHILD, inp, outp], cwd=str(REPO),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=subprocess_env(PYTHONPATH=str(REPO / "src")))
    try:
        per_rank = compat.spawn(
            run_moe_cases, 8,
            ([MoECase(cfg, p, x) for p, cfg in modes.values()],),
            device="cpu", timeout_s=120.0, join_timeout_s=300.0)
        stdout, stderr = child.communicate(timeout=300)
    finally:
        if child.poll() is None:
            child.kill()
    assert "CHILD_OK" in stdout, stdout + stderr
    with np.load(outp) as f:
        ref = {k: f[k] for k in f.files}
    out = {m: (p, cfg, [r[i] for r in per_rank])
           for i, (m, (p, cfg)) in enumerate(modes.items())}
    return out, x, ref


def _assembled(results):
    """Per rank (y shard, aux) → (y (B, S, D), aux): the model replicas
    of each data shard equal, then the data shards in order."""
    ys = [y for y, _ in results]
    for d in range(2):
        for m in range(1, 4):
            np.testing.assert_array_equal(ys[d * 4 + m], ys[d * 4])
    auxes = {a for _, a in results}
    assert len(auxes) == 1, auxes
    return np.concatenate([ys[0], ys[4]]), auxes.pop()


@pytest.mark.parametrize("mode", list(MODES))
def test_apply_moe_sharded_matches_apply_moe(sharded, mode):
    """The tolerances of tests/test_distributed_moe.py: y within 2e-4 of
    one rank's apply_moe, aux (the mean of the two data shards' losses)
    within 0.1 of the whole batch's."""
    runs, x, _ = sharded
    p, cfg, results = runs[mode]
    y, aux = _assembled(results)
    y_one, aux_one = tmoe.apply_moe({k: T(v) for k, v in p.items()}, T(x),
                                    cfg)
    np.testing.assert_allclose(y, y_one.numpy(), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(aux, float(aux_one), rtol=0.1)
    assert tmoe.expert_parallel(cfg, 4) == (mode == "expert_parallel")


@pytest.mark.parametrize("mode", list(MODES))
def test_apply_moe_sharded_matches_the_reference_sharded(sharded, mode):
    """The reference's apply_moe_sharded on the same weights and tokens:
    y within 1e-5, the per-shard aux averaged over the data shards within
    1e-6 relative."""
    runs, _, ref = sharded
    y, aux = _assembled(runs[mode][2])
    np.testing.assert_allclose(y, ref[f"{mode}/y"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(aux, float(ref[f"{mode}/aux"]), rtol=1e-6)
