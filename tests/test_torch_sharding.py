"""The port's placement rules, meshes and cost model
(``repro_torch/launch/{sharding,rules,mesh,costs}.py``) against the JAX
reference's (``repro/launch/{sharding,rules,mesh,costs}.py``), on
shape-only meshes (no ranks, no devices): the twins of
``tests/test_sharding.py``; every parameter placement of every LM config
under every rule set at three meshes; every family's decode-state
placements; the serve step's bundle placements; ``analytic_costs`` of
every arch and input shape. On a mesh with a rank's coordinates (no
process group): a rank's sharded draws and conversions against the
shards of the whole weights and state."""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro import compat as jcompat
from repro.configs import get_config as j_get_config
from repro.launch import costs as jcosts
from repro.launch import mesh as jmesh
from repro.launch import sharding as jshd
from repro.launch import steps as jsteps
from repro.launch.rules import RULE_SETS as J_RULE_SETS
from repro.models.transformer import build_model as j_build_model
from repro_torch.configs import PORTED_ARCHS, get_config
from repro_torch.launch import costs, mesh as tmesh, sharding as shd, steps
from repro_torch.launch.rules import RULE_SETS, get_rules
from repro_torch.launch.sharding import (batch_pspec, kv_repeat_for,
                                         param_pspecs, pspec_for)
from repro_torch import convert
from repro_torch.models.layers import (local_shape, local_shard, shard_count,
                                       template_init, tree_leaves)
from repro_torch.models.transformer import build_model

MESH = tmesh.make_production_mesh()
POD_MESH = tmesh.make_production_mesh(multi_pod=True)
LM_ARCHS = [a for a in PORTED_ARCHS if a != "svm_tfidf"]
# (sizes, names): a small host grid and the two production grids
MESHES = (((2, 4), ("data", "model")), ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")))


def _meshes():
    """(port mesh, reference AbstractMesh) pairs of MESHES."""
    return [(tmesh.Mesh(names, sizes),
             jcompat.make_abstract_mesh(sizes, names))
            for sizes, names in MESHES]


def _state_leaves(state) -> list:
    """A decode state's tensors (or placements) in field order."""
    if isinstance(state, tuple) and hasattr(state, "_fields"):
        return [x for f in state._fields
                for x in _state_leaves(getattr(state, f))]
    return [state]


def _specs(tree) -> list:
    """The reference's PartitionSpecs of a tree as tuples, in order."""
    return [tuple(s) for s in jax.tree.leaves(
        tree, is_leaf=lambda x: isinstance(x, P))]


# ---------------------------------------------------------------------------
# Twins of tests/test_sharding.py
# ---------------------------------------------------------------------------

def test_vocab_parallel_embedding():
    assert pspec_for((151936, 4096), ("vocab", "embed"), MESH) \
        == ("model", "data")


def test_divisibility_fallback():
    # 12 heads don't divide 16 → replicated
    spec = pspec_for((1536, 12, 128), ("embed", "heads", "head_dim"), MESH)
    assert (spec + (None,) * 3)[1] is None
    # but ffn still shards
    assert pspec_for((1536, 8960), ("embed", "ffn"), MESH) \
        == ("data", "model")


def test_no_axis_reuse_within_tensor():
    # both dims want "model" → the second falls through
    assert pspec_for((1024, 2048), ("vocab", "ffn"), MESH).count("model") == 1


def test_experts_fallback_small_expert_count():
    # mixtral: 8 experts < 16 shards → experts replicated, ffn sharded
    spec = pspec_for((8, 6144, 16384), ("experts", "embed", "ffn"), MESH)
    assert spec[0] is None and "model" in spec
    # qwen3: 128 experts shard cleanly
    assert pspec_for((128, 4096, 1536), ("experts", "embed", "ffn"),
                     MESH)[0] == "model"


def test_kv_repeat():
    assert kv_repeat_for(get_config("llama3-8b"), MESH) == 2      # 8→16
    assert kv_repeat_for(get_config("qwen3-moe-235b-a22b"), MESH) == 4
    assert kv_repeat_for(get_config("chatglm3-6b"), MESH) == 8    # 2→16
    assert kv_repeat_for(get_config("zamba2-1.2b"), MESH) == 1    # 32%16==0
    assert kv_repeat_for(get_config("qwen2-1.5b"), MESH) == 1     # H=12: no
    assert kv_repeat_for(get_config("rwkv6-7b"), MESH) == 1       # attn-free


def test_batch_pspec():
    assert batch_pspec(MESH, 256) == ("data",)
    assert batch_pspec(POD_MESH, 256) == (("pod", "data"),)
    assert batch_pspec(MESH, 1) == (None,)      # long_500k: replicated


def test_param_pspecs_cover_all_leaves():
    model = build_model(get_config("mixtral-8x22b"))
    specs = tree_leaves(param_pspecs(model, MESH))
    abstract = tree_leaves(model.abstract())
    assert len(specs) == len(abstract)
    assert all(isinstance(s, tuple) for s in specs)
    # every split dim divides its mesh axis
    for spec, a in zip(specs, abstract):
        for dim, ax in zip(a.shape, spec):
            if ax is not None:
                assert dim % shard_count(ax, MESH) == 0, (spec, a.shape)


def test_rule_sets_exist():
    for name in ("baseline", "tp_only", "fsdp_ffn", "expert_first"):
        assert name in RULE_SETS
        get_rules(name)
    with pytest.raises(KeyError):
        get_rules("nope")


# ---------------------------------------------------------------------------
# Every placement ≡ the reference's
# ---------------------------------------------------------------------------

def test_rule_sets_equal_the_reference():
    assert RULE_SETS == J_RULE_SETS
    assert shd.DEFAULT_RULES == jshd.DEFAULT_RULES


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_param_pspecs_equal_the_reference(arch):
    """Every leaf, under every rule set, at (2, 4), (16, 16) and
    (2, 16, 16): the same placement as the reference's PartitionSpec,
    leaf for leaf in the same (sorted-key) order."""
    model, jmodel = build_model(get_config(arch)), j_build_model(
        j_get_config(arch))
    n = len(jax.tree.leaves(jmodel.abstract()))
    for tm, jm in _meshes():
        for name in RULE_SETS:
            got = tree_leaves(param_pspecs(model, tm, RULE_SETS[name]))
            want = _specs(jshd.param_pspecs(jmodel, jm, J_RULE_SETS[name]))
            assert len(got) == len(want) == n
            assert got == want, (arch, tm.sizes, name)


def _state_pairs(arch, tm, jm, batch, cache):
    """(port, reference) decode states of ``arch`` at the mesh's
    kv_repeat: the port's as ``meta`` tensors, the reference's
    ShapeDtypeStructs."""
    r = kv_repeat_for(get_config(arch), tm)
    assert r == jshd.kv_repeat_for(j_get_config(arch), jm)
    model = build_model(get_config(arch), kv_repeat=r)
    jmodel = j_build_model(j_get_config(arch), kv_repeat=r)
    state = model.decode_state_abstract(batch, cache)
    return model, state, jmodel, jmodel.decode_state_abstract(batch, cache)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "chatglm3-6b",
                                  "qwen3-moe-235b-a22b", "rwkv6-7b",
                                  "zamba2-1.2b", "whisper-base"])
def test_decode_state_pspecs_equal_the_reference(arch):
    """Each family's decode state (dense, MoE, attention-free, hybrid,
    encoder-decoder), leaf for leaf: the same shapes and placements at
    the three meshes, the batch split (128) and replicated (3)."""
    for tm, jm in _meshes():
        for batch in (128, 3):
            model, state, jmodel, jstate = _state_pairs(arch, tm, jm, batch,
                                                        64)
            assert [tuple(t.shape) for t in _state_leaves(state)] == \
                [a.shape for a in jax.tree.leaves(jstate)]
            got = _state_leaves(shd.decode_state_pspecs(model, state, tm,
                                                           batch))
            want = _specs(jshd.decode_state_pspecs(jmodel, jstate, jm,
                                                   batch))
            assert got == want, (arch, tm.sizes, batch)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "qwen2-1.5b",
                                  "chatglm3-6b", "llama3-8b",
                                  "llava-next-34b"])
def test_serve_bundle_placements_equal_the_reference(arch):
    """``build_serve_step`` on the shape-only meshes at decode_32k and
    long_500k (a replicated batch): kv_repeat, every in_ and
    out_sharding and the abstract inputs' shapes as the reference's
    bundle on an AbstractMesh."""
    for tm, jm in _meshes():
        for name in ("decode_32k", "long_500k"):
            tb = steps.build_serve_step(get_config(arch), tm,
                                        steps.INPUT_SHAPES[name])
            jb = jsteps.build_serve_step(j_get_config(arch), jm,
                                         jsteps.INPUT_SHAPES[name])
            assert tb.model.kv_repeat == jb.model.kv_repeat
            assert tb.donate_argnums == jb.donate_argnums == (1,)
            got = (tree_leaves(tb.in_shardings[0])
                   + _state_leaves(tb.in_shardings[1])
                   + [tb.in_shardings[2], tb.out_shardings[0]]
                   + _state_leaves(tb.out_shardings[1]))
            want = (_specs(jb.in_shardings[0]) + _specs(jb.in_shardings[1])
                    + _specs([jb.in_shardings[2], jb.out_shardings[0]])
                    + _specs(jb.out_shardings[1]))
            assert got == want, (arch, tm.sizes, name)
            assert [tuple(t.shape) for t in _state_leaves(tb.args[1])] \
                == [a.shape for a in jax.tree.leaves(jb.args[1])]


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "llava-next-34b",
                                  "whisper-base"])
def test_leading_batch_specs_equal_the_reference(arch):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    for tm, jm in _meshes():
        for name in ("train_4k", "long_500k"):
            batch = steps.train_batch_abstract(cfg, steps.INPUT_SHAPES[name])
            jbatch = jsteps.train_batch_abstract(jcfg,
                                                 jsteps.INPUT_SHAPES[name])
            B = steps.INPUT_SHAPES[name].global_batch
            got = tree_leaves(shd.leading_batch_specs(batch, tm, B))
            assert got == _specs(jshd.leading_batch_specs(jbatch, jm, B))


def test_mesh_helpers_equal_the_reference():
    for tm, jm in _meshes():
        assert tmesh.batch_axes(tm) == jmesh.batch_axes(jm)
        assert tmesh.data_parallel_size(tm) == jmesh.data_parallel_size(jm)
        assert tmesh.model_parallel_size(tm) == \
            jmesh.model_parallel_size(jm)
    assert (MESH.axis_names, MESH.sizes) == (("data", "model"), (16, 16))
    assert (POD_MESH.axis_names, POD_MESH.sizes) == (
        ("pod", "data", "model"), (2, 16, 16))
    with pytest.raises(ValueError, match="shape-only"):
        MESH.index("data")


def test_local_shard_and_one_rank_host_mesh():
    """Without a process group the host mesh is 1 × 1 (the reference's
    clamp to the devices there are) and a shard is the whole tensor; a
    rank's block along a split dim, the axes of a tuple entry taken
    row-major."""
    one = tmesh.make_host_mesh(2, 4)
    assert one.sizes == (1, 1) and one.coords == (0, 0)
    t = torch.arange(24.0).reshape(4, 6)
    assert local_shard(t, ("data", "model"), one) is t
    grid = tmesh.Mesh(("pod", "data", "model"), (2, 2, 3),
                      coords=(1, 0, 2))
    assert local_shape((8, 6), (("pod", "data"), "model"), grid) \
        == (2, 2)
    got = local_shard(t.repeat(2, 1), (("pod", "data"), "model"), grid)
    np.testing.assert_array_equal(got.numpy(), t.repeat(2, 1)[4:6, 4:6])
    with pytest.raises(ValueError, match="does not split"):
        local_shape((6,), ("model",), tmesh.Mesh(("model",), (4,)))


@pytest.mark.parametrize("coords", [(0, 1), (1, 0)])
def test_a_ranks_draws_are_its_shards_of_one_process_weights(coords):
    """``template_init`` with placements draws each slice whole and keeps
    the rank's part: the shards of the one-process init from the same
    seed (``convert.shard_params``), bit for bit; so are
    ``lm_params_from_jax``'s and ``decode_state_from_jax``'s slices of
    numpy arrays, and the rank's zero state has the slice's shapes."""
    cfg = dataclasses.replace(get_config("qwen2-1.5b"), num_layers=2,
                              d_model=64, num_heads=4, num_kv_heads=2,
                              d_ff=96, vocab_size=128, head_dim=16,
                              dtype="float32")
    grid = tmesh.Mesh(("data", "model"), (2, 2), coords=coords)
    model = build_model(cfg)
    place = param_pspecs(model, grid)
    whole = model.init(torch.Generator().manual_seed(3))
    mine = template_init(model.template(), torch.Generator().manual_seed(3),
                         torch.float32, place, grid)
    want = convert.shard_params(whole, place, grid)
    assert [tuple(t.shape) for t in tree_leaves(mine)] == [
        local_shape(tuple(w.shape), pl, grid)
        for w, pl in zip(tree_leaves(whole), tree_leaves(place))]
    for a, b in zip(tree_leaves(mine), tree_leaves(want)):
        assert torch.equal(a, b)
    host = convert.lm_params_from_jax(_numpy_tree(whole), mesh=grid,
                                      placements=place)
    for a, b in zip(tree_leaves(host), tree_leaves(want)):
        assert torch.equal(a, b)
    state = model.decode_state_abstract(4, 8)
    splace = shd.decode_state_pspecs(model, state, grid, 4)
    full = np.arange(state.caches.k.numel(), dtype=np.float32).reshape(
        state.caches.k.shape)
    like = state._replace(caches=state.caches._replace(
        k=torch.empty(local_shape(full.shape, splace.caches.k, grid)),
        v=torch.empty(local_shape(full.shape, splace.caches.v, grid))),
        pos=torch.zeros((), dtype=torch.int32))
    got = convert.decode_state_from_jax(
        state._replace(caches=state.caches._replace(k=full, v=-full),
                       pos=np.int32(5)), like, splace, grid)
    assert torch.equal(got.caches.k, local_shard(torch.from_numpy(full),
                                                     splace.caches.k, grid))
    assert torch.equal(got.caches.v, -got.caches.k) and int(got.pos) == 5


def _numpy_tree(tree):
    return {k: _numpy_tree(v) if isinstance(v, dict) else v.numpy()
            for k, v in tree.items()}


# ---------------------------------------------------------------------------
# analytic_costs ≡ the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", LM_ARCHS)
def test_analytic_costs_equal_the_reference(arch):
    """FLOPs and HBM bytes of every input shape within 1e-12 relative,
    at the config's own dtype and in float32."""
    for dtype in (None, "float32"):
        cfg, jcfg = get_config(arch), j_get_config(arch)
        if dtype:
            cfg = dataclasses.replace(cfg, dtype=dtype)
            jcfg = dataclasses.replace(jcfg, dtype=dtype)
        for name, shape in steps.INPUT_SHAPES.items():
            got = costs.analytic_costs(cfg, shape)
            want = jcosts.analytic_costs(jcfg, jsteps.INPUT_SHAPES[name])
            for f in ("flops", "hbm_bytes"):
                a, b = getattr(got, f), getattr(want, f)
                assert abs(a - b) <= 1e-12 * abs(b), (arch, name, f, a, b)
            assert got.flops > 0 and got.hbm_bytes > 0
