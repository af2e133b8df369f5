"""The port's LM training against the JAX reference, on the CPU: the
loss's gradients by autograd against ``jax.value_and_grad(model.loss)``
for every ported LM config's smoke variant (and with several
checkpointed loss chunks, the last padded), three steps of
``build_train_step`` against the reference's, remat on against off, the
prefill step, the twin of ``test_smoke_train_step_reduces_loss``, the
train CLI's LM mode and ``examples/torch_train_backbone.py`` resuming
the reference example's checkpoint and the other way round. Parameters
are JAX-initialised and carried across with
``convert.lm_params_from_jax``, optimizer state with
``convert.opt_state_from_jax``. All in float32; a gradient leaf is held
to max |Δ| ≤ 1e-5 of its largest entry."""
import dataclasses
import importlib.util
import os
import runpy
import shutil
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro.ckpt.checkpoint import _flatten as j_flatten
from repro.configs import get_config as j_get_config
from repro.data import DataConfig as JDataConfig
from repro.data import lm_batch_at as j_lm_batch_at
from repro.launch import steps as jsteps
from repro.launch.mesh import make_host_mesh
from repro.metrics import read_jsonl
from repro.models import layers as jlayers
from repro.models.config import smoke_variant as j_smoke_variant
from repro.models.transformer import build_model as j_build_model
from repro_torch import convert, optim
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, lm_batch_at
from repro_torch.kernels import ops
from repro_torch.launch import steps, train
from repro_torch.models import layers as tlayers
from repro_torch.models.config import smoke_variant
from repro_torch.models.layers import tree_leaves, tree_map
from repro_torch.models.transformer import build_model
from torch_threads import one_thread, process_threads  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
LM_ARCHS = ("tinyllama-1.1b", "llama3-8b", "qwen2-1.5b", "chatglm3-6b",
            "llava-next-34b", "mixtral-8x22b", "qwen3-moe-235b-a22b",
            "rwkv6-7b", "zamba2-1.2b", "whisper-base")
TRAJ_ARCHS = ("tinyllama-1.1b", "qwen2-1.5b", "llava-next-34b")
TOL = 1e-5
B, S = 2, 32


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _cfgs(arch, **kw):
    return (dataclasses.replace(smoke_variant(get_config(arch)), **kw),
            dataclasses.replace(j_smoke_variant(j_get_config(arch)), **kw))


def _setup(arch, step=0, **kw):
    """(port cfg, JAX cfg, JAX params, port params, numpy batch)."""
    cfg, jcfg = _cfgs(arch, **kw)
    jparams = j_build_model(jcfg).init(jax.random.PRNGKey(0))
    tparams = convert.lm_params_from_jax(jax.tree.map(np.asarray, jparams))
    batch = j_lm_batch_at(JDataConfig(batch_size=B, seq_len=S, seed=3),
                          jcfg, step)
    return cfg, jcfg, jparams, tparams, batch


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _leaf_close(got, want, tol=TOL, what=""):
    got, want = got.detach().float().numpy(), _np(want)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, f"{what}: max|Δ| {err:.2e} of its largest entry"


def _grads(loss_fn, params):
    wrt = tree_map(lambda p: p.detach().requires_grad_(), params)
    loss = loss_fn(wrt)
    return loss.detach(), torch.autograd.grad(loss, tree_leaves(wrt))


# ---------------------------------------------------------------------------
# gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", LM_ARCHS)
def test_loss_gradients_match_reference(arch):
    """One batch's loss and every gradient leaf by autograd through the
    model's ``loss`` against ``jax.value_and_grad(model.loss)``, on each
    ported config's smoke variant: within 1e-5. Without RoPE (whisper)
    a key bias shifts each query's scores by one constant, which the
    softmax cancels: its gradient is 0 but for rounding (~1e-9 in
    either package), and both packages' are held to 1e-5 of the largest
    gradient entry of any leaf instead."""
    cfg, jcfg, jparams, tparams, batch = _setup(arch)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        j_build_model(jcfg).loss, has_aux=True))(jparams, _jb(batch))
    model = build_model(cfg)
    loss, grads = _grads(lambda p: model.loss(p, _tb(batch))[0], tparams)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=TOL)
    largest = max(float(np.abs(_np(g)).max()) for g in jax.tree.leaves(jgrads))
    for (path, jg), g in zip(jax.tree_util.tree_flatten_with_path(jgrads)[0],
                             grads):
        name = jax.tree_util.keystr(path)
        if cfg.rope_fraction == 0 and name.endswith("['bk']"):
            assert max(float(g.abs().max()), float(np.abs(_np(jg)).max())) \
                <= TOL * largest, f"{arch} {name}"
        else:
            _leaf_close(g, jg, what=f"{arch} {name}")


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "qwen2-1.5b"])
def test_chunked_loss_gradients_match_reference(arch):
    """The chunked loss at chunk 24 over 64 tokens (three checkpointed
    chunks, the last padded by 8 rows), with a loss mask: the loss and
    every gradient leaf within 1e-5 of JAX's ``jax.checkpoint``-ed scan,
    on an untied (tinyllama) and a tied head (qwen2)."""
    cfg, jcfg, jparams, tparams, batch = _setup(arch, step=1)
    mask = (np.random.default_rng(4).random((B, S)) < 0.7).astype(np.int32)
    jmodel, model = j_build_model(jcfg), build_model(cfg)

    def jloss(p):
        h, _ = jmodel.hidden_states(p, jnp.asarray(batch["tokens"]))
        return jlayers.chunked_lm_loss(
            p["embed"], h, jnp.asarray(batch["labels"]), jcfg.tie_embeddings,
            jnp.asarray(mask), chunk=24)

    def tloss(p):
        h, _ = model.hidden_states(p, torch.from_numpy(batch["tokens"]))
        return tlayers.chunked_lm_loss(
            p["embed"], h, torch.from_numpy(batch["labels"]),
            cfg.tie_embeddings, torch.from_numpy(mask), chunk=24)

    want, jgrads = jax.jit(jax.value_and_grad(jloss))(jparams)
    got, grads = _grads(tloss, tparams)
    np.testing.assert_allclose(float(got), float(want), rtol=TOL)
    for (path, jg), g in zip(jax.tree_util.tree_flatten_with_path(jgrads)[0],
                             grads):
        _leaf_close(g, jg, what=f"{arch} {jax.tree_util.keystr(path)}")


def test_remat_gives_the_same_gradients():
    """cfg.remat (each layer checkpointed) against no remat, in the port,
    on the VLM and a MoE config: the same loss and gradients within
    1e-6."""
    for arch in ("llava-next-34b", "qwen3-moe-235b-a22b"):
        cfg, _, _, tparams, batch = _setup(arch)
        out = []
        for remat in (False, True):
            model = build_model(dataclasses.replace(cfg, remat=remat))
            out.append(_grads(lambda p: model.loss(p, _tb(batch))[0],
                              tparams))
        (l0, g0), (l1, g1) = out
        assert float(l0) == pytest.approx(float(l1), rel=1e-6)
        for a, b in zip(g0, g1):
            assert float((a - b).abs().max()) <= 1e-6 * max(
                float(a.abs().max()), 1e-30)


# ---------------------------------------------------------------------------
# the step builders
# ---------------------------------------------------------------------------

# eps 1e-6, not 1e-8: a key bias's gradient is zero but for rounding (one
# shift of every key's score leaves the softmax as it is), and at eps 1e-8
# AdamW turns that ~1e-10 noise into steps of O(lr), which differ between
# any two implementations; at 1e-6 they stay below 1e-3·lr
TRAJ_OPT = dict(lr=1e-3, eps=1e-6, warmup_steps=1, total_steps=10)


@pytest.mark.parametrize("arch", TRAJ_ARCHS)
def test_train_step_trajectory_matches_reference(arch):
    """Three steps of the port's build_train_step against the reference's
    build_train_step (its default remat=True, on a one-device host mesh),
    from the same params and optimizer state (carried across with
    convert.opt_state_from_jax) on each package's own batches (the same
    bytes): each step's loss,
    ce, aux, lr and grad_norm, then the params and moments (over the
    largest entry of the tree), within 1e-5."""
    cfg, jcfg, jparams, tparams, _ = _setup(arch)
    shape = steps.InputShape("t", "train", S, B)
    jb = jsteps.build_train_step(jcfg, make_host_mesh(1, 1),
                                 jsteps.InputShape("t", "train", S, B),
                                 opt_cfg=joptim.OptConfig(**TRAJ_OPT))
    tb = steps.build_train_step(cfg, None, shape,
                                opt_cfg=optim.OptConfig(**TRAJ_OPT))
    assert tb.model.cfg.remat and tb.donate_argnums == (0, 1)
    assert tb.in_shardings is None and tb.out_shardings is None
    jstate = joptim.init(jparams)
    tstate = convert.opt_state_from_jax(jax.tree.map(np.asarray, jstate))
    jfn = jax.jit(jb.fn)
    dcfg, jdcfg = (DataConfig(batch_size=B, seq_len=S, seed=3),
                   JDataConfig(batch_size=B, seq_len=S, seed=3))
    for step in range(3):
        jparams, jstate, jm = jfn(jparams, jstate,
                                  _jb(j_lm_batch_at(jdcfg, jcfg, step)))
        tparams, tstate, tm = tb.fn(tparams, tstate,
                                    _tb(lm_batch_at(dcfg, cfg, step)))
        assert sorted(tm) == sorted(jm) == ["aux", "ce", "grad_norm",
                                            "loss", "lr"]
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=TOL,
                                       atol=TOL, err_msg=f"step {step} {k}")
    assert int(tstate.step) == 3
    for got, want in zip(tree_leaves(tparams), jax.tree.leaves(jparams)):
        np.testing.assert_allclose(got.numpy(), _np(want), atol=TOL)
    for tree, jtree in ((tstate.mu, jstate.mu), (tstate.nu, jstate.nu)):
        scale = max(float(jnp.abs(w).max()) for w in jax.tree.leaves(jtree))
        for got, want in zip(tree_leaves(tree), jax.tree.leaves(jtree)):
            np.testing.assert_allclose(got.numpy(), _np(want), rtol=0,
                                       atol=TOL * scale)


def test_step_bundles_and_abstract_inputs():
    """The bundles' abstract inputs mirror the reference's (shapes and
    dtypes, meta tensors; the decode state too, for every family),
    build_step dispatches on the shape's kind, and a mesh of more than
    one rank raises naming 13g for the families whose steps stay open
    there (a MoE train step, an rwkv6 prefill step); rules without a mesh
    raise."""
    for arch in ("qwen2-1.5b", "llava-next-34b", "rwkv6-7b", "zamba2-1.2b",
                 "whisper-base"):
        cfg, jcfg = _cfgs(arch)
        for name in ("train_4k", "prefill_32k", "decode_32k"):
            shape = steps.INPUT_SHAPES[name]
            jshape = jsteps.INPUT_SHAPES[name]
            assert dataclasses.asdict(shape) == dataclasses.asdict(jshape)
            tb = steps.build_step(cfg, None, shape)
            jb = jsteps.build_step(jcfg, make_host_mesh(1, 1), jshape)
            got, want = [], []
            tree_map(got.append, tb.args[-1] if name != "decode_32k"
                             else {"t": tb.args[-1]})
            want = jax.tree.leaves(jb.args[-1])
            assert [(tuple(t.shape), str(t.dtype).removeprefix("torch."))
                    for t in got] == [(a.shape, str(a.dtype)) for a in want]
            assert all(t.device.type == "meta" for t in got)
            assert tb.donate_argnums == jb.donate_argnums
            params = tree_leaves(tb.args[0])
            assert [tuple(p.shape) for p in params] == \
                [a.shape for a in jax.tree.leaves(jb.args[0])]
            if name == "decode_32k":      # the decode state, leaf by leaf
                assert [(tuple(t.shape), str(t.dtype).removeprefix("torch."))
                        for t in jax.tree.leaves(tb.args[1])] == \
                    [(a.shape, str(a.dtype))
                     for a in jax.tree.leaves(jb.args[1])], arch
        assert steps.applicability(cfg, steps.INPUT_SHAPES["long_500k"]) \
            == jsteps.applicability(jcfg, jsteps.INPUT_SHAPES["long_500k"])
    from repro_torch.launch.mesh import Mesh
    grid = Mesh(("data", "model"), (1, 2))            # shape-only, 2 ranks
    with pytest.raises(NotImplementedError, match="13g"):
        steps.build_train_step(_cfgs("mixtral-8x22b")[0], grid,
                               steps.INPUT_SHAPES["train_4k"])
    with pytest.raises(NotImplementedError, match="13g"):
        steps.build_prefill_step(_cfgs("rwkv6-7b")[0], grid,
                                 steps.INPUT_SHAPES["prefill_32k"])
    with pytest.raises(ValueError, match="mesh"):
        steps.build_prefill_step(cfg, None, steps.INPUT_SHAPES["train_4k"],
                                 rules={})


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "llava-next-34b"])
def test_prefill_step_matches_reference(arch):
    """build_prefill_step's last-position logits (B, 1, V) against the
    reference's, on a dense and the VLM smoke config: within 1e-5."""
    cfg, jcfg, jparams, tparams, batch = _setup(arch)
    batch.pop("labels")
    shape = steps.InputShape("p", "prefill", S, B)
    jb = jsteps.build_prefill_step(jcfg, make_host_mesh(1, 1),
                                   jsteps.InputShape("p", "prefill", S, B))
    want = jax.jit(jb.fn)(jparams, _jb(batch))
    got = steps.build_prefill_step(cfg, None, shape).fn(tparams, _tb(batch))
    assert tuple(got.shape) == (B, 1, cfg.vocab_size) and not got.requires_grad
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_smoke_train_step_reduces_loss(arch):
    """The reference's test_smoke_train_step_reduces_loss on the port,
    through build_train_step: 8 steps on one batch, losses finite and
    falling."""
    cfg = smoke_variant(get_config(arch))
    P = cfg.num_prefix_tokens
    batch = {"tokens": torch.zeros((B, S - P), dtype=torch.int32),
             "labels": torch.ones((B, S - P), dtype=torch.int32)}
    if P:
        batch["prefix_embeds"] = torch.ones((B, P, cfg.d_model))
    if cfg.is_encoder_decoder:
        batch["frames"] = torch.ones((B, cfg.encoder_seq, cfg.d_model))
    bundle = steps.build_train_step(
        cfg, None, steps.InputShape("s", "train", S, B),
        opt_cfg=optim.OptConfig(lr=5e-3, warmup_steps=2, total_steps=50),
        remat=False)
    params = bundle.model.init(torch.Generator().manual_seed(0))
    ostate = optim.init(params)
    losses = []
    for _ in range(8):
        params, ostate, m = bundle.fn(params, ostate, batch)
        losses.append(float(m["loss"]))
        assert np.isfinite(losses[-1]), f"{arch} diverged"
    assert losses[-1] < losses[0], f"{arch}: {losses[0]} -> {losses[-1]}"


def test_train_step_launches_no_kernel_on_the_cpu():
    """A train step on CPU tensors runs plain PyTorch only: every launch
    and route count stays 0, and no param requires grad after it."""
    cfg, _, _, tparams, batch = _setup("qwen2-1.5b")
    bundle = steps.build_train_step(cfg, None,
                                    steps.InputShape("c", "train", S, B))
    ops.reset_launches()
    bundle.fn(tparams, optim.init(tparams), _tb(batch))
    assert not any(ops.LAUNCHES.values()), ops.LAUNCHES
    assert not any(ops.ROUTE_LAUNCHES.values()), ops.ROUTE_LAUNCHES
    assert not any(p.requires_grad for p in tree_leaves(tparams))


# ---------------------------------------------------------------------------
# the train CLI and the backbone example
# ---------------------------------------------------------------------------

def test_train_cli_lm_mode_saves_the_reference_keys(tmp_path, capsys):
    """``--smoke --steps 2 --batch 2 --seq 32 --device cpu --ckpt``: two
    steps, the reference's lines, and a checkpoint whose keys are those
    the reference's CLI writes ({"params": params} of the smoke model);
    --data-par 2 on a MoE arch raises naming 13g (the dense and VLM
    archs train on ranks: tests/test_torch_tp_train.py)."""
    path = str(tmp_path / "lm.npz")
    losses = train.main(["--arch", "tinyllama-1.1b", "--smoke", "--steps",
                         "2", "--batch", "2", "--seq", "32", "--device",
                         "cpu", "--ckpt", path])
    assert len(losses) == 2 and all(np.isfinite(losses))
    out = capsys.readouterr().out
    assert "step    0 loss" in out and "tok/s" in out and "saved" in out
    jcfg = j_smoke_variant(j_get_config("tinyllama-1.1b"))
    want = j_flatten({"params": jax.tree.map(
        lambda a: np.zeros(a.shape, a.dtype),
        j_build_model(jcfg).abstract())})
    with np.load(path) as f:
        assert sorted(f.files) == sorted(want)
    with pytest.raises(NotImplementedError, match="13g"):
        train.main(["--arch", "mixtral-8x22b", "--smoke", "--data-par",
                    "2", "--device", "cpu"])


# 11 steps: the resumed run logs steps 11–21 and prints (the example's
# check) at 20 and 21
BACKBONE = ["--steps", "11", "--batch", "2", "--seq", "32", "--lr", "3e-3"]


def _reference_backbone(monkeypatch, ckpt_dir, *extra):
    monkeypatch.setattr(sys, "argv", ["train_backbone.py", *BACKBONE,
                                      "--ckpt-dir", str(ckpt_dir), *extra])
    runpy.run_path(str(ROOT / "examples" / "train_backbone.py"),
                   run_name="__main__")


def _port_backbone(ckpt_dir, *extra):
    spec = importlib.util.spec_from_file_location(
        "torch_train_backbone", ROOT / "examples" / "torch_train_backbone.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.main([*BACKBONE, "--ckpt-dir", str(ckpt_dir), "--device",
                     "cpu", *extra])


def _metrics(ckpt_dir):
    return read_jsonl(os.path.join(ckpt_dir, "demo-20m_metrics.jsonl"))


def _same_metrics(got, want):
    assert [r["step"] for r in got] == [r["step"] for r in want]
    for k in ("loss", "lr", "grad_norm"):
        np.testing.assert_allclose([r[k] for r in got], [r[k] for r in want],
                                   rtol=TOL, atol=TOL, err_msg=k)


# the process's own threads: the backbone's 12.6M-parameter steps are
# matmuls, and their metrics are held to JAX's at 1e-5 with the summation
# order those threads give (on one thread a grad-norm spike of step 15
# reads 1.49e-5 off)
@pytest.mark.parametrize("writer", ["reference", "port"])
@pytest.mark.usefixtures("process_threads")
def test_backbone_resumes_across_packages(writer, tmp_path, monkeypatch):
    """One package's train_backbone writes 11 steps; the directory is
    copied and both packages continue it with --resume (steps 11–21, on
    the same stateless batches from the same restored params and AdamW
    state): their metrics JSONL (loss, lr, grad_norm a step) within 1e-5,
    and each run's own final check holds."""
    first, a, b = tmp_path / "first", tmp_path / "ref", tmp_path / "port"
    if writer == "reference":
        _reference_backbone(monkeypatch, first)
    else:
        assert _port_backbone(first)["start"] == 0
    shutil.copytree(first, a)
    shutil.copytree(first, b)
    _reference_backbone(monkeypatch, a, "--resume")
    res = _port_backbone(b, "--resume")
    assert res["start"] == 11 and res["final_loss"] < res["first_loss"]
    got, want = _metrics(b), _metrics(a)
    assert got[0]["step"] == 11 and len(got) == 11
    _same_metrics(got, want)
