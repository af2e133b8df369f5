"""The port's AdamW, LM data pipeline and metrics logger against the JAX
reference, on the CPU: the schedule, the global norm and its clip,
AdamW steps on mixed float32 / bfloat16 trees with and without clipping
(f32 params and the moments within 1e-6, bf16 params within one bf16
ulp), the quadratic-convergence twin, the LM batches byte for byte, and
the metrics logger's records; twins of ``tests/test_substrate.py`` and
``tests/test_metrics.py``."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro.configs import get_config as j_get_config
from repro.data import DataConfig as JDataConfig
from repro.data import lm_batch_at as j_lm_batch_at
from repro.data import lm_batches as j_lm_batches
from repro.metrics import MetricsLogger as JMetricsLogger
from repro.metrics import read_jsonl as j_read_jsonl
from repro.models.config import smoke_variant as j_smoke_variant
from repro_torch import convert, optim
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, lm_batch_at, lm_batches
from repro_torch.metrics import MetricsLogger, read_jsonl
from repro_torch.models.config import ModelConfig, smoke_variant
from repro_torch.models.layers import tree_leaves

T = convert.tensor_from_numpy


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _t(x):
    return x.detach().float().numpy()


def _bf16_ulps(got: np.ndarray, want: np.ndarray) -> float:
    """max |got − want| in bf16 ulps of the larger magnitude."""
    mag = np.maximum(np.abs(got), np.abs(want))
    ulp = np.exp2(np.floor(np.log2(np.maximum(mag, 1e-30))) - 7)
    return float((np.abs(got - want) / ulp).max())


# ---------------------------------------------------------------------------
# schedule, global norm, clipping
# ---------------------------------------------------------------------------

SCHED_CFGS = {
    "default": dict(),
    "short": dict(lr=1e-3, warmup_steps=10, total_steps=100,
                  min_lr_ratio=0.05),
    "no-warmup": dict(lr=2e-2, warmup_steps=0, total_steps=7),
}


@pytest.mark.parametrize("name", list(SCHED_CFGS))
def test_schedule_matches_reference(name):
    """Steps 0, 1, warmup − 1, warmup, the midpoint, total and past total:
    within 1e-7; linear warmup, then a cosine down to min_lr_ratio·lr."""
    kw = SCHED_CFGS[name]
    cfg, jcfg = optim.OptConfig(**kw), joptim.OptConfig(**kw)
    w, tot = cfg.warmup_steps, cfg.total_steps
    for step in (0, 1, max(w - 1, 0), w, (w + tot) // 2, tot, tot + 50):
        got = optim.schedule(cfg, torch.tensor(step, dtype=torch.int32))
        want = joptim.schedule(jcfg, jnp.asarray(step, jnp.int32))
        assert got.dtype == torch.float32 and got.shape == ()
        np.testing.assert_allclose(float(got), float(want), rtol=0,
                                   atol=1e-7, err_msg=f"step {step}")
    s = lambda t: float(optim.schedule(cfg, torch.tensor(t)))
    assert s(tot) == pytest.approx(cfg.min_lr_ratio * cfg.lr, rel=1e-5)
    if w > 1:
        assert s(w // 2) == pytest.approx(cfg.lr * (w // 2) / w, rel=1e-6)


def _mixed_tree(rng, scale=1.0):
    """A nested f32 / bf16 tree as numpy (bf16 via ml_dtypes)."""
    f = lambda *s: (scale * rng.normal(size=s)).astype(np.float32)
    b = lambda *s: np.asarray(jnp.asarray(f(*s), jnp.bfloat16))
    return {"a": f(5, 7), "emb": {"w": b(16, 8), "z": f(3)},
            "layers": {"k": b(2, 4, 6)}}


def test_global_norm_and_clip_match_reference():
    """global_norm over f32 and bf16 leaves within 1e-6; the clipped
    grads (the scale cast to each leaf's dtype first, as the reference):
    f32 leaves within 1e-6, bf16 within one bf16 ulp; the clipped norm is
    max_norm; a norm below max_norm leaves the grads as they are."""
    tree = _mixed_tree(np.random.default_rng(0), scale=3.0)
    jt = jax.tree.map(jnp.asarray, tree)
    tt = convert.lm_params_from_jax(tree)
    np.testing.assert_allclose(float(optim.global_norm(tt)),
                               float(joptim.global_norm(jt)), rtol=1e-6)
    for max_norm in (1.0, 1e4):
        got, gn = optim.clip_by_global_norm(tt, max_norm)
        want, jn = joptim.clip_by_global_norm(jt, max_norm)
        np.testing.assert_allclose(float(gn), float(jn), rtol=1e-6)
        for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
            assert str(g.dtype).removeprefix("torch.") == str(w.dtype)
            if g.dtype == torch.bfloat16:
                assert _bf16_ulps(_t(g), _np(w)) <= 1.0
            else:
                np.testing.assert_allclose(_t(g), _np(w), rtol=1e-6,
                                           atol=1e-6)
    clipped, _ = optim.clip_by_global_norm(tt, 1.0)
    assert float(optim.global_norm(clipped)) == pytest.approx(1.0, rel=1e-2)
    same, _ = optim.clip_by_global_norm(tt, 1e4)
    for a, b in zip(tree_leaves(same), tree_leaves(tt)):
        assert torch.equal(a, b)


def test_grad_clipping():
    """The reference's test_grad_clipping on the port."""
    g = {"a": torch.full((4,), 100.0)}
    clipped, norm = optim.clip_by_global_norm(g, 1.0)
    assert float(norm) == pytest.approx(200.0)
    assert float(optim.global_norm(clipped)) == pytest.approx(1.0, rel=1e-5)


# ---------------------------------------------------------------------------
# AdamW steps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("clip", [1.0, None], ids=["clip", "no-clip"])
def test_apply_updates_matches_reference(clip):
    """Five AdamW steps on the same mixed f32 / bf16 params and the same
    grads (norm ≈ 10, so clip_norm 1 clips): f32 params and every moment
    within 1e-6, bf16 params within one bf16 ulp; lr and grad_norm within
    1e-6; the params and moments are updated in place, the grads are
    not touched, and the moments stay f32."""
    rng = np.random.default_rng(1)
    params = _mixed_tree(rng)
    grads = [_mixed_tree(rng, scale=0.7) for _ in range(5)]
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=6, clip_norm=clip)
    cfg, jcfg = optim.OptConfig(**kw), joptim.OptConfig(**kw)
    jp = jax.tree.map(jnp.asarray, params)
    js = joptim.init(jp)
    tp = convert.lm_params_from_jax(params)
    ts = optim.init(tp)
    assert all(m.dtype == torch.float32 for m in tree_leaves(ts.mu))
    assert ts.step.dtype == torch.int32 and ts.step.shape == ()
    for g in grads:
        tg = convert.lm_params_from_jax(g)
        before = [x.clone() for x in tree_leaves(tg)]
        leaves = tree_leaves(tp)
        tp, ts, tm = optim.apply_updates(tp, tg, ts, cfg)
        jp, js, jm = joptim.apply_updates(
            jp, jax.tree.map(jnp.asarray, g), js, jcfg)
        assert all(a is b for a, b in zip(tree_leaves(tp), leaves))
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(tg), before))
        for k in ("lr", "grad_norm"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-6)
    assert int(ts.step) == int(js.step) == 5
    for got, want in zip(tree_leaves(tp), jax.tree.leaves(jp)):
        assert str(got.dtype).removeprefix("torch.") == str(want.dtype)
        if got.dtype == torch.bfloat16:
            assert _bf16_ulps(_t(got), _np(want)) <= 1.0
        else:
            np.testing.assert_allclose(_t(got), _np(want), rtol=1e-6,
                                       atol=1e-6)
    for tree, jtree in ((ts.mu, js.mu), (ts.nu, js.nu)):
        for got, want in zip(tree_leaves(tree), jax.tree.leaves(jtree)):
            assert got.dtype == torch.float32
            np.testing.assert_allclose(_t(got), _np(want), rtol=1e-6,
                                       atol=1e-6)


def test_adamw_converges_quadratic():
    """The reference's test_adamw_converges_quadratic on the port, its
    grads by autograd; the 150 steps end within 1e-5 of JAX's."""
    target = torch.tensor([1.0, -2.0, 3.0])
    params = {"w": torch.zeros(3)}
    state = optim.init(params)
    cfg = optim.OptConfig(lr=0.2, warmup_steps=5, total_steps=200,
                          weight_decay=0.0)
    loss_fn = lambda p: ((p["w"] - target) ** 2).sum()
    for _ in range(150):
        w = params["w"].detach().requires_grad_()
        (g,) = torch.autograd.grad(loss_fn({"w": w}), [w])
        params, state, _ = optim.apply_updates(params, {"w": g}, state, cfg)
    assert float(loss_fn(params)) < 1e-2

    jtarget = jnp.asarray([1.0, -2.0, 3.0])
    jcfg = joptim.OptConfig(lr=0.2, warmup_steps=5, total_steps=200,
                            weight_decay=0.0)

    @jax.jit
    def jstep(p, s):
        g = jax.grad(lambda p: jnp.sum((p["w"] - jtarget) ** 2))(p)
        return joptim.apply_updates(p, g, s, jcfg)[:2]
    jp = {"w": jnp.zeros(3)}
    js = joptim.init(jp)
    for _ in range(150):
        jp, js = jstep(jp, js)
    np.testing.assert_allclose(params["w"].numpy(), _np(jp["w"]), atol=1e-5)


def test_opt_state_from_jax_and_abstract_state():
    """convert.opt_state_from_jax carries the reference's state (f32
    moments, int32 step) over exactly; abstract_state is meta f32 with
    a 0-d int32 step."""
    params = _mixed_tree(np.random.default_rng(2))
    jp = jax.tree.map(jnp.asarray, params)
    js = joptim.init(jp)
    js = joptim.apply_updates(jp, jax.tree.map(lambda x: x * 0.5, jp), js,
                              joptim.OptConfig())[1]
    ts = convert.opt_state_from_jax(jax.tree.map(np.asarray, js))
    assert isinstance(ts, optim.OptState) and ts._fields == ("mu", "nu",
                                                             "step")
    assert ts.step.dtype == torch.int32 and int(ts.step) == 1
    for got, want in zip(tree_leaves(ts.nu), jax.tree.leaves(js.nu)):
        np.testing.assert_array_equal(_t(got), _np(want))
    ab = optim.abstract_state(convert.lm_params_from_jax(params))
    assert all(t.device.type == "meta" and t.dtype == torch.float32
               for t in tree_leaves(ab.mu) + tree_leaves(ab.nu))
    assert ab.step.device.type == "meta" and ab.step.dtype == torch.int32
    assert [tuple(t.shape) for t in tree_leaves(ab.mu)] == \
        [a.shape for a in jax.tree.leaves(params)]


# ---------------------------------------------------------------------------
# LM batches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "llava-next-34b"])
def test_lm_batches_match_reference(arch):
    """lm_batch_at at several steps and lm_batches resumed from
    start_step: the same keys, dtypes and bytes as the reference's, for a
    dense config and llava's smoke variant (stub prefix embeddings)."""
    mcfg, jmcfg = (smoke_variant(get_config(arch)),
                   j_smoke_variant(j_get_config(arch)))
    kw = dict(batch_size=3, seq_len=40, seed=5)
    cfg, jcfg = DataConfig(**kw), JDataConfig(**kw)
    for step in (0, 3, 17):
        got, want = lm_batch_at(cfg, mcfg, step), j_lm_batch_at(jcfg, jmcfg,
                                                                step)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            assert got[k].tobytes() == want[k].tobytes(), (step, k)
    it, jit_ = lm_batches(cfg, mcfg, start_step=4), j_lm_batches(
        jcfg, jmcfg, start_step=4)
    for _ in range(3):
        got, want = next(it), next(jit_)
        assert all(got[k].tobytes() == want[k].tobytes() for k in want)
    b = lm_batch_at(cfg, mcfg, 5)
    assert b["tokens"].max() < mcfg.vocab_size
    np.testing.assert_array_equal(b["labels"][:, :-1], b["tokens"][:, 1:])
    if mcfg.frontend == "vision":
        assert b["prefix_embeds"].shape == (3, mcfg.num_prefix_tokens,
                                            mcfg.d_model)
        assert b["tokens"].shape == (3, 40 - mcfg.num_prefix_tokens)


def test_lm_batch_frames_wait_for_their_family():
    """The encoder-decoder's batch branches on is_encoder_decoder, as the
    reference's: whisper's smoke variant (no ``frontend`` set) gets stub
    ``frames`` (B, encoder_seq, D) from the batch's rng, then its tokens
    and labels, byte for byte the reference's; a config that sets
    ``frontend="audio"`` without being an encoder-decoder gets none."""
    mcfg = smoke_variant(get_config("whisper-base"))
    jmcfg = j_smoke_variant(j_get_config("whisper-base"))
    assert mcfg.frontend is None and mcfg.is_encoder_decoder
    kw = dict(batch_size=3, seq_len=40, seed=5)
    for step in (0, 3):
        got = lm_batch_at(DataConfig(**kw), mcfg, step)
        want = j_lm_batch_at(JDataConfig(**kw), jmcfg, step)
        assert sorted(got) == sorted(want) == ["frames", "labels", "tokens"]
        for k in want:
            assert got[k].dtype == want[k].dtype
            assert got[k].tobytes() == want[k].tobytes(), (step, k)
    assert got["frames"].shape == (3, mcfg.encoder_seq, mcfg.d_model)
    audio = ModelConfig(name="a", family="audio", num_layers=1, d_model=8,
                        num_heads=1, num_kv_heads=1, d_ff=8, vocab_size=16,
                        frontend="audio")
    assert sorted(lm_batch_at(DataConfig(), audio, 0)) == ["labels", "tokens"]


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

def _records(path):
    return [{k: v for k, v in r.items() if k != "t"} for r in path]


def test_metrics_roundtrip_and_summary(tmp_path):
    """The reference's test_metrics_roundtrip_and_summary on the port,
    and the same records (but the clock's ``t``) and summary as the
    reference's logger given the same logs."""
    logs = []
    for cls, sub in ((MetricsLogger, "port"), (JMetricsLogger, "ref")):
        d = str(tmp_path / sub)
        log = cls(d, "unit", flush_every=2)
        for s in range(10):
            log.log(s, loss=10.0 - s, lr=1e-3)
        log.flush()
        logs.append((log, os.path.join(d, "unit.jsonl")))
    (log, path), (jlog, jpath) = logs
    recs = read_jsonl(path)
    assert len(recs) == 10
    assert recs[0]["loss"] == 10.0 and recs[-1]["loss"] == 1.0
    summ = log.summary("loss")
    assert summ["min"] == 1.0 and summ["max"] == 10.0 and summ["n"] == 10
    assert _records(recs) == _records(j_read_jsonl(jpath))
    assert summ == jlog.summary("loss")


def test_metrics_no_dir_is_memory_only():
    log, jlog = MetricsLogger(None), JMetricsLogger(None)
    for lg in (log, jlog):
        lg.log(0, loss=3.0)
    assert log.summary("loss")["last"] == 3.0
    assert log.summary("loss") == jlog.summary("loss")
