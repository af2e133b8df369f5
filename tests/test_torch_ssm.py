"""The port's SSM and hybrid families against the JAX reference, on the
CPU: the Mamba-2 block (``repro_torch.models.mamba2``) and the RWKV-6
time and channel mixes (``repro_torch.models.rwkv6``) layer by layer,
on one chunk, on several and on one ragged chunk, and their decode
steps; the port's twins of the chunked-matches-stepwise tests of
``tests/test_model_properties.py``; the rwkv6 single-chunk overflow the
port keeps from the reference; and rwkv6-7b's and zamba2-1.2b's smoke
models (``RWKV6Model``, ``HybridModel``, the hybrid at two segments as
well): forward, gradients across several checkpointed chunks, decode
steps and their states, and teacher-forced decode against the
forward over several chunks. Weights are numpy draws handed to both
packages; all in float32, held at 1e-5 of each output's largest
magnitude unless a case says otherwise."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import mamba2 as jmamba
from repro.models import rwkv6 as jrwkv
from repro.models.config import ModelConfig as JModelConfig
from repro.models.layers import PSpec as JPSpec
from repro.models.transformer import build_model as j_build_model
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.models import mamba2 as tmamba
from repro_torch.models import rwkv6 as trwkv
from repro_torch.models.config import ModelConfig, smoke_variant
from repro_torch.models.layers import tree_leaves, tree_map
from repro_torch.models.transformer import build_model
from torch_threads import one_thread  # noqa: F401

T = convert.tensor_from_numpy
TOL = 1e-5
B = 2

MAMBA = dict(name="m", family="hybrid", num_layers=1, d_model=64,
             num_heads=4, num_kv_heads=4, d_ff=64, vocab_size=64,
             ssm_state=16, attn_every=1)
RWKV = dict(name="r", family="ssm", attn_free=True, num_layers=1,
            d_model=128, num_heads=2, num_kv_heads=2, d_ff=256,
            vocab_size=64, norm_style="layernorm")


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, tol=TOL, what=""):
    """max |Δ| ≤ tol · max |want|."""
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = _np(want)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: max|Δ| {err:.2e} of {scale:.3g}"


def _np_init(template, seed, nonzero=()):
    """Numpy draws for a reference template: fan-in scaled normals
    (embedding rows 1/√d), zeros and ones as declared, except the leaves
    named in ``nonzero`` (zeros or ones at init), drawn N(0, 0.5²)."""
    rng = np.random.default_rng(seed)

    def draw(path, p):
        name = jax.tree_util.keystr(path)
        if any(f"'{n}'" in name for n in nonzero):
            return (0.5 * rng.normal(size=p.shape)).astype(np.float32)
        if p.init in ("zeros", "ones"):
            return np.full(p.shape, p.init == "ones", np.float32)
        fan = p.shape[-1] if p.init == "embed" else (
            p.fan_in or (p.shape[-2] if len(p.shape) >= 2 else p.shape[-1]))
        return (rng.normal(size=p.shape) / np.sqrt(fan)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(
        draw, template, is_leaf=lambda x: isinstance(x, JPSpec))


def _params(template, seed, nonzero=()):
    """→ (JAX tree, port tree) of the same :func:`_np_init` draws."""
    tree = _np_init(template, seed, nonzero)
    return jax.tree.map(jnp.asarray, tree), convert.lm_params_from_jax(tree)


def _x(shape, seed, scale=0.5):
    return (scale * np.random.default_rng(seed).normal(size=shape)
            ).astype(np.float32)


# ---------------------------------------------------------------------------
# Mamba-2
# ---------------------------------------------------------------------------

MAMBA_RANDOM = ("a_log", "dt_bias", "d_skip", "norm_scale")


@pytest.fixture(scope="module")
def mamba():
    jcfg, tcfg = JModelConfig(**MAMBA), ModelConfig(**MAMBA)
    pj, pt = _params(jmamba.mamba2_template(jcfg), 0, MAMBA_RANDOM)
    return jcfg, tcfg, pj, pt


@pytest.mark.parametrize("T_", [8, 256, 100])
def test_apply_mamba2_matches_reference(mamba, T_):
    """One chunk (T 8), two chunks of 128 (T 256), one ragged chunk of
    100: outputs within 1e-5."""
    jcfg, tcfg, pj, pt = mamba
    x = _x((B, T_, 64), T_)
    want = jax.jit(lambda p, x: jmamba.apply_mamba2(p, x, jcfg))(
        pj, jnp.asarray(x))
    _close(tmamba.apply_mamba2(pt, T(x), tcfg), want, what=f"T {T_}")


def test_mamba2_split_and_dims():
    """The projection splits at the reference's indices: z, xBC, dt of
    widths d_inner, d_inner + 2N, nh; x, B, C of d_inner, N, N."""
    cfg = ModelConfig(**MAMBA)
    d_inner, nh, N = tmamba.ssm_dims(cfg)
    assert (d_inner, nh, N) == jmamba.ssm_dims(JModelConfig(**MAMBA))
    u = torch.randn(1, 3, 64)
    p = {"w_in": torch.randn(64, 2 * d_inner + 2 * N + nh)}
    z, xBC, dt = tmamba._split_proj(p, u, cfg)
    assert (z.shape[-1], xBC.shape[-1], dt.shape[-1]) == \
        (d_inner, d_inner + 2 * N, nh)
    x, Bc, Cc = tmamba._split_xbc(xBC, cfg)
    assert (x.shape[-1], Bc.shape[-1], Cc.shape[-1]) == (d_inner, N, N)


def test_mamba2_decode_steps_match_reference(mamba):
    """6 decode steps from the zero state: outputs and both state
    leaves within 1e-5 of the reference's at every step; the given
    state is left as it was."""
    jcfg, tcfg, pj, pt = mamba
    x = _x((B, 6, 64), 3)
    js = jmamba.init_mamba2_state(jcfg, B, jnp.float32)
    ts = tmamba.init_mamba2_state(tcfg, B, torch.float32)
    step = jax.jit(lambda p, x, s: jmamba.mamba2_decode_step(p, x, s, jcfg))
    for t in range(6):
        yj, js = step(pj, jnp.asarray(x[:, t:t + 1]), js)
        before = [a.clone() for a in ts]
        yt, new = tmamba.mamba2_decode_step(pt, T(x[:, t:t + 1]), ts, tcfg)
        assert all(torch.equal(a, b) for a, b in zip(before, ts))
        ts = new
        _close(yt, yj, what=f"y step {t}")
        _close(ts.h, js.h, what=f"h step {t}")
        _close(ts.conv_buf, js.conv_buf, what=f"conv_buf step {t}")


def test_mamba2_chunked_matches_stepwise():
    """Twin of tests/test_model_properties.py:140 on the port: the
    chunked SSD equals the step-by-step recurrence fed the same
    projections (the reference's rtol, atol 2e-3)."""
    cfg = ModelConfig(**MAMBA)
    _, p = _params(jmamba.mamba2_template(JModelConfig(**MAMBA)), 0)
    x = torch.from_numpy(_x((2, 8, 64), 1))
    y_chunked = tmamba.apply_mamba2(p, x, cfg)
    st = tmamba.init_mamba2_state(cfg, 2, torch.float32)
    outs = []
    for t in range(8):
        y_t, st = tmamba.mamba2_decode_step(p, x[:, t:t + 1, :], st, cfg)
        outs.append(y_t)
    np.testing.assert_allclose(y_chunked.numpy(), torch.cat(outs, 1).numpy(),
                               rtol=2e-3, atol=2e-3)


# ---------------------------------------------------------------------------
# RWKV-6
# ---------------------------------------------------------------------------

RWKV_RANDOM = ("mu", "dec_base", "u_bonus", "ln_scale")


@pytest.fixture(scope="module")
def rwkv():
    jcfg, tcfg = JModelConfig(**RWKV), ModelConfig(**RWKV)
    pj, pt = _params(jrwkv.rwkv6_template(jcfg), 1, RWKV_RANDOM)
    return jcfg, tcfg, pj, pt


@pytest.mark.parametrize("T_", [8, 96, 40])
def test_rwkv_time_and_channel_match_reference(rwkv, T_):
    """The time mix over one chunk (T 8), three chunks of 32 (T 96) and
    one ragged chunk of 40, from a nonzero previous token, and the
    channel mix: within 1e-5; the wkv state after the chunks too."""
    jcfg, tcfg, pj, pt = rwkv
    x, prev = _x((B, T_, 128), T_), _x((B, 1, 128), 7)

    @jax.jit
    def reference(p, x, prev):
        r, k, v, logw, _ = jrwkv._project(p["time"], x, prev)
        _, S = jrwkv._wkv_chunked(r, k, v, logw,
                                  p["time"]["u_bonus"], jrwkv.rwkv_heads(jcfg))
        return (jrwkv.apply_rwkv_time(p["time"], x, jcfg, prev),
                jrwkv.apply_rwkv_channel(p["channel"], x, prev), S)

    yt_j, yc_j, S_j = reference(pj, jnp.asarray(x), jnp.asarray(prev))
    _close(trwkv.apply_rwkv_time(pt["time"], T(x), tcfg, T(prev)), yt_j,
           what="time")
    _close(trwkv.apply_rwkv_channel(pt["channel"], T(x), T(prev)), yc_j,
           what="channel")
    r, k, v, logw, _ = trwkv._project(pt["time"], T(x), T(prev))
    _, S_t = trwkv._wkv_chunked(r, k, v, logw, pt["time"]["u_bonus"],
                                trwkv.rwkv_heads(tcfg))
    _close(S_t, S_j, what="final state")


def test_rwkv_decay_clamp_and_group_norm():
    """The log-decay is clamped to [LOG_W_MIN, −1e-4] as the reference's;
    the group norm uses the population variance (torch.var's default
    would not)."""
    jcfg, tcfg = JModelConfig(**RWKV), ModelConfig(**RWKV)
    tp = {"dec_base": T(np.array([-30.0, 0.0, 5.0] + [0.0] * 125,
                                 np.float32)),
          "w_dec1": torch.zeros(128, 64), "w_dec2": torch.zeros(64, 128)}
    lw = trwkv._decay(tp, torch.zeros(1, 1, 128))
    assert float(lw[0, 0, 0]) == pytest.approx(-1e-4)
    assert float(lw[0, 0, 2]) == pytest.approx(trwkv.LOG_W_MIN)
    want = jrwkv._decay({k: jnp.asarray(v.numpy()) for k, v in tp.items()},
                        jnp.zeros((1, 1, 128)))
    _close(lw, want)
    y, scale = _x((2, 3, 128), 4), _x((128,), 5) + 1
    _close(trwkv._group_norm(T(y), T(scale), 2),
           jrwkv._group_norm(jnp.asarray(y), jnp.asarray(scale), 2))


def test_rwkv_decode_steps_match_reference(rwkv):
    """6 time-mix decode steps from a zero state, the previous token fed
    along as the reference's test does: outputs and the state within
    1e-5; the given state is left as it was."""
    jcfg, tcfg, pj, pt = rwkv
    x = _x((B, 6, 128), 8)
    H = trwkv.rwkv_heads(tcfg)
    Sj = jnp.zeros((B, H, 64, 64))
    St = torch.zeros((B, H, 64, 64))
    prev = np.zeros((B, 1, 128), np.float32)
    step = jax.jit(lambda p, x, S, prev: jrwkv.rwkv_time_decode_step(
        p, x, S, prev, jcfg))
    for t in range(6):
        xt = x[:, t:t + 1]
        yj, Sj = step(pj["time"], jnp.asarray(xt), Sj, jnp.asarray(prev))
        before = St.clone()
        yt, new = trwkv.rwkv_time_decode_step(pt["time"], T(xt), St, T(prev),
                                              tcfg)
        assert torch.equal(before, St)
        St, prev = new, xt
        _close(yt, yj, what=f"y step {t}")
        _close(St, Sj, what=f"S step {t}")


def test_rwkv_chunked_matches_stepwise():
    """Twin of tests/test_model_properties.py:162 on the port (the
    reference's rtol, atol 2e-3)."""
    cfg = ModelConfig(**RWKV)
    _, p = _params(jrwkv.rwkv6_template(JModelConfig(**RWKV)), 0)
    p = p["time"]
    x = torch.from_numpy(_x((2, 8, 128), 1))
    y_chunked = trwkv.apply_rwkv_time(p, x, cfg, torch.zeros(2, 1, 128))
    S = torch.zeros(2, trwkv.rwkv_heads(cfg), 64, 64)
    x_prev = torch.zeros(2, 1, 128)
    outs = []
    for t in range(8):
        y_t, S = trwkv.rwkv_time_decode_step(p, x[:, t:t + 1, :], S, x_prev,
                                             cfg)
        x_prev = x[:, t:t + 1, :]
        outs.append(y_t)
    np.testing.assert_allclose(y_chunked.numpy(), torch.cat(outs, 1).numpy(),
                               rtol=2e-3, atol=2e-3)


def test_rwkv_single_long_chunk_overflows_as_the_reference():
    """A reference quirk the port keeps: T 96 is three chunks of 32, and
    both packages agree within 1e-5; T 100 is one chunk of 100, whose
    exp(−cum) overflows float32, and both packages' outputs are NaN.
    The config is the reference test's (test_model_properties.py:162),
    its weights fan-in scaled draws (the decay base 0: w ≈ e^-1 a
    token)."""
    jcfg, tcfg = JModelConfig(**RWKV), ModelConfig(**RWKV)
    pj, pt = _params(jrwkv.rwkv6_template(jcfg), 0)
    pj, pt = pj["time"], pt["time"]
    fn = jax.jit(lambda p, x: jrwkv.apply_rwkv_time(
        p, x, jcfg, jnp.zeros((2, 1, 128))))
    for T_, nan in ((96, False), (100, True)):
        x = _x((2, T_, 128), 1)
        want = np.asarray(fn(pj, jnp.asarray(x)))
        got = trwkv.apply_rwkv_time(pt, T(x), tcfg,
                                    torch.zeros(2, 1, 128)).numpy()
        assert bool(np.isnan(want).any()) == nan
        assert bool(np.isnan(got).any()) == nan
        if nan:
            np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        else:
            _close(got, want, what=f"T {T_}")


# ---------------------------------------------------------------------------
# The models: rwkv6-7b and zamba2-1.2b smoke variants
# ---------------------------------------------------------------------------

def _model_params(jcfg, seed=0):
    """The reference model and the same numpy parameters in both
    packages, the zero / one leaves of the SSM blocks drawn too."""
    jm = j_build_model(jcfg)
    return (jm, *_params(jm.template(), seed, RWKV_RANDOM + MAMBA_RANDOM))


MODEL_CASES = {
    "rwkv6": lambda: smoke_variant(get_config("rwkv6-7b")),
    "zamba2": lambda: smoke_variant(get_config("zamba2-1.2b")),
    # two segments of two mamba layers, the shared block after each
    "zamba2-2seg": lambda: dataclasses.replace(
        smoke_variant(get_config("zamba2-1.2b")), num_layers=4),
}


def _cfg_pair(case):
    tcfg = MODEL_CASES[case]()
    jcfg = JModelConfig(**{f.name: getattr(tcfg, f.name)
                           for f in dataclasses.fields(JModelConfig)})
    return jcfg, tcfg


@pytest.fixture(scope="module", params=list(MODEL_CASES))
def model_case(request):
    jcfg, tcfg = _cfg_pair(request.param)
    jm, pj, pt = _model_params(jcfg)
    return request.param, jcfg, tcfg, jm, pj, build_model(tcfg), pt


def test_model_forward_and_decode_match_reference(model_case):
    """forward and 5 decode steps from the zero state, on the same
    parameters (the SSM blocks' zero and one leaves drawn too; the loss
    is tests/test_torch_models.py's): logits within 1e-5, every state
    leaf after the steps too, and a sixth step from the reference's
    state carried across (``convert.decode_state_from_jax``). The
    hybrid's shared block has one KV cache an application."""
    name, jcfg, tcfg, jm, pj, tm, pt = model_case
    rng = np.random.default_rng(2)
    nb = {"tokens": rng.integers(0, tcfg.vocab_size, (B, 24)
                                 ).astype(np.int32)}
    lg_j, _ = jax.jit(jm.forward)(pj, jnp.asarray(nb["tokens"]))
    lg_t, aux = tm.forward(pt, T(nb["tokens"]))
    assert float(aux) == 0 and aux.dtype == torch.float32
    _close(lg_t, lg_j, what="logits")

    js = jm.init_decode_state(B, 16)
    ts = tm.init_decode_state(B, 16)
    step = jax.jit(jm.decode_step)
    for t in range(5):
        tok = nb["tokens"][:, t:t + 1]
        lj, js = step(pj, js, jnp.asarray(tok))
        lt, ts = tm.decode_step(pt, ts, T(tok))
        _close(lt, lj, what=f"decode logits step {t}")
    assert int(ts.pos) == int(js.pos) == 5
    for got, want in zip(jax.tree.leaves(convert.to_numpy(ts)),
                         jax.tree.leaves(js)):
        _close(got, want, what=f"{name} state leaf")
    if name.startswith("zamba2"):
        n_seg = tcfg.num_layers // tcfg.attn_every
        assert ts.shared_cache.k.shape[0] == n_seg
        assert ts.ssm.h.shape[:2] == (n_seg, tcfg.attn_every)
    # convert.decode_state_from_jax: the reference's state, carried into
    # the port, decodes on to the same logits
    carried = convert.decode_state_from_jax(jax.tree.map(np.asarray, js),
                                            tm.init_decode_state(B, 16))
    assert type(carried) is type(ts)
    tok = nb["tokens"][:, 5:6]
    _close(tm.decode_step(pt, carried, T(tok))[0],
           step(pj, js, jnp.asarray(tok))[0], what="carried state")


@pytest.mark.parametrize("case,steps", [("rwkv6", 96), ("zamba2", 256)])
def test_teacher_forced_decode_matches_forward_over_chunks(case, steps):
    """decode_step fed the tokens one at a time reproduces forward over
    a sequence of several chunks (rwkv6: 3 of 32; zamba2: 2 of 128),
    within 1e-4 of the logits' largest magnitude (the chunked sums and
    the recurrence accumulate in other orders); no kernel launched on
    the CPU. Batch 1 keeps the 256 steps short."""
    jcfg, tcfg = _cfg_pair(case)
    _, _, pt = _model_params(jcfg)
    tm = build_model(tcfg)
    toks = T(np.random.default_rng(3).integers(
        0, tcfg.vocab_size, (1, steps)).astype(np.int32))
    ops.reset_launches()
    with torch.no_grad():
        want, _ = tm.forward(pt, toks)
        state = tm.init_decode_state(1, steps)
        outs = []
        for t in range(steps):
            lg, state = tm.decode_step(pt, state, toks[:, t:t + 1])
            outs.append(lg[:, 0])
    assert not any(ops.LAUNCHES.values())
    _close(torch.stack(outs, 1), want.numpy(), tol=1e-4)


@pytest.mark.parametrize("case,S", [("rwkv6", 64), ("zamba2", 256)])
def test_gradients_over_checkpointed_chunks_match_reference(case, S):
    """The loss's gradients through two checkpointed chunks (rwkv6 at S
    64, zamba2 at S 256), with remat on (each layer checkpointed as
    well), against jax.value_and_grad: every leaf within 1e-5 of its
    largest entry, but mamba's a_log and dt_bias within 1e-4: each of
    their (nh,) entries sums a head's terms of every position through
    the chunks' exp(cum) products, whose float32 sums the two packages
    order differently (3.3e-5 read on this case)."""
    jcfg, tcfg = _cfg_pair(case)
    tcfg = dataclasses.replace(tcfg, remat=True)
    jm, pj, pt = _model_params(jcfg)
    rng = np.random.default_rng(4)
    nb = {k: rng.integers(0, tcfg.vocab_size, (1, S)).astype(np.int32)
          for k in ("tokens", "labels")}
    (l_j, _), g_j = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(
        pj, {k: jnp.asarray(v) for k, v in nb.items()})
    wrt = tree_map(lambda p: p.detach().requires_grad_(), pt)
    loss, _ = build_model(tcfg).loss(wrt, {k: T(v) for k, v in nb.items()})
    grads = torch.autograd.grad(loss, tree_leaves(wrt))
    _close(loss, l_j, what="loss")
    for (path, gj), g in zip(jax.tree_util.tree_flatten_with_path(g_j)[0],
                             grads):
        name = jax.tree_util.keystr(path)
        per_head = "'a_log'" in name or "'dt_bias'" in name
        _close(g, gj, tol=1e-4 if per_head else TOL, what=name)


def test_build_model_dispatches_as_the_reference():
    """rwkv6-7b → RWKV6Model, zamba2-1.2b → HybridModel; a hybrid whose
    attn_every does not divide its layers raises the reference's
    ValueError."""
    from repro_torch.models.hybrid import HybridModel
    from repro_torch.models.rwkv6_model import RWKV6Model
    assert type(build_model(get_config("rwkv6-7b"))) is RWKV6Model
    assert type(build_model(get_config("zamba2-1.2b"))) is HybridModel
    with pytest.raises(ValueError, match="attn_every"):
        build_model(dataclasses.replace(get_config("zamba2-1.2b"),
                                        attn_every=5))
    with pytest.raises(ValueError, match="attn_every"):
        j_build_model(dataclasses.replace(j_get_config("zamba2-1.2b"),
                                          attn_every=5))
