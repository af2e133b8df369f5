"""The port's forward pass against the JAX reference, on the CPU:
full-sequence ``attention``, the LM losses, ``hidden_states``,
``forward`` and ``loss`` of every decoder-only LM config's smoke variant
(the dense, MoE, VLM, rwkv6 and hybrid families; whisper's in
``tests/test_torch_encdec.py``), on
the same numpy inputs and the same parameters (JAX-initialised, carried
across with ``convert.lm_params_from_jax``); the port's twins of
``tests/test_models_smoke.py`` and of the RoPE, rmsnorm and
sliding-window cases of ``tests/test_model_properties.py``; and the
configs field for field. All in float32: 1e-5 is the tolerance where
one function is compared, as two libraries' f32 sums differ in the last
bits."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.configs import _ALIASES as j_aliases
from repro.configs import get_config as j_get_config
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models.config import ModelConfig as JModelConfig
from repro.models.config import smoke_variant as j_smoke_variant
from repro.models.transformer import build_model as j_build_model
from repro_torch import convert
from repro_torch.configs import PORTED_ARCHS, get_config
from repro_torch.kernels import ops
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models.config import ModelConfig, smoke_variant
from repro_torch.models.transformer import build_model

T = convert.tensor_from_numpy
NEW_ARCHS = ("llama3-8b", "qwen2-1.5b", "chatglm3-6b", "llava-next-34b",
             "rwkv6-7b", "zamba2-1.2b")
MOE_ARCHS = ("mixtral-8x22b", "qwen3-moe-235b-a22b")
# the encoder-decoder: its forward needs frames (tests/test_torch_encdec.py)
ENCDEC_ARCHS = ("whisper-base",)
LM_ARCHS = ("tinyllama-1.1b",) + NEW_ARCHS + MOE_ARCHS + ENCDEC_ARCHS
TOL = dict(rtol=1e-5, atol=1e-5)
B, S = 2, 32


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _both(tree):
    """numpy tree → (JAX tree, torch tree)."""
    return (jax.tree.map(jnp.asarray, tree),
            convert.lm_params_from_jax(tree))


# ---------------------------------------------------------------------------
# attention: the full-sequence, query-chunked masked softmax
# ---------------------------------------------------------------------------

ATTN = dict(name="t", family="dense", num_layers=1, d_model=64, num_heads=8,
            num_kv_heads=2, d_ff=128, vocab_size=64, qkv_bias=True)
ATTN_CASES = {
    "causal": (40, dict(), dict()),
    "non-causal": (40, dict(), dict(causal=False)),
    "window": (40, dict(sliding_window=8), dict()),
    "partial-rope-theta": (40, dict(rope_fraction=0.5, rope_theta=5e5),
                           dict()),
    "kv-repeat": (40, dict(), dict(kv_repeat=2)),
    "chunked-1024": (1024, dict(), dict()),
    "chunked-window": (1024, dict(sliding_window=300), dict()),
    "unchunked-600": (600, dict(), dict()),
    "cross": (24, dict(), dict(causal=False, cross=40)),
}


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_attention_matches_reference(case):
    """Causal and not, the sliding window, partial RoPE at llama3's θ,
    duplicated KV heads, the 512-query blocks at S = 1024 (and one block
    at S = 600, not a multiple of 512), cross-attention through kv_x:
    within 1e-5."""
    Sq, cfg_kw, call_kw = ATTN_CASES[case]
    jcfg, tcfg = JModelConfig(**ATTN, **cfg_kw), ModelConfig(**ATTN, **cfg_kw)
    rng = np.random.default_rng(len(case) + Sq)
    p = {n: (rng.normal(size=s.shape) / np.sqrt(s.fan_in or 10)
             ).astype(np.float32)
         for n, s in jattn.attn_template(jcfg).items()}
    x = rng.normal(size=(B, Sq, 64)).astype(np.float32)
    pos = np.broadcast_to(np.arange(Sq, dtype=np.int32), (B, Sq))
    kw = {k: v for k, v in call_kw.items() if k != "cross"}
    jkw, tkw = dict(kw), dict(kw)
    if "cross" in call_kw:
        Sk = call_kw["cross"]
        kv_x = rng.normal(size=(B, Sk, 64)).astype(np.float32)
        kv_pos = np.broadcast_to(np.arange(Sk, dtype=np.int32), (B, Sk))
        jkw.update(kv_x=jnp.asarray(kv_x), kv_positions=jnp.asarray(kv_pos))
        tkw.update(kv_x=T(kv_x), kv_positions=T(kv_pos))
    pj, pt = _both(p)
    want = jattn.attention(pj, jnp.asarray(x), jcfg,
                           positions=jnp.asarray(pos), **jkw)
    got = tattn.attention(pt, T(x), tcfg, positions=T(pos), **tkw)
    assert got.shape == (B, Sq, 64) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


def test_attention_rounds_as_the_reference_in_bfloat16():
    """bf16 activations: scores and their scale rounded to bf16, the
    softmax in f32, probabilities rounded before PV — within 2⁻⁷ of the
    largest output, two roundings of the same f32 values."""
    jcfg, tcfg = JModelConfig(**ATTN), ModelConfig(**ATTN)
    rng = np.random.default_rng(3)
    p = {n: (rng.normal(size=s.shape) / np.sqrt(s.fan_in or 10)
             ).astype(np.float32)
         for n, s in jattn.attn_template(jcfg).items()}
    x = rng.normal(size=(B, 48, 64)).astype(np.float32)
    pos = np.broadcast_to(np.arange(48, dtype=np.int32), (B, 48))
    pj = {n: jnp.asarray(a, jnp.bfloat16) for n, a in p.items()}
    pt = {n: T(np.asarray(a)) for n, a in pj.items()}
    xj = jnp.asarray(x, jnp.bfloat16)
    want = _np(jattn.attention(pj, xj, jcfg, positions=jnp.asarray(pos)))
    got = tattn.attention(pt, T(np.asarray(xj)), tcfg, positions=T(pos))
    assert got.dtype == torch.bfloat16
    err = np.abs(convert.to_numpy(got) - want).max() / np.abs(want).max()
    assert err <= 2 ** -7, err


# ---------------------------------------------------------------------------
# LM losses
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_loss_matches_reference(masked):
    rng = np.random.default_rng(4)
    logits = (3 * rng.normal(size=(2, 5, 37))).astype(np.float32)
    labels = rng.integers(0, 37, size=(2, 5)).astype(np.int32)
    mask = (rng.random((2, 5)) > 0.4).astype(np.float32) if masked else None
    want = jlayers.cross_entropy_loss(
        jnp.asarray(logits), jnp.asarray(labels),
        None if mask is None else jnp.asarray(mask))
    got = tlayers.cross_entropy_loss(T(logits), T(labels),
                                     None if mask is None else T(mask))
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)
    # an all-zero mask: the mean is over max(Σ mask, 1)
    zero = tlayers.cross_entropy_loss(T(logits), T(labels),
                                      torch.zeros((2, 5)))
    assert float(zero) == 0.0


@pytest.mark.parametrize("tie", [False, True])
@pytest.mark.parametrize("chunk,masked", [(64, False), (64, True), (5, False),
                                          (5, True), (4, True)])
def test_chunked_lm_loss_matches_reference(tie, chunk, masked):
    """T = 12 tokens: one call (chunk 64), chunks of 5 with a padded
    last chunk of 3 (mask 0), chunks of 4 with no padding."""
    rng = np.random.default_rng(5 + chunk)
    V, D = 37, 16
    emb = {"embedding": (rng.normal(size=(V, D)) / 4).astype(np.float32)}
    if not tie:
        emb["lm_head"] = (rng.normal(size=(D, V)) / 4).astype(np.float32)
    h = rng.normal(size=(2, 6, D)).astype(np.float32)
    labels = rng.integers(0, V, size=(2, 6)).astype(np.int32)
    mask = (rng.random((2, 6)) > 0.3).astype(np.float32) if masked else None
    ej, et = _both(emb)
    want = jlayers.chunked_lm_loss(ej, jnp.asarray(h), jnp.asarray(labels),
                                   tie, None if mask is None
                                   else jnp.asarray(mask), chunk=chunk)
    got = tlayers.chunked_lm_loss(et, T(h), T(labels), tie,
                                  None if mask is None else T(mask),
                                  chunk=chunk)
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)
    # the chunking does not change the loss
    whole = tlayers.chunked_lm_loss(et, T(h), T(labels), tie,
                                    None if mask is None else T(mask))
    np.testing.assert_allclose(got.numpy(), whole.numpy(), **TOL)


# ---------------------------------------------------------------------------
# The slice: hidden_states, forward and loss on every config's smoke variant
# ---------------------------------------------------------------------------

def _models(arch, seed=0):
    """The reference's and the port's model on the same JAX-initialised
    parameters of ``arch``'s smoke variant."""
    jcfg = j_smoke_variant(j_get_config(arch))
    tcfg = smoke_variant(get_config(arch))
    jm = j_build_model(jcfg)
    pj = jm.init(jax.random.PRNGKey(seed))
    # biases are zeros at init: make them matter (qwen2, chatglm3)
    rng = np.random.default_rng(seed)
    np_params = jax.tree.map(np.asarray, pj)
    for n in ("bq", "bk", "bv"):
        if n in np_params.get("layers", {}).get("attn", {}):
            a = np_params["layers"]["attn"][n]
            np_params["layers"]["attn"][n] = (
                0.1 * rng.normal(size=a.shape)).astype(np.float32)
    pj, pt = _both(np_params)
    return jcfg, tcfg, jm, pj, build_model(tcfg), pt


def _lm_batch(cfg, rng, S_text, prefix):
    tokens = rng.integers(0, cfg.vocab_size, size=(B, S_text)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, size=(B, S_text)).astype(np.int32)
    batch = dict(tokens=tokens, labels=labels,
                 loss_mask=(rng.random((B, S_text)) > 0.2).astype(np.float32))
    if prefix:
        batch["prefix_embeds"] = rng.normal(
            size=(B, cfg.num_prefix_tokens, cfg.d_model)).astype(np.float32)
    return batch


@pytest.mark.parametrize("arch", NEW_ARCHS + MOE_ARCHS)
def test_forward_and_loss_match_reference(arch):
    """llava with prefix embeddings (its loss on the text positions
    only), qwen2's QKV bias and tied embeddings, chatglm3's partial RoPE,
    llama3's rope θ, mixtral's sliding window and the two MoE configs'
    routed experts: hidden states, logits and loss within 1e-5; with and
    without a loss mask. aux is 0 without experts, else the layers'
    load-balance losses (> 0), within 1e-5 of the reference's."""
    jcfg, tcfg, jm, pj, tm, pt = _models(arch)
    if arch == "llava-next-34b":
        assert tcfg.family == "vlm" and tcfg.num_prefix_tokens == 4
    rng = np.random.default_rng(1)
    nb = _lm_batch(tcfg, rng, 12, prefix=tcfg.frontend is not None)
    jb = {k: jnp.asarray(v) for k, v in nb.items()}
    tb = {k: T(v) for k, v in nb.items()}
    pre_t = tb.get("prefix_embeds")

    @jax.jit
    def reference(pj, jb):
        pre = jb.get("prefix_embeds")
        unmasked = {k: v for k, v in jb.items() if k != "loss_mask"}
        return (jm.hidden_states(pj, jb["tokens"], pre),
                jm.forward(pj, jb["tokens"], pre)[0],
                [jm.loss(pj, b) for b in (jb, unmasked)])

    (h_j, aux_j), lg_j, losses_j = reference(pj, jb)
    h_t, aux_t = tm.hidden_states(pt, tb["tokens"], pre_t)
    assert h_t.shape == (B, 12 + tcfg.num_prefix_tokens, tcfg.d_model)
    assert aux_t.dtype == torch.float32
    if tcfg.is_moe:
        assert float(aux_t) > 0
        np.testing.assert_allclose(float(aux_t), float(aux_j), rtol=1e-5)
    else:
        assert float(aux_t) == float(aux_j) == 0
    np.testing.assert_allclose(h_t.numpy(), _np(h_j), **TOL)
    lg_t, _ = tm.forward(pt, tb["tokens"], pre_t)
    np.testing.assert_allclose(lg_t.numpy(), _np(lg_j), **TOL)
    unmasked = {k: v for k, v in tb.items() if k != "loss_mask"}
    for (l_j, m_j), tbb in zip(losses_j, (tb, unmasked)):
        l_t, m_t = tm.loss(pt, tbb)
        np.testing.assert_allclose(l_t.numpy(), _np(l_j), **TOL)
        np.testing.assert_allclose(m_t["ce"].numpy(), _np(m_j["ce"]), **TOL)
        np.testing.assert_allclose(m_t["aux"].numpy(), _np(m_j["aux"]),
                                   **TOL)


def test_forward_takes_the_chunked_attention_at_s_1024():
    """qwen2's smoke variant over 1024 tokens: the 512-query blocks in
    every layer, within 1e-5 of the reference's logits' scale."""
    jcfg, tcfg, jm, pj, tm, pt = _models("qwen2-1.5b", seed=2)
    tok = np.random.default_rng(2).integers(
        0, tcfg.vocab_size, size=(1, 1024)).astype(np.int32)
    want = _np(jax.jit(jm.forward)(pj, jnp.asarray(tok))[0])
    got = tm.forward(pt, T(tok))[0].numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_forward_and_loss_launch_nothing_on_the_cpu():
    cfg = smoke_variant(get_config("llava-next-34b"))
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    nb = _lm_batch(cfg, np.random.default_rng(0), 12, prefix=True)
    ops.reset_launches()
    model.forward(params, T(nb["tokens"]), T(nb["prefix_embeds"]))
    model.loss(params, {k: T(v) for k, v in nb.items()})
    assert not any(ops.LAUNCHES.values())
    assert not any(ops.ROUTE_LAUNCHES.values())


# ---------------------------------------------------------------------------
# Twins of tests/test_models_smoke.py
# ---------------------------------------------------------------------------

def _smoke_batch(cfg):
    batch = {"tokens": torch.zeros((B, S), dtype=torch.int32),
             "labels": torch.ones((B, S), dtype=torch.int32)}
    if cfg.family == "vlm":
        P = cfg.num_prefix_tokens
        batch["tokens"] = torch.zeros((B, S - P), dtype=torch.int32)
        batch["labels"] = torch.ones((B, S - P), dtype=torch.int32)
        batch["prefix_embeds"] = torch.ones((B, P, cfg.d_model),
                                            dtype=cfg.torch_dtype)
    if cfg.family == "audio":
        batch["frames"] = _frames(cfg)
    return batch


def _frames(cfg):
    return torch.ones((B, cfg.encoder_seq, cfg.d_model), dtype=cfg.torch_dtype)


def _decode_state(model, params, cache_len):
    """A zero decode state; an encoder-decoder's holds the cross K/V of
    stub frames, as the reference's smoke decode test."""
    if model.cfg.is_encoder_decoder:
        return model.init_decode_state(B, cache_len, frames=_frames(model.cfg),
                                       params=params)
    return model.init_decode_state(B, cache_len)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_smoke_forward_and_loss(arch):
    cfg = smoke_variant(get_config(arch))
    assert cfg.num_layers <= 2 and cfg.d_model <= 512
    assert cfg.num_experts <= 4
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    loss, metrics = model.loss(params, _smoke_batch(cfg))
    assert loss.shape == ()
    assert bool(torch.isfinite(loss)), f"{arch} loss not finite"
    assert float(loss) > 0


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_smoke_decode_step(arch):
    cfg = smoke_variant(get_config(arch))
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    state = _decode_state(model, params, 64)
    tok = torch.zeros((B, 1), dtype=torch.int32)
    for _ in range(3):
        logits, state = model.decode_step(params, state, tok)
        assert logits.shape == (B, 1, cfg.vocab_size)
        assert bool(torch.isfinite(logits.float()).all())
        tok = logits[:, -1:, :].argmax(-1).to(torch.int32)
    assert int(state.pos) == 3


@pytest.mark.parametrize("arch", ("tinyllama-1.1b", "llama3-8b", "qwen2-1.5b",
                                  "chatglm3-6b") + MOE_ARCHS
                         + ("rwkv6-7b", "zamba2-1.2b") + ENCDEC_ARCHS)
@pytest.mark.parametrize("kernel", [True, False])
def test_decode_matches_forward(arch, kernel):
    """Teacher-forced decode reproduces the forward's logits, on both
    decode routes (the kernel's plain version here), at the reference's
    rtol 2e-2, atol 2e-3 (the MoE configs at the smoke variants'
    capacity factor 8, where neither drops a token, as the reference's
    mixtral case; whisper over the same stub frames)."""
    cfg = dataclasses.replace(smoke_variant(get_config(arch)),
                              sliding_window=None)
    model = build_model(cfg, decode_kernel=kernel)
    params = model.init(torch.Generator().manual_seed(0))
    steps = 8
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, size=(B, steps)).astype(np.int32))
    if cfg.is_encoder_decoder:
        full_logits, _ = model.forward(params, tokens, _frames(cfg))
    else:
        full_logits, _ = model.forward(params, tokens)
    state = _decode_state(model, params, steps)
    outs = []
    for t in range(steps):
        logits, state = model.decode_step(params, state, tokens[:, t:t + 1])
        outs.append(logits[:, 0, :])
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(),
                               full_logits.numpy(), rtol=2e-2, atol=2e-3)


def test_param_counts_match_assignment():
    """The full configs carry the assigned dimensions, and param_count
    (and active_param_count, MoE included) is the reference's."""
    for arch in LM_ARCHS:
        cfg, jcfg = get_config(arch), j_get_config(arch)
        assert cfg.param_count() == jcfg.param_count(), arch
        assert cfg.active_param_count() == jcfg.active_param_count(), arch
    assert 7.0e9 < get_config("llama3-8b").param_count() < 9.0e9
    assert 1.0e9 < get_config("tinyllama-1.1b").param_count() < 1.25e9
    llava = get_config("llava-next-34b")
    assert (llava.family, llava.frontend, llava.num_prefix_tokens) == \
        ("vlm", "vision", 576)
    cfg = get_config("qwen3-moe-235b-a22b")
    assert (cfg.family, cfg.num_layers, cfg.d_model, cfg.num_heads,
            cfg.num_kv_heads, cfg.d_ff, cfg.vocab_size, cfg.num_experts,
            cfg.experts_per_token) == \
        ("moe", 94, 4096, 64, 4, 1536, 151936, 128, 8)
    cfg = get_config("mixtral-8x22b")
    assert (cfg.family, cfg.num_layers, cfg.d_model, cfg.num_experts,
            cfg.experts_per_token, cfg.sliding_window) == \
        ("moe", 56, 6144, 8, 2, 4096)
    assert cfg.active_param_count() < cfg.param_count()


@pytest.mark.parametrize("arch", [a for a in PORTED_ARCHS if a != "svm_tfidf"])
def test_configs_are_the_reference_configs_field_for_field(arch):
    """Every field of the port's ModelConfig, of the full config and of
    its smoke variant, equals the reference's."""
    cfg, jcfg = get_config(arch), j_get_config(arch)
    for f in dataclasses.fields(ModelConfig):
        assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
        assert getattr(smoke_variant(cfg), f.name) == \
            getattr(j_smoke_variant(jcfg), f.name), f.name
    assert cfg.citation and cfg.hd == jcfg.hd and cfg.is_moe == jcfg.is_moe
    # the reference's alias resolves to the same config
    alias = next(a for a, n in j_aliases.items() if n == arch)
    assert get_config(alias) is cfg


@pytest.mark.parametrize("family,fields", [
    ("ssm", {}), ("hybrid", {"attn_every": 3}), ("audio", {}),
    ("retnet", {})])
def test_unported_families_raise_naming_their_item(family, fields):
    """Every family of the reference is ported; the configs it refuses
    the port refuses with its ValueError: an ssm without attn_free, a
    hybrid whose attn_every does not divide its layers, an audio config
    that is not an encoder-decoder, an unknown family."""
    cfg = ModelConfig(**dict(ATTN, family=family, **fields))
    jcfg = JModelConfig(**dict(ATTN, family=family, **fields))
    for build in (build_model, j_build_model):
        with pytest.raises(ValueError, match="family|attn_every"):
            build(jcfg if build is j_build_model else cfg)


# ---------------------------------------------------------------------------
# Twins of tests/test_model_properties.py (RoPE, rmsnorm, sliding window)
# ---------------------------------------------------------------------------

_SET = dict(max_examples=10, deadline=None)


@given(st.integers(0, 500), st.integers(2, 6), st.sampled_from([32, 64]))
@settings(**_SET)
def test_rope_preserves_norm(offset, heads, hd):
    x = torch.from_numpy(np.random.default_rng(offset).normal(
        size=(1, 4, heads, hd)).astype(np.float32))
    pos = torch.arange(4)[None, :] + offset
    r = tlayers.apply_rope(x, pos, 1.0, 10000.0)
    np.testing.assert_allclose(r.norm(dim=-1).numpy(), x.norm(dim=-1).numpy(),
                               rtol=1e-4)


def test_rope_relative_position_invariance():
    rng = np.random.default_rng(0)
    q, k = (torch.from_numpy(rng.normal(size=(1, 8, 2, 64)).astype(np.float32))
            for _ in range(2))
    p = torch.arange(8)[None, :]

    def scores(shift):
        return torch.einsum("bshd,bthd->bhst",
                            tlayers.apply_rope(q, p + shift, 1.0, 1e4),
                            tlayers.apply_rope(k, p + shift, 1.0, 1e4))
    for delta in (1, 17, 1000):
        np.testing.assert_allclose(scores(0).numpy(), scores(delta).numpy(),
                                   rtol=2e-3, atol=2e-3)


def test_partial_rope_leaves_tail_untouched():
    x = torch.from_numpy(np.random.default_rng(2).normal(
        size=(1, 4, 2, 64)).astype(np.float32))
    r = tlayers.apply_rope(x, torch.arange(4)[None, :] + 3, 0.5, 1e4)
    assert torch.equal(r[..., 32:], x[..., 32:])
    assert not torch.allclose(r[..., :32], x[..., :32])


@given(st.integers(0, 100))
@settings(**_SET)
def test_rmsnorm_unit_rms(seed):
    x = torch.from_numpy(np.random.default_rng(seed).normal(
        size=(3, 5, 64)).astype(np.float32)) * 7.0
    y = tlayers.rmsnorm(x, torch.ones(64), 1e-6)
    np.testing.assert_allclose(y.square().mean(-1).sqrt().numpy(), 1.0,
                               rtol=1e-3)


def test_sliding_window_masks_distant_tokens():
    """Perturbing x_0 leaves the outputs at t ≥ window unchanged."""
    cfg = ModelConfig(name="t", family="dense", num_layers=1, d_model=64,
                      num_heads=4, num_kv_heads=4, d_ff=64, vocab_size=64,
                      sliding_window=4)
    p = tlayers.template_init(tattn.attn_template(cfg),
                              torch.Generator().manual_seed(0), torch.float32)
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(1, 12, 64)).astype(np.float32))
    pos = torch.arange(12)[None, :]
    y1 = tattn.attention(p, x, cfg, positions=pos)
    x2 = x.clone()
    x2[0, 0] += 10.0
    y2 = tattn.attention(p, x2, cfg, positions=pos)
    np.testing.assert_allclose(y1[0, 4:].numpy(), y2[0, 4:].numpy(),
                               rtol=1e-4, atol=1e-5)
    assert not np.allclose(y1[0, 1].numpy(), y2[0, 1].numpy(), rtol=1e-4)
