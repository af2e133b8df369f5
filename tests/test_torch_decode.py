"""The port's LM serve path against the JAX reference, on the CPU: the
plain ``flash_decode`` (the CUDA kernel runs only on a card;
``chip_smoke.py`` holds it against this), the layers, the decode step
on both routes, and greedy decoding of a JAX-initialised model through
``convert.lm_params_from_jax``. The Pallas kernel runs in interpret
mode, as the reference's tests run it. Inputs come from numpy seeds and
go to both packages."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.kernels import decode_attention as j_decode_attention
from repro.launch.mesh import make_host_mesh
from repro.launch.steps import InputShape, build_serve_step
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models.config import ModelConfig as JModelConfig
from repro.models.config import smoke_variant as j_smoke_variant
from repro.models.transformer import TransformerModel as JTransformer
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.launch.serve import serve_lm
from repro_torch.launch.steps import make_serve_step
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models.config import ModelConfig, smoke_variant
from repro_torch.models.transformer import build_model

T = convert.tensor_from_numpy


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _pair(a, dtype):
    """A numpy f32 array → (JAX array in ``dtype``, the same values as a
    torch tensor)."""
    j = jnp.asarray(a, dtype)
    return j, T(np.asarray(j))


# ---------------------------------------------------------------------------
# flash_decode: the port's plain version ≡ the Pallas kernel
# ---------------------------------------------------------------------------

# the last: qwen3-moe-235b-a22b's group, G 16 at hd 64
SWEEP = [(1, 4, 4, 128, 64), (2, 8, 2, 256, 64), (2, 16, 4, 512, 128),
         (1, 64, 4, 256, 64)]


def _qkv(B, H, KV, S, hd, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, H, hd)).astype(np.float32),
            rng.normal(size=(B, KV, S, hd)).astype(np.float32),
            rng.normal(size=(B, KV, S, hd)).astype(np.float32))


@pytest.mark.parametrize("B,H,KV,S,hd", SWEEP)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("vlen", ["zero", "one", "partial", "full"])
def test_decode_attention_matches_pallas_flash_decode(B, H, KV, S, hd, dtype,
                                                      vlen):
    """The tolerances of tests/test_kernels.py:67: 1e-4 in f32; 3e-2 in
    bf16, where both sides compute in f32 and round the output once."""
    valid = {"zero": 0, "one": 1, "partial": S - S // 4 - 3, "full": S}[vlen]
    q, k, v = _qkv(B, H, KV, S, hd, seed=S + hd)
    (qj, qt), (kj, kt), (vj, vt) = (_pair(a, dtype) for a in (q, k, v))
    out_j = j_decode_attention(qj, kj, vj, jnp.asarray(valid, jnp.int32),
                               bs=64)
    vl = torch.tensor(valid, dtype=torch.int32)
    out_t = ops.decode_attention(qt, kt, vt, vl)
    assert out_t.dtype == qt.dtype and out_t.shape == (B, H, hd)
    tol = 1e-4 if dtype == "float32" else 3e-2
    np.testing.assert_allclose(convert.to_numpy(out_t), _np(out_j),
                               rtol=tol, atol=tol)
    if valid == 0:      # every score −1e30: the mean of V over all slots
        mean = vt.float().mean(2).repeat_interleave(H // KV, dim=1)
        np.testing.assert_allclose(convert.to_numpy(out_t), mean.numpy(),
                                   rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_ignores_the_cache_past_valid_len(dtype):
    """K/V past valid_len set to ±99 change nothing (exactly)."""
    q, k, v = (T(a).to(dtype) for a in _qkv(1, 4, 4, 128, 32, seed=3))
    vl = torch.tensor(60, dtype=torch.int32)
    out1 = ops.decode_attention(q, k, v, vl)
    k2, v2 = k.clone(), v.clone()
    k2[:, :, 60:] = 99.0
    v2[:, :, 60:] = -99.0
    assert torch.equal(ops.decode_attention(q, k2, v2, vl), out1)


def test_decode_attention_checks_inputs_and_counts_no_launch_on_cpu():
    q, k, v = (T(a) for a in _qkv(2, 8, 2, 32, 16, seed=4))
    vl = torch.tensor(5, dtype=torch.int32)
    with pytest.raises(ValueError, match="group"):
        ops.decode_attention(q[:, :7], k, v, vl)
    with pytest.raises(ValueError, match="int32"):
        ops.decode_attention(q, k, v, torch.tensor(5))
    with pytest.raises(ValueError, match="one dtype"):
        ops.decode_attention(q, k.double(), v.double(), vl)
    ops.reset_launches()
    ops.decode_attention(q, k, v, vl)
    assert ops.LAUNCHES["flash_decode"] == 0


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

def test_rmsnorm_layernorm_and_embed_tokens_match_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 3, 64)).astype(np.float32)
    s = rng.normal(size=(64,)).astype(np.float32)
    bias = rng.normal(size=(64,)).astype(np.float32)
    np.testing.assert_allclose(
        tlayers.rmsnorm(T(x), T(s), 1e-5).numpy(),
        _np(jlayers.rmsnorm(jnp.asarray(x), jnp.asarray(s), 1e-5)),
        rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        tlayers.layernorm(T(x), T(s), T(bias), 1e-5).numpy(),
        _np(jlayers.layernorm(jnp.asarray(x), jnp.asarray(s),
                              jnp.asarray(bias), 1e-5)),
        rtol=1e-5, atol=1e-5)
    E = rng.normal(size=(50, 64)).astype(np.float32)
    tok = rng.integers(0, 50, size=(3, 1)).astype(np.int32)
    for dtype in (jnp.float32, jnp.bfloat16):
        Ej = jnp.asarray(E, dtype)
        got = tlayers.embed_tokens({"embedding": T(np.asarray(Ej))},
                                   torch.from_numpy(tok))
        want = jlayers.embed_tokens({"embedding": Ej}, jnp.asarray(tok))
        assert got.dtype == T(np.asarray(want)).dtype
        np.testing.assert_array_equal(convert.to_numpy(got), _np(want))


@pytest.mark.parametrize("fraction", [1.0, 0.5])
def test_apply_rope_matches_reference(fraction):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 5, 4, 32)).astype(np.float32)
    pos = rng.integers(0, 4096, size=(2, 5)).astype(np.int32)
    got = tlayers.apply_rope(T(x), torch.from_numpy(pos), fraction, 10000.0)
    want = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), fraction,
                              10000.0)
    # angles up to 4096 rad: cos/sin of two libraries differ by ~1e-4
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-4, atol=2e-4)
    if fraction < 1.0:
        np.testing.assert_array_equal(got[..., 16:].numpy(), x[..., 16:])


@pytest.mark.parametrize("style", ["swiglu", "gelu"])
def test_apply_mlp_matches_reference(style):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 1, 32)).astype(np.float32)
    tpl = jlayers.mlp_template(32, 48, style)
    p = {n: rng.normal(size=s.shape).astype(np.float32) / 6
         for n, s in tpl.items()}
    got = tlayers.apply_mlp(T(x), {n: T(a) for n, a in p.items()}, style)
    want = jlayers.apply_mlp(jnp.asarray(x),
                             {n: jnp.asarray(a) for n, a in p.items()}, style)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-5, atol=1e-5)


def _tree_sig(tree, prefix=""):
    if isinstance(tree, dict):
        return sum((_tree_sig(tree[k], f"{prefix}/{k}") for k in sorted(tree)),
                   [])
    return [(prefix, tuple(tree.shape), str(tree.dtype))]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("qkv_bias", [False, True])
def test_template_init_gives_the_reference_tree(dtype, qkv_bias):
    jcfg = dataclasses.replace(j_smoke_variant(j_get_config("tinyllama-1.1b")),
                               dtype=dtype, qkv_bias=qkv_bias)
    tcfg = dataclasses.replace(smoke_variant(get_config("tinyllama-1.1b")),
                               dtype=dtype, qkv_bias=qkv_bias)
    want = _tree_sig(jax.tree.map(np.asarray,
                                  JTransformer(jcfg).init(jax.random.PRNGKey(0))))
    got = _tree_sig(build_model(tcfg).init(torch.Generator().manual_seed(0)))
    assert [(n, s) for n, s, _ in got] == [(n, s) for n, s, _ in want]
    assert {d for _, _, d in got} == {f"torch.{dtype}"}
    # fan-in scaled: wq (L, d, H, hd) has std 1/√d
    p = build_model(tcfg).init(torch.Generator().manual_seed(0))
    std = float(p["layers"]["attn"]["wq"].float().std())
    assert abs(std * tcfg.d_model ** 0.5 - 1.0) < 0.05
    assert tcfg.param_count() == jcfg.param_count()


# ---------------------------------------------------------------------------
# The decode step, both routes
# ---------------------------------------------------------------------------

ATTN_CFG = dict(name="t", family="dense", num_layers=1, d_model=64,
                num_heads=8, num_kv_heads=2, d_ff=128, vocab_size=64)


def _attn_case(seed, cfg_kw, cache_len, filled, kv_repeat):
    """Random attention params (biases too), input and a cache with
    ``filled`` written slots, as numpy."""
    jcfg = JModelConfig(**ATTN_CFG, **cfg_kw)
    rng = np.random.default_rng(seed)
    p = {n: (rng.normal(size=s.shape) / np.sqrt(s.fan_in or 100)
             ).astype(np.float32)          # biases: std 0.1
         for n, s in jattn.attn_template(jcfg).items()}
    x = rng.normal(size=(2, 1, jcfg.d_model)).astype(np.float32)
    S = min(cache_len, jcfg.sliding_window or cache_len)
    shape = (2, jcfg.num_kv_heads * kv_repeat, S, jcfg.hd)
    k = np.zeros(shape, np.float32)
    v = np.zeros(shape, np.float32)
    k[:, :, :filled] = rng.normal(size=shape[:2] + (filled, shape[3]))
    v[:, :, :filled] = rng.normal(size=shape[:2] + (filled, shape[3]))
    return jcfg, ModelConfig(**ATTN_CFG, **cfg_kw), p, x, k, v


@pytest.mark.parametrize("kernel", [False, True])
def test_attention_decode_step_matches_reference(kernel):
    """After 5 prefilled positions, with qkv bias and kv_repeat 2: port
    ``use_kernel`` ≡ reference ``use_pallas`` (Pallas in interpret mode).
    y within 2e-4 on the kernel route (a blockwise online softmax on
    both sides) and 2e-5 on the plain route; the caches equal to 1e-6
    (the new slot is a projection computed by two libraries)."""
    jcfg, tcfg, p, x, k, v = _attn_case(7, dict(qkv_bias=True), 16, 5, 2)
    pos = 5
    y_j, c_j = jattn.attention_decode_step(
        {n: jnp.asarray(a) for n, a in p.items()}, jnp.asarray(x),
        jattn.LayerKVCache(jnp.asarray(k), jnp.asarray(v)),
        jnp.asarray(pos, jnp.int32), jcfg, kv_repeat=2, use_pallas=kernel)
    cache = tattn.LayerKVCache(T(k), T(v))
    y_t, c_t = tattn.attention_decode_step(
        {n: T(a) for n, a in p.items()}, T(x), cache,
        torch.tensor(pos, dtype=torch.int32), tcfg, kv_repeat=2,
        use_kernel=kernel)
    tol = 2e-4 if kernel else 2e-5
    np.testing.assert_allclose(y_t.numpy(), _np(y_j), rtol=tol, atol=tol)
    assert c_t.k is cache.k             # written in place
    for a, b in ((c_t.k, c_j.k), (c_t.v, c_j.v)):
        np.testing.assert_allclose(a.numpy(), _np(b), rtol=1e-6, atol=1e-6)
        assert not a[:, :, pos + 1:].any()


@pytest.mark.parametrize("kernel", [False, True])
def test_sliding_window_ring_route_matches_reference(kernel):
    """A ring cache of 8 slots at position 11 (wrapped): both routes of
    the port take the ring path, as the reference does."""
    jcfg, tcfg, p, x, k, v = _attn_case(8, dict(sliding_window=8), 32, 8, 1)
    pos = 11
    y_j, c_j = jattn.attention_decode_step(
        {n: jnp.asarray(a) for n, a in p.items()}, jnp.asarray(x),
        jattn.LayerKVCache(jnp.asarray(k), jnp.asarray(v)),
        jnp.asarray(pos, jnp.int32), jcfg, use_pallas=kernel)
    ops.reset_launches()
    y_t, c_t = tattn.attention_decode_step(
        {n: T(a) for n, a in p.items()}, T(x),
        tattn.LayerKVCache(T(k), T(v)), torch.tensor(pos, dtype=torch.int32),
        tcfg, use_kernel=kernel)
    np.testing.assert_allclose(y_t.numpy(), _np(y_j), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(c_t.k.numpy(), _np(c_j.k), rtol=1e-6,
                               atol=1e-6)
    slots = tattn.cache_slot_positions(tcfg, 8, torch.tensor(pos))
    np.testing.assert_array_equal(
        slots.numpy(),
        np.asarray(jattn.cache_slot_positions(jcfg, 8, jnp.asarray(pos))))


# ---------------------------------------------------------------------------
# Greedy decoding of a JAX-initialised model
# ---------------------------------------------------------------------------

SMALL = dict(name="gqa-small", family="dense", num_layers=2, d_model=128,
             num_heads=8, num_kv_heads=2, d_ff=256, vocab_size=512)


SMOKE_NAMES = {"tinyllama-smoke": "tinyllama-1.1b",
               "qwen3-moe-smoke": "qwen3-moe-235b-a22b",
               "rwkv6-smoke": "rwkv6-7b", "zamba2-smoke": "zamba2-1.2b",
               "whisper-smoke": "whisper-base"}


@pytest.mark.parametrize("kernel,arch", [
    (kernel, arch) for kernel in (True, False)
    for arch in ["gqa-small"] + list(SMOKE_NAMES)
    # rwkv6 has no cache attention: one route
    if kernel or arch != "rwkv6-smoke"])
def test_greedy_decode_matches_reference_serve_step(arch, kernel):
    """8 greedy steps from token 0 and a zero cache (rwkv6: state;
    whisper: zero cross K/V, as the reference's state without frames):
    the reference's own serve step (``build_serve_step``) against the
    port's, on the same parameters. Tokens equal at every step, logits
    and every state leaf within 1e-4."""
    if arch == "gqa-small":
        jcfg, tcfg = JModelConfig(**SMALL), ModelConfig(**SMALL)
    else:
        name = SMOKE_NAMES[arch]
        jcfg = j_smoke_variant(j_get_config(name))
        tcfg = smoke_variant(get_config(name))
    B, steps, cache_len = 3, 8, 16
    bundle = build_serve_step(jcfg, make_host_mesh(1, 1),
                              InputShape("t", "decode", cache_len, B))
    jmodel = bundle.model
    jparams = jmodel.init(jax.random.PRNGKey(1))
    params = convert.lm_params_from_jax(jax.tree.map(np.asarray, jparams))
    tmodel = build_model(tcfg, decode_kernel=kernel)
    jstate = jmodel.init_decode_state(B, cache_len)
    state = tmodel.init_decode_state(B, cache_len)
    j_step = jax.jit(bundle.fn)
    j_decode = jax.jit(jmodel.decode_step)
    t_step = make_serve_step(tmodel)
    tok_j = jnp.zeros((B, 1), jnp.int32)
    tok_t = torch.zeros((B, 1), dtype=torch.int32)
    for i in range(steps):
        logits_j, _ = j_decode(jparams, jstate, tok_j)
        # writing this step's cache slot twice writes the same values
        logits_t, _ = tmodel.decode_step(params, state, tok_t)
        np.testing.assert_allclose(logits_t.numpy(), _np(logits_j),
                                   rtol=1e-4, atol=1e-4)
        nj, jstate = j_step(jparams, jstate, tok_j)
        nt, state = t_step(params, state, tok_t)
        assert nt.dtype == torch.int32
        np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))
        tok_j, tok_t = nj[:, None], nt[:, None]
    assert int(state.pos) == int(jstate.pos) == steps
    for got, want in zip(jax.tree.leaves(convert.to_numpy(state)),
                         jax.tree.leaves(jstate)):
        np.testing.assert_allclose(got, _np(want), rtol=1e-4, atol=1e-4)


def test_serve_lm_runs_the_smoke_config_and_counts_no_launch_on_cpu():
    cfg = smoke_variant(get_config("tinyllama-1.1b"))
    ops.reset_launches()
    res = serve_lm(cfg, batch=2, cache_len=32, tokens=4, device="cpu")
    assert res.tokens.shape == (4, 2) and res.tokens.dtype == torch.int32
    assert 0 <= int(res.tokens.min()) and int(res.tokens.max()) < cfg.vocab_size
    assert int(res.state.pos) == 4 and res.tok_per_s > 0
    assert ops.LAUNCHES["flash_decode"] == 0
    # a given state is advanced from where it stands
    again = serve_lm(cfg, batch=2, cache_len=32, tokens=2, device="cpu",
                     state=res.state)
    assert int(again.state.pos) == 6


def test_serve_lm_refuses_to_run_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = smoke_variant(get_config("tinyllama-1.1b"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_lm(cfg, batch=2, cache_len=32, tokens=1)


def test_unported_archs_and_families_raise_naming_the_roadmap():
    """Every architecture of the reference resolves; the configs the
    reference refuses raise its errors: an unknown arch, an ssm config
    without attn_free."""
    from repro_torch.launch.serve import main
    from repro_torch.models.rwkv6_model import RWKV6Model
    assert type(build_model(get_config("rwkv6-7b"))) is RWKV6Model
    with pytest.raises(ModuleNotFoundError, match="unknown architecture"):
        get_config("gpt-5")
    with pytest.raises(ValueError, match="unknown family 'ssm'"):
        build_model(ModelConfig(**dict(SMALL, family="ssm")))
    # the moe family (mixtral-8x22b, qwen3-moe-235b-a22b) is ported
    assert build_model(ModelConfig(**dict(SMALL, family="moe",
                                          num_experts=4,
                                          experts_per_token=2))).cfg.is_moe
    # the vlm family (llava-next-34b) is the dense decoder: it builds
    assert build_model(ModelConfig(**dict(SMALL, family="vlm"))).cfg.family \
        == "vlm"
    # --restore is ported (item 9) and, as the reference's, needs its
    # directory; --shuffle is ported too (item 7) and, as the reference's,
    # takes only the merge transports' names
    with pytest.raises(SystemExit, match="--restore requires"):
        main(["--arch", "svm-tfidf", "--device", "cpu", "--restore"])
    with pytest.raises(SystemExit):
        main(["--arch", "svm-tfidf", "--device", "cpu", "--shuffle", "tree"])
