"""The port's encoder-decoder family (``repro_torch.models.encdec``)
against the JAX reference (``repro/models/encdec.py``), on the CPU, on
whisper-base's smoke variant with the same numpy weights in both
packages: the sinusoidal positions, ``encode``, ``hidden_states``, the
logits, ``loss``, ``_cross_kv`` and the decode state built from frames,
``decode_step`` on both decode routes (the kernel's plain version here),
``dec_pos`` read at min(pos, max_decoder_len − 1) past position 448, the
prefill step, and teacher-forced decode against the forward. All in
float32, held at 1e-5 of each output's largest magnitude."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.launch import steps as jsteps
from repro.launch.mesh import make_host_mesh
from repro.models import encdec as jencdec
from repro.models.config import smoke_variant as j_smoke_variant
from repro.models.layers import PSpec as JPSpec
from repro.models.layers import lm_logits as j_lm_logits
from repro.models.transformer import build_model as j_build_model
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.launch import steps
from repro_torch.models import encdec as tencdec
from repro_torch.models.config import smoke_variant
from repro_torch.models.transformer import build_model
from torch_threads import one_thread  # noqa: F401

T = convert.tensor_from_numpy
TOL = 1e-5
B, S = 2, 12


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, tol=TOL, what=""):
    """max |Δ| ≤ tol · max |want|."""
    got = got.detach().float().numpy()
    want = _np(want)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: max|Δ| {err:.2e} of {scale:.3g}"


def _np_init(template, rng):
    """Numpy draws for a reference template: fan-in scaled normals
    (embedding rows 1/√d), the norms' ones, and the biases (zeros at
    init) drawn N(0, 0.1²) so that they matter."""
    def draw(p):
        if p.init == "ones":
            return np.ones(p.shape, np.float32)
        if p.init == "zeros":
            return (0.1 * rng.normal(size=p.shape)).astype(np.float32)
        fan = p.shape[-1] if p.init == "embed" else (
            p.fan_in or (p.shape[-2] if len(p.shape) >= 2 else p.shape[-1]))
        return (rng.normal(size=p.shape) / np.sqrt(fan)).astype(np.float32)
    return jax.tree.map(draw, template,
                        is_leaf=lambda x: isinstance(x, JPSpec))


@pytest.fixture(scope="module")
def whisper():
    jcfg = j_smoke_variant(j_get_config("whisper-base"))
    tcfg = smoke_variant(get_config("whisper-base"))
    jm = j_build_model(jcfg)
    rng = np.random.default_rng(0)
    tree = _np_init(jm.template(), rng)
    frames = rng.normal(size=(B, tcfg.encoder_seq, tcfg.d_model)
                        ).astype(np.float32)
    tokens = rng.integers(0, tcfg.vocab_size, (B, S)).astype(np.int32)
    return dict(jcfg=jcfg, tcfg=tcfg, jm=jm, tm=build_model(tcfg),
                pj=jax.tree.map(jnp.asarray, tree),
                pt=convert.lm_params_from_jax(tree), frames=frames,
                tokens=tokens)


def test_config_and_build():
    """whisper-base builds an EncDecModel; the audio family without
    is_encoder_decoder raises the reference's ValueError."""
    cfg = get_config("whisper-base")
    assert type(build_model(cfg)) is tencdec.EncDecModel
    assert cfg.is_encoder_decoder and cfg.max_decoder_len == 448
    bad = dataclasses.replace(cfg, is_encoder_decoder=False)
    with pytest.raises(ValueError, match="unknown family 'audio'"):
        build_model(bad)


def test_sinusoidal_positions_match_reference():
    _close(tencdec.sinusoidal_positions(1500, 512),
           jencdec.sinusoidal_positions(1500, 512))


def test_encode_decoder_and_loss_match_reference(whisper):
    """encode (bidirectional, sinusoidal positions), hidden_states over
    the encoder states, the logits (forward), and loss with and without
    a loss mask: within 1e-5."""
    w = whisper
    jm, tm, pj, pt = w["jm"], w["tm"], w["pj"], w["pt"]
    rng = np.random.default_rng(1)
    nb = {"frames": w["frames"], "tokens": w["tokens"],
          "labels": rng.integers(0, w["tcfg"].vocab_size, (B, S)
                                 ).astype(np.int32),
          "loss_mask": (rng.random((B, S)) > 0.2).astype(np.float32)}
    jb = {k: jnp.asarray(v) for k, v in nb.items()}

    @jax.jit
    def reference(pj, jb):
        enc = jm.encode(pj, jb["frames"])
        h, aux = jm.hidden_states(pj, jb["tokens"], enc)
        unmasked = {k: v for k, v in jb.items() if k != "loss_mask"}
        return (enc, h, aux, j_lm_logits(pj["embed"], h, True),
                [jm.loss(pj, b) for b in (jb, unmasked)])

    enc_j, h_j, aux_j, lg_j, losses_j = reference(pj, jb)
    tb = {k: T(v) for k, v in nb.items()}
    enc_t = tm.encode(pt, tb["frames"])
    _close(enc_t, enc_j, what="encode")
    h_t, aux_t = tm.hidden_states(pt, tb["tokens"], enc_t)
    assert float(aux_t) == float(aux_j) == 0
    _close(h_t, h_j, what="hidden_states")
    _close(tm.forward(pt, tb["tokens"], tb["frames"])[0], lg_j,
           what="logits")
    unmasked = {k: v for k, v in tb.items() if k != "loss_mask"}
    for (l_j, m_j), b in zip(losses_j, (tb, unmasked)):
        l_t, m_t = tm.loss(pt, b)
        _close(l_t, l_j, what="loss")
        _close(m_t["ce"], m_j["ce"], what="ce")


@pytest.mark.parametrize("kernel", [True, False])
def test_decode_steps_match_reference(whisper, kernel):
    """init_decode_state from frames (the cross K/V of every decoder
    layer, ``_cross_kv``), then 6 decode steps: logits, the
    self-attention caches and the position within 1e-5 of the
    reference's, on both decode routes; no kernel launched on the
    CPU."""
    w = whisper
    jm, pj, pt = w["jm"], w["pj"], w["pt"]
    tm = build_model(w["tcfg"], decode_kernel=kernel)
    frames, tokens = w["frames"], w["tokens"]
    js = jm.init_decode_state(B, 16, frames=jnp.asarray(frames), params=pj)
    ts = tm.init_decode_state(B, 16, frames=T(frames), params=pt)
    _close(ts.cross_k, js.cross_k, what="cross_k")
    _close(ts.cross_v, js.cross_v, what="cross_v")
    ck, cv = tm._cross_kv(pt, tm.encode(pt, T(frames)))
    assert torch.equal(ck, ts.cross_k) and torch.equal(cv, ts.cross_v)
    step = jax.jit(jm.decode_step)
    ops.reset_launches()
    for t in range(6):
        lj, js = step(pj, js, jnp.asarray(tokens[:, t:t + 1]))
        lt, ts = tm.decode_step(pt, ts, T(tokens[:, t:t + 1]))
        _close(lt, lj, what=f"logits step {t}")
    assert not any(ops.LAUNCHES.values())
    assert int(ts.pos) == int(js.pos) == 6
    _close(ts.self_cache.k, js.self_cache.k, what="self cache k")
    _close(ts.self_cache.v, js.self_cache.v, what="self cache v")


def test_dec_pos_is_clamped_past_the_decoder_cap(whisper):
    """At positions 447, 448 and 500 (cache 512) the step reads dec_pos
    row min(pos, 447), as the reference's: logits within 1e-5 of its
    step from the same state; at 500 zeroing row 447 moves the logits
    and zeroing row 446 does not."""
    w = whisper
    jm, tm, pj, pt = w["jm"], w["tm"], w["pj"], w["pt"]
    assert w["tcfg"].max_decoder_len == 448
    tok = w["tokens"][:, :1]
    js0 = jm.init_decode_state(B, 512, frames=jnp.asarray(w["frames"]),
                               params=pj)
    step = jax.jit(jm.decode_step)
    def port_step(params, pos):
        # a fresh state each time: the step writes its cache in place
        ts = tm.init_decode_state(B, 512, frames=T(w["frames"]), params=pt)
        ts = ts._replace(pos=torch.tensor(pos, dtype=torch.int32))
        return tm.decode_step(params, ts, T(tok))[0]

    for pos in (447, 448, 500):
        js = js0._replace(pos=jnp.asarray(pos, jnp.int32))
        _close(port_step(pt, pos), step(pj, js, jnp.asarray(tok))[0],
               what=f"pos {pos}")
    # past the cap the step reads row 447 and no other
    for row, moves in ((447, True), (446, False)):
        dec_pos = pt["dec_pos"].clone()
        dec_pos[row] = 0
        changed = port_step({**pt, "dec_pos": dec_pos}, 500)
        assert torch.equal(changed, port_step(pt, 500)) != moves, row


def test_prefill_step_matches_reference(whisper):
    """build_prefill_step encodes the frames, then the decoder: the
    last position's logits within 1e-5; its abstract batch caps the
    decoder at max_decoder_len, as the reference's."""
    w = whisper
    batch = {"frames": w["frames"], "tokens": w["tokens"]}
    jb = jsteps.build_prefill_step(w["jcfg"], make_host_mesh(1, 1),
                                   jsteps.InputShape("p", "prefill", S, B))
    want = jax.jit(jb.fn)(w["pj"], {k: jnp.asarray(v)
                                    for k, v in batch.items()})
    tb = steps.build_prefill_step(w["tcfg"], None,
                                  steps.InputShape("p", "prefill", S, B))
    got = tb.fn(w["pt"], {k: T(v) for k, v in batch.items()})
    _close(got, want)
    abs_ = steps.train_batch_abstract(w["tcfg"],
                                      steps.INPUT_SHAPES["train_4k"])
    jabs = jsteps.train_batch_abstract(w["jcfg"],
                                       jsteps.INPUT_SHAPES["train_4k"])
    assert {k: tuple(v.shape) for k, v in abs_.items()} == \
        {k: v.shape for k, v in jabs.items()}
    assert abs_["tokens"].shape[1] == 448


def test_teacher_forced_decode_matches_forward(whisper):
    """decode_step fed the tokens one at a time (the kernel route, its
    plain version here) reproduces forward's logits within 1e-5."""
    w = whisper
    tm, pt = w["tm"], w["pt"]
    frames, tokens = T(w["frames"]), T(w["tokens"])
    with torch.no_grad():
        want, _ = tm.forward(pt, tokens, frames)
        state = tm.init_decode_state(B, S, frames=frames, params=pt)
        outs = []
        for t in range(S):
            lg, state = tm.decode_step(pt, state, tokens[:, t:t + 1])
            outs.append(lg[:, 0])
    _close(torch.stack(outs, 1), want)
