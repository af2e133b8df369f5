"""The MLP activations of the port against the reference's, in bf16.

``jax.nn.silu`` and ``jax.nn.gelu`` round every step to the input's
dtype where XLA runs them on the CPU; ``repro_torch.models.layers.silu``
and ``gelu`` do the same, so the dense and gelu MLPs
(``layers.apply_mlp``, and ``apply_mlp_sharded`` on a rank's shards)
equal the reference's ``apply_mlp`` bit for bit in bf16, from the same
seeded numpy inputs. ``F.silu`` / ``F.gelu(approximate="tanh")``, which
round once, are the controls: they differ on most inputs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.models import layers as jlayers
from repro_torch import compat, convert
from repro_torch.models import layers

D, FF = 32, 48


def _bf16(a: np.ndarray):
    """numpy f32 → (the JAX bf16 array, the torch bf16 tensor) holding the
    same values."""
    j = jnp.asarray(a, jnp.bfloat16)
    t = convert.tensor_from_numpy(np.asarray(j.astype(jnp.float32))).to(
        torch.bfloat16)
    return j, t


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return convert.to_numpy(x.float())
    return np.asarray(jnp.asarray(x, jnp.float32))


def _share_equal(a, b) -> float:
    return float(np.mean(_np(a) == _np(b)))


@pytest.mark.parametrize("name", ["silu", "gelu"])
def test_activation_is_jax_bit_for_bit_in_bfloat16(name):
    """2¹⁸ N(0, 9) bf16 inputs: every output equal to jitted JAX's; the
    one-rounding torch function (the control) matches far fewer."""
    x = (np.random.default_rng(3).standard_normal(1 << 18) * 3).astype(
        np.float32)
    xj, xt = _bf16(x)
    want = jax.jit(getattr(jax.nn, name))(xj)
    got = getattr(layers, name)(xt)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(got), _np(want))
    control = F.silu(xt) if name == "silu" else F.gelu(xt,
                                                       approximate="tanh")
    assert _share_equal(control, want) < 0.8


def test_activations_in_float32_match_jax():
    x = (np.random.default_rng(4).standard_normal(4096) * 3).astype(
        np.float32)
    for name in ("silu", "gelu"):
        want = np.asarray(jax.jit(getattr(jax.nn, name))(jnp.asarray(x)))
        got = getattr(layers, name)(torch.from_numpy(x))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def _mlp_inputs(style: str, seed: int):
    rng = np.random.default_rng(seed)
    tpl = jlayers.mlp_template(D, FF, style)
    p = {}
    for k, spec in tpl.items():
        fan_in = spec.shape[0] if len(spec.shape) == 2 else 1
        p[k] = (rng.normal(size=spec.shape) / np.sqrt(fan_in)).astype(
            np.float32)
    x = rng.normal(size=(2, 24, D)).astype(np.float32)
    return p, x


@pytest.mark.parametrize("style", ["swiglu", "gelu"])
def test_apply_mlp_is_the_reference_bit_for_bit_in_bfloat16(style):
    """Both MLP styles at d 32, ffn 48, 48 tokens: y equal to the
    reference's ``apply_mlp`` bit for bit; the same MLP with the
    one-rounding activation (the control) is not."""
    p, x = _mlp_inputs(style, seed=11)
    pj, pt = {}, {}
    for k, v in p.items():
        pj[k], pt[k] = _bf16(v)
    xj, xt = _bf16(x)
    want = jax.jit(lambda p, x: jlayers.apply_mlp(x, p, style))(pj, xj)
    got = layers.apply_mlp(xt, pt, style)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == x.shape
    np.testing.assert_array_equal(_np(got), _np(want))
    if style == "swiglu":
        control = (F.silu(xt @ pt["w_gate"]) * (xt @ pt["w_up"])) \
            @ pt["w_down"]
    else:
        control = F.gelu(xt @ pt["w_in"] + pt["b_in"],
                         approximate="tanh") @ pt["w_out"] + pt["b_out"]
    assert _share_equal(control, want) < 0.9


@pytest.mark.parametrize("style", ["swiglu", "gelu"])
def test_sharded_mlp_on_one_rank_is_apply_mlp(style):
    """``apply_mlp_sharded`` on a 1 × 1 mesh (the leaves whole, ffn over
    model) runs the same bf16 activation as ``apply_mlp``: bit for bit
    with its own products (torch's ``@``) through
    ``layers.mlp_activation``, and not with ``F.silu`` / ``F.gelu`` (the
    control)."""
    p, x = _mlp_inputs(style, seed=12)
    pt = {k: _bf16(v)[1] for k, v in p.items()}
    xt = _bf16(x)[1]
    mesh = compat.rank_mesh(("data", "model"), (1, 1))
    place = {k: (None,) * (len(v.shape) - 1) + ("model",)
             if k in ("w_gate", "w_up", "w_in", "b_in")
             else ("model", None) if k in ("w_down", "w_out")
             else (None,) for k, v in p.items()}
    got = layers.apply_mlp_sharded(xt, pt, place, style, mesh)

    def mlp(act):
        if style == "swiglu":
            return (act(xt @ pt["w_gate"]) * (xt @ pt["w_up"])) \
                @ pt["w_down"]
        return act(xt @ pt["w_in"] + pt["b_in"]) @ pt["w_out"] + pt["b_out"]
    np.testing.assert_array_equal(_np(got), _np(mlp(
        lambda h: layers.mlp_activation(h, style))))
    one = F.silu if style == "swiglu" else \
        (lambda h: F.gelu(h, approximate="tanh"))
    assert _share_equal(got, mlp(one)) < 0.9
