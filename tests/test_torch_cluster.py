"""Host side of the two redesigned kernels, on the CPU: the cluster
route of ``cd_solve`` (the rule that picks the cluster size, and a plain
emulation of its sum order against the plain solve) and the tensor-core
route of ``flash_decode`` (the two bf16 planes of P, and a plain
emulation of its arithmetic against the plain version and the JAX
package's Pallas kernel in interpret mode, as its own tests run it).
The CUDA kernels run only on a card; ``chip_smoke.py`` holds them
against the plain versions there."""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import decode_attention as j_decode_attention
from repro_torch.kernels import ops, ref, svm_step
from torch_threads import one_thread  # noqa: F401

# the module, not the package's ``decode_attention`` wrapper function
fd = importlib.import_module("repro_torch.kernels.decode_attention")
BF16 = torch.bfloat16


# ---------------------------------------------------------------------------
# cd_solve: the cluster route
# ---------------------------------------------------------------------------

def test_cluster_size_rule():
    # golden test shape (96 + 128 rows, d 1024 f32): one CTA
    assert ops.cd_solve_cluster_size(224, 1024, torch.float32) == 1
    # svm-tfidf full width: 8192 + 2048 rows of 131072 bf16; also the
    # final fit's 2048 rows: 8 CTAs' registers hold w
    assert ops.cd_solve_cluster_size(10240, 131072, BF16) == 8
    assert ops.cd_solve_cluster_size(2048, 131072, BF16) == 8
    assert ops.cd_solve_cluster_size(64, 65536, BF16) == 4
    assert ops.cd_solve_cluster_size(64, 65536, torch.float32) == 8
    # one row takes the cluster route too (its α step needs its own sync)
    assert ops.cd_solve_cluster_size(1, 65536, torch.float32) == 8
    # α of more rows than 8 CTAs' shared memory holds: 16 CTAs (smaller
    # rings), and past that the single route
    assert ops.cluster_smem(131072, 30000, 8, BF16) > ops.CLUSTER_SMEM
    assert ops.cd_solve_cluster_size(30000, 131072, BF16) == 16
    assert ops.cd_solve_cluster_size(60000, 131072, BF16) == 1
    # rows of no whole 16-byte vectors, no rows, or w too wide for 16 CTAs
    assert ops.cd_solve_cluster_size(224, 131071, BF16) == 1
    assert ops.cd_solve_cluster_size(0, 131072, BF16) == 1
    assert ops.cd_solve_cluster_size(64, 16 * 16384 + 8, BF16) == 1
    for n, d, dt in ((10240, 131072, BF16), (80, 65536, torch.float32)):
        c = ops.cd_solve_cluster_size(n, d, dt)
        assert c & (c - 1) == 0 and c * svm_step.cluster_slice_cols(
            d, c, dt) >= d


def _jobs(L, per, S, d, dtype, seed):
    rng = np.random.default_rng(seed)
    X = rng.random((L * per + S, d)) * (rng.random((L * per + S, d)) < 0.05)
    X /= np.maximum(np.linalg.norm(X, axis=1, keepdims=True), 1e-9)
    X = torch.from_numpy(X.astype(np.float32)).to(dtype)
    y = torch.from_numpy(np.sign(rng.normal(size=L * per + S))
                         .astype(np.float32))
    y_aug = torch.cat([y[:L * per].reshape(L, per),
                       y[L * per:].expand(L, S)], 1).contiguous()
    m = torch.from_numpy((rng.random(y_aug.shape) > 0.1).astype(np.float32))
    return X[:L * per].reshape(L, per, d), X[L * per:], y_aug, m


@pytest.mark.parametrize("dtype,d,c,per,S", [(torch.float32, 1024, 2, 40, 16),
                                             (torch.float32, 2048, 4, 40, 16),
                                             (BF16, 2048, 2, 40, 16),
                                             (torch.float32, 1024, 2, 1, 0)])
def test_emulated_cluster_solve_matches_plain(dtype, d, c, per, S):
    """c column slices, partials added in rank order: the plain solve
    to float32 rounding (atol 1e-5), the same epochs, and bit-identical
    reruns; also with one row a job."""
    assert -(-d // svm_step.cluster_slice_cols(d, c, dtype)) == c
    xh, xs, y, m = _jobs(3, per, S, d, dtype, seed=d + c)
    kw = dict(C=1.0, tol=1e-3, max_epochs=6)
    emu = svm_step.emulate_cluster(xh, xs, y, m, cluster=c, **kw)
    plain = ref.cd_solve_ref(xh, xs, y, m, **kw)
    assert torch.equal(emu[3], plain[3])
    for a, p in zip(emu[:3], plain[:3]):
        np.testing.assert_allclose(a.numpy(), p.numpy(), atol=1e-5)
    again = svm_step.emulate_cluster(xh, xs, y, m, cluster=c, **kw)
    assert all(torch.equal(a, b) for a, b in zip(emu, again))


def test_cd_solve_counts_no_route_on_cpu():
    xh, xs, y, m = _jobs(2, 8, 4, 64, torch.float32, seed=1)
    ops.reset_launches()
    ops.cd_solve(xh, xs, y, m, C=1.0, tol=1e-3, max_epochs=2)
    assert ops.ROUTE_LAUNCHES["cd_solve/cluster"] == 0
    assert ops.ROUTE_LAUNCHES["cd_solve/single"] == 0
    assert ops.LAUNCHES["cd_solve"] == 0


# ---------------------------------------------------------------------------
# flash_decode: the tensor-core route
# ---------------------------------------------------------------------------

def test_p_planes_keep_p_to_2_pow_minus_16():
    rng = np.random.default_rng(0)
    p = np.concatenate([
        [0.0, 1.0, 0.5, 1.0 - 2.0 ** -24, 2.0 ** -118, 2.0 ** -126,
         1e-38, 1e-40, 1e-45],
        rng.random(4096), np.exp(-rng.random(4096) * 80.0)]).astype(
            np.float32)
    pt = torch.from_numpy(p)
    hi, lo = fd.split_p(pt)
    assert hi.dtype == BF16 and lo.dtype == BF16
    back = hi.float() + lo.float()
    err = (back - pt).abs()
    assert float(back[0]) == 0.0 and float(back[1]) == 1.0
    assert float(hi[1]) == 1.0 and float(lo[1]) == 0.0
    # relative 2⁻¹⁶ while lo is a normal bf16 number; below 2⁻¹¹⁸ lo is
    # subnormal, and the error is at most half its spacing, 2⁻¹³⁴
    normal = pt >= 2.0 ** -118
    assert bool((err[normal] <= 2.0 ** -16 * pt[normal]).all())
    assert bool((err[~normal] <= 2.0 ** -134).all())
    # one plane alone keeps only 2⁻⁹
    one = (hi.float() - pt).abs()
    assert float((one / pt.clamp_min(1e-30))[normal].max()) > 2.0 ** -12


def _qkv(B, H, KV, S, hd, seed, q_scale=1.0):
    rng = np.random.default_rng(seed)
    q = q_scale * rng.normal(size=(B, H, hd))
    k = 4.0 * rng.normal(size=(B, KV, S, hd))
    v = rng.normal(size=(B, KV, S, hd))
    return (torch.from_numpy(a.astype(np.float32)).to(BF16)
            for a in (q, k, v))


def _rel_max(a, b):
    a, b = a.float(), b.float()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


@pytest.mark.parametrize("B,H,KV,S,hd", [(1, 4, 4, 128, 64),
                                         (2, 16, 2, 1024, 64),
                                         (1, 8, 2, 9664, 128)])
@pytest.mark.parametrize("vlen", ["zero", "one", "partial", "full"])
def test_emulated_two_plane_route_matches_plain_and_pallas(B, H, KV, S, hd,
                                                           vlen):
    """bf16 rows, keys N(0, 16) (a peaked softmax); the last shape has
    three chunks of the route's 4096 rows, the last one ragged. Against the plain version: 8e-3 of max |plain|
    (chip_smoke's FD_TOL: both round one f32 value to bf16); against the
    Pallas kernel: 3e-2 (tests/test_kernels.py:67)."""
    valid = {"zero": 0, "one": 1, "partial": S - S // 4 - 3, "full": S}[vlen]
    q, k, v = _qkv(B, H, KV, S, hd, seed=S + hd, q_scale=0.25)
    vl = torch.tensor(valid, dtype=torch.int32)
    emu = fd.emulate_tc(q, k, v, vl)
    assert emu.dtype == BF16 and emu.shape == (B, H, hd)
    assert _rel_max(emu, ref.decode_attention_ref(q, k, v, vl)) <= 8e-3
    out_j = j_decode_attention(*(jnp.asarray(t.float().numpy(), jnp.bfloat16)
                                 for t in (q, k, v)),
                               jnp.asarray(valid, jnp.int32), bs=64)
    np.testing.assert_allclose(emu.float().numpy(),
                               np.asarray(out_j.astype(jnp.float32)),
                               rtol=3e-2, atol=3e-2)


def test_two_planes_keep_the_f32_semantics():
    """In f32 (no final bf16 rounding) the two-plane P · V equals the
    plain version to 1e-5 of max |plain|; one plane would not."""
    q, k, v = (t.float() for t in _qkv(2, 8, 2, 5000, 64, seed=7))
    vl = torch.tensor(4500, dtype=torch.int32)
    plain = ref.decode_attention_ref(q, k, v, vl)
    assert _rel_max(fd.emulate_tc(q, k, v, vl), plain) <= 1e-5
    hi_only = fd.split_p
    try:
        fd.split_p = lambda p: (p.to(BF16), torch.zeros_like(p, dtype=BF16))
        assert _rel_max(fd.emulate_tc(q, k, v, vl), plain) > 1e-5
    finally:
        fd.split_p = hi_only


def test_decode_route_rule_and_no_launch_on_cpu():
    assert ops.decode_route(BF16, 64) == "tensor_core"
    assert ops.decode_route(BF16, 16) == "tensor_core"
    assert ops.decode_route(BF16, 128) == "tensor_core"
    assert ops.decode_route(BF16, 136) == "simt"     # past 128
    assert ops.decode_route(BF16, 72) == "simt"      # not a multiple of 16
    assert ops.decode_route(torch.float32, 64) == "simt"
    q, k, v = _qkv(1, 4, 2, 64, 32, seed=3)
    ops.reset_launches()
    ops.decode_attention(q, k, v, torch.tensor(40, dtype=torch.int32))
    assert ops.LAUNCHES["flash_decode"] == 0
    assert ops.ROUTE_LAUNCHES["flash_decode/tensor_core"] == 0
    assert ops.ROUTE_LAUNCHES["flash_decode/simt"] == 0
