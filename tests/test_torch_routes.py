"""Host-side logic of the tensor-core routes of ``gram`` and
``hinge_scores``, on the CPU: the three-plane split of W, the plain
emulation of the ``hinge_scores`` tensor-core arithmetic against the
plain version and the JAX package's Pallas kernel (interpret mode, as
its own tests run it), and the wrappers' "same rows" rule that selects
the symmetric Gram. The CUDA kernels run only on a card;
``chip_smoke.py`` holds them against the plain versions there."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import risk_eval
from repro_torch import sparse
from repro_torch.kernels import hinge_score, ops, ref


def _extreme_w(rng, L, d):
    """Entries of magnitudes log-uniform in [1e-30, 1e3], either sign."""
    mag = 10.0 ** rng.uniform(-30.0, 3.0, size=(L, d))
    return (rng.normal(size=(L, d)) * mag).astype(np.float32)


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("extreme", [False, True])
def test_three_planes_sum_back_to_w_exactly(seed, extreme):
    rng = np.random.default_rng(seed)
    W = _extreme_w(rng, 8, 4096) if extreme else \
        rng.normal(size=(8, 4096)).astype(np.float32)
    Wt = torch.from_numpy(W)
    planes = hinge_score.split_planes(Wt)
    assert planes.dtype == torch.bfloat16 and planes.shape == (3, 8, 4096)
    p = planes.float()
    assert torch.equal((p[0] + p[1]) + p[2], Wt)


def test_three_planes_of_edge_values():
    W = torch.tensor([[0.0, -0.0, 1.0, -1.0, 3.0e38, -3.0e38, 1e-30, -1e-30,
                       1.0 + 2.0 ** -23, 0.1, 1e3, 7.0e-20]])
    p = hinge_score.split_planes(W).float()
    assert torch.equal((p[0] + p[1]) + p[2], W)
    # the first plane alone is the bf16 rounding, which loses bits here
    assert not torch.equal(p[0], W)


def test_fragment_columns_follow_the_mma_layout():
    """Lane t's A and B registers of a 32-column step hold columns
    8t .. 8t + 7; MMA h takes registers 2h and 2h + 1, which the
    m16n8k16 layout reads as logical k ∈ {2t, 2t + 1} and {2t + 8,
    2t + 9}."""
    cols = hinge_score.fragment_columns()
    assert sorted(cols.tolist()) == list(range(32))
    for h in (0, 1):
        for t in range(4):
            logical = [2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9]
            assert [int(cols[16 * h + k]) for k in logical] == \
                list(range(8 * t + 4 * h, 8 * t + 4 * h + 4))


@pytest.mark.parametrize("n,d,L", [(100, 24, 1), (63, 1001, 5),
                                   (65, 4096, 8), (300, 4100, 3)])
def test_emulated_tensor_core_route_matches_plain_and_pallas(n, d, L):
    """bf16 rows; W with extreme magnitudes; d past one 2048-column slab
    and not a multiple of 32. rtol 1e-5: float32 sums in another
    order."""
    rng = np.random.default_rng(n * d + L)
    Xb = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)) \
        .to(torch.bfloat16)
    W = _extreme_w(rng, L, d)
    b = rng.normal(size=L).astype(np.float32)
    y = np.sign(rng.normal(size=n)).astype(np.float32)
    m = (rng.random(n) > 0.25).astype(np.float32)
    args = (Xb, *(torch.from_numpy(a) for a in (W, b, y, m)))
    loss, cnt = hinge_score.emulate_tc(*args)
    loss_p, cnt_p = ref.hinge_scores_ref(*args)
    np.testing.assert_allclose(loss.numpy(), loss_p.numpy(), rtol=1e-5)
    assert float(cnt) == float(cnt_p)
    Xf = Xb.float().numpy()
    loss_j, cnt_j = risk_eval(*(jnp.asarray(a) for a in (Xf, W, b, y, m)),
                              bn=128)
    np.testing.assert_allclose(loss.numpy(), np.asarray(loss_j), rtol=1e-5)
    assert float(cnt) == float(cnt_j)


def test_emulated_route_sums_slabs_before_the_hinge():
    """A row whose slabs' scores cancel: the hinge of the sum is 0, the
    sum of the slabs' hinges would not be."""
    d = 2 * hinge_score.SLAB_COLS
    X = torch.zeros((1, d), dtype=torch.bfloat16)
    X[0, 0], X[0, -1] = 1.0, 1.0
    W = torch.zeros((1, d))
    W[0, 0], W[0, -1] = 5.0, -3.0         # slab scores 5 and -3: sum 2
    one = torch.ones(1)
    loss, _ = hinge_score.emulate_tc(X, W, torch.zeros(1), one, one)
    assert float(loss) == 0.0
    assert float(ref.hinge_scores_ref(X, W, torch.zeros(1), one, one)[0]) \
        == 0.0


def test_same_rows_rule():
    X = torch.randn(6, 16)
    H, S = torch.randn(2, 5, 16), torch.randn(3, 16)
    assert ops.same_rows(X, X)
    assert ops.same_rows(X, X.view(6, 16))          # another view, same rows
    assert ops.same_rows((H, S), (H, S))
    assert ops.same_rows((H, S), (H[:], S[:]))
    assert not ops.same_rows(X, X.clone())           # equal values
    assert not ops.same_rows((H, S), (H.clone(), S))
    assert not ops.same_rows((H, S), (H, S.clone()))
    assert not ops.same_rows(X, X[1:])               # another offset
    assert not ops.same_rows(X[:3], X[1:4])
    assert not ops.same_rows(X[:, :8], X[:, 8:])
    Y = torch.randn(16, 6).T                         # another stride
    assert not ops.same_rows(Y, Y.contiguous())
    assert not ops.same_rows(X[::2], X[:3])
    assert not ops.same_rows(X, (X[None], X[:0]))    # a pair vs a batch
    assert not ops.same_rows(X, X.to(torch.bfloat16))


def test_routes_count_no_launch_on_cpu():
    ops.reset_launches()
    X = torch.randn(4, 8)
    ops.gram(X, X, kind="rbf")
    ops.hinge_scores(X.to(torch.bfloat16), torch.ones((2, 8)),
                     torch.zeros(2), torch.ones(4), torch.ones(4))
    Xs = sparse.from_dense(X, 3)
    ops.hinge_scores(Xs, torch.ones((2, 8)), torch.zeros(2), torch.ones(4),
                     torch.ones(4))
    ops.cd_solve(Xs[None], Xs[:0], torch.ones((1, 4)), torch.ones((1, 4)),
                 C=1.0, tol=1e-3, max_epochs=2)
    assert set(ops.ROUTE_LAUNCHES) == {
        "gram/tensor_core", "gram/simt", "hinge_scores/tensor_core",
        "hinge_scores/simt", "flash_decode/tensor_core", "flash_decode/simt",
        "cd_solve/cluster", "cd_solve/single", "cd_solve_gram/cluster",
        "cd_solve_gram/single", "sparse_gram/gram", "sparse_gram/scores",
        "cd_solve/sparse", "hinge_scores/sparse"}
    assert not any(ops.ROUTE_LAUNCHES.values())
    assert not any(ops.LAUNCHES.values())
