"""Host side of the redesigned blocked-CSR kernels on the linear path
(``cd_solve/sparse`` and ``hinge_scores/sparse``), on the CPU: the
look-ahead of the sparse solve emulated in plain PyTorch (its window
table, stale reads replaced by what the window's rows left, the skips)
against the plain version bit for bit and against the JAX reference; the
hinge kernel's reduction order against the plain version; the mark that
spares a checked batch of rows the column-id round trip; and
``init_sv_buffer``'s device. The CUDA kernels run only on a card;
``chip_smoke.py`` holds them to these emulations there, bit for bit.

Tolerances: the emulation in the plain version's sum order must equal
it exactly; in the kernel's order it sums w·x otherwise, so α, w and b
agree to float32 rounding carried through the epochs (atol 1e-5, as
``tests/test_torch_sparse_linear.py``); the hinge sums to 1e-5
relative."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
from repro import sparse as jsp
from repro.core.svm import fit_binary_linear as j_fit_binary_linear
import repro_torch.core as T
from repro_torch import sparse as tsp
from repro_torch import text as ttext
from repro_torch.kernels import hinge_score, ops, ref, svm_step


def _rows(n_rows, d, cap, rng, *, same=False, shuffled=False, col0=True):
    """Row-normalised rows of up to ``cap`` nonzeros: random columns, or
    (``same``) every row on the same columns, at the same slots or
    (``shuffled``) each row in its own slot order; every third row holds
    a real column 0 beside its padding when ``col0``."""
    base = rng.choice(np.arange(1, d), cap - 1, replace=False)
    idx = np.zeros((n_rows, cap), np.int32)
    val = np.zeros((n_rows, cap), np.float32)
    for i in range(n_rows):
        if same:
            cols = np.concatenate([[0], base]) if col0 else base
            k = len(cols)
            if shuffled:
                cols = rng.permutation(cols)
        else:
            k = int(rng.integers(1, cap + 1))
            cols = rng.choice(np.arange(1, d), k, replace=False)
            if col0 and i % 3 == 0:
                cols[0] = 0
        idx[i, :k] = cols
        val[i, :k] = rng.random(k) + 0.05
    val /= np.linalg.norm(val, axis=1, keepdims=True)
    return tsp.SparseRows(torch.from_numpy(idx), torch.from_numpy(val), d)


def _problem(L, per, S, d, cap, seed, *, dead=False, masked=0.2, **kw):
    """L jobs of per home rows and S shared rows (``dead``: every other
    shared row's values 0 with its ids kept, as SV_global's dead slots),
    labels from a random separator, masked rows."""
    rng = np.random.default_rng(seed)
    rows = _rows(L * per + S, d, cap, rng, **kw)
    if dead and S:
        live = torch.ones((L * per + S, 1))
        live[L * per::2] = 0.0
        rows = rows * live
    xh = rows[:L * per].reshape(L, per, d)
    xs = rows[L * per:]
    y = np.where(tsp.to_dense(rows).numpy() @ rng.normal(size=d) >= 0,
                 1.0, -1.0).astype(np.float32)
    y_aug = np.concatenate([y[:L * per].reshape(L, per),
                            np.broadcast_to(y[L * per:], (L, S))], 1)
    m_aug = (rng.random((L, per + S)) > masked).astype(np.float32)
    return xh, xs, torch.from_numpy(y_aug), torch.from_numpy(m_aug)


# overlap cases: random rows; every row on the same columns, at the same
# slots and at other slots; dead SV slots; a window longer than the rows
# (n = 3 and n = 1); rows whose Δ is 0 inside the window (masked rows,
# and a converged solve that runs on with Δ = 0 almost everywhere)
OVERLAP_CASES = {
    "random": dict(L=3, per=40, S=12, d=48, cap=6, seed=0),
    "same ids, same slots": dict(L=2, per=30, S=6, d=64, cap=8, seed=1,
                                 same=True),
    "same ids, other slots": dict(L=2, per=30, S=6, d=64, cap=8, seed=2,
                                  same=True, shuffled=True),
    "dead SV slots": dict(L=3, per=20, S=16, d=32, cap=5, seed=3,
                          dead=True),
    "window longer than n": dict(L=2, per=2, S=1, d=16, cap=4, seed=4),
    "one row": dict(L=2, per=1, S=0, d=16, cap=4, seed=5, same=True),
    "Δ = 0 inside the window": dict(L=2, per=30, S=4, d=24, cap=6, seed=6,
                                    masked=0.6),
}


@pytest.mark.parametrize("case", OVERLAP_CASES, ids=str)
def test_lookahead_emulation_equals_plain_solve_bit_for_bit(case):
    """Stale gathers corrected from the window's records give exactly the
    plain version's α, w, b, epochs and violation; without the
    corrections the overlap cases drift."""
    xh, xs, y, m = _problem(**OVERLAP_CASES[case])
    kw = dict(C=1.0, tol=1e-3, max_epochs=12)
    plain = ref.cd_solve_sparse_ref(xh, xs, y, m, **kw)
    emu = svm_step.emulate_sparse_lookahead(xh, xs, y, m, **kw,
                                            order="plain")
    for a, b in zip(plain, emu, strict=True):
        assert torch.equal(a, b)
    stale = svm_step.emulate_sparse_lookahead(xh, xs, y, m, **kw,
                                              order="plain", correct=False)
    assert not all(torch.equal(a, b) for a, b in zip(plain[:3], stale[:3]))


def test_lookahead_converged_steps_leave_w_alone():
    """A solve run on past convergence: most later steps have Δ = 0 and
    store nothing, the emulation still equals the plain version."""
    xh, xs, y, m = _problem(L=2, per=40, S=8, d=32, cap=6, seed=7)
    kw = dict(C=1.0, tol=-1.0, max_epochs=40)        # never stops early
    plain = ref.cd_solve_sparse_ref(xh, xs, y, m, **kw)
    emu = svm_step.emulate_sparse_lookahead(xh, xs, y, m, **kw,
                                            order="plain")
    assert all(torch.equal(a, b) for a, b in zip(plain, emu))
    assert int(plain[3][0]) == 40


@pytest.mark.parametrize("ahead", [1, 2, 4, 6])
def test_lookahead_depths_all_equal_plain(ahead):
    xh, xs, y, m = _problem(L=2, per=25, S=5, d=20, cap=6, seed=8,
                            same=True, shuffled=True)
    kw = dict(C=1.0, tol=1e-3, max_epochs=6)
    plain = ref.cd_solve_sparse_ref(xh, xs, y, m, **kw)
    emu = svm_step.emulate_sparse_lookahead(xh, xs, y, m, **kw,
                                            ahead=ahead, order="plain")
    assert all(torch.equal(a, b) for a, b in zip(plain, emu))


@pytest.mark.parametrize("n,ahead,want", [(1, 4, 1), (2, 4, 1), (3, 4, 2),
                                          (5, 4, 4), (10240, 4, 4),
                                          (100, 1, 1)])
def test_lookahead_depth_rule(n, ahead, want):
    assert svm_step.sparse_lookahead(n, ahead) == want


def _table_brute_force(ids, live, k):
    n, cap = ids.shape
    out = np.zeros((n, cap), np.int64)
    for i in range(n):
        for s in range(cap):
            if not live[i, s]:
                continue
            for delta in range(1, k + 1):
                j = (i - delta) % n
                hit = [t for t in range(cap)
                       if live[j, t] and ids[j, t] == ids[i, s]]
                if hit:
                    out[i, s] = (delta << svm_step.SPARSE_SLOT_BITS) | hit[0]
                    break
    return out


@pytest.mark.parametrize("k", [1, 3, 4])
@pytest.mark.parametrize("kind", ["random", "same", "shuffled"])
def test_lookahead_table_matches_brute_force(kind, k):
    rng = np.random.default_rng(k)
    rows = _rows(9, 12, 5, rng, same=kind != "random",
                 shuffled=kind == "shuffled")
    ids, live = rows.indices.long(), rows.values != 0
    got = svm_step.lookahead_table(ids, live, k)
    want = _table_brute_force(ids.numpy(), live.numpy(), k)
    np.testing.assert_array_equal(got.numpy(), want)
    if kind != "random":            # every live slot finds the row before
        assert bool((got[live] >> svm_step.SPARSE_SLOT_BITS == 1).all())


@pytest.mark.parametrize("cap", [1, 7, 32, 33, 256, 300, 512])
def test_kernel_order_sum_is_the_cta_order(cap):
    """Thread t adds slots t, t + 32W in turn, a warp pairs its lanes by
    xor shuffles, the warps add in order: the sum as a Python loop."""
    rng = np.random.default_rng(cap)
    p = torch.from_numpy(rng.normal(size=(3, cap)).astype(np.float32))
    live = torch.from_numpy(rng.random((3, cap)) > 0.2)
    got = svm_step._kernel_order_sum(p, live)
    warps = min(8, -(-cap // 32))
    threads = 32 * warps
    for r in range(3):
        lane_sums = []
        for t in range(threads):
            acc = np.float32(0)
            for s in range(t, cap, threads):
                if live[r, s]:
                    acc = np.float32(acc + p[r, s].numpy())
            lane_sums.append(acc)
        total = np.float32(0)
        for w in range(warps):
            lanes = lane_sums[32 * w:32 * w + 32]
            while len(lanes) > 1:
                half = len(lanes) // 2
                lanes = [np.float32(a + b) for a, b in
                         zip(lanes[:half], lanes[half:])]
            total = np.float32(total + lanes[0])
        assert float(got[r]) == float(total)
    torch.testing.assert_close(got, (p * live).sum(-1), atol=1e-5, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seed", [0, 1])
def test_lookahead_kernel_order_matches_reference(dtype, seed):
    """The kernel's arithmetic (look-ahead, corrections and its sum
    order) against the JAX reference's jitted ``fit_binary_linear`` on
    the same blocked-CSR rows: α, w, b within 1e-5, epochs equal."""
    rng = np.random.default_rng(seed)
    rows = _rows(150, 40, 8, rng, same=seed == 1, shuffled=True)
    y = np.where(tsp.to_dense(rows).numpy() @ rng.normal(size=40) >= 0,
                 1.0, -1.0).astype(np.float32)
    m = (rng.random(150) > 0.15).astype(np.float32)
    Xj = jsp.SparseRows(jnp.asarray(rows.indices.numpy()),
                        jnp.asarray(rows.values.numpy()), 40)
    if dtype == "bfloat16":
        Xj = jsp.SparseRows(Xj.indices, Xj.values.astype(jnp.bfloat16), 40)
        rows = rows.to(dtype=torch.bfloat16)
    svm = dict(C=1.0, max_epochs=10, tol=1e-3)
    fit = jax.jit(j_fit_binary_linear, static_argnums=3)
    jr = fit(Xj, jnp.asarray(y), jnp.asarray(m), J.SVMConfig(**svm))
    emu = svm_step.emulate_sparse_lookahead(
        rows[None], rows[:0], torch.from_numpy(y)[None],
        torch.from_numpy(m)[None], C=1.0, tol=1e-3, max_epochs=10)
    assert int(emu[3][0]) == int(jr.epochs_run)
    for a, b in ((emu[0][0], jr.alpha), (emu[1][0], jr.w), (emu[2][0], jr.b)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5,
                                   rtol=0)


@pytest.mark.parametrize("L", [1, 3, 8])
@pytest.mark.parametrize("cap,dtype", [(7, torch.float32),
                                       (32, torch.bfloat16),
                                       (300, torch.float32)])
def test_hinge_emulation_matches_plain(cap, dtype, L):
    """The sparse hinge kernel's order (8 slots a lane a chunk, the
    9-shuffle reduce-scatter's pairwise tree, rows a warp, warps a CTA,
    the last CTA's sum of the partials) against the plain version, with
    W from 1e-30 to 1e3, a masked row set, and n not a multiple of the
    64-row tile."""
    rng = np.random.default_rng(cap + L)
    n, d = 1000, 4096
    rows = _rows(n, d, cap, rng).to(dtype=dtype)
    W = torch.from_numpy((rng.normal(size=(L, d))
                          * 10.0 ** rng.uniform(-30, 3, size=(L, d))
                          ).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=L).astype(np.float32))
    y = torch.from_numpy(np.where(rng.random(n) > 0.5, 1.0, -1.0)
                         .astype(np.float32))
    m = torch.from_numpy((rng.random(n) > 0.25).astype(np.float32))
    lp, cp = ref.hinge_scores_ref(rows, W, b, y, m)
    le, ce = hinge_score.emulate_sparse(rows, W, b, y, m)
    assert float(ce) == float(cp)
    torch.testing.assert_close(le, lp, rtol=1e-5, atol=0)


def test_hinge_emulation_of_no_rows():
    rows = tsp.SparseRows(torch.zeros((0, 8), dtype=torch.int32),
                          torch.zeros((0, 8)), 64)
    loss, cnt = hinge_score.emulate_sparse(rows, torch.ones((2, 64)),
                                           torch.ones(2), torch.ones(0),
                                           torch.ones(0))
    assert torch.equal(loss, torch.zeros(2)) and float(cnt) == 0.0


def test_hinge_takes_w_as_the_sparse_solve_returns_it():
    """W as a strided view of a (d, 8) array (hypotheses adjacent, as
    ``cd_solve/sparse`` returns it) gives the contiguous W's losses; the
    kernel reads it as it is, and the wrapper packs a contiguous W or a
    view whose last column cannot hold 8 readable floats."""
    rng = np.random.default_rng(3)
    rows = _rows(200, 64, 6, rng)
    W = torch.from_numpy(rng.normal(size=(5, 64)).astype(np.float32))
    buf = torch.zeros((64, 8))
    buf[:, :5] = W.T
    Wv = buf[:, :5].T
    y = torch.ones(200)
    args = (torch.zeros(5), y, y)
    assert torch.equal(ops.hinge_scores(rows, Wv, *args)[0],
                       ops.hinge_scores(rows, W, *args)[0])
    assert hinge_score.is_packed(Wv) and not hinge_score.is_packed(W)
    tight = torch.zeros(63 * 8 + 5)
    short = tight.as_strided((5, 64), (1, 8))
    assert not hinge_score.is_packed(short)


@pytest.mark.parametrize("L", [1, 5, 8])
def test_pack_gives_the_packed_layout_of_the_same_weights(L):
    """What the wrapper does with a W the kernel cannot read as it is:
    the same floats in a (d, 8) array, hypotheses adjacent."""
    W = torch.from_numpy(np.random.default_rng(L).normal(
        size=(L, 40)).astype(np.float32))
    Wp = hinge_score.pack(W)
    assert hinge_score.is_packed(Wp) and Wp.stride() == (1, 8)
    assert torch.equal(Wp, W)


# -- the column-id mark -------------------------------------------------------

def _marked(n=12, d=32, cap=4, seed=0):
    rows = _rows(n, d, cap, np.random.default_rng(seed))
    ops.check_column_ids(rows)
    return rows


@pytest.mark.parametrize("derive", [
    lambda r: tsp.pad_rows(r, 4),
    lambda r: r.reshape(3, 4, r.d),
    lambda r: tsp.take_rows_along(r.reshape(3, 4, r.d),
                                  torch.tensor([[0, 2], [1, 1], [3, 0]])),
    lambda r: r * torch.rand((r.shape[0], 1)),
    lambda r: tsp.rows_concat(r, r),
    lambda r: r[2:7],
    lambda r: r.to(device="cpu", dtype=torch.bfloat16),
], ids=["pad_rows", "reshape", "take_rows_along", "scale", "rows_concat",
        "slice", "to"])
def test_id_mark_survives_derivations(derive):
    rows = _marked()
    assert rows.ids_in_range and derive(rows).ids_in_range


def test_id_mark_is_not_given_or_inherited_unchecked():
    fresh = _rows(12, 32, 4, np.random.default_rng(1))
    assert not fresh.ids_in_range
    assert not tsp.rows_concat(_marked(), fresh).ids_in_range
    assert not tsp.pad_rows(fresh, 3).ids_in_range


def test_id_mark_cleared_by_an_in_place_change():
    rows = _marked()
    view = rows.reshape(3, 4, rows.d)
    rows.indices[0, 0] = rows.d + 3
    assert not rows.ids_in_range and not view.ids_in_range
    with pytest.raises(ValueError, match="column ids outside"):
        ops.check_column_ids(rows)


def test_id_mark_cleared_by_other_ids():
    """Rows given another ids tensor lose the mark, even one whose version
    counter equals the checked tensor's."""
    rows = _marked()
    bad = rows.indices.clone()
    bad[0, 0] = rows.d
    fresh = torch.tensor(bad.tolist(), dtype=torch.int32)
    assert fresh._version == rows.indices._version
    rows.indices = fresh
    assert not rows.ids_in_range
    with pytest.raises(ValueError, match="column ids outside"):
        ops.check_column_ids(rows)


@pytest.mark.parametrize("bad", [32, 40, -1])
def test_fresh_rows_with_an_id_out_of_range_raise_on_the_cpu(bad):
    """A fresh batch with an id outside [0, d) raises ValueError in the
    sparse solve and the sparse hinge before any plain version runs."""
    rows = _rows(12, 32, 4, np.random.default_rng(2))
    rows.indices[5, 0] = bad
    y = torch.ones((2, 6))
    ops.reset_launches()
    with pytest.raises(ValueError, match="column ids outside"):
        ops.cd_solve(rows[:12].reshape(2, 6, 32), rows[:0], y, y, C=1.0,
                     tol=1e-3, max_epochs=1)
    with pytest.raises(ValueError, match="column ids outside"):
        ops.hinge_scores(rows, torch.zeros((1, 32)), torch.zeros(1),
                         torch.ones(12), torch.ones(12))
    assert not any(ops.LAUNCHES.values())


def test_checked_rows_pass_and_fit_mapreduce_checks_once():
    rows = _rows(64, 32, 4, np.random.default_rng(3))
    y = torch.from_numpy(np.where(np.arange(64) % 3 == 0, 1.0, -1.0)
                         .astype(np.float32))
    cfg = T.MRSVMConfig(sv_capacity=8, max_rounds=2,
                        svm=T.SVMConfig(C=1.0, max_epochs=4,
                                        row_format="sparse_csr", nnz_cap=4))
    calls = []
    real = ops.check_column_ids

    def counting(*parts):
        calls.append([p.ids_in_range for p in parts])
        return real(*parts)

    ops.check_column_ids = counting
    try:
        model = T.fit_mapreduce(rows, y, 4, cfg, device="cpu")
    finally:
        ops.check_column_ids = real
    # the fit's first check does the work; every later part is marked
    assert calls[0] == [False]
    assert all(all(c) for c in calls[1:]) and len(calls) > 3
    assert model.sv.x.ids_in_range


def test_tfidf_keeps_the_mark_of_its_counts():
    counts = ttext.vectorize_sparse(["a b c", "b c d e", "a"], 64, nnz_cap=4)
    model = ttext.fit_idf(counts)
    assert not ttext.transform(counts, model, device="cpu").ids_in_range
    ops.check_column_ids(counts)
    assert ttext.transform(counts, model, device="cpu").ids_in_range


# -- init_sv_buffer's device -------------------------------------------------

def test_init_sv_buffer_defaults_to_the_card():
    """Without a device it runs where every entry point runs: on the card
    (raising without one, as no entry point falls back to the CPU)."""
    if torch.cuda.is_available():
        assert T.init_sv_buffer(64, 16).x.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            T.init_sv_buffer(64, 16)


@pytest.mark.parametrize("nnz_cap", [None, 4])
def test_init_sv_buffer_on_the_cpu(nnz_cap):
    sv = T.init_sv_buffer(64, 16, torch.bfloat16, device="cpu",
                          nnz_cap=nnz_cap)
    x = tsp.to_dense(sv.x) if nnz_cap else sv.x
    assert x.device.type == "cpu" and x.dtype == torch.bfloat16
    assert torch.equal(x, torch.zeros((64, 16), dtype=torch.bfloat16))
    for t in (sv.y, sv.alpha, sv.mask):
        assert torch.equal(t, torch.zeros(64, dtype=torch.bfloat16))
    assert torch.equal(sv.ids, torch.full((64,), -1, dtype=torch.int32))
    if nnz_cap:
        assert sv.x.nnz_cap == 4 and sv.x.ids_in_range
