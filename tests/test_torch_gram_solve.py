"""Host side of the two redesigned Gram-path kernels, on the CPU: the
tiled, clustered ``cd_solve_gram`` (its cluster-size rule and a plain
emulation of its arithmetic, which must equal the plain solve bit for
bit) and ``sparse_gram``'s tiled CSC view and fused scores route (a
plain emulation against ``K @ coef + b``, and the wrapper on the CPU
against the JAX package's Pallas ``sparse_gram`` in interpret mode, as
its own tests run it); and the full-width sparse-rbf fit's structure,
cut in rows, through both packages. The CUDA kernels run only on a
card; ``chip_smoke.py`` holds them against the plain versions there."""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
import repro_torch.core as T
from repro import sparse as jsp
from repro.core.svm import fit_binary_kernel as j_fit_binary_kernel
from repro.data import pipeline as jpipe
from repro.kernels import gram as jgram
from repro_torch import sparse as tsp
from repro_torch.kernels import gram_solve, ops, ref

# the module, not the package's ``gram`` wrapper function
gram = importlib.import_module("repro_torch.kernels.gram")
BF16 = torch.bfloat16


# ---------------------------------------------------------------------------
# cd_solve_gram: rows in tiles, one cluster per job
# ---------------------------------------------------------------------------

def _gram_jobs(L, n, seed, dtype=torch.float32, masked_job=None):
    """Symmetric rbf K of unit-norm rows, labels with padding (y = m = 0
    on ~10 % of rows); job ``masked_job`` has every row masked, so it
    stops after one epoch while the others go on."""
    rng = np.random.default_rng(seed)
    X = rng.random((L, n, 16)) * (rng.random((L, n, 16)) < 0.5)
    X /= np.maximum(np.linalg.norm(X, axis=2, keepdims=True), 1e-9)
    dots = np.einsum("lnd,lmd->lnm", X, X)
    K = np.exp(-np.maximum(2.0 - 2.0 * dots, 0.0))
    K = (K + K.transpose(0, 2, 1)) / 2                 # exactly symmetric
    y = np.where(rng.random((L, n)) > 0.5, 1.0, -1.0)
    m = (rng.random((L, n)) > 0.1).astype(np.float64)
    if masked_job is not None:
        m[masked_job] = 0.0
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(dtype)  # noqa
    return t(K), t(y * m), t(m)


@pytest.mark.parametrize("dtype", [torch.float32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("L,n,c,tile,masked_job", [
    (3, 300, 4, 32, None),     # ragged last tile, 4 ranks
    (2, 45, 2, 32, None),      # n not a multiple of the tile, rank 1 short
    (2, 1, 2, 32, None),       # one row a job: rank 1 owns nothing
    (3, 70, 1, 32, 1),         # the single route; job 1 stops first
    (2, 100, 8, 8, None),      # small tiles: a rank owns 2 of them
])
def test_emulated_tiled_solve_equals_plain_bit_for_bit(dtype, L, n, c, tile,
                                                      masked_job):
    K, y, m = _gram_jobs(L, n, seed=n + c, dtype=dtype, masked_job=masked_job)
    kw = dict(C=1.0, tol=1e-3, max_epochs=8)
    emu = gram_solve.emulate_tiled(K, y, m, tile=tile, cluster=c, **kw)
    plain = ref.cd_solve_gram_ref(K, y, m, **kw)
    assert emu[0].dtype == emu[2].dtype == dtype
    for a, b in zip(emu, plain):
        assert torch.equal(a, b)
    if masked_job is not None:
        assert int(emu[1][masked_job]) == 1 and int(emu[1].max()) > 1
        assert not emu[0][masked_job].any()


def test_emulated_tiled_solve_matches_the_reference():
    """The emulation against vmapped ``fit_binary_kernel`` on the same K
    (f32: α and viol to 1e-5, epochs equal), as the plain version is."""
    K, y, m = _gram_jobs(4, 70, seed=5)
    cfg = J.SVMConfig(C=1.0, tol=1e-3, max_epochs=10,
                      kernel=J.KernelConfig("rbf"), use_gram=True)
    Xdummy = jnp.zeros((4, 70, 1))
    jres = jax.vmap(lambda x, k, yy, mm: j_fit_binary_kernel(
        x, yy, mm, cfg, gram_fn=lambda a, b: k))(
        Xdummy, jnp.asarray(K.numpy()), jnp.asarray(y.numpy()),
        jnp.asarray(m.numpy()))
    alpha, t, viol = gram_solve.emulate_tiled(K, y, m, C=1.0, tol=1e-3,
                                              max_epochs=10, tile=32,
                                              cluster=2)
    np.testing.assert_allclose(alpha.numpy(), np.asarray(jres.alpha),
                               atol=1e-5)
    np.testing.assert_allclose(viol.numpy(), np.asarray(jres.max_violation),
                               atol=1e-5)
    np.testing.assert_array_equal(t.numpy(), np.asarray(jres.epochs_run))


def test_gram_solve_cluster_size_rule():
    rule = ops.cd_solve_gram_cluster_size
    # full-width reducers (8 jobs × (8192 + 2048) rows): 8 CTAs of 1280
    assert rule(8, 10240) == 8
    assert ops.gram_solve_rows_per_cta(10240, 8) == 1280
    # the golden reducers and the full-width final fit: one CTA
    assert rule(8, 224) == 1
    assert rule(1, 2048) == 1
    assert rule(1, 1) == 1
    # just above the old one-CTA cap of 11622 rows: a route now
    assert rule(1, 11623) == 8
    assert rule(1, 11776) == 8
    # the rows a CTA decide, not the number of jobs: many jobs run in
    # waves of clusters
    assert rule(64, 20000) == rule(1, 20000) == 16
    assert ops.gram_solve_rows_per_cta(20000, 16) == 1280
    # the new cap: 16 CTAs × 11552 rows (no K is allocated here)
    cap = ops.GRAM_SOLVE_MAX_CLUSTER * ops.GRAM_SOLVE_MAX_ROWS_PER_CTA
    assert cap > 16 * 11000
    assert rule(1, cap) == 16
    with pytest.raises(ValueError, match="at most 16"):
        rule(1, cap + 1)
    for L, n in ((8, 10240), (1, 11776), (1, cap), (64, 20000), (3, 45)):
        c = rule(L, n)
        W = ops.gram_solve_rows_per_cta(n, c)
        assert c & (c - 1) == 0 and c * W >= n
        assert W % ops.GRAM_SOLVE_TILE == 0
        assert W <= ops.GRAM_SOLVE_MAX_ROWS_PER_CTA


def test_cd_solve_gram_counts_no_launch_on_cpu():
    K, y, m = _gram_jobs(2, 40, seed=1)
    ops.reset_launches()
    out = ops.cd_solve_gram(K, y, m, C=1.0, tol=1e-3, max_epochs=3)
    plain = ref.cd_solve_gram_ref(K, y, m, C=1.0, tol=1e-3, max_epochs=3)
    assert all(torch.equal(a, b) for a, b in zip(out, plain))
    assert not any(ops.LAUNCHES.values())
    assert not any(ops.ROUTE_LAUNCHES.values())


# ---------------------------------------------------------------------------
# sparse_gram: the tiled CSC view and the fused scores route
# ---------------------------------------------------------------------------

def _sparse(n, d, nnz, cap, seed, dead=0.1):
    """Unit-norm blocked-CSR rows with padding slots and dead rows."""
    rng = np.random.default_rng(seed)
    dense = np.zeros((n, d), np.float32)
    for i in range(n):
        dense[i, rng.choice(d, nnz, replace=False)] = rng.random(nnz) + 0.1
    dense /= np.linalg.norm(dense, axis=1, keepdims=True)
    dense[rng.random(n) < dead] = 0.0
    return dense, tsp.from_dense(torch.from_numpy(dense), cap)


def _lists(view, jobs, tiles, d):
    """(job, column) → the entries of every tile of the column, in tile
    order, as (Z row, value)."""
    start, end, ent = view
    zrow, zval = ent[:, 0], ent[:, 1].view(torch.float32)
    out = {}
    for j in range(jobs):
        for c in range(d):
            rows, vals = [], []
            for t in range(tiles):
                k = (j * tiles + t) * d + c
                rows += zrow[start[k]:end[k]].tolist()
                vals += zval[start[k]:end[k]].tolist()
            out[j, c] = (rows, vals)
    return out


@pytest.mark.parametrize("tile,chunk_slots", [(32, 1 << 22), (64, 1 << 22),
                                              (96, 1 << 22), (32, 500),
                                              (64, 12 * 64)])
def test_tiled_csc_view_holds_the_untiled_entries(tile, chunk_slots):
    """Also when the rows go through in chunks of one or more tiles,
    some straddling the home and shared rows; every nonzero slot is
    listed once, and no zero one."""
    d = 120
    _, H = _sparse(3 * 50, d, 9, 12, seed=1)
    _, S = _sparse(37, d, 9, 12, seed=2)
    Z = gram.JobRows(H.reshape(3, 50, d), S)
    n = Z.n
    view = gram.csc_view(Z, d, tile, chunk_slots)
    tiles = -(-n // tile)
    start, end, ent = view
    assert start.dtype == end.dtype == ent.dtype == torch.int32
    assert start.shape == end.shape == (3 * tiles * d,)
    lists = _lists(view, 3, tiles, d)
    assert lists == _lists(gram.csc_view(Z, d, n), 3, 1, d)
    nonzero = int((H.values != 0).sum()) + 3 * int((S.values != 0).sum())
    assert sum(len(r) for r, _ in lists.values()) == nonzero
    assert all(v != 0 for _, vals in lists.values() for v in vals)
    zrow = ent[:, 0]
    for j in range(3):            # each tile's entries lie in the tile
        for t in range(tiles):
            for c in range(0, d, 7):
                k = (j * tiles + t) * d + c
                assert bool(((zrow[start[k]:end[k]] // tile) == t).all())


def _scores_case(seed, nz_home, L, cdtype):
    """Query rows X against Z = [H; S] with eq. 7's coefficients: zero
    off each hypothesis's block of H, some zeros inside it (non-support
    vectors), and hypothesis 0 zero on S too. With 3072 rows of H, Z has
    two tiles and hypothesis 0 skips the second."""
    d, cap = 300, 16
    _, X = _sparse(45, d, 10, cap, seed)
    _, H = _sparse(nz_home, d, 10, cap, seed + 1)
    _, S = _sparse(23, d, 10, cap, seed + 2)
    rng = np.random.default_rng(seed)
    per = nz_home // L
    coef = rng.normal(size=(L, nz_home + 23)).astype(np.float32)
    coef[:, ::5] = 0.0
    for l in range(L):
        coef[l, :l * per] = 0.0
        coef[l, (l + 1) * per:nz_home] = 0.0
    coef[0, nz_home:] = 0.0
    b = rng.normal(size=L).astype(np.float32)
    return (X, (H.reshape(1, nz_home, d), S), torch.from_numpy(coef).to(cdtype),
            torch.from_numpy(b).to(cdtype))


KINDS = [("linear", {}), ("rbf", dict(gamma=0.5)),
         ("poly", dict(gamma=0.5, coef0=1.0, degree=2))]


@pytest.mark.parametrize("kind,kw", KINDS, ids=[k for k, _ in KINDS])
@pytest.mark.parametrize("nz_home", [120, 3072], ids=["one-tile",
                                                     "two-tiles"])
def test_emulated_scores_match_k_coef_f32(kind, kw, nz_home):
    """f32: the tiled, fused sums (tiles a hypothesis does not read
    skipped) against K @ coef + b within 1e-5 of the scale; the plain
    version is that product."""
    X, Z, coef, b = _scores_case(7, nz_home, 3, torch.float32)
    if nz_home > gram.SPARSE_TILE:
        tiles = coef[:, :gram.SPARSE_TILE].ne(0).any(1), \
            coef[:, gram.SPARSE_TILE:].ne(0).any(1)
        assert tiles[0].tolist() == [True, True, False]
        assert tiles[1].tolist() == [False, True, True]
    emu = gram.emulate_scores(X, Z, coef, b, kind=kind, **kw)
    plain = ref.sparse_gram_scores_ref(X, Z, coef, b, kind=kind, **kw)
    assert emu.shape == (45, 3) and emu.dtype == torch.float32
    K = ref.sparse_gram_ref(X, tsp.rows_concat(Z[0][0], Z[1]), kind, **kw)
    direct = K @ coef.T + b
    scale = float(direct.abs().max()) + 1.0
    assert float((emu - direct).abs().max()) <= 1e-5 * scale
    assert float((plain - direct).abs().max()) <= 1e-5 * scale


def test_emulated_scores_bf16_coefficients():
    """bf16 coefficients: k rounded to bf16 before the product, f32 sums,
    one rounding of the sum and one of the bias add — within one bf16
    step (2⁻⁸ relative, so 2⁻⁷ of the scale) of the plain
    ``K.to(bf16) @ coef + b``."""
    X, Z, coef, b = _scores_case(11, 3072, 3, BF16)
    emu = gram.emulate_scores(X, Z, coef, b, kind="rbf", gamma=0.5)
    plain = ref.sparse_gram_scores_ref(X, Z, coef, b, kind="rbf", gamma=0.5)
    assert emu.dtype == plain.dtype == BF16
    scale = float(plain.float().abs().max())
    assert float((emu.float() - plain.float()).abs().max()) <= 2 ** -7 * scale


@pytest.mark.parametrize("kind,kw", KINDS, ids=[k for k, _ in KINDS])
def test_sparse_gram_scores_on_cpu_match_the_reference(kind, kw):
    """ops.sparse_gram_scores on the CPU ≡ the JAX package's decision
    values on the same numpy rows, K from the Pallas sparse_gram in
    interpret mode: against a (home, shared) pair and against plain
    rows, two hypotheses; 1e-5 of the scale."""
    d, cap = 200, 12
    dx, X = _sparse(30, d, 8, cap, 21)
    dh, H = _sparse(25, d, 8, cap, 22)
    ds, S = _sparse(9, d, 8, cap, 23)
    rng = np.random.default_rng(3)
    coef = rng.normal(size=(2, 34)).astype(np.float32)
    b = rng.normal(size=2).astype(np.float32)
    ops.reset_launches()
    got = ops.sparse_gram_scores(X, (H.reshape(1, 25, d), S),
                                 torch.from_numpy(coef), torch.from_numpy(b),
                                 kind=kind, **kw).numpy()
    plain_z = ops.sparse_gram_scores(X, S, torch.from_numpy(coef[:, 25:]),
                                     torch.from_numpy(b), kind=kind,
                                     **kw).numpy()
    assert not any(ops.LAUNCHES.values())
    xj = jsp.from_dense(jnp.asarray(dx), cap)
    for zd, c, out in ((np.concatenate([dh, ds]), coef, got),
                       (ds, coef[:, 25:], plain_z)):
        K = np.asarray(jgram.sparse_gram(
            xj, jsp.from_dense(jnp.asarray(zd), cap), kind=kind, **kw))
        want = K @ c.T + b
        np.testing.assert_allclose(out, want,
                                   atol=1e-5 * (np.abs(want).max() + 1.0))


def test_sparse_gram_scores_checks_inputs():
    _, X = _sparse(5, 40, 4, 6, 1)
    _, Z = _sparse(7, 40, 4, 6, 2)
    one = torch.ones(2)
    with pytest.raises(ValueError, match="coef must be"):
        ops.sparse_gram_scores(X, Z, torch.ones((2, 6)), one)
    with pytest.raises(ValueError, match="one job of rows"):
        ops.sparse_gram_scores(X, (Z[:6].reshape(2, 3, 40), Z[6:]),
                               torch.ones((2, 4)), one)
    with pytest.raises(ValueError, match="one dtype"):
        ops.sparse_gram_scores(X, Z, torch.ones((2, 7)), one.to(BF16))
    with pytest.raises(ValueError, match="query rows"):
        ops.sparse_gram_scores(tsp.to_dense(X), Z, torch.ones((2, 7)), one)


# ---------------------------------------------------------------------------
# the full-width sparse-rbf cell's structure against the reference
# ---------------------------------------------------------------------------

def test_full_width_gram_structure_behaves_as_the_reference():
    """The full-width sparse-rbf fit's structure — 8 partitions,
    sv_capacity 1/32 of the rows, rbf γ = 1, C = 1, 10 epochs, 256
    nonzeros a row at stride d/256 of d = 131072, 64 signal dims — cut
    to 128 rows a partition, through both packages: the same rounds,
    reducers, |SV| and SV ids, R_emp to 1e-5. Both jump above R_emp 1
    after round 0: the reference's own behaviour on these rows, not the
    port's. The reference runs gram_impl='xla' (its Pallas sparse Gram
    in interpret mode is too slow at this d), the port its blocked-CSR
    route (the plain versions on the CPU)."""
    L, per, d, cap = 8, 128, 131072, 256
    Xs, y = jpipe.svm_rows_sparse(L * per, d, cap, seed=0, nnz=256)
    base = dict(sv_capacity=L * per // 32, gamma=1e-4, max_rounds=3)
    svm = dict(C=1.0, max_epochs=10, use_gram=True, row_format="sparse_csr",
               nnz_cap=cap)
    jcfg = J.MRSVMConfig(svm=J.SVMConfig(kernel=J.KernelConfig("rbf"),
                                         gram_impl="xla", **svm), **base)
    tcfg = T.MRSVMConfig(svm=T.SVMConfig(kernel=T.KernelConfig("rbf"),
                                         gram_impl="pallas_sparse", **svm),
                         **base)
    indices, values = np.asarray(Xs.indices), np.asarray(Xs.values)
    jm = J.fit_mapreduce(jsp.SparseRows(jnp.asarray(indices),
                                        jnp.asarray(values), d),
                         jnp.asarray(y), L, jcfg)
    tm = T.fit_mapreduce(tsp.SparseRows(torch.from_numpy(indices),
                                        torch.from_numpy(values), d),
                         y, L, tcfg, device="cpu")
    assert tm.rounds == jm.rounds == 3
    for ht, hj in zip(tm.history, jm.history, strict=True):
        assert (ht["reducer"], ht["sv_count"]) == (hj["reducer"],
                                                   hj["sv_count"])
        assert ht["risk"] == pytest.approx(hj["risk"], abs=1e-5)
    np.testing.assert_array_equal(tm.sv.ids.numpy(), np.asarray(jm.sv.ids))
    for m in (tm, jm):
        assert m.history[0]["risk"] < 0.2 < 1.0 < m.history[1]["risk"]


@pytest.mark.parametrize("gamma,beats", [(1.0, False), (8.0, True)])
def test_rbf_pick_beats_the_majority_only_at_large_gamma(gamma, beats):
    """The same cut, the port alone (plain versions), two rounds: on
    these unit-norm rows k(x, z) = e^(−2γ(1 − x·z)). At γ = 1 the eq. 7
    pick only ties the majority class (the full-width γ = 1 check is
    "≥"); at γ = 8 k nearly vanishes off the diagonal, the pick gets its
    own partition's rows right and beats the majority, which makes the
    full-width γ = 8 check of chip_smoke.py one that can fail."""
    L, per, d, cap = 8, 128, 131072, 256
    Xs, y = jpipe.svm_rows_sparse(L * per, d, cap, seed=0, nnz=256)
    X = tsp.SparseRows(torch.from_numpy(np.asarray(Xs.indices)),
                       torch.from_numpy(np.asarray(Xs.values)), d)
    yt = torch.from_numpy(y)
    svm = T.SVMConfig(C=1.0, max_epochs=10,
                      kernel=T.KernelConfig("rbf", gamma=gamma),
                      use_gram=True, gram_impl="pallas_sparse",
                      row_format="sparse_csr", nnz_cap=cap)
    cfg = T.MRSVMConfig(sv_capacity=L * per // 32, gamma=1e-4, max_rounds=2,
                        svm=svm)
    model = T.fit_mapreduce(X, y, L, cfg, device="cpu")
    # replay the rounds before the pick, then solve and score its reducer
    h = min(model.history, key=lambda r: r["risk"])
    Xp, yp = X.reshape(L, per, d), yt.reshape(L, per)
    mp = torch.ones_like(yp)
    sv = T.init_sv_buffer(cfg.sv_capacity, d, torch.float32, "cpu",
                          nnz_cap=cap)
    for _ in range(h["round"]):
        sv = T.mapreduce_round(Xp, yp, mp, sv, cfg).sv
    j = slice(h["reducer"], h["reducer"] + 1)
    y_aug = torch.cat([yp[j], sv.y[None]], 1)
    m_aug = torch.cat([mp[j], sv.mask[None]], 1)
    res = T.solve_kernel_jobs(Xp[j], sv.x, y_aug, m_aug, cfg.svm)
    s = T.decision_kernel((Xp[j], sv.x), (res.alpha * y_aug * m_aug)[0],
                          res.b[0], X, cfg.svm)
    pick = float((torch.where(s >= 0, 1.0, -1.0) == yt).float().mean())
    major = float(max((yt > 0).float().mean(), (yt < 0).float().mean()))
    assert float(torch.clamp(1.0 - yt * s, min=0.0).mean()) == \
        pytest.approx(h["risk"], abs=1e-5)
    assert (pick > major) == beats and pick >= major
