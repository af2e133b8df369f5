"""The port's blocked-CSR rows (``repro_torch.sparse``), sparse
featurizer and sparse row generators against the JAX reference: the
same numpy inputs go to both."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import sparse as jsp
from repro import text as jtext
from repro.data import pipeline as jpipe
from repro_torch import sparse as tsp
from repro_torch import text as ttext
from repro_torch.data import pipeline as tpipe
from repro_torch.device import as_tensor, resolve_device


def _pair(n=24, d=40, nnz=5, cap=8, seed=0):
    """Dense numpy rows with DISTINCT in-row columns, ≤ cap nonzeros."""
    rng = np.random.default_rng(seed)
    dense = np.zeros((n, d), np.float32)
    for i in range(n):
        dense[i, rng.choice(d, nnz, replace=False)] = rng.normal(0, 1, nnz)
    return dense, tsp.from_dense(torch.from_numpy(dense), cap), \
        jsp.from_dense(jnp.asarray(dense), cap)


def _same(t: tsp.SparseRows, j) -> None:
    """Port and reference rows hold identical leaves."""
    np.testing.assert_array_equal(t.indices.numpy(), np.asarray(j.indices))
    np.testing.assert_array_equal(t.values.numpy(), np.asarray(j.values))
    assert t.d == j.d and t.shape == tuple(j.shape)


def test_from_dense_to_dense_match_reference():
    dense, t, j = _pair()
    _same(t, j)
    assert t.indices.dtype == torch.int32 and t.nnz_cap == 8 and t.ndim == 2
    np.testing.assert_array_equal(tsp.to_dense(t).numpy(), dense)
    # padding slots are (0, 0.0)
    pad = t.values == 0
    assert pad.any() and not t.indices[pad].any()


@pytest.mark.parametrize("row", [
    [[0.1, -5.0, 0.0, 2.0, -0.5, 3.0]],      # truncation to top-|value|
    [[1.0, -1.0, 0.5, 1.0, -1.0, 0.0]],      # |value| ties: lower column first
    [[0.0, 0.0, 2.0, 0.0, 0.0, 0.0]],        # mostly padding
])
def test_from_dense_ties_and_truncation_match_lax_top_k(row):
    a = np.asarray(row, np.float32)
    _same(tsp.from_dense(torch.from_numpy(a), 3),
          jsp.from_dense(jnp.asarray(a), 3))


def test_dense_like_surface_matches_reference():
    dense, t, j = _pair(seed=1)
    rng = np.random.default_rng(1)
    W = rng.normal(size=(dense.shape[1], 3)).astype(np.float32)
    v = W[:, 0].copy()
    np.testing.assert_allclose((t @ torch.from_numpy(W)).numpy(),
                               np.asarray(j @ jnp.asarray(W)), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose((t @ torch.from_numpy(v)).numpy(),
                               np.asarray(j @ jnp.asarray(v)), rtol=1e-5,
                               atol=1e-6)
    scale = np.arange(1.0, dense.shape[0] + 1.0, dtype=np.float32)[:, None]
    _same(t * torch.from_numpy(scale), j * jnp.asarray(scale))
    _same(t[4:9], j[4:9])
    _same(t.reshape(2, 12, t.d), j.reshape(2, 12, j.d))
    with pytest.raises(ValueError):
        t * torch.ones(dense.shape)
    with pytest.raises(ValueError):
        t.reshape(24, 7)
    b = t.to(dtype=torch.bfloat16)
    assert b.dtype == torch.bfloat16 and b.indices.dtype == torch.int32


def test_structural_ops_match_reference():
    _, xt, xj = _pair(seed=2)
    _, yt, yj = _pair(seed=3)
    _same(tsp.rows_concat(xt, yt), jsp.rows_concat(xj, yj))
    _same(tsp.pad_rows(xt, 5), jsp.pad_rows(xj, 5))
    rt, rj = tsp.pad_rows(xt, 4).reshape(2, 14, xt.d), \
        jsp.pad_rows(xj, 4).reshape(2, 14, xj.d)
    topi = np.asarray([[3, 0, 7], [13, 1, 2]])
    _same(tsp.take_rows_along(rt, torch.from_numpy(topi)),
          jsp.take_rows_along(rj, jnp.asarray(topi)))
    with pytest.raises(TypeError):
        tsp.rows_concat(xt, tsp.to_dense(yt))
    with pytest.raises(ValueError):
        tsp.rows_concat(xt, tsp.from_dense(tsp.to_dense(yt), 4))


@pytest.mark.parametrize("fmt", ["sparse", "dense"])
def test_wave_helpers_match_reference(fmt):
    """The streaming wave's joins: ``rows_concat_all`` of micro-batches,
    ``rows_stack`` of jobs [new rows; SVs] zero-padded to the longest
    (the reference's pad-then-stack), an empty job as the reference's
    ``rows_zeros_like`` job; the column-id mark kept."""
    parts = [_pair(n=n, seed=s) for n, s in ((24, 4), (10, 5), (16, 6))]
    if fmt == "dense":
        parts = [(d, torch.from_numpy(d), jnp.asarray(d))
                 for d, _, _ in parts]
        same = lambda t, j: np.testing.assert_array_equal(  # noqa: E731
            t.numpy(), np.asarray(j))
    else:
        same = _same
        for _, t, _ in parts:
            t.mark_ids_in_range()
    (_, a, ja), (_, b, jb), (_, c, jc) = parts
    same(tsp.rows_concat_all([a, b, c]), jsp.rows_concat_all([ja, jb, jc]))
    assert tsp.rows_concat_all([a]) is a
    jobs_j = [jsp.rows_concat(ja, jb), jsp.pad_rows(jc, 34 - 16)]
    jobs_j.append(jsp.rows_zeros_like(jobs_j[0]))
    got = tsp.rows_stack([[a, b], [c], []])
    same(got, jsp.rows_stack(jobs_j))
    assert tuple(tsp.rows_stack([[c]], 20).shape) == (1, 20, 40)
    if fmt == "sparse":
        assert got.ids_in_range
        assert not tsp.rows_stack([[a, tsp.from_dense(
            torch.zeros((2, 40)), 8)]]).ids_in_range
    with pytest.raises(ValueError, match="more than"):
        tsp.rows_stack([[a, b]], 20)
    with pytest.raises(TypeError):
        tsp.rows_stack([[a], [tsp.to_dense(a) if fmt == "sparse"
                              else tsp.from_dense(a, 8)]])
    with pytest.raises(ValueError):
        tsp.rows_concat_all([])


@pytest.mark.parametrize("mix", ["ss", "sd", "ds", "dd"])
def test_cross_dots_every_format_mix_matches_reference(mix):
    """1e-5: float32 sums of ≤ 5 products in another order."""
    dx, xt, xj = _pair(n=17, seed=4)
    dz, zt, zj = _pair(n=70, seed=5)             # > one 64-row chunk
    a_t = xt if mix[0] == "s" else torch.from_numpy(dx)
    a_j = xj if mix[0] == "s" else jnp.asarray(dx)
    b_t = zt if mix[1] == "s" else torch.from_numpy(dz)
    b_j = zj if mix[1] == "s" else jnp.asarray(dz)
    np.testing.assert_allclose(tsp.cross_dots(a_t, b_t).numpy(),
                               np.asarray(jsp.cross_dots(a_j, b_j)),
                               rtol=1e-5, atol=1e-5)


def test_norms_row_sums_and_scores_match_reference():
    dense, t, j = _pair(seed=6)
    rng = np.random.default_rng(6)
    coef = rng.normal(size=dense.shape[0]).astype(np.float32)
    W = rng.normal(size=(3, dense.shape[1])).astype(np.float32)
    b = rng.normal(size=3).astype(np.float32)
    np.testing.assert_allclose(tsp.row_sq_norms(t).numpy(),
                               np.asarray(jsp.row_sq_norms(j)), rtol=1e-6)
    np.testing.assert_allclose(
        tsp.weighted_row_sum(t, torch.from_numpy(coef)).numpy(),
        np.asarray(jsp.weighted_row_sum(j, jnp.asarray(coef))), rtol=1e-5,
        atol=1e-6)
    np.testing.assert_allclose(
        tsp.score_rows(t, torch.from_numpy(W), torch.from_numpy(b)).numpy(),
        np.asarray(jsp.score_rows(j, jnp.asarray(W), jnp.asarray(b))),
        rtol=1e-5, atol=1e-6)


def test_device_helpers_take_sparse_rows():
    _, t, _ = _pair()
    assert resolve_device(None, like=t) == torch.device("cpu")
    moved = as_tensor(t, torch.device("cpu"), torch.bfloat16)
    assert tsp.is_sparse(moved) and moved.dtype == torch.bfloat16
    assert moved.indices.dtype == torch.int32


_DOCS = ["seçim sonuçları bugün açıklandı açıklandı",
         "bugün hava çok güzel", "seçim seçim seçim anketi", ""]


def test_sparse_tokenizer_is_byte_identical():
    texts = ttext.generate(ttext.CorpusConfig(num_messages=200,
                                              seed=2)).texts + _DOCS
    for cap in (4, 32):
        t = ttext.vectorize_sparse(texts, 1024, nnz_cap=cap)
        j = jtext.tokenizer.vectorize_sparse(texts, 1024, nnz_cap=cap)
        _same(t, j)
    toks = [ttext.tokenize(x) for x in _DOCS]
    _same(ttext.count_rows_sparse(toks, 64, nnz_cap=8),
          jtext.tokenizer.count_rows_sparse(toks, 64, nnz_cap=8))


@pytest.mark.parametrize("smooth", [True, False])
def test_sparse_tfidf_matches_reference(smooth):
    """1e-6: the same float32 operations, one gather of idf per slot."""
    texts = ttext.generate(ttext.CorpusConfig(num_messages=150,
                                              seed=3)).texts
    counts = ttext.vectorize_sparse(texts, 256, nnz_cap=16)
    jc = jax.tree_util.tree_map(
        jnp.asarray, jtext.tokenizer.vectorize_sparse(texts, 256, nnz_cap=16))
    Xt, mt = ttext.fit_transform(counts, smooth=smooth, device="cpu")
    Xj, mj = jtext.fit_transform(jc, smooth=smooth)
    np.testing.assert_allclose(mt.idf.numpy(), np.asarray(mj.idf), rtol=1e-6)
    assert tsp.is_sparse(Xt)
    np.testing.assert_array_equal(Xt.indices.numpy(), np.asarray(Xj.indices))
    np.testing.assert_allclose(Xt.values.numpy(), np.asarray(Xj.values),
                               rtol=1e-6, atol=1e-7)
    raw = ttext.transform(counts, mt, l2_normalize=False)
    # padding slots stay exactly 0 although idf[0] is not
    np.testing.assert_array_equal((raw.values == 0).numpy(),
                                  (counts.values == 0).numpy())


def test_svm_rows_sparse_is_byte_identical():
    for args, kw in (((2500, 512, 8), dict(seed=3)),
                     ((2100, 256, 8), dict(seed=5, process_index=1,
                                           process_count=3)),
                     ((100, 64, 16), dict(seed=0, nnz=7))):
        Xt, yt = tpipe.svm_rows_sparse(*args, **kw)
        Xj, yj = jpipe.svm_rows_sparse(*args, **kw)
        _same(Xt, Xj)
        np.testing.assert_array_equal(yt, yj)
    with pytest.raises(ValueError, match="exceeds nnz_cap"):
        tpipe.svm_rows_sparse(10, 4096, 8)


def test_svm_rows_sparse_device_has_the_svm_rows_sparse_distribution():
    n, d, cap, nnz = 1100, 512, 16, 8
    X, y = tpipe.svm_rows_sparse_device(n, d, cap, seed=2, nnz=nnz,
                                        device="cpu")
    assert X.shape == (n, d) and y.shape == (n,)
    assert X.dtype == torch.float32 and X.indices.dtype == torch.int32
    live = X.values[:, :nnz]
    assert (live > 0).all() and not X.values[:, nnz:].any() \
        and not X.indices[:, nnz:].any()
    stride = d // nnz
    np.testing.assert_array_equal((X.indices[:, :nnz] // stride).numpy(),
                                  np.broadcast_to(np.arange(nnz), (n, nnz)))
    torch.testing.assert_close(X.values.norm(dim=1), torch.ones(n))
    w = torch.from_numpy(jpipe._svm_signal(d, 2, 64))
    assert torch.equal(y, torch.sign((X.values * w[X.indices.long()]).sum(1)
                                     + 1e-3))
    # stateless blocks: block 0 does not depend on the rows that follow
    Xb, yb = tpipe.svm_rows_sparse_device(1024, d, cap, seed=2, nnz=nnz,
                                          device="cpu")
    assert torch.equal(Xb.indices, X.indices[:1024])
    assert torch.equal(Xb.values, X.values[:1024])
    assert torch.equal(yb, y[:1024])
