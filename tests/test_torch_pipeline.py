"""The port's paper pipeline against the JAX reference:

    tweets → TF×IDF (eq. 10-11) → 2-class / 3-class MapReduce SVM →
    confusion matrix (Tablo 6 / Tablo 8)

the featurizer and data generator byte for byte, the golden accuracy
floors of tests/test_paper_pipeline.py, and held-out predictions equal
to the reference's."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
import repro_torch.core as T
from repro import text as jtext
from repro.data import pipeline as jpipe
from repro_torch import convert
from repro_torch import text as ttext
from repro_torch.data import pipeline as tpipe

N_MSG, N_FEAT, N_TRAIN = 1024, 1024, 768
CLASSES = {2: (-1, 1), 3: (-1, 0, 1)}


def _cfgs():
    kw = dict(sv_capacity=128, gamma=1e-4, max_rounds=4)
    return (J.MRSVMConfig(svm=J.SVMConfig(C=1.0, max_epochs=15), **kw),
            T.MRSVMConfig(svm=T.SVMConfig(C=1.0, max_epochs=15), **kw))


def test_corpus_and_tokenizer_are_byte_identical():
    cfg = dict(num_messages=300, classes=(-1, 0, 1), seed=4)
    cj = jtext.generate(jtext.CorpusConfig(**cfg))
    ct = ttext.generate(ttext.CorpusConfig(**cfg))
    assert ct.texts == cj.texts
    np.testing.assert_array_equal(ct.labels, cj.labels)
    np.testing.assert_array_equal(ct.universities, cj.universities)
    assert ct.university_names == cj.university_names
    texts = ct.texts + ["İSTANBUL Işık http://x.co @ali #tag çok GÜZEL!!"]
    assert [ttext.tokenize(t) for t in texts] == \
        [jtext.tokenize(t) for t in texts]
    assert ttext.hash_token("güzel", 131072) == jtext.hash_token("güzel", 131072)
    np.testing.assert_array_equal(ttext.vectorize(texts, 512),
                                  jtext.vectorize(texts, 512))


@pytest.mark.parametrize("smooth", [True, False])
def test_tfidf_matches_reference_to_float32_rounding(smooth):
    counts = ttext.vectorize(ttext.generate(
        ttext.CorpusConfig(num_messages=200, seed=1)).texts, 256)
    Xt, mt = ttext.fit_transform(counts, smooth=smooth, device="cpu")
    Xj, mj = jtext.fit_transform(jnp.asarray(counts), smooth=smooth)
    np.testing.assert_allclose(mt.idf.numpy(), np.asarray(mj.idf), rtol=1e-6)
    np.testing.assert_allclose(Xt.numpy(), np.asarray(Xj), rtol=1e-6,
                               atol=1e-7)
    raw = ttext.transform(torch.from_numpy(counts), mt, l2_normalize=False)
    assert raw.shape == counts.shape


def test_svm_rows_are_identical_to_reference():
    for args, kw in (((2500, 512), dict(seed=3)),
                     ((2500, 512), dict(seed=3, process_index=1,
                                        process_count=3)),
                     ((100, 64), dict(seed=0, nnz=7))):
        Xt, yt = tpipe.svm_rows_shard(*args, **kw)
        Xj, yj = jpipe.svm_rows_shard(*args, **kw)
        np.testing.assert_array_equal(Xt, Xj)
        np.testing.assert_array_equal(yt, yj)
    assert tpipe.default_row_nnz(131072) == jpipe.default_row_nnz(131072)
    assert tpipe.host_row_range(10, 2, 3) == jpipe.host_row_range(10, 2, 3)


def test_svm_rows_device_has_the_svm_rows_distribution():
    d = 64
    X, y = tpipe.svm_rows_device(1100, d, seed=2, dtype=torch.float32,
                                 device="cpu")
    assert X.shape == (1100, d) and y.shape == (1100,)
    nnz = (X != 0).sum(1)
    assert (nnz == tpipe.default_row_nnz(d)).all()
    torch.testing.assert_close(X.norm(dim=1), torch.ones(1100))
    w = torch.from_numpy(jpipe._svm_signal(d, 2, 64))
    assert torch.equal(y, torch.sign(X @ w + 1e-3))
    assert abs(float((y > 0).float().mean())
               - float((jpipe.svm_rows(1100, d, seed=2)[1] > 0).mean())) < 0.1
    # stateless blocks: block 0 does not depend on how many rows follow,
    # and bf16 rows are the float32 rows rounded
    Xb, yb = tpipe.svm_rows_device(1024, d, seed=2, device="cpu")
    assert Xb.dtype == torch.bfloat16
    assert torch.equal(Xb, X[:1024].to(torch.bfloat16))
    assert torch.equal(yb, y[:1024])


def _features(k, pkg):
    corpus = pkg.generate(pkg.CorpusConfig(num_messages=N_MSG,
                                           classes=CLASSES[k], seed=0))
    counts = pkg.vectorize(corpus.texts, N_FEAT)
    return counts, corpus.labels.astype(np.float32)


@pytest.fixture(scope="module", params=[2, 3])
def golden(request):
    """Both packages' pipelines on the same corpus: features, models,
    held-out predictions and the reference's held-out scores."""
    k = request.param
    jcfg, tcfg = _cfgs()
    counts, y = _features(k, ttext)
    Xj, _ = jtext.fit_transform(jnp.asarray(_features(k, jtext)[0]))
    Xt, _ = ttext.fit_transform(counts, device="cpu")
    tr, te = slice(0, N_TRAIN), slice(N_TRAIN, None)
    if k == 2:
        jm = J.fit_mapreduce(Xj[tr], jnp.asarray(y[tr]), 8, jcfg)
        tm = T.fit_mapreduce(Xt[tr], y[tr], 8, tcfg)
        jpred = np.asarray(J.predict(jm, Xj[te], jcfg))
        tpred = T.predict(tm, Xt[te], tcfg).numpy()
        jscore = np.asarray(J.decision_values(jm, Xj[te], jcfg))[:, None]
    else:
        jm = J.fit_one_vs_rest(Xj[tr], jnp.asarray(y[tr]), list(CLASSES[k]),
                               8, jcfg)
        tm = T.fit_one_vs_rest(Xt[tr], y[tr], list(CLASSES[k]), 8, tcfg)
        jpred = np.asarray(jm.predict(Xj[te]))
        tpred = tm.predict(Xt[te]).numpy()
        dm = np.sort(np.asarray(jm.decision_matrix(Xj[te])), axis=1)
        jscore = dm[:, -1:] - dm[:, -2:-1]      # OvR margin of the argmax
    return dict(k=k, y_te=y[te], jm=jm, tm=tm, jpred=jpred, tpred=tpred,
                jscore=jscore, Xj_te=Xj[te], Xt_te=Xt[te], cfgs=(jcfg, tcfg))


def test_golden_pipeline_accuracy_and_confusion_matrix(golden):
    """Tablo 6 / Tablo 8 analogue: the accuracy floors of
    tests/test_paper_pipeline.py hold for the port."""
    k, y_te, pred = golden["k"], golden["y_te"], golden["tpred"]
    floor = {2: 0.85, 3: 0.75}[k]
    acc = float(np.mean(pred == y_te))
    assert acc > floor, f"{k}-class held-out accuracy {acc:.3f}"
    cm = T.confusion_matrix(y_te, pred, list(CLASSES[k]))
    assert cm.shape == (k, k) and abs(cm.sum() - 100.0) < 1e-3
    assert np.trace(cm) > 100 * floor
    cm_row = T.confusion_matrix(y_te, pred, list(CLASSES[k]), "true")
    np.testing.assert_allclose(cm_row.sum(1), 100.0, atol=1e-6)


def test_golden_predictions_equal_the_reference(golden):
    """Held-out predictions equal JAX's, except where the reference's
    own score is within 1e-4 of the decision boundary."""
    firm = np.abs(golden["jscore"][:, 0]) >= 1e-4
    assert firm.mean() > 0.95
    np.testing.assert_array_equal(golden["tpred"][firm],
                                  golden["jpred"][firm])


def test_reference_model_served_by_the_port(golden):
    """A JAX-trained model, carried across with convert.py, gives the
    reference's predictions from the port."""
    jcfg, tcfg = golden["cfgs"]

    def carry(jm):
        return convert.mapreduce_model_from_numpy(
            np.asarray(jm.w), np.asarray(jm.b),
            [np.asarray(f) for f in jm.sv], [np.asarray(f) for f in jm.final],
            np.asarray(jm.risk), jm.rounds, jm.history)

    jm = golden["jm"]
    X = golden["Xt_te"]
    if golden["k"] == 2:
        pred = T.predict(carry(jm), X, tcfg).numpy()
    else:
        ovr = T.OneVsRestSVM(classes=jm.classes, cfg=tcfg,
                             models={c: carry(m) for c, m in jm.models.items()})
        pred = ovr.predict(X).numpy()
    firm = np.abs(golden["jscore"][:, 0]) >= 1e-4
    np.testing.assert_array_equal(pred[firm], golden["jpred"][firm])
    back = convert.to_numpy(carry(jm) if golden["k"] == 2
                            else carry(next(iter(jm.models.values()))))
    ref = jm if golden["k"] == 2 else next(iter(jm.models.values()))
    np.testing.assert_array_equal(back.sv.ids, np.asarray(ref.sv.ids))
    np.testing.assert_array_equal(back.final.w, np.asarray(ref.final.w))
