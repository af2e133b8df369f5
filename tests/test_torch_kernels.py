"""The port's kernels, through their plain PyTorch versions on the CPU,
against the JAX reference: the same numpy inputs go to both.

The CUDA kernels themselves run only on a card; ``chip_smoke.py`` holds
them against these plain versions there."""
import ast
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.svm import SVMConfig as JSVMConfig
from repro.core.svm import fit_binary_linear as j_fit_binary_linear
from repro.kernels import ref as jref
from repro.kernels import risk_eval, svm_cd_epoch
from repro_torch.kernels import ops, ref

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _rows(rng, n, d, density=0.2):
    """Nonnegative, L2-normalized sparse-ish rows (TF×IDF-like)."""
    X = rng.random((n, d), dtype=np.float32) * (rng.random((n, d)) < density)
    return (X / np.maximum(np.linalg.norm(X, axis=1, keepdims=True), 1e-9)
            ).astype(np.float32)


def _labels(rng, X):
    w = rng.normal(size=X.shape[1]).astype(np.float32)
    return np.where(X @ w + 0.05 * rng.normal(size=len(X)) >= 0, 1.0, -1.0
                    ).astype(np.float32)


@pytest.mark.parametrize("n,d", [(64, 32), (200, 96)])
def test_cd_epoch_ref_matches_reference_oracle_and_pallas(n, d):
    rng = np.random.default_rng(n + d)
    X = rng.normal(size=(n, d)).astype(np.float32)
    y = np.sign(rng.normal(size=n)).astype(np.float32)
    mask = (rng.random(n) > 0.1).astype(np.float32)
    a0, w0 = np.zeros(n, np.float32), np.zeros(d, np.float32)
    a, w, b = ref.cd_epoch_ref(torch.from_numpy(X), alpha=torch.from_numpy(a0),
                               w=torch.from_numpy(w0), b=0.0,
                               y=torch.from_numpy(y), mask=torch.from_numpy(mask))
    ar, wr, br = jref.cd_epoch_ref(X, alpha=a0, w=w0, b=0.0, y=y, mask=mask)
    np.testing.assert_allclose(a.numpy(), ar, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(w.numpy(), wr, rtol=1e-4, atol=1e-4)
    assert float(b) == pytest.approx(float(br), abs=1e-4)
    ap, wp, bp = svm_cd_epoch(jnp.asarray(X), jnp.asarray(y), jnp.asarray(a0),
                              jnp.asarray(w0), jnp.float32(0),
                              jnp.asarray(mask), C=1.0, bn=64)
    np.testing.assert_allclose(a.numpy(), np.asarray(ap), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(w.numpy(), np.asarray(wp), rtol=1e-4, atol=1e-4)
    assert float(b) == pytest.approx(float(bp), abs=1e-4)


@pytest.mark.parametrize("L,per,S,d,C,max_epochs", [
    (8, 96, 128, 64, 1.0, 15),     # a MapReduce round: home rows + SV buffer
    (4, 48, 0, 40, 0.5, 7),        # no shared rows, odd width
    (1, 64, 0, 32, 1.0, 1),        # one epoch (tests/test_kernels.py:99)
])
def test_cd_solve_ref_matches_vmapped_reference_solver(L, per, S, d, C,
                                                       max_epochs):
    rng = np.random.default_rng(L * 1000 + per)
    xh = _rows(rng, L * per, d).reshape(L, per, d)
    xs = _rows(rng, S, d)
    y = _labels(rng, np.concatenate([xh.reshape(-1, d), xs])).astype(np.float32)
    yh, ys = y[:L * per].reshape(L, per), y[L * per:]
    mh = (rng.random((L, per)) > 0.1).astype(np.float32)
    ms = (rng.random(S) > 0.3).astype(np.float32)
    y_aug = np.concatenate([yh, np.broadcast_to(ys, (L, S))], 1)
    m_aug = np.concatenate([mh, np.broadcast_to(ms, (L, S))], 1)
    tol = 1e-3

    alpha, w, b, t, viol = ref.cd_solve_ref(
        torch.from_numpy(xh), torch.from_numpy(xs), torch.from_numpy(y_aug),
        torch.from_numpy(m_aug), C=C, tol=tol, max_epochs=max_epochs)

    jcfg = JSVMConfig(C=C, tol=tol, max_epochs=max_epochs)
    Xa = np.concatenate([xh, np.broadcast_to(xs, (L, S, d))], 1)
    jres = jax.vmap(lambda X, yy, mm: j_fit_binary_linear(X, yy, mm, jcfg))(
        jnp.asarray(Xa), jnp.asarray(y_aug), jnp.asarray(m_aug))
    np.testing.assert_allclose(alpha.numpy(), np.asarray(jres.alpha), atol=1e-5)
    np.testing.assert_allclose(w.numpy(), np.asarray(jres.w), atol=1e-5)
    np.testing.assert_allclose(b.numpy(), np.asarray(jres.b), atol=1e-5)
    np.testing.assert_array_equal(t.numpy(), np.asarray(jres.epochs_run))
    np.testing.assert_allclose(viol.numpy(), np.asarray(jres.max_violation),
                               atol=1e-5)


def test_cd_solve_zero_epochs_leaves_state_empty():
    xh = torch.ones((2, 3, 8))
    alpha, w, b, t, viol = ref.cd_solve_ref(
        xh, torch.zeros((0, 8)), torch.ones((2, 3)), torch.ones((2, 3)),
        C=1.0, tol=1e-3, max_epochs=0)
    assert not alpha.any() and not w.any() and not b.any()
    assert t.tolist() == [0, 0] and torch.isinf(viol).all()


@pytest.mark.parametrize("n,d,L", [(100, 32, 4), (512, 64, 8), (700, 48, 3)])
@pytest.mark.parametrize("chunk_rows", [64, 4096])
def test_hinge_scores_ref_matches_pallas_risk_eval(n, d, L, chunk_rows):
    rng = np.random.default_rng(n * L)
    X = rng.normal(size=(n, d)).astype(np.float32)
    W = rng.normal(size=(L, d)).astype(np.float32)
    b = rng.normal(size=L).astype(np.float32)
    y = np.sign(rng.normal(size=n)).astype(np.float32)
    m = (rng.random(n) > 0.2).astype(np.float32)
    loss, cnt = ref.hinge_scores_ref(*(torch.from_numpy(a) for a in
                                       (X, W, b, y, m)), chunk_rows=chunk_rows)
    loss_j, cnt_j = risk_eval(*(jnp.asarray(a) for a in (X, W, b, y, m)),
                              bn=128)
    np.testing.assert_allclose(loss.numpy(), np.asarray(loss_j), rtol=1e-5)
    assert float(cnt) == float(cnt_j)


def test_stable_sort_breaks_top_k_ties_like_lax_top_k():
    v = np.array([[0.5, 1, 1, 0.2, 1, 1]], np.float32)
    _, j_idx = jax.lax.top_k(jnp.asarray(v), 3)
    _, t_idx = torch.sort(torch.from_numpy(v), dim=1, descending=True,
                          stable=True)
    assert t_idx[:, :3].tolist() == np.asarray(j_idx).tolist() == [[1, 2, 4]]


def test_wrappers_check_inputs():
    x = torch.zeros((2, 3, 8))
    with pytest.raises(ValueError, match="features"):
        ops.cd_solve(x, torch.zeros((1, 4)), torch.zeros((2, 4)),
                     torch.zeros((2, 4)), C=1.0, tol=1e-3, max_epochs=1)
    with pytest.raises(ValueError, match="rows must be"):
        ops.cd_solve(x.double(), torch.zeros((0, 8), dtype=torch.float64),
                     torch.zeros((2, 3)), torch.zeros((2, 3)), C=1.0,
                     tol=1e-3, max_epochs=1)
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.gram(*(torch.zeros((4, 8), device="meta") for _ in range(2)))
    # meta tensors take the shape rule where a wrapper has one
    loss, cnt = ops.hinge_scores(*(torch.zeros(s, device="meta") for s in
                                   ((4, 8), (2, 8), (2,), (4,), (4,))))
    assert loss.is_meta and tuple(loss.shape) == (2,) and cnt.dim() == 0


def test_wrappers_count_no_launch_on_cpu():
    ops.reset_launches()
    ops.hinge_scores(torch.ones((4, 8)), torch.ones((2, 8)), torch.zeros(2),
                     torch.ones(4), torch.ones(4))
    assert set(ops.LAUNCHES) == {"cd_solve", "hinge_scores", "gram",
                                 "sparse_gram", "cd_solve_gram",
                                 "flash_decode"}
    assert not any(ops.LAUNCHES.values())


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_neither_jax_nor_the_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    twins = sorted((ROOT / "examples").glob("torch_*.py"))
    assert len(files) > 10 and len(twins) >= 4
    files += twins
    # the cluster launch's modules and its example twin are walked too
    walked = {str(f.relative_to(ROOT)) for f in files}
    assert {"src/repro_torch/launch/cluster.py",
            "src/repro_torch/launch/train.py",
            "src/repro_torch/launch/multihost.py",
            "examples/torch_multihost_svm.py"} <= walked
    bad = [(str(f.relative_to(ROOT)), mod) for f in files
           for mod in _imports(f)
           if mod.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert bad == []


def test_entry_points_refuse_to_run_without_a_card(monkeypatch):
    from repro_torch.core import MRSVMConfig, fit_binary, fit_mapreduce
    from repro_torch.text import fit_transform
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X = np.eye(8, dtype=np.float32)
    y = np.ones(8, np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fit_mapreduce(X, y, 2, MRSVMConfig(sv_capacity=4))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fit_binary(X, y)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fit_transform(X)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fit_mapreduce(torch.from_numpy(X), y, 2, MRSVMConfig(sv_capacity=4),
                      device="cuda")
    from repro_torch.configs import get_config
    from repro_torch.models import build_model, smoke_variant
    from repro_torch.serving import BatchScheduler, StreamingSVMService
    with pytest.raises(RuntimeError, match="device='cpu'"):
        StreamingSVMService(MRSVMConfig(sv_capacity=4))
    model = build_model(smoke_variant(get_config("tinyllama-1.1b")))
    params = model.init(torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BatchScheduler(model, params, batch_size=1, cache_len=8)
