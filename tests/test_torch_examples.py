"""The port's example twins (``examples/torch_*.py``) on the CPU.

The three svm twins run at reduced sizes, and so do the reference's own
examples: each reference example module is loaded from its file and
run with its corpus sizes divided by ``SCALE`` and its hashed width set
to ``FEATURES`` (its ``CorpusConfig`` and ``vectorize`` wrapped), its
confusion matrices recorded and its printed accuracies read. Each
twin's confusion matrix (global %) is held to the reference's within
``CM_TOL`` points a cell and its accuracies within ``ACC_TOL``: the two
packages' predictions differ only where a message's score lies within
rounding of the decision boundary (``tests/test_torch_pipeline.py``).
The serve and embed twins run at their smoke sizes, and the serve CLI
takes each new architecture."""
import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.text as jtext
import repro.core as jcore
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.launch.serve import main as serve_main
from repro_torch.models import smoke_variant

ROOT = Path(__file__).resolve().parents[1]
SCALE, FEATURES = 4, 1024
# one cell of a 500-message matrix is 0.2 points a message
CM_TOL, ACC_TOL = 0.81, 0.0081


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The plain solves on the CPU are loops of small ops, which run
    fastest on one intra-op thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _load(name: str):
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _reference(name: str, monkeypatch):
    """The reference example ``name`` at the reduced sizes, its confusion
    matrices recorded in ``mod.matrices``."""
    mod = _load(name)
    mod.matrices = []

    def corpus_config(**kw):
        return jtext.CorpusConfig(**dict(kw, num_messages=kw["num_messages"]
                                         // SCALE))

    def confusion(*args, **kw):
        cm = jcore.confusion_matrix(*args, **kw)
        mod.matrices.append(np.asarray(cm))
        return cm
    monkeypatch.setattr(mod, "CorpusConfig", corpus_config)
    monkeypatch.setattr(mod, "vectorize",
                        lambda texts, num_features=None:
                        jtext.vectorize(texts, FEATURES))
    if hasattr(mod, "confusion_matrix"):
        monkeypatch.setattr(mod, "confusion_matrix", confusion)
    return mod


def _accuracies(text: str):
    return [float(a) for a in re.findall(r"acc=([0-9.]+)", text)]


def test_quickstart_twin_matches_the_reference(monkeypatch, capsys):
    ref = _reference("quickstart", monkeypatch)
    ref.main()
    got = _load("torch_quickstart").main(num_messages=2000 // SCALE,
                                         num_features=FEATURES, device="cpu")
    (want,) = ref.matrices
    np.testing.assert_allclose(got["confusion"], want, atol=CM_TOL)
    assert abs(got["accuracy"] - np.trace(want) / 100) <= ACC_TOL
    assert got["accuracy"] > 0.85


def test_polarization_report_twin_matches_the_reference(monkeypatch):
    ref = _reference("polarization_report", monkeypatch)
    ref.report_two_class()
    ref.report_three_class()
    got = _load("torch_polarization_report").main(
        num_messages=3000 // SCALE, num_features=FEATURES, device="cpu")
    two, three = ref.matrices
    np.testing.assert_allclose(got["two_class"], two, atol=CM_TOL)
    np.testing.assert_allclose(got["three_class"], three, atol=CM_TOL)
    assert got["three_class"].shape == (3, 3)


def test_incremental_update_twin_matches_the_reference(monkeypatch, capsys):
    ref = _reference("incremental_update", monkeypatch)
    ref.main()
    want = _accuracies(capsys.readouterr().out)
    got = _load("torch_incremental_update").main(
        initial_messages=1500 // SCALE, month_messages=1000 // SCALE,
        num_features=FEATURES, device="cpu")
    flat = [got["initial"]] + [a for m in got["months"] for a in m]
    assert len(want) == len(flat) == 5
    np.testing.assert_allclose(flat, want, atol=ACC_TOL)
    # the update keeps the model current: updated ≥ stale each month
    assert all(fresh >= stale for stale, fresh in got["months"])


def test_serve_twin_runs_each_ported_lm_at_smoke_size():
    mod = _load("torch_serve")
    ops.reset_launches()
    for arch in ("llama3-8b", "llava-next-34b"):
        res = mod.main(arch, batch=2, prompt_len=4, tokens=4, cache_len=16,
                       device="cpu")
        toks = res["tokens"]
        assert toks.shape == (2, 4) and toks.dtype == torch.int32
        vocab = smoke_variant(get_config(arch)).vocab_size
        assert 0 <= int(toks.min()) and int(toks.max()) < vocab
    assert ops.LAUNCHES["flash_decode"] == 0


def test_embed_twin_fits_the_svm_on_backbone_embeddings():
    res = _load("torch_embed_svm").main(messages=800, device="cpu")
    X = res["X"]
    assert X.shape == (800, 256) and X.dtype == torch.float32
    torch.testing.assert_close(X.norm(dim=1), torch.ones(800))
    assert res["svm"].rounds >= 1 and res["accuracy"] > 0.6


@pytest.mark.parametrize("arch", ["llama3-8b", "qwen2-1.5b", "chatglm3-6b",
                                  "llava-next-34b"])
def test_serve_cli_runs_each_new_architecture(arch):
    """``python -m repro_torch.launch.serve --arch …`` on each new config
    (smoke width, plain versions): llava decodes from token 0 with no
    prefix, as the reference's serve."""
    res = serve_main(["--arch", arch, "--smoke", "--batch", "2",
                      "--cache-len", "16", "--tokens", "3", "--device",
                      "cpu"])
    assert res.tokens.shape == (3, 2) and int(res.state.pos) == 3
