"""Beyond-paper example on the PyTorch port: the paper's MapReduce-SVM
head on FROZEN BACKBONE EMBEDDINGS instead of TF×IDF, as
examples/embed_svm.py.

Tweets → tokens → (reduced) backbone → mean-pooled hidden states →
iterative MapReduce SVM → polarity. On the card the SVM's rows are the
backbone's dtype (bf16 at full width): ``cd_solve`` and
``hinge_scores`` at d = d_model.

    PYTHONPATH=src python examples/torch_embed_svm.py --arch qwen2-1.5b  # cuda
    PYTHONPATH=src python examples/torch_embed_svm.py --device cpu
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import MRSVMConfig, SVMConfig, fit_mapreduce, predict
from repro_torch.device import resolve_device
from repro_torch.models import build_model, smoke_variant
from repro_torch.text import CorpusConfig, generate, tokenize
from repro_torch.text.tokenizer import hash_token

SEQ = 24
MCFG = MRSVMConfig(sv_capacity=128, gamma=1e-4, max_rounds=5,
                   svm=SVMConfig(C=1.0, max_epochs=20))


def token_ids(texts, vocab_size: int, seq: int = SEQ) -> np.ndarray:
    """Each message's first ``seq`` hashed tokens (ids 1..V−1, 0 pads)."""
    ids = np.zeros((len(texts), seq), np.int32)
    for i, text in enumerate(texts):
        toks = tokenize(text)[:seq]
        ids[i, :len(toks)] = [hash_token(t, vocab_size - 1) + 1 for t in toks]
    return ids


def embed(model, params, ids: torch.Tensor, batch: int = 64) -> torch.Tensor:
    """Mean-pooled final hidden states, L2-normalised rows (n, d_model)
    in the backbone's dtype."""
    feats = [model.hidden_states(params, ids[i:i + batch])[0].mean(1)
             for i in range(0, ids.shape[0], batch)]
    X = torch.cat(feats)
    return X / X.norm(dim=1, keepdim=True).clamp_min(1e-9)


def pipeline(model, params, messages: int = 800, partitions: int = 8,
             verbose: bool = True) -> dict:
    """Corpus → embeddings through ``model`` → MapReduce SVM, on the
    parameters' device; → rows, labels, the fit and its accuracy."""
    dev = params["embed"]["embedding"].device
    corpus = generate(CorpusConfig(num_messages=messages, classes=(-1, 1),
                                   seed=0))
    ids = torch.from_numpy(token_ids(corpus.texts, model.cfg.vocab_size))
    X = embed(model, params, ids.to(dev))
    y = torch.tensor(corpus.labels, dtype=torch.float32, device=dev)
    if verbose:
        print(f"embedded {X.shape[0]} messages → {X.shape[1]}-d "
              f"({model.cfg.name} backbone, {X.dtype})")
    svm = fit_mapreduce(X, y, num_partitions=partitions, cfg=MCFG,
                        verbose=verbose)
    acc = float((predict(svm, X, MCFG) == y).float().mean())
    return dict(X=X, y=y, svm=svm, accuracy=acc)


def main(arch: str = "qwen2-1.5b", messages: int = 800, device=None) -> dict:
    dev = resolve_device(device)
    cfg = smoke_variant(get_config(arch))
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    res = pipeline(model, params, messages)
    print(f"embedding-SVM accuracy: {res['accuracy']:.3f} "
          "(untrained backbone: structure only, not semantics)")
    return res


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--messages", type=int, default=800)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    a = ap.parse_args()
    main(a.arch, a.messages, a.device)
