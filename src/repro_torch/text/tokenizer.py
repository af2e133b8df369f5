"""Tweet normalization + hashing vectorizer.

The paper's pipeline: stopword removal (Tablo 4) → vector space → TF×IDF.
2014 Hadoop used sparse term dictionaries; terms are hashed into a
fixed feature space (``num_features``) instead, as dense count rows or
as blocked-CSR rows (:mod:`repro_torch.sparse`). Host-side numpy,
byte-identical to the reference featurizer.
"""
from __future__ import annotations

import re
import zlib
from collections import Counter
from typing import Iterable, List, Sequence

import numpy as np

from repro_torch import sparse as sparse_rows
from repro_torch.text.stopwords import TURKISH_STOPWORDS

_URL_RE = re.compile(r"https?://\S+|www\.\S+")
_MENTION_RE = re.compile(r"[@#]\w+")
_NONWORD_RE = re.compile(r"[^a-zçğıöşü0-9\s]+")

# Turkish-aware lowercase: dotted/dotless i must not go through ASCII rules.
_TR_LOWER = str.maketrans({"İ": "i", "I": "ı"})


def normalize(text: str) -> str:
    text = text.translate(_TR_LOWER).lower()
    text = _URL_RE.sub(" ", text)
    text = _MENTION_RE.sub(" ", text)
    text = _NONWORD_RE.sub(" ", text)
    return text


def tokenize(text: str, remove_stopwords: bool = True) -> List[str]:
    toks = normalize(text).split()
    if remove_stopwords:
        toks = [t for t in toks if t not in TURKISH_STOPWORDS]
    return toks


def hash_token(token: str, num_features: int) -> int:
    """Stable (process-independent) token hash — zlib.crc32, not hash()."""
    return zlib.crc32(token.encode("utf-8")) % num_features


def count_matrix(docs: Iterable[Sequence[str]], num_features: int,
                 dtype=np.float32) -> np.ndarray:
    """Token-count matrix (n_docs, num_features) from tokenized docs."""
    docs = list(docs)
    out = np.zeros((len(docs), num_features), dtype)
    for i, toks in enumerate(docs):
        for t in toks:
            out[i, hash_token(t, num_features)] += 1.0
    return out


def vectorize(texts: Iterable[str], num_features: int,
              remove_stopwords: bool = True) -> np.ndarray:
    """Text → hashed count matrix in one shot."""
    return count_matrix((tokenize(t, remove_stopwords) for t in texts),
                        num_features)


def count_rows_sparse(docs: Iterable[Sequence[str]], num_features: int,
                      nnz_cap: int, dtype=np.float32):
    """Blocked-CSR token counts straight from tokenized docs, never an
    (n, d) dense matrix. Docs with more than ``nnz_cap`` distinct hashed
    terms keep their ``nnz_cap`` highest-count terms (ties by column
    id); in-row column ids are distinct by construction. → ``SparseRows``
    with CPU leaves."""
    docs = list(docs)
    indices = np.zeros((len(docs), nnz_cap), np.int32)
    values = np.zeros((len(docs), nnz_cap), dtype)
    for i, toks in enumerate(docs):
        counts = Counter(hash_token(t, num_features) for t in toks)
        top = sorted(counts.items(), key=lambda kv: (-kv[1], kv[0]))
        for j, (col, cnt) in enumerate(top[:nnz_cap]):
            indices[i, j] = col
            values[i, j] = cnt
    return sparse_rows.from_numpy_coo(indices, values, num_features)


def vectorize_sparse(texts: Iterable[str], num_features: int,
                     nnz_cap: int, remove_stopwords: bool = True):
    """Text → blocked-CSR hashed count rows in one shot."""
    return count_rows_sparse(
        (tokenize(t, remove_stopwords) for t in texts), num_features,
        nnz_cap)
