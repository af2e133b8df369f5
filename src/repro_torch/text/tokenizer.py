"""Tweet normalization + hashing vectorizer.

The paper's pipeline: stopword removal (Tablo 4) → vector space → TF×IDF.
2014 Hadoop used sparse term dictionaries; terms are hashed into a
fixed dense feature space (``num_features``) instead. Host-side numpy,
byte-identical to the reference featurizer. Sparse rows wait for a
later slice of the port.
"""
from __future__ import annotations

import re
import zlib
from typing import Iterable, List, Sequence

import numpy as np

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
