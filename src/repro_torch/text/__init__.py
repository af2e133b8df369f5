"""Text substrate: the paper's TF×IDF sentiment pipeline (dense rows)."""
from repro_torch.text.stopwords import TURKISH_STOPWORDS, is_stopword
from repro_torch.text.tokenizer import (count_matrix, hash_token, normalize,
                                        tokenize, vectorize)
from repro_torch.text.tfidf import (TfidfModel, fit_idf, fit_transform,
                                    transform)
from repro_torch.text.corpus import (CLASS_NEG, CLASS_NEU, CLASS_POS, Corpus,
                                     CorpusConfig, generate)

__all__ = [
    "TURKISH_STOPWORDS", "is_stopword", "count_matrix", "hash_token",
    "normalize", "tokenize", "vectorize", "TfidfModel", "fit_idf",
    "fit_transform", "transform", "CLASS_NEG", "CLASS_NEU", "CLASS_POS",
    "Corpus", "CorpusConfig", "generate",
]
