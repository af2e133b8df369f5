"""Text substrate: the paper's TF×IDF sentiment pipeline (dense or
blocked-CSR rows)."""
from repro_torch.text.stopwords import TURKISH_STOPWORDS, is_stopword
from repro_torch.text.tokenizer import (count_matrix, count_rows_sparse,
                                        hash_token, normalize, tokenize,
                                        vectorize, vectorize_sparse)
from repro_torch.text.tfidf import (TfidfModel, fit_idf, fit_transform,
                                    transform)
from repro_torch.text.corpus import (CLASS_NEG, CLASS_NEU, CLASS_POS, Corpus,
                                     CorpusConfig, generate)
from repro_torch.text.feature_select import chi2_scores, select_top_k

__all__ = [
    "TURKISH_STOPWORDS", "is_stopword", "count_matrix", "count_rows_sparse",
    "hash_token", "normalize", "tokenize", "vectorize", "vectorize_sparse",
    "TfidfModel", "fit_idf", "fit_transform", "transform", "CLASS_NEG",
    "CLASS_NEU", "CLASS_POS", "Corpus", "CorpusConfig", "generate",
    "chi2_scores", "select_top_k",
]
