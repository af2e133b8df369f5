"""Workload configurations of the port."""
from repro_torch.configs.svm_tfidf import CONFIG as SVM_TFIDF, SVMTfidfConfig

__all__ = ["SVM_TFIDF", "SVMTfidfConfig"]
