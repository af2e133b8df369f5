"""Workload configurations of the port, and the architecture registry
``get_config(arch_id)`` of the reference's ``repro/configs``.

Only the ported architectures resolve: the paper's svm-tfidf and
tinyllama-1.1b (the dense LM serve path). Every other architecture of
the reference raises ``NotImplementedError`` (ROADMAP Queue 1 item 13).
"""
from __future__ import annotations

import importlib

from repro_torch.configs.svm_tfidf import CONFIG as SVM_TFIDF, SVMTfidfConfig

PORTED_ARCHS = ("svm_tfidf", "tinyllama_1_1b")


def canonical(arch: str) -> str:
    return arch.replace("-", "_").replace(".", "_")


def get_config(arch: str):
    name = canonical(arch)
    if name not in PORTED_ARCHS:
        raise NotImplementedError(
            f"architecture {arch!r} is not ported to repro_torch yet "
            f"(ROADMAP Queue 1 item 13); ported: {', '.join(PORTED_ARCHS)}")
    return importlib.import_module(f"repro_torch.configs.{name}").CONFIG


__all__ = ["PORTED_ARCHS", "SVM_TFIDF", "SVMTfidfConfig", "canonical",
           "get_config"]
