"""Workload configurations of the port, and the architecture registry
``get_config(arch_id)`` of the reference's ``repro/configs``.

Only the ported architectures resolve: the paper's svm-tfidf and the
dense and VLM decoders (tinyllama-1.1b, llama3-8b, qwen2-1.5b,
chatglm3-6b, llava-next-34b). Every other architecture of the reference
raises ``NotImplementedError`` naming the roadmap item that ports it.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.svm_tfidf import CONFIG as SVM_TFIDF, SVMTfidfConfig

PORTED_ARCHS = ("svm_tfidf", "tinyllama_1_1b", "llama3_8b", "qwen2_1_5b",
                "chatglm3_6b", "llava_next_34b")

#: ROADMAP Queue 1 item of each architecture not ported yet
UNPORTED_ARCHS = {"mixtral_8x22b": "13d", "qwen3_moe_235b_a22b": "13d",
                  "rwkv6_7b": "13e", "zamba2_1_2b": "13e",
                  "whisper_base": "13f"}


def canonical(arch: str) -> str:
    """The module name of ``arch`` (the reference's aliases, such as
    ``qwen2-1.5b``, map as its ``_ALIASES`` do)."""
    return arch.replace("-", "_").replace(".", "_")


def get_config(arch: str):
    name = canonical(arch)
    if name not in PORTED_ARCHS:
        item = UNPORTED_ARCHS.get(name, "13")
        raise NotImplementedError(
            f"architecture {arch!r} is not ported to repro_torch yet "
            f"(ROADMAP Queue 1 item {item}); ported: "
            f"{', '.join(PORTED_ARCHS)}")
    return importlib.import_module(f"repro_torch.configs.{name}").CONFIG


__all__ = ["PORTED_ARCHS", "SVM_TFIDF", "SVMTfidfConfig", "canonical",
           "get_config"]
