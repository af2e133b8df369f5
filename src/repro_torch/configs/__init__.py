"""Workload configurations of the port, and the architecture registry
``get_config(arch_id)`` of the reference's ``repro/configs``: the
paper's svm-tfidf and every model configuration of the reference, the
dense and VLM decoders (tinyllama-1.1b, llama3-8b, qwen2-1.5b,
chatglm3-6b, llava-next-34b), the MoE decoders (mixtral-8x22b,
qwen3-moe-235b-a22b), the attention-free rwkv6-7b, the hybrid
zamba2-1.2b and the encoder-decoder whisper-base.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.svm_tfidf import CONFIG as SVM_TFIDF, SVMTfidfConfig

PORTED_ARCHS = ("svm_tfidf", "tinyllama_1_1b", "llama3_8b", "qwen2_1_5b",
                "chatglm3_6b", "llava_next_34b", "mixtral_8x22b",
                "qwen3_moe_235b_a22b", "rwkv6_7b", "zamba2_1_2b",
                "whisper_base")


def canonical(arch: str) -> str:
    """The module name of ``arch`` (the reference's aliases, such as
    ``qwen2-1.5b``, map as its ``_ALIASES`` do)."""
    return arch.replace("-", "_").replace(".", "_")


def get_config(arch: str):
    name = canonical(arch)
    if name not in PORTED_ARCHS:
        raise ModuleNotFoundError(
            f"unknown architecture {arch!r}; known: {', '.join(PORTED_ARCHS)}")
    return importlib.import_module(f"repro_torch.configs.{name}").CONFIG


__all__ = ["PORTED_ARCHS", "SVM_TFIDF", "SVMTfidfConfig", "canonical",
           "get_config"]
