"""Named placement-rule sets, ported from ``repro/launch/rules.py``.

``baseline`` is the standard (Megatron tensor parallelism over
``model`` + FSDP over ``data``); the others are the reference's variants,
chosen per run with ``rules=`` without touching model code.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

from repro_torch.launch.sharding import DEFAULT_RULES

RULE_SETS: Dict[str, Dict[Optional[str], Tuple[str, ...]]] = {
    "baseline": DEFAULT_RULES,
    # TP only: params replicated over data (no FSDP gathers; for models
    # that fit replicated)
    "tp_only": {**DEFAULT_RULES, "embed": ()},
    # FSDP heavier: ffn to data first (less model-axis traffic, more
    # data-axis gathers)
    "fsdp_ffn": {**DEFAULT_RULES, "ffn": ("data", "model")},
    # expert first: for MoE, experts on model and ffn on data
    "expert_first": {**DEFAULT_RULES, "ffn": ("data", "model"),
                     "experts": ("model",)},
}


def get_rules(name: str):
    if name not in RULE_SETS:
        raise KeyError(f"unknown rule set {name!r}; have {list(RULE_SETS)}")
    return RULE_SETS[name]
