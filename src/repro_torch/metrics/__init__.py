"""Structured run metrics: a JSONL stream and rolling aggregates."""
from repro_torch.metrics.logger import MetricsLogger, read_jsonl

__all__ = ["MetricsLogger", "read_jsonl"]
