"""Bounded retry with exponential backoff, ported from
``repro/faults/retry.py``.

The "survived" arm of the fault contract for transient failures:
coordinator handshakes and checkpoint writes retry a bounded number of
times with deterministic backoff; exhaustion converts the last error
into a typed :class:`~repro_torch.faults.plan.FaultDetected` naming the
layer, the cause and the operator action — never an anonymous
stack trace from deep inside a retry loop.
"""
from __future__ import annotations

import time
from typing import Callable, Optional, Tuple, Type

from repro_torch.faults.plan import FaultDetected, count


def retry_with_backoff(fn: Callable, *, attempts: int = 3,
                       base_s: float = 0.05, factor: float = 2.0,
                       max_s: float = 2.0,
                       retry_on: Tuple[Type[BaseException], ...]
                       = (Exception,),
                       on_retry: Optional[Callable] = None,
                       layer: str = "core", cause: str = "operation",
                       action: Optional[str] = None):
    """Call ``fn()`` up to ``attempts`` times, sleeping
    ``base_s * factor**i`` (capped at ``max_s``) between tries.

    Only ``retry_on`` exceptions are retried — anything else
    propagates immediately (a validation error is not a flaky wire).
    Each retry bumps the process-wide ``retries`` counter and calls
    ``on_retry(attempt_index, exc)`` so services can account for it in
    their throughput reports. Exhaustion raises
    :class:`FaultDetected(layer, cause, action)` chained to the last
    underlying error.
    """
    if attempts < 1:
        raise ValueError(f"attempts must be >= 1, got {attempts}")
    last: Optional[BaseException] = None
    for i in range(attempts):
        try:
            return fn()
        except retry_on as e:          # noqa: PERF203 — bounded loop
            last = e
            if i == attempts - 1:
                break
            count("retries")
            if on_retry is not None:
                on_retry(i, e)
            time.sleep(min(base_s * factor ** i, max_s))
    raise FaultDetected(
        layer, f"{cause} failed after {attempts} attempts: {last}",
        action) from last
