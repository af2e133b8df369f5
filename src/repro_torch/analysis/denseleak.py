"""Rule 4: dense-materialization lint, the counterpart of
``repro/analysis/denseleak.py``.

The blocked-CSR path's value is that nothing materializes an O(n·d)
dense row block at vocabulary-scale ``d``: an edit that densifies a
whole shard would silently inflate memory a hundredfold. Two layers:

* :func:`check_no_dense_materialization` runs a program once under a
  ``TorchDispatchMode``: any op output whose last dim is the feature dim
  ``d`` and whose leading dims multiply past ``max_dense_rows`` is a
  violation naming the op. The ceiling is the allowlist. A kernel's
  plain version is read as the kernel, by its outputs
  (:func:`repro_torch.analysis.base.run_plain`).
* :func:`check_memory_ceiling` takes the peak of
  ``torch.cuda.max_memory_allocated`` over one call on a card, above
  what was allocated before it (the port's counterpart of a compiled
  program's temp memory), and holds it under a caller-derived limit. On
  the CPU there are no device memory stats, and the report says so in
  its ``note``, as the reference notes a backend without
  ``memory_analysis``.
"""
from __future__ import annotations

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.analysis.base import (LintViolation, RuleReport, linting,
                                      tensor_leaves)

RULE = "dense-materialization"

# a chunked densify's scratch width plus headroom for a config axis on
# top of it (the reference's ceiling)
DEFAULT_MAX_DENSE_ROWS = 256


class _DenseMode(TorchDispatchMode):
    def __init__(self, program: str, d: int, max_dense_rows: int):
        super().__init__()
        self.program, self.d, self.max_rows = program, d, max_dense_rows
        self.checked = 0

    def on_kernel(self, name, inputs, out) -> None:
        self._check(name, out)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self._check(func.overloadpacket.__name__, out)
        return out

    def _check(self, op: str, out) -> None:
        for t in tensor_leaves(out):
            shape = tuple(t.shape)
            if len(shape) < 2 or shape[-1] != self.d:
                continue
            self.checked += 1
            rows = 1
            for s in shape[:-1]:
                rows *= int(s)
            if rows > self.max_rows:
                raise LintViolation(
                    RULE, self.program, op,
                    f"an output of shape {shape} materializes {rows} dense "
                    f"rows at feature dim d={self.d} (ceiling: "
                    f"{self.max_rows} rows). A sparse program must never "
                    "inflate a full row block.")


def check_no_dense_materialization(
        fn, args, *, d: int,
        max_dense_rows: int = DEFAULT_MAX_DENSE_ROWS,
        program: str = "<program>") -> RuleReport:
    """Run ``fn(*args)`` once and reject op outputs of shape ``(..., d)``
    with more than ``max_dense_rows`` leading rows. Run this on
    blocked-CSR programs only: the dense path holds (n, d) blocks by
    design."""
    mode = _DenseMode(program, d, max_dense_rows)
    with linting(mode):
        fn(*args)
    return RuleReport(rule=RULE, program=program, checked=mode.checked)


def check_memory_ceiling(fn, args, *, limit_bytes: int,
                         program: str = "<program>") -> RuleReport:
    """The device memory that one call of ``fn(*args)`` allocates at its
    peak, above what was allocated before it, must stay under
    ``limit_bytes``. Callers derive the limit from the dense block the
    program must not allocate (one dense copy of a job's rows). On a
    card the report's ``note`` gives the peak and the limit; without
    one it is skipped with a note."""
    dev = next((t.device for t in tensor_leaves(args) if t.is_cuda), None)
    if dev is None or not torch.cuda.is_available():
        return RuleReport(rule=RULE, program=program, checked=0,
                          note="skipped: no device memory stats")
    torch.cuda.synchronize(dev)
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    fn(*args)
    torch.cuda.synchronize(dev)
    peak = torch.cuda.max_memory_allocated(dev) - base
    if peak > limit_bytes:
        raise LintViolation(
            RULE, program, "max_memory_allocated",
            f"one call allocates {peak} B at its peak, over the sparse "
            f"ceiling {limit_bytes} B: an O(n·d) dense block is being "
            "materialized")
    return RuleReport(rule=RULE, program=program, checked=1,
                      note=f"peak {peak} B of limit {limit_bytes} B")
