"""Shared vocabulary of the invariant linter, as the reference's
(``repro/analysis/base.py``).

Every rule reports through :class:`LintViolation`, one exception type
carrying (rule, program, op, detail), so ``python -m
repro_torch.analysis.lint`` and the tests print uniform messages naming
the offending op and the program it appeared in. A rule never prints
and goes on: a violation is an exception, an allowlisted occurrence is
silence plus an entry in the returned report.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Optional, Tuple

import torch


class LintViolation(AssertionError):
    """An invariant rule fired. ``rule``/``program``/``op`` are
    structured so tests can assert on what failed, not on prose."""

    def __init__(self, rule: str, program: str, op: str, detail: str):
        self.rule = rule
        self.program = program
        self.op = op
        self.detail = detail
        super().__init__(
            f"[{rule}] program={program!r} op={op!r}: {detail}")


@dataclasses.dataclass(frozen=True)
class Allowed:
    """One allowlisted occurrence: recorded, never raised, so a reader
    can audit what the allowlist absorbed."""
    rule: str
    program: str
    op: str
    reason: str


@dataclasses.dataclass(frozen=True)
class RuleReport:
    """Outcome of one rule over one program (returned on success; on
    failure the rule raises :class:`LintViolation` instead)."""
    rule: str
    program: str
    checked: int                       # ops the rule examined
    allowed: Tuple[Allowed, ...] = ()
    note: Optional[str] = None         # e.g. 'skipped: no device memory stats'


def tensor_leaves(tree) -> list:
    """The tensors of an argument tree in order: tensors, ``SparseRows``
    (indices, then values), tuples, lists, NamedTuples and dicts (by
    key) of them; anything else is skipped."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if hasattr(tree, "indices") and hasattr(tree, "values") \
            and hasattr(tree, "nnz_cap"):
        return [tree.indices, tree.values]
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in tensor_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [t for x in tree for t in tensor_leaves(x)]
    return []


_MODES = threading.local()


def _active() -> list:
    stack = getattr(_MODES, "stack", None)
    if stack is None:
        stack = _MODES.stack = []
    return stack


@contextlib.contextmanager
def linting(mode):
    """Enter a rule's ``TorchDispatchMode`` and register it, so that a
    kernel's plain version reaches it as one op (:func:`run_plain`)."""
    stack = _active()
    stack.append(mode)
    try:
        with mode:
            yield mode
    finally:
        stack.remove(mode)


def run_plain(name: str, fn, *args, **kwargs):
    """Run a kernel's plain version (a wrapper of
    :mod:`repro_torch.kernels.ops` given CPU tensors). Under the rules'
    dispatch modes it runs outside them and reaches each as one op
    named ``name`` (``mode.on_kernel(name, inputs, output)``), as a
    kernel on the card is one launch: the rules read its inputs and
    outputs, not the plain version's own steps (its early exits read
    the device; its Gram densifies)."""
    modes = list(_active())
    if not modes:
        return fn(*args, **kwargs)
    from torch.utils._python_dispatch import _disable_current_modes
    with _disable_current_modes():
        out = fn(*args, **kwargs)
    for mode in modes:
        mode.on_kernel(name, (args, kwargs), out)
    return out
