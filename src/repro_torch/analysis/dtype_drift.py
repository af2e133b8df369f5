"""Rule 5: dtype-drift lint, the counterpart of
``repro/analysis/dtype_drift.py``.

Solver state (the labels ``y``, the duals ``α``, the hypothesis ``(w,
b)``) is float32 by contract, and the one sanctioned reduced-precision
passage is the bf16 wire pack, which views the bf16 pairs as f32 lanes
at once (:func:`repro_torch.sparse.pack_lanes`, ``Tensor.view(dtype)``:
the port's ``bitcast_convert_type``). Anything else, a stray
``.to(torch.bfloat16)`` on ``α``, is silent precision loss that eq. 7
and eq. 8 then inherit.

Mechanism: forward taint over the ops that ``fn`` runs, observed once
under a ``TorchDispatchMode`` (the reference propagates over a jaxpr).
The caller marks the solver-state input tensors; taint flows through
every op, in-place ops taint the tensor they write, except the
comparison family (``eq``, ``ne``, ``lt``, ``gt``, ``ge``, ``le``,
``isfinite``, ``sign``, ``argmax``, ``argmin``, ``all``, ``any``), whose
outputs carry no precision; a kernel's plain version is one op from its
inputs to its outputs (:func:`repro_torch.analysis.base.run_plain`).
An op that turns a tainted ≥32-bit float input into a narrower float
output is a violation, unless its result
reaches a dtype view (``aten.view.dtype``) through layout-only ops (the
wire-pack allowlist: :class:`Allowed` with reason "bf16 wire pack"), or
the caller allowlists the op.
"""
from __future__ import annotations

from typing import Collection, List, Sequence

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.analysis.base import (Allowed, LintViolation, RuleReport,
                                      linting, tensor_leaves)

RULE = "dtype-drift"

#: ops that only rearrange elements between a downcast and the wire view
_LAYOUT_OPS = frozenset({
    "view", "_unsafe_view", "reshape", "expand", "permute", "transpose",
    "t", "slice", "select", "squeeze", "unsqueeze", "cat", "stack",
    "clone", "contiguous", "constant_pad_nd", "pad", "alias", "detach",
    "flatten", "unflatten", "split", "split_with_sizes", "as_strided",
    "narrow", "unbind", "copy_", "_to_copy", "lift_fresh",
})
#: outputs are boolean/ordinal structure, not solver precision
_STOP_OPS = frozenset({"eq", "ne", "lt", "gt", "ge", "le", "isfinite",
                       "sign", "argmax", "argmin", "all", "any"})


def _wide_float(t: torch.Tensor) -> bool:
    return t.dtype.is_floating_point and t.element_size() >= 4


def _narrow_float(t: torch.Tensor) -> bool:
    return t.dtype.is_floating_point and t.element_size() < 4


def _is_dtype_view(func, args) -> bool:
    return (func.overloadpacket.__name__ == "view" and len(args) > 1
            and isinstance(args[1], torch.dtype))


class _TaintMode(TorchDispatchMode):
    def __init__(self, program: str, tainted: Sequence[torch.Tensor]):
        super().__init__()
        self.program = program
        self.checked = 0
        # tensors are kept alive while tracked, so an id is never reused
        self._keep: List[torch.Tensor] = list(tainted)
        self._taint = {id(t) for t in tainted}
        self.pending = []            # (op, detail, reach set of ids, hit)

    def _mark(self, ids: set, ts) -> None:
        for t in ts:
            if id(t) not in ids:
                ids.add(id(t))
                self._keep.append(t)

    def on_kernel(self, name, inputs, out) -> None:
        self._flow(name, None, inputs[0], inputs[1], out)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self._flow(func.overloadpacket.__name__, func, args, kwargs, out)
        return out

    def _flow(self, name, func, args, kwargs, out) -> None:
        self.checked += 1
        ins = tensor_leaves((args, kwargs))
        outs = tensor_leaves(out)
        # an in-place op (and copy_) writes its first argument
        inplace = name.endswith("_") and ins and args \
            and isinstance(args[0], torch.Tensor)
        written = outs + ([args[0]] if inplace else [])
        tainted_in = [t for t in ins if id(t) in self._taint]
        # the wire-pack allowlist: a pending downcast whose result
        # reaches a dtype view through layout-only ops
        for p in self.pending:
            if not any(id(t) in p[2] for t in ins):
                continue
            if func is not None and _is_dtype_view(func, args):
                p[3] = True
            elif name in _LAYOUT_OPS:
                self._mark(p[2], written)
        if tainted_in and name not in _STOP_OPS:
            src = [t for t in tainted_in if _wide_float(t)]
            low = [t for t in written if _narrow_float(t)]
            if src and low:
                detail = (f"solver state downcast {src[0].dtype}→"
                          f"{low[0].dtype} by aten.{name}")
                self.pending.append([name, detail, set(), False])
                self._mark(self.pending[-1][2], low)
            self._mark(self._taint, written)


def check_no_dtype_drift(fn, args, *, taint: Sequence[bool],
                         program: str = "<program>",
                         allow_ops: Collection[str] = ()) -> RuleReport:
    """Run ``fn(*args)`` once and verify that no tainted (solver-state)
    value passes through a reduced-precision conversion outside the
    wire-pack allowlist. ``taint`` aligns with the tensors of ``args``
    in :func:`~repro_torch.analysis.base.tensor_leaves` order
    — True marks a solver-state tensor (y/α/w/b). ``allow_ops`` names
    ops the caller sanctions for this program."""
    leaves = tensor_leaves(args)
    if len(taint) != len(leaves):
        raise ValueError(f"taint mask has {len(taint)} entries for "
                         f"{len(leaves)} argument tensors")
    mode = _TaintMode(program, [t for t, m in zip(leaves, taint) if m])
    with linting(mode):
        fn(*args)
    allowed = []
    for name, detail, _, hit in mode.pending:
        if hit:
            allowed.append(Allowed(RULE, program, name, "bf16 wire pack"))
        elif name in allow_ops:
            allowed.append(Allowed(RULE, program, name,
                                   f"caller allowlist: {detail}"))
        else:
            raise LintViolation(RULE, program, name, detail)
    return RuleReport(rule=RULE, program=program, checked=mode.checked,
                      allowed=tuple(allowed))
