"""Rule 3: host-sync lint, the counterpart of
``repro/analysis/hostsync.py``.

Hot loops (``StreamingSVMService.run_wave``, ``core.sweep._run_rounds``,
the sharded round) may make the host wait on the device only at their
designed readback points (the eq. 8 risks). Two layers:

* runtime guard: :func:`no_implicit_host_sync` arms
  ``torch.cuda.set_sync_debug_mode("error")`` for a region, so any
  operation that synchronizes the host with the card raises; the
  designed readbacks are wrapped in :func:`allowed_host_sync` (mode 0
  inside), which is the explicit allowlist: every sanctioned sync point
  is named in source at its call site. Each region restores on exit the
  mode it found, so regions nest. On the CPU there is no device to wait
  for, and the guard cannot fire (:func:`host_guards_enforced` is
  False): the static layer below is the check that runs everywhere.
* static lint: :func:`check_no_host_callbacks` runs a hot-loop program
  once under a ``TorchDispatchMode`` and rejects every op that makes the
  host wait on device values outside an :func:`allowed_host_sync`
  region (a kernel's plain version is one op, as the card's launch):
  ``aten._local_scalar_dense`` (what ``.item()``, ``bool(t)``,
  ``int(t)`` and ``float(t)`` reach), the ops whose output shape depends
  on the data (``nonzero``, ``masked_select``, ``unique*``, indexing by
  a boolean mask) and a copy of a CUDA tensor to the host.

The sync debug mode is one setting of the process, not of a thread, so
a region belongs to the thread that armed it: :func:`allowed_host_sync`
changes the mode only in that thread (elsewhere it leaves the mode as it
is), and arming a second region from another thread raises. The
streaming service's scheduler thread is kept out of a region it did not
arm: while another thread holds one (:func:`armed_elsewhere`), its loop
folds nothing and waits, so the folds inside the region are the ones the
arming thread runs (``run_wave``, ``drain``) and a readback of the
scheduler's can neither trip the region nor disarm it. The static
layer's allowed regions are per thread.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Collection

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.analysis.base import (Allowed, LintViolation, RuleReport,
                                      linting)

RULE = "host-sync"

#: ops that read device values on the host (one device→host round trip a
#: call) or whose output shape depends on the data (the host waits for it)
_HOST_WAIT_OPS = frozenset({"nonzero", "nonzero_static", "masked_select",
                             "_unique", "_unique2", "unique_dim",
                             "unique_consecutive", "unique_dim_consecutive",
                             "argwhere", "_local_scalar_dense"})

_ALLOWED = threading.local()
#: the thread that armed the runtime guard, and its nesting depth
_ARMED = {"owner": None, "depth": 0}
_ARM_LOCK = threading.Lock()


def _allowed_depth() -> int:
    return getattr(_ALLOWED, "depth", 0)


def armed_elsewhere() -> bool:
    """Whether another thread holds a :func:`no_implicit_host_sync`
    region."""
    owner = _ARMED["owner"]
    return owner is not None and owner != threading.get_ident()


@contextlib.contextmanager
def _sync_mode(mode):
    """Set the sync debug mode for the block and restore the mode found
    (nothing without a card)."""
    if not torch.cuda.is_available():
        yield
        return
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(mode)
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


@contextlib.contextmanager
def no_implicit_host_sync():
    """Arm the host-sync tripwire for a region: on a card, any
    synchronizing operation in it raises (``set_sync_debug_mode
    ("error")``); the previous mode is restored on exit. Regions of
    one thread nest; another thread's region raises ``RuntimeError``."""
    me = threading.get_ident()
    with _ARM_LOCK:
        if armed_elsewhere():
            raise RuntimeError("no_implicit_host_sync is armed by another "
                               "thread")
        _ARMED["owner"] = me
        _ARMED["depth"] += 1
    try:
        with _sync_mode("error"):
            yield
    finally:
        with _ARM_LOCK:
            _ARMED["depth"] -= 1
            if _ARMED["depth"] == 0:
                _ARMED["owner"] = None


@contextlib.contextmanager
def allowed_host_sync(reason: str):
    """A designed sync point inside a :func:`no_implicit_host_sync`
    region (mode 0 inside, the mode found restored on exit). ``reason``
    is mandatory: the allowlist lives in source, next to the readback it
    sanctions. In a thread other than the arming one the mode is left
    as it is."""
    if not reason:
        raise ValueError("allowed_host_sync needs a reason")
    _ALLOWED.depth = _allowed_depth() + 1
    try:
        with (contextlib.nullcontext() if armed_elsewhere()
              else _sync_mode(0)):
            yield
    finally:
        _ALLOWED.depth -= 1


def host_guards_enforced(device=None) -> bool:
    """Whether the runtime guard can fire: False on the CPU (or for a
    ``device`` that is not CUDA), True on a card."""
    if device is not None and torch.device(device).type != "cuda":
        return False
    return torch.cuda.is_available()


def _bool_index(args) -> bool:
    """An ``aten.index``/``index_put`` whose indices hold a bool mask."""
    idx = args[1] if len(args) > 1 else ()
    return any(isinstance(t, torch.Tensor) and t.dtype == torch.bool
               for t in (idx or ()))


def host_sync_op(func, args, kwargs) -> str:
    """The name of the host-waiting op ``func`` is with these arguments,
    or "" when it is none."""
    name = func.overloadpacket.__name__
    if name in _HOST_WAIT_OPS:
        return name
    if name in ("index", "index_put", "index_put_") and _bool_index(args):
        return f"{name}[bool mask]"
    if name == "_to_copy" and args and isinstance(args[0], torch.Tensor) \
            and args[0].is_cuda:
        dev = (kwargs or {}).get("device")
        if dev is not None and torch.device(dev).type == "cpu":
            return "_to_copy[cuda->cpu]"
    if name == "copy_" and len(args) > 1 and all(
            isinstance(t, torch.Tensor) for t in args[:2]) \
            and args[1].is_cuda and args[0].device.type == "cpu":
        return "copy_[cuda->cpu]"
    return ""


class _HostSyncMode(TorchDispatchMode):
    def __init__(self, program: str, allow: Collection[str]):
        super().__init__()
        self.program = program
        self.allow = tuple(allow)
        self.checked = 0
        self.allowed = []

    def _allow(self, op: str, reason: str) -> None:
        """Record an allowed occurrence, once an (op, reason)."""
        entry = Allowed(RULE, self.program, op, reason)
        if entry not in self.allowed:
            self.allowed.append(entry)

    def on_kernel(self, name, inputs, out) -> None:
        self.checked += 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.checked += 1
        op = host_sync_op(func, args, kwargs)
        if op:
            if _allowed_depth() > 0:
                self._allow(op, "allowed_host_sync region")
            elif op in self.allow or op.split("[")[0] in self.allow:
                self._allow(op, "caller allowlist")
            else:
                raise LintViolation(
                    RULE, self.program, op,
                    "the host waits on device values inside a hot-loop "
                    "program: one implicit device→host round trip per "
                    "call (move it out of the loop, or wrap a designed "
                    "readback in allowed_host_sync)")
        return func(*args, **(kwargs or {}))


def check_no_host_callbacks(fn, args, program: str = "<program>",
                            allow: Collection[str] = ()) -> RuleReport:
    """Run ``fn(*args)`` once and reject every op that makes the host
    wait on device values outside an :func:`allowed_host_sync` region.
    ``allow`` names ops sanctioned for this program."""
    mode = _HostSyncMode(program, allow)
    with linting(mode):
        fn(*args)
    return RuleReport(rule=RULE, program=program, checked=mode.checked,
                      allowed=tuple(mode.allowed))
