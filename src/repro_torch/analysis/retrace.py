"""Rule 2: retrace detector, the counterpart of
``repro/analysis/retrace.py``.

The reference's jit-cache discipline (module-level jits, power-of-two
wave buckets in the streaming service) exists so that steady-state hot
loops never meet a new program shape. The port has no jit; its
*compile events* are of two kinds:

* a kernel library built or loaded by
  :func:`repro_torch.kernels.build.load` (event ``build:<name>``);
* the first call in the process of a wrapper *signature* of
  :mod:`repro_torch.kernels.ops`: the wrapper, its route (``cuda`` on a
  card, ``plain`` on the CPU), its argument shapes and dtypes and its
  launch geometry (event ``<wrapper>[…]``). On the card a wrapper's
  kernel route and launch geometry are functions of these shapes,
  dtypes and static arguments, so a signature met before launches a
  kernel configuration met before. The signature is recorded at the
  wrapper's entry on either device, so the rule runs in the CPU tests;
  it counts no launch (``ops.LAUNCHES`` and ``ops.ROUTE_LAUNCHES`` count
  what they always did).

:func:`watch_compiles` collects the events of a region in the thread
that opened it; :func:`no_retrace` turns them into a failing check.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import List

from repro_torch.analysis.base import LintViolation

RULE = "retrace"

_SEEN: set = set()
_SEEN_LOCK = threading.Lock()
_WATCHERS = threading.local()


class RetraceError(LintViolation):
    def __init__(self, program: str, events: List[str]):
        names = ", ".join(events) or "<unknown>"
        super().__init__(RULE, program, names,
                         f"{len(events)} compile event(s) inside a "
                         "steady-state region that must meet only kernel "
                         "libraries and wrapper signatures met before")
        self.events = list(events)


@dataclasses.dataclass
class RetraceStats:
    """Mutable capture handed to the ``with`` body: ``events`` grows one
    name per compile event observed inside the region."""
    events: List[str] = dataclasses.field(default_factory=list)

    @property
    def count(self) -> int:
        return len(self.events)


def _watchers() -> list:
    w = getattr(_WATCHERS, "stack", None)
    if w is None:
        w = _WATCHERS.stack = []
    return w


def note_compile(event: str) -> None:
    """Record one compile event for every region open in this thread."""
    for stats in _watchers():
        stats.events.append(event)


def _describe(a) -> str:
    shape = getattr(a, "shape", None)
    dtype = getattr(a, "dtype", None)
    if shape is not None and dtype is not None:
        return f"{str(dtype).replace('torch.', '')}{list(shape)}"
    if isinstance(a, (tuple, list)):
        return "(" + ",".join(_describe(x) for x in a) + ")"
    if isinstance(a, (int, float)) and not isinstance(a, bool):
        return type(a).__name__
    return repr(a)


def _leaves(a):
    """Tensors of an argument: tensors, ``SparseRows`` (indices, values
    and d), tuples of them; anything else as it is."""
    if hasattr(a, "indices") and hasattr(a, "values") and hasattr(a, "d"):
        return (a.indices, a.values, f"d={a.d}")
    if isinstance(a, (tuple, list)):
        return tuple(_leaves(x) for x in a)
    return a


def note_signature(wrapper: str, *args, **static) -> None:
    """Record a call of ops wrapper ``wrapper``: a compile event when its
    signature (route, argument shapes and dtypes, static arguments) is
    new in this process."""
    dev = next((getattr(t, "device", None) for t in _flat(args)
                if getattr(t, "device", None) is not None), None)
    route = "cuda" if dev is not None and dev.type == "cuda" else "plain"
    sig = (wrapper, route, _describe(tuple(_leaves(a) for a in args)),
           tuple(sorted((k, _describe(v)) for k, v in static.items())))
    with _SEEN_LOCK:
        if sig in _SEEN:
            return
        _SEEN.add(sig)
    extra = ",".join(f"{k}={v}" for k, v in sig[3])
    note_compile(f"{wrapper}[{route}:{sig[2]}{';' + extra if extra else ''}]")


def _flat(args):
    for a in args:
        a = _leaves(a)
        if isinstance(a, tuple):
            yield from _flat(a)
        else:
            yield a


@contextlib.contextmanager
def watch_compiles():
    """Count compile events in a region without failing: the accounting
    primitive under :func:`no_retrace` and the streaming service's
    retrace counter. Yields :class:`RetraceStats`."""
    stats = RetraceStats()
    stack = _watchers()
    stack.append(stats)
    try:
        yield stats
    finally:
        stack.remove(stats)


@contextlib.contextmanager
def no_retrace(program: str = "<steady state>", allow: int = 0):
    """Fail with :class:`RetraceError` if more than ``allow`` compile
    events happen inside the region. ``allow`` is the explicit allowlist
    knob: a warm-up region that may compile N programs passes
    ``allow=N`` and still catches the N+1st."""
    with watch_compiles() as stats:
        yield stats
    if stats.count > allow:
        raise RetraceError(program, stats.events)
