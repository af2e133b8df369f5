"""Deterministic fault injection, ported from ``repro/faults/plan.py``.

Every data boundary of the port has an explicit, seed-driven *seam*
where a fault can be injected, and one typed vocabulary
(:class:`FaultDetected`) for how a hardened layer reports a fault it
caught. The contract each seam-bearing layer owes the chaos harness
(:mod:`repro_torch.faults.chaos`):

* **survived** — a transient fault (a delayed round, a flaky merge call,
  a failed checkpoint write) is absorbed by retry with backoff and the
  run ends bit for bit as the fault-free run;
* **detected** — a corrupting or terminal fault (a garbled wire,
  flipped snapshot bytes, poisoned rows, a dead scheduler, a stalled
  fold) raises
  :class:`FaultDetected` naming the layer and the cause, with the
  operator's action;
* never a hang, never a silent wrong answer.

Seams consult the process-wide *active plan* (:func:`inject` /
:func:`set_active`) and cost nothing when none is armed. All seams here
fire on the host, at call time: before any launch, except
:func:`garble_wire`, which changes a received message on its device.
The plans, their draws and the seams' randomness are the reference's:
the same seed gives the same faults, rows and bytes in both packages.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
import time
import zlib
from collections import Counter
from typing import Dict, Iterable, Optional, Tuple

import numpy as np
import torch

# fault kind → the layer whose hardening owns it
KINDS: Dict[str, str] = {
    "delay_round": "transport",      # a round's merge stalls, then completes
    "transport_exc": "transport",    # the merge call raises transiently
    "ring_garble": "transport",      # bits flip on the wire mid-hop
    "stall": "transport",            # stranded-in-collective hang
    "ckpt_write_fail": "ckpt",       # snapshot/manifest write raises
    "ckpt_corrupt": "ckpt",          # written media truncated/bit-flipped
    "poison_rows": "serving",        # NaN/Inf rows at the featurizer seam
    "scheduler_kill": "serving",     # the wave scheduler thread dies
    "handshake_flake": "cluster",    # coordinator handshake flaps
}


class FaultDetected(RuntimeError):
    """A fault crossed a hardened boundary and was caught: typed, named by
    layer and cause, with the operator's action."""

    def __init__(self, layer: str, cause: str,
                 action: Optional[str] = None):
        self.layer, self.cause, self.action = layer, cause, action
        msg = f"[{layer}] {cause}"
        if action:
            msg += f" — {action}"
        super().__init__(msg)


class InjectedFault(RuntimeError):
    """Raised by an armed seam: the fault itself, not its detection."""

    def __init__(self, spec: "FaultSpec", seam: str):
        self.spec, self.seam = spec, seam
        super().__init__(f"injected {spec.kind} at seam {seam!r}")


class TransientFault(InjectedFault):
    """An injected failure a retry is expected to absorb."""


class InjectedWriteError(OSError):
    """Injected I/O failure: an ``OSError``, so write-retry filters
    (``retry_on=OSError``) treat it as the real thing."""

    def __init__(self, spec: "FaultSpec", seam: str):
        self.spec, self.seam = spec, seam
        super().__init__(f"injected {spec.kind} at seam {seam!r}")


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One scheduled fault: ``kind`` (see :data:`KINDS`), ``when`` — the
    round, wave or hop it targets (``None``: the first opportunity),
    ``count`` — how many times a transient seam fires before letting the
    call through, ``param`` — kind-specific salt (corruption mode, poison
    seed, …)."""
    kind: str
    when: Optional[int] = None
    count: int = 1
    param: int = 0

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} "
                             f"(known: {sorted(KINDS)})")

    @property
    def layer(self) -> str:
        return KINDS[self.kind]


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A seeded, deterministic schedule of faults. The same (constructor,
    seed) gives the same specs and the same per-seam randomness
    (:meth:`rng` derives substreams from the seed and a string salt)."""
    seed: int
    specs: Tuple[FaultSpec, ...]

    def rng(self, *salt) -> np.random.Generator:
        keys = [self.seed] + [zlib.crc32(str(s).encode()) for s in salt]
        return np.random.default_rng(keys)

    @classmethod
    def single(cls, kind: str, seed: int) -> "FaultPlan":
        """One seeded fault of ``kind`` (the chaos sweep's unit)."""
        g = np.random.default_rng([seed, zlib.crc32(kind.encode())])
        when: Optional[int] = None
        count = 1
        if kind == "delay_round":
            when = int(g.integers(0, 3))
        elif kind == "ring_garble":
            when = int(g.integers(1, 7))        # hop 1..6 of an 8-ring
        elif kind in ("transport_exc", "ckpt_write_fail",
                      "handshake_flake"):
            count = 1 + int(g.integers(0, 2))   # 1-2 transient failures
        return cls(seed=seed,
                   specs=(FaultSpec(kind, when=when, count=count,
                                    param=int(g.integers(0, 1 << 30))),))

    @classmethod
    def from_seed(cls, seed: int,
                  kinds: Optional[Iterable[str]] = None) -> "FaultPlan":
        """A mixed plan: 2-4 seeded faults drawn from ``kinds``."""
        pool = sorted(kinds) if kinds is not None else sorted(KINDS)
        g = np.random.default_rng([seed, len(pool)])
        picked = g.choice(len(pool), size=int(g.integers(2, 5)),
                          replace=True)
        specs = tuple(s for i in picked
                      for s in cls.single(pool[i], seed).specs)
        return cls(seed=seed, specs=specs)


class _ArmedPlan:
    """Runtime state of an active plan: fires left per spec and a log of
    what fired (scenario checks read it)."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self.remaining = [s.count for s in plan.specs]
        self.fired: list = []
        self.lock = threading.Lock()


_ACTIVE: Optional[_ArmedPlan] = None
_COUNTS: Counter = Counter()
_COUNT_LOCK = threading.Lock()


def count(name: str, n: int = 1) -> None:
    """Bump a process-wide hardening counter (retries, watchdog_fires,
    quarantined, ckpt_fallbacks, …)."""
    with _COUNT_LOCK:
        _COUNTS[name] += n


def counters() -> Dict[str, int]:
    with _COUNT_LOCK:
        return dict(_COUNTS)


def reset_counters() -> None:
    with _COUNT_LOCK:
        _COUNTS.clear()


def set_active(plan: Optional[FaultPlan]) -> None:
    """Arm ``plan`` process-wide (``None`` disarms); tests prefer the
    scoped :func:`inject`."""
    global _ACTIVE
    _ACTIVE = _ArmedPlan(plan) if plan is not None else None


def active() -> Optional[_ArmedPlan]:
    return _ACTIVE


@contextlib.contextmanager
def inject(plan: FaultPlan):
    """Scope an armed plan: seams fire inside, and the previous plan, if
    any, is back on exit. Yields the armed state (``.fired``,
    ``.remaining``)."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = armed = _ArmedPlan(plan)
    try:
        yield armed
    finally:
        _ACTIVE = prev


def fire(seam: str, kinds: Iterable[str],
         when: Optional[int] = None) -> Optional[FaultSpec]:
    """Consume one armed fault matching this seam, or ``None``: a spec of
    a kind the seam serves, whose ``when`` is unset or the caller's, with
    fires left. Each match takes one fire off the spec's count."""
    armed = _ACTIVE
    if armed is None:
        return None
    kindset = set(kinds)
    with armed.lock:
        for i, spec in enumerate(armed.plan.specs):
            if (spec.kind in kindset and armed.remaining[i] > 0
                    and (spec.when is None or when is None
                         or spec.when == when)):
                armed.remaining[i] -= 1
                armed.fired.append((seam, spec, when))
                count(f"injected.{spec.kind}")
                return spec
    return None


def maybe_raise(seam: str, kinds: Iterable[str],
                when: Optional[int] = None) -> None:
    """Raise the typed injected error if a matching fault is armed:
    write kinds :class:`InjectedWriteError` (an ``OSError``), transient
    kinds :class:`TransientFault`, the rest :class:`InjectedFault`."""
    spec = fire(seam, kinds, when)
    if spec is None:
        return
    if spec.kind == "ckpt_write_fail":
        raise InjectedWriteError(spec, seam)
    if spec.kind in ("transport_exc", "handshake_flake"):
        raise TransientFault(spec, seam)
    raise InjectedFault(spec, seam)


def maybe_sleep(seam: str, when: Optional[int] = None,
                max_s: float = 0.5) -> float:
    """Host delay seam (``delay_round``): stall the caller a seeded time
    below ``max_s``. Returns the seconds slept."""
    armed = _ACTIVE
    spec = fire(seam, ("delay_round",), when)
    if spec is None:
        return 0.0
    dt = float(armed.plan.rng("delay", spec.param).uniform(0.05, max_s))
    time.sleep(dt)
    return dt


def garble_wire(msg, hop: int):
    """The packed transports' wire-corruption seam (``ring_garble``).

    Called on the message a rank receives at hop ``hop`` of a ring or
    hier merge, every round. With a matching armed fault it flips one
    seeded mantissa bit of one f32 lane — the lane and bit the
    reference draws from the same plan, below the last lane so that an
    appended integrity lane is never the one flipped and the checksum
    mismatch is certain. Every rank arms the same plan, so every rank
    flips its received message at the same hop, as the reference's
    traced program does on every device. Without an armed plan the
    message passes through untouched.
    """
    armed = _ACTIVE
    spec = fire("transport.wire", ("ring_garble",), when=hop)
    if spec is None or msg is None:
        return msg
    g = armed.plan.rng("garble", hop, spec.param)
    lane = int(g.integers(0, max(int(msg.shape[0]) - 1, 1)))
    bit = 1 << int(g.integers(1, 23))           # mantissa bit: value changes
    out = msg.clone()
    bits = out.view(torch.int32)
    bits[lane] ^= bit
    return out


def poison_batch(X, y, spec: FaultSpec):
    """Featurizer-seam corruption (``poison_rows``): a seeded NaN or Inf
    lands in one row of the batch, as a hostile or buggy upstream
    vectorizer would hand it to ``submit()``. The same plan picks the
    same value, row and column as the reference's; the batch is copied,
    never changed in place. ``X`` is a tensor, numpy rows or
    :class:`repro_torch.sparse.SparseRows` (whose slot 0 of the row is
    hit, as the reference's)."""
    from repro_torch import sparse as sparse_rows
    armed = _ACTIVE
    g = (armed.plan.rng("poison", spec.param) if armed is not None
         else np.random.default_rng(spec.param))
    bad = float("nan") if int(g.integers(0, 2)) else float("inf")
    row = int(g.integers(0, X.shape[0]))
    if sparse_rows.is_sparse(X):
        vals = X.values.clone()
        vals[row, 0] = bad
        return sparse_rows.SparseRows(X.indices, vals, X.d,
                                      X.ids_in_range), y
    col = int(g.integers(0, X.shape[1]))
    X = (torch.from_numpy(np.array(X)) if isinstance(X, np.ndarray)
         else torch.as_tensor(X).clone())
    X[row, col] = bad
    return X, y


def corrupt_file(path: str, spec: FaultSpec,
                 rng: Optional[np.random.Generator] = None) -> str:
    """Media-corruption seam (``ckpt_corrupt``): truncate the file or flip
    one seeded byte, the two shapes a torn write or a bad disk leaves.
    Returns what was done."""
    armed = _ACTIVE
    g = rng if rng is not None else (
        armed.plan.rng("media", spec.param) if armed is not None
        else np.random.default_rng(spec.param))
    size = os.path.getsize(path)
    if spec.param % 2:
        keep = max(size // 2, 1)
        with open(path, "r+b") as f:
            f.truncate(keep)
        return f"truncated {size}B→{keep}B"
    off = int(g.integers(0, max(size, 1)))
    with open(path, "r+b") as f:
        f.seek(off)
        byte = f.read(1) or b"\x00"
        f.seek(off)
        f.write(bytes([byte[0] ^ (1 << int(g.integers(0, 8)))]))
    return f"bit-flipped byte {off}/{size}"


def check_finite_risks(risks, where: str = "round",
                       mask=None) -> None:
    """Detection of poisoned state on a host readback of the risks (a
    numpy array: the caller's eq. 8 readback, so no new sync). +inf is
    the ring wire checksum's sentinel in the reference's sharded mode;
    NaN means non-finite rows reached a fold. Raises
    :class:`FaultDetected` naming the layer; silent on finite risks."""
    r = np.asarray(risks)
    if mask is not None:
        r = r[np.asarray(mask)]
    if r.size == 0 or bool(np.isfinite(r).all()):
        return
    if bool(np.isinf(r).any()) and not bool(np.isnan(r).any()):
        raise FaultDetected(
            "transport",
            f"+inf empirical risk at {where}: the ring wire checksum "
            "flagged a garbled merge message",
            action="re-run the round from the last checkpoint (the "
            "fault is transient; persistent mismatches mean a bad link)")
    raise FaultDetected(
        "core",
        f"NaN empirical risk at {where}: non-finite feature rows or "
        "labels reached a fold",
        action="quarantine the offending batch (serving does this at "
        "submit()) and restore the last intact snapshot")
