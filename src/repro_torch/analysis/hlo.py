"""The collectives of a recorded schedule as the reference's HLO view,
the counterpart of ``repro/analysis/hlo.py``.

The reference parses the compiled program's HLO text into
:class:`CollectiveOp` records (kind, output shapes, replica groups,
source → target pairs, start/done halves). The port compiles no
program: :func:`repro_torch.compat.record_collectives` records each
collective as a rank issues it (:class:`repro_torch.compat.
CollectiveEntry`), and this module gives those entries the reference's
view: :func:`collective_ops` maps each onto a :class:`CollectiveOp` of
the reference's kind, with its group size, bytes and signature, so
that ``launch.hlo_analysis`` does the reference's byte arithmetic and
the dry run's records keep the reference's kind names.

The port's kinds and the reference's (:data:`KIND_OF`): ``psum`` and
``pmax`` ↔ all-reduce, ``psum_scatter`` ↔ reduce-scatter,
``all_gather`` and ``all_gather_groups`` ↔ all-gather,
``ppermute_start`` ↔ collective-permute (its
``ppermute_wait`` ↔ the ``-done`` half). A ``CollectiveEntry``'s shapes
and dtypes are its INPUT's, so an all-gather's output is reckoned from
them and the group size (:attr:`CollectiveOp.max_nbytes`).

No counterpart: the HLO text parser (``parse_collective_ops``,
``tensor_shapes`` of type strings, the replica-group and pair regexes)
and ``while_body_computations``. XLA prints the body of a loop once, so
the reference corrects its counts with single-layer probes; the port
records every collective as it is issued, on every trip of its Python
layer loop, so its counts need no correction.
"""
from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Iterable, List, Optional, Tuple

# Bits of the dtypes a CollectiveEntry names (``str(dtype)`` without
# ``torch.``); the wire moves 2-byte floats and bools as bytes, which
# keeps their sizes.
_DTYPE_BITS = {
    "bool": 8, "uint8": 8, "int8": 8,
    "float8_e4m3fn": 8, "float8_e5m2": 8,
    "int16": 16, "uint16": 16, "bfloat16": 16, "float16": 16,
    "int32": 32, "uint32": 32, "float32": 32,
    "int64": 64, "uint64": 64, "float64": 64, "complex64": 64,
    "complex128": 128,
}
_FALLBACK_BITS = 32            # conservative: overcount, never undercount
_warned_dtypes = set()

#: the port's collective kinds → the reference's HLO kinds
KIND_OF = {"psum": "all-reduce", "pmax": "all-reduce",
           "psum_scatter": "reduce-scatter",
           "all_gather": "all-gather", "all_gather_groups": "all-gather",
           "ppermute_start": "collective-permute",
           "ppermute_wait": "collective-permute"}


def dtype_nbits(dt) -> int:
    """Bit width of a torch dtype (or its name); unknown types warn once
    and count as a conservative 32 bits."""
    name = str(dt).replace("torch.", "")
    bits = _DTYPE_BITS.get(name)
    if bits is None:
        if name not in _warned_dtypes:
            _warned_dtypes.add(name)
            warnings.warn(f"unknown dtype {name!r}; counting it as "
                          f"{_FALLBACK_BITS} bits (conservative overcount)",
                          stacklevel=2)
        bits = _FALLBACK_BITS
    return bits


def tensor_nbytes(shapes: Iterable[Tuple[int, ...]],
                  dtypes: Iterable) -> List[int]:
    """Byte size of each (shape, dtype) pair."""
    return [math.ceil(math.prod(s) * dtype_nbits(dt) / 8)
            for s, dt in zip(shapes, dtypes)]


@dataclasses.dataclass(frozen=True)
class CollectiveOp:
    """One recorded collective in the reference's terms: ``kind`` the
    reference's, ``port_kind`` the port's; ``shapes`` the (dtype, dims)
    of its OUTPUT; the replica groups, pairs and serial as recorded."""
    kind: str
    port_kind: str
    shapes: Tuple[Tuple[str, Tuple[int, ...]], ...]
    replica_groups: Optional[Tuple[Tuple[int, ...], ...]] = None
    source_target_pairs: Optional[Tuple[Tuple[int, int], ...]] = None
    serial: int = -1
    is_done: bool = False

    @property
    def group_size(self) -> int:
        if self.source_target_pairs:
            return 1
        if self.replica_groups:
            return max(len(g) for g in self.replica_groups)
        return 1

    @property
    def max_nbytes(self) -> int:
        sizes = tensor_nbytes([s for _, s in self.shapes],
                              [dt for dt, _ in self.shapes])
        return max(sizes) if sizes else 0

    def signature(self) -> tuple:
        """What every participant must agree on (the serial, a rank's own
        count, excluded)."""
        return (self.kind, self.port_kind, self.shapes, self.replica_groups,
                self.source_target_pairs)


def collective_op(entry) -> CollectiveOp:
    """The :class:`CollectiveOp` of one ``CollectiveEntry``: an
    all-gather's output is its input stacked g times (g its group size);
    every other kind's output has its input's shape."""
    kind = KIND_OF.get(entry.kind, entry.kind)
    groups = tuple(tuple(g) for g in entry.replica_groups) or None
    pairs = tuple(tuple(p) for p in entry.pairs) or None
    shapes = tuple(zip(entry.dtypes, entry.shapes))
    if kind == "all-gather" and groups:
        g = max(len(r) for r in groups)
        shapes = tuple((dt, (g,) + tuple(s)) for dt, s in shapes)
    if pairs and kind == "collective-permute":
        groups = None
    return CollectiveOp(kind=kind, port_kind=entry.kind,
                        shapes=tuple((str(dt), tuple(s)) for dt, s in shapes),
                        replica_groups=groups, source_target_pairs=pairs,
                        serial=entry.serial,
                        is_done=entry.kind == "ppermute_wait")


def collective_ops(record) -> List[CollectiveOp]:
    """Every entry of a recorded schedule as a :class:`CollectiveOp`, in
    issue order (``-done`` halves included; callers filter on
    ``is_done``, as the reference's)."""
    return [collective_op(e) for e in record]
