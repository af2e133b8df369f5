"""Rule 1: collective-schedule checker, the counterpart of
``repro/analysis/schedule.py``.

A multi-process program deadlocks when its ranks disagree on the ordered
sequence of collectives they issue. The reference reads that sequence
from compiled HLO text (``repro/analysis/hlo.py``, which has no
counterpart here); the port records it as it runs: while
:func:`repro_torch.compat.record_collectives` is armed, every collective
a rank issues appends one :class:`repro_torch.compat.CollectiveEntry`
(kind, the group's ranks, the replica groups, the source → target
pairs, shapes and dtypes). Kinds: ``psum``, ``psum_scatter``,
``all_gather``, ``pmax``, ``all_gather_groups``, ``ppermute_start`` and ``ppermute_wait`` (the
wait of its ``Pending``, as an async ``-done``).

* :func:`check_schedule`: structural validity of one rank's record:
  each ``ppermute_start`` is paired with its wait, each hop's pairs are
  a partial permutation (no rank sends or receives twice in one hop),
  and the groups of one op are disjoint.
* :func:`assert_schedules_agree`: the ranks (or two builds of one
  program) recorded the same ordered schedule.
* :func:`compare_collective_counts`: per-kind counts of two records.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

from repro_torch.analysis.base import LintViolation, RuleReport

RULE = "collective-schedule"
_WAIT = "ppermute_wait"


def _name(entry, i: int) -> str:
    return f"{entry.kind}#{i}"


def collective_schedule(record) -> Tuple[tuple, ...]:
    """Ordered schedule signature of one rank's record: one entry per
    issued collective (waits excluded: the start is the issue point),
    each its kind, replica groups, pairs, shapes and dtypes; not the
    rank's own group, which differs between the ranks of a grouped
    collective."""
    return tuple(e.signature() for e in record if e.kind != _WAIT)


def check_schedule(record, program: str = "<program>") -> RuleReport:
    """Structural schedule validity of one rank's record."""
    open_starts: Dict[int, int] = {}
    for i, e in enumerate(record):
        if e.kind == "ppermute_start":
            open_starts[e.serial] = i
        elif e.kind == _WAIT:
            if e.serial not in open_starts:
                raise LintViolation(
                    RULE, program, _name(e, i),
                    "ppermute wait with no preceding matching start")
            del open_starts[e.serial]
    if open_starts:
        i = min(open_starts.values())
        raise LintViolation(
            RULE, program, _name(record[i], i),
            "ppermute_start never waited on (dangling async collective)")

    for i, e in enumerate(record):
        if e.kind != "ppermute_start":
            continue
        srcs = [s for s, _ in e.pairs]
        tgts = [t for _, t in e.pairs]
        for what, xs in (("source", srcs), ("target", tgts)):
            if len(set(xs)) != len(xs):
                dup = sorted({x for x in xs if xs.count(x) > 1})
                raise LintViolation(
                    RULE, program, _name(e, i),
                    f"ppermute has duplicate {what} rank(s) {dup} in "
                    f"pairs={list(e.pairs)}: a rank cannot "
                    f"{'send' if what == 'source' else 'receive'} twice "
                    "in one hop")

    for i, e in enumerate(record):
        if not e.replica_groups or e.kind == _WAIT:
            continue
        seen: Dict[int, int] = {}
        for gi, g in enumerate(e.replica_groups):
            for r in g:
                if r in seen:
                    raise LintViolation(
                        RULE, program, _name(e, i),
                        f"{e.kind} replica groups place rank {r} in groups "
                        f"{seen[r]} and {gi}: groups must be disjoint")
                seen[r] = gi
    return RuleReport(rule=RULE, program=program, checked=len(record))


def assert_schedules_agree(schedules: Dict[str, Sequence[tuple]],
                           program: str = "<program>") -> RuleReport:
    """All participants recorded the same ordered collective schedule.
    Keys name the participants (ranks, builds); the error names the
    first position where two schedules diverge."""
    items = sorted(schedules.items())
    if len(items) < 2:
        return RuleReport(rule=RULE, program=program,
                          checked=len(items and items[0][1]))
    ref_name, ref = items[0]
    for name, sched in items[1:]:
        if len(sched) != len(ref):
            raise LintViolation(
                RULE, program, f"{ref_name} vs {name}",
                f"collective counts diverge: {ref_name} issues "
                f"{len(ref)} collectives, {name} issues {len(sched)}")
        for i, (a, b) in enumerate(zip(ref, sched)):
            if a != b:
                raise LintViolation(
                    RULE, program, f"schedule[{i}]",
                    f"{ref_name} and {name} disagree at collective #{i}: "
                    f"{a} vs {b}: a launch of these ranks together would "
                    "deadlock")
    return RuleReport(rule=RULE, program=program,
                      checked=len(ref) * len(items))


def collective_counts(record) -> Dict[str, dict]:
    """Per-kind ``{"count": n}`` of a record (waits excluded), the shape
    of the reference's ``collective_stats``."""
    out: Dict[str, dict] = {}
    for e in record:
        if e.kind != _WAIT:
            out.setdefault(e.kind, {"count": 0})["count"] += 1
    return out


def compare_collective_counts(recorded: Dict[str, dict],
                              fresh: Dict[str, dict],
                              program: str = "<record>") -> RuleReport:
    """Per-kind collective counts of a kept record vs. a fresh one (dicts
    of ``{"count": n}`` by kind, as :func:`collective_counts` gives)."""
    kinds = sorted(set(recorded) | set(fresh))
    for kind in kinds:
        r = int(recorded.get(kind, {}).get("count", 0))
        f = int(fresh.get(kind, {}).get("count", 0))
        if r != f:
            raise LintViolation(
                RULE, program, kind,
                f"the kept record has {r} {kind} op(s) but a fresh run "
                f"issues {f}: the record is stale")
    return RuleReport(rule=RULE, program=program, checked=len(kinds))
