"""Roofline terms of a rank's step, ported from
``repro/launch/hlo_analysis.py``.

compute term    = FLOPs / (chips × peak)
memory term     = HBM bytes / (chips × HBM bandwidth)
collective term = a rank's collective bytes / link bandwidth

with the port's card's constants (``launch.mesh``: one H100 SXM5's dense
bf16 rate, HBM3 rate and NVLink 4 rate a direction).

The reference reads its collectives from the compiled HLO text; the port
reads the entries :func:`repro_torch.compat.record_collectives` recorded
while a rank ran its step (:func:`collective_stats`), through
:mod:`repro_torch.analysis.hlo`'s view of them, and keeps the
reference's kinds and the reference's dict: kind → ``count``,
``operand_bytes``, ``output_bytes``, ``wire_bytes``. The wire model of
each of the port's kinds, g the group size and x the bytes of a rank's
input:

    psum               all-reduce          operand = out = x
                                           wire ≈ 2·x·(g-1)/g (ring all-reduce)
    pmax               all-reduce          operand = out = x
                                           wire = x·(g-1): the port gathers
                                           every rank's x and takes the max
                                           locally (gloo's MAX drops NaN)
    all_gather,        all-gather          operand = x, out = g·x
    all_gather_groups                      wire = out·(g-1)/g
    ppermute_start     collective-permute  operand = out = x, wire = x

The port records every collective of every loop trip, so no probe
correction applies (:func:`combine_with_layer` is kept for the
reference's arithmetic; the dry run reports the probes but adds nothing
through it).
"""
from __future__ import annotations

from typing import Dict

from repro_torch.analysis import hlo as hlo_view
from repro_torch.launch.mesh import HBM_BW, LINK_BW, PEAK_FLOPS_BF16

_KEYS = ("count", "operand_bytes", "output_bytes", "wire_bytes")


def _new() -> Dict[str, float]:
    return {"count": 0, "operand_bytes": 0.0, "output_bytes": 0.0,
            "wire_bytes": 0.0}


def collective_stats(record) -> Dict[str, Dict[str, float]]:
    """Per-kind {count, operand_bytes, output_bytes, wire_bytes} of a
    rank's recorded collectives (``compat.CollectiveEntry`` list); the
    waits (the ``-done`` halves) are not counted, nor is a collective
    that moves no bytes."""
    stats: Dict[str, Dict[str, float]] = {}
    for op in hlo_view.collective_ops(record):
        if op.is_done:
            continue
        biggest = op.max_nbytes
        if not biggest:
            continue
        g = max(op.group_size, 1)
        if op.kind == "all-gather":
            operand, wire = biggest / g, biggest * (g - 1) / g
        elif op.port_kind == "pmax":
            operand, wire = float(biggest), float(biggest) * (g - 1)
        elif op.kind == "all-reduce":
            operand, wire = float(biggest), 2.0 * biggest * (g - 1) / g
        else:                                   # collective-permute
            operand, wire = float(biggest), float(biggest)
        s = stats.setdefault(op.kind, _new())
        s["count"] += 1
        s["operand_bytes"] += operand
        s["output_bytes"] += biggest
        s["wire_bytes"] += wire
    return stats


def total_collective_bytes(stats: Dict[str, Dict[str, float]],
                           key: str = "operand_bytes") -> float:
    """The sum of ``key`` over every kind (the reference's convention:
    operand bytes; ``wire_bytes`` the physical alternative)."""
    return float(sum(s[key] for s in stats.values()))


def combine_with_layer(full: Dict, layer: Dict, extra_trips: int) -> Dict:
    """collective_total = full + extra_trips × a single layer's (the
    reference's correction of XLA's once-counted loop bodies)."""
    out = {k: dict(v) for k, v in full.items()}
    for kind, s in layer.items():
        t = out.setdefault(kind, _new())
        for key in _KEYS:
            t[key] = t.get(key, 0) + extra_trips * s.get(key, 0)
    return out


def roofline_terms(flops: float, hbm_bytes: float, collective_bytes: float,
                   chips: int) -> Dict[str, float]:
    """Terms in seconds. ``flops`` and ``hbm_bytes`` are the whole job's;
    ``collective_bytes`` is one rank's."""
    return {
        "compute_s": flops / (chips * PEAK_FLOPS_BF16),
        "memory_s": hbm_bytes / (chips * HBM_BW),
        "collective_s": collective_bytes / LINK_BW,
    }


def dominant_term(terms: Dict[str, float]) -> str:
    return max(("compute_s", "memory_s", "collective_s"),
               key=lambda k: terms[k])
