"""repro_torch.analysis: the invariant linter, the counterpart of
``repro/analysis``.

The reference checks traced jaxprs and compiled HLO; the port has
neither, so each rule observes the program as it runs on a rank: the
ops it dispatches (a ``TorchDispatchMode``), the collectives it issues
(:func:`repro_torch.compat.record_collectives`), the kernel libraries
and wrapper signatures it meets, and on a card the host syncs and the
device memory. The rules keep the reference's names and vocabulary
(:class:`LintViolation`, :class:`Allowed`, :class:`RuleReport`):

1. collective-schedule (:mod:`.schedule`): every rank's recorded
   schedule is structurally valid and agrees across ranks and builds.
2. retrace (:mod:`.retrace`): steady-state hot regions (sweep rounds
   past the first, a streaming fold of a signature met before) meet no
   new kernel library or wrapper signature.
3. host-sync (:mod:`.hostsync`): hot loops wait on the device only at
   their named readback points.
4. dense-materialization (:mod:`.denseleak`): blocked-CSR programs never
   hold an O(n·d) dense row block.
5. dtype-drift (:mod:`.dtype_drift`): solver-state tensors (y/α/w/b)
   never pass a reduced-precision op outside the bf16 wire pack.

Entry points: ``python -m repro_torch.analysis.lint`` (the matrix over
the real round programs, and ``--self-test``), and the check functions
below for use inside the loops (``core.sweep``, ``serving.svm_stream``,
``launch.sharded``).
"""
from repro_torch.analysis.base import Allowed, LintViolation, RuleReport
from repro_torch.analysis.denseleak import (DEFAULT_MAX_DENSE_ROWS,
                                            check_memory_ceiling,
                                            check_no_dense_materialization)
from repro_torch.analysis.dtype_drift import check_no_dtype_drift
from repro_torch.analysis.hostsync import (allowed_host_sync,
                                           check_no_host_callbacks,
                                           host_guards_enforced,
                                           no_implicit_host_sync)
from repro_torch.analysis.retrace import (RetraceError, RetraceStats,
                                          no_retrace, watch_compiles)
from repro_torch.analysis.schedule import (assert_schedules_agree,
                                           check_schedule,
                                           collective_counts,
                                           collective_schedule,
                                           compare_collective_counts)

__all__ = [
    "Allowed", "LintViolation", "RuleReport",
    "collective_schedule", "check_schedule", "assert_schedules_agree",
    "collective_counts", "compare_collective_counts",
    "RetraceError", "RetraceStats", "no_retrace", "watch_compiles",
    "allowed_host_sync", "check_no_host_callbacks",
    "host_guards_enforced", "no_implicit_host_sync",
    "DEFAULT_MAX_DENSE_ROWS", "check_memory_ceiling",
    "check_no_dense_materialization",
    "check_no_dtype_drift",
]
