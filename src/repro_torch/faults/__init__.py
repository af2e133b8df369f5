"""Deterministic fault injection and the hardening it drives, ported
from ``repro/faults``. ``python -m repro_torch.faults.chaos`` is the
seed-sweep harness; :mod:`repro_torch.faults.chaos` is imported there,
never from here (it imports the layers under attack, which import this
package)."""
from repro_torch.faults.plan import (KINDS, FaultDetected, FaultPlan,
                                     FaultSpec, InjectedFault,
                                     InjectedWriteError, TransientFault,
                                     active, check_finite_risks,
                                     corrupt_file, count, counters, fire,
                                     garble_wire, inject, maybe_raise,
                                     maybe_sleep,
                                     poison_batch, reset_counters,
                                     set_active)
from repro_torch.faults.retry import retry_with_backoff
from repro_torch.faults.watchdog import (WATCHDOG_EXIT_CODE,
                                         CollectiveWatchdog, exit_handler)

__all__ = [
    "KINDS", "FaultDetected", "FaultPlan", "FaultSpec", "InjectedFault",
    "InjectedWriteError", "TransientFault", "active",
    "check_finite_risks", "corrupt_file", "count", "counters", "fire",
    "garble_wire", "inject", "maybe_raise", "maybe_sleep", "poison_batch",
    "reset_counters", "set_active", "retry_with_backoff",
    "WATCHDOG_EXIT_CODE", "CollectiveWatchdog", "exit_handler",
]
