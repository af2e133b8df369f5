"""Launch topology of the sharded mode, ported from
``repro/launch/mesh.py``.

The port has no device mesh: the ranks of a ``torch.distributed`` group
take its place (:mod:`repro_torch.compat`). The counterpart of the
reference's ``make_cluster_mesh`` / ``make_host_mesh`` is the
process-major rank order of a cluster launch (:func:`rank_layout`): the
data axis enumerates the ranks so that each process's ranks are
contiguous, and each rank makes the rows of its own place on it.

No counterpart: ``make_production_mesh`` and the TPU v5e roofline
constants (a TPU pod's mesh); ``batch_axes``, ``data_parallel_size`` and
``model_parallel_size`` belong to the LM mesh of the model zoo (ROADMAP
Queue 1 item 13).
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch import compat


def rank_layout(cluster) -> np.ndarray:
    """The global ranks of ``cluster`` as a (process_count, k) array:
    row p holds process p's ranks, ``p · k + i``; flattened, the data
    axis in process-major order, the order ``host_row_range`` and the
    hier transport's host groups assume."""
    return np.arange(cluster.device_count).reshape(
        cluster.process_count, cluster.local_device_count)


def simulated_hier_hosts(ndev: int) -> Optional[int]:
    """Host count for ``shuffle_impl="hier"`` launch configs.

    On a multi-process launch returns ``None``, so that the round counts
    the launched processes (:func:`repro_torch.compat.process_count`,
    read by :func:`repro_torch.core.mapreduce_svm.resolve_topology`).
    On one process, the simulated case, a two-level split that
    exercises both legs of the schedule: ``ndev // 8`` hosts (one
    simulated host per 8 ranks), else 2, and 1 only when ``ndev`` is
    odd, as the reference's.
    """
    if compat.process_count() > 1:
        return None
    for hosts in (max(2, ndev // 8), 2):
        if hosts <= ndev and ndev % hosts == 0:
            return hosts
    return 1
