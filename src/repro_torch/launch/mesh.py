"""Launch topology helpers of the sharded mode.

The port has no device mesh: the ranks of a ``torch.distributed`` group
take its place (:mod:`repro_torch.compat`). What is left of the
reference's ``repro/launch/mesh.py`` here is the host count a launcher
pins for the hier transport; the cluster meshes wait for the
multi-process launch (ROADMAP Queue 1 item 10).
"""
from __future__ import annotations


def simulated_hier_hosts(ndev: int) -> int:
    """Host count for ``shuffle_impl="hier"`` launch configs on one host:
    a two-level split that exercises both legs of the schedule, ``ndev
    // 8`` hosts (one simulated host per 8 ranks), else 2, and 1 only
    when ``ndev`` is odd, as the reference's single-process case. (On a
    multi-host run the reference returns None, so that the round
    counts the real hosts; that run waits for item 10, and
    ``hier_num_hosts=None`` counts them already,
    :func:`repro_torch.core.mapreduce_svm.resolve_topology`.)
    """
    for hosts in (max(2, ndev // 8), 2):
        if hosts <= ndev and ndev % hosts == 0:
            return hosts
    return 1
