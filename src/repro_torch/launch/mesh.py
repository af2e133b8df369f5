"""Launch topology, ported from ``repro/launch/mesh.py``.

The port has no device mesh: the ranks of a ``torch.distributed`` group
take its place (:mod:`repro_torch.compat`).

- The sharded svm round: the counterpart of the reference's
  ``make_cluster_mesh`` is the process-major rank order of a cluster
  launch (:func:`rank_layout`): the data axis enumerates the ranks so
  that each process's ranks are contiguous, and each rank makes the rows
  of its own place on it.
- The LM mesh: a ``compat.Mesh`` (``compat.rank_mesh``), a (data ×
  model) grid of ranks laid out as ``jax.make_mesh`` lays out its
  devices (rank ``d · model + m``), with this rank's coordinates and a
  subgroup an axis; :func:`make_host_mesh` (the reference's clamping),
  :func:`make_production_mesh` (a shape-only mesh: the 16 × 16 and
  2 × 16 × 16 grids, no ranks, for reckoning placements),
  :func:`batch_axes`, :func:`data_parallel_size`,
  :func:`model_parallel_size` and :func:`batch_group` (the group of a
  rank's ranks along the batch axes).

The roofline constants are the port's card's, in place of the
reference's TPU v5e ones (``PEAK_FLOPS_BF16``, ``HBM_BW``; ``LINK_BW``
in place of ``ICI_BW``): NVIDIA H100 SXM5 data sheet, dense bf16 on the
tensor cores, HBM3, and NVLink 4 (18 links, 900 GB/s both directions
together). No TPU number carries over.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch.distributed as dist

from repro_torch import compat
from repro_torch.compat import Mesh, rank_mesh


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


# ---------------------------------------------------------------------------
# The LM mesh: a grid of ranks
# ---------------------------------------------------------------------------

def make_host_mesh(data: int = 1, model: int = 1, cluster=None) -> Mesh:
    """The ("data", "model") mesh over the launched ranks, clamped as the
    reference's: without a cluster, data ≤ ranks and model ≤ ranks /
    data; with a distributed cluster, model ≤ ranks and data (0: all the
    rest) ≤ ranks / model. The ranks are the default group's (a spawn's
    world; under a cluster launch the global ranks, process-major).
    Raises unless the clamped grid covers every rank."""
    n = compat.axis_size() if dist.is_initialized() else 1
    if cluster is not None and cluster.is_distributed:
        model = max(1, min(model, n))
        data = min(data or n // model, n // model)
    else:
        data = min(data, n)
        model = max(1, min(model, n // max(data, 1)))
    return rank_mesh(("data", "model"), (data, model))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production grid as a shape-only mesh: 16 × 16
    ("data", "model"), or 2 × 16 × 16 ("pod", "data", "model")."""
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))


def batch_axes(mesh) -> tuple:
    """Mesh axes the batch dim shards over."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def data_parallel_size(mesh) -> int:
    return math.prod(mesh.shape[a] for a in batch_axes(mesh))


def batch_group(mesh):
    """The process group of this rank's ranks along the batch axes of a
    rank ``mesh`` (those that differ from it only in their ("pod",)
    "data" coordinates, in row-major order): the group a data-parallel
    program such as the sharded svm round runs on, as the reference's
    ``shard_map`` over those axes. Made on first use, for every batch
    group at once (every rank of the world calls it alike)."""
    axes = batch_axes(mesh)
    if len(axes) == 1:
        g = mesh.groups_of(axes[0])
    else:
        mesh._need_ranks("process groups")
        dims = [mesh.axis_names.index(a) for a in axes]
        rest = [i for i in range(len(mesh.sizes)) if i not in dims]
        grid = np.arange(mesh.size).reshape(mesh.sizes)
        parts = np.transpose(grid, rest + dims).reshape(
            -1, data_parallel_size(mesh))
        g = compat.new_groups([list(map(int, r)) for r in parts])
    return g.handles[g.mine]


def model_parallel_size(mesh) -> int:
    return mesh.shape.get("model", 1)


# Roofline constants of one NVIDIA H100 SXM5 (data sheet).
PEAK_FLOPS_BF16 = 989.4e12      # FLOP/s, dense bf16 on the tensor cores
HBM_BW = 3.35e12                # B/s, HBM3
# B/s a direction of one card's NVLink 4: the collective term of the
# roofline assumes a rank's collective bytes leave at this rate through
# the NVSwitch fabric, every link busy, nothing overlapped with compute
LINK_BW = 450e9
