"""Cluster runtime: the process-count-agnostic multi-process substrate,
ported from ``repro/launch/cluster.py``.

The paper's premise is that ONE machine cannot hold the quadratic SVM
training problem: training is distributed across nodes and only support
vectors travel (Çatak 2014). Every layer above this module is written
against the global topology reported here, so the same program runs on
one process or on N processes, each on its own machine or several on
one:

  init_cluster()  — joins the cluster: explicit --coordinator /
                    --num-processes / --process-id flags, the same
                    environment spellings as the reference's, and a
                    1-process fast path that opens no socket and no
                    process group;
  Cluster         — the topology: process index and count, the k ranks
                    each process runs, coordinator gating.

A process is a launcher: it joins the cluster here (a handshake with
process 0's ``torch.distributed`` TCP store at the coordinator address,
retried through :func:`repro_torch.faults.retry_with_backoff` at the
``cluster.handshake`` seam), then starts its k local ranks with
:func:`repro_torch.compat.spawn` (``cluster=``), which join one world of
``process_count · k`` ranks through that store. Ranks are process-major:
global rank ``process_index · k + i``, the order ``host_row_range``
assumes, so a process's rows are the concatenation of its ranks' rows.

The reference's ``Cluster.make_global_array`` has no counterpart: there
are no global arrays. Each rank makes only its own rows (for example
``svm_rows_device(n, d, process_index=rank, process_count=world)``),
which is what a process's shard cut into its ranks' shards gives.
"""
from __future__ import annotations

import dataclasses
import datetime
import json
import os
import socket
import time
from typing import Any, List, Optional

import torch

from repro_torch import compat, faults

# One process-wide runtime: repeated init_cluster() calls return the
# same handle, as the reference's (jax.distributed initializes once).
_CLUSTER: Optional["Cluster"] = None


@dataclasses.dataclass(frozen=True)
class ClusterConfig:
    """How to join (or not join) a multi-process cluster.

    All ``None`` → single process, unless the ``REPRO_COORDINATOR`` /
    ``REPRO_NUM_PROCESSES`` / ``REPRO_PROCESS_ID`` environment variables
    (or their ``JAX_``-prefixed spellings) supply the triple, for
    launchers that template per-process environment instead of argv.
    ``local_device_count`` is the number of ranks this process runs: on
    a card it defaults to ``torch.cuda.device_count()``; on the CPU a
    multi-process launch must give it.
    """
    coordinator: Optional[str] = None      # "host:port" of process 0
    num_processes: Optional[int] = None
    process_id: Optional[int] = None
    local_device_count: Optional[int] = None
    cpu_collectives: str = "gloo"
    initialization_timeout: int = 120      # s; bounds a dead-peer hang
    # Coordinator handshake retry: a restarted process often races the
    # coordinator's store coming back; a bounded retry with backoff turns
    # that window into a survived transient instead of a launch failure.
    handshake_retries: int = 3
    handshake_backoff_s: float = 0.5

    def resolved(self) -> "ClusterConfig":
        """Fill unset fields from the environment (explicit args win)."""
        def env(*names):
            for n in names:
                v = os.environ.get(n)
                if v:
                    return v
            return None

        coord = self.coordinator or env("REPRO_COORDINATOR",
                                        "JAX_COORDINATOR_ADDRESS")
        num = self.num_processes
        if num is None:
            v = env("REPRO_NUM_PROCESSES", "JAX_NUM_PROCESSES")
            num = int(v) if v else None
        pid = self.process_id
        if pid is None:
            v = env("REPRO_PROCESS_ID", "JAX_PROCESS_ID")
            pid = int(v) if v else None
        return dataclasses.replace(self, coordinator=coord,
                                   num_processes=num, process_id=pid)

    @property
    def is_multiprocess(self) -> bool:
        return (self.num_processes or 1) > 1 or self.coordinator is not None


@dataclasses.dataclass(frozen=True)
class Cluster:
    """Topology of the running job, as every layer above sees it.

    ``local_device_count`` is k, the ranks each process runs (the same
    on every process); ``cards_per_process`` the cards a process may
    give its ranks a card each (0 when processes share a host, so that
    their ranks share the cards over gloo); ``store`` process 0's TCP
    store (a client of it elsewhere; None on one process);
    ``handshake_ms`` the handshake's time."""
    process_index: int
    process_count: int
    coordinator: Optional[str] = None
    local_device_count: int = 1
    cards_per_process: Optional[int] = None
    handshake_ms: float = 0.0
    store: Any = dataclasses.field(default=None, compare=False, repr=False)

    @property
    def is_distributed(self) -> bool:
        return self.process_count > 1

    @property
    def is_coordinator(self) -> bool:
        """Process 0: the one that ingests, admits and reports."""
        return self.process_index == 0

    @property
    def device_count(self) -> int:
        """Global ranks: ``process_count · local_device_count``."""
        return self.process_count * self.local_device_count

    def local_ranks(self) -> List[int]:
        """This process's global ranks, ``process_index · k + i``."""
        k = self.local_device_count
        return list(range(self.process_index * k,
                          (self.process_index + 1) * k))

    def describe(self) -> dict:
        """Topology report (JSON-able) for logs."""
        return {"process_index": self.process_index,
                "process_count": self.process_count,
                "coordinator": self.coordinator,
                "platform": "cuda" if torch.cuda.is_available() else "cpu",
                "local_devices": self.local_device_count,
                "global_devices": self.device_count,
                "handshake_ms": self.handshake_ms}


def local_cluster(local_device_count: int = 1) -> Cluster:
    """The 1-process topology (no coordinator, no store)."""
    return Cluster(process_index=0, process_count=1,
                   local_device_count=local_device_count)


def _local_count(cfg: ClusterConfig) -> Optional[int]:
    if cfg.local_device_count:
        return int(cfg.local_device_count)
    if torch.cuda.is_available():
        return torch.cuda.device_count()
    return None


def init_cluster(cfg: Optional[ClusterConfig] = None) -> Cluster:
    """Join the cluster described by ``cfg`` (+ environment) and report
    the topology.

    Single-process fast path: with no coordinator configured anywhere
    this opens no store, no socket and no process group, and returns the
    1-process :class:`Cluster` (k = ``local_device_count``, else the
    card count, else 1). Multi-process: the full triple and k are checked
    before any side effect, then :func:`join` does the handshake.
    Idempotent: the first call wins; later calls return the same handle.
    """
    global _CLUSTER
    if _CLUSTER is not None:
        return _CLUSTER
    cfg = (cfg or ClusterConfig()).resolved()
    if not cfg.is_multiprocess:
        _CLUSTER = local_cluster(_local_count(cfg) or 1)
        return _CLUSTER
    _CLUSTER = join(cfg)
    compat.set_process_count(_CLUSTER.process_count)
    return _CLUSTER


def _check(cfg: ClusterConfig) -> int:
    """The triple and k of a multi-process ``cfg``, checked before any
    side effect. → k."""
    if cfg.coordinator is None or cfg.num_processes is None \
            or cfg.process_id is None:
        raise ValueError(
            "multi-process launch needs the full triple: coordinator "
            f"address, num_processes and process_id (got {cfg})")
    if not 0 <= cfg.process_id < cfg.num_processes:
        raise ValueError(f"process_id {cfg.process_id} outside "
                         f"[0, {cfg.num_processes})")
    if cfg.cpu_collectives != "gloo":
        raise ValueError("the ranks' CPU collectives are gloo's, got "
                         f"{cfg.cpu_collectives!r}")
    host, _, port = cfg.coordinator.rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(f"coordinator {cfg.coordinator!r} is not host:port")
    k = _local_count(cfg)
    if k is None:
        raise ValueError(
            "no CUDA device: a multi-process CPU launch must give the "
            "ranks each process runs (local_device_count, "
            "--local-devices)")
    return k


def join(cfg: ClusterConfig) -> Cluster:
    """The handshake of one process of a multi-process ``cfg`` (resolved),
    without recording it as this process's cluster: process 0 hosts a
    ``torch.distributed`` TCP store at the coordinator address, every
    process connects to it and posts its rank count, host and cards, and
    waits for every other's, within ``initialization_timeout``. The
    connection retries through :func:`faults.retry_with_backoff` (seam
    ``cluster.handshake``, fault ``handshake_flake``). → the
    :class:`Cluster`, holding the store."""
    k = _check(cfg)
    host, _, port = cfg.coordinator.rpartition(":")
    timeout = datetime.timedelta(seconds=cfg.initialization_timeout)
    n, me = cfg.num_processes, cfg.process_id
    t0 = time.perf_counter()

    def handshake():
        faults.maybe_raise("cluster.handshake", kinds=("handshake_flake",))
        return torch.distributed.TCPStore(
            host, int(port), world_size=n, is_master=me == 0,
            timeout=timeout, wait_for_workers=False)

    store = faults.retry_with_backoff(
        handshake, attempts=cfg.handshake_retries,
        base_s=cfg.handshake_backoff_s, layer="cluster",
        cause=f"coordinator handshake with {cfg.coordinator}",
        action="check that process 0 is reachable at the coordinator "
               "address, then relaunch this process (the restarted "
               "process rejoins from the last checkpoint)")
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    store.set(f"cluster/hello/{me}", json.dumps(
        {"k": k, "host": socket.gethostname(), "cards": cards}))
    keys = [f"cluster/hello/{p}" for p in range(n)]
    store.wait(keys)
    hellos = [json.loads(store.get(key)) for key in keys]
    counts = sorted({h["k"] for h in hellos})
    if counts != [k]:
        raise ValueError(f"the processes run different rank counts "
                         f"{[h['k'] for h in hellos]}: global rank "
                         "process · k + i needs the same k on each")
    hosts = [h["host"] for h in hellos]
    alone = len(set(hosts)) == len(hosts)
    return Cluster(process_index=me, process_count=n,
                   coordinator=cfg.coordinator, local_device_count=k,
                   cards_per_process=(min(h["cards"] for h in hellos)
                                      if alone else 0),
                   handshake_ms=1e3 * (time.perf_counter() - t0),
                   store=store)


# ---------------------------------------------------------------------------
# Entry-point wiring (launch/{train,serve}.py, examples).
# ---------------------------------------------------------------------------

def add_cluster_flags(parser) -> None:
    """The launch flags every entry point shares."""
    parser.add_argument("--coordinator", default=None,
                        help="process 0 address host:port "
                             "(multi-process launch)")
    parser.add_argument("--num-processes", type=int, default=None)
    parser.add_argument("--process-id", type=int, default=None)
    parser.add_argument("--local-devices", type=int, default=None,
                        help="ranks this process runs (default: one a "
                             "card; required on the CPU)")
    parser.add_argument("--cluster-timeout", type=int, default=120,
                        help="handshake, rendezvous and collective time "
                             "limit (s): bounds how long a restarted "
                             "process waits for dead peers to rejoin")


def cluster_config_from_args(args) -> ClusterConfig:
    return ClusterConfig(coordinator=args.coordinator,
                         num_processes=args.num_processes,
                         process_id=args.process_id,
                         local_device_count=args.local_devices,
                         initialization_timeout=args.cluster_timeout)


def free_port() -> int:
    """A TCP port free on this host now (for a coordinator)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def simulated_topology(num_processes: int, device_count: int) -> dict:
    """Per-process split of a ``device_count``-rank job over
    ``num_processes`` processes: a topology described, not run."""
    if device_count % num_processes != 0:
        raise ValueError(f"{device_count} devices do not split over "
                         f"{num_processes} processes")
    return {"process_count": num_processes,
            "devices_per_process": device_count // num_processes}
