"""One process of the multi-process harness: the counterpart of the
reference's ``tests/mp_worker.py``, kept in the package so that the CPU
tests and ``chip_smoke.py`` launch the same code.

Each process joins the cluster through
:func:`repro_torch.launch.cluster.init_cluster` (explicit coordinator,
process count and index, k local ranks) and starts its k ranks with
:func:`repro_torch.compat.spawn` (``cluster=``); every rank makes only
its own rows of the reference's numpy dataset (``svm_rows_shard`` with
its global rank) and runs the legs, in this order:

* ``rounds`` — the sharded round (:func:`repro_torch.core.
  build_sharded_round`) on allgather, ring and hier, on dense rows and on
  blocked-CSR rows (cap 8, lossless at d = 16), ``--rounds`` rounds from
  an empty buffer, f32 wire; hier counts its hosts from the launched
  processes (``hier_num_hosts=None``). Global rank 0 writes every
  round's outputs and its launches by route to ``<out>/rounds.pkl`` for
  the parent to hold against a reference;
* ``crash`` — the dedup-ring sweep (S = 2, C ∈ {1, 0.5}) with a round
  state saved by global rank 0 after each round
  (:func:`repro_torch.core.save_sweep_state`); rounds from 1 on run under
  :class:`repro_torch.faults.CollectiveWatchdog` (a heartbeat file a
  rank). Process 1's first rank SIGKILLs its own process and itself
  after round ``--kill-round`` − 1, and that process's ranks die with it
  (a round needs every rank: none after that one completes); the
  stranded ranks of process 0 exit with code 17 (the watchdog, or the
  peer loss surfacing as an error, with a typed heartbeat), and so does
  process 0;
* ``resume`` — ``handshake_flake`` is armed before ``init_cluster``, whose
  retry absorbs it; the ranks restore the newest generation (round
  ``kill_round`` − 1), finish the sweep, and must equal an uninterrupted
  run bit for bit; then global rank 0 flips a byte in the newest
  generation, every rank's ``latest_step`` falls back to ``kill_round``
  − 2, and the run resumed from there equals it bit for bit too.

Each rank writes its pid to ``<out>/pid_r<rank>``, so that a parent can
check that no rank outlives its process. A process prints
``MP_OK <legs>`` last when every leg passed.

    python -m repro_torch.launch.multihost --coordinator 127.0.0.1:9911 \\
        --num-processes 2 --process-id 0 --local-devices 4 --out /tmp/mp \\
        --legs rounds,crash --device cpu

:func:`launch` starts the N processes of such a run from a parent.
"""
from __future__ import annotations

import argparse
import os
import pickle
import signal
import subprocess
import sys
import time
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch import compat, faults

N_ROWS, D, SEED, CAP = 512, 16, 3, 8
SWEEP_C = (1.0, 0.5)
LEGS = ("rounds", "crash", "resume")


def _cfg(shuffle: str, sparse: bool = False):
    from repro_torch.core import MRSVMConfig, SVMConfig
    svm = SVMConfig(C=1.0, max_epochs=15)
    if sparse:
        svm = SVMConfig(C=1.0, max_epochs=15, row_format="sparse_csr",
                        nnz_cap=CAP)
    return MRSVMConfig(sv_capacity=64, svm=svm, shuffle_impl=shuffle,
                       shuffle_wire_dtype="float32")


def rank_rows(rank):
    """This rank's rows of ``svm_rows(N_ROWS, D, seed=SEED)``, made by
    itself (its global rank as the process index of ``svm_rows_shard``).
    → (Xl, yl) numpy."""
    from repro_torch.data.pipeline import svm_rows_shard
    return svm_rows_shard(N_ROWS, D, seed=SEED, process_index=rank.rank,
                          process_count=rank.world_size)


def rounds_leg(rank, rounds: int) -> dict:
    """The round legs on this rank. → ``{"{dense|sparse}-{impl}": per-round
    lists of numpy risks, ids, mask, alpha, x (dense), w, b}``, with
    ``"hosts"`` the hier transport's host count."""
    from repro_torch import sparse as sp
    from repro_torch.convert import to_numpy
    from repro_torch.core import build_sharded_round, init_sv_buffer
    from repro_torch.core.mapreduce_svm import resolve_topology
    Xl, yl = rank_rows(rank)
    per = Xl.shape[0]
    X = torch.from_numpy(Xl).to(rank.device)
    y = torch.from_numpy(yl).to(rank.device)
    m = torch.ones_like(y)
    out = {"hosts": resolve_topology(_cfg("hier"), rank.world_size)}
    for fmt in ("dense", "sparse"):
        Xr = sp.from_dense(X, CAP) if fmt == "sparse" else X
        for impl in ("allgather", "ring", "hier"):
            cfg = _cfg(impl, fmt == "sparse")
            fn = build_sharded_round(cfg, per, device=rank.device)
            sv = init_sv_buffer(cfg.sv_capacity, D, torch.float32,
                                rank.device,
                                nnz_cap=CAP if fmt == "sparse" else None)
            res = {k: [] for k in ("risks", "ids", "mask", "alpha", "x",
                                   "w", "b")}
            for _ in range(rounds):
                sv, risks, w, b = fn(Xr, y, m, sv)
                x = sp.to_dense(sv.x) if sp.is_sparse(sv.x) else sv.x
                for k, v in zip(res, (risks, sv.ids, sv.mask, sv.alpha, x,
                                      w, b)):
                    res[k].append(to_numpy(v))
            out[f"{fmt}-{impl}"] = res
    return out


class _Sweep:
    """The dedup-ring sweep of the crash and resume legs on one rank."""

    def __init__(self, rank, ckpt_dir: str):
        from repro_torch.core import build_sharded_sweep_round, stack_params
        import dataclasses
        self.rank, self.dir = rank, ckpt_dir
        self.cfg = _cfg("ring")
        self.params = stack_params([dataclasses.replace(
            self.cfg.svm, C=c).params() for c in SWEEP_C])
        Xl, yl = rank_rows(rank)
        self.per = Xl.shape[0]
        self.X = torch.from_numpy(Xl).to(rank.device)
        self.y = torch.from_numpy(yl).to(rank.device)
        self.m = torch.ones_like(self.y)
        self.fn = build_sharded_sweep_round(self.cfg, self.per,
                                            device=rank.device)

    def init(self):
        return self.fn.init_sv(len(SWEEP_C), D, self.X.dtype)

    def run(self, state, start: int, stop: int, checkpoint: bool = False,
            kill_after: Optional[int] = None):
        from repro_torch.core import save_sweep_state
        out = None
        for t in range(start, stop):
            state, risks, ws, bs = self.fn(self.X, self.y, self.m, state,
                                           self.params)
            if checkpoint and self.rank.rank == 0:
                save_sweep_state(os.path.join(self.dir, f"sweep_{t}.npz"),
                                 state, step=t)
            if t == kill_after and self.rank.process_index == 1 \
                    and self.rank.local_rank == 0:
                time.sleep(0.5)       # let process 0 finish round t and save
                os.kill(os.getppid(), signal.SIGKILL)
                # and this rank with it, now: the others of its process die
                # once the launcher is torn down (PR_SET_PDEATHSIG), which
                # for a process holding a CUDA context can take longer than
                # a round; alive meanwhile, the process would run round t +
                # 1 with process 0, which would save it
                os.kill(os.getpid(), signal.SIGKILL)
            out = (risks, ws, bs)
        return state, out

    def restore(self, path: str):
        from repro_torch.core import restore_sweep_state
        return restore_sweep_state(path, self.cfg, len(SWEEP_C), D,
                                   self.rank.world_size, self.per,
                                   self.X.dtype, device=self.rank.device)

    def leaves(self, state, out) -> List[np.ndarray]:
        from repro_torch.convert import to_numpy
        from repro_torch.core import expand_sweep_sv
        return [to_numpy(a) for a in (*expand_sweep_sv(state), *out)]


def crash_leg(rank, ckpt_dir: str, rounds: int, kill_round: int) -> None:
    """The crash leg on this rank; never returns (see the module doc)."""
    import json
    sw = _Sweep(rank, ckpt_dir)
    hb = os.path.join(ckpt_dir, f"hb_r{rank.rank}.json")
    state, _ = sw.run(sw.init(), 0, 1, checkpoint=True,
                      kill_after=kill_round - 1)
    try:
        with faults.CollectiveWatchdog(
                60.0, heartbeat_path=hb, layer="transport",
                cause=f"rank {rank.rank} ring merge collective") as wd:
            for t in range(1, rounds):
                state, _ = sw.run(state, t, t + 1, checkpoint=True,
                                  kill_after=kill_round - 1)
                wd.beat()
    except Exception as e:                 # raised, not stranded
        tmp = hb + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"status": "detected", "layer": "transport",
                       "cause": f"{type(e).__name__}: {e}"}, f)
        os.replace(tmp, hb)
        print(f"FaultDetected[transport]: rank {rank.rank} lost a peer "
              f"({type(e).__name__}) — restart from the last checkpoint "
              "generation", flush=True)
        raise SystemExit(faults.WATCHDOG_EXIT_CODE)
    raise SystemExit("crash leg completed: process 1 never died")


def resume_leg(rank, ckpt_dir: str, rounds: int, kill_round: int) -> dict:
    """The resume leg on this rank (see the module doc). → what it saw."""
    import torch.distributed as dist
    from repro_torch.ckpt.checkpoint import latest_path, latest_step
    sw = _Sweep(rank, ckpt_dir)
    want = sw.leaves(*sw.run(sw.init(), 0, rounds))

    def resumed(t0: int) -> int:
        got = sw.leaves(*sw.run(sw.restore(latest_path(ckpt_dir)), t0 + 1,
                                rounds))
        if len(got) != len(want) or not all(
                np.array_equal(a, b, equal_nan=True)
                for a, b in zip(got, want)):
            raise AssertionError(f"rank {rank.rank}: the sweep resumed "
                                 f"after round {t0} differs from the "
                                 "uninterrupted run")
        return len(got)

    newest = latest_step(ckpt_dir)
    if newest != kill_round - 1:
        raise AssertionError(f"newest generation {newest}, expected "
                             f"{kill_round - 1}")
    n_leaves = resumed(newest)
    dist.barrier()
    if rank.rank == 0:           # corrupt the newest generation's medium
        path = latest_path(ckpt_dir)
        with open(path, "r+b") as f:
            f.seek(os.path.getsize(path) // 2)
            byte = f.read(1)
            f.seek(-1, 1)
            f.write(bytes([byte[0] ^ 0x40]))
    dist.barrier()
    before = faults.counters().get("ckpt_fallbacks", 0)
    fallback = latest_step(ckpt_dir)
    if fallback != kill_round - 2 or \
            faults.counters().get("ckpt_fallbacks", 0) <= before:
        raise AssertionError(f"corrupt newest generation: latest_step "
                             f"{fallback}, expected {kill_round - 2} "
                             "and a counted fallback")
    resumed(fallback)
    return {"newest": newest, "fallback": fallback, "leaves": n_leaves}


def run_legs(rank, legs: Sequence[str], out_dir: str, rounds: int,
             kill_round: int) -> dict:
    """Rank target of :func:`main`: the legs on this rank. → ``{"pid",
    "process_count", "backend", "routes": launches by route, "modules":
    whether JAX or the reference was imported, "resume": what the resume
    leg saw}``."""
    from repro_torch.kernels import ops
    with open(os.path.join(out_dir, f"pid_r{rank.rank}"), "w") as f:
        f.write(str(os.getpid()))
    before = dict(ops.ROUTE_LAUNCHES)
    out = {"pid": os.getpid(), "process_count": compat.process_count(),
           "backend": rank.backend, "resume": None}
    ckpt_dir = os.path.join(out_dir, "ckpt")
    if "rounds" in legs:
        res = rounds_leg(rank, rounds)
        res["routes"] = {k: v - before.get(k, 0)
                         for k, v in ops.ROUTE_LAUNCHES.items()
                         if v - before.get(k, 0)}
        if rank.rank == 0:
            tmp = os.path.join(out_dir, "rounds.pkl.tmp")
            with open(tmp, "wb") as f:
                pickle.dump(res, f)
            os.replace(tmp, os.path.join(out_dir, "rounds.pkl"))
    if "resume" in legs:
        out["resume"] = resume_leg(rank, ckpt_dir, rounds + 1, kill_round)
    out["routes"] = {k: v - before.get(k, 0)
                     for k, v in ops.ROUTE_LAUNCHES.items()
                     if v - before.get(k, 0)}
    out["modules"] = sorted(m for m in ("jax", "repro") if m in sys.modules)
    if "crash" in legs:
        os.makedirs(ckpt_dir, exist_ok=True)
        crash_leg(rank, ckpt_dir, rounds + 1, kill_round)
    return out


def main(argv: Optional[Sequence[str]] = None) -> int:
    from repro_torch.launch.cluster import (add_cluster_flags,
                                            cluster_config_from_args,
                                            init_cluster)
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    add_cluster_flags(ap)
    ap.add_argument("--out", required=True,
                    help="directory shared by the processes")
    ap.add_argument("--legs", default="rounds",
                    help=f"comma-separated, of {LEGS}")
    ap.add_argument("--rounds", type=int, default=3,
                    help="rounds of the round legs (the sweep runs one "
                         "more)")
    ap.add_argument("--kill-round", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    legs = [x for x in args.legs.split(",") if x]
    if set(legs) - set(LEGS):
        raise SystemExit(f"unknown legs {sorted(set(legs) - set(LEGS))}")
    if "resume" in legs:
        # armed BEFORE init_cluster: the restarted process's handshake
        # flaps 1-2 times and init_cluster's retry absorbs it
        faults.set_active(faults.FaultPlan.single("handshake_flake",
                                                  seed=args.process_id or 0))
    cluster = init_cluster(cluster_config_from_args(args))
    if "resume" in legs:
        retries = faults.counters().get("retries", 0)
        faults.set_active(None)
        if retries < 1:
            raise SystemExit("handshake flake armed but init_cluster never "
                             "retried")
        print(f"[p{cluster.process_index}] flaky coordinator handshake "
              f"absorbed by the retry ({retries} retries)", flush=True)
    print(f"[p{cluster.process_index}] joined {cluster.describe()}",
          flush=True)
    os.makedirs(args.out, exist_ok=True)
    try:
        per_rank = compat.spawn(
            run_legs, cluster.local_device_count,
            (legs, args.out, args.rounds, args.kill_round),
            device=args.device, cluster=cluster,
            timeout_s=args.cluster_timeout,
            join_timeout_s=900.0)
    except compat.RankFailed as e:
        if e.exitcode == faults.WATCHDOG_EXIT_CODE:
            print(f"[p{cluster.process_index}] {e}", flush=True)
            return faults.WATCHDOG_EXIT_CODE
        raise
    with open(os.path.join(args.out, f"result_p{cluster.process_index}.pkl"),
              "wb") as f:
        pickle.dump(per_rank, f)
    print(f"MP_OK {','.join(legs)}", flush=True)
    return 0


# ---------------------------------------------------------------------------
# The parent's side: N processes of one run.
# ---------------------------------------------------------------------------

def launch(module: str, num_processes: int, local: int,
           args: Sequence[str] = (), env: Optional[dict] = None,
           log_dir: Optional[str] = None) -> List[subprocess.Popen]:
    """Start ``python -m <module>`` as ``num_processes`` processes of one
    cluster (coordinator on a free localhost port, ``local`` ranks
    each), with ``args`` after the cluster flags. The package's source
    directory goes first on ``PYTHONPATH``. Output goes to
    ``<log_dir>/p<i>.log`` (else a pipe). → the processes, in order."""
    src = str(Path(__file__).resolve().parents[2])
    env = dict(os.environ if env is None else env)
    env["PYTHONPATH"] = os.pathsep.join(
        [src] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                 if p])
    from repro_torch.launch.cluster import free_port
    port = free_port()
    procs = []
    for i in range(num_processes):
        out = (open(os.path.join(log_dir, f"p{i}.log"), "w")
               if log_dir else subprocess.PIPE)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", module, "--coordinator",
             f"127.0.0.1:{port}", "--num-processes", str(num_processes),
             "--process-id", str(i), "--local-devices", str(local),
             *args], stdout=out, stderr=subprocess.STDOUT, text=True,
            env=env))
        if log_dir:
            out.close()
    return procs


def alive(pids: Sequence[int]) -> List[int]:
    """Those of ``pids`` that still run (not zombies)."""
    out = []
    for pid in pids:
        try:
            with open(f"/proc/{pid}/stat") as f:
                state = f.read().rsplit(")", 1)[1].split()[0]
        except OSError:
            continue
        if state != "Z":
            out.append(pid)
    return out


def rank_pids(out_dir: str) -> List[int]:
    """The pids the ranks of a run wrote to ``out_dir``."""
    return [int(p.read_text()) for p in Path(out_dir).glob("pid_r*")]


def wait_all(procs, timeout_s: float) -> List[int]:
    """Wait for every process, killing those still running at the
    limit. → their return codes."""
    deadline = time.monotonic() + timeout_s
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [p.returncode for p in procs]


if __name__ == "__main__":
    sys.exit(main())
