"""Training entry point, ported from ``repro/launch/train.py``: its
svm-tfidf mode, on one process or on N processes of a cluster.

A process joins the cluster (:func:`repro_torch.launch.cluster.
init_cluster`), starts its k ranks (:func:`repro_torch.compat.spawn`,
``--local-devices``, default one a card), and each rank makes only its
own rows and runs the sharded MapReduce round on them. Output comes from
process 0 only.

    PYTHONPATH=src python -m repro_torch.launch.train --arch svm-tfidf \\
        --smoke --local-devices 8 --device cpu

Multi-process (each line its own process, on one machine or several):

    PYTHONPATH=src python -m repro_torch.launch.train --arch svm-tfidf \\
        --smoke --coordinator 127.0.0.1:9911 --num-processes 2 \\
        --process-id 0 --local-devices 4 --device cpu

On the card drop ``--device cpu`` (and ``--smoke`` for full width: 8192
rows × 131072 bf16 features a rank). ``--rows host`` makes each rank's
rows with the reference's numpy generator (``svm_rows_shard``, byte for
byte the reference's rows); the default makes them on the rank's device
(``svm_rows_device``). ``--report PATH`` writes process 0's JSON record
of the run: every rank's times, each round's SV ids and α, launches by
route, peak memory. ``--split-ms`` times each round's solve and eq. 7
between device syncs (the rest is the merge).

The LM mode (``--arch`` of an LM config) trains as the reference's:
random weights (``torch.Generator`` seed 0), the synthetic token stream
(``data.lm_batch_at``), ``build_train_step`` without remat, a line every
10 steps and ``--ckpt PATH`` saving ``{"params": params}`` in the
reference's file format:

    PYTHONPATH=src python -m repro_torch.launch.train --arch \
        tinyllama-1.1b --smoke --steps 2 --batch 2 --seq 64 --device cpu

``--data-par D --model-par M`` (a dense or VLM arch) trains on a (D × M)
mesh of D·M ranks (``compat.spawn``; gloo on the CPU or on one card):
each rank its shards of the same seed-0 weights and its rows of each
batch, rank 0 printing the same lines (the one process's losses, to
rounding) and saving the gathered weights:

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \
        --smoke --steps 2 --batch 4 --seq 64 --data-par 2 --model-par 2 \
        --device cpu

The MoE, SSM, hybrid and encoder-decoder archs on more than one rank
raise (ROADMAP Queue 1 item 13g-c); a multi-process LM launch exits, as
the reference's.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
from typing import List, NamedTuple, Optional, Sequence

import torch

from repro_torch import compat
from repro_torch.configs import get_config
from repro_torch.core.mapreduce_svm import SHUFFLE_IMPLS, MRSVMConfig
from repro_torch.launch.cluster import (add_cluster_flags,
                                        cluster_config_from_args,
                                        init_cluster)

_T0 = time.time()        # this process's start, as near as the import is


class TrainJob(NamedTuple):
    """What every rank of a train run needs."""
    n: int
    d: int
    per: int
    dtype: str
    cfg: MRSVMConfig
    sweep: int
    rows: str             # "device" | "host"
    split_ms: bool
    handshake_ms: float
    started: float        # the launching process's start (epoch s)


@contextlib.contextmanager
def split_timer(device, acc: dict):
    """While the block runs, ``ops.cd_solve`` and ``ops.hinge_scores`` add
    their ms to ``acc["solve"]`` / ``acc["eq7"]``, each call between two
    device syncs."""
    from repro_torch.kernels import ops
    shipped = {"solve": ops.cd_solve, "eq7": ops.hinge_scores}
    dev = torch.device(device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def wrap(part):
        def run(*a, **kw):
            sync()
            t0 = time.perf_counter()
            out = shipped[part](*a, **kw)
            sync()
            acc[part] += 1e3 * (time.perf_counter() - t0)
            return out
        return run
    ops.cd_solve, ops.hinge_scores = wrap("solve"), wrap("eq7")
    try:
        yield acc
    finally:
        ops.cd_solve, ops.hinge_scores = shipped["solve"], shipped["eq7"]


def _rank_rows(rank, job: TrainJob):
    """This rank's rows and labels on its device, made here."""
    from repro_torch.data.pipeline import svm_rows_device, svm_rows_shard
    dt = getattr(torch, job.dtype)
    shard = dict(process_index=rank.rank, process_count=rank.world_size)
    if job.rows == "host":
        Xl, yl = svm_rows_shard(job.n, job.d, seed=0, **shard)
        return (torch.from_numpy(Xl).to(rank.device).to(dt),
                torch.from_numpy(yl).to(rank.device))
    return svm_rows_device(job.n, job.d, seed=0, dtype=dt,
                           device=rank.device, **shard)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _rounds(rank, job: TrainJob, X, y) -> dict:
    """The reference's round loop over the sharded round on this rank:
    rounds until |prev − r| ≤ γ or ``max_rounds``. → per-round records
    and this rank's accuracy of the last round's best reducer."""
    from repro_torch.convert import to_numpy
    from repro_torch.core import build_sharded_round, init_sv_buffer
    from repro_torch.core.svm import decision_linear
    cfg = job.cfg
    fn = build_sharded_round(cfg, job.per, device=rank.device)
    sv = init_sv_buffer(cfg.sv_capacity, job.d, X.dtype, rank.device)
    m = torch.ones_like(y)
    recs, prev = [], float("inf")
    for t in range(cfg.max_rounds):
        acc = {"solve": 0.0, "eq7": 0.0}
        _sync(rank.device)
        t0 = time.perf_counter()
        with (split_timer(rank.device, acc) if job.split_ms
              else contextlib.nullcontext()):
            sv, risks, w, b = fn(X, y, m, sv)
        r = float(risks.min())
        ms = 1e3 * (time.perf_counter() - t0)
        recs.append({"risk": r, "sv": int(sv.mask.sum()),
                     "ids": to_numpy(sv.ids).tolist(),
                     "alpha": to_numpy(sv.alpha).astype(float).tolist(),
                     "ms": ms, "solve_ms": acc["solve"],
                     "eq7_ms": acc["eq7"],
                     "merge_ms": ms - acc["solve"] - acc["eq7"]})
        if t > 0 and abs(prev - r) <= cfg.gamma:
            break
        prev = r
    # in row chunks: a float32 copy of a full-width rank's rows is 4.3 GB
    s = decision_linear(w.float(), b.float(), X, chunk_rows=1024)
    hit = (torch.sign(s) == y.float()).float().mean()
    return {"rounds": recs, "acc": float(hit)}


def _sweep(rank, job: TrainJob, X, y) -> dict:
    """``--sweep S`` on this rank: :func:`repro_torch.launch.sharded.
    fit_sharded_sweep` (C = logspace(-2, 1, S)) on its rows."""
    from repro_torch.launch.sharded import fit_sharded_sweep
    acc = {"solve": 0.0, "eq7": 0.0}
    with (split_timer(rank.device, acc) if job.split_ms
          else contextlib.nullcontext()):
        res = fit_sharded_sweep(rank, X, y, job.cfg, sweep=job.sweep)
    n = len(res["history"])
    return {"sweep": {
        "C": [float(c) for c in res["C"]],
        "risks": res["risks"].astype(float).tolist(),
        "acc": res["acc"], "rounds": res["rounds"].tolist(),
        "best": int(res["best"]),
        "history": [h.astype(float).tolist() for h in res["history"]],
        "ids": res["ids"].tolist(),
        "alpha": res["alpha"].astype(float).tolist(),
        "ms": res["ms"], "round_ms": res["ms"] / n,
        "solve_ms": acc["solve"] / n, "eq7_ms": acc["eq7"] / n,
        "merge_ms": (res["ms"] - acc["solve"] - acc["eq7"]) / n}}


def train_rank(rank, job: TrainJob) -> dict:
    """Rank target of :func:`train_svm`: this rank's rows, then the round
    loop or the sweep. → this rank's record; rank 0's also holds every
    rank's (``"all"``, one ``all_gather_object`` after the run)."""
    import torch.distributed as dist
    from repro_torch.kernels import ops
    t0 = time.time()
    X, y = _rank_rows(rank, job)
    _sync(rank.device)
    if torch.device(rank.device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(rank.device)
    before = dict(ops.ROUTE_LAUNCHES)
    first = time.time()
    out = (_sweep if job.sweep >= 1 else _rounds)(rank, job, X, y)
    _sync(rank.device)
    out.update(
        rank=rank.rank, process=rank.process_index, pid=os.getpid(),
        handshake_ms=job.handshake_ms, rows_s=first - t0,
        first_round_at=first, first_round_s=first - job.started,
        peak_bytes=(torch.cuda.max_memory_allocated(rank.device)
                    if torch.device(rank.device).type == "cuda" else None),
        routes={k: v - before.get(k, 0) for k, v in
                ops.ROUTE_LAUNCHES.items() if v - before.get(k, 0)})
    every = [None] * rank.world_size
    dist.all_gather_object(every, out)
    out["all"] = every if rank.rank == 0 else None
    return out


def svm_job(svm_cfg, world: int, *, smoke: bool = False, rounds: int = 6,
            shuffle: Optional[str] = None, sweep: int = 0,
            rows: str = "device", rows_per_device: int = 0,
            split_ms: bool = False, handshake_ms: float = 0.0) -> TrainJob:
    """The job of a train run over ``world`` ranks, as the reference's
    train mode configures it (``repro/launch/train.py:59-74``): the
    ``--smoke`` cut, the rows, and the MapReduce config (γ = 1e-4,
    ``rounds`` rounds, the config's transport unless ``shuffle``)."""
    from repro_torch.core.svm import SVMConfig
    from repro_torch.launch.mesh import simulated_hier_hosts
    if smoke:
        svm_cfg = dataclasses.replace(svm_cfg, num_features=256,
                                      sv_capacity=64, rows_per_device=64,
                                      dtype="float32")
    per = rows_per_device or svm_cfg.rows_per_device
    shuffle = shuffle or svm_cfg.shuffle_impl
    cfg = MRSVMConfig(sv_capacity=svm_cfg.sv_capacity, gamma=1e-4,
                      max_rounds=max(1, rounds), shuffle_impl=shuffle,
                      hier_num_hosts=(simulated_hier_hosts(world)
                                      if shuffle == "hier" else None),
                      svm=SVMConfig(C=svm_cfg.C,
                                    max_epochs=svm_cfg.max_epochs))
    return TrainJob(world * per, svm_cfg.num_features, per, svm_cfg.dtype,
                    cfg, sweep, rows, split_ms, handshake_ms, _T0)


def train_svm(svm_cfg, args, cluster) -> Optional[dict]:
    """The svm-tfidf train mode (``repro/launch/train.py:42-128``): rows
    sharded over ``cluster``'s ranks, each rank making its own; ``--sweep
    S`` runs S configs a round as one batched sweep. Process 0 prints the
    reference's lines. → process 0's report (every rank's records), or
    None on another process."""
    say = print if cluster.is_coordinator else (lambda *a, **k: None)
    world, k = cluster.device_count, cluster.local_device_count
    job = svm_job(svm_cfg, world, smoke=args.smoke, rounds=args.rounds,
                  shuffle=args.shuffle, sweep=args.sweep, rows=args.rows,
                  rows_per_device=args.rows_per_device,
                  split_ms=args.split_ms, handshake_ms=cluster.handshake_ms)
    n, d, per, cfg = job.n, job.d, job.per, job.cfg
    say(f"svm-tfidf: {n} rows × {d} features over {world} devices, "
        f"{cluster.process_count} process(es) ({per * k} rows made per "
        f"process, {per} per rank)")
    t0 = time.perf_counter()
    mine = compat.spawn(train_rank, k, (job,),
                        device=args.device or "cuda",
                        cluster=cluster if cluster.is_distributed else None,
                        timeout_s=args.cluster_timeout,
                        join_timeout_s=3600.0)
    secs = time.perf_counter() - t0
    if not cluster.is_coordinator:
        return None
    every = mine[0]["all"]
    # the process-local shard's accuracy, as the reference's: its ranks'
    # shards are equal parts of it
    local = [r for r in every if r["process"] == cluster.process_index]
    if args.sweep >= 1:
        sw = every[0]["sweep"]
        for s in range(args.sweep):
            acc = sum(r["sweep"]["acc"][s] for r in local) / len(local)
            say(f"  config C={sw['C'][s]:<8.4g} R_emp={sw['risks'][s]:.4f} "
                f"acc={acc:.3f} rounds={sw['rounds'][s]}")
        say(f"sweep selected C={sw['C'][sw['best']]:.4g} ({args.sweep} "
            f"configs, {sw['ms'] / 1e3:.1f}s)")
    else:
        for t, rec in enumerate(every[0]["rounds"]):
            say(f"round {t}: R_emp={rec['risk']:.4f} |SV|={rec['sv']}")
        acc = sum(r["acc"] for r in local) / len(local)
        say(f"best-reducer accuracy: {acc:.3f}"
            + (" (host-local shard)" if cluster.is_distributed else ""))
    routes: dict = {}
    for r in every:
        for key, v in r["routes"].items():
            routes[key] = routes.get(key, 0) + v
    report = {"n": n, "d": d, "world": world,
              "processes": cluster.process_count, "local_ranks": k,
              "cfg": dataclasses.asdict(cfg), "spawn_s": secs,
              "routes": routes, "ranks": every}
    if args.report:
        with open(args.report, "w") as f:
            json.dump(report, f)
    return report


def train_lm(cfg, args) -> List[float]:
    """The LM train mode (``repro/launch/train.py:155-194``) on
    ``args.device`` (default cuda): one process, or with ``--data-par D
    --model-par M`` above 1 a (D × M) mesh of ``compat.spawn`` ranks
    (dense and VLM archs), rank 0 printing. → the losses printed."""
    from repro_torch.device import resolve_device
    from repro_torch.models.config import smoke_variant
    if args.smoke:
        cfg = smoke_variant(cfg)
    job = (cfg, args.data_par, args.model_par, args.steps, args.batch,
           args.seq, args.ckpt)
    if args.data_par * args.model_par > 1:
        if cfg.family not in ("dense", "vlm"):
            raise NotImplementedError(
                f"--data-par / --model-par above 1 for the {cfg.family} "
                "family is not ported to repro_torch yet (ROADMAP Queue 1 "
                "item 13g-c)")
        on = "cpu" if resolve_device(args.device).type == "cpu" else "cuda"
        return compat.spawn(train_lm_rank, args.data_par * args.model_par,
                            job, device=on, join_timeout_s=3600.0)[0]
    return _train_lm_loop(resolve_device(args.device), None, *job)


def train_lm_rank(rank, *job) -> List[float]:
    """A rank of the LM train mode on a mesh (``compat.spawn`` target):
    ``make_host_mesh(data, model)``, its shards of the seed-0 weights
    and its rows of each batch; rank 0 prints the lines and saves the
    checkpoint. → the losses (every rank's the same)."""
    from repro_torch.launch.mesh import make_host_mesh
    return _train_lm_loop(torch.device(rank.device),
                          make_host_mesh(*job[1:3]), *job, say=rank.rank == 0)


def _train_lm_loop(dev, mesh, cfg, data, model, steps, batch, seq, ckpt,
                   say: bool = True) -> List[float]:
    from repro_torch import optim
    from repro_torch.ckpt import save
    from repro_torch.data import DataConfig, lm_batch_at
    from repro_torch.launch.steps import (InputShape, build_train_step,
                                          gather_tree, local_batch)
    shape = InputShape("cli", "train", seq, batch)
    bundle = build_train_step(cfg, mesh, shape, remat=False)
    params = bundle.model.init(torch.Generator(device=dev).manual_seed(0))
    opt_state = optim.init(params)
    dcfg = DataConfig(batch_size=batch, seq_len=seq)
    losses = []
    t0 = time.time()
    for step in range(steps):
        b = lm_batch_at(dcfg, cfg, step)
        b = (local_batch(b, bundle.in_shardings[2], mesh, dev)
             if mesh is not None else
             {k: torch.from_numpy(v).to(dev) for k, v in b.items()})
        params, opt_state, m = bundle.fn(params, opt_state, b)
        if step % 10 == 0 or step == steps - 1:
            losses.append(float(m["loss"]))
            if say:
                print(f"step {step:4d} loss {losses[-1]:.4f} "
                      f"gnorm {float(m['grad_norm']):.2f} "
                      f"{(step + 1) * batch * seq / (time.time() - t0):,.0f} "
                      "tok/s" + (f" ({data} × {model} ranks)"
                                 if mesh is not None else ""), flush=True)
    if ckpt:
        if mesh is not None:
            params = gather_tree(params, bundle.in_shardings[0], mesh)
        if say:
            save(ckpt, {"params": params}, step=steps)
            print(f"saved {ckpt}")
    return losses


def main(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced variant (svm: d 256, sv_capacity 64, 64 "
                         "rows a rank, f32; LM: smoke_variant)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--data-par", type=int, default=1)
    ap.add_argument("--model-par", type=int, default=1)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--sweep", type=int, default=0,
                    help="svm family: run S configs (C = logspace(-2, 1, "
                         "S)) a round as one batched sweep")
    ap.add_argument("--rounds", type=int, default=6,
                    help="svm family: MapReduce rounds")
    ap.add_argument("--rows-per-device", type=int, default=0,
                    help="svm family: override rows per rank")
    ap.add_argument("--shuffle", default=None, choices=SHUFFLE_IMPLS,
                    help="svm family: SV merge transport (default: the "
                         "arch config's shuffle_impl)")
    ap.add_argument("--rows", default="device", choices=("device", "host"),
                    help="svm family: make each rank's rows on its device "
                         "(svm_rows_device), or the reference's rows with "
                         "numpy (svm_rows_shard)")
    ap.add_argument("--device", default=None,
                    help="torch device of the ranks (default cuda; 'cpu' "
                         "runs the plain versions of the kernels)")
    ap.add_argument("--split-ms", action="store_true",
                    help="time each round's solve and eq. 7 between device "
                         "syncs")
    ap.add_argument("--report", default=None,
                    help="process 0 writes its JSON record of the run here")
    add_cluster_flags(ap)
    args = ap.parse_args(argv)

    cluster = init_cluster(cluster_config_from_args(args))
    cfg = get_config(args.arch)
    if getattr(cfg, "family", None) == "svm":
        return train_svm(cfg, args, cluster)
    if cluster.is_distributed:
        raise SystemExit(
            "multi-process launch currently covers the svm family; the "
            "LM data pipeline still materializes full global batches")
    return train_lm(cfg, args)


if __name__ == "__main__":
    main()
