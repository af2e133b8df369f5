"""Multi-process MapReduce-SVM on the PyTorch port: the paper's actual
deployment shape, N processes, each holding only its shard of the
TF×IDF rows, exchanging nothing but support vectors. The twin of
``examples/multihost_svm.py``.

Each process joins the cluster (``repro_torch.launch.cluster``) and
starts its k ranks (``--local-devices``, default one a card); rank r of
the 2k makes only its own rows and runs the sharded round. The
2-process launch line (each in its own shell or host; the same flags
work for ``-m repro_torch.launch.train --arch svm-tfidf``):

    PYTHONPATH=src python examples/torch_multihost_svm.py \\
        --coordinator 127.0.0.1:9911 --num-processes 2 --process-id 0 \\
        --local-devices 4 --device cpu &
    PYTHONPATH=src python examples/torch_multihost_svm.py \\
        --coordinator 127.0.0.1:9911 --num-processes 2 --process-id 1 \\
        --local-devices 4 --device cpu

Run with no cluster flags to have the script start both processes
itself (4 ranks each on the CPU with ``--device cpu``, else one a card).
"""
import argparse
import os
import subprocess
import sys


def rank_main(rank, n, d):
    """One rank: its own rows, the round loop, its rows' accuracy."""
    import torch
    from repro_torch.core import (MRSVMConfig, SVMConfig,
                                  build_sharded_round, init_sv_buffer)
    from repro_torch.data import svm_rows_shard
    cfg = MRSVMConfig(sv_capacity=32 * rank.world_size, gamma=1e-4,
                      svm=SVMConfig(C=1.0, max_epochs=15))
    Xl, yl = svm_rows_shard(n, d, seed=0, process_index=rank.rank,
                            process_count=rank.world_size)
    X = torch.from_numpy(Xl).to(rank.device)
    y = torch.from_numpy(yl).to(rank.device)
    round_fn = build_sharded_round(cfg, Xl.shape[0], device=rank.device)
    sv = init_sv_buffer(cfg.sv_capacity, d, torch.float32, rank.device)
    lines, prev = [], float("inf")
    for t in range(6):
        sv, risks, w, b = round_fn(X, y, torch.ones_like(y), sv)
        r = float(risks.min())                  # the same on every rank
        lines.append(f"round {t}: R_emp={r:.4f} |SV|={int(sv.mask.sum())}")
        if t > 0 and abs(prev - r) <= cfg.gamma:   # eq. 8
            lines.append("eq. 8 convergence")
            break
        prev = r
    acc = float((torch.sign(X @ w) == y).float().mean())
    return lines, acc


def worker(args) -> None:
    from repro_torch import compat
    from repro_torch.launch.cluster import (cluster_config_from_args,
                                            init_cluster)
    cluster = init_cluster(cluster_config_from_args(args))
    say = print if cluster.is_coordinator else (lambda *a, **k: None)
    say(f"cluster: {cluster.describe()}")
    ndev = cluster.device_count
    n, d = 128 * ndev, 2048
    say(f"{n} rows × {d} features: {n // ndev} rows a rank, "
        f"{n // cluster.process_count} a process over "
        f"{cluster.process_count} processes, {ndev} ranks")
    out = compat.spawn(rank_main, cluster.local_device_count, (n, d),
                       device=args.device or "cuda",
                       cluster=cluster if cluster.is_distributed else None)
    for line in out[0][0]:
        say(line)
    # the process-local shard is its ranks' shards, equal in size
    acc = sum(a for _, a in out) / len(out)
    print(f"[p{cluster.process_index}] hypothesis accuracy on the "
          f"process-local shard: {acc:.3f}")


def main():
    ap = argparse.ArgumentParser()
    from repro_torch.launch.cluster import add_cluster_flags
    add_cluster_flags(ap)
    ap.add_argument("--device", default=None,
                    help="torch device of the ranks (default cuda)")
    args = ap.parse_args()
    if args.process_id is not None:
        return worker(args)

    # no cluster flags: start the 2-process launch above
    from repro_torch.launch.cluster import free_port
    num = args.num_processes or 2
    local = args.local_devices or (4 if args.device == "cpu" else None)
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    env = dict(os.environ,
               PYTHONPATH=src + os.pathsep + os.environ.get("PYTHONPATH", ""))
    port = free_port()
    procs = [subprocess.Popen(
        [sys.executable, __file__, "--coordinator", f"127.0.0.1:{port}",
         "--num-processes", str(num), "--process-id", str(i),
         *(["--local-devices", str(local)] if local else []),
         *(["--device", args.device] if args.device else [])], env=env)
        for i in range(num)]
    # signal-killed workers return NEGATIVE codes; any nonzero is failure
    sys.exit(1 if any(p.wait() != 0 for p in procs) else 0)


if __name__ == "__main__":
    main()
