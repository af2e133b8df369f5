"""Serving entry points: the LM family's greedy decode loop and the svm
family's streaming polarization service.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \\
        --batch 8 --cache-len 4096 --tokens 16             # full width, card
    PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \\
        --smoke --batch 4 --tokens 16                      # on the card
    PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \\
        --smoke --tokens 4 --batch 2 --cache-len 64 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch svm-tfidf \\
        --smoke --streams 4 --waves 3                      # on the card

LM (tinyllama-1.1b, llama3-8b, qwen2-1.5b, chatglm3-6b, llava-next-34b,
mixtral-8x22b, qwen3-moe-235b-a22b, rwkv6-7b, zamba2-1.2b, whisper-base):
the loop starts from a zero cache (or recurrent state) and token 0 and
feeds each step's argmax back in, as ``repro/launch/serve.py:188-218``;
llava decodes its text from token 0 with no prefix, as the reference's
does, and whisper against the cross K/V of seeded stub frames. Every step stays
on the device: the tokens are copied to the host once, after the loop.

``--data-par D --model-par M`` (D · M > 1) serves a dense or VLM arch on
a (data × model) mesh of D · M ranks (``compat.spawn``: gloo where they
share a card or run on the CPU), as the reference's
``make_host_mesh(data_par, model_par)``: each rank holds its shards of
the weights and the cache (``launch.sharding``), and rank 0 prints the
line. The other families under such a mesh raise (ROADMAP Queue 1 item
13g-c).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch chatglm3-6b \
        --smoke --device cpu --data-par 2 --model-par 2

svm: micro-batches of drifting messages fold into each tenant's
SV_global behind the service's background scheduler
(:mod:`repro_torch.serving.svm_stream`), as ``repro/launch/serve.py:
34-133``: the streams submit one after another and the scheduler folds
what has queued when it wakes, so a wave's first stream may fold alone
and the rest as one sweep. ``--checkpoint-dir`` saves every tenant's
snapshot on register and every ``--checkpoint-every`` waves (the newest
``--checkpoint-keep`` generations kept); ``--restore`` rebuilds the
service from that directory instead of retraining the streams, and the
waves count from the restored versions; ``--fold-deadline`` arms the
fold watchdog (heartbeat file ``--heartbeat``), which exits the process
with code 17 on a stalled fold. ``--shuffle`` sets the config's SV merge
transport (and for ``hier`` the simulated host count of
:func:`repro_torch.launch.mesh.simulated_hier_hosts`), as the
reference's does. The cluster flags (:mod:`repro_torch.launch.cluster`)
make the service process-count-aware: process 0 admits and folds, every
other process is a read-only replica that serves its snapshots.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch svm-tfidf \
        --smoke --streams 3 --waves 2 --checkpoint-dir /tmp/ck
    PYTHONPATH=src python -m repro_torch.launch.serve --arch svm-tfidf \
        --smoke --streams 3 --waves 2 --checkpoint-dir /tmp/ck --restore
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, Callable, List, NamedTuple, Optional, Sequence

import torch

from repro_torch import compat
from repro_torch.configs import get_config
from repro_torch.core.mapreduce_svm import (SHUFFLE_IMPLS, MRSVMConfig,
                                            fit_mapreduce)
from repro_torch.core.svm import SVMConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.launch.cluster import (add_cluster_flags,
                                        cluster_config_from_args,
                                        init_cluster)
from repro_torch.launch.steps import (InputShape, build_serve_step,
                                      make_serve_step)
from repro_torch.models.config import ModelConfig, smoke_variant
from repro_torch.models.layers import local_shard, shard_count
from repro_torch.models.transformer import build_model


class ServeResult(NamedTuple):
    tokens: torch.Tensor      # (steps, B) int32 on the CPU
    seconds: float            # host clock over the loop, to the last token
    tok_per_s: float          # steps · B / seconds
    state: Any                # after the last step (caches on the device)


def serve_lm(cfg: ModelConfig, *, batch: int, cache_len: int, tokens: int,
             device: DeviceLike = None, params=None,
             state=None, mesh=None,
             first: Optional[torch.Tensor] = None) -> ServeResult:
    """Greedy decode of ``tokens`` steps for ``batch`` sequences.

    ``params`` default to random ones from ``torch.Generator`` seed 0 on
    the device, ``state`` to a zero cache (or recurrent state) of
    ``cache_len`` at position 0; an encoder-decoder's state holds the
    cross K/V of stub frames N(0, 1) drawn from seed 1 (the reference's
    serve draws them from ``PRNGKey(1)``). A given state is advanced
    (its caches written in place). The first tokens are ``first`` ((batch,
    1) int32), else 0 as the reference's. Runs on ``cuda`` unless
    ``device`` says otherwise; raises without a card.

    ``mesh`` (a rank ``compat.Mesh``) serves on this rank's shards, as
    ``launch.steps.build_serve_step(cfg, mesh)`` places them (the default
    placement rules): the model repeats its KV heads
    ``kv_repeat_for(cfg, mesh)`` times, default ``params`` are this
    rank's shards of seed 0's weights (``params`` and ``state``, when
    given, this rank's shards), and the rank decodes its batch rows of
    ``first``. The result's tokens are every row's (gathered over the
    data ranks after the timed loop).
    """
    dev = resolve_device(device)
    if mesh is None:
        model, state_place, tok_place = build_model(cfg), None, ()
    else:
        bundle = build_serve_step(cfg, mesh, InputShape(
            "serve", "decode", cache_len, batch))
        model = bundle.model
        _, state_place, tok_place = bundle.in_shardings
    if params is None:
        params = model.init(torch.Generator(device=dev).manual_seed(0))
    if state is None and cfg.is_encoder_decoder:
        frames = torch.randn((batch, cfg.encoder_seq, cfg.d_model),
                             generator=torch.Generator(device=dev)
                             .manual_seed(1), device=dev)
        state = model.init_decode_state(batch, cache_len, dev,
                                        frames=frames.to(cfg.torch_dtype),
                                        params=params)
    elif state is None and mesh is None:
        state = model.init_decode_state(batch, cache_len, dev)
    elif state is None:
        state = model.init_decode_state(batch, cache_len, dev,
                                        place=state_place)
    step = make_serve_step(model)
    tok = (torch.zeros((batch, 1), dtype=torch.int32, device=dev)
           if first is None else first.to(dev, torch.int32))
    if mesh is not None:
        tok = local_shard(tok, tok_place, mesh)
    out = torch.empty((tokens, tok.shape[0]), dtype=torch.int32, device=dev)
    t0 = time.perf_counter()
    for i in range(tokens):
        nxt, state = step(params, state, tok)
        out[i] = nxt
        tok = nxt[:, None]
    host = out.cpu()                   # waits for the last step
    dt = time.perf_counter() - t0
    if tok_place and shard_count(tok_place[0], mesh) > 1:
        parts = compat.all_gather_groups(out, mesh.groups_of("data"))
        host = torch.cat(parts.unbind(0), dim=1).cpu()
    return ServeResult(host, dt, tokens * batch / dt, state)


def serve_rank(rank, cfg: ModelConfig, data: int, model: int, batch: int,
               cache_len: int, tokens: int) -> ServeResult:
    """A rank of the CLI's sharded serve (``compat.spawn`` target): the
    (data × model) mesh of :func:`repro_torch.launch.mesh.make_host_mesh`,
    one :func:`serve_lm` on it; rank 0 prints the reference's line. →
    the result without its state, the tokens as numpy (a tensor would
    leave the rank through shared memory, which ends with it)."""
    from repro_torch.launch.mesh import make_host_mesh
    res = serve_lm(cfg, batch=batch, cache_len=cache_len, tokens=tokens,
                   device=rank.device, mesh=make_host_mesh(data, model))
    if rank.rank == 0:
        print(f"{cfg.name}: {tokens} tokens × {batch} seqs in "
              f"{res.seconds:.2f}s → {res.tok_per_s:,.1f} tok/s "
              f"({data} × {model} ranks)", flush=True)
    return res._replace(tokens=res.tokens.numpy(), state=None)


def stream_batch(stream: int, wave: int, rows: int, d: int,
                 dtype: torch.dtype, device, drift: float = 0.4):
    """Synthetic drifting message batch: rows N(0, 1) in ``dtype``,
    labels sign(x·w) against stream ``stream``'s separator w = w0 +
    drift · wave · wd, which rotates along a per-stream direction. Made
    on ``device`` from seeded ``torch.Generator`` s (w0: seed ``stream``,
    wd: 500 + ``stream``, rows: 1000 · ``stream`` + ``wave``). → (X
    (rows, d), y (rows,) in ``dtype``)."""
    dev = torch.device(device)

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)
    w0 = torch.randn(d, generator=gen(stream), device=dev)
    wd = torch.randn(d, generator=gen(500 + stream), device=dev)
    w = w0 + drift * wave * wd
    X = torch.randn((rows, d), generator=gen(1000 * stream + wave),
                    device=dev, dtype=dtype)
    y = torch.sign(X.float() @ w).to(dtype)
    return X, y


class StreamServeResult(NamedTuple):
    service: object            # the stopped StreamingSVMService
    cfg: MRSVMConfig
    stale: List[List[float]]   # per wave, per stream: acc before the fold
    fresh: List[List[float]]   # per wave, per stream: acc after it
    seconds: List[float]       # per wave: submit → every stream folded


def _accuracy(svc, stream: str, X, y) -> float:
    return float((svc.predict(stream, X) == y).float().mean())


def serve_svm(svm_cfg, *, streams: int = 4, waves: int = 3,
              smoke: bool = False, partitions: int = 8,
              quarantine: bool = True, device=None,
              checkpoint_dir: Optional[str] = None,
              checkpoint_every: int = 1, checkpoint_keep: int = 3,
              restore: bool = False, fold_deadline: Optional[float] = None,
              heartbeat: Optional[str] = None,
              shuffle: Optional[str] = None,
              test_probe: Optional[Callable] = None,
              cluster=None,
              fail_on_retrace: bool = False) -> StreamServeResult:
    """The streaming polarization serve mode (``--arch svm-tfidf``).

    Registers ``streams`` tenants, each trained by ``fit_mapreduce`` on
    its wave-0 batch, starts the background scheduler and runs
    ``waves`` waves: each stream submits its drifting batch
    (:func:`stream_batch`), and the wave ends when every stream's
    snapshot has swapped; the stale and folded accuracies on that batch
    are printed. ``smoke`` cuts the config to d 128, ``sv_capacity`` 64,
    256 rows a wave, f32. The service and the batches live on ``device``
    (default ``cuda``). ``checkpoint_dir``, ``checkpoint_every``,
    ``checkpoint_keep``, ``fold_deadline`` and ``heartbeat`` configure
    the service's durability and watchdog; with ``restore`` the service
    comes back from ``checkpoint_dir``, restored streams are not
    registered again, and a wave is complete when each stream's version
    is its restored one plus the wave. ``test_probe(wave, stage, service)`` is a seam
    for a test harness that measures the waves (the CLI never sets it):
    it is called with stage "submit" before a wave's submits,
    "submitted" right after them and "folded" once every stream has
    swapped. ``shuffle`` (default the arch config's) is the config's SV
    merge transport; for ``hier`` the host count is
    :func:`repro_torch.launch.mesh.simulated_hier_hosts` of the
    partitions. On a process of ``cluster`` other than 0 the service is
    a read-only replica (``repro/launch/serve.py:99-105``): its streams
    are registered and readable, it reports stream 0's accuracy and runs
    no wave. ``fail_on_retrace`` arms the service's retrace guard around
    each fold (:mod:`repro_torch.analysis.retrace`). →
    :class:`StreamServeResult`.
    """
    from repro_torch.launch.mesh import simulated_hier_hosts
    from repro_torch.serving import StreamingSVMService

    if smoke:
        svm_cfg = dataclasses.replace(svm_cfg, num_features=128,
                                      sv_capacity=64,
                                      stream_rows_per_wave=256,
                                      dtype="float32")
    d, rows = svm_cfg.num_features, svm_cfg.stream_rows_per_wave
    L = partitions
    shuffle = shuffle or svm_cfg.shuffle_impl
    cfg = MRSVMConfig(sv_capacity=svm_cfg.sv_capacity, gamma=1e-4,
                      max_rounds=3, shuffle_impl=shuffle,
                      hier_num_hosts=(simulated_hier_hosts(L)
                                      if shuffle == "hier" else None),
                      svm=SVMConfig(C=svm_cfg.C,
                                    max_epochs=svm_cfg.max_epochs))
    dt = getattr(torch, svm_cfg.dtype)
    hardening = dict(checkpoint_every_waves=checkpoint_every,
                     checkpoint_keep=checkpoint_keep, quarantine=quarantine,
                     fold_deadline_s=fold_deadline, heartbeat_path=heartbeat,
                     cluster=cluster, device=device,
                     fail_on_retrace=fail_on_retrace)
    if restore:
        if not checkpoint_dir:
            raise SystemExit("--restore requires --checkpoint-dir")
        svc = StreamingSVMService.restore(cfg, checkpoint_dir, **hardening)
        L = svc.L
        print(f"svm-serve: restored {len(svc.streams())} streams from "
              f"{checkpoint_dir}")
    else:
        svc = StreamingSVMService(cfg, num_partitions=L,
                                  max_batches_per_wave=streams,
                                  checkpoint_dir=checkpoint_dir, **hardening)
    dev = svc.device

    def batch(stream: int, wave: int):
        return stream_batch(stream, wave, rows, d, dt, dev)

    print(f"svm-serve: {streams} streams × {rows} rows/wave, {d} features, "
          f"{L} partitions ({dev})")
    for s in range(streams):
        if f"stream{s}" in svc.streams():
            continue                   # came back with the checkpoint
        X0, y0 = batch(s, 0)
        svc.register(f"stream{s}", fit_mapreduce(X0, y0, L, cfg,
                                                 device=dev))
    if cluster is not None and not cluster.is_coordinator:
        # snapshots are served from every process; admission is not
        X0, y0 = batch(0, 0)
        print(f"process {cluster.process_index}: read-only replica "
              f"(stream0 snapshot v{svc.snapshot('stream0').version}, "
              f"acc={_accuracy(svc, 'stream0', X0, y0):.3f}); admission "
              "runs on process 0")
        return StreamServeResult(svc, cfg, [], [], [])
    # after a restore the versions resume from the checkpoint, so a
    # wave's completion counts from them
    base = {s: svc.snapshot(f"stream{s}").version for s in range(streams)}
    svc.start()
    stale_all, fresh_all, secs = [], [], []
    for wave in range(1, waves + 1):
        batches = [batch(s, wave) for s in range(streams)]
        stale = [_accuracy(svc, f"stream{s}", X, y)
                 for s, (X, y) in enumerate(batches)]
        if test_probe is not None:
            test_probe(wave, "submit", svc)
        t0 = time.perf_counter()
        for s, (X, y) in enumerate(batches):
            svc.submit(f"stream{s}", X, y)
        if test_probe is not None:
            test_probe(wave, "submitted", svc)
        deadline = t0 + 300
        while any(svc.snapshot(f"stream{s}").version < base[s] + wave
                  for s in range(streams)):
            if svc.scheduler_error is not None \
                    or time.perf_counter() > deadline:
                raise RuntimeError(
                    f"wave {wave} never folded") from svc.scheduler_error
            time.sleep(0.001)
        secs.append(time.perf_counter() - t0)
        if test_probe is not None:
            test_probe(wave, "folded", svc)
        fresh = [_accuracy(svc, f"stream{s}", X, y)
                 for s, (X, y) in enumerate(batches)]
        stale_all.append(stale)
        fresh_all.append(fresh)
        print(f"wave {wave}: stale acc={sum(stale) / len(stale):.3f} → "
              f"folded acc={sum(fresh) / len(fresh):.3f} "
              f"({secs[-1]:.2f}s)")
    svc.stop()
    print(svc.throughput_report())
    return StreamServeResult(svc, cfg, stale_all, fresh_all, secs)



def main(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--cache-len", type=int, default=256)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' runs the "
                         "plain versions of the kernels)")
    ap.add_argument("--data-par", type=int, default=1,
                    help="svm family: partitions (default 8); LM: the data "
                         "axis of the (data × model) mesh of ranks")
    ap.add_argument("--model-par", type=int, default=1,
                    help="LM: the model axis of the (data × model) mesh of "
                         "ranks (dense and VLM archs)")
    ap.add_argument("--streams", type=int, default=4,
                    help="svm family: tenant streams served")
    ap.add_argument("--shuffle", default=None, choices=SHUFFLE_IMPLS,
                    help="svm family: SV merge transport of the sharded "
                         "fold programs (default: the arch config's)")
    ap.add_argument("--waves", type=int, default=3,
                    help="svm family: update waves to run")
    ap.add_argument("--no-quarantine", action="store_true",
                    help="svm family: fold non-finite batches instead of "
                         "diverting them at submit()")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="svm family: durable per-stream snapshot "
                         "checkpoints")
    ap.add_argument("--checkpoint-every", type=int, default=1,
                    help="svm family: waves between checkpoints")
    ap.add_argument("--restore", action="store_true",
                    help="svm family: rebuild the service from the newest "
                         "intact generation in --checkpoint-dir instead of "
                         "retraining the stream models")
    ap.add_argument("--checkpoint-keep", type=int, default=3,
                    help="svm family: snapshot generations kept; restore "
                         "falls back past corrupt ones")
    ap.add_argument("--fold-deadline", type=float, default=None,
                    help="svm family: watchdog deadline (s) of a wave's "
                         "folds; a stalled fold exits the process with "
                         "code 17")
    ap.add_argument("--heartbeat", default=None,
                    help="svm family: path of the watchdog's JSON "
                         "heartbeat file")
    add_cluster_flags(ap)
    args = ap.parse_args(argv)
    # before anything else: a process joins its cluster first
    cluster = init_cluster(cluster_config_from_args(args))
    cfg = get_config(args.arch)
    if getattr(cfg, "family", None) == "svm":
        if args.model_par > 1:
            raise SystemExit("--model-par applies to the LM archs")
        return serve_svm(cfg, streams=args.streams, waves=args.waves,
                         smoke=args.smoke,
                         partitions=args.data_par if args.data_par > 1
                         else 8,
                         quarantine=not args.no_quarantine,
                         device=args.device,
                         checkpoint_dir=args.checkpoint_dir,
                         checkpoint_every=args.checkpoint_every,
                         checkpoint_keep=args.checkpoint_keep,
                         restore=args.restore,
                         fold_deadline=args.fold_deadline,
                         heartbeat=args.heartbeat, shuffle=args.shuffle,
                         cluster=cluster)
    if cluster.is_distributed:
        raise SystemExit(
            "multi-process launch currently covers the svm family")
    if args.smoke:
        cfg = smoke_variant(cfg)
    ranks = args.data_par * args.model_par
    if ranks > 1:
        if cfg.family not in ("dense", "vlm"):
            raise NotImplementedError(
                f"--data-par / --model-par above 1 for the {cfg.family} "
                "family is not ported to repro_torch yet (ROADMAP Queue 1 "
                "item 13g-c)")
        on = "cpu" if resolve_device(args.device).type == "cpu" else "cuda"
        res = compat.spawn(serve_rank, ranks,
                           (cfg, args.data_par, args.model_par, args.batch,
                            args.cache_len, args.tokens), device=on)[0]
        return res._replace(tokens=torch.from_numpy(res.tokens))
    res = serve_lm(cfg, batch=args.batch, cache_len=args.cache_len,
                   tokens=args.tokens, device=args.device)
    print(f"{cfg.name}: {args.tokens} tokens × {args.batch} seqs "
          f"in {res.seconds:.2f}s → {res.tok_per_s:,.1f} tok/s")
    return res


if __name__ == "__main__":
    main()
