"""Streaming polarization service: fold live message batches into
SV_global behind an async wave scheduler (the paper's §SONUÇ future
work), ported from ``repro/serving/svm_stream.py``.

The converged global SV set is the model's sufficient statistic: a
drifted month of messages is absorbed by retraining on (new batch ∪
carried SVs), so old non-support rows never travel.

  submit  : vectorized micro-batches queue per tenant *stream*; a batch
            with a NaN or Inf is quarantined here, and blocked-CSR
            batches have their column ids checked once
  admit   : the scheduler pops ≤ ``max_batches_per_wave`` batches per
            stream into one *wave*
  fold    : a lone admitted stream retrains through
            :func:`~repro_torch.core.mapreduce_svm.update_mapreduce`;
            several streams of one row format ride the sweep axis, S
            streams as S jobs of :func:`~repro_torch.core.sweep.
            fit_mapreduce_sweep` (per-job rows, labels, masks and
            stacked ``SolverParams``): one solve launch a round for all
            their partitions. The job axis is padded to a power of two
            with all-masked jobs.
  swap    : ``predict`` / ``decision_values`` serve from an immutable
            :class:`ModelSnapshot`; a fold's snapshot is published only
            after its work on the card has finished.

On the card every fold runs on the service's own CUDA stream, so a
``predict`` on the caller's stream does not queue behind it. The fold
stream waits for what a ``register`` or ``submit`` queued on the
caller's stream before it. Readers mark the snapshot's tensors as used
on their stream (``record_stream``), so the memory of a snapshot that a
swap drops is not handed to the next fold while their kernels still
read it.

A fold that dies mid-wave requeues the un-swapped streams' batches at
the HEAD of their queues; batches complete only after their snapshot
swap, so re-admission is exactly-once at the model level. Admission
control bounds the per-tenant queues (``max_queue_per_stream``,
``shed_policy``) and the wave's width (``max_streams_per_wave``), and
counts latency-SLO violations (``slo_s``).

Durability: with ``checkpoint_dir`` set, every tenant's snapshot is
saved through :mod:`repro_torch.ckpt` on ``register`` and after each
``checkpoint_every_waves``-th wave, one npz a stream a *generation*
(``gen000007_stream0.npz``) and a format-2 manifest keeping the last
``checkpoint_keep`` generations with per-leaf and file crc32s, in the
reference's file format: each package restores the other's.
:meth:`StreamingSVMService.restore` rebuilds a queues-empty service on
its device from the newest intact generation, falling back past corrupt
ones. A checkpoint reads snapshots only after their swap, so its
device-to-host copies (on the caller's stream) never wait for a fold
running on the service's stream.

Fault seams (:mod:`repro_torch.faults`): ``serving.submit`` poisons a
batch before the quarantine, ``serving.wave`` kills a wave before it
folds (its batches requeue), ``serving.stall`` stalls a fold past
``fold_deadline_s``, whose watchdog (heartbeat at ``heartbeat_path``)
raises ``FaultDetected("serving")`` or calls ``watchdog_handler``.

Not ported yet, and refused with ``NotImplementedError``: the retrace
guard (ROADMAP Queue 1 item 12), the multi-process ``cluster`` (item 10)
and the SV merge transport ``shuffle_impl`` of sharded mode (item 7).
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import threading
import time
import traceback
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch import faults
from repro_torch import sparse as sparse_rows
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.core.mapreduce_svm import (MapReduceSVM, MRSVMConfig,
                                            SVBuffer,
                                            decision_values as
                                            mr_decision_values,
                                            init_sv_buffer,
                                            predict as mr_predict,
                                            update_mapreduce)
from repro_torch.core.svm import BinarySVM, SolverParams
from repro_torch.core.sweep import fit_mapreduce_sweep, stack_params
from repro_torch.device import DeviceLike, as_tensor, resolve_device
from repro_torch.kernels import ops

_MANIFEST = "service_manifest.json"


def _not_ported(what: str, item: int) -> NotImplementedError:
    return NotImplementedError(
        f"{what} of the streaming service is not ported to repro_torch yet "
        f"(ROADMAP Queue 1 item {item})")


def _as_rows(x):
    """Numpy rows or labels as a CPU tensor (no copy); tensors and
    ``SparseRows`` as they are."""
    if isinstance(x, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(x))
    if isinstance(x, (torch.Tensor, sparse_rows.SparseRows)):
        return x
    return torch.as_tensor(x)


def _all_finite(X, y) -> bool:
    """Whether a micro-batch's features and labels are all finite: the
    quarantine gate at ``submit``. One NaN row folded into SV_global
    poisons the model for every later reader, so the check runs once a
    batch: on the host for host input, with one readback for a batch
    already on the card."""
    vals = X.values if sparse_rows.is_sparse(X) else X
    return bool((torch.isfinite(vals).all() & torch.isfinite(y).all()).item())


def _leaves(obj):
    """Tensor and array leaves of rows, NamedTuples and params."""
    if sparse_rows.is_sparse(obj):
        yield from (obj.indices, obj.values)
    elif isinstance(obj, (torch.Tensor, np.ndarray)):
        yield obj
    elif isinstance(obj, (tuple, list)):
        for o in obj:
            yield from _leaves(o)


def _f32(v) -> torch.Tensor:
    """A hyper-parameter (number, numpy or tensor) as a float32 tensor."""
    return torch.as_tensor(np.float32(v) if not isinstance(v, torch.Tensor)
                           else v, dtype=torch.float32)


def _snapshot_tree(snap: "ModelSnapshot") -> dict:
    """The checkpointable view of one stream's snapshot, as the
    reference's: ``rounds`` and ``version`` ride the manifest, and
    ``history`` restores empty."""
    m = snap.model
    tree = {"model": {"w": m.w, "b": m.b, "risk": _f32(m.risk),
                      "sv": dict(m.sv._asdict()),
                      "final": dict(m.final._asdict())}}
    if snap.params is not None:
        tree["params"] = {k: _f32(v) for k, v in snap.params._asdict().items()}
    return tree


def _abstract_snapshot_tree(cfg: MRSVMConfig, d: int,
                            nnz_cap: Optional[int], has_params: bool,
                            dtypes: Dict[str, str]) -> dict:
    """The ``like`` tree of :func:`_snapshot_tree` from the manifest's
    facts: shapes from (cfg, d, nnz_cap), leaf dtypes from the recorded
    :func:`repro_torch.ckpt.leaf_dtypes`; ``meta`` tensors, no memory."""
    cap = cfg.sv_capacity

    def zf(*shape):
        return torch.empty(shape, dtype=torch.float32, device="meta")

    sv = init_sv_buffer(cap, d, device="meta", nnz_cap=nnz_cap)
    final = BinarySVM(alpha=zf(cap), b=zf(), w=zf(d),
                      epochs_run=torch.empty((), dtype=torch.int32,
                                             device="meta"),
                      max_violation=zf())
    tree = {"model": {"w": zf(d), "b": zf(), "risk": zf(),
                      "sv": dict(sv._asdict()),
                      "final": dict(final._asdict())}}
    if has_params:
        tree["params"] = {k: zf() for k in SolverParams._fields}
    return ckpt.with_dtypes(tree, dtypes)


@dataclasses.dataclass
class MicroBatch:
    """One vectorized message micro-batch queued for a stream."""
    uid: int
    stream: str
    X: Optional[object]           # dropped (None) once the batch folds
    y: Optional[torch.Tensor]
    # per-slot accounting (stamped by the service, host clock):
    submitted_s: float = 0.0
    admitted_s: float = 0.0
    completed_s: float = 0.0
    wave: int = -1

    @property
    def queue_s(self) -> float:
        """Time spent waiting for admission."""
        return max(self.admitted_s - self.submitted_s, 0.0)

    @property
    def latency_s(self) -> float:
        """Submit → the batch's model swap (not the whole wave's wall)."""
        return max(self.completed_s - self.submitted_s, 0.0)


class ModelSnapshot(NamedTuple):
    """Immutable served state of one stream. A fold builds a new
    snapshot and the service swaps the reference; ``version`` rises by
    one a swap, so readers can tag results with the model that made
    them."""
    model: MapReduceSVM
    params: Optional[SolverParams]
    version: int


@dataclasses.dataclass
class StreamWaveStats:
    """One admission wave of the streaming service."""
    wave: int
    streams: int        # tenants folded this wave
    batches: int        # micro-batches admitted
    rows: int           # new message rows folded
    batched: bool       # True: a sweep fold of several tenants ran
    wall_s: float


class StreamingSVMService:
    """Multi-tenant streaming polarization service.

    The tenants share one :class:`MRSVMConfig` (shapes, kernel family,
    loop bounds); per-stream hyper-parameters ride the snapshot's
    :class:`SolverParams`, which is what lets S streams fold as one
    sweep. Runs on ``device`` (default ``cuda``; raises without a card);
    ``submit`` and the readers put numpy input there.
    """

    def __init__(self, cfg: MRSVMConfig, num_partitions: int = 8,
                 max_batches_per_wave: int = 4,
                 keep_history: bool = False,
                 shuffle_impl: Optional[str] = None,
                 cluster=None,
                 checkpoint_dir: Optional[str] = None,
                 checkpoint_every_waves: int = 1,
                 max_queue_per_stream: Optional[int] = None,
                 shed_policy: str = "drop_oldest",
                 max_streams_per_wave: Optional[int] = None,
                 slo_s: Optional[float] = None,
                 pad_wave_to_bucket: bool = True,
                 fail_on_retrace: bool = False,
                 checkpoint_keep: int = 3,
                 quarantine: bool = True,
                 fold_deadline_s: Optional[float] = None,
                 heartbeat_path: Optional[str] = None,
                 watchdog_handler=None,
                 device: DeviceLike = None):
        # ``checkpoint_dir`` turns on durable snapshots: on register and
        # after every ``checkpoint_every_waves``-th wave, the newest
        # ``checkpoint_keep`` generations kept. ``fold_deadline_s`` arms a
        # watchdog around each wave's folds (heartbeat file at
        # ``heartbeat_path``; ``watchdog_handler`` replaces the default
        # handler, which exits the process).
        # The reference's arguments that the port refuses, with the
        # ROADMAP Queue 1 item that brings them:
        for name, given, item in (
                ("fail_on_retrace", fail_on_retrace, 12),
                ("cluster", cluster is not None, 10),
                ("shuffle_impl", shuffle_impl is not None, 7)):
            if given:
                raise _not_ported(f"{name}=", item)
        if shed_policy not in ("drop_oldest", "reject"):
            raise ValueError(f"unknown shed_policy {shed_policy!r} "
                             "(expected 'drop_oldest' or 'reject')")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.L = num_partitions
        self.max_batches_per_wave = max_batches_per_wave
        self.keep_history = keep_history
        self.max_queue_per_stream = max_queue_per_stream
        self.shed_policy = shed_policy
        self.max_streams_per_wave = max_streams_per_wave
        self.slo_s = slo_s
        self.pad_wave_to_bucket = pad_wave_to_bucket
        self.quarantine = quarantine
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_every_waves = checkpoint_every_waves
        self.checkpoint_keep = checkpoint_keep
        self.fold_deadline_s = fold_deadline_s
        self.heartbeat_path = heartbeat_path
        self.watchdog_handler = watchdog_handler
        # folds run on a stream of their own, readers on theirs
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)
        self._fold_signatures: set = set()
        self.shed: List[MicroBatch] = []
        self.quarantined: List[MicroBatch] = []
        self._requeued = 0
        self._slo_violations = 0
        self.restore_fallbacks = 0
        self._retries = 0
        self._watchdog_fires = 0
        self._waves_since_ckpt = 0
        #: ms of the last checkpoint() by part (d2h, savez, fsync, crc32,
        #: manifest, total)
        self.last_checkpoint_ms: Dict[str, float] = {}
        self._stream_slot: Dict[str, int] = {}
        self._snapshots: Dict[str, ModelSnapshot] = {}
        self._queues: Dict[str, List[MicroBatch]] = {}
        self._history: Dict[str, Dict[int, ModelSnapshot]] = {}
        self._lock = threading.Lock()          # queues + snapshot refs
        self._cv = threading.Condition(self._lock)
        self._wave_lock = threading.Lock()     # serializes folds
        self._ckpt_lock = threading.Lock()     # serializes checkpoints
        self._uid = 0
        self._wave = 0
        # the generation counter resumes past an existing manifest, so a
        # checkpoint never reuses a file name a kept record references
        self._generation = 0
        self._gen_records: List[dict] = []
        if checkpoint_dir is not None:
            man = self._read_manifest(checkpoint_dir)
            if man is not None and man.get("format", 1) >= 2:
                self._generation = int(man.get("generation", -1)) + 1
                self._gen_records = list(man.get("generations", []))
        self.done: List[MicroBatch] = []
        self.stats: List[StreamWaveStats] = []
        self._thread: Optional[threading.Thread] = None
        self._stop_evt = threading.Event()
        self._scheduler_error: Optional[BaseException] = None

    # -- stream lifecycle --------------------------------------------------

    def register(self, stream: str, model: MapReduceSVM,
                 params: Optional[SolverParams] = None) -> ModelSnapshot:
        """Install a stream's initial model (its version-0 snapshot).

        ``params`` must be the :class:`SolverParams` the model was
        trained with (sweep-selected streams), else the config defaults
        are assumed: the contract of :func:`update_mapreduce`.
        """
        snap = ModelSnapshot(model=model, params=params, version=0)
        with self._lock:
            if stream in self._snapshots:
                raise ValueError(f"stream {stream!r} already registered")
            self._snapshots[stream] = snap
            self._queues[stream] = []
            self._stream_slot[stream] = len(self._stream_slot)
            if self.keep_history:
                self._history[stream] = {0: snap}
        self._fold_after_caller()
        if self.checkpoint_dir is not None:
            # a stream is durable from the moment it exists
            self.checkpoint()
        return snap

    @classmethod
    def restore(cls, cfg: MRSVMConfig, checkpoint_dir: str,
                **kwargs) -> "StreamingSVMService":
        """Rebuild a queues-empty service from the newest intact
        generation of the manifest (format 1 or 2, either package's).

        Every stream's snapshot comes back at its checkpointed version,
        on the service's device (``device=`` among ``kwargs``); the wave
        and uid counters resume from the manifest. A generation whose
        file or leaves fail their crc32s is skipped (counted in
        ``restore_fallbacks``); none intact raises
        ``FaultDetected("ckpt")``. Blocked-CSR SV rows read from a file
        have their column ids checked once. Queued batches are not
        durable: clients re-submit what they never saw complete.
        ``cfg`` must match the checkpointed ``sv_capacity``; the other
        ``kwargs`` go to the constructor (``num_partitions`` and
        ``max_batches_per_wave`` default to the manifest's).
        """
        path = os.path.join(checkpoint_dir, _MANIFEST)
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"no service manifest under {checkpoint_dir!r} — the "
                "service checkpoints on register and every "
                "checkpoint_every_waves-th wave")
        with open(path) as f:
            man = json.load(f)
        if man.get("sv_capacity") != cfg.sv_capacity:
            raise ValueError(
                f"checkpoint was taken at sv_capacity="
                f"{man.get('sv_capacity')} but cfg has {cfg.sv_capacity} "
                "— restore with the training-time config")
        kwargs.setdefault("num_partitions", man["num_partitions"])
        kwargs.setdefault("max_batches_per_wave",
                          man["max_batches_per_wave"])
        svc = cls(cfg, checkpoint_dir=checkpoint_dir, **kwargs)
        if man.get("format", 1) >= 2:
            gens = list(man.get("generations", []))
        else:                          # format 1: one implicit generation
            gens = [{"generation": 0, "wave": man["wave"],
                     "uid": man["uid"], "streams": man["streams"]}]
        errors: List[str] = []
        restored = None
        for rec in reversed(gens):
            try:
                restored = rec, {s: svc._load_stream(cfg, checkpoint_dir,
                                                     rec["streams"][s])
                                 for s in sorted(rec["streams"])}
                break
            except Exception as e:     # this generation is corrupt/missing
                errors.append(f"generation {rec.get('generation')}: {e}")
                faults.count("ckpt_fallbacks")
                svc.restore_fallbacks += 1
        if restored is None:
            raise faults.FaultDetected(
                "ckpt",
                f"no intact snapshot generation under {checkpoint_dir!r}"
                f" ({'; '.join(errors) or 'no generations recorded'})",
                action="restore from an older backup or re-register the "
                       "streams from their training pipelines")
        rec, loaded = restored
        if svc.restore_fallbacks:
            print(f"[svm_stream] newest snapshot generation(s) failed "
                  f"verification — restored generation "
                  f"{rec.get('generation')} instead "
                  f"({svc.restore_fallbacks} skipped)", flush=True)
        with svc._lock:
            for stream, (snap, slot) in loaded.items():
                svc._snapshots[stream] = snap
                svc._queues[stream] = []
                svc._stream_slot[stream] = slot
                if svc.keep_history:
                    svc._history[stream] = {snap.version: snap}
            svc._wave = rec["wave"]
            svc._uid = rec["uid"]
        return svc

    def _load_stream(self, cfg: MRSVMConfig, checkpoint_dir: str,
                     meta: dict) -> Tuple[ModelSnapshot, int]:
        """One stream's snapshot of a generation record, verified (file
        crc32, per-leaf crc32s, shapes and dtypes) and on the service's
        device; → (snapshot, slot)."""
        fpath = os.path.join(checkpoint_dir, meta["file"])
        want = meta.get("file_crc32")
        if want is not None and ckpt.file_crc32(fpath) != want:
            raise ckpt.CorruptCheckpointError(
                f"{meta['file']}: medium does not match its recorded crc32")
        like = _abstract_snapshot_tree(cfg, meta["d"], meta["nnz_cap"],
                                       meta["has_params"], meta["dtypes"])
        tree = ckpt.restore(fpath, like, checksums=meta.get("checksums"))
        dev = self.device
        m = tree["model"]
        x = as_tensor(m["sv"]["x"], dev)
        if sparse_rows.is_sparse(x):
            ops.check_column_ids(x)    # rows from a file: checked, once
        sv = SVBuffer(**{k: x if k == "x" else as_tensor(v, dev)
                         for k, v in m["sv"].items()})
        model = MapReduceSVM(
            w=as_tensor(m["w"], dev), b=as_tensor(m["b"], dev), sv=sv,
            final=BinarySVM(**{k: as_tensor(v, dev)
                               for k, v in m["final"].items()}),
            risk=m["risk"], rounds=meta["rounds"], history=())
        # params stay host numbers, as a live service's are
        params = (SolverParams(**{k: float(v)
                                  for k, v in tree["params"].items()})
                  if meta["has_params"] else None)
        self._fold_after_caller()
        return (ModelSnapshot(model=model, params=params,
                              version=meta["version"]), meta["slot"])

    @staticmethod
    def _read_manifest(checkpoint_dir: str) -> Optional[dict]:
        try:
            with open(os.path.join(checkpoint_dir, _MANIFEST)) as f:
                return json.load(f)
        except (OSError, json.JSONDecodeError, ValueError):
            return None

    def checkpoint(self) -> str:
        """Durably snapshot every stream and the service counters;
        returns the manifest path.

        Under ``checkpoint_dir``: one npz a stream a generation
        (``gen000007_stream0.npz``, :func:`repro_torch.ckpt.save`: tmp →
        fsync → rename) and an atomically replaced JSON manifest (format
        2) of the last ``checkpoint_keep`` generations with each stream's
        per-leaf and file crc32s, so :meth:`restore` verifies each
        payload and falls back past a corrupt newest generation. A crash
        at any point leaves the previous complete checkpoint installed;
        media of dropped generations are removed. Snapshots are read
        after their swap: their device-to-host copies run on the
        caller's stream and wait for no fold. ``last_checkpoint_ms``
        holds the time by part.
        """
        if self.checkpoint_dir is None:
            raise RuntimeError("service was built without checkpoint_dir")
        os.makedirs(self.checkpoint_dir, exist_ok=True)
        with self._ckpt_lock:
            t_all = time.perf_counter()
            ms = {"d2h": 0.0, "savez": 0.0, "fsync": 0.0, "crc32": 0.0}
            gen = self._generation
            self._generation += 1
            with self._lock:
                snaps = dict(self._snapshots)
                slots = dict(self._stream_slot)
                wave, uid = self._wave, self._uid
            streams_meta = {}
            for stream, snap in snaps.items():
                fname = f"gen{gen:06d}_stream{slots[stream]}.npz"
                t0 = time.perf_counter()
                tree = ckpt.to_host(_snapshot_tree(snap))
                ms["d2h"] += 1e3 * (time.perf_counter() - t0)
                crc = ckpt.save(
                    os.path.join(self.checkpoint_dir, fname), tree,
                    on_retry=self._note_retry, timings=ms)
                t0 = time.perf_counter()
                sums = ckpt.leaf_checksums(tree)
                ms["crc32"] += 1e3 * (time.perf_counter() - t0)
                x = snap.model.sv.x
                sp = sparse_rows.is_sparse(x)
                streams_meta[stream] = {
                    "file": fname, "slot": slots[stream],
                    "version": snap.version,
                    "rounds": int(snap.model.rounds),
                    "d": int(x.shape[1]),
                    "nnz_cap": int(x.nnz_cap) if sp else None,
                    "has_params": snap.params is not None,
                    "dtypes": ckpt.leaf_dtypes(tree),
                    "checksums": sums,
                    "file_crc32": crc,
                }
            rec = {"generation": gen, "wave": wave, "uid": uid,
                   "streams": streams_meta}
            records = [r for r in self._gen_records
                       if r.get("generation") != gen] + [rec]
            keep = max(int(self.checkpoint_keep), 1)
            dropped, records = records[:-keep], records[-keep:]
            self._gen_records = records
            t0 = time.perf_counter()
            # the top-level wave/uid/streams mirror the newest generation,
            # so format-1 readers keep working
            ckpt.atomic_write_json(
                os.path.join(self.checkpoint_dir, _MANIFEST),
                {"format": 2, "wave": wave, "uid": uid,
                 "sv_capacity": self.cfg.sv_capacity,
                 "num_partitions": self.L,
                 "max_batches_per_wave": self.max_batches_per_wave,
                 "generation": gen, "generations": records,
                 "streams": streams_meta},
                on_retry=self._note_retry)
            kept = {m["file"] for r in records
                    for m in r["streams"].values()}
            for r in dropped:
                for m in r["streams"].values():
                    if m["file"] not in kept:
                        try:
                            os.remove(os.path.join(self.checkpoint_dir,
                                                   m["file"]))
                        except OSError:
                            pass
            ms["manifest"] = 1e3 * (time.perf_counter() - t0)
            ms["total"] = 1e3 * (time.perf_counter() - t_all)
            self.last_checkpoint_ms = ms
            self._waves_since_ckpt = 0
            return os.path.join(self.checkpoint_dir, _MANIFEST)

    def _note_retry(self, attempt: int, exc: BaseException) -> None:
        self._retries += 1

    def streams(self) -> List[str]:
        with self._lock:
            return list(self._snapshots)

    def snapshot(self, stream: str) -> ModelSnapshot:
        """The stream's current served snapshot (atomic reference read)."""
        with self._lock:
            return self._snapshots[stream]

    def history(self, stream: str) -> Dict[int, ModelSnapshot]:
        """version → snapshot (only populated with ``keep_history``)."""
        with self._lock:
            return dict(self._history.get(stream, {}))

    # -- ingest ------------------------------------------------------------

    def _fold_after_caller(self) -> None:
        """Make the fold stream wait for the work the caller queued on
        its own stream so far (copies of a batch, a model's last
        kernels)."""
        if self._stream is not None:
            self._stream.wait_stream(torch.cuda.current_stream(self.device))

    def submit(self, stream: str, X, y) -> int:
        """Queue one vectorized micro-batch; returns its uid. ``X`` is
        dense ``(n, d)`` or blocked-CSR :class:`repro_torch.sparse.
        SparseRows`, whichever format the stream's model serves; numpy
        input goes to the service's device. A dead scheduler raises:
        enqueueing behind one grows queues that can never fold while
        readers pin the stale snapshot."""
        if self._scheduler_error is not None:
            raise RuntimeError(
                "streaming scheduler died — restart the service before "
                "submitting more work") from self._scheduler_error
        X, y = _as_rows(X), _as_rows(y)
        # featurizer seam: an armed poison_rows fault lands a NaN or Inf
        # in the batch where a buggy upstream vectorizer would
        spec = faults.fire("serving.submit", kinds=("poison_rows",))
        if spec is not None:
            X, y = faults.poison_batch(X, y, spec)
        if X.ndim != 2 or y.dim() != 1 or y.shape[0] != X.shape[0]:
            raise ValueError(f"micro-batch must be (n, d) rows with (n,) "
                             f"labels; got X{tuple(X.shape)} "
                             f"y{tuple(y.shape)}")
        with self._lock:
            if stream not in self._snapshots:
                raise KeyError(f"unregistered stream {stream!r}")
            sv_x = self._snapshots[stream].model.sv.x
        d_model = sv_x.shape[1]
        if X.shape[1] != d_model:
            raise ValueError(
                f"stream {stream!r} serves {d_model}-dim features but the "
                f"batch has {X.shape[1]} — vectorize with the same "
                "featurizer as training")
        sp_model = sparse_rows.is_sparse(sv_x)
        sp_batch = sparse_rows.is_sparse(X)
        if sp_model != sp_batch:
            raise ValueError(
                f"stream {stream!r} serves "
                f"{'sparse' if sp_model else 'dense'} rows but the batch is "
                f"{'sparse' if sp_batch else 'dense'} — submit the model's "
                "row format")
        if sp_batch and X.nnz_cap != sv_x.nnz_cap:
            raise ValueError(
                f"stream {stream!r} serves nnz_cap={sv_x.nnz_cap} rows but "
                f"the batch has nnz_cap={X.nnz_cap} — re-block with the "
                "model's cap")
        finite = not self.quarantine or _all_finite(X, y)
        if finite:
            if sp_batch:
                ops.check_column_ids(X)     # once a batch, where it lies
            X, y = as_tensor(X, self.device), as_tensor(y, self.device)
            self._fold_after_caller()
        with self._cv:
            if not finite:
                # NaN/Inf never reaches a fold: the batch is
                # acknowledged (uid) but diverted, and counted.
                faults.count("quarantined")
                self._uid += 1
                mb = MicroBatch(uid=self._uid, stream=stream, X=None,
                                y=None, submitted_s=time.perf_counter())
                self.quarantined.append(mb)
                return mb.uid
            q = self._queues[stream]
            if (self.max_queue_per_stream is not None
                    and len(q) >= self.max_queue_per_stream):
                if self.shed_policy == "reject":
                    raise RuntimeError(
                        f"stream {stream!r} queue is at its cap "
                        f"({self.max_queue_per_stream}) — admission control "
                        "rejected the batch (shed_policy='reject')")
                # drop_oldest: under drift the stalest batch is worth least
                old = q.pop(0)
                old.X = old.y = None
                self.shed.append(old)
            self._uid += 1
            mb = MicroBatch(uid=self._uid, stream=stream, X=X, y=y,
                            submitted_s=time.perf_counter())
            q.append(mb)
            self._cv.notify_all()
            return mb.uid

    def pending(self) -> int:
        with self._lock:
            return sum(len(q) for q in self._queues.values())

    # -- serve -------------------------------------------------------------

    def _read(self, snap: ModelSnapshot, fn, X):
        """``fn`` of one snapshot on the caller's stream; the snapshot's
        tensors are marked as used there, so a swap that drops the
        snapshot cannot hand their memory to a fold while this read
        still runs."""
        out = fn(snap.model, as_tensor(X, self.device), self.cfg,
                 params=snap.params)
        if self._stream is not None:
            reader = torch.cuda.current_stream(self.device)
            for t in _leaves(snap):
                if isinstance(t, torch.Tensor) and t.is_cuda:
                    t.record_stream(reader)
        return out

    def decision_values(self, stream: str, X) -> torch.Tensor:
        """Scores from the stream's current snapshot, read once, so a
        swap mid-call cannot give a half-updated model."""
        return self._read(self.snapshot(stream), mr_decision_values, X)

    def predict(self, stream: str, X, with_version: bool = False):
        """±1 polarization labels from the current snapshot."""
        snap = self.snapshot(stream)
        pred = self._read(snap, mr_predict, X)
        return (pred, snap.version) if with_version else pred

    # -- wave admission + fold --------------------------------------------

    def _admit(self) -> Dict[str, Tuple[ModelSnapshot, List[MicroBatch]]]:
        """Pop ≤ max_batches_per_wave batches per stream, pairing each
        admitted stream with the snapshot whose SVs the fold carries.
        With ``max_streams_per_wave`` the streams whose head batch has
        waited longest go first, so a narrow fold never starves a
        tenant."""
        now = time.perf_counter()
        admitted: Dict[str, Tuple[ModelSnapshot, List[MicroBatch]]] = {}
        with self._lock:
            ready = sorted((q[0].submitted_s, stream)
                           for stream, q in self._queues.items() if q)
            if self.max_streams_per_wave is not None:
                ready = ready[:self.max_streams_per_wave]
            for _, stream in ready:
                q = self._queues[stream]
                take, self._queues[stream] = (q[:self.max_batches_per_wave],
                                              q[self.max_batches_per_wave:])
                for mb in take:
                    mb.admitted_s = now
                    mb.wave = self._wave
                admitted[stream] = (self._snapshots[stream], take)
        return admitted

    def _swap(self, stream: str, model: MapReduceSVM,
              params: Optional[SolverParams]) -> ModelSnapshot:
        """Publish a new snapshot once the fold's work has finished."""
        if self._stream is not None:
            self._stream.synchronize()
        with self._lock:
            old = self._snapshots[stream]
            snap = ModelSnapshot(model=model, params=params,
                                 version=old.version + 1)
            self._snapshots[stream] = snap
            if self.keep_history:
                self._history[stream][snap.version] = snap
        return snap

    def _on_fold_stream(self):
        return (torch.cuda.stream(self._stream) if self._stream is not None
                else contextlib.nullcontext())

    def run_wave(self) -> Optional[StreamWaveStats]:
        """Admit one wave and fold it. Returns its stats, or ``None``
        when every queue was empty. Thread-safe; folds are serialized."""
        with self._wave_lock:
            t0 = time.perf_counter()
            admitted = self._admit()
            if not admitted:
                return None
            wave_id = self._wave
            self._wave += 1

            names = sorted(admitted)
            joined = {}
            swapped: List[str] = []
            any_batched = False
            with self._on_fold_stream():
                for s in names:
                    snap, batches = admitted[s]
                    Xn = sparse_rows.rows_concat_all(
                        [mb.X for mb in batches], axis=0)
                    yn = torch.cat([mb.y.to(Xn.dtype) for mb in batches])
                    joined[s] = (snap, batches, Xn, yn)
                try:
                    # scheduler seam: an armed scheduler_kill dies here,
                    # before any launch, and the wave's batches requeue
                    faults.maybe_raise("serving.wave",
                                       kinds=("scheduler_kill",),
                                       when=wave_id)
                    with self._watchdog(wave_id) as wd:
                        # stall seam: a fold that stops making progress,
                        # past the deadline, so the watchdog ends it
                        if faults.fire("serving.stall", ("stall",),
                                       when=wave_id) is not None:
                            time.sleep((self.fold_deadline_s or 0.5) * 1.5)
                        for group in self._fold_groups(names, joined):
                            if len(group) == 1:
                                # a lone tenant: the plain incremental update
                                s = group[0]
                                snap, _, Xn, yn = joined[s]
                                self._fold_signatures.add(
                                    self._fold_signature(
                                        "single", Xn, yn, snap.model.sv))
                                model = update_mapreduce(
                                    snap.model, Xn, yn, self.L, self.cfg,
                                    params=snap.params)
                                self._swap(s, model, snap.params)
                                swapped.append(s)
                            else:
                                any_batched = True
                                self._fold_batched(joined, group, swapped)
                            if wd is not None:
                                wd.beat()
                    if wd is not None:
                        wd.check()
                except BaseException:
                    self._recover_wave(joined, names, swapped)
                    raise

            now = time.perf_counter()
            n_batches = n_rows = 0
            for s in names:
                _, batches, Xn, _ = joined[s]
                n_batches += len(batches)
                n_rows += int(Xn.shape[0])
                for mb in batches:
                    mb.completed_s = now
                    if self.slo_s is not None and mb.latency_s > self.slo_s:
                        self._slo_violations += 1
                    # folded rows live on in SV_global or were dropped as
                    # non-support; only the accounting fields stay
                    mb.X = mb.y = None
                    self.done.append(mb)
            st = StreamWaveStats(wave=wave_id, streams=len(names),
                                 batches=n_batches, rows=n_rows,
                                 batched=any_batched, wall_s=now - t0)
            self.stats.append(st)
            if (self.checkpoint_dir is not None
                    and self.checkpoint_every_waves > 0):
                self._waves_since_ckpt += 1
                if self._waves_since_ckpt >= self.checkpoint_every_waves:
                    self.checkpoint()
            return st

    def _watchdog(self, wave_id: int):
        """The deadline around a wave's folds (``fold_deadline_s``), or
        no watchdog."""
        if self.fold_deadline_s is None:
            return contextlib.nullcontext()
        return faults.CollectiveWatchdog(
            self.fold_deadline_s, heartbeat_path=self.heartbeat_path,
            layer="serving", cause=f"wave {wave_id} fold",
            action="kill the process and restore the service from its "
                   "last checkpoint generation",
            on_timeout=self._on_watchdog_timeout)

    def _on_watchdog_timeout(self, info: dict) -> None:
        self._watchdog_fires += 1
        handler = self.watchdog_handler
        if handler is not None:
            handler(info)
        else:
            faults.exit_handler(info)

    @staticmethod
    def _fold_signature(kind: str, *trees) -> tuple:
        """A fold's shapes: every folded leaf's (shape, dtype) and the
        kind; ``fold_programs`` counts the distinct ones."""
        return (kind,) + tuple((tuple(a.shape), str(a.dtype))
                               for a in _leaves(trees))

    def _fold_groups(self, names, joined) -> List[List[str]]:
        """Partition admitted streams into stackable fold groups: jobs
        of one sweep must agree on (format, d, nnz_cap), so a mixed
        wave folds as one sweep a group."""
        groups: Dict[tuple, List[str]] = {}
        for s in names:
            x = joined[s][0].model.sv.x
            sp = sparse_rows.is_sparse(x)
            key = (sp, int(x.shape[1]), int(x.nnz_cap) if sp else -1)
            groups.setdefault(key, []).append(s)
        return [groups[k] for k in sorted(groups)]

    def _bucket_width(self, n: int) -> int:
        """Job-axis width a fold runs at: the next power of two, so
        waves of any tenant count share a few shapes."""
        if not self.pad_wave_to_bucket or n <= 1:
            return n
        width = 1
        while width < n:
            width *= 2
        return width

    def _recover_wave(self, joined, names, swapped) -> None:
        """Mid-wave failure: exactly-once at the model level. Streams
        whose snapshot already swapped complete; every other admitted
        batch goes back to the HEAD of its queue with its rows (X and y
        drop only on completion), for the next wave to fold once."""
        now = time.perf_counter()
        done_set = set(swapped)
        with self._lock:
            for s in names:
                _, batches, _, _ = joined[s]
                if s in done_set:
                    for mb in batches:
                        mb.completed_s = now
                        mb.X = mb.y = None
                        self.done.append(mb)
                else:
                    self._queues[s][:0] = batches
                    self._requeued += len(batches)

    def _fold_batched(self, joined, names, swapped) -> None:
        """S admitted streams as S jobs on the sweep axis: job s holds
        rows ``[new rows; carried SVs]`` zero-padded to the longest job,
        labels and a mask (1 on new rows, the SV mask on carried ones, 0
        on padding), and its stream's params; the job axis is padded to
        the bucket width with all-masked jobs, whose results are
        dropped. With equal new-row counts a job's inputs are exactly
        those :func:`update_mapreduce` builds for its stream. Each stream
        joins ``swapped`` the moment its snapshot publishes."""
        cap = self.cfg.sv_capacity
        n_new = [int(joined[s][2].shape[0]) for s in names]
        n_max = max(n_new) + cap
        width = self._bucket_width(len(names))
        dt = joined[names[0]][3].dtype
        yb = torch.zeros((width, n_max), dtype=dt, device=self.device)
        mb_ = torch.zeros((width, n_max), dtype=dt, device=self.device)
        jobs, ps = [], []
        for i, s in enumerate(names):
            snap, _, Xn, yn = joined[s]
            sv = snap.model.sv
            n = n_new[i]
            jobs.append([Xn, sv.x])
            yb[i, :n] = yn
            yb[i, n:n + cap] = sv.y
            mb_[i, :n] = 1
            mb_[i, n:n + cap] = sv.mask
            ps.append(snap.params if snap.params is not None
                      else self.cfg.svm.params())
        jobs += [[]] * (width - len(names))
        ps += [ps[0]] * (width - len(names))
        Xb = sparse_rows.rows_stack(jobs, n_max)          # (S', n_max, d)
        params_b = stack_params(ps)

        self._fold_signatures.add(self._fold_signature(
            "batched", Xb, yb, mb_, params_b))
        res = fit_mapreduce_sweep(Xb, yb, self.L, self.cfg, params_b,
                                  mask=mb_, device=self.device)
        del Xb
        for i, s in enumerate(names):                    # padding dropped
            snap = joined[s][0]
            pick = lambda a: a[i].clone()                # noqa: E731
            sv = SVBuffer(*(
                sparse_rows.SparseRows(pick(f.indices), pick(f.values), f.d,
                                       f.ids_in_range)
                if sparse_rows.is_sparse(f) else pick(f) for f in res.sv))
            history = tuple(
                {"round": h["round"], "risk": float(h["risks"][i]),
                 "reducer": int(h["reducers"][i]), "ms": h["ms"]}
                for h in res.history if h["reducers"][i] >= 0)
            model = MapReduceSVM(
                w=pick(res.ws), b=pick(res.bs), sv=sv,
                final=BinarySVM(*(pick(f) for f in res.final)),
                risk=res.risks[i].clone(), rounds=int(res.rounds[i]),
                history=history)
            self._swap(s, model, snap.params)
            swapped.append(s)

    def drain(self) -> int:
        """Run waves until every queue is empty; returns waves run."""
        waves = 0
        while self.run_wave() is not None:
            waves += 1
        return waves

    # -- async scheduler ---------------------------------------------------

    def start(self, idle_poll_s: float = 0.05) -> None:
        """Start the background wave scheduler: batches submitted after
        this fold in continuously without blocking the submitter."""
        with self._lock:
            if self._thread is not None:
                return
            self._stop_evt.clear()
            self._scheduler_error = None
            self._thread = threading.Thread(
                target=self._scheduler_loop, args=(idle_poll_s,),
                name="svm-stream-scheduler", daemon=True)
            self._thread.start()

    @property
    def scheduler_error(self) -> Optional[BaseException]:
        """The exception that killed the background scheduler, if any."""
        return self._scheduler_error

    def _scheduler_loop(self, idle_poll_s: float) -> None:
        while not self._stop_evt.is_set():
            with self._cv:
                while (not self._stop_evt.is_set()
                       and not any(self._queues.values())):
                    self._cv.wait(timeout=idle_poll_s)
                if self._stop_evt.is_set():
                    return
            try:
                self.run_wave()
            except BaseException as e:
                # a silently dead thread would leave queues growing and
                # readers on the stale snapshot: record the error
                # (submit, wait_idle and stop raise it) and stop loudly
                self._scheduler_error = e
                self._stop_evt.set()
                traceback.print_exc()
                return

    def wait_idle(self, timeout_s: float = 120.0,
                  poll_s: float = 0.01) -> bool:
        """Block until every queue is empty and no wave is in flight.

        A doomed wait raises at once: a recorded scheduler error, a
        scheduler thread that died without one, or queued work with no
        scheduler running. Returns ``False`` only on a real timeout."""
        deadline = time.perf_counter() + timeout_s
        while True:
            if self._scheduler_error is not None:
                raise RuntimeError(
                    "streaming scheduler died") from self._scheduler_error
            thread = self._thread
            if (thread is not None and not thread.is_alive()
                    and not self._stop_evt.is_set()):
                raise RuntimeError(
                    "scheduler thread died without recording an error — "
                    "restart the service")
            if thread is None and self.pending() > 0:
                raise RuntimeError(
                    "no scheduler is running but work is queued — call "
                    "start() (or drain() synchronously) first")
            if self.pending() == 0 and not self._wave_lock.locked():
                return True
            if time.perf_counter() >= deadline:
                return False
            time.sleep(poll_s)

    def stop(self, drain: bool = True, timeout_s: float = 60.0) -> None:
        """Stop the scheduler thread; optionally fold what is queued.
        Re-raises the error that killed the scheduler, if any; a thread
        that does not end within ``timeout_s`` (stranded in a fold)
        raises ``FaultDetected("serving")``."""
        thread = self._thread
        if thread is None:
            return
        self._stop_evt.set()
        with self._cv:
            self._cv.notify_all()
        thread.join(timeout=timeout_s)
        if thread.is_alive():
            raise faults.FaultDetected(
                "serving",
                f"scheduler thread refused to die within {timeout_s:.0f}s"
                " (likely stranded in a fold)",
                action="kill the process and restart from the last "
                       "checkpoint generation")
        self._thread = None
        if self._scheduler_error is not None:
            raise RuntimeError(
                "streaming scheduler died") from self._scheduler_error
        if drain:
            self.drain()

    # -- reporting ---------------------------------------------------------

    def throughput_report(self) -> Dict[str, float]:
        """The reference's keys. ``retraces`` counts a guard that is not
        ported (ROADMAP Queue 1 item 12) and stays 0."""
        lats = [mb.latency_s for mb in self.done]
        queues = [mb.queue_s for mb in self.done]
        rows = sum(s.rows for s in self.stats)
        wall = sum(s.wall_s for s in self.stats)
        return {
            "batches": len(self.done),
            "rows": rows,
            "waves": len(self.stats),
            "wall_s": round(wall, 3),
            "rows_per_s": round(rows / max(wall, 1e-9), 1),
            "mean_latency_s": round(float(np.mean(lats)), 4) if lats else 0.0,
            "p95_latency_s": (round(float(np.percentile(lats, 95)), 4)
                              if lats else 0.0),
            "mean_queue_s": (round(float(np.mean(queues)), 4)
                             if queues else 0.0),
            "shed": len(self.shed),
            "requeued": self._requeued,
            "slo_violations": self._slo_violations,
            "fold_programs": len(self._fold_signatures),
            "retraces": 0,
            "quarantined": len(self.quarantined),
            "retries": self._retries,
            "watchdog_fires": self._watchdog_fires,
        }
