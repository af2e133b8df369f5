"""Multi-pod dry run, ported from ``repro/launch/dryrun.py``: is a
distribution config coherent at 256 and 512 ranks, and what does one
rank of it hold, move and compute?

The reference lowers and compiles the step for 256 (512) fake host
devices and reads XLA's memory and cost analyses and its HLO. The port
has no compiler to ask. :func:`run_one` opens a ``fake`` process group
of the mesh's size in this one process (``torch.distributed``'s fake
backend: collectives return at once and move nothing), lays the
production mesh (``launch.mesh.make_production_mesh``'s 16 × 16, or
2 × 16 × 16 with ``multi_pod``) over it with ``compat.rank_mesh``, and
builds rank 0's step on it (``launch.steps``). Then:

* **Lower** (any device): rank 0's step runs shape-only on the CPU
  under ``FakeTensorMode``, its inputs its shards as fake tensors, with
  ``compat.record_collectives``, ``FlopCounterMode``, the kernels'
  shape rules (``kernels.ops.record_kernel_work``) and a tracker of the
  live bytes of every tensor it makes (:class:`PeakBytes`).
* **Compile** (on the card only): rank 0's step runs once for real on
  its shards (inputs from a seeded ``torch.Generator``; what the other
  ranks would send is whatever the fake group leaves in the receive
  buffers), then once more timed, with the card's peak memory above
  what it held before the inputs were made.

A rank whose reckoned peak does not fit one card records
``status: "error"`` stating its bytes. Entries still open record the
``NotImplementedError`` that names their item: the MoE, SSM, hybrid and
encoder-decoder families under a mesh (ROADMAP Queue 1 item 13g-c); the
dense and VLM train, prefill and decode steps run.

The record (``_write``, the reference's artifact names) keeps the
reference's keys where their meaning carries over: ``arch``, ``shape``,
``mesh``, ``chips``, ``rules``, ``status``, ``reason``, ``error``,
``traceback``, ``processes``, ``topology``, ``per_host_args``,
``shuffle``, ``row_format``, ``nnz_cap``, ``flops_global``,
``hbm_bytes_global`` (the svm steps: rank 0's × chips, as the
reference's XLA numbers × chips; the LM steps: ``launch.costs``),
``collective_bytes_per_device``, ``collective_wire_bytes_per_device``,
``collectives`` (the reference's kinds, ``launch.hlo_analysis``),
``roofline``, ``collective_s_wire``, ``dominant``,
``argument_size_in_bytes`` (rank 0's shards), ``probes``,
``model_flops_analytic`` and ``useful_flops_ratio``. The reference's
``probe_error`` has no counterpart: a probe that fails fails the
record.
New keys where it does not:

* ``lower_s`` → ``trace_s``: seconds of the shape-only run;
* ``xla_per_device_flops`` / ``_bytes`` → ``per_rank_flops`` /
  ``per_rank_bytes``: ``FlopCounterMode``'s FLOPs and every op's
  input and output bytes (views and factories aside) of rank 0's
  step, plus its kernels' work by their shape rules (a solve's at its
  epoch cutoff); ``kernels``: that work by kernel;
* ``temp_size_in_bytes`` → ``temp_peak_bytes``: the most bytes the
  step held at once above its arguments (outputs included), and
  ``peak_bytes``: that plus the arguments, the rank's reckoned peak;
  ``collective_count``: the collectives rank 0 issued, waits aside,
  and ``schedule_digest`` (:func:`schedule_digest`): their ordered
  signatures, which ``analysis.lint --artifacts`` holds a fresh run to;
* ``compile_s`` and ``memory_analysis`` → ``card``: on the card,
  ``first_ms`` and ``step_ms`` (the first and the second run, host
  clock to a synchronize), ``peak_bytes`` (``max_memory_allocated``
  above the baseline, the second run) and ``peak_ratio`` (the card's
  peak over ``peak_bytes``).

Usage:
    python -m repro_torch.launch.dryrun --arch llama3-8b --shape decode_32k --device cpu
    python -m repro_torch.launch.dryrun --arch svm-tfidf --shape svm_sweep --shuffle ring
    python -m repro_torch.launch.dryrun --all --device cpu   # every pair
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import sys
import time
import traceback
import weakref

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import sparse as sparse_rows
from repro_torch.analysis.base import tensor_leaves

#: where artifacts go unless ``--out`` names another directory
DEFAULT_OUT = "dryrun_out"
SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k", "svm",
          "svm_sweep", "svm_serve")
#: the sweep's configs and the serve wave's streams, as the reference's
SWEEP_CONFIGS = 8
SERVE_STREAMS = 4
#: one card's memory (H100 SXM5 data sheet: 80 GB) for the fit check of
#: a shape-only run on the CPU; on the card its own total
CARD_BYTES = 80e9


# ---------------------------------------------------------------------------
# Trees of tensors
# ---------------------------------------------------------------------------

def tree_map_tensors(fn, tree):
    """``fn`` over every tensor of a tree, keeping its structure."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if sparse_rows.is_sparse(tree):
        return sparse_rows.SparseRows(fn(tree.indices), fn(tree.values),
                                      tree.d)
    if isinstance(tree, dict):
        return {k: tree_map_tensors(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map_tensors(fn, v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map_tensors(fn, v) for v in tree)
    return tree


def fake_like(tree):
    """A tree of ``meta`` tensors as empty tensors of the same shapes and
    dtypes on the CPU: fake ones under an active ``FakeTensorMode``."""
    return tree_map_tensors(
        lambda t: torch.empty(tuple(t.shape), dtype=t.dtype), tree)


def arg_bytes(tree) -> int:
    """The bytes of a tree's tensors, each storage once."""
    storages = {id(t.untyped_storage()): t.untyped_storage()
                for t in tensor_leaves(tree)}
    return sum(st.nbytes() for st in storages.values())


class PeakBytes(TorchDispatchMode):
    """The live bytes of the tensors a region makes, and their most at
    once (``peak``): each storage an op returns counted once, when it
    first appears, and dropped when it dies; a storage an op's inputs
    already hold is not new (views, in-place and ``out=`` ops, and
    ``_unsafe_view``, whose schema does not say it aliases). And
    ``op_bytes``: the input and output bytes of every op that is not a
    view, a factory or a collective (the bytes it reads and writes).
    Works on fake tensors."""

    _SKIP = ("c10d", "_c10d_functional")

    def __init__(self):
        super().__init__()
        from torch.utils.weak import WeakIdKeyDictionary
        self._live = WeakIdKeyDictionary()
        self.current = self.peak = 0
        self.op_bytes = 0

    def _free(self, n: int) -> None:
        self.current -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        ins = tensor_leaves(list(args) + list((kwargs or {}).values()))
        held = {id(t.untyped_storage()) for t in ins}
        outs = tensor_leaves(out)
        shares = False
        for t in outs:
            st = t.untyped_storage()
            if id(st) in held:
                shares = True
            elif st not in self._live:
                n = self._live[st] = st.nbytes()
                self.current += n
                self.peak = max(self.peak, self.current)
                weakref.finalize(st, self._free, n)
        writes = any(r.alias_info is not None and r.alias_info.is_write
                     for r in func._schema.returns)
        if ins and not (shares and not writes) \
                and func.namespace not in self._SKIP:
            self.op_bytes += sum(t.numel() * t.element_size()
                                 for t in ins + outs)
        return out


# ---------------------------------------------------------------------------
# The fake group
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def fake_group(world_size: int, rank: int = 0):
    """A ``fake`` default process group of ``world_size`` ranks in which
    this process is ``rank``; destroyed on the way out. Refuses to start
    when a process group is already up: the dry run owns the process."""
    if dist.is_initialized():
        raise RuntimeError(
            "a process group is already up in this process; the dry run "
            f"opens a fake group of {world_size} ranks of its own and must "
            "run in a process without one")
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()
        from repro_torch import compat
        compat.forget_groups()


# ---------------------------------------------------------------------------
# Steps
# ---------------------------------------------------------------------------

def arch_config(arch: str, row_format=None, nnz_cap=None):
    """``arch``'s config, with the svm row format and nnz_cap given."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    over = {k: v for k, v in (("row_format", row_format),
                              ("nnz_cap", nnz_cap)) if v is not None}
    return dataclasses.replace(cfg, **over) if over else cfg


def build_bundle(cfg, shape_name: str, mesh, rules_name: str = "baseline",
                 shuffle=None):
    """The step of ``cfg`` at ``shape_name`` on ``mesh``: the svm round,
    sweep (:data:`SWEEP_CONFIGS` configs) or serve wave
    (:data:`SERVE_STREAMS` streams) for the svm family, else
    ``steps.build_step`` at ``INPUT_SHAPES[shape_name]``."""
    from repro_torch.launch import steps as steps_lib
    from repro_torch.launch.rules import get_rules
    if getattr(cfg, "family", None) == "svm":
        if shape_name == "svm_sweep":
            return steps_lib.build_svm_sweep_step(
                cfg, mesh, num_configs=SWEEP_CONFIGS, shuffle_impl=shuffle)
        if shape_name == "svm_serve":
            return steps_lib.build_svm_serve_step(
                cfg, mesh, num_streams=SERVE_STREAMS, shuffle_impl=shuffle)
        return steps_lib.build_svm_round_step(cfg, mesh,
                                              shuffle_impl=shuffle)
    return steps_lib.build_step(cfg, mesh, steps_lib.INPUT_SHAPES[shape_name],
                                rules=get_rules(rules_name))


def lower(bundle, mesh) -> dict:
    """This process's rank's step shape-only (see the module docstring).
    → ``trace_s``, FLOPs, op bytes, ``temp_peak`` and ``arg_bytes``, the
    rank's collective entries (``"record"``) and the kernels' work
    (``"work"``)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch import compat
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import local_abstract
    local = local_abstract(bundle.args, bundle.in_shardings, mesh)
    with FakeTensorMode(), torch.no_grad():
        args = fake_like(local)
        nargs = arg_bytes(args)
        t0 = time.perf_counter()
        with compat.record_collectives() as rec, \
                ops.record_kernel_work() as work, \
                FlopCounterMode(display=False) as fc, PeakBytes() as pk:
            out = bundle.fn(*args)
            del out
        secs = time.perf_counter() - t0
    return {"trace_s": secs, "flops": float(fc.get_total_flops()),
            "op_bytes": float(pk.op_bytes), "temp_peak": pk.peak,
            "arg_bytes": nargs, "record": rec, "work": work}


def schedule_digest(record) -> str:
    """A digest of a rank's ordered collective schedule
    (``analysis.collective_schedule``: kind, groups, pairs, shapes and
    dtypes of each collective)."""
    import hashlib

    from repro_torch.analysis import collective_schedule
    return hashlib.sha256(repr(collective_schedule(record)).encode()) \
        .hexdigest()[:16]


def kernel_totals(work, epochs: int) -> dict:
    """The kernels' work by route (``ops.ROUTE_LAUNCHES``' keys):
    launches, FLOPs and bytes (a solve's per-epoch work × its cutoff, or
    × ``epochs`` where the cutoff was a tensor)."""
    out: dict = {}
    for w in work:
        e = w.epochs if w.epochs is not None else epochs
        k = out.setdefault(f"{w.name}/{w.route}",
                           {"launches": 0, "flops": 0.0, "bytes": 0.0})
        k["launches"] += 1
        k["flops"] += w.flops * e
        k["bytes"] += w.nbytes * e
    return out


def _rows_real(svm_cfg, lead, d, dt, seed, dev):
    """Rows of the repo's synthetic TF×IDF distribution
    (``data.pipeline.svm_rows_device``, or ``svm_rows_sparse_device``
    for blocked-CSR rows of ``nnz_cap`` slots: distinct column ids in a
    row, at most ``nnz_cap`` of them live), seeded, in the shape ``lead``
    + the row; and their labels."""
    from repro_torch.data.pipeline import (default_row_nnz,
                                           svm_rows_device,
                                           svm_rows_sparse_device)
    n = math.prod(lead)
    nnz = svm_cfg.row_nnz or default_row_nnz(d)
    if svm_cfg.row_format == "sparse_csr":
        X, y = svm_rows_sparse_device(n, d, svm_cfg.nnz_cap, seed,
                                      nnz=min(nnz, svm_cfg.nnz_cap),
                                      dtype=dt, device=dev)
        X = sparse_rows.SparseRows(
            *(t.reshape(*lead, svm_cfg.nnz_cap) for t in (X.indices,
                                                          X.values)), d)
        from repro_torch.kernels import ops
        ops.check_column_ids(X)
    else:
        X, y = svm_rows_device(n, d, seed, nnz=nnz, dtype=dt, device=dev)
        X = X.reshape(*lead, d)
    return X, y.reshape(lead).to(dt)


def real_inputs(kind: str, cfg, bundle, mesh, shuffle, gen, dev,
                seed: int = 0):
    """Rank 0's inputs of its step, on ``dev``: svm rows of the repo's
    synthetic TF×IDF distribution from ``seed`` (:func:`_rows_real`),
    their labels, a full mask, the round-0 SV state, and for the sweep
    and serve steps C over logspace(-2, 1, S); an LM step's shards of
    weights drawn from ``gen`` (``layers.template_init``), and for the
    decode step (``kind`` "decode") its cache slice of N(0, 1) keys and
    values at position S − 1 (every slot attended) and random tokens, for
    the train step ("train") zero AdamW moments and its rows of random
    tokens and labels (and N(0, 1) prefix embeddings), for the prefill
    step ("prefill") its rows of random tokens (and prefix embeddings)."""
    from repro_torch.launch import steps as steps_lib
    from repro_torch.launch.mesh import data_parallel_size
    from repro_torch.launch.steps import local_abstract
    local = local_abstract(bundle.args, bundle.in_shardings, mesh)
    if kind in ("svm", "svm_sweep", "svm_serve"):
        import numpy as np

        from repro_torch.core import init_sv_buffer, sweep_grid
        from repro_torch.core.sweep import _params_on, init_sharded_sweep_sv
        d = cfg.num_features
        dt = getattr(torch, cfg.dtype)
        lead = tuple(local[1].shape)          # the labels' (S,) per
        X, y = _rows_real(cfg, lead, d, dt, seed, dev)
        m = torch.ones(lead, dtype=dt, device=dev)
        ndev = data_parallel_size(mesh)
        mr = steps_lib._svm_mr_cfg(cfg, shuffle, ndev)
        nnzc = cfg.nnz_cap if cfg.row_format == "sparse_csr" else None
        if kind == "svm":
            return (X, y, m, init_sv_buffer(cfg.sv_capacity, d, dt, dev,
                                            nnz_cap=nnzc))
        S = local[4].C.shape[0]
        state = init_sharded_sweep_sv(mr, S, d, ndev, lead[-1], dt,
                                      per_config_data=kind == "svm_serve",
                                      device=dev)
        params = _params_on(sweep_grid(mr.svm, C=np.logspace(-2, 1, S)),
                            dev)
        return X, y, m, state, params
    from repro_torch.models.layers import template_init
    model = bundle.model
    pspecs, state_specs = bundle.in_shardings[:2]
    params = template_init(model.template(), gen, model.cfg.torch_dtype,
                           placements=pspecs, mesh=mesh)
    if kind in ("train", "prefill"):
        from repro_torch import optim
        batch = {}
        for k, t in local[-1].items():
            if t.dtype == torch.int32:
                batch[k] = torch.randint(0, model.cfg.vocab_size,
                                         tuple(t.shape), generator=gen,
                                         device=dev, dtype=torch.int32)
            else:
                batch[k] = torch.randn(tuple(t.shape), generator=gen,
                                       device=dev).to(t.dtype)
        if kind == "prefill":
            return params, batch
        return params, optim.init(params), batch
    B = local[2].shape[0]                     # the rank's sequences
    S = local[1].caches.k.shape[3]
    state = model.init_decode_state(bundle.args[2].shape[0], S, device=dev,
                                    place=state_specs)
    for c in state.caches:
        for layer in c:
            layer.normal_(generator=gen)
    state = state._replace(pos=torch.tensor(S - 1, dtype=torch.int32,
                                            device=dev))
    tokens = torch.randint(0, model.cfg.vocab_size, (B, 1), generator=gen,
                           device=dev, dtype=torch.int32)
    return params, state, tokens


def run_on_card(kind: str, cfg, bundle, mesh, shuffle, seed: int = 0,
                inspect=None) -> dict:
    """Rank 0's step for real on the card (see the module docstring). →
    ``first_ms``, ``step_ms``, ``peak_bytes``, ``arg_bytes`` (the card's
    bytes of the inputs). ``inspect(fn, args)``, when given, is called
    after the two runs with the step and its inputs."""
    dev = torch.device("cuda", torch.cuda.current_device())
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    gen = torch.Generator(device=dev).manual_seed(seed)
    with torch.no_grad():
        args = real_inputs(kind, cfg, bundle, mesh, shuffle, gen, dev,
                           seed)
        torch.cuda.synchronize()
        nargs = torch.cuda.memory_allocated() - base
        times = []
        for _ in range(2):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            out = bundle.fn(*args)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
            peak = torch.cuda.max_memory_allocated() - base
            del out
        if inspect is not None:
            inspect(bundle.fn, args)
    del args
    torch.cuda.empty_cache()
    return {"first_ms": times[0], "step_ms": times[1], "peak_bytes": peak,
            "arg_bytes": nargs}


# ---------------------------------------------------------------------------
# One (arch, shape, mesh)
# ---------------------------------------------------------------------------

def _fmt(a) -> str:
    if sparse_rows.is_sparse(a):
        return (f"sparse_csr[d={a.d}] "
                f"idx={_dt(a.indices)}{list(a.indices.shape)} "
                f"val={_dt(a.values)}{list(a.values.shape)}")
    return f"{_dt(a)}{list(a.shape)}"


def _dt(t) -> str:
    return str(t.dtype).replace("torch.", "")


def _fmt_tree(tree):
    """The reference's ``per_host_args`` layout: lists for tuples,
    dicts for dicts, a string a tensor or ``SparseRows``."""
    if isinstance(tree, torch.Tensor) or sparse_rows.is_sparse(tree):
        return _fmt(tree)
    if isinstance(tree, dict):
        return {k: _fmt_tree(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (tuple, list)):
        return [_fmt_tree(v) for v in tree]
    return tree


def run_one(arch: str, shape_name: str, multi_pod: bool,
            rules_name: str = "baseline", out_dir: str = DEFAULT_OUT,
            verbose: bool = True, measure_layers: bool = True,
            shuffle: str = None, processes: int = 1,
            row_format: str = None, nnz_cap: int = None,
            device=None, inspect=None) -> dict:
    """The dry run of (``arch``, ``shape_name``) on the production mesh
    (2 × 16 × 16 with ``multi_pod``): the record, also written to
    ``out_dir`` (:func:`_write`). ``device`` None or "cuda" adds the run
    on the card (raising without one; ``inspect`` as
    :func:`run_on_card`'s); "cpu" runs the shape-only part alone.
    Refuses to start in a process with a process group up."""
    from repro_torch import compat
    from repro_torch.configs import canonical, get_config
    from repro_torch.device import resolve_device
    from repro_torch.launch import steps as steps_lib
    from repro_torch.launch.cluster import simulated_topology
    from repro_torch.launch.costs import analytic_costs
    from repro_torch.launch.hlo_analysis import (collective_stats,
                                                 dominant_term,
                                                 roofline_terms,
                                                 total_collective_bytes)
    from repro_torch.launch.mesh import make_production_mesh

    dev = resolve_device(device)
    cfg = get_config(arch)
    arch = canonical(arch)
    shape_mesh = make_production_mesh(multi_pod=multi_pod)
    chips = shape_mesh.size
    record = {"arch": arch, "shape": shape_name,
              "mesh": "2x16x16" if multi_pod else "16x16",
              "chips": chips, "rules": rules_name, "status": "ok"}
    if processes > 1:
        record["processes"] = processes
    svm = getattr(cfg, "family", None) == "svm"
    with fake_group(chips):
        try:
            if processes > 1:
                record["topology"] = simulated_topology(processes, chips)
            if svm:
                record["shuffle"] = steps_lib._svm_shuffle(cfg, shuffle)
                cfg = arch_config(arch, row_format, nnz_cap)
                record["row_format"] = cfg.row_format
                if cfg.row_format == "sparse_csr":
                    record["nnz_cap"] = cfg.nnz_cap
                shape = None
            else:
                shape = steps_lib.INPUT_SHAPES[shape_name]
                skip = steps_lib.applicability(cfg, shape)
                if skip:
                    record.update(status="skip", reason=skip)
                    _write(record, out_dir)
                    if verbose:
                        print(json.dumps(record, indent=2))
                    return record
            mesh = compat.rank_mesh(shape_mesh.axis_names, shape_mesh.sizes)
            bundle = build_bundle(cfg, shape_name, mesh, rules_name, shuffle)
            if processes > 1:
                record["per_host_args"] = _fmt_tree(
                    steps_lib.per_host_abstract(
                        bundle.args, bundle.in_shardings, mesh, processes))
            low = lower(bundle, mesh)
            coll = collective_stats(low["record"])
            if measure_layers and not svm:
                # a probe that fails fails the record (the reference
                # keeps its probes best-effort, under "probe_error")
                from repro_torch.launch.probes import (build_probes,
                                                       measure_probes)
                pm = measure_probes(build_probes(
                    cfg, mesh, shape, bundle=bundle), mesh)
                record["probes"] = {
                    k: {"extra_trips": v["extra_trips"],
                        "collectives": v["collectives"]}
                    for k, v in pm.items()}
            epochs = cfg.max_epochs if svm else 1
            kernels = kernel_totals(low["work"], epochs)
            flops_rank = low["flops"] + sum(k["flops"]
                                            for k in kernels.values())
            bytes_rank = low["op_bytes"] + sum(k["bytes"]
                                               for k in kernels.values())
            if svm:
                flops_glob, hbm_glob = flops_rank * chips, bytes_rank * chips
            else:
                ac = analytic_costs(cfg, shape)
                flops_glob, hbm_glob = ac.flops, ac.hbm_bytes
            coll_bytes = total_collective_bytes(coll)
            wire_bytes = total_collective_bytes(coll, "wire_bytes")
            terms = roofline_terms(flops_glob, hbm_glob, coll_bytes, chips)
            peak = low["arg_bytes"] + low["temp_peak"]
            record.update(
                trace_s=round(low["trace_s"], 2),
                flops_global=flops_glob, hbm_bytes_global=hbm_glob,
                per_rank_flops=flops_rank, per_rank_bytes=bytes_rank,
                kernels=kernels,
                collective_count=sum(1 for e in low["record"]
                                     if e.kind != "ppermute_wait"),
                schedule_digest=schedule_digest(low["record"]),
                collective_bytes_per_device=coll_bytes,
                collective_wire_bytes_per_device=wire_bytes,
                collectives=coll, roofline=terms,
                collective_s_wire=roofline_terms(
                    flops_glob, hbm_glob, wire_bytes, chips)["collective_s"],
                dominant=dominant_term(terms),
                argument_size_in_bytes=low["arg_bytes"],
                temp_peak_bytes=low["temp_peak"], peak_bytes=peak)
            if not svm:
                record["model_flops_analytic"] = _model_flops(cfg, shape)
                record["useful_flops_ratio"] = (
                    record["model_flops_analytic"] / max(flops_glob, 1.0))
            room = (torch.cuda.get_device_properties(dev).total_memory
                    if dev.type == "cuda" else CARD_BYTES)
            if peak > room:
                raise MemoryError(
                    f"rank 0's step does not fit one card: reckoned peak "
                    f"{peak} bytes ({low['arg_bytes']} of shards) > {room}")
            if dev.type == "cuda":
                card = run_on_card(shape_name if svm else shape.kind, cfg,
                                   bundle, mesh, shuffle, inspect=inspect)
                card["peak_ratio"] = card["peak_bytes"] / peak
                record["card"] = card
        except Exception as e:
            record.update(status="error", error=f"{type(e).__name__}: {e}",
                          traceback=traceback.format_exc()[-2000:])
    _write(record, out_dir)
    if verbose:
        slim = {k: v for k, v in record.items() if k != "traceback"}
        print(json.dumps(slim, indent=2, default=str))
    return record


def reckon(arch: str, shape_name: str, sizes, shuffle=None,
           row_format=None, nnz_cap=None, rules_name: str = "baseline"
           ) -> dict:
    """Rank 0's reckoned bytes of the step on a ("data", "model") mesh
    of ``sizes`` (shape-only, on a fake group of its own; no record): →
    ``arg_bytes``, ``temp_peak``, ``peak_bytes``."""
    from repro_torch import compat
    cfg = arch_config(arch, row_format, nnz_cap)
    with fake_group(sizes[0] * sizes[1]):
        mesh = compat.rank_mesh(("data", "model"), sizes)
        low = lower(build_bundle(cfg, shape_name, mesh, rules_name, shuffle),
                    mesh)
    return {"arg_bytes": low["arg_bytes"], "temp_peak": low["temp_peak"],
            "peak_bytes": low["arg_bytes"] + low["temp_peak"]}


def _model_flops(cfg, shape) -> float:
    """MODEL_FLOPS = 6·N·D (dense) / 6·N_active·D for the step's tokens:
    training counts the forward and backward (6·N a token), prefill and
    decode the forward (2·N)."""
    n_active = cfg.active_param_count()
    S = shape.seq_len
    if cfg.is_encoder_decoder:
        S = min(S, cfg.max_decoder_len)   # decoder-context cap
    if shape.kind == "train":
        return 6.0 * n_active * shape.global_batch * S
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * S
    return 2.0 * n_active * shape.global_batch     # decode: 1 token/seq


def _write(record: dict, out_dir: str) -> None:
    os.makedirs(out_dir, exist_ok=True)
    shuffle = f"_{record['shuffle']}" if "shuffle" in record else ""
    procs = (f"_p{record['processes']}"
             if record.get("processes", 1) > 1 else "")
    sparse = (f"_sparse{record['nnz_cap']}"
              if record.get("row_format") == "sparse_csr" else "")
    name = (f"dryrun_{record['arch']}_{record.get('shape')}"
            f"_{record['mesh']}_{record.get('rules', 'baseline')}"
            f"{shuffle}{sparse}{procs}.json")
    with open(os.path.join(out_dir, name.replace("/", "_")), "w") as f:
        json.dump(record, f, indent=2, default=str)


def main(argv=None) -> int:
    from repro_torch.core.mapreduce_svm import SHUFFLE_IMPLS
    ap = argparse.ArgumentParser(description="the port's dry run")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default="train_4k", choices=SHAPES)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--rules", default="baseline")
    ap.add_argument("--shuffle", default=None, choices=SHUFFLE_IMPLS,
                    help="svm family: SV merge transport (default: the "
                         "arch config's shuffle_impl)")
    ap.add_argument("--processes", type=int, default=1,
                    help="the job split over N processes: records each "
                         "process's input shapes and suffixes the artifact "
                         "name with _pN")
    ap.add_argument("--row-format", default=None,
                    choices=("dense", "sparse_csr"),
                    help="svm family: row representation (default: the "
                         "arch config's); sparse_csr suffixes the artifact "
                         "name with _sparse<nnz_cap>")
    ap.add_argument("--nnz-cap", type=int, default=None,
                    help="svm family, sparse_csr: (index, value) slots a "
                         "blocked-CSR row")
    ap.add_argument("--all", action="store_true",
                    help="run every (arch × shape) on this mesh")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--device", default=None, choices=("cpu", "cuda"),
                    help="cpu: the shape-only run alone; default the card, "
                         "where rank 0's step also runs for real")
    args = ap.parse_args(argv)

    if args.all:
        from repro_torch.configs import PORTED_ARCHS
        ok = True
        for arch in PORTED_ARCHS:
            if arch == "svm_tfidf":
                rec = run_one(arch, "svm", args.multi_pod, args.rules,
                              args.out, shuffle=args.shuffle,
                              device=args.device)
                ok &= rec["status"] in ("ok", "skip")
                continue
            for shape in ("train_4k", "prefill_32k", "decode_32k",
                          "long_500k"):
                rec = run_one(arch, shape, args.multi_pod, args.rules,
                              args.out, device=args.device)
                ok &= rec["status"] in ("ok", "skip")
        return 0 if ok else 1
    rec = run_one(args.arch, args.shape, args.multi_pod, args.rules, args.out,
                  shuffle=args.shuffle, processes=args.processes,
                  row_format=args.row_format, nnz_cap=args.nnz_cap,
                  device=args.device)
    return 0 if rec["status"] in ("ok", "skip") else 1


if __name__ == "__main__":
    sys.exit(main())
