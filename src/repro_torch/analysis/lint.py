"""``python -m repro_torch.analysis.lint``: run the invariant rules
against the real programs, the counterpart of
``repro/analysis/lint.py``.

Matrix (static rules): every sharded SVM program, the round
(``build_sharded_round``), the sweep (``build_sharded_sweep_round``, 4
configs) and the serve wave (``build_sharded_sweep_round(...,
per_config_data=True)``, 4 streams), under every transport in
``SHUFFLE_IMPLS`` (``allgather``/``ring``/``hier``) and both row
formats (``dense``/``sparse_csr``), on the 8 ranks of one
``compat.spawn`` (gloo on the CPU, or with ``--device cuda`` the ranks
sharing the card). Each rank runs each program once under all of:

* host-sync: no op that makes the host wait on device values outside an
  ``allowed_host_sync`` region;
* dtype-drift: the solver-state tensors (y/α) never downcast outside
  the bf16 wire pack;
* dense-materialization (blocked-CSR programs): no op output holds a
  dense row block past the ceiling;
* collective-schedule: the rank's recorded schedule is valid; a second
  build of the program records the same schedule, and the parent holds
  the 8 ranks' schedules equal.

Dynamic rules: a real ``fit_mapreduce_sweep`` under
``no_implicit_host_sync`` with ``fail_on_retrace=True``, and a
``StreamingSVMService(fail_on_retrace=True)`` folding two waves of one
shape: the second must meet no new compile event.

Modes:
    python -m repro_torch.analysis.lint              # the matrix
    python -m repro_torch.analysis.lint --self-test  # seed one violation
        per rule and require the rule to fire naming op and program
    python -m repro_torch.analysis.lint --artifacts D  # the reference's
        dry-run artifacts: not ported (ROADMAP Queue 1 item 13g-b)

``--device cuda`` runs the matrix, the dynamic rules and the self-test
on the card (where the runtime host-sync guard can fire); the default is
the CPU, as the reference lints on host devices.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

# The feature dim is what the dense-leak ceiling keys on; the rows per
# rank are above the ceiling, so densifying a whole shard is a
# detectable violation (the reference's harness shapes).
LINT_FEATURES = 512
LINT_ROWS_PER_DEVICE = 512
LINT_SV_CAPACITY = 32
LINT_NNZ_CAP = 32
NUM_CONFIGS = 4
NUM_STREAMS = 4
NUM_RANKS = 8
KINDS = ("round", "sweep", "serve")
ROW_FORMATS = ("dense", "sparse_csr")


def lint_cfg(row_format: str):
    """The svm-tfidf config at the lint shapes, in float32: the
    dtype-drift rule tracks solver state staying f32, which the bf16
    default would trivialize."""
    from repro_torch.configs.svm_tfidf import SVMTfidfConfig
    return dataclasses.replace(
        SVMTfidfConfig(), dtype="float32", num_features=LINT_FEATURES,
        rows_per_device=LINT_ROWS_PER_DEVICE, sv_capacity=LINT_SV_CAPACITY,
        nnz_cap=LINT_NNZ_CAP, row_format=row_format,
        stream_rows_per_wave=LINT_ROWS_PER_DEVICE)


def mr_cfg(svm_cfg, shuffle: str, ndev: int):
    """The round's ``MRSVMConfig`` of a launch config, as the
    reference's ``launch.steps._svm_mr_cfg``: hier gets the simulated
    host count."""
    from repro_torch.core import MRSVMConfig, SVMConfig
    from repro_torch.launch.mesh import simulated_hier_hosts
    sparse = svm_cfg.row_format == "sparse_csr"
    return MRSVMConfig(
        sv_capacity=svm_cfg.sv_capacity, shuffle_impl=shuffle,
        hier_num_hosts=simulated_hier_hosts(ndev) if shuffle == "hier"
        else None,
        svm=SVMConfig(C=svm_cfg.C, max_epochs=svm_cfg.max_epochs,
                      row_format=svm_cfg.row_format,
                      nnz_cap=svm_cfg.nnz_cap if sparse else 0))


def _rows(gen, lead, d: int, svm_cfg, dev):
    """Random rows of shape lead + (d,) on ``dev``: dense, or blocked-CSR
    with ``nnz_cap`` slots a row (their column ids checked once)."""
    import torch
    from repro_torch import sparse as sparse_rows
    if svm_cfg.row_format != "sparse_csr":
        return torch.randn(*lead, d, generator=gen).to(dev)
    k = svm_cfg.nnz_cap
    idx = torch.randint(0, d, (*lead, k), generator=gen, dtype=torch.int32)
    rows = sparse_rows.SparseRows(idx.to(dev),
                                  torch.randn(*lead, k, generator=gen).to(dev),
                                  d)
    rows.mark_ids_in_range()
    return rows


def build_program(kind: str, svm_cfg, shuffle: str, rank):
    """One program on this rank at the lint shapes. → (fn, args, taint):
    the taint marks the solver-state tensors (labels, the state's y and
    α) among ``args``'s tensors."""
    import torch
    from repro_torch import sparse as sparse_rows
    from repro_torch.analysis.base import tensor_leaves
    from repro_torch.core import (build_sharded_round,
                                  build_sharded_sweep_round, init_sv_buffer,
                                  sweep_grid)
    from repro_torch.core.svm import SolverParams
    ndev, dev = rank.world_size, rank.device
    cfg = mr_cfg(svm_cfg, shuffle, ndev)
    d, cap = svm_cfg.num_features, svm_cfg.sv_capacity
    gen = torch.Generator().manual_seed(1000 + rank.rank)
    if kind == "serve":
        per = -(-(svm_cfg.stream_rows_per_wave + cap) // ndev)
        lead = (NUM_STREAMS, per)
    else:
        per = svm_cfg.rows_per_device
        lead = (per,)
    Xl = _rows(gen, lead, d, svm_cfg, dev)
    yl = torch.where(torch.rand(*lead, generator=gen) < 0.5, -1.0,
                     1.0).to(dev)
    ml = torch.ones(lead).to(dev)
    nnz = svm_cfg.nnz_cap if sparse_rows.is_sparse(Xl) else None
    if kind == "round":
        fn = build_sharded_round(cfg, per, device=dev)
        state = init_sv_buffer(cap, d, torch.float32, dev, nnz_cap=nnz)
        args = (Xl, yl, ml, state)
    else:
        S = NUM_STREAMS if kind == "serve" else NUM_CONFIGS
        fn = build_sharded_sweep_round(cfg, per, device=dev,
                                       per_config_data=kind == "serve")
        state = fn.init_sv(S, d, torch.float32)
        grid = sweep_grid(cfg.svm, C=[0.1 * 2 ** s for s in range(S)])
        params = SolverParams(*(torch.as_tensor(f, dtype=torch.float32,
                                                device=dev) for f in grid))
        args = (Xl, yl, ml, state, params)
    solver = {"y", "alpha"}
    taint = ([False] * len(tensor_leaves(Xl)) + [True, False]
             + [f in solver for f in state._fields
                for _ in tensor_leaves(getattr(state, f))]
             + [False] * len(tensor_leaves(args[4:])))
    return fn, args, taint


def _report(rep) -> str:
    extra = f", allowed={len(rep.allowed)}" if rep.allowed else ""
    note = f" [{rep.note}]" if rep.note else ""
    return f"  OK [{rep.rule}] checked={rep.checked}{extra}{note}"


def lint_program(kind: str, svm_cfg, shuffle: str, rank) -> dict:
    """Every static rule over one program on this rank (one run under
    all of them), then a second build's schedule. → lines to print, the
    recorded schedule and its per-kind counts."""
    from repro_torch import analysis, compat
    name = f"{kind}/{shuffle}/{svm_cfg.row_format}"
    fn, args, taint = build_program(kind, svm_cfg, shuffle, rank)
    sparse = svm_cfg.row_format == "sparse_csr"
    reps = {}

    def under_dense(*a):
        if sparse:
            reps["dense"] = analysis.check_no_dense_materialization(
                fn, a, d=svm_cfg.num_features, program=name)
        else:
            fn(*a)

    def under_drift(*a):
        reps["drift"] = analysis.check_no_dtype_drift(
            under_dense, a, taint=taint, program=name)

    with compat.record_collectives() as rec:
        reps["host"] = analysis.check_no_host_callbacks(under_drift, args,
                                                        program=name)
    reps["schedule"] = analysis.check_schedule(rec, program=name)
    fn2, args2, _ = build_program(kind, svm_cfg, shuffle, rank)
    with compat.record_collectives() as rec2:
        fn2(*args2)
    analysis.check_schedule(rec2, program=name)
    sched = analysis.collective_schedule(rec)
    reps["agree"] = analysis.assert_schedules_agree(
        {"build0": sched, "build1": analysis.collective_schedule(rec2)},
        program=name)
    lines = [f"program {name}"] + [_report(reps[k]) for k in
                                   ("host", "drift", "dense", "schedule",
                                    "agree") if k in reps]
    return {"name": name, "lines": lines, "schedule": sched,
            "counts": analysis.collective_counts(rec)}


def lint_rank(rank, programs) -> list:
    """Rank target of the matrix: each (kind, row format, shuffle) of
    ``programs`` linted on this rank."""
    return [lint_program(kind, lint_cfg(fmt), shuffle, rank)
            for kind, fmt, shuffle in programs]


def matrix_programs():
    from repro_torch.core.mapreduce_svm import SHUFFLE_IMPLS
    return [(kind, fmt, shuffle) for fmt in ROW_FORMATS
            for shuffle in SHUFFLE_IMPLS for kind in KINDS]


def run_matrix(device: str, programs=None) -> int:
    """The matrix on one spawn of ``NUM_RANKS`` ranks, then the dynamic
    rules. Prints each program's reports and per-kind collective counts
    (``counts {json}``)."""
    from repro_torch import analysis, compat
    from repro_torch.analysis import lint as by_name   # not __main__'s
    programs = programs or matrix_programs()
    t0 = time.perf_counter()
    out = compat.spawn(by_name.lint_rank, NUM_RANKS, (programs,),
                       device=device, timeout_s=300.0, join_timeout_s=900.0)
    for i, first in enumerate(out[0]):
        for line in first["lines"]:
            print(line)
        rep = analysis.assert_schedules_agree(
            {f"rank{r}": out[r][i]["schedule"] for r in range(NUM_RANKS)},
            program=first["name"])
        print(f"  OK [{rep.rule}] {NUM_RANKS} ranks agree on "
              f"{len(first['schedule'])} collectives")
        print(f"  counts {json.dumps(first['counts'], sort_keys=True)}")
    print(f"matrix: {len(programs)} programs on {NUM_RANKS} ranks in "
          f"{time.perf_counter() - t0:.1f} s")
    return run_dynamic(device)


def run_dynamic(device: str) -> int:
    """Dynamic rules on the functional loops: retrace and host-sync
    on live hot loops at small shapes (the loop discipline, not the
    model). The data is on ``device`` before the guards."""
    import numpy as np
    import torch
    from repro_torch import analysis
    from repro_torch.core import (MRSVMConfig, SVMConfig, fit_mapreduce,
                                  fit_mapreduce_sweep, sweep_grid)
    from repro_torch.core.svm import SolverParams
    from repro_torch.serving import StreamingSVMService

    cfg = MRSVMConfig(sv_capacity=32, max_rounds=3, gamma=1e-4,
                      svm=SVMConfig(C=1.0, max_epochs=8))
    rng = np.random.default_rng(0)
    w = rng.normal(size=16).astype(np.float32)

    def rows(n):
        X = rng.normal(size=(n, 16)).astype(np.float32)
        return X, np.sign(X @ w).astype(np.float32)
    X, y = rows(128)
    Xd, yd = torch.from_numpy(X).to(device), torch.from_numpy(y).to(device)
    params = SolverParams(*(torch.as_tensor(f, dtype=torch.float32,
                                            device=device)
                            for f in sweep_grid(cfg.svm, C=[0.5, 1.0])))

    print("program dynamic/sweep-rounds")
    with analysis.no_implicit_host_sync():
        res = fit_mapreduce_sweep(Xd, yd, 4, cfg, params,
                                  fail_on_retrace=True, device=device)
    print(f"  OK [retrace] steady-state sweep rounds met no compile event "
          f"(rounds {res.rounds.tolist()})")
    print("  OK [host-sync] designed readbacks pass the armed guard"
          + ("" if analysis.host_guards_enforced(device)
             else " [note: the CPU cannot fire the runtime guard]"))

    print("program dynamic/streaming-wave")
    svc = StreamingSVMService(cfg, num_partitions=4, fail_on_retrace=True,
                              device=device)
    svc.register("t0", fit_mapreduce(Xd, yd, 4, cfg, device=device))
    for _ in range(2):               # wave 0 warms; wave 1 must not compile
        Xb, yb = rows(64)
        svc.submit("t0", Xb, yb)
        svc.run_wave()
    rep = svc.throughput_report()
    if rep["retraces"]:
        print(f"FAIL [retrace] streaming waves retraced: {rep}")
        return 1
    print(f"  OK [retrace] steady-state wave fold met no compile event "
          f"(fold_programs={rep['fold_programs']}, "
          f"retraces={rep['retraces']})")
    return 0


# ---------------------------------------------------------------------------
# Self-test: seed one violation per rule; each must fire.
# ---------------------------------------------------------------------------

def _expect(rule: str, fn) -> int:
    from repro_torch.analysis import LintViolation
    try:
        fn()
    except LintViolation as e:
        if e.rule != rule:
            print(f"FAIL self-test [{rule}]: wrong rule fired: {e}")
            return 1
        if not e.op or not e.program:
            print(f"FAIL self-test [{rule}]: violation does not name "
                  f"op/program: {e}")
            return 1
        print(f"  OK seeded [{rule}] violation fired: op={e.op!r} "
              f"program={e.program!r}")
        return 0
    print(f"FAIL self-test [{rule}]: seeded violation did not fire")
    return 1


_FRESH = [0]


def _fresh_gram(device: str):
    """A Gram call of a shape no call in this process has used: a new
    wrapper signature."""
    import torch
    from repro_torch.kernels import ops
    _FRESH[0] += 1
    X = torch.ones((4, 1000 + 8 * _FRESH[0]), device=device)
    return ops.gram(X, X)


def _entry(kind, pairs=(), groups=None, shape=(8,), serial=0):
    from repro_torch.compat import CollectiveEntry
    return CollectiveEntry(kind=kind, ranks=tuple(range(8)),
                           replica_groups=groups or (tuple(range(8)),),
                           pairs=tuple(pairs), shapes=(shape,),
                           dtypes=("float32",), serial=serial)


def seeded_cases(device: str = "cpu"):
    """The seeded violations of the self-test: (rule, callable), each
    callable raising the rule's ``LintViolation``."""
    import torch
    from repro_torch import analysis
    d = LINT_FEATURES
    bad_ring = [_entry("ppermute_start", ((0, 3), (1, 2), (2, 3))),
                _entry("ppermute_wait")]
    hier_ring = tuple((h * 4 + l, ((h + 1) % 2) * 4 + l)
                      for h in range(2) for l in range(4))
    bad_hier = [_entry("ppermute_start", hier_ring),
                _entry("ppermute_wait"),
                _entry("all_gather_groups",
                       groups=((0, 1, 2, 3), (3, 4, 5, 6, 7)))]
    good = analysis.collective_schedule([_entry("psum"),
                                         _entry("all_gather")])

    def retrace():
        with analysis.no_retrace("self-test wave"):
            _fresh_gram(device)

    def leaky(x):
        x.sum().item()
        return x * 2.0

    def densify(v):
        return (v[:, None] * torch.ones((LINT_ROWS_PER_DEVICE, d),
                                        device=device)).sum()

    def drift(alpha):
        return alpha.to(torch.bfloat16).sum()

    return [
        ("retrace", retrace),
        ("collective-schedule",
         lambda: analysis.check_schedule(bad_ring, "self-test ring")),
        ("collective-schedule",
         lambda: analysis.check_schedule(bad_hier, "self-test hier")),
        ("collective-schedule",
         lambda: analysis.assert_schedules_agree(
             {"proc0": good, "proc1": good[:1]}, "self-test agreement")),
        ("collective-schedule",
         lambda: analysis.compare_collective_counts(
             {"psum": {"count": 3}}, {"psum": {"count": 2}},
             "self-test counts")),
        ("host-sync",
         lambda: analysis.check_no_host_callbacks(
             leaky, (torch.zeros((4,), device=device),),
             "self-test hot loop")),
        ("dense-materialization",
         lambda: analysis.check_no_dense_materialization(
             densify, (torch.zeros((LINT_ROWS_PER_DEVICE,),
                                   device=device),),
             d=d, program="self-test densify")),
        ("dtype-drift",
         lambda: analysis.check_no_dtype_drift(
             drift, (torch.zeros((8,), device=device),), taint=[True],
             program="self-test drift")),
    ]


def wire_pack_report(device: str = "cpu"):
    """The dtype-drift report of a bf16 downcast of α that the wire pack
    views as f32 lanes: allowed and recorded."""
    import torch
    from repro_torch import analysis
    from repro_torch.core.mapreduce_svm import pack_wire_rows

    def pack(alpha):
        return pack_wire_rows(alpha.to(torch.bfloat16), torch.bfloat16)[0]
    return analysis.check_no_dtype_drift(
        pack, (torch.zeros((8, 16), device=device),), taint=[True],
        program="self-test wire pack")


def runtime_guard_fires(device: str) -> bool:
    """On a card: a seeded ``.item()`` inside ``no_implicit_host_sync``
    raises, and one inside ``allowed_host_sync`` does not."""
    import torch
    from repro_torch import analysis
    x = torch.ones((4,), device=device)
    with analysis.no_implicit_host_sync():
        with analysis.allowed_host_sync("self-test readback"):
            x.sum().item()
        try:
            x.sum().item()
        except RuntimeError:
            return True
    return False


def run_self_test(device: str = "cpu") -> int:
    from repro_torch import analysis
    failures = 0
    for rule, fn in seeded_cases(device):
        failures += _expect(rule, fn)

    # a declared warm-up budget absorbs the compile event
    with analysis.no_retrace("self-test warmup", allow=1):
        _fresh_gram(device)
    print("  OK [retrace] allow=1 absorbs the declared warm-up compile")

    rep = wire_pack_report(device)
    if not rep.allowed:
        print("FAIL self-test [dtype-drift]: wire-pack downcast was not "
              "recorded as allowlisted")
        failures += 1
    else:
        print(f"  OK [dtype-drift] wire-pack allowlist absorbed the "
              f"downcast ({rep.allowed[0].reason})")

    if analysis.host_guards_enforced(device):
        if runtime_guard_fires(device):
            print("  OK [host-sync] a seeded .item() raised inside "
                  "no_implicit_host_sync on the card; an allowed one did "
                  "not")
        else:
            print("FAIL self-test [host-sync]: the runtime guard did not "
                  "fire on the card")
            failures += 1
    else:
        print("  note [host-sync] the CPU cannot fire the runtime guard; "
              "the static rule above is its check here")
    return failures


def run_artifacts(art_dir: str) -> int:
    raise NotImplementedError(
        "--artifacts re-compiles the reference's JAX dry-run artifacts for "
        "TPU meshes; the port has no dry-run (ROADMAP Queue 1 item 13g-b, "
        f"launch/dryrun), so {art_dir!r} cannot be checked")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="the port's invariant linter")
    ap.add_argument("--artifacts", default=None, metavar="DIR",
                    help="the reference's dry-run artifacts (not ported)")
    ap.add_argument("--self-test", action="store_true",
                    help="seed one violation per rule; each must fire "
                         "naming the offending op and program")
    ap.add_argument("--device", default="cpu", choices=("cpu", "cuda"),
                    help="where the programs run (default: the CPU)")
    args = ap.parse_args(argv)
    from repro_torch.analysis.base import LintViolation
    try:
        if args.self_test:
            failures = run_self_test(args.device)
        elif args.artifacts:
            failures = run_artifacts(args.artifacts)
        else:
            failures = run_matrix(args.device)
    except LintViolation as e:
        print(f"LINT FAILURE: {e}")
        return 1
    if failures:
        print(f"{failures} lint failure(s)")
        return 1
    print("lint: all invariant rules passed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
