"""Seed-sweep chaos harness, ported from ``repro/faults/chaos.py``.

Runs each fault scenario under a deterministic :class:`FaultPlan` per
seed and checks the survived-vs-detected contract:

* **survived** — transient faults (a delayed round, a flaky merge call,
  a failed checkpoint write, a killed wave scheduler, poisoned rows
  behind the quarantine) are absorbed and the result is bit for bit the
  fault-free one; a delayed or retried round launches what a clean one
  does (``ops.ROUTE_LAUNCHES``);
* **detected** — corrupting or terminal faults (corrupted snapshot
  media, a stalled fold) raise a typed :class:`FaultDetected` naming
  layer and cause, or fall back to the newest intact checkpoint
  generation;
* never a hang (the sweep runs under its own watchdog), never a silent
  wrong answer.

Usage::

    PYTHONPATH=src python -m repro_torch.faults.chaos --seeds 0,1,2
    PYTHONPATH=src python -m repro_torch.faults.chaos --device cpu

The fits and services run on ``--device`` (default ``cuda``; without a
card it raises unless ``--device cpu``). Exit status 0 only if every
scenario run met its expected outcome. The scenarios of the sharded
transport (``wire_check_clean``, ``ring_garble``, ``hier_transient``,
``hier_garble``: ROADMAP Queue 1 item 7) and of the multi-process
cluster (``handshake_flake``: item 10) are listed as waiting and not run.

Not imported from :mod:`repro_torch.faults`: this module imports the
layers under attack (core, ckpt, serving), which import that package.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

from repro_torch.faults.plan import (FaultDetected, FaultPlan, InjectedFault,
                                     counters, inject, reset_counters)
from repro_torch.faults.watchdog import CollectiveWatchdog

# partitions of the fits, as the reference's 8 devices
NDEV = 8


class Ctx:
    """Lazily built clean references the scenarios compare with, on
    ``device``; scratch directories removed by :meth:`close`."""

    def __init__(self, device: str = "cuda"):
        self.device = device
        self._cache = {}
        self._dirs = []

    def problem(self):
        """256 × 16 float32 rows, labels sign(x·w), made with numpy."""
        if "problem" not in self._cache:
            import torch
            X = np.random.default_rng(0).normal(size=(256, 16)
                                                ).astype(np.float32)
            w = np.random.default_rng(1).normal(size=16).astype(np.float32)
            y = np.sign(X @ w).astype(np.float32)
            self._cache["problem"] = (torch.from_numpy(X).to(self.device),
                                      torch.from_numpy(y).to(self.device))
        return self._cache["problem"]

    def cfg(self):
        if "cfg" not in self._cache:
            from repro_torch.core import MRSVMConfig, SVMConfig
            self._cache["cfg"] = MRSVMConfig(
                sv_capacity=64, max_rounds=3, gamma=1e-4,
                svm=SVMConfig(C=1.0, max_epochs=10))
        return self._cache["cfg"]

    def fit(self):
        """One fit of the problem → (model, launches by route)."""
        from repro_torch.core.mapreduce_svm import fit_mapreduce
        from repro_torch.kernels import ops
        X, y = self.problem()
        before = dict(ops.ROUTE_LAUNCHES)
        m = fit_mapreduce(X, y, NDEV, self.cfg(), device=self.device)
        return m, {k: v - before.get(k, 0)
                   for k, v in ops.ROUTE_LAUNCHES.items()}

    def clean(self):
        """The fault-free fit and its launches: the bit-for-bit oracle."""
        if "clean" not in self._cache:
            self._cache["clean"] = self.fit()
        return self._cache["clean"]

    def tmpdir(self, prefix: str) -> str:
        d = tempfile.mkdtemp(prefix=prefix)
        self._dirs.append(d)
        return d

    def close(self) -> None:
        for d in self._dirs:
            shutil.rmtree(d, ignore_errors=True)
        self._dirs.clear()


def _model_leaves(m):
    return {"w": m.w, "b": m.b, "alpha": m.final.alpha, "fw": m.final.w,
            "fb": m.final.b, "ids": m.sv.ids, "mask": m.sv.mask,
            "svx": m.sv.x}


def _assert_bitwise_equal(got, want, what: str) -> None:
    import torch
    a, b = _model_leaves(got), _model_leaves(want)
    for k in a:
        if not torch.equal(a[k].cpu(), b[k].cpu()):
            raise AssertionError(
                f"{what}: leaf {k!r} differs from the fault-free run "
                "— the fault was absorbed but NOT bit-for-bit")


# ---------------------------------------------------------------------------
# scenarios: each returns a detail string on the expected outcome and
# raises AssertionError on a contract violation
# ---------------------------------------------------------------------------

def scenario_delay_round(seed: int, ctx: Ctx) -> str:
    """delay_round → SURVIVED: a stalled round completes late; the model
    is bit-identical to the fault-free run, with the same launches."""
    clean, clean_launches = ctx.clean()
    plan = FaultPlan.single("delay_round", seed)
    t0 = time.monotonic()
    with inject(plan) as armed:
        m, launches = ctx.fit()
    assert armed.fired, "the delay never fired (dead seam)"
    _assert_bitwise_equal(m, clean, "delay_round")
    assert launches == clean_launches, \
        f"delayed fit launched {launches}, the clean one {clean_launches}"
    return (f"slept at round {plan.specs[0].when}, "
            f"+{time.monotonic() - t0:.2f}s wall, model bit-identical, "
            "same launches")


def scenario_transport_exc(seed: int, ctx: Ctx) -> str:
    """transport_exc → SURVIVED: the merge call fails transiently 1-2×
    before the round launches anything; retry with backoff absorbs it;
    the model is bit-identical, with the same launches."""
    clean, clean_launches = ctx.clean()
    plan = FaultPlan.single("transport_exc", seed)
    before = counters().get("retries", 0)
    with inject(plan) as armed:
        m, launches = ctx.fit()
    assert sum(armed.remaining) == 0, "injected failures not all raised"
    retried = counters().get("retries", 0) - before
    assert retried >= plan.specs[0].count, \
        f"expected ≥{plan.specs[0].count} retries, saw {retried}"
    _assert_bitwise_equal(m, clean, "transport_exc")
    assert launches == clean_launches, \
        f"retried fit launched {launches}, the clean one {clean_launches}"
    return f"{retried} retries absorbed, model bit-identical, same launches"


def scenario_stall(seed: int, ctx: Ctx) -> str:
    """stall → DETECTED: a body that stops beating trips the watchdog;
    the heartbeat file records the typed diagnosis."""
    plan = FaultPlan.single("stall", seed)
    hb = os.path.join(ctx.tmpdir("chaos_hb_"), "hb.json")
    fired = []
    with inject(plan):
        with CollectiveWatchdog(0.25, heartbeat_path=hb,
                                layer="transport",
                                cause=f"seed {seed} stalled merge",
                                on_timeout=fired.append) as wd:
            time.sleep(0.7)            # stranded: no beat() arrives
        try:
            wd.check()
        except FaultDetected as e:
            assert e.layer == "transport"
            with open(hb) as f:
                status = json.load(f)
            assert status["status"] == "timeout", status
            return (f"watchdog fired after {status['elapsed_s']}s "
                    "(deadline 0.25s), heartbeat says timeout")
    raise AssertionError("stalled section did not trip the watchdog")


def _service(ctx: Ctx, ckpt_dir, **kw):
    from repro_torch.serving import StreamingSVMService
    return StreamingSVMService(ctx.cfg(), num_partitions=4,
                               checkpoint_dir=ckpt_dir, device=ctx.device,
                               **kw)


def _register_stream(svc, ctx: Ctx) -> None:
    from repro_torch.core.mapreduce_svm import fit_mapreduce
    X, y = ctx.problem()
    svc.register("t", fit_mapreduce(X, y, 4, ctx.cfg(), device=ctx.device))


def scenario_ckpt_write_fail(seed: int, ctx: Ctx) -> str:
    """ckpt_write_fail → SURVIVED: 1-2 injected write failures are
    retried; the installed checkpoint restores bit-exact."""
    from repro_torch.serving import StreamingSVMService
    d = ctx.tmpdir("chaos_ckpt_")
    svc = _service(ctx, d)
    _register_stream(svc, ctx)
    plan = FaultPlan.single("ckpt_write_fail", seed)
    with inject(plan) as armed:
        svc.checkpoint()
    assert sum(armed.remaining) == 0, "write failures not all injected"
    assert svc.throughput_report()["retries"] >= plan.specs[0].count
    svc2 = StreamingSVMService.restore(ctx.cfg(), d, device=ctx.device)
    _assert_bitwise_equal(svc2.snapshot("t").model,
                          svc.snapshot("t").model, "ckpt_write_fail")
    return (f"{svc.throughput_report()['retries']} write retries, "
            "restore bit-exact")


def scenario_ckpt_corrupt(seed: int, ctx: Ctx) -> str:
    """ckpt_corrupt → DETECTED + FALLBACK: the newest generation's
    medium is corrupted in flight; restore skips it (crc mismatch) and
    comes back from the previous intact generation."""
    import torch
    from repro_torch.core.mapreduce_svm import update_mapreduce
    from repro_torch.serving import StreamingSVMService
    X, y = ctx.problem()
    d = ctx.tmpdir("chaos_ckpt_")
    svc = _service(ctx, d)
    _register_stream(svc, ctx)          # generation 0 (intact)
    w_gen0 = svc.snapshot("t").model.w.cpu()
    # advance the model, then checkpoint generation 1 under corruption
    m1 = update_mapreduce(svc.snapshot("t").model, X[:64], y[:64], 4,
                          ctx.cfg(), device=ctx.device)
    svc._swap("t", m1, None)
    plan = FaultPlan.single("ckpt_corrupt", seed)
    with inject(plan) as armed:
        svc.checkpoint()
    assert armed.fired, "the media corruption never fired"
    svc2 = StreamingSVMService.restore(ctx.cfg(), d, device=ctx.device)
    assert svc2.restore_fallbacks >= 1, \
        "restore trusted a corrupt newest generation"
    got = svc2.snapshot("t").model.w.cpu()
    assert torch.equal(got, w_gen0), \
        "fallback restored something other than the previous generation"
    return ("gen 1 media corrupt → crc mismatch, fell back to intact "
            "gen 0 bit-exact")


def scenario_poison_rows(seed: int, ctx: Ctx) -> str:
    """poison_rows → SURVIVED: the poisoned batch is quarantined at
    submit(); the folded model is bit-identical to a clean-only fold."""
    import torch
    X, y = ctx.problem()
    Xa, ya = X[:96], y[:96]
    Xb, yb = X[96:192], y[96:192]

    def fold(poison: bool):
        svc = _service(ctx, None)
        _register_stream(svc, ctx)
        if poison:
            plan = FaultPlan.single("poison_rows", seed)
            with inject(plan) as armed:
                svc.submit("t", Xb, yb)     # poisoned → quarantined
            assert armed.fired, "poison seam never fired"
            assert svc.throughput_report()["quarantined"] == 1
        svc.submit("t", Xa, ya)
        svc.drain()
        return svc

    clean = fold(poison=False)
    chaos = fold(poison=True)
    assert bool(torch.isfinite(chaos.snapshot("t").model.w).all())
    _assert_bitwise_equal(chaos.snapshot("t").model,
                          clean.snapshot("t").model, "poison_rows")
    return "1 batch quarantined, model ≡ clean-only fold bit-for-bit"


def scenario_scheduler_kill(seed: int, ctx: Ctx) -> str:
    """scheduler_kill → SURVIVED after restart: the wave dies, its
    batches requeue at the HEAD, the retry wave folds them exactly once
    — model ≡ an uninterrupted fold."""
    X, y = ctx.problem()
    Xa, ya = X[:96], y[:96]

    svc_ref = _service(ctx, None)
    _register_stream(svc_ref, ctx)
    svc_ref.submit("t", Xa, ya)
    svc_ref.drain()

    svc = _service(ctx, None)
    _register_stream(svc, ctx)
    svc.submit("t", Xa, ya)
    plan = FaultPlan.single("scheduler_kill", seed)
    with inject(plan):
        try:
            svc.run_wave()
            raise AssertionError("injected scheduler death did not kill "
                                 "the wave")
        except InjectedFault:
            pass
    assert svc.pending() == 1, "dead wave's batch was not requeued"
    assert svc.throughput_report()["requeued"] == 1
    svc.drain()                          # the restarted scheduler's wave
    _assert_bitwise_equal(svc.snapshot("t").model,
                          svc_ref.snapshot("t").model, "scheduler_kill")
    return "wave died, batch requeued, refolded exactly once bit-exact"


SCENARIOS = [
    ("delay_round", "survived", scenario_delay_round),
    ("transport_exc", "survived", scenario_transport_exc),
    ("stall", "detected", scenario_stall),
    ("ckpt_write_fail", "survived", scenario_ckpt_write_fail),
    ("ckpt_corrupt", "detected", scenario_ckpt_corrupt),
    ("poison_rows", "survived", scenario_poison_rows),
    ("scheduler_kill", "survived", scenario_scheduler_kill),
]

#: the reference's scenarios that wait for a ROADMAP Queue 1 item
WAITING = {"wire_check_clean": 7, "ring_garble": 7, "hier_transient": 7,
           "hier_garble": 7, "handshake_flake": 10}


def sweep(seeds, device: str = "cuda", only=None,
          deadline_s: float = 240.0):
    """Every scenario (whose name contains ``only``, if given) for each
    seed, under a watchdog of ``deadline_s`` a scenario. → rows
    (seed, name, expected, outcome, ok, seconds, detail)."""
    ctx = Ctx(device)
    rows = []
    try:
        with CollectiveWatchdog(deadline_s, layer="harness",
                                cause="chaos scenario") as wd:
            for seed in seeds:
                for name, expect, fn in SCENARIOS:
                    if only and only not in name:
                        continue
                    t0 = time.monotonic()
                    try:
                        detail = fn(seed, ctx)
                        outcome, ok = expect, True
                    except AssertionError as e:
                        outcome, ok, detail = "VIOLATED", False, str(e)
                    except Exception as e:
                        outcome, ok = "ERROR", False
                        detail = f"{type(e).__name__}: {e}"
                    rows.append((seed, name, expect, outcome, ok,
                                 time.monotonic() - t0, detail))
                    wd.beat()
    finally:
        ctx.close()
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="deterministic fault-injection sweep")
    ap.add_argument("--seeds", default="0,1,2",
                    help="comma-separated plan seeds")
    ap.add_argument("--only", default=None,
                    help="run only scenarios whose name contains this")
    ap.add_argument("--deadline", type=float, default=240.0,
                    help="per-scenario watchdog deadline (s) — the "
                         "harness itself must never hang")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the fits and services (default "
                         "cuda; 'cpu' runs the plain versions)")
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",") if s != ""]

    reset_counters()
    t_start = time.monotonic()
    rows = sweep(seeds, args.device, args.only, args.deadline)
    width = max([len(r[1]) for r in rows] + [len(k) for k in WAITING])
    print(f"\nchaos sweep: seeds={seeds} device={args.device} "
          f"({time.monotonic() - t_start:.1f}s total)")
    print(f"{'seed':>4}  {'scenario':<{width}}  {'expect':<9} "
          f"{'outcome':<9} {'t(s)':>6}  detail")
    for seed, name, expect, outcome, ok, dt, detail in rows:
        mark = "ok " if ok else "FAIL"
        print(f"{seed:>4}  {name:<{width}}  {expect:<9} "
              f"{outcome:<9} {dt:>6.1f}  [{mark}] {detail}")
    for name, item in WAITING.items():
        print(f"{'-':>4}  {name:<{width}}  waits for ROADMAP Queue 1 item "
              f"{item}: not run")
    print(f"counters: {dict(sorted(counters().items()))}")
    failures = sum(not r[4] for r in rows)
    if failures:
        print(f"chaos: {failures} scenario(s) violated the "
              "survived-vs-detected contract", file=sys.stderr)
        return 1
    print("chaos: every fault survived bit-for-bit or was detected "
          "and named — no hangs, no silent wrong answers")
    return 0


if __name__ == "__main__":
    sys.exit(main())
