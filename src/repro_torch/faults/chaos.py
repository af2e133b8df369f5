"""Seed-sweep chaos harness, ported from ``repro/faults/chaos.py``.

Runs each fault scenario under a deterministic :class:`FaultPlan` per
seed and checks the survived-vs-detected contract:

* **survived** — transient faults (a delayed round, a flaky merge call,
  a failed checkpoint write, a killed wave scheduler, poisoned rows
  behind the quarantine) are absorbed and the result is bit for bit the
  fault-free one; a delayed or retried round launches what a clean one
  does (``ops.ROUTE_LAUNCHES``);
* **detected** — corrupting or terminal faults (a garbled ring or hier
  wire, corrupted snapshot media, a stalled fold) raise a typed
  :class:`FaultDetected` naming layer and cause, or fall back to the
  newest intact checkpoint generation;
* never a hang (the sweep runs under its own watchdog), never a silent
  wrong answer.

Usage::

    PYTHONPATH=src python -m repro_torch.faults.chaos --seeds 0,1,2
    PYTHONPATH=src python -m repro_torch.faults.chaos --device cpu

The fits and services run on ``--device`` (default ``cuda``; without a
card it raises unless ``--device cpu``). Exit status 0 only if every
scenario run met its expected outcome. The four scenarios of the
sharded transports (``wire_check_clean``, ``ring_garble``,
``hier_transient``, ``hier_garble``) run the sharded round on
:data:`NDEV` ranks (:func:`repro_torch.compat.spawn`; gloo on the CPU
and for ranks that share a card), every seed's in one spawn, each rank
checking the reference's outcome on its own outputs; a scenario passes
when it does on every rank. ``handshake_flake`` runs the real cluster
handshake (:func:`repro_torch.launch.cluster.join`) on a free localhost
port.

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

from repro_torch import faults
from repro_torch.faults.plan import (FaultDetected, FaultPlan, InjectedFault,
                                     counters, inject, reset_counters)
from repro_torch.faults.watchdog import CollectiveWatchdog

# partitions of the fits and ranks of the sharded scenarios, as the
# reference's 8 devices
NDEV = 8
#: the scenarios of the sharded transports, run on NDEV ranks
TRANSPORT = ("wire_check_clean", "ring_garble", "hier_transient",
             "hier_garble")


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

    def transport(self, seed: int, name: str) -> str:
        """Transport scenario ``name`` of ``seed``: its rows from the NDEV
        ranks (spawned for this seed unless :meth:`run_transport` ran
        it); the detail if every rank met the outcome, else the first
        rank's violation raised as the harness reports it."""
        if (seed, name) not in self._cache:
            self.run_transport([seed])
        rows = self._cache[(seed, name)]
        for rank, (outcome, ok, detail) in enumerate(rows):
            if outcome == "ERROR":
                raise RuntimeError(f"rank {rank}: {detail}")
            if not ok:
                raise AssertionError(f"rank {rank}: {detail}")
        return (f"{rows[0][2]} (on each of {len(rows)} ranks; the spawn "
                f"of every seed's took {self._cache['spawn_s']:.1f} s)")

    def run_transport(self, seeds) -> None:
        """The transport scenarios of ``seeds`` in one spawn of NDEV
        ranks (:func:`transport_rank`), their rows cached."""
        from repro_torch import compat
        seeds = list(seeds)
        t0 = time.monotonic()
        per_rank = compat.spawn(transport_rank, NDEV, (seeds, TRANSPORT),
                                device="cpu" if self.device == "cpu"
                                else "cuda", timeout_s=120.0,
                                join_timeout_s=600.0)
        self._cache["spawn_s"] = time.monotonic() - t0
        for i, (seed, name) in enumerate((s, n) for s in seeds
                                         for n in TRANSPORT):
            self._cache[(seed, name)] = [rows[i] for rows in per_rank]

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


def scenario_handshake_flake(seed: int, ctx: Ctx) -> str:
    """handshake_flake → SURVIVED: the coordinator handshake flaps 1-2×
    and the bounded retry of the cluster join absorbs it. The real
    handshake (:func:`repro_torch.launch.cluster.join`) of a 1-process
    cluster, hosting its store on a free localhost port; the two-process
    restart runs it under ``init_cluster`` (the resume leg of
    :mod:`repro_torch.launch.multihost`)."""
    from repro_torch.launch import cluster as cl
    plan = FaultPlan.single("handshake_flake", seed)
    before = counters().get("retries", 0)
    with inject(plan) as armed:
        c = cl.join(cl.ClusterConfig(
            coordinator=f"127.0.0.1:{cl.free_port()}", num_processes=1,
            process_id=0, local_device_count=1, handshake_backoff_s=0.01,
            initialization_timeout=30))
    retried = counters().get("retries", 0) - before
    assert retried == plan.specs[0].count, \
        f"{plan.specs[0].count} flakes armed, {retried} retries"
    assert sum(armed.remaining) == 0
    assert c.process_count == 1 and c.store.num_keys() >= 1, \
        "the handshake did not complete"
    return (f"{plan.specs[0].count} flakes absorbed, handshake completed "
            "once")


# ---------------------------------------------------------------------------
# the sharded transports' scenarios: run on each rank of a spawn
# ---------------------------------------------------------------------------

class _RankCtx:
    """A rank's side of the transport scenarios: its 32 rows of the
    harness's problem, the configs and the round."""

    def __init__(self, rank):
        import torch
        from repro_torch.core import MRSVMConfig, SVMConfig
        self.rank, self.device = rank, rank.device
        X = np.random.default_rng(0).normal(size=(256, 16)).astype(np.float32)
        w = np.random.default_rng(1).normal(size=16).astype(np.float32)
        y = np.sign(X @ w).astype(np.float32)
        self.per = 256 // rank.world_size
        rows = slice(rank.rank * self.per, (rank.rank + 1) * self.per)
        self.X = torch.from_numpy(X[rows].copy()).to(self.device)
        self.y = torch.from_numpy(y[rows].copy()).to(self.device)
        self.mask = torch.ones_like(self.y)
        self.cfg = MRSVMConfig(sv_capacity=64, max_rounds=3, gamma=1e-4,
                               svm=SVMConfig(C=1.0, max_epochs=10))

    def ring_cfg(self, wire_check: bool):
        import dataclasses as dc
        return dc.replace(self.cfg, shuffle_impl="ring",
                          shuffle_wire_dtype="float32",
                          shuffle_wire_check=wire_check)

    def hier_cfg(self, wire_check: bool):
        """Two-level transport at the simulated 2-host × 4-local
        topology."""
        import dataclasses as dc
        return dc.replace(self.cfg, shuffle_impl="hier",
                          shuffle_wire_dtype="float32", hier_num_hosts=2,
                          shuffle_wire_check=wire_check)

    def build(self, cfg):
        from repro_torch.core.mapreduce_svm import (build_sharded_round,
                                                    init_sv_buffer)
        fn = build_sharded_round(cfg, self.per, device=self.device)
        return fn, init_sv_buffer(cfg.sv_capacity, self.X.shape[1],
                                  device=self.device)


def _leaves(risks, sv, w):
    return [t.cpu() for t in (risks, sv.ids, sv.x, w)]


def rank_wire_check_clean(seed: int, rc: _RankCtx) -> str:
    """No fault, integrity lane ON → the checked ring gives the
    unchecked ring's results bit for bit (the lane is free when
    honest)."""
    import torch
    outs = []
    for wire_check in (False, True):
        fn, sv = rc.build(rc.ring_cfg(wire_check))
        for _ in range(2):
            sv, risks, w, b = fn(rc.X, rc.y, rc.mask, sv)
        faults.check_finite_risks(risks.cpu().numpy(),
                                  where="clean checked ring")
        outs.append(_leaves(risks, sv, w))
    for a, b2 in zip(*outs):
        assert torch.equal(a, b2), \
            "integrity lane changed the clean ring's results"
    return "checked ring ≡ unchecked ring bit-for-bit, risks finite"


def _garbled(rc: _RankCtx, cfg, plan, what: str) -> str:
    with inject(plan) as armed:
        fn, sv = rc.build(cfg)
        sv, risks, w, b = fn(rc.X, rc.y, rc.mask, sv)
    assert armed.fired, f"the garble never fired on the {what} wire"
    try:
        faults.check_finite_risks(risks.cpu().numpy(),
                                  where=f"garbled {what} round")
    except FaultDetected as e:
        assert e.layer == "transport", f"wrong layer {e.layer!r}"
        return e.layer
    raise AssertionError(
        f"garbled {what} wire produced FINITE risks — silent corruption")


def rank_ring_garble(seed: int, rc: _RankCtx) -> str:
    """ring_garble → DETECTED: one mantissa bit flipped on one ring hop
    is caught by the wire checksum; FaultDetected names transport."""
    plan = FaultPlan.single("ring_garble", seed)
    layer = _garbled(rc, rc.ring_cfg(True), plan, "ring")
    return (f"hop {plan.specs[0].when} garble caught: [{layer}] wire "
            "checksum sentinel")


def rank_hier_transient(seed: int, rc: _RankCtx) -> str:
    """delay_round + transport_exc over the HIER transport → SURVIVED: a
    slow hop and 1-2 transient merge failures are absorbed by the
    driver's seams, which fire on every rank at the same round before
    its first collective, and the hier rounds stay bit-identical to the
    fault-free run."""
    import torch
    from repro_torch.faults.plan import (TransientFault, maybe_raise,
                                         maybe_sleep)
    from repro_torch.faults.retry import retry_with_backoff
    fn, sv0 = rc.build(rc.hier_cfg(True))

    def drive():
        sv = sv0
        for t in range(3):
            maybe_sleep("transport.round", when=t)

            def run_round():
                maybe_raise("transport.merge", kinds=("transport_exc",),
                            when=t)
                return fn(rc.X, rc.y, rc.mask, sv)

            sv, risks, w, b = retry_with_backoff(
                run_round, attempts=3, base_s=0.01,
                retry_on=TransientFault, layer="transport",
                cause=f"hier merge collective at round {t}")
        return _leaves(risks, sv, w)

    clean = drive()                     # no plan armed: the oracle
    plan = FaultPlan(seed=seed,
                     specs=(FaultPlan.single("delay_round", seed).specs
                            + FaultPlan.single("transport_exc", seed).specs))
    before = counters().get("retries", 0)
    with inject(plan) as armed:
        chaos_run = drive()
    assert armed.fired, "neither transport fault fired over hier"
    assert sum(armed.remaining) == 0, "injected failures not all raised"
    retried = counters().get("retries", 0) - before
    for a, b2 in zip(chaos_run, clean):
        assert torch.equal(a, b2), \
            "hier rounds under transient faults are NOT bit-identical"
    return (f"slow hop at round {plan.specs[0].when} + {retried} merge "
            "retries absorbed, hier rounds bit-identical")


def rank_hier_garble(seed: int, rc: _RankCtx) -> str:
    """ring_garble over the HIER transport → DETECTED: a mantissa bit
    flipped on the inter-host exchange is caught by the same checksum
    lane. At 2 simulated hosts only hop 0 shifts, so the spec pins
    ``when=None`` (the first opportunity), as the reference's does."""
    from repro_torch.faults.plan import FaultSpec
    param = int(np.random.default_rng([seed, 1093]).integers(0, 1 << 30))
    plan = FaultPlan(seed=seed, specs=(FaultSpec("ring_garble", when=None,
                                                 count=1, param=param),))
    layer = _garbled(rc, rc.hier_cfg(True), plan, "hier")
    return f"inter-host hop garble caught: [{layer}] wire checksum sentinel"


_RANK_SCENARIOS = {"wire_check_clean": ("survived", rank_wire_check_clean),
                   "ring_garble": ("detected", rank_ring_garble),
                   "hier_transient": ("survived", rank_hier_transient),
                   "hier_garble": ("detected", rank_hier_garble)}


def transport_rank(rank, seeds, names=TRANSPORT):
    """The rank target of :meth:`Ctx.run_transport`: each of ``names``
    for each seed on this rank. A scenario's collectives are the same
    on every rank, so a violation on one rank leaves the others in step.
    → [(outcome, ok, detail)] in (seed, name) order."""
    rc = _RankCtx(rank)
    rows = []
    for seed in seeds:
        for name in names:
            expect, fn = _RANK_SCENARIOS[name]
            try:
                rows.append((expect, True, fn(seed, rc)))
            except AssertionError as e:
                rows.append(("VIOLATED", False, str(e)))
            except Exception as e:
                rows.append(("ERROR", False, f"{type(e).__name__}: {e}"))
    return rows


def _transport_scenario(name: str):
    def scenario(seed: int, ctx: Ctx) -> str:
        return ctx.transport(seed, name)
    scenario.__name__ = f"scenario_{name}"
    scenario.__doc__ = _RANK_SCENARIOS[name][1].__doc__
    return scenario


scenario_wire_check_clean = _transport_scenario("wire_check_clean")
scenario_ring_garble = _transport_scenario("ring_garble")
scenario_hier_transient = _transport_scenario("hier_transient")
scenario_hier_garble = _transport_scenario("hier_garble")


SCENARIOS = [
    ("delay_round", "survived", scenario_delay_round),
    ("transport_exc", "survived", scenario_transport_exc),
    ("wire_check_clean", "survived", scenario_wire_check_clean),
    ("ring_garble", "detected", scenario_ring_garble),
    ("hier_transient", "survived", scenario_hier_transient),
    ("hier_garble", "detected", scenario_hier_garble),
    ("stall", "detected", scenario_stall),
    ("ckpt_write_fail", "survived", scenario_ckpt_write_fail),
    ("ckpt_corrupt", "detected", scenario_ckpt_corrupt),
    ("poison_rows", "survived", scenario_poison_rows),
    ("scheduler_kill", "survived", scenario_scheduler_kill),
    ("handshake_flake", "survived", scenario_handshake_flake),
]


def sweep(seeds, device: str = "cuda", only=None,
          deadline_s: float = 240.0):
    """Every scenario (whose name contains ``only``, if given) for each
    seed, under a watchdog of ``deadline_s`` a scenario. → rows
    (seed, name, expected, outcome, ok, seconds, detail)."""
    ctx = Ctx(device)
    rows = []
    if any(not only or only in n for n in TRANSPORT):
        ctx.run_transport(seeds)        # one spawn for every seed
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
    width = max(len(r[1]) for r in rows)
    print(f"\nchaos sweep: seeds={seeds} device={args.device} "
          f"({time.monotonic() - t_start:.1f}s total)")
    print(f"{'seed':>4}  {'scenario':<{width}}  {'expect':<9} "
          f"{'outcome':<9} {'t(s)':>6}  detail")
    for seed, name, expect, outcome, ok, dt, detail in rows:
        mark = "ok " if ok else "FAIL"
        print(f"{seed:>4}  {name:<{width}}  {expect:<9} "
              f"{outcome:<9} {dt:>6.1f}  [{mark}] {detail}")
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
