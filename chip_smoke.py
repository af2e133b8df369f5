#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py                 # the whole run, one card

Phases, one line or block each; any failure exits non-zero:

1. environment: torch/CUDA versions, the card, nvcc, the kernel build;
2. each CUDA kernel against its plain PyTorch version on the card, at
   small shapes and at the main path's shapes, with times and bounds;
3. the paper pipeline (corpus → TF×IDF → 2-class MapReduce SVM and OvR
   3-class) at the golden test's settings, with accuracy floors;
4. the main path at full width: svm-tfidf (d = 131072, sv_capacity
   2048, 8 partitions, bf16 rows, C = 1, max_epochs = 10, γ = 1e-4, up
   to 6 rounds) through ``fit_mapreduce``, with the kernel launch
   counts of that run.

The last two lines are the kernels' JSON record and
``{"ok": true, "device": {...}}``; before them, the card's name and
power limit as nvidia-smi gives them. ``--quick`` stops after phase 3
and prints no result.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 rate and the float32
# rate outside the tensor cores — both kernels do float32 FMAs.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12

CD_SRC = "src/repro_torch/kernels/csrc/cd_solve.cu"
HINGE_SRC = "src/repro_torch/kernels/csrc/hinge_scores.cu"
CD_TPU = "src/repro/kernels/svm_step.py:81"
HINGE_TPU = "src/repro/kernels/hinge_score.py:52"
DEV = "cuda"


def say(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def bound_ms(nbytes: float, flops: float):
    """Least time for the work on the card, and what sets it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def cuda_ms(torch, fn, reps: int, warmup: int = 1) -> float:
    """Mean device time of ``fn`` over ``reps`` calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def phase_environment(torch, build):
    say(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    say(f"[env] card: {nvidia_smi()}")
    nvcc = build.nvcc()
    ver = subprocess.run([nvcc, "--version"], capture_output=True,
                         text=True).stdout.strip().splitlines()[-1]
    say(f"[env] nvcc: {nvcc} ({ver})")
    say("[env] CUTLASS headers: " + ("present" if Path(
        "/usr/local/cutlass/include/cutlass/cutlass.h").is_file()
        else "absent"))
    secs = build.build_all()
    say(f"[env] kernel build: {secs:.1f} s (nvcc per source, in parallel)")
    for name, report in build.PTXAS_REPORT.items():
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                say(f"[env] ptxas {name}: {line.strip()}")


def _rows(torch, gen, n, d, dtype, device, density=0.05):
    """Nonnegative, L2-normalized sparse-ish rows (TF×IDF-like)."""
    X = torch.rand((n, d), generator=gen, device=device)
    X = X * (torch.rand((n, d), generator=gen, device=device) < density)
    return (X / X.norm(dim=1, keepdim=True).clamp(min=1e-9)).to(dtype)


def _labels(torch, gen, X):
    w = torch.randn(X.shape[1], generator=gen, device=X.device)
    s = X.float() @ w
    return torch.where(s >= s.median(), 1.0, -1.0)


def phase_kernels_small(torch, ops, ref):
    """cd_solve at small f32 shapes (w in shared and in global memory,
    vector and scalar loads) and in bf16 at d = 131072."""
    dev = torch.device(DEV)
    gen = torch.Generator(device=dev).manual_seed(0)
    for L, per, S, d in ((4, 200, 64, 256), (3, 96, 32, 1001),
                         (2, 64, 16, 65536)):
        xh = _rows(torch, gen, L * per, d, torch.float32, dev).reshape(L, per, d)
        xs = _rows(torch, gen, S, d, torch.float32, dev)
        y = _labels(torch, gen, torch.cat([xh.reshape(-1, d), xs]))
        y_aug = torch.cat([y[:L * per].reshape(L, per), y[L * per:].expand(L, S)], 1)
        m_aug = (torch.rand(y_aug.shape, generator=gen, device=dev) > 0.1).float()
        for epochs, tol in ((1, 1e-5), (20, 1e-4)):
            args = (xh, xs, y_aug.contiguous(), m_aug)
            kw = dict(C=1.0, tol=1e-3, max_epochs=epochs)
            a_k, w_k, b_k, t_k, v_k = ops.cd_solve(*args, **kw)
            a_p, w_p, b_p, t_p, v_p = ref.cd_solve_ref(*args, **kw)
            torch.cuda.synchronize()
            err = max(float((a_k - a_p).abs().max()),
                      float((w_k - w_p).abs().max()),
                      float((b_k - b_p).abs().max()))
            say(f"[kernels] cd_solve f32 L={L} per={per} S={S} d={d} "
                f"epochs≤{epochs}: epochs {t_k.tolist()} vs plain "
                f"{t_p.tolist()}, max|Δ(α,w,b)|={err:.2e} (atol {tol:g})")
            check(torch.equal(t_k, t_p), "cd_solve epochs differ from plain")
            check(err <= tol, f"cd_solve differs from plain by {err:.2e}")

    L, per, S, d = 8, 32, 32, 131072
    xh = _rows(torch, gen, L * per, d, torch.bfloat16, dev, 512 / d
               ).reshape(L, per, d)
    xs = _rows(torch, gen, S, d, torch.bfloat16, dev, 512 / d)
    y = _labels(torch, gen, torch.cat([xh.reshape(-1, d), xs]))
    y_aug = torch.cat([y[:L * per].reshape(L, per), y[L * per:].expand(L, S)], 1
                      ).contiguous()
    m_aug = torch.ones_like(y_aug)
    kw = dict(C=1.0, tol=1e-3, max_epochs=10)
    k = ops.cd_solve(xh, xs, y_aug, m_aug, **kw)
    p = ref.cd_solve_ref(xh, xs, y_aug, m_aug, **kw)
    Xall = torch.cat([xh.reshape(-1, d), xs])
    ones = torch.ones(Xall.shape[0], device=dev)
    r_k = ref.hinge_scores_ref(Xall, k[1], k[2], y, ones)[0] / Xall.shape[0]
    r_p = ref.hinge_scores_ref(Xall, p[1], p[2], y, ones)[0] / Xall.shape[0]
    err = float((r_k - r_p).abs().max())
    say(f"[kernels] cd_solve bf16 L={L} per={per} S={S} d={d}: hinge risk "
        f"max|Δ|={err:.2e} (atol 1e-4), epochs {k[3].tolist()} vs "
        f"{p[3].tolist()}")
    check(err <= 1e-4, f"cd_solve bf16 risk differs from plain by {err:.2e}")


def phase_pipeline(torch, T, text):
    """The golden pipeline of tests/test_paper_pipeline.py on the card."""
    from repro_torch.kernels import ops
    cfg = T.MRSVMConfig(sv_capacity=128, gamma=1e-4, max_rounds=4,
                        svm=T.SVMConfig(C=1.0, max_epochs=15))
    for classes, floor in (((-1, 1), 0.85), ((-1, 0, 1), 0.75)):
        corpus = text.generate(text.CorpusConfig(num_messages=1024,
                                                 classes=classes, seed=0))
        X, _ = text.fit_transform(text.vectorize(corpus.texts, 1024),
                                  device=DEV)
        y = torch.tensor(corpus.labels, dtype=torch.float32, device=X.device)
        ops.reset_launches()
        t0 = time.perf_counter()
        if len(classes) == 2:
            model = T.fit_mapreduce(X[:768], y[:768], 8, cfg)
            pred = T.predict(model, X[768:], cfg)
        else:
            model = T.fit_one_vs_rest(X[:768], y[:768], list(classes), 8, cfg)
            pred = model.predict(X[768:])
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        acc = float((pred == y[768:].to(pred.dtype)).float().mean())
        cm = T.confusion_matrix(y[768:], pred, list(classes))
        say(f"[pipeline] {len(classes)}-class: held-out accuracy {acc:.4f} "
            f"(floor {floor}), fit+predict {ms:.1f} ms, launches "
            f"{dict(ops.LAUNCHES)}")
        say("[pipeline] confusion matrix (% of all): "
            + json.dumps(cm.round(3).tolist()))
        check(acc > floor, f"{len(classes)}-class accuracy {acc:.4f}")
        check(min(ops.LAUNCHES.values()) > 0, "pipeline bypassed a kernel")


def time_hinge(torch, ops, ref, Xflat, yflat, mflat, W, b):
    """hinge_scores at the main path's shapes: check, time, bound."""
    n, d = Xflat.shape
    L = W.shape[0]
    loss_k, cnt_k = ops.hinge_scores(Xflat, W, b, yflat, mflat)
    loss_p, cnt_p = ref.hinge_scores_ref(Xflat, W, b, yflat, mflat)
    torch.cuda.synchronize()
    rel = float(((loss_k - loss_p).abs() / loss_p.abs().clamp(min=1e-30)).max())
    err = float((loss_k - loss_p).abs().max())
    say(f"[kernels] hinge_scores n={n} d={d} L={L} bf16: max rel "
        f"Δ={rel:.2e} (rtol 1e-4), count {float(cnt_k)} vs {float(cnt_p)}")
    check(rel <= 1e-4 and float(cnt_k) == float(cnt_p),
          "hinge_scores differs from plain")
    rerun = ops.hinge_scores(Xflat, W, b, yflat, mflat)[0]
    check(torch.equal(rerun, loss_k), "hinge_scores rerun not bit-identical")
    Wb = W.to(Xflat.dtype)
    library = lambda: torch.clamp(  # noqa: E731
        1 - yflat[:, None] * (Xflat @ Wb.T + b), min=0).mul(
        mflat[:, None]).sum(0)
    ms = cuda_ms(torch, lambda: ops.hinge_scores(Xflat, W, b, yflat, mflat), 5)
    plain = cuda_ms(torch, lambda: ref.hinge_scores_ref(Xflat, W, b, yflat,
                                                        mflat), 2)
    lib = cuda_ms(torch, library, 5)
    nbytes = n * d * Xflat.element_size() + L * d * 4 + L * 4 + 2 * n * 4 \
        + L * 4 + 4
    bms, by = bound_ms(nbytes, 2.0 * n * d * L)
    say(f"[kernels] hinge_scores: kernel {ms:.3f} ms, plain {plain:.3f} ms, "
        f"library (bf16 matmul one-liner) {lib:.3f} ms, bound {bms:.3f} ms "
        f"({by})")
    return dict(name="hinge_scores", route="cuda", source=HINGE_SRC,
                replaces=HINGE_TPU, max_abs_err=err, ms=ms, plain_ms=plain,
                bound_ms=bms, bound_by=by, library_ms=lib)


def time_cd_solve(torch, T, ops, ref, Xp, yp, maskp, cfg):
    """cd_solve at the main path's shapes: one epoch of round 0 (home
    rows + the empty SV buffer), kernel against plain."""
    L, per, d = Xp.shape
    cap = cfg.sv_capacity
    sv = T.init_sv_buffer(cap, d, Xp.dtype, Xp.device)
    y_aug = torch.cat([yp, sv.y.expand(L, cap)], 1).float().contiguous()
    m_aug = torch.cat([maskp, sv.mask.expand(L, cap)], 1).float().contiguous()
    kw = dict(C=cfg.svm.C, tol=cfg.svm.tol, max_epochs=1)
    args = (Xp, sv.x, y_aug, m_aug)
    k = ops.cd_solve(*args, **kw)
    t0 = time.perf_counter()
    p = ref.cd_solve_ref(*args, **kw)
    torch.cuda.synchronize()
    plain = 1e3 * (time.perf_counter() - t0)
    err = float((k[0] - p[0]).abs().max())
    Xflat, yflat = Xp.reshape(L * per, d), yp.reshape(L * per).float()
    mflat = maskp.reshape(L * per).float()
    r_k = ref.hinge_scores_ref(Xflat, k[1], k[2], yflat, mflat)[0] / mflat.sum()
    r_p = ref.hinge_scores_ref(Xflat, p[1], p[2], yflat, mflat)[0] / mflat.sum()
    rerr = float((r_k - r_p).abs().max())
    say(f"[kernels] cd_solve one epoch L={L} per={per} S={cap} d={d} bf16: "
        f"max|Δα|={err:.2e}, hinge risk max|Δ|={rerr:.2e} (atol 1e-4)")
    check(rerr <= 1e-4, f"cd_solve risk differs from plain by {rerr:.2e}")
    ms = cuda_ms(torch, lambda: ops.cd_solve(*args, **kw), 2)
    n = per + cap
    moved = int((p[0] != 0).sum())          # rows whose α moved → an axpy
    nbytes = (L * per + cap) * d * Xp.element_size() + 2 * L * n * 4 \
        + L * n * 4 + L * d * 4 + 3 * L * 4
    bms, by = bound_ms(nbytes, 2.0 * L * n * d + 2.0 * moved * d)
    say(f"[kernels] cd_solve: kernel {ms:.3f} ms, plain {plain:.3f} ms, "
        f"bound {bms:.3f} ms ({by}); {moved} of {L * n} rows moved α")
    return dict(name="cd_solve", route="cuda", source=CD_SRC,
                replaces=CD_TPU, max_abs_err=err, ms=ms, plain_ms=plain,
                bound_ms=bms, bound_by=by, library_ms=None)


def profile_round(torch, T, Xp, yp, maskp, sv, cfg):
    """One more round from the converged SV_global under torch.profiler:
    device time by kernel and the device's busy share of the round."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if DEV == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        out = T.mapreduce_round(Xp, yp, maskp, sv, cfg)
        out.risks.cpu()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    # Kernel rows only: an operator's row repeats its kernels' time.
    rows = sorted(((evt.self_device_time_total / 1e3, evt.count, evt.key)
                   for evt in prof.key_averages()
                   if evt.device_type == torch.autograd.DeviceType.CUDA),
                  reverse=True)
    busy = sum(r[0] for r in rows)
    say(f"[profile] one round: {wall_ms:.1f} ms host clock (profiled), "
        f"device busy {busy:.1f} ms ({100 * busy / wall_ms:.1f} %)")
    for ms, count, key in rows[:8]:
        say(f"[profile]   {ms:10.3f} ms  {count:4d}×  {key[:90]}")


def phase_full_width(torch, T, ops, ref):
    from repro_torch.configs import SVM_TFIDF
    from repro_torch.data.pipeline import svm_rows_device
    L, per, d = 8, SVM_TFIDF.rows_per_device, SVM_TFIDF.num_features
    cfg = T.MRSVMConfig(sv_capacity=SVM_TFIDF.sv_capacity, gamma=1e-4,
                        max_rounds=6,
                        svm=T.SVMConfig(C=SVM_TFIDF.C,
                                        max_epochs=SVM_TFIDF.max_epochs))
    t0 = time.perf_counter()
    X, y = svm_rows_device(L * per, d, seed=0, dtype=torch.bfloat16,
                           device=DEV)
    torch.cuda.synchronize()
    say(f"[full] data: {L * per} rows × {d} features bf16 "
        f"({X.numel() * 2 / 1e9:.2f} GB on the card) in "
        f"{time.perf_counter() - t0:.1f} s")
    Xp, yp = X.reshape(L, per, d), y.to(X.dtype).reshape(L, per)
    maskp = torch.ones_like(yp)

    cd = time_cd_solve(torch, T, ops, ref, Xp, yp, maskp, cfg)
    gen = torch.Generator(device=DEV).manual_seed(1)
    W = torch.randn((L, d), generator=gen, device=DEV) * 0.05
    b = torch.randn((L,), generator=gen, device=DEV) * 0.1
    hinge = time_hinge(torch, ops, ref, X, y, torch.ones_like(y), W, b)
    torch.cuda.synchronize()

    # --- the main path: counts from 0, one fit_mapreduce, counts read --
    ops.reset_launches()
    t0 = time.perf_counter()
    model = T.fit_mapreduce(X, y, L, cfg, verbose=True)
    torch.cuda.synchronize()
    fit_ms = 1e3 * (time.perf_counter() - t0)
    launches = dict(ops.LAUNCHES)
    for h in model.history:
        say(f"[full] round {h['round']}: R_emp={h['risk']:.6f} "
            f"|SV|={h['sv_count']} reducer={h['reducer']} "
            f"round_ms={h['ms']:.1f}")
    say(f"[full] fit_mapreduce: {model.rounds} rounds in {fit_ms:.1f} ms, "
        f"launches {launches} (cd_solve = rounds + final fit, "
        f"hinge_scores = rounds)")
    check(launches["cd_solve"] == model.rounds + 1,
          f"cd_solve launched {launches['cd_solve']} times")
    check(launches["hinge_scores"] == model.rounds,
          f"hinge_scores launched {launches['hinge_scores']} times")
    risks = [h["risk"] for h in model.history]
    check(all(math.isfinite(r) for r in risks), f"risks not finite: {risks}")
    check(model.final.w.shape == (d,) and bool(torch.isfinite(
        model.final.w).all()), "final w not finite")
    acc = float((T.predict(model, X, cfg) == y).float().mean())
    best = float((T.predict(model, X, cfg, use_final=False) == y).float().mean())
    major = float(max((y > 0).float().mean(), (y < 0).float().mean()))
    say(f"[full] training accuracy: final model {acc:.4f}, best reducer "
        f"{best:.4f}, majority class {major:.4f}")
    # The eq. 7 pick must beat the zero hypothesis (hinge risk 1) and
    # the constant majority-class predictor.
    check(float(model.risk) < 1.0, f"selected risk {float(model.risk)}")
    check(best > major, "selected hypothesis no better than the majority")
    profile_round(torch, T, Xp, yp, maskp, model.sv, cfg)
    cd["launches"] = launches["cd_solve"]
    hinge["launches"] = launches["hinge_scores"]
    return [cd, hinge]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="stop after the pipeline phase; print no result")
    args = ap.parse_args()

    import torch
    import repro_torch.core as T
    from repro_torch import text
    from repro_torch.kernels import build, ops, ref

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    t_all = time.perf_counter()
    phase_environment(torch, build)
    phase_kernels_small(torch, ops, ref)
    torch.cuda.synchronize()
    phase_pipeline(torch, T, text)
    torch.cuda.synchronize()
    if args.quick:
        say(f"[quick] done in {time.perf_counter() - t_all:.1f} s; "
            "full-width phase skipped, no result")
        return 0
    kernels = phase_full_width(torch, T, ops, ref)
    torch.cuda.synchronize()
    say(f"[done] {time.perf_counter() - t_all:.1f} s")
    print(nvidia_smi())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
