#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py                 # the whole run, one card
    python3 chip_smoke.py --variants [flash_decode] [cd_solve]
                          [cd_solve_sparse]   # build variants, timed (all
                                              # three when none is named);
                                              # no result
    python3 chip_smoke.py --sharded       # the sharded phases; no result
    python3 chip_smoke.py --cluster       # the cluster phases; no result
    python3 chip_smoke.py --models        # flash_decode's small shapes and
                                          # the LM configs; no result
    python3 chip_smoke.py --tp            # [tp-serve-full] only; no result
    python3 chip_smoke.py --dryrun        # [dryrun] only; no result

Phases, one line or block each; any failure exits non-zero:

1. environment: torch/CUDA versions, the card, nvcc, the kernel build;
2. each CUDA kernel against its plain PyTorch version on the card at
   small shapes: ``cd_solve`` on both routes (one CTA a job; one
   cluster of 8 or 16 CTAs a job, one row a job, and d = 131072 with a
   few rows a job, with the clusters' occupancy and bit-identical
   reruns);
   ``gram``, ``sparse_gram`` and
   ``cd_solve_gram`` in f32 and bf16, linear/rbf/poly, ragged edges,
   padding slots, masked rows and (home, shared) job rows, with the bf16
   tensor-core ``gram`` at its tile edges and on its symmetric route;
   ``hinge_scores`` on both routes (f32 SIMT, bf16 tensor cores) over
   ragged n, d and L, masks with zeros and W from 1e-30 to 1e3;
   ``sparse_gram``'s fused scores route (per-job and shared Z, f32 and
   bf16 coefficients); ``cd_solve_gram`` within 1e-5 of plain on K as
   the Gram kernels return it, and bit for bit on K made exactly
   symmetric, on the rule's cluster and on 1, 2 and 16 CTAs a job (one
   row a job, a job that stops first), and one job of 11776 rows, above
   the one-CTA cap of earlier versions; ``cd_solve/sparse`` and
   ``hinge_scores/sparse`` (blocked-CSR rows on the linear path) in f32
   and bf16 values, ``nnz_cap`` 1, 7, 32, 256 and 300, padding slots
   beside a real column 0, masked rows, dead SV slots, S = 0, per = 1,
   a job that stops first, heavy overlap (every row on the same
   columns; the golden text rows), L 1, 8 and 9, W from 1e-30 to 1e3 and
   W as the sparse solve returns it; each bit for bit against its
   emulation (``svm_step.emulate_sparse_lookahead``,
   ``hinge_score.emulate_sparse``, run on the CPU); a column id ≥ d
   refused before any launch, fresh or changed in place after a check;
   the sweep axis's per-job C, tol and epoch cutoffs (one at 0) of
   ``cd_solve`` (both dense routes and ``cd_solve/sparse``) and
   ``cd_solve_gram``, and per-job γ and coef0 of ``gram`` and
   ``sparse_gram`` over a stack of shared blocks: one launch of all jobs
   against one launch a job on its own rows, and against plain;
3. the paper pipeline (corpus → TF×IDF → 2-class MapReduce SVM and OvR
   3-class) at the golden test's settings, with accuracy floors, on the
   linear path; then on ``vectorize_sparse(…, nnz_cap=32)`` rows through
   the two sparse routes only, with R_emp per round within 1e-4 of the
   dense fit on the same rows, and ``update_mapreduce`` of that 2-class
   model on the held-out rows and χ² ``select_top_k`` each on the card
   and on the CPU with the same inputs;
4. the golden pipeline on the Gram path (rbf, γ = 1): dense rows with
   ``gram_impl="pallas"`` (2-class and OvR 3-class) and blocked-CSR rows
   (``nnz_cap`` 32) with ``"pallas_sparse"`` (2-class), with floors
   and each kernel's launch count; then ``[sweep]``, the sweep axis at
   the golden settings: linear dense and ``nnz_cap`` 32 rows over C ×
   tol, an epoch-cutoff grid with one config at 0, the rbf C × γ grid on
   ``gram`` and on ``sparse_gram``, OvR 3-class and per-job rows, each
   one solve launch a round for all its jobs (counted), each config
   against its sequential fit on the card (rounds, picks, SV ids, R_emp
   per round within 1e-6, w and b or the final α bit for bit) and each
   sweep against the plain versions on the CPU;
5. slice 1's main path at full width: svm-tfidf (d = 131072,
   sv_capacity 2048, 8 partitions × 8192 rows, bf16 rows, C = 1,
   max_epochs = 10, γ = 1e-4, up to 6 rounds), linear, through
   ``fit_mapreduce``, with ``cd_solve`` (the cluster route, checked,
   rerun, timed against clusters of 16 and one CTA a job) and
   ``hinge_scores`` timed at its shapes and the launch counts of that
   run; then ``[full-sweep]``: the same rows over C = logspace(-2, 1, 4)
   (the reference launcher's ``--sweep 4``) through
   ``fit_mapreduce_sweep``, one ``cd_solve/cluster`` launch of 32 jobs a
   round (the waves a round printed), C = 1 ≡ the fit above, its time
   beside 4 × the fit's, one sweep round under
   ``no_implicit_host_sync``;
6. ``gram`` at one full-width reducer shape (10240 × 10240 × 131072
   bf16, rbf and linear) on the tensor-core route's upper triangle (K
   must equal its transpose), against its plain version and the bf16
   matmul route, one call profiled; the f32 SIMT route timed at the
   golden Gram shape;
7. slice 2's main path at full width: the same svm-tfidf shapes as
   blocked-CSR rows (``nnz_cap`` = row nnz = 256, f32 values), rbf
   (γ = 1) on the Gram path with ``gram_impl="pallas_sparse"``, with the
   launch counts and routes of that run (one fused eq. 7 launch a
   round), then ``sparse_gram`` (the reducer Gram), ``cd_solve_gram``
   on it (α bit for bit against plain, the rule's cluster against other
   sizes) and eq. 7 through the fused scores route over all 65536 query
   rows (its peak memory read) checked and timed, and one round
   profiled; last, the same fit with rbf at γ = 8 and with the linear
   kernel on the Gram path, whose eq. 7 picks must beat the majority
   class (the rbf pick at γ = 1 only matches it); and
   ``[full-kernel-sweep]``, γ ∈ {1, 8} as one S = 2 sweep (16 jobs a
   solve and a Gram launch), each config ≡ its fit above;
7b. slice 7's main path at full width (``[full-sparse]``): the same
   svm-tfidf shapes as blocked-CSR rows with bf16 values on the linear
   path, every solve on ``cd_solve/sparse`` and every eq. 7 on
   ``hinge_scores/sparse`` (counted), the eq. 7 pick above the majority
   share; one epoch of ``cd_solve/sparse`` (and its prep kernel alone)
   and ``hinge_scores/sparse`` (W as the solve returns it, and as rows
   the wrapper packs first) checked and timed against plain, the bound and (for the hinge)
   ``torch.sparse.mm``; one round under
   ``no_implicit_host_sync`` and one profiled; last,
   the rows densified (17.2 GB) and fit on the dense linear path, which
   must pick the same reducers and keep the same SV ids, with R_emp per
   round within 1e-4 (the paths differ only in Q_ii, whose Σ v² the
   reference rounds to bf16 on blocked-CSR rows); before that,
   ``[full-sparse-sweep]``: the S = 4 grid of phase 5 on these rows, one
   ``cd_solve/sparse`` call of 32 jobs a round, C = 1 ≡ the fit above,
   one sweep round under ``no_implicit_host_sync``;
8. slice 3, the LM serve path: ``flash_decode`` against its plain
   version at small shapes (f32 and bf16 — the SIMT and the
   tensor-core route, each route's launches counted —, valid_len 0, 1,
   partial and S, a ragged S = 1000, more than 8 heads a group, K/V
   past valid_len set to ±99, a rerun) with phase 2; the smoke serve of tinyllama-1.1b through the port's CLI
   code path (batch 4, cache 256, 16 tokens, the same tokens as the
   plain versions on the CPU) after phase 4; last, tinyllama-1.1b at
   full width in bf16 (batch 32, cache 32768 filled with seeded random
   K/V, 16 greedy tokens through ``serve_lm``, every launch on the
   tensor-core route) with ``flash_decode`` timed at one layer's shape
   in turns with the library call and the SIMT route, one step under
   ``no_implicit_host_sync``, the kernel route against
   the plain route and one step profiled;
9. slice 10, the serving layer: after the smoke serve, ``[stream-smoke]``
   (the --smoke svm-tfidf serve through the port's CLI, 2 streams × 2
   waves, against the same batches through the plain versions on the
   CPU) and ``[sched-smoke]`` (the decode ``BatchScheduler`` at
   ``smoke_variant`` against the CPU, token for token); before the
   full-width LM serve, ``[stream-full]`` (``serve_svm`` at the
   svm-tfidf width: 4 streams × 3 waves of 8192 bf16 rows on the
   background scheduler's stream, the streams submitting one after
   another as in the reference's launcher, so a wave may fold as
   several sweeps; wave 1's widest solve call (a real tenant's jobs)
   and first hinge_scores call against the plain versions, and each
   tenant ≡ its ``update_mapreduce`` bit for bit; per wave its time,
   rows/s, latencies, folds and launches by route; a wave profiled;
   predicts from the main thread while wave 3 folds, each ≡ the predict
   of the version it reports), ``[stream-full-mixed]`` (2 dense and 2
   blocked-CSR tenants as one wave of two fold groups, its host syncs
   counted, then 3 + 3 tenants, each group padded to 4 jobs; every
   tenant ≡ its ``update_mapreduce``, each padding job's solve ≡ plain,
   a blocked-CSR tenant's solve and the blocked-CSR hinge_scores
   against plain) and ``[sched-full]`` (the scheduler at
   tinyllama-1.1b's width, bf16, batch 4, cache 512, 10 requests; every
   ``flash_decode`` launch on the tensor-core route, one step's calls
   against plain). Each kernel row's ``launches`` is its main path's
   count; ``launches_by_path`` adds these paths' counts beside it;
10. slice 12, the sharded round (``build_sharded_round`` on
   ``torch.distributed``): after ``[chaos]`` (whose four transport
   scenarios run on 8 ranks), ``[sharded-small]`` (the golden rows on 8
   ranks sharing the card over gloo: allgather, ring and hier × dense,
   blocked-CSR and ``use_gram`` rows with psum, and on dense rows with
   tree, each ≡ the functional round on the card, ring and hier ≡
   allgather bit for bit;
   then W = 1 on NCCL, a round of each transport under
   ``no_implicit_host_sync``); after phase 7b, ``[sharded-full]``
   (svm-tfidf at full width, 8 ranks × 8192 rows, each making only its
   own rows, dense bf16 and blocked-CSR rows on ``ring`` and
   ``allgather``, 2 rounds each (3 until slice 17): SV ids and α bit for
   bit with 2 functional rounds on the same rows, risks within 1e-5; a round-0
   solve and hinge_scores call of each format (ranks 0 and 1) against
   plain; round ms split
   into solve, merge and eq. 7, the bytes a rank ships), whose launches
   over the ranks go into ``launches_by_path["sharded-full"]``.
   ``--sharded`` runs only the sharded phases (these and slice 13's)
   after the build;
11. slice 13, the sharded sweep (``build_sharded_sweep_round`` /
   ``run_sharded_sweep``): ``[sharded-sweep-small]`` in
   ``[sharded-small]``'s spawn (the golden rows, S = 4 configs that
   converge at different rounds: allgather, ring and hier with the dedup
   state, blocked-CSR rows, 4 streams of per-config rows, bf16 rows on a
   bf16 wire, a state saved after round 1 and resumed; each ≡ the port's
   functional sweep on the card, ring and hier ≡ allgather bit for bit,
   one solve launch of S jobs a round on each rank; then a W = 1 NCCL
   sweep round on the ring under ``no_implicit_host_sync``); after
   ``[sharded-full]``, ``[sharded-sweep-full]`` (svm-tfidf width, 8
   ranks × 8192 rows, C = logspace(-2, 1, 4), 2 rounds: blocked-CSR
   rows through ``fit_sharded_sweep`` on ring and allgather, dense bf16
   rows on ring round by round, and the per-stream wave of 4 tenants ×
   (8192 + 2048) rows; each config's SV ids and α bit for bit with the
   functional sweep every round on every rank, risks within 1e-5; the
   round split into solve, merge and eq. 7, the bytes a rank ships, each
   rank's peak memory; a solve and a hinge_scores call of each part
   against plain), whose launches go into
   ``launches_by_path["sharded-sweep-full"]``;
12. slice 14, the cluster launch (2 OS processes × 4 ranks sharing the
   card over gloo, joined through ``init_cluster`` and process 0's TCP
   store): after ``[sharded-small]``, ``[cluster-small]`` (the package's
   multi-process harness ``repro_torch.launch.multihost``: the round on
   allgather, ring and hier (2 hosts, counted from the processes) on
   dense and blocked-CSR rows ≡ the functional round on the card; a
   killed process 1 and process 0's exit 17 with a typed heartbeat; a
   flaky handshake absorbed and the sweep resumed bit for bit from the
   newest and, past a corrupted one, the previous generation; no rank
   outliving its process); after ``[sharded-sweep-full]``,
   ``[cluster-full]`` (``python -m repro_torch.launch.train --arch
   svm-tfidf --rounds 3`` at full width as the two processes, plain and
   with ``--sweep 4``, each bit for bit with the same runs through
   ``compat.spawn``; start-up, handshake, the round split, MB a rank,
   peak memory), whose launches go into
   ``launches_by_path["cluster-full"]``. ``--cluster`` runs only these
   two after the build.

13. slice 15, the invariant linter (``repro_torch.analysis``): after
   ``[chaos]``, ``[lint]`` (the self-test on the card, with a seeded
   ``.item()`` that must raise inside ``no_implicit_host_sync``, and the
   dynamic rules at the lint shapes on the card); ``[full-sweep]``,
   ``[full-sparse-sweep]`` and ``[full-kernel-sweep]`` run with
   ``fail_on_retrace=True``, ``[stream-full]`` under the service's
   retrace guard (``retraces`` must be 0), ``[full-sparse]`` holds one
   blocked-CSR round's peak memory under one dense copy of a job's rows
   (``check_memory_ceiling``), and ``[sharded-small]`` /
   ``[sharded-sweep-small]`` hold every rank's recorded collective
   schedule valid and equal on all 8 ranks.

14. slice 16, the dense and VLM forward pass: ``flash_decode``'s small
   shapes add hd 128 at G = 6, 7 and 16 (phase 8); last, ``[model-full]``
   takes tinyllama-1.1b, qwen2-1.5b, chatglm3-6b, llama3-8b and
   llava-next-34b at full width, one at a time (seeded random bf16
   weights, freed before the next): the prefill step and the loss at
   batch 3 × 4096 positions (llava: 576 stub prefix embeddings + 3520
   tokens; the loss in chunks of 8192 tokens, the last padded), one
   layer's attention beside scaled_dot_product_attention (information),
   32 teacher-forced decode steps on the kernel route against the
   forward's logits with controls, then ``[serve-full]`` at the config's
   width (tinyllama-1.1b, qwen2-1.5b and chatglm3-6b batch 32, llama3-8b
   batch 8, cache 32768; llava batch 4, cache 4096, a stated cut); on
   qwen2-1.5b's weights ``[embed-full]``, ``examples/torch_embed_svm.py``
   on the full-width backbone (800 messages → bf16 rows of d 1536), the
   kernel fit held to the plain fit on the card. The flash_decode row is
   tinyllama-1.1b's serve, the other configs' under ``configs``; their
   launches go into ``launches_by_path``. ``--models`` runs only these
   (and phase 15) and the small flash_decode shapes after the build.

15. slice 17, LM training on one process: ``[model-full]``'s prefill is
   ``launch.steps.build_prefill_step``; then ``[train-full]`` takes
   tinyllama-1.1b and qwen2-1.5b at full width and depth (bf16, seeded
   random weights, f32 AdamW moments), one at a time:
   ``build_train_step`` with remat at batch 3 × 4096 (a stated cut of
   train_4k's 256); the bf16 gradients against the same batch's on f32
   copies of the weights (cosines, with another batch as the control),
   one AdamW step against float64 on the host on three leaves, then a
   warm step and 3 steps on one batch under ``no_implicit_host_sync``
   (losses falling, no kernel launched), with step ms, tokens/s, the
   optimizer's ms, peak memory and the bf16 operations bound. Last,
   ``[train-backbone]``: ``examples/torch_train_backbone.py --preset
   100m`` for 20 steps, then ``--resume`` for 80 more.

16. slice 18, the MoE family: ``flash_decode``'s small shapes add G 16
   at hd 64 (qwen3-moe's group); ``[model-full]`` adds mixtral-8x22b
   and qwen3-moe-235b-a22b at full width, every expert and the config's
   top-k, full vocabulary, bf16, depth cut to 4 layers (a stated cut):
   the forward and loss at 3 × 4096 (aux finite and > 0, the prefill
   under ``no_implicit_host_sync``), the teacher-forced decode against
   the forward at capacity factor E / K (C = T) over the positions routed
   alike in every layer, and a 16-step ``[serve-full]`` at batch 32 and
   the config's capacity factor 1.25, with the share of assignments past
   capacity printed per step (the serve run again from the same cache
   with the routing recorded); mixtral's sliding window decodes on the
   ring route, with no kernel, so it adds no flash_decode row, config or
   launches. Every model's step and decode checks compare the rows
   routed alike (all rows without experts). ``[moe-sharded]``, in
   ``[sharded-full]``'s spawn: one qwen3-moe layer at full width through
   ``apply_moe_sharded`` on 2 data × 4 model ranks over gloo against
   ``apply_moe`` on one rank.

17. slice 19, the SSM, hybrid and encoder-decoder families:
   ``flash_decode``'s small shapes add G 1 at hd 64 (zamba2-1.2b's 32
   and whisper-base's 8 heads); ``[model-full]`` adds rwkv6-7b,
   zamba2-1.2b and whisper-base at full width and depth, bf16: the
   forward and loss at 3 × 4096 (whisper: 3 × 1500 stub frames and 448
   decoder tokens), one attention beside SDPA (zamba2's shared block,
   whisper's encoder), the teacher-forced decode against the forward
   over 256 tokens (rwkv6, zamba2: in float32, several chunks, controls
   that reset the state, force the decay to 1 and drop the token shift
   or the conv buffer; zamba2 also the attention controls) or 32
   (whisper, bf16, with the cross K/V of the same frames), and a 16-step
   ``[serve-full]`` at batch 32: rwkv6 from a random state (no cache, no
   kernel), zamba2 at cache 32768 (its two shared-block applications'
   17.2 GB of KV), whisper at its 448-token cap; ``flash_decode`` at
   both G 1 shapes against plain, SDPA and its SIMT route, its launches
   under ``configs`` and ``launches_by_path``.

18. slice 20, tensor- and data-parallel LM serving on ranks: after
   ``[model-full]``, ``[tp-serve-full]``: chatglm3-6b at full width and
   depth, bf16, seeded random weights, on a 1 × 4 mesh of ranks over
   gloo on this card (kv_repeat 2: a rank decodes 8 query heads over 1
   cache head, G 8, hd 128), batch 32, cache 8192 (a stated cut), 16
   greedy steps from seeded distinct first tokens through
   ``serve_lm(mesh=)``, held to the one-rank kernel-route ``serve_lm``
   of the same weights, cache and tokens run first here and freed
   (teacher-forced logits within the serve step's swap limit a layer,
   with two controls: one rank's heads alone in the attention sum,
   valid_len a chunk short; tokens equal where the margin exceeds the
   difference); one rank step under ``no_implicit_host_sync``; then, on
   the same ranks, the same weights in float32 with seeded q/k/v biases,
   4 teacher-forced steps at batch 4 over a 16-slot cache against the
   one-rank float32 run within 1e-4 of max |logit|, with three controls
   each on one rank (two heads swapped in wo, the q bias shard dropped,
   the new K/V cut from the next rank's block); ms a step
   per rank against the one-rank step and the per-rank bytes bound
   (``launch.costs`` beside it), peak memory a rank, ``flash_decode``
   launches by route over the ranks (the flash_decode row's
   ``configs`` and ``launches_by_path``), and ``flash_decode`` at a
   rank's shape (B 32, H 8, KV 1, S 8192, hd 128) against plain, SDPA
   and its SIMT route. In the same spawn, first, the data axis at smoke
   width: chatglm3's smoke variant on 2 × 2 ranks (FSDP gathers, the
   batch split) against its one-rank run on the CPU, token for token.
   ``--tp`` runs only this phase after the build.

19. slice 21, the dry run (``repro_torch.launch.dryrun``) on ``fake``
   process groups of 256 and 512 ranks: after ``[tp-serve-full]``,
   ``[dryrun]``: shape-only on the host, svm-tfidf's round, sweep (8
   configs) and serve wave (4 streams) on allgather and hier, the ring
   sweep with ``--processes 2`` and tinyllama-1.1b's decode_32k on
   2 × 16 × 16; then, shape-only and rank 0 run for real on this card
   (two runs; what the other ranks would send is whatever the fake
   group leaves), on the 16 × 16 mesh: the dense ring round (8192 bf16
   rows of d 131072 and the 2048-row SV buffer), the dense ring sweep,
   the ring serve wave (4 × 640 rows), the ring ``sparse256`` sweep and
   llama3-8b's decode_32k (its (32, 8, 1, 32768, 128) cache slice and
   weight shards); each step's launches by route equal twice its shape
   rules' count, job 0 of its first ``cd_solve`` (every epoch the step
   ran; not the round's, ``DRYRUN_SOLVE_CHECKED``) and its first
   ``hinge_scores`` against plain, ``flash_decode`` at llama3-8b's rank
   (B 8, H 2, KV 1, S 32768, hd 128) against plain, SDPA and its SIMT
   route; each measured peak within 0.8–1.25 of its reckoning, with a
   control that must fall outside: the arguments alone for the svm
   steps, the reckoning at 8 × 16 ranks for the decode step (whose batch
   a rank then doubles; an svm rank's rows do not move with it); last
   ``lint --artifacts`` over the phase's svm records. The launches go
   into ``launches_by_path["dryrun"]``, the decode shape into the
   flash_decode row's ``configs``. ``--dryrun`` runs only this phase
   after the build.

The last two lines are the kernels' JSON record and
``{"ok": true, "device": {...}}``; before them, the card's name and
power limit as nvidia-smi gives them. ``--quick`` stops after phase 4
and the smoke serves, and prints no result.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 rate, the float32
# rate outside the tensor cores and the bf16 tensor-core rate.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12
# special-function results (exp) a second: 132 SMs × 16 a clock × the
# 1980 MHz boost clock (NVIDIA Hopper architecture white paper)
SFU_PER_S = 132 * 16 * 1.98e9

CD_SRC = "src/repro_torch/kernels/csrc/cd_solve.cu"
HINGE_SRC = "src/repro_torch/kernels/csrc/hinge_scores.cu"
CD_TPU = "src/repro/kernels/svm_step.py:81"
HINGE_TPU = "src/repro/kernels/hinge_score.py:52"
GRAM_SRC = "src/repro_torch/kernels/csrc/gram.cu"
GRAM_TPU = "src/repro/kernels/gram.py:83"
SPARSE_SRC = "src/repro_torch/kernels/csrc/sparse_gram.cu"
SPARSE_TPU = "src/repro/kernels/gram.py:201"
CDG_SRC = "src/repro_torch/kernels/csrc/cd_solve_gram.cu"
CDG_TPU = "src/repro/core/svm.py:279 (no TPU kernel: XLA loop)"
FD_SRC = "src/repro_torch/kernels/csrc/flash_decode.cu"
FD_TPU = "src/repro/kernels/decode_attention.py:70"
CDS_SRC = "src/repro_torch/kernels/csrc/cd_solve_sparse.cu"
CDS_TPU = "src/repro/core/svm.py:154 (no TPU kernel: XLA loop)"
HS_SPARSE_TPU = "src/repro/core/mapreduce_svm.py:243 (no TPU kernel: XLA " \
    "gathers)"
KERNEL_PATH_LAUNCHES = ("gram", "sparse_gram", "cd_solve_gram")
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


def bound_ms(nbytes: float, flops: float, flop_rate: float = F32_FLOP_PER_S):
    """Least time for the work on the card, and what sets it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flop_rate * 1e3
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


def _demangle(name: str) -> str:
    """A kernel's name and template arguments, without its parameters
    (``c++filt`` where the toolkit's host has it)."""
    try:
        out = subprocess.run(["c++filt", name], capture_output=True,
                             text=True).stdout.strip()
    except OSError:
        return name
    out = (out or name).replace("(anonymous namespace)::", "")
    return out.removeprefix("void ").split("(")[0]


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
        entry = "?"
        for line in report.splitlines():
            if "Compiling entry function" in line and "'" in line:
                entry = _demangle(line.split("'")[1])
            elif "registers" in line or "spill" in line:
                say(f"[env] ptxas {name} {entry}: {line.strip()}")


def _rows(torch, gen, n, d, dtype, device, density=0.05):
    """Nonnegative, L2-normalized sparse-ish rows (TF×IDF-like)."""
    X = torch.rand((n, d), generator=gen, device=device)
    X = X * (torch.rand((n, d), generator=gen, device=device) < density)
    return (X / X.norm(dim=1, keepdim=True).clamp(min=1e-9)).to(dtype)


def _labels(torch, gen, X):
    w = torch.randn(X.shape[1], generator=gen, device=X.device)
    s = X.float() @ w
    return torch.where(s >= s.median(), 1.0, -1.0)


def _launch_kw(torch, ops, kw, jobs, device):
    """``kw``'s C, tol and max_epochs as the launchers take them: (jobs,)
    tensors on the card."""
    return (ops.job_values(kw["C"], jobs, device),
            ops.job_values(kw["tol"], jobs, device),
            ops.job_values(int(kw["max_epochs"]), jobs, device, torch.int32))


def _cd_run(ops, args, kw, c):
    """cd_solve through ``ops.cd_solve`` (c None: the rule's size, the
    launch counted) or forced onto c CTAs a job (1: the single route)
    through its launcher, uncounted."""
    if c is None:
        return ops.cd_solve(*args, **kw)
    import torch
    from repro_torch.kernels.svm_step import launch_cd_solve
    return launch_cd_solve(*args, *_launch_kw(torch, ops, kw, args[2].shape[0],
                                              args[2].device), c)


def _cd_routes(torch, ops, ref, args, kw, tag, tol, sizes):
    """cd_solve on each cluster size of ``sizes`` (None: the rule's)
    against its plain version: the same epochs, max|Δ(α, w, b)| ≤ tol,
    the rule's route counted, a bit-identical rerun."""
    plain = ref.cd_solve_ref(*args, **kw)
    L, per, d = args[0].shape
    rule = ops.cd_solve_cluster_size(per + args[1].shape[0], d, args[0].dtype)
    for c in sizes:
        ops.reset_launches()
        k = _cd_run(ops, args, kw, c)
        torch.cuda.synchronize()
        route = _routes(ops, "cd_solve")
        err = max(float((a - b).abs().max()) for a, b in zip(k[:3], plain[:3]))
        say(f"[kernels] cd_solve {tag} c={c or f'{rule} (the rule)'}: routes "
            f"counted {route}, epochs {k[3].tolist()} vs plain "
            f"{plain[3].tolist()}, max|Δ(α,w,b)|={err:.2e} (atol {tol:g})")
        check(torch.equal(k[3], plain[3]), "cd_solve epochs differ from plain")
        check(err <= tol, f"cd_solve differs from plain by {err:.2e}")
        if c is None:
            want = "cluster" if rule > 1 else "single"
            check(route[want] == 1, f"cd_solve {tag} took {route}")
        again = _cd_run(ops, args, kw, c)
        check(all(torch.equal(a, b) for a, b in zip(k, again)),
              f"cd_solve {tag} c={c}: rerun not bit-identical")
    return plain


def phase_kernels_small(torch, ops, ref):
    """cd_solve at small f32 shapes on both routes (single: w in shared
    and in global memory, vector and scalar loads; cluster: d = 65536,
    8 (the rule's) and 16 CTAs a job, and one row a job), then in bf16
    at d = 131072 with a few rows a job on clusters of 8 (the rule's)
    and 16 and on one CTA (the full-width fit's route, cheaply), each
    with a bit-identical rerun."""
    from repro_torch.kernels import svm_step
    dev = torch.device(DEV)
    gen = torch.Generator(device=dev).manual_seed(0)
    for c in (8, 16):
        resident = svm_step.max_active_clusters(torch.bfloat16, 131072,
                                                10240, c)
        say(f"[kernels] cd_solve cluster route d=131072 bf16, 10240 rows, "
            f"c={c}: {resident} clusters can be resident at once")
    for L, per, S, d in ((4, 200, 64, 256), (3, 96, 32, 1001),
                         (2, 64, 16, 65536), (2, 1, 0, 65536)):
        xh = _rows(torch, gen, L * per, d, torch.float32, dev).reshape(L, per, d)
        xs = _rows(torch, gen, S, d, torch.float32, dev)
        y = _labels(torch, gen, torch.cat([xh.reshape(-1, d), xs]))
        y_aug = torch.cat([y[:L * per].reshape(L, per), y[L * per:].expand(L, S)], 1)
        m_aug = (torch.rand(y_aug.shape, generator=gen, device=dev) > 0.1).float()
        sizes = (None, 16) if (d, per) == (65536, 64) else (None,)
        for epochs, tol in ((1, 1e-5), (20, 1e-4)):
            args = (xh, xs, y_aug.contiguous(), m_aug)
            kw = dict(C=1.0, tol=1e-3, max_epochs=epochs)
            _cd_routes(torch, ops, ref, args, kw, f"f32 L={L} per={per} "
                       f"S={S} d={d} epochs≤{epochs}", tol, sizes)

    L, per, S, d = 8, 32, 32, 131072
    xh = _rows(torch, gen, L * per, d, torch.bfloat16, dev, 512 / d
               ).reshape(L, per, d)
    xs = _rows(torch, gen, S, d, torch.bfloat16, dev, 512 / d)
    y = _labels(torch, gen, torch.cat([xh.reshape(-1, d), xs]))
    y_aug = torch.cat([y[:L * per].reshape(L, per), y[L * per:].expand(L, S)], 1
                      ).contiguous()
    m_aug = torch.ones_like(y_aug)
    kw = dict(C=1.0, tol=1e-3, max_epochs=10)
    Xall = torch.cat([xh.reshape(-1, d), xs])
    ones = torch.ones(Xall.shape[0], device=dev)
    args = (xh, xs, y_aug, m_aug)
    p = _cd_routes(torch, ops, ref, args, kw,
                   f"bf16 L={L} per={per} S={S} d={d}", 1e-3, (None, 16, 1))
    r_p = ref.hinge_scores_ref(Xall, p[1], p[2], y, ones)[0] / Xall.shape[0]
    for c in (None, 16):
        k = _cd_run(ops, args, kw, c)
        r_k = ref.hinge_scores_ref(Xall, k[1], k[2], y, ones)[0] \
            / Xall.shape[0]
        err = float((r_k - r_p).abs().max())
        say(f"[kernels] cd_solve bf16 L={L} per={per} S={S} d={d} "
            f"c={c or 'the rule'}: hinge risk max|Δ|={err:.2e} (atol 1e-4), "
            f"epochs {k[3].tolist()} vs {p[3].tolist()}")
        check(err <= 1e-4,
              f"cd_solve bf16 risk differs from plain by {err:.2e}")


def _rel(a, b) -> float:
    """max |a − b| / (1 + |b|), in float32."""
    a, b = a.float(), b.float()
    return float(((a - b).abs() / (1.0 + b.abs())).max()) if b.numel() \
        else 0.0


GRAM_KINDS = (("linear", {}), ("rbf", dict(gamma=0.5)),
              ("poly", dict(gamma=0.5, coef0=-0.3, degree=3)),
              ("poly", dict(gamma=1.0, coef0=1.0, degree=2)))


def _routes(ops, kernel: str) -> dict:
    return {k.split("/")[1]: v for k, v in ops.ROUTE_LAUNCHES.items()
            if k.startswith(kernel + "/")}


def _gram_tile_edges(torch, ops, ref, dense) -> float:
    """The bf16 tensor-core route at its tile edges (n, m around 128;
    d % 64 ≠ 0, with whole 16-byte chunks and without), its symmetric
    route as gram(X, X) and as ((H, S), (H, S)) with the home/shared
    boundary inside a tile, and the general route on equal-valued
    copies. A symmetric K must equal its transpose bit for bit. → the
    worst max |Δ|/(1 + |K|) against plain."""
    worst = 0.0
    for d in (200, 1001):
        for n, m in ((127, 129), (128, 257), (129, 128), (257, 127)):
            X, Z = dense(n, d, torch.bfloat16), dense(m, d, torch.bfloat16)
            for kind, kw in GRAM_KINDS:
                worst = max(worst, _rel(ops.gram(X, Z, kind=kind, **kw),
                                        ref.gram_ref(X, Z, kind=kind, **kw)))
        for n in (127, 128, 129, 257):
            X = dense(n, d, torch.bfloat16)
            for kind, kw in GRAM_KINDS:
                K = ops.gram(X, X, kind=kind, **kw)
                check(torch.equal(K, K.T), f"gram(X, X) n={n} d={d} {kind} "
                      "is not symmetric")
                worst = max(worst, _rel(K, ref.gram_ref(X, X, kind=kind,
                                                        **kw)))
        H = dense(3 * 100, d, torch.bfloat16).reshape(3, 100, d)
        S = dense(57, d, torch.bfloat16)          # rows 100..156: in a tile
        Hc, Sc = H.clone(), S.clone()
        for kind, kw in GRAM_KINDS:
            plain = ops.per_job(ref.gram_ref, (H, S), (H, S), kind=kind, **kw)
            K = ops.gram((H, S), (H, S), kind=kind, **kw)
            check(torch.equal(K, K.transpose(1, 2)),
                  f"gram((H, S), (H, S)) d={d} {kind} is not symmetric")
            worst = max(worst, _rel(K, plain),
                        _rel(ops.gram((H, S), (Hc, Sc), kind=kind, **kw),
                             plain))
    return worst


def phase_hinge_small(torch, ops, ref):
    """hinge_scores against its plain version at small shapes on both
    routes (f32 rows: SIMT; bf16: tensor cores): n ∈ {1, 63, 65, 1000},
    d ∈ {24, 1001, 4096}, L ∈ {1, 5, 8, 11} (11 is two launches), masks
    with zeros, and W entries of magnitudes from 1e-30 to 1e3 (the three
    bf16 planes of the tensor-core route); equal counts and
    bit-identical reruns; the planes kernel ≡ ``split_planes``."""
    from repro_torch.kernels import hinge_score as hs
    dev = torch.device(DEV)
    gen = torch.Generator(device=dev).manual_seed(6)
    for dtype, route in ((torch.float32, "simt"),
                         (torch.bfloat16, "tensor_core")):
        tag = "f32" if dtype == torch.float32 else "bf16"
        ops.reset_launches()
        worst, cases = 0.0, 0
        for n in (1, 63, 65, 1000):
            y = torch.where(torch.rand((n,), generator=gen, device=dev) > 0.5,
                            1.0, -1.0)
            m = (torch.rand((n,), generator=gen, device=dev) > 0.25).float()
            for d in (24, 1001, 4096):
                X = torch.randn((n, d), generator=gen, device=dev).to(dtype)
                for L in (1, 5, 8, 11):
                    mag = torch.empty((L, d), device=dev).uniform_(
                        -30.0, 3.0, generator=gen)
                    W = torch.randn((L, d), generator=gen, device=dev) \
                        * 10.0 ** mag
                    b = torch.randn((L,), generator=gen, device=dev)
                    if route == "tensor_core" and L <= hs.MAX_HYPOTHESES:
                        P = hs.tc_planes(W)
                        check(torch.equal(P[:, :L, :d], hs.split_planes(W))
                              and not P[:, L:].any() and not P[..., d:].any(),
                              f"hinge_tc_planes differs from split_planes "
                              f"(d={d} L={L})")
                    loss, cnt = ops.hinge_scores(X, W, b, y, m)
                    lp, cp = ref.hinge_scores_ref(X, W, b, y, m)
                    rel = float(((loss - lp).abs()
                                 / lp.abs().clamp(min=1e-30)).max())
                    worst = max(worst, rel)
                    check(float(cnt) == float(cp), f"hinge_scores {tag} n={n} "
                          f"d={d} L={L}: count {float(cnt)} vs {float(cp)}")
                    check(torch.equal(ops.hinge_scores(X, W, b, y, m)[0],
                                      loss), f"hinge_scores {tag} rerun not "
                          f"bit-identical (n={n} d={d} L={L})")
                    cases += 1
        routes = _routes(ops, "hinge_scores")
        say(f"[kernels] hinge_scores {tag}: max rel Δ = {worst:.2e} over "
            f"{cases} cases (rtol 1e-4); counts equal, reruns bit-identical"
            + ("; planes ≡ split_planes" if route == "tensor_core" else "")
            + f"; routes {routes}")
        check(worst <= 1e-4, f"hinge_scores {tag} differs from plain by "
              f"{worst:.2e}")
        check(routes[route] == ops.LAUNCHES["hinge_scores"] > 0,
              f"hinge_scores {tag} did not take the {route} route")


def phase_gram_small(torch, ops, ref, sp):
    """gram, sparse_gram and cd_solve_gram against their plain versions:
    f32 and bf16, linear/rbf/poly, ragged shapes, padding slots, dead
    rows, masked rows and (home, shared) job rows."""
    dev = torch.device(DEV)
    gen = torch.Generator(device=dev).manual_seed(2)

    def dense(n, d, dtype):
        return (torch.randn((n, d), generator=gen, device=dev)
                / math.sqrt(d)).to(dtype)

    def sparse(n, d, cap, dtype, density=0.02):
        X = torch.randn((n, d), generator=gen, device=dev)
        X = X * (torch.rand((n, d), generator=gen, device=dev) < density)
        X = X / X.norm(dim=1, keepdim=True).clamp(min=1e-9)
        live = (torch.rand((n, 1), generator=gen, device=dev) > 0.1)
        return sp.from_dense(X, cap) * live.float()  # dead rows keep ids

    for dtype in (torch.float32, torch.bfloat16):
        tag = "f32" if dtype == torch.float32 else "bf16"
        worst = 0.0
        ops.reset_launches()
        for n, m, d in ((64, 64, 32), (130, 70, 96), (300, 200, 260),
                        (33, 129, 1001)):
            X, Z = dense(n, d, dtype), dense(m, d, dtype)
            for kind, kw in GRAM_KINDS:
                worst = max(worst, _rel(ops.gram(X, Z, kind=kind, **kw),
                                        ref.gram_ref(X, Z, kind=kind, **kw)))
        H, S = dense(3 * 50, 40, dtype).reshape(3, 50, 40), dense(17, 40, dtype)
        Q = dense(61, 40, dtype)
        for X, Z in (((H, S), (H, S)), (Q, (H[:1], S)), ((H, S), Q)):
            for kind, kw in GRAM_KINDS:
                worst = max(worst, _rel(
                    ops.gram(X, Z, kind=kind, **kw),
                    ops.per_job(ref.gram_ref, X, Z, kind=kind, **kw)))
        if dtype == torch.bfloat16:
            worst = max(worst, _gram_tile_edges(torch, ops, ref, dense))
        route = "tensor_core" if dtype == torch.bfloat16 else "simt"
        other = "simt" if route == "tensor_core" else "tensor_core"
        say(f"[kernels] gram {tag}: max |Δ|/(1+|K|) = {worst:.2e} over 4 "
            "shapes × 4 transforms and (home, shared) jobs"
            + (", tile edges and the symmetric route" if route ==
               "tensor_core" else "") + f" (tol 1e-4); routes "
            f"{_routes(ops, 'gram')}")
        check(worst <= 1e-4, f"gram {tag} differs from plain by {worst:.2e}")
        check(ops.ROUTE_LAUNCHES[f"gram/{route}"] > 0
              and ops.ROUTE_LAUNCHES[f"gram/{other}"] == 0,
              f"gram {tag} did not take the {route} route")

        worst = 0.0
        for n, m, d, cap in ((64, 40, 300, 16), (130, 257, 2000, 33)):
            X = sparse(n, d, cap, torch.float32).to(dtype=dtype)
            Z = sparse(m, d, cap, torch.float32).to(dtype=dtype)
            for kind, kw in GRAM_KINDS:
                worst = max(worst, _rel(
                    ops.sparse_gram(X, Z, kind=kind, **kw),
                    ref.sparse_gram_ref(X, Z, kind=kind, **kw)))
        H = sparse(3 * 50, 500, 12, torch.float32).to(dtype=dtype) \
            .reshape(3, 50, 500)
        S = sparse(17, 500, 12, torch.float32).to(dtype=dtype)
        Q = sparse(61, 500, 12, torch.float32).to(dtype=dtype)
        for X, Z in (((H, S), (H, S)), (Q, (H[:1], S))):
            for kind, kw in GRAM_KINDS:
                worst = max(worst, _rel(
                    ops.sparse_gram(X, Z, kind=kind, **kw),
                    ops.per_job(ref.sparse_gram_ref, X, Z, kind=kind,
                               **kw)))
        say(f"[kernels] sparse_gram {tag}: max |Δ|/(1+|K|) = {worst:.2e} "
            "over 2 shapes × 4 transforms and (home, shared) jobs (tol 1e-5)")
        check(worst <= 1e-5,
              f"sparse_gram {tag} differs from plain by {worst:.2e}")
        _scores_small(torch, ops, ref, H, S, Q, dtype, tag)

        for L, n, kind, epochs, C in ((3, 200, "rbf", 15, 1.0),
                                      (2, 37, "linear", 15, 0.5),
                                      (2, 1100, "rbf", 2, 1.0),
                                      (2, 1, "rbf", 3, 1.0)):
            X = dense(L * n, 64, torch.float32).reshape(L, n, 64)
            K = ops.gram((X, X[0, :0]), (X, X[0, :0]), kind=kind,
                         gamma=1.0).to(dtype)
            y = torch.where(torch.randn((L, n), generator=gen, device=dev)
                            > 0, 1.0, -1.0)
            m = (torch.rand((L, n), generator=gen, device=dev) > 0.1).float()
            if n == 200:
                m[1] = 0.0                  # job 1 stops after one epoch
            y = torch.where(m > 0, y, 0.0)          # padding: y = m = 0
            y, m = y.to(dtype).contiguous(), m.to(dtype).contiguous()
            kw = dict(C=C, tol=1e-3, max_epochs=epochs)
            what = f"{tag} L={L} n={n} {kind} epochs≤{epochs}"
            _cdg_as_given(torch, ops, ref, K, y, m, kw, what)
            _cdg_sizes(torch, ops, ref, _symmetric(K), y, m, kw, what)


# The scores route against its plain version K.to(coef.dtype) @ coefᵀ
# + b, max |Δ| over (1 + max |plain|): f32 sums in another order; with
# bf16 coefficients both round the sum and the bias add to bf16, which
# may land one bf16 step (2⁻⁸ of the scale) apart.
SCORES_TOL = {"float32": 1e-5, "bfloat16": 2 ** -7}


def _scores_small(torch, ops, ref, H, S, Q, dtype, tag):
    """sparse_gram_scores against its plain version: Z a (home, shared)
    pair with eq. 7's coefficients (3 hypotheses, zero off each one's
    block of home rows) and plain rows with 2 dense hypotheses, 4
    transforms, f32 and bf16 coefficients, zero coefficients; a
    bit-identical rerun and one launch of the scores route each."""
    dev = Q.values.device
    gen = torch.Generator(device=dev).manual_seed(9)
    worst = {"float32": 0.0, "bfloat16": 0.0}
    ops.reset_launches()
    calls = 0
    J, per = H.shape[0], H.shape[1]
    home = H.reshape(1, J * per, H.shape[2])
    block = torch.zeros((J, J * per + S.shape[0]), device=dev)
    for l in range(J):
        block[l, l * per:(l + 1) * per] = 1.0
    block[:, J * per:] = 1.0
    for Z, mask in (((home, S), block), (S, torch.ones((2, S.shape[0]),
                                                      device=dev))):
        coef = torch.randn(mask.shape, generator=gen, device=dev) * mask
        coef[:, ::4] = 0.0
        b = torch.randn((mask.shape[0],), generator=gen, device=dev)
        for cdt in (torch.float32, torch.bfloat16):
            c, bb = coef.to(cdt), b.to(cdt)
            for kind, kw in GRAM_KINDS:
                got = ops.sparse_gram_scores(Q, Z, c, bb, kind=kind, **kw)
                want = ref.sparse_gram_scores_ref(Q, Z, c, bb, kind=kind,
                                                  **kw)
                name = str(cdt).split(".")[1]
                err = float((got.float() - want.float()).abs().max()) / \
                    (1.0 + float(want.float().abs().max()))
                worst[name] = max(worst[name], err)
                again = ops.sparse_gram_scores(Q, Z, c, bb, kind=kind, **kw)
                calls += 2
                check(torch.equal(got, again),
                      "sparse_gram_scores rerun not bit-identical")
    say(f"[kernels] sparse_gram_scores {tag} rows: max |Δ|/(1+max|S|) "
        f"f32 coef {worst['float32']:.2e} (tol {SCORES_TOL['float32']:g}), "
        f"bf16 coef {worst['bfloat16']:.2e} (tol "
        f"{SCORES_TOL['bfloat16']:g}), routes {_routes(ops, 'sparse_gram')}")
    for name, err in worst.items():
        check(err <= SCORES_TOL[name],
              f"sparse_gram_scores ({name} coef) differs by {err:.2e}")
    check(ops.ROUTE_LAUNCHES["sparse_gram/scores"] == calls
          and ops.ROUTE_LAUNCHES["sparse_gram/gram"] == 0,
          f"sparse_gram_scores took {_routes(ops, 'sparse_gram')}")


def _symmetric(K):
    """K with its upper triangle mirrored: equal to Kᵀ bit for bit, as
    the solve's kernel (which reads K's rows for Q's columns) and its
    plain version (which reads the columns) need to agree exactly."""
    return (K.triu() + K.triu(1).mT).contiguous()


def _cdg_as_given(torch, ops, ref, K, y, m, kw, tag):
    """cd_solve_gram on K as the Gram kernels return it, which the fit
    passes on: the kernel reads K's rows where the plain version reads
    its columns, so α and viol within 1e-5 of plain, epochs equal."""
    sym = torch.equal(K, K.mT)
    a_k, t_k, v_k = ops.cd_solve_gram(K, y, m, **kw)
    a_p, t_p, v_p = ref.cd_solve_gram_ref(K, y, m, **kw)
    torch.cuda.synchronize()
    err = max(float((a_k.float() - a_p.float()).abs().max()),
              float((v_k.float() - v_p.float()).abs().max()))
    say(f"[kernels] cd_solve_gram {tag} on K as given (bit-symmetric "
        f"{sym}): epochs {t_k.tolist()} vs plain {t_p.tolist()}, "
        f"max|Δ(α, viol)| = {err:.2e} (tol 1e-5)")
    check(torch.equal(t_k, t_p), f"cd_solve_gram {tag}: epochs differ")
    check(err <= 1e-5, f"cd_solve_gram {tag} differs by {err:.2e}")


def _cdg_sizes(torch, ops, ref, K, y, m, kw, tag, sizes=(None, 1, 2, 16)):
    """cd_solve_gram on the rule's cluster size (counted) and on forced
    sizes (uncounted) against its plain version: α, viol and epochs equal
    bit for bit (K symmetric, so both read the same Q), the rule's route
    counted, a bit-identical rerun. → the plain result."""
    from repro_torch.kernels.gram_solve import launch_cd_solve_gram
    L, n, _ = K.shape
    rule = ops.cd_solve_gram_cluster_size(L, n)
    plain = ref.cd_solve_gram_ref(K, y, m, **kw)
    for c in sizes:
        ops.reset_launches()
        run = (lambda: ops.cd_solve_gram(K, y, m, **kw)) if c is None else \
            (lambda: launch_cd_solve_gram(
                K, y, m, *_launch_kw(torch, ops, kw, L, K.device), c))
        a, t, v = run()
        torch.cuda.synchronize()
        route = _routes(ops, "cd_solve_gram")
        err = max(float((a.float() - plain[0].float()).abs().max()),
                  float((v.float() - plain[2].float()).abs().max()))
        say(f"[kernels] cd_solve_gram {tag} c={c or f'{rule} (the rule)'}: "
            f"epochs {t.tolist()} vs plain {plain[1].tolist()}, "
            f"max|Δ(α, viol)| = {err:.2e} (expected 0), routes {route}")
        check(torch.equal(t, plain[1]), "cd_solve_gram epochs differ")
        check(torch.equal(a, plain[0]) and torch.equal(v, plain[2]),
              f"cd_solve_gram differs from plain by {err:.2e}")
        if c is None:
            want = "cluster" if rule > 1 else "single"
            check(route[want] == 1, f"cd_solve_gram {tag} took {route}")
        again = run()
        check(all(torch.equal(p, q) for p, q in zip((a, t, v), again)),
              f"cd_solve_gram {tag} c={c}: rerun not bit-identical")
    return plain


def phase_gram_solve_rows(torch, ops, ref):
    """cd_solve_gram just above what one CTA's shared memory holds (11622
    rows, the cap of the one-CTA design):
    one job of 11776 rows, f32, 2 epochs, on the rule's cluster; and the
    clusters the full-width reducers can keep resident."""
    from repro_torch.kernels.gram_solve import max_active_clusters
    for c in (8, 16):
        say(f"[kernels] cd_solve_gram 10240 rows, c={c}: "
            f"{max_active_clusters(torch.float32, 10240, c)} clusters can "
            "be resident at once")
    dev = torch.device(DEV)
    gen = torch.Generator(device=dev).manual_seed(5)
    n = 11776
    X = torch.randn((n, 64), generator=gen, device=dev) / 8.0
    K = ops.gram(X, X, kind="rbf", gamma=1.0)[None]
    y = torch.where(torch.randn((1, n), generator=gen, device=dev) > 0,
                    1.0, -1.0)
    m = torch.ones_like(y)
    kw = dict(C=1.0, tol=1e-3, max_epochs=2)
    what = f"f32 L=1 n={n} rbf epochs≤2"
    _cdg_as_given(torch, ops, ref, K, y, m, kw, what)
    _cdg_sizes(torch, ops, ref, _symmetric(K), y, m, kw, what, sizes=(None,))
    check(ops.cd_solve_gram_cluster_size(1, n) > 1,
          "11776 rows did not take the cluster route")


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
        check(ops.LAUNCHES["cd_solve"] > 0 and ops.LAUNCHES["hinge_scores"]
              > 0, "pipeline bypassed a kernel")
        # d = 1024: one CTA a job (the cluster route's rule gives c = 1)
        check(ops.ROUTE_LAUNCHES["cd_solve/single"] == ops.LAUNCHES["cd_solve"]
              and ops.ROUTE_LAUNCHES["cd_solve/cluster"] == 0,
              f"golden cd_solve took the routes {_routes(ops, 'cd_solve')}")


def phase_kernel_pipeline(torch, T, text):
    """The golden pipeline on the Gram path (rbf, γ = 1). → the launch
    counts of the dense 2-class run."""
    from repro_torch.kernels import ops
    kern = T.KernelConfig("rbf", gamma=1.0)
    runs = (("dense", (-1, 1), 0.87), ("dense", (-1, 0, 1), 0.77),
            ("sparse", (-1, 1), 0.87))
    first = None
    for fmt, classes, floor in runs:
        corpus = text.generate(text.CorpusConfig(num_messages=1024,
                                                 classes=classes, seed=0))
        if fmt == "dense":
            counts = text.vectorize(corpus.texts, 1024)
            svm = T.SVMConfig(C=1.0, max_epochs=15, kernel=kern,
                              use_gram=True, gram_impl="pallas")
            want = ("gram", "cd_solve_gram")
        else:
            counts = text.vectorize_sparse(corpus.texts, 1024, nnz_cap=32)
            svm = T.SVMConfig(C=1.0, max_epochs=15, kernel=kern,
                              use_gram=True, gram_impl="pallas_sparse",
                              row_format="sparse_csr", nnz_cap=32)
            want = ("sparse_gram", "cd_solve_gram")
        cfg = T.MRSVMConfig(sv_capacity=128, gamma=1e-4, max_rounds=4,
                            svm=svm)
        X, _ = text.fit_transform(counts, device=DEV)
        y = torch.tensor(corpus.labels, dtype=torch.float32, device=DEV)
        ops.reset_launches()
        t0 = time.perf_counter()
        if len(classes) == 2:
            model = T.fit_mapreduce(X[:768], y[:768], 8, cfg)
            pred = T.predict(model, X[768:], cfg)
            risks = [round(h["risk"], 5) for h in model.history]
        else:
            model = T.fit_one_vs_rest(X[:768], y[:768], list(classes), 8,
                                      cfg)
            pred = model.predict(X[768:])
            risks = "-"
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        launches = {k: ops.LAUNCHES[k] for k in KERNEL_PATH_LAUNCHES}
        acc = float((pred == y[768:].to(pred.dtype)).float().mean())
        say(f"[kernel-pipeline] {fmt} {len(classes)}-class rbf: held-out "
            f"accuracy {acc:.4f} (floor {floor}), round risks {risks}, "
            f"fit+predict {ms:.1f} ms, launches {launches}")
        check(acc > floor, f"{fmt} {len(classes)}-class accuracy {acc:.4f}")
        check(all(launches[k] > 0 for k in want),
              f"{fmt} kernel pipeline bypassed one of {want}")
        first = first or launches
    return first


def time_hinge(torch, ops, ref, Xflat, yflat, mflat, W, b):
    """hinge_scores at the main path's shapes: check, time, bound."""
    n, d = Xflat.shape
    L = W.shape[0]
    ops.reset_launches()
    loss_k, cnt_k = ops.hinge_scores(Xflat, W, b, yflat, mflat)
    check(ops.ROUTE_LAUNCHES["hinge_scores/tensor_core"] == 1,
          f"hinge_scores bf16 took the routes {_routes(ops, 'hinge_scores')}")
    loss_p, cnt_p = ref.hinge_scores_ref(Xflat, W, b, yflat, mflat)
    torch.cuda.synchronize()
    rel = float(((loss_k - loss_p).abs() / loss_p.abs().clamp(min=1e-30)).max())
    err = float((loss_k - loss_p).abs().max())
    say(f"[kernels] hinge_scores n={n} d={d} L={L} bf16 (tensor-core "
        f"route): max rel Δ={rel:.2e} (rtol 1e-4), count {float(cnt_k)} vs "
        f"{float(cnt_p)}")
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
    n = per + cap
    c = ops.cd_solve_cluster_size(n, d, Xp.dtype)
    ops.reset_launches()
    k = ops.cd_solve(*args, **kw)
    check(ops.ROUTE_LAUNCHES["cd_solve/cluster"] == 1,
          f"full-width cd_solve took the routes {_routes(ops, 'cd_solve')}")
    t0 = time.perf_counter()
    p = ref.cd_solve_ref(*args, **kw)
    torch.cuda.synchronize()
    plain = 1e3 * (time.perf_counter() - t0)
    err = float((k[0] - p[0]).abs().max())
    Xflat, yflat = Xp.reshape(L * per, d), yp.reshape(L * per).float()
    mflat = maskp.reshape(L * per).float()

    def risk(out):
        return ref.hinge_scores_ref(Xflat, out[1], out[2], yflat,
                                    mflat)[0] / mflat.sum()

    r_p = risk(p)
    rerr = float((risk(k) - r_p).abs().max())
    say(f"[kernels] cd_solve one epoch L={L} per={per} S={cap} d={d} bf16, "
        f"cluster route c={c}: max|Δα|={err:.2e}, hinge risk max|Δ|="
        f"{rerr:.2e} (atol 1e-4)")
    check(rerr <= 1e-4, f"cd_solve risk differs from plain by {rerr:.2e}")
    again = ops.cd_solve(*args, **kw)
    check(all(torch.equal(a, b) for a, b in zip(k, again)),
          "cd_solve rerun not bit-identical at full width")
    from repro_torch.kernels import svm_step
    other = {}
    for size in (8, 16, 1):      # clusters of 8 and 16, and one CTA
        if size == c:
            continue
        o = _cd_run(ops, args, kw, size)
        o_err = float((risk(o) - r_p).abs().max())
        check(o_err <= 1e-4, f"cd_solve c={size} risk differs from plain "
              f"by {o_err:.2e}")
        other[size] = cuda_ms(torch, lambda: _cd_run(ops, args, kw, size), 1)
    ms = cuda_ms(torch, lambda: ops.cd_solve(*args, **kw), 3)
    say(f"[kernels] cd_solve epoch: c={c} (the rule's) {ms:.3f} ms; "
        + ", ".join(f"c={size} {t:.3f} ms" for size, t in other.items())
        + "; resident clusters "
        + ", ".join(f"c={size}: "
                    f"{svm_step.max_active_clusters(Xp.dtype, d, n, size)}"
                    for size in (8, 16)))
    moved = int((p[0] != 0).sum())          # rows whose α moved → an axpy
    nbytes = (L * per + cap) * d * Xp.element_size() + 2 * L * n * 4 \
        + L * n * 4 + L * d * 4 + 3 * L * 4
    bms, by = bound_ms(nbytes, 2.0 * L * n * d + 2.0 * moved * d)
    say(f"[kernels] cd_solve: kernel {ms:.3f} ms, plain {plain:.3f} ms, "
        f"bound {bms:.3f} ms ({by}); {moved} of {L * n} rows moved α")
    return dict(name="cd_solve", route="cuda", source=CD_SRC,
                replaces=CD_TPU, max_abs_err=err, ms=ms, plain_ms=plain,
                bound_ms=bms, bound_by=by, library_ms=None)


def profile(torch, fn, what: str) -> None:
    """``fn()`` (which ends in a host readback) under torch.profiler:
    device time by kernel and the device's busy share of the call."""
    with profiling(torch, what):
        fn()


@contextlib.contextmanager
def profiling(torch, what: str):
    """The block (which ends in a host readback) under torch.profiler,
    as :func:`profile` reports it; kernels of every thread count."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if DEV == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        yield
        wall_ms = 1e3 * (time.perf_counter() - t0)
    # Kernel rows only: an operator's row repeats its kernels' time.
    rows = sorted(((evt.self_device_time_total / 1e3, evt.count, evt.key)
                   for evt in prof.key_averages()
                   if evt.device_type == torch.autograd.DeviceType.CUDA),
                  reverse=True)
    busy = sum(r[0] for r in rows)
    say(f"[profile] {what}: {wall_ms:.1f} ms host clock (profiled), "
        f"device busy {busy:.1f} ms ({100 * busy / wall_ms:.1f} %), "
        f"{sum(r[1] for r in rows)} kernel launches")
    for ms, count, key in rows[:8]:
        say(f"[profile]   {ms:10.3f} ms  {count:4d}×  {key[:90]}")


def profile_round(torch, T, Xp, yp, maskp, sv, cfg):
    """One more round from the converged SV_global, profiled."""
    profile(torch, lambda: T.mapreduce_round(Xp, yp, maskp, sv, cfg
                                             ).risks.cpu(), "one round")


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
        f"hinge_scores = rounds), routes {_routes(ops, 'cd_solve')}, "
        f"{ops.cd_solve_cluster_size(per + cfg.sv_capacity, d, X.dtype)}"
        " CTAs a job")
    check(launches["cd_solve"] == model.rounds + 1,
          f"cd_solve launched {launches['cd_solve']} times")
    check(ops.ROUTE_LAUNCHES["cd_solve/cluster"] == launches["cd_solve"],
          f"the fit's cd_solve took the routes {_routes(ops, 'cd_solve')}")
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

    # --- the sweep axis: S = 4 configs, C = logspace(-2, 1, 4) ----------
    from repro_torch.kernels import svm_step
    params = T.sweep_grid(cfg.svm, C=SWEEP_C)
    S, n = len(params.C), per + cfg.sv_capacity
    resident = svm_step.max_active_clusters(X.dtype, d, n, 8)
    say(f"[full-sweep] dense: {S * L} jobs of {n} rows on clusters of 8 "
        f"CTAs, {resident} resident at once: {-(-S * L // resident)} waves "
        "a round")
    full_sweep(torch, T, ops, X, y, L, cfg, params, {SWEEP_C_ONE: model},
               "full-sweep", fit_ms,
               {"cd_solve/cluster": lambda r: len(r.history) + 1,
                "hinge_scores/tensor_core":
                    lambda r: len(r.history) * -(-S * L // 8)})

    # --- [nan-full]: one NaN entry in these rows, for the two calls ------
    old = X[37, 5].clone()
    X[37, 5] = math.nan
    _nan_full(torch, ops, "fit_mapreduce, dense bf16 rows (8 × 8192 × "
              "131072, sv_capacity 2048)",
              lambda: T.fit_mapreduce(X, y, L, cfg))
    _nan_full(torch, ops, f"fit_mapreduce_sweep S = {S}, dense bf16 rows",
              lambda: T.fit_mapreduce_sweep(X, y, L, cfg, params))
    X[37, 5] = old
    return [cd, hinge]


def time_gram_full(torch, T, ops, ref):
    """gram at one full-width reducer shape: n = m = 8192 + 2048 rows of
    d = 131072, bf16, rbf γ = 1; kernel, plain and the bf16 matmul
    route (``gram_impl="xla"``: ``apply_kernel`` on bf16 rows)."""
    from repro_torch.configs import SVM_TFIDF
    from repro_torch.data.pipeline import svm_rows_device
    n, d = SVM_TFIDF.rows_per_device + SVM_TFIDF.sv_capacity, \
        SVM_TFIDF.num_features
    X, _ = svm_rows_device(n, d, seed=3, dtype=torch.bfloat16, device=DEV)
    kw = dict(kind="rbf", gamma=1.0)
    ops.reset_launches()
    K = ops.gram(X, X, **kw)
    check(ops.ROUTE_LAUNCHES["gram/tensor_core"] == 1,
          f"gram bf16 took the routes {_routes(ops, 'gram')}")
    check(torch.equal(K, K.T), "the symmetric route's K is not symmetric")
    P = ref.gram_ref(X, X, **kw)
    torch.cuda.synchronize()
    err = float((K - P).abs().max())
    say(f"[kernels] gram {n}×{n}×{d} bf16 rbf (tensor-core route, upper "
        f"triangle, K ≡ Kᵀ): max|Δ| vs plain {err:.2e} (atol 1e-4)")
    check(err <= 1e-4, f"gram differs from plain by {err:.2e}")
    del K, P
    K = ops.gram(X, X, kind="linear")
    lin = _rel(K, ref.gram_ref(X, X, kind="linear"))
    say(f"[kernels] gram {n}×{n}×{d} bf16 linear: max |Δ|/(1+|K|) vs plain "
        f"{lin:.2e} (tol 1e-4)")
    check(lin <= 1e-4, f"linear gram differs from plain by {lin:.2e}")
    del K
    kc = T.KernelConfig("rbf", gamma=1.0)
    ms = cuda_ms(torch, lambda: ops.gram(X, X, **kw), 2)
    plain = cuda_ms(torch, lambda: ref.gram_ref(X, X, **kw), 1)
    lib = cuda_ms(torch, lambda: T.apply_kernel(X, X, cfg=kc), 3)
    # gram(X, X): X is read once, and the symmetric K needs the
    # n(n + 1)/2 distinct dot products of d multiply-adds each
    bms, by = bound_ms(n * d * 2 + n * n * 4, 1.0 * n * (n + 1) * d,
                       BF16_FLOP_PER_S)
    say(f"[kernels] gram: kernel {ms:.3f} ms, plain {plain:.3f} ms, library "
        f"(bf16 matmul route) {lib:.3f} ms, bound {bms:.3f} ms ({by}, bf16 "
        "tensor-core rate)")
    # the rbf call's own kernels: the norms pass and the tensor-core tiles
    profile(torch, lambda: float(ops.gram(X, X, **kw)[0, 0]), "one rbf gram")
    # the f32 SIMT route at the golden Gram pipeline's reducer shape: 8
    # jobs × (96 home + 128 SV rows) × 1024, rbf
    gen = torch.Generator(device=DEV).manual_seed(4)
    H = torch.rand((8, 96, 1024), generator=gen, device=DEV)
    S = torch.rand((128, 1024), generator=gen, device=DEV)
    simt = cuda_ms(torch, lambda: ops.gram((H, S), (H, S), **kw), 20)
    say(f"[kernels] gram f32 (SIMT route) 8 jobs × 224² × 1024 rbf: "
        f"{simt:.3f} ms")
    return dict(name="gram", route="cuda", source=GRAM_SRC,
                replaces=GRAM_TPU, max_abs_err=err, ms=ms, plain_ms=plain,
                bound_ms=bms, bound_by=by, library_ms=lib)


def _index_matches(torch, Xp, sv_x, d):
    """Nonzero slot pairs with equal columns in one reducer Gram over
    the L jobs: Σ over jobs and columns of (the job's rows holding the
    column)²."""
    L = Xp.shape[0]
    jobs = torch.arange(L, device=Xp.indices.device)[:, None] * d
    cols = torch.cat([Xp.indices.reshape(L, -1),
                      sv_x.indices.reshape(1, -1).expand(L, -1)], 1)
    live = torch.cat([Xp.values.reshape(L, -1),
                      sv_x.values.reshape(1, -1).expand(L, -1)], 1) != 0
    counts = torch.bincount((cols.long() + jobs)[live], minlength=L * d)
    return int((counts.long() ** 2).sum())


def _eq7_matches(torch, Xflat, Z, d):
    """Nonzero slot pairs with equal columns between the query rows and
    the union rows Z: Σ over columns of (query rows holding it) × (rows
    of Z holding it)."""
    def counts(rows):
        live = rows.values != 0
        return torch.bincount(rows.indices[live].long(), minlength=d)
    return int((counts(Xflat).long() * counts(Z).long()).sum())


def time_sparse_kernels(torch, ops, ref, Xp, sv, yp, maskp, cfg):
    """sparse_gram and cd_solve_gram at the full-width fit's shapes, from
    its SV_global: the reducer Gram over the L jobs (checked against
    plain, rerun, timed); cd_solve_gram on it (on K made exactly
    symmetric, α must equal plain bit for bit; rerun; one epoch and one
    launch timed on the rule's cluster, and other sizes); then eq. 7 of
    that solve's hypotheses through the fused scores route over all
    query rows (checked against plain, rerun, timed, its peak memory
    read). → the three kernel rows."""
    from repro_torch import sparse as sparse_rows
    from repro_torch.kernels.gram_solve import launch_cd_solve_gram
    L, per, d = Xp.shape
    cap = sv.y.shape[0]
    n = per + cap
    kc = cfg.svm.kernel
    kw = dict(kind=kc.name, gamma=kc.gamma)
    side = (Xp, sv.x)
    ops.reset_launches()
    K = ops.sparse_gram(side, side, **kw)
    check(ops.ROUTE_LAUNCHES["sparse_gram/gram"] == 1,
          f"sparse_gram took {_routes(ops, 'sparse_gram')}")
    P = ops.per_job(ref.sparse_gram_ref, side, side, **kw)
    torch.cuda.synchronize()
    err = float((K - P).abs().max())
    del P
    same = torch.equal(K, ops.sparse_gram(side, side, **kw))
    say(f"[kernels] sparse_gram {L} jobs × {n}² nnz_cap {Xp.nnz_cap} f32 "
        f"{kc.name}: max|Δ| vs plain {err:.2e} (atol 1e-5), rerun "
        f"bit-identical {same}")
    check(err <= 1e-5, f"sparse_gram differs from plain by {err:.2e}")
    check(same, "sparse_gram rerun not bit-identical")
    ms = cuda_ms(torch, lambda: ops.sparse_gram(side, side, **kw), 3)
    plain = cuda_ms(torch, lambda: ops.per_job(
        ref.sparse_gram_ref, side, side, **kw), 1, warmup=0)
    matches = _index_matches(torch, Xp, sv.x, d)
    # X and Z are the same rows here: their slots are read once
    slot_bytes = (L * per + cap) * Xp.nnz_cap * 8
    bms, by = bound_ms(slot_bytes + L * n * n * 4, 2.0 * matches)
    say(f"[kernels] sparse_gram: kernel {ms:.3f} ms, plain "
        f"{plain:.3f} ms, bound {bms:.3f} ms ({by}); {matches} index "
        "matches")
    sg = dict(name="sparse_gram", route="cuda", source=SPARSE_SRC,
              replaces=SPARSE_TPU, max_abs_err=err, ms=ms, plain_ms=plain,
              bound_ms=bms, bound_by=by, library_ms=None)

    # --- cd_solve_gram on the reducer Gram ------------------------------
    sym = torch.equal(K, K.mT)
    Ks = K if sym else _symmetric(K)
    y_aug = torch.cat([yp, sv.y.expand(L, cap)], 1).contiguous()
    m_aug = torch.cat([maskp, sv.mask.expand(L, cap)], 1).contiguous()
    kw1 = dict(C=cfg.svm.C, tol=cfg.svm.tol, max_epochs=1)
    rule = ops.cd_solve_gram_cluster_size(L, n)
    ops.reset_launches()
    a_k, t_k, v_k = ops.cd_solve_gram(Ks, y_aug, m_aug, **kw1)
    check(ops.ROUTE_LAUNCHES["cd_solve_gram/cluster"] == 1,
          f"cd_solve_gram took {_routes(ops, 'cd_solve_gram')}")
    t0 = time.perf_counter()
    a_p, t_p, v_p = ref.cd_solve_gram_ref(Ks, y_aug, m_aug, **kw1)
    torch.cuda.synchronize()
    cd_plain = 1e3 * (time.perf_counter() - t0)
    cd_err = float((a_k - a_p).abs().max())
    again = ops.cd_solve_gram(Ks, y_aug, m_aug, **kw1)
    rerun = all(torch.equal(p, q) for p, q in zip((a_k, t_k, v_k), again))
    say(f"[kernels] cd_solve_gram one epoch L={L} n={n} f32, {rule} CTAs a "
        f"job: max|Δα| vs plain {cd_err:.2e} (expected 0; K "
        f"{'is' if sym else 'is not'} bit-symmetric, "
        f"{'as given' if sym else 'its upper triangle mirrored'}), epochs "
        f"{t_k.tolist()}, rerun bit-identical {rerun}")
    check(torch.equal(a_k, a_p) and torch.equal(t_k, t_p)
          and torch.equal(v_k, v_p), "cd_solve_gram differs from plain")
    check(rerun, "cd_solve_gram rerun not bit-identical")
    if not sym:
        a_u = ops.cd_solve_gram(K, y_aug, m_aug, **kw1)[0]
        a_up = ref.cd_solve_gram_ref(K, y_aug, m_aug, **kw1)[0]
        u_err = float((a_u - a_up).abs().max())
        say(f"[kernels] cd_solve_gram on the unsymmetrized K: max|Δα| "
            f"{u_err:.2e} (atol 1e-5; rows vs columns of K)")
        check(u_err <= 1e-5, f"cd_solve_gram differs by {u_err:.2e}")
    cd_ms = cuda_ms(torch, lambda: ops.cd_solve_gram(Ks, y_aug, m_aug,
                                                     **kw1), 3)
    forced = {c: cuda_ms(torch, lambda: launch_cd_solve_gram(
        Ks, y_aug, m_aug, *_launch_kw(torch, ops, kw1, Ks.shape[0],
                                      Ks.device), c), 3)
        for c in (1, 4, 16)}
    kw_fit = dict(kw1, max_epochs=cfg.svm.max_epochs)
    launch_ms = cuda_ms(torch, lambda: ops.cd_solve_gram(Ks, y_aug, m_aug,
                                                         **kw_fit), 1)
    alpha, epochs, _ = ops.cd_solve_gram(Ks, y_aug, m_aug, **kw_fit)
    moved = int((a_p != 0).sum())
    nbytes = moved * n * 4 + L * n * 4 * 4 + L * 8
    cbms, cby = bound_ms(nbytes, 8.0 * moved * n)
    say(f"[kernels] cd_solve_gram: kernel {cd_ms:.3f} ms per epoch on "
        f"{rule} CTAs a job, forced "
        + ", ".join(f"{c} CTAs {t:.3f}" for c, t in forced.items())
        + f"; one launch of {epochs.tolist()} epochs {launch_ms:.3f} ms; "
        f"plain {cd_plain:.3f} ms, bound {cbms:.3f} ms "
        f"({cby}) an epoch; {moved} of {L * n} rows moved α")
    cdg = dict(name="cd_solve_gram", route="cuda", source=CDG_SRC,
               replaces=CDG_TPU, max_abs_err=cd_err, ms=cd_ms,
               plain_ms=cd_plain, bound_ms=cbms, bound_by=cby,
               library_ms=None)
    del K, Ks

    # --- eq. 7: the fused scores route over all query rows ---------------
    # as _kernel_risks: the union [Xflat; SV_global], hypothesis l's
    # coefficients zero off its job's rows
    coef = alpha * y_aug * m_aug
    b = coef.sum(1)
    Xflat = Xp.reshape(L * per, d)
    N = Xflat.shape[0]
    union = (Xp.reshape(1, N, d), sv.x)
    Coef = torch.zeros((L, N + cap), device=coef.device)
    for l in range(L):
        Coef[l, l * per:(l + 1) * per] = coef[l, :per]
    Coef[:, N:] = coef[:, per:]
    coef, side = Coef, union
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    ops.reset_launches()
    S = ops.sparse_gram_scores(Xflat, side, coef, b, **kw)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - base
    check(ops.ROUTE_LAUNCHES["sparse_gram/scores"] == 1,
          f"eq. 7 took {_routes(ops, 'sparse_gram')}")
    chunk = (1 << 28) * 4
    say(f"[kernels] sparse_gram_scores eq. 7 ({N} × {N + cap}, {L} "
        f"hypotheses): peak "
        f"memory above its inputs {extra / 1e6:.1f} MB (a K chunk of the "
        f"chunked route: {chunk / 1e6:.1f} MB; all of K: "
        f"{N * (L * per + cap) * 4 / 1e9:.1f} GB)")
    check(extra < chunk, "eq. 7 allocated as much as a K chunk")
    same = torch.equal(S, ops.sparse_gram_scores(Xflat, side, coef, b, **kw))
    t0 = time.perf_counter()
    want = ref.sparse_gram_scores_ref(Xflat, side, coef, b, **kw)
    torch.cuda.synchronize()
    e_plain = 1e3 * (time.perf_counter() - t0)
    e_err = float((S - want).abs().max())
    e_rel = e_err / (1.0 + float(want.abs().max()))
    say(f"[kernels] sparse_gram_scores eq. 7: max|Δ| vs plain {e_err:.2e}, "
        f"/(1+max|S|) {e_rel:.2e} (tol {SCORES_TOL['float32']:g}), rerun "
        f"bit-identical {same}")
    check(e_rel <= SCORES_TOL["float32"],
          f"eq. 7 scores differ from plain by {e_rel:.2e}")
    check(same, "eq. 7 scores rerun not bit-identical")
    del want
    e_ms = cuda_ms(torch, lambda: ops.sparse_gram_scores(Xflat, side, coef,
                                                         b, **kw), 3)
    # the function's work: each query row against each union row whose
    # coefficient is not 0 for some hypothesis (α = 0 rows add nothing,
    # and the kernel skips them) — one exp a pair for rbf, at the SFU
    # rate — their index matches and the coefficient products in f32
    # (one hypothesis a pair off SV_global's rows); bytes: the query
    # slots and those union rows' slots, coef, S
    Z_all = sparse_rows.rows_concat(Xflat, sv.x)
    used = (coef != 0).any(0)
    Z_used = Z_all[used]
    pairs = N * Z_used.shape[0]
    e_matches = _eq7_matches(torch, Xflat, Z_used, d)
    e_bytes = (N + Z_used.shape[0]) * Xp.nnz_cap * 8 + coef.numel() * 4 \
        + N * L * 4
    ebms, eby = bound_ms(e_bytes, 2.0 * e_matches + 2.0 * pairs)
    t_exp = pairs / SFU_PER_S * 1e3 if kc.name == "rbf" else 0.0
    if t_exp > ebms:
        ebms, eby = t_exp, "operations"
    say(f"[kernels] sparse_gram_scores eq. 7: kernel {e_ms:.3f} ms, plain "
        f"{e_plain:.3f} ms, bound {ebms:.3f} ms ({eby}; {pairs} pairs "
        f"over {Z_used.shape[0]} of {Z_all.shape[0]} union rows with a "
        f"coefficient, {e_matches} index matches)")
    sgs = dict(name="sparse_gram_scores", route="cuda", source=SPARSE_SRC,
               replaces=SPARSE_TPU, max_abs_err=e_err, ms=e_ms,
               plain_ms=e_plain, bound_ms=ebms, bound_by=eby,
               library_ms=None)
    return sg, sgs, cdg


def pick_accuracy(torch, T, Xp, yp, maskp, cfg, model):
    """Training accuracy and hinge risk of the hypothesis eq. 7 picked
    (a kernel model keeps no weights of it): replay the rounds before
    it, which the deterministic kernels reproduce bit for bit, and
    solve and score its reducer again."""
    h = min(model.history, key=lambda r: r["risk"])   # first minimum
    L, per, d = Xp.shape
    sv = T.init_sv_buffer(cfg.sv_capacity, d, Xp.dtype, DEV,
                          nnz_cap=getattr(Xp, "nnz_cap", None))
    for _ in range(h["round"]):
        sv = T.mapreduce_round(Xp, yp, maskp, sv, cfg).sv
    j = slice(h["reducer"], h["reducer"] + 1)
    y_aug = torch.cat([yp[j], sv.y[None]], 1)
    m_aug = torch.cat([maskp[j], sv.mask[None]], 1)
    res = T.solve_kernel_jobs(Xp[j], sv.x, y_aug, m_aug, cfg.svm)
    coef = (res.alpha * y_aug * m_aug)[0]
    yflat = yp.reshape(-1)
    s = T.decision_kernel((Xp[j], sv.x), coef, res.b[0],
                          Xp.reshape(L * per, d), cfg.svm)
    acc = float((torch.where(s >= 0, 1.0, -1.0) == yflat).float().mean())
    risk = float(torch.clamp(1.0 - yflat * s, min=0.0).mean())
    return acc, risk


def _fit_full_gram(torch, T, ops, X, y, L, kernel, tag):
    """One full-width fit_mapreduce on the Gram path with
    gram_impl="pallas_sparse", counts from 0 before it and read after;
    checks the launch counts, the risks and the replayed eq. 7 pick.
    → (cfg, model, launches, eq. 7 pick accuracy, majority share, the
    fit's ms)."""
    from repro_torch.configs import SVM_TFIDF
    svm = T.SVMConfig(C=SVM_TFIDF.C, max_epochs=SVM_TFIDF.max_epochs,
                      kernel=kernel, use_gram=True,
                      gram_impl="pallas_sparse", row_format="sparse_csr",
                      nnz_cap=X.nnz_cap)
    cfg = T.MRSVMConfig(sv_capacity=SVM_TFIDF.sv_capacity, gamma=1e-4,
                        max_rounds=6, svm=svm)
    ops.reset_launches()
    t0 = time.perf_counter()
    model = T.fit_mapreduce(X, y, L, cfg, verbose=True)
    torch.cuda.synchronize()
    fit_ms = 1e3 * (time.perf_counter() - t0)
    launches = dict(ops.LAUNCHES, **ops.ROUTE_LAUNCHES)
    for h in model.history:
        say(f"[{tag}] round {h['round']}: R_emp={h['risk']:.6f} "
            f"|SV|={h['sv_count']} reducer={h['reducer']} "
            f"round_ms={h['ms']:.1f}")
    n_all = X.shape[0]
    routes = {k: v for k, v in ops.ROUTE_LAUNCHES.items()
              if k.startswith(("sparse_gram/", "cd_solve_gram/"))}
    say(f"[{tag}] fit_mapreduce: {model.rounds} rounds in {fit_ms:.1f} ms, "
        f"launches {dict(ops.LAUNCHES)} (cd_solve_gram = rounds + final fit; "
        "sparse_gram = rounds × (1 reducer Gram + 1 eq. 7 scores) + final "
        f"fit), routes {routes}")
    check(launches["cd_solve_gram"] == model.rounds + 1,
          f"{tag}: cd_solve_gram launched {launches['cd_solve_gram']} times")
    check(launches["sparse_gram"] == model.rounds * 2 + 1,
          f"{tag}: sparse_gram launched {launches['sparse_gram']} times")
    # the reducers (8 jobs × 10240 rows) on clusters, the final fit's
    # 2048 rows on one CTA; one fused eq. 7 launch a round
    check(routes == {"sparse_gram/gram": model.rounds + 1,
                     "sparse_gram/scores": model.rounds,
                     "cd_solve_gram/cluster": model.rounds,
                     "cd_solve_gram/single": 1},
          f"{tag}: the fit took the routes {routes}")
    risks = [h["risk"] for h in model.history]
    check(all(math.isfinite(r) for r in risks),
          f"{tag}: risks not finite: {risks}")
    check(float(model.risk) < 1.0, f"{tag}: selected risk {float(model.risk)}")
    Xp = X.reshape(L, n_all // L, X.shape[1])
    yp = y.reshape(L, -1)
    acc = float((T.predict(model, X, cfg) == y).float().mean())
    major = float(max((y > 0).float().mean(), (y < 0).float().mean()))
    pick, pick_risk = pick_accuracy(torch, T, Xp, yp, torch.ones_like(yp),
                                    cfg, model)
    say(f"[{tag}] training accuracy: eq. 7 pick {pick:.4f} (replayed, "
        f"R_emp {pick_risk:.6f} vs {float(model.risk):.6f} in the fit), "
        f"final model {acc:.4f}, majority class {major:.4f}")
    check(abs(pick_risk - float(model.risk)) <= 1e-4,
          f"{tag}: replayed eq. 7 pick differs from the fit's")
    return cfg, model, launches, pick, major, fit_ms


# On these unit-norm rows k(x, z) = e^(−2γ(1 − x·z)). On a CPU cut of
# the full-width cell (8 × 256 rows, the plain versions) the eq. 7
# pick did not beat the majority class at γ = 0.1–4 and did at 8, 16
# and 64: k then nearly vanishes off the diagonal, and the pick gets
# its own partition's rows right (PERF.md §6).
RBF_PICK_GAMMA = 8.0


def phase_full_kernel(torch, T, ops, ref):
    """Slice 2's main path at svm-tfidf widths: blocked-CSR rows, rbf on
    the Gram path with gram_impl="pallas_sparse"; then the same rows
    with rbf at γ = RBF_PICK_GAMMA and with the linear kernel on the
    Gram path, whose eq. 7 picks must beat the majority class."""
    from repro_torch.configs import SVM_TFIDF
    from repro_torch.data.pipeline import svm_rows_sparse_device
    L, per, d = 8, SVM_TFIDF.rows_per_device, SVM_TFIDF.num_features
    cap = SVM_TFIDF.nnz_cap
    t0 = time.perf_counter()
    X, y = svm_rows_sparse_device(L * per, d, cap, seed=0, nnz=cap,
                                  dtype=torch.float32, device=DEV)
    torch.cuda.synchronize()
    say(f"[full-kernel] data: {L * per} rows × {d} features, nnz_cap {cap}, "
        f"f32 values ({(X.values.numel() * 8) / 1e6:.0f} MB on the card) in "
        f"{time.perf_counter() - t0:.1f} s")

    # --- the main path: rbf, γ = 1 ---------------------------------------
    cfg, model, launches, pick, major, ms_g1 = _fit_full_gram(
        torch, T, ops, X, y, L, T.KernelConfig("rbf", gamma=1.0),
        "full-kernel")
    # At γ = 1 on these rows k(x, z) ≈ e⁻² for nearly every pair: the
    # rbf pick predicts the majority class, so "no worse than the
    # majority" is all this run can ask (PERF.md §6, PR 12). The
    # linear-kernel run below asks for better.
    check(pick >= major, "selected rbf hypothesis worse than the majority")
    Xp = X.reshape(L, per, d)
    yp, maskp = y.reshape(L, per), torch.ones((L, per), device=DEV)
    sg, sgs, cdg = time_sparse_kernels(torch, ops, ref, Xp, model.sv, yp,
                                       maskp, cfg)
    profile_round(torch, T, Xp, yp, maskp, model.sv, cfg)
    sg["launches"] = launches["sparse_gram/gram"]
    sgs["launches"] = launches["sparse_gram/scores"]
    cdg["launches"] = launches["cd_solve_gram"]

    # --- rbf at a γ whose pick must beat the majority -------------------
    _, model_g8, _, pick, major, ms_g8 = _fit_full_gram(
        torch, T, ops, X, y, L, T.KernelConfig("rbf", gamma=RBF_PICK_GAMMA),
        f"full-rbf-gamma{RBF_PICK_GAMMA:g}")
    check(pick > major, f"selected rbf (γ = {RBF_PICK_GAMMA:g}) hypothesis "
          "no better than the majority")

    # --- the sweep axis: the two fits above as one S = 2 sweep ------------
    params = T.sweep_grid(cfg.svm, gamma=[1.0, RBF_PICK_GAMMA])
    full_sweep(torch, T, ops, X, y, L, cfg, params, {0: model, 1: model_g8},
               "full-kernel-sweep", (ms_g1 + ms_g8) / 2,
               {"cd_solve_gram/cluster": lambda r: len(r.history),
                "cd_solve_gram/single": lambda r: 1,
                "sparse_gram/gram": lambda r: len(r.history) + 1,
                "sparse_gram/scores": lambda r: 2 * len(r.history)},
               solve="cd_solve_gram", bits=False, sync_round=False)
    del model, model_g8

    # --- the same kernels with a kernel that sees the planted signal ----
    _, _, _, pick, major, _ = _fit_full_gram(
        torch, T, ops, X, y, L, T.KernelConfig("linear"), "full-linear-gram")
    check(pick > major,
          "selected linear-Gram hypothesis no better than the majority")
    return [sg, sgs, cdg]


# --- slice 7: blocked-CSR rows on the linear path ---------------------------

SPARSE_CAPS = (1, 7, 32, 256, 300)


def _sparse_rows(torch, sp, gen, n, d, cap, dtype):
    """Blocked-CSR rows of about 0.8·cap nonzeros in ``cap`` slots, so
    most rows hold padding slots (index 0, value 0) and some are full;
    every third row also holds a real column 0 (its largest entry, so
    ``from_dense`` keeps it) beside its padding."""
    dev = torch.device(DEV)
    X = torch.rand((n, d), generator=gen, device=dev)
    X = X * (torch.rand((n, d), generator=gen, device=dev)
             < min(1.0, 0.8 * cap / d))
    X[::3, 0] = 2.0
    X = X / X.norm(dim=1, keepdim=True).clamp(min=1e-9)
    return sp.from_dense(X, cap).to(dtype=dtype)


def _same_ids_rows(torch, sp, gen, n, d, cap, dtype):
    """Heavy overlap: every row holds the same 3/4·cap columns (each row
    in its own slot order, a real column 0 among them) and padding."""
    dev = torch.device(DEV)
    k = max(1, 3 * cap // 4)
    cols = torch.randperm(d - 1, generator=gen, device=dev)[:k - 1] + 1
    cols = torch.cat([torch.zeros(1, dtype=cols.dtype, device=dev), cols])
    order = torch.rand((n, k), generator=gen, device=dev).argsort(1)
    idx = torch.zeros((n, cap), dtype=torch.int32, device=dev)
    val = torch.zeros((n, cap), dtype=torch.float32, device=dev)
    idx[:, :k] = cols[order].int()
    val[:, :k] = torch.rand((n, k), generator=gen, device=dev) + 0.05
    val = val / val.norm(dim=1, keepdim=True)
    return sp.SparseRows(idx, val.to(dtype), d)


def _cds_case(torch, ops, ref, sp, gen, L, per, S, d, cap, dtype,
              rows=None, tag=None):
    """cd_solve/sparse against its plain version on L jobs of per home
    rows and S shared rows (every tenth shared row dead: value 0, ids
    kept, as SV_global's dead slots), masked rows, and job 0 all masked,
    so that it stops after one epoch while the others go on; rows from
    :func:`_sparse_rows` unless given (L · per + S of them). Then, over
    3 epochs, the kernel against ``svm_step.emulate_sparse_lookahead``
    (its look-ahead, corrections and sum order, run on the CPU) bit for
    bit. → whether the jobs ran different epoch counts."""
    from repro_torch.kernels import svm_step
    dev = torch.device(DEV)
    if rows is None:
        rows = _sparse_rows(torch, sp, gen, L * per + S, d, cap, dtype)
    xh = rows[:L * per].reshape(L, per, d)
    live = (torch.arange(S, device=dev) % 10 != 3).float()[:, None]
    xs = rows[L * per:] * live
    y = _labels(torch, gen, sp.to_dense(rows).float())
    y_aug = torch.cat([y[:L * per].reshape(L, per),
                       y[L * per:].expand(L, S)], 1).contiguous()
    m_aug = (torch.rand(y_aug.shape, generator=gen, device=dev) > 0.1
             ).float()
    m_aug[0] = 0.0
    staggered = False
    tag = (f"{tag or ''}{'bf16' if dtype == torch.bfloat16 else 'f32'} "
           f"L={L} per={per} S={S} d={d} nnz_cap={cap}")
    args = (xh, xs, y_aug, m_aug)
    for epochs, tol in ((1, 1e-5), (20, 1e-4)):
        kw = dict(C=1.0, tol=1e-3, max_epochs=epochs)
        ops.reset_launches()
        k = ops.cd_solve(*args, **kw)
        torch.cuda.synchronize()
        route = _routes(ops, "cd_solve")
        p = ref.cd_solve_sparse_ref(*args, **kw)
        err = max(float((a - b).abs().max()) for a, b in zip(k[:3], p[:3]))
        say(f"[kernels] cd_solve/sparse {tag} epochs≤{epochs}: epochs "
            f"{k[3].tolist()} vs plain {p[3].tolist()}, max|Δ(α,w,b)|="
            f"{err:.2e} (atol {tol:g}), routes {route}")
        check(route["sparse"] == 1 == ops.LAUNCHES["cd_solve"],
              f"cd_solve {tag} took the routes {route}")
        check(torch.equal(k[3], p[3]), "cd_solve/sparse epochs differ")
        check(err <= tol, f"cd_solve/sparse differs from plain by {err:.2e}")
        check(not k[0][m_aug == 0].any(), "a masked row's α moved")
        again = ops.cd_solve(*args, **kw)
        check(all(torch.equal(a, b) for a, b in zip(k, again)),
              f"cd_solve/sparse {tag}: rerun not bit-identical")
        staggered |= len(set(k[3].tolist())) > 1
    kw = dict(C=1.0, tol=1e-3, max_epochs=3)
    k = ops.cd_solve(*args, **kw)
    cpu = [a.cpu() if torch.is_tensor(a) else a.to(device="cpu")
           for a in args]
    e = svm_step.emulate_sparse_lookahead(*cpu, **kw)
    same = all(torch.equal(a.cpu(), b) for a, b in zip(k, e))
    say(f"[kernels] cd_solve/sparse {tag} epochs≤3 vs its emulation "
        f"(look-ahead {svm_step.sparse_lookahead(per + S)}): bit-identical "
        f"{same}")
    check(same, f"cd_solve/sparse {tag} differs from its emulation")
    return staggered


def phase_sparse_linear_small(torch, ops, ref, sp):
    """cd_solve/sparse and hinge_scores/sparse against their plain
    versions at small shapes: f32 and bf16 values, nnz_cap 1, 7, 32,
    256 and 300, ragged n, padding slots, a real column 0 beside them,
    masked rows, dead SV slots, S = 0, per = 1, a job that stops first;
    for the hinge L = 1, 8 and 9 (two launches) and W from 1e-30 to 1e3.
    Tolerances: the kernels sum in another order than the plain
    versions' slot order, so values agree to float32 rounding (the
    solve's α, w, b within 1e-5 after one epoch, 1e-4 after 20; the
    hinge losses within 1e-4 relative); epochs and counts are equal and
    reruns bit-identical."""
    dev = torch.device(DEV)
    gen = torch.Generator(device=dev).manual_seed(7)
    staggered = False
    for L, per, S, d, cap, dtype in (
            (4, 200, 64, 4096, 32, torch.float32),
            (3, 97, 31, 4096, 7, torch.bfloat16),
            (2, 50, 0, 4096, 256, torch.bfloat16),
            (5, 1, 16, 4096, 300, torch.float32),
            (8, 33, 20, 8192, 1, torch.float32),
            (3, 40, 24, 2048, 256, torch.float32)):
        staggered |= _cds_case(torch, ops, ref, sp, gen, L, per, S, d, cap,
                               dtype)
    check(staggered, "no job stopped before the others")
    # heavy overlap: every row on the same columns; the golden text rows
    for L, per, S, cap, dtype in ((3, 60, 20, 32, torch.float32),
                                  (2, 40, 10, 256, torch.bfloat16)):
        rows = _same_ids_rows(torch, sp, gen, L * per + S, 4096, cap, dtype)
        _cds_case(torch, ops, ref, sp, gen, L, per, S, 4096, cap, dtype,
                  rows=rows, tag="same ids on every row, ")
    from repro_torch import text
    corpus = text.generate(text.CorpusConfig(num_messages=1024,
                                             classes=(-1, 1), seed=0))
    rows, _ = text.fit_transform(
        text.vectorize_sparse(corpus.texts, 1024, nnz_cap=32), device=DEV)
    _cds_case(torch, ops, ref, sp, gen, 8, 96, 128, 1024, 32, torch.float32,
              rows=rows[:8 * 96 + 128], tag="golden text rows, ")
    _sparse_id_check(torch, ops, sp, gen)

    from repro_torch.kernels import hinge_score
    ops.reset_launches()
    worst, cases, emu_ok = 0.0, 0, True
    d = 4096
    for dtype in (torch.float32, torch.bfloat16):
        for n in (1, 65, 1000):
            y = torch.where(torch.rand((n,), generator=gen, device=dev) > 0.5,
                            1.0, -1.0)
            m = (torch.rand((n,), generator=gen, device=dev) > 0.25).float()
            for cap in SPARSE_CAPS:
                X = _sparse_rows(torch, sp, gen, n, d, cap, dtype)
                for L in (1, 8, 9):
                    mag = torch.empty((L, d), device=dev).uniform_(
                        -30.0, 3.0, generator=gen)
                    W = torch.randn((L, d), generator=gen, device=dev) \
                        * 10.0 ** mag
                    b = torch.randn((L,), generator=gen, device=dev)
                    loss, cnt = ops.hinge_scores(X, W, b, y, m)
                    lp, cp = ref.hinge_scores_ref(X, W, b, y, m)
                    rel = float(((loss - lp).abs()
                                 / lp.abs().clamp(min=1e-30)).max())
                    worst = max(worst, rel)
                    check(float(cnt) == float(cp), f"hinge_scores/sparse "
                          f"n={n} cap={cap} L={L}: count {float(cnt)} vs "
                          f"{float(cp)}")
                    check(torch.equal(ops.hinge_scores(X, W, b, y, m)[0],
                                      loss), "hinge_scores/sparse rerun not "
                          f"bit-identical (n={n} cap={cap} L={L})")
                    # W as cd_solve/sparse returns it: read packed, the
                    # same arithmetic; and the emulation, on the CPU
                    Wp = torch.zeros((d, -(-L // 8) * 8), device=dev)
                    Wp[:, :L] = W.T
                    check(torch.equal(ops.hinge_scores(X, Wp[:, :L].T, b, y,
                                                       m)[0], loss),
                          f"hinge_scores/sparse n={n} cap={cap} L={L}: "
                          "packed W differs")
                    Xc = X.to(device="cpu")
                    emu = [hinge_score.emulate_sparse(
                        Xc, W[l0:l0 + 8].cpu(), b[l0:l0 + 8].cpu(), y.cpu(),
                        m.cpu()) for l0 in range(0, L, 8)]
                    emu_ok &= torch.equal(loss.cpu(), torch.cat(
                        [e[0] for e in emu])) and torch.equal(
                        cnt.cpu(), emu[-1][1])
                    cases += 1
    routes = _routes(ops, "hinge_scores")
    say(f"[kernels] hinge_scores/sparse: max rel Δ = {worst:.2e} over "
        f"{cases} cases (rtol 1e-4); counts equal, reruns bit-identical, "
        f"W read packed equal; bit-identical to its emulation {emu_ok}; "
        f"routes {routes}")
    check(worst <= 1e-4, f"hinge_scores/sparse differs from plain by "
          f"{worst:.2e}")
    check(emu_ok, "hinge_scores/sparse differs from its emulation")
    check(routes["sparse"] == ops.LAUNCHES["hinge_scores"] > 0,
          "hinge_scores on SparseRows did not take the sparse route")


def _sparse_id_check(torch, ops, sp, gen):
    """A column id ≥ d raises ValueError on the card before any launch, in
    cd_solve and hinge_scores, for fresh rows and for checked rows whose
    ids were then changed in place; checked rows pass without a device
    round trip."""
    dev = torch.device(DEV)
    L, per, S, d, cap = 2, 30, 8, 4096, 32
    rows = _sparse_rows(torch, sp, gen, L * per + S, d, cap, torch.float32)
    y = torch.ones((L, per + S), device=dev)
    kw = dict(C=1.0, tol=1e-3, max_epochs=1)
    W = torch.zeros((1, d), device=dev)
    b = torch.zeros((1,), device=dev)

    def calls(x):
        xh, xs = x[:L * per].reshape(L, per, d), x[L * per:]
        return (lambda: ops.cd_solve(xh, xs, y, y, **kw),
                lambda: ops.hinge_scores(x[:per], W, b, y[0, :per],
                                         y[0, :per]))

    def refused(call) -> bool:
        ops.reset_launches()
        try:
            call()
        except ValueError:
            return sum(ops.LAUNCHES.values()) == 0
        return False

    bad = sp.SparseRows(rows.indices.clone(), rows.values.clone(), d)
    bad.indices[1, 0] = d
    fresh = all(refused(c) for c in calls(bad))
    ops.check_column_ids(rows)
    from repro_torch.analysis import no_implicit_host_sync
    with no_implicit_host_sync():
        for c in calls(rows):
            c()
    rows.indices[0, 0] = d + 5
    changed = all(refused(c) for c in calls(rows))
    say(f"[kernels] column id ≥ d: refused before any launch for fresh rows "
        f"{fresh} and for checked rows changed in place {changed}; checked "
        "rows ran under no_implicit_host_sync")
    check(fresh and changed, "an out-of-range column id was not refused")


def _linear_route_counts(ops):
    return {k: v for k, v in ops.ROUTE_LAUNCHES.items()
            if k.startswith(("cd_solve/", "hinge_scores/")) and v}


def _same_rounds(hist_a, hist_b, what, picks=False):
    """Rounds, R_emp per round within 1e-4 (and reducer picks, if
    asked) of two fits' histories; → max |ΔR_emp|."""
    check(len(hist_a) == len(hist_b),
          f"{what}: {len(hist_a)} rounds vs {len(hist_b)}")
    diff = max(abs(a["risk"] - b["risk"]) for a, b in zip(hist_a, hist_b))
    check(diff <= 1e-4, f"{what}: R_emp per round differs by {diff:.2e}")
    if picks:
        check([a["reducer"] for a in hist_a] == [b["reducer"]
                                                 for b in hist_b],
              f"{what}: reducer picks differ")
    return diff


def phase_sparse_pipeline(torch, T, text, sp):
    """The golden pipeline of phase 3 on ``vectorize_sparse(…,
    nnz_cap=32)`` rows through the sparse TF×IDF linear path, with the
    reference's golden floors; every launch on the two sparse routes;
    R_emp per round within 1e-4 of the dense fit on the same rows."""
    from repro_torch.kernels import ops
    svm = dict(C=1.0, max_epochs=15)
    cfg = T.MRSVMConfig(sv_capacity=128, gamma=1e-4, max_rounds=4,
                        svm=T.SVMConfig(**svm, row_format="sparse_csr",
                                        nnz_cap=32))
    dcfg = T.MRSVMConfig(sv_capacity=128, gamma=1e-4, max_rounds=4,
                         svm=T.SVMConfig(**svm))
    for classes, floor in (((-1, 1), 0.85), ((-1, 0, 1), 0.75)):
        corpus = text.generate(text.CorpusConfig(num_messages=1024,
                                                 classes=classes, seed=0))
        X, _ = text.fit_transform(
            text.vectorize_sparse(corpus.texts, 1024, nnz_cap=32),
            device=DEV)
        y = torch.tensor(corpus.labels, dtype=torch.float32, device=DEV)
        ops.reset_launches()
        t0 = time.perf_counter()
        if len(classes) == 2:
            model = T.fit_mapreduce(X[:768], y[:768], 8, cfg)
            pred = T.predict(model, X[768:], cfg)
            hists = [model.history]
        else:
            model = T.fit_one_vs_rest(X[:768], y[:768], list(classes), 8, cfg)
            pred = model.predict(X[768:])
            hists = [model.models[c].history for c in classes]
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        routes = _linear_route_counts(ops)
        launches = {k: v for k, v in ops.LAUNCHES.items() if v}
        acc = float((pred == y[768:].to(pred.dtype)).float().mean())
        Xd = sp.to_dense(X)
        if len(classes) == 2:
            dense = [T.fit_mapreduce(Xd[:768], y[:768], 8, dcfg).history]
        else:
            dm = T.fit_one_vs_rest(Xd[:768], y[:768], list(classes), 8, dcfg)
            dense = [dm.models[c].history for c in classes]
        diff = max(_same_rounds(a, b, f"sparse golden {len(classes)}-class")
                   for a, b in zip(hists, dense))
        say(f"[sparse-pipeline] {len(classes)}-class: held-out accuracy "
            f"{acc:.4f} (floor {floor}), fit+predict {ms:.1f} ms, round "
            f"risks {[round(h['risk'], 6) for h in hists[0]]}, max |ΔR_emp| "
            f"vs dense rows {diff:.2e} (atol 1e-4), launches {launches}, "
            f"routes {routes}")
        check(acc > floor, f"sparse {len(classes)}-class accuracy {acc:.4f}")
        check(set(launches) == {"cd_solve", "hinge_scores"}
              and routes == {"cd_solve/sparse": launches["cd_solve"],
                             "hinge_scores/sparse": launches["hinge_scores"]},
              f"the sparse golden run took the routes {routes}")
        if len(classes) == 2:
            _card_vs_cpu_entry_points(torch, T, text, sp, model, X, y, cfg)


def _card_vs_cpu_entry_points(torch, T, text, sp, model, X, y, cfg):
    """Slice 7's two other entry points, once on the card and once on the
    CPU (the plain versions) with the same inputs: ``update_mapreduce``
    of the golden 2-class model on the 256 held-out blocked-CSR rows
    (new rows ∪ the carried SVs; the same rounds and reducer picks, R_emp
    within 1e-4, as kernel and plain sum in other orders), and χ²
    ``select_top_k`` on the rows densified (scores within 1e-5 of the
    largest, 0 where the CPU's are, the same 256 features, ties at zero
    mass by the lower index)."""
    from repro_torch.kernels import ops
    ops.reset_launches()
    card = T.update_mapreduce(model, X[768:], y[768:], 8, cfg)
    torch.cuda.synchronize()
    routes = _linear_route_counts(ops)
    cpu = T.update_mapreduce(model, X[768:].to(device="cpu"),
                             y[768:].cpu(), 8, cfg, device="cpu")
    diff = _same_rounds(card.history, cpu.history,
                        "update_mapreduce card vs CPU", picks=True)
    ids_c, ids_p = card.sv.ids.cpu(), cpu.sv.ids
    say(f"[sparse-pipeline] update_mapreduce on 256 new rows ∪ "
        f"{int(model.sv.mask.sum())} carried SVs: {card.rounds} rounds, "
        f"R_emp {[round(h['risk'], 6) for h in card.history]}, max "
        f"|ΔR_emp| vs the CPU {diff:.2e} (atol 1e-4), SV ids equal "
        f"{int((ids_c == ids_p).sum())} of {ids_c.numel()}, routes {routes}")
    check(sp.is_sparse(card.sv.x) and routes and set(routes) ==
          {"cd_solve/sparse", "hinge_scores/sparse"},
          f"update_mapreduce took the routes {routes}")
    Xd = sp.to_dense(X)
    classes = (-1, 1)
    s_card = text.chi2_scores(Xd, y, classes)
    s_cpu = text.chi2_scores(Xd.cpu(), y.cpu(), classes)
    Xk_card, idx_card = text.select_top_k(Xd, y, classes, 256)
    Xk_cpu, idx_cpu = text.select_top_k(Xd.cpu(), y.cpu(), classes, 256)
    # Scale: the largest score. A feature whose mass splits as the classes
    # do scores Σ (O − E)² / E with O ≈ E, and its f32 rounding of O and E
    # (other sum orders on the card) is large against that score itself.
    err = (s_card.cpu() - s_cpu).abs()
    rel = float(err.max() / s_cpu.abs().max())
    zero = int((s_cpu == 0).sum())
    say(f"[sparse-pipeline] chi2 on the card vs the CPU: scores max |Δ| "
        f"{rel:.2e} of the largest (tol 1e-5; per score at most "
        f"{float((err / s_cpu.abs().clamp(min=1e-12)).max()):.2e}), {zero} "
        f"of {s_cpu.numel()} features of zero mass (score 0 on both: "
        f"{bool((s_card.cpu()[s_cpu == 0] == 0).all())}), top-256 equal "
        f"{bool(torch.equal(idx_card.cpu(), idx_cpu))}")
    check(rel <= 1e-5 and bool((s_card.cpu()[s_cpu == 0] == 0).all()),
          f"chi2_scores card vs CPU differ by {rel:.2e} of the largest")
    check(torch.equal(idx_card.cpu(), idx_cpu)
          and torch.equal(Xk_card.cpu(), Xk_cpu),
          "select_top_k picks other features on the card")


def time_cd_solve_sparse(torch, T, ops, ref, Xp, yp, maskp, cfg):
    """cd_solve/sparse at the main path's shapes: one epoch of round 0
    (home rows + the empty SV buffer) against plain, rerun, timed; one
    launch of the fit's epochs timed."""
    L, per, d = Xp.shape
    cap = cfg.sv_capacity
    sv = T.init_sv_buffer(cap, d, Xp.dtype, DEV, nnz_cap=Xp.nnz_cap)
    y_aug = torch.cat([yp, sv.y.expand(L, cap)], 1).float().contiguous()
    m_aug = torch.cat([maskp, sv.mask.expand(L, cap)], 1).float().contiguous()
    kw = dict(C=cfg.svm.C, tol=cfg.svm.tol, max_epochs=1)
    args = (Xp, sv.x, y_aug, m_aug)
    ops.reset_launches()
    k = ops.cd_solve(*args, **kw)
    check(ops.ROUTE_LAUNCHES["cd_solve/sparse"] == 1,
          f"full-width cd_solve took the routes {_routes(ops, 'cd_solve')}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p = ref.cd_solve_sparse_ref(*args, **kw)
    torch.cuda.synchronize()
    plain = 1e3 * (time.perf_counter() - t0)
    err = max(float((a - b).abs().max()) for a, b in zip(k[:3], p[:3]))
    Xflat = Xp.reshape(L * per, d)
    yflat, mflat = yp.reshape(-1).float(), maskp.reshape(-1).float()

    def risk(out):
        return ref.hinge_scores_ref(Xflat, out[1], out[2], yflat,
                                           mflat)[0] / mflat.sum()

    rerr = float((risk(k) - risk(p)).abs().max())
    again = ops.cd_solve(*args, **kw)
    same = all(torch.equal(a, b) for a, b in zip(k, again))
    say(f"[kernels] cd_solve/sparse one epoch L={L} per={per} S={cap} d={d} "
        f"nnz_cap {Xp.nnz_cap} {str(Xp.dtype).split('.')[-1]}: max|Δ(α,w,b)| "
        f"{err:.2e} (atol 1e-4), hinge risk max|Δ| {rerr:.2e} (atol 1e-5), "
        f"epochs {k[3].tolist()} vs {p[3].tolist()}, rerun bit-identical "
        f"{same}")
    check(err <= 1e-4 and rerr <= 1e-5 and torch.equal(k[3], p[3]),
          "cd_solve/sparse differs from plain at full width")
    check(same, "cd_solve/sparse rerun not bit-identical at full width")
    ms = cuda_ms(torch, lambda: ops.cd_solve(*args, **kw), 5)
    prep_ms = cuda_ms(torch, lambda: ops.cd_solve(*args, **dict(
        kw, max_epochs=0)), 5)
    kw_fit = dict(kw, max_epochs=cfg.svm.max_epochs)
    launch_ms = cuda_ms(torch, lambda: ops.cd_solve(*args, **kw_fit), 2)
    epochs = ops.cd_solve(*args, **kw_fit)[3]
    # the function's work in one epoch: every slot of the home rows and
    # the shared rows read once, y, m in, α, w, b out; 2 flop a live slot
    # for w·x and 2 more a live slot of each row whose α moved
    n = per + cap
    live_h = (Xp.values != 0).sum(-1).reshape(L, per)
    live_s = (sv.x.values != 0).sum(-1)
    live = torch.cat([live_h, live_s.expand(L, cap)], 1).float()
    moved = p[0] != 0
    flops = 2.0 * float(live.sum()) + 2.0 * float(live[moved].sum())
    slot_bytes = (L * per + cap) * Xp.nnz_cap * (4 + Xp.values.element_size())
    nbytes = slot_bytes + 2 * L * n * 4 + L * n * 4 + L * d * 4 + 3 * L * 4
    bms, by = bound_ms(nbytes, flops)
    step_us = 1e3 * (ms - prep_ms) / n
    say(f"[kernels] cd_solve/sparse: {ms:.3f} ms a one-epoch call through "
        f"the wrapper, of which the prep kernel (row blocks, Q, look-ahead "
        f"table) and the wrapper {prep_ms:.3f} ms (a 0-epoch call); "
        f"{step_us:.3f} µs a row step; one launch of {epochs.tolist()} "
        f"epochs {launch_ms:.3f} ms; plain {plain:.3f} ms an epoch; bound "
        f"{bms:.4f} ms ({by}), chain at the no-gather floor: see "
        f"--variants; {int(moved.sum())} of {L * n} rows moved α")
    return dict(name="cd_solve/sparse", route="cuda", source=CDS_SRC,
                replaces=CDS_TPU, max_abs_err=err, ms=ms, plain_ms=plain,
                bound_ms=bms, bound_by=by, library_ms=None)


def time_hinge_sparse(torch, ops, ref, X, y, m, W, b):
    """hinge_scores/sparse at the main path's shapes against plain,
    rerun, timed, with the library call ``torch.sparse.mm`` of the rows
    as a CSR tensor by Wᵀ plus the hinge in torch as the yardstick."""
    n, d = X.shape
    L = W.shape[0]
    ops.reset_launches()
    loss_k, cnt_k = ops.hinge_scores(X, W, b, y, m)
    check(ops.ROUTE_LAUNCHES["hinge_scores/sparse"] == 1,
          f"hinge_scores took the routes {_routes(ops, 'hinge_scores')}")
    loss_p, cnt_p = ref.hinge_scores_ref(X, W, b, y, m)
    torch.cuda.synchronize()
    rel = float(((loss_k - loss_p).abs() / loss_p.abs().clamp(min=1e-30))
                .max())
    err = float((loss_k - loss_p).abs().max())
    same = torch.equal(ops.hinge_scores(X, W, b, y, m)[0], loss_k)
    cap = X.nnz_cap
    crow = torch.arange(0, n * cap + 1, cap, device=DEV)
    Xcsr = torch.sparse_csr_tensor(crow, X.indices.reshape(-1).long(),
                                   X.values.reshape(-1).float(), (n, d),
                                   check_invariants=False)
    Wt = W.T.contiguous()

    def library():
        s = torch.sparse.mm(Xcsr, Wt) + b
        return (torch.clamp(1 - y[:, None] * s, min=0) * m[:, None]).sum(0)

    lib_rel = float(((library() - loss_p).abs()
                     / loss_p.abs().clamp(min=1e-30)).max())
    # W as the main path hands it over: cd_solve/sparse's (d, 8) array
    Wp = torch.zeros((d, 8), device=DEV)
    Wp[:, :L] = W.T
    Wv = Wp[:, :L].T
    check(torch.equal(ops.hinge_scores(X, Wv, b, y, m)[0], loss_k),
          "hinge_scores/sparse: packed W differs")
    say(f"[kernels] hinge_scores/sparse n={n} d={d} nnz_cap {cap} L={L} "
        f"{str(X.dtype).split('.')[-1]} values: max rel Δ {rel:.2e} (rtol "
        f"1e-4), count {float(cnt_k)} vs {float(cnt_p)}, rerun "
        f"bit-identical {same}; the library call's rel Δ {lib_rel:.2e}")
    check(rel <= 1e-4 and float(cnt_k) == float(cnt_p),
          "hinge_scores/sparse differs from plain")
    check(same, "hinge_scores/sparse rerun not bit-identical")
    ms = cuda_ms(torch, lambda: ops.hinge_scores(X, Wv, b, y, m), 20)
    rows_ms = cuda_ms(torch, lambda: ops.hinge_scores(X, W, b, y, m), 20)
    plain = cuda_ms(torch, lambda: ref.hinge_scores_ref(X, W, b, y, m), 2)
    lib = cuda_ms(torch, library, 20)
    live = int((X.values != 0).sum())
    nbytes = n * cap * (4 + X.values.element_size()) + L * d * 4 + L * 4 \
        + 2 * n * 4 + L * 4 + 4
    bms, by = bound_ms(nbytes, 2.0 * live * L)
    say(f"[kernels] hinge_scores/sparse: {ms:.3f} ms a call through the "
        f"wrapper with W as cd_solve/sparse returns it (read packed), "
        f"{rows_ms:.3f} ms with W as (L, d) rows (packed by the wrapper); "
        f"plain {plain:.3f} ms, library (torch.sparse.mm of CSR rows by Wᵀ "
        f"+ hinge) {lib:.3f} ms, bound {bms:.4f} ms ({by})")
    return dict(name="hinge_scores/sparse", route="cuda", source=HINGE_SRC,
                replaces=HS_SPARSE_TPU, max_abs_err=err, ms=ms,
                plain_ms=plain, bound_ms=bms, bound_by=by, library_ms=lib)


def phase_full_sparse(torch, T, ops, ref, sp):
    """Slice 7's main path at svm-tfidf widths: blocked-CSR rows
    (``nnz_cap`` = row nnz = 256, bf16 values, the config's dtype) on
    the linear path, no cut; the two kernels timed at its shapes; one
    round under ``no_implicit_host_sync`` and one profiled; last,
    the same rows densified and fit on the dense linear path, which must
    pick the same reducers and keep the same SV ids, with R_emp per
    round within 1e-4. The two paths differ as the reference's do:
    blocked-CSR bf16 rows round Σ v² of Q_ii to bf16 (``svm.py:165``),
    dense rows keep it in float32."""
    from repro_torch.configs import SVM_TFIDF
    from repro_torch.data.pipeline import svm_rows_sparse_device
    L, per, d = 8, SVM_TFIDF.rows_per_device, SVM_TFIDF.num_features
    cap = SVM_TFIDF.nnz_cap
    t0 = time.perf_counter()
    X, y = svm_rows_sparse_device(L * per, d, cap, seed=0, nnz=cap,
                                  dtype=torch.bfloat16, device=DEV)
    torch.cuda.synchronize()
    say(f"[full-sparse] data: {L * per} rows × {d} features, nnz_cap {cap}, "
        f"bf16 values ({X.values.numel() * 6 / 1e6:.0f} MB on the card) in "
        f"{time.perf_counter() - t0:.1f} s")
    svm = dict(C=SVM_TFIDF.C, max_epochs=SVM_TFIDF.max_epochs)
    mr = dict(sv_capacity=SVM_TFIDF.sv_capacity, gamma=1e-4, max_rounds=6)
    cfg = T.MRSVMConfig(svm=T.SVMConfig(**svm, row_format="sparse_csr",
                                        nnz_cap=cap), **mr)
    Xp, yp = X.reshape(L, per, d), y.to(X.dtype).reshape(L, per)
    maskp = torch.ones_like(yp)

    cds = time_cd_solve_sparse(torch, T, ops, ref, Xp, yp, maskp, cfg)
    gen = torch.Generator(device=DEV).manual_seed(1)
    W = torch.randn((L, d), generator=gen, device=DEV) * 0.05
    b = torch.randn((L,), generator=gen, device=DEV) * 0.1
    hs = time_hinge_sparse(torch, ops, ref, X, y, torch.ones_like(y), W, b)
    torch.cuda.synchronize()

    # --- the main path: counts from 0, one fit_mapreduce, counts read --
    ops.reset_launches()
    t0 = time.perf_counter()
    model = T.fit_mapreduce(X, y, L, cfg, verbose=True)
    torch.cuda.synchronize()
    fit_ms = 1e3 * (time.perf_counter() - t0)
    launches = dict(ops.LAUNCHES)
    routes = _linear_route_counts(ops)
    for h in model.history:
        say(f"[full-sparse] round {h['round']}: R_emp={h['risk']:.6f} "
            f"|SV|={h['sv_count']} reducer={h['reducer']} "
            f"round_ms={h['ms']:.1f}")
    say(f"[full-sparse] fit_mapreduce: {model.rounds} rounds in "
        f"{fit_ms:.1f} ms, launches {launches} (cd_solve = rounds + final "
        f"fit, one count a call of its prep and solve kernels; hinge_scores "
        f"= rounds), routes {routes}")
    check(routes == {"cd_solve/sparse": model.rounds + 1,
                     "hinge_scores/sparse": model.rounds}
          and launches["cd_solve"] == model.rounds + 1
          and launches["hinge_scores"] == model.rounds,
          f"the sparse fit took the routes {routes}")
    risks = [h["risk"] for h in model.history]
    check(all(math.isfinite(r) for r in risks), f"risks not finite: {risks}")
    check(bool(torch.isfinite(model.final.w).all()), "final w not finite")
    acc = float((T.predict(model, X, cfg) == y).float().mean())
    pick = float((T.predict(model, X, cfg, use_final=False) == y).float()
                 .mean())
    major = float(max((y > 0).float().mean(), (y < 0).float().mean()))
    say(f"[full-sparse] training accuracy: eq. 7 pick {pick:.4f}, final "
        f"model {acc:.4f}, majority class {major:.4f}")
    check(float(model.risk) < 1.0, f"selected risk {float(model.risk)}")
    check(pick > major, "selected hypothesis no better than the majority")
    # one round from the converged SV_global with no host sync in it: the
    # rows' ids checked once before it, then every check passes on the mark
    ops.check_column_ids(Xp)
    from repro_torch import analysis
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with analysis.no_implicit_host_sync():
        out = T.mapreduce_round(Xp, yp, maskp, model.sv, cfg)
    enqueue_ms = 1e3 * (time.perf_counter() - t0)
    risks_sync = out.risks.cpu()
    say(f"[full-sparse] one mapreduce_round under no_implicit_host_sync: "
        f"no host sync, enqueued in {enqueue_ms:.1f} ms, risks finite "
        f"{bool(torch.isfinite(risks_sync).all())}")
    check(bool(torch.isfinite(risks_sync).all()), "round risks not finite")
    del out, risks_sync
    # the dense-materialization rule's memory layer: one round's peak
    # device memory above what it found, under one dense copy of a job's
    # rows (per · d · 4 B, the reference's ceiling for a round)
    per, d = Xp.shape[1], Xp.shape[-1]
    limit = per * d * 4
    rep = analysis.check_memory_ceiling(
        lambda *a: T.mapreduce_round(*a, cfg), (Xp, yp, maskp, model.sv),
        limit_bytes=limit, program="full-sparse round")
    peak = int(rep.note.split()[1])
    say(f"[full-sparse] one blocked-CSR round's peak device memory "
        f"{peak} B ({peak / 2**30:.3f} GiB) under the ceiling {limit} B "
        f"({limit / 2**30:.3f} GiB): one dense copy of a job's {per} rows "
        f"× {d} f32")
    profile_round(torch, T, Xp, yp, maskp, model.sv, cfg)
    cds["launches"] = launches["cd_solve"]
    hs["launches"] = launches["hinge_scores"]
    params = T.sweep_grid(cfg.svm, C=SWEEP_C)
    S = len(params.C)
    full_sweep(torch, T, ops, X, y, L, cfg, params, {SWEEP_C_ONE: model},
               "full-sparse-sweep", fit_ms,
               {"cd_solve/sparse": lambda r: len(r.history) + 1,
                "hinge_scores/sparse":
                    lambda r: len(r.history) * -(-S * L // 8)})
    old = X.values[37, 0].clone()
    X.values[37, 0] = math.nan
    _nan_full(torch, ops, f"fit_mapreduce, blocked-CSR bf16 rows (nnz_cap "
              f"{cap})", lambda: T.fit_mapreduce(X, y, L, cfg))
    X.values[37, 0] = old

    # --- the same rows, dense ---------------------------------------------
    hist, ids = model.history, model.sv.ids
    del model, Xp, yp, maskp, W
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    Xd = sp.to_dense(X)
    torch.cuda.synchronize()
    say(f"[full-sparse] densified: {Xd.numel() * 2 / 1e9:.1f} GB bf16 in "
        f"{time.perf_counter() - t0:.1f} s")
    dcfg = T.MRSVMConfig(svm=T.SVMConfig(**svm), **mr)
    ops.reset_launches()
    t0 = time.perf_counter()
    dm = T.fit_mapreduce(Xd, y, L, dcfg)
    torch.cuda.synchronize()
    dense_ms = 1e3 * (time.perf_counter() - t0)
    diff = _same_rounds(hist, dm.history, "sparse vs dense at full width",
                        picks=True)
    live_s, live_d = set(ids[ids >= 0].tolist()), \
        set(dm.sv.ids[dm.sv.ids >= 0].tolist())
    overlap = len(live_s & live_d) / max(1, len(live_s | live_d))
    say(f"[full-sparse] dense fit on the same rows: {dm.rounds} rounds in "
        f"{dense_ms:.1f} ms (routes {_linear_route_counts(ops)}), reducers "
        f"{[h['reducer'] for h in dm.history]} (sparse "
        f"{[h['reducer'] for h in hist]}), max |ΔR_emp| per round "
        f"{diff:.2e} (atol 1e-4), SV ids shared {len(live_s & live_d)} of "
        f"{len(live_s)} / {len(live_d)} (Jaccard {overlap:.4f})")
    check(live_s == live_d, "the sparse and the dense fit keep other SV ids")
    del Xd, dm
    torch.cuda.empty_cache()
    return [cds, hs]


# --- slice 9: the sweep axis ------------------------------------------------

# The reference launcher's ``--sweep 4`` grid (``launch/train.py:98-100``):
# C = logspace(-2, 1, 4); its config 2 (C = 1) is the full-width fits'
SWEEP_C = [0.01, 0.1, 1.0, 10.0]
SWEEP_C_ONE = 2


def _sweep_jobs(torch, sp, gen, rows, L, per, S):
    """Home blocks (L, per, ·) and 2 shared blocks (2, S, ·) of ``rows``
    (L·per + 2S of them), labels and masks of 2·L jobs, config-major."""
    dev = torch.device(DEV)
    xh = rows[:L * per].reshape(L, per, rows.shape[-1])
    xs = rows[L * per:].reshape(2, S, rows.shape[-1])
    dense = rows if torch.is_tensor(rows) else sp.to_dense(rows)
    yr = _labels(torch, gen, dense.float())
    jobs = torch.arange(2 * L, device=dev)
    y = torch.cat([yr[:L * per].reshape(L, per)[jobs % L],
                   yr[L * per:].reshape(2, S)[jobs // L]], 1).contiguous()
    m = (torch.rand(y.shape, generator=gen, device=dev) > 0.1).float()
    return xh, xs, y, m


def _per_job_vs_one_a_job(torch, run, jobs, tag, bits=True):
    """``run(None)`` (all jobs, one launch) against ``run(j)`` (job j
    alone, its rows materialised, scalars): bit for bit, or within 1e-6
    relative where ``bits`` is False. → the batched output."""
    out = run(None)
    worst = 0.0
    for j in range(jobs):
        one = run(j)
        for a, b in zip(out, one):
            if bits:
                check(torch.equal(a[j], b[0]), f"{tag}: job {j} differs "
                      "from its own launch")
            else:
                worst = max(worst, float(((a[j] - b[0]).abs()
                                          / b[0].abs().clamp(min=1e-6)).max()))
    check(worst <= 1e-6, f"{tag}: a job differs from its own launch by "
          f"{worst:.2e}")
    return out


def phase_sweep_kernels_small(torch, ops, ref, sp):
    """Per-job hyper-parameters and the job → (home block, shared block)
    mapping of every solve and Gram kernel on the card: one launch of
    2·L jobs (two configs, C, tol and cutoffs per job, one cutoff 0)
    against one launch a job with scalars on the job's own rows, and
    against the plain version."""
    gen = torch.Generator(device=DEV).manual_seed(19)
    dev = torch.device(DEV)
    C = torch.tensor([0.5, 1.0, 2.0, 0.1, 1.0, 4.0], device=dev)
    tol = torch.tensor([1e-3, 1e-2, 1e-3, 1e-4, 1e-3, 1e-3], device=dev)
    cut = torch.tensor([3, 0, 8, 5, 1, 8], dtype=torch.int32, device=dev)
    L, per, S = 3, 40, 24
    cases = [("single", 1024, torch.float32, None),
             ("cluster", 32768, torch.bfloat16, None),
             ("sparse", 4096, torch.bfloat16, 48)]
    for route, d, dtype, cap in cases:
        if cap is None:
            rows = _rows(torch, gen, L * per + 2 * S, d, dtype, DEV)
        else:
            rows = _sparse_rows(torch, sp, gen, L * per + 2 * S, d, cap,
                                dtype)
        xh, xs, y, m = _sweep_jobs(torch, sp, gen, rows, L, per, S)

        def run(j):
            if j is None:
                return ops.cd_solve(xh, xs, y, m, C=C, tol=tol,
                                    max_epochs=cut)
            return ops.cd_solve(xh[j % L][None], xs[j // L], y[j:j + 1],
                                m[j:j + 1], C=float(C[j]), tol=float(tol[j]),
                                max_epochs=int(cut[j]))
        ops.reset_launches()
        out = _per_job_vs_one_a_job(torch, run, 2 * L, f"cd_solve/{route}")
        check(ops.ROUTE_LAUNCHES[f"cd_solve/{route}"] == 1 + 2 * L,
              f"per-job cd_solve took {_routes(ops, 'cd_solve')}")
        plain_fn = ref.cd_solve_sparse_ref if cap else ref.cd_solve_ref
        cpu = [a.to(device="cpu") for a in (xh, xs, y, m)]
        p = plain_fn(*cpu, C=C.cpu(), tol=tol.cpu(), max_epochs=cut.cpu())
        err = max(float((a.cpu() - b).abs().max())
                  for a, b in zip(out[:3], p[:3]))
        zero = not (out[0][1].any() or out[1][1].any() or out[2][1] != 0)
        say(f"[sweep-kernels] cd_solve/{route} {2 * L} jobs (2 shared "
            f"blocks, d={d}, {dtype}): one launch ≡ one launch a job bit "
            f"for bit; epochs {out[3].tolist()} (plain {p[3].tolist()}), "
            f"max|Δ(α,w,b)| vs plain {err:.2e} (atol 1e-4); the cutoff-0 "
            f"job all zero {zero}")
        check(torch.equal(out[3].cpu(), p[3]) and err <= 1e-4 and zero,
              f"per-job cd_solve/{route} against plain")
    # cd_solve_gram: per-job C, tol and cutoffs, f32 and bf16 state, on
    # K made exactly symmetric (the kernel reads Q[:, i] as K's row i)
    Xg = torch.randn((6, 300, 8), generator=gen, device=dev)
    K = torch.exp(-0.25 * torch.cdist(Xg, Xg) ** 2)
    K = 0.5 * (K + K.transpose(1, 2))
    yg = torch.where(torch.randn((6, 300), generator=gen, device=dev) > 0,
                     1.0, -1.0)
    mg = (torch.rand((6, 300), generator=gen, device=dev) > 0.1).float()
    for dt in (torch.float32, torch.bfloat16):
        Kd, yd, md = K.to(dt), yg.to(dt), mg.to(dt)

        def run(j):
            if j is None:
                return ops.cd_solve_gram(Kd, yd, md, C=C, tol=tol,
                                         max_epochs=cut)
            return ops.cd_solve_gram(Kd[j:j + 1], yd[j:j + 1], md[j:j + 1],
                                     C=float(C[j]), tol=float(tol[j]),
                                     max_epochs=int(cut[j]))
        out = _per_job_vs_one_a_job(torch, run, 6, f"cd_solve_gram {dt}")
        p = ref.cd_solve_gram_ref(Kd, yd, md, C=C, tol=tol, max_epochs=cut)
        same = all(torch.equal(a, b) for a, b in zip(out, p))
        say(f"[sweep-kernels] cd_solve_gram 6 jobs {dt}: one launch ≡ one "
            f"launch a job bit for bit; epochs {out[1].tolist()}; α, epochs "
            f"and violations bit for bit with plain {same}")
        check(same, f"per-job cd_solve_gram {dt} against plain")
    # gram / sparse_gram: per-job γ and coef0 over a stack of shared blocks
    g = torch.linspace(0.2, 2.0, 2 * L, device=dev)
    c0 = torch.linspace(-0.5, 0.5, 2 * L, device=dev)
    for fn, dtype, make in (
            (ops.gram, torch.bfloat16, lambda n: _rows(torch, gen, n, 1024,
                                                       torch.bfloat16, DEV)),
            (ops.gram, torch.float32, lambda n: _rows(torch, gen, n, 1024,
                                                      torch.float32, DEV)),
            (ops.sparse_gram, torch.float32, lambda n: _sparse_rows(
                torch, sp, gen, n, 4096, 32, torch.float32))):
        rows = make(L * per + 2 * S)
        xh, xs, _, _ = _sweep_jobs(torch, sp, gen, rows, L, per, S)
        side = (xh, xs, L)
        for kind in ("rbf", "poly"):
            def run(j):
                if j is None:
                    return (fn(side, side, kind=kind, gamma=g, coef0=c0,
                               degree=2),)
                r = sp.rows_concat(xh[j % L], xs[j // L])
                return (fn(r, r, kind=kind, gamma=float(g[j]),
                           coef0=float(c0[j]), degree=2)[None],)
            ops.reset_launches()
            (Kb,) = _per_job_vs_one_a_job(torch, run, 2 * L,
                                          f"{fn.__name__} {kind}", bits=False)
            check(sum(ops.LAUNCHES.values()) == 1 + 2 * L,
                  f"{fn.__name__} launches {dict(ops.LAUNCHES)}")
            cpu = (xh.to(device="cpu"), xs.to(device="cpu"), L)
            Kp = fn(cpu, cpu, kind=kind, gamma=g.cpu(), coef0=c0.cpu(),
                    degree=2)
            err = _rel(Kb.cpu(), Kp)
            say(f"[sweep-kernels] {fn.__name__} {kind} {dtype} {2 * L} jobs "
                f"(γ, coef0 per job, 2 shared blocks): one launch ≡ one "
                f"launch a job (rel 1e-6), vs plain rel {err:.2e} (1e-5)")
            check(err <= 1e-5, f"{fn.__name__} per-job vs plain {err:.2e}")


def _sweep_vs_fits(torch, res, fits, tag, bits=True):
    """Each config of a sweep against its sequential fit on the card
    (``fits``: config → MapReduceSVM): the same rounds, eq. 7 picks and
    SV ids, R_emp per round within 1e-6, and (``bits``) the best and
    final hypotheses bit for bit. → max |ΔR_emp|."""
    worst = 0.0
    for s, m in fits.items():
        hist = [h for h in res.history if h["reducers"][s] >= 0]
        check(len(hist) == m.rounds == int(res.rounds[s]),
              f"{tag} config {s}: {len(hist)} rounds vs {m.rounds}")
        check([int(h["reducers"][s]) for h in hist]
              == [h["reducer"] for h in m.history],
              f"{tag} config {s}: eq. 7 picks differ")
        worst = max([worst] + [abs(float(h["risks"][s]) - hm["risk"])
                               for h, hm in zip(hist, m.history)])
        check(torch.equal(res.sv.ids[s], m.sv.ids),
              f"{tag} config {s}: other SV ids")
        if bits:
            check(torch.equal(res.ws[s], m.w.float())
                  and torch.equal(res.final.w[s], m.final.w)
                  and torch.equal(res.final.b[s], m.final.b),
                  f"{tag} config {s}: hypotheses not bit-identical")
        else:
            check(torch.equal(res.final.alpha[s], m.final.alpha),
                  f"{tag} config {s}: final α not bit-identical")
    check(worst <= 1e-6, f"{tag}: R_emp per round differs by {worst:.2e}")
    return worst


def _sweep_run(torch, T, ops, X, y, L, cfg, params, tag, **kw):
    """One ``fit_mapreduce_sweep`` with the counts set to 0 before it and
    read after. → (result, ms, launches by kernel and route)."""
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = T.fit_mapreduce_sweep(X, y, L, cfg, params, **kw)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    launches = {k: v for k, v in {**ops.LAUNCHES, **ops.ROUTE_LAUNCHES}
                .items() if v}
    S = len(res.rounds)
    say(f"[{tag}] S={S}: {len(res.history)} rounds (per config "
        f"{res.rounds.tolist()}) in {ms:.1f} ms, round ms "
        f"{[round(h['ms'], 1) for h in res.history]}, launches {launches}")
    for h in res.history:
        say(f"[{tag}] round {h['round']}: active {h['active']}, R_emp "
            f"{[round(float(r), 6) for r in h['risks']]}, picks "
            f"{h['reducers'].tolist()}")
    check(bool(torch.isfinite(res.risks).all()), f"{tag}: risks not finite")
    return res, ms, launches


def _check_solve_launches(launches, res, tag, solve="cd_solve"):
    """One solve launch a round for all S·L jobs, one for the final
    retrain of the S configs."""
    check(launches.get(solve, 0) == len(res.history) + 1,
          f"{tag}: {solve} launched {launches.get(solve, 0)} times for "
          f"{len(res.history)} rounds")


def phase_sweep_golden(torch, T, text, sp):
    """The sweep axis at the golden test's settings on the card: linear
    dense and ``vectorize_sparse(…, nnz_cap=32)`` rows over C × tol, OvR
    3-class, per-job rows, an epoch-cutoff grid with one config at 0,
    and the rbf C × γ grid on ``gram`` and on ``sparse_gram``; each
    sweep's launches counted, each config against its sequential fit on
    the card, each sweep against the plain versions on the CPU (risks
    within 1e-4, the same rounds)."""
    from repro_torch.kernels import ops
    corpus = text.generate(text.CorpusConfig(num_messages=1024,
                                             classes=(-1, 1), seed=0))
    Xd, _ = text.fit_transform(text.vectorize(corpus.texts, 1024),
                               device=DEV)
    Xs, _ = text.fit_transform(
        text.vectorize_sparse(corpus.texts, 1024, nnz_cap=32), device=DEV)
    y = torch.tensor(corpus.labels, dtype=torch.float32, device=DEV)
    tr = slice(0, 768)
    mr = dict(sv_capacity=128, gamma=1e-4, max_rounds=4)
    svm = dict(C=1.0, max_epochs=15)
    rbf = T.KernelConfig("rbf", gamma=1.0)
    runs = [
        ("linear dense C×tol", Xd, T.SVMConfig(**svm),
         dict(C=[0.1, 1.0, 10.0], tol=[1e-3, 1e-2]), True),
        ("linear sparse C×tol", Xs,
         T.SVMConfig(**svm, row_format="sparse_csr", nnz_cap=32),
         dict(C=[0.1, 1.0, 10.0], tol=[1e-3, 1e-2]), True),
        ("epoch cutoffs", Xd, T.SVMConfig(**svm),
         dict(max_epochs=[0, 2, 15]), True),
        ("rbf C×γ gram", Xd,
         T.SVMConfig(**svm, kernel=rbf, use_gram=True, gram_impl="pallas"),
         dict(C=[1.0, 10.0], gamma=[0.5, 2.0]), False),
        ("rbf C×γ sparse_gram", Xs,
         T.SVMConfig(**svm, kernel=rbf, use_gram=True,
                     gram_impl="pallas_sparse", row_format="sparse_csr",
                     nnz_cap=32),
         dict(C=[1.0, 10.0], gamma=[0.5, 2.0]), False)]
    for tag, X, svm_cfg, axes, linear in runs:
        cfg = T.MRSVMConfig(svm=svm_cfg, **mr)
        params = T.sweep_grid(svm_cfg, **axes)
        res, ms, launches = _sweep_run(torch, T, ops, X[tr], y[tr], 8, cfg,
                                       params, f"sweep] [{tag}")
        _check_solve_launches(launches, res, tag,
                              "cd_solve" if linear else "cd_solve_gram")
        if "sparse" in tag:
            want = ("cd_solve/sparse", "hinge_scores/sparse") if linear \
                else ("sparse_gram/gram", "sparse_gram/scores")
        else:
            want = ("cd_solve/single", "hinge_scores/simt") if linear \
                else ("gram/simt", "cd_solve_gram/single")
        check(all(launches.get(k, 0) > 0 for k in want),
              f"{tag}: routes {launches}")
        t0 = time.perf_counter()
        fits = {s: T.fit_mapreduce(X[tr], y[tr], 8, cfg, params=T.SolverParams(
            *(float(f[s]) for f in params))) for s in range(len(res.rounds))}
        torch.cuda.synchronize()
        seq_ms = 1e3 * (time.perf_counter() - t0)
        diff = _sweep_vs_fits(torch, res, fits, tag, bits=linear)
        cpu = T.fit_mapreduce_sweep(X[tr].to(device="cpu"), y[tr].cpu(), 8,
                                    cfg, params, device="cpu")
        cerr = float((cpu.risks - res.risks).abs().max())
        acc = (T.predict_sweep(res, X[768:], cfg) == y[768:]).float() \
            .mean(1)
        say(f"[sweep] [{tag}] ≡ {len(fits)} sequential fits on the card "
            f"(picks, SV ids, max|ΔR_emp| {diff:.2e}"
            f"{', w and b bit for bit' if linear else ', final α bit for bit'}"
            f"; the fits {seq_ms:.1f} ms against the sweep's {ms:.1f}); vs "
            f"plain on the CPU max|Δrisk| {cerr:.2e} (1e-4), rounds "
            f"{cpu.rounds.tolist()}; held-out accuracy per config "
            f"{[round(float(a), 4) for a in acc]}, best config {res.best}")
        check(cerr <= 1e-4 and (cpu.rounds == res.rounds).all(),
              f"{tag}: the sweep differs from plain")
        if tag == "epoch cutoffs":
            check(not res.final.w[0].any() and float(res.final.b[0]) == 0.0
                  and int(res.final.epochs_run[0]) == 0,
                  "the cutoff-0 config's final model is not 0")
        if tag == "rbf C×γ gram":
            check(float(acc[res.best]) > 0.85, "golden rbf sweep best config")
    _golden_sweep_ovr_and_per_job(torch, T, text, Xd, y)


def _golden_sweep_ovr_and_per_job(torch, T, text, Xd, y):
    """The golden OvR 3-class sweep (job j = config j // 3, class j % 3;
    config 1 against ``fit_one_vs_rest`` at C = 1) and a sweep of two
    configs on two row sets of ``Xd`` (per-job rows)."""
    from repro_torch.kernels import ops
    tr = slice(0, 768)
    mr = dict(sv_capacity=128, gamma=1e-4, max_rounds=4)
    svm = dict(C=1.0, max_epochs=15)
    corpus3 = text.generate(text.CorpusConfig(num_messages=1024,
                                              classes=(-1, 0, 1), seed=0))
    X3, _ = text.fit_transform(text.vectorize(corpus3.texts, 1024),
                               device=DEV)
    y3 = torch.tensor(corpus3.labels, dtype=torch.float32, device=DEV)
    cfg = T.MRSVMConfig(svm=T.SVMConfig(**svm), **mr)
    params = T.sweep_grid(cfg.svm, C=[0.1, 1.0])
    ops.reset_launches()
    ovr = T.fit_one_vs_rest_sweep(X3[tr], y3[tr], [-1, 0, 1], 8, cfg, params)
    launches = dict(ops.LAUNCHES)
    _check_solve_launches(launches, ovr.result, "OvR sweep")
    seq = T.fit_one_vs_rest(X3[tr], y3[tr], [-1, 0, 1], 8, cfg)
    fits = {3 + k: seq.models[c] for k, c in enumerate((-1, 0, 1))}
    diff = _sweep_vs_fits(torch, ovr.result, fits, "OvR sweep")
    acc = (ovr.predict(X3[768:]) == y3[768:]).float().mean(1)
    say(f"[sweep] [OvR 3-class] 6 jobs: launches {launches}; config 1's "
        f"three classes ≡ fit_one_vs_rest at C = 1 (max|ΔR_emp| "
        f"{diff:.2e}); held-out accuracy {acc.tolist()}, best {ovr.best}")
    check(float(acc[1]) > 0.75, "OvR sweep accuracy at C = 1")
    # per-job rows: two configs on two row sets
    Xj = torch.stack([Xd[:768], Xd[256:]])
    yj = torch.stack([y[:768], y[256:]])
    cfg = T.MRSVMConfig(svm=T.SVMConfig(**svm), **mr)
    params = T.sweep_grid(cfg.svm, C=[1.0, 10.0])
    res, _, launches = _sweep_run(torch, T, ops, Xj, yj, 8, cfg, params,
                                  "sweep] [per-job rows")
    _check_solve_launches(launches, res, "per-job rows")
    fits = {s: T.fit_mapreduce(Xj[s], yj[s], 8, cfg, params=T.SolverParams(
        *(float(f[s]) for f in params))) for s in range(2)}
    diff = _sweep_vs_fits(torch, res, fits, "per-job rows")
    say(f"[sweep] [per-job rows] ≡ 2 sequential fits (max|ΔR_emp| "
        f"{diff:.2e}, bit for bit)")


def full_sweep(torch, T, ops, X, y, L, cfg, params, fits, tag, seq_ms,
               routes, solve="cd_solve", bits=True, sync_round=True):
    """A full-width sweep through ``fit_mapreduce_sweep``, counts from 0:
    its routes, its configs in ``fits`` (config → sequential fit made
    before) reproduced, its time beside S × the sequential fit's
    (``seq_ms``); then one round from its converged state profiled and
    (``sync_round``) one under ``no_implicit_host_sync`` (the
    eq. 8 readback after it). → the result."""
    import numpy as np
    from repro_torch.core import sweep as sweep_mod
    from repro_torch.kernels import hinge_score
    packs = []
    pack = hinge_score.pack
    hinge_score.pack = lambda W: packs.append(W.shape) or pack(W)
    try:
        res, ms, launches = _sweep_run(torch, T, ops, X, y, L, cfg, params,
                                       tag, fail_on_retrace=True)
    finally:
        hinge_score.pack = pack
    S = len(res.rounds)
    if launches.get("hinge_scores/sparse"):
        # the solve's (d, 8⌈S·L/8⌉) w is read in place, 8 hypotheses a
        # launch, never packed again
        check(not packs, f"{tag}: hinge_scores/sparse packed W {packs}")
    _check_solve_launches(launches, res, tag, solve)
    check(all(launches.get(k, 0) == n(res) for k, n in routes.items()),
          f"{tag}: routes {launches}, expected "
          f"{ {k: n(res) for k, n in routes.items()} }")
    diff = _sweep_vs_fits(torch, res, fits, tag, bits=bits)
    say(f"[{tag}] configs {sorted(fits)} ≡ their sequential fits (rounds, "
        f"picks, SV ids, max|ΔR_emp| {diff:.2e}, "
        f"{'w and b' if bits else 'final α'} bit for bit); the sweep "
        f"{ms:.1f} ms for S={S}, S × the sequential fit {S * seq_ms:.1f} ms "
        f"({S * seq_ms / ms:.2f}×)")
    Xp = X.reshape(L, -1, X.shape[-1])
    yp = y.to(X.dtype).reshape(L, -1)
    maskp = torch.ones_like(yp)

    def step(sv_b, eff):
        out = T.sweep_round(Xp, yp, maskp, sv_b, cfg, eff)
        return (out.sv, *sweep_mod.best_reducers(out))
    done = np.zeros(S, bool)
    profile(torch, lambda: sweep_mod.masked_step(
        step, res.sv, res.params, done)[1].cpu(), f"one sweep round ({tag})")
    if not sync_round:
        return res
    from repro_torch.analysis import no_implicit_host_sync
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with no_implicit_host_sync():
        _, picks, _, _ = sweep_mod.masked_step(step, res.sv, res.params, done)
    enqueue_ms = 1e3 * (time.perf_counter() - t0)
    picks = picks.cpu()
    torch.cuda.synchronize()
    say(f"[{tag}] the sweep ran with fail_on_retrace=True (no compile event "
        f"past round 0); one sweep round under no_implicit_host_sync: no "
        f"host sync, enqueued in {enqueue_ms:.1f} ms, risks "
        f"{picks[0].tolist()}")
    check(bool(torch.isfinite(picks).all()), f"{tag}: round risks")
    return res


# --- slice 3: the LM serve path --------------------------------------------

# flash_decode against its plain version: max |Δ| over max |plain|, the
# largest output. In f32 the two differ only in summation order; in bf16
# both round one f32 value to bf16, and 1e-6 apart can round one ulp
# apart: at most 2⁻⁷ of the largest output.
FD_TOL = {"float32": 1e-5, "bfloat16": 8e-3}
# The controls' chunk: one chunk of the SIMT route (kChunk), an eighth of
# the tensor-core route's at full width; dropping 512 rows is no larger
# a fault than dropping a whole chunk of either route.
FD_CHUNK = 512


def _fd_chunk(S: int) -> int:
    """The controls' chunk for a cache of S slots: FD_CHUNK, or half
    the cache when it holds fewer than two (whisper-base's 448)."""
    return FD_CHUNK if S >= 2 * FD_CHUNK else S // 2
# q's scale in the checks: 1 leaves the softmax over N(0, 1) keys nearly
# flat (outputs a mean of many V rows, ~1/√S); 8 peaks it as a trained
# model's attention is peaked, so that the outputs are O(1) and a chunk
# dropped or mis-weighted moves them by as much.
FD_Q_SCALES = (1.0, 8.0)


def _rel_max(a, b) -> float:
    """max |a − b| / max |b|, in float32."""
    a, b = a.float(), b.float()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def phase_decode_small(torch, ops, ref):
    """flash_decode against its plain version at small shapes: the three
    of tests/test_kernels.py:46-50, G = 8 at hd = 64, a ragged S = 1000,
    G = 6, 7 and 16 at hd = 128 (the new dense and VLM configs' groups),
    G = 16 at hd = 64 (qwen3-moe-235b-a22b's), G = 1 at hd = 64
    (zamba2-1.2b's and whisper-base's);
    valid_len 0, 1, a partial chunk and S; a flat and a peaked softmax
    (FD_Q_SCALES); K/V past valid_len set to ±99 (nothing may change)
    and a rerun (bit-identical)."""
    dev = torch.device(DEV)
    gen = torch.Generator(device=dev).manual_seed(5)
    shapes = ((1, 4, 4, 128, 64), (2, 8, 2, 256, 64), (2, 16, 4, 512, 128),
              (2, 32, 4, 2048, 64), (3, 16, 2, 1000, 64), (2, 8, 2, 300, 72),
              (1, 12, 1, 700, 32),
              # hd 128 at the groups of qwen2 (G 6), llava (G 7, part of a
              # CTA's 8 heads) and chatglm3 (G 16: two CTAs a KV head)
              (2, 12, 2, 300, 128), (1, 56, 8, 260, 128), (2, 32, 2, 512, 128),
              # qwen3-moe-235b-a22b's group: H 64 / KV 4 (G 16) at hd 64
              (2, 64, 4, 600, 64),
              # G 1 (MHA) at hd 64: zamba2-1.2b's shared block (32 heads)
              # and whisper-base's decoder (8 heads, its 448-slot cap)
              (2, 32, 32, 600, 64), (2, 8, 8, 448, 64))
    for dtype in (torch.float32, torch.bfloat16):
        tag = str(dtype).split(".")[1]
        worst, cases = 0.0, 0
        ops.reset_launches()
        want = {"tensor_core": 0, "simt": 0}
        for B, H, KV, S, hd in shapes:
            k, v = (torch.randn((B, KV, S, hd), generator=gen,
                                device=dev).to(dtype) for _ in range(2))
            for qs in FD_Q_SCALES:
                q = (qs * torch.randn((B, H, hd), generator=gen,
                                      device=dev)).to(dtype)
                for vl in (0, 1, S // 2 + 3, S):
                    valid = torch.tensor(vl, dtype=torch.int32, device=dev)
                    out = ops.decode_attention(q, k, v, valid)
                    want[ops.decode_route(dtype, hd)] += 1
                    worst = max(worst, _rel_max(out, ref.decode_attention_ref(
                        q, k, v, valid)))
                    check(torch.equal(ops.decode_attention(q, k, v, valid),
                                      out), "flash_decode rerun not "
                          f"bit-identical ({B, H, KV, S, hd})")
                    if 1 <= vl < S:
                        k2, v2 = k.clone(), v.clone()
                        k2[:, :, vl:], v2[:, :, vl:] = 99.0, -99.0
                        check(torch.equal(ops.decode_attention(
                            q, k2, v2, valid), out),
                            f"flash_decode read past valid_len {vl} of {S}")
                    cases += 1
        routes = _routes(ops, "flash_decode")
        say(f"[kernels] flash_decode {tag}: max |Δ|/max|plain| = "
            f"{worst:.2e} over {cases} cases (tol {FD_TOL[tag]:g}); past-"
            f"valid_len ±99 unchanged, reruns bit-identical; first calls by "
            f"route {want}, all launches {routes}")
        check(worst <= FD_TOL[tag],
              f"flash_decode {tag} differs from plain by {worst:.2e}")
        check(all(routes[r] >= want[r] and (routes[r] > 0) == (want[r] > 0)
                  for r in want), f"flash_decode {tag} took the routes "
              f"{routes}, want {want} first calls")


def phase_serve_smoke(torch, ops):
    """The smoke serve through the port's CLI code path (batch 4, cache
    256, 16 tokens): tokens in range, 2 layers × 16 flash_decode
    launches, and the same tokens from the plain versions on the CPU
    with the same weights."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import build_model, smoke_variant
    from repro_torch.models.layers import tree_map
    cfg = smoke_variant(get_config("tinyllama-1.1b"))
    ops.reset_launches()
    res = serve.main(["--arch", "tinyllama-1.1b", "--smoke", "--batch", "4",
                      "--cache-len", "256", "--tokens", "16"])
    launches = ops.LAUNCHES["flash_decode"]
    toks = res.tokens
    say(f"[serve-smoke] {cfg.name}: {tuple(toks.shape)} tokens, "
        f"{res.tok_per_s:.1f} tok/s, flash_decode launches {launches} "
        f"(want {cfg.num_layers} × 16)")
    check(tuple(toks.shape) == (16, 4), f"token shape {tuple(toks.shape)}")
    check(0 <= int(toks.min()) and int(toks.max()) < cfg.vocab_size,
          "smoke tokens out of range")
    check(launches == cfg.num_layers * 16,
          f"flash_decode launched {launches} times in the smoke serve")
    params = build_model(cfg).init(
        torch.Generator(device=DEV).manual_seed(0))
    host = tree_map(lambda w: w.cpu(), params)
    card = serve.serve_lm(cfg, batch=4, cache_len=256, tokens=16, device=DEV,
                          params=params)
    cpu = serve.serve_lm(cfg, batch=4, cache_len=256, tokens=16,
                         device="cpu", params=host)
    same = int((card.tokens == cpu.tokens).sum())
    say(f"[serve-smoke] the same weights on the card and on the CPU (plain "
        f"versions): {same} of {card.tokens.numel()} tokens equal")
    check(torch.equal(card.tokens, cpu.tokens),
          "smoke serve tokens differ from the plain versions on the CPU")


# The cache's K rows are N(0, KEY_SCALE²) and its V rows N(0, 1). The
# model's own q and k rows are about N(0, 1) a component (unit-rms x times
# 1/√d-scaled weights), which would leave each softmax over 32768
# positions nearly flat (effective sample S·e^(−σ²) ≈ 12000 rows at σ = 1)
# and the attention outputs ~1/√S: too small to move the residual, and
# the step checks below could not see attention. At σ = 4 the scores' std
# is 4 and a handful of rows carry each softmax, as in a trained model.
KEY_SCALE = 4.0


def _kv_caches(state):
    """A decode state's stacked KV caches (``LayerKVCache``, leading dim
    the cache attentions), None where it keeps none (rwkv6)."""
    for name in ("caches", "shared_cache", "self_cache"):
        if hasattr(state, name):
            return getattr(state, name)
    return None


def _recurrent(state) -> dict:
    """A decode state's recurrent leaves, name → tensor: the hybrid's
    mamba SSM and conv states, rwkv6's wkv states and token shifts."""
    if hasattr(state, "ssm"):
        return state.ssm._asdict()
    return {n: getattr(state, n) for n in ("S", "x_prev_t", "x_prev_c")
            if hasattr(state, n)}


def _new_state(torch, model, params, batch, cache_len, gen):
    """A zero decode state on gen's device; an encoder-decoder's holds
    the cross K/V of stub frames N(0, 1) drawn from ``gen``."""
    cfg = model.cfg
    if cfg.is_encoder_decoder:
        frames = torch.randn((batch, cfg.encoder_seq, cfg.d_model),
                             generator=gen, device=gen.device)
        return model.init_decode_state(batch, cache_len, gen.device,
                                       frames=frames.to(cfg.torch_dtype),
                                       params=params)
    return model.init_decode_state(batch, cache_len, gen.device)


def _fill_cache(torch, state, gen):
    """Seeded random K/V in every slot, layer by layer; recurrent
    states N(0, 1) (the stated state the SSM families serve from)."""
    kv = _kv_caches(state)
    for i in range(0 if kv is None else kv.k.shape[0]):
        kv.k[i].normal_(std=KEY_SCALE, generator=gen)
        kv.v[i].normal_(generator=gen)
    for t in _recurrent(state).values():
        t.normal_(generator=gen)


def _unrescaled_combine(torch, q, k, v):
    """flash-decoding over _fd_chunk(S) chunks with the combine pass's
    exp(m_c − m) factors left out (every position valid): a control."""
    B, H, hd = q.shape
    KV, S = k.shape[1], k.shape[2]
    chunk = _fd_chunk(S)
    n = S // chunk
    qg = q.float().reshape(B, KV, H // KV, hd) * (1.0 / hd ** 0.5)
    s = torch.einsum("bkgh,bkth->bkgt", qg, k.float())
    s = s.reshape(B, KV, H // KV, n, chunk)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    acc = torch.einsum("bkgct,bkcth->bkgch", p,
                       v.float().reshape(B, KV, n, chunk, hd))
    out = acc.sum(3) / p.sum((3, 4))[..., None]
    return out.reshape(B, H, hd).to(q.dtype)


def time_flash_decode(torch, ops, ref, H, k, v, valid, gen):
    """flash_decode at one layer's full shape: checked with a flat and a
    peaked q against its plain version, with two controls the check must
    see (one chunk dropped; the combine pass unrescaled); rerun, timed,
    bounded, and timed against plain and scaled_dot_product_attention
    (the library yardstick)."""
    F = torch.nn.functional
    B, KV, S, hd = k.shape
    tag = str(k.dtype).split(".")[1]
    dev = k.device
    mask = (torch.arange(S, device=dev) < valid)[None, None, None]
    base = torch.randn((B, H, hd), generator=gen, device=dev)
    route = ops.decode_route(k.dtype, hd)
    for qs in FD_Q_SCALES:
        # scores std qs: a key is N(0, KEY_SCALE²)
        q = (base * (qs / KEY_SCALE)).to(k.dtype)
        ops.reset_launches()
        out = ops.decode_attention(q, k, v, valid)
        check(ops.ROUTE_LAUNCHES[f"flash_decode/{route}"] == 1,
              f"flash_decode took the routes {_routes(ops, 'flash_decode')}")
        plain = ref.decode_attention_ref(q, k, v, valid)
        err = float((out.float() - plain.float()).abs().max())
        rel = _rel_max(out, plain)
        dropped = _rel_max(ref.decode_attention_ref(q, k, v,
                                                    valid - _fd_chunk(S)),
                           plain)
        unres = _rel_max(_unrescaled_combine(torch, q, k, v), plain)
        lib_out = F.scaled_dot_product_attention(
            q[:, :, None], k, v, attn_mask=mask, enable_gqa=True)[:, :, 0]
        say(f"[kernels] flash_decode B={B} H={H} KV={KV} S={S} hd={hd} {tag},"
            f" scores std {qs:g}: max|plain| "
            f"{float(plain.float().abs().max()):.3f}, max|Δ| {err:.2e} = "
            f"{rel:.2e} of it (tol {FD_TOL[tag]:g}); controls: last chunk "
            f"dropped {dropped:.2e}, combine unrescaled {unres:.2e}; library "
            f"vs plain {_rel_max(lib_out, plain):.2e}")
        check(rel <= FD_TOL[tag],
              f"flash_decode differs from plain by {rel:.2e} of max|plain|")
        if qs > 1:
            check(min(dropped, unres) > FD_TOL[tag], "the full-width "
                  "flash_decode check cannot see a dropped or unrescaled chunk")
        check(torch.equal(ops.decode_attention(q, k, v, valid), out),
              "flash_decode rerun not bit-identical at full width")
    from repro_torch.kernels.decode_attention import launch_flash_decode
    simt = launch_flash_decode(q, k, v, valid, "simt")
    simt_rel = _rel_max(simt, ref.decode_attention_ref(q, k, v, valid))
    check(simt_rel <= FD_TOL[tag], f"flash_decode SIMT route differs from "
          f"plain by {simt_rel:.2e}")
    # in turns: kernel, library, SIMT route, SIMT route, library, kernel
    kern = lambda: ops.decode_attention(q, k, v, valid)  # noqa: E731
    library = lambda: F.scaled_dot_product_attention(  # noqa: E731
        q[:, :, None], k, v, attn_mask=mask, enable_gqa=True)
    old = lambda: launch_flash_decode(q, k, v, valid, "simt")  # noqa: E731
    turns = {"kernel": [], "library": [], "simt": []}
    for name, fn in (("kernel", kern), ("library", library), ("simt", old),
                     ("simt", old), ("library", library), ("kernel", kern)):
        turns[name].append(cuda_ms(torch, fn, 20))
    ms, lib, simt_ms = (sum(t) / len(t) for t in turns.values())
    plain_ms = cuda_ms(torch, lambda: ref.decode_attention_ref(q, k, v,
                                                               valid), 3)
    say(f"[kernels] flash_decode {route} route in turns: kernel "
        f"{turns['kernel']}, library {turns['library']}, SIMT route "
        f"{turns['simt']} ms (SIMT vs plain {simt_rel:.2e})")
    rows = min(int(valid), S) if int(valid) >= 1 else S
    nbytes = 2 * B * KV * rows * hd * k.element_size() \
        + 2 * B * H * hd * q.element_size() + 4
    bms, by = bound_ms(nbytes, 4.0 * B * H * rows * hd, BF16_FLOP_PER_S)
    say(f"[kernels] flash_decode: kernel {ms:.3f} ms ({route} route; the "
        f"SIMT route {simt_ms:.3f} ms), plain {plain_ms:.3f} ms, library "
        f"(scaled_dot_product_attention, enable_gqa, mask) {lib:.3f} ms, "
        f"bound {bms:.3f} ms ({by}; {nbytes / 1e9:.3f} GB, "
        f"{nbytes / ms / 1e6:.0f} GB/s achieved)")
    return dict(name="flash_decode", route="cuda", source=FD_SRC,
                replaces=FD_TPU, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bms, bound_by=by, library_ms=lib, simt_ms=simt_ms,
                shape=[B, H, KV, S, hd])


# One full-width bf16 step, the logits' max |Δ| over their largest
# magnitude, against two references: the plain route (decode_kernel=False),
# which rounds scores and probabilities to bf16 where the kernel keeps
# f32; and the kernel route with the kernel's plain version in its place,
# which differs from it only in summation order. 22 random bf16 layers
# carry a one-ulp difference far: with keys at KEY_SCALE = 4, a CPU
# rehearsal (d 1024, 16 heads / 2 KV, 22 layers, batch 4, cache 32768, a
# chunked f32 flash-decode for the kernel) read 0.100 and 0.052, and the
# weakest control 0.41. Each limit sits between, and every control of
# _step_controls must exceed it, or the check could not see such a fault.
# Each layer's peaked attention over the random cache passes the
# difference on and the next adds its own, so the readings grow with the
# depth, about linearly: on the card (NVIDIA H100 80GB HBM3, 700 W) the
# route check read 0.0024–0.0055 of max |logit| a layer and the swap
# check 0.0013–0.0034 over 22, 28, 32 and 60 layers (0.310 and 0.204 at
# llava-next-34b's 60), while the weakest control stays at 0.355–1.13.
# So the limits are those set at 22 layers, scaled by the depth.
ROUTE_TOL = 0.2 / 22       # a layer
SWAP_TOL = 0.15 / 22
# A MoE layer passes a rounding on further than a dense one: its gates
# move with the router's logits. A CPU probe (d 1024, 16 heads / 1 KV, 4
# layers, batch 8, a chunked f32 flash-decode for the kernel) read the
# route check at 0.0129 a MoE layer (E 128, K 8) against 0.0057 a dense
# one, on the rows routed alike; the card (NVIDIA H100 80GB HBM3, 700 W)
# read 0.0121 a qwen3-moe layer against 0.0024–0.0055 for the dense
# configs. So a MoE layer counts MOE_STEP_LAYERS.
MOE_STEP_LAYERS = 3


def _step_controls(torch, ops, S: int):
    """Faults of the kernel or its wiring, as stand-ins for
    ops.decode_attention: name → function of (q, k, v, valid_len); the
    chunk cut short is _fd_chunk of the cache's S slots."""
    fd = ops.decode_attention
    chunk = _fd_chunk(S)
    return {
        "attention zeroed": lambda q, k, v, n: torch.zeros_like(q),
        "valid_len one chunk short": lambda q, k, v, n: fd(q, k, v,
                                                           n - chunk),
        "KV heads rolled": lambda q, k, v, n: fd(q, k.roll(1, 1),
                                                 v.roll(1, 1), n),
    }


# A MoE token whose expert set differs between two runs in some layer (a
# near tie at the k-th place decided the other way by a rounding) moves
# its logits by ~0.07 of max |logit|: a CPU probe (d 512 and 1024, E 128,
# K 8, 4 bf16 layers, 3 × 32 teacher-forced tokens) saw 4–7 % of the
# token-layers flip between decode and forward, the positions routed
# alike within 0.009–0.017 and the others up to 0.074. So the checks
# compare the rows (positions) routed alike in every layer by both runs,
# and at least MIN_ALIKE of them must be: a fault that moves the routing
# everywhere fails that instead. Without experts every row is alike. On
# the card (NVIDIA H100 80GB HBM3, 700 W) the comparisons read 47 %
# (qwen3-moe's kernel route against the plain route, whose bf16 scores
# over 32768 keys flip the most) to 96 % alike, the controls 0–33 %, and
# each control at ≥ 25 % exceeded the error limit.
MIN_ALIKE = 0.25


@contextlib.contextmanager
def _routing(log):
    """Record, while armed, the expert set (ascending ids, (B, S, K)) of
    every apply_moe call into ``log``; the package's routing itself runs
    as it is."""
    from repro_torch.models import moe
    apply_moe = moe.apply_moe

    def recording(p, x, cfg, capacity_factor=None):
        _, _, idx = moe.route(x.reshape(-1, x.shape[-1]), p["router"], cfg)
        log.append(idx.sort(-1).values.reshape(x.shape[0], x.shape[1], -1))
        return apply_moe(p, x, cfg, capacity_factor)
    moe.apply_moe = recording
    try:
        yield log
    finally:
        moe.apply_moe = apply_moe


def _by_layer(torch, log, L):
    """Recorded sets of L-layer passes (layer-minor) → (L, B, positions,
    K), the passes' positions in order; None without experts."""
    if not log:
        return None
    return torch.stack([torch.cat(log[i::L], 1) for i in range(L)])


def _alike(torch, a, b, shape):
    """(B, positions) True where runs ``a`` and ``b`` (``_by_layer``)
    chose the same experts in every layer."""
    if a is None:
        return torch.ones(shape, dtype=torch.bool, device=DEV)
    return (~(a != b).any(-1).any(0)).reshape(shape)


def _rows_check(torch, got, want, alike, scale, tol) -> tuple:
    """→ (max |Δ| / scale over the rows routed alike, their share, ok)."""
    err = (got - want).abs().amax(-1) / scale
    share = float(alike.float().mean())
    rel = float(err[alike].max()) if bool(alike.any()) else float("inf")
    return rel, share, share >= MIN_ALIKE and rel <= tol


def _over(rel: float, share: float) -> str:
    """A ``_rows_check`` reading for the log."""
    if share == 0:
        return "no row routed alike"
    return f"{rel:.2e} over {share:.0%}"


def _step_logits(torch, ops, model, params, state, tok, attend=None):
    """Last logits (f32) of one decode step from ``state`` and its
    routing by layer; ``attend`` stands in for ops.decode_attention
    during the step when given."""
    fd = ops.decode_attention
    if attend is not None:
        ops.decode_attention = attend
    try:
        with _routing([]) as log:
            logits = model.decode_step(params, state, tok)[0][:, -1].float()
        return logits, _by_layer(torch, log, model.cfg.num_layers)
    finally:
        ops.decode_attention = fd


def _attn_layers(model) -> int:
    """Cache attentions in one decode step: one a layer in the decoder
    families (whisper's decoder self-attention), one an application of
    the hybrid's shared block, none in the attention-free rwkv6."""
    cfg = model.cfg
    if cfg.attn_free:
        return 0
    if cfg.family == "hybrid":
        return cfg.num_layers // cfg.attn_every
    return cfg.num_layers


def _step_checks(torch, ops, ref, model, params, state, tok):
    """One step from ``state``: the kernel route against the plain route
    and against itself with the kernel's plain version, each with
    controls, over the rows routed alike. The limits scale with the
    step's cache attentions (_attn_layers), where the two routes
    differ."""
    from repro_torch.models import build_model
    cfg = model.cfg
    batch = tok.shape[0]
    logits_k, route_k = _step_logits(torch, ops, model, params, state, tok)
    check(bool(torch.isfinite(logits_k).all()),
          "kernel-route logits not finite")
    plain = _step_logits(torch, ops, build_model(cfg, decode_kernel=False),
                         params, state, tok)
    swap = _step_logits(torch, ops, model, params, state, tok,
                        ref.decode_attention_ref)
    S = _kv_caches(state).k.shape[3]
    controls = {name: _step_logits(torch, ops, model, params, state, tok, fn)
                for name, fn in _step_controls(torch, ops, S).items()}
    scale = float(plain[0].abs().max())
    # the hybrid counts its two shared-block applications, one layer
    # each: on the card (NVIDIA H100 80GB HBM3, 700 W) zamba2-1.2b's route
    # check read 0.0117 of max |logit| (limit 0.0182) and its weakest
    # control, valid_len one chunk short (512 of 32768 keys in 2 of its
    # 40 blocks), 0.0207; counted 3× an application, as a MoE layer, the
    # limit (0.0545) hid that control
    L = _attn_layers(model) * (MOE_STEP_LAYERS if cfg.is_moe else 1)
    for what, (want, route_w), tol in (
            ("plain route", plain, ROUTE_TOL * L),
            ("kernel's plain version", swap, SWAP_TOL * L)):
        alike = _alike(torch, route_k, route_w, (batch,))
        rel, share, ok = _rows_check(torch, logits_k, want, alike, scale,
                                     tol)
        ctl = {n: _rows_check(torch, c, want,
                              _alike(torch, r, route_w, (batch,)), scale,
                              tol)
               for n, (c, r) in controls.items()}
        say(f"[serve-full] kernel route vs {what}, one step: logits max|Δ| "
            f"{rel:.2e} of max |logit| {scale:.3f} over the {share:.0%} of "
            f"rows routed alike (tol {tol:.3g}, at least {MIN_ALIKE:.0%}); "
            "controls: " + ", ".join(f"{n} {_over(r, s)}"
                                     for n, (r, s, _) in ctl.items()))
        check(ok, f"kernel route and {what} differ by {rel:.2e} over "
              f"{share:.0%} of the rows")
        check(not any(c[2] for c in ctl.values()), f"the step check "
              f"against the {what} cannot see a control")
    alike = _alike(torch, route_k, plain[1], (batch,))
    diff = float((logits_k - plain[0])[alike].abs().max())
    top2 = plain[0].topk(2, dim=-1).values
    clear = ((top2[:, 0] - top2[:, 1]) > diff) & alike
    agree = logits_k.argmax(-1) == plain[0].argmax(-1)
    say(f"[serve-full] greedy tokens of the two routes equal in "
        f"{int(agree.sum())} of {batch} rows, {int(clear.sum())} rows routed "
        f"alike with a top-2 margin > their max|Δ| {diff:.4f}")
    check(bool(agree[clear].all()), "greedy tokens differ where the margin "
          "exceeds the routes' difference")


def _drop_shares(torch, cfg, res, params, state, snap, start, cache_len):
    """The serve again from the same cache and position with each layer's
    routing recorded: its tokens must be the serve's; → per step the
    share of the step's B·K·layers assignments past an expert's
    capacity (the config's factor over the step's B tokens)."""
    from repro_torch.launch.serve import serve_lm
    from repro_torch.models import moe
    state.caches.k.copy_(snap[0])
    state.caches.v.copy_(snap[1])
    B = state.caches.k.shape[1]
    C = moe.capacity(B, cfg)
    with _routing([]) as log:
        again = serve_lm(cfg, batch=B, cache_len=cache_len,
                         tokens=res.tokens.shape[0], device=DEV,
                         params=params, state=state._replace(pos=start))
    check(torch.equal(again.tokens, res.tokens), "the serve's tokens differ "
          "when it runs again from the same cache")
    L, K = cfg.num_layers, cfg.experts_per_token
    shares = []
    for s in range(res.tokens.shape[0]):
        dropped = sum(int((torch.bincount(idx.reshape(-1),
                                          minlength=cfg.num_experts) - C)
                          .clamp(min=0).sum())
                      for idx in log[s * L:(s + 1) * L])
        shares.append(dropped / (L * B * K))
    return shares, C


def _step_bytes(model, params, state, batch, cache_len, steps):
    """Bytes one decode step must move, averaged over the serve's steps:
    every weight it reads (not the embedding table, B rows of it; not an
    encoder-decoder's encoder nor its cross K/V projections, whose
    outputs the state holds) once, the K/V rows up to its position (a
    ring: its slots) of each cache attention, the encoder's cross K/V,
    and the recurrent state read and written. → (bytes, weight elements
    read)."""
    from repro_torch.models.layers import tree_leaves
    cfg = model.cfg
    emb = params["embed"]["embedding"]
    skip = [emb]
    if cfg.is_encoder_decoder:
        skip += tree_leaves(params["enc_layers"]) + tree_leaves(
            params["enc_norm"]) + [params["dec_layers"]["cross_attn"][n]
                                   for n in ("wk", "wv", "bk", "bv")
                                   if n in params["dec_layers"]["cross_attn"]]
    w_elems = sum(t.numel() for t in tree_leaves(params)) \
        - sum(t.numel() for t in skip)
    el = emb.element_size()
    nbytes = w_elems * el + batch * cfg.d_model * el
    kv = _kv_caches(state)
    if kv is not None:
        S_cache = kv.k.shape[3]
        rows = min(S_cache, sum(cache_len - steps + i + 1
                                for i in range(steps)) / steps)
        nbytes += 2 * _attn_layers(model) * batch * kv.k.shape[2] * rows \
            * cfg.hd * kv.k.element_size()
    if cfg.is_encoder_decoder:
        nbytes += 2 * state.cross_k.numel() * state.cross_k.element_size()
    nbytes += 2 * sum(t.numel() * t.element_size()
                      for t in _recurrent(state).values())
    return nbytes, w_elems


# the serve step with the MLP activation as shipped against the fused one
# it replaced (tinyllama-1.1b's shape; chatglm3-6b's, the model that
# [tp-serve-full] splits over 4 ranks)
ACTIVATION_AB_ARCHS = ("tinyllama-1.1b", "chatglm3-6b")
ACTIVATION_AB_STEPS = 8


def _activation_ab(torch, cfg, step, params, state, tok):
    """One decode step (``make_serve_step``) with the MLP activation as
    shipped (``layers.mlp_activation``: silu or the tanh gelu with each
    step rounded to bf16, as XLA rounds them) against the fused
    ``F.silu`` / ``F.gelu`` it replaced, in turns A B B A of
    ``ACTIVATION_AB_STEPS`` steps each, wall time over the steps after a
    sync (the steps are host-bound): the activation's share of a serve
    step, on this host, in one process."""
    import torch.nn.functional as F
    from repro_torch.models import layers
    shipped = layers.mlp_activation

    def fused(h, style):
        return F.silu(h) if style == "swiglu" \
            else F.gelu(h, approximate="tanh")
    ms = {"stepwise": [], "fused": []}
    for name in ("stepwise", "fused", "fused", "stepwise"):
        layers.mlp_activation = shipped if name == "stepwise" else fused
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(ACTIVATION_AB_STEPS):
                step(params, state, tok)
            torch.cuda.synchronize()
        finally:
            layers.mlp_activation = shipped
        ms[name].append(1e3 * (time.perf_counter() - t0)
                        / ACTIVATION_AB_STEPS)
    a, b = (sum(v) / len(v) for v in ms.values())
    say(f"[serve-full] {cfg.name} MLP activation A/B, ms a decode step "
        f"(turns A B B A of {ACTIVATION_AB_STEPS}): stepwise "
        f"{[round(v, 3) for v in ms['stepwise']]}, fused "
        f"{[round(v, 3) for v in ms['fused']]}; the stepwise activation "
        f"costs {a - b:+.3f} ms a step ({(a - b) / b:+.1%}, "
        f"{cfg.num_layers} layers)")


def phase_serve_full(torch, ops, ref, cfg, params, batch, cache_len, steps):
    """The LM serve path at ``cfg``'s width with ``params`` on the card: a
    cache filled with seeded random K/V (the SSM families' recurrent
    states N(0, 1); whisper's cross K/V from stub frames), 16 greedy
    tokens from position cache_len − steps through serve_lm. A
    sliding-window config decodes on the ring route, and rwkv6 keeps no
    cache: neither launches a kernel (no flash_decode row → None, no
    route checks). A MoE config's serve prints the share of assignments
    past capacity per step."""
    from repro_torch.launch.serve import serve_lm
    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models import build_model
    model = build_model(cfg)
    dev = torch.device(DEV)
    ring = bool(cfg.sliding_window)
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    state = _new_state(torch, model, params, batch, cache_len, gen)
    _fill_cache(torch, state, gen)
    start = torch.full((), cache_len - steps, dtype=torch.int32, device=dev)
    state = state._replace(pos=start)
    torch.cuda.synchronize()
    w_bytes = _nbytes(params)
    kv = _kv_caches(state)
    kv_bytes = 0 if kv is None else 2 * kv.k.numel() * kv.k.element_size()
    S_cache = 0 if kv is None else kv.k.shape[3]
    rec_bytes = sum(t.numel() * t.element_size()
                    for t in _recurrent(state).values())
    cross = (f", cross K/V {2 * state.cross_k.numel() * 2 / 1e9:.3f} GB "
             f"({cfg.encoder_seq} frames)" if cfg.is_encoder_decoder else "")
    say(f"[serve-full] {cfg.name}: {cfg.num_layers} layers, d {cfg.d_model}, "
        f"{cfg.num_heads} heads / {cfg.num_kv_heads} KV, ff {cfg.d_ff}, "
        f"vocab {cfg.vocab_size}, {cfg.dtype}; weights {w_bytes / 1e9:.3f} GB, "
        f"KV cache {kv_bytes / 1e9:.3f} GB over {_attn_layers(model)} cache "
        f"attentions (batch {batch}, cache {cache_len}, {S_cache} slots), "
        f"recurrent state {rec_bytes / 1e9:.3f} GB{cross}; set-up "
        f"{time.perf_counter() - t0:.1f} s")

    H, hd = cfg.num_heads, cfg.hd
    tok = torch.zeros((batch, 1), dtype=torch.int32, device=dev)
    row = None
    if ring:
        say(f"[serve-full] {cfg.name}: sliding window {cfg.sliding_window}, "
            "the ring route (plain attention, as the reference's "
            "use_pallas and not sliding_window): no kernel on this path")
    elif kv is None:
        say(f"[serve-full] {cfg.name}: attention-free (an O(1) wkv state a "
            "layer, no KV cache): no kernel on this path")
    else:
        full = torch.full((), cache_len, dtype=torch.int32, device=dev)
        row = time_flash_decode(torch, ops, ref, H, kv.k[0], kv.v[0], full,
                                gen)
        _step_checks(torch, ops, ref, model, params, state, tok)

    # one step may not wait for the device
    step = make_serve_step(model)
    from repro_torch.analysis import no_implicit_host_sync
    torch.cuda.synchronize()
    with no_implicit_host_sync():
        step(params, state, tok)
    torch.cuda.synchronize()
    say("[serve-full] one decode step ran under no_implicit_host_sync")
    if cfg.name in ACTIVATION_AB_ARCHS:
        _activation_ab(torch, cfg, step, params, state, tok)

    snap = (state.caches.k.clone(), state.caches.v.clone()) \
        if cfg.is_moe else None
    # --- the main path: counts from 0, one serve_lm, counts read ---------
    ops.reset_launches()
    res = serve_lm(cfg, batch=batch, cache_len=cache_len, tokens=steps,
                   device=dev, params=params, state=state)
    launches = ops.LAUNCHES["flash_decode"]
    step_ms = 1e3 * res.seconds / steps
    step_bytes, w_elems = _step_bytes(model, params, state, batch, cache_len,
                                      steps)
    rows = min(S_cache, cache_len - steps / 2)
    # matmuls (a MoE layer's over the slots its dispatch fills) and the
    # cache attentions' q·K and p·V
    mm = _matmul_flops(cfg, batch) if cfg.family in ("dense", "moe", "vlm") \
        else 2.0 * w_elems * batch
    sbms, sby = bound_ms(step_bytes, mm + 4.0 * batch * H * rows * hd
                         * _attn_layers(model), BF16_FLOP_PER_S)
    want = 0 if ring else _attn_layers(model) * steps
    say(f"[serve-full] serve_lm: {steps} tokens × {batch} seqs from "
        f"position {cache_len - steps} in {1e3 * res.seconds:.1f} ms: "
        f"{step_ms:.3f} ms per step (bound {sbms:.3f} ms, {sby}: "
        f"{step_bytes / 1e9:.2f} GB a step), {res.tok_per_s:.1f} tok/s; "
        f"flash_decode launches {launches} (want {want}), routes "
        f"{_routes(ops, 'flash_decode')}")
    toks = res.tokens
    check(launches == want,
          f"flash_decode launched {launches} times in the serve")
    if want:
        route = ops.decode_route(cfg.torch_dtype, hd)
        check(ops.ROUTE_LAUNCHES[f"flash_decode/{route}"] == launches,
              f"the serve's flash_decode took the routes "
              f"{_routes(ops, 'flash_decode')}, want {route}")
    check(tuple(toks.shape) == (steps, batch) and 0 <= int(toks.min())
          and int(toks.max()) < cfg.vocab_size, "serve tokens out of range")
    check(int(res.state.pos) == cache_len, f"pos {int(res.state.pos)}")
    check(all(bool(torch.isfinite(t).all())
              for t in _recurrent(res.state).values()),
          "the recurrent state is not finite after the serve")
    if cfg.is_moe:
        shares, C = _drop_shares(torch, cfg, res, params, state, snap, start,
                                 cache_len)
        del snap
        say(f"[serve-full] {cfg.name} at capacity factor "
            f"{cfg.moe_capacity_factor:g} (C = {C} slots an expert for the "
            f"step's {batch} tokens): share of the {batch} × "
            f"{cfg.experts_per_token} × {cfg.num_layers} assignments past "
            f"capacity, by step: {[round(s, 4) for s in shares]}, mean "
            f"{sum(shares) / len(shares):.4f} (the serve run again from the "
            "same cache, routing recorded: the same tokens)")

    profile(torch, lambda: step(params, state, tok)[0].cpu(),
            f"one decode step at position {cache_len - steps}")
    if row is not None:
        row["launches"] = launches
    return row


# --- slice 16: the dense and VLM forward pass at full width ----------------

# [model-full]: (arch, serve batch, serve cache) at full width, one config
# on the card at a time. llava-next-34b's batch 4 and cache 4096 are a
# stated cut: its 68.8 GB of weights leave ~15 GB of the card.
MODEL_CELLS = (("tinyllama-1.1b", 32, 32768), ("qwen2-1.5b", 32, 32768),
               ("chatglm3-6b", 32, 32768), ("llama3-8b", 8, 32768),
               ("llava-next-34b", 4, 4096), ("mixtral-8x22b", 32, 32768),
               ("qwen3-moe-235b-a22b", 32, 32768),
               # slice 19: rwkv6 serves from position 32752 of a stated
               # (random) state, no cache; zamba2's two shared-block
               # applications hold 17.2 GB of KV; whisper decodes up to
               # its 448-token cap
               ("rwkv6-7b", 32, 32768), ("zamba2-1.2b", 32, 32768),
               ("whisper-base", 32, 448))
# The MoE configs run at full width, every expert and the config's top-k,
# full vocabulary, with the depth cut to MOE_LAYERS (a stated cut):
# neither fits the card whole (261.9 and 431.6 GiB); 4 layers are ~20.8
# GB (mixtral) and ~22.1 GB (qwen3-moe) of bf16 weights.
MOE_LAYERS = 4
FWD_BATCH, FWD_SEQ = 3, 4096     # 3 × 4096 tokens: chunked_lm_loss chunks
TF_STEPS = 32
# the SSM families decode against the forward over several of its chunks:
# rwkv6 128 tokens (4 chunks of 32; 256 until a whole run took 1073.4 s
# of its 1200 on an H100 host), zamba2 256 (2 chunks of 128). They
# do so in float32 (their
# weights widened on the card for this check only): with random weights
# a bf16 rounding difference grows through their 32 and 38 recurrent
# layers and along the sequence, and a CPU probe (d 512, full depth, 256
# tokens × 3) read decode vs forward at 0.33 (rwkv6) and 0.38 (zamba2)
# of max |logit| in bf16, above zamba2's attention controls (0.26–0.48):
# no limit would separate them. In float32 the same probe read ~1e-3
# (8.6e-4 at 64 tokens), every control ≥ 0.25.
SSM_TF_STEPS = {"ssm": 128, "hybrid": 256}
# Teacher-forced decode against the forward, max |Δ| of the logits over
# their largest magnitude: the forward rounds scores and probabilities to
# bf16 where flash_decode keeps f32, and its matmuls see B·S rows where
# the decode sees B. A CPU probe at full depth (d 512) read 0.014–0.024,
# an NVIDIA H100 80GB HBM3 (700 W) 0.012–0.027 at full width over 22–60
# layers (the cache is the model's own, not peaked: no growth with depth
# as in [serve-full]); the weakest control read 0.41–0.88. Every control
# must exceed the limit.
DECODE_FWD_TOL = 0.1
# the controls decode the first CONTROL_STEPS tokens only
CONTROL_STEPS = 8
# [embed-full]: R_emp per round of the kernel fit against the plain fit on
# the card, both on the same bf16 rows (f32 sums in other orders)
EMBED_TOL = 1e-4


def _example(name: str):
    """examples/<name>.py as a module."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _nbytes(tree) -> int:
    from repro_torch.models.layers import tree_leaves
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def _matmul_flops(cfg, tokens: int, head_tokens=None) -> float:
    """Matmul operations of the layers over ``tokens`` tokens and of the
    LM head over ``head_tokens`` (default ``tokens``): 2 · weights ·
    tokens; a MoE layer's experts count over the E · C slots the
    dispatch fills and multiplies (C = capacity of ``tokens``)."""
    from repro_torch.models.moe import capacity
    V, D = cfg.vocab_size, cfg.d_model
    head = V * D
    body = cfg.param_count() - head * (1 if cfg.tie_embeddings else 2)
    flops = 2.0 * body * tokens + 2.0 * head * (
        tokens if head_tokens is None else head_tokens)
    if cfg.is_moe:
        expert = 3 * D * cfg.d_ff
        slots = cfg.num_experts * capacity(tokens, cfg)
        flops += 2.0 * cfg.num_layers * expert * (
            slots - cfg.num_experts * tokens)
    return flops


def _forward_flops(cfg, B: int, S: int) -> float:
    """Operations of the prefill at batch B: the matmuls of every weight
    over the tokens it sees (the LM head over the last positions only),
    the scores and PV products of the attentions (causal: half) and the
    SSM families' chunk products. S is the positions of a decoder (an
    encoder-decoder's decoder tokens; its encoder sees encoder_seq
    frames)."""
    D, F, L, V = cfg.d_model, cfg.d_ff, cfg.num_layers, cfg.vocab_size
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    attn_w = D * H * hd + 2 * D * KV * hd + H * hd * D
    head = 2.0 * V * D * B
    if cfg.family in ("dense", "moe", "vlm"):
        return _matmul_flops(cfg, B * S, B) + 2.0 * L * B * S ** 2 * H * hd
    if cfg.attn_free:
        from repro_torch.models import rwkv6
        hr, Q = rwkv6.HEADDIM, rwkv6.CHUNK
        w = 5 * D * D + 2 * D * 64 + 2 * D * F + D * D
        # a chunk's r·kᵀ, A·v, q·S and state update, a token and head
        wkv = (4 * Q * hr + 4 * hr * hr) * (D // hr)
        return 2.0 * L * w * B * S + head + L * B * S * wkv
    if cfg.family == "hybrid":
        from repro_torch.models import mamba2
        d_inner, nh, N = mamba2.ssm_dims(cfg)
        P, Q = mamba2.HEADDIM, mamba2.CHUNK
        n_seg = L // cfg.attn_every
        w = D * (2 * d_inner + 2 * N + nh) + d_inner * D
        # a chunk's C·Bᵀ (shared by the heads), W·x, the state read and
        # the state update, a token
        ssd = 2 * Q * N + nh * (2 * Q * P + 4 * P * N)
        return (2.0 * L * w * B * S + L * B * S * ssd
                + n_seg * (2.0 * (attn_w + 3 * D * F) * B * S
                           + 2.0 * B * S ** 2 * H * hd) + head)
    # the encoder-decoder: the encoder over the frames, the decoder's
    # self-attention, cross-attention (K/V over the frames) and MLP
    T_enc = cfg.encoder_seq
    enc = cfg.encoder_layers * (2.0 * (attn_w + 2 * D * F) * B * T_enc
                                + 4.0 * B * T_enc ** 2 * H * hd)
    cross_kv = 2.0 * D * KV * hd
    dec = L * (2.0 * (attn_w + (attn_w - cross_kv) + 2 * D * F) * B * S
               + 2.0 * cross_kv * B * T_enc
               + 2.0 * B * S ** 2 * H * hd + 4.0 * B * S * T_enc * H * hd)
    return enc + dec + head


def _attention_probe(cfg, params):
    """One attention of the forward to time against the library: (layer
    params, positions, causal), None for the attention-free rwkv6."""
    from repro_torch.models.layers import tree_map
    if cfg.attn_free:
        return None
    if cfg.family == "hybrid":
        return params["shared"]["attn"], FWD_SEQ, True
    if cfg.is_encoder_decoder:
        return (tree_map(lambda w: w[0], params["enc_layers"])["attn"],
                cfg.encoder_seq, False)
    return tree_map(lambda w: w[0], params["layers"])["attn"], FWD_SEQ, True


def _forward_full(torch, model, params, gen):
    """The prefill step (``launch.steps.build_prefill_step``:
    hidden_states → last-position logits; an encoder-decoder encodes its
    frames first) and the loss at batch FWD_BATCH and FWD_SEQ positions,
    a VLM's stub prefix embeddings included (an encoder-decoder: its
    encoder_seq stub frames and min(FWD_SEQ, max_decoder_len) decoder
    tokens); one attention against the library's. → seconds."""
    from repro_torch.launch.steps import InputShape, build_prefill_step
    from repro_torch.models import attention as attn_lib
    from repro_torch.models.layers import apply_rope
    F = torch.nn.functional
    cfg = model.cfg
    dev = gen.device
    P = cfg.num_prefix_tokens
    S_text = min(FWD_SEQ, cfg.max_decoder_len) if cfg.is_encoder_decoder \
        else FWD_SEQ - P

    def ids():
        return torch.randint(0, cfg.vocab_size, (FWD_BATCH, S_text),
                             generator=gen, device=dev, dtype=torch.int32)
    tokens, labels = ids(), ids()
    batch = dict(tokens=tokens, labels=labels)
    if P:
        batch["prefix_embeds"] = torch.randn(
            (FWD_BATCH, P, cfg.d_model), generator=gen,
            device=dev).to(cfg.torch_dtype)
    if cfg.is_encoder_decoder:
        batch["frames"] = torch.randn(
            (FWD_BATCH, cfg.encoder_seq, cfg.d_model), generator=gen,
            device=dev).to(cfg.torch_dtype)
    prefill_step = build_prefill_step(
        cfg, None, InputShape("prefill-full", "prefill", FWD_SEQ,
                              FWD_BATCH)).fn
    prefill_batch = {k: v for k, v in batch.items() if k != "labels"}

    def prefill():
        return prefill_step(params, prefill_batch)

    from repro_torch.analysis import no_implicit_host_sync
    t_all = time.perf_counter()
    with torch.no_grad():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        loss, metrics = model.loss(params, batch)
        loss_v, aux = float(loss), float(metrics["aux"])
        loss_ms = 1e3 * (time.perf_counter() - t0)
        loss_peak = torch.cuda.max_memory_allocated() - base
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        # the forward may not wait for the device
        with no_implicit_host_sync():
            last = prefill()
        torch.cuda.synchronize()
        fwd_ms = 1e3 * (time.perf_counter() - t0)
        fwd_peak = torch.cuda.max_memory_allocated() - base
    T = FWD_BATCH * S_text
    flops = _forward_flops(cfg, FWD_BATCH, S_text + P)
    bms, by = bound_ms(_nbytes(params), flops, BF16_FLOP_PER_S)
    what = (f"{cfg.encoder_seq} stub frames + {S_text} decoder tokens"
            if cfg.is_encoder_decoder else
            f"{FWD_SEQ} positions ({P} prefix embeddings + {S_text} tokens)")
    say(f"[model-full] {cfg.name} forward: batch {FWD_BATCH} × {what}: "
        f"prefill to last-position logits {fwd_ms:.1f} ms (bound "
        f"{bms:.1f} ms, {by}; {flops / 1e12:.2f} TFLOP; after the loss's "
        f"forward; under no_implicit_host_sync), peak {fwd_peak / 1e9:.2f} "
        f"GB above the weights; loss over {T} text tokens "
        f"({-(-T // 8192)} chunks of 8192, the last padded; the first "
        f"forward) {loss_ms:.1f} ms, peak {loss_peak / 1e9:.2f} GB: "
        f"ce {float(metrics['ce']):.4f} (ln V = "
        f"{math.log(cfg.vocab_size):.4f}), aux {aux:g}")
    check(tuple(last.shape) == (FWD_BATCH, 1, cfg.vocab_size)
          and bool(torch.isfinite(last.float()).all()),
          f"{cfg.name} prefill logits not finite or of shape "
          f"{tuple(last.shape)}")
    check(math.isfinite(loss_v) and loss_v > 0, f"{cfg.name} loss {loss_v}")
    check(math.isfinite(aux) and (aux > 0) == cfg.is_moe,
          f"{cfg.name} aux {aux}")

    # information: one attention at this shape, the port's chunked masked
    # softmax against scaled_dot_product_attention
    probe = _attention_probe(cfg, params)
    if probe is None:
        say(f"[model-full] {cfg.name}: attention-free, no attention to "
            "time against the library")
        return time.perf_counter() - t_all
    lp, S_a, causal = probe
    x = torch.randn((FWD_BATCH, S_a, cfg.d_model), generator=gen,
                    device=dev).to(cfg.torch_dtype)
    pos = torch.arange(S_a, device=dev)[None].expand(FWD_BATCH, -1)
    H, hd = cfg.num_heads, cfg.hd

    def plain():
        return attn_lib.attention(lp, x, cfg, positions=pos, causal=causal)

    def library():
        q, k, v = attn_lib._project_qkv(lp, x, x, cfg, 1)
        q = apply_rope(q, pos, cfg.rope_fraction, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_fraction, cfg.rope_theta)
        o = F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=causal, enable_gqa=True)
        return o.transpose(1, 2).reshape(FWD_BATCH, S_a, H * hd) \
            @ lp["wo"].reshape(H * hd, -1)
    # the fused backends only: the math one would hold (B, H, S, S)
    from torch.nn.attention import SDPBackend, sdpa_kernel
    fused = [SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
             SDPBackend.CUDNN_ATTENTION]
    with torch.no_grad():
        a_ms = cuda_ms(torch, plain, 3)
        try:
            with sdpa_kernel(fused):
                rel = _rel_max(library(), plain())
                lib = f"{cuda_ms(torch, library, 3):.3f} ms"
        except RuntimeError as e:
            rel, lib = float("nan"), f"not measured ({str(e)[:80]})"
    say(f"[model-full] {cfg.name} one {'causal' if causal else 'encoder'} "
        f"attention (B {FWD_BATCH}, S {S_a}, H {H}, KV {cfg.num_kv_heads}, "
        f"hd {hd}, projections included): the port's {a_ms:.3f} ms, "
        f"scaled_dot_product_attention {lib} (information; library vs port "
        f"{rel:.2e} of max)")
    return time.perf_counter() - t_all


def _teacher_forced(torch, ops, model, params, tokens, start=0, attend=None,
                    step_attn=None, frames=None, each_step=None,
                    step_params=None):
    """Logits (B, T, V) f32 of decode_step fed ``tokens`` one at a time
    from a zero cache (and recurrent state) at position ``start``, and
    the routing by layer (``_by_layer``); an encoder-decoder's state
    holds the cross K/V of ``frames`` under ``params``. ``attend`` stands
    in for ops.decode_attention, ``step_attn`` for the layers'
    attention_decode_step, ``each_step`` maps the state before every
    step and ``step_params`` stand in for the params of the steps, when
    given."""
    from repro_torch.models import attention as attn_lib
    B, steps = tokens.shape
    dev = tokens.device
    if frames is not None:
        state = model.init_decode_state(B, steps + start, dev, frames=frames,
                                        params=params)
    else:
        state = model.init_decode_state(B, steps + start, dev)
    state = state._replace(pos=torch.full((), start, dtype=torch.int32,
                                          device=dev))
    fd, sa = ops.decode_attention, attn_lib.attention_decode_step
    if attend is not None:
        ops.decode_attention = attend
    if step_attn is not None:
        attn_lib.attention_decode_step = step_attn
    try:
        outs = []
        with _routing([]) as log:
            for t in range(steps):
                if each_step is not None:
                    state = each_step(state)
                logits, state = model.decode_step(
                    params if step_params is None else step_params, state,
                    tokens[:, t:t + 1])
                outs.append(logits[:, 0].float())
    finally:
        ops.decode_attention, attn_lib.attention_decode_step = fd, sa
    return torch.stack(outs, 1), _by_layer(torch, log, model.cfg.num_layers)


def _ssm_controls(torch, model, params) -> dict:
    """The SSM families' decode faults, name → ``_teacher_forced``
    keywords: the recurrent state reset every step; the decay forced to
    1 (rwkv6: the decay base at −inf, so log w = −1e-4 after the clamp;
    mamba: a_log at −inf, so A = 0); the token shift (rwkv6) or the conv
    buffer (mamba) dropped every step."""
    from repro_torch.models.layers import tree_map
    cfg = model.cfg
    if not (cfg.attn_free or cfg.family == "hybrid"):
        return {}

    def zeroed(*names):
        def fn(state):
            rec = _recurrent(state)
            for n in names:
                rec[n] = torch.zeros_like(rec[n])
            if hasattr(state, "ssm"):
                return state._replace(ssm=type(state.ssm)(**rec))
            return state._replace(**rec)
        return fn

    def decay_off(p):
        p = tree_map(lambda w: w, p)         # a new tree, the same leaves
        if cfg.attn_free:
            t = dict(p["layers"]["time"])
            t["dec_base"] = torch.full_like(t["dec_base"], -math.inf)
            p["layers"] = dict(p["layers"], time=t)
        else:
            m = dict(p["mamba_layers"]["mamba"])
            m["a_log"] = torch.full_like(m["a_log"], -math.inf)
            p["mamba_layers"] = dict(p["mamba_layers"], mamba=m)
        return p
    if cfg.attn_free:
        return {"state reset every step": dict(each_step=zeroed("S")),
                "decay forced to 1": dict(step_params=decay_off(params)),
                "token shift dropped": dict(
                    each_step=zeroed("x_prev_t", "x_prev_c"))}
    return {"state reset every step": dict(each_step=zeroed("h")),
            "decay forced to 1": dict(step_params=decay_off(params)),
            "conv buffer dropped": dict(each_step=zeroed("conv_buf"))}


def _decode_controls(torch, ops, ring: bool) -> dict:
    """The teacher-forced decode's faults, name → ``_teacher_forced``
    keywords: on the kernel route stand-ins for ops.decode_attention; on
    the ring route, which never calls it, wrappers of each layer's
    attention_decode_step."""
    if not ring:
        fd = ops.decode_attention
        return {
            "attention zeroed": dict(
                attend=lambda q, k, v, n: torch.zeros_like(q)),
            "KV heads rolled": dict(
                attend=lambda q, k, v, n: fd(q, k.roll(1, 1), v.roll(1, 1),
                                             n))}
    from repro_torch.models import attention as attn_lib
    step = attn_lib.attention_decode_step

    def zeroed(p, x, cache, pos, cfg, kv_repeat=1, use_kernel=False):
        y, cache = step(p, x, cache, pos, cfg, kv_repeat, use_kernel)
        return torch.zeros_like(y), cache

    def rolled(p, x, cache, pos, cfg, kv_repeat=1, use_kernel=False):
        step(p, x, cache, pos, cfg, kv_repeat, use_kernel)   # the write
        y, _ = step(p, x, attn_lib.LayerKVCache(cache.k.roll(1, 1),
                                                cache.v.roll(1, 1)),
                    pos, cfg, kv_repeat, use_kernel)
        return y, cache
    return {"attention zeroed": dict(step_attn=zeroed),
            "KV heads rolled": dict(step_attn=rolled)}


def _tf_steps(cfg) -> int:
    """Teacher-forced decode length: TF_STEPS; the SSM families their
    SSM_TF_STEPS, so that the forward spans several chunks."""
    if cfg.attn_free:
        return SSM_TF_STEPS["ssm"]
    return SSM_TF_STEPS["hybrid"] if cfg.family == "hybrid" else TF_STEPS


def _decode_vs_forward(torch, ops, model, params, gen) -> int:
    """_tf_steps tokens teacher-forced through decode_step (the kernel
    route; a sliding-window config's ring route) against forward's
    logits over the same tokens (an encoder-decoder's over the same stub
    frames), over the positions routed alike, with controls. → the
    decode's flash_decode launches."""
    cfg = model.cfg
    ring = bool(cfg.sliding_window)
    steps = _tf_steps(cfg)
    tokens = torch.randint(0, cfg.vocab_size, (FWD_BATCH, steps),
                           generator=gen, device=gen.device,
                           dtype=torch.int32)
    frames = None
    if cfg.is_encoder_decoder:
        frames = torch.randn((FWD_BATCH, cfg.encoder_seq, cfg.d_model),
                             generator=gen, device=gen.device
                             ).to(cfg.torch_dtype)
    L = cfg.num_layers
    with torch.no_grad():
        with _routing([]) as log:
            want = (model.forward(params, tokens, frames) if frames is not None
                    else model.forward(params, tokens))[0].float()
        route_w = _by_layer(torch, log, L)
        ops.reset_launches()
        got, route_g = _teacher_forced(torch, ops, model, params, tokens,
                                       frames=frames)
        launches = ops.LAUNCHES["flash_decode"]
        routes = _routes(ops, "flash_decode")
        first = tokens[:, :CONTROL_STEPS]
        kws = dict(_ssm_controls(torch, model, params))
        if not cfg.attn_free:       # rwkv6 reads no position
            kws["positions shifted by one"] = dict(start=1)
            kws.update(_decode_controls(torch, ops, ring))
        controls = {name: _teacher_forced(torch, ops, model, params, first,
                                          frames=frames, **kw)
                    for name, kw in kws.items()}
    scale = float(want.abs().max())
    shape = tokens.shape
    alike = _alike(torch, route_g, route_w, shape)
    rel, share, ok = _rows_check(torch, got, want, alike, scale,
                                 DECODE_FWD_TOL)
    head = (lambda r: None if r is None else r[:, :, :CONTROL_STEPS])
    ctl = {n: _rows_check(torch, c, want[:, :CONTROL_STEPS],
                          _alike(torch, r, head(route_w),
                                 first.shape), scale, DECODE_FWD_TOL)
           for n, (c, r) in controls.items()}
    diff = float((got - want)[alike].abs().max()) if bool(alike.any()) \
        else float("inf")
    top2 = want.topk(2, dim=-1).values
    clear = ((top2[..., 0] - top2[..., 1]) > diff) & alike
    agree = got.argmax(-1) == want.argmax(-1)
    every = float((got - want).abs().max()) / scale
    want_l = 0 if ring else _attn_layers(model) * steps
    say(f"[model-full] {cfg.name} decode of {steps} teacher-forced tokens "
        f"× {FWD_BATCH} in {cfg.dtype} from a zero cache vs forward: logits "
        f"max|Δ| "
        f"{rel:.2e} of max |logit| {scale:.3f} over the {share:.0%} of "
        f"positions routed alike in every layer (tol {DECODE_FWD_TOL:g}, "
        f"at least {MIN_ALIKE:.0%}; {every:.2e} over all); controls: "
        + ", ".join(f"{n} {_over(r, s)}" for n, (r, s, _) in ctl.items())
        + f" (over the first {CONTROL_STEPS}); greedy tokens equal at "
        f"{int(agree.sum())} of {agree.numel()} positions, "
        f"{int(clear.sum())} routed alike with a top-2 margin > their "
        f"max|Δ|; flash_decode launches {launches} (want {want_l}), routes "
        f"{routes}")
    check(ok, f"{cfg.name} teacher-forced decode differs from the forward "
          f"by {rel:.2e} over {share:.0%} of the positions")
    check(not any(c[2] for c in ctl.values()), f"{cfg.name}: the decode-vs-"
          f"forward check cannot see a control ({ctl})")
    check(bool(agree[clear].all()), f"{cfg.name} greedy tokens differ where "
          "the margin exceeds the difference")
    route = ops.decode_route(cfg.torch_dtype, cfg.hd)
    check(launches == want_l and routes[route] == launches,
          f"{cfg.name} decode launched flash_decode {launches} times, "
          f"routes {routes}")
    check(len(ctl) >= 3, f"{cfg.name}: only {len(ctl)} controls")
    return launches


@contextlib.contextmanager
def plain_kernels(ops, ref):
    """The solve and eq. 7 wrappers replaced by their plain versions, on
    the card's tensors; the plain solve's epochs replayed from CUDA
    graphs (:func:`_plain_solve`, checked bit for bit against the plain
    solve as shipped first)."""
    import torch
    from repro_torch import sparse as sp
    _check_graphed_plain(torch, ref, sp)
    solve, hinge = ops.cd_solve, ops.hinge_scores
    ops.cd_solve = lambda xh, xs, y, m, **kw: _plain_solve(torch, ref, xh,
                                                           xs, y, m, kw)
    ops.hinge_scores = ref.hinge_scores_ref
    try:
        yield
    finally:
        ops.cd_solve, ops.hinge_scores = solve, hinge


def phase_embed_full(torch, T, ops, ref, model, params) -> dict:
    """examples/torch_embed_svm.py's pipeline on the full-width backbone:
    800 messages × 24 tokens → mean-pooled bf16 rows (d = d_model) → the
    MapReduce SVM over 8 partitions with the kernels, held to the same
    fit with the plain versions on the card. → launches by kernel row."""
    mod = _example("torch_embed_svm")
    t0 = time.perf_counter()
    ops.reset_launches()
    res = mod.pipeline(model, params, messages=800, verbose=False)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {k: ops.LAUNCHES[k] for k in ("cd_solve", "hinge_scores")}
    routes = {k: v for k, v in ops.ROUTE_LAUNCHES.items()
              if k.split("/")[0] in launches and v}
    X, svm = res["X"], res["svm"]
    t0 = time.perf_counter()
    with plain_kernels(ops, ref):
        plain = T.fit_mapreduce(X, res["y"], 8, mod.MCFG)
    plain_s = time.perf_counter() - t0
    picks = [h["reducer"] for h in svm.history]
    worst = max(abs(a["risk"] - b["risk"])
                for a, b in zip(svm.history, plain.history))
    say(f"[embed-full] {model.cfg.name}: {tuple(X.shape)} {X.dtype} rows in "
        f"{secs:.1f} s with the fit, {svm.rounds} rounds, picks {picks}, "
        f"R_emp {[round(h['risk'], 5) for h in svm.history]}, accuracy "
        f"{res['accuracy']:.3f}; plain versions on the card ({plain_s:.1f} "
        f"s): picks {[h['reducer'] for h in plain.history]}, R_emp max|Δ| "
        f"{worst:.2e} (tol {EMBED_TOL:g}); launches {launches}, by route "
        f"{routes}")
    check(X.dtype == model.cfg.torch_dtype
          and tuple(X.shape) == (800, model.cfg.d_model), "embed rows")
    check(len(svm.history) == len(plain.history)
          and picks == [h["reducer"] for h in plain.history],
          "[embed-full] the kernel fit and the plain fit pick differently")
    check(worst <= EMBED_TOL, f"[embed-full] R_emp differs by {worst:.2e}")
    check(all(launches.values()), f"[embed-full] launches {launches}")
    return launches


def phase_model_full(torch, T, ops, ref, arch, batch, cache_len):
    """One config at full width: seeded random weights on the card, the
    forward and the loss, the teacher-forced decode against the forward,
    the serve path (phase_serve_full) and, for qwen2-1.5b, [embed-full];
    the weights freed after. A MoE config keeps its width, experts and
    top-k, its depth cut to MOE_LAYERS; its decode runs against the
    forward at capacity factor E / K (C = T: neither drops a token, as
    the reference's own decode test sets 8.0), its forward and serve at
    the config's own. → (the serve's flash_decode row, None on the ring
    route, its launches by path, [embed-full]'s launches)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = get_config(arch)
    cut = ""
    if cfg.is_moe:
        cut = (f"; a stated cut: {MOE_LAYERS} of its {cfg.num_layers} "
               f"layers, every one of its {cfg.num_experts} experts, top-"
               f"{cfg.experts_per_token}, capacity factor "
               f"{cfg.moe_capacity_factor:g}")
        cfg = dataclasses.replace(cfg, num_layers=MOE_LAYERS)
    model = build_model(cfg)
    dev = torch.device(DEV)
    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = model.init(gen)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    w_bytes = _nbytes(params)
    transient = torch.cuda.max_memory_allocated() - before - w_bytes
    if cfg.family == "hybrid":
        cut += (f"; {cfg.num_layers} mamba2 layers (d_state "
                f"{cfg.ssm_state}) in {cfg.num_layers // cfg.attn_every} "
                f"segments, the shared attention block after each")
    elif cfg.attn_free:
        cut += "; attention-free (rwkv6 time and channel mixes)"
    elif cfg.is_encoder_decoder:
        cut += (f"; {cfg.encoder_layers} encoder layers over "
                f"{cfg.encoder_seq} stub frames, {cfg.num_layers} decoder "
                f"layers up to {cfg.max_decoder_len} tokens")
    say(f"[model-full] {arch} ({cfg.family}): {cfg.num_layers} layers, d "
        f"{cfg.d_model}, {cfg.num_heads} heads / {cfg.num_kv_heads} KV (G "
        f"{cfg.num_heads // cfg.num_kv_heads}), hd {cfg.hd}, ff {cfg.d_ff}, "
        f"vocab {cfg.vocab_size}, {cfg.dtype}; weights {w_bytes / 1e9:.3f} GB "
        f"({w_bytes / 2 ** 30:.2f} GiB) drawn in {init_s:.1f} s, init "
        f"transient {transient / 1e9:.3f} GB{cut}")
    fwd_s = _forward_full(torch, model, params, gen)
    t0 = time.perf_counter()
    tf_model, tf_params = model, params
    if cfg.is_moe:
        tf_model = build_model(dataclasses.replace(
            cfg, moe_capacity_factor=cfg.num_experts
            / cfg.experts_per_token))
    if cfg.attn_free or cfg.family == "hybrid":
        from repro_torch.models.layers import tree_map
        tf_model = build_model(dataclasses.replace(cfg, dtype="float32"))
        tf_params = tree_map(lambda w: w.float(), params)
    paths = {f"decode-vs-forward:{arch}": _decode_vs_forward(
        torch, ops, tf_model, tf_params, gen)}
    del tf_params
    tf_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    row = phase_serve_full(torch, ops, ref, cfg, params, batch, cache_len,
                           16)
    paths[f"serve-full:{arch}"] = 0 if row is None else row["launches"]
    serve_s = time.perf_counter() - t0
    embed = {}
    if arch == "qwen2-1.5b":
        embed = phase_embed_full(torch, T, ops, ref, model, params)
    del params
    torch.cuda.empty_cache()
    say(f"[model-full] {arch} done in {time.perf_counter() - t_phase:.1f} s "
        f"(init {init_s:.1f}, forward and loss {fwd_s:.1f}, decode vs "
        f"forward {tf_s:.1f}, serve {serve_s:.1f})")
    return row, paths, embed


# --- slice 20: tensor- and data-parallel LM serving on ranks ---------------

# [tp-serve-full]: chatglm3-6b at full width and depth on a 1 × 4 mesh of
# ranks sharing the card over gloo. kv_repeat is 2 (2 KV heads → 4), so a
# rank decodes its 8 of the 32 query heads over 1 of the 4 cache heads (G
# 8, hd 128). The cache of 8192 is a stated cut: r = 2 doubles the KV
# cache, 60 GB at 32768 over the four ranks of one card.
TP_ARCH = "chatglm3-6b"
TP_GRID = (1, 4)
TP_BATCH, TP_CACHE, TP_STEPS = 32, 8192, 16
# The data axis (FSDP gathers, the batch split) at smoke width only: its
# weight gathers through gloo's host staging would take seconds a step at
# full width.
TP_SMOKE_GRID, TP_SMOKE_BATCH, TP_SMOKE_CACHE = (2, 2), 4, 256
# A float32 check of the same weights on the same 1 × 4 ranks, tight
# enough to see one head's fault: 4 teacher-forced steps at batch 4 over
# a 16-slot cache, with seeded random q/k/v biases (the template's are
# zeros, which would hide a dropped bias shard), against the one-rank
# float32 run. The bf16 limit above is ~0.19 of max |logit|, wider than
# one head's fault; float32 differs only by the order of the sums (the
# CPU tests hold the sharded step to JAX's at 1e-5 of max |logit|).
# Three controls, each on one rank only, one step each (a step of the
# four ranks over gloo takes 0.5–0.8 s): two of its heads' output rows
# swapped in every layer, its shard of the q bias dropped, and the new
# K/V cut from the next rank's block of the KV·r heads (a wrong kv_repeat
# slice: it reaches only the new slot, hence the short cache).
TP32_BATCH, TP32_CACHE, TP32_STEPS = 4, 16, 4
TP32_BIAS_STD = 0.5
TP32_TOL = 1e-4


def _tp_prompts(torch, vocab: int, batch: int):
    """Seeded, distinct first tokens (batch, 1) int32 on the host."""
    gen = torch.Generator().manual_seed(11)
    return torch.randperm(vocab, generator=gen)[:batch, None].to(torch.int32)


def _tp_logits(torch, model, params, state, start, tokens):
    """Last logits (steps, B, V) f32 on the host of decode_step fed
    ``tokens`` (B, steps) one at a time from ``state`` at position
    ``start`` (slots from ``start`` on are written before they are
    read)."""
    st = state._replace(pos=start)
    outs = []
    for t in range(tokens.shape[1]):
        logits, st = model.decode_step(params, st, tokens[:, t:t + 1])
        outs.append(logits[:, -1].float().cpu())
    return torch.stack(outs)


def _tp_build(cfg, mesh, batch: int, cache: int):
    """The serve bundle's model of ``cfg`` on ``mesh`` and (params', state's)
    placements (``launch.steps.build_serve_step``)."""
    from repro_torch.launch.steps import InputShape, build_serve_step
    bundle = build_serve_step(cfg, mesh, InputShape("tp", "decode", cache,
                                                    batch))
    return bundle.model, bundle.in_shardings[:2]


def _tp_fill(torch, cfg, params, state, gen, kv_repeat=1, place=None,
             mesh=None, biases=False):
    """Seeded random q/k/v biases (``biases``) and K/V in every slot,
    each drawn whole as the one-rank run draws it (the cache layer by
    layer), repeated ``kv_repeat``× and cut to this rank's slice under
    ``place`` (the params' and state's placements) on ``mesh``."""
    from repro_torch.models.layers import local_shard, shard_count

    def cut(t, pl):
        return t if mesh is None else local_shard(t, pl, mesh)
    attn = params["layers"]["attn"]
    for b in ("bq", "bk", "bv") if biases else ():
        lead = (cfg.num_layers,)
        heads = cfg.num_heads if b == "bq" else cfg.num_kv_heads
        whole = torch.empty(lead + (heads, cfg.hd), dtype=attn[b].dtype,
                            device=attn[b].device)
        whole.normal_(std=TP32_BIAS_STD, generator=gen)
        attn[b].copy_(cut(whole, None if mesh is None else place[0][
            "layers"]["attn"][b]))
    B, S = state.caches.k.shape[1], state.caches.k.shape[3]
    if mesh is not None:
        B *= shard_count(place[1].caches.k[1], mesh)
    whole = torch.empty((B, cfg.num_kv_heads, S, cfg.hd),
                        dtype=state.caches.k.dtype,
                        device=state.caches.k.device)
    for i in range(cfg.num_layers):
        for dst, std in ((state.caches.k[i], KEY_SCALE),
                         (state.caches.v[i], 1.0)):
            whole.normal_(std=std, generator=gen)
            dst.copy_(cut(whole.repeat_interleave(kv_repeat, 1),
                          None if mesh is None else place[1].caches.k[1:]))


def _tp_serve_rank(rank, sprompts, prompts, tf_in) -> dict:
    """This rank's part of [tp-serve-full]: the smoke serve on the 2 × 2
    mesh, then chatglm3-6b on the 1 × 4 mesh: its shards of seed 0's
    weights and of the seed-1 cache (each layer's K/V drawn whole as the
    one-rank run draws them, repeated r× and cut), the main path (one
    serve_lm, its flash_decode launches counted from 0), the
    teacher-forced logits on the one-rank tokens, the two controls and
    one step under no_implicit_host_sync; then the float32 check and its
    three controls. → rank 0's logits and the rank's tokens, launches,
    ms, bytes and peak."""
    import dataclasses
    import torch
    from repro_torch.analysis import no_implicit_host_sync
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.serve import serve_lm
    from repro_torch.models import attention as attn_lib
    from repro_torch.models import layers, smoke_variant
    t_part = time.perf_counter()
    dev = torch.device(rank.device)
    out = {}
    ops.reset_launches()
    smoke = serve_lm(smoke_variant(get_config(TP_ARCH)), batch=TP_SMOKE_BATCH,
                     cache_len=TP_SMOKE_CACHE, tokens=TP_STEPS, device=dev,
                     mesh=make_host_mesh(*TP_SMOKE_GRID), first=sprompts)
    out["smoke_tokens"] = smoke.tokens.numpy()
    out["smoke_launches"] = ops.LAUNCHES["flash_decode"]
    del smoke
    cfg = get_config(TP_ARCH)
    mesh = make_host_mesh(*TP_GRID)
    model, place = _tp_build(cfg, mesh, TP_BATCH, TP_CACHE)
    r = model.kv_repeat
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    state = model.init_decode_state(TP_BATCH, TP_CACHE, dev, place=place[1])
    _tp_fill(torch, cfg, params, state,
             torch.Generator(device=dev).manual_seed(1), r, place, mesh)
    start = torch.full((), TP_CACHE - TP_STEPS, dtype=torch.int32,
                       device=dev)
    tf = tf_in.to(dev)
    torch.cuda.synchronize()
    out["setup_s"] = time.perf_counter() - t0
    # a warm step (its slot is written again before it is read)
    model.decode_step(params, state._replace(pos=start), tf[:, :1])
    # --- the main path: counts from 0, one serve_lm, counts read ---------
    ops.reset_launches()
    res = serve_lm(cfg, batch=TP_BATCH, cache_len=TP_CACHE, tokens=TP_STEPS,
                   device=dev, params=params, state=state._replace(pos=start),
                   mesh=mesh, first=prompts)
    out["launches"] = ops.LAUNCHES["flash_decode"]
    out["routes"] = {k: v for k, v in ops.ROUTE_LAUNCHES.items()
                     if k.startswith("flash_decode") and v}
    out["tokens"] = res.tokens.numpy()
    out["step_ms"] = 1e3 * res.seconds / TP_STEPS
    out["kv_repeat"] = r
    out["heads"] = (params["layers"]["attn"]["wq"].shape[2],
                    state.caches.k.shape[2])
    out["bytes"] = _step_bytes(model, params, state, TP_BATCH, TP_CACHE,
                               TP_STEPS)[0]
    out["shard_bytes"] = _nbytes(params)
    # one all-reduce of the residual stream (B × d f32) over the model
    # group, as a layer sums its partial products: its round trip
    x = torch.zeros((TP_BATCH, cfg.d_model), device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        x = layers.model_sum(x, mesh)
    torch.cuda.synchronize()
    out["sum_ms"] = 1e3 * (time.perf_counter() - t0) / 10
    got = _tp_logits(torch, model, params, state, start, tf)
    # the controls, one step each from the same cache and position
    fd, sm = ops.decode_attention, attn_lib.sharded_matmul

    def heads_alone(x, w, place, mesh, *, nk=1, x_split=False):
        summed = layers.model_sum
        layers.model_sum = lambda y, mesh: y
        try:
            return sm(x, w, place, mesh, nk=nk, x_split=x_split)
        finally:
            layers.model_sum = summed
    controls = {}
    for name, patch in (
            ("one rank's heads alone in the attention sum",
             lambda: setattr(attn_lib, "sharded_matmul", heads_alone)),
            ("valid_len one chunk short",
             lambda: setattr(ops, "decode_attention", lambda q, k, v, n: fd(
                 q, k, v, n - _fd_chunk(TP_CACHE))))):
        patch()
        try:
            controls[name] = _tp_logits(torch, model, params, state, start,
                                        tf[:, :1])[0]
        finally:
            ops.decode_attention, attn_lib.sharded_matmul = fd, sm
    torch.cuda.synchronize()
    with no_implicit_host_sync():
        model.decode_step(params, state._replace(pos=start), tf[:, :1])
    torch.cuda.synchronize()
    out["peak"] = torch.cuda.max_memory_allocated()
    if rank.rank == 0:
        out["logits"], out["controls"] = got.numpy(), {
            k: v.numpy() for k, v in controls.items()}
    del params, state, res, model
    torch.cuda.empty_cache()
    # --- float32: the same weights, tight enough to see one head's fault
    t0 = time.perf_counter()
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    model, place = _tp_build(cfg32, mesh, TP32_BATCH, TP32_CACHE)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    state = model.init_decode_state(TP32_BATCH, TP32_CACHE, dev,
                                    place=place[1])
    _tp_fill(torch, cfg32, params, state,
             torch.Generator(device=dev).manual_seed(2), r, place, mesh,
             biases=True)
    start = torch.full((), TP32_CACHE - TP32_STEPS, dtype=torch.int32,
                       device=dev)
    tf = tf_in[:TP32_BATCH, :TP32_STEPS].to(dev)
    got = _tp_logits(torch, model, params, state, start, tf)
    attn, m, ms = params["layers"]["attn"], mesh.shape["model"], \
        attn_lib.model_shard
    bq = attn["bq"].clone()

    def swap_heads():                     # an involution: undoes itself
        attn["wo"][:, [0, 1]] = attn["wo"][:, [1, 0]]

    def next_block(t, dim, mesh):
        size = t.shape[dim] // m
        return t.narrow(dim, (mesh.index("model") + 1) % m * size, size)
    controls = {}
    for name, who, patch, undo in (
            ("rank 2's heads 0 and 1 swapped in wo", 2, swap_heads,
             swap_heads),
            ("rank 3's shard of the q bias dropped", 3,
             lambda: attn["bq"].zero_(), lambda: attn["bq"].copy_(bq)),
            ("rank 1's new K/V cut from the next rank's block", 1,
             lambda: setattr(attn_lib, "model_shard", next_block),
             lambda: setattr(attn_lib, "model_shard", ms))):
        if rank.rank == who:
            patch()
        try:
            controls[name] = _tp_logits(torch, model, params, state, start,
                                        tf[:, :1])[0]
        finally:
            if rank.rank == who:
                undo()
    if rank.rank == 0:
        out["logits32"], out["controls32"] = got.numpy(), {
            k: v.numpy() for k, v in controls.items()}
    out["f32_s"] = time.perf_counter() - t0
    del params, state
    torch.cuda.empty_cache()
    out["s"] = time.perf_counter() - t_part
    return out


def _tp_token_checks(torch, got, want, tokens, one_tokens, tag):
    """Tokens (steps, B) of a sharded run against the one-rank run's:
    the teacher-forced argmax equal where the one-rank top-2 margin
    exceeds the step's max |Δ| of the logits; the free-running serve's
    rows equal up to their first difference, which must come at such a
    near tie. → (steps × rows equal, rows that ran apart)."""
    diff = (got - want).abs().amax(-1)                       # (steps, B)
    top2 = want.topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > diff
    agree = got.argmax(-1) == one_tokens.long()
    check(bool(agree[clear].all()), f"[{tag}] teacher-forced tokens differ "
          "where the margin exceeds the ranks' difference")
    same = torch.from_numpy(tokens).long() == one_tokens.long()
    apart = 0
    for b in range(same.shape[1]):
        if bool(same[:, b].all()):
            continue
        t = int((~same[:, b]).nonzero()[0, 0])
        apart += 1
        check(not bool(clear[t, b]), f"[{tag}] row {b} ran apart at step "
              f"{t}, where the one-rank margin exceeds the difference")
    return int(agree.sum()), apart


def phase_tp_serve(torch, ops, ref):
    """``[tp-serve-full]`` (the module's docstring, phase 18). → (the
    flash_decode entry of a rank's shape for the row's ``configs``, the
    main path's launches over the ranks)."""
    import dataclasses
    from repro_torch import compat
    from repro_torch.configs import get_config
    from repro_torch.launch import costs
    from repro_torch.launch.serve import serve_lm
    from repro_torch.launch.steps import InputShape
    from repro_torch.models import build_model, smoke_variant
    from repro_torch.models.layers import tree_map
    import numpy as np
    t_phase = time.perf_counter()
    dev = torch.device(DEV)
    scfg = smoke_variant(get_config(TP_ARCH))
    sprompts = _tp_prompts(torch, scfg.vocab_size, TP_SMOKE_BATCH)
    sparams = build_model(scfg).init(torch.Generator(device=dev)
                                     .manual_seed(0))
    cpu = serve_lm(scfg, batch=TP_SMOKE_BATCH, cache_len=TP_SMOKE_CACHE,
                   tokens=TP_STEPS, device="cpu", first=sprompts,
                   params=tree_map(lambda w: w.cpu(), sparams))
    del sparams
    # the one-rank reference at full width: seed 0's weights, seed 1's
    # cache, the kernel route
    cfg = get_config(TP_ARCH)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    state = model.init_decode_state(TP_BATCH, TP_CACHE, dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    _fill_cache(torch, state, gen)
    prompts = _tp_prompts(torch, cfg.vocab_size, TP_BATCH)
    start = torch.full((), TP_CACHE - TP_STEPS, dtype=torch.int32,
                       device=dev)
    model.decode_step(params, state._replace(pos=start),
                      prompts.to(dev))                    # a warm step
    torch.cuda.synchronize()
    one = serve_lm(cfg, batch=TP_BATCH, cache_len=TP_CACHE, tokens=TP_STEPS,
                   device=dev, params=params, state=state._replace(pos=start),
                   first=prompts)
    tf_in = torch.cat([prompts, one.tokens[:-1].T], 1)      # (B, steps)
    want = _tp_logits(torch, model, params, state, start, tf_in.to(dev))
    check(torch.equal(want.argmax(-1).to(torch.int32), one.tokens),
          "[tp-serve-full] the one-rank teacher-forced argmax is not its "
          "serve's tokens")
    one_bytes = _step_bytes(model, params, state, TP_BATCH, TP_CACHE,
                            TP_STEPS)[0]
    m = TP_GRID[1]
    H = cfg.num_heads // m
    k = state.caches.k[0][:, :1].contiguous()    # rank 0's cache head
    v = state.caches.v[0][:, :1].contiguous()
    full = torch.full((), TP_CACHE, dtype=torch.int32, device=dev)
    fd_row = time_flash_decode(torch, ops, ref, H, k, v, full, gen)
    del params, state, model, k, v
    torch.cuda.empty_cache()
    # the one-rank float32 reference of the float32 check
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    model = build_model(cfg32)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    state = model.init_decode_state(TP32_BATCH, TP32_CACHE, dev)
    _tp_fill(torch, cfg32, params, state,
             torch.Generator(device=dev).manual_seed(2), biases=True)
    start = torch.full((), TP32_CACHE - TP32_STEPS, dtype=torch.int32,
                       device=dev)
    want32 = _tp_logits(torch, model, params, state, start,
                        tf_in[:TP32_BATCH, :TP32_STEPS].to(dev))
    del params, state, model
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    one_s = time.perf_counter() - t_phase
    t0 = time.perf_counter()
    per_rank = compat.spawn(_tp_serve_rank, m * TP_GRID[0],
                            (sprompts, prompts, tf_in), device="cuda",
                            timeout_s=300.0, join_timeout_s=600.0)
    spawn_s = time.perf_counter() - t0
    # the data axis at smoke width: every rank the whole batch's tokens
    for r, res in enumerate(per_rank):
        check(torch.equal(torch.from_numpy(res["smoke_tokens"]), cpu.tokens),
              f"[tp-serve-full] smoke rank {r}: {TP_SMOKE_GRID} ranks' "
              "tokens differ from the one-rank CPU run")
    slaunch = sum(r["smoke_launches"] for r in per_rank)
    say(f"[tp-serve-full] {scfg.name} smoke variant on {TP_SMOKE_GRID[0]} "
        f"data × {TP_SMOKE_GRID[1]} model ranks (FSDP gathers, batch "
        f"{TP_SMOKE_BATCH} split): {TP_STEPS} tokens ≡ the one-rank CPU run "
        f"(plain versions) on every rank; flash_decode launches "
        f"{slaunch} over the ranks")
    check(slaunch == scfg.num_layers * TP_STEPS * len(per_rank),
          f"[tp-serve-full] the smoke serve launched {slaunch} flash_decode")
    # full width: the teacher-forced logits against the one-rank run's
    r0 = per_rank[0]
    got = torch.from_numpy(r0["logits"])
    scale = float(want.abs().max())
    tol = SWAP_TOL * cfg.num_layers
    rel = [float((got[t] - want[t]).abs().max()) / scale
           for t in range(TP_STEPS)]
    ctl = {n: float((torch.from_numpy(c) - want[0]).abs().max()) / scale
           for n, c in r0["controls"].items()}
    agree, apart = _tp_token_checks(torch, got, want, r0["tokens"],
                                    one.tokens, "tp-serve-full")
    for r, res in enumerate(per_rank):
        check(np.array_equal(res["tokens"], r0["tokens"]),
              f"[tp-serve-full] rank {r}'s tokens are not rank 0's")
    launches = sum(r["launches"] for r in per_rank)
    routes = {}
    for res in per_rank:
        for key, n in res["routes"].items():
            routes[key] = routes.get(key, 0) + n
    want_launches = cfg.num_layers * TP_STEPS * len(per_rank)
    bytes_rank = max(r["bytes"] for r in per_rank)
    bms_rank = bytes_rank / HBM_BYTES_PER_S * 1e3
    card_ms = sum(r["bytes"] for r in per_rank) / HBM_BYTES_PER_S * 1e3
    analytic = costs.step_hbm_bytes(cfg, InputShape(
        "tp", "decode", TP_CACHE, TP_BATCH))
    one_ms = 1e3 * one.seconds / TP_STEPS
    say(f"[tp-serve-full] {TP_ARCH} at full width: {cfg.num_layers} layers, "
        f"d {cfg.d_model}, {cfg.num_heads} heads / {cfg.num_kv_heads} KV, "
        f"kv_repeat {r0['kv_repeat']} → a rank's {r0['heads'][0]} query heads "
        f"over {r0['heads'][1]} cache head (G "
        f"{r0['heads'][0] // r0['heads'][1]}), on {TP_GRID[0]} × {m} ranks "
        f"over gloo on this card; batch {TP_BATCH}, cache {TP_CACHE} (a "
        f"stated cut), {TP_STEPS} steps from position "
        f"{TP_CACHE - TP_STEPS}")
    say(f"[tp-serve-full] teacher-forced logits vs the one-rank kernel "
        f"route, by step: max|Δ| / max|logit| {scale:.3f} = "
        f"{[f'{x:.2e}' for x in rel]} (tol {tol:.3g} = {SWAP_TOL:.4g} a "
        f"layer × {cfg.num_layers}); controls at step 0: "
        + ", ".join(f"{n} {x:.2e}" for n, x in ctl.items())
        + f"; greedy tokens: teacher-forced {agree} of "
        f"{TP_STEPS * TP_BATCH} equal, the serve's rows run apart in "
        f"{apart} of {TP_BATCH}, each at a near tie")
    check(max(rel) <= tol, f"[tp-serve-full] logits differ by {max(rel):.2e}")
    check(min(ctl.values()) > tol, "[tp-serve-full] the check cannot see a "
          f"control: {ctl}")
    got32 = torch.from_numpy(r0["logits32"])
    scale32 = float(want32.abs().max())
    rel32 = [float((got32[t] - want32[t]).abs().max()) / scale32
             for t in range(TP32_STEPS)]
    ctl32 = {n: float((torch.from_numpy(c) - want32[0]).abs().max())
             / scale32 for n, c in r0["controls32"].items()}
    say(f"[tp-serve-full] float32, the same weights with q/k/v biases "
        f"N(0, {TP32_BIAS_STD}), batch {TP32_BATCH}, cache {TP32_CACHE}, "
        f"{TP32_STEPS} teacher-forced steps on the {TP_GRID[0]} × {m} ranks "
        f"vs the one-rank float32 run: max|Δ| / max|logit| {scale32:.3f} = "
        f"{[f'{x:.2e}' for x in rel32]} (tol {TP32_TOL:.0e}); controls "
        "at step 0, each on one rank: "
        + ", ".join(f"{n} {x:.2e}" for n, x in ctl32.items())
        + f" ({max(x['f32_s'] for x in per_rank):.1f} s a rank)")
    check(max(rel32) <= TP32_TOL, "[tp-serve-full] float32 logits differ "
          f"by {max(rel32):.2e}")
    check(min(ctl32.values()) > TP32_TOL, "[tp-serve-full] the float32 "
          f"check cannot see a control: {ctl32}")
    say(f"[tp-serve-full] serve_lm on the ranks: ms a step by rank "
        f"{[round(x['step_ms'], 3) for x in per_rank]} against "
        f"{one_ms:.3f} on one rank (a step's {2 * cfg.num_layers + 1} "
        f"all-reduces and a gather: one all-reduce of {TP_BATCH} × "
        f"{cfg.d_model} f32 over the model group "
        f"{[round(x['sum_ms'], 3) for x in per_rank]} ms by rank); a rank's "
        f"bytes bound {bms_rank:.3f} ms "
        f"({bytes_rank / 1e9:.3f} GB a step: its weight shards "
        f"{r0['shard_bytes'] / 1e9:.3f} GB, its cache head's rows), the "
        f"four ranks on one card {card_ms:.3f} ms (one rank: "
        f"{one_bytes / HBM_BYTES_PER_S * 1e3:.3f}; launch.costs' whole "
        f"step {analytic / 1e9:.2f} GB, a quarter "
        f"{analytic / 4 / HBM_BYTES_PER_S * 1e3:.3f} ms); peak memory by "
        f"rank (GB) {[round(x['peak'] / 1e9, 2) for x in per_rank]}; "
        f"flash_decode launches {launches} over the ranks (want "
        f"{want_launches}), routes {routes}; one step a rank under "
        f"no_implicit_host_sync")
    check(launches == want_launches and routes.get(
        "flash_decode/tensor_core", 0) == launches,
        f"[tp-serve-full] flash_decode launched {launches}, routes {routes}")
    say(f"[tp-serve-full] done in {time.perf_counter() - t_phase:.1f} s (the "
        f"one-rank reference and flash_decode {one_s:.1f}, the spawn "
        f"{spawn_s:.1f}: a rank's setup {r0['setup_s']:.1f}, its part "
        f"{max(x['s'] for x in per_rank):.1f})")
    entry = {key: fd_row[key] for key in (
        "ms", "plain_ms", "bound_ms", "library_ms", "simt_ms", "shape")}
    entry["launches"] = launches
    return entry, launches


# --- slice 21: the dry run on fake groups of 256 and 512 ranks -------------

# rank 0's measured peak over its reckoned peak: within these bounds
DRYRUN_PEAK_LIMITS = (0.8, 1.25)
SPARSE_RING = dict(shuffle="ring", row_format="sparse_csr", nnz_cap=256)
# shape-only runs on the host; the ring runs are in DRYRUN_ON_CARD
DRYRUN_SHAPE_ONLY = tuple(
    ("svm-tfidf", shape, dict(shuffle=t))
    for shape in ("svm", "svm_sweep", "svm_serve")
    for t in ("allgather", "hier")) + (
    ("svm-tfidf", "svm_sweep", dict(shuffle="ring", processes=2)),
    ("tinyllama-1.1b", "decode_32k", dict(multi_pod=True)))
# shape-only and rank 0 run for real on the card, 16 × 16
DRYRUN_ON_CARD = (
    ("svm-tfidf", "svm", dict(shuffle="ring")),
    ("svm-tfidf", "svm_sweep", dict(shuffle="ring")),
    ("svm-tfidf", "svm_serve", dict(shuffle="ring")),
    ("svm-tfidf", "svm_sweep", SPARSE_RING),
    ("llama3-8b", "decode_32k", {}))


def _dryrun_tag(arch, shape, kw) -> str:
    return " ".join([arch, shape] + [f"{k}={v}" for k, v in kw.items()])


# the steps whose first solve call [dryrun] holds against the plain solve:
# the round's (one job of 8192 + 2048 rows on the dense ring, the shape
# and program of [sharded-full]'s rank 0 check) is not held again, a
# stated cut since a whole run took 1073.4 s of its 1200 on an H100
# host; the 8-job sweeps and the serve wave's 640-row blocks are
DRYRUN_SOLVE_CHECKED = ("svm_sweep", "svm_serve")


def _dryrun_inspect(torch, ops, ref, sp, tag, got, solve_check=True):
    """``run_on_card``'s inspection of a step: the launches of its two
    measured runs read first; then a third run records job 0 of the
    step's first ``cd_solve`` call (every epoch it ran) and its first
    ``hinge_scores`` call, each held against its plain version (the
    solve only with ``solve_check``); for the LM step ``flash_decode`` at its layer's shape (its
    cache slice, keys N(0, KEY_SCALE²)) checked and timed."""
    def inspect(fn, args):
        got["routes"] = {k: v for k, v in ops.ROUTE_LAUNCHES.items() if v}
        if "decode" in tag:
            params, state, tokens = args
            k = torch.empty_like(state.caches.k[0])
            gen = torch.Generator(device=k.device).manual_seed(5)
            k.normal_(std=KEY_SCALE, generator=gen)
            v = torch.empty_like(k).normal_(generator=gen)
            H = got["group"] * k.shape[1]      # the rank's query heads
            full = torch.full((), k.shape[2], dtype=torch.int32,
                              device=k.device)
            got["fd"] = time_flash_decode(torch, ops, ref, H, k, v, full,
                                          gen)
            return

        def keep(name, a, kw, out, calls):
            if calls[name]:
                return None
            if name == "cd_solve":
                return _job_slice(torch, sp, a, kw, out, slice(0, 1))
            return _hinge_call(a, out)
        with recording(ops, ("cd_solve", "hinge_scores"), keep) as calls:
            fn(*args)
        if solve_check:
            _solve_vs_plain(torch, ref, sp, calls["cd_solve"][0],
                            f"dryrun {tag}")
        _hinge_vs_plain(torch, ref, calls["hinge_scores"][0],
                        f"dryrun {tag}")
    return inspect


def phase_dryrun(torch, ops, ref):
    """``[dryrun]`` (the module's docstring, phase 19). → (the
    flash_decode entry of llama3-8b's rank for the row's ``configs``,
    the launches by kernel row of the five steps run on the card)."""
    import shutil
    import tempfile
    from repro_torch import sparse as sp
    from repro_torch.analysis import lint
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.sharding import kv_repeat_for
    t_phase = time.perf_counter()
    out = tempfile.mkdtemp(prefix="dryrun_")
    for arch, shape, kw in DRYRUN_SHAPE_ONLY:
        t0 = time.perf_counter()
        kw = dict(kw)
        rec = dryrun.run_one(arch, shape, kw.pop("multi_pod", False),
                             out_dir=out, verbose=False, device="cpu", **kw)
        tag = _dryrun_tag(arch, shape, kw)
        check(rec["status"] == "ok", f"[dryrun] {tag}: {rec.get('error')}")
        chips = 512 if rec["mesh"] == "2x16x16" else 256
        check(rec["chips"] == chips and rec["roofline"]["memory_s"] > 0
              and rec["dominant"] in rec["roofline"],
              f"[dryrun] {tag}: record {rec}")
        say(f"[dryrun] {tag} on {rec['chips']} ranks ({rec['mesh']}), "
            f"shape-only: {rec['collective_count']} collectives "
            f"{ {k: v['count'] for k, v in rec['collectives'].items()} }, "
            f"rank 0 {rec['per_rank_flops'] / 1e9:.1f} GFLOP, reckoned peak "
            f"{rec['peak_bytes'] / 1e9:.3f} GB ({rec['argument_size_in_bytes'] / 1e9:.3f} "
            f"of shards), dominant {rec['dominant']}; traced in "
            f"{rec['trace_s']} s, {time.perf_counter() - t0:.1f} s in all")
    launches, fd_entry = {}, None
    for arch, shape, kw in DRYRUN_ON_CARD:
        t0 = time.perf_counter()
        tag = _dryrun_tag(arch, shape, kw)
        got = {}
        if shape == "decode_32k":
            cfg = get_config(arch)
            got["group"] = cfg.num_heads // (cfg.num_kv_heads * kv_repeat_for(
                cfg, make_production_mesh()))
        ops.reset_launches()
        rec = dryrun.run_one(arch, shape, False, out_dir=out, verbose=False,
                             device=DEV, inspect=_dryrun_inspect(
                                 torch, ops, ref, sp, tag, got,
                                 shape in DRYRUN_SOLVE_CHECKED), **kw)
        check(rec["status"] == "ok", f"[dryrun] {tag}: {rec.get('error')}"
              f"\n{rec.get('traceback')}")
        card, peak = rec["card"], rec["peak_bytes"]
        want = {r: 2 * k["launches"] for r, k in rec["kernels"].items()}
        check(got["routes"] == want, f"[dryrun] {tag}: the two runs "
              f"launched {got['routes']}, the shape rules reckon {want}")
        for r, n in got["routes"].items():
            launches[r] = launches.get(r, 0) + n
        lo, hi = DRYRUN_PEAK_LIMITS
        ratio = card["peak_ratio"]
        controls = {"the arguments alone": card["peak_bytes"]
                    / rec["argument_size_in_bytes"]}
        if shape == "decode_32k":
            # an svm rank's rows are fixed by rows_per_device: only the
            # decode step's reckoning moves with the data ranks
            half = dryrun.reckon(arch, shape, (8, 16), **kw)["peak_bytes"]
            controls["8 × 16 ranks' reckoning"] = card["peak_bytes"] / half
        say(f"[dryrun] {tag}: rank 0 on the card {card['step_ms']:.1f} ms a "
            f"step (first {card['first_ms']:.1f}); peak "
            f"{card['peak_bytes'] / 1e9:.3f} GB against {peak / 1e9:.3f} "
            f"reckoned: {ratio:.3f} (limits {lo}–{hi}); controls "
            + ", ".join(f"{k} {v:.3f}" for k, v in controls.items())
            + f"; launches {got['routes']} (2 runs, as the rules reckon); "
            f"{rec['collective_count']} collectives, reckoned "
            f"{rec['per_rank_flops'] / 1e9:.1f} GFLOP, "
            f"{rec['per_rank_bytes'] / 1e9:.2f} GB a step; "
            f"{time.perf_counter() - t0:.1f} s")
        check(lo <= ratio <= hi, f"[dryrun] {tag}: measured peak over "
              f"reckoned {ratio:.3f} outside {lo}–{hi}")
        check(any(not lo <= c <= hi for c in controls.values()),
              f"[dryrun] {tag}: no control falls outside {lo}–{hi}: "
              f"{controls}")
        if shape == "decode_32k":
            half_ratio = controls["8 × 16 ranks' reckoning"]
            check(not lo <= half_ratio <= hi, f"[dryrun] {tag}: the "
                  f"half-data-ranks control {half_ratio:.3f} is inside")
            fd = got["fd"]
            fd_entry = {key: fd[key] for key in (
                "ms", "plain_ms", "bound_ms", "library_ms", "simt_ms",
                "shape")}
            fd_entry["launches"] = got["routes"].get(
                "flash_decode/tensor_core", 0)
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    check(lint.run_artifacts(out) == 0, "[dryrun] lint --artifacts failed")
    say(f"[dryrun] lint --artifacts over the phase's svm records: current "
        f"({time.perf_counter() - t0:.1f} s)")
    shutil.rmtree(out, ignore_errors=True)
    say(f"[dryrun] done in {time.perf_counter() - t_phase:.1f} s; launches "
        f"{launches}")
    return fd_entry, _row_launches(launches)


# --- slice 17: LM training on one process at full width --------------------

# [train-full]: full width and depth, bf16, one config at a time (an untied
# and a tied head with QKV bias). Batch 3 × 4096 is a stated cut of the
# reference's train_4k (global batch 256): one card holds no such batch,
# and the reference has no gradient accumulation. 12288 tokens take the
# chunked loss's padded second chunk.
TRAIN_CELLS = ("tinyllama-1.1b", "qwen2-1.5b")
TRAIN_BATCH, TRAIN_SEQ = 3, 4096
TRAIN_STEPS = 3
# the reference's OptConfig defaults (lr 3e-4 after 100 warmup steps): with
# a warmup of 1 step the full-width loss jumped on a repeated batch
# (tinyllama-1.1b on an NVIDIA H100 80GB HBM3 at 700 W: 10.80 → 8.05 →
# 15.30 → 7.27 → 15.65 → 12.23)
TRAIN_OPT = dict()
# bf16 gradients against the same batch's on f32 copies of the weights:
# the cosine of every leaf and of the whole flattened gradient. A CPU
# probe at full depth and d 256 (seq 512 and 1024) read ≥ 0.99928 (qwen2's
# tied embedding), its control (another batch's bf16 gradient against
# this one's f32) ≤ 0.69 for every leaf and the whole. The whole control
# must fall below the limit; a leaf's is printed (at 3 layers a norm
# scale's read 0.993: those gradients share a part from batch to batch).
GRAD_COS_TOL = 0.99
# [train-backbone]: examples/torch_train_backbone.py --preset 100m for 20
# steps, then --resume for 80. The example checks that its last logged
# loss is below its first; 150 then 150 more failed that check on an
# NVIDIA H100 80GB HBM3 at 700 W (the resumed run, at the schedule's floor
# of 3e-5 on the loss's plateau, logged 4.027 at step 160 and 4.113 at
# 299), so the
# resumed run starts before the plateau; 80, not 150, to keep the whole
# run within 1000 s.
BACKBONE_STEPS = (20, 80)


def _leaf_index(tree, leaf) -> int:
    from repro_torch.models.layers import tree_leaves
    return next(i for i, t in enumerate(tree_leaves(tree)) if t is leaf)


def _train_batch(torch, cfg, step, dev):
    from repro_torch.data import DataConfig, lm_batch_at
    b = lm_batch_at(DataConfig(TRAIN_BATCH, TRAIN_SEQ, seed=0), cfg, step)
    return {k: torch.from_numpy(v).to(dev) for k, v in b.items()}


def _loss_grads(torch, model, params, batch):
    """(loss, gradients in tree_leaves order) by autograd, as
    build_train_step takes them."""
    from repro_torch.models.layers import tree_leaves, tree_map
    with torch.enable_grad():
        wrt = tree_map(lambda p: p.detach().requires_grad_(), params)
        loss, _ = model.loss(wrt, batch)
        return loss.detach(), list(torch.autograd.grad(loss,
                                                       tree_leaves(wrt)))


def _cosines(torch, got, want):
    """Cosine of each leaf pair and of the whole flattened gradients (f64
    sums on the card)."""
    dots, na, nb = [], [], []
    for a, b in zip(got, want):
        a, b = a.double().flatten(), b.double().flatten()
        dots.append(a @ b)
        na.append(a @ a)
        nb.append(b @ b)
    each = [float(d / (x * y).sqrt()) for d, x, y in zip(dots, na, nb)]
    whole = float(sum(dots) / (sum(na) * sum(nb)).sqrt())
    return each, whole


def _bf16_ulp(torch, x):
    """The bf16 ulp at each |x| (f64)."""
    return torch.exp2(torch.floor(torch.log2(x.abs().clamp(min=1e-30))) - 7)


def _opt_vs_float64(torch, optim, ocfg, params, grads, state, leaves):
    """One optim.apply_updates on the card (timed by CUDA events) against
    the update recomputed in float64 on the host for ``leaves``, (name
    path, rows) pairs: the clip scale from the card's f32 norm, cast to
    bf16 as the reference casts it. → (params, state, (ms, worst param
    error over its tolerance, worst moment error over its largest entry,
    f32 vs f64 norm, what was read))."""
    from repro_torch.models.layers import tree_unflatten
    f64 = lambda t: t.detach().double().cpu()
    picks = []
    for name, rows in leaves:
        leaf = _leaf_at(params, name)
        g = grads[_leaf_index(params, leaf)]
        m, v = (_leaf_at(state.mu, name), _leaf_at(state.nu, name))
        picks.append((name, leaf, rows, m, v, f64(leaf[rows]), f64(g[rows]),
                      f64(m[rows]), f64(v[rows])))
    norm64 = math.sqrt(sum(float(g.double().square().sum()) for g in grads))
    step = int(state.step) + 1
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    params, state, om = optim.apply_updates(
        params, tree_unflatten(params, grads), state, ocfg)
    ev[1].record()
    ev[1].synchronize()
    ms = ev[0].elapsed_time(ev[1])
    gnorm = float(om["grad_norm"])
    b1, b2 = ocfg.betas
    s = float(step)
    frac = min(max((s - ocfg.warmup_steps) / max(
        ocfg.total_steps - ocfg.warmup_steps, 1), 0.0), 1.0)
    lr = ocfg.lr * (s / max(ocfg.warmup_steps, 1) if s < ocfg.warmup_steps
                    else ocfg.min_lr_ratio + (1 - ocfg.min_lr_ratio) * 0.5
                    * (1 + math.cos(math.pi * frac)))
    scale = min(1.0, ocfg.clip_norm / max(gnorm, 1e-9))
    scale = float(torch.tensor(scale).to(torch.bfloat16))
    worst_ulp, worst_mom, rows_read = 0.0, 0.0, []
    for name, leaf, rows, m_t, v_t, p, g, m, v in picks:
        g = (g * scale).to(torch.bfloat16).double()
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        delta = (m / (1 - b1 ** step)) / ((v / (1 - b2 ** step)).sqrt()
                                          + ocfg.eps) + ocfg.weight_decay * p
        want = p - lr * delta
        # one bf16 ulp of the result, plus f32's rounding of the operands
        # where p − lr·delta cancels (the reference computes it in f32)
        tol = _bf16_ulp(torch, want) + 2.0 ** -21 * (p.abs()
                                                      + lr * delta.abs())
        got = f64(leaf[rows])
        worst_ulp = max(worst_ulp, float(((got - want).abs() / tol).max()))
        for got, w in ((f64(m_t[rows]), m), (f64(v_t[rows]), v)):
            worst_mom = max(worst_mom, float((got - w).abs().max())
                            / max(float(w.abs().max()), 1e-30))
        rows_read.append(f"{'.'.join(name)}{'' if rows.stop is None else f'[:{rows.stop}]'} "
                         f"{tuple(leaf[rows].shape)}")
    return params, state, (ms, worst_ulp, worst_mom,
                           abs(gnorm - norm64) / norm64, rows_read)


def _leaf_at(tree, name):
    for k in name:
        tree = tree[k]
    return tree


def phase_train_full(torch, ops, arch) -> dict:
    """LM training at full width and depth on the card (bf16, seeded
    random weights, remat): the bf16 gradients against f32 copies of the
    weights with a control, one AdamW step against float64 on three
    leaves, then a warm step and TRAIN_STEPS steps of build_train_step on
    one batch under no_implicit_host_sync, launching no kernel. → numbers
    for the summary line."""
    import dataclasses
    from repro_torch import optim
    from repro_torch.analysis import no_implicit_host_sync
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import InputShape, build_train_step
    from repro_torch.models import build_model
    from repro_torch.models.layers import tree_leaves, tree_map
    cfg = get_config(arch)
    ocfg = optim.OptConfig(**TRAIN_OPT)
    bundle = build_train_step(cfg, None, InputShape(
        "train-full", "train", TRAIN_SEQ, TRAIN_BATCH), opt_cfg=ocfg)
    model = bundle.model
    dev = torch.device(DEV)
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    state = optim.init(params)
    torch.cuda.synchronize()
    n = sum(p.numel() for p in tree_leaves(params))
    w_bytes = _nbytes(params)
    m_bytes = _nbytes(state.mu) + _nbytes(state.nu)
    T = TRAIN_BATCH * TRAIN_SEQ
    say(f"[train-full] {arch}: {cfg.num_layers} layers, d {cfg.d_model}, "
        f"{n / 1e9:.3f} G params, {cfg.dtype}; weights {w_bytes / 1e9:.3f} "
        f"GB, f32 moments {m_bytes / 1e9:.3f} GB (with bf16 grads 12 B a "
        f"param: {12 * n / 1e9:.3f} GB); batch {TRAIN_BATCH} × {TRAIN_SEQ} "
        f"(a stated cut of train_4k's 256), remat, {ocfg}")
    batch = _train_batch(torch, cfg, 0, dev)
    other = _train_batch(torch, cfg, 1, dev)

    # bf16 gradients against the same batch's on f32 copies of the weights
    laps = [time.perf_counter()]

    def lap():
        torch.cuda.synchronize()
        laps.append(time.perf_counter())
        return laps[-1] - laps[-2]
    loss16, g16 = _loss_grads(torch, model, params, batch)
    t16 = lap()
    model32 = build_model(dataclasses.replace(model.cfg, dtype="float32"))
    p32 = tree_map(lambda w: w.float(), params)
    loss32, g32 = _loss_grads(torch, model32, p32, batch)
    del p32
    t32 = lap()
    each, whole = _cosines(torch, g16, g32)
    _, gctl = _loss_grads(torch, model, params, other)
    ctl_each, ctl_whole = _cosines(torch, gctl, g32)
    del g32, gctl
    torch.cuda.empty_cache()
    tctl = lap()
    names = []

    def walk(t, pre=()):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], pre + (k,))
        else:
            names.append(pre)
    walk(params)
    worst = min(range(len(each)), key=lambda i: each[i])
    say(f"[train-full] {arch} bf16 gradients vs the f32 weights' (same "
        f"batch, loss {float(loss16):.4f} vs {float(loss32):.4f}): cosine "
        f"whole {whole:.6f}, least leaf {min(each):.6f} "
        f"({'.'.join(names[worst])}) (tol {GRAD_COS_TOL}); control (another "
        f"batch's bf16 gradient): whole {ctl_whole:.4f}, most leaf "
        f"{max(ctl_each):.4f}, {sum(c < GRAD_COS_TOL for c in ctl_each)} of "
        f"{len(ctl_each)} leaves below the limit; bf16 gradients {t16:.1f} "
        f"s, f32 {t32:.1f} s, the control and cosines {tctl:.1f} s")
    check(min(each) >= GRAD_COS_TOL and whole >= GRAD_COS_TOL,
          f"{arch} bf16 gradients differ from f32: cosines {each}, {whole}")
    check(ctl_whole < GRAD_COS_TOL, f"{arch}: the gradient check cannot "
          f"see its control ({ctl_whole})")

    # one AdamW step against float64 on three leaves (step 1)
    picks = [(("final_norm", "scale"), slice(None)),
             (("layers", "attn", "wk"), slice(None)),
             (("embed", "embedding"), slice(0, 4096))]
    params, state, (opt_first_ms, ulps, mom, norm_rel, read) = \
        _opt_vs_float64(torch, optim, ocfg, params, g16, state, picks)
    del g16
    say(f"[train-full] {arch} AdamW step 1 vs float64 on the host ({read}): "
        f"params within {ulps:.3f} of one bf16 ulp (+ f32's rounding of "
        f"p and lr·delta where they cancel), moments within "
        f"{mom:.2e} of their largest entry, grad norm f32 vs f64 "
        f"{norm_rel:.2e}; the step's first call {opt_first_ms:.1f} ms")
    check(ulps <= 1.0 and mom <= 1e-5 and norm_rel <= 1e-4,
          f"{arch} AdamW differs from float64: {ulps} ulp, {mom}, {norm_rel}")

    # the main path: a warm step, then TRAIN_STEPS steps on the same batch
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    params, state, m = bundle.fn(params, state, batch)
    losses = [m["loss"]]
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True)
          for _ in range(TRAIN_STEPS + 1)]
    t0 = time.perf_counter()
    with no_implicit_host_sync():
        ev[0].record()
        for i in range(TRAIN_STEPS):
            params, state, m = bundle.fn(params, state, batch)
            losses.append(m["loss"])
            ev[i + 1].record()
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0) / TRAIN_STEPS
    step_ms = [ev[i].elapsed_time(ev[i + 1]) for i in range(TRAIN_STEPS)]
    peak = torch.cuda.max_memory_allocated() - base
    launches = {k: v for k, v in ops.LAUNCHES.items() if v}
    losses = [float(x) for x in losses]
    zeros = tree_map(torch.zeros_like, params)
    opt_ms = cuda_ms(torch, lambda: optim.apply_updates(params, zeros, state,
                                                        ocfg), 2)
    del zeros
    # bound: 8·N·T matmul operations with remat (forward, recompute,
    # backward) plus the plain attention's full S² (scores and PV, in the
    # forward, the recompute and twice in the backward); bytes: the
    # weights, grads and moments each read and written once
    n_mm = cfg.param_count() - (0 if cfg.tie_embeddings else
                                cfg.vocab_size * cfg.d_model)
    flops = 8.0 * n_mm * T + 16.0 * cfg.num_layers * TRAIN_BATCH \
        * TRAIN_SEQ ** 2 * cfg.num_heads * cfg.hd
    bms, by = bound_ms(2 * (w_bytes + m_bytes + w_bytes), flops,
                       BF16_FLOP_PER_S)
    ms = sorted(step_ms)[len(step_ms) // 2]
    say(f"[train-full] {arch} build_train_step: losses {[round(x, 4) for x in losses]} "
        f"(warm step, then {TRAIN_STEPS} under no_implicit_host_sync); "
        f"step {', '.join(f'{x:.1f}' for x in step_ms)} ms (CUDA events; "
        f"host {wall_ms:.1f} ms a step), {T / ms * 1e3:,.0f} tokens/s at "
        f"the median; bound {bms:.1f} ms ({by}: {flops:.3e} bf16 "
        f"operations at 989 TFLOP/s); the optimizer {opt_ms:.1f} ms a step "
        f"({opt_first_ms:.1f} its first call); peak {peak / 1e9:.2f} GB "
        f"(state with grads {12 * n / 1e9:.2f} GB); launches {launches}; "
        f"{nvidia_smi()}")
    check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
          f"{arch} train losses {losses}")
    check(not launches, f"{arch} train step launched kernels {launches}")
    del params, state, batch, other, bundle, model, model32
    torch.cuda.empty_cache()
    secs = time.perf_counter() - t_phase
    say(f"[train-full] {arch} done in {secs:.1f} s")
    return {"arch": arch, "step_ms": ms, "tok_s": T / ms * 1e3,
            "bound_ms": bms, "opt_ms": opt_ms, "peak_gb": peak / 1e9,
            "seconds": secs}


def phase_train_backbone(torch) -> dict:
    """examples/torch_train_backbone.py --preset 100m on the card for
    BACKBONE_STEPS[0] steps, then --resume for BACKBONE_STEPS[1], in a
    temporary directory: the example's own check holds in both runs, and
    the resumed run restores the saved state bit for bit."""
    import tempfile
    from repro_torch.ckpt import restore
    from repro_torch.models.layers import tree_leaves
    mod = _example("torch_train_backbone")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        argv = ["--preset", "100m", "--ckpt-dir", d, "--ckpt-every", "0",
                "--device", DEV]
        try:
            first = mod.main(argv + ["--steps", str(BACKBONE_STEPS[0])])
            saved = restore(first["ckpt"], {"params": first["params"],
                                            "opt": first["opt"]},
                            device=DEV)
            same = all(torch.equal(a, b) for a, b in zip(
                tree_leaves(saved["params"]) + tree_leaves(saved["opt"].mu)
                + tree_leaves(saved["opt"].nu) + [saved["opt"].step],
                tree_leaves(first["params"]) + tree_leaves(first["opt"].mu)
                + tree_leaves(first["opt"].nu) + [first["opt"].step]))
            del saved, first["params"], first["opt"]
            second = mod.main(argv + ["--steps", str(BACKBONE_STEPS[1]),
                                      "--resume"])
        except AssertionError as e:
            check(False, f"[train-backbone] {e}")
    secs = time.perf_counter() - t0
    say(f"[train-backbone] demo-100m (f32, 512 tokens a step): steps "
        f"0–{BACKBONE_STEPS[0] - 1} loss "
        f"{first['first_loss']:.4f} → {first['final_loss']:.4f}, "
        f"{first['tok_s']:,.0f} tok/s; resumed from step {second['start']} "
        f"(state restored bit for bit: {same}): loss "
        f"{second['first_loss']:.4f} → {second['final_loss']:.4f}, "
        f"{second['tok_s']:,.0f} tok/s; {secs:.1f} s; {nvidia_smi()}")
    check(same and second["start"] == BACKBONE_STEPS[0],
          "[train-backbone] the resumed run did not start from the saved "
          "state")
    return {"tok_s": (first["tok_s"], second["tok_s"]), "seconds": secs}


def phase_train(torch, ops):
    """[train-full] for each of TRAIN_CELLS, then [train-backbone]."""
    t0 = time.perf_counter()
    rows = [phase_train_full(torch, ops, arch) for arch in TRAIN_CELLS]
    bb = phase_train_backbone(torch)
    say(f"[train] done in {time.perf_counter() - t0:.1f} s: "
        + ", ".join(f"{r['arch']} {r['step_ms']:.1f} ms a step "
                    f"({r['seconds']:.1f} s)" for r in rows)
        + f", train-backbone {bb['seconds']:.1f} s")


# --- slice 10: the streaming service and the decode batch scheduler --------

# [stream-smoke]: the card's w and b against the CPU's, over max |w| of the
# CPU's final model: kernel and plain versions sum in other orders, as
# update_mapreduce's R_emp in [sparse-pipeline] (atol 1e-4)
STREAM_TOL = 1e-4
STREAMS = 4


def _route_delta(after: dict, before: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v - before.get(k, 0)}


def _row_launches(routes: dict) -> dict:
    """Launches by the kernel-table row a route belongs to."""
    rows = {"cd_solve/cluster": "cd_solve", "cd_solve/single": "cd_solve",
            "hinge_scores/tensor_core": "hinge_scores",
            "hinge_scores/simt": "hinge_scores",
            "cd_solve/sparse": "cd_solve/sparse",
            "hinge_scores/sparse": "hinge_scores/sparse",
            "flash_decode/tensor_core": "flash_decode",
            "flash_decode/simt": "flash_decode"}
    out = {}
    for route, n in routes.items():
        check(route in rows, f"a stream or scheduler run took route {route}")
        out[rows[route]] = out.get(rows[route], 0) + n
    return out


def _same_as_update(torch, T, got, base, X, y, L, cfg, tag):
    """A tenant's snapshot from a batched wave ≡ ``update_mapreduce`` of
    the model it folded from, on the same batch: rounds, R_emp and picks
    per round, SV ids, w, b and the final α, w and b, bit for bit."""
    ref = T.update_mapreduce(base, X, y, L, cfg)
    risks = ([h["risk"] for h in got.history],
             [h["risk"] for h in ref.history])
    same = (got.rounds == ref.rounds and risks[0] == risks[1]
            and [h["reducer"] for h in got.history]
            == [h["reducer"] for h in ref.history]
            and all(torch.equal(a, b) for a, b in (
                (got.w, ref.w), (got.b, ref.b), (got.sv.ids, ref.sv.ids),
                (got.final.alpha, ref.final.alpha),
                (got.final.w, ref.final.w), (got.final.b, ref.final.b))))
    check(same, f"{tag}: the wave's model differs from update_mapreduce "
          f"(rounds {got.rounds} vs {ref.rounds}, R_emp {risks[0]} vs "
          f"{risks[1]})")
    return got.rounds


def _stream_smoke_cpu(torch, T, cfg, streams, waves, rows, d):
    """The launcher's smoke run on the CPU (plain versions) from the same
    batches, made on the card: the service driven synchronously (each
    wave's submits, then ``drain``). → (service, stale, fresh)."""
    from repro_torch.launch import serve
    from repro_torch.serving import StreamingSVMService
    svc = StreamingSVMService(cfg, num_partitions=8,
                              max_batches_per_wave=streams, device="cpu")

    def batch(s, w):
        X, y = serve.stream_batch(s, w, rows, d, torch.float32, DEV)
        return X.cpu(), y.cpu()
    for s in range(streams):
        svc.register(f"stream{s}",
                     T.fit_mapreduce(*batch(s, 0), 8, cfg, device="cpu"))
    stale, fresh = [], []
    for w in range(1, waves + 1):
        bs = [batch(s, w) for s in range(streams)]

        def acc():
            return [float((svc.predict(f"stream{s}", X) == y).float().mean())
                    for s, (X, y) in enumerate(bs)]
        stale.append(acc())
        for s, (X, y) in enumerate(bs):
            svc.submit(f"stream{s}", X, y)
        svc.drain()
        fresh.append(acc())
    return svc, stale, fresh


def phase_stream_smoke(torch, T, ops):
    """The --smoke svm-tfidf serve (2 streams, 2 waves) through the
    port's CLI on the card, against the same waves on the CPU (plain
    versions) on the same batches, made on the card: the same stale and
    folded accuracies, w and b within STREAM_TOL of max |w|; folding
    beats the stale model in each wave."""
    from repro_torch.launch import serve
    ops.reset_launches()
    card = serve.main(["--arch", "svm-tfidf", "--smoke", "--streams", "2",
                       "--waves", "2", "--device", DEV])
    routes = _linear_route_counts(ops)
    # the launcher's --smoke cut: 256 rows of d 128 a stream a wave
    svc_cpu, stale_cpu, fresh_cpu = _stream_smoke_cpu(torch, T, card.cfg,
                                                      2, 2, 256, 128)
    worst, ids = 0.0, 0
    for s in range(2):
        a = card.service.snapshot(f"stream{s}").model
        b = svc_cpu.snapshot(f"stream{s}").model
        scale = float(b.final.w.abs().max())
        for x, z in ((a.w, b.w), (a.b, b.b), (a.final.w, b.final.w),
                     (a.final.b, b.final.b)):
            worst = max(worst, float((x.cpu() - z).abs().max()) / scale)
        ids += int((a.sv.ids.cpu() == b.sv.ids).sum())
    say(f"[stream-smoke] 2 streams × 2 waves on the card (folds of "
        f"{[st.streams for st in card.service.stats]} tenants): stale "
        f"{card.stale} → folded {card.fresh}; the CPU (plain versions, the "
        f"same batches): stale {stale_cpu} → folded {fresh_cpu}; w and b "
        f"max |Δ| {worst:.2e} of max |w| (tol {STREAM_TOL:g}), SV ids equal "
        f"{ids} of 128; routes {routes}; "
        f"{card.service.throughput_report()}")
    check(card.stale == stale_cpu and card.fresh == fresh_cpu,
          "stream smoke accuracies differ from the plain versions")
    check(worst <= STREAM_TOL, f"stream smoke w, b differ by {worst:.2e}")
    check(all(sum(f) > sum(s) for f, s in zip(card.fresh, card.stale)),
          "a folded wave did not beat the stale model")
    check(set(routes) == {"cd_solve/single", "hinge_scores/simt"},
          f"stream smoke routes {routes}")


@contextlib.contextmanager
def recording(ops, names, keep):
    """While the block runs, each ``ops.<name>`` of ``names`` runs as
    shipped (its launch count unchanged) and then appends
    ``keep(name, args, kwargs, out, calls)`` to ``calls[name]`` where
    that is not None; ``calls`` is what the block gets. The calls may
    come from another thread (the service's scheduler)."""
    shipped = {n: getattr(ops, n) for n in names}
    calls = {n: [] for n in names}

    def wrap(name):
        def record(*a, **kw):
            out = shipped[name](*a, **kw)
            kept = keep(name, a, kw, out, calls)
            if kept is not None:
                calls[name].append(kept)
            return out
        return record
    for n in names:
        setattr(ops, n, wrap(n))
    try:
        yield calls
    finally:
        for n, f in shipped.items():
            setattr(ops, n, f)


def _job_slice(torch, sp, a, kw, out, jobs):
    """Jobs ``jobs`` (a slice) of a ``cd_solve`` call (args ``a``,
    keywords ``kw``, outputs ``out``) as a call of their own: the home
    rows a view, the rest copied at once, on the caller's stream (a
    later round may reuse their buffers). → ((xh, xs, y, m), kw, out)."""
    xh, xs, y, m = a[:4]
    L = y.shape[0]

    def copy(x):
        return (sp.SparseRows(x.indices.clone(), x.values.clone(), x.d,
                              x.ids_in_range) if sp.is_sparse(x)
                else x.clone())
    if len(xs.shape) == 3:                   # block l // (L / B) of B
        jps = L // xs.shape[0]
        xs = xs[jobs.start // jps:(jobs.stop - 1) // jps + 1]
    if xh.shape[0] == L:
        xh = xh[jobs]
    else:                                    # home rows l % n_home
        check(jobs.start % xh.shape[0] == 0
              and jobs.stop - jobs.start == xh.shape[0],
              f"jobs {jobs} do not cover the {xh.shape[0]} home blocks")
    kw = {k: v[jobs].clone() if isinstance(v, torch.Tensor) and v.dim()
          else v for k, v in kw.items()}
    return ((xh, copy(xs), y[jobs].clone(), m[jobs].clone()), kw,
            tuple(o[jobs].clone() for o in out))


def _hinge_call(a, out):
    """A ``hinge_scores`` call as (rows (a view), W, b, y, m copied),
    (losses, count) copied."""
    return (a[0],) + tuple(t.clone() for t in a[1:5]), \
        tuple(t.clone() for t in out)


def _graphed_epochs(torch, epoch):
    """``epoch(α, w, b, y, m, active)`` of the plain solve's loop
    (``ref._solve``) captured in a CUDA graph on its first call and
    replayed on every call, its first included: the same kernels on the
    same tensors in the same order, without the host's dispatch of some
    25 small launches a row each epoch. The loop updates α, w and b in
    place, so each replay reads and writes the captured tensors; only
    ``active`` is new each epoch and is copied into the captured one."""
    g = {}

    def run(*args):
        *state, active = args
        if not g:
            g["state"], g["active"] = state, active.clone()
            g["graph"] = torch.cuda.CUDAGraph()
            torch.cuda.synchronize()
            # other threads (a service's scheduler) may use the card
            with torch.cuda.graph(g["graph"],
                                  capture_error_mode="thread_local"):
                g["viol"] = epoch(*state, g["active"])
        check(all(a is b for a, b in zip(state, g["state"])),
              "the plain solve's state moved between epochs")
        g["active"].copy_(active)
        g["graph"].replay()
        return g["viol"].clone()
    return run


def _plain_solve(torch, ref, xh, xs, y, m, kw, graphed=True):
    """The plain solve of a recorded call's inputs and keywords
    (``ref.cd_solve_ref`` or ``ref.cd_solve_sparse_ref``, every epoch
    and the stop rule as shipped), each epoch replayed from a CUDA graph
    (:func:`_graphed_epochs`) unless ``graphed`` is False. C goes in as
    a (jobs,) tensor on the card (a capture may not copy a number
    there), which the plain solve reads as it reads the number."""
    from repro_torch import sparse as sp
    from repro_torch.kernels import ops
    kw = dict(kw, C=ops.job_values(kw["C"], y.shape[0], y.device))
    solve = ref.cd_solve_sparse_ref if sp.is_sparse(xh) else ref.cd_solve_ref
    if not graphed:
        return solve(xh, xs, y, m, **kw)
    shipped = ref._solve
    ref._solve = lambda d, y, m, tol, max_epochs, epoch: shipped(
        d, y, m, tol, max_epochs, _graphed_epochs(torch, epoch))
    try:
        return solve(xh, xs, y, m, **kw)
    finally:
        ref._solve = shipped


_GRAPHED_PLAIN_CHECKED = []


def _check_graphed_plain(torch, ref, sp):
    """Once a process: :func:`_plain_solve` replayed from graphs against
    the plain solve as shipped, bit for bit, on small dense and
    blocked-CSR bf16 rows (2 home blocks, 3 jobs, 16 shared rows half
    masked; job 0 runs 4 epochs, job 1 is cut at 2, job 2 stops by its
    tol after 1)."""
    if _GRAPHED_PLAIN_CHECKED:
        return
    gen = torch.Generator(device=DEV).manual_seed(11)
    L, per, S, d, cap = 3, 48, 16, 4096, 32
    y = (torch.randint(0, 2, (L, per + S), generator=gen, device=DEV)
         * 2 - 1).float()
    m = torch.ones_like(y)
    m[:, per + S // 2:] = 0
    kw = dict(C=1.0, tol=torch.tensor([0.0, 0.0, 1e9], device=DEV),
              max_epochs=torch.tensor([4, 2, 4], dtype=torch.int32,
                                      device=DEV))
    dense = torch.randn((2, per + S, d), generator=gen, device=DEV) / 16
    ids = torch.stack([torch.randperm(d, generator=gen, device=DEV)[:cap]
                       for _ in range(2 * (per + S))]).reshape(2, per + S, cap)
    vals = torch.randn((2, per + S, cap), generator=gen, device=DEV)
    rows = sp.SparseRows(ids.int(), vals.to(torch.bfloat16), d, True)
    for name, xh, xs in (
            ("dense", dense[:, :per].to(torch.bfloat16),
             dense[0, per:].to(torch.bfloat16)),
            ("blocked-CSR", rows[:, :per], rows[0, per:])):
        got = _plain_solve(torch, ref, xh, xs, y, m, kw)
        want = _plain_solve(torch, ref, xh, xs, y, m, kw, graphed=False)
        check(all(torch.equal(a, b) for a, b in zip(got, want)),
              f"the graph-replayed plain solve ({name}) differs from the "
              f"plain solve")
    _GRAPHED_PLAIN_CHECKED.append(True)


def _solve_vs_plain(torch, ref, sp, call, tag):
    """A recorded solve of the path (:func:`_job_slice`: its inputs,
    keywords and outputs, as many epochs as the path ran) against the
    plain solve of the same inputs and keywords, each plain epoch
    replayed from a CUDA graph (:func:`_plain_solve`, checked bit for
    bit against the plain solve as shipped once a process): the hinge
    risk of each job's w, b over its home rows within 1e-4, as
    ``[kernels] cd_solve`` at full width holds one epoch (an update or
    mask gone wrong moves it by far more); max |Δα| and the epochs
    printed."""
    (xh, xs, y, m), kw, out = call
    L, per = y.shape[0], xh.shape[1]
    sparse = sp.is_sparse(xh)
    _check_graphed_plain(torch, ref, sp)
    t0 = time.perf_counter()
    plain = _plain_solve(torch, ref, xh, xs, y, m, kw)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    rerr = 0.0
    for j in range(L):
        X = xh[j % xh.shape[0]]
        yj, mj = y[j, :per], m[j, :per]
        r = [ref.hinge_scores_ref(X, o[1][j:j + 1], o[2][j:j + 1], yj,
                                  mj)[0] / mj.sum() for o in (out, plain)]
        rerr = max(rerr, float((r[0] - r[1]).abs().max()))
    same = all(torch.equal(k, p) for k, p in zip(out[:3], plain[:3]))
    say(f"[{tag}] {'cd_solve/sparse' if sparse else 'cd_solve/cluster'} "
        f"of the path ({L} jobs of {per} + {xs.shape[-2]} rows, mask "
        f"{float(m[:, :per].sum()):.0f} of {L * per} home rows) against "
        f"plain ({plain_s:.1f} s): hinge risk max|Δ| {rerr:.2e} (atol "
        f"1e-4), max|Δα| {float((out[0] - plain[0]).abs().max()):.2e}, "
        f"α, w, b bit for bit {same}; epochs {out[3].tolist()} vs "
        f"{plain[3].tolist()}")
    check(rerr <= 1e-4, f"{tag}: the solve's risk differs from plain by "
          f"{rerr:.2e}")
    check(torch.equal(out[3], plain[3]), f"{tag}: the solve ran epochs "
          f"{out[3].tolist()}, plain {plain[3].tolist()}")


def _hinge_vs_plain(torch, ref, call, tag):
    """A recorded ``hinge_scores`` call (:func:`_hinge_call`) against the
    plain version on its inputs: rtol 1e-4 and the same count, as
    ``[kernels] hinge_scores`` at full width."""
    (X, W, b, y, m), (loss_k, cnt_k) = call
    loss_p, cnt_p = ref.hinge_scores_ref(X, W, b, y, m)
    rel = float(((loss_k - loss_p).abs() / loss_p.abs().clamp(min=1e-30))
                .max())
    say(f"[{tag}] hinge_scores of the wave (n={X.shape[0]} d={X.shape[-1]} "
        f"L={W.shape[0]}) against plain: max rel Δ {rel:.2e} (rtol 1e-4), "
        f"count {float(cnt_k)} vs {float(cnt_p)}")
    check(rel <= 1e-4 and float(cnt_k) == float(cnt_p),
          f"{tag}: hinge_scores differs from plain")


def _bucket(k: int) -> int:
    """The job-axis width a fold of k tenants runs at."""
    return 1 if k <= 1 else 1 << (k - 1).bit_length()


def phase_stream_full(torch, T, ops, ref):
    """``serve_svm`` at configs/svm_tfidf.py's width (d 131072, sv_capacity
    2048, 8 partitions, 8192 bf16 rows a stream a wave; C 1, max_epochs
    10, γ 1e-4, max_rounds 3): 4 streams × 3 waves with the background
    scheduler. The streams submit one after another, as the reference's
    launcher does, and the scheduler folds what has queued when it
    wakes: a wave may fold as several sweeps (printed). Per wave its
    time, rows/s, latencies, its folds and launches by route (counted
    per fold). Wave 1: the first solve call of its widest fold (jobs
    0–7, a real tenant) and its first hinge_scores call against the
    plain versions, and each tenant ≡ its own update_mapreduce bit for
    bit; wave 2 profiled; at least 20 predicts with their versions
    while wave 3 folds, each ≡ the predict of that version. → (launches
    by kernel row, the result)."""
    import collections
    from repro_torch import sparse as sp
    from repro_torch.configs import SVM_TFIDF
    from repro_torch.launch import serve
    d, rows = SVM_TFIDF.num_features, SVM_TFIDF.stream_rows_per_wave
    dt = getattr(torch, SVM_TFIDF.dtype)
    Xq = [serve.stream_batch(s, 3, 1024, d, dt, DEV)[0]
          for s in range(STREAMS)]
    marks, snaps, reads, held = {}, {}, [], {}

    def read(svc, s):
        """One predict and its host time, to the result on the host."""
        t0 = time.perf_counter()
        pred, ver = svc.predict(f"stream{s}", Xq[s], with_version=True)
        pred = pred.cpu()
        reads.append((s, ver, pred, 1e3 * (time.perf_counter() - t0)))

    def keep(name, a, kw, out, calls):
        """The first solve call of each fold width (a round's, 8 jobs a
        tenant; the final retrains' fewer jobs are skipped), jobs 0–7;
        the first hinge_scores call."""
        if name == "hinge_scores":
            return None if calls[name] else _hinge_call(a, out)
        jobs = a[2].shape[0]
        if jobs < 8 or any(c[0] == jobs for c in calls[name]):
            return None
        return jobs, _job_slice(torch, sp, a, kw, out, slice(0, 8))

    def probe(wave, stage, svc):
        marks[wave, stage] = dict(ops.ROUTE_LAUNCHES)
        if stage == "submit":
            snaps[wave] = [svc.snapshot(f"stream{s}") for s in range(STREAMS)]
            if wave == 1:
                held["rec"] = recording(ops, ("cd_solve", "hinge_scores"),
                                        keep)
                held["calls"] = held["rec"].__enter__()
            elif wave == 2:
                held["prof"] = profiling(torch, "one full-width wave, "
                                         "submit → every stream folded "
                                         "(4 tenants, 8 jobs each)")
                held["prof"].__enter__()
        elif stage == "folded" and wave == 1:
            held.pop("rec").__exit__(None, None, None)
            calls = held.pop("calls")
            jobs, solve = max(calls["cd_solve"], key=lambda c: c[0])
            widths = [c[0] for c in calls["cd_solve"]]
            say(f"[stream-full] wave 1: solve calls of {widths} jobs; "
                f"held to plain: the {jobs}-job call's jobs 0–7")
            _solve_vs_plain(torch, ref, sp, solve, "stream-full")
            _hinge_vs_plain(torch, ref, calls["hinge_scores"][0],
                            "stream-full")
            del calls, solve
        elif stage == "folded" and wave == 2:
            held.pop("prof").__exit__(None, None, None)
        elif stage == "submitted" and wave == 3:
            # readers on the caller's stream while the fold runs on the
            # service's: each read tagged with the version it served
            while svc.scheduler_error is None and (len(reads) < 20 or any(
                    svc.snapshot(f"stream{s}").version < 3
                    for s in range(STREAMS))):
                read(svc, len(reads) % STREAMS)
                time.sleep(0.002)
            for s in range(STREAMS):         # and once more after the swap
                read(svc, s)

    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    res = serve.serve_svm(SVM_TFIDF, streams=STREAMS, waves=3, device=DEV,
                          test_probe=probe, fail_on_retrace=True)
    total_s = time.perf_counter() - t0
    routes = _linear_route_counts(ops)
    svc, cfg = res.service, res.cfg
    after = {w: snaps[w + 1] for w in (1, 2)}
    after[3] = [svc.snapshot(f"stream{s}") for s in range(STREAMS)]
    from repro_torch.kernels import svm_step
    n_job = -(-(rows + cfg.sv_capacity) // 8) + cfg.sv_capacity
    resident = svm_step.max_active_clusters(dt, d, n_job, 8)
    say(f"[stream-full] {STREAMS} streams × 3 waves × {rows} rows of {d} "
        f"{SVM_TFIDF.dtype}, 8 partitions, sv_capacity {cfg.sv_capacity}: "
        f"{total_s:.1f} s with set-up (4 fit_mapreduce) and the wave-1 "
        f"checks; launches {routes}; a fold of k tenants solves "
        f"{_bucket(STREAMS)} × 8 jobs at most, of {n_job} rows on clusters "
        f"of 8 CTAs, {resident} resident")
    stats = {st.wave: st for st in svc.stats}
    for w in (1, 2, 3):
        # each wave submits one batch a stream, uids 4(w − 1) + 1 … 4w
        folds = collections.defaultdict(list)
        for mb in svc.done:
            if (mb.uid - 1) // STREAMS == w - 1:
                folds[mb.wave].append(int(mb.stream[len("stream"):]))
        lats = [1e3 * mb.latency_s for mb in svc.done
                if (mb.uid - 1) // STREAMS == w - 1]
        delta = _route_delta(marks[w, "folded"], marks[w, "submit"])
        delta = {k: v for k, v in delta.items()
                 if k.startswith(("cd_solve", "hinge_scores"))}
        want = collections.Counter()
        told = []
        for sw, tenants in sorted(folds.items()):
            r = max(after[w][s].model.rounds for s in tenants)
            want["cd_solve/cluster"] += r + 1
            want["hinge_scores/tensor_core"] += _bucket(len(tenants)) * r
            ms = [round(h["ms"], 1)
                  for h in after[w][tenants[0]].model.history]
            told.append(f"{sorted(tenants)} {1e3 * stats[sw].wall_s:.1f} ms "
                        f"{r} rounds (round ms {ms})")
        secs = res.seconds[w - 1]
        say(f"[stream-full] wave {w}: {1e3 * secs:.1f} ms submit → every "
            f"stream folded, {STREAMS * rows / secs:.0f} rows/s; folds "
            f"(tenants, wall, rounds): {'; '.join(told)}; batch latency "
            f"mean {sum(lats) / len(lats):.1f} ms p95 "
            f"{float(torch.tensor(lats).quantile(0.95)):.1f} ms; accuracy "
            f"stale {sum(res.stale[w - 1]) / STREAMS:.4f} → folded "
            f"{sum(res.fresh[w - 1]) / STREAMS:.4f}; launches {delta}")
        check(sorted(s for t in folds.values() for s in t)
              == list(range(STREAMS)), f"wave {w} folds {dict(folds)}")
        check(delta == dict(want), f"wave {w} launches {delta}, want "
              f"{dict(want)}")
    report = svc.throughput_report()
    say(f"[stream-full] {report}")
    say(f"[stream-full] under fail_on_retrace: fold_programs "
        f"{report['fold_programs']}, retraces {report['retraces']}")
    check(report["retraces"] == 0, f"[stream-full] retraces {report}")

    # wave 1 ≡ each tenant's own update_mapreduce
    for s in range(STREAMS):
        X1, y1 = serve.stream_batch(s, 1, rows, d, dt, DEV)
        _same_as_update(torch, T, after[1][s].model, snaps[1][s].model,
                        X1, y1, 8, cfg, f"stream-full wave 1 stream{s}")
    say(f"[stream-full] wave 1 ≡ update_mapreduce of each tenant bit for "
        f"bit (rounds {[a.model.rounds for a in after[1]]}, R_emp, picks, "
        "SV ids, w, b, final α, w, b)")

    # every interleaved read ≡ the predict of the version it reports
    expect = {(s, snap.version): T.predict(snap.model, Xq[s], cfg).cpu()
              for s in range(STREAMS) for snap in (snaps[3][s], after[3][s])}
    bad = [(s, v) for s, v, p, _ in reads
           if (s, v) not in expect or not torch.equal(p, expect[s, v])]
    during = [ms for _, v, _, ms in reads if v == 2]
    say(f"[stream-full] {len(reads)} predicts (1024 rows each) from the "
        f"main thread around wave 3's folds on the service's stream: "
        f"{len(during)} served by version 2 (while it folded; ms each, "
        f"to the result on the host: median "
        f"{sorted(during)[len(during) // 2] if during else 0:.2f}, max "
        f"{max(during, default=0):.2f}), {len(reads) - len(during)} by "
        f"version 3, each ≡ the predict of the version it reports: "
        f"{not bad}")
    check(len(reads) >= 20 and during and not bad,
          f"interleaved predicts: {len(reads)} reads, {len(during)} during "
          f"the fold, mismatches {bad[:4]}")
    return _row_launches(routes), res


def _padding_job_vs_plain(torch, ref, sp, call, tag):
    """The all-masked padding config of a bucket-padded fold (recorded
    as jobs 24–31 of its first solve launch by :func:`_job_slice`)
    against the plain solve of the same jobs: α, w and b bit for bit."""
    (xh, xs, y, m), kw, out = call
    plain = (ref.cd_solve_sparse_ref if sp.is_sparse(xh)
             else ref.cd_solve_ref)(xh, xs, y, m, **kw)
    same = all(torch.equal(o, p) for o, p in zip(out[:3], plain[:3]))
    say(f"[stream-full-mixed] {tag} padding job (mask all 0): α, w, b ≡ "
        f"plain {same}; max |α| {float(out[0].abs().max()):.1e}, "
        f"epochs {out[3].tolist()}")
    check(same, f"{tag}: the padding job's solve differs from plain")


def phase_stream_mixed(torch, T, ops, ref, dense_models, cfg):
    """2 dense and 2 blocked-CSR tenants (nnz_cap 256, bf16 values, the
    config's sparse_csr rows) at the same widths as one wave (two fold
    groups) under set_sync_debug_mode("warn") (its host syncs counted),
    then 3 + 3 tenants, each group bucket-padded to 4 jobs. Routes
    counted; each real tenant ≡ its update_mapreduce; each padding job's
    solve ≡ plain. → launches by kernel row."""
    import collections
    import warnings
    from repro_torch import sparse as sp
    from repro_torch.configs import SVM_TFIDF
    from repro_torch.data.pipeline import svm_rows_sparse_device
    from repro_torch.launch import serve
    from repro_torch.serving import StreamingSVMService
    d, rows = SVM_TFIDF.num_features, SVM_TFIDF.stream_rows_per_wave
    cap, dt, L = SVM_TFIDF.nnz_cap, getattr(torch, SVM_TFIDF.dtype), 8
    svc = StreamingSVMService(cfg, num_partitions=L, max_batches_per_wave=1,
                              device=DEV)
    for s, model in enumerate(dense_models):
        svc.register(f"d{s}", model)

    def sparse_batch(s, wave):
        X, y = svm_rows_sparse_device(rows, d, cap, seed=100 * wave + s,
                                      nnz=cap, dtype=dt, device=DEV)
        return X, y.to(dt)
    for s in range(3):
        svc.register(f"s{s}", T.fit_mapreduce(*sparse_batch(s, 0), L, cfg))
    counts = collections.Counter()

    def wave(names, w, capture=None):
        batches = {n: (serve.stream_batch(int(n[1]), 3 + w, rows, d, dt, DEV)
                       if n[0] == "d" else sparse_batch(int(n[1]), w))
                   for n in names}
        base = {n: svc.snapshot(n) for n in names}
        for n, (X, y) in batches.items():
            svc.submit(n, X, y)
        torch.cuda.synchronize()
        ops.reset_launches()
        st = svc.run_wave() if capture is None else capture()
        routes = _linear_route_counts(ops)
        counts.update(routes)
        got = {n: svc.snapshot(n) for n in names}
        rounds = {k: max(got[n].model.rounds for n in names if n[0] == k)
                  for k in "ds"}
        # a group of k tenants folds at the next power of two of k jobs
        width = {k: 1 << (sum(n[0] == k for n in names) - 1).bit_length()
                 for k in "ds"}
        want = {"cd_solve/cluster": rounds["d"] + 1,
                "hinge_scores/tensor_core": width["d"] * rounds["d"],
                "cd_solve/sparse": rounds["s"] + 1,
                "hinge_scores/sparse": width["s"] * rounds["s"]}
        check(routes == want and st.streams == len(names) and st.batched,
              f"mixed wave {w}: routes {routes}, want {want}")
        for n in names:
            _same_as_update(torch, T, got[n].model, base[n].model,
                            *batches[n], L, cfg, f"stream-full-mixed {n}")
        say(f"[stream-full-mixed] wave {w}: {len(names)} tenants "
            f"{sorted(names)}, {1e3 * st.wall_s:.1f} ms, "
            f"{st.rows / st.wall_s:.0f} rows/s, rounds {rounds}, launches "
            f"{routes}; every tenant ≡ its update_mapreduce bit for bit")

    def with_syncs():
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            prev = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("warn")   # counted, not refused
            try:
                st = svc.run_wave()
            finally:
                torch.cuda.set_sync_debug_mode(prev)
        syncs = [c for c in caught if "synchroniz" in str(c.message)]
        where = collections.Counter(
            f"{Path(c.filename).name}:{c.lineno}" for c in syncs)
        say(f"[stream-full-mixed] host syncs in one fold of 2 + 2 tenants "
            f"(set_sync_debug_mode('warn')): {len(syncs)}, by line "
            f"{dict(where.most_common())}")
        return st
    wave(["d0", "d1", "s0", "s1"], 1, with_syncs)

    def keep(name, a, kw, out, calls):
        """Per format, the fold's first solve call: its padding jobs
        24–31 and (blocked-CSR) a real tenant's jobs 0–7; the first
        blocked-CSR hinge_scores call."""
        kind = "sparse" if sp.is_sparse(a[0]) else "dense"
        if any(c[0] == kind for c in calls[name]):
            return None
        if name == "hinge_scores":
            return (kind, _hinge_call(a, out)) if kind == "sparse" else None
        real = (_job_slice(torch, sp, a, kw, out, slice(0, L))
                if kind == "sparse" else None)
        return (kind, a[2].shape[0],
                _job_slice(torch, sp, a, kw, out, slice(3 * L, 4 * L)), real)

    rec = {}

    def recorded():
        with recording(ops, ("cd_solve", "hinge_scores"),
                       keep) as rec["calls"]:
            return svc.run_wave()
    wave(["d0", "d1", "d2", "s0", "s1", "s2"], 2, recorded)
    calls = rec.pop("calls")
    for kind, jobs, padding, real in calls["cd_solve"]:
        check(jobs == 4 * L, f"{kind} fold jobs {jobs}")
        _padding_job_vs_plain(torch, ref, sp, padding, kind)
        if real is not None:
            _solve_vs_plain(torch, ref, sp, real, "stream-full-mixed")
    check({c[0] for c in calls["cd_solve"]} == {"dense", "sparse"}
          and len(calls["hinge_scores"]) == 1,
          f"recorded {[c[0] for c in calls['cd_solve']]}")
    _hinge_vs_plain(torch, ref, calls["hinge_scores"][0][1],
                    "stream-full-mixed")
    return _row_launches(dict(counts))


def _requests(Request, spec):
    return [Request(uid=u, prompt=p, max_new_tokens=m) for u, p, m in spec]


def _decode_calls(sched) -> int:
    """decode_step calls of a scheduler's waves: the prompt steps, then
    one a generated token but the last."""
    return sum(st.prompt_steps + st.decode_steps - 1 for st in sched.stats)


def phase_sched_smoke(torch, ops):
    """BatchScheduler at smoke_variant (f32: the SIMT flash_decode) on
    the card, the 10 requests of tests/test_serving.py in waves of 4,
    against the same weights on the CPU (plain versions): the same
    tokens, one flash_decode launch a layer a step."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model, smoke_variant
    from repro_torch.models.layers import tree_map
    from repro_torch.serving import BatchScheduler, Request
    cfg = smoke_variant(get_config("tinyllama-1.1b"))
    model = build_model(cfg)
    params = model.init(torch.Generator(device=DEV).manual_seed(0))
    spec = [(i, [1 + i, 2, 3], 5 + (i % 3)) for i in range(10)]
    out = {}
    for dev, p in ((DEV, params), ("cpu", tree_map(lambda w: w.cpu(),
                                                   params))):
        ops.reset_launches()
        sched = BatchScheduler(model, p, batch_size=4, cache_len=96,
                               device=dev)
        for r in _requests(Request, spec):
            sched.submit(r)
        out[dev] = {r.uid: r.output for r in sched.run()}
        if dev == DEV:
            launches, card = ops.LAUNCHES["flash_decode"], sched
            routes = _routes(ops, "flash_decode")
    say(f"[sched-smoke] {cfg.name}: 10 requests in {len(card.stats)} waves, "
        f"{card.throughput_report()}; flash_decode launches {launches} "
        f"(want {cfg.num_layers} × {_decode_calls(card)} steps), routes "
        f"{routes}; tokens ≡ the CPU's: {out[DEV] == out['cpu']}")
    check(out[DEV] == out["cpu"], "scheduler tokens differ from the CPU's")
    check(launches == cfg.num_layers * _decode_calls(card)
          and routes.get("simt") == launches,
          f"sched smoke flash_decode launches {launches}, routes {routes}")


def phase_sched_full(torch, ops, ref):
    """BatchScheduler at tinyllama-1.1b's full width (bf16, random weights
    from a seeded generator), batch 4, cache 512, 10 requests with
    prompts of 3–12 tokens and 4–16 new tokens (seeded): every
    flash_decode launch on the tensor-core route, one a layer a step;
    one step's calls against the plain version; each request's latency
    at most its wave's wall time, and the earliest done below it; tok/s.
    → launches by kernel row."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serving import BatchScheduler, Request
    cfg = get_config("tinyllama-1.1b")
    model = build_model(cfg)
    params = model.init(torch.Generator(device=DEV).manual_seed(0))
    rng = np.random.default_rng(0)
    spec = [(i, rng.integers(1, cfg.vocab_size,
                             int(rng.integers(3, 13))).tolist(),
             int(rng.integers(4, 17))) for i in range(10)]
    sched = BatchScheduler(model, params, batch_size=4, cache_len=512,
                           device=DEV)
    for r in _requests(Request, spec):
        sched.submit(r)
    # the ninth decode_step of the first wave (one call a layer), its
    # inputs and outputs copied as they were (the cache is written on)
    step = range(8 * cfg.num_layers, 9 * cfg.num_layers)
    seen = [0]

    def keep(name, a, kw, out, calls):
        seen[0] += 1
        if seen[0] - 1 not in step:
            return None
        return tuple(t.clone() for t in a), out.clone()
    torch.cuda.synchronize()
    ops.reset_launches()
    with recording(ops, ("decode_attention",), keep) as calls:
        done = sched.run()
    launches = ops.LAUNCHES["flash_decode"]
    routes = _routes(ops, "flash_decode")
    worst = max(_rel_max(out, ref.decode_attention_ref(*a))
                for a, out in calls["decode_attention"])
    valid = int(calls["decode_attention"][0][0][3])
    say(f"[sched-full] one decode_step of the run ({cfg.num_layers} "
        f"flash_decode calls, B 4, cache 512, valid {valid}) against the "
        f"plain decode_attention on the same inputs: max|Δ| {worst:.2e} of "
        f"max|plain| (tol {FD_TOL['bfloat16']:g})")
    check(len(calls["decode_attention"]) == cfg.num_layers
          and worst <= FD_TOL["bfloat16"],
          f"sched full flash_decode differs from plain by {worst:.2e}")
    rep = sched.throughput_report()
    for k, st in enumerate(sched.stats):
        lat = [1e3 * r.latency_s for r in done[4 * k:4 * k + 4]]
        say(f"[sched-full] wave {k}: {st.batch} requests, {st.prompt_steps} "
            f"prompt + {st.decode_steps} decode steps in "
            f"{1e3 * st.wall_s:.1f} ms ({st.tokens_per_s:.1f} tok/s by "
            f"WaveStats), per-slot latency ms {[round(x, 1) for x in lat]}")
        check(max(lat) <= 1e3 * st.wall_s + 1e-3 and min(lat)
              < 1e3 * st.wall_s, f"wave {k} latencies {lat} vs wall "
              f"{1e3 * st.wall_s:.1f} ms")
    say(f"[sched-full] {cfg.name} bf16, batch 4, cache 512: {rep}; "
        f"flash_decode launches {launches} (want {cfg.num_layers} × "
        f"{_decode_calls(sched)} steps), routes {routes}")
    check(all(0 <= t < cfg.vocab_size for r in done for t in r.output)
          and [len(r.output) for r in done] == [m for _, _, m in spec],
          "sched full tokens out of range or short")
    check(launches == cfg.num_layers * _decode_calls(sched)
          and routes.get("tensor_core") == launches,
          f"sched full flash_decode launches {launches}, routes {routes}")
    return {"flash_decode": launches}


# --- slice 11: NaN through the kernels, fault seams, checkpoints ------------

def _nan_pattern(torch, got, want, tol):
    """Whether two outputs are NaN, ±Inf and finite at the same places,
    and the largest |Δ| over the places where both are finite."""
    g, w = got.detach().float().cpu(), want.detach().float().cpu()
    same = (torch.equal(torch.isnan(g), torch.isnan(w))
            and torch.equal(torch.isinf(g), torch.isinf(w)))
    fin = torch.isfinite(g) & torch.isfinite(w)
    err = float((g[fin] - w[fin]).abs().max()) if fin.any() else 0.0
    return same and err <= tol, err, int(torch.isnan(w).sum()), w.numel()


def _nan_case(torch, route, tag, got, want, names, tol, bad):
    """One [nan-small] comparison: each named output's NaN/finite pattern
    and finite entries (within ``tol``) against the plain version's; an
    int32 output (the epochs) must be equal."""
    parts = []
    ok = True
    for name, g, w in zip(names, got, want):
        if not g.dtype.is_floating_point:
            same = torch.equal(g.cpu(), w.cpu())
            parts.append(f"{name} {g.tolist()} vs {w.tolist()}")
        else:
            same, err, nans, n = _nan_pattern(torch, g, w, tol)
            parts.append(f"{name} NaN {nans}/{n} pattern "
                         f"{'equal' if same else 'DIFFERS'} max|Δ| {err:.2e}")
        ok &= same
    say(f"[nan-small] {route} {tag}: {'; '.join(parts)} (tol {tol:g}) — "
        f"{'matches plain' if ok else 'DIFFERS from plain'}")
    if not ok:
        bad.append(f"{route} {tag}")


def phase_nan_small(torch, ops, ref, sp):
    """One row with a NaN (or an Inf) entry through each solve and scoring
    route at small shapes, against the plain versions, which let NaN
    through as the reference's ``jnp.clip`` / ``jnp.maximum`` do: the
    NaN/finite pattern of α, w, b, the violation and the losses, the
    epochs run, and the finite entries to the route's limit. A job that
    meets the NaN stops after its first epoch (its violation is NaN);
    the other jobs go on to their own stop. Routes: cd_solve single (f32,
    d 256) and cluster (bf16, d 131072), cd_solve/sparse (f32 and bf16),
    cd_solve_gram on the rule's cluster and on one CTA, hinge_scores
    SIMT, tensor cores and sparse (a NaN row of X; W of a NaN solve), and
    sparse_gram's rbf on both routes (the clamp of the squared distance).
    → the routes that differ (empty once every kernel lets NaN through)."""
    from repro_torch.kernels.gram_solve import launch_cd_solve_gram
    dev = torch.device(DEV)
    gen = torch.Generator(device=dev).manual_seed(21)
    bad = []
    kw = dict(C=1.0, tol=1e-6, max_epochs=20)
    names = ("α", "w", "b", "epochs", "viol")

    # dense cd_solve: a NaN in job 0's home rows, an Inf in job 1's, and
    # a NaN in the shared rows (every job); job 2 finite in the first two
    for route, L, per, S, d, dtype, tol in (
            ("cd_solve/single", 3, 12, 4, 256, torch.float32, 1e-5),
            ("cd_solve/cluster", 3, 12, 4, 131072, torch.bfloat16, 1e-3)):
        xh = _rows(torch, gen, L * per, d, torch.float32, dev, 0.5
                   ).reshape(L, per, d)
        xs = _rows(torch, gen, S, d, torch.float32, dev, 0.5)
        y = _labels(torch, gen, torch.cat([xh.reshape(-1, d), xs]))
        y_aug = torch.cat([y[:L * per].reshape(L, per),
                           y[L * per:].expand(L, S)], 1).contiguous()
        m_aug = torch.ones_like(y_aug)
        m_aug[0, 7] = 0.0
        for where, poison in (("NaN in job 0's row 5, Inf in job 1's row 3",
                               ((0, 5, 2, math.nan), (1, 3, 1, math.inf))),
                              ("NaN in shared row 2", None)):
            a, b = xh.clone(), xs.clone()
            if poison is None:
                b[2, 3] = math.nan
            else:
                for j, i, c, v in poison:
                    a[j, i, c] = v
            a, b = a.to(dtype), b.to(dtype)
            ops.reset_launches()
            k = ops.cd_solve(a, b, y_aug, m_aug, **kw)
            torch.cuda.synchronize()
            want = route.split("/")[1]
            check(_routes(ops, "cd_solve")[want] == 1,
                  f"[nan-small] {route}: took {_routes(ops, 'cd_solve')}")
            p = ref.cd_solve_ref(a, b, y_aug, m_aug, **kw)
            _nan_case(torch, route, f"{where}", k, p, names, tol, bad)

    # cd_solve/sparse: NaN in slot 0 of job 0's row 4 (the poison seam's
    # slot), padding slots and dead shared slots beside it
    for dtype in (torch.float32, torch.bfloat16):
        L, per, S, d, cap = 3, 12, 6, 64, 8
        rows = _sparse_rows(torch, sp, gen, L * per + S, d, cap, dtype)
        vals = rows.values.clone()
        vals[4, 0] = math.nan
        rows = sp.SparseRows(rows.indices, vals, d)
        xh = rows[:L * per].reshape(L, per, d)
        live = (torch.arange(S, device=dev) % 3 != 1).float()[:, None]
        xs = rows[L * per:] * live
        y = torch.where(torch.rand((L * per + S,), generator=gen,
                                   device=dev) > 0.5, 1.0, -1.0)
        y_aug = torch.cat([y[:L * per].reshape(L, per),
                           y[L * per:].expand(L, S)], 1).contiguous()
        m_aug = torch.ones_like(y_aug)
        ops.reset_launches()
        k = ops.cd_solve(xh, xs, y_aug, m_aug, **kw)
        torch.cuda.synchronize()
        check(_routes(ops, "cd_solve")["sparse"] == 1,
              f"[nan-small] cd_solve/sparse took {_routes(ops, 'cd_solve')}")
        p = ref.cd_solve_sparse_ref(xh, xs, y_aug, m_aug, **kw)
        tag = f"{'bf16' if dtype == torch.bfloat16 else 'f32'} NaN in slot 0"
        _nan_case(torch, "cd_solve/sparse", tag, k, p, names, 1e-5, bad)
        # eq. 7 on these rows with the NaN solve's W (its (d, 8) view),
        # and with finite W: every loss NaN (the NaN row is in X)
        Xall = rows
        yy = torch.where(torch.arange(Xall.shape[0], device=dev) % 2 == 0,
                         1.0, -1.0)
        mm = torch.ones_like(yy)
        mm[4] = 0.0                          # a masked NaN row still counts
        Wf = torch.randn((L, d), generator=gen, device=dev)
        bf = torch.randn((L,), generator=gen, device=dev)
        for wtag, W, bb in (("W of the NaN solve", k[1], k[2]),
                            ("finite W", Wf, bf)):
            ops.reset_launches()
            hk = ops.hinge_scores(Xall, W, bb, yy, mm)
            torch.cuda.synchronize()
            check(_routes(ops, "hinge_scores")["sparse"] == 1,
                  "[nan-small] hinge_scores/sparse took "
                  f"{_routes(ops, 'hinge_scores')}")
            hp = ref.hinge_scores_ref(Xall, W, bb, yy, mm)
            _nan_case(torch, "hinge_scores/sparse", f"{tag}, {wtag}", hk, hp,
                      ("losses", "count"), 1e-4 * float(hp[0].nan_to_num()
                                                        .abs().max() + 1),
                      bad)

    # dense hinge_scores: a NaN row of X (masked), then W with one NaN
    # hypothesis (a job that met a NaN) over finite X
    for route, dtype in (("hinge_scores/simt", torch.float32),
                         ("hinge_scores/tensor_core", torch.bfloat16)):
        n, d, L = 65, 1001, 8
        X = torch.randn((n, d), generator=gen, device=dev)
        y = torch.where(torch.rand((n,), generator=gen, device=dev) > 0.5,
                        1.0, -1.0)
        m = torch.ones_like(y)
        m[9] = 0.0
        W = torch.randn((L, d), generator=gen, device=dev) * 0.1
        b = torch.randn((L,), generator=gen, device=dev)
        Xn = X.clone()
        Xn[9, 17] = math.nan
        Wn = W.clone()
        Wn[3] = math.nan
        for tag, XX, WW in (("NaN in masked row 9 of X", Xn, W),
                            ("hypothesis 3 all NaN", X, Wn)):
            XX = XX.to(dtype)
            ops.reset_launches()
            hk = ops.hinge_scores(XX, WW, b, y, m)
            torch.cuda.synchronize()
            want = route.split("/")[1]
            check(_routes(ops, "hinge_scores")[want] == 1,
                  f"[nan-small] {route} took {_routes(ops, 'hinge_scores')}")
            hp = ref.hinge_scores_ref(XX, WW, b, y, m)
            _nan_case(torch, route, tag, hk, hp, ("losses", "count"),
                      1e-4 * float(hp[0].nan_to_num().abs().max() + 1), bad)

    # cd_solve_gram, bit-symmetric K: NaN in row and column 5 of job 0
    # and an Inf alone on job 1's diagonal (a Δ = 0 row's 0 · Inf must
    # reach g, as in the reference), job 2 finite; then the linear Gram
    # of rows with a NaN entry (job 0, row 5) and an Inf entry (job 1,
    # row 7)
    L, n = 3, 40
    Xg = torch.randn((L, n, 16), generator=gen, device=dev)
    K1 = _symmetric(Xg @ Xg.mT / 16)
    K1[0, 5, :] = math.nan
    K1[0, :, 5] = math.nan
    K1[1, 7, 7] = math.inf
    Xg[0, 5, 3] = math.nan
    Xg[1, 7, 2] = math.inf
    K2 = _symmetric(Xg @ Xg.mT / 16)
    y = torch.where(torch.rand((L, n), generator=gen, device=dev) > 0.5,
                    1.0, -1.0)
    m = torch.ones_like(y)
    m[2, 9] = 0.0
    rule = ops.cd_solve_gram_cluster_size(L, n)
    for ktag, K in (("K with NaN row/column, Inf on a diagonal", K1),
                    ("Gram of rows with NaN and Inf entries", K2)):
        p = ref.cd_solve_gram_ref(K, y, m, **kw)
        for c in (None, 2 if rule == 1 else 1):
            ops.reset_launches()
            got = ops.cd_solve_gram(K, y, m, **kw) if c is None else \
                launch_cd_solve_gram(K, y, m,
                                     *_launch_kw(torch, ops, kw, L, dev), c)
            torch.cuda.synchronize()
            _nan_case(torch, "cd_solve_gram",
                      f"{ktag}, c={c or f'{rule} (the rule)'}", got, p,
                      ("α", "epochs", "viol"), 0.0, bad)

    # sparse_gram rbf: a NaN value in query row 3 (its norm is NaN, so
    # every distance is); the reducer Gram and the fused scores route
    Q = _sparse_rows(torch, sp, gen, 24, 64, 8, torch.float32)
    Z = _sparse_rows(torch, sp, gen, 30, 64, 8, torch.float32)
    vals = Q.values.clone()
    vals[3, 1] = math.nan
    Qn = sp.SparseRows(Q.indices, vals, 64)
    Kk = ops.sparse_gram(Qn, Z, kind="rbf", gamma=0.5)
    torch.cuda.synchronize()
    _nan_case(torch, "sparse_gram/gram", "rbf, NaN in query row 3", (Kk,),
              (ref.sparse_gram_ref(Qn, Z, kind="rbf", gamma=0.5),), ("K",),
              1e-5, bad)
    coef = torch.randn((4, 30), generator=gen, device=dev)
    bb = torch.randn((4,), generator=gen, device=dev)
    Sk = ops.sparse_gram_scores(Qn, Z, coef, bb, kind="rbf", gamma=0.5)
    torch.cuda.synchronize()
    _nan_case(torch, "sparse_gram/scores", "rbf, NaN in query row 3", (Sk,),
              (ref.sparse_gram_scores_ref(Qn, Z, coef, bb, kind="rbf",
                                          gamma=0.5),), ("scores",), 1e-4,
              bad)
    say(f"[nan-small] routes that drop NaN where the plain versions keep "
        f"it: {bad or 'none'}")
    return bad


def phase_chaos(torch):
    """``repro_torch.faults.chaos`` on the card: twelve scenarios, seeds
    0, 1 and 2, each against the reference's outcome (survived bit for
    bit, or detected and named); a delayed or retried round launches
    what a clean one does (checked inside the scenarios from
    ``ops.ROUTE_LAUNCHES``). The four transport scenarios run the sharded
    round on 8 ranks sharing the card over gloo, every seed's in one
    spawn; ``handshake_flake`` the cluster's real handshake."""
    from repro_torch.faults import chaos
    t0 = time.perf_counter()
    rows = chaos.sweep([0, 1, 2], DEV)
    for seed, name, expect, outcome, ok, dt, detail in rows:
        say(f"[chaos] seed {seed} {name}: expected {expect}, got {outcome} "
            f"in {dt:.2f} s — {detail}")
    say(f"[chaos] {len(rows)} scenario runs in "
        f"{time.perf_counter() - t0:.1f} s")
    check(len(rows) == 36 and all(r[4] for r in rows),
          f"[chaos] violated: {[r[:4] for r in rows if not r[4]]}")


def phase_lint(torch):
    """``[lint]``: the invariant linter (``repro_torch.analysis``) on the
    card. Its self-test (every rule's seeded violation fires, naming op
    and program; the wire pack is allowed and recorded), with the
    runtime host-sync guard that only a card can fire: a seeded
    ``.item()`` inside ``no_implicit_host_sync`` must raise, one inside
    ``allowed_host_sync`` must not; then the dynamic rules at the lint
    shapes: ``fit_mapreduce_sweep`` under ``no_implicit_host_sync`` with
    ``fail_on_retrace=True``, and a ``StreamingSVMService(
    fail_on_retrace=True)`` folding two waves of one shape."""
    import contextlib
    import io
    from repro_torch.analysis import lint
    t0 = time.perf_counter()
    check(lint.runtime_guard_fires(DEV),
          "[lint] a seeded .item() did not raise inside "
          "no_implicit_host_sync")
    say("[lint] a seeded .item() raised inside no_implicit_host_sync on "
        "the card; one inside allowed_host_sync did not")
    for name, run in (("self-test", lint.run_self_test),
                      ("dynamic rules", lint.run_dynamic)):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            failures = run(DEV)
        for line in out.getvalue().splitlines():
            say(f"[lint] {name}: {line.strip()}")
        check(failures == 0, f"[lint] {name}: {failures} failure(s)")
    say(f"[lint] self-test and dynamic rules on the card in "
        f"{time.perf_counter() - t0:.1f} s")


def _nan_full(torch, ops, tag, run, solves=1):
    """``run()`` on full-width rows with one NaN entry raises
    ``FaultDetected("core")`` at round 0, after that round's launches
    (``solves`` solve launches, no final fit) and no more."""
    from repro_torch import faults
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    try:
        run()
    except faults.FaultDetected as e:
        ms = 1e3 * (time.perf_counter() - t0)
        routes = {k: v for k, v in ops.ROUTE_LAUNCHES.items() if v}
        say(f"[nan-full] {tag}: FaultDetected [{e.layer}] “{e.cause}” "
            f"after {ms:.1f} ms, launches {routes}")
        check(e.layer == "core" and "round 0" in e.cause,
              f"[nan-full] {tag}: raised [{e.layer}] {e.cause}")
        check(ops.LAUNCHES["cd_solve"] == solves,
              f"[nan-full] {tag}: {ops.LAUNCHES['cd_solve']} solve launches")
        return
    check(False, f"[nan-full] {tag}: a NaN row folded without a "
          "FaultDetected")


def phase_nan_stream(torch, T, ops, models, cfg):
    """``[nan-full]`` on the streaming service: the [stream-full] tenants
    in a service with ``quarantine=False``, one wave of 4 full-width
    batches, stream1's with a NaN entry: ``FaultDetected("core")`` at
    round 0 of the wave's sweep, every admitted batch requeued at the
    head (``pending()`` 4, as the reference gives), every snapshot still
    at its version."""
    from repro_torch import faults
    from repro_torch.configs import SVM_TFIDF
    from repro_torch.launch import serve
    from repro_torch.serving import StreamingSVMService
    d, rows = SVM_TFIDF.num_features, SVM_TFIDF.stream_rows_per_wave
    dt = getattr(torch, SVM_TFIDF.dtype)
    svc = StreamingSVMService(cfg, num_partitions=8,
                              max_batches_per_wave=STREAMS,
                              quarantine=False, device=DEV)
    for s, m in enumerate(models):
        svc.register(f"stream{s}", m)
    for s in range(STREAMS):
        X, y = serve.stream_batch(s, 4, rows, d, dt, DEV)
        if s == 1:
            X[100, 7] = math.nan
        svc.submit(f"stream{s}", X, y)
    _nan_full(torch, ops, f"quarantine=False service, {STREAMS} tenants, "
              "stream1's batch NaN", svc.run_wave)
    versions = [svc.snapshot(f"stream{s}").version for s in range(STREAMS)]
    rep = svc.throughput_report()
    say(f"[nan-full] service after the fault: pending {svc.pending()}, "
        f"requeued {rep['requeued']}, versions {versions}")
    check(svc.pending() == STREAMS == rep["requeued"]
          and versions == [0] * STREAMS,
          "[nan-full] the service did not requeue the wave intact")


def _same_snapshot(torch, a, b) -> bool:
    """Two snapshots bit for bit: version, rounds and every leaf of the
    checkpointed tree (w, b, risk, every sv and final leaf)."""
    from repro_torch.ckpt import checkpoint as ck
    from repro_torch.serving import svm_stream
    la = ck._leaves(svm_stream._snapshot_tree(a))
    lb = ck._leaves(svm_stream._snapshot_tree(b))
    return (a.version == b.version and a.model.rounds == b.model.rounds
            and la.keys() == lb.keys()
            and all(la[k].dtype == lb[k].dtype
                    and torch.equal(la[k].cpu(), lb[k].cpu()) for k in la))


def phase_stream_ckpt(torch, T, ops):
    """``[stream-full-ckpt]``: the [stream-full] configuration (4 streams
    × 8192 bf16 rows a wave, d 131072, 8 partitions, sv_capacity 2048,
    max_rounds 3, the streams submitting one after another to the
    background scheduler) with ``checkpoint_dir`` (a temporary directory,
    removed at the end), ``checkpoint_every_waves=1`` and
    ``checkpoint_keep=2``. Register (each register checkpoints), wave 1,
    checkpointed; restore on the card; wave 2 on the original service
    (checkpointing) and on the restored one (not checkpointing): every
    tenant bit for bit the same in both, versions and uids continuing
    from the manifest; then one more checkpoint, its medium corrupted,
    and a restore falls back past it to wave 2's generation, bit for
    bit. Each checkpoint's ms by part, restore ms, bytes on disk. A
    second checkpointed wave before the restore (~18 s on a fast host,
    22.4 s on a slow one) went with [tp-serve-full]'s coming, to keep the
    whole run within 1000 s: the run with it took 1204.7 s on an NVIDIA
    H100 80GB HBM3 at 700 W whose host built the kernels in 46.2 s."""
    import shutil
    import tempfile
    from repro_torch import faults
    from repro_torch.configs import SVM_TFIDF
    from repro_torch.launch import serve
    from repro_torch.serving import StreamingSVMService
    d, rows = SVM_TFIDF.num_features, SVM_TFIDF.stream_rows_per_wave
    dt = getattr(torch, SVM_TFIDF.dtype)
    cfg = T.MRSVMConfig(sv_capacity=SVM_TFIDF.sv_capacity, gamma=1e-4,
                        max_rounds=3,
                        svm=T.SVMConfig(C=SVM_TFIDF.C,
                                        max_epochs=SVM_TFIDF.max_epochs))
    ck_dir = tempfile.mkdtemp(prefix="stream_ckpt_")
    free = shutil.disk_usage(ck_dir).free
    say(f"[stream-full-ckpt] checkpoint_dir {ck_dir}: {free / 1e9:.1f} GB "
        "free (keep 2 generations of ~2.15 GB, a third while it is "
        "written)")
    names = [f"stream{s}" for s in range(STREAMS)]

    def split(ms):
        return ", ".join(f"{k} {v:.1f}" for k, v in ms.items())

    def wave(svc, w):
        """One wave, the reference's arrival; → (ms submit → folded,
        ms submit → folded and checkpointed, the folds' walls and the
        checkpoints taken: one a fold, ``run_wave``)."""
        base = [svc.snapshot(s).version for s in names]
        n_stats, gen = len(svc.stats), svc._generation
        t0 = time.perf_counter()
        for s in range(STREAMS):
            svc.submit(names[s], *serve.stream_batch(s, w, rows, d, dt, DEV))
        while any(svc.snapshot(s).version < v + 1
                  for s, v in zip(names, base)):
            check(svc.scheduler_error is None,
                  f"[stream-full-ckpt] wave {w}: {svc.scheduler_error!r}")
            time.sleep(0.001)
        folded = 1e3 * (time.perf_counter() - t0)
        check(svc.wait_idle(timeout_s=300), "[stream-full-ckpt] wave hung")
        done = 1e3 * (time.perf_counter() - t0)
        return folded, done, (f"{[round(1e3 * st.wall_s, 1) for st in svc.stats[n_stats:]]}"
                              f", {svc._generation - gen} checkpoints")

    try:
        svc = StreamingSVMService(cfg, num_partitions=8,
                                  max_batches_per_wave=STREAMS,
                                  checkpoint_dir=ck_dir,
                                  checkpoint_every_waves=1,
                                  checkpoint_keep=2, device=DEV)
        for s in range(STREAMS):
            X0, y0 = serve.stream_batch(s, 0, rows, d, dt, DEV)
            model = T.fit_mapreduce(X0, y0, 8, cfg)
            svc.register(names[s], model)
            say(f"[stream-full-ckpt] register {names[s]}: checkpoint of "
                f"{s + 1} stream(s) {split(svc.last_checkpoint_ms)} ms")
        del X0, y0, model
        svc.start()
        folded, done, walls = wave(svc, 1)
        say(f"[stream-full-ckpt] wave 1: folded {folded:.1f} ms (folds "
            f"{walls}), with its checkpoint {done:.1f} ms; checkpoint "
            f"{split(svc.last_checkpoint_ms)} ms")
        files = [os.path.join(ck_dir, f) for f in os.listdir(ck_dir)]
        on_disk = sum(os.path.getsize(f) for f in files)
        man = json.load(open(os.path.join(ck_dir, "service_manifest.json")))
        say(f"[stream-full-ckpt] on disk: {on_disk / 1e9:.3f} GB in "
            f"{len(files)} files, generations "
            f"{[g['generation'] for g in man['generations']]}, one "
            f"generation {sum(os.path.getsize(os.path.join(ck_dir, m['file'])) for m in man['generations'][-1]['streams'].values()) / 1e9:.3f} GB")
        after2 = {s: svc.snapshot(s) for s in names}

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r1 = StreamingSVMService.restore(cfg, ck_dir, device=DEV,
                                         checkpoint_every_waves=0)
        torch.cuda.synchronize()
        restore_ms = 1e3 * (time.perf_counter() - t0)
        same = all(_same_snapshot(torch, r1.snapshot(s), after2[s])
                   for s in names)
        say(f"[stream-full-ckpt] restore on the card: {restore_ms:.1f} ms, "
            f"{len(r1.streams())} streams at versions "
            f"{[r1.snapshot(s).version for s in names]}, every leaf bit for "
            f"bit the saved snapshot's {same}; wave/uid {r1._wave}/{r1._uid} "
            f"vs the service's {svc._wave}/{svc._uid}")
        check(same and r1._uid == svc._uid and r1._wave == svc._wave,
              "[stream-full-ckpt] restore is not the saved state")

        folded, done, walls = wave(svc, 2)
        say(f"[stream-full-ckpt] wave 2, original service: folded "
            f"{folded:.1f} ms (folds {walls}), with its checkpoints "
            f"{done:.1f} ms")
        svc.stop()
        r1.start()
        folded, done, walls = wave(r1, 2)
        r1.stop()
        same = all(_same_snapshot(torch, r1.snapshot(s), svc.snapshot(s))
                   for s in names)
        uids = sorted(mb.uid for mb in r1.done)
        say(f"[stream-full-ckpt] wave 2, restored service (no checkpoint): "
            f"folded {folded:.1f} ms (folds {walls}); every tenant bit for "
            f"bit the original's {same}, versions "
            f"{[r1.snapshot(s).version for s in names]}, uids {uids}")
        check(same and uids == sorted(mb.uid for mb in svc.done[-STREAMS:]),
              "[stream-full-ckpt] the restored service folds differently")
        del r1, after2

        # one more checkpoint, its medium corrupted: restore falls back to
        # the generation before it, wave 2's last, bit for bit
        plan = faults.FaultPlan.single("ckpt_corrupt", 0)
        with faults.inject(plan) as armed:
            svc.checkpoint()
        check(bool(armed.fired), "[stream-full-ckpt] corruption never fired")
        t0 = time.perf_counter()
        r2 = StreamingSVMService.restore(cfg, ck_dir, device=DEV,
                                         checkpoint_every_waves=0)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        same = all(_same_snapshot(torch, r2.snapshot(s), svc.snapshot(s))
                   for s in names)
        say(f"[stream-full-ckpt] a checkpoint corrupted on the medium "
            f"({split(svc.last_checkpoint_ms)} ms), then restore: {ms:.1f} "
            f"ms, restore_fallbacks {r2.restore_fallbacks}, versions "
            f"{[r2.snapshot(s).version for s in names]}, bit for bit the "
            f"generation before {same}")
        check(r2.restore_fallbacks >= 1 and same,
              "[stream-full-ckpt] no fallback to the intact generation")
    finally:
        shutil.rmtree(ck_dir, ignore_errors=True)


# --variants: build variants of flash_decode, cd_solve and cd_solve/sparse,
# each a copy of the shipped source with (old, new) text replacements,
# timed at the main path's shapes through the shipped launchers.
# ---------------------------------------------------------------------------
# slice 12: the sharded round on torch.distributed
# ---------------------------------------------------------------------------

SHARDED_TRANSPORTS = (("allgather", None), ("ring", None), ("hier", 2))
# the reference's own tolerances (tests/test_sharded_round.py)
SHARDED_RTOL, SHARDED_ATOL = 1e-4, 1e-5
SV_FIELDS = ("ids", "mask", "alpha", "y", "x", "w", "b")


def _leaves(v):
    return v if isinstance(v, tuple) else (v,)


def _same_np(a, b) -> bool:
    import numpy as np
    return all(np.array_equal(u, w, equal_nan=True)
               for u, w in zip(_leaves(a), _leaves(b)))


def _replicated(per_rank, i, tag):
    """Case ``i``'s outputs on every rank equal rank 0's bit for bit."""
    ref0 = per_rank[0]["cases"][i]
    for r, res in enumerate(per_rank[1:], 1):
        got = res["cases"][i]
        check(all(_same_np(a, b) for k in ref0 for a, b in zip(ref0[k],
                                                              got[k])),
              f"[{tag}] rank {r}'s outputs differ from rank 0's")


def _functional_rounds(torch, T, X, y, L, cfg, rounds):
    """The port's functional round on the card over ``rounds`` rounds:
    per round (risks, ids, mask, alpha) as numpy."""
    from repro_torch import sparse as sp
    n, d = X.shape
    per = n // L
    Xp = X.reshape(L, per, d)
    yp = y.to(X.dtype).reshape(L, per)
    mp = torch.ones_like(yp)
    sv = T.init_sv_buffer(cfg.sv_capacity, d, X.dtype, DEV,
                          nnz_cap=X.nnz_cap if sp.is_sparse(X) else None)
    out = []
    for _ in range(rounds):
        res = T.mapreduce_round(Xp, yp, mp, sv, cfg)
        sv = res.sv
        out.append(tuple(t.float().cpu().numpy() if t.is_floating_point()
                         else t.cpu().numpy()
                         for t in (res.risks, sv.ids, sv.mask, sv.alpha)))
    return out


def _hold_to_functional(per_rank, i, want, tag):
    """Rank 0's case ``i`` against the functional rounds ``want``: SV ids
    and mask equal, α and risks within the reference's rtol / atol.
    → max |Δ risk|."""
    import numpy as np
    got = per_rank[0]["cases"][i]
    worst = 0.0
    for t, (risks, ids, mask, alpha) in enumerate(want):
        check(np.array_equal(got["ids"][t], ids)
              and np.array_equal(got["mask"][t], mask),
              f"[{tag}] round {t}: SV ids or mask differ from the "
              "functional round")
        for what, a, b in (("alpha", got["alpha"][t], alpha),
                           ("risks", got["risks"][t], risks)):
            ok = np.allclose(a, b, rtol=SHARDED_RTOL, atol=SHARDED_ATOL)
            check(ok, f"[{tag}] round {t}: {what} differ from the functional "
                  f"round by {float(np.abs(a - b).max()):.2e}")
        worst = max(worst, float(np.abs(got["risks"][t] - risks).max()))
    return worst


def _packed_vs_allgather(per_rank, names, tag):
    """Each ring / hier case ≡ its allgather case (wire dtype = data
    dtype): SV buffer, w and b bit for bit; risks within 1e-6 relative.
    → whether every packed case's risks were also bit for bit."""
    import numpy as np
    all_bits = True
    for i, name in enumerate(names):
        parts = name.split("-")
        if parts[1] not in ("ring", "hier"):
            continue
        j = names.index("-".join([parts[0], "allgather"] + parts[2:]))
        a, b = per_rank[0]["cases"][i], per_rank[0]["cases"][j]
        picks = [(int(np.argmin(u)), int(np.argmin(v)))
                 for u, v in zip(a["risks"], b["risks"])]
        for k in SV_FIELDS:
            check(all(_same_np(u, v) for u, v in zip(a[k], b[k])),
                  f"[{tag}] {name}: {k} differs from allgather's (picks "
                  f"by round {picks})")
        for u, v in zip(a["risks"], b["risks"]):
            check(np.allclose(u, v, rtol=1e-6, atol=0),
                  f"[{tag}] {name}: risks differ from allgather's")
        all_bits &= all(np.array_equal(u, v) for u, v in zip(a["risks"],
                                                             b["risks"]))
    return all_bits


def _schedules_agree(per_rank, cases, sweeps):
    """Every rank's recorded collective schedule of each case (checked
    valid on the rank by ``run_cases``) equal on all ranks."""
    from repro_torch import analysis
    n = 0
    for key, cs, tag in (("schedules", cases, "sharded-small"),
                         ("sweep_schedules", sweeps, "sharded-sweep-small")):
        for i, c in enumerate(cs):
            analysis.assert_schedules_agree(
                {f"rank{r}": res[key][i] for r, res in enumerate(per_rank)},
                program=f"{tag} {c.name}")
            n += len(per_rank[0][key][i])
    say(f"[sharded-small] collective schedules of {len(cases)} cases and "
        f"{len(sweeps)} sweep cases valid on every rank and equal on all "
        f"{len(per_rank)} ({n} collectives a rank)")


def phase_sharded_small(torch, T, text):
    """``[sharded-small]``: the sharded round (``build_sharded_round``)
    at the golden size (the golden pipeline's 768 training rows × 1024
    features, sv_capacity 128) on 8 ranks sharing the card over gloo:
    allgather, ring and hier (2 simulated hosts) × dense, blocked-CSR
    (``nnz_cap`` 32) and ``use_gram`` rows (dense ``gram``; blocked-CSR
    ``sparse_gram``) with the psum readback, and the three transports on
    dense rows with the tree readback, 3 rounds each, every rank's
    outputs the same; each held to the port's functional ``mapreduce_round`` on
    the card (SV ids and mask equal, α and risks within 1e-4 / 1e-5); an
    f32 wire, so ring and hier ≡ allgather bit for bit (SV buffer and
    hypothesis); a ring message garbled on one rank alone, which must
    give +inf risks on every rank; then W = 1 on NCCL, round 1 of each
    transport under ``no_implicit_host_sync``. → launches by
    route, summed over the ranks of the 8-rank run."""
    import numpy as np
    from repro_torch import compat
    from repro_torch.launch.sharded import Case, SweepCase, run_cases
    corpus = text.generate(text.CorpusConfig(num_messages=1024,
                                             classes=(-1, 1), seed=0))
    Xd, _ = text.fit_transform(text.vectorize(corpus.texts, 1024),
                               device="cpu")
    Xs, _ = text.fit_transform(
        text.vectorize_sparse(corpus.texts, 1024, nnz_cap=32), device="cpu")
    Xd = Xd[:768].numpy()
    Xs = (Xs.indices[:768].numpy(), Xs.values[:768].numpy(), 1024)
    y = np.asarray(corpus.labels[:768], np.float32)
    lin = dict(C=1.0, max_epochs=15)
    fmts = {"dense": (Xd, {}),
            "sparse": (Xs, dict(row_format="sparse_csr", nnz_cap=32)),
            "gram": (Xd, dict(use_gram=True, gram_impl="pallas")),
            "sparse_gram": (Xs, dict(use_gram=True, row_format="sparse_csr",
                                     nnz_cap=32, gram_impl="pallas_sparse"))}
    cases = []
    for conv in ("psum", "tree"):
        for impl, hosts in SHARDED_TRANSPORTS:
            for fmt, (X, svm) in fmts.items():
                if conv == "tree" and fmt != "dense":   # the readback is
                    continue                            # format-blind
                cfg = T.MRSVMConfig(
                    sv_capacity=128, shuffle_impl=impl, converge_impl=conv,
                    hier_num_hosts=hosts, shuffle_wire_dtype="float32",
                    svm=T.SVMConfig(**lin, **svm))
                cases.append(Case(f"{fmt}-{impl}-{conv}", cfg, X, y))
    names = [c.name for c in cases]
    # one rank's received ring message garbled: every rank must see +inf
    garble = Case("garble-ring-r3", T.MRSVMConfig(
        sv_capacity=128, shuffle_impl="ring", shuffle_wire_dtype="float32",
        shuffle_wire_check=True, svm=T.SVMConfig(**lin)), Xd, y, rounds=1,
        garble=(3, 0))
    sweeps = _sweep_small_cases(T, Xd, Xs, y)
    t0 = time.perf_counter()
    per_rank = compat.spawn(run_cases, 8, (cases + [garble], (), None, sweeps),
                            device="cuda", timeout_s=300.0,
                            join_timeout_s=600.0)
    secs = time.perf_counter() - t0
    check(all(r["modules"] == [] for r in per_rank),
          "[sharded-small] a rank imported JAX or the reference")
    check(all(r["backend"] == "gloo" for r in per_rank),
          "[sharded-small] 8 ranks on one card must share it over gloo")
    _schedules_agree(per_rank, cases + [garble], sweeps)
    lone = [r["cases"][len(cases)]["risks"][0] for r in per_rank]
    check(all(np.isposinf(x).all() for x in lone),
          f"[sharded-small] a message garbled on rank 3 alone left finite "
          f"risks on some rank: {lone}")
    routes = {}
    for r in per_rank:
        for k, v in r["routes"].items():
            routes[k] = routes.get(k, 0) + v
    routes = {k: v for k, v in routes.items() if v}
    yt = torch.from_numpy(y).to(DEV)
    want = {}
    for fmt, (X, svm) in fmts.items():
        cfg = T.MRSVMConfig(sv_capacity=128, svm=T.SVMConfig(**lin, **svm))
        rows = (sp_rows(torch, X) if isinstance(X, tuple)
                else torch.from_numpy(X).to(DEV))
        want[fmt] = _functional_rounds(torch, T, rows, yt, 8, cfg, 3)
    worst = 0.0
    for i, name in enumerate(names):
        _replicated(per_rank, i, f"sharded-small {name}")
        worst = max(worst, _hold_to_functional(
            per_rank, i, want[name.split("-")[0]], f"sharded-small {name}"))
    bits = _packed_vs_allgather(per_rank, names, "sharded-small")
    for i, name in enumerate(names):
        if name.endswith("-tree"):
            j = names.index(name[:-4] + "psum")
            a, b = per_rank[0]["cases"][i], per_rank[0]["cases"][j]
            check(all(_same_np(u, v) for k in ("ids", "x", "alpha", "w")
                      for u, v in zip(a[k], b[k])),
                  f"[sharded-small] {name}: differs from psum")
    p = per_rank[3]["probe"]
    check(p["index"] == 3 and np.isnan(p["pmax"][1])
          and np.array_equal(p["ring"], np.arange(3) + 20.0),
          f"[sharded-small] collective probe on rank 3: {p}")
    check(len(cases) == 15, f"[sharded-small] {len(cases)} cases")
    say(f"[sharded-small] {len(cases)} cases × 3 rounds on 8 ranks sharing "
        f"the card over gloo in {secs:.1f} s (spawn included): every rank "
        "the same, each ≡ the functional round (SV ids, mask; α and risks "
        f"within 1e-4/1e-5, max |ΔR| {worst:.2e}), ring and hier ≡ "
        f"allgather bit for bit (risks too: {bits}), tree ≡ psum; launches "
        f"by route over the ranks {routes}; a ring message garbled on "
        "rank 3 alone gave +inf risks on all 8")
    check(routes.get("cd_solve/single", 0) > 0
          and routes.get("cd_solve/sparse", 0) > 0
          and routes.get("cd_solve_gram/single", 0)
          + routes.get("cd_solve_gram/cluster", 0) > 0
          and routes.get("hinge_scores/simt", 0) > 0
          and routes.get("hinge_scores/sparse", 0) > 0,
          f"[sharded-small] a kernel of the path never launched: {routes}")
    _check_sweep_small(torch, T, per_rank, sweeps, secs)

    # --- W = 1 on NCCL, a round of each transport with no host sync ---
    # hier_num_hosts None: the hosts of the group (one), counted when the
    # round is built
    one = [Case(f"dense-{impl}-psum", T.MRSVMConfig(
        sv_capacity=128, shuffle_impl=impl, shuffle_wire_dtype="float32",
        svm=T.SVMConfig(**lin)), Xd, y, sync_check_round=1)
        for impl, _ in SHARDED_TRANSPORTS]
    # a sweep round on the ring (the dedup state) under the same guard
    w1_sweep = [SweepCase("w1-sweep-ring", sweeps[1].cfg, Xd, y,
                          sweeps[1].params, drive=False, rounds=2,
                          sync_check_round=1)]
    t0 = time.perf_counter()
    res = compat.spawn(run_cases, 1, (one, (), None, w1_sweep),
                       device="cuda", timeout_s=120.0, join_timeout_s=300.0)
    secs = time.perf_counter() - t0
    check(res[0]["backend"] == "nccl",
          f"[sharded-small] W = 1 ran on {res[0]['backend']}, not NCCL")
    cfg = T.MRSVMConfig(sv_capacity=128, svm=T.SVMConfig(**lin))
    w1 = _functional_rounds(torch, T, torch.from_numpy(Xd).to(DEV), yt, 1,
                            cfg, 3)
    names1 = [c.name for c in one]
    for i, name in enumerate(names1):
        _hold_to_functional(res, i, w1, f"sharded-small W=1 nccl {name}")
    _packed_vs_allgather(res, names1, "sharded-small W=1 nccl")
    w1 = _sweep_raw_rounds(torch, T, torch.from_numpy(Xd).to(DEV)[None],
                           yt[None], w1_sweep[0], 2)
    _raw_vs_functional(res[0]["sweeps"][0]["rounds"], w1,
                       "sharded-sweep-small W=1 nccl")
    say(f"[sharded-small] W = 1 on NCCL ({secs:.1f} s with the spawn): "
        "allgather, ring and hier ≡ the functional round (L = 1), ring and "
        "hier ≡ allgather bit for bit, round 1 of each under "
        "no_implicit_host_sync with no host sync; launches "
        f"{ {k: v for k, v in res[0]['routes'].items() if v} }; "
        "[sharded-sweep-small] 2 sweep rounds of S = 4 on the ring (the "
        "dedup state), round 1 under no_implicit_host_sync, ≡ 2 "
        "functional sweep rounds (SV ids, α bit for bit); launches "
        f"{ {k: v for k, v in res[0]['sweep_routes'].items() if v} }")
    return routes


# ---------------------------------------------------------------------------
# slice 13: the sharded sweep on torch.distributed
# ---------------------------------------------------------------------------

# the golden sweep grid of the reference's sharded sweep tests: its
# configs converge at different rounds (tests/test_sweep.py)
SWEEP_SMALL_C = (1e-4, 0.5, 1.0, 5.0)


def _sweep_small_cases(T, Xd, Xs, y):
    """``[sharded-sweep-small]``'s cases on [sharded-small]'s golden rows
    (sv_capacity 128, γ 5e-3, up to 6 rounds, C = 1e-4, 0.5, 1, 5, f32
    wire): allgather, ring and hier on dense rows (ring and hier carry
    the dedup state; the ring also 3 rounds driven one by one with the
    state saved after round 1 and resumed), blocked-CSR rows on
    allgather and ring, 4 streams of permuted rows (``per_config_data``)
    on allgather and ring, and bf16 rows on a bf16 wire."""
    import dataclasses
    import numpy as np
    from repro_torch.launch.sharded import SweepCase
    lin = dict(C=1.0, max_epochs=15)

    def cfg(impl, **svm):
        return T.MRSVMConfig(
            sv_capacity=128, gamma=5e-3, max_rounds=6, shuffle_impl=impl,
            hier_num_hosts=2 if impl == "hier" else None,
            shuffle_wire_dtype="float32", svm=T.SVMConfig(**lin, **svm))
    params = T.sweep_grid(T.SVMConfig(**lin), C=list(SWEEP_SMALL_C))
    rng = np.random.default_rng(5)
    perms = [rng.permutation(y.shape[0]) for _ in range(4)]
    Xst = np.stack([Xd[p] for p in perms])
    yst = np.stack([y[p] for p in perms])
    cases = [SweepCase(f"sweep-dense-{impl}", cfg(impl), Xd, y, params,
                       rounds=3 if impl == "ring" else 0,
                       resume_round=1 if impl == "ring" else None)
             for impl in ("allgather", "ring", "hier")]
    cases += [SweepCase(f"sweep-sparse-{impl}",
                        cfg(impl, row_format="sparse_csr", nnz_cap=32), Xs,
                        y, params) for impl in ("allgather", "ring")]
    cases += [SweepCase(f"sweep-stream-{impl}", cfg(impl), Xst, yst, params,
                        per_config_data=True)
              for impl in ("allgather", "ring")]
    cases.append(SweepCase(
        "sweep-bf16-ring", dataclasses.replace(cfg("ring"),
                                               shuffle_wire_dtype="bfloat16"),
        Xd, y, params, dtype="bfloat16"))
    return cases


def _case_rows(torch, X, dtype):
    """A case's numpy rows (dense or ``(indices, values, d)``, maybe with
    a leading streams axis) on the card as ``dtype``."""
    if isinstance(X, tuple):
        return sp_rows(torch, X).to(dtype=dtype)
    return torch.from_numpy(X).to(DEV, dtype)


def _functional_sweep(torch, T, case):
    """The port's functional sweep on the card of a sweep case's rows
    (8 partitions)."""
    import dataclasses
    cfg = dataclasses.replace(case.cfg, shuffle_impl="allgather",
                              hier_num_hosts=None)
    dt = getattr(torch, case.dtype)
    return T.fit_mapreduce_sweep(_case_rows(torch, case.X, dt), case.y, 8,
                                 cfg, case.params, device=DEV)


def _sweep_vs_functional(got, want, tag, rtol=1e-5):
    """A driven sharded sweep (``run_sweep_case``'s ``sweep``) against the
    functional sweep: rounds, per-round picks, SV ids and α (in the
    state's dtype) bit for bit, per-round risks within ``rtol``. → max
    relative |Δ risk|."""
    import numpy as np
    check(np.array_equal(got["rounds"], want.rounds),
          f"[{tag}] rounds {got['rounds']} vs {want.rounds}")
    check(np.array_equal(got["sv"].ids, want.sv.ids.cpu().numpy()),
          f"[{tag}] SV ids differ from the functional sweep")
    # the state keeps α in the rows' dtype
    wa = want.sv.alpha.to(want.sv.x.dtype).float().cpu().numpy()
    check(np.array_equal(got["sv"].alpha, wa),
          f"[{tag}] α not bit for bit with the functional sweep")
    worst = 0.0
    check(len(got["history"]) == len(want.history),
          f"[{tag}] {len(got['history'])} rounds vs {len(want.history)}")
    for t, (r, l, h) in enumerate(zip(got["history"], got["reducers"],
                                      want.history)):
        check(np.array_equal(l, h["reducers"]),
              f"[{tag}] round {t}: picks {l} vs {h['reducers']}")
        act = ~np.isnan(h["risks"])
        rel = float(np.max(np.abs(r[act] - h["risks"][act])
                           / np.abs(h["risks"][act]))) if act.any() else 0.0
        check(rel <= rtol, f"[{tag}] round {t}: risks differ by {rel:.2e}")
        worst = max(worst, rel)
    return worst


def _sweep_raw_rounds(torch, T, Xp, yp, case, rounds):
    """``rounds`` functional sweep rounds (``sweep_round``, the grid
    unmasked) of a case on the card: per round (ids, α in the rows'
    dtype, risks) as numpy. ``Xp`` (L, per, d) or (S, L, per, d)."""
    import dataclasses
    from repro_torch.core import sweep as sw
    from repro_torch.core.mapreduce_svm import sweep_round
    cfg = dataclasses.replace(case.cfg, shuffle_impl="allgather",
                              hier_num_hosts=None)
    S = len(case.params.C)
    sv = sw._stack_sv(T.init_sv_buffer(
        cfg.sv_capacity, Xp.shape[-1], Xp.dtype, DEV,
        nnz_cap=Xp.nnz_cap if hasattr(Xp, "nnz_cap") else None), S)
    params = sw._params_on(case.params, torch.device(DEV))
    out = []
    for _ in range(rounds):
        res = sweep_round(Xp, yp, torch.ones_like(yp), sv, cfg, params)
        sv = res.sv
        out.append((sv.ids.cpu().numpy(),
                    sv.alpha.to(Xp.dtype).float().cpu().numpy(),
                    res.risks.float().cpu().numpy()))
    return out


def _raw_vs_functional(got, want, tag, rtol=1e-5):
    """Rounds driven one by one (``run_sweep_case``'s ``rounds``, or the
    full-width ranks' records) against functional ``sweep_round``s:
    ids and α bit for bit, risks within ``rtol`` relative. → max
    relative |Δ risk|."""
    import numpy as np
    worst = 0.0
    for t, (g, (ids, alpha, risks)) in enumerate(zip(got, want)):
        check(np.array_equal(g["ids"], ids),
              f"[{tag}] round {t}: SV ids differ from the functional round")
        check(np.array_equal(g["alpha"], alpha),
              f"[{tag}] round {t}: α not bit for bit with the functional "
              "round")
        rel = float(np.max(np.abs(g["risks"] - risks) / np.abs(risks)))
        check(rel <= rtol, f"[{tag}] round {t}: risks differ by {rel:.2e}")
        worst = max(worst, rel)
    check(len(got) == len(want), f"[{tag}] {len(got)} rounds recorded")
    return worst


def _check_sweep_small(torch, T, per_rank, sweeps, secs):
    """``[sharded-sweep-small]``'s checks on the 8-rank run: every rank
    the same; each driven sweep ≡ the port's functional sweep on the
    card; ring and hier ≡ allgather bit for bit; the resumed rounds ≡
    the uninterrupted ones; one solve launch a round on each rank."""
    import numpy as np
    names = [c.name for c in sweeps]
    for i, name in enumerate(names):
        a = per_rank[0]["sweeps"][i]
        for r, res in enumerate(per_rank[1:], 1):
            b = res["sweeps"][i]["sweep"]
            check(all(_same_np(u, v) for k in ("risks", "ws", "rounds")
                      for u, v in [(a["sweep"][k], b[k])])
                  and _same_np(a["sweep"]["sv"].ids, b["sv"].ids),
                  f"[sharded-sweep-small] {name}: rank {r} differs")
    worst = 0.0
    for i, case in enumerate(sweeps):
        want = _functional_sweep(torch, T, case)
        worst = max(worst, _sweep_vs_functional(
            per_rank[0]["sweeps"][i]["sweep"], want,
            f"sharded-sweep-small {case.name}"))
        del want
    for name in names:
        kind, impl = name.rsplit("-", 1)
        if impl == "allgather" or f"{kind}-allgather" not in names:
            continue
        a = per_rank[0]["sweeps"][names.index(name)]["sweep"]
        b = per_rank[0]["sweeps"][names.index(f"{kind}-allgather")]["sweep"]
        check(all(_same_np(getattr(a["sv"], k), getattr(b["sv"], k))
                  for k in ("ids", "alpha", "mask"))
              and _same_np(a["ws"], b["ws"])
              and np.array_equal(a["rounds"], b["rounds"])
              and np.allclose(a["risks"], b["risks"], rtol=1e-6, atol=0),
              f"[sharded-sweep-small] {name} differs from allgather")
    ring = per_rank[0]["sweeps"][names.index("sweep-dense-ring")]
    check(len(ring["resumed"]) == 1 and all(
        _same_np(ring["rounds"][2][k], ring["resumed"][0][k])
        for k in ("ids", "alpha", "x", "risks", "w", "b", "ptr")),
        "[sharded-sweep-small] the resumed round differs from the "
        "uninterrupted one")
    # rank 0's rounds: driven, one by one and resumed
    rounds = sum(len(per_rank[0]["sweeps"][i]["sweep"]["history"])
                 + c.rounds + (c.rounds - c.resume_round - 1
                               if c.resume_round is not None else 0)
                 for i, c in enumerate(sweeps))
    routes = {}
    for r in per_rank:
        for k, v in r["sweep_routes"].items():
            if v:
                routes[k] = routes.get(k, 0) + v
    solves = sum(v for k, v in routes.items() if k.startswith("cd_solve"))
    check(solves == 8 * rounds,
          f"[sharded-sweep-small] {solves} solve launches over 8 ranks, "
          f"not one a round on each ({rounds} rounds)")
    check(routes.get("cd_solve/sparse", 0) > 0
          and routes.get("hinge_scores/sparse", 0) > 0
          and routes.get("hinge_scores/tensor_core", 0) > 0,
          f"[sharded-sweep-small] a kernel of the path never launched: "
          f"{routes}")
    say(f"[sharded-sweep-small] {len(sweeps)} sweeps of S = 4 on 8 ranks "
        f"in the same spawn ({secs:.1f} s in all): every rank the same, "
        "each ≡ the port's functional sweep on the card (rounds, picks, SV "
        f"ids, α bit for bit; risks within 1e-5, max rel {worst:.2e}), "
        "ring and hier ≡ allgather bit for bit, the state saved after "
        "round 1 resumes bit for bit; one solve launch of S jobs a round "
        f"on each rank ({solves} over {rounds} rounds × 8 ranks); "
        f"launches by route {routes}")


def sp_rows(torch, X):
    """``(indices, values, d)`` numpy → ``SparseRows`` on the card."""
    from repro_torch.convert import rows_from_numpy
    return rows_from_numpy(X, DEV)


@contextlib.contextmanager
def _timed(torch, ops, acc, keep=None):
    """While the block runs, ``ops.cd_solve`` and ``ops.hinge_scores``
    run as shipped between two ``torch.cuda.synchronize`` and add their
    seconds to ``acc[name]``; ``keep(name, args, kwargs, out)`` sees
    each call."""
    shipped = {n: getattr(ops, n) for n in ("cd_solve", "hinge_scores")}

    def wrap(name):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = shipped[name](*a, **kw)
            torch.cuda.synchronize()
            acc[name] += time.perf_counter() - t0
            if keep is not None:
                keep(name, a, kw, out)
            return out
        return run
    for n in shipped:
        setattr(ops, n, wrap(n))
    try:
        yield acc
    finally:
        for n, f in shipped.items():
            setattr(ops, n, f)


# 2 rounds, 3 until slice 17: with 3 the whole run took 1020 s on an NVIDIA
# H100 80GB HBM3 at 700 W, past its budget of 1000 s
SHARDED_FULL_ROUNDS = 2


def _sharded_full_cfg(T, fmt, impl):
    from repro_torch.configs import SVM_TFIDF
    svm = dict(C=SVM_TFIDF.C, max_epochs=SVM_TFIDF.max_epochs)
    if fmt == "sparse":
        svm.update(row_format="sparse_csr", nnz_cap=SVM_TFIDF.nnz_cap)
    return T.MRSVMConfig(sv_capacity=SVM_TFIDF.sv_capacity, gamma=1e-4,
                         shuffle_impl=impl, svm=T.SVMConfig(**svm))


def _sharded_full_rank(rank, rounds):
    """``[sharded-full]`` on one rank: its own 8192 rows of the
    svm-tfidf data (dense bf16, then blocked-CSR ``nnz_cap`` 256 with
    bf16 values), made here by ``svm_rows_device`` /
    ``svm_rows_sparse_device`` with its process index; ``rounds`` rounds
    on ``ring`` (the config's transport, bf16 wire), then on
    ``allgather``, each round timed and split into the solve, eq. 7 and
    the rest (the merge: collectives, staging, assembly). Rank 0 records
    its round-0 solve and first hinge_scores call of the dense ring case,
    rank 1 those of the blocked-CSR ring case; each holds them to the
    plain versions after the last case, so that the two plain solves
    (~45 s each at this shape) run at once; before them, the rank's part
    of [moe-sharded] (``_moe_sharded_rank``). → per case: per round ids,
    α, risks, the split, the bytes a rank ships; launches by route of
    the rounds; "moe": the [moe-sharded] part."""
    import torch
    import repro_torch.core as T
    from repro_torch import sparse as sp
    from repro_torch.configs import SVM_TFIDF
    from repro_torch.core import mapreduce_svm as mr
    from repro_torch.data.pipeline import (svm_rows_device,
                                           svm_rows_sparse_device)
    from repro_torch.kernels import ops, ref
    L, per, d = rank.world_size, SVM_TFIDF.rows_per_device, \
        SVM_TFIDF.num_features
    dev = rank.device
    shard = dict(device=dev, process_index=rank.rank,
                 process_count=rank.world_size)
    out = {"cases": {}, "routes": {}}
    checks = []
    for fmt in ("dense", "sparse"):
        if fmt == "dense":
            X, y = svm_rows_device(L * per, d, seed=0, dtype=torch.bfloat16,
                                   **shard)
        else:
            X, y = svm_rows_sparse_device(L * per, d, SVM_TFIDF.nnz_cap,
                                          seed=0, nnz=SVM_TFIDF.nnz_cap,
                                          dtype=torch.bfloat16, **shard)
        m = torch.ones_like(y)
        for impl in ("ring", "allgather"):
            cfg = _sharded_full_cfg(T, fmt, impl)
            fn = T.build_sharded_round(cfg, per, device=dev)
            sv = T.init_sv_buffer(cfg.sv_capacity, d, torch.bfloat16, dev,
                                  nnz_cap=X.nnz_cap if sp.is_sparse(X)
                                  else None)
            record = impl == "ring" and rank.rank == ("dense",
                                                      "sparse").index(fmt)
            calls = {}

            def keep(name, a, kw, o):
                if record and name not in calls:
                    calls[name] = (_job_slice(torch, sp, a, kw, o,
                                              slice(0, 1))
                                   if name == "cd_solve"
                                   else _hinge_call(a, o))
            res = {k: [] for k in ("ids", "alpha", "risks", "solve_ms",
                                   "eq7_ms", "merge_ms", "round_ms")}
            before = dict(ops.ROUTE_LAUNCHES)
            for t in range(rounds):
                acc = {"cd_solve": 0.0, "hinge_scores": 0.0}
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with _timed(torch, ops, acc, keep if t == 0 else None):
                    sv, risks, w, b = fn(X, y, m, sv)
                torch.cuda.synchronize()
                ms = 1e3 * (time.perf_counter() - t0)
                res["round_ms"].append(ms)
                res["solve_ms"].append(1e3 * acc["cd_solve"])
                res["eq7_ms"].append(1e3 * acc["hinge_scores"])
                res["merge_ms"].append(ms - 1e3 * (acc["cd_solve"]
                                                   + acc["hinge_scores"]))
                res["ids"].append(sv.ids.cpu().numpy())
                res["alpha"].append(sv.alpha.float().cpu().numpy())
                res["risks"].append(risks.cpu().numpy())
            for k, v in ops.ROUTE_LAUNCHES.items():
                out["routes"][k] = out["routes"].get(k, 0) + v - before[k]
            k = cfg.sv_capacity // L
            if impl == "ring":
                _, wslots = mr.pack_wire_rows(X[:1], cfg.shuffle_wire_dtype)
                lanes = k * wslots + 4 * k + d + 1
                res["msg_bytes"] = 4 * lanes
                res["rows_bytes"] = 4 * k * wslots
                res["sent_bytes"] = (L - 1) * 4 * lanes
            else:
                xb = (k * X.nnz_cap * 6 if sp.is_sparse(X) else k * d * 2)
                res["msg_bytes"] = xb + k * (2 + 4 + 2 + 4) + 4 * d + 4
                res["rows_bytes"] = xb
                res["sent_bytes"] = (L - 1) * res["msg_bytes"]
            if record:
                checks.append((fmt, calls))
            out["cases"][f"{fmt}-{impl}"] = res
            del fn, sv
        del X, y, m
        torch.cuda.empty_cache()
    out["moe"] = _moe_sharded_rank(rank)
    for fmt, calls in checks:
        tag = f"sharded-full {fmt} rank {rank.rank}"
        _solve_vs_plain(torch, ref, sp, calls["cd_solve"], tag)
        _hinge_vs_plain(torch, ref, calls["hinge_scores"], tag)
    return out


# [moe-sharded]: one qwen3-moe-235b-a22b layer at full width (128 experts,
# 32 a model rank, top-8) through apply_moe_sharded on 2 data × 4 model
# ranks of [sharded-full]'s spawn (experts split over model, the weights
# over data as the reference's in_specs), against apply_moe on one rank,
# both at capacity factor E / K (C = T: nothing dropped), bf16.
MOE_SHARDED_ARCH = "qwen3-moe-235b-a22b"
MOE_SHARDED_GRID = (2, 4)
MOE_SHARDED_TOKENS = (4, 256)          # batch, positions
# y, max |Δ| over max |y|: the two sum a token's 8 bf16 contributions in
# other groupings (each model rank's experts, then the 4 partials over
# gloo, against one sequential sum): a few bf16 ulps (2⁻⁸ each) of partial
# sums as large as y (a CPU rehearsal at d 256 read 8.1e-3); the control
# (one model rank's 32 experts left out, 0.73 there) must exceed it
MOE_SHARDED_TOL = 2 ** -5


def _moe_sharded_inputs(torch, cfg, dev, take):
    """The seeded full-width MoE layer, drawn the same on every process:
    each leaf in sorted order (an expert's slice at a time, f32 draws
    rounded to bf16, fan-in scaled) handed to ``take(name, leaf)`` and
    dropped; → the tokens (B, S, D) bf16, drawn last."""
    from repro_torch.models import moe
    gen = torch.Generator(device=dev).manual_seed(7)
    tpl = moe.moe_template(cfg)
    for name in sorted(tpl):
        shape = tpl[name].shape
        leaf = torch.empty(shape, dtype=torch.bfloat16, device=dev)
        for part in (leaf[None] if len(shape) == 2 else leaf):
            part.copy_(torch.randn(part.shape, generator=gen, device=dev)
                       .mul_(1.0 / math.sqrt(shape[-2])))
        take(name, leaf)
        del leaf
    B, S = MOE_SHARDED_TOKENS
    return torch.randn((B, S, cfg.d_model), generator=gen,
                       device=dev).to(torch.bfloat16)


def _moe_sharded_rank(rank) -> dict:
    """This rank's part of [moe-sharded]: its shards of the layer and of
    the tokens, one apply_moe_sharded (timed, its weight gathers
    included). → its y shard (f32 numpy), aux, ms, the part's seconds,
    shard bytes, peak."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    t_part = time.perf_counter()
    cfg = get_config(MOE_SHARDED_ARCH)
    mesh = moe.moe_mesh(*MOE_SHARDED_GRID)
    torch.cuda.reset_peak_memory_stats()
    p = {}
    x = _moe_sharded_inputs(
        torch, cfg, rank.device,
        lambda name, leaf: p.update(moe.shard_moe_params({name: leaf}, cfg,
                                                         mesh)))
    x = moe.shard_tokens(x, mesh).contiguous()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    y, aux = moe.apply_moe_sharded(
        p, x, cfg, mesh, cfg.num_experts / cfg.experts_per_token)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    return {"y": y.float().cpu().numpy(), "aux": float(aux), "ms": ms,
            "s": time.perf_counter() - t_part, "bytes": _nbytes(p),
            "peak": torch.cuda.max_memory_allocated()}


def _check_moe_sharded(torch, per_rank) -> None:
    """[moe-sharded] on the card: the ranks' y shards (each data shard's
    model replicas equal) against apply_moe on one rank, with a control;
    aux within the reference test's rtol 0.1."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    cfg = get_config(MOE_SHARDED_ARCH)
    E, K = cfg.num_experts, cfg.experts_per_token
    data, model = MOE_SHARDED_GRID
    t0 = time.perf_counter()
    p = {}
    x = _moe_sharded_inputs(torch, cfg, DEV, p.__setitem__)
    with torch.no_grad():
        y_one, aux_one = moe.apply_moe(p, x, cfg, E / K)
        w_down = p["w_down"].clone()
        w_down[:E // model] = 0            # model rank 0's experts left out
        y_ctl = moe.apply_moe(dict(p, w_down=w_down), x, cfg, E / K)[0]
    del p, w_down
    torch.cuda.empty_cache()
    ys = [r["y"] for r in per_rank]
    for d in range(data):
        for m in range(1, model):
            check(np.array_equal(ys[d * model + m], ys[d * model]),
                  f"[moe-sharded] data shard {d}: model rank {m}'s y is not "
                  "rank 0's")
    auxes = {r["aux"] for r in per_rank}
    check(len(auxes) == 1, f"[moe-sharded] aux differs over the ranks "
          f"{auxes}")
    y = torch.from_numpy(np.concatenate(ys[::model])).to(DEV)
    want = y_one.float()
    rel = _rel_max(y, want)
    ctl = _rel_max(y_ctl, want)
    aux = auxes.pop()
    B, S = MOE_SHARDED_TOKENS
    say(f"[moe-sharded] {MOE_SHARDED_ARCH} one layer at full width (d "
        f"{cfg.d_model}, ff {cfg.d_ff}, {E} experts, top-{K}), {B} × {S} "
        f"tokens bf16, {data} data × {model} model ranks ({E // model} "
        f"experts a model rank) at capacity factor {E // K} (C = T): y max|Δ| "
        f"{rel:.2e} of max|y| against apply_moe on one rank (tol "
        f"{MOE_SHARDED_TOL:.3g}; control, model rank 0's experts left "
        f"out: {ctl:.2e}); aux {aux:.6f} (mean of the data shards') vs "
        f"{float(aux_one):.6f}; apply_moe_sharded ms by rank "
        f"{[round(r['ms'], 1) for r in per_rank]} (the weight gathers over "
        f"gloo included), shard {per_rank[0]['bytes'] / 1e9:.3f} GB a rank, "
        f"peak {max(r['peak'] for r in per_rank) / 1e9:.2f} GB; the ranks' "
        f"part {max(r['s'] for r in per_rank):.1f} s with the draws, the "
        f"one-rank reference {time.perf_counter() - t0:.1f} s")
    check(rel <= MOE_SHARDED_TOL, f"[moe-sharded] y differs by {rel:.2e}")
    check(ctl > MOE_SHARDED_TOL, "[moe-sharded] the check cannot see a "
          f"model rank's experts left out ({ctl:.2e})")
    check(abs(aux - float(aux_one)) <= 0.1 * float(aux_one),
          f"[moe-sharded] aux {aux} against {float(aux_one)}")


def phase_sharded_full(torch, T):
    """``[sharded-full]``: configs/svm_tfidf.py at full width on 8 ranks
    × 8192 rows × d = 131072 sharing the card over gloo (a cut: one
    card; NCCL needs a card a rank): dense bf16 rows and the config's
    blocked-CSR rows (``nnz_cap`` 256, bf16 values), on ``ring`` (bf16
    wire) and ``allgather``, SHARDED_FULL_ROUNDS rounds each, each rank
    making only its own rows. Held to as many functional rounds on the
    same rows, run first here
    and freed before the spawn: SV ids equal each round, α bit for bit,
    risks within 1e-5 relative. → launches by kernel row over the ranks."""
    import numpy as np
    from repro_torch import compat
    from repro_torch.configs import SVM_TFIDF
    from repro_torch.data.pipeline import (svm_rows_device,
                                           svm_rows_sparse_device)
    L, per, d = 8, SVM_TFIDF.rows_per_device, SVM_TFIDF.num_features
    want = {}
    t0 = time.perf_counter()
    for fmt in ("dense", "sparse"):
        if fmt == "dense":
            X, y = svm_rows_device(L * per, d, seed=0, dtype=torch.bfloat16,
                                   device=DEV)
        else:
            X, y = svm_rows_sparse_device(L * per, d, SVM_TFIDF.nnz_cap,
                                          seed=0, nnz=SVM_TFIDF.nnz_cap,
                                          dtype=torch.bfloat16, device=DEV)
        want[fmt] = _functional_rounds(torch, T, X, y, L, _sharded_full_cfg(
            T, fmt, "allgather"), SHARDED_FULL_ROUNDS)
        del X, y
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    say(f"[sharded-full] the functional reference, dense and blocked-CSR, "
        f"{SHARDED_FULL_ROUNDS} rounds each: {time.perf_counter() - t0:.1f} "
        "s; its rows freed")
    t0 = time.perf_counter()
    per_rank = compat.spawn(_sharded_full_rank, L, (SHARDED_FULL_ROUNDS,),
                            device="cuda", timeout_s=600.0,
                            join_timeout_s=900.0)
    say(f"[sharded-full] 8 ranks × 4 cases × {SHARDED_FULL_ROUNDS} rounds "
        f"in {time.perf_counter() - t0:.1f} s (the spawn and each rank's "
        "rows included)")
    routes = {}
    for r in per_rank:
        for k, v in r["routes"].items():
            if v:
                routes[k] = routes.get(k, 0) + v
    for case in per_rank[0]["cases"]:
        fmt = case.split("-")[0]
        for r, res in enumerate(per_rank):
            got = res["cases"][case]
            for t, (risks, ids, mask, alpha) in enumerate(want[fmt]):
                rel = float(np.abs(got["risks"][t] - risks).max()
                            / np.abs(risks).max())
                check(np.array_equal(got["ids"][t], ids),
                      f"[sharded-full] {case} rank {r} round {t}: SV ids "
                      "differ from the functional round")
                check(np.array_equal(got["alpha"][t], alpha),
                      f"[sharded-full] {case} rank {r} round {t}: α not "
                      "bit for bit with the functional round")
                check(rel <= 1e-5, f"[sharded-full] {case} rank {r} round "
                      f"{t}: risks differ by {rel:.2e} relative")
        r0 = per_rank[0]["cases"][case]
        for t in range(SHARDED_FULL_ROUNDS):
            split = {k: [round(res["cases"][case][k][t], 1)
                         for res in per_rank]
                     for k in ("round_ms", "solve_ms", "merge_ms", "eq7_ms")}
            say(f"[sharded-full] {case} round {t}: R_emp "
                f"{float(r0['risks'][t].min()):.6f}, |SV| "
                f"{int((r0['ids'][t] >= 0).sum())}; ms by rank: "
                + json.dumps(split))
        say(f"[sharded-full] {case}: a rank ships "
            f"{r0['sent_bytes'] / 1e6:.2f} MB a round ({r0['msg_bytes'] / 1e6:.3f} "
            f"MB a message, {r0['rows_bytes'] / 1e6:.3f} MB of it feature "
            "rows); SV ids and α bit for bit, risks within 1e-5 of the "
            "functional round on every rank")
    # the reckoned row lanes of a ring message: k = 2048 / 8 = 256 rows of
    # d / 2 = 65536 bf16 pairs (dense), or of 128 value pairs + 256 ids
    k, cap = SVM_TFIDF.sv_capacity // L, SVM_TFIDF.nnz_cap
    ring = per_rank[0]["cases"]
    check(ring["dense-ring"]["rows_bytes"] == k * (d // 2) * 4
          and ring["sparse-ring"]["rows_bytes"] == k * (cap // 2 + cap) * 4,
          "[sharded-full] the ring message's row lanes are not the "
          f"reckoned {k} × {d // 2} (dense) and {k} × {cap // 2 + cap} "
          "(blocked-CSR) lanes")
    rows = _row_launches(routes)
    say(f"[sharded-full] launches over the 8 ranks: routes {routes}, by "
        f"kernel row {rows}")
    _check_moe_sharded(torch, [r["moe"] for r in per_rank])
    check(rows.get("cd_solve", 0) == 2 * L * SHARDED_FULL_ROUNDS
          and rows.get("cd_solve/sparse", 0) == 2 * L * SHARDED_FULL_ROUNDS
          and rows.get("hinge_scores", 0) > 0
          and rows.get("hinge_scores/sparse", 0) > 0,
          f"[sharded-full] launches {rows}")
    return rows


SWEEP_FULL_S = 4          # C = logspace(-2, 1, 4), the launcher's --sweep 4
SWEEP_FULL_ROUNDS = 2
STREAM_TENANTS = 4


def _sweep_full_cfg(T, fmt, impl):
    import dataclasses
    return dataclasses.replace(_sharded_full_cfg(T, fmt, impl),
                               max_rounds=SWEEP_FULL_ROUNDS)


def _sweep_full_grid(T, cfg, S):
    import numpy as np
    return T.sweep_grid(cfg.svm, C=np.logspace(-2, 1, S).astype(np.float32))


def _stream_rows(torch, s, **kw):
    """Tenant ``s``'s wave at the service's width: 8192 new rows and the
    2048 carried SV rows (``sv_capacity``), bf16."""
    from repro_torch.configs import SVM_TFIDF
    from repro_torch.data.pipeline import svm_rows_device
    return svm_rows_device(SVM_TFIDF.stream_rows_per_wave
                           + SVM_TFIDF.sv_capacity, SVM_TFIDF.num_features,
                           seed=20 + s, dtype=torch.bfloat16, **kw)


def _state_ids_alpha(torch, state):
    """Each config's SV ids and α of a round state, without making its
    (S, cap, d) rows: from the dedup state's ptr, or the buffer's own."""
    if hasattr(state, "ptr"):
        safe = state.ptr.clamp(min=0).long()
        valid = (state.ptr >= 0) & (state.mask > 0)
        return (torch.where(valid, state.ids[safe], -1),
                state.alpha * valid.to(state.alpha.dtype))
    return state.ids, state.alpha


def _msg_bytes(T, X, cfg, S, L, dedup):
    """The bytes of a rank's packed sweep message: the wire rows, then
    the f32 sidebands and the S hypotheses."""
    from repro_torch.core import mapreduce_svm as mr
    from repro_torch.core import sweep as sw
    k = cfg.sv_capacity // L
    per, d = X.shape[-2], X.shape[-1]
    _, wslots = mr.pack_wire_rows(X.reshape(-1, d)[:1],
                                  cfg.shuffle_wire_dtype)
    if dedup:
        U = sw.dedup_unique_cap(cfg, S, k, per)
        rows, side = U * wslots, 2 * U + 3 * S * k
    else:
        rows, side = S * k * wslots, 4 * S * k
    return 4 * (rows + side + S * d + S), 4 * rows


def _sweep_full_rank(rank, rounds, s_dense):
    """``[sharded-sweep-full]`` on one rank, its own rows made here with
    its process index: (a) the blocked-CSR svm-tfidf rows (``nnz_cap``
    256, bf16 values) through ``fit_sharded_sweep`` (S = 4, the train
    mode's ``--sweep 4``) on ``ring`` then ``allgather``; (b) the dense
    bf16 rows on ``ring``, ``rounds`` rounds driven one by one at S =
    ``s_dense``; (c) the per-stream wave, 4 tenants × (8192 + 2048)
    rows, ``per_config_data``, on ``ring``, ``rounds`` rounds. Each
    round timed and split into the solve, eq. 7 and the rest (the merge);
    each part's peak memory. Rank 0 records (b)'s round-0 solve (its
    first job) and first hinge_scores call, rank 1 (a)'s ring, rank 2
    (c)'s, and holds them to the plain versions after the last part.
    → per part the results, launches by route and peak bytes."""
    import numpy as np
    import torch
    import repro_torch.core as T
    from repro_torch import sparse as sp
    from repro_torch.configs import SVM_TFIDF
    from repro_torch.data.pipeline import (svm_rows_device,
                                           svm_rows_sparse_device)
    from repro_torch.kernels import ops, ref
    from repro_torch.launch.sharded import fit_sharded_sweep
    from repro_torch.convert import to_numpy
    L, per, d = rank.world_size, SVM_TFIDF.rows_per_device, \
        SVM_TFIDF.num_features
    dev = rank.device
    shard = dict(device=dev, process_index=rank.rank, process_count=L)
    out = {"parts": {}, "routes": {}, "peak": {}}
    checks = []

    def recorder(on):
        calls = {}

        def keep(name, a, kw, o):
            if on and name not in calls:
                calls[name] = (_job_slice(torch, sp, a, kw, o, slice(0, 1))
                               if name == "cd_solve" else _hinge_call(a, o))
        return calls, keep

    def begin():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        return dict(ops.ROUTE_LAUNCHES)

    def end(name, before):
        torch.cuda.synchronize()
        out["peak"][name] = torch.cuda.max_memory_allocated(dev)
        out["routes"][name] = {k: v - before[k]
                               for k, v in ops.ROUTE_LAUNCHES.items()
                               if v - before[k]}

    # (a) blocked-CSR rows through the train mode's sweep
    X, y = svm_rows_sparse_device(L * per, d, SVM_TFIDF.nnz_cap, seed=0,
                                  nnz=SVM_TFIDF.nnz_cap,
                                  dtype=torch.bfloat16, **shard)
    for impl in ("ring", "allgather"):
        cfg = _sweep_full_cfg(T, "sparse", impl)
        calls, keep = recorder(impl == "ring" and rank.rank == 1)
        before = begin()
        acc = {"cd_solve": 0.0, "hinge_scores": 0.0}
        with _timed(torch, ops, acc, keep):
            res = fit_sharded_sweep(rank, X, y, cfg, sweep=SWEEP_FULL_S)
        end(f"sparse-{impl}", before)
        n = len(res["history"])
        res["solve_ms"] = 1e3 * acc["cd_solve"] / n
        res["eq7_ms"] = 1e3 * acc["hinge_scores"] / n
        res["round_ms"] = res["ms"] / n
        res["merge_ms"] = res["round_ms"] - res["solve_ms"] - res["eq7_ms"]
        if impl == "ring":
            res["msg_bytes"], res["rows_bytes"] = _msg_bytes(
                T, X, cfg, SWEEP_FULL_S, L, True)
        else:
            k = cfg.sv_capacity // L
            res["rows_bytes"] = SWEEP_FULL_S * k * X.nnz_cap * 6
            res["msg_bytes"] = res["rows_bytes"] + SWEEP_FULL_S * (
                k * (2 + 4 + 4 + 2) + 4 * d + 4)
        res["sent_bytes"] = (L - 1) * res["msg_bytes"]
        out["parts"][f"sparse-{impl}"] = res
        if calls:
            checks.append(("blocked-CSR ring", calls))
    del X, y
    torch.cuda.empty_cache()

    def by_rounds(name, fn, X, y, params, S, record, dedup):
        m = torch.ones_like(y)
        calls, keep = recorder(record)
        before = begin()
        state = fn.init_sv(S, d, X.dtype)
        res = {k: [] for k in ("ids", "alpha", "risks", "round_ms",
                               "solve_ms", "eq7_ms", "merge_ms")}
        for t in range(rounds):
            acc = {"cd_solve": 0.0, "hinge_scores": 0.0}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with _timed(torch, ops, acc, keep if t == 0 else None):
                state, risks, w, b = fn(X, y, m, state, params)
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0)
            ids, alpha = _state_ids_alpha(torch, state)
            res["ids"].append(to_numpy(ids))
            res["alpha"].append(to_numpy(alpha))
            res["risks"].append(to_numpy(risks))
            res["round_ms"].append(ms)
            res["solve_ms"].append(1e3 * acc["cd_solve"])
            res["eq7_ms"].append(1e3 * acc["hinge_scores"])
            res["merge_ms"].append(ms - 1e3 * (acc["cd_solve"]
                                               + acc["hinge_scores"]))
        del state
        end(name, before)
        res["msg_bytes"], res["rows_bytes"] = _msg_bytes(
            T, X, fn.cfg, S, L, dedup)
        res["sent_bytes"] = (L - 1) * res["msg_bytes"]
        out["parts"][name] = res
        return calls

    # (c) the per-stream wave: 4 tenants, ring, per-config buffers
    rows = [_stream_rows(torch, s, **shard) for s in range(STREAM_TENANTS)]
    Xs = torch.stack([r[0] for r in rows])
    ys = torch.stack([r[1] for r in rows])
    del rows
    cfg = _sweep_full_cfg(T, "dense", "ring")
    fn = T.build_sharded_sweep_round(cfg, Xs.shape[1], device=dev,
                                     per_config_data=True)
    fn.cfg = cfg
    params = T.stack_params([cfg.svm.params()] * STREAM_TENANTS)
    calls = by_rounds("stream-ring", fn, Xs, ys,
                      T.SolverParams(*(torch.as_tensor(f).to(dev)
                                       for f in params)),
                      STREAM_TENANTS, rank.rank == 2, False)
    if calls:
        checks.append(("per-stream ring", calls))
    del Xs, ys, fn
    torch.cuda.empty_cache()

    # (b) dense bf16 rows, ring (the dedup state), round by round
    X, y = svm_rows_device(L * per, d, seed=0, dtype=torch.bfloat16, **shard)
    fn = T.build_sharded_sweep_round(cfg, per, device=dev)
    fn.cfg = cfg
    params = _sweep_full_grid(T, cfg, s_dense)
    calls = by_rounds("dense-ring", fn, X, y,
                      T.SolverParams(*(torch.as_tensor(f).to(dev)
                                       for f in params)),
                      s_dense, rank.rank == 0, True)
    if calls:
        checks.append(("dense ring", calls))
    del X, y, fn
    torch.cuda.empty_cache()
    for what, calls in checks:
        tag = f"sharded-sweep-full {what} rank {rank.rank}"
        _solve_vs_plain(torch, ref, sp, calls["cd_solve"], tag)
        _hinge_vs_plain(torch, ref, calls["hinge_scores"], tag)
    return out


def _sweep_full_references(torch, T, s_dense, parts):
    """The functional references of ``[sharded-sweep-full]`` on the card,
    on the same rows made whole: (a) ``fit_mapreduce_sweep`` of the
    blocked-CSR rows, (b) / (c) ``rounds`` functional ``sweep_round``s
    of the dense rows at S = ``s_dense`` / of the 4 tenants' rows. Each
    part's rows are freed before the next."""
    from repro_torch.configs import SVM_TFIDF
    from repro_torch.data.pipeline import (svm_rows_device,
                                           svm_rows_sparse_device)
    from repro_torch.launch.sharded import SweepCase
    L, per, d = 8, SVM_TFIDF.rows_per_device, SVM_TFIDF.num_features
    want = {}
    if "sparse" in parts:
        X, y = svm_rows_sparse_device(L * per, d, SVM_TFIDF.nnz_cap, seed=0,
                                      nnz=SVM_TFIDF.nnz_cap,
                                      dtype=torch.bfloat16, device=DEV)
        cfg = _sweep_full_cfg(T, "sparse", "allgather")
        want["sparse"] = T.fit_mapreduce_sweep(
            X, y, L, cfg, _sweep_full_grid(T, cfg, SWEEP_FULL_S), device=DEV)
        del X, y
    cfg = _sweep_full_cfg(T, "dense", "allgather")
    if "stream" in parts:
        rows = [_stream_rows(torch, s, device=DEV)
                for s in range(STREAM_TENANTS)]
        n = rows[0][0].shape[0]
        Xs = torch.stack([r[0] for r in rows]).reshape(
            STREAM_TENANTS, L, n // L, d)
        ys = torch.stack([r[1] for r in rows]).reshape(STREAM_TENANTS, L,
                                                       n // L)
        del rows
        case = SweepCase("stream", cfg, None, None, T.stack_params(
            [cfg.svm.params()] * STREAM_TENANTS))
        want["stream"] = _sweep_raw_rounds(torch, T, Xs, ys.to(Xs.dtype),
                                           case, SWEEP_FULL_ROUNDS)
        del Xs, ys
    if "dense" in parts:
        X, y = svm_rows_device(L * per, d, seed=0, dtype=torch.bfloat16,
                               device=DEV)
        case = SweepCase("dense", cfg, None, None,
                         _sweep_full_grid(T, cfg, s_dense))
        want["dense"] = _sweep_raw_rounds(
            torch, T, X.reshape(L, per, d), y.to(X.dtype).reshape(L, per),
            case, SWEEP_FULL_ROUNDS)
        del X, y
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return want


def phase_sharded_sweep_full(torch, T):
    """``[sharded-sweep-full]``: the sharded sweep at svm-tfidf width on 8
    ranks × 8192 rows × d = 131072 sharing the card over gloo (a cut: one
    card), SWEEP_FULL_ROUNDS rounds: (a) blocked-CSR rows through
    ``fit_sharded_sweep``
    on ring and allgather (C = logspace(-2, 1, 4)); (b) dense bf16 rows
    on ring round by round, S = 4 (2 if S = 4 runs out of memory, then
    printed as a cut); (c) the per-stream wave at the service's width, 4
    tenants × (8192 + 2048) rows, ring. Held to the functional sweep on
    the same rows, run first here and freed before the spawn: each
    config's SV ids and α bit for bit every round on every rank (α in
    the state's dtype, bf16), risks within 1e-5 relative; one solve
    launch of S jobs a round on each rank. → launches by kernel row over
    the ranks."""
    import numpy as np
    from repro_torch import compat
    L = 8
    s_dense = SWEEP_FULL_S
    t0 = time.perf_counter()
    want = _sweep_full_references(torch, T, s_dense,
                                  ("sparse", "stream", "dense"))
    say(f"[sharded-sweep-full] the functional references: "
        f"{time.perf_counter() - t0:.1f} s; their rows freed")
    t0 = time.perf_counter()
    try:
        per_rank = compat.spawn(_sweep_full_rank, L,
                                (SWEEP_FULL_ROUNDS, s_dense), device="cuda",
                                timeout_s=600.0, join_timeout_s=900.0)
    except RuntimeError as e:
        if "out of memory" not in str(e):
            raise
        s_dense = 2
        say(f"[sharded-sweep-full] CUT: the dense sweep at S = "
            f"{SWEEP_FULL_S} ran out of memory on a rank; again at S = 2")
        torch.cuda.empty_cache()
        want.update(_sweep_full_references(torch, T, s_dense, ("dense",)))
        t0 = time.perf_counter()
        per_rank = compat.spawn(_sweep_full_rank, L,
                                (SWEEP_FULL_ROUNDS, s_dense), device="cuda",
                                timeout_s=600.0, join_timeout_s=900.0)
    say(f"[sharded-sweep-full] 8 ranks × 4 parts in "
        f"{time.perf_counter() - t0:.1f} s (the spawn and each rank's rows "
        f"included); dense S = {s_dense}")
    routes = {}
    for r in per_rank:
        for part in r["routes"].values():
            for k, v in part.items():
                routes[k] = routes.get(k, 0) + v
    # (a): each rank against the functional sweep; ring ≡ allgather
    fa = want["sparse"]
    for impl in ("ring", "allgather"):
        for r, res in enumerate(per_rank):
            got = dict(res["parts"][f"sparse-{impl}"])
            got["sv"] = T.SVBuffer(None, None, got["alpha"], got["ids"],
                                   None)
            _sweep_vs_functional(got, fa, f"sharded-sweep-full blocked-CSR "
                                 f"{impl} rank {r}")
        solves = [res["routes"][f"sparse-{impl}"].get("cd_solve/sparse", 0)
                  for res in per_rank]
        n = len(per_rank[0]["parts"][f"sparse-{impl}"]["history"])
        check(solves == [n] * L, f"[sharded-sweep-full] blocked-CSR {impl}: "
              f"solve launches by rank {solves}, not one a round ({n})")
    a, b = (per_rank[0]["parts"][f"sparse-{i}"] for i in ("ring",
                                                          "allgather"))
    check(_same_np(a["ids"], b["ids"]) and _same_np(a["alpha"], b["alpha"])
          and np.allclose(a["risks"], b["risks"], rtol=1e-6, atol=0),
          "[sharded-sweep-full] blocked-CSR ring differs from allgather")
    # (b), (c): every round on every rank against the functional rounds
    worst = 0.0
    for part, key in (("dense-ring", "dense"), ("stream-ring", "stream")):
        for r, res in enumerate(per_rank):
            got = res["parts"][part]
            worst = max(worst, _raw_vs_functional(
                [{"ids": i, "alpha": al, "risks": rk} for i, al, rk in
                 zip(got["ids"], got["alpha"], got["risks"])], want[key],
                f"sharded-sweep-full {part} rank {r}"))
            solves = sum(v for k, v in res["routes"][part].items()
                         if k in ("cd_solve/cluster", "cd_solve/single"))
            check(solves == SWEEP_FULL_ROUNDS,
                  f"[sharded-sweep-full] {part} rank {r}: {solves} solve "
                  f"launches in {SWEEP_FULL_ROUNDS} rounds")
    for part, r0 in per_rank[0]["parts"].items():
        keys = ("round_ms", "solve_ms", "merge_ms", "eq7_ms")
        if isinstance(r0["round_ms"], list):
            for t in range(SWEEP_FULL_ROUNDS):
                split = {k: [round(res["parts"][part][k][t], 1)
                             for res in per_rank] for k in keys}
                say(f"[sharded-sweep-full] {part} round {t}: ms by rank "
                    + json.dumps(split))
        else:
            split = {k: [round(res["parts"][part][k], 1)
                         for res in per_rank] for k in keys}
            say(f"[sharded-sweep-full] {part} (rounds {r0['rounds']}, "
                f"R_emp {np.round(r0['risks'], 6).tolist()}, acc on rank "
                f"0's shard {np.round(r0['acc'], 4).tolist()}): mean ms a "
                "round by rank " + json.dumps(split))
        say(f"[sharded-sweep-full] {part}: a rank ships "
            f"{r0['sent_bytes'] / 1e6:.2f} MB a round "
            f"({r0['msg_bytes'] / 1e6:.3f} MB a message, "
            f"{r0['rows_bytes'] / 1e6:.3f} MB of it feature rows); peak "
            "memory by rank (GB) "
            + json.dumps([round(res['peak'][part] / 1e9, 3)
                          for res in per_rank]))
    rows = _row_launches(routes)
    say(f"[sharded-sweep-full] every config's SV ids and α bit for bit "
        f"with the functional sweep on every rank every round, risks "
        f"within 1e-5 (max rel {worst:.2e}); launches over the 8 ranks: "
        f"routes {routes}, by kernel row {rows}")
    check(rows.get("cd_solve", 0) > 0 and rows.get("cd_solve/sparse", 0) > 0
          and rows.get("hinge_scores", 0) > 0
          and rows.get("hinge_scores/sparse", 0) > 0,
          f"[sharded-sweep-full] launches {rows}")
    return rows


# ---------------------------------------------------------------------------
# slice 14: cluster launch (N OS processes × k ranks, the coordinator's store)
# ---------------------------------------------------------------------------

CLUSTER_PROCS, CLUSTER_LOCAL = 2, 4
CLUSTER_FULL_ROUNDS = 2


def _cluster_launch(module, args, out, timeout_s):
    """``module`` as CLUSTER_PROCS processes of one cluster (CLUSTER_LOCAL
    ranks each, sharing the card), logs in ``out``. → (return codes, the
    logs, the epoch second before the first process started)."""
    from repro_torch.launch import multihost as mh
    t0 = time.time()
    procs = mh.launch(module, CLUSTER_PROCS, CLUSTER_LOCAL, args,
                      log_dir=out)
    rcs = mh.wait_all(procs, timeout_s)
    logs = [Path(out, f"p{i}.log").read_text() for i in range(CLUSTER_PROCS)]
    return rcs, logs, t0


def _tails(logs, n=3000):
    return "\n".join(f"--- process {i} ---\n{log[-n:]}"
                     for i, log in enumerate(logs))


def _no_rank_alive(pids, tag):
    """Every pid in ``pids`` is gone within 10 s (a rank dies with its
    process)."""
    from repro_torch.launch import multihost as mh
    deadline = time.monotonic() + 10.0
    while mh.alive(pids) and time.monotonic() < deadline:
        time.sleep(0.2)
    check(not mh.alive(pids), f"[{tag}] ranks {mh.alive(pids)} outlived "
          "their process")


def phase_cluster_small(torch, T):
    """``[cluster-small]``: the package's multi-process harness
    (``repro_torch.launch.multihost``, the reference's mp_worker.py) as
    2 OS processes × 4 ranks sharing the card over gloo, joined through
    ``init_cluster`` and process 0's TCP store. Launch A: the sharded
    round on allgather, ring and hier (2 hosts, counted from the
    processes) on dense and blocked-CSR rows (512 × 16, cap 8), 3 rounds,
    each held to the port's functional ``mapreduce_round`` on the card
    (SV ids and mask equal, α and risks within 1e-4 / 1e-5), then the
    dedup-ring sweep until process 1 SIGKILLs itself after round 1:
    process 0 must exit 17 (watchdog or detected peer loss, a typed
    heartbeat) and the newest generation be round 1. Launch B: a flaky
    handshake absorbed, the resume bit for bit from the newest
    generation and, after its medium is corrupted, from the one before.
    No rank may outlive its process. → launches by kernel row of the
    round legs on rank 0."""
    import pickle
    import shutil
    import tempfile
    import numpy as np
    from repro_torch.ckpt.checkpoint import latest_step
    from repro_torch.data.pipeline import svm_rows
    from repro_torch.launch import multihost as mh
    out = tempfile.mkdtemp(prefix="cluster_small_")
    try:
        t0 = time.perf_counter()
        rcs, logs, _ = _cluster_launch(
            "repro_torch.launch.multihost",
            ["--out", out, "--legs", "rounds,crash", "--device", DEV],
            out, 600)
        secs_a = time.perf_counter() - t0
        check(rcs == [17, -9], f"[cluster-small] launch A exited {rcs}, "
              f"not [17, -9]:\n{_tails(logs)}")
        check("transport" in logs[0], "[cluster-small] process 0's log "
              "does not name the transport")
        _no_rank_alive(mh.rank_pids(out), "cluster-small")
        ckpt = os.path.join(out, "ckpt")
        hb = {p.name: json.loads(p.read_text())["status"]
              for p in Path(ckpt).glob("hb_r*.json")}
        p0 = [hb.get(f"hb_r{r}.json") for r in range(CLUSTER_LOCAL)]
        check({"detected", "timeout"} & set(p0), f"[cluster-small] no "
              f"typed heartbeat on process 0's ranks: {p0}")
        check(latest_step(ckpt) == 1, f"[cluster-small] newest generation "
              f"{latest_step(ckpt)}, not round 1")
        with open(os.path.join(out, "rounds.pkl"), "rb") as f:
            rounds = pickle.load(f)
        Xf, yf = svm_rows(mh.N_ROWS, mh.D, seed=mh.SEED)
        want = _functional_rounds(torch, T, torch.from_numpy(Xf).to(DEV),
                                  torch.from_numpy(yf).to(DEV), 8,
                                  mh._cfg("allgather"), 3)
        worst = 0.0
        for case in (f"{f}-{i}" for f in ("dense", "sparse")
                     for i in ("allgather", "ring", "hier")):
            worst = max(worst, _hold_to_functional(
                [{"cases": [rounds[case]]}], 0, want,
                f"cluster-small {case}"))
        check(rounds["hosts"] == 2, f"[cluster-small] hier counted "
              f"{rounds['hosts']} hosts, not the 2 processes")
        routes = _row_launches(rounds["routes"])
        check(all(routes.get(k, 0) > 0 for k in (
            "cd_solve", "hinge_scores", "cd_solve/sparse",
            "hinge_scores/sparse")),
            f"[cluster-small] rank 0's round legs launched {routes}")
        say(f"[cluster-small] launch A (6 round legs × 3 rounds, then the "
            f"killed sweep) {secs_a:.1f} s: exits {rcs}, heartbeats of "
            f"process 0's ranks {p0}, newest generation 1; every round ≡ "
            f"the functional round on the card (max |Δ risk| {worst:.2e}), "
            f"hier over 2 hosts; rank 0's launches {routes}")
        for p in Path(out).glob("pid_r*"):
            p.unlink()
        t0 = time.perf_counter()
        rcs, logs, _ = _cluster_launch(
            "repro_torch.launch.multihost",
            ["--out", out, "--legs", "resume", "--device", DEV], out, 600)
        secs_b = time.perf_counter() - t0
        check(rcs == [0, 0] and all("MP_OK resume" in x
                                     and "absorbed by the retry" in x
                                     for x in logs),
              f"[cluster-small] launch B exited {rcs}:\n{_tails(logs)}")
        _no_rank_alive(mh.rank_pids(out), "cluster-small")
        results = []
        for i in range(CLUSTER_PROCS):
            with open(os.path.join(out, f"result_p{i}.pkl"), "rb") as f:
                results += pickle.load(f)
        check(len(results) == 8 and all(
            r["resume"] == {"newest": 1, "fallback": 0, "leaves": 8}
            and r["modules"] == [] and r["process_count"] == 2
            for r in results), f"[cluster-small] resume leg: {results}")
        res_routes = {}
        for r in results:
            for k, v in r["routes"].items():
                res_routes[k] = res_routes.get(k, 0) + v
        say(f"[cluster-small] launch B {secs_b:.1f} s: the flaky handshake "
            "absorbed on both processes, the sweep resumed after round 1 "
            "and, past the corrupted newest generation, after round 0, "
            "each ≡ the uninterrupted run bit for bit (8 leaves); "
            f"launches over the 8 ranks {_row_launches(res_routes)}; no "
            "rank outlived its process")
        return routes
    finally:
        shutil.rmtree(out, ignore_errors=True)


def _cluster_ref_rank(rank, jobs):
    """``[cluster-full]``'s reference on one rank of a plain spawn: each
    train job as ``launch.train`` runs it on a rank, the memory of one
    returned to the card before the next (8 ranks at S = 4 take 58 of
    its 80 GB)."""
    import gc
    import torch
    from repro_torch.launch import train
    out = []
    for job in jobs:
        out.append(train.train_rank(rank, job))
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _same_train_record(got, want, sweep, tag):
    """A cluster rank's train record ≡ the spawn rank's: SV ids and α bit
    for bit (each round's, or the sweep's converged buffers), rounds and
    the pick equal, risks within 1e-6 relative."""
    import numpy as np

    def close(a, b):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        return a.shape == b.shape and np.allclose(a, b, rtol=1e-6, atol=0)
    if sweep:
        g, w = got["sweep"], want["sweep"]
        check(g["ids"] == w["ids"] and np.array_equal(
            np.asarray(g["alpha"], np.float32),
            np.asarray(w["alpha"], np.float32)),
            f"[{tag}] SV ids or α differ from the spawn's")
        check(g["rounds"] == w["rounds"] and g["best"] == w["best"]
              and len(g["history"]) == len(w["history"])
              and all(close(a, b) for a, b in zip(g["history"],
                                                  w["history"])),
              f"[{tag}] rounds, pick or risks differ from the spawn's")
        return
    g, w = got["rounds"], want["rounds"]
    check(len(g) == len(w), f"[{tag}] {len(g)} rounds, the spawn {len(w)}")
    for t, (a, b) in enumerate(zip(g, w)):
        check(a["ids"] == b["ids"] and np.array_equal(
            np.asarray(a["alpha"], np.float32),
            np.asarray(b["alpha"], np.float32)),
            f"[{tag}] round {t}: SV ids or α differ from the spawn's")
        check(close(a["risk"], b["risk"]) and a["sv"] == b["sv"],
              f"[{tag}] round {t}: R_emp or |SV| differ from the spawn's")


def phase_cluster_full(torch, T):
    """``[cluster-full]``: ``python -m repro_torch.launch.train --arch
    svm-tfidf --rounds 2`` as 2 OS processes × 4 ranks sharing the card
    over gloo (``--coordinator 127.0.0.1:<port> --num-processes 2
    --process-id {0,1} --local-devices 4``): full width, 8 × 8192 ×
    131072 bf16 rows, ring, each rank making only its rows; then the same
    launch with ``--sweep 4``. Each is held to the same computation
    through ``compat.spawn`` (one process, 8 ranks, run first here): each
    round's SV ids and α (the sweep's converged buffers, rounds and pick)
    bit for bit on every rank, risks within 1e-6. Prints each rank's
    time from its process's start to round 0, each process's handshake,
    the round ms split into solve, merge and eq. 7, the MB a rank ships a
    round, each rank's peak memory and the launches by route. → launches
    by kernel row over both launches' ranks."""
    import shutil
    import tempfile
    import numpy as np
    from repro_torch import compat
    from repro_torch.configs import SVM_TFIDF
    from repro_torch.launch import multihost as mh
    from repro_torch.launch import train
    L, per, d = 8, SVM_TFIDF.rows_per_device, SVM_TFIDF.num_features

    jobs = {mode: train.svm_job(SVM_TFIDF, L, rounds=CLUSTER_FULL_ROUNDS,
                                sweep=S)
            for mode, S in (("plain", 0), ("sweep", SWEEP_FULL_S))}
    t0 = time.perf_counter()
    per_rank = compat.spawn(_cluster_ref_rank, L, (list(jobs.values()),),
                            device=DEV, timeout_s=600.0, join_timeout_s=900.0)
    refs = {mode: (job, [r[i] for r in per_rank])
            for i, (mode, job) in enumerate(jobs.items())}
    say(f"[cluster-full] the reference: both runs through compat.spawn, 8 "
        f"ranks of one process, in {time.perf_counter() - t0:.1f} s; peak "
        "memory by rank (GB) " + json.dumps(
            {mode: [round((r["peak_bytes"] or 0) / 1e9, 3) for r in ref]
             for mode, (_, ref) in refs.items()}))
    meta = torch.zeros((per, d), dtype=torch.bfloat16, device="meta")
    routes = {}
    out = tempfile.mkdtemp(prefix="cluster_full_")
    try:
        for mode, (job, ref) in refs.items():
            S, tag = job.sweep, f"cluster-full {mode}"
            report = os.path.join(out, f"{mode}.json")
            t0 = time.perf_counter()
            rcs, logs, t_launch = _cluster_launch(
                "repro_torch.launch.train",
                ["--arch", "svm-tfidf", "--rounds", str(CLUSTER_FULL_ROUNDS),
                 "--split-ms", "--report", report, "--device", DEV]
                + (["--sweep", str(S)] if S else []), out, 900)
            secs = time.perf_counter() - t0
            check(rcs == [0, 0], f"[{tag}] exited {rcs}:\n{_tails(logs)}")
            rep = json.load(open(report))
            ranks = rep["ranks"]
            check([r["rank"] for r in ranks] == list(range(L))
                  and [r["process"] for r in ranks] == [0] * 4 + [1] * 4,
                  f"[{tag}] ranks {[(r['rank'], r['process']) for r in ranks]}")
            for r in range(L):
                _same_train_record(ranks[r], ref[r], S, f"{tag} rank {r}")
            _no_rank_alive([r["pid"] for r in ranks], tag)
            cfg = job.cfg
            k = cfg.sv_capacity // L
            if S:
                msg, rows_b = _msg_bytes(T, meta, cfg, S, L, True)
            else:
                lanes = k * (d // 2) + 4 * k + d + 1
                msg, rows_b = 4 * lanes, 4 * k * (d // 2)
            keys = ("ms", "solve_ms", "merge_ms", "eq7_ms")
            if S:
                split = {kk: [round(r["sweep"]["round_ms" if kk == "ms"
                                               else kk], 1) for r in ranks]
                         for kk in keys}
                first = ranks[0]["sweep"]
                say(f"[{tag}] rounds {first['rounds']}, R_emp "
                    f"{np.round(first['risks'], 6).tolist()}, selected C = "
                    f"{first['C'][first['best']]:.4g}; mean ms a round by "
                    f"rank {json.dumps(split)}")
            else:
                for t in range(len(ranks[0]["rounds"])):
                    split = {kk: [round(r["rounds"][t][kk], 1)
                                  for r in ranks] for kk in keys}
                    say(f"[{tag}] round {t}: R_emp "
                        f"{ranks[0]['rounds'][t]['risk']:.6f}, |SV| "
                        f"{ranks[0]['rounds'][t]['sv']}; ms by rank "
                        + json.dumps(split))
            say(f"[{tag}] launch {secs:.1f} s; process start → round 0 by "
                "rank (s) "
                + json.dumps([round(r["first_round_at"] - t_launch, 2)
                              for r in ranks])
                + "; handshake ms by process "
                + json.dumps([round(ranks[p * 4]["handshake_ms"], 1)
                              for p in range(CLUSTER_PROCS)])
                + f"; a rank ships {(L - 1) * msg / 1e6:.2f} MB a round "
                f"({msg / 1e6:.3f} MB a message, {rows_b / 1e6:.3f} MB of "
                "it feature rows); peak memory by rank (GB) "
                + json.dumps([round((r["peak_bytes"] or 0) / 1e9, 3)
                              for r in ranks]))
            rows = _row_launches(rep["routes"])
            say(f"[{tag}] SV ids and α bit for bit with the spawn on every "
                f"rank; launches over the 8 ranks: routes {rep['routes']}, "
                f"by kernel row {rows}")
            check(rows.get("cd_solve", 0) > 0
                  and rows.get("hinge_scores", 0) > 0,
                  f"[{tag}] launches {rows}")
            for kk, v in rows.items():
                routes[kk] = routes.get(kk, 0) + v
    finally:
        shutil.rmtree(out, ignore_errors=True)
    return routes


def _fd_variant(chunk, warps, stages, l2_hint=True):
    edits = [(f"    FD_TC_CASE({hd})\n", "")      # hd 64 only: a quick build
             for hd in (16, 32, 48, 80, 96, 112, 128)]
    edits += [("kChunkTc = 4096;", f"kChunkTc = {chunk};"),
              ("kWarps = 8;", f"kWarps = {warps};"),
              ("kStages = 4;", f"kStages = {stages};")]
    return edits + ([] if l2_hint else [(".L2::256B", "")])


FD_VARIANTS = {
    f"chunk {ch}, warps {wp}, stages {st}, L2 hint {hint}": _fd_variant(
        ch, wp, st, hint)
    for ch, wp, st in ((2048, 8, 4), (4096, 4, 4), (4096, 8, 3),
                       (4096, 8, 4), (8192, 8, 4), (8192, 16, 3))
    for hint in (True, False)}
FD_VARIANTS["chunk 4096, warps 8, stages 4, combine not a dependent"] = \
    _fd_variant(4096, 8, 4) + [(
        "programmaticStreamSerializationAllowed = 1;",
        "programmaticStreamSerializationAllowed = 0;")]
CD_VARIANTS = {st: [("kStages = 4;", f"kStages = {st};")] for st in (2, 3, 4)}
# cd_solve/sparse: the look-ahead depth k (gathers issued k row steps
# early), the producer's slack (rows staged k + slack steps early) and the
# prep kernel's warps a CTA; then a step with one part taken out, for
# timing only (each computes another function, so Δ, and with it the
# stores, can differ): no gather of w (the chain's floor: every w read
# is 0), no α gather (α read as 0), no stores of w, no corrections
CDS_VARIANTS = {f"look-ahead {k}": [("kAhead = 2;", f"kAhead = {k};")]
                for k in (1, 2, 3, 4, 6)}
CDS_VARIANTS.update({
    f"staging slack {st}": [("kStageAhead = 6;", f"kStageAhead = {st};")]
    for st in (2, 10)})
CDS_VARIANTS.update({
    f"prep: {pw} warps a CTA": [("kPrepWarps = 8;", f"kPrepWarps = {pw};")]
    for pw in (4, 16)})
CDS_VARIANTS.update({
    "no gather (chain floor)": [
        ("              __int_as_float(e.y) != 0.f);\n",
         "              false);\n")],
    "no α gather (α read as 0)": [("cp4(agath + ring, aj + row, true);",
                                   "cp4(agath + ring, aj + row, false);")],
    "no stores of w": [("        if (delta != 0.f) {\n",
                        "        if (false) {\n")],
    "no corrections": [
        ("      x[j] = back != 0 && back <= h ? fixed : x[j];\n", "")],
})
# timing only: no scattered global access in the step (no gather issued,
# so the reads are stale shared memory; no stores of w)
_CDS_NO_SCATTER = [
    ("        cp16z(gathered + ring * kSpt * T + s, wq + (size_t)e.x * ldw,\n"
     "              __int_as_float(e.y) != 0.f);\n", "        ;\n"),
    ("        if (delta != 0.f) {\n", "        if (false) {\n")]
# clock64() around the step's parts, averaged over the steps and written
# over α[0:8] of each job: thread 0 (a consumer) and the producer's
# copier, each [barrier wait, update, next step's part before its
# barrier, stores + gathers (copier: staging)]
_CDS_CYCLES = [
    ("  const bool run = n > 0 && max_epochs > 0;\n",
     "  const bool run = n > 0 && max_epochs > 0;\n"
     "  long long cyc[4] = {0, 0, 0, 0};\n"),
    ("    for (int i = 0; i < n; ++i, ++g) {\n      __syncthreads();\n",
     "    for (int i = 0; i < n; ++i, ++g) {\n"
     "      const long long c0 = clock64();\n      __syncthreads();\n"
     "      const long long c1 = clock64();\n"),
    ("      coef_back[1] = coef;\n",
     "      coef_back[1] = coef;\n      const long long c2 = clock64();\n"
     "      long long c3 = c2;\n"),
    ("        pre(g + 1, st_n, rg_n, k == 1 ? 0 : k - 2);\n",
     "        pre(g + 1, st_n, rg_n, k == 1 ? 0 : k - 2);\n"
     "        c3 = clock64();\n"),
    ("      row_s = ring_next(row_s, n);\n",
     "      const long long c4 = clock64();\n      cyc[0] += c1 - c0;\n"
     "      cyc[1] += c2 - c1;\n      cyc[2] += c3 - c2;\n"
     "      cyc[3] += c4 - c3;\n      row_s = ring_next(row_s, n);\n"),
    ("  if (tid == 0) {\n    b_out[job] = b;",
     "  if (tid == 0 || copier)\n    for (int q = 0; q < 4; ++q)\n"
     "      aj[q + (copier ? 4 : 0)] = (float)cyc[q] / (float)g;\n"
     "  if (tid == 0) {\n    b_out[job] = b;")]
CDS_VARIANTS.update({
    f"{w} consumer warps": [("kMaxWarps = 8;", f"kMaxWarps = {w};"),
                            ("kMaxSpt = 2;", f"kMaxSpt = {512 // (32 * w)};")]
    for w in (2, 4)})
CDS_VARIANTS["no gathers and no stores (timing only)"] = _CDS_NO_SCATTER
CDS_VARIANTS["cycle breakdown (α overwritten)"] = _CDS_CYCLES
CDS_VARIANTS["cycle breakdown, no gathers and no stores"] = \
    _CDS_NO_SCATTER + _CDS_CYCLES


def _variant_libs(build, name, variants):
    """A copy of ``csrc/<name>.cu`` per variant with its replacements
    (each old text must occur once), one nvcc each, all started
    together. → {key: loaded library}."""
    import ctypes
    src = (build.CSRC / f"{name}.cu").read_text()
    out_dir = build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (key, edits) in enumerate(variants.items()):
        text = src
        for old, new in edits:
            check(text.count(old) == 1, f"{name}.cu variant {key}: "
                  f"{old!r} does not occur once")
            text = text.replace(old, new)
        cu = out_dir / f"{name}_{i}.cu"
        cu.write_text(text)
        procs[key] = (cu.with_suffix(".so"), subprocess.Popen(
            [build.nvcc(), *build.NVCC_FLAGS, "-o", str(cu.with_suffix(".so")),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs = {}
    for key, (so, proc) in procs.items():
        log = proc.communicate()[0]
        check(proc.returncode == 0, f"{name}.cu variant {key} did not "
              f"build:\n{log}")
        libs[key] = ctypes.CDLL(str(so))
    return libs


def phase_variants(torch, build, ops, ref, chosen):
    """flash_decode's tensor-core route at one layer's full shape (B 32,
    H 32, KV 4, S = valid_len = 32768, hd 64 bf16) per variant, checked
    against plain and timed in turns with scaled_dot_product_attention;
    one epoch of cd_solve's round 0 at full width on clusters of 8 and
    16 per ring depth, its hinge risk against the shipped build's; each
    when ``chosen`` names it."""
    import importlib
    from repro_torch.data.pipeline import svm_rows_device
    fd = importlib.import_module("repro_torch.kernels.decode_attention")
    dev = torch.device(DEV)
    fd_libs = _variant_libs(build, "flash_decode", FD_VARIANTS) \
        if "flash_decode" in chosen else {}
    cd_libs = _variant_libs(build, "cd_solve", CD_VARIANTS) \
        if "cd_solve" in chosen else {}
    shipped, stages0 = dict(build._LIBS), ops.CLUSTER_STAGES
    gen = torch.Generator(device=dev).manual_seed(0)
    B, H, KV, S, hd = 32, 32, 4, 32768, 64
    k = (KEY_SCALE * torch.randn((B, KV, S, hd), generator=gen, device=dev)
         ).to(torch.bfloat16)
    v = torch.randn((B, KV, S, hd), generator=gen, device=dev
                    ).to(torch.bfloat16)
    q = (torch.randn((B, H, hd), generator=gen, device=dev) / KEY_SCALE
         ).to(torch.bfloat16)
    valid = torch.tensor(S, dtype=torch.int32, device=dev)
    plain = ref.decode_attention_ref(q, k, v, valid)
    mask = torch.ones((1, 1, 1, S), dtype=torch.bool, device=dev)
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
        q[:, :, None], k, v, attn_mask=mask, enable_gqa=True)
    kern = lambda: fd.launch_flash_decode(q, k, v, valid,  # noqa: E731
                                          "tensor_core")
    try:
        for key, lib in fd_libs.items():
            build._LIBS["flash_decode"] = lib
            rel = _rel_max(kern(), plain)
            check(rel <= FD_TOL["bfloat16"], f"flash_decode variant {key} "
                  f"differs from plain by {rel:.2e}")
            t = [cuda_ms(torch, f, 50) for f in (kern, sdpa, sdpa, kern) * 2]
            say(f"[variants] flash_decode {key}: kernel "
                f"{sum(t[0::4] + t[3::4]) / 4:.4f} ms, SDPA "
                f"{sum(t[1::4] + t[2::4]) / 4:.4f} ms (turns "
                f"{[round(x, 4) for x in t]}), max|Δ|/max|plain| {rel:.2e}")
        del k, v
        torch.cuda.empty_cache()
        L, per, cap, d = 8, 8192, 2048, 131072
        X, y = svm_rows_device(L * per, d, seed=0, dtype=torch.bfloat16,
                               device=DEV)
        y = y.float()
        xs = torch.zeros((cap, d), dtype=torch.bfloat16, device=dev)
        y_aug = torch.cat([y.reshape(L, per), torch.zeros((L, cap),
                                                          device=dev)], 1)
        m_aug = torch.cat([torch.ones((L, per), device=dev),
                           torch.zeros((L, cap), device=dev)], 1)
        args = (X.reshape(L, per, d), xs, y_aug.contiguous(),
                m_aug.contiguous())
        kw = dict(C=1.0, tol=1e-3, max_epochs=1)

        def risk(out):        # each job's hinge risk over all rows
            return ref.hinge_scores_ref(X, out[1], out[2], y,
                                        torch.ones_like(y))[0] / len(y)

        for c in (8, 16) if cd_libs else ():
            base = risk(_cd_run(ops, args, kw, c))
            for stages, lib in cd_libs.items():
                build._LIBS["cd_solve"] = lib
                ops.CLUSTER_STAGES = stages
                err = float((risk(_cd_run(ops, args, kw, c)) - base).abs()
                            .max())
                check(err <= 1e-4, f"cd_solve ring depth {stages} c={c}: "
                      f"risk differs by {err:.2e}")
                ms = cuda_ms(torch, lambda: _cd_run(ops, args, kw, c), 3)
                say(f"[variants] cd_solve ring depth {stages}, c={c}: "
                    f"{ms:.3f} ms an epoch, risk |Δ| {err:.2e}")
    finally:
        build._LIBS.clear()
        build._LIBS.update(shipped)
        ops.CLUSTER_STAGES = stages0


def phase_sparse_variants(torch, T, build, ops, ref):
    """One epoch of cd_solve/sparse's round 0 at full width ([full-sparse]
    rows: 8 jobs × (8192 + 2048) slots of nnz_cap 256, bf16) per
    CDS_VARIANTS entry through the shipped launcher, in turns with the
    shipped build; each variant's hinge risk against the shipped build's
    (the no-gather floor excepted: it computes another function)."""
    from repro_torch.configs import SVM_TFIDF
    from repro_torch.data.pipeline import svm_rows_sparse_device
    from repro_torch.kernels import svm_step
    libs = _variant_libs(build, "cd_solve_sparse", CDS_VARIANTS)
    svm_step._sparse_lib()                       # the shipped build, loaded
    shipped = dict(build._LIBS)
    ahead0 = svm_step.SPARSE_AHEAD, svm_step.SPARSE_MAX_WARPS
    L, per, d = 8, SVM_TFIDF.rows_per_device, SVM_TFIDF.num_features
    cap, S = SVM_TFIDF.nnz_cap, SVM_TFIDF.sv_capacity
    X, y = svm_rows_sparse_device(L * per, d, cap, seed=0, nnz=cap,
                                  dtype=torch.bfloat16, device=DEV)
    xs = T.init_sv_buffer(S, d, X.dtype, DEV, nnz_cap=cap).x   # round 0
    y = y.float()
    y_aug = torch.cat([y.reshape(L, per), torch.zeros((L, S), device=DEV)],
                      1).contiguous()
    m_aug = torch.cat([torch.ones((L, per), device=DEV),
                       torch.zeros((L, S), device=DEV)], 1).contiguous()
    args = (X.reshape(L, per, d), xs, y_aug, m_aug)
    kw = dict(C=1.0, tol=1e-3, max_epochs=1)
    n = per + S

    def risk(out):
        return ref.hinge_scores_ref(X, out[1], out[2], y,
                                    torch.ones_like(y))[0] / len(y)

    def run():
        return ops.cd_solve(*args, **kw)

    try:
        base = risk(run())
        prep = cuda_ms(torch, lambda: ops.cd_solve(*args, **dict(
            kw, max_epochs=0)), 5)
        for key, lib in libs.items():
            build._LIBS["cd_solve_sparse"] = lib
            svm_step.SPARSE_AHEAD = lib.cd_solve_sparse_ahead()
            svm_step.SPARSE_MAX_WARPS = lib.cd_solve_sparse_max_warps()
            out = run()
            err = float((risk(out) - base).abs().max())
            if "cycle" in key:
                cyc = [round(c, 1) for c in out[0][0, :8].tolist()]
                say(f"[variants] cd_solve/sparse {key}, cycles a step, job 0:"
                    f" thread 0 {cyc[:4]}, copier {cyc[4:]}")
            prep_v = cuda_ms(torch, lambda: ops.cd_solve(*args, **dict(
                kw, max_epochs=0)), 3)
            if key.startswith(("look-ahead", "prep:", "staging")) or \
                    key.endswith("consumer warps"):
                check(err <= 1e-4, f"cd_solve/sparse variant {key}: risk "
                      f"differs by {err:.2e}")
            t = []
            for which in (lib, shipped["cd_solve_sparse"]) * 2:
                build._LIBS["cd_solve_sparse"] = which
                svm_step.SPARSE_AHEAD = which.cd_solve_sparse_ahead()
                svm_step.SPARSE_MAX_WARPS = which.cd_solve_sparse_max_warps()
                t.append(cuda_ms(torch, run, 3))
            build._LIBS["cd_solve_sparse"] = shipped["cd_solve_sparse"]
            svm_step.SPARSE_AHEAD, svm_step.SPARSE_MAX_WARPS = ahead0
            ms = (t[0] + t[2]) / 2
            say(f"[variants] cd_solve/sparse {key}: {ms:.3f} ms a one-epoch "
                f"call, {1e3 * (ms - prep) / n:.3f} µs a row step (shipped "
                f"{(t[1] + t[3]) / 2:.3f} ms in turns; the 0-epoch call "
                f"{prep_v:.3f} ms, shipped {prep:.3f}), risk |Δ| {err:.2e}")
    finally:
        build._LIBS.clear()
        build._LIBS.update(shipped)
        svm_step.SPARSE_AHEAD, svm_step.SPARSE_MAX_WARPS = ahead0


VARIANT_PHASES = ("flash_decode", "cd_solve", "cd_solve_sparse")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="stop after the pipeline phase; print no result")
    ap.add_argument("--variants", nargs="*", choices=VARIANT_PHASES,
                    help="time build variants of these kernels (all three "
                    "when none is named) after the kernel build; print no "
                    "result")
    ap.add_argument("--sharded", action="store_true",
                    help="run only the sharded round's and sweep's "
                    "phases ([sharded-small] with [sharded-sweep-small], "
                    "[sharded-full], [sharded-sweep-full]) after the "
                    "kernel build; print no result")
    ap.add_argument("--cluster", action="store_true",
                    help="run only the cluster launch's phases "
                    "([cluster-small], [cluster-full]) after the kernel "
                    "build; print no result")
    ap.add_argument("--tp", action="store_true",
                    help="run only [tp-serve-full] after the kernel build; "
                    "print no result")
    ap.add_argument("--dryrun", action="store_true",
                    help="run only [dryrun] after the kernel build; print "
                    "no result")
    ap.add_argument("--models", action="store_true",
                    help="run only flash_decode's small shapes and the LM "
                    "configs at full width ([model-full], [serve-full], "
                    "[embed-full], [train-full], [train-backbone]) after "
                    "the kernel build; print no result")
    args = ap.parse_args()

    import torch
    import repro_torch.core as T
    from repro_torch import sparse as sp
    from repro_torch import text
    from repro_torch.kernels import build, ops, ref

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    t_all = time.perf_counter()
    laps = [t_all]

    def lap(label):
        """Seconds since the previous lap, and since the start."""
        now = time.perf_counter()
        say(f"[time] {label}: {now - laps[-1]:.1f} s (at {now - t_all:.1f} s)")
        laps.append(now)
    phase_environment(torch, build)
    lap("[env] and the kernel build")
    if args.variants is not None:
        chosen = args.variants or VARIANT_PHASES
        if {"flash_decode", "cd_solve"} & set(chosen):
            phase_variants(torch, build, ops, ref, chosen)
        if "cd_solve_sparse" in chosen:
            phase_sparse_variants(torch, T, build, ops, ref)
        say(f"[variants] done in {time.perf_counter() - t_all:.1f} s; "
            f"{nvidia_smi()}; no result")
        return 0
    if args.sharded:
        phase_sharded_small(torch, T, text)
        say(f"[sharded-full] launches by kernel row "
            f"{phase_sharded_full(torch, T)}")
        torch.cuda.empty_cache()
        say(f"[sharded-sweep-full] launches by kernel row "
            f"{phase_sharded_sweep_full(torch, T)}")
        say(f"[sharded] done in {time.perf_counter() - t_all:.1f} s; "
            f"{nvidia_smi()}; no result")
        return 0
    if args.dryrun:
        phase_dryrun(torch, ops, ref)
        say(f"[dryrun-only] done in {time.perf_counter() - t_all:.1f} s; "
            f"{nvidia_smi()}; no result")
        return 0
    if args.tp:
        phase_tp_serve(torch, ops, ref)
        say(f"[tp] done in {time.perf_counter() - t_all:.1f} s; "
            f"{nvidia_smi()}; no result")
        return 0
    if args.models:
        phase_decode_small(torch, ops, ref)
        for arch, batch, cache_len in MODEL_CELLS:
            phase_model_full(torch, T, ops, ref, arch, batch, cache_len)
        phase_train(torch, ops)
        say(f"[models] done in {time.perf_counter() - t_all:.1f} s; "
            f"{nvidia_smi()}; no result")
        return 0
    if args.cluster:
        phase_cluster_small(torch, T)
        say(f"[cluster-full] launches by kernel row "
            f"{phase_cluster_full(torch, T)}")
        say(f"[cluster] done in {time.perf_counter() - t_all:.1f} s; "
            f"{nvidia_smi()}; no result")
        return 0
    phase_kernels_small(torch, ops, ref)
    phase_gram_small(torch, ops, ref, sp)
    phase_gram_solve_rows(torch, ops, ref)
    phase_hinge_small(torch, ops, ref)
    phase_sparse_linear_small(torch, ops, ref, sp)
    phase_sweep_kernels_small(torch, ops, ref, sp)
    bad = phase_nan_small(torch, ops, ref, sp)
    check(not bad, f"[nan-small] routes differ from plain on NaN: {bad}")
    phase_decode_small(torch, ops, ref)
    torch.cuda.synchronize()
    lap("the small kernel phases")
    phase_pipeline(torch, T, text)
    phase_sparse_pipeline(torch, T, text, sp)
    gram_launches = phase_kernel_pipeline(torch, T, text)
    phase_sweep_golden(torch, T, text, sp)
    phase_serve_smoke(torch, ops)
    phase_stream_smoke(torch, T, ops)
    phase_sched_smoke(torch, ops)
    lap("the pipelines and smokes")
    phase_chaos(torch)
    lap("[chaos]")
    phase_lint(torch)
    lap("[lint]")
    phase_sharded_small(torch, T, text)
    torch.cuda.synchronize()
    lap("[sharded-small]")
    phase_cluster_small(torch, T)
    lap("[cluster-small]")
    if args.quick:
        say(f"[quick] done in {time.perf_counter() - t_all:.1f} s; "
            "full-width phases skipped, no result")
        return 0
    kernels = phase_full_width(torch, T, ops, ref)
    torch.cuda.synchronize()
    lap("[full] and [full-sweep]")
    gram = time_gram_full(torch, T, ops, ref)
    # gram is not on the blocked-CSR main path: its count is the dense
    # golden Gram-path run's (phase 4)
    gram["launches"] = gram_launches["gram"]
    kernels.append(gram)
    lap("the Gram at full width")
    kernels += phase_full_kernel(torch, T, ops, ref)
    torch.cuda.synchronize()
    lap("[full-kernel]")
    kernels += phase_full_sparse(torch, T, ops, ref, sp)
    torch.cuda.synchronize()
    lap("[full-sparse]")
    torch.cuda.empty_cache()
    # slice 12: the sharded round at full width, 8 ranks on this card
    sharded = phase_sharded_full(torch, T)
    lap("[sharded-full]")
    torch.cuda.empty_cache()
    # slice 13: the sharded sweep at full width, 8 ranks on this card
    sweep_full = phase_sharded_sweep_full(torch, T)
    lap("[sharded-sweep-full]")
    torch.cuda.empty_cache()
    # slice 14: the train launch as 2 processes × 4 ranks on this card
    cluster = phase_cluster_full(torch, T)
    lap("[cluster-full]")
    torch.cuda.empty_cache()
    # slice 10's full-width paths: their launches join the kernels' rows
    stream, res = phase_stream_full(torch, T, ops, ref)
    mixed = phase_stream_mixed(
        torch, T, ops, ref,
        [res.service.snapshot(f"stream{s}").model for s in range(3)],
        res.cfg)
    phase_nan_stream(torch, T, ops, [res.service.snapshot(
        f"stream{s}").model for s in range(STREAMS)], res.cfg)
    lap("[stream-full] and [stream-full-mixed]")
    del res
    torch.cuda.empty_cache()
    phase_stream_ckpt(torch, T, ops)
    lap("[stream-full-ckpt]")
    torch.cuda.empty_cache()
    sched = phase_sched_full(torch, ops, ref)
    lap("[sched-full]")
    say(f"[stream] launches by kernel row: [stream-full] {stream}, "
        f"[stream-full-mixed] {mixed}, [sched-full] {sched}")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    # slice 16: each LM config at full width, one at a time; the
    # flash_decode row is tinyllama-1.1b's serve, the others' beside it
    t_models = time.perf_counter()
    fd_paths, by_config, embed = {}, {}, {}
    for arch, batch, cache_len in MODEL_CELLS:
        fd_row, paths, got = phase_model_full(torch, T, ops, ref, arch,
                                              batch, cache_len)
        embed = got or embed
        if fd_row is None:          # the ring route: no kernel on its path
            continue
        fd_paths.update(paths)
        if arch == MODEL_CELLS[0][0]:
            kernels.append(fd_row)
        else:
            by_config[arch] = {k: fd_row[k] for k in (
                "ms", "plain_ms", "bound_ms", "library_ms", "simt_ms",
                "launches", "shape")}
    say(f"[model-full] {len(MODEL_CELLS)} configs in "
        f"{time.perf_counter() - t_models:.1f} s")
    lap("[model-full]")
    torch.cuda.empty_cache()
    # slice 20: chatglm3-6b served on a 1 × 4 mesh of ranks
    by_config[f"tp-serve-full:{TP_ARCH}"], fd_paths[
        f"tp-serve-full:{TP_ARCH}"] = phase_tp_serve(torch, ops, ref)
    lap("[tp-serve-full]")
    torch.cuda.empty_cache()
    # slice 21: the dry run; rank 0 of five steps run on this card
    by_config["dryrun:llama3-8b"], dry = phase_dryrun(torch, ops, ref)
    lap("[dryrun]")
    kernels[-1]["configs"] = by_config
    # slice 17: LM training at full width; no kernel on its path
    phase_train(torch, ops)
    lap("[train-full]")
    # `launches` stays the row's main path's own count (the fit, or the
    # LM serve for flash_decode); the other paths are counted beside it
    for row in kernels:
        row["launches_by_path"] = {
            "main": row["launches"], "stream": stream.get(row["name"], 0),
            "stream_mixed": mixed.get(row["name"], 0),
            "sched": sched.get(row["name"], 0),
            "sharded-full": sharded.get(row["name"], 0),
            "sharded-sweep-full": sweep_full.get(row["name"], 0),
            "cluster-full": cluster.get(row["name"], 0),
            "embed-full": embed.get(row["name"], 0),
            "dryrun": dry.get(row["name"], 0),
            **(fd_paths if row["name"] == "flash_decode" else {})}
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
