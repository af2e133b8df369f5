"""Deterministic synthetic data: LM token batches and TF×IDF-like rows
for the MapReduce SVM. The numpy code is the reference's
(``repro/data/pipeline.py``), byte for byte.

LM batches (:func:`lm_batch_at`, :func:`lm_batches`) are Zipf tokens
with a planted bigram rule, stateless in ``(seed, step)``: a run resumes
from any checkpoint step on the same batches.

Rows are generated in BLOCK-STATELESS chunks: block j draws from
``default_rng((seed, 1, j))`` independently of every other block, so a
process can make exactly its own row range.

:func:`svm_rows_device` makes rows of the same distribution straight
on the device, where a full-width dataset takes seconds instead of
minutes of host time. :func:`svm_rows_sparse` and
:func:`svm_rows_sparse_device` do the same for blocked-CSR rows.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch import sparse as sparse_rows
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    batch_size: int = 8
    seq_len: int = 128
    seed: int = 0


def _tokens_for_step(cfg: DataConfig, vocab: int, step: int,
                     structure: int = 97) -> np.ndarray:
    """Zipfian tokens with a deterministic bigram rule planted:
    after token t comes (t * 31 + 7) % structure with prob ~0.5 —
    learnable signal for smoke-training."""
    rng = np.random.default_rng((cfg.seed, step))
    B, S = cfg.batch_size, cfg.seq_len
    base = rng.zipf(1.3, size=(B, S)).clip(1, vocab - 1)
    follow = (base * 31 + 7) % min(structure, vocab)
    use_follow = rng.random((B, S)) < 0.5
    out = base.copy()
    out[:, 1:] = np.where(use_follow[:, 1:], follow[:, :-1], base[:, 1:])
    return out.astype(np.int32)


def lm_batches(cfg: DataConfig, model_cfg: ModelConfig,
               start_step: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    """Next-token LM batches: {tokens, labels} (+ frontend stubs)."""
    step = start_step
    while True:
        yield lm_batch_at(cfg, model_cfg, step)
        step += 1


def lm_batch_at(cfg: DataConfig, model_cfg: ModelConfig,
                step: int) -> Dict[str, np.ndarray]:
    """The batch of ``step`` as numpy arrays: tokens and next-token
    labels (B, S) int32; an encoder-decoder's stub ``frames`` (B,
    encoder_seq, D) float32; a VLM's stub ``prefix_embeds`` (B, P, D)
    float32, its text then S − P tokens."""
    rng = np.random.default_rng((cfg.seed, step, 1))
    S = cfg.seq_len
    P = model_cfg.num_prefix_tokens if model_cfg.frontend == "vision" else 0
    toks = _tokens_for_step(cfg, model_cfg.vocab_size, step)
    batch: Dict[str, np.ndarray] = {}
    if model_cfg.is_encoder_decoder:
        batch["frames"] = rng.normal(
            0, 1, (cfg.batch_size, model_cfg.encoder_seq,
                   model_cfg.d_model)).astype(np.float32)
        batch["tokens"] = toks[:, :S]
        batch["labels"] = np.concatenate(
            [toks[:, 1:S], toks[:, :1]], axis=1).astype(np.int32)
    elif P > 0:
        batch["prefix_embeds"] = rng.normal(
            0, 1, (cfg.batch_size, P, model_cfg.d_model)).astype(np.float32)
        text = toks[:, :S - P]
        batch["tokens"] = text
        batch["labels"] = np.concatenate(
            [text[:, 1:], text[:, :1]], axis=1).astype(np.int32)
    else:
        batch["tokens"] = toks
        batch["labels"] = np.concatenate(
            [toks[:, 1:], toks[:, :1]], axis=1).astype(np.int32)
    return batch

_ROW_BLOCK = 1024     # rows per stateless block (host memory granule)


def _svm_signal(num_features: int, seed: int, signal_dims: int) -> np.ndarray:
    """The planted linear separator — identical on every host."""
    rng = np.random.default_rng((seed, 0))
    signal_dims = min(signal_dims, num_features)
    w = np.zeros(num_features, np.float32)
    idx = rng.choice(num_features, signal_dims, replace=False)
    w[idx] = rng.normal(0, 1, signal_dims)
    return w


def default_row_nnz(num_features: int) -> int:
    """Historical synthetic density: ~d/256 nonzeros, floor 4."""
    return min(num_features, max(4, num_features // 256))


def _svm_row_block(block: int, rows: int, num_features: int,
                   seed: int, nnz: Optional[int] = None) -> np.ndarray:
    """``rows`` normalized sparse-ish rows of stateless block ``block``."""
    rng = np.random.default_rng((seed, 1, block))
    nnz = default_row_nnz(num_features) if nnz is None \
        else min(num_features, max(1, int(nnz)))
    # nnz distinct columns per row without a Python loop: the nnz
    # smallest of d iid uniforms are a uniform no-replacement sample
    scores = rng.random((rows, num_features), dtype=np.float32)
    cols = np.argpartition(scores, nnz - 1, axis=1)[:, :nnz]
    X = np.zeros((rows, num_features), np.float32)
    np.put_along_axis(X, cols, rng.random((rows, nnz), dtype=np.float32),
                      axis=1)
    norm = np.linalg.norm(X, axis=1, keepdims=True)
    return X / np.maximum(norm, 1e-9)


def host_row_range(num_rows: int, process_index: int,
                   process_count: int) -> Tuple[int, int]:
    """Balanced contiguous ``[start, stop)`` of one process's rows."""
    if not 0 <= process_index < process_count:
        raise ValueError(f"process_index {process_index} outside "
                         f"[0, {process_count})")
    return (process_index * num_rows // process_count,
            (process_index + 1) * num_rows // process_count)


def svm_rows(num_rows: int, num_features: int, seed: int = 0,
             signal_dims: int = 64, nnz: Optional[int] = None
             ) -> Tuple[np.ndarray, np.ndarray]:
    """Synthetic sparse-ish TF×IDF-like rows with a linear signal."""
    return svm_rows_shard(num_rows, num_features, seed, signal_dims, nnz=nnz)


def svm_rows_shard(num_rows: int, num_features: int, seed: int = 0,
                   signal_dims: int = 64, nnz: Optional[int] = None,
                   *, process_index: int = 0,
                   process_count: int = 1
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """THIS process's disjoint shard of the ``svm_rows`` dataset."""
    start, stop = host_row_range(num_rows, process_index, process_count)
    w = _svm_signal(num_features, seed, signal_dims)
    if stop == start:
        X = np.zeros((0, num_features), np.float32)
    else:
        parts = []
        for block in range(start // _ROW_BLOCK, (stop - 1) // _ROW_BLOCK + 1):
            b0 = block * _ROW_BLOCK
            rows = min(num_rows - b0, _ROW_BLOCK)
            full = _svm_row_block(block, rows, num_features, seed, nnz)
            parts.append(full[max(start - b0, 0):stop - b0])
        X = np.concatenate(parts, axis=0)
    y = np.sign(X @ w + 1e-3).astype(np.float32)
    return X, y


# -- sparse rows: blocked-CSR straight from the generator, on their own
# stateless stream (seed, 2, block). Columns are drawn one per stratum
# (stride = d // nnz), so in-row indices are DISTINCT — the SparseRows
# contract under which Σv² row norms equal the densified rows' norms.

def _svm_sparse_row_block(block: int, rows: int, num_features: int,
                          nnz_cap: int, nnz: int, seed: int
                          ) -> Tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng((seed, 2, block))
    stride = num_features // nnz
    offs = rng.integers(0, stride, (rows, nnz))
    cols = (np.arange(nnz, dtype=np.int64) * stride)[None, :] + offs
    vals = rng.random((rows, nnz), dtype=np.float32)
    norm = np.linalg.norm(vals, axis=1, keepdims=True)
    vals = vals / np.maximum(norm, 1e-9)
    indices = np.zeros((rows, nnz_cap), np.int32)
    values = np.zeros((rows, nnz_cap), np.float32)
    indices[:, :nnz] = cols.astype(np.int32)
    values[:, :nnz] = vals
    return indices, values


def _sparse_nnz(num_features: int, nnz_cap: int, nnz: Optional[int]) -> int:
    nnz = default_row_nnz(num_features) if nnz is None \
        else min(num_features, max(1, int(nnz)))
    if nnz > nnz_cap:
        raise ValueError(f"nnz={nnz} exceeds nnz_cap={nnz_cap}")
    return nnz


def svm_rows_sparse(num_rows: int, num_features: int, nnz_cap: int,
                    seed: int = 0, signal_dims: int = 64,
                    nnz: Optional[int] = None, *, process_index: int = 0,
                    process_count: int = 1):
    """THIS process's shard as blocked-CSR rows (``SparseRows`` with CPU
    leaves) + labels, on the block-stateless contract of
    :func:`svm_rows_shard`."""
    nnz = _sparse_nnz(num_features, nnz_cap, nnz)
    start, stop = host_row_range(num_rows, process_index, process_count)
    w = _svm_signal(num_features, seed, signal_dims)
    if stop == start:
        indices = np.zeros((0, nnz_cap), np.int32)
        values = np.zeros((0, nnz_cap), np.float32)
    else:
        iparts, vparts = [], []
        for block in range(start // _ROW_BLOCK, (stop - 1) // _ROW_BLOCK + 1):
            b0 = block * _ROW_BLOCK
            rows = min(num_rows - b0, _ROW_BLOCK)
            bi, bv = _svm_sparse_row_block(block, rows, num_features,
                                           nnz_cap, nnz, seed)
            lo = max(start - b0, 0)
            iparts.append(bi[lo:stop - b0])
            vparts.append(bv[lo:stop - b0])
        indices = np.concatenate(iparts, axis=0)
        values = np.concatenate(vparts, axis=0)
    y = np.sign(np.sum(values * w[indices], axis=1) + 1e-3
                ).astype(np.float32)
    return sparse_rows.from_numpy_coo(indices, values, num_features), y


def _block_generator(seed: int, block: int, device,
                     stream: int = 1) -> torch.Generator:
    """The torch stream of stateless block ``block``, seeded from
    ``(seed, stream, block)`` like the numpy generator's (stream 1:
    dense rows, 2: sparse rows)."""
    g = torch.Generator(device=device)
    g.manual_seed(int(np.random.SeedSequence((seed, stream, block))
                      .generate_state(1, np.uint64)[0]))
    return g


def _shard_blocks(num_rows: int, process_index: int, process_count: int):
    """The stateless blocks that cover one process's row range, as
    (block, rows of the block, first row kept, end of rows kept, where
    they go in the shard). → (shard rows, [blocks])."""
    start, stop = host_row_range(num_rows, process_index, process_count)
    blocks = []
    if stop > start:
        for block in range(start // _ROW_BLOCK, (stop - 1) // _ROW_BLOCK + 1):
            b0 = block * _ROW_BLOCK
            rows = min(num_rows - b0, _ROW_BLOCK)
            lo, hi = max(start - b0, 0), min(stop - b0, rows)
            blocks.append((block, rows, lo, hi, b0 + lo - start))
    return stop - start, blocks


def svm_rows_device(num_rows: int, num_features: int, seed: int = 0,
                    signal_dims: int = 64, nnz: Optional[int] = None, *,
                    dtype: torch.dtype = torch.bfloat16, device="cuda",
                    process_index: int = 0, process_count: int = 1
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rows of the ``svm_rows`` distribution, made on ``device``.

    Each stateless block draws from its own ``torch.Generator``: ``nnz``
    distinct uniform columns per row (the smallest of d iid uniforms),
    uniform values, L2-normalized, labels ``sign(x·w + 1e-3)`` against
    the same planted separator as :func:`svm_rows`. The random stream
    is torch's, so the values differ from the numpy generator's; the
    distribution does not. Rows are made in float32 and stored as
    ``dtype``; only one block is ever float32 at a time.

    ``process_index`` / ``process_count`` give THIS process's shard
    (:func:`host_row_range`), as :func:`svm_rows_shard` does: only the
    blocks covering it are made, and the shards of all processes
    together are one call's rows bit for bit.
    """
    dev = torch.device(device)
    nnz = default_row_nnz(num_features) if nnz is None \
        else min(num_features, max(1, int(nnz)))
    w = torch.from_numpy(_svm_signal(num_features, seed, signal_dims)).to(dev)
    n, blocks = _shard_blocks(num_rows, process_index, process_count)
    X = torch.empty((n, num_features), dtype=dtype, device=dev)
    y = torch.empty((n,), dtype=torch.float32, device=dev)
    for block, rows, lo, hi, at in blocks:
        g = _block_generator(seed, block, dev)
        scores = torch.rand((rows, num_features), generator=g, device=dev)
        cols = torch.topk(scores, nnz, dim=1, largest=False).indices
        del scores
        vals = torch.rand((rows, nnz), generator=g, device=dev)
        Xb = torch.zeros((rows, num_features), device=dev).scatter_(1, cols,
                                                                     vals)
        Xb /= Xb.norm(dim=1, keepdim=True).clamp(min=1e-9)
        y[at:at + hi - lo] = torch.sign(Xb[lo:hi] @ w + 1e-3)
        X[at:at + hi - lo] = Xb[lo:hi].to(dtype)
    return X, y


def svm_rows_sparse_device(num_rows: int, num_features: int, nnz_cap: int,
                           seed: int = 0, signal_dims: int = 64,
                           nnz: Optional[int] = None, *,
                           dtype: torch.dtype = torch.float32,
                           device="cuda", process_index: int = 0,
                           process_count: int = 1):
    """Blocked-CSR rows of the ``svm_rows_sparse`` distribution, made on
    ``device``: per stateless block its own ``torch.Generator``, one
    uniform column per stride-``d // nnz`` stratum, uniform values,
    L2-normalized, labels ``sign(x·w + 1e-3)`` against the planted
    separator of :func:`svm_rows_sparse`. The random stream is torch's,
    so the values differ from the numpy generator's; the distribution
    does not. ``process_index`` / ``process_count`` give this process's
    shard, as for :func:`svm_rows_device`. → (``SparseRows`` with
    ``dtype`` values, labels f32)."""
    dev = torch.device(device)
    nnz = _sparse_nnz(num_features, nnz_cap, nnz)
    stride = num_features // nnz
    w = torch.from_numpy(_svm_signal(num_features, seed, signal_dims)).to(dev)
    n, blocks = _shard_blocks(num_rows, process_index, process_count)
    indices = torch.zeros((n, nnz_cap), dtype=torch.int32, device=dev)
    values = torch.zeros((n, nnz_cap), dtype=dtype, device=dev)
    y = torch.empty((n,), dtype=torch.float32, device=dev)
    base = torch.arange(nnz, device=dev) * stride
    for block, rows, lo, hi, at in blocks:
        g = _block_generator(seed, block, dev, stream=2)
        cols = base + torch.randint(0, stride, (rows, nnz), generator=g,
                                    device=dev)
        vals = torch.rand((rows, nnz), generator=g, device=dev)
        vals /= vals.norm(dim=1, keepdim=True).clamp(min=1e-9)
        cols, vals = cols[lo:hi], vals[lo:hi]
        indices[at:at + hi - lo, :nnz] = cols.to(torch.int32)
        values[at:at + hi - lo, :nnz] = vals.to(dtype)
        y[at:at + hi - lo] = torch.sign((vals * w[cols]).sum(1) + 1e-3)
    return sparse_rows.SparseRows(indices, values, num_features), y
