"""Flat-npz checkpointing of trees of tensors, ported from
``repro/ckpt/checkpoint.py``, in the reference's own file format: each
package restores the other's files.

A tree is nested dicts, lists, tuples and NamedTuples with
``torch.Tensor`` leaves (on any device: they are read back to the host),
numpy arrays or :class:`repro_torch.sparse.SparseRows`. Its flat keys
are the strings ``jax.tree_util`` makes of the same tree's key paths,
joined by ``||``: dict keys sorted and written ``['key']``, sequence
items ``[i]``, NamedTuple fields ``.field``, and a ``SparseRows`` as its
two children ``[<flat index 0>]`` (column ids) and ``[<flat index 1>]``
(values). numpy has no bf16, so a bf16 leaf is stored as its uint16
view under the key plus ``__bf16__``; dtype names are numpy's
(``'float32'``, ``'int32'``) and ``'bfloat16'``.

Writes are crash-durable (the tmp file fsync'd, the directory fsync'd
after the rename), retried with backoff on ``OSError`` and
content-addressed: :func:`save` returns the written file's crc32 and,
with ``step``, records it in the ``generations`` list of
``ckpt_meta.json`` (keep-last-N, older media removed).
:func:`latest_step` / :func:`latest_path` verify the recorded crc32s
newest first and skip corrupt generations.
"""
from __future__ import annotations

import json
import os
import time
import zlib
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch import faults
from repro_torch import sparse as sparse_rows

_SEP = "||"

_BF16 = "__bf16__"

_META = "ckpt_meta.json"

# generations kept per checkpoint directory (callers override per save)
DEFAULT_KEEP = 3


class CorruptCheckpointError(ValueError):
    """A stored leaf failed its recorded content checksum."""


def _map(tree, fn: Callable, path: tuple = ()):
    """``tree`` with every leaf replaced by ``fn(key, leaf)``, visiting
    the leaves in ``jax.tree_util``'s order (dict keys sorted); ``None``
    is an empty subtree, as there."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map(tree[k], fn, path + (f"[{k!r}]",))
                for k in sorted(tree)}
    if sparse_rows.is_sparse(tree):
        return sparse_rows.SparseRows(
            fn(_SEP.join(path + ("[<flat index 0>]",)), tree.indices),
            fn(_SEP.join(path + ("[<flat index 1>]",)), tree.values), tree.d)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(getattr(tree, f), fn, path + (f".{f}",))
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn, path + (f"[{i}]",))
                          for i, v in enumerate(tree))
    return fn(_SEP.join(path), tree)


def _leaves(tree) -> Dict[str, Any]:
    """Flat key → leaf, in key-path order."""
    out: Dict[str, Any] = {}
    _map(tree, lambda key, leaf: out.__setitem__(key, leaf))
    return out


def _dtype_name(dtype) -> str:
    """numpy's name of a torch or numpy dtype (``'bfloat16'`` for bf16)."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    return str(np.dtype(dtype))


def _torch_dtype(name: str) -> torch.dtype:
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


def to_host(tree):
    """``tree`` with every tensor leaf copied to the host (the one
    device-to-host read of a save: flatten, checksum and dtype record of
    the host tree read no device)."""
    return _map(tree, lambda _, leaf: leaf.detach().cpu()
                if isinstance(leaf, torch.Tensor) else leaf)


def _stored(leaf):
    """A leaf as the numpy array the file holds, and whether it is a bf16
    leaf stored as its uint16 view."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), True
        return t.numpy(), False
    return np.asarray(leaf), False


def _flatten(tree) -> Dict[str, np.ndarray]:
    flat = {}
    for key, leaf in _leaves(tree).items():
        arr, bf16 = _stored(leaf)
        flat[key + _BF16 if bf16 else key] = arr
    return flat


def _fsync_dir(dirname: str) -> None:
    """Best-effort directory fsync: makes the rename itself durable (some
    filesystems refuse an O_RDONLY directory fsync)."""
    try:
        fd = os.open(dirname or ".", os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def file_crc32(path: str) -> int:
    """crc32 of the file's bytes (chunked)."""
    crc = 0
    with open(path, "rb") as f:
        while True:
            chunk = f.read(1 << 20)
            if not chunk:
                return crc
            crc = zlib.crc32(chunk, crc)


def leaf_checksums(tree: Any) -> Dict[str, int]:
    """crc32 per flat key over the stored bytes (a bf16 leaf over its
    uint16 form), recorded beside a save so :func:`restore` can verify
    each payload apart from the npz container."""
    return {key: zlib.crc32(np.ascontiguousarray(arr).tobytes())
            for key, arr in _flatten(tree).items()}


def leaf_dtypes(tree: Any) -> Dict[str, str]:
    """dtype name per flat leaf key, recorded beside a save so a restorer
    can rebuild an exactly typed ``like`` tree (:func:`with_dtypes`)."""
    return {key: _dtype_name(leaf.dtype) if hasattr(leaf, "dtype")
            else str(np.asarray(leaf).dtype)
            for key, leaf in _leaves(tree).items()}


def with_dtypes(like: Any, dtypes: Dict[str, str]) -> Any:
    """``like`` with each leaf retyped from a :func:`leaf_dtypes` record
    (shapes and structure kept; keys absent from the record keep their
    leaf). The new leaves are ``meta`` tensors: shapes and dtypes, no
    memory."""
    def retype(key, leaf):
        dt = dtypes.get(key)
        return leaf if dt is None else torch.empty(
            tuple(leaf.shape), dtype=_torch_dtype(dt), device="meta")
    return _map(like, retype)


def atomic_write_json(path: str, payload: Any, attempts: int = 3,
                      on_retry=None) -> None:
    """Write JSON via tmp + fsync + rename: readers see the old file or
    the new one, never a torn or empty one. Retries ``OSError`` with
    backoff; exhaustion raises ``FaultDetected("ckpt", …)``."""
    def write():
        faults.maybe_raise("ckpt.write", kinds=("ckpt_write_fail",))
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        _fsync_dir(os.path.dirname(path))

    faults.retry_with_backoff(
        write, attempts=attempts, base_s=0.02, retry_on=OSError,
        on_retry=on_retry, layer="ckpt",
        cause=f"manifest write {os.path.basename(path)}",
        action="check disk space/permissions; the previously installed "
               "manifest is still intact")


def save(path: str, tree: Any, step: Optional[int] = None,
         keep: int = DEFAULT_KEEP, attempts: int = 3,
         on_retry=None, timings: Optional[Dict[str, float]] = None) -> int:
    """Atomic, durable save (write tmp → fsync → rename → dir fsync).

    Returns the crc32 of the written bytes. With ``step`` the directory's
    ``ckpt_meta.json`` gains a generation record ``{step, file, crc32}``;
    only the newest ``keep`` are kept and older npz files removed.
    ``timings``, if given, gains the ms of the host copy and flatten
    (``"d2h"``), ``np.savez`` (``"savez"``), the fsyncs (``"fsync"``) and
    the file crc32 (``"crc32"``).
    """
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    t = timings if timings is not None else {}

    def lap(name, t0):
        t[name] = t.get(name, 0.0) + 1e3 * (time.perf_counter() - t0)
        return time.perf_counter()

    t0 = time.perf_counter()
    flat = _flatten(tree)
    lap("d2h", t0)

    def write() -> int:
        faults.maybe_raise("ckpt.write", kinds=("ckpt_write_fail",))
        tmp = path + ".tmp"
        t0 = time.perf_counter()
        np.savez(tmp, **flat)
        t0 = lap("savez", t0)
        actual = tmp if tmp.endswith(".npz") else tmp + ".npz"
        with open(actual, "rb") as f:
            os.fsync(f.fileno())
        t0 = lap("fsync", t0)
        # crc of the intended bytes, before the media-corruption seam: a
        # corrupted file must mismatch its recorded crc, which is how
        # restore detects it and falls back
        crc = file_crc32(actual)
        t0 = lap("crc32", t0)
        spec = faults.fire("ckpt.media", kinds=("ckpt_corrupt",))
        if spec is not None:
            faults.corrupt_file(actual, spec)
        os.replace(actual, path)
        _fsync_dir(os.path.dirname(path))
        lap("fsync", t0)
        return crc

    crc = faults.retry_with_backoff(
        write, attempts=attempts, base_s=0.02, retry_on=OSError,
        on_retry=on_retry, layer="ckpt",
        cause=f"snapshot write {os.path.basename(path)}",
        action="check disk space/permissions; the previous snapshot "
               "generation is still intact")
    if step is not None:
        _record_generation(os.path.dirname(path) or ".", step,
                           os.path.basename(path), crc, keep, on_retry)
    return crc


def _record_generation(ckpt_dir: str, step: int, fname: str, crc: int,
                       keep: int, on_retry=None) -> None:
    """Append a generation to the meta pointer, keep the newest ``keep``,
    remove dropped media. The meta keeps the flat ``latest_step`` /
    ``file`` fields for readers from before generations."""
    meta = _read_meta(ckpt_dir) or {}
    gens = [g for g in meta.get("generations", [])
            if g.get("file") != fname]
    gens.append({"step": step, "file": fname, "crc32": crc})
    dropped, gens = (gens[:-keep], gens[-keep:]) if keep >= 1 \
        else ([], gens)
    atomic_write_json(
        os.path.join(ckpt_dir, _META),
        {"latest_step": step, "file": fname, "generations": gens},
        on_retry=on_retry)
    kept_files = {g["file"] for g in gens}
    for g in dropped:
        if g["file"] not in kept_files:
            try:
                os.remove(os.path.join(ckpt_dir, g["file"]))
            except OSError:
                pass


def restore(path: str, like: Any,
            checksums: Optional[Dict[str, int]] = None,
            device=None) -> Any:
    """Restore into the structure of ``like`` (its leaves give shapes and
    dtypes: tensors, ``meta`` tensors or numpy arrays), as tensors on
    ``device`` (default the CPU).

    Dtype drift raises instead of casting: a checkpoint restores bit-exact
    or not at all. With ``checksums`` (a :func:`leaf_checksums` record)
    every stored leaf's bytes are verified first; a mismatch raises
    :class:`CorruptCheckpointError`.
    """
    with np.load(path, allow_pickle=False) as data:
        def load(key, leaf):
            if key + _BF16 in data:
                skey = key + _BF16
                raw = data[skey]
                t = torch.from_numpy(raw.view(np.int16)).view(torch.bfloat16)
            elif key in data:
                skey = key
                raw = data[key]
                t = torch.from_numpy(raw)
            else:
                raise KeyError(f"checkpoint missing leaf {key!r}")
            if checksums is not None and skey in checksums:
                got = zlib.crc32(np.ascontiguousarray(raw).tobytes())
                if got != checksums[skey]:
                    raise CorruptCheckpointError(
                        f"checksum mismatch for leaf {skey!r} in "
                        f"{os.path.basename(path)} — the snapshot payload "
                        "is corrupt")
            if tuple(t.shape) != tuple(leaf.shape):
                raise ValueError(f"shape mismatch for {key}: ckpt "
                                 f"{tuple(t.shape)} vs {tuple(leaf.shape)}")
            want = _dtype_name(leaf.dtype)
            if _dtype_name(t.dtype) != want:
                raise ValueError(
                    f"dtype mismatch for {key}: ckpt {_dtype_name(t.dtype)} "
                    f"vs like {want} — checkpoints restore exactly, not "
                    "cast")
            return t.to(device) if device is not None else t
        return _map(like, load)


def _read_meta(ckpt_dir: str) -> Optional[dict]:
    meta = os.path.join(ckpt_dir, _META)
    if not os.path.exists(meta):
        return None
    try:
        with open(meta) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return None                     # unreadable pointer ≡ no pointer


def _newest_intact(ckpt_dir: str, meta: dict) -> Optional[dict]:
    """The newest generation whose medium verifies against its recorded
    crc32; corrupt or missing generations are skipped (counted as
    ``ckpt_fallbacks``). A meta from before generations has no crc: its
    pointer is trusted."""
    gens = meta.get("generations")
    if gens is None:
        if meta.get("file") is None:
            return None
        return {"step": meta.get("latest_step"), "file": meta["file"]}
    for rec in reversed(gens):
        p = os.path.join(ckpt_dir, rec["file"])
        if not os.path.exists(p):
            faults.count("ckpt_fallbacks")
            continue
        crc = rec.get("crc32")
        if crc is not None and file_crc32(p) != crc:
            faults.count("ckpt_fallbacks")
            continue
        return rec
    return None


def latest_step(ckpt_dir: str) -> Optional[int]:
    meta = _read_meta(ckpt_dir)
    if meta is None:
        return None
    rec = _newest_intact(ckpt_dir, meta)
    return rec.get("step") if rec is not None else None


def latest_path(ckpt_dir: str) -> Optional[str]:
    """Path of the newest intact checkpoint generation (crc32-verified
    when recorded), or ``None``."""
    meta = _read_meta(ckpt_dir)
    if meta is None:
        return None
    rec = _newest_intact(ckpt_dir, meta)
    if rec is None or not rec.get("file"):
        return None
    return os.path.join(ckpt_dir, rec["file"])
