"""Blocked sparse rows: fixed-``nnz_cap`` padded CSR/ELL.

``SparseRows`` stores each row as ``nnz_cap`` column-id / value pairs:

    indices : (..., n, nnz_cap) int32   — column ids, 0 on padding slots
    values  : (..., n, nnz_cap) float   — 0.0 on padding slots

The feature dimension ``d`` rides along. Padding slots are index 0 with
value 0.0; duplicate indices are legal and always mean *sum* (as
:func:`to_dense`'s scatter-add does), so a padding slot adds nothing to
any contraction. ``torch.sparse`` keeps neither the (0, 0) padding
slots nor that rule, so the layout is two plain tensors.

Rows with more than ``nnz_cap`` nonzeros are truncated by
:func:`from_dense` to their ``nnz_cap`` largest-|value| entries.

The packed wire of the sharded mode's ring and hier transports ships
blocked-CSR rows as f32 lanes (:func:`pack_wire`, :func:`unpack_wire`):
values packed as dense rows are, ids by their bits.

The kernels take only column ids in [0, d). A ``SparseRows`` carries a
mark that its ids were found in range (:meth:`SparseRows.mark_ids_in_range`,
set by ``kernels.ops.check_column_ids`` after one check); rows derived
from marked rows (``[]``, ``*``, ``reshape``, ``to``, :func:`pad_rows`,
:func:`take_rows_along`, and :func:`rows_concat`, :func:`rows_concat_all`
or :func:`rows_stack` of marked batches) keep
it, so a kernel wrapper checks a batch once and not at every call. The
mark holds the ids tensor it was given for and that tensor's version
counter, so giving the rows other ids, or changing the ids in place,
clears it. A write that bypasses the version counter (through ``.data``,
DLPack or a raw pointer) is not seen: rows changed that way must be made
anew.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


class SparseRows:
    """Batch of sparse feature rows in padded-CSR (ELL) layout.

    ``.shape``/``.dtype``/``.ndim`` report the DENSE ``(..., n, d)``
    view; ``[]`` over batch dims, ``*`` by a trailing-1 row scale, ``@``
    by a dense matrix and ``.reshape`` of batch dims work as on a dense
    tensor, so format-blind call sites run on either.
    """

    __slots__ = ("indices", "values", "d", "_ids_checked")

    def __init__(self, indices: torch.Tensor, values: torch.Tensor, d: int,
                 ids_in_range: bool = False):
        self.indices = indices
        self.values = values
        self.d = int(d)
        self._ids_checked = None
        if ids_in_range:
            self.mark_ids_in_range()

    @property
    def ids_in_range(self) -> bool:
        """Whether every column id is known to lie in [0, d): checked, or
        derived from checked rows, and neither replaced nor changed in
        place since."""
        mark = self._ids_checked
        return (mark is not None and mark[0] is self.indices
                and mark[1] == self.indices._version)

    def mark_ids_in_range(self) -> None:
        """Record that the ids were checked to lie in [0, d): the ids
        tensor itself and its version."""
        self._ids_checked = (self.indices, self.indices._version)

    @property
    def shape(self) -> Tuple[int, ...]:
        """Shape of the DENSE row matrix this represents: (..., n, d)."""
        return tuple(self.values.shape[:-1]) + (self.d,)

    @property
    def ndim(self) -> int:
        return self.values.dim()

    @property
    def dtype(self) -> torch.dtype:
        return self.values.dtype

    @property
    def device(self) -> torch.device:
        return self.values.device

    @property
    def nnz_cap(self) -> int:
        return int(self.values.shape[-1])

    def to(self, device=None, dtype=None) -> "SparseRows":
        """Both leaves to ``device``; ``dtype`` casts the values only."""
        return SparseRows(self.indices.to(device=device),
                          self.values.to(device=device,
                                         dtype=dtype or self.values.dtype),
                          self.d, self.ids_in_range)

    def __getitem__(self, idx) -> "SparseRows":
        """Indexing over the batch dims; the slot axis is not addressable."""
        return SparseRows(self.indices[idx], self.values[idx], self.d,
                          self.ids_in_range)

    def __mul__(self, other) -> "SparseRows":
        """Row-wise scale by ``other`` with a trailing axis of 1."""
        o = torch.as_tensor(other, device=self.values.device)
        if o.dim() and o.shape[-1] != 1:
            raise ValueError(
                "SparseRows * x requires x constant along the feature axis "
                f"(trailing dim 1), got shape {tuple(o.shape)}")
        return SparseRows(self.indices, self.values * o.to(self.values.dtype),
                          self.d, self.ids_in_range)

    __rmul__ = __mul__

    def __matmul__(self, other: torch.Tensor) -> torch.Tensor:
        """``X @ W`` against a DENSE ``(d,)`` or ``(d, k)`` operand by
        gather and accumulate."""
        if other.shape[0] != self.d:
            raise ValueError(f"matmul dim mismatch: d={self.d} vs "
                             f"{tuple(other.shape)}")
        g = other[self.indices.long()]                  # (..., n, cap[, k])
        v = self.values.to(other.dtype)
        if other.dim() == 1:
            return (g * v).sum(-1)
        return (g * v[..., None]).sum(-2)

    def reshape(self, *shape) -> "SparseRows":
        """Reshape the BATCH dims; the last entry must be ``d``."""
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        if not shape or shape[-1] != self.d:
            raise ValueError(
                f"SparseRows.reshape last dim must be d={self.d}, "
                f"got {shape}")
        lead = tuple(int(s) for s in shape[:-1]) + (self.nnz_cap,)
        return SparseRows(self.indices.reshape(lead),
                          self.values.reshape(lead), self.d,
                          self.ids_in_range)

    def __repr__(self):
        return (f"SparseRows(shape={self.shape}, nnz_cap={self.nnz_cap}, "
                f"dtype={self.values.dtype})")


def is_sparse(x) -> bool:
    return isinstance(x, SparseRows)


# -- conversions ---------------------------------------------------------

def from_dense(X: torch.Tensor, nnz_cap: int, d: int | None = None
               ) -> SparseRows:
    """Dense ``(..., n, d)`` → ``SparseRows`` keeping, per row, the
    ``nnz_cap`` largest-|value| entries. A stable descending sort puts
    the lower column first on ties, as ``lax.top_k`` does."""
    d = X.shape[-1] if d is None else d
    if nnz_cap > d:
        raise ValueError(f"nnz_cap={nnz_cap} exceeds d={d}")
    idx = torch.sort(X.abs(), dim=-1, descending=True,
                     stable=True).indices[..., :nnz_cap]
    vals = torch.gather(X, -1, idx)
    idx = torch.where(vals != 0, idx, 0).to(torch.int32)
    return SparseRows(idx, vals, d)


def to_dense(sp: SparseRows) -> torch.Tensor:
    """``SparseRows`` → dense ``(..., n, d)`` by scatter-ADD."""
    out = torch.zeros(sp.values.shape[:-1] + (sp.d,), dtype=sp.dtype,
                      device=sp.device)
    return out.scatter_add_(-1, sp.indices.long(), sp.values)


def from_numpy_coo(indices: np.ndarray, values: np.ndarray,
                   d: int) -> SparseRows:
    """From already-blocked numpy arrays (the tokenizer and generator
    emit this layout directly); the leaves stay on the CPU."""
    return SparseRows(torch.from_numpy(np.ascontiguousarray(indices,
                                                            np.int32)),
                      torch.from_numpy(np.ascontiguousarray(values)), d)


# -- structural ops on batch dims -----------------------------------------

def rows_concat(a, b, axis: int = 0):
    """Concatenate two row batches of one format along a batch axis."""
    sa, sb = is_sparse(a), is_sparse(b)
    if sa != sb:
        raise TypeError("cannot concatenate sparse rows with dense rows")
    if not sa:
        return torch.cat([a, b], dim=axis)
    if a.d != b.d:
        raise ValueError(f"feature-dim mismatch: {a.d} vs {b.d}")
    if a.nnz_cap != b.nnz_cap:
        raise ValueError(f"nnz_cap mismatch: {a.nnz_cap} vs {b.nnz_cap}")
    return SparseRows(torch.cat([a.indices, b.indices], dim=axis),
                      torch.cat([a.values, b.values.to(a.dtype)], dim=axis),
                      a.d, a.ids_in_range and b.ids_in_range)


def rows_concat_all(parts, axis: int = 0):
    """Concatenate one or more row batches of one format along a batch
    axis (the streaming wave's join of its micro-batches), in one copy."""
    if not parts:
        raise ValueError("rows_concat_all: empty sequence")
    if len(parts) == 1:
        return parts[0]
    sp = is_sparse(parts[0])
    if any(is_sparse(p) != sp for p in parts[1:]):
        raise TypeError("cannot concatenate sparse rows with dense rows")
    if not sp:
        return torch.cat(list(parts), dim=axis)
    first = parts[0]
    for p in parts[1:]:
        if p.d != first.d:
            raise ValueError(f"feature-dim mismatch: {first.d} vs {p.d}")
        if p.nnz_cap != first.nnz_cap:
            raise ValueError(f"nnz_cap mismatch: {first.nnz_cap} vs "
                             f"{p.nnz_cap}")
    return SparseRows(torch.cat([p.indices for p in parts], dim=axis),
                      torch.cat([p.values.to(first.dtype) for p in parts],
                                dim=axis),
                      first.d, all(p.ids_in_range for p in parts))


def rows_stack(jobs, rows: int | None = None):
    """Stack row batches on a NEW leading axis (the sweep's job axis).

    Entry s of ``jobs`` is a sequence of 2-D row batches that job s
    holds one after the other along the row axis, zero-padded to
    ``rows`` rows (default: the longest job); an empty entry is a job of
    padding only. All batches share one format, d (and ``nnz_cap``).
    The jobs are written into one preallocated ``(S, rows, ·)`` array,
    so no job's joined rows are ever copied on their own. Blocked-CSR
    padding is index 0 / value 0, the empty row. Values take the first
    batch's dtype."""
    parts = [p for job in jobs for p in job]
    if not parts:
        raise ValueError("rows_stack: no row batch to stack")
    first = parts[0]
    sp = is_sparse(first)
    if any(is_sparse(p) != sp for p in parts[1:]):
        raise TypeError("rows_stack: mixed dense/sparse inputs")
    for p in parts[1:]:
        if p.shape[-1] != first.shape[-1]:
            raise ValueError(f"feature-dim mismatch: {first.shape[-1]} vs "
                             f"{p.shape[-1]}")
        if sp and p.nnz_cap != first.nnz_cap:
            raise ValueError(f"nnz_cap mismatch: {first.nnz_cap} vs "
                             f"{p.nnz_cap}")
    lengths = [sum(p.shape[0] for p in job) for job in jobs]
    rows = max(lengths) if rows is None else rows
    if max(lengths) > rows:
        raise ValueError(f"a job holds {max(lengths)} rows, more than "
                         f"{rows}")
    leaves = ((lambda p: p.indices), (lambda p: p.values)) if sp \
        else ((lambda p: p),)
    outs = []
    for leaf in leaves:
        like = leaf(first)
        out = torch.empty((len(jobs), rows) + tuple(like.shape[1:]),
                          dtype=like.dtype, device=like.device)
        for s, job in enumerate(jobs):
            r = 0
            for p in job:
                out[s, r:r + p.shape[0]] = leaf(p)
                r += p.shape[0]
            out[s, r:].zero_()
        outs.append(out)
    if not sp:
        return outs[0]
    return SparseRows(*outs, first.d, all(p.ids_in_range for p in parts))


def pad_rows(x, pad: int):
    """Zero-pad ``pad`` rows at the end of the ROW axis (-2 of the dense
    view), for either format."""
    if not pad:
        return x
    if not is_sparse(x):
        return torch.nn.functional.pad(x, (0, 0, 0, pad))
    return SparseRows(torch.nn.functional.pad(x.indices, (0, 0, 0, pad)),
                      torch.nn.functional.pad(x.values, (0, 0, 0, pad)), x.d,
                      x.ids_in_range)


def take_rows_along(x, topi: torch.Tensor):
    """Rows ``topi[l]`` of each leading batch entry ``l`` of a 3-D row
    batch ``x`` (L, per, ·) → (L, k, ·), for either format."""
    rows = torch.arange(topi.shape[0], device=topi.device)[:, None]
    return x[rows, topi]


# -- contractions ----------------------------------------------------------

def row_sq_norms(x) -> torch.Tensor:
    """Σ_j x_ij² per row (distinct in-row indices assumed when sparse)."""
    if not is_sparse(x):
        return (x * x).sum(-1)
    return (x.values * x.values).sum(-1)


def weighted_row_sum(x, coef: torch.Tensor) -> torch.Tensor:
    """``X.T @ coef`` → dense ``(d,)``: w = Σ_i coef_i x_i. On blocked-CSR
    rows the slots of one column add in a fixed order (``index_put_``
    with ``accumulate`` sorts the ids on the card, where ``index_add_``
    adds with float atomics), so a rerun gives the same bits."""
    if not is_sparse(x):
        return x.T @ coef
    contrib = (x.values * coef[:, None]).reshape(-1)
    w = torch.zeros((x.d,), dtype=contrib.dtype, device=contrib.device)
    return w.index_put_((x.indices.reshape(-1).long(),), contrib,
                        accumulate=True)


def cross_dots(x, z, *, chunk: int = 64) -> torch.Tensor:
    """Dot-product matrix ``<x_i, z_j>`` → ``(n, m)`` for any format mix.
    Sparse × sparse densifies ``z`` in chunks of ``chunk`` rows by
    scatter-add and gathers each chunk at ``x``'s column ids:
    O(n·m·nnz + m·d), never an (n, d) dense copy."""
    xs, zs = is_sparse(x), is_sparse(z)
    if not xs and not zs:
        return x @ z.T
    if xs and not zs:
        return x @ z.T
    if not xs and zs:
        return (z @ x.T).T
    if x.d != z.d:
        raise ValueError(f"feature-dim mismatch: {x.d} vs {z.d}")
    ct = torch.promote_types(x.dtype, z.dtype)
    n, m = x.values.shape[-2], z.values.shape[-2]
    out = torch.empty((n, m), dtype=ct, device=x.device)
    xi, xv = x.indices.long(), x.values.to(ct)
    for j0 in range(0, m, chunk):
        zi = z.indices[j0:j0 + chunk].long()
        zv = z.values[j0:j0 + chunk].to(ct)
        c = zi.shape[0]
        zd = torch.zeros((x.d, c), dtype=ct, device=x.device)
        cols = torch.arange(c, device=x.device)[:, None].expand_as(zi)
        zd.index_put_((zi.reshape(-1), cols.reshape(-1)), zv.reshape(-1),
                      accumulate=True)
        out[:, j0:j0 + c] = (zd[xi] * xv[..., None]).sum(-2)
    return out


def score_rows(x, W: torch.Tensor, b=None) -> torch.Tensor:
    """Decision scores ``X @ W.T (+ b)`` with dense ``W (L, d)``."""
    s = x @ W.T
    return s if b is None else s + b


# -- the packed wire of the sharded mode's ring and hier transports ----------

def pack_lanes(xw: torch.Tensor, wire_dt: torch.dtype):
    """(n, m) wire-dtype matrix → ``(lanes (n, slots) f32, slots)``:
    2-byte dtypes put element PAIRS into one f32 lane by their bits
    (lossless; an odd m is padded with one zero), 4-byte floats pass
    through."""
    n, m = xw.shape
    size = wire_dt.itemsize
    if size == 2:
        if m % 2:
            xw = torch.nn.functional.pad(xw, (0, 1))
        return xw.contiguous().view(torch.float32), (m + m % 2) // 2
    if size != 4:
        raise ValueError(f"unsupported shuffle_wire_dtype {wire_dt}")
    return xw.contiguous().view(torch.float32), m


def unpack_lanes(lanes: torch.Tensor, m: int, wire_dt: torch.dtype):
    """Inverse of :func:`pack_lanes`: (n, slots) f32 → (n, m) wire."""
    rows = lanes.contiguous().view(wire_dt)
    return rows[:, :m] if rows.shape[1] != m else rows


def pack_wire(x: SparseRows, wire_dt: torch.dtype):
    """Blocked-CSR rows as f32 lanes: each row's values in the wire
    dtype, packed as :func:`pack_lanes` packs dense rows, then its
    int32 column ids by their bits (never quantized).
    → ``(lanes (n, wslots), wslots)``, wslots = value slots + nnz_cap."""
    vf, vslots = pack_lanes(x.values.to(wire_dt), wire_dt)
    idxf = x.indices.to(torch.int32).contiguous().view(torch.float32)
    return torch.cat([vf, idxf], 1), vslots + x.nnz_cap


def unpack_wire(lanes: torch.Tensor, d: int, nnz_cap: int,
                wire_dt: torch.dtype) -> SparseRows:
    """Inverse of :func:`pack_wire`: (n, wslots) f32 lanes → the
    ``SparseRows`` that were shipped, values in the wire dtype. The
    rows are new and carry no checked-ids mark, so a kernel checks their
    ids before it reads them and a garbled id never reaches one."""
    vslots = lanes.shape[1] - nnz_cap
    vals = unpack_lanes(lanes[:, :vslots], nnz_cap, wire_dt)
    idx = lanes[:, vslots:].contiguous().view(torch.int32)
    return SparseRows(idx, vals, d)
