"""Collectives of the sharded mode over a ``torch.distributed`` group.

The counterpart of the collective half of ``repro/compat.py``: the same
names (:func:`axis_index`, :func:`psum`, :func:`psum_scatter` (and
:func:`psum_scatter_bytes`), :func:`pmax`, :func:`all_gather`, :func:`all_gather_groups`,
:func:`ppermute`, :func:`ring_shift`, :func:`process_count`) over a
``ProcessGroup`` in place of mesh axes. One process is one rank, and a rank holds one
partition, as one device of the reference's mesh does. ``group=None``
is the default (world) group.

:class:`Mesh` (:func:`rank_mesh`) lays the ranks out on a grid of named
axes, as ``jax.make_mesh`` lays out devices, with this rank's
coordinates and a subgroup partition (:class:`Groups`) an axis.

Backends. NCCL runs every op on device tensors. gloo reads host memory,
so on a gloo group every op here stages a CUDA tensor through a pinned
host buffer (one copy to the host before the op, one back after it);
CPU tensors go as they are. Only the message moves through the host:
the solve and the scoring stay on the card. The backend is read from
``dist.get_backend(group)``. 2-byte floats and bools travel as views
of their bytes, which every backend carries bit for bit.

Semantics follow ``jax.lax``: :func:`ppermute` gives zeros to a rank
that receives nothing and copies locally on a self pair (i → i);
:func:`pmax` passes NaN on, as ``lax.pmax`` does (gloo's MAX is
``std::max``, which drops it, so it is a gather and a local ``amax``).

:func:`spawn` is the counterpart of ``compat.make_mesh``: it starts W
ranks with ``torch.multiprocessing`` and runs a function on each, under
a collective time limit and a join time limit of its own; under a
cluster launch (:mod:`repro_torch.launch.cluster`) each process starts
its k ranks and they join one world through the coordinator's store.
:func:`process_count` is the number of launched processes, as the
reference's.

:func:`record_collectives` records, while it is armed, every collective
this process issues (:class:`CollectiveEntry`): the schedule the
invariant linter checks (:mod:`repro_torch.analysis.schedule`);
:func:`timed_collectives` adds up their host seconds.

The sharded train step differentiates through them: the autograd
functions of the last section (:func:`sum_replicated`,
:func:`copy_to_parallel`, :func:`gather_shards`, :func:`scatter_sum`,
:func:`take_block`) pair each forward collective with its transpose,
what ``jax.grad`` derives for the reference under SPMD.
"""
from __future__ import annotations

import contextlib
import dataclasses
import datetime
import itertools
import math
import os
import pickle
import queue as queue_mod
import shutil
import signal
import tempfile
import time
import traceback
from typing import (Any, Callable, Dict, List, NamedTuple, Optional,
                    Sequence, Tuple)

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.analysis.hostsync import allowed_host_sync


def _backend(group=None) -> str:
    return str(dist.get_backend(group)).lower()


def _staged(t: torch.Tensor, group=None) -> bool:
    """Whether ``t`` goes through host memory on ``group``."""
    return t.is_cuda and _backend(group) == "gloo"


_BYTES = (torch.bfloat16, torch.float16, torch.bool)


def _wire(t: torch.Tensor) -> torch.Tensor:
    """The tensor a backend moves: 2-byte floats and bools as a flat
    uint8 view of their bytes (which every backend carries bit for bit;
    gloo has no int16), everything else as it is; contiguous."""
    t = t.contiguous()
    return t.reshape(-1).view(torch.uint8) if t.dtype in _BYTES else t


def _to_host(t: torch.Tensor) -> torch.Tensor:
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    with allowed_host_sync("gloo stages a CUDA message through the host"):
        h.copy_(t)
    return h


def _host_like(t: torch.Tensor) -> torch.Tensor:
    return torch.empty(t.shape, dtype=t.dtype, pin_memory=True)


def _back(h: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``h`` (a :func:`_wire` view, maybe on the host) as ``like``'s
    dtype, shape and device."""
    h = h.to(like.device, non_blocking=True)
    return h.view(like.dtype).reshape(like.shape) \
        if h.dtype != like.dtype else h


def axis_index(group=None) -> int:
    """This rank's index in ``group`` (the flattened device index)."""
    return dist.get_rank(group)


def axis_size(group=None) -> int:
    return dist.get_world_size(group)


#: the processes of the launch this process belongs to (set by
#: ``launch.cluster.init_cluster`` in a launching process and by
#: :func:`spawn` in each of its ranks)
_PROCESSES = 1


def process_count() -> int:
    """Processes of the job, as the reference's ``jax.process_count()``:
    the OS processes a cluster launch started, each running its own
    ranks (:mod:`repro_torch.launch.cluster`); 1 under :func:`spawn`
    alone. The ranks of a process are contiguous in rank order."""
    return _PROCESSES


def set_process_count(n: int) -> None:
    """Record the processes of this process's launch."""
    global _PROCESSES
    _PROCESSES = int(n)


class CollectiveEntry(NamedTuple):
    """One collective as :func:`record_collectives` saw it: its kind,
    the global ranks of its group, the replica groups (the partition a
    grouped collective runs over, as group-rank lists), the (source,
    target) pairs of a permute, the shapes and dtypes it moved, and a
    serial number that pairs a ``ppermute_start`` with its wait."""
    kind: str
    ranks: tuple
    replica_groups: tuple
    pairs: tuple
    shapes: tuple
    dtypes: tuple
    serial: int

    def signature(self) -> tuple:
        """What every rank of the collective must agree on."""
        return (self.kind, self.replica_groups, self.pairs, self.shapes,
                self.dtypes)


_RECORD: Optional[list] = None
_SERIAL = itertools.count()


@contextlib.contextmanager
def record_collectives():
    """Record every collective this process issues inside the block;
    yields the list of :class:`CollectiveEntry`, in issue order."""
    global _RECORD
    prev, _RECORD = _RECORD, []
    try:
        yield _RECORD
    finally:
        _RECORD = prev


def _group_ranks(group) -> tuple:
    return (tuple(range(dist.get_world_size())) if group is None
            else tuple(dist.get_process_group_ranks(group)))


def _note(kind: str, x: Optional[torch.Tensor], group=None, *,
          replica_groups=None, pairs=(), serial: Optional[int] = None
          ) -> int:
    """Append a :class:`CollectiveEntry` when recording; → its serial."""
    if serial is None:
        serial = next(_SERIAL)
    if _RECORD is None:
        return serial
    n = axis_size(group)
    groups = (tuple(tuple(g) for g in replica_groups)
              if replica_groups is not None else (tuple(range(n)),))
    _RECORD.append(CollectiveEntry(
        kind=kind, ranks=_group_ranks(group), replica_groups=groups,
        pairs=tuple(tuple(p) for p in pairs),
        shapes=() if x is None else (tuple(x.shape),),
        dtypes=() if x is None else (str(x.dtype).replace("torch.", ""),),
        serial=serial))
    return serial


_CLOCK: Optional[list] = None


@contextlib.contextmanager
def timed_collectives():
    """Add up, while armed, the host seconds this process spends inside
    :func:`psum`, :func:`psum_scatter`, :func:`pmax` and the all-gathers;
    yields a one-item list holding the sum. Each op first waits for the
    device (``torch.cuda.synchronize``), so that its clock holds its own
    staging, wire and copy back, not the work queued before it: a gloo
    op on a CUDA tensor waits there anyway, in its staging copy."""
    global _CLOCK
    prev, _CLOCK = _CLOCK, [0.0]
    try:
        yield _CLOCK
    finally:
        if prev is not None:
            prev[0] += _CLOCK[0]
        _CLOCK = prev


def collective_clock() -> float:
    """The seconds :func:`timed_collectives` has added up so far (0 when
    it is not armed)."""
    return 0.0 if _CLOCK is None else _CLOCK[0]


def _timed(fn):
    """``fn`` (a collective of this module) on :func:`timed_collectives`'
    clock while it is armed."""
    def run(x, *args, **kwargs):
        if _CLOCK is None:
            return fn(x, *args, **kwargs)
        clock = _CLOCK
        if x.is_cuda:
            torch.cuda.synchronize(x.device)
        t0 = time.perf_counter()
        out = fn(x, *args, **kwargs)
        if x.is_cuda:
            torch.cuda.synchronize(x.device)
        clock[0] += time.perf_counter() - t0
        return out
    run.__name__, run.__doc__ = fn.__name__, fn.__doc__
    run.__wrapped__ = fn
    return run


@_timed
def psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """Sum of ``x`` over the ranks (an all-reduce); a new tensor.
    ``group`` may be a :class:`Groups` partition: each rank then sums
    over its own group of it."""
    if isinstance(group, Groups):
        group, replica = group.handles[group.mine], group.groups
    else:
        replica = None
    _note("psum", x, group, replica_groups=replica)
    if _staged(x, group):
        h = _to_host(x)
        dist.all_reduce(h, group=group)
        return h.to(x.device, non_blocking=True)
    out = x.clone()
    dist.all_reduce(out, group=group)
    return out


def _gather_list(x: torch.Tensor, group) -> List[torch.Tensor]:
    """Every rank's ``x`` in group order: one ``all_gather_into_tensor``
    into one buffer, moved back in one copy."""
    n = axis_size(group)
    w = _wire(x).reshape(-1)
    staged = _staged(x, group)
    if staged:
        w = _to_host(w)
    out = (torch.empty(n * w.numel(), dtype=w.dtype, pin_memory=True)
           if staged else w.new_empty(n * w.numel()))
    dist.all_gather_into_tensor(out, w, group=group)
    out = out.to(x.device, non_blocking=True)
    if out.dtype != x.dtype:
        out = out.view(x.dtype)
    return list(out.reshape(n, *x.shape).unbind(0))


@_timed
def all_gather(x: torch.Tensor, group=None, *, tiled: bool = False
               ) -> torch.Tensor:
    """Every rank's ``x`` in rank order: stacked on a new leading axis,
    or with ``tiled`` concatenated along axis 0."""
    _note("all_gather", x, group)
    parts = _gather_list(x, group)
    return torch.cat(parts) if tiled else torch.stack(parts)


@_timed
def pmax(x: torch.Tensor, group=None) -> torch.Tensor:
    """Elementwise max over the ranks; NaN passes on (``lax.pmax``).
    ``group`` may be a :class:`Groups` partition, as :func:`psum`'s."""
    if isinstance(group, Groups):
        group, replica = group.handles[group.mine], group.groups
    else:
        replica = None
    _note("pmax", x, group, replica_groups=replica)
    return torch.stack(_gather_list(x, group)).amax(0)


@_timed
def psum_scatter(x: torch.Tensor, group=None, *, dim: int = 0
                 ) -> torch.Tensor:
    """``lax.psum_scatter(..., tiled=True)``: the sum of ``x`` over the
    ranks, of which each rank keeps its block along ``dim`` (block i of
    n, i its index in the group); a new tensor, by one
    ``reduce_scatter_tensor``. ``group`` may be a :class:`Groups`
    partition."""
    if isinstance(group, Groups):
        group, replica = group.handles[group.mine], group.groups
    else:
        replica = None
    _note("psum_scatter", x, group, replica_groups=replica)
    n = axis_size(group)
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                         f"over {n} ranks")
    xs = x.movedim(dim, 0).contiguous()
    staged = _staged(x, group)
    if staged:
        xs = _to_host(xs)
    k = xs.shape[0] // n
    out = _host_like(xs[:k]) if staged else torch.empty_like(xs[:k])
    dist.reduce_scatter_tensor(out, xs, group=group)
    return out.to(x.device, non_blocking=True).movedim(0, dim).contiguous()


@_timed
def psum_scatter_bytes(x: torch.Tensor, group=None, *, dim: int = 0
                       ) -> torch.Tensor:
    """:func:`psum_scatter` of a 2-byte ``x`` with its bytes on the wire:
    each rank's block j goes to rank j (one ``all_to_all_single`` of a
    uint8 view: gloo has no 2-byte sums), which adds the blocks it gets
    in float32 in rank order and rounds once to x's dtype, as
    ``psum_scatter(x.float())`` would (with two ranks exactly so).
    Recorded as the ``psum_scatter`` it is, of x's dtype."""
    if isinstance(group, Groups):
        group, replica = group.handles[group.mine], group.groups
    else:
        replica = None
    _note("psum_scatter", x, group, replica_groups=replica)
    n = axis_size(group)
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                         f"over {n} ranks")
    xs = x.movedim(dim, 0).contiguous()
    w = _wire(xs)
    staged = _staged(x, group)
    if staged:
        w = _to_host(w)
    out = (torch.empty(w.shape, dtype=w.dtype, pin_memory=True) if staged
           else torch.empty_like(w))
    dist.all_to_all_single(out, w, group=group)
    out = out.to(x.device, non_blocking=True).view(x.dtype).reshape(
        n, xs.shape[0] // n, *xs.shape[1:])
    total = out[0].float()
    for j in range(1, n):
        total += out[j].float()
    return total.to(x.dtype).movedim(0, dim).contiguous()


# ---------------------------------------------------------------------------
# Differentiable collectives (the sharded train step's): each forward is one
# of the ops above on a Groups partition, each backward its transpose.
# Convention: a tensor replicated over a group holds the whole gradient on
# every rank of it; a tensor split over it holds its own block's.
# ---------------------------------------------------------------------------

def _gather_dim(x: torch.Tensor, groups: "Groups", dim: int) -> torch.Tensor:
    return torch.cat(all_gather_groups(x, groups).unbind(0), dim=dim)


def _block(x: torch.Tensor, groups: "Groups", dim: int) -> torch.Tensor:
    handle = groups.handles[groups.mine]
    k = x.shape[dim] // axis_size(handle)
    return x.narrow(dim, axis_index(handle) * k, k)


def _sum_f32(x: torch.Tensor, groups: "Groups", dim: Optional[int] = None
             ) -> torch.Tensor:
    """:func:`psum` (``dim`` None) or :func:`psum_scatter` along ``dim``,
    in float32, rounded once to x's dtype. A 2-byte ``x`` scattered goes
    as its bytes (:func:`psum_scatter_bytes`): half a float32 message."""
    if dim is not None and x.element_size() == 2:
        return psum_scatter_bytes(x, groups, dim=dim)
    xf = x.float()
    out = psum(xf, groups) if dim is None else psum_scatter(xf, groups,
                                                            dim=dim)
    return out.to(x.dtype)


class _SumReplicated(torch.autograd.Function):
    """Partial sums → their sum on every rank (an all-reduce); the
    gradient of the sum reaches each partial as it is."""

    @staticmethod
    def forward(ctx, x, groups):
        return _sum_f32(x, groups)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyToParallel(torch.autograd.Function):
    """A replicated tensor entering ops whose gradients are partial
    (products with a rank's block of a weight): the same tensor forward,
    the partial gradients summed over the group backward."""

    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum_f32(g, ctx.groups), None


class _GatherShards(torch.autograd.Function):
    """Each rank's block along ``dim`` → the whole tensor on every rank
    (an all-gather). ``partial``: the consumers' gradients are partial
    and the backward sums them and keeps the rank's block (a
    reduce-scatter); else they are whole and it keeps the block."""

    @staticmethod
    def forward(ctx, x, groups, dim, partial):
        ctx.groups, ctx.dim, ctx.partial = groups, dim, partial
        return _gather_dim(x, groups, dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.partial:
            return _sum_f32(g, ctx.groups, ctx.dim), None, None, None
        return _block(g, ctx.groups, ctx.dim).contiguous(), None, None, None


class _ScatterSum(torch.autograd.Function):
    """Partial sums → the rank's block along ``dim`` of their sum (a
    reduce-scatter); backward, the blocks' gradients gathered whole."""

    @staticmethod
    def forward(ctx, x, groups, dim):
        ctx.groups, ctx.dim = groups, dim
        return _sum_f32(x, groups, dim)

    @staticmethod
    def backward(ctx, g):
        return _gather_dim(g, ctx.groups, ctx.dim), None, None


class _TakeBlock(torch.autograd.Function):
    """A replicated tensor → the rank's block along ``dim`` (no
    message); backward, the blocks' gradients gathered whole."""

    @staticmethod
    def forward(ctx, x, groups, dim):
        ctx.groups, ctx.dim = groups, dim
        return _block(x, groups, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _gather_dim(g, ctx.groups, ctx.dim), None, None


def sum_replicated(x: torch.Tensor, groups: "Groups") -> torch.Tensor:
    """Forward all-reduce (float32), backward identity: the sum after a
    row-parallel product."""
    return _SumReplicated.apply(x, groups)


def copy_to_parallel(x: torch.Tensor, groups: "Groups") -> torch.Tensor:
    """Forward identity, backward all-reduce: a replicated tensor before
    column-parallel products (or a replicated weight used on a rank's
    block of the rows)."""
    return _CopyToParallel.apply(x, groups)


def gather_shards(x: torch.Tensor, groups: "Groups", dim: int, *,
                  partial: bool = True) -> torch.Tensor:
    """Forward all-gather along ``dim``; backward reduce-scatter
    (``partial``) or the rank's block: an FSDP gather of a leaf, or the
    sequence gather entering a layer's products."""
    return _GatherShards.apply(x, groups, dim, partial)


def scatter_sum(x: torch.Tensor, groups: "Groups", dim: int
                ) -> torch.Tensor:
    """Forward reduce-scatter along ``dim`` (float32), backward
    all-gather: the row-parallel sum leaving a layer's products onto the
    sequence-split residual."""
    return _ScatterSum.apply(x, groups, dim)


def take_block(x: torch.Tensor, groups: "Groups", dim: int
               ) -> torch.Tensor:
    """Forward the rank's block along ``dim``, backward all-gather."""
    return _TakeBlock.apply(x, groups, dim)


@dataclasses.dataclass
class Groups:
    """Subgroups made once, when a round is built: ``handles[i]`` is the
    ``ProcessGroup`` of group i of a partition of the ranks, ``mine``
    the index of this rank's group and ``groups`` the partition, as
    rank lists of the parent group."""
    handles: List[Any]
    mine: int
    groups: tuple = ()


_GROUPS: dict = {}


def new_groups(groups: Sequence[Sequence[int]], group=None) -> Groups:
    """A ``ProcessGroup`` for each of ``groups`` (ascending rank lists
    that partition ``group``). Every rank creates every group, in the
    same order, as ``dist.new_group`` requires. The groups of one
    partition of one parent group are made once and reused: every
    rank builds the same rounds, so every rank hits or misses alike."""
    groups = [list(g) for g in groups]
    flat = sorted(r for g in groups for r in g)
    if flat != list(range(axis_size(group))) or any(
            g != sorted(g) for g in groups):
        raise ValueError(f"groups {groups} must partition the ranks in "
                         "ascending lists")
    parent = dist.group.WORLD if group is None else group
    key = (id(parent), tuple(map(tuple, groups)))
    if key not in _GROUPS or _GROUPS[key][0] is not parent:
        ranks = (list(range(axis_size(group))) if group is None
                 else dist.get_process_group_ranks(group))
        _GROUPS[key] = (parent, [dist.new_group([ranks[r] for r in g])
                                 for g in groups])
    me = axis_index(group)
    mine = next(i for i, g in enumerate(groups) if me in g)
    return Groups(_GROUPS[key][1], mine, tuple(map(tuple, groups)))


def forget_groups() -> None:
    """Drop the subgroups :func:`new_groups` made and keeps: for a
    process that destroys its default group and may start another."""
    _GROUPS.clear()


@_timed
def all_gather_groups(x: torch.Tensor, groups: Groups, *,
                      tiled: bool = False) -> torch.Tensor:
    """Grouped all-gather: each rank gathers within its own group of
    ``groups`` (:func:`new_groups`), in the group's rank order."""
    handle = groups.handles[groups.mine]
    _note("all_gather_groups", x, handle, replica_groups=groups.groups)
    parts = _gather_list(x, handle)
    return torch.cat(parts) if tiled else torch.stack(parts)


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A mesh: its axes' names and sizes; on a rank mesh also this
    rank's coordinates and, for each axis, the subgroups of the ranks
    that differ only along it (:class:`Groups`, this rank's group at
    ``mine``). A shape-only mesh (``coords`` None) reckons placements;
    nothing runs on it."""
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]
    coords: Optional[Tuple[int, ...]] = None
    groups: Optional[Tuple[Optional[Groups], ...]] = None

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)

    def _need_ranks(self, what: str) -> None:
        if self.coords is None:
            raise ValueError(f"a shape-only mesh has no {what}: it reckons "
                             "placements; running needs a rank mesh "
                             "(rank_mesh)")

    def index(self, axis: str) -> int:
        """This rank's coordinate along ``axis``."""
        self._need_ranks("rank coordinates")
        return self.coords[self.axis_names.index(axis)]

    def groups_of(self, axis: str) -> Groups:
        """The partition of the ranks along ``axis``."""
        self._need_ranks("process groups")
        return self.groups[self.axis_names.index(axis)]


def rank_mesh(axis_names: Sequence[str], sizes: Sequence[int]) -> Mesh:
    """A mesh over the default group's ranks, row-major: rank r's
    coordinates are r's digits in the sizes' mixed radix (two axes:
    r = d · model + m, the order of ``jax.make_mesh``). Every rank calls
    it, in the same order (it makes the subgroups). One process without
    a process group makes a 1 × … × 1 mesh without groups."""
    axis_names, sizes = tuple(axis_names), tuple(int(s) for s in sizes)
    world = axis_size() if dist.is_initialized() else 1
    if math.prod(sizes) != world:
        raise ValueError(f"a {' × '.join(map(str, sizes))} mesh needs "
                         f"{math.prod(sizes)} ranks, not {world}")
    me = axis_index() if dist.is_initialized() else 0
    coords = tuple(int(c) for c in np.unravel_index(me, sizes))
    if not dist.is_initialized():
        return Mesh(axis_names, sizes, coords, (None,) * len(sizes))
    grid = np.arange(world).reshape(sizes)
    groups = tuple(
        new_groups([list(map(int, g))
                    for g in np.moveaxis(grid, a, -1).reshape(-1, sizes[a])])
        for a in range(len(sizes)))
    return Mesh(axis_names, sizes, coords, groups)


class Pending:
    """A started :func:`ppermute_start`; :meth:`wait` gives the received
    tensor on the sender's device."""

    def __init__(self, like: torch.Tensor, works, recv, local,
                 group=None, serial: int = -1):
        self._like, self._works = like, works
        self._recv, self._local = recv, local
        self._group, self._serial = group, serial

    def wait(self) -> torch.Tensor:
        _note("ppermute_wait", None, self._group, serial=self._serial)
        for w in self._works:
            w.wait()
        if self._local is not None:
            return self._local
        if self._recv is None:
            return torch.zeros_like(self._like)
        return _back(self._recv, self._like)


def ppermute_start(x: torch.Tensor, perm, group=None) -> Pending:
    """Start sending ``x`` along ``perm`` (pairs (src, dst) of rank
    indices in ``group``, each rank at most once a source and once a
    destination) with ``dist.batch_isend_irecv``; the transfer runs while
    the caller goes on until :meth:`Pending.wait`."""
    me = axis_index(group)
    serial = _note("ppermute_start", x, group, pairs=perm)
    dst = [d for s, d in perm if s == me]
    src = [s for s, d in perm if d == me]
    if len(dst) > 1 or len(src) > 1:
        raise ValueError(f"rank {me} sends or receives twice in {perm}")
    if dst and dst[0] == me:
        return Pending(x, [], None, x.clone(), group, serial)
    staged = _staged(x, group)
    w = _wire(x)
    ops, recv = [], None
    if dst:
        out = _to_host(w) if staged else w
        ops.append(dist.P2POp(dist.isend, out, _global(dst[0], group),
                              group))
    if src:
        recv = _host_like(w) if staged else torch.empty_like(w)
        ops.append(dist.P2POp(dist.irecv, recv, _global(src[0], group),
                              group))
    works = dist.batch_isend_irecv(ops) if ops else []
    return Pending(x, works, recv, None, group, serial)


def _global(r: int, group) -> int:
    return r if group is None else dist.get_global_rank(group, r)


def ppermute(x: torch.Tensor, perm, group=None) -> torch.Tensor:
    """``lax.ppermute``: rank d gets x of the rank s with (s, d) in
    ``perm``, zeros if there is none."""
    return ppermute_start(x, perm, group).wait()


def ring_perm(n: int):
    return [(i, (i + 1) % n) for i in range(n)]


def ring_shift(x: torch.Tensor, group=None) -> torch.Tensor:
    """Each rank's ``x`` to its ring successor: rank i gets rank
    i − 1 mod N's."""
    return ppermute(x, ring_perm(axis_size(group)), group)


def probe(rank) -> dict:
    """Each op of this module once on small tensors of ``rank.device``
    over the world group: a self-check of their semantics that a spawn
    returns (the tests and the card's smoke run hold it). → numpy
    results by name."""
    n, me = rank.world_size, rank.rank
    dev = rank.device
    x = torch.arange(3, dtype=torch.float32, device=dev) + 10 * me
    nan = torch.tensor([float(me), float("nan") if me == n - 1 else 0.0],
                       device=dev)
    half = torch.full((2,), me + 0.5, dtype=torch.bfloat16, device=dev)
    # a partial permutation: 0 → 1, a self pair on the last rank; the
    # other ranks receive nothing
    perm = [(0, 1 % n)] + ([(n - 1, n - 1)] if n > 2 else [])
    groups = new_groups([list(range(n // 2)), list(range(n // 2, n))]
                        if n > 1 else [[0]])
    out = {"index": axis_index(), "size": axis_size(),
           "psum": psum(x), "pmax": pmax(nan),
           "gather": all_gather(half), "tiled": all_gather(x, tiled=True),
           "groups": all_gather_groups(x, groups),
           "ppermute": ppermute(x, perm), "ring": ring_shift(x)}
    return {k: (v.float().cpu().numpy() if isinstance(v, torch.Tensor)
                else v) for k, v in out.items()}


def rank_sum(rank, skip: Optional[int] = None) -> float:
    """The sum of the rank indices by one all-reduce; rank ``skip`` never
    calls it (a partner that does not come: the others' collective then
    fails within the spawn's limits, it does not hang)."""
    if rank.rank == skip:
        return float("nan")
    return float(psum(torch.tensor([float(rank.rank)],
                                   device=rank.device))[0])


# ---------------------------------------------------------------------------
# Ranks as processes: W on one host, or k a process of a cluster launch.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Rank:
    """What :func:`spawn` hands the function on each rank: its global
    rank and the world size, its device and backend, and where it sits
    in a cluster launch (``process_index · k + local_rank == rank``)."""
    rank: int
    world_size: int
    device: str          # "cpu" or "cuda:<i>"
    backend: str
    local_rank: int = 0
    process_index: int = 0


class RankFailed(RuntimeError):
    """A rank of :func:`spawn` raised, exited or was killed: ``rank`` is
    its global rank, ``exitcode`` the code it exited with (its
    ``SystemExit`` code, or the process's exit code when it left no
    report; None when it raised)."""

    def __init__(self, msg: str, rank: int, exitcode: Optional[int]):
        super().__init__(msg)
        self.rank, self.exitcode = rank, exitcode


def choose_backend(world_size: int, device: str,
                   cards_per_process: Optional[int] = None) -> str:
    """NCCL when each rank has a card of its own, gloo otherwise (CPU
    tensors, or ranks sharing a card). Under a cluster launch
    ``world_size`` is a process's ranks and ``cards_per_process`` the
    cards each process may give them (0 when processes share a host)."""
    if device == "cpu":
        return "gloo"
    cards = (torch.cuda.device_count() if cards_per_process is None
             else cards_per_process)
    return "nccl" if world_size <= cards else "gloo"


_PR_SET_PDEATHSIG = 1


def _die_with_parent(parent_pid: int) -> None:
    """SIGKILL this process when the process that started it dies
    (``prctl(PR_SET_PDEATHSIG)``), so that no rank outlives a killed
    launcher and holds its card, port or peers; if the parent is gone
    already, exit."""
    try:
        import ctypes
        ctypes.CDLL(None, use_errno=True).prctl(_PR_SET_PDEATHSIG,
                                                int(signal.SIGKILL))
    except (OSError, AttributeError):      # not Linux: the join limits hold
        pass
    if os.getppid() != parent_pid:
        os._exit(1)


def _rendezvous(init, timeout) -> dict:
    """``init_process_group``'s keywords: a file store of its own on one
    host, or a client of the coordinator's TCP store (``(host, port,
    prefix)``) under a cluster launch."""
    if isinstance(init, str):
        return {"init_method": init}
    host, port, prefix = init
    store = dist.TCPStore(host, port, is_master=False, timeout=timeout)
    return {"store": dist.PrefixStore(prefix, store)}


def _rank_main(rank, world, init, backend, device, timeout_s, fn, args_path,
               results, parent_pid, local_rank, process_index,
               process_count):
    _die_with_parent(parent_pid)
    with open(args_path, "rb") as f:
        args = pickle.load(f)
    set_process_count(process_count)
    torch.set_num_threads(1)
    dev = "cpu"
    reported = False
    try:
        if device != "cpu":
            ordinal = local_rank % torch.cuda.device_count()
            torch.cuda.set_device(ordinal)
            dev = f"cuda:{ordinal}"
        timeout = datetime.timedelta(seconds=timeout_s)
        dist.init_process_group(backend, world_size=world, rank=rank,
                                timeout=timeout,
                                **_rendezvous(init, timeout))
        try:
            out = fn(Rank(rank, world, dev, backend, local_rank,
                          process_index), *args)
        except BaseException as e:
            # reported before the group goes down: the peers' errors
            # about the closed group then come after this root cause
            results.put((rank, False, (_exit_code(e),
                                       traceback.format_exc())))
            reported = True
            raise
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException as e:
        # the parent stops every rank on this report; the exit code says
        # the same to anything else watching the process
        if not reported:
            results.put((rank, False, (_exit_code(e),
                                       traceback.format_exc())))
        raise


def _exit_code(e: BaseException) -> Optional[int]:
    if isinstance(e, SystemExit):
        return e.code if isinstance(e.code, int) else 1
    return None


_SPAWNS = itertools.count()


def spawn(fn: Callable, world_size: int, args: Sequence = (), *,
          device: str = "cuda", timeout_s: float = 300.0,
          join_timeout_s: float = 900.0, cluster=None) -> List[Any]:
    """Run ``fn(Rank, *args)`` on ``world_size`` new processes (spawn
    start method), one rank each, and return their results in rank
    order.

    ``fn`` must be importable by name (a module-level function of a
    module on ``sys.path``); ``args`` reach the ranks pickled in a file
    (through the start pipe, a start would wait for the previous rank to
    import ``fn``'s module when they exceed the pipe's 64 KiB). Ranks
    rendezvous through a file in a
    directory of their own, so concurrent spawns never share a port; each
    calls ``torch.set_num_threads(1)`` and dies with this process
    (``PR_SET_PDEATHSIG``). ``device="cuda"`` (the default;
    without a card it raises unless ``device="cpu"``) gives local rank i
    card ``i % device_count``; the backend is :func:`choose_backend`'s. The
    kernels are built here, before the ranks start, so that no rank runs
    ``nvcc``.

    With ``cluster`` (a joined :class:`repro_torch.launch.cluster.
    Cluster`), this process starts its ``cluster.local_device_count``
    ranks (``world_size`` must be that number) and they join one world
    of ``process_count · k`` ranks with every other process's, through
    the coordinator's TCP store: local rank i is global rank
    ``process_index · k + i``, and :func:`process_count` in a rank is the
    cluster's. Every process of the cluster calls :func:`spawn` as often
    and in the same order (each call is a world of its own). The result
    is this process's ranks' results, in rank order.

    A collective that waits longer than ``timeout_s`` raises on its
    rank. A rank that raises or exits makes this raise
    :class:`RankFailed` with its traceback (a rank's own error, reported
    before its group goes down, comes first); ranks still running after
    ``join_timeout_s`` are killed and this raises ``TimeoutError``.
    Either way every rank of this process is stopped first.
    """
    import torch.multiprocessing as mp
    if device != "cpu":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' to run the ranks on the CPU")
        from repro_torch.kernels import build
        build.build_all()
    n_spawn = next(_SPAWNS)
    if cluster is None:
        k, first, world, procs_n, pidx = world_size, 0, world_size, 1, 0
        backend = choose_backend(world_size, device)
        rdzv = tempfile.mkdtemp(prefix="repro_torch_rdzv_")
        init = f"file://{rdzv}/store"
    else:
        k = cluster.local_device_count
        if world_size != k:
            raise ValueError(f"this process of the cluster runs {k} ranks, "
                             f"not {world_size}")
        pidx, procs_n = cluster.process_index, cluster.process_count
        first, world = pidx * k, procs_n * k
        backend = choose_backend(k, device, cluster.cards_per_process)
        rdzv = None
        host, port = cluster.coordinator.rsplit(":", 1)
        init = (host, int(port), f"spawn{n_spawn}/")
    box = tempfile.mkdtemp(prefix="repro_torch_args_")
    args_path = os.path.join(box, "args.pkl")
    with open(args_path, "wb") as f:
        pickle.dump(tuple(args), f, protocol=pickle.HIGHEST_PROTOCOL)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(first + i, world, init, backend, device,
                               timeout_s, fn, args_path, results,
                               os.getpid(), i, pidx, procs_n))
             for i in range(k)]
    mine = list(range(first, first + k))
    got: dict = {}
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + join_timeout_s
        while len(got) < k:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"ranks {sorted(set(mine) - set(got))} of {world} "
                    f"still running after {join_timeout_s} s")
            try:
                rank, ok, out = results.get(timeout=min(left, 1.0))
            except queue_mod.Empty:
                dead = [r for r, p in zip(mine, procs)
                        if r not in got and p.exitcode is not None]
                if dead:
                    time.sleep(0.5)             # its last message may lag
                    if results.empty():
                        code = procs[dead[0] - first].exitcode
                        raise RankFailed(
                            f"rank {dead[0]} exited with code {code} and "
                            "no result", dead[0], code)
                continue
            if not ok:
                code, text = out
                raise RankFailed(f"rank {rank} of {world} failed:\n{text}",
                                 rank, code)
            got[rank] = out
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 1.0))
        return [got[r] for r in mine]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            if p.pid is not None:
                p.join(timeout=5.0)
        results.close()
        shutil.rmtree(box, ignore_errors=True)
        if rdzv is not None:
            shutil.rmtree(rdzv, ignore_errors=True)
