"""The group layer of the multi-device schedules: who the ranks are, the
collectives between them, and what they cost.

Port of gemini_seal_tpu/parallel/comm.py's role.  The JAX package runs a
schedule as one program over a device mesh (``shard_map``) and reads the
collectives that XLA placed out of the compiled HLO text.  Here a schedule
is written once as a per-rank body that calls the collectives of a
:class:`Group` itself, so the collective profile is what the body issues:
every collective adds its count and the bytes of its result on one rank
(the JAX module's measure: the result footprint per participating device)
to the group's :class:`CollectiveStats`.

Two groups carry the same bodies:

- :class:`ThreadGroup`: ``size`` ranks as threads of one process on one
  device.  Every rank launches on the device's default stream, so an
  exchange (a copy out of another rank's tensor, enqueued after that rank
  enqueued the kernel that wrote it, which a barrier orders) needs no
  event.  This runs the schedules on the CPU in the tests and as C ranks
  on one card.
- :class:`DistGroup`: one rank per process over ``torch.distributed``
  (gloo for CPU tensors, NCCL for CUDA tensors, one process per card).

A group has named axes laid out row-major over its ranks (the (dp, limb)
mesh of mesh.py); ``sub(axis)`` is the group of the ranks that share every
other coordinate.  :func:`run_spmd` runs one body on every rank.
"""

from __future__ import annotations

import contextvars
import os
import socket
import tempfile
import threading
from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence, Tuple

import torch

from ..ops.backend import resolve_device
from ..tracing import span

__all__ = ["CollectiveStats", "Group", "ThreadGroup", "DistGroup", "run_spmd", "spawn"]

# the JAX module's names of the collectives (HLO op names)
ALL_GATHER = "all-gather"
ALL_TO_ALL = "all-to-all"
PERMUTE = "collective-permute"
ALL_REDUCE = "all-reduce"

# a ThreadGroup's exchange copies (chip_smoke.py's profile_steps reads the name)
_EXCHANGE = span("gst_exchange")


@dataclass
class CollectiveStats:
    """Per-kind counts and result bytes of the collectives one rank issued."""

    count: Dict[str, int] = field(default_factory=dict)
    bytes: Dict[str, int] = field(default_factory=dict)

    def add(self, kind: str, nbytes: int) -> None:
        self.count[kind] = self.count.get(kind, 0) + 1
        self.bytes[kind] = self.bytes.get(kind, 0) + nbytes

    def reset(self) -> None:
        self.count.clear()
        self.bytes.clear()

    def as_dict(self) -> dict:
        return {"count": dict(self.count), "bytes": dict(self.bytes)}

    def __str__(self) -> str:
        rows = [f"{k}: count={self.count[k]} bytes={self.bytes[k]}" for k in sorted(self.count)]
        return "; ".join(rows) if rows else "no collectives"


def _axis(x: torch.Tensor, axis: int) -> int:
    return axis % x.dim()


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class Group:
    """One rank's handle on a group of ranks.

    rank, size: this rank's index in the group and the group's size.
    axis_names, axis_sizes: the group's named axes, row-major over its ranks
    (one axis ``"x"`` of ``size`` unless a mesh is given).
    stats: the CollectiveStats that this rank's collectives add to (shared
    with the sub-groups of the rank).
    """

    rank: int
    size: int
    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]
    stats: CollectiveStats

    # -- the collectives ---------------------------------------------------
    def all_gather(self, x: torch.Tensor, axis: int) -> torch.Tensor:
        """Tiled all-gather: every rank's x joined along `axis` in rank order."""
        raise NotImplementedError

    def all_to_all(self, x: torch.Tensor, axis: int) -> torch.Tensor:
        """x split along `axis` into `size` blocks, block j sent to rank j;
        the blocks received, joined along `axis` in source-rank order
        (jax.lax.all_to_all with split_axis = concat_axis = axis)."""
        raise NotImplementedError

    def ppermute(self, x: torch.Tensor, perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
        """(src, dst) pairs: each rank receives the x of the rank that sends
        to it, zeros when none does (jax.lax.ppermute)."""
        raise NotImplementedError

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """Sum over the ranks, mod 2^64 in int64 (jax.lax.psum of u64)."""
        raise NotImplementedError

    def sub(self, axis: str) -> "Group":
        """The group along `axis`: the ranks whose other coordinates equal
        this rank's."""
        raise NotImplementedError

    # -- layout ------------------------------------------------------------
    def coords(self) -> Dict[str, int]:
        """This rank's coordinate on each axis."""
        out, r = {}, self.rank
        for name, n in reversed(list(zip(self.axis_names, self.axis_sizes))):
            out[name] = r % n
            r //= n
        return out

    def _members(self, axis: str) -> Tuple[int, ...]:
        """Group ranks of the sub-group along `axis` through this rank."""
        if axis not in self.axis_names:
            raise ValueError(f"group has no axis {axis!r} (axes {self.axis_names})")
        k = self.axis_names.index(axis)
        stride = 1
        for n in self.axis_sizes[k + 1:]:
            stride *= n
        base = self.rank - self.coords()[axis] * stride
        return tuple(base + i * stride for i in range(self.axis_sizes[k]))


def _layout(size: int, mesh) -> Tuple[Tuple[str, ...], Tuple[int, ...]]:
    if mesh is None:
        return ("x",), (size,)
    names, sizes = tuple(mesh.axis_names), tuple(mesh.axis_sizes)
    n = 1
    for s in sizes:
        n *= s
    if n != size:
        raise ValueError(f"mesh {dict(zip(names, sizes))} has {n} ranks, the group {size}")
    return names, sizes


# --------------------------------------------------------------------------
# ranks as threads of one process
# --------------------------------------------------------------------------

class _Exchange:
    """The meeting point of one set of ranks: a slot per member and a
    barrier that every member passes twice per collective (after putting
    its tensor in, after taking what it needs out)."""

    def __init__(self, n: int, timeout: float):
        self.slots = [None] * n
        self.barrier = threading.Barrier(n, timeout=timeout)


class ThreadGroup:
    """`size` ranks as threads of one process on one device (None means the
    card, and raises without one; "cpu" for the plain versions).

    The team object: ``handle(r)`` is rank r's :class:`Group`, and
    :func:`run_spmd` runs a body on every rank's thread.  The first
    exception raised by any rank aborts every barrier (the other ranks stop
    with threading.BrokenBarrierError) and is re-raised in the caller; a
    rank that waits longer than `timeout` seconds at a barrier breaks it
    too, so a rank that fails never leaves the others waiting.
    """

    def __init__(self, size: int, device=None, mesh=None, timeout: float = 600.0, lock=None):
        if size < 1:
            raise ValueError("a group needs at least one rank")
        self.size = size
        self.device = resolve_device(device)
        self.axis_names, self.axis_sizes = _layout(size, mesh)
        self.timeout = timeout
        # held around every exchange copy, when given: what else the process
        # serialises with it (an instrument timing kernel calls) then never
        # overlaps with a copy on the shared stream
        self.copy_lock = lock
        self._lock = threading.Lock()
        self._exchanges: Dict[Tuple[int, ...], _Exchange] = {}
        self.stats = [CollectiveStats() for _ in range(size)]
        self._handles = [_ThreadRank(self, r, tuple(range(size)), self.axis_names,
                                     self.axis_sizes, self.stats[r]) for r in range(size)]

    def handle(self, rank: int) -> "Group":
        return self._handles[rank]

    def exchange(self, members: Tuple[int, ...]) -> _Exchange:
        with self._lock:
            ex = self._exchanges.get(members)
            if ex is None:
                ex = self._exchanges[members] = _Exchange(len(members), self.timeout)
            return ex

    def abort(self) -> None:
        with self._lock:
            exchanges = list(self._exchanges.values())
        for ex in exchanges:
            ex.barrier.abort()

    def reset(self) -> None:
        """Fresh barriers (after an aborted run) and zeroed stats."""
        with self._lock:
            self._exchanges.clear()
        for s in self.stats:
            s.reset()


class _ThreadRank(Group):
    def __init__(self, team: ThreadGroup, rank: int, members: Tuple[int, ...],
                 axis_names, axis_sizes, stats: CollectiveStats):
        self.team = team
        self.rank = rank
        self.size = len(members)
        self.members = members             # team ranks, in group-rank order
        self.axis_names = tuple(axis_names)
        self.axis_sizes = tuple(axis_sizes)
        self.stats = stats

    def sub(self, axis: str) -> Group:
        if self.axis_names == (axis,):
            return self
        idx = self._members(axis)
        members = tuple(self.members[i] for i in idx)
        return _ThreadRank(self.team, idx.index(self.rank), members, (axis,),
                           (len(members),), self.stats)

    def _swap(self, x, take):
        """Put x in this rank's slot, wait for every member, compute
        take(slots), wait again so that no slot is overwritten before every
        member has read it."""
        ex = self.team.exchange(self.members)
        ex.slots[self.rank] = x
        ex.barrier.wait()
        lock = self.team.copy_lock
        if lock is not None:
            lock.acquire()
        try:
            with _EXCHANGE:
                out = take(ex.slots)
        finally:
            if lock is not None:
                lock.release()
        ex.barrier.wait()
        return out

    def all_gather(self, x, axis):
        ax = _axis(x, axis)
        out = self._swap(x, lambda s: torch.cat(s, dim=ax))
        self.stats.add(ALL_GATHER, _nbytes(out))
        return out

    def all_to_all(self, x, axis):
        ax = _axis(x, axis)
        n = x.shape[ax]
        if n % self.size:
            raise ValueError(f"all_to_all: axis of {n} does not split into {self.size}")
        b = n // self.size
        r = self.rank
        out = self._swap(x, lambda s: torch.cat([t.narrow(ax, r * b, b) for t in s], dim=ax))
        self.stats.add(ALL_TO_ALL, _nbytes(out))
        return out

    def ppermute(self, x, perm):
        src = [s for s, d in perm if d == self.rank]
        if len(src) > 1:
            raise ValueError(f"ppermute: rank {self.rank} receives from {src}")
        out = self._swap(x, lambda s: s[src[0]].clone() if src else torch.zeros_like(x))
        self.stats.add(PERMUTE, _nbytes(out))
        return out

    def psum(self, x):
        def total(s):
            acc = s[0].clone()
            for t in s[1:]:
                acc += t
            return acc
        out = self._swap(x, total)
        self.stats.add(ALL_REDUCE, _nbytes(out))
        return out


# --------------------------------------------------------------------------
# ranks as processes: torch.distributed
# --------------------------------------------------------------------------

class DistGroup(Group):
    """This process's rank of a torch.distributed world (or of one of its
    sub-groups).  The process group must be initialised; a CUDA tensor
    needs the NCCL backend, a CPU tensor gloo.  ``mesh`` names the world's
    axes; every process must build the same DistGroup, in the same order,
    because the sub-groups are created collectively (dist.new_group)."""

    def __init__(self, mesh=None, pg=None, members: Optional[Tuple[int, ...]] = None,
                 stats: Optional[CollectiveStats] = None):
        import torch.distributed as dist

        self._dist = dist
        self.pg = pg
        world = dist.get_world_size()
        self.members = tuple(range(world)) if members is None else members
        self.size = len(self.members)
        self.rank = self.members.index(dist.get_rank())
        if members is None:
            self.axis_names, self.axis_sizes = _layout(world, mesh)
        else:
            self.axis_names, self.axis_sizes = ("x",), (self.size,)
        self.stats = CollectiveStats() if stats is None else stats
        self._subs: Dict[str, "DistGroup"] = {}
        if members is None and len(self.axis_names) > 1:
            # every process creates every sub-group, in one order
            for k, name in enumerate(self.axis_names):
                for group_ranks in _all_lines(self.axis_sizes, k):
                    pg_k = dist.new_group(list(group_ranks))
                    if dist.get_rank() in group_ranks:
                        sub = DistGroup(pg=pg_k, members=tuple(group_ranks), stats=self.stats)
                        sub.axis_names = (name,)
                        self._subs[name] = sub

    def sub(self, axis: str) -> Group:
        if self.axis_names == (axis,):
            return self
        if axis not in self._subs:
            raise ValueError(f"group has no axis {axis!r} (axes {self.axis_names})")
        return self._subs[axis]

    def _global(self, r: int) -> int:
        return self.members[r]

    def all_gather(self, x, axis):
        ax = _axis(x, axis)
        xf = x.movedim(ax, 0).contiguous()
        out = torch.empty((self.size * xf.shape[0],) + tuple(xf.shape[1:]), dtype=x.dtype,
                          device=x.device)
        self._dist.all_gather_into_tensor(out, xf, group=self.pg)
        out = out.movedim(0, ax).contiguous()
        self.stats.add(ALL_GATHER, _nbytes(out))
        return out

    def all_to_all(self, x, axis):
        ax = _axis(x, axis)
        if x.shape[ax] % self.size:
            raise ValueError(f"all_to_all: axis of {x.shape[ax]} does not split into {self.size}")
        xf = x.movedim(ax, 0).contiguous()
        out = torch.empty_like(xf)
        self._dist.all_to_all_single(out, xf, group=self.pg)
        out = out.movedim(0, ax).contiguous()
        self.stats.add(ALL_TO_ALL, _nbytes(out))
        return out

    def ppermute(self, x, perm):
        dist = self._dist
        x = x.contiguous()
        out = torch.zeros_like(x)
        ops = []
        for s, d in perm:
            if s == self.rank and d == self.rank:
                out.copy_(x)
            elif s == self.rank:
                ops.append(dist.P2POp(dist.isend, x, self._global(d), group=self.pg))
            elif d == self.rank:
                ops.append(dist.P2POp(dist.irecv, out, self._global(s), group=self.pg))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        self.stats.add(PERMUTE, _nbytes(out))
        return out

    def psum(self, x):
        out = x.contiguous().clone()
        self._dist.all_reduce(out, op=self._dist.ReduceOp.SUM, group=self.pg)
        self.stats.add(ALL_REDUCE, _nbytes(out))
        return out


def _all_lines(sizes: Tuple[int, ...], k: int):
    """Every set of world ranks along axis k (row-major), in one order."""
    stride = 1
    for n in sizes[k + 1:]:
        stride *= n
    total = 1
    for n in sizes:
        total *= n
    seen = set()
    for r in range(total):
        base = r - ((r // stride) % sizes[k]) * stride
        if base in seen:
            continue
        seen.add(base)
        yield tuple(base + i * stride for i in range(sizes[k]))


# --------------------------------------------------------------------------
# running a body on every rank
# --------------------------------------------------------------------------

def run_spmd(fn, group_or_size, *per_rank_args, device=None):
    """Run fn(group, *args_r) on every rank; returns the results by rank.

    group_or_size: a ThreadGroup (every rank runs on its own thread, each
    in a copy of the caller's context, so that a scope such as
    ops.backend.plain_versions holds on every rank), an int (a ThreadGroup
    of that size on `device`), or a DistGroup (this process's rank only:
    the other entries of the result are None).  per_rank_args: sequences
    indexed by rank; `device` is the new ThreadGroup's (None: the card).
    """
    if isinstance(group_or_size, int):
        group_or_size = ThreadGroup(group_or_size, device)
    if isinstance(group_or_size, DistGroup):
        g = group_or_size
        out = [None] * g.size
        out[g.rank] = fn(g, *(a[g.rank] for a in per_rank_args))
        return out
    team = group_or_size
    results = [None] * team.size
    errors = []
    dev = team.device

    def body(r):
        try:
            if dev.type == "cuda":
                torch.cuda.set_device(dev)
            results[r] = fn(team.handle(r), *(a[r] for a in per_rank_args))
        except BaseException as exc:  # noqa: BLE001 - re-raised in the caller
            errors.append((r, exc))
            team.abort()

    threads = [threading.Thread(target=contextvars.copy_context().run, args=(body, r),
                                name=f"gst-rank-{r}", daemon=True)
               for r in range(team.size)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        team.reset()
        first = next((e for e in errors if not isinstance(e[1], threading.BrokenBarrierError)),
                     errors[0])
        raise first[1]
    return results


# --------------------------------------------------------------------------
# processes: one rank each, over torch.distributed
# --------------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def _spawned(rank, fn, world, backend, port, outdir, mesh, args):
    import torch.distributed as dist

    if backend == "nccl":
        torch.cuda.set_device(rank)
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    try:
        group = DistGroup(mesh=mesh)
        out = fn(group, *args)
        torch.save({"result": out, "stats": group.stats.as_dict()},
                   os.path.join(outdir, f"rank{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def spawn(fn, world: int, backend: str, *args, mesh=None):
    """Run fn(group, *args) on `world` new processes, one rank each, over
    torch.distributed (``gloo``: CPU tensors; ``nccl``: rank r on card r).
    fn must be importable by name (a module-level function) and return CPU
    tensors or plain values.  Returns [(result, stats dict)] by rank.  A
    failing rank fails the call, and every process is stopped before it
    returns."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="gst_spawn_") as outdir:
        mp.start_processes(_spawned, args=(fn, world, backend, _free_port(), outdir, mesh, args),
                           nprocs=world, join=True, start_method="spawn")
        out = []
        for r in range(world):
            got = torch.load(os.path.join(outdir, f"rank{r}.pt"), weights_only=False)
            out.append((got["result"], got["stats"]))
    return out
