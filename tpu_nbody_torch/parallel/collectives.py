"""Collectives of the sharded port: its counterpart of ``jax.shard_map``
and of the ``jax.lax`` collectives that ``tpu_nbody/parallel/`` uses.

A :class:`Group` is P ranks that each run the same body (SPMD) on their
own shard and exchange tensors with :meth:`~Group.ppermute`,
:meth:`~Group.all_gather`, :meth:`~Group.psum`, :meth:`~Group.pmax`,
:meth:`~Group.psum_scatter` and :meth:`~Group.all_to_all`, with the
semantics of the ``jax.lax`` functions of those names, ``tiled`` forms
included. Two backings run the same body code:

* :class:`ThreadGroup`: P ranks as P threads of one process on one device
  (the CPU in the tests; one card, whose default stream the ranks share,
  so work one rank hands to another is ordered on the device as it was
  enqueued). The ranks run in turns and exchange tensors through a shared
  slot table.
* :class:`DistGroup`: one rank a process over ``torch.distributed``, gloo
  for CPU tensors and NCCL for CUDA tensors (one card a process). It never
  sends a CUDA tensor through gloo or a CPU tensor through NCCL.

A sharded value is a list with one entry per rank this process runs
(``group.local_ranks``: every rank for a ThreadGroup, its own for a
DistGroup); :func:`run_spmd` runs a body on each and returns the list of
results. Every collective returns a new tensor, and a body must not change
a tensor in place after handing it to one. A rank that raises aborts
the exchange, so the other ranks raise instead of waiting, and every wait
is bounded by the group's ``timeout`` (seconds).
"""

from __future__ import annotations

import os
import threading
from datetime import timedelta

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT = 300.0


class RankAborted(RuntimeError):
    """Raised in a rank whose exchange was aborted: another rank raised,
    or not every rank came within the group's timeout."""


def _check_perm(perm, size: int):
    """``perm`` as a list of (source, destination) pairs of a partial
    permutation of ``range(size)``, as ``jax.lax.ppermute`` requires."""
    perm = [(int(s), int(d)) for s, d in perm]
    srcs = [s for s, _ in perm]
    dsts = [d for _, d in perm]
    if (len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts)
            or not all(0 <= i < size for i in srcs + dsts)):
        raise ValueError(f"ppermute: {perm} is not a permutation of ranks "
                         f"0..{size - 1}")
    return perm


def _split_size(x, dim: int, size: int, what: str) -> int:
    n = x.shape[dim]
    if n % size:
        raise ValueError(f"{what}: dimension {dim} of size {n} does not "
                         f"split over {size} ranks")
    return n // size


def _tiled_only(tiled: bool, what: str):
    if not tiled:
        raise ValueError(f"{what}: only tiled=True is implemented (the "
                         f"sharded steps use no other form)")


class Group:
    """P ranks running one body each; see the module docstring.

    ``size`` is P, ``device`` the device of every rank's tensors in this
    process, ``local_ranks`` the ranks this process runs and ``rank`` the
    rank of the calling body.
    """

    size: int
    device: torch.device
    local_ranks: list
    timeout: float

    @property
    def rank(self) -> int:
        raise NotImplementedError

    def close(self):
        """Leave the group; nothing to do but for a :class:`DistGroup`."""

    def ppermute(self, x, perm):
        """``jax.lax.ppermute``: rank d receives ``x`` of the rank s with
        (s, d) in ``perm``; a rank that no pair names receives zeros."""
        raise NotImplementedError

    def all_gather(self, x, tiled: bool = False):
        """Every rank's ``x``, stacked on a new leading axis of size P
        (``tiled=True``: concatenated along axis 0)."""
        raise NotImplementedError

    def psum(self, x):
        """Elementwise sum over the ranks."""
        raise NotImplementedError

    def pmax(self, x):
        """Elementwise maximum over the ranks."""
        raise NotImplementedError

    def psum_scatter(self, x, scatter_dimension: int = 0, tiled: bool = True):
        """Sum over the ranks, then rank r keeps block r of P equal blocks
        along ``scatter_dimension``."""
        raise NotImplementedError

    def all_to_all(self, x, split_axis: int, concat_axis: int,
                   tiled: bool = True):
        """Block j of P along ``split_axis`` goes to rank j; the blocks a
        rank receives are concatenated along ``concat_axis`` in rank
        order."""
        raise NotImplementedError

    def _run(self, fn, args: list) -> list:
        raise NotImplementedError


def run_spmd(group: Group, fn, *per_rank_args) -> list:
    """Run ``fn(*args)`` once for every rank this process runs, each
    argument taken from a list with one entry per ``group.local_ranks``;
    return the list of results in that order. The body calls the group's
    collectives; the first exception a rank raises is raised here."""
    n = len(group.local_ranks)
    for a in per_rank_args:
        if len(a) != n:
            raise ValueError(f"run_spmd: {len(a)} per-rank values for "
                             f"{n} local ranks")
    return group._run(fn, [tuple(a[i] for a in per_rank_args)
                           for i in range(n)])


class ThreadGroup(Group):
    """P ranks as P threads of this process, all on ``device``.

    The ranks take turns: one runs at a time and hands a baton on at each
    collective, so one thread enqueues at a time (P threads enqueueing at
    once kept the card waiting on the host, ``PERF.md``). Each collective
    publishes the rank's tensor in a slot table; once the baton has been
    round every rank, each builds its result from the table. Two tables,
    used by alternate collectives, keep the rank that runs ahead from
    overwriting a value another has yet to read.
    """

    def __init__(self, size: int, device, timeout: float = DEFAULT_TIMEOUT):
        if size < 1:
            raise ValueError(f"a group needs at least one rank, got {size}")
        self.size = int(size)
        self.device = torch.device(device)
        self.local_ranks = list(range(self.size))
        self.timeout = float(timeout)
        self._tls = threading.local()
        self._go = [threading.Event() for _ in range(self.size)]
        self._running = threading.Lock()
        self._reset()

    def _reset(self):
        self._tables = [[None] * self.size, [None] * self.size]
        self._done = [False] * self.size
        self._aborted = False
        for e in self._go:
            e.clear()
        self._go[0].set()

    @property
    def rank(self) -> int:
        r = getattr(self._tls, "rank", None)
        if r is None:
            raise RuntimeError("a ThreadGroup collective was called outside "
                               "run_spmd")
        return r

    def _abort(self):
        self._aborted = True
        for e in self._go:
            e.set()

    def _hand_on(self):
        """Pass the baton to the next rank whose body has not returned."""
        r = self.rank
        nxt = next(((r + i) % self.size for i in range(1, self.size + 1)
                    if not self._done[(r + i) % self.size]), r)
        self._go[nxt].set()

    def _wait_turn(self):
        r = self.rank
        if not self._go[r].wait(self.timeout):
            self._abort()
            raise RankAborted(f"rank {r}: no turn within {self.timeout} s")
        self._go[r].clear()
        if self._aborted:
            raise RankAborted(f"rank {r}: the run was aborted (another rank "
                              f"raised or timed out)")

    def _exchange(self, op: str, x, combine):
        """Publish ``x``; once every rank has, return ``combine(values)``
        of the values in rank order."""
        r, k = self.rank, self._tls.seq
        self._tls.seq = k + 1
        table = self._tables[k % 2]
        table[r] = (k, op, x)
        self._hand_on()        # the baton comes back once all have published
        self._wait_turn()
        missing = [i for i, v in enumerate(table) if v is None or v[0] != k]
        if missing:
            raise RankAborted(f"ranks {missing} returned before collective "
                              f"{k} ({op})")
        ops = {v[1] for v in table}
        if len(ops) != 1:
            raise RuntimeError(f"ranks called different collectives at once: "
                               f"{sorted(ops)}")
        return combine([v[2] for v in table])

    def ppermute(self, x, perm):
        src = [s for s, d in _check_perm(perm, self.size) if d == self.rank]
        return self._exchange(
            "ppermute", x,
            lambda v: v[src[0]].clone() if src else torch.zeros_like(x))

    def all_gather(self, x, tiled: bool = False):
        join = torch.cat if tiled else torch.stack
        return self._exchange("all_gather", x, lambda v: join(v))

    def _reduce(self, op, x, fn):
        def combine(v):
            out = v[0].clone()
            for y in v[1:]:
                out = fn(out, y)
            return out
        return self._exchange(op, x, combine)

    def psum(self, x):
        return self._reduce("psum", x, torch.add)

    def pmax(self, x):
        return self._reduce("pmax", x, torch.maximum)

    def psum_scatter(self, x, scatter_dimension: int = 0, tiled: bool = True):
        _tiled_only(tiled, "psum_scatter")
        c = _split_size(x, scatter_dimension, self.size, "psum_scatter")
        r = self.rank

        def combine(v):
            out = v[0].narrow(scatter_dimension, r * c, c).clone()
            for y in v[1:]:
                out += y.narrow(scatter_dimension, r * c, c)
            return out
        return self._exchange("psum_scatter", x, combine)

    def all_to_all(self, x, split_axis: int, concat_axis: int,
                   tiled: bool = True):
        _tiled_only(tiled, "all_to_all")
        c = _split_size(x, split_axis, self.size, "all_to_all")
        r = self.rank
        return self._exchange(
            "all_to_all", x,
            lambda v: torch.cat([y.narrow(split_axis, r * c, c) for y in v],
                                dim=concat_axis))

    def _run(self, fn, args: list) -> list:
        if not self._running.acquire(blocking=False):
            raise RuntimeError("run_spmd on a ThreadGroup that is already "
                               "running one")
        try:
            return self._run_threads(fn, args)
        finally:
            self._running.release()

    def _run_threads(self, fn, args: list) -> list:
        results = [None] * self.size
        errors = [None] * self.size
        self._reset()

        def body(r):
            self._tls.rank, self._tls.seq = r, 0
            try:
                self._wait_turn()
                results[r] = fn(*args[r])
            except BaseException as e:  # noqa: BLE001 re-raised by the caller
                errors[r] = e
                self._abort()
            finally:
                self._done[r] = True
                self._hand_on()
                self._tls.rank = None

        if self.size == 1:
            body(0)
        else:
            threads = [threading.Thread(target=body, args=(r,), daemon=True,
                                        name=f"spmd-rank-{r}")
                       for r in range(self.size)]
            for t in threads:
                t.start()
            for t in threads:      # every wait inside is bounded
                t.join()
        failed = [e for e in errors if e is not None]
        if failed:
            # the first rank that failed on its own, not of the abort
            raise next((e for e in failed if not isinstance(e, RankAborted)),
                       failed[0])
        return results


class DistGroup(Group):
    """This process as one rank of ``torch.distributed``'s default group
    (initialised by the caller or by :func:`~tpu_nbody_torch.parallel.mesh.
    make_mesh`). CUDA tensors need the NCCL backend and CPU tensors gloo.
    ``owns`` says that the group was initialised for this object, which
    :meth:`close` then tears down."""

    def __init__(self, device, timeout: float = DEFAULT_TIMEOUT,
                 owns: bool = False):
        if not dist.is_initialized():
            raise RuntimeError("DistGroup needs torch.distributed."
                               "init_process_group first")
        self.device = torch.device(device)
        self.backend = dist.get_backend()
        want = "nccl" if self.device.type == "cuda" else "gloo"
        if self.backend != want:
            raise ValueError(f"{self.device.type} tensors need the {want} "
                             f"backend, the process group has "
                             f"{self.backend!r}")
        self.size = dist.get_world_size()
        self._rank = dist.get_rank()
        self.local_ranks = [self._rank]
        self.timeout = float(timeout)   # as given to init_process_group
        self._owns = owns
        if self.backend == "nccl" and self.size > 1:
            # NCCL sets up point-to-point links in the first send/receive
            # batch, which every rank must join: a ring shift does that
            self.ppermute(torch.zeros(1, device=self.device),
                          [(i, (i + 1) % self.size) for i in range(self.size)])

    @property
    def rank(self) -> int:
        return self._rank

    def close(self):
        """A barrier, so that no rank leaves while another still talks to
        it, then ``destroy_process_group``, when the group was initialised
        for this object; a second call does nothing. A process that exits
        with the group alive can abort in the backend's teardown."""
        if self._owns and dist.is_initialized():
            dist.barrier()
            dist.destroy_process_group()
        self._owns = False

    def _wire(self, x):
        """``x`` as a contiguous tensor the backend carries: bool as uint8,
        complex as its real view."""
        if x.device != self.device:
            raise ValueError(f"tensor on {x.device}, this rank's group runs "
                             f"on {self.device}")
        if x.dtype == torch.bool:
            return x.to(torch.uint8).contiguous()
        if x.is_complex():
            return torch.view_as_real(x.contiguous()).clone()
        return x.contiguous().clone()

    @staticmethod
    def _unwire(y, like):
        if like.dtype == torch.bool:
            return y.to(torch.bool)
        if like.is_complex():
            return torch.view_as_complex(y.contiguous())
        return y

    def ppermute(self, x, perm):
        perm = _check_perm(perm, self.size)
        w = self._wire(x)
        out = torch.zeros_like(w)
        ops = []
        for s, d in perm:
            if s == d == self._rank:
                out.copy_(w)
            elif s == self._rank:
                ops.append(dist.P2POp(dist.isend, w, d))
            elif d == self._rank:
                ops.append(dist.P2POp(dist.irecv, out, s))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return self._unwire(out, x)

    def all_gather(self, x, tiled: bool = False):
        w = self._wire(x)
        parts = [torch.empty_like(w) for _ in range(self.size)]
        dist.all_gather(parts, w)
        out = torch.cat(parts) if tiled else torch.stack(parts)
        return self._unwire(out, x)

    def _all_reduce(self, x, op):
        w = self._wire(x)
        dist.all_reduce(w, op=op)
        return self._unwire(w, x)

    def psum(self, x):
        return self._all_reduce(x, dist.ReduceOp.SUM)

    def pmax(self, x):
        return self._all_reduce(x, dist.ReduceOp.MAX)

    def psum_scatter(self, x, scatter_dimension: int = 0, tiled: bool = True):
        _tiled_only(tiled, "psum_scatter")
        _split_size(x, scatter_dimension, self.size, "psum_scatter")
        w = self._wire(x.movedim(scatter_dimension, 0))
        out = torch.empty((w.shape[0] // self.size, *w.shape[1:]),
                          dtype=w.dtype, device=w.device)
        dist.reduce_scatter_tensor(out, w)
        return self._unwire(out, x).movedim(0, scatter_dimension)

    def all_to_all(self, x, split_axis: int, concat_axis: int,
                   tiled: bool = True):
        _tiled_only(tiled, "all_to_all")
        _split_size(x, split_axis, self.size, "all_to_all")
        w = self._wire(x.movedim(split_axis, 0))
        out = torch.empty_like(w)
        dist.all_to_all_single(out, w)
        blocks = self._unwire(out, x).chunk(self.size)
        return torch.cat([b.movedim(0, split_axis) for b in blocks],
                         dim=concat_axis)

    def _run(self, fn, args: list) -> list:
        return [fn(*args[0])]


def init_dist(device, timeout: float = DEFAULT_TIMEOUT,
              init_method: str | None = None):
    """Initialise ``torch.distributed`` from the environment ``torchrun``
    sets (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``,
    ``LOCAL_RANK``) with NCCL for a CUDA device and gloo for the CPU, and
    return this process's device (``cuda:LOCAL_RANK`` for CUDA).
    ``init_method`` (e.g. ``file:///shared/path``) replaces the TCP
    rendezvous at ``MASTER_ADDR:MASTER_PORT``; rank and world size still
    come from ``RANK`` and ``WORLD_SIZE``."""
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        where = {}
        if init_method is not None:
            where = dict(init_method=init_method,
                         rank=int(os.environ["RANK"]),
                         world_size=int(os.environ["WORLD_SIZE"]))
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                timeout=timedelta(seconds=timeout), **where)
    return dev
