"""The process-group layer of the port's tensor and data parallelism, and
the ring all-gather matmul (counterpart of ``repro.distributed.collectives``).

One process runs one rank.  Code names a mesh axis by a plain string, as
the reference's ``shard_map`` bodies do (the config keeps ``tp_axis:
str``), and this module keeps the registry from that name to the
axis's ``torch.distributed`` group, this process's index on it and its
size.  ``psum`` / ``pmax`` / ``all_gather`` / ``ppermute`` are the
reference's ``lax`` collectives over such a name.

Which backend runs is the caller's explicit choice (``spawn``'s
``backend``): ``nccl`` when every rank has a card of its own, ``gloo``
for ranks on the CPU and for ranks that share a card.  Nothing falls
back: ``nccl`` with more ranks than visible cards raises and names the
flag that selects gloo.  Under gloo a CUDA tensor takes gloo's own CUDA
path (a copy to the host, the host algorithm, a copy back) for the
collectives in ``GLOO_CUDA_NATIVE``; the point-to-point ``ppermute``,
which gloo would run on the device pointer as if it were host memory,
is staged through pinned host memory here, by name
(``GLOO_HOST_STAGED``).  ``probe_gloo_cuda`` checks on the card that the
native ones agree with their CPU result.

``metered()`` counts the collectives a block issues, sums the bytes of
their results and times them (CUDA events around each NCCL call, the
host clock around each synchronous gloo call), for the per-step figures
of ``chip_smoke.py`` and ``launch/trace.py``; outside it the collectives
carry no timing.

A planning axis (``register_plan``, inside ``planning()``) has sizes but
no process group, for the dry-run planner (``launch/dryrun.py``) to
trace one rank's program: each collective over it is metered as above
(its kind and result bytes) and moves nothing.  A ``psum`` or ``pmax``
gives its input back, an ``all_gather`` the concatenation of as many
copies as the axis has ranks, a ``ppermute`` a copy of its input.

``ag_matmul_local`` computes ``all_gather(x) @ w`` as a ring: each step
multiplies the chunk held against the matching rows of ``w`` while the
next chunk is in flight (``dist.batch_isend_irecv``).  Nothing on the
decode path calls it; it is the reference's overlap primitive.
"""
from __future__ import annotations

import contextlib
import os
import shutil
import tempfile
import time
from collections import defaultdict
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

# gloo's CUDA path (copy to host, host algorithm, copy back), used as is
GLOO_CUDA_NATIVE = frozenset({"psum", "pmax", "all_gather"})
# staged through pinned host memory by this module under gloo
GLOO_HOST_STAGED = frozenset({"ppermute"})
BACKENDS = ("nccl", "gloo")
PLAN = "plan"            # the backend name of a planning axis


class Axis(NamedTuple):
    """One named mesh axis as this process sees it."""
    name: str
    group: object            # the torch.distributed ProcessGroup
    rank: int                # this process's index along the axis
    size: int
    backend: str
    ranks: tuple             # the group's global ranks, in axis order


_AXES: dict = {}


def register(name: str, ranks, backend: str, group=None) -> Axis:
    """Register axis ``name`` over the global ``ranks`` (this process among
    them) with its ``group`` (default: the whole world)."""
    ranks = tuple(int(r) for r in ranks)
    me = dist.get_rank()
    if me not in ranks:
        raise ValueError(f"rank {me} is not on axis {name!r} {ranks}")
    ax = Axis(name, group if group is not None else dist.group.WORLD,
              ranks.index(me), len(ranks), backend, ranks)
    _AXES[name] = ax
    return ax


def register_plan(name: str, size: int, rank: int = 0) -> Axis:
    """Register planning axis ``name`` of ``size`` ranks, this process at
    index ``rank`` on it, with no process group (see the module's
    docstring)."""
    if not 0 <= rank < size:
        raise ValueError(f"rank {rank} is not on an axis of {size}")
    ax = Axis(name, None, int(rank), int(size), PLAN, tuple(range(size)))
    _AXES[name] = ax
    return ax


@contextlib.contextmanager
def planning():
    """A block whose ``register_plan`` calls are undone at its end: the
    registry is restored to what it held before."""
    saved = dict(_AXES)
    try:
        yield
    finally:
        _AXES.clear()
        _AXES.update(saved)


def clear():
    """Forget every registered axis (before the process group goes)."""
    _AXES.clear()


def axis(name: str) -> Axis:
    try:
        return _AXES[name]
    except KeyError:
        raise ValueError(
            f"no process group is registered for axis {name!r}: start the "
            "ranks with collectives.spawn and build the groups with "
            "tp.make_tp_group (or collectives.register)") from None


def axis_index(name: str) -> int:
    """This process's index along ``name`` (``lax.axis_index``): a host
    int, fixed for the process's life."""
    return axis(name).rank


# ---------------------------------------------------------------------------
# metering
# ---------------------------------------------------------------------------

class Meter:
    """Counts, result bytes and times of the collectives issued inside
    ``metered()``, by op name.  ``ms()`` waits for the recorded CUDA
    events."""

    def __init__(self):
        self.count = defaultdict(int)
        self.bytes = defaultdict(int)
        self._host_ms = defaultdict(float)
        self._events = []

    def ms(self) -> dict:
        out = defaultdict(float, self._host_ms)
        if self._events:
            torch.cuda.synchronize()
        for op, e0, e1 in self._events:
            out[op] += e0.elapsed_time(e1)
        return dict(out)

    def total(self):
        """(count, ms) over every op."""
        return sum(self.count.values()), sum(self.ms().values())


_METER: Optional[Meter] = None


@contextlib.contextmanager
def metered():
    """Meter the collectives issued in the block: yields a ``Meter``."""
    global _METER
    prev, _METER = _METER, Meter()
    try:
        yield _METER
    finally:
        _METER = prev


def _run(op: str, ax: Axis, x, call, nbytes: int):
    """``call()`` (one collective over ``x`` whose result holds ``nbytes``),
    metered when a meter is on; on a planning axis only metered."""
    m = _METER
    if m is not None:
        m.count[op] += 1
        m.bytes[op] += nbytes
    if ax.backend == PLAN:
        return None
    if m is None:
        return call()
    if x.is_cuda and ax.backend == "nccl":
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = call()
        e1.record()
        m._events.append((op, e0, e1))
        return out
    if x.is_cuda:
        torch.cuda.synchronize(x.device)
    t0 = time.perf_counter()
    out = call()
    if x.is_cuda:
        torch.cuda.synchronize(x.device)
    m._host_ms[op] += (time.perf_counter() - t0) * 1e3
    return out


def _pinned(x):
    h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    h.copy_(x)
    return h


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

def psum_(x, axis_name: str):
    """Sum ``x`` over the axis, in place when ``x`` is contiguous (else in
    a contiguous copy); returns the sum."""
    ax = axis(axis_name)
    if not x.is_contiguous():
        x = x.contiguous()
    _run("psum", ax, x,
         lambda: dist.all_reduce(x, op=dist.ReduceOp.SUM, group=ax.group),
         x.nbytes)
    return x


def psum(x, axis_name: str):
    """``lax.psum``: the sum of ``x`` over the axis, as a new tensor."""
    return psum_(x.clone(memory_format=torch.contiguous_format), axis_name)


def pmax(x, axis_name: str):
    """``lax.pmax``: the elementwise max of ``x`` over the axis."""
    ax = axis(axis_name)
    out = x.clone(memory_format=torch.contiguous_format)
    _run("pmax", ax, out,
         lambda: dist.all_reduce(out, op=dist.ReduceOp.MAX, group=ax.group),
         out.nbytes)
    return out


def all_gather(x, axis_name: str, dim: int = 0, tiled: bool = True):
    """``lax.all_gather``: every rank's ``x`` in axis order, concatenated
    along ``dim`` (``tiled``) or stacked on a new axis at ``dim``."""
    ax = axis(axis_name)
    x = x.contiguous()
    if ax.backend == PLAN:
        parts = [x] * ax.size
    else:
        parts = [torch.empty_like(x) for _ in range(ax.size)]
    _run("all_gather", ax, x,
         lambda: dist.all_gather(parts, x, group=ax.group),
         x.nbytes * ax.size)
    dim = dim % (x.dim() + (0 if tiled else 1))
    return torch.cat(parts, dim) if tiled else torch.stack(parts, dim)


def _ppermute_start(x, ax: Axis, perm):
    """Post the sends and receives of ``ppermute``: -> (the send and
    receive buffers, kept alive until the works finish; the works; the
    device to copy a staged receive back to, or None; whether this rank
    receives)."""
    me = ax.rank
    dst = [d for s, d in perm if s == me]
    src = [s for s, d in perm if d == me]
    staged = (x.is_cuda and ax.backend == "gloo"
              and "ppermute" in GLOO_HOST_STAGED)
    send = _pinned(x) if staged else x.contiguous()
    recv = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send, ax.ranks[d], ax.group) for d in dst]
    ops += [dist.P2POp(dist.irecv, recv, ax.ranks[s], ax.group) for s in src]
    works = dist.batch_isend_irecv(ops) if ops else []
    return (send, recv), works, (x.device if staged else None), bool(src)


def _ppermute_finish(x, pending):
    (_, recv), works, staged_dev, received = pending
    for w in works:
        w.wait()
    if not received:
        return torch.zeros_like(x)
    return recv.to(staged_dev) if staged_dev is not None else recv


def ppermute(x, axis_name: str, perm):
    """``lax.ppermute``: each (source, destination) pair of ``perm`` (axis
    indices) sends the source's ``x`` to the destination; a rank that
    receives nothing gets zeros."""
    ax = axis(axis_name)
    out = _run("ppermute", ax, x,
               lambda: _ppermute_finish(x, _ppermute_start(x, ax, perm)),
               x.nbytes)
    return x.clone() if ax.backend == PLAN else out


# ---------------------------------------------------------------------------
# ring all-gather matmul
# ---------------------------------------------------------------------------

def ag_matmul_local(x_loc, w, axis_name: str):
    """On each rank: ``x_loc`` [..., k_loc] (this rank's slice of x's last
    dimension, slices in axis order), ``w`` [k_glob, n] replicated.
    Returns all_gather(x) @ w without gathering x: step s multiplies the
    chunk from rank (idx + s) % N against its rows of ``w`` while the
    next chunk is received from the right neighbour."""
    ax = axis(axis_name)
    N, idx = ax.size, ax.rank
    k_loc = x_loc.shape[-1]
    y = torch.zeros(x_loc.shape[:-1] + (w.shape[-1],),
                    dtype=torch.promote_types(x_loc.dtype, w.dtype),
                    device=x_loc.device)
    perm = [(i, (i - 1) % N) for i in range(N)]   # receive the next chunk
    chunk = x_loc
    for step in range(N):
        pending = (_ppermute_start(chunk, ax, perm) if step != N - 1
                   else None)
        src = (idx + step) % N                     # chunk currently held
        rows = w[src * k_loc:(src + 1) * k_loc]
        y = y + torch.einsum("...k,kn->...n", chunk.to(y.dtype),
                             rows.to(y.dtype))
        if pending is not None:
            chunk = _run("ppermute", ax, chunk,
                         lambda: _ppermute_finish(chunk, pending),
                         chunk.nbytes)
    return y


def ag_matmul(x, w, axis_name: str = "model"):
    """``x`` [..., k] (the same on every rank) sharded on its last
    dimension over ``axis_name``: this rank keeps its slice and the ring
    computes ``x @ w``."""
    from repro_torch.distributed.sharding import shard_leaf
    spec = (None,) * (x.dim() - 1) + (axis_name,)
    ax = axis(axis_name)
    return ag_matmul_local(shard_leaf(x, spec, ax.rank, ax.size), w,
                           axis_name)


# ---------------------------------------------------------------------------
# starting the ranks
# ---------------------------------------------------------------------------

def check_backend(backend: str, ranks: int, device="cuda"):
    """Refuse a backend that cannot run ``ranks`` ranks on ``device``:
    nccl wants one card per rank.  Nothing is chosen for the caller."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}: {BACKENDS}")
    if backend != "nccl":
        return
    if torch.device(device).type != "cuda":
        raise ValueError("nccl runs ranks on cards; pass --tp-backend gloo "
                         "for ranks on the CPU")
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < ranks:
        raise ValueError(f"nccl needs one card per rank: {ranks} ranks, {n} "
                         f"card(s) visible; pass --tp-backend gloo to run "
                         f"the ranks on shared cards")


def rank_device(backend: str, rank: int, device="cuda") -> torch.device:
    """The device of global ``rank``: the CPU when asked for; else card
    ``rank`` (nccl, one card per rank) or ``rank`` modulo the visible
    cards (gloo: ranks share them)."""
    from repro_torch.runtime import resolve_device
    dev = resolve_device(device)
    if dev.type == "cpu":
        return dev
    return torch.device("cuda", rank % torch.cuda.device_count())


class Ranks:
    """Spawned ranks; ``join()`` waits for them and returns each rank's
    result, in rank order (a failed rank raises with its traceback)."""

    def __init__(self, ctx, tmp: str, world: int):
        self.ctx, self.tmp, self.world = ctx, tmp, world

    def join(self, timeout: Optional[float] = None) -> list:
        """Wait for every rank; past ``timeout`` seconds (None: no limit)
        terminate them and raise ``TimeoutError`` (a rank that waits in a
        collective its peers never issue waits for ever)."""
        end = None if timeout is None else time.monotonic() + timeout
        try:
            while not self.ctx.join(timeout=1.0):
                if end is not None and time.monotonic() > end:
                    for p in self.ctx.processes:
                        if p.is_alive():
                            p.terminate()
                    raise TimeoutError(f"ranks still running after "
                                       f"{timeout} s; terminated")
            return [torch.load(os.path.join(self.tmp, f"rank{r}.pt"),
                               weights_only=False)
                    for r in range(self.world)]
        finally:
            shutil.rmtree(self.tmp, ignore_errors=True)


def _rank_main(rank, fn, world, backend, device, tmp, threads, args):
    if threads:
        torch.set_num_threads(threads)
    dev = rank_device(backend, rank, device)
    if dev.type == "cuda":
        # before the first launch: the kernels raise their shared-memory
        # limits on, and launch on, the current device
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method="file://" + os.path.join(
        tmp, "store"), rank=rank, world_size=world)
    try:
        out = fn(rank, world, dev, *args)
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        clear()
        dist.destroy_process_group()


def spawn(fn, world: int, *, backend: str, device="cuda", args=(),
          threads: int = 0, join: bool = True,
          timeout: Optional[float] = None):
    """Run ``fn(rank, world, device, *args)`` in ``world`` new processes,
    one a rank, joined through a ``FileStore`` in a fresh temporary
    directory (no port is opened).  ``backend`` is "nccl" or "gloo" and is
    checked against the visible cards first; each rank's device comes
    from ``rank_device`` and is made current before ``fn`` runs.
    ``threads`` > 0 sets each rank's intra-op threads.  ``fn`` must be
    importable by name (a module-level function) and return picklable
    values.  Returns the ranks' results (``join``, waiting at most
    ``timeout`` seconds) or the ``Ranks``."""
    from repro_torch.runtime import resolve_device
    check_backend(backend, world, device)
    resolve_device(device)          # no card: raise here, before any rank
    tmp = tempfile.mkdtemp(prefix="repro_torch_ranks_")
    ctx = torch.multiprocessing.start_processes(
        _rank_main, args=(fn, world, backend, str(device), tmp, threads,
                          tuple(args)),
        nprocs=world, join=False, start_method="spawn")
    ranks = Ranks(ctx, tmp, world)
    return ranks.join(timeout) if join else ranks


# ---------------------------------------------------------------------------
# the card check of gloo's CUDA path
# ---------------------------------------------------------------------------

def probe_gloo_cuda(axis_name: str, device) -> dict:
    """On every rank of a gloo axis: each collective of
    ``GLOO_CUDA_NATIVE`` run on a CUDA tensor, held equal to the same
    collective on the CPU, and each of ``GLOO_HOST_STAGED`` through its
    staging.  -> {op: "native" | "staged"}; raises where a result
    differs."""
    ax = axis(axis_name)
    gen = torch.Generator().manual_seed(ax.rank)
    x = torch.randn((3, 5), generator=gen)
    perm = [(i, (i + 1) % ax.size) for i in range(ax.size)]
    calls = {"psum": lambda t: psum(t, axis_name),
             "pmax": lambda t: pmax(t, axis_name),
             "all_gather": lambda t: all_gather(t, axis_name, 0, False),
             "ppermute": lambda t: ppermute(t, axis_name, perm)}
    out = {}
    for op, call in calls.items():
        got = call(x.to(device)).cpu()
        want = call(x)
        if not torch.equal(got, want):
            raise RuntimeError(f"gloo {op} on CUDA tensors differs from the "
                               f"CPU result")
        out[op] = "native" if op in GLOO_CUDA_NATIVE else "staged"
    return out
