"""The ring and the grid: the port's counterparts of the JAX package's mesh
axes.

One process per device in a ``torch.distributed`` group (NCCL on the card,
gloo on the CPU). Where JAX's shard_map bodies call ``lax.pmax`` /
``psum`` / ``all_gather`` / ``axis_index`` over a mesh axis, the port calls
the functions below with ``axis=``: ``"model"`` (the default), ``"data"``,
``"pod"`` or a tuple of them in that order of nesting, ``("pod", "data",
"model")`` (``ALL``) being the whole group.

Without ``grid`` the group is the ring: its one axis is ``"model"`` and
every other axis has size 1. ``grid(n_data, n_model, n_pod=1)`` splits the
group into one sub-group per mesh axis (and per tuple of axes): member
(p, d, m) is process ``(p * n_data + d) * n_model + m``, the JAX mesh's
row-major device order, so it holds what JAX device ``d * n_model + m``
holds. With no process group initialised every axis has size 1 and every
collective is the identity, so the same bodies run in a single process
(``grid(1, 1)`` there declares a grid of one).

Autograd through the collectives follows JAX's transposes inside
``shard_map(..., check_vma=False)``, which the JAX trainer runs under:

* ``psum``: the backward sums the cotangent over the axis. A loss that is
  replicated on every member therefore contributes one cotangent per
  member, and the head gradient grows with the ring size (ROADMAP.md C.1);
  the port keeps that, as the reference does.
* ``all_gather`` (tiled or stacked): the backward reduce-scatters the
  cotangent (sums it over the axis, keeps this member's slice).
* ``pmax`` / ``pmin``: no gradient (their results are detached).

The zoo trainer differentiates outside its head's body, as the JAX zoo
differentiates outside its shard_map, and its gradient is that of the
mean loss whatever the grid (the JAX package's, at n_model 1, 2 and 4):
``pvary`` (the identity, its backward a ``psum``) carries the replicated
features into the head, ``grad_mean`` (the identity, its backward over
the axes' size) carries the replicated loss out, and ``shard_rows`` cuts
a replicated table's row block, its backward an all-gather, so every
member's copy gets the whole gradient. Inside a tensor-parallel trunk
every member holds the whole cotangent of a value the model axis holds
alike: ``pvary`` opens a region where members work on their own slices
(a column-parallel product), and ``psum_invariant`` (a sum whose backward
is the identity) closes it (a row-parallel product), or
``all_gather_invariant`` (a gather whose backward keeps the member's
block) where the next step needs every member's columns.

The functions are written by hand, not taken from
``torch.distributed.nn``, whose backward rules differ between versions. A
gloo group cannot run every collective on CUDA tensors (two processes on
one card, where NCCL refuses the pair, take gloo): on a gloo group a CUDA
tensor's collective is staged through pinned host memory, its result
copied back to the card; an NCCL group never takes that branch.

``all_gather_start`` / ``reduce_scatter_start`` start the tiled gather
and its backward's reduce-scatter in the background and return a
``Pending`` whose ``wait()`` gives the result, so a schedule can compute
while they are in flight (``core.pipeline``); ``record_async()`` records
the order of starts and waits, ``wait_seconds()`` the host's time blocked
in the gathers.

``count_collectives()`` counts the bytes of every collective called
inside it, where it is called, as the comm ledger charges them (the
output's bytes, by kind: all-reduce for ``psum`` / ``pmax`` / ``pmin``
and the backward of ``psum`` / ``pvary``; all-gather for ``all_gather``,
``all_gather_invariant`` and ``shard_rows``' backward; reduce-scatter
for ``all_gather``'s backward; collective-permute for ``ppermute``).
``simulated_ring(n, r)`` makes this process member r of a ring of n that
exists only in shapes,
``simulated_grid(n_data, n_model, n_pod)`` member (0, 0, 0) of such a
grid: on meta tensors every collective returns an empty meta tensor of its
output's shape and is counted, and on any other tensor it raises. The dry
run (``launch.dryrun``) lowers one member's step on them, where the JAX
package compiles for placeholder devices.
"""
from __future__ import annotations

import contextlib
import itertools
import math
import os
import queue
import tempfile
import time
import traceback

import torch
import torch.distributed as tdist

AXES = ("pod", "data", "model")
ALL = AXES
# the axes a batch's rows are split over
BATCH = ("pod", "data")
# {"sizes": {axis: n}, "index": {axis: i}} while a simulated ring or grid
# is active (``simulated_ring``, ``simulated_grid``)
_SIM = None
# {"sizes", "index", "groups": {axes: ProcessGroup}} once ``grid`` ran
_GRID = None
# the active collective counts (``count_collectives``)
_COUNTS: list = []
# host seconds this process spent blocked in gathers and reduce-scatters
# (``wait_seconds``)
_WAIT_S = [0.0]


def _pg_active() -> bool:
    return tdist.is_available() and tdist.is_initialized()


def _active() -> bool:
    return _SIM is not None or _pg_active()


def _axes(axis) -> tuple:
    """An axis name or a tuple of them, as a tuple in the grid's nesting
    order."""
    names = (axis,) if isinstance(axis, str) else tuple(axis)
    for a in names:
        if a not in AXES:
            raise ValueError(f"unknown mesh axis {a!r}; axes: {AXES}")
    if list(names) != sorted(names, key=AXES.index):
        raise ValueError(f"axes {names} are not in the order {AXES}")
    return names


def _layout() -> tuple:
    """({axis: size}, {axis: index}) of this process."""
    if _SIM is not None:
        return _SIM["sizes"], _SIM["index"]
    if _GRID is not None:
        return _GRID["sizes"], _GRID["index"]
    if _pg_active():
        return ({"pod": 1, "data": 1, "model": tdist.get_world_size()},
                {"pod": 0, "data": 0, "model": tdist.get_rank()})
    return {a: 1 for a in AXES}, {a: 0 for a in AXES}


def grid_shape() -> tuple:
    """(n_pod, n_data, n_model) of this process's grid (the ring: (1, 1,
    its size))."""
    sizes, _ = _layout()
    return tuple(sizes[a] for a in AXES)


def grid_declared() -> bool:
    """Whether ``grid`` (or ``simulated_grid``) laid this process out on a
    (pod, data, model) grid, rather than the plain ring."""
    return _GRID is not None or (_SIM is not None and _SIM["grid"])


def world_size(axis="model") -> int:
    """The size of ``axis`` (a name or a tuple of names; ``ALL``: the
    whole group)."""
    sizes, _ = _layout()
    return math.prod(sizes[a] for a in _axes(axis))


def rank(axis="model") -> int:
    """This member's index on ``axis``; over a tuple of axes the row-major
    flat index (JAX's ``axis_index`` over several axes)."""
    sizes, index = _layout()
    idx = 0
    for a in _axes(axis):
        idx = idx * sizes[a] + index[a]
    return idx


def flat_axis_index(axis="model") -> int:
    """This member's index on ``axis`` (JAX: ``lax.axis_index``)."""
    return rank(axis)


def _trivial(axes: tuple) -> bool:
    """Whether a collective over ``axes`` is the identity: no group, or
    axes of size 1, except the plain ring's, whose collectives run even on
    a ring of one, as they always have, so their counts hold."""
    if not _active():
        return True
    if axes == ("model",) and not grid_declared():
        return False
    return world_size(axes) == 1


def _global_rank(index: dict) -> int:
    sizes, _ = _layout()
    r = 0
    for a in AXES:
        r = r * sizes[a] + index[a]
    return r


def grid(n_data: int, n_model: int, n_pod: int = 1) -> tuple:
    """Lay this process group out as a (pod, data, model) grid of
    ``n_pod * n_data * n_model`` members (every member calls it, in the
    same order as any other group call): one sub-group per axis and per
    tuple of axes whose size is neither 1 nor the whole group. Without a
    process group, only the grid of one. Returns this member's (pod,
    data, model) index."""
    global _GRID
    sizes = {"pod": n_pod, "data": n_data, "model": n_model}
    if min(sizes.values()) < 1:
        raise ValueError(f"grid sizes must be positive, got {sizes}")
    world = math.prod(sizes.values())
    if _SIM is not None:
        raise RuntimeError("a grid inside a simulated one")
    if not _pg_active():
        if world != 1:
            raise RuntimeError(f"a grid of {world} members needs a process "
                               f"group of {world}")
        _GRID = {"sizes": sizes, "index": {a: 0 for a in AXES},
                 "groups": {}}
        return (0, 0, 0)
    if tdist.get_world_size() != world:
        raise ValueError(f"a ({n_pod}, {n_data}, {n_model}) grid needs "
                         f"{world} processes, the group has "
                         f"{tdist.get_world_size()}")
    me = tdist.get_rank()
    index, r = {}, me
    for a in reversed(AXES):
        index[a] = r % sizes[a]
        r //= sizes[a]
    groups = {}
    for k in range(1, len(AXES) + 1):
        for combo in itertools.combinations(AXES, k):
            n = math.prod(sizes[a] for a in combo)
            if n in (1, world):
                continue
            rest = [a for a in AXES if a not in combo]
            for fixed in itertools.product(*(range(sizes[a]) for a in rest)):
                members = []
                for vals in itertools.product(*(range(sizes[a])
                                                for a in combo)):
                    idx = dict(zip(rest, fixed))
                    idx.update(zip(combo, vals))
                    rr = 0
                    for a in AXES:
                        rr = rr * sizes[a] + idx[a]
                    members.append(rr)
                g = tdist.new_group(sorted(members))
                if me in members:
                    groups[combo] = g
    _GRID = {"sizes": sizes, "index": index, "groups": groups}
    return tuple(index[a] for a in AXES)


def release_grid() -> None:
    """Forget the grid (the process group stays): the plain ring again."""
    global _GRID
    _GRID = None


def _group(axes: tuple):
    """The process group of ``axes`` (None: the whole group)."""
    if world_size(axes) == tdist.get_world_size():
        return None
    if _GRID is None:
        raise RuntimeError(f"no grid: axes {axes} name no group")
    return _GRID["groups"][axes]


@contextlib.contextmanager
def simulated_ring(n: int, r: int = 0):
    """Act as member ``r`` of a ring of ``n`` whose collectives move
    shapes only (meta tensors; module docstring)."""
    global _SIM
    if not 0 <= r < n:
        raise ValueError(f"rank {r} is not on a ring of {n}")
    if _pg_active():
        raise RuntimeError("a simulated ring inside a process group")
    prev, _SIM = _SIM, {"sizes": {"pod": 1, "data": 1, "model": n},
                        "index": {"pod": 0, "data": 0, "model": r},
                        "grid": False}
    try:
        yield
    finally:
        _SIM = prev


@contextlib.contextmanager
def simulated_grid(n_data: int, n_model: int, n_pod: int = 1):
    """Act as member (0, 0, 0) of a (pod, data, model) grid whose
    collectives move shapes only (meta tensors; module docstring)."""
    global _SIM
    if _pg_active():
        raise RuntimeError("a simulated grid inside a process group")
    prev, _SIM = _SIM, {"sizes": {"pod": n_pod, "data": n_data,
                                  "model": n_model},
                        "index": {a: 0 for a in AXES}, "grid": True}
    try:
        yield
    finally:
        _SIM = prev


@contextlib.contextmanager
def count_collectives():
    """Yields a dict that fills, as collectives run inside, with
    ``{kind: {"bytes", "count"}}`` and ``"total_bytes"``: the layout of
    ``telemetry.CommLedger.per_kind``, so the two compare directly."""
    counts = {"total_bytes": 0.0}
    _COUNTS.append(counts)
    try:
        yield counts
    finally:
        _COUNTS.remove(counts)


def _charge(kind: str, out: torch.Tensor) -> torch.Tensor:
    _charge_bytes(kind, float(out.numel() * out.element_size()))
    return out


def _charge_bytes(kind: str, nbytes: float) -> None:
    for counts in _COUNTS:
        slot = counts.setdefault(kind, {"bytes": 0.0, "count": 0})
        slot["bytes"] += nbytes
        slot["count"] += 1
        counts["total_bytes"] += nbytes


def _simulated(x: torch.Tensor, shape) -> torch.Tensor:
    """A collective's output on the simulated ring."""
    if x.device.type != "meta":
        raise RuntimeError(f"the simulated ring moves meta tensors only, "
                           f"got one on {x.device}")
    return torch.empty(shape, dtype=x.dtype, device="meta")


def _staged(group, x: torch.Tensor) -> bool:
    """Whether ``x``'s collective on ``group`` goes through host memory: a
    CUDA tensor on a gloo group (module docstring)."""
    return x.is_cuda and tdist.get_backend(group) == "gloo"


def _host(x: torch.Tensor) -> torch.Tensor:
    h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    return h.copy_(x)


def barrier() -> None:
    """Wait until every member of the group reaches this point (a
    checkpoint's readers wait for its writer); nothing to wait for alone."""
    if _pg_active() and _SIM is None:
        tdist.barrier()


def _all_reduce(x: torch.Tensor, op, axes: tuple = ("model",)):
    if _SIM is not None:
        return _charge("all-reduce", _simulated(x, x.shape))
    out = x.detach().clone().contiguous()
    group = _group(axes)
    if _staged(group, out):
        h = _host(out)
        tdist.all_reduce(h, op=op, group=group)
        out.copy_(h)
    else:
        tdist.all_reduce(out, op=op, group=group)
    return _charge("all-reduce", out)


def _gather(x: torch.Tensor, dim: int, tiled: bool,
            axes: tuple = ("model",)) -> torch.Tensor:
    n = world_size(axes)
    if _SIM is not None:
        shape = list(x.shape)
        if tiled:
            shape[dim] *= n
        else:
            shape.insert(dim if dim >= 0 else dim + x.dim() + 1, n)
        return _charge("all-gather", _simulated(x, shape))
    t0 = time.perf_counter()
    x = x.detach().contiguous()
    group = _group(axes)
    src = _host(x) if _staged(group, x) else x
    parts = [torch.empty_like(src) for _ in range(n)]
    tdist.all_gather(parts, src, group=group)
    out = torch.cat(parts, dim=dim) if tiled else torch.stack(parts, dim=dim)
    out = out.to(x.device)
    _WAIT_S[0] += time.perf_counter() - t0
    return _charge("all-gather", out)


def _reduce_scatter(parts: list, axes: tuple) -> torch.Tensor:
    if _SIM is not None:
        return _simulated(parts[0], parts[rank(axes)].shape)
    t0 = time.perf_counter()
    group = _group(axes)
    parts = [p.contiguous() for p in parts]
    if _staged(group, parts[0]):
        hp = [_host(p) for p in parts]
        out = torch.empty_like(hp[0])
        tdist.reduce_scatter(out, hp, group=group)
        out = out.to(parts[0].device)
    else:
        out = torch.empty_like(parts[0],
                               memory_format=torch.contiguous_format)
        tdist.reduce_scatter(out, parts, group=group)
    _WAIT_S[0] += time.perf_counter() - t0
    return out


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes):
        ctx.axes = axes
        return _all_reduce(x, tdist.ReduceOp.SUM, axes)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, tdist.ReduceOp.SUM, ctx.axes), None


class _PSumInvariant(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes):
        return _all_reduce(x, tdist.ReduceOp.SUM, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, tiled, axes):
        ctx.dim, ctx.tiled, ctx.axes = dim, tiled, axes
        ctx.n = x.shape[dim] if tiled else 1
        return _gather(x, dim, tiled, axes)

    @staticmethod
    def backward(ctx, g):
        g = g.detach()
        parts = (g.split(ctx.n, dim=ctx.dim) if ctx.tiled
                 else g.unbind(ctx.dim))
        out = _reduce_scatter(list(parts), ctx.axes)
        return _charge("reduce-scatter", out), None, None, None


def all_gather(x: torch.Tensor, dim: int = 0, tiled: bool = True,
               axis="model"):
    """Gather ``x`` from every member of ``axis``, in index order.
    ``tiled=True`` concatenates along ``dim``; otherwise stacks a new axis
    at ``dim``. The backward reduce-scatters the cotangent."""
    axes = _axes(axis)
    if _trivial(axes):
        return x if tiled else x.unsqueeze(dim)
    return _AllGather.apply(x, dim, tiled, axes)


# ---------------------------------------------------------------------------
# collectives in the background: a start / wait pair
# ---------------------------------------------------------------------------


# the lists ``record_async`` yields: ("start" | "wait", kind, tag) in order
_ASYNC_LOGS: list = []


def _log_async(event: str, kind: str, tag) -> None:
    for log in _ASYNC_LOGS:
        log.append((event, kind, tag))


@contextlib.contextmanager
def record_async():
    """Yields a list that fills with ``("start" | "wait", kind, tag)`` as
    the start / wait pairs below are started and waited inside: the
    order in which a schedule issues and consumes its collectives."""
    log: list = []
    _ASYNC_LOGS.append(log)
    try:
        yield log
    finally:
        _ASYNC_LOGS.remove(log)


def wait_seconds() -> float:
    """Host seconds this process has spent blocked in the ring's gathers
    and reduce-scatters: a blocking call's whole time, a started one's
    ``Pending.wait`` (a running total: read it before and after a
    step)."""
    return _WAIT_S[0]


class Pending:
    """A collective started in the background (``all_gather_start``,
    ``reduce_scatter_start``); ``wait()`` returns its result, ordered on
    the current CUDA stream before anything reads it, and returns it again
    on a second call."""

    def __init__(self, kind: str, tag, work=None, finish=None):
        self.kind, self.tag = kind, tag
        self._work, self._finish = work, finish
        self._value = None
        _log_async("start", kind, tag)

    def wait(self) -> torch.Tensor:
        if self._finish is not None:
            t0 = time.perf_counter()
            if self._work is not None:
                # NCCL: the current stream waits, the host does not; gloo:
                # the host waits for the collective's thread
                self._work.wait()
            self._value = self._finish()
            self._work = self._finish = None
            _WAIT_S[0] += time.perf_counter() - t0
            _log_async("wait", self.kind, self.tag)
        return self._value


def all_gather_start(x: torch.Tensor, dim: int = 0, axis="model",
                     tag=None) -> Pending:
    """Start ``all_gather(x, dim, tiled=True, axis)`` in the background;
    ``wait()`` gives the gathered tensor. No gradient flows through it.
    Charged to ``count_collectives`` when it starts, as the blocking call
    charges it.

    What runs beside it: on NCCL the collective runs on NCCL's stream
    while the card goes on with the kernels queued after the start, and
    ``wait()`` orders the result on the current stream without blocking
    the host. On gloo the collective runs on gloo's thread while this
    thread queues the next kernels; a CUDA tensor is first copied to
    pinned host memory, a copy that waits for the kernel that made ``x``,
    and ``wait()`` copies the result back. The identity where the blocking
    call is one (``_trivial``)."""
    axes = _axes(axis)
    x = x.detach()
    if _trivial(axes):
        return Pending("all-gather", tag, finish=lambda: x)
    n = world_size(axes)
    if _SIM is not None:
        shape = list(x.shape)
        shape[dim] *= n
        out = _charge("all-gather", _simulated(x, shape))
        return Pending("all-gather", tag, finish=lambda: out)
    x = x.contiguous()
    group = _group(axes)
    src = _host(x) if _staged(group, x) else x
    parts = [torch.empty_like(src) for _ in range(n)]
    work = tdist.all_gather(parts, src, group=group, async_op=True)
    _charge_bytes("all-gather", float(n * x.numel() * x.element_size()))
    return Pending("all-gather", tag, work,
                   lambda: torch.cat(parts, dim=dim).to(x.device))


def reduce_scatter_start(x: torch.Tensor, dim: int = 0, axis="model",
                         tag=None) -> Pending:
    """Start the backward of ``all_gather_start`` in the background: the
    sum over ``axis`` of every member's ``x``, split along ``dim`` into
    the axis's blocks, this member's block given by ``wait()`` (what
    ``all_gather``'s backward does to the gathered cotangent). Charged and
    overlapped as ``all_gather_start``; the identity where the gather is
    one."""
    axes = _axes(axis)
    x = x.detach()
    if _trivial(axes):
        return Pending("reduce-scatter", tag, finish=lambda: x)
    n = world_size(axes)
    parts = list(x.split(x.shape[dim] // n, dim=dim))
    if _SIM is not None:
        out = _charge("reduce-scatter", _simulated(x, parts[0].shape))
        return Pending("reduce-scatter", tag, finish=lambda: out)
    group = _group(axes)
    parts = [p.contiguous() for p in parts]
    if _staged(group, parts[0]):
        parts = [_host(p) for p in parts]
    out = torch.empty_like(parts[0])
    work = tdist.reduce_scatter(out, parts, group=group, async_op=True)
    _charge_bytes("reduce-scatter", float(out.numel() * out.element_size()))
    return Pending("reduce-scatter", tag, work, lambda: out.to(x.device))


class _AllGatherInvariant(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, axes):
        ctx.dim, ctx.n, ctx.axes = dim, x.shape[dim], axes
        return _gather(x, dim, True, axes)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, rank(ctx.axes) * ctx.n, ctx.n), None, None


def all_gather_invariant(x: torch.Tensor, dim: int = -1, axis="model"):
    """Every member's block of ``x`` concatenated along ``dim`` into a
    value every member then uses alike (the end of a column-parallel
    product whose next step needs the whole dim); the backward keeps this
    member's block of the cotangent, since inside a tensor-parallel trunk
    every member holds that value's whole cotangent."""
    axes = _axes(axis)
    if _trivial(axes):
        return x
    return _AllGatherInvariant.apply(x, dim % x.dim(), axes)


class _PVary(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes):
        ctx.axes = axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, tdist.ReduceOp.SUM, ctx.axes), None


class _GradMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, n):
        ctx.n = n
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


class _RowBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, axes):
        ctx.axes = axes
        n = w.shape[0] // world_size(axes)
        r = rank(axes)
        return w[r * n:(r + 1) * n].clone()

    @staticmethod
    def backward(ctx, g):
        return _gather(g, 0, True, ctx.axes), None


def pvary(x: torch.Tensor, axis="model") -> torch.Tensor:
    """The identity, whose backward sums the cotangent over ``axis`` (JAX:
    ``lax.pvary``, the transpose of a shard_map input replicated over the
    axis): a value every member computes alike and feeds to its own shard
    of the work gets the gradient of every shard."""
    axes = _axes(axis)
    return x if _trivial(axes) else _PVary.apply(x, axes)


def grad_mean(x: torch.Tensor, axis="model") -> torch.Tensor:
    """The identity, whose backward divides the cotangent by the size of
    ``axis``: a result replicated on every member (a loss completed by
    ``psum``), each member's copy carrying 1 / P of its cotangent, so that
    the ``psum`` backwards inside it give every shard its gradient once."""
    axes = _axes(axis)
    return x if _trivial(axes) else _GradMean.apply(x, world_size(axes))


def shard_rows(w: torch.Tensor, axis="model") -> torch.Tensor:
    """This member's row block of a replicated [V, ...] tensor whose rows
    divide ``axis``. Under grad the block is a copy, whose backward
    all-gathers the members' block gradients into the whole tensor's (JAX:
    the transpose of slicing a replicated array into a shard_map input
    split over the axis), so every member's copy of ``w`` gets the same
    gradient; otherwise a view."""
    axes = _axes(axis)
    n = world_size(axes)
    if n == 1:
        return w
    if torch.is_grad_enabled() and w.requires_grad:
        return _RowBlock.apply(w, axes)
    v_loc = w.shape[0] // n
    r = rank(axes)
    return w[r * v_loc:(r + 1) * v_loc]


def pmax(x: torch.Tensor, axis="model") -> torch.Tensor:
    """Elementwise max over ``axis``; carries no gradient."""
    axes = _axes(axis)
    return (x.detach() if _trivial(axes)
            else _all_reduce(x, tdist.ReduceOp.MAX, axes))


def pmin(x: torch.Tensor, axis="model") -> torch.Tensor:
    """Elementwise min over ``axis``; carries no gradient."""
    axes = _axes(axis)
    return (x.detach() if _trivial(axes)
            else _all_reduce(x, tdist.ReduceOp.MIN, axes))


def psum(x: torch.Tensor, axis="model") -> torch.Tensor:
    """Sum over ``axis``; the backward sums the cotangent over it."""
    axes = _axes(axis)
    return x if _trivial(axes) else _PSum.apply(x, axes)


def psum_invariant(x: torch.Tensor, axis="model") -> torch.Tensor:
    """Sum over ``axis`` into a value every member then uses alike (the end
    of a row-parallel product); the backward passes each member's
    cotangent through, since inside a tensor-parallel trunk every member
    holds that value's whole cotangent."""
    axes = _axes(axis)
    return x if _trivial(axes) else _PSumInvariant.apply(x, axes)


def pmean(x: torch.Tensor, axis="model") -> torch.Tensor:
    """Mean over ``axis`` (``psum`` over its size)."""
    return psum(x, axis) / world_size(axis)


def ppermute(x: torch.Tensor, shift: int = 1) -> torch.Tensor:
    """Shift along the model axis (JAX: ``lax.ppermute`` with the
    permutation ``[(i, (i + shift) % n)]``): member r sends ``x`` to r +
    shift and returns what r - shift sent. Carries no gradient; the
    identity on a ring of one."""
    n = world_size()
    x = x.detach()
    if n == 1 or shift % n == 0:
        return x
    if _SIM is not None:
        return _charge("collective-permute", _simulated(x, x.shape))
    _, index = _layout()
    r = index["model"]
    dst = _global_rank(dict(index, model=(r + shift) % n))
    src = _global_rank(dict(index, model=(r - shift) % n))
    x = x.contiguous()
    staged = _staged(_group(("model",)), x)
    send = _host(x) if staged else x
    out = torch.empty_like(send)
    reqs = tdist.batch_isend_irecv([tdist.P2POp(tdist.isend, send, dst),
                                    tdist.P2POp(tdist.irecv, out, src)])
    for req in reqs:
        req.wait()
    return _charge("collective-permute", out.to(x.device))


# ---------------------------------------------------------------------------
# a leaf's block on the grid, by its spec
# ---------------------------------------------------------------------------


def _entry_axes(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def member_block(x: torch.Tensor, spec: tuple) -> torch.Tensor:
    """This member's block of the whole tensor ``x`` laid out by ``spec``
    (a tuple of mesh-axis entries, one a dim, as ``train.gspmd.fit_spec``
    makes them: None, an axis name or a tuple of names; missing trailing
    entries are None): a view."""
    for dim, entry in enumerate(spec):
        axes = _entry_axes(entry)
        if not axes:
            continue
        n = world_size(axes)
        size = x.shape[dim] // n
        x = x.narrow(dim, rank(axes) * size, size)
    return x


def gather_block(x: torch.Tensor, spec: tuple, axis=None) -> torch.Tensor:
    """The inverse of ``member_block``: the whole tensor from every
    member's block (a collective), or, with ``axis``, only the dims split
    over it gathered (the FSDP gather over ``"data"``). Differentiable:
    the backward reduce-scatters."""
    only = None if axis is None else set(_axes(axis))
    for dim, entry in enumerate(spec):
        axes = _entry_axes(entry)
        if not axes or (only is not None and not only & set(axes)):
            continue
        if only is not None and not set(axes) <= only:
            raise NotImplementedError(
                f"dim {dim} is split over {axes}: gather it whole")
        x = all_gather(x, dim=dim, axis=axes)
    return x


def spec_axes(spec) -> tuple:
    """The mesh axes a spec splits its tensor over, in the grid's order."""
    names = {a for e in (spec or ()) for a in _entry_axes(e)}
    return tuple(a for a in AXES if a in names)


# ---------------------------------------------------------------------------
# spawning a ring of processes
# ---------------------------------------------------------------------------


_RING_TIMEOUT_S = 300.0


def _ring_worker(r, n, init_file, fn, args, out_q):
    try:
        torch.set_num_threads(1)
        tdist.init_process_group("gloo", init_method=f"file://{init_file}",
                                 world_size=n, rank=r)
        try:
            out_q.put((r, True, fn(*args)))
        finally:
            release_grid()
            tdist.destroy_process_group()
    except BaseException:
        # report to the parent, which raises it, rather than leave it
        # waiting for a result that never comes
        out_q.put((r, False, traceback.format_exc()))
        raise


def spawn_ring(fn, n: int, *args) -> list:
    """Run ``fn(*args)`` on a ring of ``n`` fresh CPU processes joined into
    one gloo process group (``file://`` rendezvous in a temp directory, so
    parallel callers never share a port). Returns the per-rank results in rank
    order. ``fn`` must be importable by name (spawned workers re-import
    it). ``n == 1`` runs ``fn`` in this process with no group: the ring of
    one, where every collective is the identity."""
    if n < 1:
        raise ValueError(f"ring size must be positive, got {n}")
    if n == 1:
        return [fn(*args)]
    ctx = torch.multiprocessing.get_context("spawn")
    out_q = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="ring_") as tmp:
        init_file = os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_ring_worker,
                             args=(r, n, init_file, fn, args, out_q))
                 for r in range(n)]
        for p in procs:
            p.start()
        results, errors = {}, []
        try:
            for _ in range(n):
                try:
                    r, ok, val = out_q.get(timeout=_RING_TIMEOUT_S)
                except queue.Empty:
                    raise TimeoutError(f"ring of {n} did not finish in "
                                       f"{_RING_TIMEOUT_S}s") from None
                if ok:
                    results[r] = val
                else:
                    errors.append(f"rank {r}:\n{val}")
                    break
        finally:
            for p in procs:
                p.join(timeout=30 if not errors else 1)
                if p.is_alive():
                    p.kill()
                    p.join()
        if errors:
            raise RuntimeError("ring worker failed\n" + "\n".join(errors))
    return [results[r] for r in range(n)]


def _on_grid(n_pod: int, n_data: int, n_model: int, fn, *args):
    """``fn(*args)`` on this member of a (pod, data, model) grid."""
    grid(n_data, n_model, n_pod)
    try:
        return fn(*args)
    finally:
        release_grid()


def spawn_grid(fn, n_data: int, n_model: int, *args, n_pod: int = 1
               ) -> list:
    """``spawn_ring`` of ``n_pod * n_data * n_model`` processes laid out as
    a (pod, data, model) grid (``grid``) before ``fn(*args)`` runs on each:
    the results in the group's rank order, member (p, d, m) at ``(p *
    n_data + d) * n_model + m``. A grid of one runs in this process."""
    return spawn_ring(_on_grid, n_pod * n_data * n_model, n_pod, n_data,
                      n_model, fn, *args)
