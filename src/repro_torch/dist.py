"""The ring: the port's counterpart of the JAX package's ``"hybrid"`` mesh
axis.

One process per device in a ``torch.distributed`` group (NCCL on the card,
gloo on the CPU). Where JAX's shard_map bodies call ``lax.pmax`` /
``psum`` / ``all_gather`` / ``axis_index`` over the axis, the port calls
the functions below. With no process group initialised the ring has one
member and every collective is the identity, so the same bodies run in a
single process.

Autograd through the collectives follows JAX's transposes inside
``shard_map(..., check_vma=False)``, which the JAX trainer runs under:

* ``psum``: the backward sums the cotangent over the ring. A loss that is
  replicated on every member therefore contributes one cotangent per
  member, and the head gradient grows with the ring size (ROADMAP.md C.1);
  the port keeps that, as the reference does.
* ``all_gather`` (tiled or stacked): the backward reduce-scatters the
  cotangent (sums it over the ring, keeps this member's slice).
* ``pmax`` / ``pmin``: no gradient (their results are detached).

The zoo trainer differentiates outside its head's body, as the JAX zoo
differentiates outside its shard_map, and its gradient is that of the
mean loss whatever the ring size (the JAX package's, at n_model 1, 2 and
4): ``pvary`` (the identity, its backward a ``psum``) carries the
replicated features into the head, ``grad_mean`` (the identity, its
backward over the ring size) carries the replicated loss out, and
``shard_rows`` cuts a replicated table's row block, its backward an
all-gather, so every member's copy gets the whole gradient.

The functions are written by hand, not taken from
``torch.distributed.nn``, whose backward rules differ between versions.

``count_collectives()`` counts the bytes of every collective called
inside it, where it is called, as the comm ledger charges them (the
output's bytes, by kind: all-reduce for ``psum`` / ``pmax`` / ``pmin``
and the backward of ``psum`` / ``pvary``; all-gather for ``all_gather``
and ``shard_rows``' backward; reduce-scatter for ``all_gather``'s
backward; collective-permute for ``ppermute``). ``simulated_ring(n, r)``
makes this process member r of a ring of n that exists only in shapes:
on meta tensors every collective returns an empty meta tensor of its
output's shape and is counted, and on any other tensor it raises. The dry
run (``launch.dryrun``) lowers one member's step on it, where the JAX
package compiles for placeholder devices.
"""
from __future__ import annotations

import contextlib
import os
import queue
import tempfile
import traceback

import torch
import torch.distributed as tdist

# (n, r) while a simulated ring is active (``simulated_ring``)
_SIM = None
# the active collective counts (``count_collectives``)
_COUNTS: list = []


def _active() -> bool:
    return _SIM is not None or (tdist.is_available()
                                and tdist.is_initialized())


def world_size() -> int:
    if _SIM is not None:
        return _SIM[0]
    return tdist.get_world_size() if _active() else 1


def rank() -> int:
    if _SIM is not None:
        return _SIM[1]
    return tdist.get_rank() if _active() else 0


@contextlib.contextmanager
def simulated_ring(n: int, r: int = 0):
    """Act as member ``r`` of a ring of ``n`` whose collectives move
    shapes only (meta tensors; module docstring)."""
    global _SIM
    if not 0 <= r < n:
        raise ValueError(f"rank {r} is not on a ring of {n}")
    if tdist.is_available() and tdist.is_initialized():
        raise RuntimeError("a simulated ring inside a process group")
    prev, _SIM = _SIM, (n, r)
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
    nbytes = float(out.numel() * out.element_size())
    for counts in _COUNTS:
        slot = counts.setdefault(kind, {"bytes": 0.0, "count": 0})
        slot["bytes"] += nbytes
        slot["count"] += 1
        counts["total_bytes"] += nbytes
    return out


def _simulated(x: torch.Tensor, shape) -> torch.Tensor:
    """A collective's output on the simulated ring."""
    if x.device.type != "meta":
        raise RuntimeError(f"the simulated ring moves meta tensors only, "
                           f"got one on {x.device}")
    return torch.empty(shape, dtype=x.dtype, device="meta")


def flat_axis_index() -> int:
    """This member's index on the ring (JAX: ``lax.axis_index``)."""
    return rank()


def barrier() -> None:
    """Wait until every member reaches this point (a checkpoint's readers
    wait for its writer); nothing to wait for on a ring of one."""
    if _active() and _SIM is None:
        tdist.barrier()


def _all_reduce(x: torch.Tensor, op) -> torch.Tensor:
    if _SIM is not None:
        return _charge("all-reduce", _simulated(x, x.shape))
    out = x.detach().clone().contiguous()
    tdist.all_reduce(out, op=op)
    return _charge("all-reduce", out)


def _gather(x: torch.Tensor, dim: int, tiled: bool) -> torch.Tensor:
    n = world_size()
    if _SIM is not None:
        shape = list(x.shape)
        if tiled:
            shape[dim] *= n
        else:
            shape.insert(dim if dim >= 0 else dim + x.dim() + 1, n)
        return _charge("all-gather", _simulated(x, shape))
    x = x.detach().contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    tdist.all_gather(parts, x)
    return _charge("all-gather", torch.cat(parts, dim=dim) if tiled
                   else torch.stack(parts, dim=dim))


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _all_reduce(x, tdist.ReduceOp.SUM)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, tdist.ReduceOp.SUM)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, tiled):
        ctx.dim, ctx.tiled, ctx.n = dim, tiled, x.shape[dim] if tiled else 1
        return _gather(x, dim, tiled)

    @staticmethod
    def backward(ctx, g):
        g = g.detach()
        parts = (g.split(ctx.n, dim=ctx.dim) if ctx.tiled
                 else g.unbind(ctx.dim))
        if _SIM is not None:
            out = _simulated(g, parts[rank()].shape)
        else:
            out = torch.empty_like(parts[rank()],
                                   memory_format=torch.contiguous_format)
            tdist.reduce_scatter(out, [p.contiguous() for p in parts])
        return _charge("reduce-scatter", out), None, None


def all_gather(x: torch.Tensor, dim: int = 0, tiled: bool = True):
    """Gather ``x`` from every member, in rank order. ``tiled=True``
    concatenates along ``dim``; otherwise stacks a new axis at ``dim``.
    The backward reduce-scatters the cotangent."""
    if not _active():
        return x if tiled else x.unsqueeze(dim)
    return _AllGather.apply(x, dim, tiled)


class _PVary(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, tdist.ReduceOp.SUM)


class _GradMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g / world_size()


class _RowBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w):
        n = w.shape[0] // world_size()
        return w[rank() * n:(rank() + 1) * n].clone()

    @staticmethod
    def backward(ctx, g):
        return _gather(g, 0, True)


def pvary(x: torch.Tensor) -> torch.Tensor:
    """The identity, whose backward sums the cotangent over the ring (JAX:
    ``lax.pvary``, the transpose of a shard_map input replicated over the
    axis): a value every member computes alike and feeds to its own shard
    of the work gets the gradient of every shard."""
    return _PVary.apply(x) if _active() else x


def grad_mean(x: torch.Tensor) -> torch.Tensor:
    """The identity, whose backward divides the cotangent by the ring size:
    a result replicated on every member (a loss completed by ``psum``),
    each member's copy carrying 1 / P of its cotangent, so that the
    ``psum`` backwards inside it give every shard its gradient once."""
    return _GradMean.apply(x) if _active() else x


def shard_rows(w: torch.Tensor) -> torch.Tensor:
    """This member's row block of a replicated [V, ...] tensor whose rows
    divide the ring. Under grad the block is a copy, whose backward
    all-gathers the members' block gradients into the whole tensor's (JAX:
    the transpose of slicing a replicated array into a shard_map input
    split over the axis), so every member's copy of ``w`` gets the same
    gradient; otherwise a view."""
    n = world_size()
    if n == 1:
        return w
    if torch.is_grad_enabled() and w.requires_grad:
        return _RowBlock.apply(w)
    v_loc = w.shape[0] // n
    return w[rank() * v_loc:(rank() + 1) * v_loc]


def pmax(x: torch.Tensor) -> torch.Tensor:
    """Elementwise max over the ring; carries no gradient."""
    return _all_reduce(x, tdist.ReduceOp.MAX) if _active() else x.detach()


def pmin(x: torch.Tensor) -> torch.Tensor:
    """Elementwise min over the ring; carries no gradient."""
    return _all_reduce(x, tdist.ReduceOp.MIN) if _active() else x.detach()


def psum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the ring; the backward sums the cotangent over the ring."""
    return _PSum.apply(x) if _active() else x


def pmean(x: torch.Tensor) -> torch.Tensor:
    """Mean over the ring (``psum`` over the ring size)."""
    return psum(x) / world_size()


def ppermute(x: torch.Tensor, shift: int = 1) -> torch.Tensor:
    """Ring shift (JAX: ``lax.ppermute`` with the permutation
    ``[(i, (i + shift) % n)]``): member r sends ``x`` to r + shift and
    returns what r - shift sent. Carries no gradient; the identity on a
    ring of one."""
    n = world_size()
    x = x.detach()
    if n == 1 or shift % n == 0:
        return x
    if _SIM is not None:
        return _charge("collective-permute", _simulated(x, x.shape))
    r = rank()
    x = x.contiguous()
    out = torch.empty_like(x)
    reqs = tdist.batch_isend_irecv([
        tdist.P2POp(tdist.isend, x, (r + shift) % n),
        tdist.P2POp(tdist.irecv, out, (r - shift) % n)])
    for req in reqs:
        req.wait()
    return _charge("collective-permute", out)


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
