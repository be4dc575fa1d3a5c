"""The ring: the port's counterpart of the JAX package's ``"hybrid"`` mesh
axis.

One process per device in a ``torch.distributed`` group (NCCL on the card,
gloo on the CPU). Where JAX's shard_map bodies call ``lax.pmax`` /
``psum`` / ``all_gather`` / ``axis_index`` over the axis, the port calls
the functions below. With no process group initialised the ring has one
member and every collective is the identity, so the same bodies run in a
single process.

Autograd through the collectives comes with the training slice; these are
forward-only.
"""
from __future__ import annotations

import os
import queue
import tempfile
import traceback

import torch
import torch.distributed as tdist


def _active() -> bool:
    return tdist.is_available() and tdist.is_initialized()


def world_size() -> int:
    return tdist.get_world_size() if _active() else 1


def rank() -> int:
    return tdist.get_rank() if _active() else 0


def flat_axis_index() -> int:
    """This member's index on the ring (JAX: ``lax.axis_index``)."""
    return rank()


def all_gather(x: torch.Tensor, dim: int = 0, tiled: bool = True):
    """Gather ``x`` from every member, in rank order. ``tiled=True``
    concatenates along ``dim``; otherwise stacks a new axis at ``dim``."""
    if not _active():
        return x if tiled else x.unsqueeze(dim)
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(world_size())]
    tdist.all_gather(parts, x)
    return torch.cat(parts, dim=dim) if tiled else torch.stack(parts, dim=dim)


def _all_reduce(x: torch.Tensor, op) -> torch.Tensor:
    if not _active():
        return x
    out = x.clone().contiguous()
    tdist.all_reduce(out, op=op)
    return out


def pmax(x: torch.Tensor) -> torch.Tensor:
    return _all_reduce(x, tdist.ReduceOp.MAX)


def pmin(x: torch.Tensor) -> torch.Tensor:
    return _all_reduce(x, tdist.ReduceOp.MIN)


def psum(x: torch.Tensor) -> torch.Tensor:
    return _all_reduce(x, tdist.ReduceOp.SUM)


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
