"""Reshard planning: map a checkpoint's source ring onto a destination ring.

The port's copy of the JAX package's ``elastic/plan.py``, which is pure
Python. On the port's ring a member is both a class-row shard and a
data-parallel replica, so ``n_model == n_data == dist.world_size()``.

A checkpoint stores GLOBAL (host-gathered) arrays, but several pieces of
state bake the ring size in anyway: the row partition of the `[V/n, D]`
class-weight and optimizer-moment shards, the sketch heads' bucket count
(rounded up to divide the ring), per-head aux CSRs with a leading shard
axis, and the DGC error-feedback buffers' leading worker axis. This
module is the geometry half of `repro_torch.elastic`: it validates a
src->dst move up front (`ReshardError` instead of a shape error deep in
the restore) and produces a `ReshardPlan`, the interval intersection of
the src and dst row partitions, whose bytes the restore accounts.
Everything here is host-side; the checkpoint layer imports it for the
up-front validation.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple


class ReshardError(ValueError):
    """A checkpoint cannot be restored onto this experiment's geometry —
    raised up front (before any leaf is decoded or placed) with the src
    and dst geometries named, instead of a shape error downstream."""


@dataclass(frozen=True)
class MeshGeometry:
    """The mesh shape a checkpoint was written on (or is restored onto).

    ``n_model`` is the number of class/vocab row shards (the ring size
    on the paper system), ``n_data`` the data-parallel width,
    ``n_classes`` the mesh-invariant logical class count (0 = unknown,
    skips the class-count check)."""
    n_model: int
    n_data: int = 1
    n_classes: int = 0

    def describe(self) -> str:
        return (f"(model={self.n_model}, data={self.n_data}, "
                f"classes={self.n_classes})")

    def meta(self) -> dict:
        """The dict stored in the checkpoint payload (`checkpoint.save
        meta=`)."""
        return {"n_model": self.n_model, "n_data": self.n_data,
                "n_classes": self.n_classes}


def geometry_from_meta(meta: Optional[dict],
                       default: MeshGeometry) -> MeshGeometry:
    """Geometry recorded in a checkpoint's meta dict; ``default`` (the
    restoring experiment's own geometry) for pre-elastic checkpoints that
    carry no meta — those can only assert same-mesh restores."""
    if not meta or "n_model" not in meta:
        return default
    return MeshGeometry(
        n_model=int(meta["n_model"]),
        n_data=int(meta.get("n_data", 1)),
        n_classes=int(meta.get("n_classes", default.n_classes)))


def validate_geometry(src: MeshGeometry, dst: MeshGeometry, *,
                      reshard: bool = False) -> None:
    """Up-front src-vs-dst check. Class-count changes are never
    reshardable; mesh-shape changes are allowed only when the caller asked
    for an elastic restore (``resume="reshard"`` / ``--resume-reshard``)."""
    if src.n_classes and dst.n_classes and src.n_classes != dst.n_classes:
        raise ReshardError(
            f"checkpoint was written for {src.n_classes} classes but this "
            f"experiment has {dst.n_classes}; class-count changes cannot "
            f"be resharded [src {src.describe()} -> dst {dst.describe()}]")
    if (src.n_model, src.n_data) != (dst.n_model, dst.n_data):
        if not reshard:
            raise ReshardError(
                f"checkpoint mesh {src.describe()} does not match restore "
                f"mesh {dst.describe()}; pass resume='reshard' "
                f"(launcher: --resume-reshard) to re-shard onto this mesh")
        if dst.n_classes and dst.n_classes % dst.n_model != 0:
            raise ReshardError(
                f"cannot reshard onto dst {dst.describe()}: "
                f"{dst.n_classes} classes not divisible by "
                f"{dst.n_model} model shards")


@dataclass(frozen=True)
class RowTransfer:
    """One contiguous global row interval ``[start, stop)`` moving from
    ``src_shard``'s block to ``dst_shard``'s block."""
    src_shard: int
    dst_shard: int
    start: int
    stop: int

    @property
    def rows(self) -> int:
        return self.stop - self.start


@dataclass(frozen=True)
class ReshardPlan:
    """Row repartition of ``n_rows`` global rows from ``src.n_model`` to
    ``dst.n_model`` equal blocks.

    ``aligned`` — one ring divides the other, so every dst block is a
    concatenation of whole src blocks (or a sub-slice of one). Either way
    each member of the port's ring cuts its own contiguous rows out of the
    global host array it read.

    ``moved_rows`` counts rows whose owning shard INDEX changes (the
    device at ring position i keeps rows it already owned) — the bytes a
    real multi-host reshard puts on the wire.
    """
    src: MeshGeometry
    dst: MeshGeometry
    n_rows: int
    aligned: bool
    transfers: Tuple[RowTransfer, ...]
    moved_rows: int

    def bytes_moved(self, row_bytes: int) -> int:
        return self.moved_rows * int(row_bytes)

    def describe(self) -> str:
        kind = "aligned" if self.aligned else "chunked"
        return (f"{self.src.n_model}->{self.dst.n_model} shards, "
                f"{self.n_rows} rows, {kind}, moved={self.moved_rows}")


def plan_reshard(src: MeshGeometry, dst: MeshGeometry,
                 n_rows: Optional[int] = None) -> ReshardPlan:
    """Interval-intersect the src and dst row partitions of ``n_rows``
    (default: the geometries' class count) global rows."""
    n = int(n_rows if n_rows is not None else src.n_classes)
    n_src, n_dst = src.n_model, dst.n_model
    if n <= 0:
        raise ReshardError(f"cannot plan a reshard over {n} rows")
    for label, shards in (("src", n_src), ("dst", n_dst)):
        if shards < 1 or n % shards != 0:
            raise ReshardError(
                f"{n} rows not divisible by {label} shards={shards} "
                f"[src {src.describe()} -> dst {dst.describe()}]")
    r_src, r_dst = n // n_src, n // n_dst
    transfers, moved = [], 0
    for q in range(n_dst):
        lo, hi = q * r_dst, (q + 1) * r_dst
        for s in range(lo // r_src, (hi - 1) // r_src + 1):
            a, b = max(lo, s * r_src), min(hi, (s + 1) * r_src)
            transfers.append(RowTransfer(s, q, a, b))
            if s != q:
                moved += b - a
    aligned = n_src % n_dst == 0 or n_dst % n_src == 0
    return ReshardPlan(src=src, dst=dst, n_rows=n, aligned=aligned,
                       transfers=tuple(transfers), moved_rows=moved)
