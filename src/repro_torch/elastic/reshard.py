"""Host-side reshard transforms for the state whose layout bakes in the ring
size: the port of the JAX package's ``elastic/reshard.py``, in numpy.

A checkpoint stores GLOBAL arrays, so dense ``[V, D]`` rows need no
rewrite: each member of the destination ring cuts its own block out of
the global host array (``row_block``, which ``interop`` and the restore
share). What is rewritten:

  * KNN graph CSR (``decompress_graph`` / ``repack_knn_aux``): the
    per-shard CSR is exactly invertible (``ranks`` records each entry's
    original column), so an n->m re-pack preserves the mid-refresh graph
    bit for bit and n->m->n is the identity.
  * LSH tables (``lsh_bucket_map`` / ``repack_lsh_aux``): the per-shard
    bucket CSRs invert to a global class->bucket map, re-sorted per
    destination shard with the stable sort the table build uses, so the
    re-pack is exact (the planes are replicated and kept).
  * Sketch buckets (``rebucket_sketch``): when the stored bucket count no
    longer divides the ring, classes are re-hashed with the SAME universal
    family at the new modulus and each new bucket takes the mean of its
    classes' old bucket weights (empty buckets zero): the one lossy
    transform. Optimizer moments get the identical mapping.
  * DGC error feedback (``redistribute_dgc``): the per-worker residuals
    are redistributed mass-preservingly, each new worker taking an equal
    share of the total.
  * Vocab padding (``resize_vocab_rows``): pad rows sliced off or re-grown
    with zeros between two padded vocab sizes.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.elastic.plan import ReshardError
from repro_torch.optim import tree_leaves, tree_map


def _host(a) -> np.ndarray:
    if torch.is_tensor(a):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def leaf_bytes(a) -> int:
    if torch.is_tensor(a):
        return a.numel() * a.element_size()
    return int(np.asarray(a).nbytes)


def tree_bytes(tree) -> int:
    return sum(leaf_bytes(a) for a in tree_leaves(tree))


# ---------------------------------------------------------------------------
# row placement (dense [V, ...] class-sharded arrays)
# ---------------------------------------------------------------------------


def row_block(a, rank: int, world_size: int, axis: int = 0) -> np.ndarray:
    """Ring member ``rank``'s block of the global host array ``a`` along
    ``axis`` (0: the class rows of a [V, D] matrix; 1: the buckets of an
    [R, B, D] sketch): the port's placement of a row-sharded array, aligned
    plan or not. A view, not a copy: the restore's host memory holds the
    checkpoint's arrays once."""
    a = _host(a)
    if a.shape[axis] % world_size:
        raise ValueError(f"{a.shape[axis]} rows do not divide a ring of "
                         f"{world_size}")
    n = a.shape[axis] // world_size
    index = [slice(None)] * a.ndim
    index[axis] = slice(rank * n, (rank + 1) * n)
    return a[tuple(index)]


# ---------------------------------------------------------------------------
# KNN graph CSR re-pack (exact)
# ---------------------------------------------------------------------------


def decompress_graph(offsets, neighbors, ranks) -> np.ndarray:
    """Invert ``knn_graph.compress_graph``: per-shard CSRs back to the
    global ``[N, k]`` neighbor table (pad columns -1)."""
    offsets, neighbors, ranks = _host(offsets), _host(neighbors), _host(ranks)
    n_shards, n1 = offsets.shape
    n = n1 - 1
    n_loc = n // n_shards
    k = int(ranks.max()) + 1 if ranks.size else 1
    g = np.full((n, k), -1, np.int64)
    for p in range(n_shards):
        off = offsets[p].astype(np.int64)
        nnz = int(off[-1])
        rows = np.repeat(np.arange(n), np.diff(off))
        g[rows, ranks[p, :nnz]] = neighbors[p, :nnz].astype(np.int64) \
            + p * n_loc
    return g


def repack_knn_aux(aux, n_dst: int):
    """Re-pack an (offsets, neighbors, ranks) CSR triple written for one
    ring size onto ``n_dst`` shards, preserving the graph exactly."""
    from repro_torch.core import knn_graph as kg
    g = decompress_graph(*aux)
    if (g < 0).any():
        raise ReshardError("KNN graph CSR has holes; cannot re-pack")
    cg = kg.compress_graph(g, n_dst)
    return (cg.offsets, cg.neighbors, cg.ranks)


# ---------------------------------------------------------------------------
# LSH table re-pack (exact)
# ---------------------------------------------------------------------------


def lsh_bucket_map(offsets, classes) -> np.ndarray:
    """Invert the per-shard bucket CSRs of the LSH tables to the global
    class->bucket assignment ``[R, V]``."""
    offsets, classes = _host(offsets), _host(classes)
    n_shards, n_tables, v_loc = classes.shape
    n_buckets = offsets.shape[2] - 1
    bucket = np.empty((n_tables, n_shards * v_loc), np.int64)
    for p in range(n_shards):
        for r in range(n_tables):
            per_pos = np.repeat(np.arange(n_buckets),
                                np.diff(offsets[p, r].astype(np.int64)))
            bucket[r, p * v_loc + classes[p, r].astype(np.int64)] = per_pos
    return bucket


def repack_lsh_aux(aux, n_dst: int):
    """Re-pack (planes, offsets, classes) onto ``n_dst`` shards: planes
    kept, the per-shard CSRs rebuilt by the table build's stable sort, so
    the result is what the build emits for the SAME bucket assignment,
    mid-refresh staleness included."""
    planes, offsets, classes = aux
    bucket = lsh_bucket_map(offsets, classes)
    n_tables, v = bucket.shape
    n_buckets = _host(offsets).shape[2] - 1
    if v % n_dst != 0:
        raise ReshardError(f"V={v} not divisible by dst shards={n_dst}")
    v_loc = v // n_dst
    new_off = np.zeros((n_dst, n_tables, n_buckets + 1), np.int32)
    new_cls = np.zeros((n_dst, n_tables, v_loc), np.int32)
    for q in range(n_dst):
        for r in range(n_tables):
            bloc = bucket[r, q * v_loc:(q + 1) * v_loc]
            order = np.argsort(bloc, kind="stable").astype(np.int32)
            new_cls[q, r] = order
            new_off[q, r] = np.searchsorted(
                bloc[order], np.arange(n_buckets + 1)).astype(np.int32)
    return (planes, new_off, new_cls)


# ---------------------------------------------------------------------------
# sketch-head bucket transfer (lossy, class-mean)
# ---------------------------------------------------------------------------


def rebucket_sketch(w, h_old, h_new, n_buckets_new: int) -> np.ndarray:
    """Transfer ``[R, B_old, D]`` bucket weights onto a new hash table:
    each new bucket's weight is the mean of its member classes' OLD bucket
    weights (empty new buckets stay zero). Deterministic, so params and
    optimizer moments map identically."""
    w = _host(w).astype(np.float32)
    h_old = _host(h_old).astype(np.int64)
    h_new = _host(h_new).astype(np.int64)
    n_rep, _, d = w.shape
    out = np.zeros((n_rep, n_buckets_new, d), np.float32)
    counts = np.zeros((n_rep, n_buckets_new), np.int64)
    for r in range(n_rep):
        np.add.at(out[r], h_new[r], w[r][h_old[r]])
        np.add.at(counts[r], h_new[r], 1)
    out /= np.maximum(counts, 1)[..., None]
    return out


# ---------------------------------------------------------------------------
# DGC error feedback (mass-preserving)
# ---------------------------------------------------------------------------


def redistribute_dgc(tree, n_dst: int):
    """Redistribute ``[n_src, ...]``-leading error-feedback leaves over
    ``n_dst`` workers: every new worker gets total/n_dst, preserving the
    total pending residual each parameter will eventually receive."""
    def one(a):
        h = _host(a)
        total = h.sum(axis=0, dtype=h.dtype)
        return np.broadcast_to(total / n_dst, (n_dst,) + total.shape).copy()
    return tree_map(one, tree)


# ---------------------------------------------------------------------------
# vocab padding
# ---------------------------------------------------------------------------


def resize_vocab_rows(arr, v_src: int, v_dst: int, *, n_real: int):
    """Slice / zero-pad a vocab-leading array between two padded vocab
    sizes. Only pad rows (>= ``n_real``) may be created or dropped."""
    a = _host(arr)
    if a.shape[0] != v_src or v_src == v_dst:
        return a
    if min(v_src, v_dst) < n_real:
        raise ReshardError(
            f"vocab resize {v_src}->{v_dst} would drop real rows "
            f"(real vocab {n_real})")
    if v_dst < v_src:
        return np.ascontiguousarray(a[:v_dst])
    pad = np.zeros((v_dst - v_src,) + a.shape[1:], a.dtype)
    return np.concatenate([a, pad], axis=0)
