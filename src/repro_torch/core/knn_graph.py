"""Distributed exact KNN graph over the class weights (paper §3.2.2): the
port of the JAX package's ``core/knn_graph.py``.

The paper builds an *exact* (linear-search) KNN graph of the unit class
rows, because ANN recall losses turn into accuracy losses. W is split by
rows over the ring, so the build is a ring: each member's block of unit
rows visits every other member (``dist.ppermute``); each hop scores the
member's rows against the visiting block in bf16 with fp32 sums and merges
the hop's best k' into a running top-k' (pass 1, through ``ops.dist_topk``:
the hand-written kernel on the card, its plain version on the CPU). A
second, fp32 pass re-scores the k' survivors against the blocks as they
come round again, and the best k of them are kept (the paper's
mixed-precision scheme). Self is always neighbour 0: W is normalised, so
w_y ranks first in its own list, which Algorithm 1 relies on.

Compression (paper §3.2.3-i): each member keeps, for ALL N rows, only the
neighbour entries that point at classes it stores — a CSR (offsets [N+1],
values [nnz]) with *local* column ids, plus each entry's rank in the
original list.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch import dist
from repro_torch.core.sharded_softmax import _normalize
from repro_torch.kernels import ops

PASS2_ROWS = 32768    # rows per chunk of pass 2's [rows, k', D] fp32 gather


class CompressedGraph(NamedTuple):
    """Per-shard CSR of local neighbours, leading axis the shard: numpy
    arrays, as the JAX package's. ``ranks`` keeps each entry's position in
    the ORIGINAL (uncompressed) neighbour list, Algorithm 1's ranking
    score."""
    offsets: np.ndarray    # [P, N+1] int32
    neighbors: np.ndarray  # [P, nnz_cap] int32 local ids (pad = -1)
    ranks: np.ndarray      # [P, nnz_cap] int32 original positions (pad = -1)


def knn_graph_ref(w, k: int):
    """Exact top-k cosine neighbours (self included, ranked first), fp32.
    w: [N, D] -> ids [N, k] int32."""
    wn = _normalize(w.float())
    return ops.topk_stable(wn @ wn.T, k)[1]


def _merge_topk(best_v, best_i, new_v, new_i, k: int):
    """Top-k of [best, new] per row; ties to the earlier position."""
    v = torch.cat([best_v, new_v], dim=1)
    i = torch.cat([best_i, new_i], dim=1)
    top_v, pos = ops.topk_stable(v, k)
    return top_v, i.gather(1, pos.long())


def ring_knn_local(w_loc, *, k: int, kprime: int):
    """One ring member's part of the exact KNN graph of the whole W.

    w_loc: [N_loc, D] this member's rows. Returns global neighbour ids
    [N_loc, k] int32. Pass 1: bf16 scoring through ``ops.dist_topk``, one
    launch per hop, merged into a running top-k'. Pass 2: fp32 re-rank of
    the k' survivors, recomputed against each visiting block; its gather
    of the candidates' rows runs ``PASS2_ROWS`` rows at a time (the whole
    [N_loc, k', D] gather would not fit beside W at 1M classes)."""
    n_loc = w_loc.shape[0]
    n = dist.world_size()
    my = dist.flat_axis_index()
    wn = _normalize(w_loc.float())
    w16 = wn.to(torch.bfloat16)

    # -- pass 1: bf16 scoring, running top-k' ---------------------------
    block = w16
    bv = torch.full((n_loc, kprime), float("-inf"), device=w_loc.device)
    bi = torch.full((n_loc, kprime), -1, dtype=torch.int32,
                    device=w_loc.device)
    for step in range(n):
        src = (my - step) % n            # owner of the block held now
        hv, hi = ops.dist_topk(w16, block, kprime, col_offset=src * n_loc)
        bv, bi = _merge_topk(bv, bi, hv, hi, kprime)
        block = dist.ppermute(block)
    del block, hv, hi

    # -- pass 2: fp32 re-rank of the k' candidates -----------------------
    block = wn
    exact = torch.full((n_loc, kprime), float("-inf"), device=w_loc.device)
    for step in range(n):
        src = (my - step) % n
        rel = bi.long() - src * n_loc    # candidate position in this block
        here = (rel >= 0) & (rel < n_loc)
        safe = rel.clamp(0, n_loc - 1)
        for r0 in range(0, n_loc, PASS2_ROWS):
            r1 = min(r0 + PASS2_ROWS, n_loc)
            cand = block[safe[r0:r1]]                   # [rows, k', D] fp32
            s = torch.einsum("nd,nkd->nk", wn[r0:r1], cand)
            exact[r0:r1] = torch.where(here[r0:r1], s, exact[r0:r1])
            del cand
        block = dist.ppermute(block)
    exact = torch.where(bi >= 0, exact, float("-inf"))
    pos = ops.topk_stable(exact, k)[1]
    return bi.gather(1, pos.long())


def build_graph(w_loc, *, k: int, kprime: int) -> np.ndarray:
    """The ring build on every member, then an all-gather of the [N_loc, k]
    blocks, so each member holds the whole graph [N, k] (host numpy) to
    compress."""
    g = ring_knn_local(w_loc, k=k, kprime=kprime)
    return dist.all_gather(g, dim=0).cpu().numpy()


# ---------------------------------------------------------------------------
# compression (paper §3.2.3): host-side CSR build, per shard
# ---------------------------------------------------------------------------


def compress_graph(graph: np.ndarray, n_shards: int) -> CompressedGraph:
    """graph: [N, k] global neighbour ids (host numpy).

    For shard p, keep only neighbours owned by p (id // n_loc == p), as
    LOCAL ids, CSR over all N rows. Shards are padded to a common nnz cap
    so the result is one [P, ...] array. Average storage drops from N·k to
    N·k/P per shard (the paper's per-node compression)."""
    graph = np.asarray(graph)
    n, k = graph.shape
    if n % n_shards:
        raise ValueError(f"N={n} not divisible by shards={n_shards}")
    n_loc = n // n_shards
    owner = graph // n_loc
    local = graph % n_loc
    col = np.broadcast_to(np.arange(k, dtype=np.int32), graph.shape)
    offsets = np.zeros((n_shards, n + 1), np.int32)
    values, rvalues = [], []
    for p in range(n_shards):
        mask = owner == p
        offsets[p, 1:] = np.cumsum(mask.sum(axis=1))
        values.append(local[mask].astype(np.int32))
        rvalues.append(col[mask].astype(np.int32))
    nnz_cap = max(int(v.size) for v in values)
    neigh = np.full((n_shards, nnz_cap), -1, np.int32)
    ranks = np.full((n_shards, nnz_cap), -1, np.int32)
    for p, (v, r) in enumerate(zip(values, rvalues)):
        neigh[p, : v.size] = v
        ranks[p, : r.size] = r
    return CompressedGraph(offsets, neigh, ranks)


def graph_storage_bytes(cg: CompressedGraph) -> dict:
    """Storage accounting (the Table-3-style benchmark's)."""
    per_shard = cg.neighbors.shape[1] * 4 + cg.offsets.shape[1] * 4
    return {"per_shard_bytes": per_shard,
            "total_bytes": per_shard * cg.offsets.shape[0]}
