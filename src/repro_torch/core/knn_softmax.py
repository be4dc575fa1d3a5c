"""KNN softmax (paper §3.2): active-class selection + sparse distributed CE,
the port of the JAX package's ``core/knn_softmax.py``.

Per step, each ring member scores only M_local active classes instead of
its whole V_local shard. The active set is Algorithm 1 with fixed shapes:

  1. quick access: a capped CSR gather of each label's neighbour list from
     the member's *compressed* graph;
  2. dedup keeping the best (lowest) graph rank per class: a stable sort of
     an int64 (id, rank) key, then first-occurrence masking;
  3. top-M_local by rank (a stable sort, ties to the lowest position, as
     ``lax.top_k``); unfilled slots are padded with pseudo-random classes
     (paper line 7) or masked out (``pad_random=False``).

The fillers cannot be the JAX package's (``jax.random`` bits have no torch
counterpart, ROADMAP.md C.3). They come from a counter-based hash in
tensor ops, deterministic per (salt, sum of the labels), computed on the
labels' device, so no step waits on the host. Tests inject the JAX
package's draws through ``fillers=``. As in the reference, a filler that
repeats a chosen class is masked, but two equal fillers both count.

Because W is L2-normalised, each label's own class is neighbour 0 of its
own list, so rank-0 entries always win selection: the lossless inclusion
the paper relies on (``label_recall`` 1.0).
"""
from __future__ import annotations

import torch

from repro_torch import dist
from repro_torch.core.sharded_softmax import (_finish_ce, _finish_ce_stats,
                                              _normalize, batch_mean,
                                              batch_sum)
from repro_torch.kernels import ops

BIG_RANK = 1 << 20
_M32 = 0xFFFFFFFF


def _mix32(x):
    """A 32-bit integer hash (xorshift-multiply) of int64 values in
    [0, 2^32); the multipliers stay below 2^31, so no product overflows."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x5BD1E995) & _M32
    return x ^ (x >> 16)


def filler_ids(n: int, v_loc: int, y_loc, salt: int = 0):
    """``n`` pseudo-random local class ids in [0, v_loc), a function of
    (salt, sum(y_loc) mod 2^30) only — the reference's key — so that a
    recomputation gives the same draw. Stays on y_loc's device."""
    key = _mix32(_mix32(torch.full((), 17 + salt, dtype=torch.int64,
                                   device=y_loc.device))
                 ^ (y_loc.long().sum() % (1 << 30)))
    i = torch.arange(n, dtype=torch.int64, device=y_loc.device)
    h = _mix32((i * 0x27D4EB2F + key) & _M32)
    return ((h * v_loc) >> 32).to(torch.int32)


def select_active(y_loc, offsets, neighbors, *, v_loc: int, m_local: int,
                  k_cap: int, pad_random: bool = True, seed_salt: int = 0,
                  ranks=None, fillers=None):
    """Fixed-shape Algorithm 1 on one ring member.

    y_loc: [b] global labels of the batch. offsets: [N+1] CSR row offsets
    of the member's compressed graph; neighbors: [nnz_cap] local class ids;
    ranks: [nnz_cap] ORIGINAL neighbour-list positions (Algorithm 1's
    ranking score; None uses the compressed position, only safe when
    every member sees whole rows). ``fillers`` [m_local]: the pad draw to
    use instead of ``filler_ids``. Returns (active_ids [m_local] int32
    local ids, valid [m_local] bool)."""
    dev = y_loc.device
    y = y_loc.long()
    offsets = offsets.long()
    lens = offsets[y + 1] - offsets[y]
    iota = torch.arange(k_cap, device=dev)
    safe_take = (offsets[y][:, None] + iota[None, :]).clamp(
        0, neighbors.shape[0] - 1)
    in_row = iota[None, :] < torch.clamp(lens, max=k_cap)[:, None]
    cand = torch.where(in_row, neighbors[safe_take].long(), -1)
    if ranks is not None:
        rank = torch.where(in_row, ranks[safe_take].long(), BIG_RANK - 1)
    else:
        rank = iota[None, :].expand_as(cand)

    flat_id = cand.reshape(-1)
    flat_rank = torch.where(flat_id >= 0, rank.reshape(-1), BIG_RANK)
    # sort by (id, rank); the first occurrence of an id has its best rank
    order = torch.sort((flat_id + 1) * (BIG_RANK + 1) + flat_rank,
                       stable=True).indices
    sid, srank = flat_id[order], flat_rank[order]
    first = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                       sid[1:] != sid[:-1]])
    score = torch.where(first & (sid >= 0), BIG_RANK - srank, -1)
    take = min(m_local, score.shape[0])
    top_score, top_pos = ops.topk_stable(score, take)
    ids = sid[top_pos.long()]
    mask = top_score >= 0
    if take < m_local:   # fewer candidates than the budget: pad (line 7)
        pad = m_local - take
        ids = torch.cat([ids, torch.zeros(pad, dtype=ids.dtype, device=dev)])
        mask = torch.cat([mask, torch.zeros(pad, dtype=torch.bool,
                                            device=dev)])

    if pad_random:
        # fill with pseudo-random non-chosen classes; a filler equal to a
        # chosen class is masked (it would count that class twice in Z)
        if fillers is None:
            fillers = filler_ids(m_local, v_loc, y_loc, seed_salt)
        fillers = fillers.long()
        sorted_ids = torch.sort(torch.where(mask, ids, -1)).values
        pos = torch.searchsorted(sorted_ids, fillers)
        dup = sorted_ids[pos.clamp(0, m_local - 1)] == fillers
        ids = torch.where(mask, ids, fillers)
        mask = mask | ~dup
    ids = torch.where(mask, ids, 0)
    return ids.to(torch.int32), mask


def knn_softmax_local(f_loc, y_loc, w_loc, offsets_loc, neighbors_loc,
                      ranks_loc=None, *, global_batch: int, m_local: int,
                      k_cap: int, cosine_scale: float = 16.0,
                      pad_random: bool = True, n_valid: int = 0,
                      backend: str = "ref", fillers=None, batch_axes=()):
    """The KNN-softmax loss body of one ring member (counterpart of
    ``full_softmax_local``). ``offsets_loc`` / ``neighbors_loc`` /
    ``ranks_loc`` are this member's rows of the ``CompressedGraph``
    arrays. ``backend="kernel"`` runs the gather and the online softmax
    through ``ops.sparse_ce_stats`` (neither the gathered weights nor the
    [b, m_local] logits exist on the card, forward or backward); ``"ref"``
    gathers w_loc[ids] and forms dense logits. Returns (loss, {"accuracy",
    "logz", "active_frac", "label_recall"})."""
    offsets = offsets_loc.reshape(-1)
    neighbors = neighbors_loc.reshape(-1)
    ranks = ranks_loc.reshape(-1) if ranks_loc is not None else None
    v_loc = w_loc.shape[0]
    v_start = dist.flat_axis_index() * v_loc

    ids, valid = select_active(
        y_loc, offsets, neighbors, v_loc=v_loc, m_local=m_local,
        k_cap=k_cap, pad_random=pad_random, ranks=ranks, fillers=fillers)
    if n_valid:   # padded vocab rows that slipped in as random fillers
        valid = valid & ((v_start + ids.long()) < n_valid)

    # the label's position in the active set (owner member only)
    y_rel = y_loc.long() - v_start
    hit = (ids.long()[None, :] == y_rel[:, None]) & valid[None, :]
    owned = (y_rel >= 0) & (y_rel < v_loc) & hit.any(dim=1)

    if backend == "kernel":
        f = _normalize(f_loc).float().contiguous()
        wn = _normalize(w_loc).float().contiguous()   # == gather-then-norm
        gids = (v_start + ids.long()).to(torch.int32)
        bias = torch.zeros(ids.shape[0], dtype=torch.float32,
                           device=ids.device)
        m, z, corr, amax = ops.sparse_ce_stats(
            f, wn, ids, gids, bias, valid.to(torch.int32), y_loc,
            cosine_scale, False)
        corr = torch.where(owned, corr, 0.0)
        pred_gid = torch.where(amax >= 0, gids[amax.clamp_min(0).long()], -1)
        loss, metrics = _finish_ce_stats(m, z, corr, pred_gid, y_loc, owned,
                                         1.0 / global_batch, batch_axes)
    else:
        dt = f_loc.dtype
        f = _normalize(f_loc)
        w_act = _normalize(w_loc[ids.long()])   # the backward scatter-adds
        # bf16 operands, fp32 products and sums (preferred_element_type)
        logits = (f.float() @ w_act.to(dt).float().T) * cosine_scale
        logits = torch.where(valid[None, :], logits, -1e30)
        pos = hit.float().argmax(dim=1)          # the first hit
        loss, metrics = _finish_ce(logits, pos, owned, 1.0 / global_batch,
                                   batch_axes)
    with torch.no_grad():
        metrics["active_frac"] = batch_mean(
            dist.pmean(valid.float().mean()), batch_axes)
        metrics["label_recall"] = (batch_sum(dist.psum(owned.float()).sum(),
                                             batch_axes) / global_batch)
    return loss, metrics


def knn_softmax_ref(features, labels, w, graph, *, m: int,
                    cosine_scale: float = 16.0):
    """Single-device oracle of the KNN-softmax loss (graph: [N, k] global
    ids), with one "shard" owning all of W and no fillers."""
    cand = graph[labels.long()].long()           # [b, k]
    rank = torch.arange(graph.shape[1], device=cand.device)[None, :].expand_as(
        cand)
    flat_id = cand.reshape(-1)
    flat_rank = rank.reshape(-1)
    order = torch.sort((flat_id + 1) * (BIG_RANK + 1) + flat_rank,
                       stable=True).indices
    sid, srank = flat_id[order], flat_rank[order]
    first = torch.cat([torch.ones(1, dtype=torch.bool, device=sid.device),
                       sid[1:] != sid[:-1]])
    score = torch.where(first, BIG_RANK - srank, -1)
    top_score, top_pos = ops.topk_stable(score, m)
    maskv = top_score >= 0
    ids = torch.where(maskv, sid[top_pos.long()], 0)

    f = _normalize(features.float())
    wa = _normalize(w[ids].float())
    logits = f @ wa.T * cosine_scale
    logits = torch.where(maskv[None, :], logits, -1e30)
    hit = ids[None, :] == labels.long()[:, None]
    pos = hit.float().argmax(dim=1)
    corr = logits.gather(1, pos[:, None])[:, 0]
    return (torch.logsumexp(logits, dim=-1) - corr).mean()
