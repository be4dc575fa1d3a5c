"""Hybrid-parallel softmax bodies over a row-sharded class matrix (paper
§3.1, §4.5): the port of the JAX package's ``core/sharded_softmax.py``
(training, serving, and the IVF index's serving bodies).

W [N, D] is split by class rows across the ring; each member scores its own
block and the results combine with small collectives (``repro_torch.dist``)
— the counterparts of JAX's shard_map bodies. Every body takes
``backend="ref" | "kernel"``: ``ref`` is dense torch ops, ``kernel`` runs
the local scoring through the hand-written kernels
(``repro_torch.kernels.ops``).

Training (``full_softmax_local``): each member scores its class shard
against the ring-gathered batch and the softmax is completed with small
collectives — global max (``pmax``), partition sum and label logit
(``psum``). The class-weight gradient stays local to its shard. The JAX
trainer calls these bodies with ``batch_axes=()`` (its loss psum is the
identity) and the zoo trainer with the mesh's residual batch axes
(``("data",)``, ``("pod", "data")``): the loss is ``psum(sum(per-sample)
/ global_batch)`` over ``batch_axes``, every data shard's rows counted
once, and ``logz`` their ``pmean``.
"""
from __future__ import annotations

import torch

from repro_torch import dist
from repro_torch.kernels import ops

NEG_INF = -1e30
_INT32_MAX = 2**31 - 1


def _normalize(x):
    xf = x.float()
    return (xf / (torch.linalg.vector_norm(xf, dim=-1, keepdim=True)
                  + 1e-12)).to(x.dtype)


def ce_ref(features, labels, w, *, cosine_scale: float = 0.0,
           label_smoothing: float = 0.0):
    """Plain full-softmax cross entropy on one device: features [T,D],
    labels [T], w [N,D]. ``cosine_scale > 0`` switches to normalised
    (cosine) logits, the paper's normalisation strategy (§3.2.1)."""
    f = features.float()
    wf = w.float()
    if cosine_scale > 0:
        f = f / (torch.linalg.vector_norm(f, dim=-1, keepdim=True) + 1e-12)
        wf = wf / (torch.linalg.vector_norm(wf, dim=-1, keepdim=True) + 1e-12)
    logits = f @ wf.T
    if cosine_scale > 0:
        logits = logits * cosine_scale
    logz = torch.logsumexp(logits, dim=-1)
    corr = logits.gather(1, labels.long()[:, None])[:, 0]
    if label_smoothing > 0:
        corr = ((1 - label_smoothing) * corr
                + label_smoothing * logits.mean(dim=-1))
    loss = (logz - corr).mean()
    acc = (logits.argmax(dim=-1) == labels.long()).float().mean()
    return loss, {"accuracy": acc, "logz": logz.mean()}


def batch_sum(x, batch_axes):
    """``psum`` over the batch axes (none: the identity)."""
    return dist.psum(x, tuple(batch_axes)) if batch_axes else x


def batch_mean(x, batch_axes):
    """``pmean`` over the batch axes (none: the identity)."""
    return dist.pmean(x, tuple(batch_axes)) if batch_axes else x


def _finish_ce(logits, owned_label_pos, owned, batch_weight: float,
               batch_axes=()):
    """Distributed-CE tail over dense local logits [b, C_local] (already
    scaled). ``owned_label_pos`` [b] is each label's local column (only
    meaningful where ``owned``); exactly one member owns each label.
    Returns (loss, metrics), the same on every member."""
    m_loc = logits.detach().max(dim=-1).values
    m = dist.pmax(m_loc)
    z = dist.psum(torch.exp(logits - m[:, None]).sum(dim=-1))
    corr_loc = logits.gather(1, owned_label_pos.long()[:, None])[:, 0]
    corr = dist.psum(torch.where(owned, corr_loc, 0.0))
    per_sample = torch.log(z) + m - corr
    loss = batch_sum(per_sample.sum() * batch_weight, batch_axes)

    # distributed top-1 accuracy (metrics only: no gradient)
    with torch.no_grad():
        lg = logits.detach()
        amax_loc = lg.argmax(dim=-1)
        vmax_loc = lg.gather(1, amax_loc[:, None])[:, 0]
        is_best = vmax_loc >= dist.pmax(vmax_loc)
        pred_here = owned & is_best & (amax_loc == owned_label_pos.long())
        correct = dist.psum(pred_here.float()) > 0
        acc = batch_sum(correct.float().sum() * batch_weight, batch_axes)
        logz = batch_mean((torch.log(z) + m).mean(), batch_axes)
    return loss, {"accuracy": acc, "logz": logz}


def _finish_ce_stats(m_loc, z_loc, corr_loc, pred_gid, y, owned,
                     batch_weight: float, batch_axes=()):
    """Distributed-CE tail from per-shard online-softmax statistics (the
    kernel backend's counterpart of ``_finish_ce``). ``m_loc`` / ``z_loc``
    / ``corr_loc`` [b]: each shard's running max, partition sum relative to
    it, and label-logit contribution (0 off the owner). ``pred_gid`` [b]:
    the shard's best candidate as a global class id (-1 when it scored
    nothing). Gradients flow through ``z_loc`` and ``corr_loc`` into the
    backward kernel; ``m_loc`` is a non-differentiable statistic."""
    m_sg = m_loc.detach()
    m = dist.pmax(m_sg)
    z_resc = torch.where(torch.isfinite(m_sg), torch.exp(m_sg - m), 0.0)
    z = dist.psum(z_loc * z_resc)
    corr = dist.psum(corr_loc)
    per_sample = torch.log(z) + m - corr
    loss = batch_sum(per_sample.sum() * batch_weight, batch_axes)

    with torch.no_grad():
        is_best = m_sg >= m      # ties: >=; duplicates across shards unlikely
        pred_here = owned & is_best & (pred_gid.long() == y.long())
        correct = dist.psum(pred_here.float()) > 0
        acc = batch_sum(correct.float().sum() * batch_weight, batch_axes)
        logz = batch_mean((torch.log(z.detach()) + m).mean(), batch_axes)
    return loss, {"accuracy": acc, "logz": logz}


def full_softmax_local(f_loc, y_loc, w_loc, *, global_batch: int,
                       cosine_scale: float = 0.0, n_valid: int = 0,
                       backend: str = "ref", batch_axes=()):
    """The full-softmax loss body of one ring member. ``f_loc`` [b, D] is
    the ring-gathered batch (the same on every member), ``y_loc`` [b]
    global class ids, ``w_loc`` [V_loc, D] this member's class shard (row
    offset from its ring index). ``n_valid > 0`` masks padded vocab rows.
    ``backend="kernel"`` streams the scoring through ``ops.ce_shard_stats``
    (no [b, V_loc] logits on the card, forward or backward); ``"ref"``
    forms dense logits. ``batch_axes``: the axes the batch's rows are split
    over (``f_loc`` / ``y_loc`` this data shard's). Returns (loss,
    {"accuracy", "logz"})."""
    v_loc = w_loc.shape[0]
    v_start = dist.flat_axis_index() * v_loc
    pos = (y_loc.long() - v_start)
    owned = (pos >= 0) & (pos < v_loc)
    if backend == "kernel":
        f, w = ((_normalize(f_loc), _normalize(w_loc)) if cosine_scale > 0
                else (f_loc, w_loc))
        scale = cosine_scale if cosine_scale > 0 else 1.0
        y_local = torch.where(owned, pos, -1).to(torch.int32)
        limit = _shard_limit(v_start, v_loc, n_valid)
        m, z, corr, amax = ops.ce_shard_stats(
            f.float().contiguous(), w.float().contiguous(), y_local, limit,
            scale)
        pred_gid = torch.where(amax >= 0, v_start + amax.long(), -1)
        return _finish_ce_stats(m, z, corr, pred_gid, y_loc, owned,
                                1.0 / global_batch, batch_axes)
    dt = f_loc.dtype
    f, w = ((_normalize(f_loc), _normalize(w_loc)) if cosine_scale > 0
            else (f_loc, w_loc.to(dt)))
    # operands rounded to dt, products and sums in fp32 (JAX's
    # preferred_element_type=float32): bf16 products are exact in fp32
    logits = f.float() @ w.to(dt).float().T
    if cosine_scale > 0:
        logits = logits * cosine_scale
    if n_valid:
        col = v_start + torch.arange(v_loc, device=logits.device)
        logits = torch.where((col < n_valid)[None, :], logits, NEG_INF)
    return _finish_ce(logits, pos.clamp(0, v_loc - 1), owned,
                      1.0 / global_batch, batch_axes)


def _shard_limit(v_start: int, v_loc: int, n_valid: int) -> int:
    """Valid-column count of this shard: masks vocab padding inside the
    kernels. n_valid == 0 means no padding."""
    if not n_valid:
        return v_loc
    return max(0, min(n_valid - v_start, v_loc))


def _combine_argmax(vmax, gid):
    """One winner per row across the ring: lowest shard index among ties.
    vmax [b] local best value, gid [b] its global class id."""
    gmax = dist.pmax(vmax)
    shard = dist.flat_axis_index()
    is_best = vmax >= gmax
    winner = dist.pmin(torch.where(
        is_best, torch.full_like(gid, shard, dtype=torch.int32),
        torch.full_like(gid, _INT32_MAX, dtype=torch.int32)))
    mine = is_best & (winner == shard)
    return dist.psum(torch.where(mine, gid.to(torch.int32), 0)).to(
        torch.int32)


def serve_argmax_local(f_loc, w_loc, *, n_valid: int = 0):
    """Kernel-backend greedy decode: distributed argmax class ids without
    materialising the [b, V_loc] scores — the streaming kernel's (max,
    argmax) stats plus one pmax/pmin/psum combine. Counterpart of
    ``serve_logits_local``."""
    v_loc = w_loc.shape[0]
    v_start = dist.flat_axis_index() * v_loc
    limit = _shard_limit(v_start, v_loc, n_valid)
    b = f_loc.shape[0]
    y_none = torch.full((b,), -1, dtype=torch.int32, device=f_loc.device)
    m, _, _, amax = ops.ce_shard_stats(f_loc.float(), w_loc.float(), y_none,
                                       limit, 1.0)
    gid = v_start + amax.clamp_min(0)
    vmax = torch.where(amax >= 0, m, float("-inf"))
    return _combine_argmax(vmax, gid), None


def serve_logits_local(f_loc, w_loc, *, n_valid: int = 0):
    """Local fp32 logits [b, V_loc] + distributed argmax class ids: each
    shard proposes (best value, global id), combined over the ring. W is
    rounded to the features' dtype and the product is taken in fp32 (the
    JAX package's ``preferred_element_type=float32``): with bf16 features
    the products are exact and only their fp32 sums are rounded, so the
    argmax meets no ties that bf16 logits would make."""
    logits = f_loc.float() @ w_loc.to(f_loc.dtype).float().T
    v_loc = w_loc.shape[0]
    v_start = dist.flat_axis_index() * v_loc
    if n_valid:
        col = v_start + torch.arange(v_loc, device=logits.device)
        logits = torch.where((col < n_valid)[None, :], logits, NEG_INF)
    amax = logits.argmax(dim=-1)
    vmax = logits.gather(1, amax[:, None])[:, 0]
    gid = v_start + amax.to(torch.int32)
    return _combine_argmax(vmax, gid), logits


def _merge_topk_ring(vals, gids, k: int):
    """Merge per-shard top-k candidates into the global top-k: one
    all-gather over the ring, then a small [b, P*k] stable top-k (ties to
    the lowest shard, then the lowest slot). Returns (vals [b, k] desc,
    gids [b, k]), the same on every member."""
    all_v = dist.all_gather(vals, dim=0, tiled=False)      # [P, b, k]
    all_g = dist.all_gather(gids, dim=0, tiled=False)
    b = vals.shape[0]
    flat_v = all_v.movedim(0, 1).reshape(b, -1)            # [b, P*k]
    flat_g = all_g.movedim(0, 1).reshape(b, -1)
    top_v, pos = ops.topk_stable(flat_v, k)
    return top_v, flat_g.gather(1, pos.long())


def serve_topk_local(f_loc, w_loc, k: int, *, n_valid: int = 0,
                     backend: str = "ref", chunk: int = 2048):
    """Top-k retrieval with scores. Each shard scores its class block
    ([b, V_loc] — serving's product is the scores), selects its local top-k
    per row (``ref``: a stable sort; ``kernel``: the divide-and-conquer
    stage-1 kernel via ``ops.topk_rows``), then one all-gather merges the
    P*k survivors. Returns (vals [b,k] desc, gids [b,k] int32)."""
    logits = f_loc.float() @ w_loc.to(f_loc.dtype).float().T   # as above
    v_loc = w_loc.shape[0]
    v_start = dist.flat_axis_index() * v_loc
    if n_valid:
        col = v_start + torch.arange(v_loc, device=logits.device)
        logits = torch.where((col < n_valid)[None, :], logits, NEG_INF)
    kk = min(k, v_loc)
    if backend == "kernel":
        vals, idx = ops.topk_rows(logits, kk, chunk=chunk)
    else:
        vals, idx = ops.topk_stable(logits, kk)
    gids = v_start + idx.to(torch.int32)
    if kk < k:  # more slots than local classes: pad before the merge
        pad = k - kk
        vals = torch.nn.functional.pad(vals, (0, pad), value=float("-inf"))
        gids = torch.nn.functional.pad(gids, (0, pad), value=-1)
    return _merge_topk_ring(vals, gids, k)


def mask_padded_rows(x, n_queries: int, fill):
    """Serving-tier padding mask: rows >= ``n_queries`` of a fixed-shape
    micro-batch are coalescer padding, not real queries — force them to
    ``fill``. Works for [b] and [b, k] outputs."""
    b = x.shape[0]
    keep = (torch.arange(b, device=x.device) < n_queries).reshape(
        (b,) + (1,) * (x.dim() - 1))
    return torch.where(keep, x, torch.full_like(x, fill))


def serve_topk_batched_local(f_loc, w_loc, k: int, n_queries: int, *,
                             n_valid: int = 0, backend: str = "ref",
                             chunk: int = 2048):
    """Multi-query serving entry point: ``f_loc`` is a padded micro-batch
    [b_pad, D], the same on every member, with only the first ``n_queries``
    rows real. Padded rows come back as (-inf, -1)."""
    vals, gids = serve_topk_local(f_loc, w_loc, k, n_valid=n_valid,
                                  backend=backend, chunk=chunk)
    return (mask_padded_rows(vals, n_queries, float("-inf")),
            mask_padded_rows(gids, n_queries, -1))


def serve_topk_ivf_local(f_loc, w_loc, cent_loc, members_loc, k: int,
                         nprobe: int, *, backend: str = "ref",
                         block_a: int = 128):
    """IVF top-k retrieval (``repro_torch.serving.index``): probe the
    query's top-``nprobe`` centroids of this shard, rerank ONLY the member
    rows of the probed clusters, then merge over the ring with the same
    all-gather as the exact scan.

    ``f_loc`` [b, D], the same on every member; ``w_loc`` [V_loc, D] the
    class shard; ``cent_loc`` [C, D] unit centroids fit over it;
    ``members_loc`` [C, cap] int32 local row ids per cluster, -1 padded
    (every valid class sits in exactly one cluster, so ``nprobe == C``
    gives the exact scan's ids). The probe takes the normalised query
    against the centroids (``ops.topk_stable``: ties to the lowest
    cluster); the candidates keep probe order, ``cap`` slots a cluster.
    The rerank scores raw ``f . w`` dot products, as the exact path does
    (``ref``: gather + einsum + stable top-k; ``kernel``: the fused
    ``ops.ivf_rerank_probed`` on ``members_loc`` and the probe, which reads
    each probed row once for the queries that probe its cluster and never
    builds the candidate list); equal scores keep candidate order. Cosine heads
    normalise f and w before calling. ``block_a`` is the TPU kernel's
    candidate tile, kept for the JAX package's signature: the result does
    not depend on it. Returns (vals [b, k] desc,
    gids [b, k]); slots without a real candidate are (-inf, -1)."""
    c = members_loc.shape[0]
    v_loc = w_loc.shape[0]
    v_start = dist.flat_axis_index() * v_loc
    f = f_loc.float()
    b = f.shape[0]
    _, probe = ops.topk_stable(_normalize(f) @ cent_loc.float().T,
                               min(nprobe, c))
    kk = min(k, probe.shape[1] * members_loc.shape[1])
    if backend == "kernel":
        vals, lids = ops.ivf_rerank_probed(
            f.contiguous(), w_loc.float().contiguous(),
            members_loc.contiguous(), probe.contiguous(), kk)
    else:
        cand = members_loc[probe.long()].reshape(b, -1).contiguous()   # [b, A]
        wc = w_loc.float()[cand.clamp(0, v_loc - 1).long()]      # [b, A, D]
        s = torch.einsum("bd,bad->ba", f, wc)
        s = torch.where(cand >= 0, s, float("-inf"))
        vals, pos = ops.topk_stable(s, kk)
        lids = cand.gather(1, pos.long())
    gids = torch.where(lids >= 0, v_start + lids, -1).to(torch.int32)
    vals = torch.where(lids >= 0, vals, float("-inf"))
    if kk < k:  # fewer candidates than slots: pad before the merge
        pad = k - kk
        vals = torch.nn.functional.pad(vals, (0, pad), value=float("-inf"))
        gids = torch.nn.functional.pad(gids, (0, pad), value=-1)
    return _merge_topk_ring(vals, gids, k)


def serve_topk_ivf_batched_local(f_loc, w_loc, cent_loc, members_loc,
                                 k: int, nprobe: int, n_queries: int, *,
                                 backend: str = "ref", block_a: int = 128):
    """Serving-tier entry of the IVF path: a padded micro-batch [b_pad, D]
    with only the first ``n_queries`` rows real; padded rows come back as
    (-inf, -1), as on the exact path."""
    vals, gids = serve_topk_ivf_local(f_loc, w_loc, cent_loc, members_loc,
                                      k, nprobe, backend=backend,
                                      block_a=block_a)
    return (mask_padded_rows(vals, n_queries, float("-inf")),
            mask_padded_rows(gids, n_queries, -1))
