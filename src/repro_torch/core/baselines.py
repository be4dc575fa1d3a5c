"""Baseline softmax approximations the paper compares against (§4.1): the
port of the JAX package's ``core/baselines.py``.

* Selective softmax [Zhang et al., AAAI'18], HF-A flavoured: the active
  classes of a batch are the union of the locality-sensitive-hash buckets
  its features hit (random hyperplane tables over the normalised class
  weights), with the labels forced in.
* MACH [Medini et al., NeurIPS'19]: R hash functions map N classes to B
  buckets; R B-way softmaxes are trained, and class j scores the mean of
  P_r(hash_r(j)) at inference.
* Sampled softmax [Jean et al., ACL'15]: CE over the true label plus a
  drawn negative set, with the logQ correction. ``uniform`` draws
  per-member negatives without replacement (at ``n_samples >= V`` it is the
  full softmax exactly); ``log_uniform`` draws Zipfian ids with
  replacement, the same on every member.
* CSoft count-min sketch: MACH's training, decoded by the min (or the
  mean) of the rows' log-probabilities.

The ``*_local`` bodies are what one ring member runs (``repro_torch.dist``
stands in for the JAX mesh axis), each with ``backend="ref" | "kernel"``:
selective and sampled score their active columns through
``ops.sparse_ce_stats``, MACH and CSoft each repetition's bucket shard
through ``ops.ce_shard_stats``.

Random draws are the port's own (``torch.Generator``s on the tensors'
device; ROADMAP.md C.3): the LSH hyperplanes, the MACH bucket weights and
the sampled negatives do not reproduce the JAX package's ``jax.random``
bits, so the parity tests inject the JAX arrays (``planes``, the initial
weights, and ``sampled_softmax_loss``'s ``draw``). ``mach_hashes`` is numpy
and equals the JAX package's bit for bit.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import dist
from repro_torch.core.sharded_softmax import (NEG_INF, _finish_ce,
                                              _finish_ce_stats, _normalize,
                                              batch_mean, batch_sum)
from repro_torch.kernels import ops

_M32 = (1 << 32) - 1
_STEP_SALT = 2654435761          # the JAX package's step multiplier

# ---------------------------------------------------------------------------
# selective softmax (LSH active classes)
# ---------------------------------------------------------------------------


class LSHTables(NamedTuple):
    planes: torch.Tensor     # [R, D, n_bits] random hyperplanes
    offsets: torch.Tensor    # [R, n_buckets+1] CSR per table
    classes: torch.Tensor    # [R, nnz] class ids sorted by bucket


def lsh_planes(generator: torch.Generator, n_tables: int, d: int,
               n_bits: int, *, device) -> torch.Tensor:
    """[n_tables, d, n_bits] N(0, 1) hyperplanes from ``generator``."""
    return torch.randn((n_tables, d, n_bits), generator=generator,
                       device=device, dtype=torch.float32)


def _buckets(x_unit, planes):
    """[R, n] int32 bucket of each row of ``x_unit`` [n, D] in each table:
    bit k is the sign of the row against plane k, summed in int64 as the
    JAX package's ``bits * (1 << arange(n_bits))``."""
    bits = torch.einsum("nd,rdb->rnb", x_unit.float(), planes) > 0
    weight = 1 << torch.arange(planes.shape[-1], device=planes.device,
                               dtype=torch.int64)
    return (bits.long() * weight).sum(dim=-1).to(torch.int32)


def _csr(bucket, n_bits: int):
    """(offsets [R, 2^n_bits + 1], classes [R, n]) int32 of the bucket
    assignment [R, n]: a stable sort by bucket (``jnp.argsort``'s order on
    equal buckets), then each bucket's first position."""
    order = torch.argsort(bucket, dim=1, stable=True)
    sorted_b = bucket.gather(1, order).long().contiguous()
    edges = torch.arange((1 << n_bits) + 1, device=bucket.device)
    offsets = torch.searchsorted(
        sorted_b, edges.expand(bucket.shape[0], -1).contiguous())
    return offsets.to(torch.int32), order.to(torch.int32)


def build_sharded_lsh_tables(w_loc, planes):
    """This ring member's LSH tables: its own rows ``w_loc`` [V_loc, D]
    hashed through the shared ``planes`` (the same on every member), a CSR
    over LOCAL class ids. Every local class lands in one bucket a table,
    so no member needs another's rows. Returns (offsets [R, n_buckets+1],
    classes [R, V_loc]) int32, this member's row of the JAX package's
    [P, ...] arrays."""
    return _csr(_buckets(_normalize(w_loc.float()), planes),
                planes.shape[-1])


def build_lsh_tables(w, planes) -> LSHTables:
    """Single-device LSH tables of the class matrix ``w`` [N, D] through
    ``planes`` [R, D, n_bits]: one member's tables over all of it."""
    return LSHTables(planes, *build_sharded_lsh_tables(w, planes))


def _bucket_candidates(f, planes, offsets, classes, cap: int):
    """[R * b * cap] local class ids of the buckets the features ``f`` hit
    (up to ``cap`` per bucket, -1 past a bucket's end)."""
    bucket = _buckets(_normalize(f.float()), planes).long()     # [R, b]
    offsets = offsets.long()
    lo = offsets.gather(1, bucket)
    hi = offsets.gather(1, bucket + 1)
    take = lo[..., None] + torch.arange(cap, device=f.device)   # [R, b, cap]
    nnz = classes.shape[1]
    r = classes.shape[0]
    cand = classes.long().gather(
        1, take.clamp(0, nnz - 1).reshape(r, -1)).reshape(take.shape)
    return torch.where(take < hi[..., None], cand, -1).reshape(-1)


def _dedup_scores(cand, labels):
    """Sorted candidates and their scores: 2 for a label, 1 for another
    first occurrence, 0 for a repeat or -1 padding."""
    sid = torch.sort(cand).values
    first = torch.cat([torch.ones(1, dtype=torch.bool, device=sid.device),
                       sid[1:] != sid[:-1]])
    valid = first & (sid >= 0)
    ylab = torch.sort(labels).values
    pos = torch.searchsorted(ylab, sid)
    is_label = ylab[pos.clamp(0, ylab.shape[0] - 1)] == sid
    score = torch.where(valid, torch.where(is_label, 2, 1), 0)
    return sid, score


def selective_active(f, labels, tables: LSHTables, *, m: int, cap: int):
    """Active classes for a batch on one device: the union of the LSH
    buckets hit by each feature, plus the labels themselves. Returns (ids
    [m] int32, valid [m])."""
    cand = _bucket_candidates(f, tables.planes, tables.offsets,
                              tables.classes, cap)
    labels = labels.long()
    sid, score = _dedup_scores(torch.cat([labels, cand]), labels)
    top_score, top_pos = ops.topk_stable(score, m)
    ids = torch.where(top_score > 0, sid[top_pos.long()], 0)
    return ids.to(torch.int32), top_score > 0


def selective_softmax_ce(f, labels, w, tables: LSHTables, *, m: int,
                         cap: int, cosine_scale: float = 16.0):
    """Single-device selective-softmax CE (benchmark scale)."""
    ids, valid = selective_active(f, labels, tables, m=m, cap=cap)
    fn = _normalize(f.float())
    wa = _normalize(w[ids.long()].float())
    logits = fn @ wa.T * cosine_scale
    logits = torch.where(valid[None, :], logits, -1e30)
    hit = ids.long()[None, :] == labels.long()[:, None]
    pos = hit.float().argmax(dim=1)
    corr = logits.gather(1, pos[:, None])[:, 0]
    return (torch.logsumexp(logits, dim=-1) - corr).mean()


def selective_softmax_local(f_loc, y_loc, w_loc, planes, offsets_loc,
                            classes_loc, *, global_batch: int, m_local: int,
                            cap: int, cosine_scale: float = 16.0,
                            backend: str = "ref", batch_axes=()):
    """The selective-softmax loss body of one ring member (counterpart of
    ``full_softmax_local``).

    The member selects up to ``m_local`` active LOCAL classes: the union of
    the buckets of its own tables (``offsets_loc`` [R, n_buckets+1],
    ``classes_loc`` [R, V_loc]; a leading [1] axis is accepted) hit by
    every feature of the ring-gathered batch through the shared ``planes``
    [R, D, n_bits], with the labels it owns forced in, then completes the
    distributed CE with the usual pmax / psum pair. Unfilled slots are
    invalid columns. ``backend="kernel"`` scores the active columns through
    ``ops.sparse_ce_stats`` on the whole normalised shard. Returns (loss,
    {"accuracy", "logz", "active_frac", "label_recall"})."""
    offsets = offsets_loc.reshape(offsets_loc.shape[-2:])
    classes = classes_loc.reshape(classes_loc.shape[-2:])
    v_loc = w_loc.shape[0]
    v_start = dist.flat_axis_index() * v_loc
    y_rel = y_loc.long() - v_start
    owned_label = (y_rel >= 0) & (y_rel < v_loc)
    y_local = torch.where(owned_label, y_rel, -1)

    cand = _bucket_candidates(f_loc, planes, offsets, classes, cap)
    sid, score = _dedup_scores(torch.cat([y_local, cand]), y_local)
    take_n = min(m_local, score.shape[0])
    top_score, top_pos = ops.topk_stable(score, take_n)
    ids = sid[top_pos.long()]
    mask = top_score > 0
    if take_n < m_local:
        pad = m_local - take_n
        ids = torch.cat([ids, torch.zeros(pad, dtype=ids.dtype,
                                          device=ids.device)])
        mask = torch.cat([mask, torch.zeros(pad, dtype=torch.bool,
                                            device=mask.device)])
    ids = torch.where(mask, ids, 0)

    hit = (ids[None, :] == y_rel[:, None]) & mask[None, :]
    owned = owned_label & hit.any(dim=1)

    if backend == "kernel":
        f = _normalize(f_loc).float().contiguous()
        wn = _normalize(w_loc).float().contiguous()
        gids = (v_start + ids).to(torch.int32)
        bias = torch.zeros(ids.shape[0], dtype=torch.float32,
                           device=ids.device)
        m, z, corr, amax = ops.sparse_ce_stats(
            f, wn, ids.to(torch.int32), gids, bias, mask.to(torch.int32),
            y_loc, cosine_scale, False)
        corr = torch.where(owned, corr, 0.0)
        pred_gid = torch.where(amax >= 0, gids[amax.clamp_min(0).long()], -1)
        loss, metrics = _finish_ce_stats(m, z, corr, pred_gid, y_loc, owned,
                                         1.0 / global_batch, batch_axes)
    else:
        dt = f_loc.dtype
        f = _normalize(f_loc)
        w_act = _normalize(w_loc[ids])
        # operands in dt, products and sums in fp32 (preferred_element_type)
        logits = (f.float() @ w_act.to(dt).float().T) * cosine_scale
        logits = torch.where(mask[None, :], logits, -1e30)
        lpos = hit.float().argmax(dim=1)
        loss, metrics = _finish_ce(logits, lpos, owned, 1.0 / global_batch,
                                   batch_axes)
    with torch.no_grad():
        metrics["active_frac"] = batch_mean(
            dist.pmean(mask.float().mean()), batch_axes)
        metrics["label_recall"] = (batch_sum(dist.psum(owned.float()).sum(),
                                             batch_axes) / global_batch)
    return loss, metrics


# ---------------------------------------------------------------------------
# MACH
# ---------------------------------------------------------------------------


class MACHHead(NamedTuple):
    hashes: torch.Tensor     # [R, N] int32 bucket of each class per rep
    w: torch.Tensor          # [R, B_buckets, D]


def mach_hashes(n_classes: int, n_buckets: int, *, n_rep: int,
                seed: int = 0):
    """Static class->bucket tables [R, n_classes] int32 by universal hashing
    on the host: (a*j + b) mod p mod B. The (a, b) draw depends only on
    (seed, n_rep), not on the modulus, so the same family re-evaluated at a
    new bucket count reproduces the stored tables when the count is
    unchanged. numpy, so the tables equal the JAX package's bit for bit."""
    rng = np.random.default_rng(seed)
    p = 2_147_483_647
    a = rng.integers(1, p // 2, size=(n_rep, 1)).astype(np.int64) * 2 + 1
    b = rng.integers(0, p, size=(n_rep, 1)).astype(np.int64)
    j = np.arange(n_classes, dtype=np.int64)[None, :]
    return ((a * j + b) % p % n_buckets).astype(np.int32)


def init_mach(generator: torch.Generator, n_classes: int, d: int, *,
              n_buckets: int, n_rep: int, seed: int = 0,
              device="cpu") -> MACHHead:
    """Single-device MACH head: the hash tables and W [R, B, D] ~
    N(0, 1/D) from ``generator``."""
    hashes = torch.as_tensor(mach_hashes(n_classes, n_buckets, n_rep=n_rep,
                                         seed=seed), device=device)
    w = torch.randn((n_rep, n_buckets, d), generator=generator,
                    device=device) / math.sqrt(d)
    return MACHHead(hashes, w)


def mach_loss(head: MACHHead, f, labels):
    """Sum of the R bucket-level CE losses, averaged over the batch."""
    logits = torch.einsum("bd,rkd->rbk", f.float(), head.w.float())
    ybuck = head.hashes[:, labels.long()].long()                # [R, b]
    logz = torch.logsumexp(logits, dim=-1)
    corr = logits.gather(2, ybuck[:, :, None])[:, :, 0]
    return (logz - corr).sum(dim=0).mean()


def mach_predict(head: MACHHead, f):
    """argmax_j mean_r P_r(hash_r(j) | f): [b] class predictions."""
    logits = torch.einsum("bd,rkd->rbk", f.float(), head.w.float())
    probs = torch.softmax(logits, dim=-1)                       # [R, b, B]
    scores = torch.stack([probs[r][:, head.hashes[r].long()]
                          for r in range(probs.shape[0])]).mean(dim=0)
    return scores.argmax(dim=-1)


def mach_softmax_local(f_loc, y_loc, w_loc, hashes, *, global_batch: int,
                       backend: str = "ref", batch_axes=()):
    """The MACH loss body of one ring member: R independent B-way softmaxes
    with the BUCKET axis split over the ring. ``w_loc`` [R, B_loc, D] is
    this member's bucket block, ``hashes`` [R, N] replicated. Each
    repetition's CE is completed over the ring by folding the rep axis into
    the batch of the shared CE tail, so the loss is ``mach_loss``'s (the
    batch mean of the sum of R bucket CEs). The features are not
    normalised. ``backend="kernel"`` scores each repetition through
    ``ops.ce_shard_stats`` (no [R, b, B_loc] logits). ``accuracy`` is the
    mean bucket accuracy over the repetitions."""
    fl = f_loc.float()
    n_rep, b_loc = w_loc.shape[0], w_loc.shape[1]
    b = f_loc.shape[0]
    b_start = dist.flat_axis_index() * b_loc
    ybuck = hashes[:, y_loc.long()].long()                      # [R, b] global
    rel = ybuck - b_start
    owned = (rel >= 0) & (rel < b_loc)

    if backend == "kernel":
        f = fl.contiguous()
        # unbind: one stack of the reps' gradients in the backward, where a
        # select a rep would add R zero-padded [R, B_loc, D] gradients
        stats = [ops.ce_shard_stats(
                     f, w_r.float(),
                     torch.where(owned[r], rel[r], -1).to(torch.int32),
                     b_loc, 1.0)
                 for r, w_r in enumerate(w_loc.unbind(0))]     # R small
        m, z, corr, amax = (torch.cat([s[i] for s in stats])
                            for i in range(4))
        pred_gid = torch.where(amax >= 0, b_start + amax.long(), -1)
        loss, metrics = _finish_ce_stats(
            m, z, corr, pred_gid, ybuck.reshape(n_rep * b),
            owned.reshape(n_rep * b), 1.0 / global_batch, batch_axes)
    else:
        logits = torch.einsum("bd,rkd->rbk", fl, w_loc.float())  # [R,b,B_loc]
        loss, metrics = _finish_ce(
            logits.reshape(n_rep * b, b_loc),
            rel.clamp(0, b_loc - 1).reshape(n_rep * b),
            owned.reshape(n_rep * b), 1.0 / global_batch, batch_axes)
    metrics = dict(metrics)
    # the CE tail counted a hit per (rep, sample): report the mean per rep
    metrics["accuracy"] = metrics["accuracy"] / n_rep
    return loss, metrics


def _ring_bucket_softmax(f_loc, w_loc):
    """Per-rep logits [R, b, B_loc] of this member's buckets, with the
    ring's max m [R, b] and partition sum z [R, b]."""
    logits = torch.einsum("bd,rkd->rbk", f_loc.float(), w_loc.float())
    m = dist.pmax(logits.max(dim=-1).values)
    z = dist.psum(torch.exp(logits - m[..., None]).sum(dim=-1))
    return logits, m, z


def _local_class_index(hashes, b_loc: int):
    """(classes whose bucket this member owns [R, N], their local bucket
    [R, N] clipped into the block)."""
    rel = hashes.long() - dist.flat_axis_index() * b_loc
    return (rel >= 0) & (rel < b_loc), rel.clamp(0, b_loc - 1)


def mach_predict_local(f_loc, w_loc, hashes):
    """Distributed MACH inference: [b] int32 class predictions.

    A distributed softmax over each repetition's sharded buckets, then each
    member adds P_r(hash_r(j)) for the classes whose bucket it owns, one
    repetition at a time (the peak is one [b, N] score, not [R, b, N]), and
    one psum over the ring assembles the [b, N] score."""
    logits, m, z = _ring_bucket_softmax(f_loc, w_loc)
    probs = torch.exp(logits - m[..., None]) / z[..., None]     # local buckets
    del logits
    local, idx = _local_class_index(hashes, w_loc.shape[1])
    scores = torch.zeros((probs.shape[1], hashes.shape[1]),
                         dtype=torch.float32, device=probs.device)
    for r in range(probs.shape[0]):
        sc = probs[r][:, idx[r]]                                 # [b, N]
        scores += sc.masked_fill_(~local[r][None, :], 0.0)
        del sc
    scores = dist.psum(scores)
    return scores.argmax(dim=-1).to(torch.int32)


# ---------------------------------------------------------------------------
# sampled softmax [Jean et al., ACL'15]: logQ-corrected negative sampling
# ---------------------------------------------------------------------------


class SampledDraw(NamedTuple):
    ids: torch.Tensor         # [m] local candidate rows (int32)
    valid: torch.Tensor       # [m] bool: owned by this member, a real class
    logq: torch.Tensor        # [m] fp32 log expected count of each draw
    logq_y: torch.Tensor      # [] or [b] fp32, the same for the labels
    sample_frac: torch.Tensor  # [] fp32, the share of the classes drawn


def sampled_salt(y_loc, step=None) -> int:
    """The draw's salt, as the JAX package makes it: the uint32 sum of the
    batch's labels plus ``step * 2654435761``, wrapping at 2^32. (A host
    integer: the draw's generator is seeded from it.)"""
    salt = int(y_loc.long().sum()) & _M32
    if step is not None:
        salt = (salt + (int(step) & _M32) * _STEP_SALT) & _M32
    return salt


def _generator(device, seed: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed & ((1 << 63) - 1))
    return g


def sampled_draw(y_loc, *, v_loc: int, n_samples: int,
                 distribution: str = "uniform", seed: int = 17,
                 n_valid: int = 0, step=None) -> SampledDraw:
    """This ring member's negatives, a function of (seed, step, labels):

    * ``"uniform"``: ``min(V_loc, n_samples // P)`` distinct LOCAL classes,
      the head of a ``torch.randperm(V_loc)`` whose generator folds in the
      member's index (a stratified draw without replacement; every class at
      ``n_samples >= V``). The inclusion probability is the constant
      m_loc / V_loc.
    * ``"log_uniform"``: ``n_samples`` Zipfian global ids with replacement,
      the same on every member (the generator folds in no index); each
      member keeps the ids it owns, and logQ is log(n_samples * q(j)).

    The generators live on ``y_loc``'s device and are seeded from
    ``seed`` and ``sampled_salt(y_loc, step)``: the same (seed, step,
    labels) give the same draw."""
    n_shards = dist.world_size()
    n_eff = n_valid or v_loc * n_shards
    shard = dist.flat_axis_index()
    v_start = shard * v_loc
    dev = y_loc.device
    key = (int(seed) << 32) | sampled_salt(y_loc, step)

    if distribution == "uniform":
        m_loc = max(1, min(v_loc, n_samples // n_shards))
        g = _generator(dev, key * 1_000_003 + shard + 1)
        ids = torch.randperm(v_loc, generator=g, device=dev)[:m_loc]
        valid = torch.ones(m_loc, dtype=torch.bool, device=dev)
        if n_valid:
            valid &= (v_start + ids) < n_valid
        # the inclusion probability of a draw without replacement
        logq = torch.log(torch.full((m_loc,), m_loc / v_loc,
                                    dtype=torch.float32, device=dev))
        logq_y = torch.log(torch.tensor(float(m_loc), dtype=torch.float32,
                                        device=dev) / v_loc)
        frac = m_loc * n_shards / n_eff
    elif distribution == "log_uniform":
        m = n_samples
        u = torch.rand((m,), generator=_generator(dev, key), device=dev)
        gid = (torch.exp(u * math.log(float(n_eff + 1))) - 1.0).to(
            torch.int32).clamp(0, n_eff - 1)
        q = (torch.log((gid.float() + 2.0) / (gid.float() + 1.0))
             / math.log(float(n_eff + 1)))
        logq = torch.log(float(m) * q)                # log expected count
        rel = gid.long() - v_start
        valid = (rel >= 0) & (rel < v_loc)              # ownership mask
        ids = rel.clamp(0, v_loc - 1)
        yf = y_loc.float()
        qy = torch.log((yf + 2.0) / (yf + 1.0)) / math.log(float(n_eff + 1))
        logq_y = torch.log(float(m) * qy)
        frac = min(m, n_eff) / n_eff
    else:
        raise ValueError(f"unknown sampled distribution {distribution!r}")
    return SampledDraw(ids.to(torch.int32), valid, logq, logq_y,
                       torch.tensor(frac, dtype=torch.float32, device=dev))


def sampled_softmax_loss(f_loc, y_loc, w_loc, draw: SampledDraw, *,
                         global_batch: int, cosine_scale: float = 16.0,
                         backend: str = "ref", batch_axes=()):
    """The sampled-softmax loss body of one ring member, given its
    ``draw``: CE over the true label (scored by the member that owns it)
    plus the drawn candidates, each logit less its logQ, with accidental
    hits (a drawn id equal to the row's label) dropped from Z.
    ``backend="kernel"`` runs the candidates through ``ops.sparse_ce_stats``
    (bias -logQ, ``mask_hits=True``) and folds the label column into its
    per-row statistics. Returns (loss, {"accuracy", "logz",
    "sample_frac"})."""
    v_loc = w_loc.shape[0]
    v_start = dist.flat_axis_index() * v_loc
    y_rel = y_loc.long() - v_start
    owned = (y_rel >= 0) & (y_rel < v_loc)
    ids = draw.ids.long()

    dt = f_loc.dtype
    f, w = ((_normalize(f_loc), _normalize(w_loc)) if cosine_scale > 0
            else (f_loc, w_loc.to(dt)))
    scale = cosine_scale if cosine_scale > 0 else 1.0

    # the true label: scored by its owning member, the same correction
    w_y = w[y_rel.clamp(0, v_loc - 1)]
    logit_y = ((f.float() * w_y.to(dt).float()).sum(dim=-1) * scale
               - draw.logq_y)
    logit_y = torch.where(owned, logit_y, NEG_INF)

    if backend == "kernel":
        gids = (v_start + ids).to(torch.int32)
        m_s, z_s, _, amax_s = ops.sparse_ce_stats(
            f.float().contiguous(), w.float().contiguous(),
            draw.ids, gids, -draw.logq, draw.valid.to(torch.int32), y_loc,
            scale, True)
        m_row = torch.maximum(m_s, logit_y).detach()
        z_resc = torch.where(torch.isfinite(m_s),
                             torch.exp(m_s.detach() - m_row), 0.0)
        z_row = (z_s * z_resc
                 + torch.where(owned, torch.exp(logit_y - m_row), 0.0))
        corr_row = torch.where(owned, logit_y, 0.0)
        best_is_label = owned & (logit_y.detach() >= m_s)
        pred_gid = torch.where(
            best_is_label, y_loc.long(),
            torch.where(amax_s >= 0, gids[amax_s.clamp_min(0).long()].long(),
                        -1))
        loss, metrics = _finish_ce_stats(m_row, z_row, corr_row, pred_gid,
                                         y_loc, owned, 1.0 / global_batch,
                                         batch_axes)
    else:
        logits_s = (f.float() @ w[ids].to(dt).float().T) * scale
        logits_s = logits_s - draw.logq[None, :]
        acc_hit = (v_start + ids)[None, :] == y_loc.long()[:, None]
        logits_s = torch.where(draw.valid[None, :] & ~acc_hit, logits_s,
                               NEG_INF)
        logits = torch.cat([logits_s, logit_y[:, None]], dim=1)
        label_col = torch.full((f_loc.shape[0],), logits_s.shape[1],
                               dtype=torch.long, device=logits.device)
        loss, metrics = _finish_ce(logits, label_col, owned,
                                   1.0 / global_batch, batch_axes)
    metrics = dict(metrics)
    metrics["sample_frac"] = draw.sample_frac
    return loss, metrics


def sampled_softmax_local(f_loc, y_loc, w_loc, *, global_batch: int,
                          n_samples: int, distribution: str = "uniform",
                          seed: int = 17, cosine_scale: float = 16.0,
                          n_valid: int = 0, step=None, backend: str = "ref",
                          batch_axes=()):
    """``sampled_draw`` then ``sampled_softmax_loss``: the body the sampled
    head runs (counterpart of the JAX package's ``sampled_softmax_local``)."""
    draw = sampled_draw(y_loc, v_loc=w_loc.shape[0], n_samples=n_samples,
                        distribution=distribution, seed=seed,
                        n_valid=n_valid, step=step)
    return sampled_softmax_loss(f_loc, y_loc, w_loc, draw,
                                global_batch=global_batch,
                                cosine_scale=cosine_scale, backend=backend,
                                batch_axes=batch_axes)


# ---------------------------------------------------------------------------
# CSoft count-min sketch decode (training is mach_softmax_local)
# ---------------------------------------------------------------------------


def csoft_predict_local(f_loc, w_loc, hashes, *, agg: str = "min"):
    """Distributed count-min-sketch decode: [b] int32 class predictions.

    A distributed log-softmax over each repetition's sharded buckets; class
    j scores the ``min`` over the repetitions of log P_r(hash_r(j)) (each
    row over-counts j by its bucket's collisions, so the min is the
    tightest estimate), or their ``mean`` (the geometric mean of the
    probabilities). The peak is one [b, N] score a repetition."""
    logits, m, z = _ring_bucket_softmax(f_loc, w_loc)
    logp = logits - m[..., None] - torch.log(z)[..., None]      # local buckets
    del logits
    local, idx = _local_class_index(hashes, w_loc.shape[1])
    scores = None
    for r in range(logp.shape[0]):
        sc = dist.psum(logp[r][:, idx[r]].masked_fill_(~local[r][None, :],
                                                       0.0))
        if scores is None:
            scores = sc
        elif agg == "min":
            torch.minimum(scores, sc, out=scores)
        else:
            scores += sc
        del sc
    if agg == "mean":
        scores = scores / logp.shape[0]
    return scores.argmax(dim=-1).to(torch.int32)
