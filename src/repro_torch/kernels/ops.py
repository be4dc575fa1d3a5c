"""Public wrappers around the kernels: the port of the JAX package's
``kernels/ops.py`` for the slices landed so far (``ce_shard_stats`` with
its backward, ``fused_ce``, ``fused_ce_stats``, ``sparse_ce_stats``,
``dist_topk``, ``ivf_rerank`` (and ``ivf_rerank_probed``, the IVF serve's
entry), ``flash_attention``, row-wise and flat
divide-and-conquer top-k, and DGC's threshold ``topk_threshold``).

``ce_shard_stats`` and ``sparse_ce_stats`` are ``torch.autograd.Function``s
over per-row online-softmax statistics ``(m, z, corr, amax)``, as the JAX
package's are ``custom_vjp``s: the distributed completion (pmax / psum over
the ring, metrics) is plain torch in ``core.sharded_softmax``, and autograd
through it delivers the per-row cotangents ``(gz, gc)`` that the streaming
backward kernels consume. ``m`` and ``amax`` are non-differentiable: the
true total derivative of ``m`` cancels exactly against ``z``'s internal
rescaling (``z·e^m`` is m-free), so dropping its cotangent is exact.

Stage 2 of the top-k merge is ``topk_stable``: a stable descending sort,
so ties go to the lowest position exactly as ``lax.top_k`` does
(``torch.topk`` does not promise that).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ce_softmax as _ce
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ivf_rerank as _ivf
from repro_torch.kernels import knn_dist_topk as _dk
from repro_torch.kernels import sparse_ce as _sp
from repro_torch.kernels import topk_dc as _dc


def topk_stable(x, k: int):
    """Top-k along the last axis, values descending, ties to the lowest
    index. Returns (vals, int32 positions)."""
    vals, pos = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], pos[..., :k].to(torch.int32)


def topk_dc(x, k: int, *, chunk: int = 2048):
    """Exact top-k of a flat tensor by chunked two-stage selection.
    Returns (vals [k] desc, ids [k] int32 into x)."""
    n = x.shape[0]
    x = x.float()
    if n <= chunk:
        return topk_stable(x, min(k, n))
    kk = min(k, chunk)
    sub_v, sub_i = _dc.stage1_topk(x[None, :], kk, chunk=chunk)   # stage 1
    base = (torch.arange(sub_v.shape[0], device=x.device,
                         dtype=torch.int32) * chunk)[:, None]
    flat_v = sub_v.reshape(-1)
    flat_i = (sub_i + base).reshape(-1)
    vals, pos = topk_stable(flat_v, min(k, flat_v.shape[0]))      # stage 2
    return vals, flat_i[pos.long()]


def topk_threshold(x_abs, k: int, *, chunk: int = 2048):
    """k-th largest value (DGC's threshold) through ``topk_dc``: on a CUDA
    tensor longer than ``chunk``, stage 1 is the ``stage1_topk`` kernel."""
    vals, _ = topk_dc(x_abs, k, chunk=chunk)
    return vals[-1]


def topk_rows(x, k: int, *, chunk: int = 2048):
    """Row-wise exact top-k of x [B, N] through the stage-1 kernel: each
    row is cut into chunks, per-chunk top-k runs on the kernel, and a small
    stage 2 merges the survivors. Returns (vals [B, k] desc, ids [B, k]
    int32 column indices). Powers the top-k serving path."""
    b, n = x.shape
    x = x.float()
    kk = min(k, n)
    if n <= chunk:
        return _dc.stage1_topk(x, kk)
    nch = -(-n // chunk)
    kc = min(kk, chunk)
    sub_v, sub_i = _dc.stage1_topk(x, kc, chunk=chunk)   # ragged tail masked
    base = (torch.arange(nch, device=x.device, dtype=torch.int32)
            * chunk)[None, :, None]
    flat_v = sub_v.reshape(b, nch * kc)
    flat_i = (sub_i.reshape(b, nch, kc) + base).reshape(b, nch * kc)
    vals, pos = topk_stable(flat_v, kk)
    return vals, flat_i.gather(1, pos.long())


class _CEShardStats(torch.autograd.Function):
    @staticmethod
    def forward(ctx, f, w, y, limit, scale):
        m, z, corr, amax = _ce.ce_forward(f, w, y, limit=limit, scale=scale)
        ctx.save_for_backward(f, w, y, m)
        ctx.limit, ctx.scale = limit, scale
        ctx.mark_non_differentiable(m, amax)
        return m, z, corr, amax

    @staticmethod
    def backward(ctx, gm, gz, gc, gamax):
        f, w, y, m = ctx.saved_tensors
        # gm / gamax are dropped: exact (module doc)
        gz = torch.zeros_like(m) if gz is None else gz
        gc = torch.zeros_like(m) if gc is None else gc
        df, dw = _ce.ce_backward(f, w, y, m, gz, gc, limit=ctx.limit,
                                 scale=ctx.scale)
        return (df if ctx.needs_input_grad[0] else None,
                dw if ctx.needs_input_grad[1] else None, None, None, None)


def ce_shard_stats(f, w, y, limit, scale: float = 1.0):
    """Streaming online-softmax stats of f [B,D] against the class shard
    w [V,D]: per-row (m, z, corr, amax). y [B] are LOCAL ids (-1 / out of
    range = label not owned by this shard); ``limit`` masks columns
    >= limit (vocab padding). The [B, V] logit tensor never exists on the
    card, forward or backward; m and amax are non-differentiable."""
    return _CEShardStats.apply(f, w, y, limit, scale)


def fused_ce(f, w, y, scale: float = 1.0):
    """Mean CE of rows whose label is in-shard; [B, V] never exists.
    f [B,D], w [V,D], y [B] local ids (-1 / out of range = not owned
    here). Single-shard convenience over ``ce_shard_stats`` (gradients
    flow through its backward kernel)."""
    m, z, corr, _ = ce_shard_stats(f, w, y, w.shape[0], scale)
    return (torch.log(z) + m - corr).mean()


def fused_ce_stats(f, w, y, *, scale: float = 1.0):
    """(m, z, corr) building blocks for the distributed (sharded) loss."""
    m, z, corr, _ = _ce.ce_forward(f, w, y, scale=scale)
    return m, z, corr


def dist_topk(q, kmat, kprime: int, *, col_offset: int = 0):
    """Fused score + top-k' (the graph build's inner loop): q [Nq, D] x
    kmat [Nk, D], both bf16 -> (vals [Nq, k'] fp32 descending, ids [Nq, k']
    int32 columns + ``col_offset``, (-inf, -1) past Nk). Ties go to the
    lowest column. The [Nq, Nk] scores never exist on the card."""
    return _dk.dist_topk(q, kmat, kprime, col_offset=col_offset)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """Forward flash attention: q [BH, Sq, Dh], k / v [BH / g, T, Dh] ->
    [BH, Sq, Dh]. Positions are implicit (row i is position i); query head
    h reads KV head h // g (GQA without copies).

    Forward only, as the JAX package's Pallas kernel is (it has no
    ``custom_vjp``): under grad mode with an input that requires grad it
    raises on every device, since the card's output would carry no
    gradient. The zoo trainer (ROADMAP A.9.1) trains attention on the ref
    branches."""
    if torch.is_grad_enabled() and any(
            x.requires_grad for x in (q, k, v)):
        raise RuntimeError(
            "flash_attention is forward only (no backward kernel, as the JAX "
            "package's Pallas kernel has none): call it under "
            "torch.no_grad(), or train attention on the ref backend, as "
            "the zoo trainer (ROADMAP A.9.1) does")
    return _fa.flash_attention(q, k, v, causal=causal, window=window)


def ivf_rerank(f, w, cand, k: int, *, block_a: int = 128):
    """Fused gather + top-k rerank of IVF candidates: f [B, D] x the rows
    ``cand`` [B, A] (int32 local ids, -1 = padding) of the shard w [V, D]
    -> (vals [B, k] fp32 descending, ids [B, k] int32 row ids, -1 where a
    row has fewer than k real candidates). Equal values keep the order of
    their slots in ``cand``. ``block_a`` is the TPU kernel's candidate tile,
    kept for the JAX package's signature: the result does not depend on it,
    and the CUDA kernel cuts candidates into segments of its own."""
    if block_a < 1:
        raise ValueError(f"block_a must be positive, got {block_a}")
    return _ivf.ivf_rerank(f, w, cand, k)


def ivf_rerank_probed(f, w, members, probe, k: int):
    """``ivf_rerank`` of the IVF serve's candidates
    ``members[probe].reshape(B, -1)`` without building them: members
    [C, cap] int32 local ids of each cluster (-1 padded), probe [B, P]
    int32 cluster ids in probe order. The same result, ties by candidate
    position included, from the same kernel."""
    return _ivf.ivf_rerank_probed(f, w, members, probe, k)


class _SparseCEStats(torch.autograd.Function):
    @staticmethod
    def forward(ctx, f, w, ids, gids, bias, valid, y, scale, mask_hits):
        m, z, corr, amax, hit = _sp.sparse_ce_forward(
            f, w, ids, gids, bias, valid, y, scale=scale, mask_hits=mask_hits)
        ctx.save_for_backward(f, w, ids, gids, bias, valid, y, m, hit)
        ctx.scale, ctx.mask_hits = scale, mask_hits
        ctx.mark_non_differentiable(m, amax)
        return m, z, corr, amax

    @staticmethod
    def backward(ctx, gm, gz, gc, gamax):
        f, w, ids, gids, bias, valid, y, m, hit = ctx.saved_tensors
        # gm / gamax are dropped: exact (module doc)
        gz = torch.zeros_like(m) if gz is None else gz
        gc = torch.zeros_like(m) if gc is None else gc
        df, dw = _sp.sparse_ce_backward(
            f, w, ids, gids, bias, valid, y, m, gz, gc, hit, scale=ctx.scale,
            mask_hits=ctx.mask_hits)
        return (df if ctx.needs_input_grad[0] else None,
                dw if ctx.needs_input_grad[1] else None,
                None, None, None, None, None, None, None)


def sparse_ce_stats(f, w, ids, gids, bias, valid, y, scale: float = 1.0,
                    mask_hits: bool = False):
    """Fused gather + streaming CE stats over an active-class set.

    f [B,D]; w [V,D] (the whole shard: rows are gathered in the kernel);
    ids [A] local candidate rows; gids [A] global candidate ids; bias [A]
    per-column logit shift; valid [A] column mask; y [B] GLOBAL labels.
    ``mask_hits`` drops candidates whose gid is the row's label from z
    (sampled softmax's accidental hits) instead of folding the first into
    corr (knn / selective label columns).

    Returns per-row fp32 (m, z, corr) and int32 amax (the best column);
    m and amax are non-differentiable. Only f and w receive gradients: dW
    is dense [V, D], the repeated ids' rows summed deterministically."""
    return _SparseCEStats.apply(f, w, ids, gids, bias, valid, y, scale,
                                mask_hits)
