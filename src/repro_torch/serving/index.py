"""``repro_torch.serving.index`` — the IVF coarse quantizer over the class
shards: the port of the JAX package's ``repro.serving.index``.

Serving cost is linear in the class count V when every query scores the
whole [V/P, D] shard. ``IVFIndex`` clusters each shard's class rows and,
at serve time, scores only the rows of the clusters nearest the query:

  * **fit** — spherical k-means (Lloyd on unit rows, assignment by the
    largest dot product, ties to the lowest cluster, centroids renormalised
    each iteration, an empty cluster keeping its centroid) from a
    deterministic strided initialisation. Each ring member fits its own
    shard, as the JAX package's shard_map body does. The products run as
    plain torch matrix products on the card; the centroid sums are the
    one-hot product of the reference, taken over fixed row chunks in a
    fixed order, so two fits of the same W give the same bits.
  * **packing** — a capacity-balanced member tensor [C, cap] int32 with
    ``cap = ceil(1.25 * V_loc / C)``: rows claim clusters most-confident
    first (stable by row), each walking its preferences in (score desc,
    cluster asc) order and taking the first cluster with space. It gives
    exactly the reference's members for the same scores. The reference
    sorts the whole [V_loc, C] score matrix on the host and claims row by
    row in Python; here the scores and each row's first ``SHORT_LIST``
    preferences come from the card, and ``_claim`` claims a block of rows
    at once: every row of the block takes its first preference that was
    open when the block began, and the block is accepted up to the first
    row that would overfill its cluster. Up to there the sequential claim
    makes the same choices (every earlier preference was already full, and
    the chosen cluster still has room), so the result is the reference's.
    A row whose short list is full takes the best open cluster from its
    full score row on the card.
  * **lifecycle** — the index records the experiment's ``weights_version``
    at fit time; the engine refits when it moves.
    ``state_to_save`` / ``state_from_restore`` turn the index into a tree
    of tensors, laid out as the JAX package's, and back;
    ``repro_torch.checkpoint.save`` writes it, so a restarted server
    installs the index instead of refitting it.

The two normalisations of the reference are kept as they are: the fit's
``x / (|x| + 1e-12)`` (``core.sharded_softmax._normalize``) and the
packing's ``x / max(|x|, 1e-12)``.

Defaults: C = round(sqrt(V_loc)) clusters per shard, nprobe =
max(2, C // 32).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch import dist
from repro_torch.core.sharded_softmax import _normalize, _shard_limit

SHORT_LIST = 8          # preferences per row taken from the card
_ROW_CHUNK = 1 << 16    # rows per product (65,536 x C fp32 scores)
_CLAIM_BLOCK = 1 << 14  # the most rows one claim step takes


def default_n_clusters(v_loc: int) -> int:
    """sqrt(V_loc) clusters per shard: the IVF balance point between probe
    cost (C) and rerank cost (V_loc / C per cluster)."""
    return max(1, min(v_loc, int(round(v_loc ** 0.5))))


def default_nprobe(n_clusters: int) -> int:
    """At least two probes (a query near a cell boundary has its
    neighbourhood split over two cells), and C/32 beyond that."""
    return max(2, n_clusters // 32)


def _exp_head_geometry(exp):
    """(this member's [V_loc, D] class block, n_valid) of an experiment's
    retrieval matrix: the paper system's head shard, or the zoo's row
    block of ``lm.head_weight`` (the tied embedding or the untied head).
    Sketch heads, which train no [V, D] class matrix, are refused."""
    if not hasattr(exp, "trainer") and not hasattr(exp, "head_state"):
        raise TypeError(f"not a paper/zoo Experiment: {type(exp).__name__}")
    head = exp.head
    if not head.params_are_class_weights:
        raise NotImplementedError(
            f"the IVF index quantizes the [V, D] class matrix, which the "
            f"{head.name!r} head does not train; use a W-head "
            f"(full/knn/selective/sampled)")
    if hasattr(exp, "trainer"):                            # paper system
        return exp.state.head_params, head.n_valid
    from repro_torch.models import lm                      # zoo system
    from repro_torch.train.gspmd import vocab_rows
    return (vocab_rows(lm.head_weight(exp.params, exp.model_cfg, exp.specs)),
            head.n_valid)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _lloyd(w, limit: int, c: int, iters: int):
    """Spherical k-means over the first ``limit`` rows of the block w
    [V_loc, D]: the reference's strided init and ``iters`` Lloyd steps.
    Returns the unit centroids [C, D] fp32."""
    wn = _normalize(w[:limit].float())
    if limit:
        # the strided init; int64, where the reference's int32 product
        # would overflow past limit * C = 2^31 (ROADMAP.md C.6)
        idx0 = (torch.arange(c, device=w.device, dtype=torch.int64)
                * limit) // c
        cent = _normalize(wn[idx0])
    else:                    # an all-padding shard: the reference's zero rows
        cent = torch.zeros((c, w.shape[1]), device=w.device)
    for _ in range(iters):
        sums = torch.zeros_like(cent)
        cnt = torch.zeros(c, device=w.device)
        for r0 in range(0, limit, _ROW_CHUNK):
            blk = wn[r0:r0 + _ROW_CHUNK]
            assign = (blk @ cent.T).argmax(dim=1)   # ties: the lowest cluster
            oh = torch.zeros((blk.shape[0], c), device=w.device)
            oh.scatter_(1, assign[:, None], 1.0)
            sums += oh.T @ blk
            cnt += oh.sum(dim=0)
        cent = torch.where(cnt[:, None] > 0, _normalize(sums), cent)
    return cent


def _pack_normalize(x):
    return x / torch.linalg.vector_norm(x, dim=1, keepdim=True).clamp_min(
        1e-12)


def _short_lists(scores):
    """Each row's first ``SHORT_LIST`` clusters in (score desc, cluster
    asc) order, and the rows in claim order (best score desc, row asc), as
    host arrays. Sorted ``_ROW_CHUNK`` rows at a time."""
    n, c = scores.shape
    t = min(SHORT_LIST, c)
    pref = torch.empty((n, t), device=scores.device, dtype=torch.int64)
    best = torch.empty(n, device=scores.device)
    for r0 in range(0, n, _ROW_CHUNK):
        # + 0.0 turns -0.0 into +0.0, which a radix sort would order apart
        sv, sp = torch.sort(scores[r0:r0 + _ROW_CHUNK] + 0.0, dim=1,
                            descending=True, stable=True)
        pref[r0:r0 + _ROW_CHUNK] = sp[:, :t]
        best[r0:r0 + _ROW_CHUNK] = sv[:, 0]
    order = torch.sort(best, descending=True, stable=True).indices
    return pref.cpu().numpy(), order.cpu().numpy()


def _claim(pref: np.ndarray, order: np.ndarray, scores, cap: int):
    """The reference's greedy capacity-balanced claim, a block of rows at a
    time (see the module docstring). ``pref`` [n, T] short preference lists,
    ``order`` [n] claim order, ``scores`` [n, C] the full score rows (a
    tensor, read only for rows whose short list is full). Returns (members
    [C, cap] int32, -1 padded, counts [C] int32)."""
    c = scores.shape[1]
    members = np.full((c, cap), -1, np.int32)
    fill = np.zeros(c, np.int64)
    pos, blk = 0, 256
    n = order.shape[0]
    while pos < n:
        rows = order[pos:pos + blk]
        m = rows.shape[0]
        full = fill >= cap
        p = pref[rows]
        open_ = ~full[p]
        choice = p[np.arange(m), open_.argmax(axis=1)]
        deep = np.flatnonzero(~open_.any(axis=1))
        if deep.size:                     # the best open cluster of the row
            s = scores[torch.from_numpy(rows[deep]).to(scores.device)]
            s = s.masked_fill(torch.from_numpy(full).to(scores.device), -np.inf)
            choice[deep] = s.argmax(dim=1).cpu().numpy()
        # each row's rank among the block's rows that chose its cluster
        srt = np.argsort(choice, kind="stable")
        cs = choice[srt]
        rank = np.empty(m, np.int64)
        rank[srt] = np.arange(m) - np.searchsorted(cs, cs, side="left")
        slot = fill[choice] + rank
        over = np.flatnonzero(slot >= cap)
        take = int(over[0]) if over.size else m       # >= 1: row 0 has room
        members[choice[:take], slot[:take]] = rows[:take]
        fill += np.bincount(choice[:take], minlength=c)
        pos += take
        blk = min(_CLAIM_BLOCK, max(256, 2 * take))
    return members, fill.astype(np.int32)


def _pack(w, limit: int, cent, cap: int, times: Optional[dict] = None):
    """The capacity-balanced packing of the first ``limit`` rows of w into
    the clusters of ``cent``: (members [C, cap] int32 on w's device, counts
    [C] int32). ``times`` gets the seconds of the scores with the short
    lists, and of the claim."""
    times = {} if times is None else times
    t0 = time.perf_counter()
    scores = torch.empty((limit, cent.shape[0]), device=w.device)
    for r0 in range(0, limit, _ROW_CHUNK):
        r1 = min(limit, r0 + _ROW_CHUNK)
        scores[r0:r1] = _pack_normalize(w[r0:r1].float()) @ cent.T
    pref, order = _short_lists(scores)
    times["scores_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    members, counts = _claim(pref, order, scores, cap)
    members = torch.from_numpy(members).to(w.device)
    _sync(w.device)
    times["claim_s"] = time.perf_counter() - t0
    return members, counts


@dataclasses.dataclass
class IVFIndex:
    """A fitted coarse quantizer over this ring member's class shard.

    ``centroids`` [C, D] fp32 and ``members`` [C, cap] int32 (local row
    ids, -1 padded) live on the shard's device; ``counts`` [C] stays a host
    array (stats only). ``fit_s`` holds the fit's seconds by part (Lloyd,
    scores and preferences, claim), synchronised on the card."""

    centroids: torch.Tensor
    members: torch.Tensor
    counts: np.ndarray
    n_clusters: int
    cap: int
    nprobe: int
    iters: int
    version: Tuple[int, ...]
    fit_s: dict = dataclasses.field(default_factory=dict, compare=False)

    def resolve_nprobe(self, nprobe: Optional[int] = None) -> int:
        """Effective probe width: the caller's, else the fit-time default,
        clamped to the cluster count."""
        return max(1, min(int(nprobe or self.nprobe), self.n_clusters))

    @classmethod
    def fit(cls, exp, *, n_clusters: int = 0, nprobe: int = 0,
            iters: int = 8) -> "IVFIndex":
        """Fit over the experiment's CURRENT class shard (see the module
        docstring). Deterministic: no RNG, no atomics."""
        w, n_valid = _exp_head_geometry(exp)
        w = w.detach()
        v_loc = w.shape[0]
        c = min(v_loc, n_clusters or default_n_clusters(v_loc))
        cap = max(1, min(v_loc, -(-(5 * v_loc) // (4 * c))))
        limit = _shard_limit(dist.flat_axis_index() * v_loc, v_loc, n_valid)
        times = {}
        with torch.no_grad():
            t0 = time.perf_counter()
            cent = _lloyd(w, limit, c, iters)
            _sync(w.device)
            times["lloyd_s"] = time.perf_counter() - t0
            members, counts = _pack(w, limit, cent, cap, times)
        return cls(centroids=cent, members=members, counts=counts,
                   n_clusters=c, cap=cap,
                   nprobe=min(c, nprobe or default_nprobe(c)), iters=iters,
                   version=tuple(exp.weights_version), fit_s=times)

    def state_to_save(self) -> dict:
        """The index as a tree of tensors (its ints as int32 scalars, the
        version as an int32 vector, as the JAX package saves them), for
        ``repro_torch.checkpoint.save``; ``state_from_restore`` rebuilds it
        bit for bit, so a resumed server skips the refit."""
        def i32(v):
            return torch.tensor(v, dtype=torch.int32)
        return {
            "centroids": self.centroids,
            "members": self.members,
            "counts": torch.from_numpy(self.counts),
            "meta": {"n_clusters": i32(self.n_clusters),
                     "cap": i32(self.cap), "nprobe": i32(self.nprobe),
                     "iters": i32(self.iters),
                     "version": i32(tuple(self.version))},
        }

    @classmethod
    def state_from_restore(cls, tree: dict, *, device=None) -> "IVFIndex":
        """Rebuild an index from ``state_to_save``'s dict, its tensors
        copied onto ``device``: ``None`` means ``"cuda"`` (raising without
        a GPU), as for every entry point; pass ``device="cpu"`` for the
        CPU."""
        from repro_torch.api.experiment import resolve_device

        device = resolve_device(device)
        cent = torch.as_tensor(tree["centroids"], dtype=torch.float32)
        members = torch.as_tensor(tree["members"], dtype=torch.int32)
        meta = tree["meta"]
        return cls(centroids=cent.to(device, copy=True),
                   members=members.to(device, copy=True),
                   counts=np.asarray(tree["counts"], np.int32).copy(),
                   n_clusters=int(meta["n_clusters"]), cap=int(meta["cap"]),
                   nprobe=int(meta["nprobe"]), iters=int(meta["iters"]),
                   version=tuple(int(x) for x in meta["version"]))
