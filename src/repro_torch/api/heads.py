"""Softmax-head strategies: the port of the JAX package's ``api/heads.py``.

A head owns its parameters and auxiliary state (``HeadState``), its
distributed training loss ``loss_local`` and its prediction body
``eval_logits_local``. Heads register by name (``register_head``);
``make_head`` builds one from a ``HeadConfig``. All six heads of the
paper's comparison are registered: ``full``, ``knn``, ``selective``,
``sampled`` (W-heads: their params are the [V, D] class matrix, each ring
member holding a row block) and ``mach``, ``csoft`` (sketch heads: [R, B,
D] bucket weights, each member holding a block of the bucket axis).

The checkpoint contract is the JAX package's: ``state_to_save`` gathers
the GLOBAL head state over the ring (the params' rows or buckets, a
sharded aux entry stacked [P, ...], a replicated one once),
``state_from_restore`` cuts this member's block back out of it, and
``reshard_state`` / ``reshard_params_like`` rewrite a stored head for a
ring of another size (``repro_torch.elastic``): exactly for the knn graph
and the LSH tables, by re-bucketing for the sketch heads when their
bucket count no longer divides the ring.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch import dist
from repro_torch.configs.base import HeadConfig, ModelConfig, effective_vocab
from repro_torch.core import baselines as bl
from repro_torch.core import knn_graph as kg
from repro_torch.core.knn_softmax import knn_softmax_local
from repro_torch.core.sharded_softmax import (_normalize, full_softmax_local,
                                              serve_argmax_local,
                                              serve_logits_local)
from repro_torch.elastic.reshard import row_block
from repro_torch.optim import tree_leaves

KNOWN_HEADS = ("full", "knn", "selective", "mach", "sampled", "csoft")


class HeadState(NamedTuple):
    """``params`` are trained by the outer optimizer; ``aux`` is head-owned
    non-trainable state (graphs, hash tables, ...)."""
    params: Any
    aux: Any


class SoftmaxHead:
    """Base strategy. Subclasses are stateless objects bound to configs;
    all tensor state lives in the ``HeadState`` they create."""

    name = "?"
    # True when the trainable params ARE the [V, D] class-weight matrix
    params_are_class_weights = True

    def __init__(self, model_cfg: ModelConfig, head_cfg: HeadConfig):
        self.model_cfg = model_cfg
        self.head_cfg = head_cfg
        self.n_classes = model_cfg.vocab_size
        self.d = model_cfg.d_model
        # padded-vocab masking: labels < n_valid always
        self.n_valid = (effective_vocab(model_cfg)
                        if model_cfg.real_vocab_size else 0)
        self.backend = head_cfg.backend

    def init(self, generator: torch.Generator, n_dev: int, *, rank: int,
             device) -> HeadState:
        """This ring member's state: its row block of the params."""
        raise NotImplementedError

    def loss_local(self, f_all, y_all, params, aux, *, global_batch: int,
                   step=None, batch_axes=()):
        """Distributed CE on this member's shard. ``f_all`` / ``y_all`` are
        the ring-gathered batch, or this data shard's rows of it when
        ``batch_axes`` name the axes the rows are split over (the loss and
        the metrics are then completed over them, as the JAX registry's
        ``batch_axes``); ``step`` is the training step (for heads with
        per-step randomness; may be None). Returns (loss, metrics)."""
        raise NotImplementedError

    def eval_logits_local(self, f_all, params, aux):
        """Deploy-style prediction (§4.5 retrieval). Returns (pred [b]
        global class ids, local scores or None)."""
        raise NotImplementedError

    def metrics_spec(self) -> dict:
        """The metrics ``loss_local`` returns, each a scalar replicated
        over the ring (the JAX package's ``P()`` out-spec)."""
        return {"accuracy": "replicated", "logz": "replicated"}

    def aux_spec(self) -> tuple:
        """How each entry of ``aux`` lies on the ring (the JAX package's
        ``aux_spec``): ``"sharded"`` (each member holds its row of a [P,
        ...] array) or ``"replicated"``."""
        return ()

    @property
    def refresh_every(self) -> int:
        """Steps between ``refresh`` calls (0 = the head has no periodic
        work)."""
        return 0

    def refresh(self, head_state: HeadState) -> HeadState:
        """The head's periodic work (graph / table rebuilds); none for
        heads without aux state."""
        return head_state

    # -- checkpoint contract ----------------------------------------------
    def gather_params(self, block: torch.Tensor) -> torch.Tensor:
        """The GLOBAL params (or a moment shaped like them) from this
        member's block: the rows of a W-head, the buckets of a sketch.
        A head that holds no params of its own (the zoo's W-heads train
        the model's class matrix: ``()``) gives them back as they are."""
        if not torch.is_tensor(block):
            return block
        axis = 0 if self.params_are_class_weights else 1
        return dist.all_gather(block.detach(), dim=axis, tiled=True)

    def state_to_save(self, state: HeadState) -> dict:
        """The head's part of a checkpoint, GLOBAL, as the JAX package
        lays it out: ``{"params", "aux"}``, a sharded aux entry gathered
        into [P, ...], a replicated one saved once. The aux is saved, not
        rebuilt, so a restore resumes mid-refresh-interval with the tables
        the killed run used. A collective: every member calls it."""
        aux = tuple(a if spec == "replicated"
                    else dist.all_gather(a.detach(), dim=0, tiled=False)
                    for a, spec in zip(state.aux, self.aux_spec()))
        return {"params": self.gather_params(state.params), "aux": aux}

    def state_from_restore(self, tree, *, rank: int, world_size: int,
                           device) -> HeadState:
        """This member's ``HeadState`` from a restored ``state_to_save``
        tree (host arrays). The aux shapes may differ from a fresh
        ``init``'s (a refreshed knn graph is denser than the warm start)."""
        return head_state_from_tree(tree, self.aux_spec(), rank=rank,
                                    world_size=world_size, device=device)

    def init_aux(self, n_dev: int) -> tuple:
        """A shape-correct GLOBAL aux for a ring of ``n_dev`` that needs no
        weights (host arrays): what the default reshard leg installs before
        the head's own refresh rebuilds it."""
        return ()

    # -- elastic resharding (repro_torch.elastic) -------------------------
    def reshard_state(self, tree, src, dst):
        """Map a host-side ``state_to_save`` tree written on the ``src``
        ring onto ``dst`` (both ``elastic.MeshGeometry``). Global [V, D]
        params pass through; heads whose aux bakes in the ring size
        override with an exact re-pack. Returns ``(tree, needs_refresh)``:
        the default re-initializes aux for the dst ring and asks the
        trainer to run ``refresh`` after placement."""
        if src.n_model == dst.n_model or not tree_leaves(tree["aux"]):
            return tree, False
        return dict(tree, aux=self.init_aux(dst.n_model)), True

    def reshard_params_like(self, arr, src, dst):
        """Reshard one optimizer-moment leaf shaped like ``params``: the
        identity for global [V, D] rows; the sketch heads apply their
        bucket transfer, so the moments track the params."""
        return arr

    def _init_w(self, generator: torch.Generator, n_dev: int, rank: int,
                device):
        """Rows [rank*V/n, (rank+1)*V/n) of a W [V, D] ~ N(0, 1/D)
        (``_draw_block``), so W does not depend on the ring size."""
        if self.n_classes % n_dev:
            raise ValueError(f"{self.n_classes} classes do not divide a ring "
                             f"of {n_dev}")
        v_loc = self.n_classes // n_dev
        return _draw_block(generator, self.n_classes, self.d, rank * v_loc,
                           (rank + 1) * v_loc, device).div_(math.sqrt(self.d))


def _draw_block(generator: torch.Generator, n_rows: int, d: int, lo: int,
                hi: int, device, block_rows: int = 1 << 16):
    """Rows [lo, hi) of an [n_rows, d] N(0, 1) matrix: the whole matrix is
    drawn in fixed row blocks from ``generator`` and only those rows are
    kept, so no ring member ever holds more than its block plus one draw."""
    out = torch.empty((hi - lo, d), device=device, dtype=torch.float32)
    for start in range(0, n_rows, block_rows):
        stop = min(start + block_rows, n_rows)
        blk = torch.randn((stop - start, d), generator=generator,
                          device=device)
        a, b = max(start, lo), min(stop, hi)
        if a < b:
            out[a - lo:b - lo] = blk[a - start:b - start]
    return out


def _head_axis(a: np.ndarray) -> int:
    """The axis the ring splits: a [V, D] class matrix by rows, an [R, B,
    D] sketch (mach, csoft) by buckets."""
    if a.ndim == 2:
        return 0
    if a.ndim == 3:
        return 1
    raise ValueError(f"head_params must be the [V, D] class matrix or an "
                     f"[R, B, D] sketch, got shape {a.shape}")


def params_block(a, rank: int, world_size: int, device) -> torch.Tensor:
    """Ring member ``rank``'s fp32 block of GLOBAL head params (or of a
    moment shaped like them), a copy on ``device``."""
    a = np.asarray(a)
    return torch.tensor(row_block(a, rank, world_size, _head_axis(a)),
                        dtype=torch.float32, device=device)


def head_state_from_tree(tree, aux_spec, *, rank: int, world_size: int,
                         device) -> HeadState:
    """Ring member ``rank``'s ``HeadState`` from the GLOBAL head tree
    ``{"params", "aux"}`` as host arrays (a restored checkpoint, or the
    JAX package's state carried by ``interop``): its block of the params,
    and of each aux entry by ``aux_spec``: ``"sharded"`` keeps row
    ``rank`` of a leading [world_size] axis, ``"replicated"`` keeps the
    whole (every entry a copy)."""
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} is not on a ring of {world_size}")
    aux = member_aux(tree["aux"], aux_spec, rank=rank,
                     world_size=world_size, device=device)
    return HeadState(params_block(tree["params"], rank, world_size, device),
                     aux)


def member_aux(head_aux, aux_spec, *, rank: int, world_size: int,
               device) -> tuple:
    """Ring member ``rank``'s aux entries from the GLOBAL aux (host
    arrays), by ``aux_spec``: ``"sharded"`` keeps row ``rank`` of a
    leading [world_size] axis, ``"replicated"`` keeps the whole."""
    head_aux = tuple(head_aux)
    aux_spec = tuple(aux_spec)
    if len(aux_spec) != len(head_aux):
        raise ValueError(f"aux_spec {aux_spec} does not name the "
                         f"{len(head_aux)} head_aux entries")
    aux = []
    for a, spec in zip(head_aux, aux_spec):
        a = np.asarray(a)
        if spec == "replicated":
            aux.append(torch.tensor(a, device=device))
            continue
        if spec != "sharded":
            raise ValueError(f"aux spec {spec!r} is not 'sharded' or "
                             f"'replicated'")
        if a.shape[0] != world_size:
            raise ValueError(f"head_aux leading axis {a.shape[0]} is not the "
                             f"ring of {world_size}")
        aux.append(torch.tensor(a[rank], device=device))
    return tuple(aux)


HEAD_REGISTRY: dict = {}


def register_head(name: str):
    def deco(cls):
        cls.name = name
        HEAD_REGISTRY[name] = cls
        return cls
    return deco


def make_head(model_cfg: ModelConfig, head_cfg: HeadConfig) -> SoftmaxHead:
    cls = HEAD_REGISTRY.get(head_cfg.softmax_impl)
    if cls is None:
        raise ValueError(f"unknown softmax_impl {head_cfg.softmax_impl!r}; "
                         f"known heads: {sorted(HEAD_REGISTRY)}")
    return cls(model_cfg, head_cfg)


@register_head("full")
class FullSoftmaxHead(SoftmaxHead):
    """W [V, D] row-sharded; exact distributed softmax (§3.1)."""

    def init(self, generator, n_dev, *, rank, device) -> HeadState:
        return HeadState(params=self._init_w(generator, n_dev, rank, device),
                         aux=())

    def loss_local(self, f_all, y_all, params, aux, *, global_batch: int,
                   step=None, batch_axes=()):
        return full_softmax_local(
            f_all, y_all, params, global_batch=global_batch,
            cosine_scale=self.head_cfg.cosine_scale, n_valid=self.n_valid,
            backend=self.backend, batch_axes=batch_axes)

    def eval_logits_local(self, f_all, params, aux):
        f = f_all.float()
        w = params.float()
        if self.head_cfg.cosine_scale > 0:
            # §4.5 retrieval equivalence holds for the normalized objective
            f, w = _normalize(f), _normalize(w)
        if self.backend == "kernel":
            # streaming (max, argmax) stats — no [b, V_loc] scores on the card
            return serve_argmax_local(f, w, n_valid=self.n_valid)
        return serve_logits_local(f, w, n_valid=self.n_valid)


# ---------------------------------------------------------------------------
# KNN softmax (the paper's contribution, §3.2)
# ---------------------------------------------------------------------------


@register_head("knn")
class KNNSoftmaxHead(FullSoftmaxHead):
    """Active classes from the compressed KNN graph of W; ``refresh``
    rebuilds the exact graph on the ring (§3.2.2). ``aux`` is this
    member's row of the ``CompressedGraph``: (offsets [N+1], neighbors
    [nnz_cap], ranks [nnz_cap]) int32 tensors. Prediction is the full
    head's (inherited), as in the JAX package."""

    def init(self, generator, n_dev, *, rank, device) -> HeadState:
        return HeadState(params=self._init_w(generator, n_dev, rank, device),
                         aux=self._member_row(self.init_aux(n_dev), rank,
                                              device))

    def init_aux(self, n_dev: int) -> tuple:
        """The warm-start graph before the first refresh: self-only
        neighbour lists (lossless by construction: every label selects
        itself); needs no weights."""
        self_graph = np.arange(self.n_classes, dtype=np.int32)[:, None]
        cg = kg.compress_graph(self_graph, n_dev)
        return (cg.offsets, cg.neighbors, cg.ranks)

    @staticmethod
    def _member_row(aux, rank: int, device):
        return tuple(torch.as_tensor(np.ascontiguousarray(a[rank]),
                                     device=device) for a in aux)

    @property
    def refresh_every(self) -> int:
        return self.head_cfg.rebuild_every

    def refresh(self, head_state: HeadState) -> HeadState:
        """Paper §3.2.2: rebuild the exact KNN graph of the CURRENT class
        weights on the ring, compress it on the host (every member packs
        the whole graph, as the JAX package's host step does) and keep
        this member's row."""
        w = head_state.params
        graph = kg.build_graph(w, k=self.head_cfg.knn_k,
                               kprime=self.head_cfg.knn_kprime)
        cg = kg.compress_graph(graph, dist.world_size())
        return HeadState(params=w, aux=self._member_row(
            (cg.offsets, cg.neighbors, cg.ranks), dist.rank(), w.device))

    def loss_local(self, f_all, y_all, params, aux, *, global_batch: int,
                   step=None, batch_axes=()):
        offsets, neighbors, ranks = aux
        v_loc = params.shape[0]
        m_local = max(8, int(v_loc * self.head_cfg.active_frac))
        return knn_softmax_local(
            f_all, y_all, params, offsets, neighbors, ranks,
            global_batch=global_batch, m_local=m_local,
            k_cap=self.head_cfg.knn_k,
            cosine_scale=self.head_cfg.cosine_scale,
            pad_random=self.head_cfg.knn_pad_random, n_valid=self.n_valid,
            backend=self.backend, batch_axes=batch_axes)

    def aux_spec(self) -> tuple:
        return ("sharded",) * 3

    def metrics_spec(self) -> dict:
        return {"accuracy": "replicated", "logz": "replicated",
                "active_frac": "replicated", "label_recall": "replicated"}

    def reshard_state(self, tree, src, dst):
        """The exact CSR re-pack: the graph, mid-refresh staleness
        included, is preserved bit for bit, and n->m->n is the identity."""
        if src.n_model == dst.n_model:
            return tree, False
        from repro_torch.elastic.reshard import repack_knn_aux
        return dict(tree, aux=repack_knn_aux(tree["aux"],
                                             dst.n_model)), False


# ---------------------------------------------------------------------------
# selective softmax [Zhang et al., AAAI'18]: LSH active classes
# ---------------------------------------------------------------------------

_LSH_REFRESH_SEED = 41      # the JAX package's refresh key, PRNGKey(41)


@register_head("selective")
class SelectiveSoftmaxHead(FullSoftmaxHead):
    """W [V, D] row-sharded plus this member's LSH tables: ``aux`` is
    (planes [R, D, n_bits], replicated; offsets [R, n_buckets+1] and
    classes [R, V_loc], this member's CSR over its own rows). ``refresh``
    rebuilds the tables from the current weights. Prediction is the full
    head's (inherited)."""

    def _tables(self, planes, w_loc):
        offsets, classes = bl.build_sharded_lsh_tables(w_loc, planes)
        return planes, offsets, classes

    def _planes(self, generator, device):
        return bl.lsh_planes(generator, self.head_cfg.selective_n_hash,
                             self.d, self.head_cfg.selective_n_bits,
                             device=device)

    def init(self, generator, n_dev, *, rank, device) -> HeadState:
        w = self._init_w(generator, n_dev, rank, device)
        return HeadState(params=w, aux=self._tables(
            self._planes(generator, device), w))

    def aux_spec(self) -> tuple:
        return ("replicated", "sharded", "sharded")

    @property
    def refresh_every(self) -> int:
        return self.head_cfg.rebuild_every

    def refresh(self, head_state: HeadState) -> HeadState:
        """Rebuild the tables on the current weights through hyperplanes
        drawn from a generator seeded 41 on the weights' device (the same
        on every member): each member hashes its own rows, so nothing
        crosses the ring."""
        w = head_state.params
        g = torch.Generator(device=w.device)
        g.manual_seed(_LSH_REFRESH_SEED)
        return HeadState(params=w, aux=self._tables(
            self._planes(g, w.device), w.detach()))

    def loss_local(self, f_all, y_all, params, aux, *, global_batch: int,
                   step=None, batch_axes=()):
        planes, offsets, classes = aux
        v_loc = params.shape[0]
        m_local = max(8, int(v_loc * self.head_cfg.active_frac))
        return bl.selective_softmax_local(
            f_all, y_all, params, planes, offsets, classes,
            global_batch=global_batch, m_local=m_local,
            cap=self.head_cfg.selective_cap,
            cosine_scale=self.head_cfg.cosine_scale, backend=self.backend,
            batch_axes=batch_axes)

    def metrics_spec(self) -> dict:
        return {"accuracy": "replicated", "logz": "replicated",
                "active_frac": "replicated", "label_recall": "replicated"}

    def init_aux(self, n_dev: int) -> tuple:
        """Shape-correct tables without a [V, D] weight draw: every class
        in bucket 0, through planes from a generator seeded 0; the refresh
        rebuilds them from the class weights before any step uses them."""
        planes = self._planes(torch.Generator().manual_seed(0), "cpu")
        offsets, classes = bl.build_sharded_lsh_tables(
            torch.zeros((self.n_classes // n_dev, self.d)), planes)
        return (planes.numpy(),
                np.stack([offsets.numpy()] * n_dev),
                np.stack([classes.numpy()] * n_dev))

    def reshard_state(self, tree, src, dst):
        """The exact table re-pack: a bucket is a function of the
        replicated planes and the global rows, so the per-shard CSRs
        invert to a class->bucket map and re-sort per dst shard with the
        stable sort of ``build_sharded_lsh_tables``."""
        if src.n_model == dst.n_model:
            return tree, False
        from repro_torch.elastic.reshard import repack_lsh_aux
        return dict(tree, aux=repack_lsh_aux(tree["aux"],
                                             dst.n_model)), False


# ---------------------------------------------------------------------------
# MACH [Medini et al., NeurIPS'19]: R hashed B-way softmaxes
# ---------------------------------------------------------------------------


@register_head("mach")
class MACHSoftmaxHead(SoftmaxHead):
    """R bucket heads [R, B, D] with the BUCKET axis split over the ring
    (each member holds [R, B/P, D]); ``aux`` is the static class->bucket
    hash tables [R, N], replicated."""

    params_are_class_weights = False
    _hash_seed = 0          # universal-hash family seed (csoft uses 1)

    def _buckets_and_reps(self):
        return self.head_cfg.mach_b, self.head_cfg.mach_r

    def _n_buckets(self, n_dev: int) -> int:
        # the bucket axis must divide the ring
        b = self._buckets_and_reps()[0]
        return -(-b // n_dev) * n_dev

    def init(self, generator, n_dev, *, rank, device) -> HeadState:
        """This member's bucket block of W [R, B, D] ~ N(0, 1/D), each
        repetition drawn whole in fixed blocks (``_draw_block``), and the
        hash tables."""
        n_buckets = self._n_buckets(n_dev)
        n_rep = self._buckets_and_reps()[1]
        b_loc = n_buckets // n_dev
        w = torch.stack([_draw_block(generator, n_buckets, self.d,
                                     rank * b_loc, (rank + 1) * b_loc,
                                     device) for _ in range(n_rep)])
        hashes = bl.mach_hashes(self.n_classes, n_buckets, n_rep=n_rep,
                                seed=self._hash_seed)
        return HeadState(params=w.div_(math.sqrt(self.d)),
                         aux=(torch.as_tensor(hashes, device=device),))

    def aux_spec(self) -> tuple:
        return ("replicated",)

    def init_aux(self, n_dev: int) -> tuple:
        n_rep = self._buckets_and_reps()[1]
        return (bl.mach_hashes(self.n_classes, self._n_buckets(n_dev),
                               n_rep=n_rep, seed=self._hash_seed),)

    def reshard_state(self, tree, src, dst):
        """Keep the stored buckets AND hash tables verbatim while the
        stored bucket count divides the dst ring (bitwise decode
        equivalence); otherwise re-hash the classes with the SAME universal
        family at the new modulus and give each new bucket the mean of its
        classes' old bucket weights (the lossy case)."""
        w = np.asarray(tree["params"])
        if w.shape[1] % dst.n_model == 0:
            return tree, False
        from repro_torch.elastic.reshard import rebucket_sketch
        b_dst = self._n_buckets(dst.n_model)
        h_new = bl.mach_hashes(self.n_classes, b_dst, n_rep=w.shape[0],
                               seed=self._hash_seed)
        return dict(tree, params=rebucket_sketch(w, tree["aux"][0], h_new,
                                                 b_dst),
                    aux=(h_new,)), False

    def reshard_params_like(self, arr, src, dst):
        a = np.asarray(arr)
        if a.ndim != 3 or a.shape[1] % dst.n_model == 0:
            return arr
        from repro_torch.elastic.reshard import rebucket_sketch
        b_dst = self._n_buckets(dst.n_model)
        # both tables recompute from the family's seed, so the moments get
        # the transfer the params got
        h_old = bl.mach_hashes(self.n_classes, a.shape[1], n_rep=a.shape[0],
                               seed=self._hash_seed)
        h_new = bl.mach_hashes(self.n_classes, b_dst, n_rep=a.shape[0],
                               seed=self._hash_seed)
        return rebucket_sketch(a, h_old, h_new, b_dst)

    def loss_local(self, f_all, y_all, params, aux, *, global_batch: int,
                   step=None, batch_axes=()):
        (hashes,) = aux
        return bl.mach_softmax_local(f_all, y_all, params, hashes,
                                     global_batch=global_batch,
                                     backend=self.backend,
                                     batch_axes=batch_axes)

    def eval_logits_local(self, f_all, params, aux):
        (hashes,) = aux
        return bl.mach_predict_local(f_all, params, hashes), None


# ---------------------------------------------------------------------------
# sampled softmax [Jean et al., ACL'15]: logQ-corrected negative sampling
# ---------------------------------------------------------------------------


@register_head("sampled")
class SampledSoftmaxHead(FullSoftmaxHead):
    """W [V, D] row-sharded; CE over the true label plus a drawn negative
    set with the logQ correction (``sampled_dist``: ``"uniform"`` without
    replacement, the full softmax at ``sampled_n >= V``; ``"log_uniform"``
    Zipfian with replacement). Negatives are drawn anew every micro-batch
    from (``sampled_seed``, the training step, the batch's labels); there
    is no aux state. The training ``accuracy`` is relative to the
    candidate set; prediction is the full head's (inherited)."""

    def draw(self, y_all, v_loc: int, step=None) -> bl.SampledDraw:
        """This member's draw for the batch's labels ``y_all``."""
        return bl.sampled_draw(
            y_all, v_loc=v_loc, n_samples=self.head_cfg.sampled_n,
            distribution=self.head_cfg.sampled_dist,
            seed=self.head_cfg.sampled_seed, n_valid=self.n_valid, step=step)

    def loss_local(self, f_all, y_all, params, aux, *, global_batch: int,
                   step=None, batch_axes=()):
        return bl.sampled_softmax_loss(
            f_all, y_all, params, self.draw(y_all, params.shape[0], step),
            global_batch=global_batch,
            cosine_scale=self.head_cfg.cosine_scale, backend=self.backend,
            batch_axes=batch_axes)

    def metrics_spec(self) -> dict:
        return {"accuracy": "replicated", "logz": "replicated",
                "sample_frac": "replicated"}


# ---------------------------------------------------------------------------
# CSoft: a count-min sketch over class ids (MACH's training, min decode)
# ---------------------------------------------------------------------------


@register_head("csoft")
class CSoftSketchHead(MACHSoftmaxHead):
    """R pairwise-independent hash rows of B buckets, [R, B, D] with the
    bucket axis split over the ring. Training is MACH's loss (inherited);
    the heads differ in their hash family's seed and in decoding: the min
    of the rows' log-probabilities, the count-min bound, or with
    ``csoft_agg="mean"`` their mean."""

    _hash_seed = 1

    def _buckets_and_reps(self):
        return self.head_cfg.csoft_b, self.head_cfg.csoft_r

    def eval_logits_local(self, f_all, params, aux):
        (hashes,) = aux
        return bl.csoft_predict_local(f_all, params, hashes,
                                      agg=self.head_cfg.csoft_agg), None
