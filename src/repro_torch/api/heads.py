"""Softmax-head strategies: the port of the JAX package's ``api/heads.py``.

A head owns its parameters and auxiliary state (``HeadState``), its
distributed training loss ``loss_local`` and its prediction body
``eval_logits_local``. Heads register by name
(``register_head``); ``make_head`` builds one from a ``HeadConfig``. The
``full`` and ``knn`` heads are ported so far; the other four are named in
``KNOWN_HEADS`` so that configs naming them parse, and ``make_head``
refuses them until their slice lands (ROADMAP.md queue A).
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch import dist
from repro_torch.configs.base import HeadConfig, ModelConfig, effective_vocab
from repro_torch.core import knn_graph as kg
from repro_torch.core.knn_softmax import knn_softmax_local
from repro_torch.core.sharded_softmax import (_normalize, full_softmax_local,
                                              serve_argmax_local,
                                              serve_logits_local)

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
                   step=None):
        """Distributed CE on this member's shard. ``f_all`` / ``y_all`` are
        the ring-gathered batch; ``step`` is the training step (for heads
        with per-step randomness; may be None). Returns (loss, metrics)."""
        raise NotImplementedError

    def eval_logits_local(self, f_all, params, aux):
        """Deploy-style prediction (§4.5 retrieval). Returns (pred [b]
        global class ids, local scores or None)."""
        raise NotImplementedError

    def metrics_spec(self) -> dict:
        """The metrics ``loss_local`` returns, each a scalar replicated
        over the ring (the JAX package's ``P()`` out-spec)."""
        return {"accuracy": "replicated", "logz": "replicated"}

    @property
    def refresh_every(self) -> int:
        """Steps between ``refresh`` calls (0 = the head has no periodic
        work)."""
        return 0

    def refresh(self, head_state: HeadState) -> HeadState:
        """The head's periodic work (graph / table rebuilds); none for
        heads without aux state."""
        return head_state

    def _init_w(self, generator: torch.Generator, n_dev: int, rank: int,
                device, block_rows: int = 1 << 16):
        """Rows [rank*V/n, (rank+1)*V/n) of a W [V, D] ~ N(0, 1/D). The
        whole matrix is drawn in fixed row blocks from ``generator`` and
        each member keeps its own rows, so W does not depend on the ring
        size and no member ever holds more than its block plus one draw."""
        if self.n_classes % n_dev:
            raise ValueError(f"{self.n_classes} classes do not divide a ring "
                             f"of {n_dev}")
        v_loc = self.n_classes // n_dev
        lo, hi = rank * v_loc, (rank + 1) * v_loc
        out = torch.empty((v_loc, self.d), device=device, dtype=torch.float32)
        for start in range(0, self.n_classes, block_rows):
            stop = min(start + block_rows, self.n_classes)
            blk = torch.randn((stop - start, self.d), generator=generator,
                              device=device)
            a, b = max(start, lo), min(stop, hi)
            if a < b:
                out[a - lo:b - lo] = blk[a - start:b - start]
        return out.div_(math.sqrt(self.d))


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
        raise NotImplementedError(
            f"the {head_cfg.softmax_impl!r} head is not ported to torch yet "
            f"(ported: {sorted(HEAD_REGISTRY)}; see ROADMAP.md queue A)")
    return cls(model_cfg, head_cfg)


@register_head("full")
class FullSoftmaxHead(SoftmaxHead):
    """W [V, D] row-sharded; exact distributed softmax (§3.1)."""

    def init(self, generator, n_dev, *, rank, device) -> HeadState:
        return HeadState(params=self._init_w(generator, n_dev, rank, device),
                         aux=())

    def loss_local(self, f_all, y_all, params, aux, *, global_batch: int,
                   step=None):
        return full_softmax_local(
            f_all, y_all, params, global_batch=global_batch,
            cosine_scale=self.head_cfg.cosine_scale, n_valid=self.n_valid,
            backend=self.backend)

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
                         aux=self.init_aux(n_dev, rank=rank, device=device))

    def init_aux(self, n_dev: int, *, rank: int, device):
        """The warm-start graph before the first refresh: self-only
        neighbour lists (lossless by construction: every label selects
        itself); needs no weights."""
        self_graph = np.arange(self.n_classes, dtype=np.int32)[:, None]
        return self._member_row(kg.compress_graph(self_graph, n_dev), rank,
                                device)

    @staticmethod
    def _member_row(cg, rank: int, device):
        return tuple(torch.as_tensor(np.ascontiguousarray(a[rank]),
                                     device=device)
                     for a in (cg.offsets, cg.neighbors, cg.ranks))

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
        return HeadState(params=w, aux=self._member_row(cg, dist.rank(),
                                                        w.device))

    def loss_local(self, f_all, y_all, params, aux, *, global_batch: int,
                   step=None):
        offsets, neighbors, ranks = aux
        v_loc = params.shape[0]
        m_local = max(8, int(v_loc * self.head_cfg.active_frac))
        return knn_softmax_local(
            f_all, y_all, params, offsets, neighbors, ranks,
            global_batch=global_batch, m_local=m_local,
            k_cap=self.head_cfg.knn_k,
            cosine_scale=self.head_cfg.cosine_scale,
            pad_random=self.head_cfg.knn_pad_random, n_valid=self.n_valid,
            backend=self.backend)

    def metrics_spec(self) -> dict:
        return {"accuracy": "replicated", "logz": "replicated",
                "active_frac": "replicated", "label_recall": "replicated"}
