"""The paper's hybrid-parallel trainer and its serve and eval steps (§3.1):
the port of the JAX package's ``train/hybrid.py``.

Every member of the ring (``repro_torch.dist``) is a data-parallel replica
of the feature extractor AND one row block of the class matrix. A step
function here is what one member runs; with a process group of P members
every member calls it with the same arguments (the global batch), exactly
as a JAX shard_map body sees one device's shard of them.

The feature extractor is the ``feats`` trunk (precomputed features, no
params) or the paper's ResNet (``cnn``, ``models/resnet.py``) on
``{"images": [B, H, W, 3]}``. Its gradients cross the ring once a step:
a dense all-reduce, or with ``TrainConfig.dgc.enabled`` the DGC exchange
(``core.sparsify.dgc_exchange``), whose u and v are this member's
``HybridState.dgc``.

A step's micro-batches run in §3.3.1's pipeline by default
(``make_value_and_grad``, ``core.pipeline.pipelined_value_and_grad``):
one micro-batch's gathers are in flight while another's feature extractor
or head runs, bit-equal to running them in turn (``overlap=False``).

``snapshot_tree`` gathers a member's state into the GLOBAL tree a
checkpoint stores, laid out as the JAX package's trainer snapshot, and
``state_from_snapshot`` cuts a member's state back out of such a tree;
``interop`` carries the JAX package's state through the same function.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from repro_torch import dist
from repro_torch.api.heads import (HeadState, SoftmaxHead,
                                   head_state_from_tree, make_head,
                                   params_block)
from repro_torch.configs.base import HeadConfig, ModelConfig, TrainConfig
from repro_torch.core import sparsify as sp
from repro_torch.core.pipeline import (microbatched_value_and_grad,
                                       pipelined_value_and_grad)
from repro_torch.core.sharded_softmax import (_normalize, mask_padded_rows,
                                              serve_topk_batched_local,
                                              serve_topk_ivf_batched_local,
                                              serve_topk_local)
from repro_torch.models import lm
from repro_torch.models import resnet as resnet_lib
from repro_torch.optim import (OptState, make_optimizer, tree_leaves,
                               tree_map)


class HybridState(NamedTuple):
    fe_params: dict        # replicated
    head_params: Any       # this member's block of the head params
    head_aux: Any
    opt_state: Any         # optim.OptState over (fe_params, head_params)
    dgc: Optional[sp.DGCState]   # this member's u, v; None without DGC
    step: int

    @property
    def w_head(self):
        """This member's block of the head params, one tensor for every
        head: the [V/P, D] class-weight rows of the W-heads
        (full/knn/selective/sampled), the [R, B/P, D] bucket block of the
        sketch heads (mach/csoft)."""
        return self.head_params


def init_state(generator: torch.Generator, model_cfg: ModelConfig,
               head_cfg: HeadConfig, train_cfg: TrainConfig, n_dev: int, *,
               rank: int = 0, device, head: Optional[SoftmaxHead] = None
               ) -> HybridState:
    """Fresh state of ring member ``rank`` of ``n_dev``: the FE params
    (none for the ``feats`` trunk; the ResNet's for ``cnn``), this
    member's block of the head, the optimizer's zero moments over both,
    and with DGC its zero u and v over the FE params."""
    _input_structure(model_cfg)          # a trunk the paper system takes
    head = head or make_head(model_cfg, head_cfg)
    fe_params: dict = {}
    if model_cfg.family != "feats":
        # the trunk alone: the fc is this member's head shard, built below
        fe_params = {"trunk": resnet_lib.init_resnet(generator, model_cfg)}
    hs = head.init(generator, n_dev, rank=rank, device=device)
    opt_state = make_optimizer(train_cfg).init((fe_params, hs.params))
    dgc = sp.init_dgc_state(fe_params) if train_cfg.dgc.enabled else None
    return HybridState(fe_params, hs.params, hs.aux, opt_state, dgc, 0)


def _int32(v) -> torch.Tensor:
    return torch.tensor(int(v), dtype=torch.int32)


@torch.no_grad()
def snapshot_tree(state: HybridState, head: SoftmaxHead, *, t: int,
                  seed: int, gather: bool = True) -> dict:
    """The GLOBAL checkpoint tree of this member's state, in the JAX
    package's layout: ``fe`` (replicated), ``head`` (``state_to_save``),
    ``opt`` (an ``OptState`` whose moments mirror (fe, GLOBAL head)),
    ``extra`` (the cursor ``t``, the step and the seed, int32) and, with
    DGC, ``dgc`` {u, v} with every member's row stacked [P, ...]. A
    collective: every member calls it. On a ring of one the leaves are the
    state's own tensors, not copies. ``gather=False`` gives the same tree
    paths over this member's own tensors, with no collective: the template
    a restore reads the leaf names from."""
    if state.opt_state is None:
        raise ValueError("the state carries no optimizer state to save")
    opt = state.opt_state
    hs = HeadState(state.head_params, state.head_aux)
    if gather:
        gather_params = head.gather_params
        head_tree = head.state_to_save(hs)

        def stack(a):
            return dist.all_gather(a, dim=0, tiled=False)
    else:
        gather_params = stack = (lambda a: a)
        head_tree = {"params": hs.params, "aux": tuple(hs.aux)}

    def moments(pair):
        if pair is None:
            return None
        return (pair[0], gather_params(pair[1]))

    tree = {
        "fe": state.fe_params,
        "head": head_tree,
        "opt": OptState(step=_int32(opt.step), mu=moments(opt.mu),
                        nu=moments(opt.nu)),
        "extra": {"t": _int32(t), "step": _int32(state.step),
                  "seed": _int32(seed)},
    }
    if state.dgc is not None:
        tree["dgc"] = {"u": tree_map(stack, state.dgc.u),
                       "v": tree_map(stack, state.dgc.v)}
    return tree


def _fp32_tree(node, device, row: Optional[int] = None):
    """A tree of dicts and lists over host arrays -> the same tree over
    fp32 tensors on ``device`` (``row``: keep that row of each leaf's
    leading axis)."""
    if isinstance(node, dict):
        return {k: _fp32_tree(v, device, row) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_fp32_tree(v, device, row) for v in node)
    a = np.asarray(node)
    # a copy: a restored leaf or the JAX package's host array stays as is
    return torch.tensor(a if row is None else a[row], dtype=torch.float32,
                        device=device)


def state_from_snapshot(tree: dict, *, aux_spec, rank: int, world_size: int,
                        device) -> HybridState:
    """Ring member ``rank``'s ``HybridState`` from a GLOBAL snapshot tree
    of host arrays (``snapshot_tree``'s layout, restored from a checkpoint
    or built by ``interop`` from the JAX package's state): the replicated
    FE params, this member's block of the head (``head_state_from_tree``
    by the head's ``aux_spec``), the moments cut like the params, row
    ``rank`` of DGC's u and v, and the step. ``opt`` (an ``OptState``) and
    ``dgc`` may be absent or None."""
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} is not on a ring of {world_size}")
    hs = head_state_from_tree(tree["head"], aux_spec, rank=rank,
                              world_size=world_size, device=device)

    def moments(pair):
        if pair is None:
            return None
        fe, hp = pair
        return (_fp32_tree(fe, device),
                params_block(hp, rank, world_size, device))

    opt = tree.get("opt")
    if opt is not None:
        opt = OptState(step=int(np.asarray(opt.step)), mu=moments(opt.mu),
                       nu=moments(opt.nu))
    dgc = tree.get("dgc")
    if dgc is not None:
        for name in ("u", "v"):
            for leaf in sp.flatten(dgc[name])[0]:
                if np.shape(leaf)[:1] != (world_size,):
                    raise ValueError(
                        f"dgc {name} leaf of shape {np.shape(leaf)} has no "
                        f"leading ring axis of {world_size}")
        dgc = sp.DGCState(u=_fp32_tree(dgc["u"], device, rank),
                          v=_fp32_tree(dgc["v"], device, rank))
    return HybridState(_fp32_tree(tree["fe"], device), hs.params, hs.aux,
                       opt, dgc, int(np.asarray(tree["extra"]["step"])))


def _features(model_cfg: ModelConfig, fe_params, inputs: dict):
    """Label-free FE forward: flat [t, D] features."""
    if model_cfg.family == "feats":
        return inputs["features"].to(getattr(torch, model_cfg.dtype))
    h, _, _ = lm.backbone(fe_params, model_cfg, inputs)
    return h.reshape(-1, h.shape[-1])


def _local_rows(x):
    """This member's slice of a global batch (the data-parallel split;
    the batch must divide the ring, as on the JAX mesh)."""
    p, r = dist.world_size(), dist.rank()
    if x.shape[0] % p:
        raise ValueError(f"batch {x.shape[0]} does not divide the ring of {p}")
    n = x.shape[0] // p
    return x[r * n:(r + 1) * n]


def _gathered_features(model_cfg, fe_params, inputs):
    f = _features(model_cfg, fe_params,
                  {k: _local_rows(v) for k, v in inputs.items()})
    return dist.all_gather(f, dim=0, tiled=True)


def make_value_and_grad(model_cfg: ModelConfig, head: SoftmaxHead, *,
                        n_micro: int = 1, overlap: bool = True):
    """``fn(state, local_inputs) -> ((loss, metrics), (g_fe, g_hp))``: the
    mean loss, the head's metrics and this member's gradients over its
    rows ``local_inputs`` in ``n_micro`` micro-batches, each all-gathered
    over the ring: with ``overlap`` in §3.3.1's pipelined schedule
    (``core.pipeline.pipelined_value_and_grad``), else one micro-batch
    after another; the two give the same bits."""
    metric_names = list(head.metrics_spec())

    def fn(state: HybridState, local_inputs: dict):
        def fe_fn(fe_p, micro_inputs):
            return _features(model_cfg, fe_p, micro_inputs)

        def head_fn(hp, f_all, y_all):
            return head.loss_local(f_all, y_all, hp, state.head_aux,
                                   global_batch=f_all.shape[0],
                                   step=state.step)

        params = (state.fe_params, state.head_params)
        if overlap:
            return pipelined_value_and_grad(fe_fn, head_fn, params,
                                            local_inputs, n_micro,
                                            metric_names)

        def loss_fn(params, micro_inputs):
            f = fe_fn(params[0], micro_inputs)
            # hybrid parallel: gather every replica's features along the ring
            return head_fn(params[1], dist.all_gather(f, dim=0, tiled=True),
                           dist.all_gather(micro_inputs["labels"], dim=0,
                                           tiled=True))

        return microbatched_value_and_grad(loss_fn, params, local_inputs,
                                           n_micro, metric_names)

    return fn


def make_train_step(model_cfg: ModelConfig, head_cfg: HeadConfig,
                    train_cfg: TrainConfig, *, n_micro: int = 1,
                    head: Optional[SoftmaxHead] = None,
                    overlap: bool = True):
    """Returns ``step(state, inputs, lr) -> (state, loss, metrics)``.

    ``inputs`` is the GLOBAL batch (every member passes the same); each
    member takes its rows, splits them into ``n_micro`` micro-batches and
    all-gathers each over the ring, with ``overlap`` in §3.3.1's pipelined
    schedule (``make_value_and_grad``). ``metrics`` holds the head's
    metrics plus ``comm_dense_bytes`` (FE gradient bytes all-reduced) and
    ``comm_wire_bytes`` (the bytes DGC sends; 0 without DGC)."""
    head = head or make_head(model_cfg, head_cfg)
    opt = make_optimizer(train_cfg)
    dcfg = train_cfg.dgc
    value_and_grad = make_value_and_grad(model_cfg, head, n_micro=n_micro,
                                         overlap=overlap)

    def step(state: HybridState, inputs: dict, lr: float):
        if state.opt_state is None:
            raise ValueError("the state carries no optimizer state (pass "
                             "opt_state= to interop.paper_state_from_numpy)")
        n_dev = dist.world_size()
        local = {k: _local_rows(v) for k, v in inputs.items()}
        (loss, metrics), (g_fe, g_hp) = value_and_grad(state, local)
        zero = torch.zeros((), dtype=torch.float32, device=loss.device)
        dgc = state.dgc
        if dcfg.enabled:
            if dgc is None:
                raise ValueError("DGC is enabled but the state carries no "
                                 "DGC u and v")
            g_fe, dgc, info = sp.dgc_exchange(g_fe, dgc, dcfg,
                                              n_workers=n_dev)
            wire, dense = info["wire_bytes"], info["dense_bytes"]
        else:
            g_fe = sp.dense_exchange(g_fe, n_workers=n_dev)
            wire = zero
            dense = zero + float(sum(g.numel() * 4
                                     for g in tree_leaves(g_fe)))
        # head gradient: LOCAL, never crosses members (paper §3.1 step 6)
        with torch.no_grad():
            opt_state = opt.update_((g_fe, g_hp), state.opt_state,
                                    (state.fe_params, state.head_params), lr)
        metrics = dict(metrics)
        metrics["comm_wire_bytes"] = wire
        metrics["comm_dense_bytes"] = dense
        return (state._replace(opt_state=opt_state, dgc=dgc,
                               step=state.step + 1),
                loss, metrics)

    return step


def _input_structure(model_cfg: ModelConfig) -> tuple:
    """The keys of a training batch for the trunk."""
    if model_cfg.family == "feats":
        return ("features", "labels")
    if model_cfg.family == "cnn":
        return ("images", "labels")
    raise NotImplementedError(
        f"the paper trainer takes the feats and cnn trunks; "
        f"{model_cfg.family!r} is not one (ROADMAP.md queue A)")


def _serve_query_key(model_cfg: ModelConfig) -> str:
    """The input key a serving-tier query fills (no labels at serve
    time): each trunk takes one input, the first of its batch keys."""
    return _input_structure(model_cfg)[0]


def make_eval_step(model_cfg: ModelConfig, head_cfg: HeadConfig, *,
                   head: Optional[SoftmaxHead] = None):
    """(state, inputs) -> distributed top-1 accuracy (float) with the head's
    own deploy-style prediction (nearest class weight, §4.5)."""
    head = head or make_head(model_cfg, head_cfg)

    @torch.inference_mode()
    def step(state: HybridState, inputs: dict) -> float:
        f_all = _gathered_features(model_cfg, state.fe_params, inputs)
        y_all = dist.all_gather(_local_rows(inputs["labels"]), dim=0)
        pred, _ = head.eval_logits_local(f_all, state.head_params,
                                         state.head_aux)
        return float((pred.long() == y_all.long()).float().mean())

    return step


def make_serve_step(model_cfg: ModelConfig, head_cfg: HeadConfig, *,
                    head: Optional[SoftmaxHead] = None):
    """Deploy-style retrieval (§4.5): (state, inputs) -> [b] predicted
    global class ids (int32). Any "labels" key is ignored."""
    head = head or make_head(model_cfg, head_cfg)

    @torch.inference_mode()
    def step(state: HybridState, inputs: dict):
        inputs = {k: v for k, v in inputs.items() if k != "labels"}
        f_all = _gathered_features(model_cfg, state.fe_params, inputs)
        pred, _ = head.eval_logits_local(f_all, state.head_params,
                                         state.head_aux)
        return pred.to(torch.int32)

    return step


def _require_class_weights(head: SoftmaxHead):
    if not head.params_are_class_weights:
        raise NotImplementedError(
            f"top-k serving retrieves against the [V, D] class matrix, "
            f"which the {head.name!r} head does not train; use a W-head "
            f"(full/knn/selective/sampled)")


def _normalized(head_cfg, f, w):
    f, w = f.float(), w.float()
    if head_cfg.cosine_scale > 0:
        f, w = _normalize(f), _normalize(w)
    return f, w


def make_topk_serve_step(model_cfg: ModelConfig, head_cfg: HeadConfig,
                         top_k: int, *, head: Optional[SoftmaxHead] = None):
    """Top-k retrieval with scores: (state, inputs) -> (scores [b, k] desc,
    global class ids [b, k]). Each shard's local top-k (ref: a stable sort;
    kernel: ``ops.topk_rows``) is merged with one all-gather."""
    head = head or make_head(model_cfg, head_cfg)
    _require_class_weights(head)

    @torch.inference_mode()
    def step(state: HybridState, inputs: dict):
        inputs = {k: v for k, v in inputs.items() if k != "labels"}
        f_all = _gathered_features(model_cfg, state.fe_params, inputs)
        f_all, w = _normalized(head_cfg, f_all, state.head_params)
        return serve_topk_local(f_all, w, top_k, n_valid=head.n_valid,
                                backend=head.backend)

    return step


def make_batched_serve_step(model_cfg: ModelConfig, head_cfg: HeadConfig, *,
                            head: Optional[SoftmaxHead] = None):
    """Serving-tier greedy retrieval over a padded micro-batch:
    (state, queries [b_pad, ...], n_queries) -> pred [b_pad] int32, padding
    rows -1. Queries (features [D] or images [H, W, 3]) are the same on
    every member (no ring gather)."""
    head = head or make_head(model_cfg, head_cfg)
    key = _serve_query_key(model_cfg)

    @torch.inference_mode()
    def step(state: HybridState, queries, n_queries: int):
        f = _features(model_cfg, state.fe_params, {key: queries})
        pred, _ = head.eval_logits_local(f, state.head_params, state.head_aux)
        return mask_padded_rows(pred.to(torch.int32), n_queries, -1)

    return step


def make_batched_topk_serve_step(model_cfg: ModelConfig, head_cfg: HeadConfig,
                                 top_k: int, *,
                                 head: Optional[SoftmaxHead] = None):
    """Serving-tier top-k retrieval over a padded micro-batch:
    (state, queries [b_pad, ...], n_queries) -> (vals [b_pad, k] desc,
    gids [b_pad, k]), padding rows (-inf, -1)."""
    head = head or make_head(model_cfg, head_cfg)
    _require_class_weights(head)
    key = _serve_query_key(model_cfg)

    @torch.inference_mode()
    def step(state: HybridState, queries, n_queries: int):
        f = _features(model_cfg, state.fe_params, {key: queries})
        f, w = _normalized(head_cfg, f, state.head_params)
        return serve_topk_batched_local(f, w, top_k, n_queries,
                                        n_valid=head.n_valid,
                                        backend=head.backend)

    return step


def make_batched_ivf_topk_serve_step(model_cfg: ModelConfig,
                                     head_cfg: HeadConfig, top_k: int, *,
                                     nprobe: int,
                                     head: Optional[SoftmaxHead] = None):
    """Sublinear serving-tier top-k through an ``IVFIndex``:
    (state, centroids [C, D], members [C, cap], queries [b_pad, ...],
    n_queries) -> (vals [b_pad, k] desc, gids [b_pad, k]), padding rows
    (-inf, -1). The contract of ``make_batched_topk_serve_step``, but each
    member probes its own ``nprobe`` centroids and reranks only their
    member rows (``serve_topk_ivf_batched_local``; kernel backend: the
    fused ``ops.ivf_rerank``). W-heads only: the index quantizes the
    trained class matrix."""
    head = head or make_head(model_cfg, head_cfg)
    _require_class_weights(head)
    key = _serve_query_key(model_cfg)

    @torch.inference_mode()
    def step(state: HybridState, centroids, members, queries,
             n_queries: int):
        f = _features(model_cfg, state.fe_params, {key: queries})
        f, w = _normalized(head_cfg, f, state.head_params)
        return serve_topk_ivf_batched_local(
            f, w, centroids, members, top_k, nprobe, n_queries,
            backend=head.backend, block_a=head_cfg.pallas_block_a)

    return step
