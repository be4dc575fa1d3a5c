"""Train, eval and serve steps of the architecture zoo: the port of the JAX
package's ``train/gspmd.py``.

The JAX package runs the zoo's trunk tensor-parallel over a (data, model)
mesh and the head as a shard_map over the vocab whose body is any
registered ``SoftmaxHead``. The port runs it two ways. On the ring
(``repro_torch.dist`` without a grid: the model axis) every member holds
the whole trunk and runs the whole batch, and the head's class matrix,
the tied embedding table or the untied head, is row-sharded: each member
scores its row block (``vocab_rows``). On a grid (``dist.grid``) each
member holds its slices of every param as the JAX ``param_pspecs``
places them (ported here line for line: ``pspec_of``, ``fit_spec``,
``param_pspecs``; ``member_specs`` in the layout a member holds), the
trunk's layers read their slices (``models.layers``, ``models.moe``) and
gather what FSDP split (``models.decoder.gather_layer``), and the head
takes its data shard's rows with ``batch_axes`` (``vocab_axes``), as the
JAX ``shard_map`` over ``P(batch_axes)`` does; the gradients of leaves
replicated over the batch axes are then summed over them
(``sync_grads``). The sketch heads (mach, csoft) train head-owned [R,
B/P, D] bucket blocks. The loss body is the head's ``loss_local``, whose
``backend`` routes its kernels as in the paper trainer; no head branches
here. Every member calls a step with the same arguments.

The gradients are the JAX package's, which are those of the mean loss
over the batch's tokens whatever the ring or grid (measured at n_model 1,
2 and 4, and on (2, 2)): the features enter the head through
``dist.pvary`` (their gradient summed over the model axis), the
replicated loss leaves it through ``dist.grad_mean`` over every axis
(each member's copy carries its share of the cotangent, which the head's
``psum`` backwards sum back), and on the ring the tied table's row block
is cut by ``dist.shard_rows``, whose backward all-gathers the blocks'
gradients, so every member holds the same full-table gradient and, after
the update, the same params.

The trunk's attention trains on the ``ref`` branches (``ops.flash_attention``
has no backward, as the Pallas kernel has none); evaluation and serving
take ``head_cfg.backend``'s, the flash kernel on ``kernel``. The greedy
token's head is the dense ``serve_logits_local`` on both backends, as in
the JAX package.

The step builders take the JAX package's ``par: ParallelConfig``, of
which they read ``remat`` (``"full"``: each trunk layer checkpointed,
``models.decoder``) and the batch axes; the default is this process's
ring or grid, with no remat.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch import dist
from repro_torch.api.heads import HeadState, SoftmaxHead, make_head
from repro_torch.configs.base import (HeadConfig, InputShape, ModelConfig,
                                      ParallelConfig, TrainConfig,
                                      effective_vocab, ring_parallel_config)
from repro_torch.core.pipeline import microbatched_value_and_grad
from repro_torch.core.sharded_softmax import (_normalize, batch_mean,
                                              mask_padded_rows,
                                              serve_logits_local,
                                              serve_topk_batched_local,
                                              serve_topk_ivf_batched_local)
from repro_torch.models import lm
from repro_torch.optim import make_optimizer, tree_leaves, tree_map

def vocab_rows(w):
    """This member's row block of the class matrix W [V, D]: on a grid,
    where the table is split over ``model`` (``param_pspecs``), the block
    it holds; on the ring, where it is replicated, a view, or under grad a
    copy whose backward gives every member the whole table's gradient
    (``dist.shard_rows``)."""
    n = dist.world_size()
    if dist.grid_declared():
        return w
    if w.shape[0] % n:
        raise ValueError(f"the vocab of {w.shape[0]} rows does not divide "
                         f"the ring of {n}: pad it (configs.pad_vocab)")
    return dist.shard_rows(w)


# ---------------------------------------------------------------------------
# logical axes -> specs (a spec: a tuple of mesh-axis entries, one a dim)
# ---------------------------------------------------------------------------


def pspec_of(axes: Optional[tuple], par: ParallelConfig) -> tuple:
    if axes is None:
        return ()
    return tuple(par.mesh_axis_for(a) if a is not None else None
                 for a in axes)


def _mesh_sizes(par: ParallelConfig) -> dict:
    return dict(zip(par.axis_names, par.mesh_shape))


def _entry_size(entry, sizes) -> int:
    if entry is None:
        return 1
    if isinstance(entry, tuple):
        n = 1
        for a in entry:
            n *= sizes.get(a, 1)
        return n
    return sizes.get(entry, 1)


def fit_spec(spec: tuple, shape, par: ParallelConfig) -> tuple:
    """Drop mesh axes on dims they don't divide (MQA kv=1, batch=1, 3 heads
    on a 4-way axis, ...): the dim falls back to replicated. Also drops a
    mesh axis that already appeared on an earlier dim (FSDP rules can
    collide with TP rules on some tensors)."""
    sizes = _mesh_sizes(par)
    used: set = set()
    out = []
    for i, entry in enumerate(tuple(spec)
                              + (None,) * (len(shape) - len(spec))):
        names = (entry,) if isinstance(entry, str) else (entry or ())
        if any(a in used for a in names):
            out.append(None)
            continue
        n = _entry_size(entry, sizes)
        keep = entry if (n == 1 or shape[i] % n == 0) else None
        if keep is not None:
            used.update((keep,) if isinstance(keep, str) else keep)
        out.append(keep)
    return tuple(out)


def _pspec_of_param(axes: Optional[tuple], par: ParallelConfig) -> tuple:
    if axes is None:
        return ()
    return tuple(par.mesh_axis_for_param(a) if a is not None else None
                 for a in axes)


def param_pspecs(model_cfg: ModelConfig, par: ParallelConfig) -> dict:
    """Every param's spec by ``par.param_rules`` (FSDP-aware), in the JAX
    package's layout (``lm.params_tree``: the layer lists stacked on a
    leading [L]), from ``lm.abstract_model``'s shapes: the JAX
    ``param_pspecs``, leaf for leaf."""
    shapes = lm.params_tree(lm.abstract_model(model_cfg))

    def walk(ax, shape_tree):
        if ax is None or isinstance(ax, tuple):
            return tree_map(lambda leaf: fit_spec(
                _pspec_of_param(ax, par), leaf.shape, par), shape_tree)
        return {k: walk(ax.get(k), shape_tree[k]) for k in shape_tree}

    return walk(lm.model_axes(model_cfg), shapes)


def member_specs(model_cfg: ModelConfig, par: ParallelConfig) -> dict:
    """``param_pspecs`` in the layout of the params a member holds (a list
    of one dict a layer, the leading ``"layers"`` entry dropped): the tree
    ``lm.init_model`` cuts by and the trunk gathers by."""
    def unstack(node):
        if isinstance(node, dict):
            return {k: unstack(v) for k, v in node.items()}
        return node[1:]

    def build(node):
        out = {}
        for k, v in node.items():
            if k in lm.STACKED:
                n = (model_cfg.n_enc_layers if k == "enc_blocks"
                     else model_cfg.n_layers)
                out[k] = [unstack(v)] * n
            elif isinstance(v, dict):
                out[k] = build(v)
            else:
                out[k] = v
        return out

    return build(param_pspecs(model_cfg, par))


def batch_pspec(par: ParallelConfig) -> tuple:
    return (par.batch_axes,)


def vocab_axes(par: Optional[ParallelConfig] = None):
    """(model axis, vocab-axis tuple, residual batch axes) of the head: the
    vocab is split over ``model`` and the batch's rows over the batch axes
    it does not use. ``par`` defaults to this process's ring or grid."""
    par = _par(par)
    vocab_ax = par.mesh_axis_for("vocab") or par.model_axis
    vax = vocab_ax if isinstance(vocab_ax, tuple) else (vocab_ax,)
    baxes = tuple(a for a in par.batch_axes if a not in vax)
    return vocab_ax, vax, baxes


def rows_split(rows: int, par: Optional[ParallelConfig] = None) -> bool:
    """Whether a micro-batch of ``rows`` rows splits over the batch axes,
    as the JAX ``fit_spec`` of the trunk's batch dim decides. When it does
    not, every data shard runs all of the micro-batch's rows through the
    trunk and the head takes its share of their tokens (``token_share``)."""
    par = _par(par)
    return fit_spec(batch_pspec(par), (rows,), par)[0] is not None


def token_share(x: torch.Tensor, baxes: tuple) -> torch.Tensor:
    """This data shard's block of the rows of ``x`` [T, ...], the tokens of
    a micro-batch that every data shard ran alike: the JAX loss
    ``shard_map``'s split of the flat tokens over ``P(batch_axes)``, which
    needs T to divide the shards."""
    n = dist.world_size(baxes)
    if x.shape[0] % n:
        raise ValueError(f"{x.shape[0]} tokens do not split over the "
                         f"{n} data shards {baxes}")
    t = x.shape[0] // n
    r = dist.rank(baxes)
    return x[r * t:(r + 1) * t]


def n_vocab_shards(par: Optional[ParallelConfig] = None) -> int:
    _, vax, _ = vocab_axes(par)
    sizes = _mesh_sizes(_par(par))
    n = 1
    for a in vax:
        n *= sizes.get(a, 1)
    return n


def _class_params(head: SoftmaxHead, model_cfg: ModelConfig, params,
                  head_params, specs=None):
    """The head's params on this member: the model's class matrix's row
    block for the W-heads (``specs``: the grid's param specs, whose FSDP
    split of the table is gathered first), the head-owned bucket block for
    the sketch heads."""
    if head.params_are_class_weights:
        return vocab_rows(lm.head_weight(params, model_cfg, specs))
    return head_params


def grid_parallel_config(par: Optional[ParallelConfig] = None
                         ) -> ParallelConfig:
    """The ``ParallelConfig`` of this process's grid: ``par`` when given
    (its mesh must be the grid's), else the JAX host tests' policy on the
    grid's (data, model) shape (with ``pod`` when the grid has one)."""
    n_pod, n_data, n_model = dist.grid_shape()
    if par is None:
        if n_pod > 1:
            return ParallelConfig(mesh_shape=(n_pod, n_data, n_model),
                                  axis_names=dist.AXES)
        return ParallelConfig(mesh_shape=(n_data, n_model),
                              axis_names=("data", "model"))
    sizes = _mesh_sizes(par)
    got = tuple(sizes.get(a, 1) for a in dist.AXES)
    if got != (n_pod, n_data, n_model):
        raise ValueError(f"ParallelConfig mesh {par.mesh_shape} over "
                         f"{par.axis_names} is not this process's grid "
                         f"(pod, data, model) = {(n_pod, n_data, n_model)}")
    return par


# ---------------------------------------------------------------------------
# loss assembly: routed through the head registry
# ---------------------------------------------------------------------------


def _par(par: Optional[ParallelConfig]) -> ParallelConfig:
    if par is not None:
        return par
    if dist.grid_declared():
        return grid_parallel_config()
    return ring_parallel_config(dist.world_size())


def make_head_loss_fn(model_cfg: ModelConfig, head_cfg: HeadConfig, *,
                      global_tokens: int,
                      head: Optional[SoftmaxHead] = None,
                      par: Optional[ParallelConfig] = None,
                      specs=None, split: bool = True):
    """Zoo loss through any registered ``SoftmaxHead``:
    ``loss_fn(params, head_params, head_aux, inputs, step=None) -> (loss,
    metrics)``. For W-heads the class matrix is the model's own
    (``lm.head_weight``) and ``head_params`` is ignored (pass ``()``); for
    the sketch heads it is this member's bucket block. ``head_aux`` is this
    member's aux (the knn graph's row, the LSH tables, the hashes).
    ``inputs`` are this member's rows: the whole batch on the ring, its
    data shard's on a grid (``specs``: the member's param specs,
    ``member_specs``, by which the trunk gathers its FSDP-split leaves),
    where the head's loss is completed over the batch axes, as the JAX
    ``shard_map`` over ``P(batch_axes)`` completes it. The loss is the
    mean over ``global_tokens`` tokens, the same on every member; its
    gradient is the JAX package's (module docstring). ``split=False``:
    the rows did not split over the data shards (``rows_split``), so each
    data shard ran the whole micro-batch and the head takes its
    ``token_share``."""
    head = head or make_head(model_cfg, head_cfg)
    par = _par(par)
    _, _, baxes = vocab_axes(par)
    everyone = baxes + ("model",)

    def loss_fn(params, head_params, head_aux, inputs, step=None):
        # training attention: the ref branches (the kernel has no backward)
        h, aux_l, _ = lm.backbone(params, model_cfg, inputs, backend="ref",
                                  remat=par.remat, specs=specs)
        f = dist.pvary(h.reshape(-1, h.shape[-1]))
        labels = inputs["labels"].reshape(-1)
        if not split:
            f, labels = token_share(f, baxes), token_share(labels, baxes)
        hp = _class_params(head, model_cfg, params, head_params, specs)
        loss, metrics = head.loss_local(f, labels, hp, head_aux,
                                        global_batch=global_tokens,
                                        step=step, batch_axes=baxes)
        return (dist.grad_mean(loss, everyone)
                + dist.grad_mean(aux_l, baxes)), metrics

    return loss_fn


def leaf_specs(specs, head_params) -> list:
    """The spec of every trainable leaf of (model params, head params), in
    ``tree_leaves`` order: the model's from ``specs`` (``member_specs``),
    the sketch heads' [R, B, D] buckets split over ``model``."""
    def walk(node):
        if isinstance(node, dict):
            return [x for v in node.values() for x in walk(v)]
        if isinstance(node, list):
            return [x for v in node for x in walk(v)]
        return [node]
    return walk(specs) + [(None, "model", None)] * len(
        tree_leaves(head_params))


def sync_grads(grads, specs: list, baxes: tuple) -> None:
    """Sum, in place, the gradients of the leaves replicated over the batch
    axes (each data shard's rows gave its part; GSPMD's all-reduce of a
    replicated param's gradient): every leaf whose spec (``specs``, one a
    leaf of ``grads``) does not split it over them (an FSDP gather
    reduce-scattered its gradient already). One all-reduce of the leaves
    laid end to end."""
    if not baxes or dist.world_size(baxes) == 1:
        return
    todo = [g for g, s in zip(tree_leaves(grads), specs)
            if not set(dist.spec_axes(s)) & set(baxes)]
    if not todo:
        return
    with torch.no_grad():
        flat = dist.psum(torch.cat([g.reshape(-1) for g in todo]), baxes)
        for g, part in zip(todo, flat.split([g.numel() for g in todo])):
            g.copy_(part.view_as(g))


def _shim_head_cfg(model_cfg: ModelConfig, head_cfg: HeadConfig,
                   use_knn: bool) -> HeadConfig:
    """The back-compat shims' head: knn when ``use_knn`` (or the config)
    says so, else full, with the JAX package's historical numerics: raw
    logits for the full softmax on LM trunks, cosine logits for knn and
    the cnn / feats trunks."""
    impl = "knn" if (use_knn or head_cfg.softmax_impl == "knn") else "full"
    cosine = (16.0 if (impl == "knn" or model_cfg.family in ("cnn", "feats"))
              else 0.0)
    return dataclasses.replace(head_cfg, softmax_impl=impl,
                               cosine_scale=cosine)


def make_loss_fn(model_cfg: ModelConfig, head_cfg: HeadConfig, *,
                 global_tokens: int, use_knn: bool = False,
                 m_local: int = 0):
    """Back-compat full/knn zoo loss: ``loss_fn(params, inputs, graph=None)``
    with this member's knn graph row threaded by the caller. A thin shim
    over ``make_head_loss_fn``: ``m_local`` is accepted but unused (the
    head derives it from ``active_frac``)."""
    inner = make_head_loss_fn(model_cfg,
                              _shim_head_cfg(model_cfg, head_cfg, use_knn),
                              global_tokens=global_tokens)

    def loss_fn(params, inputs, graph=None):
        aux = tuple(graph) if graph is not None else ()
        return inner(params, (), aux, inputs)

    return loss_fn


# ---------------------------------------------------------------------------
# step builders
# ---------------------------------------------------------------------------


def auto_micro_batches(model_cfg: ModelConfig, shape: InputShape,
                       par: Optional[ParallelConfig] = None) -> int:
    """Micro-batch count for the paper's §3.3.1 pipeline: bound each
    member's tokens a micro-batch to about 8,192. It must divide the batch
    of a data shard (``par``'s batch axes; this process's ring or grid by
    default); powers of two only. The JAX package's count."""
    sizes = _mesh_sizes(_par(par))
    shards = 1
    for a in _par(par).batch_axes:
        shards *= sizes.get(a, 1)
    b = max(1, shape.global_batch // shards)
    tokens = b * (1 if model_cfg.family == "cnn" else shape.seq_len)
    n = 1
    while n < b and tokens // n > 8192 and b % (n * 2) == 0:
        n *= 2
    return n


def _step_tokens(model_cfg: ModelConfig, shape: InputShape) -> int:
    return shape.global_batch * (1 if model_cfg.family == "cnn"
                                 else shape.seq_len)


def make_head_train_step(model_cfg: ModelConfig, head_cfg: HeadConfig,
                         train_cfg: TrainConfig, shape: InputShape, *,
                         head: Optional[SoftmaxHead] = None,
                         par: Optional[ParallelConfig] = None,
                         specs=None):
    """Registry-routed zoo train step for any registered softmax head:

        step(params, head_state, opt_state, inputs, lr)
            -> (params, head_state, opt_state, loss, metrics)

    ``inputs`` is this member's rows ``{"tokens", "labels"}`` [b, S] of
    the global batch ``shape``: the whole batch on the ring, on a grid its
    data shard's rows of every micro-batch in turn (``ZooExperiment``
    cuts them as the JAX pipeline does; the whole batch where a
    micro-batch's rows do not split, ``rows_split``), in
    ``train_cfg.micro_batch``
    micro-batches (0: ``auto_micro_batches``). ``head_state.params`` is
    the head-owned trainable block (``()`` for the W-heads, whose class
    matrix lives in the model params) and ``head_state.aux`` the
    non-trainable part (the head's ``refresh`` rebuilds it outside the
    step). The optimizer state is over ``(params, head_state.params)``;
    both are updated in place and returned. On a grid (``specs``: the
    member's param specs) the gradients of the leaves replicated over the
    batch axes are summed over them (``sync_grads``) and LARS takes each
    leaf's norms over the whole leaf."""
    head = head or make_head(model_cfg, head_cfg)
    par = _par(par)
    n_micro = (train_cfg.micro_batch
               or auto_micro_batches(model_cfg, shape, par))
    loss_fn = make_head_loss_fn(
        model_cfg, head_cfg,
        global_tokens=_step_tokens(model_cfg, shape) // n_micro, head=head,
        par=par, specs=specs,
        split=rows_split(shape.global_batch // n_micro, par))
    opt = make_optimizer(train_cfg)
    metric_names = list(head.metrics_spec())
    _, _, baxes = vocab_axes(par)

    def train_step(params, head_state: HeadState, opt_state, inputs, lr):
        step_no = opt_state.step
        trainable = (params, head_state.params)
        (loss, metrics), grads = microbatched_value_and_grad(
            lambda p, x: loss_fn(p[0], p[1], head_state.aux, x,
                                 step=step_no),
            trainable, inputs, n_micro, metric_names)
        kw = {}
        if specs is not None:
            lspecs = leaf_specs(specs, head_state.params)
            sync_grads(grads, lspecs, baxes)
            kw["leaf_axes"] = [dist.spec_axes(s) for s in lspecs]
        with torch.no_grad():
            opt_state = opt.update_(grads, opt_state, trainable, lr, **kw)
        return params, head_state, opt_state, loss, metrics

    return train_step


def make_train_step(model_cfg: ModelConfig, head_cfg: HeadConfig,
                    train_cfg: TrainConfig, shape: InputShape, *,
                    use_knn: bool = False):
    """Back-compat full/knn zoo step, a thin shim over
    ``make_head_train_step``: ``step(params, opt_state, inputs[, graph],
    lr) -> (params, opt_state, loss, metrics)`` with the optimizer state
    over ``params``, the knn graph row a positional argument when
    ``use_knn`` (or the head config) selects knn."""
    hcfg = _shim_head_cfg(model_cfg, head_cfg, use_knn)
    step = make_head_train_step(model_cfg, hcfg, train_cfg, shape)

    def run(params, opt_state, inputs, graph, lr):
        aux = tuple(graph) if graph is not None else ()
        nu = opt_state.nu
        params, _, opt_state, loss, metrics = step(
            params, HeadState((), aux),
            opt_state._replace(mu=(opt_state.mu, ()),
                               nu=None if nu is None else (nu, ())),
            inputs, lr)
        return (params, opt_state._replace(
            mu=opt_state.mu[0],
            nu=None if nu is None else opt_state.nu[0]), loss, metrics)

    if hcfg.softmax_impl == "knn":
        return run
    return lambda params, opt_state, inputs, lr: run(params, opt_state,
                                                     inputs, None, lr)


def make_head_eval_step(model_cfg: ModelConfig, head_cfg: HeadConfig, *,
                        head: Optional[SoftmaxHead] = None,
                        par: Optional[ParallelConfig] = None, specs=None):
    """Deploy-style top-1 accuracy over the batch's tokens through the
    head's own ``eval_logits_local`` (§4.5 retrieval for the W-heads, the
    hashed-bucket decode for the sketch heads):
    ``eval_fn(params, head_params, head_aux, inputs) -> accuracy`` (a
    0-dim tensor). The trunk's attention takes ``head_cfg.backend``'s
    kernels (no grad here). On a grid ``inputs`` are the data shard's
    rows and the accuracy is the ``pmean`` of the shards' (the JAX
    ``eval_fn``'s)."""
    head = head or make_head(model_cfg, head_cfg)
    par = _par(par)
    _, _, baxes = vocab_axes(par)

    @torch.inference_mode()
    def eval_fn(params, head_params, head_aux, inputs):
        h, _, _ = lm.backbone(params, model_cfg, inputs,
                              backend=head_cfg.backend, remat=par.remat,
                              specs=specs)
        f = h.reshape(-1, h.shape[-1])
        labels = inputs["labels"].reshape(-1)
        hp = _class_params(head, model_cfg, params, head_params, specs)
        pred, _ = head.eval_logits_local(f, hp, head_aux)
        return batch_mean((pred.long() == labels.long()).float().mean(),
                          baxes)

    return eval_fn


def _refuse_topk(head: SoftmaxHead):
    if not head.params_are_class_weights:
        raise NotImplementedError(
            f"top-k serving retrieves against the [V, D] class matrix, "
            f"which the {head.name!r} head does not train; use a W-head "
            f"(full/knn/selective/sampled)")


def _retrieval_operands(head_cfg: HeadConfig, queries, w):
    f, w = queries.float(), w.float()
    if head_cfg.cosine_scale > 0:
        f, w = _normalize(f), _normalize(w)
    return f, w


def make_feature_serve_step(model_cfg: ModelConfig, head_cfg: HeadConfig, *,
                            top_k: Optional[int] = None,
                            head: Optional[SoftmaxHead] = None, specs=None):
    """The zoo's entry for the serving tier: classify precomputed backbone
    features against the model's class matrix. Queries arrive as a padded
    micro-batch [b_pad, D], the same on every member, with only the first
    ``n_queries`` rows real. Returns ``step(params, head_params, head_aux,
    queries, n_queries) ->`` pred [b_pad] int32 (``top_k=None``; any head,
    through its ``eval_logits_local``) or (vals [b_pad, k], gids [b_pad,
    k]) (``top_k=k``; W-heads only: ``stage1_topk`` per shard on the
    kernel backend, one all-gather merge). Padded rows come back -1 /
    (-inf, -1). Cosine heads normalise queries and rows first; the full
    head on an LM trunk scores raw inner products."""
    head = head or make_head(model_cfg, head_cfg)
    if top_k is not None:
        _refuse_topk(head)

    @torch.inference_mode()
    def step(params, head_params, head_aux, queries, n_queries: int):
        hp = _class_params(head, model_cfg, params, head_params, specs)
        if top_k is None:
            pred, _ = head.eval_logits_local(queries, hp, head_aux)
            return mask_padded_rows(pred.to(torch.int32), n_queries, -1)
        f, w = _retrieval_operands(head_cfg, queries, hp)
        return serve_topk_batched_local(f, w, top_k, n_queries,
                                        n_valid=head.n_valid,
                                        backend=head.backend)

    return step


def make_feature_ivf_serve_step(model_cfg: ModelConfig, head_cfg: HeadConfig,
                                top_k: int, *, nprobe: int,
                                head: Optional[SoftmaxHead] = None,
                                specs=None):
    """The zoo's sublinear top-k through an ``IVFIndex`` (the contract of
    ``make_feature_serve_step``'s top-k): ``step(params, head_params,
    head_aux, centroids [C, D], members [C, cap], queries [b_pad, D],
    n_queries) -> (vals [b_pad, k], gids [b_pad, k])``. Each member probes
    its ``nprobe`` nearest centroids and reranks only their member rows
    (``serve_topk_ivf_batched_local``; the kernel backend's fused
    ``ops.ivf_rerank_probed``). W-heads only."""
    head = head or make_head(model_cfg, head_cfg)
    _refuse_topk(head)

    @torch.inference_mode()
    def step(params, head_params, head_aux, centroids, members, queries,
             n_queries: int):
        hp = _class_params(head, model_cfg, params, head_params, specs)
        f, w = _retrieval_operands(head_cfg, queries, hp)
        return serve_topk_ivf_batched_local(
            f, w, centroids, members, top_k, nprobe, n_queries,
            backend=head.backend, block_a=head_cfg.pallas_block_a)

    return step


# ---------------------------------------------------------------------------
# token serving
# ---------------------------------------------------------------------------


def _greedy(params, model_cfg: ModelConfig, f, specs=None):
    n_valid = (effective_vocab(model_cfg)
               if model_cfg.real_vocab_size else 0)
    w = vocab_rows(lm.head_weight(params, model_cfg, specs))
    token, _ = serve_logits_local(f, w, n_valid=n_valid)
    return token


def make_prefill_step(model_cfg: ModelConfig, shape: InputShape, *,
                      backend: str = "ref",
                      par: Optional[ParallelConfig] = None, specs=None):
    """Prefill: full forward + caches + last-position greedy token.
    ``step(params, inputs) -> (token [B] int32, caches)``. ``backend``
    selects the attention's kernels (``"kernel"``: the hand-written flash
    attention). ``par.remat`` is passed on; a prefill wants its caches,
    so no layer is checkpointed. On a grid (``specs``) the caches hold the
    member's KV heads (the JAX ``cache_pspecs``)."""
    window = lm.decode_window(model_cfg, shape.seq_len)
    remat = _par(par).remat

    def prefill_step(params, inputs):
        h, _, caches = lm.backbone(params, model_cfg, inputs, want_cache=True,
                                   cache_window=window, backend=backend,
                                   remat=remat, specs=specs)
        return _greedy(params, model_cfg, h[:, -1, :], specs), caches

    return prefill_step


def make_serve_step(model_cfg: ModelConfig, shape: InputShape, *,
                    backend: str = "ref", specs=None):
    """One decode token through the cache + sharded-vocab greedy sample.
    ``step(params, caches, slots, token [B,1]) -> (next [B,1], caches,
    slots)``; the caches are updated in place."""
    window = lm.decode_window(model_cfg, shape.seq_len)

    def serve_step(params, caches, slots, token):
        h, caches, slots = lm.decode(params, model_cfg, {"token": token},
                                     caches, slots, window=window,
                                     backend=backend, specs=specs)
        return (_greedy(params, model_cfg, h[:, 0, :], specs)[:, None],
                caches, slots)

    return serve_step
