"""Train, eval and serve steps of the architecture zoo: the port of the JAX
package's ``train/gspmd.py``.

The JAX package runs the zoo's trunk tensor-parallel over a (data, model)
mesh and the head as a shard_map over the vocab whose body is any
registered ``SoftmaxHead``. Here the ring (``repro_torch.dist``) is the
model axis: every member holds the whole trunk (replicated: tensor
parallelism of the trunk and the zoo's data axis wait for their slice,
ROADMAP.md A.9) and runs the whole batch, and the head's class matrix,
the tied embedding table or the untied head, is row-sharded: each member
scores its row block (``vocab_rows``). The sketch heads (mach, csoft)
train head-owned [R, B/P, D] bucket blocks instead. The loss body is the
head's ``loss_local``, whose ``backend`` routes its kernels as in the
paper trainer; no head branches here. Every member calls a step with the
same arguments.

The gradients are the JAX package's, which are those of the mean loss
over the batch's tokens whatever the ring size (measured at n_model 1, 2
and 4): the features enter the head through ``dist.pvary`` (their
gradient summed over the ring), the replicated loss leaves it through
``dist.grad_mean`` (each member's copy carries 1 / P of the cotangent,
which the head's ``psum`` backwards sum back), and the tied table's row
block is cut by ``dist.shard_rows``, whose backward all-gathers the
blocks' gradients, so every member holds the same full-table gradient
and, after the update, the same params.

The trunk's attention trains on the ``ref`` branches (``ops.flash_attention``
has no backward, as the Pallas kernel has none); evaluation and serving
take ``head_cfg.backend``'s, the flash kernel on ``kernel``. The greedy
token's head is the dense ``serve_logits_local`` on both backends, as in
the JAX package.

The step builders take the JAX package's ``par: ParallelConfig``, of
which they read ``remat`` (``"full"``: each trunk layer checkpointed,
``models.decoder``); the default is the ring as it is, with no remat.
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
from repro_torch.core.sharded_softmax import (_normalize, mask_padded_rows,
                                              serve_logits_local,
                                              serve_topk_batched_local,
                                              serve_topk_ivf_batched_local)
from repro_torch.models import lm
from repro_torch.optim import make_optimizer

def vocab_rows(w):
    """This ring member's row block of the class matrix W [V, D]: a view,
    or under grad a copy whose backward gives every member the whole
    table's gradient (``dist.shard_rows``)."""
    n = dist.world_size()
    if w.shape[0] % n:
        raise ValueError(f"the vocab of {w.shape[0]} rows does not divide "
                         f"the ring of {n}: pad it (configs.pad_vocab)")
    return dist.shard_rows(w)


def vocab_axes():
    """The ring's counterpart of the JAX package's (model axis, vocab axes,
    residual batch axes): the vocab is split over the one ring axis, and
    there are no batch axes (every member runs the whole batch)."""
    return "ring", ("ring",), ()


def n_vocab_shards() -> int:
    """Vocab row shards: the ring's size."""
    return dist.world_size()


def _class_params(head: SoftmaxHead, model_cfg: ModelConfig, params,
                  head_params):
    """The head's params on this member: the model's class matrix's row
    block for the W-heads, the head-owned bucket block for the sketch
    heads."""
    if head.params_are_class_weights:
        return vocab_rows(lm.head_weight(params, model_cfg))
    return head_params


# ---------------------------------------------------------------------------
# loss assembly: routed through the head registry
# ---------------------------------------------------------------------------


def _par(par: Optional[ParallelConfig]) -> ParallelConfig:
    return par if par is not None else ring_parallel_config(
        dist.world_size())


def make_head_loss_fn(model_cfg: ModelConfig, head_cfg: HeadConfig, *,
                      global_tokens: int,
                      head: Optional[SoftmaxHead] = None,
                      par: Optional[ParallelConfig] = None):
    """Zoo loss through any registered ``SoftmaxHead``:
    ``loss_fn(params, head_params, head_aux, inputs, step=None) -> (loss,
    metrics)``. For W-heads the class matrix is the model's own
    (``lm.head_weight``) and ``head_params`` is ignored (pass ``()``); for
    the sketch heads it is this member's bucket block. ``head_aux`` is this
    member's aux (the knn graph's row, the LSH tables, the hashes). The
    loss is the mean over ``global_tokens`` tokens, the same on every
    member; its gradient is the JAX package's (module docstring)."""
    head = head or make_head(model_cfg, head_cfg)
    remat = _par(par).remat

    def loss_fn(params, head_params, head_aux, inputs, step=None):
        # training attention: the ref branches (the kernel has no backward)
        h, aux_l, _ = lm.backbone(params, model_cfg, inputs, backend="ref",
                                  remat=remat)
        f = dist.pvary(h.reshape(-1, h.shape[-1]))
        labels = inputs["labels"].reshape(-1)
        hp = _class_params(head, model_cfg, params, head_params)
        loss, metrics = head.loss_local(f, labels, hp, head_aux,
                                        global_batch=global_tokens,
                                        step=step)
        return dist.grad_mean(loss) + aux_l, metrics

    return loss_fn


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


def auto_micro_batches(model_cfg: ModelConfig, shape: InputShape) -> int:
    """Micro-batch count for the paper's §3.3.1 pipeline: bound each
    member's tokens a micro-batch to about 8,192. It must divide the batch
    (every member runs the whole batch: the ring has no data axis); powers
    of two only. The JAX package's count on a mesh of one data shard."""
    b = max(1, shape.global_batch)
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
                         par: Optional[ParallelConfig] = None):
    """Registry-routed zoo train step for any registered softmax head:

        step(params, head_state, opt_state, inputs, lr)
            -> (params, head_state, opt_state, loss, metrics)

    ``inputs`` is the global batch ``{"tokens", "labels"}`` [B, S], the
    same on every member, in ``train_cfg.micro_batch`` micro-batches (0:
    ``auto_micro_batches``). ``head_state.params`` is the head-owned
    trainable block (``()`` for the W-heads, whose class matrix lives in
    the model params) and ``head_state.aux`` the non-trainable part (the
    head's ``refresh`` rebuilds it outside the step). The optimizer state
    is over ``(params, head_state.params)``; both are updated in place and
    returned."""
    head = head or make_head(model_cfg, head_cfg)
    n_micro = train_cfg.micro_batch or auto_micro_batches(model_cfg, shape)
    loss_fn = make_head_loss_fn(
        model_cfg, head_cfg,
        global_tokens=_step_tokens(model_cfg, shape) // n_micro, head=head,
        par=par)
    opt = make_optimizer(train_cfg)
    metric_names = list(head.metrics_spec())

    def train_step(params, head_state: HeadState, opt_state, inputs, lr):
        step_no = opt_state.step
        trainable = (params, head_state.params)
        (loss, metrics), grads = microbatched_value_and_grad(
            lambda p, x: loss_fn(p[0], p[1], head_state.aux, x,
                                 step=step_no),
            trainable, inputs, n_micro, metric_names)
        with torch.no_grad():
            opt_state = opt.update_(grads, opt_state, trainable, lr)
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
                        par: Optional[ParallelConfig] = None):
    """Deploy-style top-1 accuracy over the batch's tokens through the
    head's own ``eval_logits_local`` (§4.5 retrieval for the W-heads, the
    hashed-bucket decode for the sketch heads):
    ``eval_fn(params, head_params, head_aux, inputs) -> accuracy`` (a
    0-dim tensor). The trunk's attention takes ``head_cfg.backend``'s
    kernels (no grad here)."""
    head = head or make_head(model_cfg, head_cfg)
    remat = _par(par).remat

    @torch.inference_mode()
    def eval_fn(params, head_params, head_aux, inputs):
        h, _, _ = lm.backbone(params, model_cfg, inputs,
                              backend=head_cfg.backend, remat=remat)
        f = h.reshape(-1, h.shape[-1])
        labels = inputs["labels"].reshape(-1)
        hp = _class_params(head, model_cfg, params, head_params)
        pred, _ = head.eval_logits_local(f, hp, head_aux)
        return (pred.long() == labels.long()).float().mean()

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
                            head: Optional[SoftmaxHead] = None):
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
        hp = _class_params(head, model_cfg, params, head_params)
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
                                head: Optional[SoftmaxHead] = None):
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
        hp = _class_params(head, model_cfg, params, head_params)
        f, w = _retrieval_operands(head_cfg, queries, hp)
        return serve_topk_ivf_batched_local(
            f, w, centroids, members, top_k, nprobe, n_queries,
            backend=head.backend, block_a=head_cfg.pallas_block_a)

    return step


# ---------------------------------------------------------------------------
# token serving
# ---------------------------------------------------------------------------


def _greedy(params, model_cfg: ModelConfig, f):
    n_valid = (effective_vocab(model_cfg)
               if model_cfg.real_vocab_size else 0)
    w = vocab_rows(lm.head_weight(params, model_cfg))
    token, _ = serve_logits_local(f, w, n_valid=n_valid)
    return token


def make_prefill_step(model_cfg: ModelConfig, shape: InputShape, *,
                      backend: str = "ref",
                      par: Optional[ParallelConfig] = None):
    """Prefill: full forward + caches + last-position greedy token.
    ``step(params, inputs) -> (token [B] int32, caches)``. ``backend``
    selects the attention's kernels (``"kernel"``: the hand-written flash
    attention). ``par.remat`` is passed on; a prefill wants its caches,
    so no layer is checkpointed."""
    window = lm.decode_window(model_cfg, shape.seq_len)
    remat = _par(par).remat

    def prefill_step(params, inputs):
        h, _, caches = lm.backbone(params, model_cfg, inputs, want_cache=True,
                                   cache_window=window, backend=backend,
                                   remat=remat)
        return _greedy(params, model_cfg, h[:, -1, :]), caches

    return prefill_step


def make_serve_step(model_cfg: ModelConfig, shape: InputShape, *,
                    backend: str = "ref"):
    """One decode token through the cache + sharded-vocab greedy sample.
    ``step(params, caches, slots, token [B,1]) -> (next [B,1], caches,
    slots)``; the caches are updated in place."""
    window = lm.decode_window(model_cfg, shape.seq_len)

    def serve_step(params, caches, slots, token):
        h, caches, slots = lm.decode(params, model_cfg, {"token": token},
                                     caches, slots, window=window,
                                     backend=backend)
        return _greedy(params, model_cfg, h[:, 0, :])[:, None], caches, slots

    return serve_step
