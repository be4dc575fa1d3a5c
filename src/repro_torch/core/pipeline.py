"""Micro-batch accumulation and the hybrid pipeline (paper §3.3.1, and
FCCS's n× batch growth): the port of the JAX package's
``core/pipeline.py``.

The JAX package expresses the per-micro-batch FE -> all-gather -> head ->
accumulate structure as a ``lax.scan`` and leaves the overlap of one
micro-batch's gathers with another's compute to XLA's latency-hiding
scheduler. Here both are explicit:

* ``microbatched_value_and_grad`` runs the micro-batches in turn, each
  one's ``loss_fn`` doing its own ring all-gathers (the zoo's steps, and
  the paper's step with ``overlap=False``);
* ``pipelined_value_and_grad`` is Fig. 4(b)'s schedule for the paper's
  hybrid step: micro-batch i+1's feature extractor runs and its gathers
  start before micro-batch i's head waits for its own, and the features'
  gradient reduce-scatter of i is in flight while the head of i+1 runs
  (``dist.all_gather_start`` / ``reduce_scatter_start``, whose docstrings
  say what overlaps on NCCL and on gloo).

Each micro-batch is a slice of the member's LOCAL batch (rows
``[i·b/n, (i+1)·b/n)``), gathered over the ring, so the rows meet in the
same order as on the JAX mesh. Both schedules accumulate in place
(``GradAccumulator``): each leaf ``acc.add_(g.float() / n_micro)``, the
JAX scan's ``a + g.astype(f32) / n_micro`` in the same two operations,
and a micro-batch's gradients are dropped once added, so the accumulator
and one micro-batch's gradients are all that is live (the scan's carry is
updated in place by XLA). Gradients, loss and metrics are added in
micro-batch order, so the two schedules give the same bits.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch import dist
from repro_torch.optim import tree_leaves, tree_map


def split_microbatches(inputs: dict, n_micro: int) -> list:
    """{k: [B, ...]} -> n_micro dicts of [B/n_micro, ...] row slices."""
    for k, x in inputs.items():
        if x.shape[0] % n_micro:
            raise ValueError(f"batch {x.shape[0]} of {k!r} does not split "
                             f"into {n_micro} micro-batches")
    return [{k: x.chunk(n_micro, dim=0)[i] for k, x in inputs.items()}
            for i in range(n_micro)]


def _live(params):
    """Detached views of ``params`` that require grad."""
    return tree_map(lambda p: p.detach().requires_grad_(True), params)


def _value_and_grad(loss_fn, params, inputs):
    """(loss, metrics), grads of ``loss_fn(params, inputs)`` with respect to
    the tensors of ``params``, which are used as they are (detached views
    that require grad)."""
    live = _live(params)
    loss, metrics = loss_fn(live, inputs)
    leaves = tree_leaves(live)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    it = iter([torch.zeros_like(p) if g is None else g
               for p, g in zip(leaves, grads)])
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()}), \
        tree_map(lambda _: next(it), live)


class GradAccumulator:
    """The mean over ``n_micro`` micro-batches of the gradients (fp32,
    the layout of ``params``), the loss and the metrics, each micro-batch
    added in place in turn."""

    def __init__(self, params, n_micro: int, metric_names=None):
        self.n_micro = n_micro
        self.grads = tree_map(lambda p: torch.zeros(
            p.shape, dtype=torch.float32, device=p.device), params)
        self.leaves = tree_leaves(self.grads)
        self.metric_names = metric_names
        self.loss = self.metrics = None

    def add_grads(self, grads, start: int = 0) -> None:
        """Add one micro-batch's gradients of ``self.leaves[start:]`` (a
        list in their order; None: a leaf the micro-batch did not
        reach)."""
        for a, g in zip(self.leaves[start:], grads):
            if g is not None:
                a.add_(g.float() / self.n_micro)

    def add_value(self, loss, metrics: dict) -> None:
        """Add one micro-batch's loss and metrics."""
        if self.loss is None:
            names = self.metric_names or list(metrics)
            self.metrics = {k: torch.zeros((), dtype=torch.float32,
                                           device=loss.device)
                            for k in names}
            self.loss = torch.zeros((), dtype=torch.float32,
                                    device=loss.device)
        self.metrics = {k: self.metrics[k] + metrics[k] / self.n_micro
                        for k in self.metrics}
        self.loss = self.loss + loss / self.n_micro

    def result(self):
        return (self.loss, self.metrics), self.grads


def microbatched_value_and_grad(loss_fn: Callable, params, inputs: dict,
                                n_micro: int, metric_names=None):
    """Mean loss / grads over ``n_micro`` micro-batches, in turn.

    ``loss_fn(params, micro_inputs) -> (loss, metrics)``. Gradients
    accumulate in fp32, in place; metrics are averaged. With ``n_micro ==
    1`` this is the paper's Fig. 4(a) baseline: one pass, no
    accumulation."""
    if n_micro == 1:
        return _value_and_grad(loss_fn, params, inputs)
    acc = GradAccumulator(params, n_micro, metric_names)
    for micro in split_microbatches(inputs, n_micro):
        (loss, metrics), grads = _value_and_grad(loss_fn, params, micro)
        acc.add_grads(tree_leaves(grads))
        acc.add_value(loss, metrics)
        del grads
    return acc.result()


def pipelined_value_and_grad(fe_fn: Callable, head_fn: Callable, params,
                             inputs: dict, n_micro: int, metric_names=None):
    """The paper's hybrid step over ``n_micro`` micro-batches in Fig.
    4(b)'s schedule: the value and gradients of ``microbatched_value_and_
    grad`` with ``loss_fn = head_fn(hp, all_gather(fe_fn(fe, x)),
    all_gather(x["labels"]))``, bit for bit.

    ``params`` is (FE params, head params); ``fe_fn(fe_params, micro)``
    gives this member's features of a micro-batch, ``head_fn(head_params,
    f_all, y_all) -> (loss, metrics)`` the head's loss on the ring-gathered
    micro-batch. The micro-batches go in pairs (i, i+1), as Fig. 4(b)
    draws them: FE(i) and FE(i+1) run and start their features' and
    labels' gathers; the head waits for gather(i), runs forward and
    backward against the gathered features and starts the features'
    gradient reduce-scatter(i), then does the same for i+1 while
    reduce-scatter(i) is in flight; then FE backward(i) from the scattered
    gradient, FE(i+2) and its gathers, FE backward(i+1), FE(i+3) and its
    gathers, each while the other's collective is in flight. So at most
    two micro-batches' FE activations are live and at most two of the
    micro-batches' collectives are in flight. A trunk whose features carry
    no gradient (``feats``) has no FE backward: FE(i+2) and its gathers
    follow head(i), so gather(i+1) is in flight while head(i) runs."""
    fe_live, hp_live = _live(params[0]), _live(params[1])
    fe_leaves, hp_leaves = tree_leaves(fe_live), tree_leaves(hp_live)
    n_fe = len(fe_leaves)
    micros = split_microbatches(inputs, n_micro)
    acc = (GradAccumulator(params, n_micro, metric_names) if n_micro > 1
           else None)
    one = {}          # n_micro == 1: the micro-batch's own results

    def forward(i):
        f = fe_fn(fe_live, micros[i])
        return (f, dist.all_gather_start(f, tag=i),
                dist.all_gather_start(micros[i]["labels"], tag=i))

    def head(i, f, gathered_f, gathered_y):
        f_all = gathered_f.wait().requires_grad_(f.requires_grad)
        loss, metrics = head_fn(hp_live, f_all, gathered_y.wait())
        wrt = hp_leaves + ([f_all] if f.requires_grad else [])
        grads = list(torch.autograd.grad(loss, wrt, allow_unused=True))
        scatter = (dist.reduce_scatter_start(grads.pop(), tag=i)
                   if f.requires_grad else None)
        loss, metrics = loss.detach(), {k: v.detach()
                                        for k, v in metrics.items()}
        if acc is None:
            one.update(loss=loss, metrics=metrics, hp=grads)
        else:
            acc.add_grads(grads, start=n_fe)
            acc.add_value(loss, metrics)
        return f, scatter

    def backward(f, scatter):
        if scatter is None:
            return
        grads = torch.autograd.grad(f, fe_leaves, grad_outputs=scatter.wait(),
                                    allow_unused=True)
        if acc is None:
            one["fe"] = grads
        else:
            acc.add_grads(grads)

    early = not fe_leaves      # no FE backward to wait for
    started = {i: forward(i) for i in range(min(2, n_micro))}
    for p in range(0, n_micro, 2):
        pair = range(p, min(p + 2, n_micro))
        headed = {}
        for i in pair:
            headed[i] = head(i, *started.pop(i))
            if early and i + 2 < n_micro:
                started[i + 2] = forward(i + 2)
        for i in pair:
            backward(*headed.pop(i))
            if not early and i + 2 < n_micro:
                started[i + 2] = forward(i + 2)
    if acc is not None:
        return acc.result()
    grads = list(one.get("fe", [None] * n_fe)) + one["hp"]
    it = iter([torch.zeros_like(p) if g is None else g
               for p, g in zip(fe_leaves + hp_leaves, grads)])
    return (one["loss"], one["metrics"]), \
        tree_map(lambda _: next(it), (fe_live, hp_live))
