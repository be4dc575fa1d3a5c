"""Micro-batch accumulation (paper §3.3.1, and FCCS's n× batch growth): the
port of the JAX package's ``core/pipeline.py``.

The JAX package expresses the per-micro-batch FE -> all-gather -> head ->
accumulate structure as a ``lax.scan``; here it is a Python loop. Each
micro-batch is a slice of the member's LOCAL batch (rows
``[i·b/n, (i+1)·b/n)``), and ``loss_fn`` does its own ring all-gather, so
the rows meet in the same order as on the JAX mesh. Gradients accumulate
as ``g / n_micro`` in fp32; loss and metrics are averaged.

The all-gathers run in turn with the compute (no ``async_op`` overlap of
micro-batch i+1's gather with micro-batch i yet; ROADMAP.md A.3).
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.optim import tree_leaves, tree_map


def split_microbatches(inputs: dict, n_micro: int) -> list:
    """{k: [B, ...]} -> n_micro dicts of [B/n_micro, ...] row slices."""
    for k, x in inputs.items():
        if x.shape[0] % n_micro:
            raise ValueError(f"batch {x.shape[0]} of {k!r} does not split "
                             f"into {n_micro} micro-batches")
    return [{k: x.chunk(n_micro, dim=0)[i] for k, x in inputs.items()}
            for i in range(n_micro)]


def _value_and_grad(loss_fn, params, inputs):
    """(loss, metrics), grads of ``loss_fn(params, inputs)`` with respect to
    the tensors of ``params``, which are used as they are (detached views
    that require grad)."""
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss, metrics = loss_fn(live, inputs)
    leaves = tree_leaves(live)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    it = iter([torch.zeros_like(p) if g is None else g
               for p, g in zip(leaves, grads)])
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()}), \
        tree_map(lambda _: next(it), live)


def microbatched_value_and_grad(loss_fn: Callable, params, inputs: dict,
                                n_micro: int, metric_names=None):
    """Mean loss / grads over ``n_micro`` micro-batches.

    ``loss_fn(params, micro_inputs) -> (loss, metrics)``. Gradients
    accumulate in fp32; metrics are averaged. With ``n_micro == 1`` this is
    the paper's Fig. 4(a) baseline: one pass, no accumulation."""
    if n_micro == 1:
        return _value_and_grad(loss_fn, params, inputs)
    acc_g = None
    acc_l = torch.zeros((), dtype=torch.float32)
    acc_m = None
    for micro in split_microbatches(inputs, n_micro):
        (loss, metrics), grads = _value_and_grad(loss_fn, params, micro)
        if acc_g is None:
            acc_g = tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                                   device=g.device), grads)
            names = metric_names or list(metrics)
            acc_m = {k: torch.zeros((), dtype=torch.float32,
                                    device=loss.device) for k in names}
            acc_l = acc_l.to(loss.device)
        acc_g = tree_map(lambda a, g: a + g.float() / n_micro, acc_g, grads)
        acc_m = {k: acc_m[k] + metrics[k] / n_micro for k in acc_m}
        acc_l = acc_l + loss / n_micro
    return (acc_l, acc_m), acc_g
