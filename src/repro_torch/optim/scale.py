"""Mixed-precision loss scaling (paper §3.1 / Micikevicius et al.): the
port of the JAX package's ``optim/scale.py``.

Static scaling (``TrainConfig.loss_scale > 0``) and dynamic scaling
(``< 0``: ``|value|`` is the initial scale, which grows 2x every
``growth_interval`` good steps and halves on non-finite gradients, that
step's update skipped). As in the JAX package no trainer reads
``TrainConfig.loss_scale``: the functions are the recipe, for a caller
that trains in fp16.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.optim.optimizers import tree_leaves, tree_map


class LossScaleState(NamedTuple):
    scale: torch.Tensor          # fp32 scalar
    good_steps: torch.Tensor     # int32 scalar


def init_loss_scale(initial: float, *, device=None) -> LossScaleState:
    return LossScaleState(
        scale=torch.tensor(abs(initial), dtype=torch.float32, device=device),
        good_steps=torch.zeros((), dtype=torch.int32, device=device))


def scaled_grads(loss_fn, params, *args, scale):
    """The gradient of ``scale * loss`` with respect to the tensors of
    ``params``, returned unscaled (fp32) with a finite flag.
    ``loss_fn(params, *args) -> (loss, aux)``. Returns ((loss, aux),
    grads, finite)."""
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss, aux = loss_fn(live, *args)
    leaves = tree_leaves(live)
    grads = torch.autograd.grad(loss * scale, leaves, allow_unused=True)
    it = iter([torch.zeros_like(p) if g is None else g.float() / scale
               for p, g in zip(leaves, grads)])
    grads = tree_map(lambda _: next(it), live)
    finite = torch.stack([torch.isfinite(g).all()
                          for g in tree_leaves(grads)]).all()
    return (loss.detach(), aux), grads, finite


def dynamic_loss_scale(state: LossScaleState, finite, *,
                       growth_interval: int = 200, factor: float = 2.0,
                       min_scale: float = 1.0, max_scale: float = 2.0 ** 24):
    """The scale after a step. Returns (new state, whether to apply the
    step's update)."""
    finite = torch.as_tensor(finite, device=state.scale.device)
    due = (state.good_steps + 1) >= growth_interval
    grown = torch.where(due, torch.clamp(state.scale * factor,
                                         max=max_scale), state.scale)
    good = torch.where(due, torch.zeros_like(state.good_steps),
                       state.good_steps + 1)
    new_scale = torch.where(finite, grown,
                            torch.clamp(state.scale / factor, min=min_scale))
    new_good = torch.where(finite, good, torch.zeros_like(good))
    return LossScaleState(scale=new_scale, good_steps=new_good), finite
