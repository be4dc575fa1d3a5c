"""Minimal functional optimizers, written by hand on tensors: the port of
the JAX package's ``optim/optimizers.py`` (which has no optax either).

API, as there:
    opt = sgd(momentum=0.9) | lars(...) | adam(...)
    state = opt.init(params)
    updates, state = opt.update(grads, state, params, lr)
    params = apply_updates(params, updates)

``params``, ``grads`` and the moments are trees of dicts, tuples and lists
over tensors (the trainer passes ``(fe_params, head_params)``). All states
are fp32, the paper's master-copy discipline. The arithmetic is the JAX
package's, expression for expression, so the two agree to fp32 rounding.

Inside the hybrid step each ring member updates its own row block of the
head, and LARS takes that member's LOCAL ``||w||`` and ``||g||`` (the JAX
update runs inside the shard_map body): the norms are never reduced over
the ring.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.configs.base import TrainConfig


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[..., Any]  # (grads, state, params, lr) -> (updates, state)


class OptState(NamedTuple):
    step: int
    mu: Any            # first moment / momentum
    nu: Any = None     # second moment (adam only)


def tree_map(fn, tree, *rest):
    """``fn`` over the tensors of ``tree`` (dicts, the zoo's
    ``models.layers.ParamDict``s, tuples, NamedTuples, lists), with the
    matching leaves of ``rest``; ``None`` leaves stay ``None``."""
    if isinstance(tree, dict):
        out = {k: tree_map(fn, v, *(r[k] for r in rest))
               for k, v in tree.items()}
        # a dict subclass (the zoo's ParamDict) keeps its type
        return out if type(tree) is dict else type(tree)(**out)
    if isinstance(tree, (tuple, list)):
        out = (tree_map(fn, v, *(r[i] for r in rest))
               for i, v in enumerate(tree))
        # a NamedTuple (OptState) takes its fields as arguments
        return type(tree)(*out) if hasattr(tree, "_fields") \
            else type(tree)(out)
    if tree is None:
        return None
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The tensors of ``tree`` in ``tree_map`` order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in tree_leaves(v)]
    return [] if tree is None else [tree]


def _zeros_like_tree(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def apply_updates(params, updates):
    return tree_map(lambda p, u: (p.float() + u).to(p.dtype), params,
                    updates)


@torch.no_grad()
def assign(dst, src) -> None:
    """Copy the tensors of ``src`` into those of ``dst`` (same tree), in
    place: the trainers update their params where they live."""
    for d, s in zip(tree_leaves(dst), tree_leaves(src)):
        d.copy_(s)


def _wd(g, p, weight_decay):
    g = g.float()
    if weight_decay:
        g = g + weight_decay * p.float()
    return g


def sgd(momentum: float = 0.9, weight_decay: float = 0.0,
        nesterov: bool = False) -> Optimizer:
    def init(params):
        return OptState(step=0, mu=_zeros_like_tree(params))

    def update(grads, state, params, lr):
        mu = tree_map(lambda g, m, p: momentum * m + _wd(g, p, weight_decay),
                      grads, state.mu, params)
        if nesterov:
            upd = tree_map(
                lambda g, m, p: -lr * (_wd(g, p, weight_decay) + momentum * m),
                grads, mu, params)
        else:
            upd = tree_map(lambda m: -lr * m, mu)
        return upd, OptState(step=state.step + 1, mu=mu)

    return Optimizer(init, update)


def lars(momentum: float = 0.9, weight_decay: float = 1e-4,
         trust_coef: float = 0.001, eps: float = 1e-9) -> Optimizer:
    """LARS [You et al. '17], the paper's FCCS local policy (§3.4). Per-leaf
    trust ratio: lr_local = trust * ||w|| / (||g|| + wd*||w||), from this
    member's own block, each norm over the whole local tensor (the sketch
    heads' [R, B/P, D] block included, as the JAX package's norm of the
    flattened leaf)."""

    def init(params):
        return OptState(step=0, mu=_zeros_like_tree(params))

    def update(grads, state, params, lr):
        def new_m(g, m, p):
            g = _wd(g, p, weight_decay)
            wn = torch.linalg.vector_norm(p.float())
            gn = torch.linalg.vector_norm(g)
            trust = torch.where((wn > 0) & (gn > 0),
                                trust_coef * wn / (gn + eps),
                                torch.ones_like(wn))
            return momentum * m + (lr * trust) * g

        mu = tree_map(new_m, grads, state.mu, params)
        upd = tree_map(lambda m: -m, mu)
        return upd, OptState(step=state.step + 1, mu=mu)

    return Optimizer(init, update)


def adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        return OptState(step=0, mu=_zeros_like_tree(params),
                        nu=_zeros_like_tree(params))

    def update(grads, state, params, lr):
        t = state.step + 1
        # bias corrections in fp32, as the JAX package computes them
        c1 = 1 - torch.tensor(b1, dtype=torch.float32) ** t
        c2 = 1 - torch.tensor(b2, dtype=torch.float32) ** t
        mu = tree_map(
            lambda g, m, p: b1 * m + (1 - b1) * _wd(g, p, weight_decay),
            grads, state.mu, params)
        nu = tree_map(
            lambda g, v, p: b2 * v + (1 - b2) * _wd(g, p, weight_decay) ** 2,
            grads, state.nu, params)
        upd = tree_map(
            lambda m, v: -lr * (m / c1.to(m.device))
            / (torch.sqrt(v / c2.to(v.device)) + eps), mu, nu)
        return upd, OptState(step=t, mu=mu, nu=nu)

    return Optimizer(init, update)


def make_optimizer(cfg: TrainConfig) -> Optimizer:
    if cfg.optimizer == "sgd":
        return sgd(momentum=cfg.momentum, weight_decay=cfg.weight_decay)
    if cfg.optimizer == "lars":
        return lars(momentum=cfg.momentum, weight_decay=cfg.weight_decay)
    if cfg.optimizer == "adam":
        return adam(weight_decay=cfg.weight_decay)
    raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
