"""Minimal functional optimizers, written by hand on tensors: the port of
the JAX package's ``optim/optimizers.py`` (which has no optax either).

API, as there:
    opt = sgd(momentum=0.9) | lars(...) | adam(...)
    state = opt.init(params)
    updates, state = opt.update(grads, state, params, lr)
    params = apply_updates(params, updates)

and, what the trainers call, ``state = opt.update_(grads, state, params,
lr)``: the same values written into the params and the moments leaf by
leaf, so a step holds one leaf's transients, not whole new trees of the
moments, the updates and the params.

``params``, ``grads`` and the moments are trees of dicts, tuples and lists
over tensors (the trainer passes ``(fe_params, head_params)``). All states
are fp32, the paper's master-copy discipline. The arithmetic is the JAX
package's, expression for expression, so the two agree to fp32 rounding.

Inside the hybrid step each ring member updates its own row block of the
head, and LARS takes that member's LOCAL ``||w||`` and ``||g||`` (the JAX
update runs inside the shard_map body): the norms are never reduced over
the ring. The zoo's update runs on the JAX package's global arrays: on a
grid the step passes ``leaf_axes`` (each leaf's mesh axes, those its
spec splits it over) and LARS sums a split leaf's squares over them, the
norm of the whole leaf.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch import dist
from repro_torch.configs.base import TrainConfig


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[..., Any]  # (grads, state, params, lr) -> (updates, state)
    # (grads, state, params, lr) -> state, params and moments updated in
    # place leaf by leaf: the same values as ``update`` + ``apply_updates``
    update_: Callable[..., Any]


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


def _leaf_args(grads, moments, params):
    """(g, *moments, p) for each leaf, in ``tree_leaves`` order."""
    return zip(tree_leaves(grads), *map(tree_leaves, moments),
               tree_leaves(params))


def _rebuild(tree, leaves):
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def _axes_of(leaf_axes, n: int) -> list:
    return [()] * n if leaf_axes is None else list(leaf_axes)


def _tree_update(leaf_fn, grads, moments, params, lr, leaf_axes=None):
    """``leaf_fn(g, *moments, p, lr, axes) -> (new moments, update)`` over
    the trees: (new moment trees, the update tree)."""
    args_all = list(_leaf_args(grads, moments, params))
    outs = [leaf_fn(*args, lr, axes) for args, axes in
            zip(args_all, _axes_of(leaf_axes, len(args_all)))]
    new = tuple(_rebuild(m, [o[0][i] for o in outs])
                for i, m in enumerate(moments))
    return new, _rebuild(params, [o[1] for o in outs])


@torch.no_grad()
def _update_in_place(leaf_fn, grads, moments, params, lr,
                     leaf_axes=None) -> None:
    """The same arithmetic as ``_tree_update`` + ``apply_updates``, one
    leaf at a time, written into the moments and the params: the only
    transients are one leaf's."""
    args_all = list(_leaf_args(grads, moments, params))
    for args, axes in zip(args_all, _axes_of(leaf_axes, len(args_all))):
        ms, p = args[1:-1], args[-1]
        new_ms, u = leaf_fn(*args, lr, axes)
        for m, m_new in zip(ms, new_ms):
            m.copy_(m_new)
        p.copy_((p.float() + u).to(p.dtype))


def _optimizer(init, make_leaf, n_moments: int) -> Optimizer:
    """An optimizer from its per-leaf rule: ``make_leaf(t)`` is the rule of
    step ``t`` (adam's bias corrections depend on it)."""
    def moments(state):
        return (state.mu,) if n_moments == 1 else (state.mu, state.nu)

    def update(grads, state, params, lr, leaf_axes=None):
        t = state.step + 1
        new, upd = _tree_update(make_leaf(t), grads, moments(state), params,
                                lr, leaf_axes)
        return upd, OptState(step=t, mu=new[0],
                             nu=new[1] if n_moments == 2 else None)

    def update_(grads, state, params, lr, leaf_axes=None):
        t = state.step + 1
        _update_in_place(make_leaf(t), grads, moments(state), params, lr,
                         leaf_axes)
        return state._replace(step=t)

    return Optimizer(init, update, update_)


def sgd(momentum: float = 0.9, weight_decay: float = 0.0,
        nesterov: bool = False) -> Optimizer:
    def init(params):
        return OptState(step=0, mu=_zeros_like_tree(params))

    def leaf(g, m, p, lr, axes=()):
        m = momentum * m + _wd(g, p, weight_decay)
        if nesterov:
            return (m,), -lr * (_wd(g, p, weight_decay) + momentum * m)
        return (m,), -lr * m

    return _optimizer(init, lambda t: leaf, 1)


def lars(momentum: float = 0.9, weight_decay: float = 1e-4,
         trust_coef: float = 0.001, eps: float = 1e-9) -> Optimizer:
    """LARS [You et al. '17], the paper's FCCS local policy (§3.4). Per-leaf
    trust ratio: lr_local = trust * ||w|| / (||g|| + wd*||w||), from this
    member's own block, each norm over the whole local tensor (the sketch
    heads' [R, B/P, D] block included, as the JAX package's norm of the
    flattened leaf), or, for a leaf split over the mesh ``axes``, over the
    whole leaf: its squares summed over them (what GSPMD computes on the
    global array)."""

    def init(params):
        return OptState(step=0, mu=_zeros_like_tree(params))

    def norm(x, axes):
        if not axes:
            return torch.linalg.vector_norm(x)
        return torch.sqrt(dist.psum(x.square().sum(), axes))

    def leaf(g, m, p, lr, axes=()):
        g = _wd(g, p, weight_decay)
        wn = norm(p.float(), axes)
        gn = norm(g, axes)
        trust = torch.where((wn > 0) & (gn > 0),
                            trust_coef * wn / (gn + eps),
                            torch.ones_like(wn))
        m = momentum * m + (lr * trust) * g
        return (m,), -m

    return _optimizer(init, lambda t: leaf, 1)


def adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        return OptState(step=0, mu=_zeros_like_tree(params),
                        nu=_zeros_like_tree(params))

    def make_leaf(t):
        # bias corrections in fp32, as the JAX package computes them
        c1 = 1 - torch.tensor(b1, dtype=torch.float32) ** t
        c2 = 1 - torch.tensor(b2, dtype=torch.float32) ** t

        def leaf(g, m, v, p, lr, axes=()):
            g = _wd(g, p, weight_decay)
            m = b1 * m + (1 - b1) * g
            v = b2 * v + (1 - b2) * g ** 2
            u = -lr * (m / c1.to(m.device)) / (torch.sqrt(v / c2.to(v.device))
                                               + eps)
            return (m, v), u

        return leaf

    return _optimizer(init, make_leaf, 2)


def make_optimizer(cfg: TrainConfig) -> Optimizer:
    if cfg.optimizer == "sgd":
        return sgd(momentum=cfg.momentum, weight_decay=cfg.weight_decay)
    if cfg.optimizer == "lars":
        return lars(momentum=cfg.momentum, weight_decay=cfg.weight_decay)
    if cfg.optimizer == "adam":
        return adam(weight_decay=cfg.weight_decay)
    raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
