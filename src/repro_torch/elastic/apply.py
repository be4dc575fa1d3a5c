"""The snapshot-level reshards, one per trainer snapshot layout: the port
of the JAX package's ``elastic/apply.py``.

``reshard_paper_snapshot`` / ``reshard_zoo_snapshot`` take the host tree a
trainer's ``_snapshot()`` template restored from disk, the head, and the
src/dst geometries, and return ``(tree, needs_refresh, CommLedger)``: the tree rewritten for the
dst ring, whether the trainer must run the head's own refresh afterwards
(the fallback for aux with no exact re-pack rule), and an itemized
"reshard"-kind ledger of the bytes a multi-host reshard would move. The
head-specific work goes through the ``SoftmaxHead.reshard_state`` /
``reshard_params_like`` seam (``repro_torch.api.heads``).
"""
from __future__ import annotations

from typing import Tuple

from repro_torch.elastic.plan import (MeshGeometry, ReshardPlan, plan_reshard,
                                      validate_geometry)
from repro_torch.elastic.reshard import (leaf_bytes, redistribute_dgc,
                                         resize_vocab_rows, tree_bytes)
from repro_torch.optim import tree_leaves, tree_map
from repro_torch.telemetry.ledger import CommLedger


def _aux_changed(old_aux, new_aux) -> bool:
    old_leaves, new_leaves = tree_leaves(old_aux), tree_leaves(new_aux)
    return any(a is not b for a, b in zip(old_leaves, new_leaves)) \
        or len(old_leaves) != len(new_leaves)


def _account_head(led: CommLedger, head, old_head_tree, new_head_tree,
                  plan: ReshardPlan) -> None:
    """Dense [V, D] params move only the plan's displaced rows; re-bucketed
    sketch params and re-packed aux are re-laid-out wholesale, so their
    full payload counts."""
    old_p, new_p = old_head_tree["params"], new_head_tree["params"]
    if tree_leaves(old_p):
        if head.params_are_class_weights:
            row = leaf_bytes(old_p) // max(1, plan.n_rows)
            led.add("reshard", "head.params", plan.bytes_moved(row))
        elif _aux_changed(old_p, new_p):
            led.add("reshard", "head.params", tree_bytes(new_p))
    if _aux_changed(old_head_tree["aux"], new_head_tree["aux"]):
        led.add("reshard", "head.aux", tree_bytes(new_head_tree["aux"]))


def _reshard_moments(opt, head, src, dst, plan, led: CommLedger, *,
                     model_leaf_fn=None):
    """The moments mirror (trunk params, head params): the trunk's are
    replicated and kept (paper) or resized like the model (zoo, through
    ``model_leaf_fn``); the head's get the head's own params
    transform."""
    def fix(moment):
        if moment is None:
            return None
        trunk_m, hp_m = moment
        if model_leaf_fn is not None:
            trunk_m = tree_map(model_leaf_fn, trunk_m)
        if tree_leaves(hp_m):
            new_hp = tree_map(
                lambda a: head.reshard_params_like(a, src, dst), hp_m)
            if head.params_are_class_weights:
                row = tree_bytes(hp_m) // max(1, plan.n_rows)
                led.add("reshard", "opt.moments", plan.bytes_moved(row))
            elif _aux_changed(hp_m, new_hp):
                led.add("reshard", "opt.moments", tree_bytes(new_hp))
            hp_m = new_hp
        return (trunk_m, hp_m)

    return type(opt)(step=opt.step, mu=fix(opt.mu),
                     nu=fix(getattr(opt, "nu", None)))


def reshard_paper_snapshot(tree: dict, head, src: MeshGeometry,
                           dst: MeshGeometry
                           ) -> Tuple[dict, bool, CommLedger]:
    """Rewrite a paper-trainer snapshot (fe / head / opt / dgc / extra)
    for the dst ring. FE params are replicated (untouched); class-weight
    rows are global in the snapshot, so only the head's aux, the sketch
    buckets, the moment mirrors and the DGC worker buffers change
    layout."""
    validate_geometry(src, dst, reshard=True)
    plan = plan_reshard(src, dst)
    led = CommLedger()
    out = dict(tree)
    new_head, needs_refresh = head.reshard_state(tree["head"], src, dst)
    _account_head(led, head, tree["head"], new_head, plan)
    out["head"] = new_head
    out["opt"] = _reshard_moments(tree["opt"], head, src, dst, plan, led)
    if "dgc" in tree:
        out["dgc"] = redistribute_dgc(tree["dgc"], dst.n_model)
        led.add("reshard", "dgc.error_feedback", tree_bytes(out["dgc"]))
    return out, needs_refresh, led


def reshard_zoo_snapshot(tree: dict, head, model_cfg, src: MeshGeometry,
                         dst: MeshGeometry, *, padded_vocab_src: int
                         ) -> Tuple[dict, bool, CommLedger]:
    """Rewrite a zoo snapshot (model / head / opt / extra) for the dst
    ring: vocab-leading model leaves (the embedding table, an untied head)
    and their moments are re-padded when the dst ring implies another
    padded vocab (``padded_vocab_src`` is the checkpoint's, from its
    meta), and the head and its moments go through the same seam as the
    paper path."""
    validate_geometry(src, dst, reshard=True)
    v_dst = model_cfg.vocab_size
    n_real = int(model_cfg.real_vocab_size or model_cfg.vocab_size)
    plan = plan_reshard(src, dst, v_dst)
    led = CommLedger()

    def fix_model_leaf(a):
        if padded_vocab_src != v_dst and getattr(a, "shape", ()) \
                and a.shape[0] == padded_vocab_src:
            out = resize_vocab_rows(a, padded_vocab_src, v_dst,
                                    n_real=n_real)
            led.add("reshard", "model.vocab_pad",
                    abs(leaf_bytes(out) - leaf_bytes(a)))
            return out
        return a

    out = dict(tree)
    out["model"] = tree_map(fix_model_leaf, tree["model"])
    new_head, needs_refresh = head.reshard_state(tree["head"], src, dst)
    _account_head(led, head, tree["head"], new_head, plan)
    out["head"] = new_head
    out["opt"] = _reshard_moments(tree["opt"], head, src, dst, plan, led,
                                  model_leaf_fn=fix_model_leaf)
    return out, needs_refresh, led


def analytic_reshard_ledger(src: MeshGeometry, dst: MeshGeometry, *,
                            row_bytes: int,
                            n_moment_trees: int = 1) -> CommLedger:
    """The dense-head reshard traffic a (src -> dst) move implies, without
    materializing any state."""
    plan = plan_reshard(src, dst)
    led = CommLedger()
    led.add("reshard", "head.params", plan.bytes_moved(row_bytes))
    if n_moment_trees:
        led.add("reshard", "opt.moments",
                plan.bytes_moved(row_bytes) * n_moment_trees)
    return led
