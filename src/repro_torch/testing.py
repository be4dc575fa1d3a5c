"""Parity workers: what each member of a ring or a grid runs when the port
is held against the JAX package on the same numpy arrays.

``repro_torch.dist.spawn_ring`` (and ``spawn_grid``, which lays the same
``file://`` rendezvous out as a (data, model) grid before a worker runs)
re-imports a worker by name in fresh processes, so workers live here
rather than in test files. Each takes
numpy arrays and plain dicts (the GLOBAL class matrix; every member keeps
its own row block) and returns numpy arrays, so the caller can compare
them with the JAX package's shard_map results directly. Both run on the
CPU.

Beside them, the gates that hold the CE kernels to their plain versions
on the card (``ce_forward_gate``, ``ce_backward_gate`` for the dense pair,
``sparse_ce_forward_gate``, ``sparse_ce_backward_gate`` for the sparse
one), and a plain-torch emulation of TF32 products (``tf32_round``,
``ce_forward_tf32``, ``ce_backward_tf32``, ``sparse_ce_forward_tf32``,
``sparse_ce_backward_tf32``): with 3xTF32 products, as the kernels take
them, the gates pass; with 1xTF32 products they must fail. The CPU tests
and ``chip_smoke.py`` run both through the same gates.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch import dist
from repro_torch.core import sharded_softmax as ss
from repro_torch.data import synthetic

BACKENDS = ("ref", "kernel")


def _np(t):
    return t.detach().cpu().numpy()


def _my_rows(w: np.ndarray, axis: int = 0) -> torch.Tensor:
    """This member's block of ``w`` along ``axis`` (0: class rows; 1: the
    buckets of an [R, B, D] sketch)."""
    n = w.shape[axis] // dist.world_size()
    r = dist.rank()
    return torch.from_numpy(np.ascontiguousarray(
        np.take(w, np.arange(r * n, (r + 1) * n), axis=axis)))


def serve_bodies(f: np.ndarray, w: np.ndarray, *, k: int, n_queries: int,
                 n_valid: int = 0, chunk: int = 2048) -> dict:
    """Every serve body of ``core.sharded_softmax`` on this member's rows
    of ``w``, with the queries ``f`` on every member. ``logits`` is the
    [b, V] matrix gathered over the ring."""
    ft, wt = torch.from_numpy(f), _my_rows(w)
    out = {"argmax": _np(ss.serve_argmax_local(ft, wt, n_valid=n_valid)[0])}
    ids, logits = ss.serve_logits_local(ft, wt, n_valid=n_valid)
    out["logits_ids"] = _np(ids)
    out["logits"] = _np(dist.all_gather(logits, dim=1))
    for b in BACKENDS:
        vals, gids = ss.serve_topk_local(ft, wt, k, n_valid=n_valid,
                                         backend=b, chunk=chunk)
        out[f"topk_{b}"] = (_np(vals), _np(gids))
        vals, gids = ss.serve_topk_batched_local(
            ft, wt, k, n_queries, n_valid=n_valid, backend=b, chunk=chunk)
        out[f"batched_{b}"] = (_np(vals), _np(gids))
    return out


def paper_serve(head_cfg: dict, w: np.ndarray, inputs: np.ndarray,
                queries: np.ndarray, *, top_k: int) -> dict:
    """A CPU ``PaperExperiment`` on this member, serving the JAX package's
    class matrix ``w`` (carried over by ``interop``): greedy and top-k on
    explicit ``inputs``, then the same through the serving engine for
    ``queries`` submitted one by one."""
    exp = _cpu_experiment(head_cfg, w)
    out = {"greedy": exp.serve({"features": inputs})}
    out["topk_ids"], out["topk_scores"] = exp.serve(
        {"features": inputs}, top_k=top_k, return_scores=True)
    for key, k in (("engine_greedy", None), ("engine_topk", top_k)):
        eng = exp.serving_engine(top_k=k, max_batch=8)
        for q in queries:
            eng.submit(q)
        done = sorted(eng.drain(), key=lambda r: r.rid)
        out[key] = np.stack([r.ids for r in done])
        if k is not None:
            out[key + "_scores"] = np.stack([r.scores for r in done])
        out[key + "_buckets"] = sorted({r.bucket for r in done})
    return out


def numpy_batch(t: int, b: int, *, classes: int, dim: int,
                seed: int = 0) -> dict:
    """A deterministic training batch for step ``t`` of ``b`` rows, made
    with numpy so both packages can be fed the same arrays: noisy unit
    prototypes of random classes."""
    protos = np.random.default_rng(seed).standard_normal(
        (classes, dim)).astype(np.float32)
    protos /= np.linalg.norm(protos, axis=1, keepdims=True)
    rng = np.random.default_rng((seed + 1) * 1_000_003 + t)
    labels = rng.integers(0, classes, b).astype(np.int32)
    noise = rng.standard_normal((b, dim)).astype(np.float32)
    return {"features": protos[labels] + np.float32(0.3) * noise,
            "labels": labels}


def step_collectives(cases: list, *, classes: int, batch: int,
                     feat_dim: int, hw: int) -> list:
    """One hybrid train step on this member for each ``(trunk, head,
    backend, n_micro)`` case, its collectives counted at the ``dist``
    wrappers (``dist.count_collectives``). The state is fresh (the knn
    head's warm-start graph) and the batch ``numpy_batch`` /
    ``numpy_image_batch`` at step 0. Returns each case's counts."""
    from repro_torch.api.heads import make_head
    from repro_torch.api.experiment import paper_model_config
    from repro_torch.configs.base import HeadConfig, TrainConfig
    from repro_torch.train import hybrid

    out = []
    for trunk, head, backend, n_micro in cases:
        mcfg = paper_model_config(trunk, classes, feat_dim)
        hcfg = HeadConfig(softmax_impl=head, backend=backend,
                          active_frac=0.1)
        tcfg = TrainConfig(optimizer="sgd")
        h = make_head(mcfg, hcfg)
        state = hybrid.init_state(torch.Generator().manual_seed(0), mcfg,
                                  hcfg, tcfg, dist.world_size(),
                                  rank=dist.rank(), device="cpu", head=h)
        data = (numpy_image_batch(0, batch, classes=classes, hw=hw)
                if trunk == "cnn" else
                numpy_batch(0, batch, classes=classes, dim=feat_dim))
        inputs = {k: torch.from_numpy(v) for k, v in data.items()}
        step = hybrid.make_train_step(mcfg, hcfg, tcfg, n_micro=n_micro,
                                      head=h)
        with dist.count_collectives() as counts:
            step(state, inputs, 0.1)
        out.append(dict(counts))
    return out


def _schedule_recorder(head, log: list):
    """Record ("fe",) at each feature-extractor forward and ("head",) at
    each head loss into ``log`` (beside ``dist.record_async``'s
    events); returns the function that undoes it."""
    from repro_torch.train import hybrid
    features, loss_local = hybrid._features, head.loss_local

    def fe(*a, **kw):
        log.append(("fe",))
        return features(*a, **kw)

    def loss(*a, **kw):
        log.append(("head",))
        return loss_local(*a, **kw)

    def undo():
        hybrid._features = features
        del head.loss_local          # the class's method again

    hybrid._features, head.loss_local = fe, loss
    return undo


def pipeline_schedules(cases: list, *, classes: int, batch: int,
                       feat_dim: int, hw: int, steps: int = 2) -> list:
    """The paper step's two schedules on this member, for each ``(trunk,
    head, n_micro, dgc)`` case, from two states made alike from seed 0 on
    ``numpy_batch`` / ``numpy_image_batch`` data: one micro-batched value
    and gradient each (``hybrid.make_value_and_grad``, overlap off and on),
    with their collectives counted and the pipelined one's schedule
    recorded (``dist.record_async`` and ``_schedule_recorder``), then
    ``steps`` train steps each. Returns, for each case, the paths of the
    loss, metrics, gradient leaves and next-state leaves whose bits differ
    between the two (``resilience.tree_compare``), both collective
    counts, the schedule and the losses."""
    from repro_torch.api.experiment import paper_model_config
    from repro_torch.api.heads import make_head
    from repro_torch.configs.base import DGCConfig, HeadConfig, TrainConfig
    from repro_torch.optim import tree_leaves
    from repro_torch.resilience import tree_compare
    from repro_torch.train import hybrid

    def data(trunk, t):
        d = (numpy_image_batch(t, batch, classes=classes, hw=hw)
             if trunk == "cnn" else
             numpy_batch(t, batch, classes=classes, dim=feat_dim))
        return {k: torch.from_numpy(v) for k, v in d.items()}

    def unequal(prefix, a, b):
        return [f"{prefix} {p}" for p in tree_compare(a, b)["mismatches"]]

    out = []
    for trunk, head_name, n_micro, dgc in cases:
        mcfg = paper_model_config(trunk, classes, feat_dim)
        hcfg = HeadConfig(softmax_impl=head_name, backend="ref",
                          active_frac=0.5)
        tcfg = TrainConfig(optimizer="lars", dgc=DGCConfig(
            enabled=dgc, sparsity=0.9, chunk=256))
        head = make_head(mcfg, hcfg)
        states = [hybrid.init_state(torch.Generator().manual_seed(0), mcfg,
                                    hcfg, tcfg, dist.world_size(),
                                    rank=dist.rank(), device="cpu",
                                    head=head) for _ in range(2)]
        local = {k: hybrid._local_rows(v) for k, v in data(trunk, 0).items()}
        res, counts = [], []
        for overlap, st in zip((False, True), states):
            vg = hybrid.make_value_and_grad(mcfg, head, n_micro=n_micro,
                                            overlap=overlap)
            with dist.count_collectives() as c, dist.record_async() as log:
                undo = _schedule_recorder(head, log)
                try:
                    res.append(vg(st, local))
                finally:
                    undo()
            counts.append(dict(c))
        (la, ma), ga = res[0]
        (lb, mb), gb = res[1]
        diff = unequal("loss", la, lb) + unequal("grad", ga, gb)
        diff += unequal("metrics", ma, mb)
        losses = []
        for overlap, st in zip((False, True), states):
            step = hybrid.make_train_step(mcfg, hcfg, tcfg, n_micro=n_micro,
                                          head=head, overlap=overlap)
            run = []
            for t in range(steps):
                st, loss, _ = step(st, data(trunk, t), 0.1)
                run.append(loss)
            losses.append(run)
            states[overlap] = st
        a, b = states
        diff += unequal("step loss", losses[0], losses[1])
        diff += unequal("next state", (a.fe_params, a.head_params,
                                       a.opt_state, a.dgc),
                        (b.fe_params, b.head_params, b.opt_state, b.dgc))
        out.append({"unequal": diff, "counts": counts, "schedule": log,
                    "losses": [float(x) for x in losses[1]],
                    "n_grad_leaves": len(tree_leaves(ga))})
    return out


def numpy_image_batch(t: int, b: int, *, classes: int, hw: int,
                      seed: int = 0) -> dict:
    """A deterministic image batch for step ``t`` of ``b`` rows, made with
    numpy so both packages can be fed the same arrays: the synthetic
    stream's per-class pattern (``data.synthetic.class_pattern``) plus
    noise. {"images": [b, hw, hw, 3] fp32, "labels": [b] int32}."""
    rng = np.random.default_rng((seed + 3) * 1_000_003 + t)
    labels = rng.integers(0, classes, b).astype(np.int32)
    base = synthetic.class_pattern(torch.from_numpy(labels), hw).numpy()
    noise = rng.standard_normal(base.shape)
    return {"images": (base + 0.3 * noise).astype(np.float32),
            "labels": labels}


def loss_body(f: np.ndarray, y: np.ndarray, w: np.ndarray, *,
              cosine_scale: float, n_valid: int, backend: str) -> dict:
    """``full_softmax_local`` on this member's rows of ``w`` with the
    batch ``f``, ``y`` on every member: loss, metrics and the head
    gradient (gathered over the ring, [V, D])."""
    wt = _my_rows(w).requires_grad_(True)
    loss, metrics = ss.full_softmax_local(
        torch.from_numpy(f), torch.from_numpy(y), wt,
        global_batch=f.shape[0], cosine_scale=cosine_scale,
        n_valid=n_valid, backend=backend)
    loss.backward()
    return {"loss": _np(loss), **{k: _np(v) for k, v in metrics.items()},
            "grad": _np(dist.all_gather(wt.grad, dim=0))}


def paper_fit(head_cfg: dict, train_cfg: dict, fccs_cfg: dict,
              w0: np.ndarray, mu0: np.ndarray, *, steps: int, batch: int,
              eval_inputs: dict, data_seed: int = 0, head_aux=(),
              classes: int = 0, draws=None) -> dict:
    """A CPU ``PaperExperiment`` on this member, started from the JAX
    package's head params and LARS/SGD moment and its aux state (the knn
    graph, the LSH tables, the sketch hashes; ``interop``, laid out by the
    head's ``aux_spec``), trained ``steps`` steps with FCCS batch growth on
    ``numpy_batch`` data. ``classes`` is the class count (default: the rows
    of the [V, D] ``w0``; the sketch heads' [R, B, D] params do not give
    it). ``draws`` maps a sampled draw's salt (``baselines.sampled_salt``)
    to the JAX package's draw for each member, which then replaces the
    port's own. Returns the history rows, the final head params gathered
    over the ring, the evaluation accuracy, the weights_version trail and
    the head's final aux state."""
    from repro_torch import interop
    from repro_torch.api import Experiment
    from repro_torch.configs.base import FCCSConfig, TrainConfig

    v, d = classes or w0.shape[0], w0.shape[-1]
    cfg = interop.head_config_from_dict(head_cfg)
    tcfg = TrainConfig(**train_cfg, fccs=FCCSConfig(**fccs_cfg))
    exp = Experiment.from_config(
        system="paper", classes=v, feat_dim=d, batch=batch, head=cfg,
        train=tcfg, device="cpu", log_every=0,
        data_fn=lambda t, b: numpy_batch(t, b, classes=v, dim=d,
                                         seed=data_seed))
    exp.load_state(interop.paper_state_from_numpy(
        {}, w0, opt_state={"step": 0, "mu": ({}, mu0), "nu": None},
        head_aux=head_aux, aux_spec=exp.head.aux_spec(), rank=dist.rank(),
        world_size=dist.world_size(), device="cpu"))
    if draws is not None:
        exp.head.draw = _injected_draw(draws)
    versions = [exp.weights_version]
    hist = exp.fit(steps, use_fccs_batch=True,
                   step_hook=lambda t: versions.append(exp.weights_version))
    axis = 0 if exp.head.params_are_class_weights else 1
    return {"history": hist,
            "w": _np(dist.all_gather(exp.state.w_head, dim=axis)),
            "eval": exp.evaluate(eval_inputs),
            "versions": versions + [exp.weights_version],
            "aux": [_np(a) for a in exp.state.head_aux]}


def _draw_tensors(d):
    """A draw given as numpy arrays (ids, valid, logq, logq_y,
    sample_frac), as tensors."""
    from repro_torch.core import baselines as bl
    return bl.SampledDraw(*(torch.from_numpy(np.asarray(a)) for a in d))


def _injected_draw(draws: dict):
    """A sampled head's ``draw`` that returns, for each micro-batch, the
    JAX package's draw of this member keyed by its salt."""
    from repro_torch.core import baselines as bl

    def draw(y_all, v_loc, step=None):
        return _draw_tensors(draws[bl.sampled_salt(y_all, step)][
            dist.rank()])
    return draw


# ---------------------------------------------------------------------------
# the selective, MACH, sampled and CSoft heads' bodies
# ---------------------------------------------------------------------------


def head_loss_body(kind: str, f: np.ndarray, y: np.ndarray, w: np.ndarray,
                   aux, *, backend: str, **kw) -> dict:
    """A baseline head's loss body on this member, with the batch ``f``,
    ``y`` on every member and the GLOBAL head params ``w`` (its rows, or
    for ``kind="mach"`` the buckets of [R, B, D]): ``selective`` takes
    ``aux`` = (planes, offsets [P, ...], classes [P, ...]), ``mach`` the
    hashes [R, N], ``sampled`` each member's draw (a list of P tuples of
    arrays); ``kw`` goes to the body. Returns loss, metrics, the head
    gradient gathered over the ring and the feature gradient stacked over
    the ring [P, b, D]."""
    from repro_torch.core import baselines as bl
    r = dist.rank()
    axis = 1 if kind == "mach" else 0
    wt = _my_rows(w, axis).requires_grad_(True)
    ft = torch.from_numpy(f).requires_grad_(True)
    yt = torch.from_numpy(y)
    if kind == "selective":
        planes, offsets, classes = aux
        loss, metrics = bl.selective_softmax_local(
            ft, yt, wt, torch.from_numpy(planes),
            torch.from_numpy(np.ascontiguousarray(offsets[r])),
            torch.from_numpy(np.ascontiguousarray(classes[r])),
            global_batch=f.shape[0], backend=backend, **kw)
    elif kind == "mach":
        loss, metrics = bl.mach_softmax_local(
            ft, yt, wt, torch.from_numpy(aux), global_batch=f.shape[0],
            backend=backend)
    elif kind == "sampled":
        loss, metrics = bl.sampled_softmax_loss(
            ft, yt, wt, _draw_tensors(aux[r]), global_batch=f.shape[0],
            backend=backend, **kw)
    else:
        raise ValueError(f"unknown head body {kind!r}")
    loss.backward()
    return {"loss": _np(loss), **{k: _np(v) for k, v in metrics.items()},
            "grad": _np(dist.all_gather(wt.grad, dim=axis)),
            "grad_f": _np(dist.all_gather(ft.grad, dim=0, tiled=False))}


def sketch_predict(f: np.ndarray, w: np.ndarray, hashes: np.ndarray) -> dict:
    """``mach_predict_local`` and ``csoft_predict_local`` (min and mean) on
    this member's buckets of the GLOBAL sketch ``w`` [R, B, D]."""
    from repro_torch.core import baselines as bl
    ft, wt, ht = torch.from_numpy(f), _my_rows(w, 1), torch.from_numpy(hashes)
    return {"mach": _np(bl.mach_predict_local(ft, wt, ht)),
            **{f"csoft_{agg}": _np(bl.csoft_predict_local(ft, wt, ht,
                                                          agg=agg))
               for agg in ("min", "mean")}}


def sampled_draws(y: np.ndarray, *, v_loc: int, n_samples: int, seed: int,
                  steps: tuple) -> dict:
    """The port's own draws on this member for the labels ``y``: each
    distribution at each step, twice (to show that a draw repeats), and at
    the labels shifted by one."""
    from repro_torch.core import baselines as bl
    yt = torch.from_numpy(y)
    out = {}
    for dist_name in ("uniform", "log_uniform"):
        kw = dict(v_loc=v_loc, n_samples=n_samples, distribution=dist_name,
                  seed=seed)
        for step in steps:
            a = bl.sampled_draw(yt, step=step, **kw)
            b = bl.sampled_draw(yt, step=step, **kw)
            out[(dist_name, step)] = [_np(t) for t in a]
            out[(dist_name, step, "again")] = [_np(t) for t in b]
        out[(dist_name, "shifted")] = [
            _np(t) for t in bl.sampled_draw(yt + 1, step=steps[0], **kw)]
    return out


def sampled_full_draw(f: np.ndarray, y: np.ndarray, w: np.ndarray, *,
                      backend: str) -> dict:
    """The sampled body with uniform draws of every class (``n_samples``
    = V) beside ``full_softmax_local`` on this member's rows: loss and
    head gradient of each, gathered over the ring."""
    from repro_torch.core import baselines as bl
    out = {}
    for name in ("sampled", "full"):
        wt = _my_rows(w).requires_grad_(True)
        ft, yt = torch.from_numpy(f), torch.from_numpy(y)
        if name == "sampled":
            loss, metrics = bl.sampled_softmax_local(
                ft, yt, wt, global_batch=f.shape[0], n_samples=w.shape[0],
                distribution="uniform", step=3, backend=backend)
            out["sample_frac"] = _np(metrics["sample_frac"])
        else:
            loss, _ = ss.full_softmax_local(ft, yt, wt,
                                            global_batch=f.shape[0],
                                            cosine_scale=16.0,
                                            backend=backend)
        loss.backward()
        out[name] = (_np(loss), _np(dist.all_gather(wt.grad, dim=0)))
    return out


def selective_refresh(w: np.ndarray, head_cfg: dict) -> dict:
    """The selective head's ``refresh`` on this member's rows of ``w``:
    its tables, and those that ``build_sharded_lsh_tables`` makes from the
    same rows through the refresh's planes."""
    from repro_torch import interop
    from repro_torch.api.experiment import paper_model_config
    from repro_torch.api.heads import HeadState, make_head
    from repro_torch.core import baselines as bl
    head = make_head(paper_model_config("feats", w.shape[0], w.shape[1]),
                     interop.head_config_from_dict(head_cfg))
    wt = _my_rows(w)
    planes, offsets, classes = head.refresh(HeadState(wt, ())).aux
    rebuilt = bl.build_sharded_lsh_tables(wt, planes)
    return {"planes": _np(planes), "offsets": _np(offsets),
            "classes": _np(classes), "rebuilt": [_np(t) for t in rebuilt]}


def knn_graph_build(w: np.ndarray, *, k: int, kprime: int) -> np.ndarray:
    """The ring build of the exact KNN graph of ``w`` from this member's
    rows: the whole [N, k] graph, as every member holds it."""
    from repro_torch.core import knn_graph as kg
    return kg.build_graph(_my_rows(w), k=k, kprime=kprime)


def knn_loss_body(f: np.ndarray, y: np.ndarray, w: np.ndarray, graph: tuple,
                  *, m_local: int, k_cap: int, backend: str,
                  pad_random: bool = False, fillers=None) -> dict:
    """``knn_softmax_local`` on this member's rows of ``w`` and of the
    compressed ``graph`` arrays ([P, ...] each), with the batch ``f``, ``y``
    on every member; ``fillers`` [P, m_local] are the pad draws to inject.
    Returns loss, metrics, the head gradient gathered over the ring [V, D]
    and this member's feature gradient stacked over the ring [P, b, D]."""
    from repro_torch.core.knn_softmax import knn_softmax_local
    r = dist.rank()
    wt = _my_rows(w).requires_grad_(True)
    ft = torch.from_numpy(f).requires_grad_(True)
    aux = [torch.from_numpy(np.ascontiguousarray(a[r])) for a in graph]
    loss, metrics = knn_softmax_local(
        ft, torch.from_numpy(y), wt, *aux, global_batch=f.shape[0],
        m_local=m_local, k_cap=k_cap, pad_random=pad_random, backend=backend,
        fillers=None if fillers is None else torch.from_numpy(fillers[r]))
    loss.backward()
    return {"loss": _np(loss), **{k: _np(v) for k, v in metrics.items()},
            "grad": _np(dist.all_gather(wt.grad, dim=0)),
            "grad_f": _np(dist.all_gather(ft.grad, dim=0, tiled=False))}


def _np_tree(tree):
    from repro_torch.optim import tree_map
    return tree_map(_np, tree)


def dgc_rounds(grads: list, dgc_cfg: dict) -> list:
    """``core.sparsify.dgc_exchange`` on this member for each round of
    ``grads`` (a list of rounds, each a list of one gradient tree per
    member), the state carried from round to round. Returns each round's
    update, u, v and info as numpy."""
    from repro_torch.configs.base import DGCConfig
    from repro_torch.core import sparsify as sp
    from repro_torch.optim import tree_map

    cfg = DGCConfig(**dgc_cfg)
    mine = [tree_map(torch.from_numpy, g[dist.rank()]) for g in grads]
    state = sp.init_dgc_state(mine[0])
    out = []
    for g in mine:
        upd, state, info = sp.dgc_exchange(g, state, cfg,
                                           n_workers=dist.world_size())
        out.append({"update": _np_tree(upd), "u": _np_tree(state.u),
                    "v": _np_tree(state.v),
                    **{k: _np(v) for k, v in info.items()}})
    return out


def cnn_fit(init: dict, head_cfg: dict, train_cfg: dict, *, steps: int,
            batch: int, classes: int, hw: int) -> dict:
    """A CPU ``PaperExperiment`` of the reduced SKU ResNet (``trunk="cnn"``)
    on this member, started from the JAX experiment's state (``init``:
    ``fe``, ``w0``, ``mu`` = (fe moments, head moment), and ``dgc`` = {"u",
    "v"} with the ring axis, or None) through ``interop``, trained
    ``steps`` steps with FCCS batch growth on ``numpy_image_batch`` data.
    ``train_cfg`` holds ``TrainConfig``'s fields with ``fccs`` and ``dgc``
    as dicts. Returns the history rows, the final head params gathered over
    the ring, the final FE params and DGC v of this member."""
    from repro_torch import interop
    from repro_torch.api import Experiment
    from repro_torch.configs.base import DGCConfig, FCCSConfig, TrainConfig

    tcfg = dict(train_cfg)
    tcfg = TrainConfig(**{**tcfg, "fccs": FCCSConfig(**tcfg["fccs"]),
                          "dgc": DGCConfig(**tcfg["dgc"])})
    exp = Experiment.from_config(
        system="paper", trunk="cnn", classes=classes, batch=batch,
        head=interop.head_config_from_dict(head_cfg), train=tcfg,
        device="cpu", log_every=0,
        data_fn=lambda t, b: numpy_image_batch(t, b, classes=classes, hw=hw))
    exp.load_state(interop.paper_state_from_numpy(
        init["fe"], init["w0"],
        opt_state={"step": 0, "mu": init["mu"], "nu": None},
        dgc=init["dgc"], rank=dist.rank(), world_size=dist.world_size(),
        device="cpu"))
    hist = exp.fit(steps, use_fccs_batch=True)
    dgc = exp.state.dgc
    return {"history": hist,
            "w": _np(dist.all_gather(exp.state.w_head, dim=0)),
            "fe": _np_tree(exp.state.fe_params),
            "v": None if dgc is None else _np_tree(dgc.v)}


def cnn_serve(init: dict, head_cfg: dict, *, classes: int, images,
              labels, k: int) -> dict:
    """Evaluation and serving of the reduced SKU ResNet on this member from
    the JAX experiment's state: ``evaluate`` on (images, labels), greedy and
    top-k ``serve`` on the explicit images, and both through a serving
    engine (each image a query, padded micro-batches of 4)."""
    from repro_torch import interop
    from repro_torch.api import Experiment

    exp = Experiment.from_config(
        system="paper", trunk="cnn", classes=classes, batch=images.shape[0],
        head=interop.head_config_from_dict(head_cfg), device="cpu",
        log_every=0)
    exp.load_state(interop.paper_state_from_numpy(
        init["fe"], init["w0"], rank=dist.rank(),
        world_size=dist.world_size(), device="cpu"))
    inputs = {"images": images, "labels": labels}
    out = {"eval": exp.evaluate(inputs), "greedy": exp.serve(inputs),
           "topk": exp.serve(inputs, top_k=k, return_scores=True)}
    for name, top_k in (("engine_greedy", None), ("engine_topk", k)):
        eng = exp.serving_engine(top_k=top_k, max_batch=4, max_wait_ms=0.0,
                                 cache=None)
        for q in images:
            eng.submit(q)
        done = sorted(eng.drain(), key=lambda r: r.rid)
        out[name] = (np.stack([r.ids for r in done]),
                     None if top_k is None
                     else np.stack([r.scores for r in done]))
    return out


def collectives() -> dict:
    """Each collective of ``dist`` on rank-dependent tensors."""
    r = dist.rank()
    x = torch.tensor([r, 10 - r], dtype=torch.float32)
    return {"rank": r, "world_size": dist.world_size(),
            "axis_index": dist.flat_axis_index(),
            "pmax": _np(dist.pmax(x)), "pmin": _np(dist.pmin(x)),
            "psum": _np(dist.psum(x)),
            "gather_tiled": _np(dist.all_gather(x[None], dim=0)),
            "gather_stacked": _np(dist.all_gather(x, dim=1, tiled=False))}


def ring_shift() -> dict:
    """``ppermute`` by one and by two places of a rank-dependent bf16
    tensor, and ``pmean`` of the rank."""
    r = dist.rank()
    x = torch.full((2, 3), float(r), dtype=torch.bfloat16)
    return {"shift1": _np(dist.ppermute(x).float()),
            "shift2": _np(dist.ppermute(x, 2).float()),
            "pmean": _np(dist.pmean(torch.tensor(float(r))))}


def collective_grads() -> dict:
    """Gradients through ``psum`` and ``all_gather`` on rank-dependent
    tensors, and the absence of one through ``pmax`` / ``pmin``."""
    r = dist.rank()
    x = torch.tensor([1.0 + r, 2.0], requires_grad=True)
    (dist.psum(x * x).sum() + (dist.all_gather(x[None] * (r + 1), dim=0)
                               ** 2).sum()).backward()
    mx = dist.pmax(x)
    return {"grad": _np(x.grad), "pmax_requires_grad": mx.requires_grad,
            "pmin_requires_grad": dist.pmin(x).requires_grad}


def clustered_weights(classes: int, dim: int, *, offset: float = 0.3,
                      seed: int = 0, device="cpu", block: int = 1 << 16):
    """Tight clustered unit class rows [classes, dim] (a stand-in for a
    converged cosine head, which the IVF quantizer needs structure to
    index): ``classes // 64`` unit centres, each row a random centre plus
    Gaussian noise of norm about ``offset``, renormalised. The JAX
    package's ``tests/test_ivf_index.py`` construction, drawn with a torch
    generator on ``device``, ``block`` rows at a time."""
    from repro_torch.core.sharded_softmax import _normalize
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    n_cent = max(2, classes // 64)
    centers = _normalize(torch.randn((n_cent, dim), generator=g,
                                     device=device))
    which = torch.randint(0, n_cent, (classes,), generator=g, device=device)
    out = torch.empty((classes, dim), device=device)
    for r0 in range(0, classes, block):
        r1 = min(classes, r0 + block)
        noise = torch.randn((r1 - r0, dim), generator=g, device=device)
        out[r0:r1] = _normalize(centers[which[r0:r1]]
                                + noise * (offset / dim ** 0.5))
    return out


def query_pool(protos, n: int, *, noise: float = 0.1, seed: int = 1):
    """n queries near random rows of ``protos``: the row plus Gaussian
    noise of norm about ``noise`` (``tests/test_ivf_index.py``'s pool)."""
    g = torch.Generator(device=protos.device)
    g.manual_seed(seed)
    labels = torch.randint(0, protos.shape[0], (n,), generator=g,
                           device=protos.device)
    d = protos.shape[1]
    return protos[labels] + torch.randn((n, d), generator=g,
                                        device=protos.device) * (
                                            noise / d ** 0.5)


def _cpu_experiment(head_cfg: dict, w: np.ndarray, n_valid: int = 0):
    """A CPU ``PaperExperiment`` on this member serving the GLOBAL class
    matrix ``w`` (its row block), with ``n_valid`` real classes (0: all)."""
    import dataclasses

    from repro_torch import interop
    from repro_torch.api import Experiment
    from repro_torch.api.experiment import paper_model_config

    v, d = w.shape
    model = dataclasses.replace(paper_model_config("feats", v, d),
                                real_vocab_size=n_valid or None)
    exp = Experiment.from_config(
        system="paper", model=model, batch=8, device="cpu",
        head=interop.head_config_from_dict(head_cfg))
    exp.load_state(interop.paper_state_from_numpy(
        {}, w, rank=dist.rank(), world_size=dist.world_size(),
        device="cpu"))
    return exp


def _stacked(t) -> np.ndarray:
    """``t`` of every member, stacked in rank order: [P, ...]."""
    return _np(dist.all_gather(t[None], dim=0))


def ivf_fit(w: np.ndarray, *, n_valid: int = 0, n_clusters: int = 0,
            iters: int = 8, centroids=None) -> dict:
    """The IVF index fit over this member's rows of ``w``, stacked over the
    ring as the JAX package's [P, ...] arrays, and whether a second fit
    gives the same bits. With ``centroids`` (the JAX fit's [P, C, D]),
    also the port's packing of this member's rows into those clusters."""
    from repro_torch.serving import index as ix

    exp = _cpu_experiment({"softmax_impl": "full"}, w, n_valid)
    idx = exp.ivf_index(n_clusters=n_clusters, iters=iters)
    again = exp.ivf_index(n_clusters=n_clusters, iters=iters, refit=True)
    out = {"centroids": _stacked(idx.centroids),
           "members": _stacked(idx.members),
           "counts": _stacked(torch.from_numpy(idx.counts)),
           "cap": idx.cap, "n_clusters": idx.n_clusters,
           "nprobe": idx.nprobe,
           "refit_bitwise": bool(
               torch.equal(idx.centroids, again.centroids)
               and torch.equal(idx.members, again.members))}
    if centroids is not None:
        wt = exp.state.head_params
        v_loc = wt.shape[0]
        limit = ss._shard_limit(dist.rank() * v_loc, v_loc, n_valid)
        members, _ = ix._pack(wt, limit, torch.from_numpy(
            np.ascontiguousarray(centroids[dist.rank()])), idx.cap)
        out["pack_members"] = _stacked(members)
    return out


def ivf_serve(head_cfg: dict, w: np.ndarray, tree: dict, f: np.ndarray,
              inputs: np.ndarray, *, k: int, n_queries: int) -> dict:
    """The IVF serve path on this member, from the JAX package's fitted
    index ``tree`` (its ``state_to_save()`` as numpy, carried over by
    ``interop``) over the class matrix ``w``: both serve bodies on both
    backends for the queries ``f``, the engine's IVF step, the facade on
    explicit ``inputs``, and the facade's exact scan beside its IVF serve
    at ``nprobe == C``. Returns numpy arrays."""
    import dataclasses

    from repro_torch import interop

    exp = _cpu_experiment(head_cfg, w)
    idx = interop.ivf_index_from_numpy(tree, rank=dist.rank(),
                                       world_size=dist.world_size(),
                                       device="cpu")
    idx = dataclasses.replace(idx, version=tuple(exp.weights_version))
    exp.install_ivf_index(idx)
    ft, wt = torch.from_numpy(f), exp.state.head_params
    out = {}
    for b in BACKENDS:
        out[f"body_{b}"] = tuple(map(_np, ss.serve_topk_ivf_local(
            ft, wt, idx.centroids, idx.members, k, idx.nprobe, backend=b)))
        out[f"batched_{b}"] = tuple(map(_np, ss.serve_topk_ivf_batched_local(
            ft, wt, idx.centroids, idx.members, k, idx.nprobe, n_queries,
            backend=b)))
    eng = exp.serving_engine(top_k=k, max_batch=f.shape[0], index="ivf")
    out["engine"] = eng.step_fn(f, n_queries)                # (ids, vals)
    q = {"features": inputs}
    out["facade"] = exp.serve(q, top_k=k, return_scores=True, index="ivf")
    out["exact"] = exp.serve(q, top_k=k, return_scores=True)
    out["full_probe"] = exp.serve(q, top_k=k, return_scores=True,
                                  index="ivf", nprobe=idx.n_clusters)
    out["not_refit"] = exp.ivf_index() is idx
    return out


def ivf_recall(protos: np.ndarray, queries: np.ndarray, *, k: int,
               batch: int) -> dict:
    """recall@k of the IVF serve at the index's default nprobe against the
    exact scan, on this member's rows of the class matrix ``protos``, for
    each backend, over ``queries`` in batches of ``batch``."""
    out = {}
    for b in BACKENDS:
        exp = _cpu_experiment({"softmax_impl": "full", "backend": b}, protos)
        exact = exp.serving_engine(top_k=k, max_batch=batch, max_wait_ms=0.0)
        ivf = exp.serving_engine(top_k=k, max_batch=batch, max_wait_ms=0.0,
                                 index="ivf")
        hits = []
        for r0 in range(0, queries.shape[0], batch):
            q = queries[r0:r0 + batch]
            ids_e = exact.step_fn(q, q.shape[0])[0]
            ids_i = ivf.step_fn(q, q.shape[0])[0]
            hits += [len(set(e) & set(i)) / k for e, i in zip(ids_e, ids_i)]
        out[b] = (float(np.mean(hits)), exp.ivf_index().nprobe)
    return out


# ---------------------------------------------------------------------------
# the zoo
# ---------------------------------------------------------------------------


def zoo_serve(tree: dict, *, arch: str, prompts: np.ndarray, gen: int,
              backend: str, variant: Optional[dict] = None) -> np.ndarray:
    """A CPU ``ZooExperiment`` (the reduced ``arch``, its fields replaced
    by ``variant``, ``model_variant``) on this member (of the ring or the
    grid), serving the JAX package's params ``tree`` (carried over by
    ``interop``) on the JAX package's ``prompts`` [b, s], which replace
    the port's ``lm_batch`` for the call. Returns the greedy tokens."""
    from repro_torch import interop
    from repro_torch.api import Experiment
    from repro_torch.configs.base import HeadConfig
    from repro_torch.data import synthetic

    b, s = prompts.shape
    with model_variant(variant):
        exp = Experiment.from_config(system="zoo", arch=arch, reduced=True,
                                     batch=b, device="cpu",
                                     head=HeadConfig(backend=backend))
    exp.load_params(interop.zoo_params_from_numpy(
        tree, exp.model_cfg, rank=dist.rank(), world_size=dist.world_size(),
        device="cpu", specs=exp.specs))
    real = synthetic.lm_batch
    synthetic.lm_batch = lambda *a, **kw: {
        "tokens": torch.tensor(prompts, dtype=torch.long)}
    try:
        return exp.serve(prompt_len=s, gen=gen, batch=b)
    finally:
        synthetic.lm_batch = real


@contextlib.contextmanager
def model_variant(fields: Optional[dict]):
    """Zoo experiments built inside take their arch's config with
    ``fields`` replaced (``"ssm"``: a dict of ``SSMConfig`` fields); None:
    the config as it is. The layout cases of the grid's tests use it."""
    from repro_torch.api import experiment

    if not fields:
        yield
        return
    real = experiment.get_model_config

    def variant(arch, reduced=False):
        cfg = real(arch, reduced)
        top = {k: v for k, v in fields.items() if k != "ssm"}
        if "ssm" in fields:
            top["ssm"] = dataclasses.replace(cfg.ssm, **fields["ssm"])
        return dataclasses.replace(cfg, **top)

    experiment.get_model_config = variant
    try:
        yield
    finally:
        experiment.get_model_config = real


def _zoo_experiment(tree: dict, head_cfg: dict, *, arch: str, batch: int,
                    seq: int, train_cfg: Optional[dict] = None,
                    batches=None, head_state=None, par=None,
                    variant: Optional[dict] = None):
    """A CPU ``ZooExperiment`` (the reduced ``arch``, its fields replaced
    by ``variant``, ``model_variant``) on this member (of the ring, or of
    the grid ``dist.grid`` laid out, under ``par``) with the JAX
    package's params ``tree`` and, when given, its head state ``{"params",
    "aux"}`` (the sketch heads' bucket weights, the LSH tables), both
    carried by ``interop``; ``batches[t]`` (the JAX package's ``lm_batch``
    arrays) replace the port's data stream."""
    from repro_torch import interop
    from repro_torch.api import Experiment
    from repro_torch.configs.base import TrainConfig

    cfg = interop.head_config_from_dict(head_cfg)
    with model_variant(variant):
        exp = Experiment.from_config(
            system="zoo", arch=arch, reduced=True, batch=batch, seq=seq,
            head=cfg,
            train=TrainConfig(**(train_cfg or {"optimizer": "sgd"})),
            device="cpu", log_every=0, par=par,
            data_fn=None if batches is None else (lambda t, b: batches[t]))
    r, n = dist.rank(), dist.world_size()
    exp.load_params(interop.zoo_params_from_numpy(
        tree, exp.model_cfg, rank=r, world_size=n, device="cpu",
        specs=exp.specs))
    if head_state is not None:
        exp.load_head_state(interop.zoo_head_state_from_numpy(
            exp.head, head_state["params"], head_state["aux"], rank=r,
            world_size=n, device="cpu"))
    return exp


def zoo_fit(tree: dict, head_cfg: dict, train_cfg: dict, *, arch: str,
            batch: int, seq: int, steps: int, lr: float, batches: list,
            eval_inputs: dict, head_state=None, draws=None,
            par=None, variant: Optional[dict] = None) -> dict:
    """``ZooExperiment.fit(steps, lr=lr)`` on this member (of the ring or
    the grid) from the JAX package's params and head state
    (``_zoo_experiment``) on its batches; ``draws`` maps a sampled draw's
    salt to the JAX package's draw of each member (``paper_fit``'s).
    Returns the history, the final params in the JAX package's layout
    (gathered over the grid), the member's own slices (``"member"``), the
    sketch heads' bucket weights gathered over the ring, the evaluation
    accuracy and the weights_version trail."""
    from repro_torch import interop
    from repro_torch.models import lm

    exp = _zoo_experiment(tree, head_cfg, arch=arch, batch=batch, seq=seq,
                          train_cfg=train_cfg, batches=batches,
                          head_state=head_state, par=par, variant=variant)
    if draws is not None:
        exp.head.draw = _injected_draw(draws)
    versions = [exp.weights_version]
    hist = exp.fit(steps, lr=lr,
                   step_hook=lambda t: versions.append(exp.weights_version))
    hp = exp.head_state.params
    whole = (exp.params if exp.specs is None
             else lm.gather_params(exp.params, exp.specs))
    return {"history": hist,
            "params": interop.zoo_params_to_numpy(whole),
            "member": (None if exp.specs is None
                       else interop.zoo_params_to_numpy(exp.params)),
            "head_params": (None if exp.head.params_are_class_weights
                            else _np(dist.all_gather(hp, dim=1))),
            "eval": exp.evaluate(eval_inputs),
            "versions": versions + [exp.weights_version]}


def zoo_launcher(module: str, argv: list) -> dict:
    """``repro_torch.launch.<module>.main(argv)`` with ``--system zoo`` on
    this member of the grid already laid out (``launch_grid`` finds no
    ``torchrun`` and keeps it): its exit code and what it printed."""
    import contextlib
    import importlib
    import io

    launcher = importlib.import_module(f"repro_torch.launch.{module}")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = launcher.main(argv)
    return {"rc": rc, "stdout": out.getvalue()}


def zoo_grads(tree: dict, head_cfg: dict, *, arch: str, inputs: dict
              ) -> dict:
    """One batch's loss and its gradient with respect to the model params
    through ``gspmd.make_head_loss_fn`` on this member, from the JAX
    package's params: the loss, and the gradient in the JAX package's
    layout (every member's should be the same)."""
    from repro_torch import interop
    from repro_torch.core.pipeline import microbatched_value_and_grad
    from repro_torch.train import gspmd

    b, s = np.shape(inputs["tokens"])
    exp = _zoo_experiment(tree, head_cfg, arch=arch, batch=b, seq=s)
    loss_fn = gspmd.make_head_loss_fn(exp.model_cfg, exp.head_cfg,
                                      global_tokens=b * s, head=exp.head)
    batch = {k: torch.as_tensor(np.asarray(v)) for k, v in inputs.items()}
    (loss, _), grads = microbatched_value_and_grad(
        lambda p, x: loss_fn(p, (), exp.head_state.aux, x), exp.params,
        batch, 1)
    return {"loss": float(loss), "grads": interop.zoo_params_to_numpy(grads)}


def zoo_retrieve(tree: dict, head_cfg: dict, *, arch: str, queries,
                 top_k: int) -> dict:
    """The zoo's feature retrieval on this member from the JAX package's
    params: ``serve(top_k=...)`` on ``queries`` [b, D] exactly, through
    the IVF index at its default nprobe and at every cluster, and on the
    default query pool, each (ids, scores); the index's geometry; greedy
    ids through the engine; and one engine batch with padded rows."""
    exp = _zoo_experiment(tree, head_cfg, arch=arch, batch=4, seq=8)
    q = np.asarray(queries, np.float32)
    kw = dict(top_k=top_k, queries=q, return_scores=True)
    out = {"exact": exp.serve(**kw), "ivf": exp.serve(index="ivf", **kw),
           "ivf_all": exp.serve(index="ivf", nprobe=10**6, **kw),
           "default": exp.serve(top_k=top_k, return_scores=True)}
    idx = exp.ivf_index()
    out.update(n_clusters=idx.n_clusters, cap=idx.cap, nprobe=idx.nprobe)
    out["greedy"] = exp.serving_engine(max_batch=8).step_fn(q, q.shape[0])[0]
    out["pad"] = exp.serving_engine(top_k=top_k, max_batch=8).step_fn(
        q[:4], 3)
    return out


# ---------------------------------------------------------------------------
# the grid: what one member of a (data, model) grid holds and computes
# ---------------------------------------------------------------------------


def grid_moe(params: dict, arch: str, x: np.ndarray, cot: np.ndarray,
             capacity_factor) -> dict:
    """``models.moe.apply_moe`` on this grid member: the reduced ``arch``'s
    MoE params (the JAX package's tree, numpy) cut by the layer's specs
    (the experts over ``model``), ``x`` [b, s, D]'s rows split over the
    data axis, and the gradient of ``sum(out * cot) + aux``. Returns the
    output and the input's gradient gathered over the data axis, the
    router loss, the params' gradients summed over the data axis and
    gathered whole, and the (token, expert) pairs kept, summed over the
    data axis."""
    import dataclasses as dc

    from repro_torch import interop
    from repro_torch.configs.base import get_model_config
    from repro_torch.models import lm, moe
    from repro_torch.models.layers import ParamDict
    from repro_torch.optim import tree_map
    from repro_torch.train import gspmd

    cfg = dc.replace(get_model_config(arch, reduced=True), dtype="float32")
    specs = gspmd.member_specs(cfg, gspmd.grid_parallel_config())[
        "blocks"][0]["moe"]
    whole = ParamDict(**tree_map(lambda a: torch.tensor(np.asarray(a)),
                                 params))
    p = tree_map(lambda t: t.detach().requires_grad_(), lm.cut(whole, specs))
    n_data, d = dist.world_size(dist.BATCH), dist.rank(dist.BATCH)
    rows = x.shape[0] // n_data
    tx = torch.tensor(x[d * rows:(d + 1) * rows]).requires_grad_()
    out, aux = moe.apply_moe(p, cfg, tx, capacity_factor=capacity_factor,
                             spec=specs)
    loss = ((out * torch.tensor(cot[d * rows:(d + 1) * rows])).sum()
            + dist.grad_mean(aux, dist.BATCH))
    loss.backward()
    grads = lm.gather_params(tree_map(lambda t: t.grad, p), specs)
    grads = interop.zoo_params_to_numpy(
        tree_map(lambda g: dist.psum(g, dist.BATCH), grads))
    with torch.no_grad():      # a row is a dispatch group (s > 1)
        top_i = moe.routing(p, cfg, tx)[2]
        cap = moe.capacity_for(tx.shape[1], cfg, capacity_factor)
        keep = moe._dispatch_group(tx, top_i, cap, cfg.moe.n_experts,
                                   cfg.moe.top_k)[1][1]
        kept = int(dist.psum(keep.sum().float(), dist.BATCH))
    return {"out": _np(dist.all_gather(out.detach(), axis=dist.BATCH)),
            "dx": _np(dist.all_gather(tx.grad, axis=dist.BATCH)),
            "aux": float(aux.detach()), "grads": grads, "kept": kept,
            "experts": int(p.wi_gate.shape[0])}


def grid_collectives() -> dict:
    """This grid member's (data, model) index and the collectives over each
    axis of ``x = [its flat index]``: ``psum`` over ``data``, ``model``
    and the whole grid, the all-gather over (data, model), the model
    axis's ``ppermute``, and the gradient of ``psum_d + 2 psum_m + 3
    psum_all + sum(gather)`` (each backward a psum, the gather's a
    reduce-scatter)."""
    r = dist.rank(dist.ALL)
    x = torch.tensor([float(r)], requires_grad=True)
    a, b = dist.psum(x, "data"), dist.psum(x, "model")
    c = dist.psum(x, dist.ALL)
    g = dist.all_gather(x, axis=("data", "model"))
    (a + 2 * b + 3 * c + g.sum()).sum().backward()
    return {"index": (dist.rank("data"), dist.rank("model")),
            "sums": (float(a), float(b), float(c)), "gather": _np(g),
            "grad": float(x.grad), "shift": float(dist.ppermute(x)),
            "invariant_grad": _invariant_grad()}


def _invariant_grad() -> float:
    y = torch.tensor([1.0], requires_grad=True)
    dist.psum_invariant(y * (dist.rank() + 1), "model").sum().backward()
    return float(y.grad)


def grid_lars(w: np.ndarray, g: np.ndarray, spec: tuple) -> dict:
    """One LARS step (momentum 0.9, weight decay 1e-4, lr 0.5) on this
    member's block of ``w`` by ``spec``, with the leaf's mesh axes
    (``leaf_axes``) and without: the updated blocks gathered whole."""
    from repro_torch.optim import lars

    opt = lars(momentum=0.9, weight_decay=1e-4)
    out = {}
    for name, axes in (("whole", [dist.spec_axes(spec)]), ("local", None)):
        p = dist.member_block(torch.tensor(w), spec).clone()
        gb = dist.member_block(torch.tensor(g), spec).clone()
        state = opt.init([p])
        opt.update_([gb], state, [p], 0.5, leaf_axes=axes)
        out[name] = _np(dist.gather_block(p, spec))
    return out


def grid_member_bytes(arch: str) -> dict:
    """The params a fresh ``ZooExperiment`` of the reduced ``arch`` holds
    on this grid member: each leaf's shape in the JAX layout and the
    element count, beside the whole model's."""
    from repro_torch.api import Experiment
    from repro_torch.models import lm
    from repro_torch.optim import tree_leaves, tree_map

    exp = Experiment.from_config(system="zoo", arch=arch, reduced=True,
                                 batch=4, seq=8, device="cpu", log_every=0)
    whole = lm.abstract_model(exp.model_cfg)
    return {"shapes": tree_map(lambda t: tuple(t.shape),
                               lm.params_tree(exp.params)),
            "numel": sum(t.numel() for t in tree_leaves(exp.params)),
            "whole": sum(t.numel() for t in tree_leaves(whole))}


# ---------------------------------------------------------------------------
# the dense CE kernels' gates, and TF32 products emulated
# ---------------------------------------------------------------------------

CE_ATOL = 1e-4        # ce_forward m and corr (scores), absolute
CE_Z_RTOL = 1e-4      # ce_forward z, a sum over V terms, relative
CE_TIE_GAP = 1e-5     # amax may differ only where the top-2 scores lie closer
CE_BWD_TOL = 2e-5     # ce_backward: each part within this of its own max|plain|
# ce_backward on a batch the model has learnt, where p - 1 cancels in the
# label columns: each part within this many times the plain version's own
# rounding (its distance from the same formula in fp64) when that is above
# CE_BWD_TOL of its max. 3xTF32 products read 1.3 times it, 1xTF32 ones
# about 100 (tests/test_torch_kernels.py)
CE_OWN_ROUNDING = 4.0


def tf32_round(x):
    """fp32 ``x`` rounded to the nearest TF32 (10 mantissa bits; ties away
    from zero, as the card's ``cvt.rna.tf32.f32``), by integer arithmetic
    on its bits; returned as fp32."""
    bits = x.float().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_matmul(a, b, passes: int):
    """``a @ b`` with TF32 operands and fp32 sums: ``passes=1`` rounds each
    operand once (hi . hi); ``passes=3`` is the kernels' 3xTF32, lo . hi +
    hi . lo + hi . hi with hi = tf32(x), lo = tf32(x - hi)."""
    ah, bh = tf32_round(a), tf32_round(b)
    if passes == 1:
        return ah @ bh
    if passes != 3:
        raise ValueError(f"passes is 1 or 3, got {passes}")
    return tf32_round(a - ah) @ bh + ah @ tf32_round(b - bh) + ah @ bh


def ce_forward_tf32(f, w, y, limit: int, scale: float, passes: int):
    """``ce_forward_plain`` with its product in 1x or 3xTF32."""
    from repro_torch.kernels.ce_softmax import ce_forward_plain
    fh, wh = tf32_round(f), tf32_round(w)
    if passes == 1:
        return ce_forward_plain(fh, wh, y, limit, scale)
    # lo . hi + hi . lo + hi . hi as one product over three copies of D
    f3 = torch.cat([tf32_round(f - fh), fh, fh], dim=1)
    w3 = torch.cat([wh, tf32_round(w - wh), wh], dim=1)
    return ce_forward_plain(f3, w3, y, limit, scale)


def ce_backward_tf32(f, w, y, m, gz, gc, limit: int, scale: float,
                     passes: int):
    """``ce_backward_plain`` with its three products in 1x or 3xTF32."""
    s = tf32_matmul(f, w.T, passes) * scale
    col = torch.arange(w.shape[0], device=w.device)
    live = (col < limit)[None, :] & torch.isfinite(m)[:, None]
    p = torch.where(live, torch.exp(s - m[:, None]), 0.0)
    hit = (col[None, :] == y[:, None].long()).float()
    dl = (p * gz[:, None] + hit * gc[:, None]) * scale
    return tf32_matmul(dl, w, passes), tf32_matmul(dl.T, f, passes)


def _worst(e) -> float:
    e = e[torch.isfinite(e)]
    return float(e.abs().max()) if e.numel() else 0.0


def _stats_gate(out, ref, s) -> dict:
    """(m, z, corr, amax) against the plain version's, ``s`` the plain
    scores with the columns that fold nothing at -inf: m and corr within
    CE_ATOL, z within CE_Z_RTOL relative, amax equal except on rows whose
    top-2 scores lie within CE_TIE_GAP (fp32 sums in another order may swap
    a near-tie)."""
    (m1, z1, c1, a1), (m2, z2, c2, a2) = out, ref
    failed = [name for name, a, b, atol, rtol in (
        ("m", m1, m2, CE_ATOL, 0.0), ("corr", c1, c2, CE_ATOL, 0.0),
        ("z", z1, z2, 0.0, CE_Z_RTOL))
        if not bool(torch.isclose(a, b, rtol=rtol, atol=atol).all())]
    differ = a1 != a2
    if s.shape[1] > 1:
        top2 = s.topk(2, dim=1).values
        differ &= ~(top2[:, 0] - top2[:, 1] < CE_TIE_GAP)
    rows = differ.nonzero()[:, 0].tolist()
    if rows:
        failed.append("amax")
    return {"ok": not failed, "failed": failed,
            "m_corr_err": max(_worst(m1 - m2), _worst(c1 - c2)),
            "z_rel_err": _worst(
                (z1 - z2) / z2.clamp_min(torch.finfo(z2.dtype).tiny)),
            "amax_rows": rows}


def ce_forward_gate(out, ref, f, w, limit: int, scale: float) -> dict:
    """``ce_forward``'s outputs ``out`` against the plain version's ``ref``
    (both (m, z, corr, amax) on the same inputs, ``limit`` clamped), by
    ``_stats_gate``. Returns ``ok``, which parts fail, the largest error of
    m and corr, of z (relative), and the rows whose amax differs."""
    s = (f @ w.T) * scale
    s[:, limit:] = float("-inf")
    return _stats_gate(out, ref, s)


def _parts_gate(parts) -> tuple:
    """Each (name, kernel, plain) part within CE_BWD_TOL of its own
    max|plain| and finite. Returns (the failing names, {name: (max abs err,
    err / max|plain|)})."""
    failed, out = [], {}
    for name, k, p in parts:
        if not p.numel():
            continue
        if not bool(torch.isfinite(k).all()):
            failed.append(name)
            out[name] = (float("inf"), float("inf"))
            continue
        scale_ref = float(p.abs().max())
        err = float((k - p).abs().max())
        if err > CE_BWD_TOL * scale_ref:
            failed.append(name)
        out[name] = (err, err / scale_ref if scale_ref else err)
    return failed, out


def ce_backward_gate(df, dw, pdf, pdw, y) -> dict:
    """``ce_backward``'s (df, dw) against the plain version's (pdf, pdw),
    ``y`` the local labels (-1 off the shard). Each part is held against
    its own max|plain| (``_parts_gate``): df, dW's label rows and dW's
    other rows, whose only term is the softmax one (orders of magnitude
    below the one-hot term of the label rows, so a shared scale would not
    see it). Returns ``ok``, which parts fail, and {part: (max abs err,
    err / max|plain|)}."""
    lab = torch.zeros(dw.shape[0], dtype=torch.bool, device=dw.device)
    lab[y[y >= 0].long()] = True
    failed, parts = _parts_gate((
        ("df", df, pdf), ("dW label rows", dw[lab], pdw[lab]),
        ("dW other rows", dw[~lab], pdw[~lab])))
    return {"ok": not failed, "failed": failed, "parts": parts}


def ce_backward_floor_gate(df, dw, pdf, pdw, qdf, qdw, y) -> dict:
    """``ce_backward_gate`` with a floor, for a batch the model has learnt:
    there p is near 1 at the labels, p - 1 cancels, and the parts shrink
    to a size where fp32 rounding alone reaches CE_BWD_TOL of their max.
    Each part (df, dW's label rows, dW's other rows) is held within the
    larger of CE_BWD_TOL of its own max|plain| and CE_OWN_ROUNDING times
    the plain version's own rounding: its max distance from (qdf, qdw),
    the plain version in fp64 on the same inputs. Returns ``ok``, which
    parts fail, and {part: (max abs err, err / max|plain|, plain's own
    rounding)}."""
    lab = torch.zeros(dw.shape[0], dtype=torch.bool, device=dw.device)
    lab[y[y >= 0].long()] = True
    failed, parts = [], {}
    for name, k, p, q in (("df", df, pdf, qdf),
                          ("dW label rows", dw[lab], pdw[lab], qdw[lab]),
                          ("dW other rows", dw[~lab], pdw[~lab], qdw[~lab])):
        if not p.numel():
            continue
        top = float(p.abs().max())
        own = float((p.double() - q.double()).abs().max())
        err = (float((k - p).abs().max()) if bool(torch.isfinite(k).all())
               else float("inf"))
        if not err <= max(CE_BWD_TOL * top, CE_OWN_ROUNDING * own):
            failed.append(name)
        parts[name] = (err, err / top if top else err, own)
    return {"ok": not failed, "failed": failed, "parts": parts}


# ---------------------------------------------------------------------------
# the sparse CE kernels' gates (the same tolerances) and emulations
# ---------------------------------------------------------------------------


def sparse_ce_forward_tf32(f, w, ids, gids, bias, valid, y, scale: float,
                           mask_hits: bool, passes: int):
    """``sparse_ce_forward_plain`` with its product in 1x or 3xTF32 (over
    the gathered rows, so the [V, D] shard is not copied)."""
    from repro_torch.kernels.sparse_ce import sparse_ce_forward_plain
    wa = w[ids.long()]
    cols = torch.arange(ids.shape[0], dtype=torch.int32, device=ids.device)
    fh, wh = tf32_round(f), tf32_round(wa)
    if passes == 1:
        f3, w3 = fh, wh
    elif passes == 3:    # lo . hi + hi . lo + hi . hi as one product
        f3 = torch.cat([tf32_round(f - fh), fh, fh], dim=1)
        w3 = torch.cat([wh, tf32_round(wa - wh), wh], dim=1)
    else:
        raise ValueError(f"passes is 1 or 3, got {passes}")
    return sparse_ce_forward_plain(f3, w3, cols, gids, bias, valid, y, scale,
                                   mask_hits)


def sparse_ce_backward_tf32(f, w, ids, gids, bias, valid, y, m, gz, gc, hit,
                            scale: float, mask_hits: bool, passes: int):
    """``sparse_ce_backward_plain`` with its three products in 1x or
    3xTF32."""
    from repro_torch.kernels.sparse_ce import _masks
    wa = w[ids.long()]
    s = tf32_matmul(f, wa.T, passes) * scale + bias[None, :]
    keep, _ = _masks(gids, valid, y, mask_hits)
    p = torch.where(keep & torch.isfinite(m)[:, None],
                    torch.exp(s - m[:, None]), 0.0)
    col = torch.arange(ids.shape[0], device=f.device)
    onehot = (col[None, :] == hit[:, None].long()).float()
    dl = (p * gz[:, None] + onehot * gc[:, None]) * scale
    dw = torch.zeros_like(w).index_add_(0, ids.long(),
                                        tf32_matmul(dl.T, f, passes))
    return tf32_matmul(dl, wa, passes), dw


def sparse_ce_forward_gate(out, ref, f, w, ids, gids, bias, valid, y,
                           scale: float, mask_hits: bool) -> dict:
    """``sparse_ce_forward``'s outputs ``out`` against the plain version's
    ``ref`` (both (m, z, corr, amax, hit) on the same inputs, ``ids``
    clipped into [0, V)): m, z, corr and amax by ``_stats_gate`` over the
    kept columns, and the hit column exact. Returns ``ok``, which parts
    fail, the largest error of m and corr, of z (relative), and the rows
    whose amax differs."""
    from repro_torch.kernels.sparse_ce import _masks, _scores
    keep, _ = _masks(gids, valid, y, mask_hits)
    s = torch.where(keep, _scores(f, w, ids, bias, scale), float("-inf"))
    gate = _stats_gate(out[:4], ref[:4], s)
    if not torch.equal(out[4], ref[4]):
        gate["failed"].append("hit")
        gate["ok"] = False
    return gate


def sparse_ce_backward_gate(df, dw, pdf, pdw, ids, gids, y) -> dict:
    """``sparse_ce_backward``'s (df, dw) against the plain version's (pdf,
    pdw), ``ids`` clipped into [0, V). Each part is held against its own
    max|plain| (``_parts_gate``): df, dW's label rows (the rows of the
    columns whose gid is some row's label) and dW's other active rows (the
    softmax term alone, orders of magnitude below the label rows' one-hot
    term). Rows off the active set must stay 0. Returns ``ok``, which parts
    fail, and {part: (max abs err, err / max|plain|)}."""
    act = torch.zeros(dw.shape[0], dtype=torch.bool, device=dw.device)
    act[ids.long()] = True
    lab = torch.zeros_like(act)
    lab[ids[torch.isin(gids, y)].long()] = True
    failed, parts = _parts_gate((
        ("df", df, pdf), ("dW label rows", dw[lab], pdw[lab]),
        ("dW other active rows", dw[act & ~lab], pdw[act & ~lab])))
    if bool(dw[~act].any()):
        failed.append("dW rows off the active set")
    return {"ok": not failed, "failed": failed, "parts": parts}


# ---------------------------------------------------------------------------
# checkpoints, recovery and elastic restores
# ---------------------------------------------------------------------------


def ckpt_experiment(spec: dict, ckpt_dir=None):
    """A CPU ``PaperExperiment`` on this member from ``spec``: ``head`` and
    ``train`` (the JAX package's ``HeadConfig`` / ``TrainConfig`` fields
    as dicts, ``fccs`` and ``dgc`` nested), ``trunk`` ("feats" or "cnn"),
    ``classes``, ``feat_dim``, ``batch``, ``ckpt_every`` and ``hw`` (the
    cnn trunk's image side), on ``numpy_batch`` / ``numpy_image_batch``
    data, checkpointing under ``ckpt_dir``."""
    from repro_torch import interop
    from repro_torch.api import Experiment
    from repro_torch.configs.base import DGCConfig, FCCSConfig, TrainConfig

    t = dict(spec["train"])
    tcfg = TrainConfig(**{**t, "fccs": FCCSConfig(**t["fccs"]),
                          "dgc": DGCConfig(**t["dgc"])})
    v, trunk = spec["classes"], spec.get("trunk", "feats")
    if trunk == "cnn":
        def data_fn(step, b):
            return numpy_image_batch(step, b, classes=v, hw=spec["hw"])
    else:
        def data_fn(step, b):
            return numpy_batch(step, b, classes=v, dim=spec["feat_dim"])
    return Experiment.from_config(
        system="paper", trunk=trunk, classes=v,
        feat_dim=spec.get("feat_dim", 64), batch=spec["batch"],
        head=interop.head_config_from_dict(spec["head"]), train=tcfg,
        ckpt_dir=ckpt_dir, ckpt_every=spec.get("ckpt_every", 0),
        log_every=0, device="cpu", data_fn=data_fn)


def _state_tree(st) -> dict:
    """A member's ``HybridState`` as one tree, for ``tree_compare``."""
    return {"fe": st.fe_params, "params": st.head_params,
            "aux": st.head_aux, "opt": st.opt_state,
            "dgc": None if st.dgc is None else {"u": st.dgc.u,
                                                  "v": st.dgc.v},
            "step": torch.tensor(st.step)}


def ckpt_from_jax(spec: dict, jax_dir: str, port_dir: str,
                  jax_state: dict) -> dict:
    """Restore the JAX package's checkpoint under ``jax_dir`` on this
    member, hold the state to ``interop.paper_state_from_numpy`` of the
    JAX state (``jax_state``: ``fe``, ``params``, ``aux``, ``opt`` =
    {"step", "mu", "nu"}, ``dgc`` = {"u", "v"} or None, ``step``), then
    save it under ``port_dir``. Returns the restored step and cursor and
    ``tree_compare``'s result."""
    from repro_torch import interop
    from repro_torch.resilience import tree_compare

    exp = ckpt_experiment(spec, jax_dir)
    step = exp.restore()
    want = interop.paper_state_from_numpy(
        jax_state["fe"], jax_state["params"], opt_state=jax_state["opt"],
        step=jax_state["step"], head_aux=jax_state["aux"],
        aux_spec=exp.head.aux_spec(), dgc=jax_state["dgc"],
        rank=dist.rank(), world_size=dist.world_size(), device="cpu")
    cmp = tree_compare(_state_tree(exp.state), _state_tree(want))
    exp.trainer.ckpt_dir = port_dir
    exp.trainer.save_checkpoint()
    return {"step": step, "t": exp.trainer._t, "cmp": cmp,
            "version": exp.weights_version}


def kill_recover(spec: dict, ckpt_dir: str, *, total_steps: int,
                 kill_at: int, fit_kw: dict, equivalence: str = "bitwise"):
    """``resilience.kill_and_recover`` on this member for the experiment
    of ``spec`` (every member runs it; member 0 writes). Returns the
    ``RecoveryReport``."""
    from repro_torch.resilience import kill_and_recover
    return kill_and_recover(lambda d: ckpt_experiment(spec, d),
                            total_steps=total_steps, kill_at=kill_at,
                            ckpt_dir=ckpt_dir, equivalence=equivalence,
                            head=spec["head"]["softmax_impl"],
                            fit_kw=fit_kw)


def snapshot_numpy(exp) -> dict:
    """The experiment's GLOBAL snapshot tree as host arrays (a collective:
    every member calls it)."""
    return _np_tree(exp.trainer._snapshot())


def elastic_source(spec: dict, ckpt_dir: str, *, steps: int,
                   queries=None) -> dict:
    """Train ``steps`` steps on this ring and save a checkpoint at the
    end; returns the snapshot and the top-5 served (ids, scores) of the
    feature ``queries`` (W-heads) or the greedy ids (sketch heads)."""
    exp = ckpt_experiment(spec, ckpt_dir)
    exp.fit(steps, use_fccs_batch=False)
    exp.trainer.save_checkpoint()
    return {"snap": snapshot_numpy(exp), "serve": _serve(exp, queries)}


def _serve(exp, queries):
    if queries is None:
        return None
    inputs = {"features": queries}
    if exp.head.params_are_class_weights:
        return exp.serve(inputs, top_k=5, return_scores=True)
    return exp.serve(inputs)


def elastic_restore(spec: dict, ckpt_dir: str, *, queries=None,
                    save_dir=None, train_steps: int = 0) -> dict:
    """Restore ``ckpt_dir``'s checkpoint onto this ring with ``reshard``;
    returns the restored step, the snapshot, the served results, the
    reshard's bytes and spans, and (with ``train_steps``) the losses of
    that many more steps. With ``save_dir`` the restored state is saved
    there first."""
    from repro_torch.telemetry import Tracer
    exp = ckpt_experiment(spec, ckpt_dir)
    tele = Tracer()
    exp.trainer.telemetry = tele
    step = exp.restore(reshard=True)
    out = {"step": step, "t": exp.trainer._t, "snap": snapshot_numpy(exp),
           "serve": _serve(exp, queries),
           "spans": [(e.name, e.depth) for e in tele.events],
           "counters": dict(tele.counters),
           "last_reshard": {k: v for k, v in
                            (exp.trainer.last_reshard or {}).items()
                            if k in ("plan", "bytes_moved")}}
    if save_dir:
        exp.trainer.ckpt_dir = save_dir
        exp.trainer.save_checkpoint()
    if train_steps:
        hist = exp.fit(train_steps, use_fccs_batch=False)
        out["losses"] = [r["loss"] for r in hist[-train_steps:]]
    return out


def zoo_ckpt_experiment(spec: dict, ckpt_dir=None):
    """A CPU ``ZooExperiment`` on this member from ``spec``: ``arch`` (its
    reduced config), ``head`` (the JAX package's ``HeadConfig`` fields as
    a dict), ``batch``, ``seq`` and ``ckpt_every``, with SGD,
    checkpointing under ``ckpt_dir``."""
    from repro_torch import interop
    from repro_torch.api import Experiment
    from repro_torch.configs.base import TrainConfig
    return Experiment.from_config(
        system="zoo", arch=spec["arch"], reduced=True,
        head=interop.head_config_from_dict(spec["head"]),
        train=TrainConfig(optimizer="sgd"), batch=spec["batch"],
        seq=spec["seq"], ckpt_dir=ckpt_dir,
        ckpt_every=spec.get("ckpt_every", 0), log_every=0, device="cpu")


def zoo_ckpt_from_jax(spec: dict, jax_dir: str, port_dir: str,
                      jax_snap: dict) -> dict:
    """Restore the JAX package's zoo checkpoint under ``jax_dir`` on this
    member, hold the port's GLOBAL snapshot to the JAX package's
    (``jax_snap``, host arrays) with ``tree_compare``, then save it under
    ``port_dir``. Returns the restored step and cursor, the comparison and
    the weights_version."""
    from repro_torch.resilience import tree_compare
    exp = zoo_ckpt_experiment(spec, jax_dir)
    step = exp.restore()
    cmp = tree_compare(exp._snapshot(), jax_snap)
    exp.ckpt_dir = port_dir
    exp.save_checkpoint()
    return {"step": step, "t": exp._t, "cmp": cmp,
            "version": exp.weights_version}


def zoo_kill_recover(spec: dict, ckpt_dir: str, *, total_steps: int,
                     kill_at: int, fit_kw: dict,
                     equivalence: str = "bitwise"):
    """``resilience.kill_and_recover`` of the zoo experiment of ``spec``
    on this member (every member runs it; member 0 writes)."""
    from repro_torch.resilience import kill_and_recover
    return kill_and_recover(lambda d: zoo_ckpt_experiment(spec, d),
                            total_steps=total_steps, kill_at=kill_at,
                            ckpt_dir=ckpt_dir, equivalence=equivalence,
                            head="zoo/" + spec["head"]["softmax_impl"],
                            fit_kw=fit_kw)


def _zoo_state(exp) -> dict:
    """The parts of a zoo snapshot that do not depend on the ring, as host
    arrays (a collective)."""
    from repro_torch.optim import tree_map
    snap = exp._snapshot()
    # copies: the snapshot shares the live params' top-level tensors
    return tree_map(lambda t: _np(t).copy(),
                    {k: snap[k] for k in ("model", "head", "opt")})


def zoo_elastic_source(spec: dict, ckpt_dir: str, *, steps: int) -> dict:
    """``fit(steps)`` on this ring, checkpointing; returns the final
    snapshot's model, head and opt parts and the history."""
    exp = zoo_ckpt_experiment(spec, ckpt_dir)
    exp.fit(steps, lr=0.5)
    return {"snap": _zoo_state(exp), "history": exp.history}


def zoo_elastic_restore(spec: dict, ckpt_dir: str, *, train_to: int
                        ) -> dict:
    """On this ring: a restore without ``reshard`` must raise
    ``ReshardError``; then ``restore(reshard=True)``, the restored
    snapshot's parts, the reshard's counters, and the losses of the steps
    on to ``train_to``."""
    from repro_torch.elastic import ReshardError
    from repro_torch.telemetry import Tracer
    exp = zoo_ckpt_experiment(spec, ckpt_dir)
    try:
        exp.restore()
        blocked = None
    except ReshardError as e:
        blocked = str(e)
    tele = Tracer()
    exp.telemetry = tele
    step = exp.restore(reshard=True)
    out = {"blocked": blocked, "step": step, "snap": _zoo_state(exp),
           "bytes_moved": tele.counters.get("reshard.bytes_moved", 0.0),
           "spans": sorted({e.name for e in tele.events})}
    exp.fit(train_to - exp._t, lr=0.5)
    out["losses"] = [r["loss"] for r in exp.history]
    return out


def zoo_grid_restore(spec: dict, src_dir: str, *, batches: list,
                     dst_dir: Optional[str] = None, steps: int = 1) -> dict:
    """On this member (of the ring or the grid): ``restore(reshard=True)``
    of the zoo checkpoint under ``src_dir`` (written on a grid of another
    shape), its GLOBAL snapshot as host arrays, the reshard's record; then
    a save of the restored state under ``dst_dir`` (when given), and
    ``fit(steps)`` on ``batches[t]`` from the restored cursor, with no
    checkpoint: its losses and the params gathered whole."""
    from repro_torch import interop
    from repro_torch.models import lm
    from repro_torch.optim import tree_map
    from repro_torch.telemetry import Tracer

    exp = zoo_ckpt_experiment(spec, src_dir)
    exp.data_fn = lambda t, b: batches[t]
    tele = Tracer()
    exp.telemetry = tele
    step = exp.restore(reshard=True)
    # copies: the snapshot shares the live params' unsplit leaves
    snap = tree_map(lambda t: _np(t).copy(), exp._snapshot())
    out = {"step": step, "t": exp._t, "snap": snap,
           "bytes_moved": tele.counters.get("reshard.bytes_moved", 0.0),
           "spans": sorted({e.name for e in tele.events}),
           "last_reshard": (exp.last_reshard["src"].describe(),
                            exp.last_reshard["dst"].describe())}
    exp.telemetry = None
    if dst_dir:
        exp.ckpt_dir = dst_dir
        exp.save_checkpoint()
    exp.ckpt_dir = None
    hist = exp.fit(steps, lr=0.1)
    whole = (exp.params if exp.specs is None
             else lm.gather_params(exp.params, exp.specs))
    out.update(losses=[r["loss"] for r in hist],
               params=interop.zoo_params_to_numpy(whole))
    return out


def encdec_decode(tree: dict, *, arch: str, frames, prompt, gen: int
                  ) -> np.ndarray:
    """The encoder-decoder's greedy decode through ``models.lm.decode`` on
    this member (of the ring or the grid, every member decoding every
    row) from the JAX package's params: the encoder over ``frames`` [b, T,
    D], the cross caches (``encdec.build_cross_cache``), the decoder fed
    ``prompt`` [b, P] token by token, then ``gen`` greedy tokens through
    the sharded-vocab argmax. Returns the greedy tokens [b, gen]."""
    from repro_torch.models import encdec, lm
    from repro_torch.train import gspmd

    b, n_prompt = np.shape(prompt)
    exp = _zoo_experiment(tree, {"softmax_impl": "full"}, arch=arch,
                          batch=b, seq=n_prompt)
    cfg, params, specs = exp.model_cfg, exp.params, exp.specs
    sp = None if specs is None else specs["encdec"]
    prompt = torch.as_tensor(np.asarray(prompt), dtype=torch.long)
    with torch.no_grad():
        enc = encdec.encode(params.encdec, cfg, torch.as_tensor(
            np.asarray(frames)).to(getattr(torch, cfg.dtype)), specs=sp)
        caches, slots, window = lm.init_decode_state(
            cfg, b, n_prompt + gen, device="cpu", specs=specs)
        caches["cross_k"], caches["cross_v"] = encdec.build_cross_cache(
            params.encdec, cfg, enc, sp)
        tok, out = prompt[:, :1], []
        for t in range(n_prompt + gen - 1):
            h, caches, slots = lm.decode(params, cfg, {"token": tok}, caches,
                                         slots, window=window, specs=specs)
            if t + 1 < n_prompt:
                tok = prompt[:, t + 1:t + 2]
                continue
            tok = gspmd._greedy(params, cfg, h[:, 0, :], specs)[:, None]
            out.append(tok[:, 0])
    return _np(torch.stack(out, dim=1))


def grid_step_collectives(archs: list, *, batch: int, seq: int) -> list:
    """One zoo train step (the full head, ``ref`` kernels, ``remat="full"``,
    SGD) of each reduced arch on this grid member, built as
    ``launch.dryrun.lower_one`` builds it on ``"DxM"`` (the grid's shape)
    but on real CPU tensors, its collectives counted at the ``dist``
    wrappers. Returns each arch's counts."""
    import math

    from repro_torch.api.heads import HeadState, make_head
    from repro_torch.configs.base import (INPUT_SHAPES, HeadConfig,
                                          TrainConfig, for_shape,
                                          get_model_config, pad_vocab)
    from repro_torch.launch.mesh import make_host_parallel_config
    from repro_torch.models import lm
    from repro_torch.optim import make_optimizer
    from repro_torch.train import gspmd

    _, n_data, n_model = dist.grid_shape()
    shape = dataclasses.replace(INPUT_SHAPES["train_4k"],
                                global_batch=batch, seq_len=seq)
    out = []
    for arch in archs:
        cfg = for_shape(get_model_config(arch, True), shape)
        cfg = pad_vocab(cfg, 128 * n_model // math.gcd(128, n_model))
        par = make_host_parallel_config(n_data, n_model, "full")
        specs = gspmd.member_specs(cfg, par)
        gen = torch.Generator().manual_seed(0)
        params = lm.init_model(gen, cfg, specs)
        hcfg = HeadConfig(softmax_impl="full", backend="ref",
                          cosine_scale=0.0)
        tcfg = TrainConfig(optimizer="sgd", micro_batch=0)
        rows = batch // n_data
        g = torch.Generator().manual_seed(1)
        inputs = {k: torch.randint(0, 512, (rows, seq), generator=g,
                                   dtype=torch.int32)
                  for k in ("tokens", "labels")}
        if cfg.family == "encdec":
            inputs["frames"] = torch.randn(
                (rows, cfg.enc_seq, cfg.d_model), generator=g).to(
                    getattr(torch, cfg.dtype))
        step = gspmd.make_head_train_step(cfg, hcfg, tcfg, shape,
                                          head=make_head(cfg, hcfg),
                                          par=par, specs=specs)
        opt_state = make_optimizer(tcfg).init((params, ()))
        with dist.count_collectives() as counts:
            step(params, HeadState((), ()), opt_state, inputs, 0.1)
        out.append(dict(counts))
    return out


def run_launcher(module: str, argv: list) -> tuple:
    """``repro_torch.launch.<module>.main(argv)`` on this member (a ring's
    launcher joins the member's group as it is): (exit code, what it
    printed)."""
    import importlib
    import io
    main = importlib.import_module(f"repro_torch.launch.{module}").main
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue()


def run_all(cases: list) -> list:
    """Run ``(worker name, args, kwargs)`` cases in order on this member,
    so one spawned ring serves a whole group of tests."""
    workers = {"serve_bodies": serve_bodies, "paper_serve": paper_serve,
               "collectives": collectives, "loss_body": loss_body,
               "paper_fit": paper_fit, "collective_grads": collective_grads,
               "knn_graph_build": knn_graph_build,
               "knn_loss_body": knn_loss_body, "ring_shift": ring_shift,
               "ivf_fit": ivf_fit, "ivf_serve": ivf_serve,
               "ivf_recall": ivf_recall, "zoo_serve": zoo_serve,
               "zoo_fit": zoo_fit, "zoo_retrieve": zoo_retrieve,
               "zoo_launcher": zoo_launcher,
               "zoo_grads": zoo_grads,
               "head_loss_body": head_loss_body,
               "sketch_predict": sketch_predict,
               "sampled_draws": sampled_draws,
               "sampled_full_draw": sampled_full_draw,
               "selective_refresh": selective_refresh,
               "dgc_rounds": dgc_rounds, "cnn_fit": cnn_fit,
               "step_collectives": step_collectives,
               "cnn_serve": cnn_serve, "ckpt_from_jax": ckpt_from_jax,
               "kill_recover": kill_recover,
               "elastic_source": elastic_source,
               "elastic_restore": elastic_restore,
               "zoo_ckpt_from_jax": zoo_ckpt_from_jax,
               "zoo_kill_recover": zoo_kill_recover,
               "zoo_grid_restore": zoo_grid_restore,
               "grid_step_collectives": grid_step_collectives,
               "encdec_decode": encdec_decode,
               "zoo_elastic_source": zoo_elastic_source,
               "zoo_elastic_restore": zoo_elastic_restore,
               "grid_moe": grid_moe, "grid_lars": grid_lars,
               "grid_collectives": grid_collectives,
               "grid_member_bytes": grid_member_bytes,
               "pipeline_schedules": pipeline_schedules}
    return [workers[name](*args, **kwargs) for name, args, kwargs in cases]
