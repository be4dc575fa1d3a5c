"""Parity workers: what each member of a ring runs when the port is held
against the JAX package on the same numpy arrays.

``repro_torch.dist.spawn_ring`` re-imports a worker by name in fresh
processes, so workers live here rather than in test files. Each takes
numpy arrays and plain dicts (the GLOBAL class matrix; every member keeps
its own row block) and returns numpy arrays, so the caller can compare
them with the JAX package's shard_map results directly. Both run on the
CPU.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import dist
from repro_torch.core import sharded_softmax as ss

BACKENDS = ("ref", "kernel")


def _np(t):
    return t.detach().cpu().numpy()


def _my_rows(w: np.ndarray) -> torch.Tensor:
    n = w.shape[0] // dist.world_size()
    r = dist.rank()
    return torch.from_numpy(np.ascontiguousarray(w[r * n:(r + 1) * n]))


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
    from repro_torch import interop
    from repro_torch.api import Experiment

    cfg = interop.head_config_from_dict(head_cfg)
    v, d = w.shape
    exp = Experiment.from_config(system="paper", classes=v, feat_dim=d,
                                 batch=inputs.shape[0], head=cfg,
                                 device="cpu")
    exp.load_state(interop.paper_state_from_numpy(
        {}, w, rank=dist.rank(), world_size=dist.world_size(),
        device="cpu"))
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
              eval_inputs: dict, data_seed: int = 0, head_aux=()) -> dict:
    """A CPU ``PaperExperiment`` on this member, started from the JAX
    package's class matrix and LARS/SGD moment and, for the knn head, its
    graph (``interop``), trained ``steps`` steps with FCCS batch growth on
    ``numpy_batch`` data. Returns the history rows, the final class matrix
    gathered over the ring, the evaluation accuracy, the weights_version
    trail and the head's final aux state."""
    from repro_torch import interop
    from repro_torch.api import Experiment
    from repro_torch.configs.base import FCCSConfig, TrainConfig

    v, d = w0.shape
    cfg = interop.head_config_from_dict(head_cfg)
    tcfg = TrainConfig(**train_cfg, fccs=FCCSConfig(**fccs_cfg))
    exp = Experiment.from_config(
        system="paper", classes=v, feat_dim=d, batch=batch, head=cfg,
        train=tcfg, device="cpu", log_every=0,
        data_fn=lambda t, b: numpy_batch(t, b, classes=v, dim=d,
                                         seed=data_seed))
    exp.load_state(interop.paper_state_from_numpy(
        {}, w0, opt_state={"step": 0, "mu": ({}, mu0), "nu": None},
        head_aux=head_aux, rank=dist.rank(), world_size=dist.world_size(),
        device="cpu"))
    versions = [exp.weights_version]
    hist = exp.fit(steps, use_fccs_batch=True,
                   step_hook=lambda t: versions.append(exp.weights_version))
    return {"history": hist,
            "w": _np(dist.all_gather(exp.state.w_head, dim=0)),
            "eval": exp.evaluate(eval_inputs),
            "versions": versions + [exp.weights_version],
            "aux": [_np(a) for a in exp.state.head_aux]}


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


def run_all(cases: list) -> list:
    """Run ``(worker name, args, kwargs)`` cases in order on this member,
    so one spawned ring serves a whole group of tests."""
    workers = {"serve_bodies": serve_bodies, "paper_serve": paper_serve,
               "collectives": collectives, "loss_body": loss_body,
               "paper_fit": paper_fit, "collective_grads": collective_grads,
               "knn_graph_build": knn_graph_build,
               "knn_loss_body": knn_loss_body, "ring_shift": ring_shift}
    return [workers[name](*args, **kwargs) for name, args, kwargs in cases]
