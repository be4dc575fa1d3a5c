"""Carry state and configs from the JAX package into the port.

Both packages name their fields alike, so a JAX ``HeadConfig`` turned into
a dict (``dataclasses.asdict``) builds the port's ``HeadConfig``, and the
JAX package's parameters and optimizer state, taken to the host as numpy
arrays (``np.asarray(exp.state.head_params)``, and the knn head's graph
``exp.state.head_aux``), become the port's ``HybridState``, so a JAX run's
state continues in the port. A fitted JAX ``IVFIndex``'s
``state_to_save()``, taken to the host the same way, becomes a ring
member's ``IVFIndex``, and a zoo model's params (``jax.device_get`` of a
JAX ``ZooExperiment``'s ``params``, blocks stacked on a leading [L] axis)
become the port's per-layer modules. Nothing here imports JAX: only numpy
arrays and plain dicts cross.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import HeadConfig, ModelConfig
from repro_torch.models.layers import ParamDict
from repro_torch.optim import OptState
from repro_torch.serving.index import IVFIndex
from repro_torch.train.hybrid import HybridState

# the JAX package's name for the hand-written kernel backend
_BACKEND_NAMES = {"pallas": "kernel"}


def head_config_from_dict(d: dict) -> HeadConfig:
    """The port's ``HeadConfig`` from a dict of the JAX package's fields;
    ``backend="pallas"`` becomes ``"kernel"``. Unknown keys raise."""
    known = {f.name for f in dataclasses.fields(HeadConfig)}
    unknown = sorted(set(d) - known)
    if unknown:
        raise ValueError(f"unknown HeadConfig fields {unknown}")
    d = dict(d)
    if "backend" in d:
        d["backend"] = _BACKEND_NAMES.get(d["backend"], d["backend"])
    return HeadConfig(**d)


def _row_block(a: np.ndarray, rank: int, world_size: int) -> np.ndarray:
    if a.shape[0] % world_size:
        raise ValueError(f"{a.shape[0]} rows do not divide a ring of "
                         f"{world_size}")
    n = a.shape[0] // world_size
    return a[rank * n:(rank + 1) * n]


def _tensor(a, device) -> torch.Tensor:
    # a copy: the JAX package's host arrays are read-only
    return torch.tensor(np.asarray(a), dtype=torch.float32, device=device)


def _moments(pair, rank: int, world_size: int, device):
    """(fe moments dict, GLOBAL [V, D] head moment) -> this member's."""
    if pair is None:
        return None
    fe, head = pair
    return ({k: _tensor(v, device) for k, v in fe.items()},
            _tensor(_row_block(np.asarray(head), rank, world_size), device))


def paper_state_from_numpy(fe_params: dict, head_params, *,
                           opt_state: Optional[dict] = None, step: int = 0,
                           head_aux=(), rank: int = 0, world_size: int = 1,
                           device) -> HybridState:
    """The port's ``HybridState`` for ring member ``rank`` of
    ``world_size``, from the JAX package's state as numpy arrays:
    ``fe_params`` (replicated; empty for the ``feats`` trunk), the GLOBAL
    [V, D] head matrix, of which this member keeps its row block, and
    optionally the optimizer state ``{"step": int, "mu": (fe moments,
    global head moment), "nu": the same or None}`` (the JAX
    ``OptState``'s fields), whose head moments are cut to the same row
    block. ``step`` is the state's step counter. ``head_aux`` is the head's
    aux state as the JAX package shards it, each array with a leading
    [world_size] axis (the knn head's ``CompressedGraph`` offsets,
    neighbors and ranks), of which this member keeps row ``rank``. Without
    ``opt_state`` the state carries none: it serves, and ``load_state`` of
    it cannot train."""
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} is not on a ring of {world_size}")
    w = np.asarray(head_params)
    if w.ndim != 2:
        raise ValueError(f"head_params must be the [V, D] class matrix, got "
                         f"shape {w.shape}")
    fe = {k: torch.as_tensor(np.asarray(v)).to(device)
          for k, v in fe_params.items()}
    block = _tensor(_row_block(w, rank, world_size), device)
    opt = None
    if opt_state is not None:
        opt = OptState(
            step=int(opt_state["step"]),
            mu=_moments(opt_state["mu"], rank, world_size, device),
            nu=_moments(opt_state.get("nu"), rank, world_size, device))
    aux = []
    for a in head_aux:
        a = np.asarray(a)
        if a.shape[0] != world_size:
            raise ValueError(f"head_aux leading axis {a.shape[0]} is not the "
                             f"ring of {world_size}")
        aux.append(torch.tensor(a[rank], device=device))   # a copy
    return HybridState(fe, block, tuple(aux), opt, None, int(step))


def ivf_index_from_numpy(tree: dict, *, rank: int = 0, world_size: int = 1,
                         device) -> IVFIndex:
    """Ring member ``rank``'s ``IVFIndex`` from the JAX package's
    ``IVFIndex.state_to_save()`` as numpy arrays: ``centroids`` [P, C, D],
    ``members`` [P, C, cap], ``counts`` [P, C] and ``meta`` (n_clusters,
    cap, nprobe, iters, version), of which this member keeps row ``rank``.
    The index keeps the JAX experiment's ``version``; installing it into a
    port experiment whose ``weights_version`` differs needs
    ``dataclasses.replace(index, version=...)``, or it is refit."""
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} is not on a ring of {world_size}")
    cent = np.asarray(tree["centroids"], np.float32)
    members = np.asarray(tree["members"], np.int32)
    if cent.ndim != 3 or members.ndim != 3 or (
            cent.shape[0], members.shape[0]) != (world_size, world_size):
        raise ValueError(f"centroids {cent.shape} / members {members.shape} "
                         f"are not [P={world_size}, C, ...]")
    meta = tree["meta"]
    return IVFIndex(
        centroids=torch.tensor(cent[rank], device=device),
        members=torch.tensor(members[rank], device=device),
        counts=np.asarray(tree["counts"], np.int32)[rank].copy(),
        n_clusters=int(np.asarray(meta["n_clusters"])),
        cap=int(np.asarray(meta["cap"])),
        nprobe=int(np.asarray(meta["nprobe"])),
        iters=int(np.asarray(meta["iters"])),
        version=tuple(int(x) for x in np.asarray(meta["version"])))


def zoo_params_from_numpy(tree: dict, cfg: ModelConfig, *, rank: int = 0,
                          world_size: int = 1, device) -> ParamDict:
    """Ring member ``rank``'s model params from the JAX package's zoo param
    tree as numpy arrays: ``{"embed": {"table"}, "blocks": {...},
    "ln_f": {...}[, "head"]}``, each leaf of ``blocks`` stacked on a
    leading [L] axis, which becomes one ``ParamDict`` a layer. The trunk
    is replicated, so every member gets all of it; the class matrix's rows
    must divide the ring, whose members each score their own block."""
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} is not on a ring of {world_size}")
    if cfg.vocab_size % world_size:
        raise ValueError(f"the vocab of {cfg.vocab_size} rows does not "
                         f"divide the ring of {world_size}")

    def convert(node, layer=None):
        if isinstance(node, dict):
            return {k: convert(v, layer) for k, v in node.items()}
        a = np.asarray(node)
        return _tensor(a if layer is None else a[layer], device)

    blocks = tree["blocks"]
    n_layers = len(np.asarray(blocks["ln1"]["scale"]))
    if n_layers != cfg.n_layers:
        raise ValueError(f"{n_layers} stacked layers, config has "
                         f"{cfg.n_layers}")
    params = {k: convert(v) for k, v in tree.items() if k != "blocks"}
    params["blocks"] = [convert(blocks, layer) for layer in range(n_layers)]
    return ParamDict(**params)
