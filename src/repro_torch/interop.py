"""Carry state and configs from the JAX package into the port.

Both packages name their fields alike, so a JAX ``HeadConfig`` turned into
a dict (``dataclasses.asdict``) builds the port's ``HeadConfig``, and the
JAX package's parameters and optimizer state, taken to the host as numpy
arrays (``np.asarray(exp.state.head_params)``, and the head's aux state
``exp.state.head_aux``: the knn graph, the LSH tables, the sketch hashes),
become the port's ``HybridState``, so a JAX run's state continues in the
port: the cnn trunk's nested params and moments, and DGC's u and v, too. A fitted JAX ``IVFIndex``'s
``state_to_save()``, taken to the host the same way, becomes a ring
member's ``IVFIndex``, and a zoo model's params (``jax.device_get`` of a
JAX ``ZooExperiment``'s ``params``, blocks stacked on a leading [L] axis)
become the port's per-layer modules and back, its SGD moments (which
mirror the params and the head params) likewise, and its ``head_state``
(the sketch heads' bucket weights, the knn graph, the LSH planes and
tables, the hashes) a ring member's. Nothing here imports JAX: only numpy arrays
and plain dicts cross.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.api.heads import HeadState, member_aux, params_block
from repro_torch.configs.base import HeadConfig, ModelConfig
from repro_torch.models import lm
from repro_torch.models.layers import ParamDict
from repro_torch.optim import OptState, tree_leaves, tree_map
from repro_torch.serving.index import IVFIndex
from repro_torch.train import hybrid
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


def paper_state_from_numpy(fe_params: dict, head_params, *,
                           opt_state: Optional[dict] = None, step: int = 0,
                           head_aux=(), aux_spec=None, dgc=None,
                           rank: int = 0, world_size: int = 1,
                           device) -> HybridState:
    """The port's ``HybridState`` for ring member ``rank`` of
    ``world_size``, from the JAX package's state as numpy arrays:
    ``fe_params`` (replicated: empty for the ``feats`` trunk, the nested
    ``{"trunk": ...}`` tree of the cnn trunk, HWIO kernels), the GLOBAL
    head params, of which this member keeps its block (the rows of a [V,
    D] class matrix, the buckets of the sketch heads' [R, B, D]), and
    optionally the optimizer state ``{"step": int, "mu": (fe moments,
    global head moment), "nu": the same or None}`` (the JAX ``OptState``'s
    fields), whose head moments are cut to the same block. ``step`` is the
    state's step counter. ``head_aux`` is the head's aux state as the JAX
    package lays it out; ``aux_spec`` (the port head's ``aux_spec()``)
    says for each entry whether it is ``"sharded"``, with a leading
    [world_size] axis of which this member keeps row ``rank`` (the knn
    head's graph, the selective head's CSR tables), or ``"replicated"``
    and kept whole (the LSH planes, the sketch heads' hash tables). Without
    ``aux_spec`` every entry is sharded. Without ``opt_state`` the state
    carries none: it serves, and ``load_state`` of it cannot train.
    ``dgc`` is the JAX ``DGCState`` as ``{"u": tree, "v": tree}``, each
    leaf with a leading [world_size] axis, of which this member keeps row
    ``rank``; without it the state carries no DGC state.

    The state goes through ``hybrid.state_from_snapshot``, the function a
    checkpoint restore places its tree with."""
    head_aux = tuple(head_aux)
    if aux_spec is None:
        aux_spec = ("sharded",) * len(head_aux)
    opt = None if opt_state is None else OptState(
        step=opt_state["step"], mu=opt_state["mu"], nu=opt_state.get("nu"))
    tree = {"fe": fe_params,
            "head": {"params": head_params, "aux": head_aux},
            "opt": opt, "dgc": dgc, "extra": {"step": step}}
    return hybrid.state_from_snapshot(tree, aux_spec=aux_spec, rank=rank,
                                      world_size=world_size, device=device)


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
                          world_size: int = 1, device,
                          specs=None) -> ParamDict:
    """Ring member ``rank``'s model params from the JAX package's zoo param
    tree as numpy arrays: ``{"embed": {"table"}, "blocks": {...},
    "ln_f": {...}[, "head"]}``, each leaf of ``blocks`` (the ssm and
    hybrid families' ``ssm.*``, ``fuse_attn`` and ``fuse_ssm`` too)
    stacked on a leading [L] axis, which becomes one ``ParamDict`` a
    layer (``models.lm.params_from_tree``). On the ring the trunk is
    replicated, so every member gets all of it; the class matrix's rows
    must divide the ring, whose members each score their own block. On a
    grid (``specs``: ``train.gspmd.member_specs``, by the JAX
    ``param_pspecs``) each leaf is cut to this grid member's slice."""
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} is not on a ring of {world_size}")
    if cfg.vocab_size % world_size:
        raise ValueError(f"the vocab of {cfg.vocab_size} rows does not "
                         f"divide the ring of {world_size}")
    return lm.cut(lm.params_from_tree(tree, cfg, device=device), specs)


def zoo_params_to_numpy(params: ParamDict) -> dict:
    """The inverse of ``zoo_params_from_numpy``: the port's zoo params as
    the JAX package's tree of numpy arrays, each leaf of ``blocks``
    stacked on a leading [L] axis."""
    return tree_map(lambda a: a.detach().cpu().numpy(),
                    lm.params_tree(params))


def zoo_opt_state_from_numpy(opt_state: dict, cfg: ModelConfig, *,
                             rank: int = 0, world_size: int = 1,
                             device, specs=None) -> OptState:
    """Ring member ``rank``'s zoo optimizer state from the JAX package's
    ``ZooExperiment.opt_state`` as numpy arrays, ``{"step", "mu", "nu"}``
    (its ``OptState``'s fields): each moment mirrors (model params, head
    params), the model's part in the stacked layout of
    ``zoo_params_from_numpy``, the head's ``()`` for the W-heads and the
    GLOBAL [R, B, D] bucket moment for the sketch heads, of which this
    member keeps its buckets; on a grid (``specs``) the model moments are
    cut as ``zoo_params_from_numpy`` cuts the params.
    ``ZooExperiment.load_opt_state`` installs it."""
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} is not on a ring of {world_size}")

    def moment(pair):
        if pair is None:
            return None
        model, hp = pair
        return (lm.cut(lm.params_from_tree(model, cfg, device=device),
                       specs),
                params_block(hp, rank, world_size, device)
                if tree_leaves(hp) else ())

    return OptState(step=int(np.asarray(opt_state["step"])),
                    mu=moment(opt_state["mu"]),
                    nu=moment(opt_state.get("nu")))


def zoo_opt_state_to_numpy(opt_state: OptState) -> dict:
    """The inverse of ``zoo_opt_state_from_numpy`` on a ring of one (the
    sketch heads' bucket moments are this member's block): the JAX
    package's ``OptState`` fields as numpy arrays, the model moments
    stacked on [L]."""
    def moment(pair):
        if pair is None:
            return None
        model, hp = pair
        return (zoo_params_to_numpy(model),
                hp.detach().cpu().numpy() if torch.is_tensor(hp) else ())

    return {"step": int(opt_state.step), "mu": moment(opt_state.mu),
            "nu": moment(opt_state.nu)}


def zoo_head_state_from_numpy(head, head_params, head_aux, *, rank: int = 0,
                              world_size: int = 1, device) -> HeadState:
    """Ring member ``rank``'s zoo ``HeadState`` from the JAX package's
    ``ZooExperiment.head_state`` as numpy arrays: ``head_params`` is ``()``
    for the W-heads (their class matrix is the model's) and the GLOBAL
    [R, B, D] bucket weights for the sketch heads (mach, csoft), of which
    this member keeps its buckets; ``head_aux`` is laid out by the port
    head's ``aux_spec()`` (the knn graph and the LSH tables' CSRs with a
    leading [world_size] axis, the LSH planes and the hashes whole).
    ``ZooExperiment.load_head_state`` installs it."""
    aux = member_aux(head_aux, head.aux_spec(), rank=rank,
                     world_size=world_size, device=device)
    if head.params_are_class_weights:
        return HeadState((), aux)
    return HeadState(params_block(head_params, rank, world_size, device),
                     aux)
