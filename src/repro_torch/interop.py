"""Carry state and configs from the JAX package into the port.

Both packages name their fields alike, so a JAX ``HeadConfig`` turned into
a dict (``dataclasses.asdict``) builds the port's ``HeadConfig``, and the
JAX package's parameters, taken to the host as numpy arrays
(``np.asarray(exp.state.head_params)``), become the port's
``HybridState``. Nothing here imports JAX: only numpy arrays and plain
dicts cross.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import HeadConfig
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


def paper_state_from_numpy(fe_params: dict, head_params, *, rank: int = 0,
                           world_size: int = 1, device) -> HybridState:
    """The port's ``HybridState`` for ring member ``rank`` of
    ``world_size``, from the JAX package's parameters as numpy arrays:
    ``fe_params`` (replicated; empty for the ``feats`` trunk) and the
    GLOBAL [V, D] head matrix, of which this member keeps its row block.
    Optimizer state is not carried: the port serves, it does not train
    yet."""
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} is not on a ring of {world_size}")
    w = np.asarray(head_params)
    if w.ndim != 2:
        raise ValueError(f"head_params must be the [V, D] class matrix, got "
                         f"shape {w.shape}")
    fe = {k: torch.as_tensor(np.asarray(v)).to(device)
          for k, v in fe_params.items()}
    # a copy: the JAX package's host arrays are read-only
    block = torch.tensor(_row_block(w, rank, world_size),
                         dtype=torch.float32, device=device)
    return HybridState(fe, block, (), None, None, 0)
