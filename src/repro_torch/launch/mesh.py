"""The JAX package's two ``ParallelConfig`` factories
(``launch/mesh.py``), and the port's two ways of joining the processes
``torchrun`` started into one ``torch.distributed`` group:

* ``launch_ring`` for the paper system: the ring of the JAX trainer's one
  mesh axis (``AXIS = "hybrid"`` in ``train/hybrid.py``), every member a
  data-parallel FE replica and a row block of the class matrix. It is the
  ungridded ring of ``repro_torch.dist`` (no ``dist.grid``), the layout
  of ``dist.spawn_ring`` that every paper test runs: its one axis is
  ``"model"``, and the paper trainer reads the ring's size and this
  member's index off it (ROADMAP A item 5 keeps this ring when the zoo's
  goes).
* ``launch_grid`` for the zoo: the group laid out as a (data, model) grid
  (``repro_torch.dist.grid``), by the JAX ``ZooExperiment``'s default
  shape (``default_grid``: ``n_model = min(4, world)``, ``n_data = world
  // n_model``) or an explicit ``n_model``.

Both take the backend ``_join_group`` picks: NCCL when every process of
a node has a card of its own, gloo on the CPU, and gloo with the CUDA
tensors' collectives staged through host memory only with
``share_cards=True`` (two processes on one card, which NCCL refuses).
"""
from __future__ import annotations

import contextlib
import os
from typing import Optional

from repro_torch import dist
from repro_torch.configs.base import ParallelConfig


def make_parallel_config(*, multi_pod: bool = False, remat: str = "full",
                         fsdp: bool = True) -> ParallelConfig:
    """The production policy: (16, 16) (data, model) on one pod, (2, 16,
    16) (pod, data, model) on two; with ``fsdp`` the params' embed dim
    goes over ``data`` ahead of the activation rules."""
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    shape = (2, 16, 16) if multi_pod else (16, 16)
    cfg = ParallelConfig(mesh_shape=shape, axis_names=axes, remat=remat)
    if fsdp:
        cfg = ParallelConfig(
            mesh_shape=shape, axis_names=axes, remat=remat,
            param_rules=(("embed", "data"),) + cfg.rules)
    return cfg


def make_host_parallel_config(n_data: int = 2, n_model: int = 4,
                              remat: str = "none") -> ParallelConfig:
    """The small (data, model) policy of the JAX package's host tests."""
    return ParallelConfig(mesh_shape=(n_data, n_model),
                          axis_names=("data", "model"), remat=remat)


def default_grid(world: int, n_model: Optional[int] = None) -> tuple:
    """The JAX ``ZooExperiment``'s layout of ``world`` devices: (n_data,
    n_model), ``n_model = min(4, world)`` unless given, ``n_data = world
    // n_model``."""
    n_model = n_model or min(4, world)
    if world % n_model:
        raise ValueError(f"n_model {n_model} does not divide {world} "
                         f"members")
    return world // n_model, n_model


def _join_group(device: str, world: int, share_cards: bool) -> str:
    """Join the group ``torchrun`` describes (its environment) and return
    the backend: NCCL when every process of the node has a card of its
    own (each takes its ``LOCAL_RANK``'s), gloo on the CPU; where a node
    runs more processes than it has cards, NCCL cannot run and gloo stages
    every collective of CUDA tensors through host memory, which is slow:
    that takes ``share_cards=True``, and raises otherwise."""
    import torch
    import torch.distributed as tdist

    backend = "gloo"
    if device.startswith("cuda"):
        local = int(os.environ.get("LOCAL_RANK", "0"))
        procs = int(os.environ.get("LOCAL_WORLD_SIZE", str(world)))
        cards = torch.cuda.device_count()
        if cards >= procs:
            torch.cuda.set_device(local)
            backend = "nccl"
        elif not share_cards:
            raise ValueError(
                f"{procs} processes on a node of {cards} cards: NCCL "
                f"wants a card a process, and gloo would stage every "
                f"collective through host memory; start one process a "
                f"card, or pass --share-cards to take gloo")
    tdist.init_process_group(backend)
    return backend


@contextlib.contextmanager
def launch_ring(device: str = "cuda", share_cards: bool = False):
    """The paper system's ring (module docstring). Under ``torchrun``
    (``WORLD_SIZE`` > 1 in the environment): join the group
    (``_join_group``) and yield the ring's size and the group's backend;
    the group is destroyed on exit. In a process already in a group (a
    ``dist.spawn_ring`` member): that group, as it is. Alone: the ring of
    one, (1, None). Every process must enter it."""
    import torch.distributed as tdist

    if tdist.is_available() and tdist.is_initialized():
        yield tdist.get_world_size(), tdist.get_backend()
        return
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world == 1:
        yield 1, None
        return
    backend = _join_group(device, world, share_cards)
    try:
        yield world, backend
    finally:
        tdist.destroy_process_group()


@contextlib.contextmanager
def launch_grid(device: str = "cuda", n_model: Optional[int] = None,
                share_cards: bool = False):
    """The zoo's grid (module docstring). Under ``torchrun``
    (``WORLD_SIZE`` > 1 in the environment): join the group
    (``_join_group``), lay it out as ``default_grid(world, n_model)`` and
    yield the (n_data, n_model) shape and the group's backend; the group
    is destroyed on exit. Alone: nothing to join, the ring of one (an
    ``n_model`` other than 1 raises). Every process must enter it."""
    import torch.distributed as tdist

    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world == 1:
        if n_model not in (None, 1):
            raise ValueError(f"--n-model {n_model} wants {n_model} "
                             f"processes: start them with torchrun "
                             f"--nproc-per-node")
        yield (1, 1), None
        return
    shape = default_grid(world, n_model)
    backend = _join_group(device, world, share_cards)
    try:
        dist.grid(*shape)
        yield shape, backend
    finally:
        dist.release_grid()
        tdist.destroy_process_group()
