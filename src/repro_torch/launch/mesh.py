"""The JAX package's two ``ParallelConfig`` factories
(``launch/mesh.py``), and the port's grid: ``launch_grid`` joins the
processes ``torchrun`` started into one ``torch.distributed`` group laid
out as a (data, model) grid (``repro_torch.dist.grid``), by the JAX
``ZooExperiment``'s default shape (``default_grid``: ``n_model = min(4,
world)``, ``n_data = world // n_model``) or an explicit ``n_model``."""
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


@contextlib.contextmanager
def launch_grid(device: str = "cuda", n_model: Optional[int] = None,
                share_cards: bool = False):
    """Under ``torchrun`` (``WORLD_SIZE`` > 1 in the environment): join the
    group, lay it out as ``default_grid(world, n_model)`` and yield the
    (n_data, n_model) shape and the group's backend; the group is
    destroyed on exit. The backend is NCCL when every process has a card
    of its own, gloo on the CPU. Where a node runs more processes than it
    has cards, NCCL cannot run and gloo stages every collective of CUDA
    tensors through host memory, which is slow: that takes
    ``share_cards=True``, and raises otherwise. Alone: nothing to join,
    the ring of one (an ``n_model`` other than 1 raises). Every process
    must enter it."""
    import torch
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
    try:
        dist.grid(*shape)
        yield shape, backend
    finally:
        dist.release_grid()
        tdist.destroy_process_group()
