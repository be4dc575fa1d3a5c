"""The JAX package's two ``ParallelConfig`` factories
(``launch/mesh.py``), without its meshes: the port's ring is one
``torch.distributed`` group (``repro_torch.dist``), and tensor-parallel
trunks over a (data, model) grid are ROADMAP.md A item 4."""
from __future__ import annotations

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
