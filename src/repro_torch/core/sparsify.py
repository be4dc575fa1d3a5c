"""Feature-extractor gradient exchange: the dense half of the JAX
package's ``core/sparsify.py``.

``dense_exchange`` is the paper's no-DGC baseline: a sum of every
member's FE gradients over the ring, divided by the ring size. DGC
(momentum correction, error feedback, top-k sparsification) is not ported
yet: ``require_dense`` refuses a config that enables it.
"""
from __future__ import annotations

from repro_torch import dist
from repro_torch.configs.base import DGCConfig
from repro_torch.optim import tree_map


def require_dense(dcfg: DGCConfig) -> None:
    if dcfg.enabled:
        raise NotImplementedError(
            "DGC gradient sparsification is not ported to torch yet "
            "(ROADMAP.md queue A.5)")


def dense_exchange(grads, *, n_workers: int = 1):
    """Baseline dense all-reduce of FE grads (paper's no-DGC path)."""
    return tree_map(lambda g: dist.psum(g) / n_workers, grads)
