"""Layer-wise top-k gradient sparsification (paper §3.3.2, DGC-style): the
port of the JAX package's ``core/sparsify.py``.

Exact DGC semantics (momentum correction, error accumulation, momentum
factor masking) on the *data-parallel* feature-extractor gradients only;
the class-row gradients never cross the ring (§3.1).

As in the JAX package the exchange is a masked-dense ``psum`` over the
ring (``repro_torch.dist``) whose *wire* bytes are accounted analytically
(``wire_bytes``: 4-byte value + 4-byte index for each sent entry), and
the top-k *selection* is real compute. ``DGCConfig.backend`` picks it:
``"kernel"`` takes the k-th largest |v| from ``kernels.ops.topk_threshold``
(stage 1 on the hand-written ``stage1_topk`` kernel, which launches on a
CUDA tensor or raises), ``"ref"`` from ``topk_threshold_dc`` below (the
same chunked algorithm with a stable sort for stage 1). Both give the
same threshold bit for bit: the k-th largest value does not depend on the
chunking.

Tensors are grouped "with similar size" (Fig. 5) by packing the flattened
leaves, in ``jax.tree.flatten``'s order (dict keys sorted, lists in
order; ``flatten``), into buckets of about ``group_bytes``, and one
selection runs per bucket. Grouped in another order, the same leaves make
other groups, other thresholds and so other updates.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Sequence

import torch

from repro_torch import dist
from repro_torch.configs.base import DGCConfig
from repro_torch.kernels import ops
from repro_torch.optim import tree_map


class DGCState(NamedTuple):
    u: dict  # momentum-corrected accumulator (per FE leaf)
    v: dict  # error-feedback residual (per FE leaf)


def init_dgc_state(fe_params) -> DGCState:
    z = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                       device=p.device), fe_params)
    return DGCState(u=z, v=tree_map(torch.clone, z))


def flatten(tree, *, with_paths: bool = False):
    """(leaves in ``jax.tree.flatten``'s order, ``unflatten(leaves)``
    rebuilding ``tree``'s structure, dict keys sorted as JAX rebuilds
    them). Dict keys are taken sorted; lists and tuples in order, a
    NamedTuple (``OptState``) by its fields; ``None`` holds no leaf.

    With ``with_paths`` the leaves come as ``(path, leaf)`` pairs, the
    path named as the JAX package's checkpoints key a leaf: the steps from
    the root joined by ``/``, a dict key by itself, a list or tuple entry
    by its index, a NamedTuple field by its name (``opt/mu/0/trunk/stem``).
    """
    leaves = []

    def walk(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], path + (str(k),))
        elif isinstance(node, (tuple, list)):
            names = getattr(node, "_fields", range(len(node)))
            for name, v in zip(names, node):
                walk(v, path + (str(name),))
        elif node is not None:
            leaves.append(("/".join(path), node) if with_paths else node)

    walk(tree, ())

    def unflatten(new):
        it = iter(new)

        def build(node):
            if isinstance(node, dict):
                return {k: build(node[k]) for k in sorted(node)}
            if hasattr(node, "_fields"):
                return type(node)(*(build(v) for v in node))
            if isinstance(node, (tuple, list)):
                return type(node)(build(v) for v in node)
            return None if node is None else next(it)

        return build(tree)

    return leaves, unflatten


# ---------------------------------------------------------------------------
# top-k selection backends
# ---------------------------------------------------------------------------


def topk_threshold_ref(flat_abs, k: int):
    """|v| threshold keeping exactly the top-k entries: the k-th value of
    a descending sort."""
    vals, _ = ops.topk_stable(flat_abs, k)
    return vals[-1]


def topk_threshold_dc(flat_abs, k: int, chunk: int = 2048):
    """Divide-and-conquer top-k (paper Fig. 5) in plain torch ops: chunk ->
    per-chunk top-k -> top-k of the M*k survivors. Exact for thresholding:
    the global k-th largest is always among the per-chunk survivors."""
    n = flat_abs.shape[0]
    if n <= chunk:
        return topk_threshold_ref(flat_abs, min(k, n))
    x = torch.nn.functional.pad(flat_abs, (0, (-n) % chunk),
                                value=float("-inf"))
    kk = min(k, chunk)
    sub, _ = ops.topk_stable(x.reshape(-1, chunk), kk)   # per-chunk stage
    merged = sub.reshape(-1)
    vals, _ = ops.topk_stable(merged, min(k, merged.shape[0]))
    return vals[-1]


# ---------------------------------------------------------------------------
# tensor grouping
# ---------------------------------------------------------------------------


def group_leaves(leaves: Sequence, group_bytes: int):
    """Pack leaf indices into buckets of ~group_bytes (paper's grouping)."""
    groups, cur, cur_bytes = [], [], 0
    for i, leaf in enumerate(leaves):
        nbytes = leaf.numel() * 4
        if cur and cur_bytes + nbytes > group_bytes:
            groups.append(cur)
            cur, cur_bytes = [], 0
        cur.append(i)
        cur_bytes += nbytes
    if cur:
        groups.append(cur)
    return groups


# ---------------------------------------------------------------------------
# the exchange
# ---------------------------------------------------------------------------


def dgc_exchange(grads, state: DGCState, cfg: DGCConfig, *,
                 n_workers: int = 1):
    """One DGC round on the FE gradient tree of this ring member.

    The masked tensors are summed over the ring (``dist.psum``; the
    identity without a process group) and divided by ``n_workers``.
    Returns (averaged dense update tree, new state, info): ``wire_bytes``
    (8 bytes a sent entry, summed over groups), ``dense_bytes`` (4 a
    gradient entry), ``compression`` (their ratio) and ``thresholds``
    (each group's |v| threshold, in group order)."""
    topk = functools.partial(
        ops.topk_threshold if cfg.backend == "kernel" else topk_threshold_dc,
        chunk=cfg.chunk)
    leaves, unflatten = flatten(grads)
    u_leaves, _ = flatten(state.u)
    v_leaves, _ = flatten(state.v)

    groups = group_leaves(leaves, cfg.group_bytes)
    n_leaves = len(leaves)
    out, new_u, new_v = [None] * n_leaves, [None] * n_leaves, [None] * n_leaves
    dev = leaves[0].device if leaves else None
    wire_bytes = torch.zeros((), dtype=torch.float32, device=dev)
    dense_bytes = 0
    thresholds = []

    for grp in groups:
        us, vs = [], []
        for i in grp:
            g = leaves[i].float().reshape(-1)
            # momentum correction, momentum * u + g in one pass (a fused
            # multiply-add; XLA fuses the JAX step's so in some fusions and
            # not in others, so u may differ from it in the last bit)
            u = torch.add(g, u_leaves[i].reshape(-1), alpha=cfg.momentum)
            us.append(u)
            vs.append(v_leaves[i].reshape(-1) + u)           # error feedback
        vflat = torch.cat(vs) if len(vs) > 1 else vs[0]
        n = vflat.shape[0]
        k = max(1, int(n * (1.0 - cfg.sparsity)))
        vabs = vflat.abs()
        thr = topk(vabs, k)
        thresholds.append(thr)
        mask = vabs >= thr
        zero = torch.zeros((), dtype=vflat.dtype, device=vflat.device)
        send = torch.where(mask, vflat, zero)
        agg = dist.psum(send) / n_workers
        resid = torch.where(mask, zero, vflat)
        wire_bytes = wire_bytes + mask.sum().float() * 8.0
        dense_bytes += n * 4

        off = 0
        for j, i in enumerate(grp):
            shape, sz = leaves[i].shape, leaves[i].numel()
            sl = slice(off, off + sz)
            out[i] = agg[sl].reshape(shape)
            new_v[i] = resid[sl].reshape(shape)
            um = us[j]
            if cfg.factor_masking:
                um = torch.where(mask[sl], zero, um)           # factor masking
            new_u[i] = um.reshape(shape)
            off += sz

    dense = torch.tensor(float(dense_bytes), dtype=torch.float32, device=dev)
    info = {"wire_bytes": wire_bytes, "dense_bytes": dense,
            "compression": dense / torch.clamp(wire_bytes, min=1.0),
            "thresholds": (torch.stack(thresholds) if thresholds
                           else torch.zeros((0,), device=dev))}
    return (unflatten(out),
            DGCState(u=unflatten(new_u), v=unflatten(new_v)), info)


def dense_exchange(grads, *, n_workers: int = 1):
    """Baseline dense all-reduce of FE grads (paper's no-DGC path)."""
    return tree_map(lambda g: dist.psum(g) / n_workers, grads)
