"""Fused gather + score + top-k over IVF candidates: the rerank of the IVF
serving index (``repro_torch.serving.index``).

``ivf_rerank`` is the port of the Pallas TPU kernel
``src/repro/kernels/ivf_rerank.py`` ``ivf_rerank`` / ``_rerank_kernel``, on
the JAX package's candidate lists ``cand`` [B, A]; ``ivf_rerank_probed``
takes what the serving path holds instead, the index's ``members`` [C, cap]
and each query's probed clusters ``probe`` [B, P], and ranks
``members[probe].reshape(B, P * cap)`` without building it. On CUDA tensors
both launch the one hand-written kernel in ``csrc/ivf_rerank.cu``
(cluster-major: each probed cluster's rows are read once, 128 slots an
item, by bulk copies into a ring, for every query that probes it; fp32 dot
products; a last launch merges each query's partials); on CPU tensors they
run ``ivf_rerank_plain``, the same function in plain torch ops.

The order of the result is the TPU kernel's: values descending, and equal
values in the order of their candidate positions (slot s of the rank-p
probe is position p * cap + s), not of their row ids. Slots a row cannot
fill with a real candidate are (-inf, -1).

Bound on an H100 SXM at the serving shapes (B = 64, P = 31 clusters of
1,263 slots of the 1,020,250 x 512 shard, k = 5): 2.57 GFLOP, 38 us at the
fp32 rate, against 1.84 GB for the union of the probed rows (0.55 ms at
3.35 TB/s; 5.1 GB if each query gathered its own): bound by bytes.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.cost import Cost, charges

LAUNCHES = 0          # kernel launches (one per call on the card)
MAX_K = 32            # the CUDA kernel keeps a row's slots one per lane
MAX_DIM = 8192        # rows stream in 512-float pieces; queries in tiles
#                       (one query a tile at 8,192: 32 KB of shared memory)
_PLAIN_ELEMS = 1 << 28   # gathered floats per chunk of the plain version


def cost(b: int, d: int, k: int, union: int, n_real: int,
         n_entries: int) -> Cost:
    """A rerank of b queries at depth d: 2 d operations for each of its
    ``n_real`` real candidates (CUDA cores, fp32); every distinct row it
    scores (``union``) read once, f, the ``n_entries`` candidate entries
    (the probe's, for the probed entry) and the [b, k] result."""
    return Cost(2.0 * n_real * d, 4.0 * d * union + 4.0 * b * d
                + 4.0 * n_entries + 8.0 * b * k, "fp32")


def _cand_cost(f, w, cand, k: int) -> Cost:
    real = cand[cand >= 0]
    return cost(f.shape[0], f.shape[1], k, int(torch.unique(real).numel()),
                int(real.numel()), cand.numel())


def _probed_cost(f, w, members, probe, k: int) -> Cost:
    union = int((members[torch.unique(probe).long()] >= 0).sum())
    n_real = int((members[probe.long()] >= 0).sum())
    return cost(f.shape[0], f.shape[1], k, union, n_real, probe.numel())


def ivf_rerank_plain(f, w, cand, k: int):
    """Plain torch version: gather the candidate rows (ids clipped into the
    shard), fp32 dot products with the query, -inf at the -1 slots, then a
    stable top-k (equal values in candidate-position order). Slots past the
    real candidates are (-inf, -1). Queries go in chunks so the gathered
    rows stay near 1 GB."""
    from repro_torch.kernels.ops import topk_stable
    b, d = f.shape
    v, a = w.shape[0], cand.shape[1]
    kk = min(k, a)
    rows = max(1, _PLAIN_ELEMS // max(1, a * d))
    vals, ids = [], []
    for r0 in range(0, b, rows):
        c = cand[r0:r0 + rows]
        wc = w[c.clamp(0, v - 1).long()].float()              # [b', A, D]
        s = torch.einsum("bd,bad->ba", f[r0:r0 + rows].float(), wc)
        s = torch.where(c >= 0, s, float("-inf"))
        top, pos = topk_stable(s, kk)
        vals.append(top)
        ids.append(torch.where(top > float("-inf"),
                               c.gather(1, pos.long()), -1))
    vals, ids = torch.cat(vals), torch.cat(ids).to(torch.int32)
    if kk < k:
        pad = k - kk
        vals = torch.nn.functional.pad(vals, (0, pad), value=float("-inf"))
        ids = torch.nn.functional.pad(ids, (0, pad), value=-1)
    return vals, ids


def ivf_rerank_probed_plain(f, w, members, probe, k: int):
    """Plain torch version of ``ivf_rerank_probed``: the candidates built
    as the serving path's ``ref`` backend builds them."""
    cand = members[probe.long()].reshape(f.shape[0], -1)
    return ivf_rerank_plain(f, w, cand, k)


def check_cuda_limits(d: int, k: int) -> None:
    """Raise ValueError for what the CUDA kernel does not take."""
    if not 1 <= k <= MAX_K:
        raise ValueError(f"the CUDA ivf_rerank takes 1 <= k <= {MAX_K}, got "
                         f"{k} (ROADMAP.md B.7)")
    if d % 4 or not 4 <= d <= MAX_DIM:
        raise ValueError(f"the CUDA ivf_rerank needs D % 4 == 0 and D <= "
                         f"{MAX_DIM}, got {d}")


def _lib():
    lib = build.library("ivf_rerank")
    fn = lib.ivf_rerank_launch
    if not fn.argtypes:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
                       + [ctypes.c_void_p] * 5)
        fn.restype = ctypes.c_int
        lib.ivf_rerank_segments.argtypes = [ctypes.c_int]
        lib.ivf_rerank_segments.restype = ctypes.c_int
        lib.ivf_rerank_plan_ints.argtypes = [ctypes.c_int] * 3
        lib.ivf_rerank_plan_ints.restype = ctypes.c_longlong
    return lib


def _check(f, w, k, *lists):
    """Check the arguments of either entry; True if they lie on a card
    (launch the kernel), False if on the CPU (run the plain version)."""
    if f.dtype != torch.float32 or w.dtype != torch.float32:
        raise TypeError(f"ivf_rerank takes float32 f and w, got {f.dtype}/"
                        f"{w.dtype}")
    if any(t.dtype != torch.int32 for t in lists):
        raise TypeError(f"ivf_rerank takes int32 candidates, got "
                        f"{[t.dtype for t in lists]}")
    if k < 1:
        raise ValueError(f"k must be positive, got {k}")
    devices = {t.device.type for t in (f, w, *lists)}
    if devices == {"cpu"}:
        return False
    if devices != {"cuda"} or len({t.device for t in (f, w, *lists)}) != 1:
        raise ValueError(f"ivf_rerank: tensors on "
                         f"{[str(t.device) for t in (f, w, *lists)]}")
    check_cuda_limits(f.shape[1], k)
    if not (f.is_contiguous() and w.is_contiguous()
            and all(t.stride(-1) == 1 for t in lists)):
        raise ValueError("ivf_rerank: f and w must be contiguous, the "
                         "candidate rows too")
    if f.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("the CUDA ivf_rerank needs 16-byte aligned f and w")
    return True


def _launch(f, w, groups, probe, k: int):
    """One launch over `groups` [G, L] (-1 padded local ids, rows
    ``groups.stride(0)`` apart) for the queries f [B, D]: query b ranks
    the groups ``probe[b]`` in order, or (probe None) group b alone."""
    global LAUNCHES
    b, d = f.shape
    v = w.shape[0]
    g, length = groups.shape
    p = 1 if probe is None else probe.shape[1]
    if b == 0 or length == 0 or p == 0 or g == 0 or v == 0:
        return (torch.full((b, k), float("-inf"), device=f.device),
                torch.full((b, k), -1, device=f.device, dtype=torch.int32))
    if p * length >= 2**31 - 1:
        raise ValueError(f"ivf_rerank: {p} x {length} candidate positions do "
                         f"not fit int32")
    vals = torch.empty((b, k), device=f.device, dtype=torch.float32)
    ids = torch.empty((b, k), device=f.device, dtype=torch.int32)
    lib = _lib()
    nseg = lib.ivf_rerank_segments(length)
    part_v = torch.empty((b, p, nseg, k), device=f.device,
                         dtype=torch.float32)
    part_p = torch.empty((b, p, nseg, k), device=f.device, dtype=torch.int32)
    plan = None if probe is None else torch.empty(
        (lib.ivf_rerank_plan_ints(g, b, p),), device=f.device,
        dtype=torch.int32)
    stream = torch.cuda.current_stream(f.device).cuda_stream
    err = lib.ivf_rerank_launch(
        f.data_ptr(), w.data_ptr(), groups.data_ptr(),
        None if probe is None else probe.data_ptr(),
        None if plan is None else plan.data_ptr(), b, v, d, g, length,
        groups.stride(0), p, k, part_v.data_ptr(), part_p.data_ptr(),
        vals.data_ptr(), ids.data_ptr(), stream)
    build.check(err, "ivf_rerank")
    LAUNCHES += 1
    return vals, ids


@charges("ivf_rerank", _cand_cost)
def ivf_rerank(f, w, cand, k: int):
    """f [B, D] fp32; w [V, D] fp32 (rows gathered in the kernel); cand
    [B, A] int32 local row ids, -1 marking padding. Returns (vals [B, k]
    fp32 descending, ids [B, k] int32 row ids, -1 where a row has fewer
    than k real candidates); equal values keep candidate-position order."""
    if (f.dim() != 2 or w.dim() != 2 or cand.dim() != 2
            or f.shape[1] != w.shape[1] or cand.shape[0] != f.shape[0]):
        raise ValueError(f"ivf_rerank: shapes f {tuple(f.shape)}, w "
                         f"{tuple(w.shape)}, cand {tuple(cand.shape)}")
    if not _check(f, w, k, cand):
        return ivf_rerank_plain(f, w, cand, k)
    return _launch(f, w, cand, None, k)


@charges("ivf_rerank", _probed_cost)
def ivf_rerank_probed(f, w, members, probe, k: int):
    """``ivf_rerank`` of ``members[probe].reshape(B, P * cap)``, the
    candidates of the IVF serve, without building them: members [C, cap]
    int32 local row ids of each cluster, -1 padded; probe [B, P] int32
    cluster ids in [0, C), each query's probes in rank order. Slot s of
    the rank-p probe is candidate position p * cap + s."""
    if (f.dim() != 2 or w.dim() != 2 or members.dim() != 2
            or probe.dim() != 2 or f.shape[1] != w.shape[1]
            or probe.shape[0] != f.shape[0]):
        raise ValueError(f"ivf_rerank_probed: shapes f {tuple(f.shape)}, w "
                         f"{tuple(w.shape)}, members {tuple(members.shape)}, "
                         f"probe {tuple(probe.shape)}")
    if not _check(f, w, k, members, probe):
        return ivf_rerank_probed_plain(f, w, members, probe, k)
    if not probe.is_contiguous():
        raise ValueError("ivf_rerank_probed: probe must be contiguous")
    return _launch(f, w, members, probe, k)
