"""Fused score + running top-k': the inner loop of the exact KNN graph build
(paper §3.2.2).

``dist_topk`` is the port of the Pallas TPU kernel
``src/repro/kernels/knn_dist_topk.py`` ``dist_topk`` / ``_dist_topk_kernel``.
On CUDA tensors it launches the hand-written kernel in
``csrc/knn_dist_topk.cu`` (each block owns 256 query rows and sweeps every
key row in tiles of 128: a producer warp streams 64-deep slabs of the
block's Q rows and the tile's K rows by TMA, two consumer warpgroups take
the bf16 products by ``wgmma`` with fp32 sums and fold the scores that beat
a row's k'-th entry into its running top-k'; past a depth of 2,048 each
64-deep chunk's products are added to fp32 sums by round-to-nearest adds,
since the tensor cores' own accumulation truncates and would drift a
score of ~1 by up to D / 16 units in the last place); on CPU tensors it
runs ``dist_topk_plain``, the same function in plain torch ops.

Bound on an H100 SXM at the graph build's shapes (Q = K = the 1,020,250
unit class rows in bf16, D = 512, k' = 32): 1.066 PFLOP of bf16 products,
1.08 s at the 989 TFLOP/s tensor-core rate, far above the 2.09 GB of
inputs (0.62 ms): bound by operations.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.cost import Cost, charges

LAUNCHES = 0          # kernel launches (one per dist_topk call on the card)
MAX_KPRIME = 32       # the CUDA kernel keeps a row's slots one per lane
MAX_DIM = 8192        # Q and K stream over depth: no cap from shared memory;
#                       the widest the card has checked (chameleon-34B)


def cost(nq: int, nk: int, d: int, kprime: int) -> Cost:
    """``dist_topk`` of nq queries over nk keys at depth d: the bf16
    product's 2 nq nk d operations; q and k read (bf16), the [nq, k']
    values and ids written."""
    return Cost(2.0 * nq * nk * d, 2.0 * (nq * d + nk * d) + 8.0 * nq * kprime,
                "bf16")


def dist_topk_plain(q, kmat, kprime: int, col_offset: int = 0):
    """Plain torch version: the fp32 product of the bf16 inputs, then a
    stable top-k' (ties to the lowest column). Slots past Nk are
    (-inf, -1)."""
    from repro_torch.kernels.ops import topk_stable
    s = q.float() @ kmat.float().T
    kk = min(kprime, kmat.shape[0])
    vals, pos = topk_stable(s, kk)
    ids = pos + col_offset
    if kk < kprime:
        pad = kprime - kk
        vals = torch.nn.functional.pad(vals, (0, pad), value=float("-inf"))
        ids = torch.nn.functional.pad(ids, (0, pad), value=-1)
    return vals, ids.to(torch.int32)


def _lib():
    fn = build.library("knn_dist_topk").dist_topk_launch
    if not fn.argtypes:
        fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 4
                       + [ctypes.c_void_p] * 3)
        fn.restype = ctypes.c_int
    return fn


@charges("dist_topk", lambda q, kmat, kprime, **k: cost(
    q.shape[0], kmat.shape[0], q.shape[1], kprime))
def dist_topk(q, kmat, kprime: int, *, col_offset: int = 0):
    """q [Nq, D] x kmat [Nk, D], both bf16 -> (vals [Nq, k'] fp32
    descending, ids [Nq, k'] int32 columns + ``col_offset``). Ties go to
    the lowest column; slots past Nk are (-inf, -1)."""
    global LAUNCHES
    if q.dtype != torch.bfloat16 or kmat.dtype != torch.bfloat16:
        raise TypeError(f"dist_topk takes bfloat16, got {q.dtype}/"
                        f"{kmat.dtype}")
    if q.dim() != 2 or kmat.dim() != 2 or q.shape[1] != kmat.shape[1]:
        raise ValueError(f"dist_topk: shapes q {tuple(q.shape)}, kmat "
                         f"{tuple(kmat.shape)}")
    if kprime < 1:
        raise ValueError(f"kprime must be positive, got {kprime}")
    if q.device.type == "cpu" and kmat.device.type == "cpu":
        return dist_topk_plain(q, kmat, kprime, col_offset)
    if q.device.type != "cuda" or kmat.device != q.device:
        raise ValueError(f"dist_topk: tensors on {q.device} and "
                         f"{kmat.device}")
    nq, d = q.shape
    nk = kmat.shape[0]
    if kprime > MAX_KPRIME:
        raise ValueError(f"the CUDA dist_topk takes k' <= {MAX_KPRIME}, got "
                         f"{kprime}")
    if d % 8 or d > MAX_DIM:
        raise ValueError(f"the CUDA dist_topk needs D % 8 == 0 and D <= "
                         f"{MAX_DIM}, got {d}")
    if not (q.is_contiguous() and kmat.is_contiguous()):
        raise ValueError("dist_topk: q and kmat must be contiguous")
    if q.data_ptr() % 16 or kmat.data_ptr() % 16:
        raise ValueError("the CUDA dist_topk needs 16-byte aligned q and kmat")
    if not nk:                  # no keys: every slot is (-inf, -1)
        return (torch.full((nq, kprime), float("-inf"), device=q.device),
                torch.full((nq, kprime), -1, device=q.device,
                           dtype=torch.int32))
    vals = torch.empty((nq, kprime), device=q.device, dtype=torch.float32)
    ids = torch.empty((nq, kprime), device=q.device, dtype=torch.int32)
    if nq:
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _lib()(q.data_ptr(), kmat.data_ptr(), nq, nk, d, kprime,
                     vals.data_ptr(), ids.data_ptr(), stream)
        build.check(err, "dist_topk")
        LAUNCHES += 1
    if col_offset:
        ids = torch.where(ids >= 0, ids + col_offset, ids)
    return vals, ids
