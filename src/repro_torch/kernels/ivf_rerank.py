"""Fused gather + score + top-k over IVF candidates: the rerank of the IVF
serving index (``repro_torch.serving.index``).

``ivf_rerank`` is the port of the Pallas TPU kernel
``src/repro/kernels/ivf_rerank.py`` ``ivf_rerank`` / ``_rerank_kernel``. On
CUDA tensors it launches the hand-written kernel in ``csrc/ivf_rerank.cu``
(one block per query and segment of 1,024 candidate slots, whole rows
gathered with 16-byte loads, fp32 dot products, a running top-k per warp in
registers, a second launch merging the segments); on CPU tensors it runs
``ivf_rerank_plain``, the same function in plain torch ops.

The order of the result is the TPU kernel's: values descending, and equal
values in the order of their slots in ``cand`` (the candidate position), not
of their row ids. Slots a row cannot fill with a real candidate are
(-inf, -1).

Bound on an H100 SXM at the serving shapes (B = 64, A = 31 x 1,263 =
39,153 candidates of the 1,020,250 x 512 shard, k = 5): 2.57 GFLOP, 38 us
at the fp32 rate, against 5.1 GB of rows gathered query by query (1.53 ms
at 3.35 TB/s), of which the union of the probed clusters, most of the
2.09 GB shard, must be read at least once: bound by bytes.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

LAUNCHES = 0          # kernel launches (one per ivf_rerank call on the card)
MAX_K = 32            # the CUDA kernel keeps a row's slots one per lane
MAX_DIM = 1024        # a lane keeps at most 8 float4 of the query
_PLAIN_ELEMS = 1 << 28   # gathered floats per chunk of the plain version


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


def _lib():
    lib = build.library("ivf_rerank")
    fn = lib.ivf_rerank_launch
    if not fn.argtypes:
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
                       + [ctypes.c_void_p] * 5)
        fn.restype = ctypes.c_int
        lib.ivf_rerank_segments.argtypes = [ctypes.c_int]
        lib.ivf_rerank_segments.restype = ctypes.c_int
    return lib


def ivf_rerank(f, w, cand, k: int):
    """f [B, D] fp32; w [V, D] fp32 (rows gathered in the kernel); cand
    [B, A] int32 local row ids, -1 marking padding. Returns (vals [B, k]
    fp32 descending, ids [B, k] int32 row ids, -1 where a row has fewer
    than k real candidates); equal values keep candidate-position order."""
    global LAUNCHES
    if f.dtype != torch.float32 or w.dtype != torch.float32:
        raise TypeError(f"ivf_rerank takes float32 f and w, got {f.dtype}/"
                        f"{w.dtype}")
    if cand.dtype != torch.int32:
        raise TypeError(f"ivf_rerank takes int32 candidates, got {cand.dtype}")
    if (f.dim() != 2 or w.dim() != 2 or cand.dim() != 2
            or f.shape[1] != w.shape[1] or cand.shape[0] != f.shape[0]):
        raise ValueError(f"ivf_rerank: shapes f {tuple(f.shape)}, w "
                         f"{tuple(w.shape)}, cand {tuple(cand.shape)}")
    if k < 1:
        raise ValueError(f"k must be positive, got {k}")
    devices = {t.device.type for t in (f, w, cand)}
    if devices == {"cpu"}:
        return ivf_rerank_plain(f, w, cand, k)
    if devices != {"cuda"} or len({f.device, w.device, cand.device}) != 1:
        raise ValueError(f"ivf_rerank: tensors on {f.device}, {w.device}, "
                         f"{cand.device}")
    b, d = f.shape
    v, a = w.shape[0], cand.shape[1]
    if k > MAX_K:
        raise ValueError(f"the CUDA ivf_rerank takes k <= {MAX_K}, got {k} "
                         f"(ROADMAP.md B.7)")
    if d % 4 or d > MAX_DIM:
        raise ValueError(f"the CUDA ivf_rerank needs D % 4 == 0 and D <= "
                         f"{MAX_DIM}, got {d}")
    if b > 65535:
        raise ValueError(f"the CUDA ivf_rerank takes at most 65,535 queries "
                         f"a call, got {b}")
    if not (f.is_contiguous() and w.is_contiguous() and cand.is_contiguous()):
        raise ValueError("ivf_rerank: f, w and cand must be contiguous")
    if f.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("the CUDA ivf_rerank needs 16-byte aligned f and w")
    if b == 0 or a == 0 or v == 0:
        return (torch.full((b, k), float("-inf"), device=f.device),
                torch.full((b, k), -1, device=f.device, dtype=torch.int32))
    vals = torch.empty((b, k), device=f.device, dtype=torch.float32)
    ids = torch.empty((b, k), device=f.device, dtype=torch.int32)
    lib = _lib()
    nseg = lib.ivf_rerank_segments(a)
    part_v = torch.empty((b, nseg, k), device=f.device, dtype=torch.float32)
    part_p = torch.empty((b, nseg, k), device=f.device, dtype=torch.int32)
    stream = torch.cuda.current_stream(f.device).cuda_stream
    err = lib.ivf_rerank_launch(
        f.data_ptr(), w.data_ptr(), cand.data_ptr(), b, v, d, a, k,
        part_v.data_ptr(), part_p.data_ptr(), vals.data_ptr(),
        ids.data_ptr(), stream)
    build.check(err, "ivf_rerank")
    LAUNCHES += 1
    return vals, ids
