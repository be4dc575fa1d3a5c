"""Streaming fused softmax statistics over a class shard: the paper's
softmax-stage hotspot (§3.2), forward only.

``ce_forward`` is the port of the Pallas TPU kernel
``src/repro/kernels/ce_softmax.py`` ``ce_forward`` / ``_fwd_kernel``. On a
CUDA tensor it launches the hand-written kernel in
``csrc/ce_softmax_fwd.cu`` (two passes: partial statistics per
(batch tile, class segment), then a per-row combine). On a CPU tensor it
runs ``ce_forward_plain``, the same function in plain torch ops.

Bound on an H100 SXM at the serving shapes (B=64, V=1,020,250, D=512): the
66.9 GFLOP fp32 product at 67 TFLOP/s (1.0 ms) outweighs reading W's
2.09 GB at 3.35 TB/s (0.62 ms), so it is bound by operations; the kernel
keeps fp32 FMA on CUDA cores for parity with the fp32 reference (no TF32)
and takes its parallelism from V, since B is small. See the source for the
design.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

LAUNCHES = 0          # kernel launches (one per ce_forward call on the card)

_SEG_BLOCKS = 2048    # pass-1 blocks to aim for: many waves over 132 SMs
_VT = 128             # class rows per tile in csrc/ce_softmax_fwd.cu
_BT = 64              # batch rows per block


def ce_forward_plain(f, w, y, limit: int, scale: float = 1.0):
    """Plain torch version: per-row (m, z, corr, amax) over the dense
    scores. ``y`` holds local label columns, -1 for labels off the shard."""
    s = (f @ w.T) * scale
    col = torch.arange(w.shape[0], device=w.device)
    valid = (col < limit)[None, :]
    s = torch.where(valid, s, float("-inf"))
    m = s.max(dim=1).values
    amax = torch.where(m > float("-inf"), s.argmax(dim=1),
                       torch.full_like(m, -1, dtype=torch.long))
    z = torch.where(valid, torch.exp(s - m[:, None]), 0.0).sum(dim=1)
    corr = torch.where(col[None, :] == y[:, None].long(), s, 0.0).sum(dim=1)
    return m, z, corr, amax.to(torch.int32)


def _lib():
    lib = build.library("ce_softmax_fwd")
    fn = lib.ce_fwd_launch
    if not fn.argtypes:
        fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 4
                       + [ctypes.c_float] + [ctypes.c_int] * 2
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _launch(f, w, y, lim: int, scale: float):
    global LAUNCHES
    b, d = f.shape
    v = w.shape[0]
    if d % 4 or f.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("the CUDA ce_forward needs D % 4 == 0 and 16-byte "
                         "aligned f and W")
    n_btiles = -(-b // _BT)
    n_vtiles = max(1, -(-v // _VT))
    n_segs = min(n_vtiles, max(1, _SEG_BLOCKS // n_btiles))
    seg_tiles = -(-n_vtiles // n_segs)
    n_segs = -(-n_vtiles // seg_tiles)
    dev = f.device
    pm = torch.empty((n_segs, b), device=dev, dtype=torch.float32)
    pz, pc = torch.empty_like(pm), torch.empty_like(pm)
    pa = torch.empty((n_segs, b), device=dev, dtype=torch.int32)
    m = torch.empty((b,), device=dev, dtype=torch.float32)
    z, corr = torch.empty_like(m), torch.empty_like(m)
    amax = torch.empty((b,), device=dev, dtype=torch.int32)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib()(f.data_ptr(), w.data_ptr(), y.data_ptr(), pm.data_ptr(),
                 pz.data_ptr(), pc.data_ptr(), pa.data_ptr(), m.data_ptr(),
                 z.data_ptr(), corr.data_ptr(), amax.data_ptr(), b, d, v,
                 lim, float(scale), seg_tiles, n_segs, stream)
    build.check(err, "ce_forward")
    LAUNCHES += 1
    return m, z, corr, amax


def ce_forward(f, w, y, *, limit=None, scale: float = 1.0):
    """f [B,D] fp32, w [V,D] fp32, y [B] local ids (out of range = not
    owned by this shard). ``limit`` (default V) masks columns >= limit —
    vocab padding on the owning shard. Returns per-row fp32 (m, z, corr)
    and int32 amax: running max, partition sum relative to m, label logit,
    argmax column (-1 when every column is masked)."""
    v = w.shape[0]
    if f.dtype != torch.float32 or w.dtype != torch.float32:
        raise TypeError(f"ce_forward takes float32, got {f.dtype}/{w.dtype}")
    if (f.dim() != 2 or w.dim() != 2 or f.shape[1] != w.shape[1]
            or tuple(y.shape) != (f.shape[0],)):
        raise ValueError(f"shapes f {tuple(f.shape)}, w {tuple(w.shape)}, "
                         f"y {tuple(y.shape)}")
    if y.device != f.device:
        raise ValueError(f"ce_forward: y on {y.device}, f on {f.device}")
    lim = v if limit is None else max(0, min(int(limit), v))
    # out-of-shard labels must fold nothing: map them to -1
    y = torch.where((y >= 0) & (y < v), y, -1).to(torch.int32)
    if f.device.type == "cpu" and w.device.type == "cpu":
        return ce_forward_plain(f, w, y, lim, scale)
    if f.device.type != "cuda" or w.device != f.device:
        raise ValueError(f"ce_forward: tensors on {f.device} and {w.device}")
    if not (f.is_contiguous() and w.is_contiguous()):
        raise ValueError("ce_forward: f and w must be contiguous")
    return _launch(f, w, y.contiguous(), lim, scale)
