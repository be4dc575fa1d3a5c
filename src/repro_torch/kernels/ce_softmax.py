"""Streaming fused softmax cross-entropy over a class shard: the paper's
softmax-stage hotspot (§3.2).

``ce_forward`` and ``ce_backward`` are the ports of the Pallas TPU kernels
``src/repro/kernels/ce_softmax.py`` ``ce_forward`` / ``_fwd_kernel`` and
``ce_backward`` / ``_bwd_kernel``. On CUDA tensors they launch the
hand-written kernels in ``csrc/ce_softmax_fwd.cu`` (two passes: partial
statistics per (batch tile, class segment), then a per-row combine) and
``csrc/ce_softmax_bwd.cu`` (one block per class segment recomputes the
scores, writes its dW rows and a df partial; a second pass sums the
partials in segment order). On CPU tensors they run ``ce_forward_plain``
and ``ce_backward_plain``, the same functions in plain torch ops.

Bound on an H100 SXM at the serving shapes (B=64, V=1,020,250, D=512): the
66.9 GFLOP fp32 product at 67 TFLOP/s (1.0 ms) outweighs reading W's
2.09 GB at 3.35 TB/s (0.62 ms), so it is bound by operations; the kernel
keeps fp32 FMA on CUDA cores for parity with the fp32 reference (no TF32)
and takes its parallelism from V, since B is small. See the source for the
design.

The backward at the training shapes (B=256, same V and D) does three such
products, 802 GFLOP (11.98 ms at 67 TFLOP/s) against 4.18 GB of W read
and dW written (1.25 ms): bound by operations as well.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

LAUNCHES = 0          # kernel launches (one per ce_forward call on the card)
BWD_LAUNCHES = 0      # kernel launches (one per ce_backward call on the card)

_SEG_BLOCKS = 2048    # pass-1 blocks to aim for: many waves over 132 SMs
_VT = 128             # class rows per tile in csrc/ce_softmax_fwd.cu
_BT = 64              # batch rows per block
_BWD_SEG_BLOCKS = 264  # backward blocks: two per SM on 132 SMs (93 KB smem each)


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


def _check(what, f, w, y, rows, limit):
    """The checks that ``ce_forward`` and ``ce_backward`` share. ``rows``
    maps the names of the other [B] inputs to them. Returns the clamped
    limit, the labels with those off the shard mapped to -1 (they must fold
    nothing), and whether the tensors are on the card (else on the CPU)."""
    if f.dtype != torch.float32 or w.dtype != torch.float32:
        raise TypeError(f"{what} takes float32, got {f.dtype}/{w.dtype}")
    rows = {"y": y, **rows}
    b, v = f.shape[0], w.shape[0]
    if (f.dim() != 2 or w.dim() != 2 or f.shape[1] != w.shape[1]
            or any(tuple(t.shape) != (b,) for t in rows.values())):
        raise ValueError(f"{what}: shapes f {tuple(f.shape)}, w "
                         f"{tuple(w.shape)}, " + ", ".join(
                             f"{k} {tuple(t.shape)}" for k, t in rows.items()))
    for k, t in rows.items():
        # a row vector elsewhere than f would hand the kernel a foreign pointer
        if t.device != f.device:
            raise ValueError(f"{what}: {k} on {t.device}, not on {f.device}")
    lim = v if limit is None else max(0, min(int(limit), v))
    y = torch.where((y >= 0) & (y < v), y, -1).to(torch.int32)
    if f.device.type == "cpu" and w.device.type == "cpu":
        return lim, y, False
    if f.device.type != "cuda" or w.device != f.device:
        raise ValueError(f"{what}: tensors on {f.device} and {w.device}")
    if not (f.is_contiguous() and w.is_contiguous()):
        raise ValueError(f"{what}: f and w must be contiguous")
    if f.shape[1] % 4 or f.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError(f"the CUDA {what} needs D % 4 == 0 and 16-byte "
                         f"aligned f and W")
    return lim, y.contiguous(), True


def ce_forward(f, w, y, *, limit=None, scale: float = 1.0):
    """f [B,D] fp32, w [V,D] fp32, y [B] local ids (out of range = not
    owned by this shard). ``limit`` (default V) masks columns >= limit —
    vocab padding on the owning shard. Returns per-row fp32 (m, z, corr)
    and int32 amax: running max, partition sum relative to m, label logit,
    argmax column (-1 when every column is masked)."""
    lim, y, on_card = _check("ce_forward", f, w, y, {}, limit)
    if not on_card:
        return ce_forward_plain(f, w, y, lim, scale)
    return _launch(f, w, y, lim, scale)


def ce_backward_plain(f, w, y, m, gz, gc, limit: int, scale: float = 1.0):
    """Plain torch version over the dense scores. ``y`` holds local label
    columns, -1 for labels off the shard. Returns (df [B,D], dw [V,D])."""
    s = (f @ w.T) * scale
    col = torch.arange(w.shape[0], device=w.device)
    live = (col < limit)[None, :] & torch.isfinite(m)[:, None]
    p = torch.where(live, torch.exp(s - m[:, None]), 0.0)
    hit = (col[None, :] == y[:, None].long()).float()
    dl = (p * gz[:, None] + hit * gc[:, None]) * scale
    return dl @ w, dl.T @ f


def _bwd_lib():
    lib = build.library("ce_softmax_bwd")
    fn = lib.ce_bwd_launch
    if not fn.argtypes:
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 4
                       + [ctypes.c_float] + [ctypes.c_int] * 2
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _bwd_launch(f, w, y, m, gz, gc, lim: int, scale: float):
    global BWD_LAUNCHES
    b, d = f.shape
    v = w.shape[0]
    n_vtiles = max(1, -(-v // _VT))
    seg_tiles = -(-n_vtiles // min(n_vtiles, _BWD_SEG_BLOCKS))
    n_segs = -(-n_vtiles // seg_tiles)
    dev = f.device
    dw = torch.empty((v, d), device=dev, dtype=torch.float32)
    pdf = torch.empty((n_segs, b, d), device=dev, dtype=torch.float32)
    df = torch.empty((b, d), device=dev, dtype=torch.float32)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _bwd_lib()(f.data_ptr(), w.data_ptr(), y.data_ptr(), m.data_ptr(),
                     gz.data_ptr(), gc.data_ptr(), dw.data_ptr(),
                     pdf.data_ptr(), df.data_ptr(), b, d, v, lim,
                     float(scale), seg_tiles, n_segs, stream)
    build.check(err, "ce_backward")
    BWD_LAUNCHES += 1
    return df, dw


def ce_backward(f, w, y, m, gz, gc, *, limit=None, scale: float = 1.0):
    """Streamed backward from per-row cotangents. f [B,D], w [V,D] fp32,
    y [B] local ids (out of range = not owned by this shard), m [B] the
    forward's row max, gz / gc [B] the cotangents of the forward's z and
    corr. ``limit`` (default V) masks columns >= limit out of the softmax
    term; the label one-hot is not masked. Returns (df [B,D], dw [V,D])
    fp32. Deterministic: no floating-point atomics on the card."""
    m, gz, gc = (t.float() for t in (m, gz, gc))
    lim, y, on_card = _check("ce_backward", f, w, y,
                             {"m": m, "gz": gz, "gc": gc}, limit)
    if not on_card:
        return ce_backward_plain(f, w, y, m, gz, gc, lim, scale)
    return _bwd_launch(f, w, y, m.contiguous(), gz.contiguous(),
                       gc.contiguous(), lim, scale)
