"""Streaming fused softmax cross-entropy over a class shard: the paper's
softmax-stage hotspot (§3.2).

``ce_forward`` and ``ce_backward`` are the ports of the Pallas TPU kernels
``src/repro/kernels/ce_softmax.py`` ``ce_forward`` / ``_fwd_kernel`` and
``ce_backward`` / ``_bwd_kernel``. On CUDA tensors they launch the
hand-written kernels in ``csrc/ce_softmax_fwd.cu`` (partial statistics per
(batch tile, class segment), then a per-row combine) and
``csrc/ce_softmax_bwd.cu`` (dW from one block per class segment over every
batch row; df from blocks of 64 batch rows that keep their partial in
registers over a class segment, then summed in segment order). On CPU
tensors they run ``ce_forward_plain`` and ``ce_backward_plain``, the same
functions in plain torch ops.

The products run on the tensor cores as 3xTF32 ``wgmma``, fed by TMA:
each fp32 operand x is split into hi = tf32(x) and lo = tf32(x - hi), and
a product is taken as lo.hi + hi.lo + hi.hi with fp32 sums
(``csrc/ce_hopper.cuh``), which keeps fp32-level accuracy at three TF32
products. Bounds on an H100 SXM at the 1,020,250 x 512 shard: the forward
at B=64 is bound by reading W's 2.09 GB (0.62 ms at 3.35 TB/s; its 66.9
GFLOP are 0.41 ms as 3xTF32 at 494.7 TFLOP/s, 1.0 ms on CUDA cores at 67),
at B=256 by its products (1.62 ms as 3xTF32, 3.99 on CUDA cores). The
backward at B=256 does three such products, 802 GFLOP: 4.87 ms as 3xTF32
(11.98 on CUDA cores) against 4.18 GB of W read and dW written (1.25 ms).
See the sources for the design.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.cost import Cost, charges, tf32x3

LAUNCHES = 0          # kernel launches (one per ce_forward call on the card)
BWD_LAUNCHES = 0      # kernel launches (one per ce_backward call on the card)

_VT = 128             # class rows per tile (csrc/ce_hopper.cuh)
_BT = 64              # batch rows per block of the forward and of df
_DG = 512             # features per block of df


def _segments(n_vtiles: int, blocks: int):
    """(tiles per segment, segments): about ``blocks`` class segments, none
    empty."""
    seg_tiles = -(-n_vtiles // max(1, min(n_vtiles, blocks)))
    return seg_tiles, -(-n_vtiles // seg_tiles)


def forward_cost(b: int, v: int, d: int) -> Cost:
    """``ce_forward`` at f [b, d], W [v, d]: one product, f, W and y read,
    the four [b] statistics written."""
    return tf32x3(4 * (b * d + v * d + b) + 16 * b, 1, b, v, d)


def backward_cost(b: int, v: int, d: int) -> Cost:
    """``ce_backward``: three products (the scores again, df, dW); f, W, y,
    m, gz, gc read, df and dW written."""
    return tf32x3(4 * (2 * b * d + 2 * v * d + 4 * b), 3, b, v, d)


def _sms(dev) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


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
        fn.argtypes = ([ctypes.c_void_p] * 13 + [ctypes.c_int] * 4
                       + [ctypes.c_float] + [ctypes.c_int] * 2
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _launch(f, w, y, lim: int, scale: float):
    global LAUNCHES
    b, d = f.shape
    v = w.shape[0]
    dev = f.device
    n_btiles = -(-b // _BT)
    # about one block an SM, the B tiles of a segment side by side
    seg_tiles, n_segs = _segments(-(-v // _VT), _sms(dev) // n_btiles)
    fh = torch.empty_like(f)             # f's TF32 halves
    fl = torch.empty_like(f)
    pm = torch.empty((n_segs, b), device=dev, dtype=torch.float32)
    pz, pc = torch.empty_like(pm), torch.empty_like(pm)
    pa = torch.empty((n_segs, b), device=dev, dtype=torch.int32)
    m = torch.empty((b,), device=dev, dtype=torch.float32)
    z, corr = torch.empty_like(m), torch.empty_like(m)
    amax = torch.empty((b,), device=dev, dtype=torch.int32)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib()(f.data_ptr(), w.data_ptr(), y.data_ptr(), fh.data_ptr(),
                 fl.data_ptr(), pm.data_ptr(), pz.data_ptr(), pc.data_ptr(),
                 pa.data_ptr(), m.data_ptr(),
                 z.data_ptr(), corr.data_ptr(), amax.data_ptr(), b, d, v,
                 lim, float(scale), seg_tiles, n_segs, stream)
    build.check(err, "ce_forward")
    LAUNCHES += 1
    return m, z, corr, amax


def _check(what, f, w, y, rows, limit):
    """The checks that ``ce_forward`` and ``ce_backward`` share. ``rows``
    maps the names of the other [B] inputs to them. Returns the clamped
    limit, the labels with those off the shard mapped to -1 (they must fold
    nothing), and where the tensors lie: "cuda" (launch the kernel), "cpu"
    (run the plain version) or "meta" (shapes only: the dry run)."""
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
    if f.device.type == w.device.type and f.device.type in ("cpu", "meta"):
        return lim, y, f.device.type
    if f.device.type != "cuda" or w.device != f.device:
        raise ValueError(f"{what}: tensors on {f.device} and {w.device}")
    if not (f.is_contiguous() and w.is_contiguous()):
        raise ValueError(f"{what}: f and w must be contiguous")
    if f.shape[1] % 4 or f.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError(f"the CUDA {what} needs D % 4 == 0 and 16-byte "
                         f"aligned f and W")
    if not (b and v and f.shape[1]):
        raise ValueError(f"the CUDA {what} needs B, V and D >= 1, got f "
                         f"{tuple(f.shape)}, w {tuple(w.shape)}")
    return lim, y.contiguous(), "cuda"


@charges("ce_forward", lambda f, w, *a, **k: forward_cost(
    f.shape[0], w.shape[0], f.shape[1]))
def ce_forward(f, w, y, *, limit=None, scale: float = 1.0):
    """f [B,D] fp32, w [V,D] fp32, y [B] local ids (out of range = not
    owned by this shard). ``limit`` (default V) masks columns >= limit —
    vocab padding on the owning shard. Returns per-row fp32 (m, z, corr)
    and int32 amax: running max, partition sum relative to m, label logit,
    argmax column (-1 when every column is masked)."""
    lim, y, where = _check("ce_forward", f, w, y, {}, limit)
    if where == "meta":
        m = torch.empty(f.shape[:1], device="meta")
        return m, torch.empty_like(m), torch.empty_like(m), torch.empty_like(
            m, dtype=torch.int32)
    if where == "cpu":
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
        fn.argtypes = ([ctypes.c_void_p] * 13 + [ctypes.c_int] * 4
                       + [ctypes.c_float] + [ctypes.c_int] * 5
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _bwd_launch(f, w, y, m, gz, gc, lim: int, scale: float):
    global BWD_LAUNCHES
    b, d = f.shape
    v = w.shape[0]
    dev = f.device
    n_vtiles = -(-v // _VT)
    sms = _sms(dev)
    seg_dw, n_segs_dw = _segments(n_vtiles, sms)
    seg_df, n_segs_df = _segments(
        n_vtiles, sms // (-(-b // _BT) * -(-d // _DG)))
    bp = -(-b // 8) * 8
    fh, fl = torch.empty_like(f), torch.empty_like(f)   # f's TF32 halves
    fth = torch.empty((d, bp), device=dev, dtype=torch.float32)  # and f^T's
    ftl = torch.empty_like(fth)
    dw = torch.empty((v, d), device=dev, dtype=torch.float32)
    pdf = torch.empty((n_segs_df, b, d), device=dev, dtype=torch.float32)
    df = torch.empty((b, d), device=dev, dtype=torch.float32)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _bwd_lib()(f.data_ptr(), w.data_ptr(), y.data_ptr(), m.data_ptr(),
                     gz.data_ptr(), gc.data_ptr(), fh.data_ptr(),
                     fl.data_ptr(), fth.data_ptr(), ftl.data_ptr(),
                     dw.data_ptr(), pdf.data_ptr(), df.data_ptr(), b, d, v,
                     lim, float(scale), bp, seg_dw, n_segs_dw, seg_df,
                     n_segs_df, stream)
    build.check(err, "ce_backward")
    BWD_LAUNCHES += 1
    return df, dw


@charges("ce_backward", lambda f, w, *a, **k: backward_cost(
    f.shape[0], w.shape[0], f.shape[1]))
def ce_backward(f, w, y, m, gz, gc, *, limit=None, scale: float = 1.0):
    """Streamed backward from per-row cotangents. f [B,D], w [V,D] fp32,
    y [B] local ids (out of range = not owned by this shard), m [B] the
    forward's row max, gz / gc [B] the cotangents of the forward's z and
    corr. ``limit`` (default V) masks columns >= limit out of the softmax
    term; the label one-hot is not masked. Returns (df [B,D], dw [V,D])
    fp32. Deterministic: no floating-point atomics on the card."""
    m, gz, gc = (t.float() for t in (m, gz, gc))
    lim, y, where = _check("ce_backward", f, w, y,
                           {"m": m, "gz": gz, "gc": gc}, limit)
    if where == "meta":
        return torch.empty_like(f), torch.empty_like(w)
    if where == "cpu":
        return ce_backward_plain(f, w, y, m, gz, gc, lim, scale)
    return _bwd_launch(f, w, y, m.contiguous(), gz.contiguous(),
                       gc.contiguous(), lim, scale)
