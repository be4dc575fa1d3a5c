"""Active-class sparse softmax cross-entropy: the fused gather + streaming
CE of the knn, selective and sampled heads.

``sparse_ce_forward`` and ``sparse_ce_backward`` are the ports of the
Pallas TPU kernels ``src/repro/kernels/sparse_ce.py`` ``sparse_ce_forward``
/ ``_fwd_kernel`` and ``sparse_ce_backward`` / ``_bwd_kernel``, the
backward with the scatter of its compact gradient into the class shard
(``src/repro/kernels/ops.py`` ``_sparse_ce_bwd``). On CUDA tensors they
launch the hand-written kernels in ``csrc/sparse_ce_fwd.cu`` and
``csrc/sparse_ce_bwd.cu`` (the CE kernels with W's rows gathered by id,
a per-column bias and masks from the global ids); on CPU tensors they run
``sparse_ce_forward_plain`` and ``sparse_ce_backward_plain``, the same
functions in plain torch ops.

Each scores f [B, D] against the A active columns, column j being row
``ids[j]`` of the shard W [V, D], with global class id ``gids[j]``, logit
shift ``bias[j]`` and mask ``valid[j]``; y [B] are global labels. With
``mask_hits=False`` (knn, selective) the FIRST valid column whose gid is the
row's label gives ``corr``, even where random fillers repeat it; with
``mask_hits=True`` (sampled) every such column is dropped from z. The
forward also returns that first-hit column per row, which the backward
takes for its one-hot: the TPU kernel finds it with a flag carried from
tile to tile, which a parallel grid does not have.

The products run on the tensor cores as 3xTF32 ``wgmma`` on
``csrc/ce_hopper.cuh``'s score tile, as the dense CE kernels' do, with W's
rows gathered by id into the tile's slabs by ``cp.async`` (a TMA box cannot
gather rows) and f's halves fed by TMA. Bounds on an H100 SXM at the knn
training shapes (B = 256, A = 102,025 of V = 1,020,250, D = 512): the
forward's 26.7 GFLOP take 0.162 ms as 3xTF32 at 494.7 TFLOP/s (0.40 ms in
fp32 FMA at 67), more than its 0.21 GB of bytes take (0.06 ms at 3.35
TB/s): bound by operations. The backward's three products, 80.2 GFLOP,
take 0.486 ms as 3xTF32 (1.20 ms in fp32 FMA), less than its 2.30 GB of
bytes take (0.687 ms), most of them the dense [V, D] dW that it
zero-fills and writes: bound by bytes. See the sources for the design.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.cost import Cost, charges, tf32x3
from repro_torch.kernels.ce_softmax import _segments, _sms

LAUNCHES = 0          # kernel launches (one per sparse_ce_forward on the card)
BWD_LAUNCHES = 0      # kernel launches (one per sparse_ce_backward on the card)

_AT = 128             # active columns per tile (csrc/ce_hopper.cuh)
_SKIP_ID = 2**31 - 1  # the scatter's key of an invalid column (INT_MAX)
_BT = 64              # batch rows per block of the forward and of df
_DG = 512             # features per block of df


def _scores(f, w, ids, bias, scale):
    return (f @ w[ids.long()].T) * scale + bias[None, :]


def _masks(gids, valid, y, mask_hits: bool):
    """(keep [B, A], first-hit column [B] int32, -1 without one)."""
    ok = (valid != 0)[None, :]
    hit = (gids[None, :].long() == y[:, None].long()) & ok
    if mask_hits:
        return ok & ~hit, torch.full((y.shape[0],), -1, dtype=torch.int32,
                                     device=y.device)
    a = gids.shape[0]
    col = torch.arange(a, device=gids.device)
    first = torch.where(hit, col[None, :], a).min(dim=1).values
    return ok.expand_as(hit), torch.where(first < a, first, -1).to(torch.int32)


def sparse_ce_forward_plain(f, w, ids, gids, bias, valid, y, scale: float,
                            mask_hits: bool):
    """Plain torch version over the dense [B, A] scores. Returns
    (m, z, corr, amax, hit) as ``sparse_ce_forward``."""
    s = _scores(f, w, ids, bias, scale)
    keep, hit = _masks(gids, valid, y, mask_hits)
    at_hit = s.gather(1, hit.clamp_min(0).long()[:, None])[:, 0]
    corr = torch.where(hit >= 0, at_hit, 0.0)
    sk = torch.where(keep, s, float("-inf"))
    m = sk.max(dim=1).values
    amax = torch.where(m > float("-inf"), sk.argmax(dim=1),
                       torch.full_like(m, -1, dtype=torch.long))
    live = keep & torch.isfinite(m)[:, None]
    z = torch.where(live, torch.exp(sk - m[:, None]), 0.0).sum(dim=1)
    return m, z, corr, amax.to(torch.int32), hit


def sparse_ce_backward_plain(f, w, ids, gids, bias, valid, y, m, gz, gc,
                             hit, scale: float, mask_hits: bool):
    """Plain torch version over the dense [B, A] scores. Returns (df [B, D],
    dW [V, D]), the compact [A, D] gradient added into W's rows by id."""
    s = _scores(f, w, ids, bias, scale)
    keep, _ = _masks(gids, valid, y, mask_hits)
    p = torch.where(keep & torch.isfinite(m)[:, None],
                    torch.exp(s - m[:, None]), 0.0)
    col = torch.arange(ids.shape[0], device=f.device)
    onehot = (col[None, :] == hit[:, None].long()).float()
    dl = (p * gz[:, None] + onehot * gc[:, None]) * scale
    wa = w[ids.long()]
    dw = torch.zeros_like(w).index_add_(0, ids.long(), dl.T @ f)
    return dl @ wa, dw


def forward_cost(b: int, a: int, d: int) -> Cost:
    """``sparse_ce_forward`` at f [b, d] over A = ``a`` gathered rows: one
    product; f, the A rows, the four [A] columns (ids, gids, bias, valid)
    and y read, the five [b] outputs written."""
    return tf32x3(4 * (b * d + a * d) + 16 * a + 24 * b, 1, b, a, d)


def backward_cost(b: int, a: int, v: int, d: int) -> Cost:
    """``sparse_ce_backward``: three products over the A rows; f and the A
    rows read, df and the dense dW [v, d] written, the columns and the
    five [b] inputs read."""
    return tf32x3(4 * (2 * b * d + a * d + v * d) + 16 * a + 20 * b, 3, b,
                  a, d)


def _check(what, f, w, ids, gids, bias, valid, y, rows):
    """The checks both directions share. ``rows`` maps the names of the
    other [B] inputs to them. Returns (ids clipped into [0, V) as int32,
    gids, bias, valid, y, rows) on f's device, and where that is: "cuda"
    (launch the kernel), "cpu" (the plain version) or "meta" (shapes
    only)."""
    if f.dtype != torch.float32 or w.dtype != torch.float32:
        raise TypeError(f"{what} takes float32, got {f.dtype}/{w.dtype}")
    b, v = f.shape[0], w.shape[0]
    cols = {"ids": ids, "gids": gids, "bias": bias, "valid": valid}
    rows = {"y": y, **rows}
    a = ids.shape[0] if ids.dim() == 1 else -1
    if (f.dim() != 2 or w.dim() != 2 or f.shape[1] != w.shape[1] or a < 1
            or any(tuple(t.shape) != (a,) for t in cols.values())
            or any(tuple(t.shape) != (b,) for t in rows.values())):
        raise ValueError(f"{what}: shapes f {tuple(f.shape)}, w "
                         f"{tuple(w.shape)}, " + ", ".join(
                             f"{k} {tuple(t.shape)}"
                             for k, t in {**cols, **rows}.items()))
    for k, t in {**cols, **rows}.items():
        # a vector elsewhere than f would hand the kernel a foreign pointer
        if t.device != f.device:
            raise ValueError(f"{what}: {k} on {t.device}, not on {f.device}")
    ids = ids.clamp(0, v - 1).to(torch.int32)
    gids, valid, y = (t.to(torch.int32) for t in (gids, valid, y))
    bias = bias.float()
    rows = {k: t.float() if t.is_floating_point() else t.to(torch.int32)
            for k, t in rows.items() if k != "y"}
    if f.device.type == w.device.type and f.device.type in ("cpu", "meta"):
        return ids, gids, bias, valid, y, rows, f.device.type
    if f.device.type != "cuda" or w.device != f.device:
        raise ValueError(f"{what}: tensors on {f.device} and {w.device}")
    if not (f.is_contiguous() and w.is_contiguous()):
        raise ValueError(f"{what}: f and w must be contiguous")
    if f.shape[1] % 4 or f.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError(f"the CUDA {what} needs D % 4 == 0 and 16-byte "
                         f"aligned f and W")
    ids, gids, bias, valid, y = (t.contiguous()
                                 for t in (ids, gids, bias, valid, y))
    return ids, gids, bias, valid, y, {k: t.contiguous()
                                       for k, t in rows.items()}, "cuda"


def _fwd_lib():
    fn = build.library("sparse_ce_fwd").sparse_ce_fwd_launch
    if not fn.argtypes:
        fn.argtypes = ([ctypes.c_void_p] * 19 + [ctypes.c_int] * 3
                       + [ctypes.c_float] + [ctypes.c_int] * 3
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


@charges("sparse_ce_forward", lambda f, w, ids, *a, **k: forward_cost(
    f.shape[0], ids.shape[0], f.shape[1]))
def sparse_ce_forward(f, w, ids, gids, bias, valid, y, *, scale: float = 1.0,
                      mask_hits: bool = False):
    """f [B,D] fp32; w [V,D] fp32, the whole shard; ids [A] rows of w;
    gids [A] global class ids; bias [A] logit shift; valid [A] column mask;
    y [B] global labels. Returns per-row fp32 (m, z, corr) and int32
    (amax, hit): running max, partition sum relative to m, label logit (0
    without a hit), the best kept column (-1 when none is kept) and the
    first hit column (-1 without one, always with ``mask_hits``)."""
    global LAUNCHES
    ids, gids, bias, valid, y, _, where = _check(
        "sparse_ce_forward", f, w, ids, gids, bias, valid, y, {})
    if where == "meta":
        m = torch.empty(f.shape[:1], device="meta")
        amax = torch.empty_like(m, dtype=torch.int32)
        return (m, torch.empty_like(m), torch.empty_like(m), amax,
                torch.empty_like(amax))
    if where == "cpu":
        return sparse_ce_forward_plain(f, w, ids, gids, bias, valid, y,
                                       scale, mask_hits)
    b, d = f.shape
    a = ids.shape[0]
    dev = f.device
    # about one block an SM, the B tiles of a segment side by side
    seg_tiles, n_segs = _segments(-(-a // _AT), _sms(dev) // -(-b // _BT))
    fh, fl = torch.empty_like(f), torch.empty_like(f)   # f's TF32 halves
    pm = torch.empty((n_segs, b), device=dev, dtype=torch.float32)
    pz, phs = torch.empty_like(pm), torch.empty_like(pm)
    pa = torch.empty((n_segs, b), device=dev, dtype=torch.int32)
    ph = torch.empty_like(pa)
    m = torch.empty((b,), device=dev, dtype=torch.float32)
    z, corr = torch.empty_like(m), torch.empty_like(m)
    amax = torch.empty((b,), device=dev, dtype=torch.int32)
    hit = torch.empty_like(amax)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _fwd_lib()(
        f.data_ptr(), w.data_ptr(), ids.data_ptr(), gids.data_ptr(),
        bias.data_ptr(), valid.data_ptr(), y.data_ptr(), fh.data_ptr(),
        fl.data_ptr(), pm.data_ptr(), pz.data_ptr(), phs.data_ptr(),
        pa.data_ptr(), ph.data_ptr(), m.data_ptr(), z.data_ptr(),
        corr.data_ptr(), amax.data_ptr(), hit.data_ptr(), b, d, a,
        float(scale), int(mask_hits), seg_tiles, n_segs, stream)
    build.check(err, "sparse_ce_forward")
    LAUNCHES += 1
    return m, z, corr, amax, hit


def _bwd_lib():
    fn = build.library("sparse_ce_bwd").sparse_ce_bwd_launch
    if not fn.argtypes:
        fn.argtypes = ([ctypes.c_void_p] * 21 + [ctypes.c_int] * 3
                       + [ctypes.c_float] + [ctypes.c_int] * 6
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


@charges("sparse_ce_backward", lambda f, w, ids, *a, **k: backward_cost(
    f.shape[0], ids.shape[0], w.shape[0], f.shape[1]))
def sparse_ce_backward(f, w, ids, gids, bias, valid, y, m, gz, gc, hit, *,
                       scale: float = 1.0, mask_hits: bool = False):
    """Backward from per-row cotangents. The inputs are the forward's; m
    [B] its row max, gz / gc [B] the cotangents of its z and corr, ``hit``
    its first-hit column. Returns (df [B,D], dW [V,D]) fp32; where ids
    repeat, their rows of the compact gradient add up in dW.
    Deterministic: no floating-point atomics on the card (the repeated
    rows are summed in the order of a stable sort, in pieces of 32 sorted
    positions and then the pieces in order; invalid columns, whose rows are
    0, are left out)."""
    global BWD_LAUNCHES
    ids, gids, bias, valid, y, rows, where = _check(
        "sparse_ce_backward", f, w, ids, gids, bias, valid, y,
        {"m": m, "gz": gz, "gc": gc, "hit": hit})
    m, gz, gc, hit = rows["m"], rows["gz"], rows["gc"], rows["hit"]
    if where == "meta":
        return torch.empty_like(f), torch.empty_like(w)
    if where == "cpu":
        return sparse_ce_backward_plain(f, w, ids, gids, bias, valid, y, m,
                                        gz, gc, hit, scale, mask_hits)
    b, d = f.shape
    v, a = w.shape[0], ids.shape[0]
    dev = f.device
    n_atiles = -(-a // _AT)
    sms = _sms(dev)
    seg_dw, n_segs_dw = _segments(n_atiles, sms)
    seg_df, n_segs_df = _segments(
        n_atiles, sms // (-(-b // _BT) * -(-d // _DG)))
    bp = -(-b // 8) * 8
    # the scatter's runs: an invalid column's dW_act row is +-0, so its key
    # sorts it past every id and the kernel skips it
    sid, order = torch.sort(torch.where(valid != 0, ids, _SKIP_ID),
                            stable=True)
    fh, fl = torch.empty_like(f), torch.empty_like(f)   # f's TF32 halves
    fth = torch.empty((d, bp), device=dev, dtype=torch.float32)  # and f^T's
    ftl = torch.empty_like(fth)
    dwa = torch.empty((a, d), device=dev, dtype=torch.float32)
    pdf = torch.empty((n_segs_df, b, d), device=dev, dtype=torch.float32)
    df = torch.empty((b, d), device=dev, dtype=torch.float32)
    dw = torch.zeros((v, d), device=dev, dtype=torch.float32)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _bwd_lib()(
        f.data_ptr(), w.data_ptr(), ids.data_ptr(), gids.data_ptr(),
        bias.data_ptr(), valid.data_ptr(), y.data_ptr(), m.data_ptr(),
        gz.data_ptr(), gc.data_ptr(), hit.data_ptr(), sid.data_ptr(),
        order.data_ptr(), fh.data_ptr(), fl.data_ptr(), fth.data_ptr(),
        ftl.data_ptr(), dwa.data_ptr(), pdf.data_ptr(), df.data_ptr(),
        dw.data_ptr(), b, d, a, float(scale), int(mask_hits), bp, seg_dw,
        n_segs_dw, seg_df, n_segs_df, stream)
    build.check(err, "sparse_ce_backward")
    BWD_LAUNCHES += 1
    return df, dw
