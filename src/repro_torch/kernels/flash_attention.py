"""Forward flash attention: the kernel backend of the zoo's self-attention
in the prefill (``repro_torch.models.layers.multihead_attention``).

``flash_attention`` is the port of the Pallas TPU kernel
``src/repro/kernels/flash_attention.py`` ``flash_attention`` /
``_flash_kernel``. On CUDA tensors it launches the hand-written kernel in
``csrc/flash_attention.cu`` (bf16: one block per head and query tile, one
or two consumer warpgroups on ``wgmma`` fed by a producer warp's TMA loads
of K and V tiles; fp32: CUDA-core FMA); on CPU tensors it runs
``flash_attention_plain``, the TPU kernel's tile loop in torch ops, which
the tests hold against the JAX package.

Positions are implicit, as in the TPU kernel: row i of q is position i and
key j is position j (top-left aligned, also when Sq != T). GQA without
copies: k and v hold BH / g heads, and query head h reads KV head h // g
(the JAX package's reshape order).

Bound on an H100 SXM at the zoo prefill's shapes (SmolLM-135M: BH = 72
query heads over 24 KV heads, S = T = 2,000, Dh = 64, bf16, causal): 36.9
GFLOP of causal products, 0.037 ms at the 989 TFLOP/s bf16 tensor-core
rate, against 49 MB of q, k, v and o (0.015 ms at 3.35 TB/s): bound by
operations.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.cost import Cost, charges

LAUNCHES = 0          # kernel launches (one per flash_attention call on the card)
MAX_HEAD_DIM = 256    # the CUDA kernel pads Dh to at most 256 in shared memory
DTYPES = (torch.float32, torch.bfloat16)
MAX_BLOCKS = 2**31 - 1   # heads x query tiles: the grid's x axis


def kv_tile(dh: int, dtype=torch.bfloat16) -> int:
    """The CUDA kernel's key tile: 128 keys for bf16 up to Dh 128, 64 for
    wider bf16 heads (registers) and for fp32."""
    return 128 if dtype == torch.bfloat16 and dh <= 128 else 64


def q_tile(dh: int, dtype=torch.bfloat16) -> int:
    """The CUDA kernel's query tile: 64 rows (one consumer warpgroup, two
    blocks an SM) for bf16 up to Dh 64, two warpgroups of 64 for wider bf16
    heads, 64 rows for fp32."""
    return 128 if dtype == torch.bfloat16 and dh > 64 else 64


def valid_pairs(s: int, t: int, causal: bool = True, window: int = 0) -> int:
    """(query, key) pairs a head scores: all s t, the causal triangle when
    s == t, within it the last ``window`` keys of each row."""
    if not (causal and s == t):
        return s * t
    w = min(window, s) if window > 0 else s
    return w * (w + 1) // 2 + (s - w) * w


def cost(bh: int, s: int, t: int, dh: int, elem_bytes: int, bhkv=None,
         causal: bool = True, window: int = 0) -> Cost:
    """``flash_attention`` of bh query heads over bhkv KV heads: 2 Dh
    operations for q.k and 2 Dh for p.v a valid pair; q and o of bh heads
    and k and v of bhkv heads moved once, at ``elem_bytes`` an element
    (bf16 on the tensor cores, fp32 on the CUDA cores)."""
    bhkv = bh if bhkv is None else bhkv
    n_ops = 4.0 * dh * valid_pairs(s, t, causal, window) * bh
    return Cost(n_ops, float(elem_bytes * dh * (2 * s * bh + 2 * t * bhkv)),
                "bf16" if elem_bytes == 2 else "fp32")


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = 0,
                          block_kv: int | None = None, round_p=None):
    """Plain torch version: the TPU kernel's sweep over kv tiles of
    ``block_kv`` keys (the CUDA kernel's tile, ``kv_tile``, by default: the
    tiles set the order of the fp32 sums) with the TPU kernel's online
    softmax in fp32, p = exp(s·scale - m). Products are fp32 sums of the
    (exact) fp32 products of the inputs; p is rounded to v's dtype before
    p . v (or mapped by ``round_p``, for a caller that bounds what that
    rounding can move), and l sums the fp32 p. Rows with no valid key come
    out 0. k and v may hold BH / g heads: query head h reads KV head h // g
    through a broadcast view, not a copy of the heads."""
    bh, sq, dh = q.shape
    bhkv, t = k.shape[0], k.shape[1]
    g = bh // bhkv
    bkv = block_kv or kv_tile(dh, q.dtype)
    if round_p is None:
        def round_p(p):
            return p.to(v.dtype).float()
    scale = 1.0 / (dh ** 0.5)
    pk = (-t) % bkv
    qf = q.float().reshape(bhkv, g, sq, dh)
    kf = torch.nn.functional.pad(k, (0, 0, 0, pk)).float()[:, None]
    vp = torch.nn.functional.pad(v, (0, 0, 0, pk))[:, None]
    qpos = torch.arange(sq, device=q.device)[:, None]
    m = torch.full((bhkv, g, sq), float("-inf"), device=q.device)
    l = torch.zeros((bhkv, g, sq), device=q.device)
    acc = torch.zeros((bhkv, g, sq, dh), device=q.device)
    for j0 in range(0, t + pk, bkv):
        kb = kf[:, :, j0:j0 + bkv].expand(bhkv, g, bkv, dh)
        vb = vp[:, :, j0:j0 + bkv].float().expand(bhkv, g, bkv, dh)
        s = (qf @ kb.transpose(2, 3)) * scale
        kpos = j0 + torch.arange(bkv, device=q.device)[None, :]
        valid = kpos < t
        if causal:
            valid = valid & (kpos <= qpos)
        if window > 0:
            valid = valid & (kpos > qpos - window)
        s = torch.where(valid, s, float("-inf"))
        m_new = torch.maximum(m, s.amax(dim=-1))
        safe_m = torch.where(torch.isfinite(m_new), m_new, 0.0)
        p = torch.exp(torch.where(valid, s - safe_m[..., None],
                                  float("-inf")))
        corr = torch.where(torch.isfinite(m), torch.exp(m - safe_m), 0.0)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + round_p(p) @ vb
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(bh, sq, dh).to(q.dtype)


def _lib():
    fn = build.library("flash_attention").flash_attention_launch
    if not fn.argtypes:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


@charges("flash_attention", lambda q, k, v, causal=True, window=0: cost(
    q.shape[0], q.shape[1], k.shape[1], q.shape[2], q.element_size(),
    k.shape[0], causal, window))
def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """q [BH, Sq, Dh]; k, v [BH / g, T, Dh] (query head h reads KV head
    h // g), all float32 or all bfloat16, Dh a multiple of 16 up to 256 ->
    [BH, Sq, Dh] in q's dtype. ``window > 0`` keeps the keys j > i - window
    of row i."""
    global LAUNCHES
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes float32 or bfloat16 q, k, v "
                        f"of one dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    if (q.dim() != 3 or k.dim() != 3 or v.shape != k.shape
            or k.shape[0] < 1 or q.shape[0] % k.shape[0]
            or k.shape[2] != q.shape[2]):
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} (k and v "
                         f"need BH / g heads for a whole g)")
    bh, sq, dh = q.shape
    bhkv, t = k.shape[0], k.shape[1]
    if dh % 16 or not 16 <= dh <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention takes a head dim that is a "
                         f"multiple of 16 up to {MAX_HEAD_DIM}, got {dh}")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    devices = {x.device.type for x in (q, k, v)}
    if devices == {"cpu"}:
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    if devices == {"meta"}:
        return torch.empty_like(q)
    if devices != {"cuda"} or len({q.device, k.device, v.device}) != 1:
        raise ValueError(f"flash_attention: tensors on {q.device}, "
                         f"{k.device}, {v.device}")
    if bh * -(-sq // q_tile(dh, q.dtype)) > MAX_BLOCKS:
        raise ValueError(f"the CUDA flash_attention takes at most "
                         f"{MAX_BLOCKS} (head, query tile) blocks a call")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: q, k and v must be contiguous")
    if q.data_ptr() % 16 or k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("the CUDA flash_attention needs 16-byte aligned "
                         "q, k and v")
    if bh == 0 or sq == 0 or t == 0:          # no keys: every row is 0
        return torch.zeros_like(q)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 bh, bhkv, sq, t, dh, int(causal), int(window),
                 1.0 / (dh ** 0.5), int(q.dtype == torch.bfloat16), stream)
    build.check(err, "flash_attention")
    LAUNCHES += 1
    return out
