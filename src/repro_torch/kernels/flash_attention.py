"""Forward flash attention: the kernel backend of the zoo's self-attention
in the prefill (``repro_torch.models.layers.multihead_attention``).

``flash_attention`` is the port of the Pallas TPU kernel
``src/repro/kernels/flash_attention.py`` ``flash_attention`` /
``_flash_kernel``. On CUDA tensors it launches the hand-written kernel in
``csrc/flash_attention.cu`` (one block per head and 64-row query tile, the
64-key tiles of K and V through shared memory, bf16 products on the tensor
cores with fp32 sums, or fp32 FMA for fp32 inputs; the running max, sum
and output in registers; key tiles outside the causal or window band
skipped); on CPU tensors it runs ``flash_attention_plain``, the TPU
kernel's tile loop in torch ops, which the tests hold against the JAX
package.

Positions are implicit, as in the TPU kernel: row i of q is position i and
key j is position j (top-left aligned, also when Sq != T). GQA is the
caller's job: it expands the KV heads into BH.

Bound on an H100 SXM at the zoo prefill's shapes (SmolLM-135M: BH = 72,
S = T = 2,000, Dh = 64, bf16, causal): 36.9 GFLOP of causal products,
0.037 ms at the 989 TFLOP/s bf16 tensor-core rate, against 74 MB of q, k,
v and o (0.022 ms at 3.35 TB/s): bound by operations.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

LAUNCHES = 0          # kernel launches (one per flash_attention call on the card)
MAX_HEAD_DIM = 256    # the CUDA kernel pads Dh to at most 256 in shared memory
BLOCK = 64            # the CUDA kernel's query and key tile
DTYPES = (torch.float32, torch.bfloat16)


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = 0,
                          block_kv: int = BLOCK):
    """Plain torch version: the TPU kernel's sweep over kv tiles of
    ``block_kv`` keys with an online softmax in fp32 (the tiles set the
    order of the fp32 sums, which the CUDA kernel's 64-key tiles match).
    Products are fp32 sums of the (exact) fp32 products of the inputs; p
    is rounded to v's dtype before p . v, and l sums the fp32 p. Rows with
    no valid key come out 0."""
    bh, sq, dh = q.shape
    t = k.shape[1]
    scale = 1.0 / (dh ** 0.5)
    pk = (-t) % block_kv
    qf = q.float()
    kf = torch.nn.functional.pad(k, (0, 0, 0, pk)).float()
    vp = torch.nn.functional.pad(v, (0, 0, 0, pk))
    qpos = torch.arange(sq, device=q.device)[:, None]
    m = torch.full((bh, sq), float("-inf"), device=q.device)
    l = torch.zeros((bh, sq), device=q.device)
    acc = torch.zeros((bh, sq, dh), device=q.device)
    for j0 in range(0, kf.shape[1], block_kv):
        s = (qf @ kf[:, j0:j0 + block_kv].transpose(1, 2)) * scale
        kpos = j0 + torch.arange(block_kv, device=q.device)[None, :]
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
        acc = acc * corr[..., None] + (
            p.to(v.dtype).float() @ vp[:, j0:j0 + block_kv].float())
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.to(q.dtype)


def _lib():
    fn = build.library("flash_attention").flash_attention_launch
    if not fn.argtypes:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """q [BH, Sq, Dh]; k, v [BH, T, Dh], all float32 or all bfloat16, Dh a
    multiple of 16 up to 256 -> [BH, Sq, Dh] in q's dtype. ``window > 0``
    keeps the keys j > i - window of row i."""
    global LAUNCHES
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes float32 or bfloat16 q, k, v "
                        f"of one dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    if (q.dim() != 3 or k.dim() != 3 or v.shape != k.shape
            or k.shape[0] != q.shape[0] or k.shape[2] != q.shape[2]):
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    bh, sq, dh = q.shape
    t = k.shape[1]
    if dh % 16 or not 16 <= dh <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention takes a head dim that is a "
                         f"multiple of 16 up to {MAX_HEAD_DIM}, got {dh}")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    devices = {x.device.type for x in (q, k, v)}
    if devices == {"cpu"}:
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    if devices != {"cuda"} or len({q.device, k.device, v.device}) != 1:
        raise ValueError(f"flash_attention: tensors on {q.device}, "
                         f"{k.device}, {v.device}")
    if bh > 65535:
        raise ValueError(f"the CUDA flash_attention takes at most 65,535 "
                         f"heads a call, got {bh}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: q, k and v must be contiguous")
    if q.data_ptr() % 16 or k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("the CUDA flash_attention needs 16-byte aligned "
                         "q, k and v")
    out = torch.empty_like(q)
    if bh == 0 or sq == 0:
        return out
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 bh, sq, t, dh, int(causal), int(window), 1.0 / (dh ** 0.5),
                 int(q.dtype == torch.bfloat16), stream)
    build.check(err, "flash_attention")
    LAUNCHES += 1
    return out
