"""Stage 1 of divide-and-conquer top-k (paper Fig. 5): per-chunk top-k.

``stage1_topk`` is the port of the Pallas TPU kernel
``src/repro/kernels/topk_dc.py`` ``stage1_topk`` / ``_stage1_kernel``. On a
CUDA tensor it launches the hand-written kernel in ``csrc/topk_stage1.cu``
(one warp a chunk: the chunk in shared memory by a bulk copy, a radix
select of the k-th largest key with per-lane counters, the survivors sorted
by a bitonic sort; its cost does not grow with k); on a CPU tensor it runs
``stage1_topk_plain``, the TPU kernel's k max-extraction sweeps in plain
torch ops.

Bound on an H100 SXM at the serving shapes (top-5 over [64, 1,020,250]
logits, chunks of 2,048): reading the 0.26 GB of logits once, about 78 us
at 3.35 TB/s — bound by bytes; the kernel reads each value once from device
memory and selects in shared memory.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.cost import Cost, charges

LAUNCHES = 0          # kernel launches (one per stage1_topk call on the card)
MAX_SMEM = 232448     # shared memory a block may use on an H100 (227 KB)


def cost(m: int, n: int, k: int, chunk=None) -> Cost:
    """``stage1_topk`` of x [m, n] in chunks of ``chunk`` columns: x read
    once and each chunk's k candidates written (8 bytes each); one compare
    an element, the selection's least work whatever k is."""
    nch = -(-n // (chunk or n)) if n else 0
    return Cost(float(m) * n, 4.0 * m * n + 8.0 * m * nch * k, "fp32")


def stage1_topk_plain(x, k: int, chunk=None):
    """x [M, N] -> per-chunk (vals [M*nch, k] desc, idx [M*nch, k] int32
    in-chunk indices), chunks of ``chunk`` columns (default N), the ragged
    tail padded with -inf. k sweeps, each taking the first maximum and
    overwriting it with -inf, as the TPU kernel does."""
    m, n = x.shape
    chunk = chunk or n
    pad = (-n) % chunk
    xs = x.float()
    if pad:
        xs = torch.nn.functional.pad(xs, (0, pad), value=float("-inf"))
    xs = xs.reshape(-1, chunk).clone()
    col = torch.arange(chunk, device=x.device)
    vals = torch.empty((xs.shape[0], k), device=x.device, dtype=torch.float32)
    idx = torch.empty((xs.shape[0], k), device=x.device, dtype=torch.int32)
    for i in range(k):
        am = xs.argmax(dim=1)
        vals[:, i] = xs.gather(1, am[:, None])[:, 0]
        idx[:, i] = am.to(torch.int32)
        xs = torch.where(col[None, :] == am[:, None], float("-inf"), xs)
    return vals, idx


def cuda_smem_bytes(chunk: int, k: int) -> int:
    """Shared memory the CUDA kernel's warp needs for one chunk: the keys,
    then the per-lane counters (a byte a bin and lane, two past 255
    columns a lane) or the sort buffer (8 bytes a survivor, at least 64),
    whichever is larger. ``topk_stage1_smem`` in ``csrc/topk_stage1.cu``
    computes the same."""
    keys = ((chunk + 4) * 4 + 15) & ~15
    counters = 256 * 32 * (1 if -(-chunk // 32) < 256 else 2)
    sort = 64
    while sort < min(k, chunk):
        sort *= 2
    return 16 + keys + max(counters, 8 * sort)


def check_cuda_chunk(chunk: int, k: int) -> None:
    """Raise ValueError for a chunk the CUDA kernel cannot hold."""
    need = cuda_smem_bytes(chunk, k)
    if need > MAX_SMEM:
        raise ValueError(f"the CUDA stage1_topk needs {need} bytes of shared "
                         f"memory for chunk={chunk}, k={k}; a block has "
                         f"{MAX_SMEM}")


def _lib():
    fn = build.library("topk_stage1").topk_stage1_launch
    if not fn.argtypes:
        fn.argtypes = ([ctypes.c_void_p] + [ctypes.c_int] * 5
                       + [ctypes.c_void_p] * 3)
        fn.restype = ctypes.c_int
    return fn


@charges("stage1_topk", lambda x, k, chunk=None: cost(
    x.shape[0], x.shape[1], k, chunk))
def stage1_topk(x, k: int, *, chunk=None):
    """x [M, N] float32 -> (vals [M*nch, k] float32 desc, idx [M*nch, k]
    int32 in-chunk indices) over chunks of ``chunk`` columns (default N;
    nch = ceil(N / chunk)). Ties go to the lowest index."""
    global LAUNCHES
    if x.dim() != 2 or x.dtype != torch.float32:
        raise TypeError(f"stage1_topk takes a 2-D float32 tensor, got "
                        f"{x.dtype} {tuple(x.shape)}")
    m, n = x.shape
    chunk = chunk or n
    if not 1 <= k <= chunk:
        raise ValueError(f"k={k} must be in [1, chunk={chunk}]")
    if x.device.type == "cpu":
        return stage1_topk_plain(x, k, chunk)
    if x.device.type != "cuda":
        raise ValueError(f"stage1_topk: tensor on {x.device}")
    check_cuda_chunk(chunk, k)
    if x.stride(1) != 1:
        raise ValueError("stage1_topk: rows must be contiguous")
    rows = m * (-(-n // chunk))
    vals = torch.empty((rows, k), device=x.device, dtype=torch.float32)
    idx = torch.empty((rows, k), device=x.device, dtype=torch.int32)
    if rows == 0:
        return vals, idx
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _lib()(x.data_ptr(), m, x.stride(0), n, chunk, k, vals.data_ptr(),
                 idx.data_ptr(), stream)
    build.check(err, "stage1_topk")
    LAUNCHES += 1
    return vals, idx
