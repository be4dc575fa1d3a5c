// Stage 1 of divide-and-conquer top-k on Hopper (sm_90a): per-chunk top-k.
//
// Replaces: src/repro/kernels/topk_dc.py, stage1_topk / _stage1_kernel (the
// Pallas TPU kernel). Input x [n_outer, ld] fp32; each outer row is cut into
// nch chunks of `chunk` columns (the last one ragged: columns >= n read as
// -inf, in the kernel, instead of a padded copy). For each chunk it writes k
// (value, in-chunk index) pairs, values descending, ties to the lowest
// index — the TPU kernel's k max-extraction sweeps, where each sweep takes
// the first maximum and overwrites it with -inf.
//
// Design. One warp per chunk. Each lane holds its ceil(chunk / 32) values in
// registers (lane + 32 t), loaded once, coalesced. A sweep needs no removal
// state: the i-th winner is the largest element, in the order (value desc,
// index asc), that comes strictly after the (i-1)-th winner; each lane scans
// its registers and a 5-step shuffle butterfly picks the warp's winner.
// Once only -inf remains, every slot of the TPU kernel's row holds -inf
// (earlier winners were overwritten with it), so its argmax returns index
// 0 for each remaining sweep; the kernel writes (-inf, 0) for those.
//
// Bound on an H100 SXM at the serving shapes (top-5 over [64, 1,020,250]
// logits: 31,936 chunks of 2,048): the logits are read once, 0.26 GB, about
// 78 us at 3.35 TB/s; the compares are a few per element. Bound by bytes,
// which the one coalesced pass from device memory into registers meets.
//
// Requires chunk <= 2048 (64 registers a lane) and k <= chunk.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

namespace {

constexpr int WARPS = 8;

template <int VPL>
__global__ void __launch_bounds__(WARPS * 32)
topk_stage1(const float* __restrict__ x, int n_outer, int ld, int n,
            int chunk, int nch, int k, float* __restrict__ vals,
            int* __restrict__ idx) {
  const int row = blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n_outer * nch) return;        // the whole warp leaves together
  const int b = row / nch, c = row - b * nch;
  const float* src = x + (size_t)b * ld + (size_t)c * chunk;
  const int valid = min(chunk, n - c * chunk);

  float v[VPL];
#pragma unroll
  for (int t = 0; t < VPL; ++t) {
    int j = lane + 32 * t;
    v[t] = (j < valid) ? src[j] : -INFINITY;
  }

  float pv = INFINITY;   // previous winner, (value desc, index asc) order
  int pi = -1;
  bool saturated = false;
  for (int r = 0; r < k; ++r) {
    if (!saturated) {
      float bv = -INFINITY;
      int bi = INT_MAX;
#pragma unroll
      for (int t = 0; t < VPL; ++t) {
        int j = lane + 32 * t;
        float xv = v[t];
        bool after = (xv < pv) || (xv == pv && j > pi);
        bool better = (xv > bv) || (xv == bv && j < bi);
        if (j < chunk && after && better) { bv = xv; bi = j; }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        float ov = __shfl_xor_sync(0xffffffffu, bv, off);
        int oi = __shfl_xor_sync(0xffffffffu, bi, off);
        if (ov > bv || (ov == bv && oi < bi)) { bv = ov; bi = oi; }
      }
      if (bv > -INFINITY) {
        pv = bv; pi = bi;
      } else {
        saturated = true;
      }
    }
    if (lane == 0) {
      size_t o = (size_t)row * k + r;
      vals[o] = saturated ? -INFINITY : pv;
      idx[o] = saturated ? 0 : pi;
    }
  }
}

template <int VPL>
void launch(const float* x, int n_outer, int ld, int n, int chunk, int nch,
            int k, float* vals, int* idx, cudaStream_t st) {
  int rows = n_outer * nch;
  int blocks = (rows + WARPS - 1) / WARPS;
  topk_stage1<VPL><<<blocks, WARPS * 32, 0, st>>>(x, n_outer, ld, n, chunk,
                                                  nch, k, vals, idx);
}

}  // namespace

extern "C" int topk_stage1_launch(const void* x, int n_outer, int ld, int n,
                                  int chunk, int k, void* vals, void* idx,
                                  void* stream) {
  if (chunk < 1 || chunk > 2048 || k < 1 || k > chunk)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int nch = (n + chunk - 1) / chunk;
  const float* xp = static_cast<const float*>(x);
  float* vp = static_cast<float*>(vals);
  int* ip = static_cast<int*>(idx);
  const int vpl = (chunk + 31) / 32;
  if (vpl <= 1) launch<1>(xp, n_outer, ld, n, chunk, nch, k, vp, ip, st);
  else if (vpl <= 2) launch<2>(xp, n_outer, ld, n, chunk, nch, k, vp, ip, st);
  else if (vpl <= 4) launch<4>(xp, n_outer, ld, n, chunk, nch, k, vp, ip, st);
  else if (vpl <= 8) launch<8>(xp, n_outer, ld, n, chunk, nch, k, vp, ip, st);
  else if (vpl <= 16) launch<16>(xp, n_outer, ld, n, chunk, nch, k, vp, ip, st);
  else if (vpl <= 32) launch<32>(xp, n_outer, ld, n, chunk, nch, k, vp, ip, st);
  else launch<64>(xp, n_outer, ld, n, chunk, nch, k, vp, ip, st);
  return static_cast<int>(cudaGetLastError());
}
