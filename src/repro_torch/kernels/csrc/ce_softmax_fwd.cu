// Streaming online-softmax statistics of f [B, D] against a class shard
// W [V, D], on Hopper (sm_90a), fp32 throughout.
//
// Replaces: src/repro/kernels/ce_softmax.py, ce_forward / _fwd_kernel (the
// Pallas TPU kernel). Same outputs per row b, over the scores
// s[b, v] = scale * <f[b], W[v]> with columns v >= limit masked to -inf:
//   m[b]    = max_v s[b, v]                       (-inf if all masked)
//   z[b]    = sum_v exp(s[b, v] - m[b])           (0 if all masked)
//   corr[b] = s[b, y[b]]                          (0 when y[b] == -1)
//   amax[b] = lowest v with s[b, v] == m[b]       (-1 if all masked)
// The [B, V] score matrix never reaches device memory.
//
// Design. The TPU kernel sweeps V in order with the whole batch in one
// block: one core. Here the parallelism comes from V. Pass 1 runs a grid of
// (B tiles of 64) x (V segments); each block walks its segment in tiles of
// 128 class rows, computing the 64 x 128 score tile with a register-tiled
// fp32 FMA product (ce_tiles.cuh: each thread a 4 x 8 micro-tile, depth
// staged through shared memory 32 at a time, 16-byte coalesced loads of W,
// the same code as the backward's recomputation), and folds it
// into per-thread running (m, z, corr, amax). The 16 threads sharing a row
// combine with warp shuffles and write one partial per (segment, row).
// Pass 2 combines the segments of a row: m = max m_s, z = sum z_s *
// exp(m_s - m), corr = sum corr_s, and ties on m go to the lowest column,
// exactly as the TPU kernel's strict `tile_m > m_old` does.
//
// Bound on an H100 SXM at the serving shapes (B = 64, V = 1,020,250,
// D = 512): W is 2.09 GB, 0.62 ms at 3.35 TB/s; the product is 66.9 GFLOP,
// 1.0 ms at the 67 TFLOP/s fp32 rate outside the tensor cores. So the
// kernel is bound by operations; products stay fp32 FMA on CUDA cores (no
// TF32) for parity with the fp32 reference. A tensor-core version is later
// work.
//
// Requires D % 4 == 0 and 16-byte aligned f and W (checked by the wrapper).

#include <cuda_runtime.h>
#include <math.h>

#include "ce_tiles.cuh"

namespace {

using ce_tiles::KC;
using ce_tiles::NT;
using ce_tiles::PAD;
constexpr int BT = 64;     // batch rows per block
constexpr int VT = 128;    // class rows per tile

// Fold (m2, z2, a2) into (m, z, a). Ties on the max keep the lower column.
__device__ __forceinline__ void merge_stat(float& m, float& z, int& a,
                                           float m2, float z2, int a2) {
  float mn = fmaxf(m, m2);
  if (mn == -INFINITY) return;             // both empty: z = 0, a = -1 stay
  float s1 = (m == -INFINITY) ? 0.f : expf(m - mn);
  float s2 = (m2 == -INFINITY) ? 0.f : expf(m2 - mn);
  z = z * s1 + z2 * s2;
  if (m2 > m || (m2 == m && a2 < a)) a = a2;
  m = mn;
}

// Three blocks per SM (at most 85 registers a thread): left free, nvcc 12.8
// takes 86 for this code and two blocks fit, 13% slower on an H100.
__global__ void __launch_bounds__(NT, 3)
ce_fwd_partial(const float* __restrict__ f, const float* __restrict__ w,
               const int* __restrict__ y, int B, int D, int V, int limit,
               float scale, int seg_tiles, float* __restrict__ pm,
               float* __restrict__ pz, float* __restrict__ pc,
               int* __restrict__ pa) {
  __shared__ __align__(16) float fs[KC][BT + PAD];
  __shared__ __align__(16) float ws[KC][VT + PAD];
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int b0 = blockIdx.x * BT;
  const int seg = blockIdx.y;
  const int v_begin = seg * seg_tiles * VT;
  const int v_end = min(V, v_begin + seg_tiles * VT);
  const int lim = min(limit, v_end);

  // this thread's rows: b0 + ty*4 + i; columns: v0 + tx*4 + j, v0 + 64 + tx*4 + j
  int yl[4];
  float rm[4], rz[4], rc[4];
  int ra[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int r = b0 + ty * 4 + i;
    yl[i] = (r < B) ? y[r] : -1;
    rm[i] = -INFINITY; rz[i] = 0.f; rc[i] = 0.f; ra[i] = -1;
  }

  for (int v0 = v_begin; v0 < v_end; v0 += VT) {
    float acc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < D; k0 += KC) {
      ce_tiles::stage_kmajor<BT>(&fs[0][0], BT + PAD, f, b0, B, k0, D, tid);
      ce_tiles::stage_kmajor<VT>(&ws[0][0], VT + PAD, w, v0, v_end, k0, D,
                                 tid);
      __syncthreads();
      ce_tiles::mma_stage(acc, &fs[0][0], BT + PAD, &ws[0][0], VT + PAD,
                          min(KC, D - k0), tx, ty);
      __syncthreads();
    }

    // fold the tile into the running statistics, columns in ascending order
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float tm = -INFINITY;
      int ta = -1;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        int col = v0 + ce_tiles::col_of(j, tx);
        float s = (col < lim) ? acc[i][j] * scale : -INFINITY;
        acc[i][j] = s;
        if (col == yl[i]) rc[i] += s;   // a masked label folds -inf, as on the TPU
        if (s > tm) { tm = s; ta = col; }
      }
      float mn = fmaxf(rm[i], tm);
      if (mn != -INFINITY) {
        if (tm > rm[i]) ra[i] = ta;
        float zz = (rm[i] == -INFINITY) ? 0.f : rz[i] * expf(rm[i] - mn);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (acc[i][j] != -INFINITY) zz += expf(acc[i][j] - mn);
        rz[i] = zz;
        rm[i] = mn;
      }
    }
  }

  // combine the 16 threads of each row (lanes differing in the low 4 bits)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      float om = __shfl_xor_sync(0xffffffffu, rm[i], off);
      float oz = __shfl_xor_sync(0xffffffffu, rz[i], off);
      int oa = __shfl_xor_sync(0xffffffffu, ra[i], off);
      float oc = __shfl_xor_sync(0xffffffffu, rc[i], off);
      merge_stat(rm[i], rz[i], ra[i], om, oz, oa);
      rc[i] += oc;
    }
    int r = b0 + ty * 4 + i;
    if (tx == 0 && r < B) {
      size_t o = (size_t)seg * B + r;
      pm[o] = rm[i]; pz[o] = rz[i]; pc[o] = rc[i]; pa[o] = ra[i];
    }
  }
}

// One block per row: each thread folds a strided run of segments, then the
// block combines them (ties to the lower column keep the result exact).
__global__ void __launch_bounds__(NT)
ce_fwd_combine(const float* __restrict__ pm, const float* __restrict__ pz,
               const float* __restrict__ pc, const int* __restrict__ pa,
               int B, int n_segs, float* __restrict__ m, float* __restrict__ z,
               float* __restrict__ corr, int* __restrict__ amax) {
  __shared__ float sm[NT / 32], sz[NT / 32], sc[NT / 32];
  __shared__ int sa[NT / 32];
  const int r = blockIdx.x, tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  float M = -INFINITY, Z = 0.f, C = 0.f;
  int A = -1;
  for (int s = tid; s < n_segs; s += NT) {
    size_t o = (size_t)s * B + r;
    merge_stat(M, Z, A, pm[o], pz[o], pa[o]);
    C += pc[o];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    float om = __shfl_xor_sync(0xffffffffu, M, off);
    float oz = __shfl_xor_sync(0xffffffffu, Z, off);
    int oa = __shfl_xor_sync(0xffffffffu, A, off);
    float oc = __shfl_xor_sync(0xffffffffu, C, off);
    merge_stat(M, Z, A, om, oz, oa);
    C += oc;
  }
  if (lane == 0) { sm[wid] = M; sz[wid] = Z; sa[wid] = A; sc[wid] = C; }
  __syncthreads();
  if (tid == 0) {
    M = sm[0]; Z = sz[0]; A = sa[0]; C = sc[0];
    for (int q = 1; q < NT / 32; ++q) {
      merge_stat(M, Z, A, sm[q], sz[q], sa[q]);
      C += sc[q];
    }
    m[r] = M; z[r] = Z; corr[r] = C; amax[r] = A;
  }
}

}  // namespace

extern "C" int ce_fwd_launch(const void* f, const void* w, const void* y,
                             void* pm, void* pz, void* pc, void* pa,
                             void* m, void* z, void* corr, void* amax,
                             int B, int D, int V, int limit, float scale,
                             int seg_tiles, int n_segs, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  dim3 grid1((B + BT - 1) / BT, n_segs);
  ce_fwd_partial<<<grid1, NT, 0, st>>>(
      static_cast<const float*>(f), static_cast<const float*>(w),
      static_cast<const int*>(y), B, D, V, limit, scale, seg_tiles,
      static_cast<float*>(pm), static_cast<float*>(pz),
      static_cast<float*>(pc), static_cast<int*>(pa));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ce_fwd_combine<<<B, NT, 0, st>>>(
      static_cast<const float*>(pm), static_cast<const float*>(pz),
      static_cast<const float*>(pc), static_cast<const int*>(pa), B, n_segs,
      static_cast<float*>(m), static_cast<float*>(z),
      static_cast<float*>(corr), static_cast<int*>(amax));
  return static_cast<int>(cudaGetLastError());
}
