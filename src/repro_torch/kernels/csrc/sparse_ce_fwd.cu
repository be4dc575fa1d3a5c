// Online-softmax statistics of f [B, D] over an active-class set gathered
// from a class shard W [V, D], on Hopper (sm_90a), fp32 throughout.
//
// Replaces: src/repro/kernels/sparse_ce.py, sparse_ce_forward / _fwd_kernel
// / _gather_tile / _first_hit (the Pallas TPU kernel). Column j of the
// active set is row ids[j] of W, with global class id gids[j], a bias[j]
// and a mask valid[j]. Over the scores s[b, j] = scale * <f[b], W[ids[j]]>
// + bias[j], with hit[b, j] = valid[j] && gids[j] == y[b] (y global):
//   mask_hits = 0 (knn, selective): keep[b, j] = valid[j]; the FIRST hit
//     column h[b] (lowest j) gives corr[b] = s[b, h[b]], 0 without a hit;
//   mask_hits = 1 (sampled): keep[b, j] = valid[j] && !hit[b, j];
//     corr = 0, h = -1.
//   m[b] = max over kept j, z[b] = sum over kept j of exp(s - m),
//   amax[b] = lowest kept j with s == m (-1 if nothing is kept), and
//   hit[b] = h[b], which the backward takes for its one-hot.
// Neither the gathered [A, D] rows nor the [B, A] scores reach device
// memory.
//
// Bound on an H100 SXM at the knn training shapes (B = 256, A = 102,025 of
// V = 1,020,250, D = 512): 2·B·A·D = 26.7 GFLOP, 0.40 ms at the 67 TFLOP/s
// fp32 rate; the gathered rows are 209 MB (0.06 ms at 3.35 TB/s). So it is
// bound by operations; products stay fp32 FMA on CUDA cores (no TF32) for
// parity with the fp32 reference.
//
// Design: ce_softmax_fwd.cu with three changes. The TPU kernel sweeps the
// active tiles in order on one core and finds the first hit with a "seen"
// flag carried from tile to tile. Here pass 1 runs a grid of (B tiles of
// 64) x (active-column segments); each block walks its segment in tiles of
// 128 columns, loads the tile's ids, gids, bias and mask into shared memory,
// and stages W's rows by id (a gather; ce_tiles.cuh's register-tiled
// product is unchanged). Each thread visits its columns in ascending order,
// so its first hit is its lowest; threads, then segments, keep the lowest
// hit column and its score, and the (m, z, amax) merges keep the lower
// column on equal maxima. Pass 2 combines the segments of each row in
// segment order. The result does not depend on the grid's timing.
//
// Requires D % 4 == 0 and 16-byte aligned f and W (checked by the wrapper);
// the wrapper clips ids into [0, V).

#include <cuda_runtime.h>
#include <math.h>

#include "ce_tiles.cuh"

namespace {

using ce_tiles::KC;
using ce_tiles::NT;
using ce_tiles::PAD;
constexpr int BT = 64;     // batch rows per block
constexpr int AT = 128;    // active columns per tile

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

// Keep the lower hit column (-1 = none) and its score.
__device__ __forceinline__ void merge_hit(int& h, float& hs, int h2,
                                          float hs2) {
  if (h2 >= 0 && (h < 0 || h2 < h)) { h = h2; hs = hs2; }
}

// Two blocks per SM: the hit column and its score take registers that the
// 85-register cap of three blocks would spill.
__global__ void __launch_bounds__(NT, 2)
sparse_fwd_partial(const float* __restrict__ f, const float* __restrict__ w,
                   const int* __restrict__ ids, const int* __restrict__ gids,
                   const float* __restrict__ bias,
                   const int* __restrict__ valid, const int* __restrict__ y,
                   int B, int D, int A, float scale, int mask_hits,
                   int seg_tiles, float* __restrict__ pm,
                   float* __restrict__ pz, float* __restrict__ phs,
                   int* __restrict__ pa, int* __restrict__ ph) {
  __shared__ __align__(16) float fs[KC][BT + PAD];
  __shared__ __align__(16) float ws[KC][AT + PAD];
  __shared__ int s_ids[AT], s_gid[AT], s_ok[AT];
  __shared__ float s_bias[AT];
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int b0 = blockIdx.x * BT;
  const int seg = blockIdx.y;
  const int a_begin = seg * seg_tiles * AT;
  const int a_end = min(A, a_begin + seg_tiles * AT);

  // this thread's rows: b0 + ty*4 + i
  int yl[4], rh[4];
  float rm[4], rz[4], rhs[4];
  int ra[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int r = b0 + ty * 4 + i;
    yl[i] = (r < B) ? y[r] : -1;
    rm[i] = -INFINITY; rz[i] = 0.f; ra[i] = -1; rh[i] = -1; rhs[i] = 0.f;
  }

  for (int a0 = a_begin; a0 < a_end; a0 += AT) {
    const int na = min(AT, a_end - a0);
    __syncthreads();                     // the previous tile's fold is done
    if (tid < AT) {
      const bool in = tid < na;
      s_ids[tid] = in ? ids[a0 + tid] : 0;
      s_gid[tid] = in ? gids[a0 + tid] : 0;
      s_ok[tid] = in && valid[a0 + tid] != 0;
      s_bias[tid] = in ? bias[a0 + tid] : 0.f;
    }
    __syncthreads();

    float acc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < D; k0 += KC) {
      ce_tiles::stage_kmajor<BT>(&fs[0][0], BT + PAD, f, b0, B, k0, D, tid);
      ce_tiles::stage_kmajor_rows<AT>(&ws[0][0], AT + PAD, w, s_ids, na, k0,
                                      D, tid);
      __syncthreads();
      ce_tiles::mma_stage(acc, &fs[0][0], BT + PAD, &ws[0][0], AT + PAD,
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
        const int cl = ce_tiles::col_of(j, tx), col = a0 + cl;
        const bool ok = s_ok[cl] != 0;
        float s = acc[i][j] * scale + s_bias[cl];
        const bool hit = ok && s_gid[cl] == yl[i];
        bool keep = ok;
        if (mask_hits) keep = ok && !hit;
        else if (hit && rh[i] < 0) { rh[i] = col; rhs[i] = s; }
        s = keep ? s : -INFINITY;
        acc[i][j] = s;
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
      int oh = __shfl_xor_sync(0xffffffffu, rh[i], off);
      float ohs = __shfl_xor_sync(0xffffffffu, rhs[i], off);
      merge_stat(rm[i], rz[i], ra[i], om, oz, oa);
      merge_hit(rh[i], rhs[i], oh, ohs);
    }
    int r = b0 + ty * 4 + i;
    if (tx == 0 && r < B) {
      size_t o = (size_t)seg * B + r;
      pm[o] = rm[i]; pz[o] = rz[i]; pa[o] = ra[i]; ph[o] = rh[i];
      phs[o] = rhs[i];
    }
  }
}

// One block per row: each thread folds a strided run of segments, then the
// block combines them (ties to the lower column, the lowest hit column).
__global__ void __launch_bounds__(NT)
sparse_fwd_combine(const float* __restrict__ pm, const float* __restrict__ pz,
                   const float* __restrict__ phs, const int* __restrict__ pa,
                   const int* __restrict__ ph, int B, int n_segs,
                   float* __restrict__ m, float* __restrict__ z,
                   float* __restrict__ corr, int* __restrict__ amax,
                   int* __restrict__ hit) {
  __shared__ float sm[NT / 32], sz[NT / 32], shs[NT / 32];
  __shared__ int sa[NT / 32], sh[NT / 32];
  const int r = blockIdx.x, tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  float M = -INFINITY, Z = 0.f, HS = 0.f;
  int A = -1, H = -1;
  for (int s = tid; s < n_segs; s += NT) {
    size_t o = (size_t)s * B + r;
    merge_stat(M, Z, A, pm[o], pz[o], pa[o]);
    merge_hit(H, HS, ph[o], phs[o]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    float om = __shfl_xor_sync(0xffffffffu, M, off);
    float oz = __shfl_xor_sync(0xffffffffu, Z, off);
    int oa = __shfl_xor_sync(0xffffffffu, A, off);
    int oh = __shfl_xor_sync(0xffffffffu, H, off);
    float ohs = __shfl_xor_sync(0xffffffffu, HS, off);
    merge_stat(M, Z, A, om, oz, oa);
    merge_hit(H, HS, oh, ohs);
  }
  if (lane == 0) { sm[wid] = M; sz[wid] = Z; sa[wid] = A; sh[wid] = H; shs[wid] = HS; }
  __syncthreads();
  if (tid == 0) {
    M = sm[0]; Z = sz[0]; A = sa[0]; H = sh[0]; HS = shs[0];
    for (int q = 1; q < NT / 32; ++q) {
      merge_stat(M, Z, A, sm[q], sz[q], sa[q]);
      merge_hit(H, HS, sh[q], shs[q]);
    }
    m[r] = M; z[r] = Z; amax[r] = A; hit[r] = H;
    corr[r] = H >= 0 ? HS : 0.f;
  }
}

}  // namespace

extern "C" int sparse_ce_fwd_launch(
    const void* f, const void* w, const void* ids, const void* gids,
    const void* bias, const void* valid, const void* y, void* pm, void* pz,
    void* phs, void* pa, void* ph, void* m, void* z, void* corr, void* amax,
    void* hit, int B, int D, int A, float scale, int mask_hits, int seg_tiles,
    int n_segs, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  dim3 grid1((B + BT - 1) / BT, n_segs);
  sparse_fwd_partial<<<grid1, NT, 0, st>>>(
      static_cast<const float*>(f), static_cast<const float*>(w),
      static_cast<const int*>(ids), static_cast<const int*>(gids),
      static_cast<const float*>(bias), static_cast<const int*>(valid),
      static_cast<const int*>(y), B, D, A, scale, mask_hits, seg_tiles,
      static_cast<float*>(pm), static_cast<float*>(pz),
      static_cast<float*>(phs), static_cast<int*>(pa), static_cast<int*>(ph));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sparse_fwd_combine<<<B, NT, 0, st>>>(
      static_cast<const float*>(pm), static_cast<const float*>(pz),
      static_cast<const float*>(phs), static_cast<const int*>(pa),
      static_cast<const int*>(ph), B, n_segs, static_cast<float*>(m),
      static_cast<float*>(z), static_cast<float*>(corr),
      static_cast<int*>(amax), static_cast<int*>(hit));
  return static_cast<int>(cudaGetLastError());
}
