// Fused score + running top-k' of bf16 query rows against bf16 key rows, on
// Hopper (sm_90a): the inner loop of the exact KNN graph build.
//
// Replaces: src/repro/kernels/knn_dist_topk.py, dist_topk /
// _dist_topk_kernel / _merge_sweep (the Pallas TPU kernel). For every query
// row q it returns the k' largest scores s[q, n] = <Q[q], K[n]> over the Nk
// key rows, accumulated in fp32 from bf16 inputs, as (value, column) pairs
// in the order (value descending, column ascending): on equal values the
// lowest column wins, as the TPU kernel's argmax sweeps over [acc, tile]
// give. Slots beyond Nk stay (-inf, -1). The [Nq, Nk] score matrix never
// reaches device memory.
//
// Bound on an H100 SXM at the graph build's shapes (Nq = Nk = 1,020,250,
// D = 512, k' = 32): 2·Nq·Nk·D = 1.066 PFLOP of bf16 products, 1.08 s at
// the 989 TFLOP/s dense bf16 tensor-core rate; the inputs are 2.09 GB
// (0.62 ms at 3.35 TB/s). So it is bound by operations, and the products
// run on the tensor cores (mma.sync m16n8k16, bf16 in, fp32 accumulate;
// wgmma is later work).
//
// Design. The TPU kernel walks the key tiles in order, merging each
// [bq, bn] score tile into a running top-k' by k' argmax sweeps. Here each
// block of 256 threads owns 128 query rows for the whole sweep over K:
//   - the block's 128 x D query rows stay in shared memory (loaded once);
//   - K streams through a 3-stage cp.async ring in tiles of 64 rows x 64
//     depth; 8 warps (4 x 2) compute the 128 x 64 score tile with
//     mma.sync, each warp a 32 x 32 corner (A and B fragments by ldmatrix);
//   - the tile goes to shared memory, and each warp then folds 16 rows into
//     their running top-k', which lives in registers: lane j of the warp
//     holds slot j of each of its rows, sorted. A score enters only if it
//     beats the row's k'-th slot under (value desc, column asc), so after
//     the first few tiles almost nothing enters and the fold is a compare
//     and a ballot per score. An entry is placed by one ballot (its rank)
//     and one shuffle (the slots below it move down one). The order is
//     total, so the result does not depend on the order of insertion.
//   - columns at or past Nk are masked in the kernel; rows past Nq are not
//     written.
// One launch per ring hop; the wrapper shifts the ids by the hop's column
// offset.
//
// Requires D % 8 == 0, D <= 640, 16-byte aligned Q and K, 1 <= k' <= 32
// (checked by the wrapper).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_tiles.cuh"

namespace {

using namespace mma_tiles;

constexpr int NT = 256;          // threads: 8 warps
constexpr int BQ = 128;          // query rows per block
constexpr int BN = 64;           // key rows per tile
constexpr int KC = 64;           // depth per pipeline stage (bf16)
constexpr int STAGES = 3;
constexpr int KS = KC + 8;       // stage row stride (bf16): 144 B, conflict-free ldmatrix
constexpr int SS = BN + 8;       // score row stride (floats): conflict-free float2 stores
constexpr int ROWS_PER_WARP = BQ / (NT / 32);   // 16

// (av, ac) comes before (bv, bc): larger value, then lower column
__device__ __forceinline__ bool before(float av, int ac, float bv, int bc) {
  return av > bv || (av == bv && ac < bc);
}

__global__ void __launch_bounds__(NT, 1)
dist_topk_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k, int Nq, int Nk, int D,
                 int Dp, int kp, float* __restrict__ vals,
                 int* __restrict__ ids) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int QS = Dp + 8;                          // query row stride (bf16)
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = qs + BQ * QS;               // [STAGES][BN][KS]
  float* sc = reinterpret_cast<float*>(ks + STAGES * BN * KS);  // [BQ][SS]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * BQ;
  const int wm = warp >> 1, wn = warp & 1;        // warp tile: 32 rows x 32 cols
  const int n_kc = Dp / KC;
  const int n_tiles = (Nk + BN - 1) / BN;
  const int total = n_tiles * n_kc;

  // -- the block's query rows, once (zero past Nq and past D) --------------
  for (int c = tid; c < BQ * (Dp / 8); c += NT) {
    const int r = c / (Dp / 8), d = (c % (Dp / 8)) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (q0 + r < Nq && d < D)
      v = *reinterpret_cast<const uint4*>(q + (size_t)(q0 + r) * D + d);
    *reinterpret_cast<uint4*>(qs + r * QS + d) = v;
  }

  auto load_stage = [&](int it) {
    const int t = it / n_kc, kc = it % n_kc;
    __nv_bfloat16* dst = ks + (it % STAGES) * BN * KS;
#pragma unroll
    for (int l = 0; l < BN * (KC / 8) / NT; ++l) {   // 2 chunks a thread
      const int c = tid + l * NT, r = c >> 3, d = kc * KC + (c & 7) * 8;
      const int n = t * BN + r;
      const bool ok = n < Nk && d < D;
      const __nv_bfloat16* src = ok ? k + (size_t)n * D + d : k;
      cp_async16(dst + r * KS + (c & 7) * 8, src, ok);
    }
  };

  // running top-k' of this warp's 16 rows: lane j holds slot j of each
  float tv[ROWS_PER_WARP];
  int ti[ROWS_PER_WARP];
#pragma unroll
  for (int r = 0; r < ROWS_PER_WARP; ++r) { tv[r] = -INFINITY; ti[r] = -1; }

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < total) load_stage(s);
    cp_async_commit();
  }

  for (int it = 0; it < total; ++it) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (it + STAGES - 1 < total) load_stage(it + STAGES - 1);
    cp_async_commit();

    const int t = it / n_kc, kc = it % n_kc;
    const __nv_bfloat16* kb = ks + (it % STAGES) * BN * KS;
#pragma unroll
    for (int kk = 0; kk < KC; kk += 16) {
      uint32_t a[2][4], b[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int row = wm * 32 + mi * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        const int col = kc * KC + kk + (lane >> 4) * 8;
        ldmatrix_x4(a[mi], qs + row * QS + col);
      }
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        const int n = wn * 32 + nj * 16 + (lane & 7) + (lane >> 4) * 8;
        const int col = kk + ((lane >> 3) & 1) * 8;
        ldmatrix_x4(b[nj], kb + n * KS + col);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          mma_bf16(acc[mi][ni], a[mi], b[ni >> 1][(ni & 1) * 2],
                   b[ni >> 1][(ni & 1) * 2 + 1]);
    }
    if (kc != n_kc - 1) continue;

    // -- the 128 x 64 tile is complete: through shared memory ------------
    {
      const int g = lane >> 2, tg = lane & 3;
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const int row = wm * 32 + mi * 16 + g, col = wn * 32 + ni * 8 + tg * 2;
          *reinterpret_cast<float2*>(sc + row * SS + col) =
              make_float2(acc[mi][ni][0], acc[mi][ni][1]);
          *reinterpret_cast<float2*>(sc + (row + 8) * SS + col) =
              make_float2(acc[mi][ni][2], acc[mi][ni][3]);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
        }
    }
    __syncthreads();

    // -- fold each row's 64 scores into its running top-k' ---------------
    const int n0 = t * BN;
#pragma unroll
    for (int r = 0; r < ROWS_PER_WARP; ++r) {
      const float* srow = sc + (warp * ROWS_PER_WARP + r) * SS;
#pragma unroll
      for (int h = 0; h < BN / 32; ++h) {
        const int col = n0 + h * 32 + lane;
        const float s = srow[h * 32 + lane];
        const float kv = __shfl_sync(0xffffffffu, tv[r], kp - 1);
        const int kcol = __shfl_sync(0xffffffffu, ti[r], kp - 1);
        unsigned cand = __ballot_sync(0xffffffffu,
                                      col < Nk && before(s, col, kv, kcol));
        while (cand) {
          const int src = __ffs(cand) - 1;
          cand &= cand - 1;
          const float v = __shfl_sync(0xffffffffu, s, src);
          const int c = __shfl_sync(0xffffffffu, col, src);
          // rank of the entry: the number of slots that come before it
          const int p = __popc(__ballot_sync(
              0xffffffffu, lane < kp && before(tv[r], ti[r], v, c)));
          const float uv = __shfl_up_sync(0xffffffffu, tv[r], 1);
          const int uc = __shfl_up_sync(0xffffffffu, ti[r], 1);
          if (p < kp) {
            if (lane == p) { tv[r] = v; ti[r] = c; }
            else if (lane > p && lane < kp) { tv[r] = uv; ti[r] = uc; }
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  // -- write each row's slots -------------------------------------------------
#pragma unroll
  for (int r = 0; r < ROWS_PER_WARP; ++r) {
    const int row = q0 + warp * ROWS_PER_WARP + r;
    if (row < Nq && lane < kp) {
      vals[(size_t)row * kp + lane] = tv[r];
      ids[(size_t)row * kp + lane] = ti[r];
    }
  }
}

}  // namespace

extern "C" int dist_topk_launch(const void* q, const void* k, int Nq, int Nk,
                                int D, int kp, void* vals, void* ids,
                                void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int Dp = (D + KC - 1) / KC * KC;
  const int smem = BQ * (Dp + 8) * 2 + STAGES * BN * KS * 2 + BQ * SS * 4;
  cudaError_t err = cudaFuncSetAttribute(
      dist_topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((Nq + BQ - 1) / BQ);
  dist_topk_kernel<<<grid, NT, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k), Nq, Nk, D, Dp, kp,
      static_cast<float*>(vals), static_cast<int*>(ids));
  return static_cast<int>(cudaGetLastError());
}
