// Backward of the active-class softmax statistics, on Hopper (sm_90a), fp32
// throughout, deterministic.
//
// Replaces: src/repro/kernels/sparse_ce.py, sparse_ce_backward / _bwd_kernel
// (the Pallas TPU kernel), and the scatter-add of its compact dW into the
// class shard that src/repro/kernels/ops.py (_sparse_ce_bwd) does after it.
// With the columns of sparse_ce_fwd.cu (row ids[j] of W, gids[j], bias[j],
// valid[j]), the forward's row max m [B], its first-hit column h [B] (-1 =
// none) and the cotangents gz, gc [B] of z and corr, it recomputes
// s[b, j] = scale * <f[b], W[ids[j]]> + bias[j] and forms
//   p[b, j]  = exp(s[b, j] - m[b])  where kept (as in the forward) and m[b]
//              is finite, else 0
//   dl[b, j] = (p[b, j] * gz[b] + [j == h[b]] * gc[b]) * scale
//   dW_act[j, :] = sum_b dl[b, j] f[b, :]   df[b, :] = sum_j dl[b, j] W[ids[j], :]
// and then dW[v, :] = sum of dW_act[j, :] over the j with ids[j] == v: ids
// repeat where random fillers collide, and those rows must add up.
//
// Bound on an H100 SXM at the knn training shapes (B = 256, A = 102,025 of
// V = 1,020,250, D = 512): three products of 2·B·A·D each, 80.2 GFLOP,
// 1.20 ms at the 67 TFLOP/s fp32 rate; the gathered rows and dW_act are
// 0.42 GB (0.12 ms at 3.35 TB/s). So it is bound by operations; fp32 FMA on
// CUDA cores, no TF32. (The dense [V, D] dW that the caller zero-fills is
// 2.09 GB more, outside this bound.)
//
// Design: ce_softmax_bwd.cu with the columns gathered by id. One block per
// active-column segment walks it in tiles of 128 columns with every batch
// row (128 rows at a time): A. the score tile from W's rows by id (the
// ce_tiles.cuh product, as the forward computes it), dl into shared memory;
// B. dW_act for the tile's columns, written once by its one owner; C. the
// segment's partial of df into the block's own slice of a [n_segs, B, D]
// buffer. The TPU kernel's first-hit flag, carried from tile to tile, is
// replaced by the forward's hit column h. Then three small launches: the df
// partials summed in segment order; and the scatter of dW_act into dW: the
// wrapper sorts ids stably, and one block per run of equal ids sums its rows
// in that order. No floating-point atomics: the same inputs give the same
// bits on every run.
//
// Requires D % 4 == 0 and 16-byte aligned f, W and the outputs (checked by
// the wrapper); the wrapper clips ids into [0, V) and zero-fills dW.

#include <cuda_runtime.h>
#include <math.h>

#include "ce_tiles.cuh"

namespace {

using ce_tiles::col_of;
using ce_tiles::KC;
using ce_tiles::mma_stage;
using ce_tiles::NT;
using ce_tiles::PAD;
using ce_tiles::stage_kmajor;
using ce_tiles::stage_kmajor_rows;
constexpr int BT = 64;     // batch rows per score sub-tile
constexpr int BS = 128;    // batch rows held in shared memory (dl rows)
constexpr int AT = 128;    // active columns per tile
constexpr int DT = 128;    // feature columns per output tile (phases B, C)
constexpr int LDL = AT + PAD;                      // dl row stride (floats)
constexpr int STAGE = KC * (BT + PAD) + KC * (AT + PAD);
constexpr int SMEM_FLOATS = BS * LDL + STAGE;      // 93,184 bytes
static_assert(STAGE >= KC * (DT + PAD), "stage too small for phases B, C");

// Stage rows [r0, r0 + 32) x columns [c0, c0 + 128) of a row-major
// [rmax, D] matrix into s[r][c] (rows are the depth), zero outside. With
// ``rows``, tile row r is row rows[r] of g (a gather).
__device__ __forceinline__ void stage_rowmajor(float* s, const float* g,
                                               const int* rows, int r0,
                                               int rmax, int c0, int D,
                                               int tid) {
  constexpr int N4 = KC * DT / 4;                  // 1024 float4
#pragma unroll
  for (int l = 0; l < N4 / NT; ++l) {
    int q = tid + l * NT, row = q >> 5, c = c0 + (q & 31) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + row < rmax && c < D) {
      const size_t src = rows ? (size_t)rows[r0 + row] : (size_t)(r0 + row);
      v = *reinterpret_cast<const float4*>(g + src * D + c);
    }
    *reinterpret_cast<float4*>(s + row * (DT + PAD) + (q & 31) * 4) = v;
  }
}

__global__ void __launch_bounds__(NT, 2)
sparse_bwd_partial(const float* __restrict__ f, const float* __restrict__ w,
                   const int* __restrict__ ids, const int* __restrict__ gids,
                   const float* __restrict__ bias,
                   const int* __restrict__ valid, const int* __restrict__ y,
                   const float* __restrict__ m, const float* __restrict__ gz,
                   const float* __restrict__ gc, const int* __restrict__ hit,
                   int B, int D, int A, float scale, int mask_hits,
                   int seg_tiles, float* __restrict__ dwa,
                   float* __restrict__ pdf) {
  extern __shared__ __align__(16) float smem[];
  float* dl = smem;                      // [BS][LDL]
  float* stage = smem + BS * LDL;
  __shared__ int s_ids[AT], s_gid[AT], s_ok[AT];
  __shared__ float s_bias[AT];
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int seg = blockIdx.x;
  const int a_begin = seg * seg_tiles * AT;
  const int a_end = min(A, a_begin + seg_tiles * AT);
  float* pdf_seg = pdf + (size_t)seg * B * D;

  for (int r0 = 0; r0 < B; r0 += BS) {
    const int nb = min(BS, B - r0);      // live rows of this chunk
    for (int a0 = a_begin; a0 < a_end; a0 += AT) {
      const int na = min(AT, a_end - a0);
      if (tid < AT) {    // the previous tile's last reader passed a barrier
        const bool in = tid < na;
        s_ids[tid] = in ? ids[a0 + tid] : 0;
        s_gid[tid] = in ? gids[a0 + tid] : 0;
        s_ok[tid] = in && valid[a0 + tid] != 0;
        s_bias[tid] = in ? bias[a0 + tid] : 0.f;
      }
      __syncthreads();

      // -- A: dl[b][j] for the chunk's rows and the tile's columns ---------
      for (int bc = 0; bc < nb; bc += BT) {
        float acc[4][8];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
        float* fs = stage;                       // [KC][BT + PAD]
        float* ws = stage + KC * (BT + PAD);     // [KC][AT + PAD]
        for (int k0 = 0; k0 < D; k0 += KC) {
          stage_kmajor<BT>(fs, BT + PAD, f, r0 + bc, B, k0, D, tid);
          stage_kmajor_rows<AT>(ws, AT + PAD, w, s_ids, na, k0, D, tid);
          __syncthreads();
          mma_stage(acc, fs, BT + PAD, ws, AT + PAD, min(KC, D - k0), tx, ty);
          __syncthreads();
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int rl = bc + ty * 4 + i, r = r0 + rl;
          float mr = 0.f, gzr = 0.f, gcr = 0.f;
          int yr = -1, hr = -1;
          const bool live = r < B;
          if (live) { mr = m[r]; gzr = gz[r]; gcr = gc[r]; yr = y[r]; hr = hit[r]; }
          const bool mfin = isfinite(mr);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int cl = col_of(j, tx), col = a0 + cl;
            const bool ok = s_ok[cl] != 0;
            const bool keep = ok && !(mask_hits && s_gid[cl] == yr);
            const float s = acc[i][j] * scale + s_bias[cl];
            const float p = (keep && mfin) ? expf(s - mr) : 0.f;
            const float oh = (col == hr) ? 1.f : 0.f;
            const float d = (p * gzr + oh * gcr) * scale;
            dl[rl * LDL + cl] = (live && cl < na) ? d : 0.f;
          }
        }
      }
      __syncthreads();

      // -- B: dW_act[a0 + j][:] (+)= sum_b dl[b][j] f[r0 + b][:] ------------
      for (int vh = 0; vh < AT; vh += 64) {
        for (int c0 = 0; c0 < D; c0 += DT) {
          float acc[4][8];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
          for (int k0 = 0; k0 < nb; k0 += KC) {
            stage_rowmajor(stage, f, nullptr, r0 + k0, B, c0, D, tid);
            __syncthreads();
            mma_stage(acc, dl + k0 * LDL + vh, LDL, stage, DT + PAD,
                      min(KC, nb - k0), tx, ty);
            __syncthreads();
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int a = a0 + vh + ty * 4 + i;
            if (a >= a_end) continue;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int c = c0 + h * 64 + tx * 4;
              if (c >= D) continue;
              float4* o = reinterpret_cast<float4*>(dwa + (size_t)a * D + c);
              float4 val = make_float4(acc[i][h * 4 + 0], acc[i][h * 4 + 1],
                                       acc[i][h * 4 + 2], acc[i][h * 4 + 3]);
              if (r0 > 0) {
                float4 old = *o;
                val.x += old.x; val.y += old.y; val.z += old.z; val.w += old.w;
              }
              *o = val;
            }
          }
        }
      }

      // -- C: pdf[seg][r0 + b][:] (+)= sum_j dl[b][j] W[ids[a0 + j]][:] ----
      for (int bc = 0; bc < nb; bc += BT) {
        for (int c0 = 0; c0 < D; c0 += DT) {
          float acc[4][8];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
          for (int k0 = 0; k0 < AT; k0 += KC) {
            stage_rowmajor(stage, w, s_ids, k0, na, c0, D, tid);
            __syncthreads();
            const float* drow = dl + (bc + ty * 4) * LDL + k0;
#pragma unroll 4
            for (int k = 0; k < KC; ++k) {
              float4 b1 = *reinterpret_cast<const float4*>(
                  stage + k * (DT + PAD) + tx * 4);
              float4 b2 = *reinterpret_cast<const float4*>(
                  stage + k * (DT + PAD) + 64 + tx * 4);
              float br[8] = {b1.x, b1.y, b1.z, b1.w, b2.x, b2.y, b2.z, b2.w};
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                const float a = drow[i * LDL + k];
#pragma unroll
                for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a, br[j], acc[i][j]);
              }
            }
            __syncthreads();
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int r = r0 + bc + ty * 4 + i;
            if (r >= B) continue;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int c = c0 + h * 64 + tx * 4;
              if (c >= D) continue;
              float4* o = reinterpret_cast<float4*>(pdf_seg + (size_t)r * D + c);
              float4 val = make_float4(acc[i][h * 4 + 0], acc[i][h * 4 + 1],
                                       acc[i][h * 4 + 2], acc[i][h * 4 + 3]);
              if (a0 > a_begin) {
                float4 old = *o;
                val.x += old.x; val.y += old.y; val.z += old.z; val.w += old.w;
              }
              *o = val;
            }
          }
        }
      }
      __syncthreads();   // dl and the column table are rewritten next tile
    }
  }
}

// df[e] = sum over segments s, in order, of pdf[s][e]: one thread per element.
__global__ void __launch_bounds__(NT)
sparse_bwd_combine(const float* __restrict__ pdf, int n_elems, int n_segs,
                   float* __restrict__ df) {
  const int e = blockIdx.x * NT + threadIdx.x;
  if (e >= n_elems) return;
  float s = 0.f;
  for (int q = 0; q < n_segs; ++q) s += pdf[(size_t)q * n_elems + e];
  df[e] = s;
}

// dW[sid[k]] = sum of dW_act[order[k']] over the run k' = k, k + 1, ... of
// equal sorted ids, in that order. One block per sorted position; only the
// first position of a run works.
__global__ void __launch_bounds__(NT)
sparse_bwd_scatter(const float* __restrict__ dwa, const int* __restrict__ sid,
                   const long long* __restrict__ order, int A, int D,
                   float* __restrict__ dw) {
  const int k = blockIdx.x;
  const int id = sid[k];
  if (k > 0 && sid[k - 1] == id) return;
  for (int c = threadIdx.x * 4; c < D; c += NT * 4) {
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int q = k; q < A && sid[q] == id; ++q) {
      float4 v = *reinterpret_cast<const float4*>(dwa + (size_t)order[q] * D + c);
      s.x += v.x; s.y += v.y; s.z += v.z; s.w += v.w;
    }
    *reinterpret_cast<float4*>(dw + (size_t)id * D + c) = s;
  }
}

}  // namespace

extern "C" int sparse_ce_bwd_launch(
    const void* f, const void* w, const void* ids, const void* gids,
    const void* bias, const void* valid, const void* y, const void* m,
    const void* gz, const void* gc, const void* hit, const void* sid,
    const void* order, void* dwa, void* pdf, void* df, void* dw, int B, int D,
    int A, float scale, int mask_hits, int seg_tiles, int n_segs,
    void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int smem_bytes = SMEM_FLOATS * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      sparse_bwd_partial, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  sparse_bwd_partial<<<n_segs, NT, smem_bytes, st>>>(
      static_cast<const float*>(f), static_cast<const float*>(w),
      static_cast<const int*>(ids), static_cast<const int*>(gids),
      static_cast<const float*>(bias), static_cast<const int*>(valid),
      static_cast<const int*>(y), static_cast<const float*>(m),
      static_cast<const float*>(gz), static_cast<const float*>(gc),
      static_cast<const int*>(hit), B, D, A, scale, mask_hits, seg_tiles,
      static_cast<float*>(dwa), static_cast<float*>(pdf));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_elems = B * D;
  sparse_bwd_combine<<<(n_elems + NT - 1) / NT, NT, 0, st>>>(
      static_cast<const float*>(pdf), n_elems, n_segs,
      static_cast<float*>(df));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sparse_bwd_scatter<<<A, NT, 0, st>>>(
      static_cast<const float*>(dwa), static_cast<const int*>(sid),
      static_cast<const long long*>(order), A, D, static_cast<float*>(dw));
  return static_cast<int>(cudaGetLastError());
}
