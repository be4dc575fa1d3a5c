// Streaming backward of the fused softmax statistics, on Hopper (sm_90a),
// fp32 throughout.
//
// Replaces: src/repro/kernels/ce_softmax.py, ce_backward / _bwd_kernel (the
// Pallas TPU kernel). Given f [B, D], a class shard W [V, D], the local
// labels y [B] (-1 = not on this shard), the forward's row max m [B] and the
// per-row cotangents gz, gc [B] of the forward's z and corr, it recomputes
// the scores s[b, v] = scale * <f[b], W[v]> and forms
//   p[b, v]  = exp(s[b, v] - m[b])   where v < limit and m[b] is finite, else 0
//   dl[b, v] = (p[b, v] * gz[b] + [v == y[b]] * gc[b]) * scale
// (the one-hot is not masked by limit, as on the TPU), then
//   dW[v, :] = sum_b dl[b, v] f[b, :]       df[b, :] = sum_v dl[b, v] W[v, :]
// The [B, V] matrix dl never reaches device memory.
//
// Bound on an H100 SXM at the training shapes (B = 256, V = 1,020,250,
// D = 512): three products of 2·B·V·D each (recompute s, dW, df), 802 GFLOP,
// 11.98 ms at the 67 TFLOP/s fp32 rate outside the tensor cores; reading W
// and writing dW is 4.18 GB, 1.25 ms at 3.35 TB/s. So the kernel is bound by
// operations; products stay fp32 FMA on CUDA cores (no TF32) for parity with
// the fp32 reference.
//
// Design. The TPU kernel sweeps V in order on one core, writing each dW tile
// and carrying df in scratch. Here the grid is one block per class segment
// (about two blocks per SM), and each block walks its segment in tiles of
// 128 classes with every batch row:
//   A. the 128-row x 128-class score tile, 64 rows at a time, with the
//      register-tiled product that ce_softmax_fwd.cu uses (ce_tiles.cuh),
//      so s is recomputed as the forward computed it; dl goes to shared memory
//      ([128][132] floats), never to device memory;
//   B. dW for the tile's 128 classes: dl^T f, depth over the batch rows,
//      written once (one block owns each class row: no atomics);
//   C. this segment's partial of df: dl W_tile, added into the block's own
//      slice of a [n_segs, B, D] buffer in device memory (the same thread
//      owns the same elements on every tile, so no atomics and no races).
// Batches above 128 rows loop over row chunks of 128 outside the tile loop;
// dW is then accumulated in place by its owning thread. A second launch
// sums the segments' df partials for each element in segment order, so the
// result is the same bit for bit on every run.
//
// Not the "df parallel over B tiles, sweeping V" plan: at B <= 256 that
// leaves B/64 <= 4 blocks busy on 132 SMs for a third of the work, and a
// separate df kernel would recompute the scores (a fourth product). Here
// W is read from device memory once per 128-row chunk and the three
// products share the recomputed scores.
//
// Requires D % 4 == 0 and 16-byte aligned f and W (checked by the wrapper).

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
constexpr int BT = 64;     // batch rows per score sub-tile
constexpr int BS = 128;    // batch rows held in shared memory (dl rows)
constexpr int VT = 128;    // classes per tile
constexpr int DT = 128;    // feature columns per output tile (phases B, C)
constexpr int LDL = VT + PAD;                      // dl row stride (floats)
constexpr int STAGE = KC * (BT + PAD) + KC * (VT + PAD);
constexpr int SMEM_FLOATS = BS * LDL + STAGE;      // 93,184 bytes
static_assert(STAGE >= KC * (DT + PAD), "stage too small for phases B, C");

// Stage rows [r0, r0 + 32) x columns [c0, c0 + 128) of a row-major
// [rows_total, D] matrix into s[r][c] (rows are the depth), zero outside.
__device__ __forceinline__ void stage_rowmajor(float* s, const float* g,
                                               int r0, int rmax, int c0,
                                               int D, int tid) {
  constexpr int N4 = KC * DT / 4;                  // 1024 float4
#pragma unroll
  for (int l = 0; l < N4 / NT; ++l) {
    int q = tid + l * NT, row = q >> 5, c = c0 + (q & 31) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + row < rmax && c < D)
      v = *reinterpret_cast<const float4*>(g + (size_t)(r0 + row) * D + c);
    *reinterpret_cast<float4*>(s + row * (DT + PAD) + (q & 31) * 4) = v;
  }
}

__global__ void __launch_bounds__(NT, 2)
ce_bwd_partial(const float* __restrict__ f, const float* __restrict__ w,
               const int* __restrict__ y, const float* __restrict__ m,
               const float* __restrict__ gz, const float* __restrict__ gc,
               int B, int D, int V, int limit, float scale, int seg_tiles,
               float* __restrict__ dw, float* __restrict__ pdf) {
  extern __shared__ __align__(16) float smem[];
  float* dl = smem;                      // [BS][LDL]
  float* stage = smem + BS * LDL;
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int seg = blockIdx.x;
  const int v_begin = seg * seg_tiles * VT;
  const int v_end = min(V, v_begin + seg_tiles * VT);
  float* pdf_seg = pdf + (size_t)seg * B * D;

  for (int r0 = 0; r0 < B; r0 += BS) {
    const int nb = min(BS, B - r0);      // live rows of this chunk
    for (int v0 = v_begin; v0 < v_end; v0 += VT) {
      // -- A: dl[b][v] for the chunk's rows and the tile's classes --------
      for (int bc = 0; bc < nb; bc += BT) {
        float acc[4][8];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
        float* fs = stage;                       // [KC][BT + PAD]
        float* ws = stage + KC * (BT + PAD);     // [KC][VT + PAD]
        for (int k0 = 0; k0 < D; k0 += KC) {
          stage_kmajor<BT>(fs, BT + PAD, f, r0 + bc, B, k0, D, tid);
          stage_kmajor<VT>(ws, VT + PAD, w, v0, v_end, k0, D, tid);
          __syncthreads();
          mma_stage(acc, fs, BT + PAD, ws, VT + PAD, min(KC, D - k0), tx, ty);
          __syncthreads();
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int rl = bc + ty * 4 + i, r = r0 + rl;
          float mr = 0.f, gzr = 0.f, gcr = 0.f;
          int yr = -1;
          bool live = r < B;
          if (live) { mr = m[r]; gzr = gz[r]; gcr = gc[r]; yr = y[r]; }
          const bool mfin = isfinite(mr);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int cl = col_of(j, tx), col = v0 + cl;
            float p = (col < limit && mfin) ? expf(acc[i][j] * scale - mr)
                                            : 0.f;
            float hit = (col == yr) ? 1.f : 0.f;
            float d = (p * gzr + hit * gcr) * scale;
            dl[rl * LDL + cl] = (live && col < v_end) ? d : 0.f;
          }
        }
      }
      __syncthreads();

      // -- B: dW[v0 + v][:] (+)= sum_b dl[b][v] f[r0 + b][:] -------------
      for (int vh = 0; vh < VT; vh += 64) {
        for (int c0 = 0; c0 < D; c0 += DT) {
          float acc[4][8];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
          for (int k0 = 0; k0 < nb; k0 += KC) {
            stage_rowmajor(stage, f, r0 + k0, B, c0, D, tid);
            __syncthreads();
            mma_stage(acc, dl + k0 * LDL + vh, LDL, stage, DT + PAD,
                      min(KC, nb - k0), tx, ty);
            __syncthreads();
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int v = v0 + vh + ty * 4 + i;
            if (v >= v_end) continue;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int c = c0 + h * 64 + tx * 4;
              if (c >= D) continue;
              float4* o = reinterpret_cast<float4*>(dw + (size_t)v * D + c);
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

      // -- C: pdf[seg][r0 + b][:] (+)= sum_v dl[b][v] W[v0 + v][:] ---------
      for (int bc = 0; bc < nb; bc += BT) {
        for (int c0 = 0; c0 < D; c0 += DT) {
          float acc[4][8];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
          for (int k0 = 0; k0 < VT; k0 += KC) {
            stage_rowmajor(stage, w, v0 + k0, v_end, c0, D, tid);
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
              if (v0 > v_begin) {
                float4 old = *o;
                val.x += old.x; val.y += old.y; val.z += old.z; val.w += old.w;
              }
              *o = val;
            }
          }
        }
      }
      __syncthreads();   // dl is rewritten by the next tile's phase A
    }
  }
}

// df[e] = sum over segments s, in order, of pdf[s][e]: one thread per element.
__global__ void __launch_bounds__(NT)
ce_bwd_combine(const float* __restrict__ pdf, int n_elems, int n_segs,
               float* __restrict__ df) {
  const int e = blockIdx.x * NT + threadIdx.x;
  if (e >= n_elems) return;
  float s = 0.f;
  for (int q = 0; q < n_segs; ++q) s += pdf[(size_t)q * n_elems + e];
  df[e] = s;
}

}  // namespace

extern "C" int ce_bwd_launch(const void* f, const void* w, const void* y,
                             const void* m, const void* gz, const void* gc,
                             void* dw, void* pdf, void* df, int B, int D,
                             int V, int limit, float scale, int seg_tiles,
                             int n_segs, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int smem_bytes = SMEM_FLOATS * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      ce_bwd_partial, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  ce_bwd_partial<<<n_segs, NT, smem_bytes, st>>>(
      static_cast<const float*>(f), static_cast<const float*>(w),
      static_cast<const int*>(y), static_cast<const float*>(m),
      static_cast<const float*>(gz), static_cast<const float*>(gc), B, D, V,
      limit, scale, seg_tiles, static_cast<float*>(dw),
      static_cast<float*>(pdf));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_elems = B * D;
  ce_bwd_combine<<<(n_elems + NT - 1) / NT, NT, 0, st>>>(
      static_cast<const float*>(pdf), n_elems, n_segs,
      static_cast<float*>(df));
  return static_cast<int>(cudaGetLastError());
}
