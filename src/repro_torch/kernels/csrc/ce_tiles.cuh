// The register-tiled fp32 product shared by ce_softmax_fwd.cu,
// ce_softmax_bwd.cu and the sparse kernels (sparse_ce_fwd.cu,
// sparse_ce_bwd.cu), so that each forward and its backward recompute the
// scores with the same loads and the same FMA order.
//
// A block of NT = 256 threads is 16 x 16 (tx = tid & 15, ty = tid >> 4);
// each thread holds a 4 x 8 micro-tile acc[i][j] of rows ty*4 + i and
// columns col_of(j, tx). Depth is staged through shared memory KC = 32 at a
// time, with 16-byte coalesced loads of the row-major operands.
#pragma once

#include <cuda_runtime.h>

namespace ce_tiles {

constexpr int KC = 32;     // depth per shared-memory stage
constexpr int NT = 256;    // threads: 16 (rows) x 16 (columns)
constexpr int PAD = 4;     // shared-memory row padding (floats)

// acc[i][j] += a[k][ty*4+i] * b[k][col_of(j, tx)] for k < kmax, ascending
__device__ __forceinline__ void mma_stage(float (&acc)[4][8], const float* a,
                                          int lda, const float* b, int ldb,
                                          int kmax, int tx, int ty) {
#pragma unroll 8
  for (int k = 0; k < kmax; ++k) {
    float4 av = *reinterpret_cast<const float4*>(a + k * lda + ty * 4);
    float4 b1 = *reinterpret_cast<const float4*>(b + k * ldb + tx * 4);
    float4 b2 = *reinterpret_cast<const float4*>(b + k * ldb + 64 + tx * 4);
    float ar[4] = {av.x, av.y, av.z, av.w};
    float br[8] = {b1.x, b1.y, b1.z, b1.w, b2.x, b2.y, b2.z, b2.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
  }
}

// The column of a tile that acc[.][j] holds in thread column tx.
__device__ __forceinline__ int col_of(int j, int tx) {
  return j < 4 ? tx * 4 + j : 64 + tx * 4 + (j - 4);
}

// Stage rows [r0, r0 + NROWS) x columns [c0, c0 + KC) of a row-major
// [rmax, D] matrix into s[c][r] (depth-major, row stride lds), zero outside.
template <int NROWS>
__device__ __forceinline__ void stage_kmajor(float* s, int lds, const float* g,
                                             int r0, int rmax, int c0, int D,
                                             int tid) {
  constexpr int N4 = NROWS * KC / 4;
  static_assert(N4 % NT == 0, "whole float4 loads per thread");
#pragma unroll
  for (int l = 0; l < N4 / NT; ++l) {
    int q = tid + l * NT, row = q >> 3, c4 = q & 7, kk = c0 + c4 * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + row < rmax && kk < D)
      v = *reinterpret_cast<const float4*>(g + (size_t)(r0 + row) * D + kk);
    s[(c4 * 4 + 0) * lds + row] = v.x; s[(c4 * 4 + 1) * lds + row] = v.y;
    s[(c4 * 4 + 2) * lds + row] = v.z; s[(c4 * 4 + 3) * lds + row] = v.w;
  }
}

// As stage_kmajor, but tile row r is row rows[r] of g (a gather, for the
// sparse kernels' active classes); rows r >= nrows are zero.
template <int NROWS>
__device__ __forceinline__ void stage_kmajor_rows(float* s, int lds,
                                                  const float* g,
                                                  const int* rows, int nrows,
                                                  int c0, int D, int tid) {
  constexpr int N4 = NROWS * KC / 4;
  static_assert(N4 % NT == 0, "whole float4 loads per thread");
#pragma unroll
  for (int l = 0; l < N4 / NT; ++l) {
    int q = tid + l * NT, row = q >> 3, c4 = q & 7, kk = c0 + c4 * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < nrows && kk < D)
      v = *reinterpret_cast<const float4*>(g + (size_t)rows[row] * D + kk);
    s[(c4 * 4 + 0) * lds + row] = v.x; s[(c4 * 4 + 1) * lds + row] = v.y;
    s[(c4 * 4 + 2) * lds + row] = v.z; s[(c4 * 4 + 3) * lds + row] = v.w;
  }
}

}  // namespace ce_tiles
