// Streaming online-softmax statistics of f [B, D] against a class shard
// W [V, D], on Hopper (sm_90a): 3xTF32 wgmma products fed by TMA.
//
// Replaces: src/repro/kernels/ce_softmax.py:106, ce_forward / _fwd_kernel
// (the Pallas TPU kernel). Same outputs per row b, over the scores
// s[b, v] = scale * <f[b], W[v]> with columns v >= limit masked to -inf:
//   m[b]    = max_v s[b, v]                       (-inf if all masked)
//   z[b]    = sum_v exp(s[b, v] - m[b])           (0 if all masked)
//   corr[b] = s[b, y[b]]                          (0 when y[b] == -1)
//   amax[b] = lowest v with s[b, v] == m[b]       (-1 if all masked)
// The [B, V] score matrix never reaches device memory.
//
// Bounds on an H100 SXM (1,020,250 x 512 shard): the fp32 product is
// 2 B V D operations, 66.9 GFLOP at B = 64 and 267.4 at B = 256. On CUDA
// cores (67 TFLOP/s) that is 1.00 / 3.99 ms; as 3xTF32 on the tensor cores
// (3 products at 494.7 TFLOP/s) 0.41 / 1.62 ms. Reading W is 2.09 GB,
// 0.62 ms at 3.35 TB/s. So the kernel is bound by W's bytes at B = 64
// (0.62 ms) and by its products at B = 256 (1.62 ms).
//
// Design. ce_hopper.cuh's score tile: classes on wgmma's M, 3xTF32 with
// W's hi and lo made in registers from the TMA-written fp32 slab, and f's
// hi and lo made once per call (split_rows, 2 x B x D x 4 bytes) and
// streamed by TMA as the B operands. A grid of (B tiles of 64) x (class
// segments), about one block an SM; the blocks of one segment's B tiles
// are neighbours in launch order, so each W tile is read from device
// memory about once and from L2 once a B tile. A block walks its segment
// in tiles of 128 classes, 32-deep slabs through a 4-stage mbarrier ring
// (W slab 16 KB, f hi and lo 8 KB each): each of the two consumer
// warpgroups scores 64 classes x 64 rows (wgmma m64n64k8, three a k8
// step) and folds them into running statistics of its 16 batch columns
// (two class rows a tile): m, z and amax in registers, corr written once
// to shared memory by the one thread that holds the label's score. The
// lanes and then the 8 warps of a column are merged in a fixed order, and
// a second launch combines the segments of a row: m = max m_s, z = sum
// z_s exp(m_s - m), corr = sum corr_s, and on equal maxima the lowest
// column, exactly as the TPU kernel's strict `tile_m > m_old` does.
// Per 128-class tile a block reads W 256 KB and f's halves 256 KB from L2.
// No atomics: two runs are bit-identical.
//
// Requires D % 4 == 0 (TMA's 16-byte row strides) and a 16-byte aligned W
// (checked by the wrapper); any B, V >= 1 and limit.

#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "ce_hopper.cuh"

namespace {

using namespace ce_hopper;   // and its ht = hopper

constexpr int BT = 64;                         // batch rows a block
constexpr int STAGES = 4;
constexpr int F_SLAB = ht::slab_bytes(BT);     // 64 rows x 32 fp32
constexpr int STAGE_BYTES = W_SLAB + 2 * F_SLAB;
constexpr int RED_OFF = STAGES * STAGE_BYTES;  // per-warp column stats
constexpr int CORR_OFF = RED_OFF + 3 * CONSUMER_WARPS * BT * 4;
constexpr int BAR_OFF = CORR_OFF + BT * 4;
constexpr int SMEM = 1024 + BAR_OFF + 8 * 2 * STAGES;

__global__ void __launch_bounds__(THREADS, 1)
ce_fwd_partial(const __grid_constant__ CUtensorMap tw,
               const __grid_constant__ CUtensorMap tfh,
               const __grid_constant__ CUtensorMap tfl,
               const int* __restrict__ y, int B, int D, int V, int limit,
               float scale, int seg_tiles, float* __restrict__ pm,
               float* __restrict__ pz, float* __restrict__ pc,
               int* __restrict__ pa) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((1024 - (ht::smem_u32(smem_raw) & 1023)) & 1023);
  float* red_m = reinterpret_cast<float*>(base + RED_OFF);   // [8][BT]
  float* red_z = red_m + CONSUMER_WARPS * BT;
  int* red_a = reinterpret_cast<int*>(red_z + CONSUMER_WARPS * BT);
  float* corr_s = reinterpret_cast<float*>(base + CORR_OFF); // [BT]
  uint64_t* full = reinterpret_cast<uint64_t*>(base + BAR_OFF);
  uint64_t* empty = full + STAGES;

  const int b0 = blockIdx.x * BT;
  const int seg = blockIdx.y;
  const int n_vtiles = (V + VT - 1) / VT;
  const int t_begin = seg * seg_tiles;
  const int t_end = min(n_vtiles, t_begin + seg_tiles);
  const int n_kc = (D + KC - 1) / KC;
  const int lim = min(limit, V);

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      ht::mbar_init(&full[s], 1);
      ht::mbar_init(&empty[s], CONSUMER_WARPS);
    }
    ht::mbar_init_fence();
  }
  if (threadIdx.x < BT) corr_s[threadIdx.x] = 0.f;
  __syncthreads();

  const int wg = threadIdx.x / WG_THREADS;
  if (wg == 0) {
    // -- producer: per tile, D in 32-deep slabs of W and of f's halves ----
    ht::regs_release<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      ht::tma_prefetch_desc(&tw);
      ht::tma_prefetch_desc(&tfh);
      ht::tma_prefetch_desc(&tfl);
      int it = 0;
      for (int tile = t_begin; tile < t_end; ++tile)
        for (int kc = 0; kc < n_kc; ++kc, ++it) {
          const int st = slot(it, STAGES);
          ht::mbar_wait(&empty[st], phase(it, STAGES) ^ 1);
          ht::mbar_expect_tx(&full[st], STAGE_BYTES);
          unsigned char* dst = base + st * STAGE_BYTES;
          ht::tma_load(dst, &tw, &full[st], kc * KC, tile * VT);
          ht::tma_load(dst + W_SLAB, &tfh, &full[st], kc * KC, b0);
          ht::tma_load(dst + W_SLAB + F_SLAB, &tfl, &full[st], kc * KC, b0);
        }
    }
    return;
  }

  // -- consumers: 64 classes of each tile x the block's 64 rows -----------
  ht::regs_claim<CONSUMER_REGS>();
  const int wc = wg - 1;
  const int warp = (threadIdx.x / 32) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wrow = wc * 64 + warp * 16 + g;      // slab row of acc[4i + 0]

  // column j of this lane: batch row b0 + 8 (j / 2) + 2t + j % 2, held in
  // acc[4 (j / 2) + j % 2] (class row wrow) and acc[... + 2] (wrow + 8)
  float cm[16], cz[16];
  int ca[16], cy[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int b = b0 + 8 * (j >> 1) + 2 * t + (j & 1);
    cy[j] = b < B ? y[b] : -1;
    cm[j] = -INFINITY;
    cz[j] = 0.f;
    ca[j] = -1;
  }

  int it = 0;
  for (int tile = t_begin; tile < t_end; ++tile) {
    float acc[BT / 2];
#pragma unroll
    for (int i = 0; i < BT / 2; ++i) acc[i] = 0.f;
    for (int kc = 0; kc < n_kc; ++kc, ++it) {
      const int st = slot(it, STAGES);
      ht::mbar_wait(&full[st], phase(it, STAGES));
      const unsigned char* src = base + st * STAGE_BYTES;
      score_slab<BT, 4>(acc, src, src + W_SLAB, src + W_SLAB + F_SLAB, wrow,
                        t);
      release(&empty[st], lane);
    }

    // fold the tile, class rows in ascending order within each column
    const int va = tile * VT + wrow, vb = va + 8;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int e = 4 * (j >> 1) + (j & 1);
      const float s0 = va < lim ? acc[e] * scale : -INFINITY;
      const float s1 = vb < lim ? acc[e + 2] * scale : -INFINITY;
      // the label's score, -inf when its column is masked (as on the TPU)
      if (cy[j] == va) corr_s[8 * (j >> 1) + 2 * t + (j & 1)] = s0;
      if (cy[j] == vb) corr_s[8 * (j >> 1) + 2 * t + (j & 1)] = s1;
      const float tm = fmaxf(s0, s1);
      if (tm > cm[j]) ca[j] = s1 > s0 ? vb : va;
      const float mn = fmaxf(cm[j], tm);
      if (mn != -INFINITY) {
        cz[j] = cz[j] * __expf(cm[j] - mn) + __expf(s0 - mn) +
                __expf(s1 - mn);
        cm[j] = mn;
      }
    }
  }

  // -- merge the 8 lanes of a column, then the 8 warps, in a fixed order --
#pragma unroll
  for (int j = 0; j < 16; ++j) {
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) {
      const float om = __shfl_xor_sync(0xffffffffu, cm[j], off);
      const float oz = __shfl_xor_sync(0xffffffffu, cz[j], off);
      const int oa = __shfl_xor_sync(0xffffffffu, ca[j], off);
      merge_stat(cm[j], cz[j], ca[j], om, oz, oa);
    }
    if (g == 0) {
      const int q = (wc * 4 + warp) * BT + 8 * (j >> 1) + 2 * t + (j & 1);
      red_m[q] = cm[j];
      red_z[q] = cz[j];
      red_a[q] = ca[j];
    }
  }
  consumers_sync();
  const int col = threadIdx.x - WG_THREADS;
  if (col < BT && b0 + col < B) {
    float M = -INFINITY, Z = 0.f;
    int A = -1;
    for (int q = 0; q < CONSUMER_WARPS; ++q)
      merge_stat(M, Z, A, red_m[q * BT + col], red_z[q * BT + col],
                 red_a[q * BT + col]);
    const size_t o = (size_t)seg * B + b0 + col;
    pm[o] = M;
    pz[o] = Z;
    pa[o] = A;
    pc[o] = corr_s[col];
  }
}

// One block per row: each thread folds a strided run of segments, then the
// block combines them (ties to the lower column keep the result exact).
__global__ void __launch_bounds__(256)
ce_fwd_combine(const float* __restrict__ pm, const float* __restrict__ pz,
               const float* __restrict__ pc, const int* __restrict__ pa,
               int B, int n_segs, float* __restrict__ m, float* __restrict__ z,
               float* __restrict__ corr, int* __restrict__ amax) {
  constexpr int NT = 256;
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

// fh, fl: [B, D] scratch for f's TF32 halves; pm, pz, pc, pa: [n_segs, B]
// partials. Returns a cudaError_t, or 10000 + a CUresult when a TMA
// descriptor cannot be encoded.
extern "C" int ce_fwd_launch(const void* f, const void* w, const void* y,
                             void* fh, void* fl, void* pm, void* pz,
                             void* pc, void* pa, void* m, void* z,
                             void* corr, void* amax, int B, int D, int V,
                             int limit, float scale, int seg_tiles,
                             int n_segs, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int n = B * D;
  ce_hopper::split_rows<<<(n + 255) / 256, 256, 0, st>>>(
      static_cast<const float*>(f), n, static_cast<float*>(fh),
      static_cast<float*>(fl));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  CUtensorMap tw, tfh, tfl;
  const uint64_t row = 4ull * D;
  int err = ht::tmap_f32(&tw, w, D, V, row, VT);
  if (!err) err = ht::tmap_f32(&tfh, fh, D, B, row, BT);
  if (!err) err = ht::tmap_f32(&tfl, fl, D, B, row, BT);
  if (err) return err;
  e = cudaFuncSetAttribute(ce_fwd_partial,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((B + BT - 1) / BT, n_segs);
  ce_fwd_partial<<<grid, THREADS, SMEM, st>>>(
      tw, tfh, tfl, static_cast<const int*>(y), B, D, V, limit, scale,
      seg_tiles, static_cast<float*>(pm), static_cast<float*>(pz),
      static_cast<float*>(pc), static_cast<int*>(pa));
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  ce_fwd_combine<<<B, 256, 0, st>>>(
      static_cast<const float*>(pm), static_cast<const float*>(pz),
      static_cast<const float*>(pc), static_cast<const int*>(pa), B, n_segs,
      static_cast<float*>(m), static_cast<float*>(z),
      static_cast<float*>(corr), static_cast<int*>(amax));
  return static_cast<int>(cudaGetLastError());
}
