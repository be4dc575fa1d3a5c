// Online-softmax statistics of f [B, D] over an active-class set gathered
// from a class shard W [V, D], on Hopper (sm_90a): 3xTF32 wgmma products,
// W's rows gathered by id with cp.async, f's halves fed by TMA.
//
// Replaces: src/repro/kernels/sparse_ce.py:140, sparse_ce_forward /
// _fwd_kernel / _gather_tile / _first_hit (the Pallas TPU kernel). Column j
// of the active set is row ids[j] of W, with global class id gids[j], a
// bias[j] and a mask valid[j]. Over the scores
// s[b, j] = scale * <f[b], W[ids[j]]> + bias[j], with
// hit[b, j] = valid[j] && gids[j] == y[b] (y global):
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
// Bounds on an H100 SXM at the knn training shapes (B = 256, A = 102,025 of
// V = 1,020,250, D = 512): the product is 2 B A D = 26.7 GFLOP, 0.162 ms as
// 3xTF32 on the tensor cores (three products at 494.7 TFLOP/s), 0.40 ms in
// fp32 FMA on CUDA cores (67 TFLOP/s); the gathered rows are 209 MB, 0.06
// ms at 3.35 TB/s. So it is bound by its products.
//
// Design. ce_softmax_fwd.cu's, on ce_hopper.cuh's score tile, with W's
// rows gathered: a grid of (B tiles of 64) x (active-column segments),
// about one block an SM, the blocks of one segment's B tiles neighbours in
// launch order, so each gathered row is read from device memory about
// once and from L2 once a B tile. A block walks its segment in tiles of
// 128 columns, 32-deep slabs through a 4-stage mbarrier ring: the producer
// warpgroup's 128 threads gather the slab's 128 rows of W by id with
// cp.async (ce_hopper.cuh says why not TMA), and with a tile's last slab
// its columns' gids, bias and valid; one producer thread loads f's halves
// by TMA. Each consumer warpgroup scores 64 columns x 64 rows (wgmma
// m64n64k8, three a k8 step), reads its two columns' side data from the
// tile's last stage, and folds the scores into running statistics of its
// 16 batch columns: m, z, amax and the first hit column with its score, in
// registers. A thread visits its columns in ascending order, so its first
// hit is its lowest; the lanes and then the 8 warps of a batch column are
// merged in a fixed order, keeping the lower column on equal maxima and
// the lowest hit, and a second launch combines the segments of a row the
// same way. The result does not depend on the grid's timing, and no
// atomics: two runs are bit-identical.
//
// Requires D % 4 == 0 (16-byte copies, TMA's row strides) and 16-byte
// aligned f and W (checked by the wrapper); the wrapper clips ids into
// [0, V).

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
constexpr int SIDE_OFF = STAGES * STAGE_BYTES;
constexpr int RED_OFF = SIDE_OFF + STAGES * SIDE_BYTES;  // per-warp stats
constexpr int TABLE_OFF = RED_OFF + 5 * CONSUMER_WARPS * BT * 4;
constexpr int BAR_OFF = TABLE_OFF + ROW_TABLE_BYTES;
constexpr int SMEM = 1024 + BAR_OFF + 8 * 2 * STAGES;
constexpr int NT = 256;                        // threads of the combine

// Keep the lower hit column (-1 = none) and its score.
__device__ __forceinline__ void merge_hit(int& h, float& hs, int h2,
                                          float hs2) {
  if (h2 >= 0 && (h < 0 || h2 < h)) { h = h2; hs = hs2; }
}

__global__ void __launch_bounds__(THREADS, 1)
sparse_fwd_partial(const __grid_constant__ CUtensorMap tfh,
                   const __grid_constant__ CUtensorMap tfl,
                   const float* __restrict__ w, const int* __restrict__ ids,
                   const int* __restrict__ gids,
                   const float* __restrict__ bias,
                   const int* __restrict__ valid, const int* __restrict__ y,
                   int B, int D, int A, float scale, int mask_hits,
                   int seg_tiles, float* __restrict__ pm,
                   float* __restrict__ pz, float* __restrict__ phs,
                   int* __restrict__ pa, int* __restrict__ ph) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((1024 - (ht::smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* side = base + SIDE_OFF;
  int* table = reinterpret_cast<int*>(base + TABLE_OFF);
  float* red_m = reinterpret_cast<float*>(base + RED_OFF);   // [8][BT]
  float* red_z = red_m + CONSUMER_WARPS * BT;
  float* red_hs = red_z + CONSUMER_WARPS * BT;
  int* red_a = reinterpret_cast<int*>(red_hs + CONSUMER_WARPS * BT);
  int* red_h = red_a + CONSUMER_WARPS * BT;
  uint64_t* full = reinterpret_cast<uint64_t*>(base + BAR_OFF);
  uint64_t* empty = full + STAGES;

  const int b0 = blockIdx.x * BT;
  const int seg = blockIdx.y;
  const int n_atiles = (A + VT - 1) / VT;
  const int t_begin = seg * seg_tiles;
  const int t_end = min(n_atiles, t_begin + seg_tiles);
  const int n_kc = (D + KC - 1) / KC;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      ht::mbar_init(&full[s], GATHER_ARRIVALS);
      ht::mbar_init(&empty[s], CONSUMER_WARPS);
    }
    ht::mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / WG_THREADS;
  if (wg == 0) {
    // -- producer: per tile, D in 32-deep slabs of gathered W and f's halves
    ht::regs_release<PRODUCER_REGS>();
    const int p = threadIdx.x;
    if (p == 0) {
      ht::tma_prefetch_desc(&tfh);
      ht::tma_prefetch_desc(&tfl);
    }
    int it = 0;
    for (int tile = t_begin; tile < t_end; ++tile) {
      int* rows = table + ((tile - t_begin) & 1) * VT;
      tile_rows(rows, ids, tile * VT, A, p);
      for (int kc = 0; kc < n_kc; ++kc, ++it) {
        const int st = slot(it, STAGES);
        ht::mbar_wait(&empty[st], phase(it, STAGES) ^ 1);
        unsigned char* dst = base + st * STAGE_BYTES;
        if (p == 0) {
          ht::mbar_expect_tx(&full[st], 2 * F_SLAB);
          ht::tma_load(dst + W_SLAB, &tfh, &full[st], kc * KC, b0);
          ht::tma_load(dst + W_SLAB + F_SLAB, &tfl, &full[st], kc * KC, b0);
        }
        gather_slab(dst, w, rows, kc * KC, D, p);
        if (kc == n_kc - 1)
          gather_side(side + st * SIDE_BYTES, gids, bias, valid, tile * VT,
                      A, p);
        ht::cp_async_arrive(&full[st]);
      }
    }
    ht::cp_async_wait_all();
    return;
  }

  // -- consumers: 64 columns of each tile x the block's 64 rows -----------
  ht::regs_claim<CONSUMER_REGS>();
  const int wc = wg - 1;
  const int warp = (threadIdx.x / 32) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wrow = wc * 64 + warp * 16 + g;      // slab row of acc[4i + 0]

  // batch column j of this lane: row b0 + 8 (j / 2) + 2t + j % 2, held in
  // acc[4 (j / 2) + j % 2] (tile column wrow) and acc[... + 2] (wrow + 8)
  float cm[16], cz[16], chs[16];
  int ca[16], ch[16], cy[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int b = b0 + 8 * (j >> 1) + 2 * t + (j & 1);
    cy[j] = b < B ? y[b] : -1;
    cm[j] = -INFINITY;
    cz[j] = 0.f;
    ca[j] = -1;
    ch[j] = -1;
    chs[j] = 0.f;
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
      if (kc < n_kc - 1) release(&empty[st], lane);
    }
    // the tile's side data came with its last slab, whose stage is kept
    const int last = slot(it - 1, STAGES);
    const Col c0 = col_at(side + last * SIDE_BYTES, wrow);
    const Col c1 = col_at(side + last * SIDE_BYTES, wrow + 8);
    release(&empty[last], lane);

    // fold the tile, columns in ascending order within each batch column
    const int ja = tile * VT + wrow, jb = ja + 8;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int e = 4 * (j >> 1) + (j & 1);
      float s0 = col_score(acc[e], scale, c0);
      float s1 = col_score(acc[e + 2], scale, c1);
      const bool h0 = c0.ok && c0.gid == cy[j];
      const bool h1 = c1.ok && c1.gid == cy[j];
      if (!mask_hits && ch[j] < 0 && (h0 || h1)) {
        ch[j] = h0 ? ja : jb;
        chs[j] = h0 ? s0 : s1;
      }
      if (!c0.ok || (mask_hits && h0)) s0 = -INFINITY;
      if (!c1.ok || (mask_hits && h1)) s1 = -INFINITY;
      const float tm = fmaxf(s0, s1);
      if (tm > cm[j]) ca[j] = s1 > s0 ? jb : ja;
      const float mn = fmaxf(cm[j], tm);
      if (mn != -INFINITY) {
        cz[j] = cz[j] * __expf(cm[j] - mn) + __expf(s0 - mn) +
                __expf(s1 - mn);
        cm[j] = mn;
      }
    }
  }

  // -- merge the 8 lanes of a batch column, then the 8 warps, in order ----
#pragma unroll
  for (int j = 0; j < 16; ++j) {
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) {
      const float om = __shfl_xor_sync(0xffffffffu, cm[j], off);
      const float oz = __shfl_xor_sync(0xffffffffu, cz[j], off);
      const int oa = __shfl_xor_sync(0xffffffffu, ca[j], off);
      const int oh = __shfl_xor_sync(0xffffffffu, ch[j], off);
      const float ohs = __shfl_xor_sync(0xffffffffu, chs[j], off);
      merge_stat(cm[j], cz[j], ca[j], om, oz, oa);
      merge_hit(ch[j], chs[j], oh, ohs);
    }
    if (g == 0) {
      const int q = (wc * 4 + warp) * BT + 8 * (j >> 1) + 2 * t + (j & 1);
      red_m[q] = cm[j];
      red_z[q] = cz[j];
      red_a[q] = ca[j];
      red_h[q] = ch[j];
      red_hs[q] = chs[j];
    }
  }
  consumers_sync();
  const int col = threadIdx.x - WG_THREADS;
  if (col < BT && b0 + col < B) {
    float M = -INFINITY, Z = 0.f, HS = 0.f;
    int Am = -1, H = -1;
    for (int q = 0; q < CONSUMER_WARPS; ++q) {
      merge_stat(M, Z, Am, red_m[q * BT + col], red_z[q * BT + col],
                 red_a[q * BT + col]);
      merge_hit(H, HS, red_h[q * BT + col], red_hs[q * BT + col]);
    }
    const size_t o = (size_t)seg * B + b0 + col;
    pm[o] = M;
    pz[o] = Z;
    pa[o] = Am;
    ph[o] = H;
    phs[o] = HS;
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

// fh, fl: [B, D] scratch for f's TF32 halves; pm, pz, phs, pa, ph:
// [n_segs, B] partials. Returns a cudaError_t, or 10000 + a CUresult when
// a TMA descriptor cannot be encoded.
extern "C" int sparse_ce_fwd_launch(
    const void* f, const void* w, const void* ids, const void* gids,
    const void* bias, const void* valid, const void* y, void* fh, void* fl,
    void* pm, void* pz, void* phs, void* pa, void* ph, void* m, void* z,
    void* corr, void* amax, void* hit, int B, int D, int A, float scale,
    int mask_hits, int seg_tiles, int n_segs, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int n = B * D;
  ce_hopper::split_rows<<<(n + 255) / 256, 256, 0, st>>>(
      static_cast<const float*>(f), n, static_cast<float*>(fh),
      static_cast<float*>(fl));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  CUtensorMap tfh, tfl;
  const uint64_t row = 4ull * D;
  int err = ht::tmap_f32(&tfh, fh, D, B, row, BT);
  if (!err) err = ht::tmap_f32(&tfl, fl, D, B, row, BT);
  if (err) return err;
  e = cudaFuncSetAttribute(sparse_fwd_partial,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((B + BT - 1) / BT, n_segs);
  sparse_fwd_partial<<<grid, THREADS, SMEM, st>>>(
      tfh, tfl, static_cast<const float*>(w), static_cast<const int*>(ids),
      static_cast<const int*>(gids), static_cast<const float*>(bias),
      static_cast<const int*>(valid), static_cast<const int*>(y), B, D, A,
      scale, mask_hits, seg_tiles, static_cast<float*>(pm),
      static_cast<float*>(pz), static_cast<float*>(phs),
      static_cast<int*>(pa), static_cast<int*>(ph));
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  sparse_fwd_combine<<<B, NT, 0, st>>>(
      static_cast<const float*>(pm), static_cast<const float*>(pz),
      static_cast<const float*>(phs), static_cast<const int*>(pa),
      static_cast<const int*>(ph), B, n_segs, static_cast<float*>(m),
      static_cast<float*>(z), static_cast<float*>(corr),
      static_cast<int*>(amax), static_cast<int*>(hit));
  return static_cast<int>(cudaGetLastError());
}
