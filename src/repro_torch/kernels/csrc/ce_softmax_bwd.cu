// Streaming backward of the fused softmax statistics, on Hopper (sm_90a):
// 3xTF32 wgmma products fed by TMA.
//
// Replaces: src/repro/kernels/ce_softmax.py:184, ce_backward / _bwd_kernel
// (the Pallas TPU kernel). Given f [B, D], a class shard W [V, D], the
// local labels y [B] (-1 = not on this shard), the forward's row max m [B]
// and the per-row cotangents gz, gc [B] of the forward's z and corr, it
// recomputes the scores s[b, v] = scale * <f[b], W[v]> and forms
//   p[b, v]  = exp(s[b, v] - m[b])   where v < limit and m[b] is finite, else 0
//   dl[b, v] = (p[b, v] * gz[b] + [v == y[b]] * gc[b]) * scale
// (the one-hot is not masked by limit, as on the TPU), then
//   dW[v, :] = sum_b dl[b, v] f[b, :]       df[b, :] = sum_v dl[b, v] W[v, :]
// The [B, V] matrix dl never reaches device memory.
//
// Bounds on an H100 SXM at the training shapes (B = 256, V = 1,020,250,
// D = 512): three products of 2 B V D (the scores, dW, df), 802 GFLOP;
// 11.98 ms on CUDA cores (67 TFLOP/s), 4.87 ms as 3xTF32 on the tensor
// cores (3 x 802 GFLOP at 494.7 TFLOP/s). Reading W and writing dW is
// 4.18 GB, 1.25 ms at 3.35 TB/s. So it is bound by its products.
//
// Why two kernels. A block that owns classes for every batch row writes
// its dW rows once, but its df partial is B x D fp32, 512 KB at B = 256:
// more than an SM's 227 KB of shared memory and 256 KB of registers, so it
// would be flushed to device memory every tile (the earlier design moved
// ~8.4 GB so, and read W and dW twice more). A block that owns 64 batch
// rows keeps its df partial (128 KB) in registers for its whole class
// segment, but then dW needs B / 64 partial sums per class (8 GB at
// B = 256). So the work is split, each kernel recomputing the scores with
// the same 3xTF32 score tile (ce_hopper.cuh) as the forward:
//   ce_bwd_dw<NB>: one block per class segment, walking it in tiles of 128
//     classes with all B rows (NB = 64 columns up to B = 64, else 256;
//     batches above 256 in chunks of 256, dW then added in place by its
//     owning thread).
//     Each consumer warpgroup scores its 64 classes x NB rows (wgmma
//     m64n64k8, 64 rows at a time), turns the scores into dl in place,
//     and takes dW = dl^T f with dl as the register A operand straight
//     from the accumulators (columns 2t, 2t + 1 of an 8-column tile are
//     depth t and t + 4) and f^T as the B operand: a [D, B] copy of f's
//     TF32 halves made once per call (split_cols, 2 x D x B x 4 bytes)
//     with each 8-row group of B permuted to match, streamed by TMA in
//     [64 d x 32 b] slabs through a second mbarrier ring. dW is written
//     once, 64 x 64 at a time, from registers; its sum over B stays in the
//     tensor cores' accumulator (96 additions at B = 256, ~1e-6 of the
//     result; ce_hopper.cuh says why longer sums are split).
//   ce_bwd_df: a grid of (B tiles of 64) x (class segments) x (D groups of
//     512) blocks. Per tile of 128 classes the same scores and dl; dl's
//     TF32 halves go to shared memory as [64 b x 128 v] (64 KB), and
//     df^T [d, b] += W^T dl^T takes W^T as the register A operand, loaded
//     transposed from the TMA-written W slabs (read again from L2) and
//     split in registers, and dl as the B operand. Each consumer
//     warpgroup keeps 4 of the 8 [64 d x 64 b] df^T blocks in registers
//     for the whole segment, each tile's share added by the CUDA cores
//     (left in the tensor cores' accumulator over a segment's ~30,000
//     additions, df failed its gate against the plain version several
//     times over), and writes them once; a last launch sums the segments'
//     partials for each element in segment order. Its k loop is not
//     unrolled: unrolled over the 8 feature blocks, the kernel's code held
//     384 wgmma and the backward ran markedly slower.
// What it costs beyond the 3-product bound: the scores are computed twice
// (a fourth product of 2 B V D; 6.49 ms at the 3xTF32 rate for all four)
// and W is read from device memory about twice (2.09 GB more, 0.62 ms);
// the df partials are n_segs x B x D x 4 bytes (17 MB at 33 segments),
// written once. Per 128-class tile ce_bwd_dw reads W 256 KB and f's halves
// and f^T's halves 1 MB each from L2 at B = 256; ce_bwd_df reads W twice
// (512 KB) and f's halves (256 KB) per B tile. These streams of f, the same
// for every tile, are the largest traffic of both kernels (PERF.md).
// No floating-point atomics and fixed orders of every sum: two runs are
// bit-identical.
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

// the row statistics of batch rows b0 .. b0 + n - 1 into shared memory;
// rows past B give dl = 0
__device__ __forceinline__ void load_rows(float* ms, float* gzs, float* gcs,
                                          int* ys, const float* m,
                                          const float* gz, const float* gc,
                                          const int* y, int b0, int n, int B,
                                          int i0, int step) {
  for (int i = i0; i < n; i += step) {
    const int b = b0 + i;
    const bool live = b < B;
    ms[i] = live ? m[b] : -INFINITY;
    gzs[i] = live ? gz[b] : 0.f;
    gcs[i] = live ? gc[b] : 0.f;
    ys[i] = live ? y[b] : -1;
  }
}

// ---------------------------------------------------------------------------
// dW: a block per class segment, every batch row
// ---------------------------------------------------------------------------

template <int NB>
struct DwLayout {
  static constexpr int S_STAGES = NB == 256 ? 2 : 3;   // W + f's halves
  static constexpr int F_SLAB = ht::slab_bytes(NB);
  static constexpr int S_BYTES = W_SLAB + 2 * F_SLAB;
  static constexpr int T_STAGES = 3;                   // f^T's halves
  static constexpr int FT_SLAB = ht::slab_bytes(64);   // 64 d x 32 b
  static constexpr int T_BYTES = 2 * FT_SLAB;
  static constexpr int T_OFF = S_STAGES * S_BYTES;
  static constexpr int ROWS_OFF = T_OFF + T_STAGES * T_BYTES;
  static constexpr int BAR_OFF = ROWS_OFF + 16 * NB;
  static constexpr int SMEM = 1024 + BAR_OFF + 8 * 2 * (S_STAGES + T_STAGES);
  // k8 steps a group of products (the scores' and dW's): the A halves of a
  // group stay live until its products are done (fewer beside NB = 256's
  // 128 accumulator registers)
  static constexpr int G = NB == 256 ? 2 : 4;
};

template <int NB>
__global__ void __launch_bounds__(THREADS, 1)
ce_bwd_dw(const __grid_constant__ CUtensorMap tw,
          const __grid_constant__ CUtensorMap tfh,
          const __grid_constant__ CUtensorMap tfl,
          const __grid_constant__ CUtensorMap tfth,
          const __grid_constant__ CUtensorMap tftl,
          const int* __restrict__ y, const float* __restrict__ m,
          const float* __restrict__ gz, const float* __restrict__ gc, int B,
          int D, int V, int limit, float scale, int seg_tiles,
          float* __restrict__ dw) {
  using L = DwLayout<NB>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((1024 - (ht::smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* tring = base + L::T_OFF;
  float* ms = reinterpret_cast<float*>(base + L::ROWS_OFF);
  float* gzs = ms + NB;
  float* gcs = gzs + NB;
  int* ys = reinterpret_cast<int*>(gcs + NB);
  uint64_t* full_s = reinterpret_cast<uint64_t*>(base + L::BAR_OFF);
  uint64_t* empty_s = full_s + L::S_STAGES;
  uint64_t* full_t = empty_s + L::S_STAGES;
  uint64_t* empty_t = full_t + L::T_STAGES;

  const int n_vtiles = (V + VT - 1) / VT;
  const int t_begin = blockIdx.x * seg_tiles;
  const int t_end = min(n_vtiles, t_begin + seg_tiles);
  const int n_kc = (D + KC - 1) / KC;
  const int n_dc = (D + 63) / 64;
  const int n_bc = (B + NB - 1) / NB;
  const int lim = min(limit, V);

  if (threadIdx.x == 0) {
    for (int s = 0; s < L::S_STAGES; ++s) {
      ht::mbar_init(&full_s[s], 1);
      ht::mbar_init(&empty_s[s], CONSUMER_WARPS);
    }
    for (int s = 0; s < L::T_STAGES; ++s) {
      ht::mbar_init(&full_t[s], 1);
      ht::mbar_init(&empty_t[s], CONSUMER_WARPS);
    }
    ht::mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / WG_THREADS;
  if (wg == 0) {
    // -- producer: per (tile, batch chunk) the score slabs, then f^T -------
    ht::regs_release<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      ht::tma_prefetch_desc(&tw);
      ht::tma_prefetch_desc(&tfh);
      ht::tma_prefetch_desc(&tfl);
      ht::tma_prefetch_desc(&tfth);
      ht::tma_prefetch_desc(&tftl);
      int its = 0, itt = 0;
      for (int tile = t_begin; tile < t_end; ++tile)
        for (int bc = 0; bc < n_bc; ++bc) {
          for (int kc = 0; kc < n_kc; ++kc, ++its) {
            const int st = slot(its, L::S_STAGES);
            ht::mbar_wait(&empty_s[st], phase(its, L::S_STAGES) ^ 1);
            ht::mbar_expect_tx(&full_s[st], L::S_BYTES);
            unsigned char* dst = base + st * L::S_BYTES;
            ht::tma_load(dst, &tw, &full_s[st], kc * KC, tile * VT);
            ht::tma_load(dst + W_SLAB, &tfh, &full_s[st], kc * KC, bc * NB);
            ht::tma_load(dst + W_SLAB + L::F_SLAB, &tfl, &full_s[st], kc * KC,
                         bc * NB);
          }
          for (int dc = 0; dc < n_dc; ++dc)
            for (int q = 0; q < NB / 32; ++q, ++itt) {
              const int st = slot(itt, L::T_STAGES);
              ht::mbar_wait(&empty_t[st], phase(itt, L::T_STAGES) ^ 1);
              ht::mbar_expect_tx(&full_t[st], L::T_BYTES);
              unsigned char* dst = tring + st * L::T_BYTES;
              ht::tma_load(dst, &tfth, &full_t[st], bc * NB + 32 * q, dc * 64);
              ht::tma_load(dst + L::FT_SLAB, &tftl, &full_t[st],
                           bc * NB + 32 * q, dc * 64);
            }
        }
    }
    return;
  }

  // -- consumers: 64 classes of each tile, all rows of a batch chunk -------
  ht::regs_claim<CONSUMER_REGS>();
  const int wc = wg - 1;
  const int warp = (threadIdx.x / 32) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wrow = wc * 64 + warp * 16 + g;

  int its = 0, itt = 0;
  for (int tile = t_begin; tile < t_end; ++tile)
    for (int bc = 0; bc < n_bc; ++bc) {
      consumers_sync();               // the previous chunk's rows are read
      load_rows(ms, gzs, gcs, ys, m, gz, gc, y, bc * NB, NB, B,
                threadIdx.x - WG_THREADS, CONSUMERS);
      consumers_sync();

      float acc[NB / 2];
#pragma unroll
      for (int i = 0; i < NB / 2; ++i) acc[i] = 0.f;
      for (int kc = 0; kc < n_kc; ++kc, ++its) {
        const int st = slot(its, L::S_STAGES);
        ht::mbar_wait(&full_s[st], phase(its, L::S_STAGES));
        const unsigned char* src = base + st * L::S_BYTES;
        score_slab<NB, L::G>(acc, src, src + W_SLAB, src + W_SLAB + L::F_SLAB,
                             wrow, t);
        release(&empty_s[st], lane);
      }

      // dl in place: acc[4i + e] is class wrow + 8 (e / 2), row 8i + 2t + e % 2
      const int va = tile * VT + wrow;
#pragma unroll
      for (int i = 0; i < NB / 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int bl = 8 * i + 2 * t + (e & 1);
          acc[4 * i + e] = dl_of(acc[4 * i + e], va + 8 * (e >> 1), lim,
                                 ms[bl], gzs[bl], gcs[bl], ys[bl], scale);
        }

      // dW[v, d] (+)= sum_b dl[v, b] f^T[d, b], 64 d at a time
      for (int dc = 0; dc < n_dc; ++dc) {
        float acc2[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) acc2[i] = 0.f;
#pragma unroll
        for (int q = 0; q < NB / 32; ++q, ++itt) {
          const int st = slot(itt, L::T_STAGES);
          ht::mbar_wait(&full_t[st], phase(itt, L::T_STAGES));
          const uint64_t dth = ht::desc_k(tring + st * L::T_BYTES, 0);
          const uint64_t dtl = desc_at(dth, L::FT_SLAB);
#pragma unroll
          for (int k0 = 0; k0 < 4; k0 += L::G) {
            uint32_t hi[L::G][4], lo[L::G][4];
#pragma unroll
            for (int kk = 0; kk < L::G; ++kk) {
              const int k = 4 * q + k0 + kk;        // 8-row group of the chunk
              ht::split_tf32(acc[4 * k + 0], hi[kk][0], lo[kk][0]);
              ht::split_tf32(acc[4 * k + 2], hi[kk][1], lo[kk][1]);
              ht::split_tf32(acc[4 * k + 1], hi[kk][2], lo[kk][2]);
              ht::split_tf32(acc[4 * k + 3], hi[kk][3], lo[kk][3]);
            }
            ht::fence_regs(acc2);
            ht::wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < L::G; ++kk)
              mma3(acc2, hi[kk], lo[kk], desc_at(dth, 32 * (k0 + kk)),
                   desc_at(dtl, 32 * (k0 + kk)));
            ht::wgmma_commit();
            ht::wgmma_wait<0>();
            ht::fence_regs(acc2);
            ht::fence_regs(hi);
            ht::fence_regs(lo);
          }
          release(&empty_t[st], lane);
        }
        // acc2[4i + 2h + c] is class wrow + 8h, feature 64 dc + 8i + 2t + c
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int v = va + 8 * h, d = dc * 64 + 8 * i + 2 * t;
            if (v < V && d < D) {
              float2* o = reinterpret_cast<float2*>(dw + (size_t)v * D + d);
              float2 val = make_float2(acc2[4 * i + 2 * h],
                                       acc2[4 * i + 2 * h + 1]);
              if (bc > 0) {
                const float2 old = *o;
                val.x += old.x;
                val.y += old.y;
              }
              *o = val;
            }
          }
      }
    }
}

// ---------------------------------------------------------------------------
// df: a block per (64 batch rows, class segment, 512 features)
// ---------------------------------------------------------------------------

constexpr int DF_DG = 512;                       // features a block
constexpr int DF_STAGES = 4;
constexpr int DF_F_SLAB = ht::slab_bytes(DF_BT);
constexpr int DF_STAGE = W_SLAB + 2 * DF_F_SLAB; // = two W slabs
static_assert(DF_STAGE == 2 * W_SLAB, "score and df stages share the ring");
constexpr int DL_OFF = DF_STAGES * DF_STAGE;     // dl hi: 4 slabs, lo: 4
constexpr int DF_ROWS_OFF = DL_OFF + 8 * DL_SLAB;
constexpr int DF_BAR_OFF = DF_ROWS_OFF + 16 * DF_BT;
constexpr int DF_SMEM = 1024 + DF_BAR_OFF + 8 * 2 * DF_STAGES;

__global__ void __launch_bounds__(THREADS, 1)
ce_bwd_df(const __grid_constant__ CUtensorMap tw,
          const __grid_constant__ CUtensorMap tfh,
          const __grid_constant__ CUtensorMap tfl,
          const int* __restrict__ y, const float* __restrict__ m,
          const float* __restrict__ gz, const float* __restrict__ gc, int B,
          int D, int V, int limit, float scale, int seg_tiles,
          float* __restrict__ pdf) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((1024 - (ht::smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* dlh = base + DL_OFF;
  unsigned char* dll = dlh + 4 * DL_SLAB;
  float* ms = reinterpret_cast<float*>(base + DF_ROWS_OFF);
  float* gzs = ms + DF_BT;
  float* gcs = gzs + DF_BT;
  int* ys = reinterpret_cast<int*>(gcs + DF_BT);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + DF_BAR_OFF);
  uint64_t* empty = full + DF_STAGES;

  const int b0 = blockIdx.x * DF_BT;
  const int seg = blockIdx.y;
  const int d0 = blockIdx.z * DF_DG;
  const int n_vtiles = (V + VT - 1) / VT;
  const int t_begin = seg * seg_tiles;
  const int t_end = min(n_vtiles, t_begin + seg_tiles);
  const int n_kc = (D + KC - 1) / KC;
  const int n_db = min(8, (D - d0 + 63) / 64);   // 64-feature blocks here
  const int lim = min(limit, V);

  if (threadIdx.x == 0) {
    for (int s = 0; s < DF_STAGES; ++s) {
      ht::mbar_init(&full[s], 1);
      ht::mbar_init(&empty[s], CONSUMER_WARPS);
    }
    ht::mbar_init_fence();
  }
  load_rows(ms, gzs, gcs, ys, m, gz, gc, y, b0, DF_BT, B, threadIdx.x,
            THREADS);
  __syncthreads();

  const int wg = threadIdx.x / WG_THREADS;
  if (wg == 0) {
    // -- producer: per tile the score slabs, then W again by 64 features ---
    ht::regs_release<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      ht::tma_prefetch_desc(&tw);
      ht::tma_prefetch_desc(&tfh);
      ht::tma_prefetch_desc(&tfl);
      int it = 0;
      for (int tile = t_begin; tile < t_end; ++tile) {
        for (int kc = 0; kc < n_kc; ++kc, ++it) {
          const int st = slot(it, DF_STAGES);
          ht::mbar_wait(&empty[st], phase(it, DF_STAGES) ^ 1);
          ht::mbar_expect_tx(&full[st], DF_STAGE);
          unsigned char* dst = base + st * DF_STAGE;
          ht::tma_load(dst, &tw, &full[st], kc * KC, tile * VT);
          ht::tma_load(dst + W_SLAB, &tfh, &full[st], kc * KC, b0);
          ht::tma_load(dst + W_SLAB + DF_F_SLAB, &tfl, &full[st], kc * KC, b0);
        }
        for (int j = 0; j < n_db; ++j, ++it) {
          const int st = slot(it, DF_STAGES);
          ht::mbar_wait(&empty[st], phase(it, DF_STAGES) ^ 1);
          ht::mbar_expect_tx(&full[st], DF_STAGE);
          unsigned char* dst = base + st * DF_STAGE;
          ht::tma_load(dst, &tw, &full[st], d0 + 64 * j, tile * VT);
          ht::tma_load(dst + W_SLAB, &tw, &full[st], d0 + 64 * j + 32,
                       tile * VT);
        }
      }
    }
    return;
  }

  // -- consumers: scores and dl of 64 classes; df^T blocks j = wc, wc + 2, ..
  ht::regs_claim<CONSUMER_REGS>();
  const int wc = wg - 1;
  const int warp = (threadIdx.x / 32) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wrow = wc * 64 + warp * 16 + g;

  const uint64_t ddh = ht::desc_k(dlh, 0), ddl = ht::desc_k(dll, 0);
  // df_block's A fragment a[r] of class row 8k + t (+ 4 for r >= 2) and
  // feature 16 warp + g (+ 8 for r odd) of a stage's two W slabs, at k = 0:
  // class row 8k lies 1024 k bytes further, with the same swizzle
  int aoff[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int d = warp * 16 + g + (r & 1) * 8;
    aoff[r] = (d >> 5) * W_SLAB + swz(t + (r >> 1) * 4, d & 31);
  }
  float dft[4][32];                  // df^T block 2jj + wc: [64 d x 64 b]
#pragma unroll
  for (int jj = 0; jj < 4; ++jj)
#pragma unroll
    for (int i = 0; i < 32; ++i) dft[jj][i] = 0.f;

  int it = 0;
  for (int tile = t_begin; tile < t_end; ++tile) {
    float acc[DF_BT / 2];
#pragma unroll
    for (int i = 0; i < DF_BT / 2; ++i) acc[i] = 0.f;
    for (int kc = 0; kc < n_kc; ++kc, ++it) {
      const int st = slot(it, DF_STAGES);
      ht::mbar_wait(&full[st], phase(it, DF_STAGES));
      const unsigned char* src = base + st * DF_STAGE;
      score_slab<DF_BT>(acc, src, src + W_SLAB, src + W_SLAB + DF_F_SLAB,
                        wrow, t);
      release(&empty[st], lane);
    }

    // dl's TF32 halves to shared memory as [b][v]: slab v / 32, row b
    consumers_sync();             // the previous tile's df products are done
    const int va = tile * VT + wrow;
#pragma unroll
    for (int i = 0; i < DF_BT / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int bl = 8 * i + 2 * t + (e & 1), vl = wrow + 8 * (e >> 1);
        uint32_t h, l;
        ht::split_tf32(dl_of(acc[4 * i + e], va + 8 * (e >> 1), lim, ms[bl],
                             gzs[bl], gcs[bl], ys[bl], scale), h, l);
        const int off = (vl >> 5) * DL_SLAB + swz(bl, vl & 31);
        *reinterpret_cast<uint32_t*>(dlh + off) = h;
        *reinterpret_cast<uint32_t*>(dll + off) = l;
      }
    ht::fence_proxy_async();      // the stores, to the wgmma operand reads
    consumers_sync();

    // df^T[d, b] += sum_v W^T[d, v] dl[b, v]: stage j holds W[tile][64 j ..],
    // for warpgroup j % 2's block j / 2
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll 1
      for (int par = 0; par < 2; ++par) {
        if (2 * jj + par >= n_db) break;
        const int st = slot(it, DF_STAGES);
        ht::mbar_wait(&full[st], phase(it, DF_STAGES));
        if (par == wc)
          df_block(dft[jj], base + st * DF_STAGE, ddh, ddl, aoff);
        release(&empty[st], lane);
        ++it;
      }
  }

  // -- this segment's df partial, written once: dft[jj][4i + e] is feature
  // d0 + 64 (2jj + wc) + 16 warp + g + 8 (e / 2), row b0 + 8i + 2t + e % 2
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) {
    const int j = 2 * jj + wc;
    if (j >= n_db) continue;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = d0 + 64 * j + warp * 16 + g + 8 * (e >> 1);
        const int b = b0 + 8 * i + 2 * t + (e & 1);
        if (b < B && d < D)
          pdf[((size_t)seg * B + b) * D + d] = dft[jj][4 * i + e];
      }
  }
}

template <int NB>
int launch_dw(const CUtensorMap& tw, const void* fh, const void* fl,
              const CUtensorMap& tfth, const CUtensorMap& tftl, const void* y,
              const void* m, const void* gz, const void* gc, void* dw, int B,
              int D, int V, int limit, float scale, int seg_tiles,
              int n_segs, cudaStream_t st) {
  using L = DwLayout<NB>;
  CUtensorMap tfh, tfl;
  const uint64_t row = 4ull * D;
  int err = ht::tmap_f32(&tfh, fh, D, B, row, NB);
  if (!err) err = ht::tmap_f32(&tfl, fl, D, B, row, NB);
  if (err) return err;
  cudaError_t e = cudaFuncSetAttribute(
      ce_bwd_dw<NB>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  ce_bwd_dw<NB><<<n_segs, THREADS, L::SMEM, st>>>(
      tw, tfh, tfl, tfth, tftl, static_cast<const int*>(y),
      static_cast<const float*>(m), static_cast<const float*>(gz),
      static_cast<const float*>(gc), B, D, V, limit, scale, seg_tiles,
      static_cast<float*>(dw));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// fh, fl: [B, D] and fth, ftl: [D, Bp] scratch for f's TF32 halves (Bp =
// B rounded up to 8); pdf: [n_segs_df, B, D] partials. Returns a
// cudaError_t, or 10000 + a CUresult when a TMA descriptor cannot be
// encoded.
extern "C" int ce_bwd_launch(const void* f, const void* w, const void* y,
                             const void* m, const void* gz, const void* gc,
                             void* fh, void* fl, void* fth, void* ftl,
                             void* dw, void* pdf, void* df, int B, int D,
                             int V, int limit, float scale, int Bp,
                             int seg_tiles_dw, int n_segs_dw,
                             int seg_tiles_df, int n_segs_df, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int n = B * D;
  ce_hopper::split_rows<<<(n + 255) / 256, 256, 0, st>>>(
      static_cast<const float*>(f), n, static_cast<float*>(fh),
      static_cast<float*>(fl));
  ce_hopper::split_cols<<<(D * Bp + 255) / 256, 256, 0, st>>>(
      static_cast<const float*>(f), B, D, Bp, static_cast<float*>(fth),
      static_cast<float*>(ftl));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);

  CUtensorMap tw, tfth, tftl, tfh, tfl;
  const uint64_t row = 4ull * D;
  int err = ht::tmap_f32(&tw, w, D, V, row, VT);
  if (!err) err = ht::tmap_f32(&tfth, fth, Bp, D, 4ull * Bp, 64);
  if (!err) err = ht::tmap_f32(&tftl, ftl, Bp, D, 4ull * Bp, 64);
  if (!err) err = ht::tmap_f32(&tfh, fh, D, B, row, DF_BT);
  if (!err) err = ht::tmap_f32(&tfl, fl, D, B, row, DF_BT);
  if (err) return err;

  if (B <= 64)
    err = launch_dw<64>(tw, fh, fl, tfth, tftl, y, m, gz, gc, dw, B, D, V,
                        limit, scale, seg_tiles_dw, n_segs_dw, st);
  else
    err = launch_dw<256>(tw, fh, fl, tfth, tftl, y, m, gz, gc, dw, B, D, V,
                         limit, scale, seg_tiles_dw, n_segs_dw, st);
  if (err) return err;

  e = cudaFuncSetAttribute(ce_bwd_df,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           DF_SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((B + DF_BT - 1) / DF_BT, n_segs_df, (D + DF_DG - 1) / DF_DG);
  ce_bwd_df<<<grid, THREADS, DF_SMEM, st>>>(
      tw, tfh, tfl, static_cast<const int*>(y), static_cast<const float*>(m),
      static_cast<const float*>(gz), static_cast<const float*>(gc), B, D, V,
      limit, scale, seg_tiles_df, static_cast<float*>(pdf));
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  ce_hopper::sum_segments<<<(n + 255) / 256, 256, 0, st>>>(
      static_cast<const float*>(pdf), n, n_segs_df, static_cast<float*>(df));
  return static_cast<int>(cudaGetLastError());
}
