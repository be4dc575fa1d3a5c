// Backward of the active-class softmax statistics, on Hopper (sm_90a):
// 3xTF32 wgmma products, W's rows gathered by id with cp.async, f's halves
// fed by TMA; deterministic.
//
// Replaces: src/repro/kernels/sparse_ce.py:232, sparse_ce_backward /
// _bwd_kernel (the Pallas TPU kernel), and the scatter-add of its compact
// dW into the class shard that src/repro/kernels/ops.py (_sparse_ce_bwd)
// does after it. With the columns of sparse_ce_fwd.cu (row ids[j] of W,
// gids[j], bias[j], valid[j]), the forward's row max m [B], its first-hit
// column h [B] (-1 = none) and the cotangents gz, gc [B] of z and corr, it
// recomputes s[b, j] = scale * <f[b], W[ids[j]]> + bias[j] and forms
//   p[b, j]  = exp(s[b, j] - m[b])  where kept (as in the forward) and m[b]
//              is finite, else 0
//   dl[b, j] = (p[b, j] * gz[b] + [j == h[b]] * gc[b]) * scale
//   dW_act[j, :] = sum_b dl[b, j] f[b, :]   df[b, :] = sum_j dl[b, j] W[ids[j], :]
// and then dW[v, :] = sum of dW_act[j, :] over the j with ids[j] == v: ids
// repeat where random fillers collide, and those rows must add up.
//
// Bounds on an H100 SXM at the knn training shapes (B = 256, A = 102,025 of
// V = 1,020,250, D = 512): three products of 2 B A D (the scores, dW_act,
// df), 80.2 GFLOP, take 0.486 ms as 3xTF32 on the tensor cores (3 x 80.2
// GFLOP at 494.7 TFLOP/s) and 1.20 ms in fp32 FMA on CUDA cores. Its bytes
// are the gathered rows (209 MB), f and df, and the dense [V, D] dW that
// the wrapper zero-fills and this kernel's scatter writes into (2.09 GB):
// 2.30 GB, 0.687 ms at 3.35 TB/s. So it is bound by its bytes, most of them
// the dense dW, which is the JAX package's semantics.
//
// Design: ce_softmax_bwd.cu's two kernels on ce_hopper.cuh's score tile,
// with W's slabs gathered by id by the producer warpgroup (cp.async, each
// 16-byte chunk at its swizzled place; ce_hopper.cuh says why not TMA)
// and each tile's gids, bias and valid copied beside its last score slab.
// The reason for two kernels is the same: a block that owns columns for
// every batch row writes its dW_act rows once, but its df partial (B x D,
// 512 KB at B = 256) fits neither shared memory nor registers; a block
// that owns 64 batch rows keeps its df partial in registers but would
// need B / 64 partials of dW_act. The alternative, the earlier design's
// one kernel flushing df partials per segment, does three products but
// moves its [n_segs, B, D] partials through device memory every tile. So:
//   sparse_bwd_dw<NB>: one block per column segment, every batch row (NB =
//     64 up to B = 64, else 128: batches above 128 in chunks of 128, a
//     tile's chunks one after the other, dW_act added in place by its
//     owning thread while the tile's rows are still in L2; at NB = 256, as
//     the dense kernel takes it, the 224 registers that the consumers keep
//     beside the gathering producer spilled). dl is made in place from the
//     score accumulators and is the register A operand of dW_act = dl^T f,
//     with f^T's halves (split_cols) streamed by TMA as the B operand.
//   sparse_bwd_df: a grid of (B tiles of 64) x (column segments) x (D
//     groups of 512). Per tile the same scores and dl; dl's halves go to
//     shared memory, and df^T += W^T dl^T takes W^T as a transposed
//     register load from two more gathered slabs of the tile's rows (64
//     features) per feature block, df^T held in registers for the whole
//     segment and written once.
// Then small launches: the df partials summed in segment order; and the
// scatter of dW_act into dW. The wrapper sorts the ids stably, with the
// invalid columns' ids replaced by INT_MAX (their dl is 0, so their dW_act
// rows are +-0 and add nothing: they sort last and are skipped). A run of
// equal ids can be long (the selective head pads its active set with
// invalid columns of id 0; a log-uniform draw repeats id 0 some 5,000
// times), so it is summed in two levels: the sorted positions in chunks of
// SCATTER_CHUNK, each chunk's piece of a run summed in order; a run that
// lies inside one chunk is written to dW at once, and the pieces of a run
// that crosses a chunk's end are summed in order by a second launch.
// What it costs beyond the bound: a fourth product (the scores twice;
// 0.648 ms at the 3xTF32 rate for all four), the gathered rows read about
// three times from device memory (dW_act, the df scores, W^T), dW_act
// written and read once (209 MB each), and the sort.
// No floating-point atomics and fixed orders of every sum: the same inputs
// give the same bits on every run.
//
// Requires D % 4 == 0 (16-byte copies, TMA's row strides) and 16-byte
// aligned f and W (checked by the wrapper); the wrapper clips ids into
// [0, V) and zero-fills dW.

#include <cuda.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "ce_hopper.cuh"

namespace {

using namespace ce_hopper;   // and its ht = hopper

constexpr int NT = 256;      // threads of the combine and the scatter
// the dW kernel's producer gathers W's slabs on all its threads and
// streams f^T on one: 40 registers spill it, so it keeps 56 and the
// consumers claim 224
constexpr int DW_PRODUCER_REGS = 56;
constexpr int DW_CONSUMER_REGS = consumer_regs(DW_PRODUCER_REGS);
static_assert(DW_CONSUMER_REGS == 224, "the consumers' claim fits the block");

// the row statistics of batch rows b0 .. b0 + n - 1 into shared memory, as
// sparse_dl takes them: m = +inf where it is not finite, y = INT_MIN
// without mask_hits; rows past B give dl = 0
__device__ __forceinline__ void load_rows(float* ms, float* gzs, float* gcs,
                                          int* ys, int* hs, const float* m,
                                          const float* gz, const float* gc,
                                          const int* y, const int* hit,
                                          int mask_hits, int b0, int n, int B,
                                          int i0, int step) {
  for (int i = i0; i < n; i += step) {
    const int b = b0 + i;
    const bool live = b < B;
    const float mb = live ? m[b] : INFINITY;
    ms[i] = isfinite(mb) ? mb : INFINITY;
    gzs[i] = live ? gz[b] : 0.f;
    gcs[i] = live ? gc[b] : 0.f;
    ys[i] = live && mask_hits ? y[b] : INT_MIN;
    hs[i] = live ? hit[b] : -1;
  }
}

// ---------------------------------------------------------------------------
// dW_act: a block per column segment, every batch row
// ---------------------------------------------------------------------------

template <int NB>
struct DwLayout {
  static constexpr int S_STAGES = 3;                   // W + f's halves
  static constexpr int F_SLAB = ht::slab_bytes(NB);
  static constexpr int S_BYTES = W_SLAB + 2 * F_SLAB;
  static constexpr int T_STAGES = 3;                   // f^T's halves
  static constexpr int FT_SLAB = ht::slab_bytes(64);   // 64 d x 32 b
  static constexpr int T_BYTES = 2 * FT_SLAB;
  static constexpr int T_OFF = S_STAGES * S_BYTES;
  static constexpr int SIDE_OFF = T_OFF + T_STAGES * T_BYTES;
  static constexpr int ROWS_OFF = SIDE_OFF + S_STAGES * SIDE_BYTES;
  static constexpr int TABLE_OFF = ROWS_OFF + 20 * NB;
  static constexpr int BAR_OFF = TABLE_OFF + ROW_TABLE_BYTES;
  static constexpr int SMEM = 1024 + BAR_OFF + 8 * 2 * (S_STAGES + T_STAGES);
  static constexpr int G = 4;    // k8 steps a group of products: a slab
};

template <int NB>
__global__ void __launch_bounds__(THREADS, 1)
sparse_bwd_dw(const __grid_constant__ CUtensorMap tfh,
              const __grid_constant__ CUtensorMap tfl,
              const __grid_constant__ CUtensorMap tfth,
              const __grid_constant__ CUtensorMap tftl,
              const float* __restrict__ w, const int* __restrict__ ids,
              const int* __restrict__ gids, const float* __restrict__ bias,
              const int* __restrict__ valid, const int* __restrict__ y,
              const float* __restrict__ m, const float* __restrict__ gz,
              const float* __restrict__ gc, const int* __restrict__ hit,
              int B, int D, int A, float scale, int mask_hits, int seg_tiles,
              float* __restrict__ dwa) {
  using L = DwLayout<NB>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((1024 - (ht::smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* tring = base + L::T_OFF;
  unsigned char* side = base + L::SIDE_OFF;
  int* table = reinterpret_cast<int*>(base + L::TABLE_OFF);
  float* ms = reinterpret_cast<float*>(base + L::ROWS_OFF);
  float* gzs = ms + NB;
  float* gcs = gzs + NB;
  int* ys = reinterpret_cast<int*>(gcs + NB);
  int* hs = ys + NB;
  uint64_t* full_s = reinterpret_cast<uint64_t*>(base + L::BAR_OFF);
  uint64_t* empty_s = full_s + L::S_STAGES;
  uint64_t* full_t = empty_s + L::S_STAGES;
  uint64_t* empty_t = full_t + L::T_STAGES;

  const int n_atiles = (A + VT - 1) / VT;
  const int t_begin = blockIdx.x * seg_tiles;
  const int t_end = min(n_atiles, t_begin + seg_tiles);
  const int n_kc = (D + KC - 1) / KC;
  const int n_dc = (D + 63) / 64;
  const int n_bc = (B + NB - 1) / NB;

  if (threadIdx.x == 0) {
    for (int s = 0; s < L::S_STAGES; ++s) {
      ht::mbar_init(&full_s[s], GATHER_ARRIVALS);
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
    // -- producer: per (tile, batch chunk) the score slabs, gathered by all
    // 128 threads, then f^T by thread 0
    ht::regs_release<DW_PRODUCER_REGS>();
    const int p = threadIdx.x;
    if (p == 0) {
      ht::tma_prefetch_desc(&tfh);
      ht::tma_prefetch_desc(&tfl);
      ht::tma_prefetch_desc(&tfth);
      ht::tma_prefetch_desc(&tftl);
    }
    int its = 0, itt = 0;
    for (int tile = t_begin; tile < t_end; ++tile) {
      int* rows = table + ((tile - t_begin) & 1) * VT;
      tile_rows(rows, ids, tile * VT, A, p);
      for (int bc = 0; bc < n_bc; ++bc) {
        for (int kc = 0; kc < n_kc; ++kc, ++its) {
          const int st = slot(its, L::S_STAGES);
          ht::mbar_wait(&empty_s[st], phase(its, L::S_STAGES) ^ 1);
          unsigned char* dst = base + st * L::S_BYTES;
          if (p == 0) {
            ht::mbar_expect_tx(&full_s[st], 2 * L::F_SLAB);
            ht::tma_load(dst + W_SLAB, &tfh, &full_s[st], kc * KC, bc * NB);
            ht::tma_load(dst + W_SLAB + L::F_SLAB, &tfl, &full_s[st],
                         kc * KC, bc * NB);
          }
          gather_slab(dst, w, rows, kc * KC, D, p);
          if (kc == n_kc - 1)
            gather_side(side + st * SIDE_BYTES, gids, bias, valid, tile * VT,
                        A, p);
          ht::cp_async_arrive(&full_s[st]);
        }
        if (p == 0)            // f^T: 64 features x 32 batch rows a stage
          for (int u = 0; u < n_dc * (NB / 32); ++u, ++itt) {
            const int st = slot(itt, L::T_STAGES);
            const int b = bc * NB + 32 * (u % (NB / 32));
            const int d = 64 * (u / (NB / 32));
            ht::mbar_wait(&empty_t[st], phase(itt, L::T_STAGES) ^ 1);
            ht::mbar_expect_tx(&full_t[st], L::T_BYTES);
            unsigned char* dst = tring + st * L::T_BYTES;
            ht::tma_load(dst, &tfth, &full_t[st], b, d);
            ht::tma_load(dst + L::FT_SLAB, &tftl, &full_t[st], b, d);
          }
      }
    }
    ht::cp_async_wait_all();
    return;
  }

  // -- consumers: 64 columns of each tile, all rows of a batch chunk -------
  ht::regs_claim<DW_CONSUMER_REGS>();
  const int wc = wg - 1;
  const int warp = (threadIdx.x / 32) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wrow = wc * 64 + warp * 16 + g;

  int its = 0, itt = 0;
  for (int tile = t_begin; tile < t_end; ++tile)
    for (int bc = 0; bc < n_bc; ++bc) {
      consumers_sync();               // the previous chunk's rows are read
      load_rows(ms, gzs, gcs, ys, hs, m, gz, gc, y, hit, mask_hits, bc * NB,
                NB, B, threadIdx.x - WG_THREADS, CONSUMERS);
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
        if (kc < n_kc - 1) release(&empty_s[st], lane);
      }
      // the tile's side data came with its last slab, whose stage is kept
      const int last = slot(its - 1, L::S_STAGES);
      const Col c[2] = {col_at(side + last * SIDE_BYTES, wrow),
                        col_at(side + last * SIDE_BYTES, wrow + 8)};
      release(&empty_s[last], lane);

      // dl in place: acc[4i + e] is column ja + 8 (e / 2), row 8i + 2t + e % 2
      const int ja = tile * VT + wrow;
#pragma unroll
      for (int i = 0; i < NB / 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int bl = 8 * i + 2 * t + (e & 1);
          acc[4 * i + e] = sparse_dl(acc[4 * i + e], ja + 8 * (e >> 1),
                                     c[e >> 1], ms[bl], gzs[bl], gcs[bl],
                                     ys[bl], hs[bl], scale);
        }

      // dW_act[j, d] (+)= sum_b dl[j, b] f^T[d, b], 64 d at a time
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
        // acc2[4i + 2h + c] is column ja + 8h, feature 64 dc + 8i + 2t + c
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int j = ja + 8 * h, d = dc * 64 + 8 * i + 2 * t;
            if (j < A && d < D) {
              float2* o = reinterpret_cast<float2*>(dwa + (size_t)j * D + d);
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
// df: a block per (64 batch rows, column segment, 512 features)
// ---------------------------------------------------------------------------

constexpr int DF_DG = 512;                       // features a block
constexpr int DF_STAGES = 4;
constexpr int DF_F_SLAB = ht::slab_bytes(DF_BT);
constexpr int DF_STAGE = W_SLAB + 2 * DF_F_SLAB; // = two W slabs
static_assert(DF_STAGE == 2 * W_SLAB, "score and df stages share the ring");
constexpr int DL_OFF = DF_STAGES * DF_STAGE;     // dl hi: 4 slabs, lo: 4
constexpr int DF_SIDE_OFF = DL_OFF + 8 * DL_SLAB;
constexpr int DF_ROWS_OFF = DF_SIDE_OFF + DF_STAGES * SIDE_BYTES;
constexpr int DF_TABLE_OFF = DF_ROWS_OFF + 20 * DF_BT;
constexpr int DF_BAR_OFF = DF_TABLE_OFF + ROW_TABLE_BYTES;
constexpr int DF_SMEM = 1024 + DF_BAR_OFF + 8 * 2 * DF_STAGES;

__global__ void __launch_bounds__(THREADS, 1)
sparse_bwd_df(const __grid_constant__ CUtensorMap tfh,
              const __grid_constant__ CUtensorMap tfl,
              const float* __restrict__ w, const int* __restrict__ ids,
              const int* __restrict__ gids, const float* __restrict__ bias,
              const int* __restrict__ valid, const int* __restrict__ y,
              const float* __restrict__ m, const float* __restrict__ gz,
              const float* __restrict__ gc, const int* __restrict__ hit,
              int B, int D, int A, float scale, int mask_hits, int seg_tiles,
              float* __restrict__ pdf) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((1024 - (ht::smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* dlh = base + DL_OFF;
  unsigned char* dll = dlh + 4 * DL_SLAB;
  unsigned char* side = base + DF_SIDE_OFF;
  int* table = reinterpret_cast<int*>(base + DF_TABLE_OFF);
  float* ms = reinterpret_cast<float*>(base + DF_ROWS_OFF);
  float* gzs = ms + DF_BT;
  float* gcs = gzs + DF_BT;
  int* ys = reinterpret_cast<int*>(gcs + DF_BT);
  int* hs = ys + DF_BT;
  uint64_t* full = reinterpret_cast<uint64_t*>(base + DF_BAR_OFF);
  uint64_t* empty = full + DF_STAGES;

  const int b0 = blockIdx.x * DF_BT;
  const int seg = blockIdx.y;
  const int d0 = blockIdx.z * DF_DG;
  const int n_atiles = (A + VT - 1) / VT;
  const int t_begin = seg * seg_tiles;
  const int t_end = min(n_atiles, t_begin + seg_tiles);
  const int n_kc = (D + KC - 1) / KC;
  const int n_db = min(8, (D - d0 + 63) / 64);   // 64-feature blocks here

  if (threadIdx.x == 0) {
    for (int s = 0; s < DF_STAGES; ++s) {
      ht::mbar_init(&full[s], GATHER_ARRIVALS);
      ht::mbar_init(&empty[s], CONSUMER_WARPS);
    }
    ht::mbar_init_fence();
  }
  load_rows(ms, gzs, gcs, ys, hs, m, gz, gc, y, hit, mask_hits, b0, DF_BT, B,
            threadIdx.x, THREADS);
  __syncthreads();

  const int wg = threadIdx.x / WG_THREADS;
  if (wg == 0) {
    // -- producer: per tile the score slabs, then W again by 64 features,
    // every slab gathered by all 128 threads
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
        const int st = slot(it, DF_STAGES);
        ht::mbar_wait(&empty[st], phase(it, DF_STAGES) ^ 1);
        unsigned char* dst = base + st * DF_STAGE;
        if (p == 0) {
          ht::mbar_expect_tx(&full[st], 2 * DF_F_SLAB);
          ht::tma_load(dst + W_SLAB, &tfh, &full[st], kc * KC, b0);
          ht::tma_load(dst + W_SLAB + DF_F_SLAB, &tfl, &full[st], kc * KC, b0);
        }
        gather_slab(dst, w, rows, kc * KC, D, p);
        if (kc == n_kc - 1)
          gather_side(side + st * SIDE_BYTES, gids, bias, valid, tile * VT,
                      A, p);
        ht::cp_async_arrive(&full[st]);
      }
      for (int j = 0; j < n_db; ++j, ++it) {
        const int st = slot(it, DF_STAGES);
        ht::mbar_wait(&empty[st], phase(it, DF_STAGES) ^ 1);
        unsigned char* dst = base + st * DF_STAGE;
        if (p == 0) ht::mbar_arrive(&full[st]);     // no TMA in this stage
        gather_slab(dst, w, rows, d0 + 64 * j, D, p);
        gather_slab(dst + W_SLAB, w, rows, d0 + 64 * j + 32, D, p);
        ht::cp_async_arrive(&full[st]);
      }
    }
    ht::cp_async_wait_all();
    return;
  }

  // -- consumers: scores and dl of 64 columns; df^T blocks j = wc, wc + 2, ..
  ht::regs_claim<CONSUMER_REGS>();
  const int wc = wg - 1;
  const int warp = (threadIdx.x / 32) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wrow = wc * 64 + warp * 16 + g;

  const uint64_t ddh = ht::desc_k(dlh, 0), ddl = ht::desc_k(dll, 0);
  // df_block's A fragment a[r] of tile column 8k + t (+ 4 for r >= 2) and
  // feature 16 warp + g (+ 8 for r odd) of a stage's two W slabs, at k = 0:
  // column 8k lies 1024 k bytes further, with the same swizzle
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
      if (kc < n_kc - 1) release(&empty[st], lane);
    }

    // dl's TF32 halves to shared memory as [b][j]: slab j / 32, row b
    consumers_sync();             // the previous tile's df products are done
    // the tile's side data came with its last slab, whose stage is kept
    const int last = slot(it - 1, DF_STAGES);
    const Col c[2] = {col_at(side + last * SIDE_BYTES, wrow),
                      col_at(side + last * SIDE_BYTES, wrow + 8)};
    const int ja = tile * VT + wrow;
#pragma unroll
    for (int i = 0; i < DF_BT / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int bl = 8 * i + 2 * t + (e & 1), jl = wrow + 8 * (e >> 1);
        uint32_t h, l;
        ht::split_tf32(sparse_dl(acc[4 * i + e], ja + 8 * (e >> 1),
                                 c[e >> 1], ms[bl], gzs[bl], gcs[bl], ys[bl],
                                 hs[bl], scale), h, l);
        const int off = (jl >> 5) * DL_SLAB + swz(bl, jl & 31);
        *reinterpret_cast<uint32_t*>(dlh + off) = h;
        *reinterpret_cast<uint32_t*>(dll + off) = l;
      }
    release(&empty[last], lane);
    ht::fence_proxy_async();      // the stores, to the wgmma operand reads
    consumers_sync();

    // df^T[d, b] += sum_j W^T[d, j] dl[b, j]: stage j holds the tile's rows'
    // features 64 j .., for warpgroup j % 2's block j / 2
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

constexpr int SCATTER_CHUNK = 32;   // sorted positions a block sums
constexpr int SKIP_ID = INT_MAX;     // the sort key of an invalid column

// Level 1 of the scatter: block c sums, for each run of equal sorted ids
// within positions [c * SCATTER_CHUNK, ...), its piece of dW_act[order[q]]
// in order. A run inside the chunk goes to dW[id]; the piece of a run that
// crosses either end of the chunk is written over dW_act[order[first
// position of the piece]], a row only this thread's column of this block
// reads.
__global__ void __launch_bounds__(NT)
sparse_bwd_scatter_pieces(float* __restrict__ dwa, const int* __restrict__ sid,
                          const long long* __restrict__ order, int A, int D,
                          float* __restrict__ dw) {
  const int k0 = blockIdx.x * SCATTER_CHUNK;
  const int k1 = min(A, k0 + SCATTER_CHUNK);
  // does the run at the chunk's first (last) position continue before (past)
  // the chunk?
  const bool open_lo = k0 > 0 && sid[k0 - 1] == sid[k0];
  const bool open_hi = k1 < A && sid[k1] == sid[k1 - 1];
  for (int c = threadIdx.x * 4; c < D; c += NT * 4) {
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    int first = k0;
    for (int q = k0; q < k1; ++q) {
      const int id = sid[q];
      if (id == SKIP_ID) break;                  // invalid columns sort last
      const float4 v =
          *reinterpret_cast<const float4*>(dwa + (size_t)order[q] * D + c);
      s.x += v.x; s.y += v.y; s.z += v.z; s.w += v.w;
      if (q + 1 < k1 && sid[q + 1] == id) continue;
      // the piece [first, q] ends here
      const bool whole = !(first == k0 && open_lo) && !(q + 1 == k1 && open_hi);
      float* dst = whole ? dw + (size_t)id * D : dwa + (size_t)order[first] * D;
      *reinterpret_cast<float4*>(dst + c) = s;
      s = make_float4(0.f, 0.f, 0.f, 0.f);
      first = q + 1;
    }
  }
}

// Level 2: dW[id] for each run that crosses a chunk's end, the sum of its
// pieces in order: the one at the run's first position, then one at each
// chunk start inside the run. Block c looks at the chunk start b = c *
// SCATTER_CHUNK (c >= 1) and works when b is the first chunk start that
// its run crosses, so that the run begins in chunk c - 1.
__global__ void __launch_bounds__(NT)
sparse_bwd_scatter_runs(const float* __restrict__ dwa,
                        const int* __restrict__ sid,
                        const long long* __restrict__ order, int A, int D,
                        float* __restrict__ dw) {
  const int b = (blockIdx.x + 1) * SCATTER_CHUNK;
  if (b >= A) return;
  const int id = sid[b];
  const int lo = b - SCATTER_CHUNK;
  if (id == SKIP_ID || sid[b - 1] != id || (lo > 0 && sid[lo - 1] == id))
    return;
  int k = b - 1;                                 // the run's first position
  while (k > lo && sid[k - 1] == id) --k;
  for (int c = threadIdx.x * 4; c < D; c += NT * 4) {
    float4 s = *reinterpret_cast<const float4*>(dwa + (size_t)order[k] * D + c);
    for (int q = b; q < A && sid[q] == id; q += SCATTER_CHUNK) {
      const float4 v =
          *reinterpret_cast<const float4*>(dwa + (size_t)order[q] * D + c);
      s.x += v.x; s.y += v.y; s.z += v.z; s.w += v.w;
    }
    *reinterpret_cast<float4*>(dw + (size_t)id * D + c) = s;
  }
}

template <int NB>
int launch_dw(const void* fh, const void* fl, const CUtensorMap& tfth,
              const CUtensorMap& tftl, const void* w, const void* ids,
              const void* gids, const void* bias, const void* valid,
              const void* y, const void* m, const void* gz, const void* gc,
              const void* hit, void* dwa, int B, int D, int A, float scale,
              int mask_hits, int seg_tiles, int n_segs, cudaStream_t st) {
  using L = DwLayout<NB>;
  CUtensorMap tfh, tfl;
  const uint64_t row = 4ull * D;
  int err = ht::tmap_f32(&tfh, fh, D, B, row, NB);
  if (!err) err = ht::tmap_f32(&tfl, fl, D, B, row, NB);
  if (err) return err;
  cudaError_t e = cudaFuncSetAttribute(
      sparse_bwd_dw<NB>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  sparse_bwd_dw<NB><<<n_segs, THREADS, L::SMEM, st>>>(
      tfh, tfl, tfth, tftl, static_cast<const float*>(w),
      static_cast<const int*>(ids), static_cast<const int*>(gids),
      static_cast<const float*>(bias), static_cast<const int*>(valid),
      static_cast<const int*>(y), static_cast<const float*>(m),
      static_cast<const float*>(gz), static_cast<const float*>(gc),
      static_cast<const int*>(hit), B, D, A, scale, mask_hits, seg_tiles,
      static_cast<float*>(dwa));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// fh, fl: [B, D] and fth, ftl: [D, Bp] scratch for f's TF32 halves (Bp =
// B rounded up to 8); dwa: [A, D] compact dW; pdf: [n_segs_df, B, D]
// partials; sid, order: ids sorted stably (an invalid column's as INT_MAX)
// and their positions; dw: [V, D], zero. dwa is overwritten. Returns a cudaError_t, or 10000 + a CUresult when a TMA descriptor
// cannot be encoded.
extern "C" int sparse_ce_bwd_launch(
    const void* f, const void* w, const void* ids, const void* gids,
    const void* bias, const void* valid, const void* y, const void* m,
    const void* gz, const void* gc, const void* hit, const void* sid,
    const void* order, void* fh, void* fl, void* fth, void* ftl, void* dwa,
    void* pdf, void* df, void* dw, int B, int D, int A, float scale,
    int mask_hits, int Bp, int seg_tiles_dw, int n_segs_dw, int seg_tiles_df,
    int n_segs_df, void* stream) {
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

  CUtensorMap tfth, tftl, tfh, tfl;
  const uint64_t row = 4ull * D;
  int err = ht::tmap_f32(&tfth, fth, Bp, D, 4ull * Bp, 64);
  if (!err) err = ht::tmap_f32(&tftl, ftl, Bp, D, 4ull * Bp, 64);
  if (!err) err = ht::tmap_f32(&tfh, fh, D, B, row, DF_BT);
  if (!err) err = ht::tmap_f32(&tfl, fl, D, B, row, DF_BT);
  if (err) return err;

  if (B <= 64)
    err = launch_dw<64>(fh, fl, tfth, tftl, w, ids, gids, bias, valid, y, m,
                        gz, gc, hit, dwa, B, D, A, scale, mask_hits,
                        seg_tiles_dw, n_segs_dw, st);
  else
    err = launch_dw<128>(fh, fl, tfth, tftl, w, ids, gids, bias, valid, y, m,
                         gz, gc, hit, dwa, B, D, A, scale, mask_hits,
                         seg_tiles_dw, n_segs_dw, st);
  if (err) return err;

  e = cudaFuncSetAttribute(sparse_bwd_df,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           DF_SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((B + DF_BT - 1) / DF_BT, n_segs_df, (D + DF_DG - 1) / DF_DG);
  sparse_bwd_df<<<grid, THREADS, DF_SMEM, st>>>(
      tfh, tfl, static_cast<const float*>(w), static_cast<const int*>(ids),
      static_cast<const int*>(gids), static_cast<const float*>(bias),
      static_cast<const int*>(valid), static_cast<const int*>(y),
      static_cast<const float*>(m), static_cast<const float*>(gz),
      static_cast<const float*>(gc), static_cast<const int*>(hit), B, D, A,
      scale, mask_hits, seg_tiles_df, static_cast<float*>(pdf));
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  ce_hopper::sum_segments<<<(n + 255) / 256, 256, 0, st>>>(
      static_cast<const float*>(pdf), n, n_segs_df, static_cast<float*>(df));
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n_chunks = (A + SCATTER_CHUNK - 1) / SCATTER_CHUNK;
  sparse_bwd_scatter_pieces<<<n_chunks, NT, 0, st>>>(
      static_cast<float*>(dwa), static_cast<const int*>(sid),
      static_cast<const long long*>(order), A, D, static_cast<float*>(dw));
  e = cudaGetLastError();
  if (e != cudaSuccess || n_chunks < 2) return static_cast<int>(e);
  sparse_bwd_scatter_runs<<<n_chunks - 1, NT, 0, st>>>(
      static_cast<const float*>(dwa), static_cast<const int*>(sid),
      static_cast<const long long*>(order), A, D, static_cast<float*>(dw));
  return static_cast<int>(cudaGetLastError());
}
