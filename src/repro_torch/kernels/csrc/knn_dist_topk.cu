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
// run on wgmma, the only way to the tensor cores' full rate.
//
// Design. One block of three warpgroups owns 256 query rows for the whole
// sweep over K, in tiles of 128 key rows:
//   - warpgroup 0 is the producer: it gives up registers (setmaxnreg) and
//     one thread streams, through a 3-stage mbarrier ring, 64-deep slabs of
//     the block's 256 query rows and of the tile's 128 key rows by TMA
//     (zero fill past Nq, Nk and D). Q is streamed over depth like K and
//     never held whole, so D has no cap from shared memory;
//   - warpgroups 1 and 2 are the consumers, 128 query rows each: S = Q K^T
//     by wgmma m64n128k16 (two per 16-deep step, one per 64-row half), both
//     operands in shared memory, fp32 accumulators in registers (128 a
//     thread); a stage is released as soon as the next one's products are
//     issued.
//   - Reuse: each K slab read from L2 feeds 256 query rows, 256 operations
//     per K byte (the card needs ~295 per byte of device memory; K is read
//     from device memory about once a wave and from L2 once a block). Q's
//     256 rows are read again for every 128-key tile, so the block does
//     2·256·128 / ((256 + 128)·2) = 85 operations per byte it reads from L2
//     in all, the most the 256 x 128 accumulator tile in registers allows
//     when both operands stream. With the fold taken out the sweep runs at
//     ~680 TFLOP/s (below), so L2 does not bind.
//   - The fold, from registers. Each thread holds 4 rows' scores (two
//     rows of each 64-row half, 32 columns each) and their current k'-th
//     value in registers. A row's 32 scores are first reduced to their
//     max; only when that reaches the k'-th value does the lane build the
//     mask of its passing scores (ties are settled exactly by the merge).
//     For a row with passing scores, its quad's 4 lanes stash their 32
//     scores in shared memory, and the warp inserts the passing ones one by
//     one into the row's sorted top-k' in shared memory (merge_row: lane j
//     holds slot j, one ballot gives an entry's rank, one shuffle moves the
//     slots below it), each checked exactly against the current k'-th
//     entry. After the first tiles almost nothing passes: keys in random
//     order enter a row's top-k' about k'(1 + ln(Nk / k')) times, ~360 over
//     a sweep of 1M keys. The order is total, so the result does not
//     depend on the order of insertion; there are no atomics, and two runs
//     are bit-identical.
//   - What it costs: the filter is cheap, the merges are not. The
//     consumers share every K slab and the producer refills a stage only
//     when all 8 consumer warps have released it, so the slowest warp's
//     fold drains the ring. Handing the merges to the producer
//     warpgroup's idle warps through per-warp queues read slower, and so
//     did a 4th stage bought by keeping the top-k' lists in the outputs in
//     device memory.
//   - Columns at or past Nk are masked in the kernel; rows past Nq are not
//     written, and get a k'-th value of +inf so nothing of theirs passes.
//   - Depth past 2,048 (PROMOTE): the tensor cores add each wgmma's
//     products into its fp32 accumulator truncating, not rounding, so a
//     sum carried through D / 16 instructions drifts towards zero by up to
//     about D / 16 units in the last place: at D = 8,192 a graph build's
//     self score of ~1 came 2.6e-5 below the plain fp32 product (an H100
//     SXM). There each 64-deep chunk's products go, one 64-row half at a
//     time, into an accumulator that starts from zero, and are added to
//     the half's fp32 sum by ordinary (round-to-nearest) adds; the two
//     halves' sums and the chunk's take 192 registers a thread. The chunk
//     is waited on before its adds, so the products no longer overlap the
//     next stage's; below 2,048 deep the drift stays under 8e-6 of a score
//     of 1 and the sums stay in the wgmma accumulators. Two bodies, since
//     the deep one costs time where the fold dominates: on 16,896 rows of
//     a graph build (scripts/chip_dist_topk_depth.py with PROMOTE_KC = 0,
//     an H100 SXM at 700 W) it took 59.7 ms against the overlapped body's
//     49.5 at D 512 over 1,020,250 keys, and the same (34.9 / 34.6 ms,
//     51.6 / 51.7 ms) at D 2,048 and 3,072 over 151,936.
// One launch per ring hop; the wrapper shifts the ids by the hop's column
// offset.
//
// Requires D % 8 == 0, 16-byte aligned Q and K, 1 <= k' <= 32 (checked by
// the wrapper).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper_tiles.cuh"

namespace {

namespace ht = hopper;

constexpr int WG_THREADS = 128;
constexpr int THREADS = 3 * WG_THREADS;     // producer + 2 consumers
constexpr int BQ = 256;                     // query rows a block
constexpr int BN = 128;                     // key rows a tile
constexpr int STAGES = 3;
constexpr int KP_MAX = 32;
constexpr int CONSUMER_WARPS = 8;
constexpr int Q_SLAB = ht::slab_bytes(BQ);  // 256 rows x 64 depth
constexpr int K_SLAB = ht::slab_bytes(BN);  // 128 rows x 64 depth
constexpr int STAGE_BYTES = Q_SLAB + K_SLAB;
constexpr int LIST_OFF = STAGES * STAGE_BYTES;
constexpr int STASH_OFF = LIST_OFF + BQ * KP_MAX * 8;    // after the top-k'
constexpr int BAR_OFF = STASH_OFF + CONSUMER_WARPS * 132 * 4;  // score stash
constexpr int SMEM = 1024 + BAR_OFF + 8 * 2 * STAGES;

// (av, ac) comes before (bv, bc): larger value, then lower column
__device__ __forceinline__ bool before(float av, int ac, float bv, int bc) {
  return av > bv || (av == bv && ac < bc);
}

// One row's passing scores (the masks of quad q's lanes over the 32
// scores each stashed in sbuf) inserted one by one into its sorted top-k'
// in shared memory, lane j holding slot j: one ballot gives an entry's
// rank, one shuffle moves the slots below it; each is checked exactly
// against the current k'-th entry. The order is total, so the order of
// insertion does not change the result. Returns the row's k'-th value. Not
// inlined: the four call sites share one copy of the code.
__device__ __noinline__ float merge_row(float* list_v, int* list_c,
                                        const float* sbuf, unsigned mask,
                                        int lr, int q, int n0, int lane,
                                        int kp) {
  float sv = lane < kp ? list_v[lr * KP_MAX + lane] : -INFINITY;
  int sc = lane < kp ? list_c[lr * KP_MAX + lane] : -1;
  float kv = __shfl_sync(0xffffffffu, sv, kp - 1);
  int kc = __shfl_sync(0xffffffffu, sc, kp - 1);
  for (int u = 0; u < 4; ++u) {
    unsigned mu = __shfl_sync(0xffffffffu, mask, q * 4 + u);
    while (mu) {
      const int b = __ffs(mu) - 1;
      mu &= mu - 1;
      const float v = sbuf[u * 33 + b];
      const int c = n0 + (b >> 1) * 8 + u * 2 + (b & 1);
      if (!before(v, c, kv, kc)) continue;
      // rank of the entry: the number of slots that come before it
      const int p = __popc(__ballot_sync(
          0xffffffffu, lane < kp && before(sv, sc, v, c)));
      const float uv = __shfl_up_sync(0xffffffffu, sv, 1);
      const int uc = __shfl_up_sync(0xffffffffu, sc, 1);
      if (lane == p) { sv = v; sc = c; }
      else if (lane > p && lane < kp) { sv = uv; sc = uc; }
      kv = __shfl_sync(0xffffffffu, sv, kp - 1);
      kc = __shfl_sync(0xffffffffu, sc, kp - 1);
    }
  }
  if (lane < kp) {
    list_v[lr * KP_MAX + lane] = sv;
    list_c[lr * KP_MAX + lane] = sc;
  }
  return kv;
}

constexpr int PROMOTE_KC = 32;   // 64-deep chunks past which sums promote

template <bool PROMOTE>
__global__ void __launch_bounds__(THREADS, 1)
dist_topk_kernel(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk, int Nq, int Nk,
                 int n_kc, int kp, float* __restrict__ vals,
                 int* __restrict__ ids) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((1024 - (ht::smem_u32(smem_raw) & 1023)) & 1023);
  float* list_v = reinterpret_cast<float*>(base + LIST_OFF);   // [BQ][32]
  int* list_c = reinterpret_cast<int*>(list_v + BQ * KP_MAX);  // [BQ][32]
  float* stash = reinterpret_cast<float*>(base + STASH_OFF);   // [8][4][33]
  uint64_t* full = reinterpret_cast<uint64_t*>(base + BAR_OFF);
  uint64_t* empty = full + STAGES;

  const int q0 = blockIdx.x * BQ;
  const int n_tiles = (Nk + BN - 1) / BN;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      ht::mbar_init(&full[s], 1);
      ht::mbar_init(&empty[s], CONSUMER_WARPS);
    }
    ht::mbar_init_fence();
  }
  for (int i = threadIdx.x; i < BQ * KP_MAX; i += THREADS) {
    list_v[i] = -INFINITY;
    list_c[i] = -1;
  }
  __syncthreads();

  const int wg = threadIdx.x / WG_THREADS;
  if (wg == 0) {
    // -- producer: Q and K slabs, tile by tile, 64 deep ---------------------
    ht::regs_release<40>();
    if (threadIdx.x == 0) {
      ht::tma_prefetch_desc(&tq);
      ht::tma_prefetch_desc(&tk);
      int it = 0;
      for (int t = 0; t < n_tiles; ++t)
        for (int kc = 0; kc < n_kc; ++kc, ++it) {
          const int st = it % STAGES;
          ht::mbar_wait(&empty[st], ((it / STAGES) & 1) ^ 1);
          ht::mbar_expect_tx(&full[st], STAGE_BYTES);
          unsigned char* dst = base + st * STAGE_BYTES;
          ht::tma_load(dst, &tq, &full[st], kc * 64, q0);
          ht::tma_load(dst + Q_SLAB, &tk, &full[st], kc * 64, t * BN);
        }
    }
    return;
  }

  // -- consumers: 128 query rows each -----------------------------------------
  ht::regs_claim<232>();
  const int wc = wg - 1;
  const int warp = (threadIdx.x / 32) & 3, lane = threadIdx.x & 31;
  const int g8 = lane >> 2, tg = lane & 3;
  float* sbuf = stash + (wc * 4 + warp) * 132;   // this warp's score stash
  // local row of (half h, row-of-pair rr) for quad q: wc*128 + h*64 +
  // warp*16 + q + 8*rr
  const int row_base = wc * 128 + warp * 16;

  // this lane's rows' k'-th value; +inf for rows past Nq, which are never
  // written, so nothing of theirs passes
  float thv[2][2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int rr = 0; rr < 2; ++rr)
      thv[h][rr] = q0 + row_base + h * 64 + g8 + 8 * rr < Nq ? -INFINITY
                                                             : INFINITY;

  int it = 0;
  for (int t = 0; t < n_tiles; ++t) {
    float acc[2][BN / 2];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[h][i] = 0.f;
    ht::fence_regs(acc[0]);
    ht::fence_regs(acc[1]);
    int prev = -1;
    for (int kc = 0; kc < n_kc; ++kc, ++it) {
      const int st = it % STAGES;
      ht::mbar_wait(&full[st], (it / STAGES) & 1);
      const unsigned char* qsl = base + st * STAGE_BYTES +
                                 wc * ht::slab_bytes(128);
      const unsigned char* ksl = base + st * STAGE_BYTES + Q_SLAB;
      if constexpr (PROMOTE) {
        // the chunk's products from zero, one half at a time, then added
        // to the half's sums with round-to-nearest adds
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float part[BN / 2];
          ht::wgmma_fence();
#pragma unroll
          for (int k4 = 0; k4 < 4; ++k4)
            ht::wgmma_ss_n128(part,
                              ht::desc_k(qsl + h * ht::slab_bytes(64), k4),
                              ht::desc_k(ksl, k4), k4);
          ht::wgmma_commit();
          ht::wgmma_wait<0>();
          ht::fence_regs(part);
#pragma unroll
          for (int i = 0; i < BN / 2; ++i) acc[h][i] += part[i];
        }
        __syncwarp();
        if (lane == 0) ht::mbar_arrive(&empty[st]);
        continue;
      } else {
        ht::wgmma_fence();
#pragma unroll
        for (int k4 = 0; k4 < 4; ++k4) {
          const uint64_t db = ht::desc_k(ksl, k4);
          ht::wgmma_ss_n128(acc[0], ht::desc_k(qsl, k4), db, kc | k4);
          ht::wgmma_ss_n128(acc[1],
                            ht::desc_k(qsl + ht::slab_bytes(64), k4), db,
                            kc | k4);
        }
        ht::wgmma_commit();
        ht::wgmma_wait<1>();                  // the previous stage is read
        if (prev >= 0) {
          __syncwarp();
          if (lane == 0) ht::mbar_arrive(&empty[prev]);
        }
        prev = st;
      }
    }
    if constexpr (!PROMOTE) {
      ht::wgmma_wait<0>();
      ht::fence_regs(acc[0]);
      ht::fence_regs(acc[1]);
      __syncwarp();
      if (lane == 0) ht::mbar_arrive(&empty[prev]);
    }

    // -- fold this tile's scores into the rows' top-k' ---------------------
    const int n0 = t * BN;
    // bit 2i + e of a row's mask: column n0 + 8i + 2tg + e
    unsigned colmask = 0xffffffffu;
    if (n0 + BN > Nk) {
      colmask = 0;
#pragma unroll
      for (int b = 0; b < 32; ++b)
        if (n0 + (b >> 1) * 8 + tg * 2 + (b & 1) < Nk) colmask |= 1u << b;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        // the row's 32 scores of this lane against its k'-th value: the max
        // first, the per-score mask only when it passes
        float mx = -INFINITY;
#pragma unroll
        for (int b = 0; b < 32; ++b)
          mx = fmaxf(mx, acc[h][4 * (b >> 1) + 2 * rr + (b & 1)]);
        if (!__any_sync(0xffffffffu, mx >= thv[h][rr])) continue;
        // v >= the k'-th value: a superset of the scores that come before
        // the k'-th entry (the merge settles ties exactly)
        unsigned mask = 0;
#pragma unroll
        for (int b = 0; b < 32; ++b)
          if (acc[h][4 * (b >> 1) + 2 * rr + (b & 1)] >= thv[h][rr])
            mask |= 1u << b;
        mask &= colmask;
        unsigned pend = __ballot_sync(0xffffffffu, mask != 0);
        while (pend) {
          const int q = (__ffs(pend) - 1) >> 2;     // the row's quad
          if (g8 == q) {                            // its 4 lanes' scores
#pragma unroll
            for (int b = 0; b < 32; ++b)
              sbuf[tg * 33 + b] = acc[h][4 * (b >> 1) + 2 * rr + (b & 1)];
          }
          __syncwarp();
          const float kv = merge_row(list_v, list_c, sbuf, mask,
                                     row_base + h * 64 + q + 8 * rr, q, n0,
                                     lane, kp);
          if (g8 == q) {                            // the row's new k'-th
            thv[h][rr] = kv;
            mask = 0;
          }
          __syncwarp();
          pend = __ballot_sync(0xffffffffu, mask != 0);
        }
      }
  }

  // -- write each row's slots: a warp writes its own 32 rows -----------------
#pragma unroll
  for (int h = 0; h < 2; ++h)
    for (int r = 0; r < 16; ++r) {
      const int lr = row_base + h * 64 + r;
      const int row = q0 + lr;
      if (row < Nq && lane < kp) {
        vals[(size_t)row * kp + lane] = list_v[lr * KP_MAX + lane];
        ids[(size_t)row * kp + lane] = list_c[lr * KP_MAX + lane];
      }
    }
}

}  // namespace

// Returns a cudaError_t, or 10000 + a CUresult when a TMA descriptor cannot
// be encoded.
extern "C" int dist_topk_launch(const void* q, const void* k, int Nq, int Nk,
                                int D, int kp, void* vals, void* ids,
                                void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  CUtensorMap tq, tk;
  const uint64_t row = 2ull * D;
  int err = ht::tmap_bf16(&tq, q, 2, D, Nq, 1, row, 0, BQ);
  if (!err) err = ht::tmap_bf16(&tk, k, 2, D, Nk, 1, row, 0, BN);
  if (err) return err;
  const int n_kc = (D + 63) / 64;
  auto kernel = n_kc > PROMOTE_KC ? dist_topk_kernel<true>
                                  : dist_topk_kernel<false>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<(Nq + BQ - 1) / BQ, THREADS, SMEM, st>>>(
      tq, tk, Nq, Nk, n_kc, kp, static_cast<float*>(vals),
      static_cast<int*>(ids));
  return static_cast<int>(cudaGetLastError());
}
