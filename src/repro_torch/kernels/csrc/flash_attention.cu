// Forward flash attention over [BH, S, Dh] with causal, sliding-window and
// kv-padding masks and grouped KV heads, on Hopper (sm_90a).
//
// Replaces: src/repro/kernels/flash_attention.py, flash_attention /
// _flash_kernel (the Pallas TPU kernel). For each of the BH query heads and
// each query row i (position i) it returns
//   o[i] = sum_j p_ij v_j / max(l_i, 1e-30),  p_ij = exp(s_ij - m_i),
//   s_ij = (q_i . k_j) * scale,  l_i = sum_j p_ij (fp32),
// over the keys j < T with j <= i when causal and j > i - window when
// window > 0; positions are top-left aligned (row i is position i, also
// when Sq != T). Query head h reads KV head h / g of the BH / g that k and
// v hold (the JAX package's reshape order: no expanded copies). The softmax
// runs online in fp32 over key tiles. For bf16 inputs p is rounded to bf16
// before the p . v product (the TPU kernel's p.astype(v.dtype)), the
// products' sums are fp32; l sums the fp32 p. A row with no valid key
// gives 0. The output has q's dtype.
//
// Bound on an H100 SXM at the zoo prefill's shapes (SmolLM-135M: B = 8,
// 9 query heads over 3 KV heads, so BH = 72 and g = 3; S = T = 2,000;
// Dh = 64; bf16; causal): 2 Dh S (S + 1) BH = 36.9 GFLOP of causal
// products, 0.037 ms at the 989 TFLOP/s dense bf16 tensor-core rate,
// against 49 MB of q, k, v and o (0.015 ms at 3.35 TB/s): bound by
// operations, so both products run on the tensor cores, and only wgmma
// reaches their full rate.
//
// Design (bf16). One block per (head, query tile), the tiles with the
// longest causal row range first (all heads' last tiles, then the ones
// before), flattened onto the grid's x axis (no 65,535-head limit):
//   - warpgroup 0 is the producer: it gives up registers (setmaxnreg) and
//     one thread issues TMA loads -- the Q tile once, then the K and V
//     tiles of the block's key range through an mbarrier ring of 3 stages
//     (2 at Dh 256; full: the bytes have landed; empty: every consumer
//     warp is done with the stage);
//   - the consumer warpgroups, 64 query rows each, take the registers the
//     producer gave up. S = Q K^T is wgmma m64nBKVk16 with both operands in
//     shared memory; the masks (only on tiles that cross the causal or
//     window edge or the end of T) and the online softmax run on the
//     accumulators in registers, in the exp2 domain (s sl2 - m is one FMA,
//     sl2 = scale log2 e; 2^x by ex2.approx); O is rescaled only where a
//     row's max moved; P is re-packed to bf16 in registers and is the
//     register A operand of O += P V, wgmma m64nDHPk16 with V as the
//     shared-memory B operand through the descriptor's transpose. m, l and
//     O stay in registers; l sums the unrounded fp32 p.
//   - Up to Dh 64 (the zoo prefill), one consumer warpgroup a block (64
//     rows) and two blocks an SM: one block's prologue (the Q and first
//     K/V loads) and epilogue overlap the other's products. Wider heads
//     keep two consumer warpgroups (128 rows) a block, since their K/V
//     ring leaves room in shared memory for one block an SM.
//   - BKV = 128 keys for Dh up to 128 (half the softmax passes and ring
//     rounds of 64 keys), 64 at Dh 256, where O's 128 fp32 registers a
//     thread leave no room for a 128-key S. Dh is padded to 64, 128 or 256
//     by the TMA boxes' zero fill of the columns past Dh; key rows past T
//     are zero-filled too and masked in the kernel (a zero key scores 0,
//     not -inf).
//   - At the prefill shapes the softmax, not the two products, sets the
//     pace: one consumer warpgroup a block beat two, and 128-key tiles beat
//     64. Issuing S of tile j before P V of tile j-1, to overlap the
//     softmax with the second product, read slower with two consumer
//     warpgroups a block and gained nothing measurable with one, so it is
//     not kept.
// Key tiles wholly outside the block's causal or window band are skipped:
// they would leave m, l and O exactly as they are, as a consumer's
// fully-masked tile does. No atomics and a fixed order of every sum: two
// runs are bit-identical.
//
// Design (fp32, off the serving path). CUDA-core FMA, no TF32: 256 threads,
// four to a query row; each thread scores 16 of the tile's 64 keys, writes
// its p to shared memory, and accumulates a quarter of the row's output
// columns; 16-byte cp.async copies.
//
// Requires 16 <= Dh <= 256 with Dh % 16 == 0, BH % BHkv == 0, contiguous
// 16-byte aligned inputs (checked by the wrapper).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper_tiles.cuh"

namespace {

struct Problem {
  int BH, g, Sq, T, Dh, causal, window, n_qt;
  float scale;
};

// the key tiles [begin, end) of BKV keys that hold a valid key for rows
// q0 .. q1-1
template <int BKV>
__device__ __forceinline__ void tile_range(const Problem& pb, int q0, int q1,
                                           int& begin, int& end) {
  end = (pb.T + BKV - 1) / BKV;
  if (pb.causal) end = min(end, (q1 - 1) / BKV + 1);
  begin = 0;
  if (pb.window > 0) {
    const int lo = q0 - pb.window + 1;       // the first key of row q0
    if (lo > 0) begin = lo / BKV;
  }
}

__device__ __forceinline__ bool key_valid(const Problem& pb, int row,
                                          int kpos) {
  return kpos < pb.T && (!pb.causal || kpos <= row) &&
         (pb.window <= 0 || kpos > row - pb.window);
}

// ---------------------------------------------------------------------------
// bf16: wgmma fed by TMA
// ---------------------------------------------------------------------------

namespace ht = hopper;

constexpr int WG_THREADS = 128;

// 2^x by the SFU (ex2.approx.ftz: within 2 ulp of exp2; 2^-inf = 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int N>
__device__ __forceinline__ void mma_ss(float (&d)[N / 2], uint64_t da,
                                       uint64_t db, int accumulate) {
  if constexpr (N == 128) ht::wgmma_ss_n128(d, da, db, accumulate);
  else ht::wgmma_ss_n64(d, da, db, accumulate);
}

template <int N>
__device__ __forceinline__ void mma_rs(float (&d)[N / 2],
                                       const uint32_t (&a)[4], uint64_t db) {
  if constexpr (N == 256) ht::wgmma_rs_n256(d, a, db, 1);
  else if constexpr (N == 128) ht::wgmma_rs_n128(d, a, db, 1);
  else ht::wgmma_rs_n64(d, a, db, 1);
}

// NC consumer warpgroups of 64 query rows a block, and the producer's
template <int DHP, int BKV, int NC>
struct Layout {
  static constexpr int BQ = 64 * NC;                   // query rows a block
  static constexpr int THREADS = (NC + 1) * WG_THREADS;
  static constexpr int BLOCKS_PER_SM = NC == 1 ? 2 : 1;
  // registers: ptxas gives every thread of the block the same count under
  // the launch bounds (a multiple of 8); the producer gives up all but 40
  // of its warpgroup's, and the consumers claim what that frees. Claiming
  // more than the block holds would wait forever in setmaxnreg.
  static constexpr int LAUNCH_REGS =
      65536 / (THREADS * BLOCKS_PER_SM) / 8 * 8 > 255
          ? 248 : 65536 / (THREADS * BLOCKS_PER_SM) / 8 * 8;
  static constexpr int PRODUCER_REGS = 40;
  static constexpr int CONSUMER_REGS =
      (LAUNCH_REGS * THREADS - PRODUCER_REGS * WG_THREADS) /
      (NC * WG_THREADS) / 8 * 8;
  static_assert(CONSUMER_REGS <= 256 && CONSUMER_REGS >= LAUNCH_REGS,
                "the consumers' register claim must fit the block");
  static constexpr int STAGES = DHP <= 128 ? 3 : 2;    // K/V ring
  static constexpr int NS = DHP / 64;                  // 64-column slabs
  static constexpr int Q_SLAB = ht::slab_bytes(BQ);
  static constexpr int KV_SLAB = ht::slab_bytes(BKV);
  static constexpr int Q_BYTES = NS * Q_SLAB;
  static constexpr int KV_BYTES = NS * KV_SLAB;        // one K or V tile
  static constexpr int BAR_OFF = Q_BYTES + 2 * STAGES * KV_BYTES;
  // 1,024 bytes of slack to align the tiles, and the barriers
  static constexpr int SMEM = 1024 + BAR_OFF + 8 * (2 * STAGES + 1);
};

// A consumer's running state for its two rows (r0 = g, r1 = g + 8 of its
// warp's 16): m in log2 units, the lane's share of l.
struct RowState {
  float m0, m1, l0, l1;
};

// The masks, then the online-softmax step on one S tile, in place: s
// becomes p = 2^(s sl2 - m) (sl2 = scale log2 e in fp32; s sl2 - m is one
// FMA, where the plain version rounds s sl2 first). Returns the
// factors (c0, c1) that rescale the rows' earlier l and O.
template <int BKV>
__device__ __forceinline__ void softmax_tile(float (&s)[BKV / 2],
                                             const Problem& pb, int kv0,
                                             int rbase, int r0, int tg,
                                             float sl2, RowState& rs,
                                             float& c0, float& c1) {
  const int r1 = r0 + 8;
  const bool edge = kv0 + BKV > pb.T ||
                    (pb.causal && kv0 + BKV - 1 > rbase) ||
                    (pb.window > 0 && kv0 <= rbase + 63 - pb.window);
  if (edge) {
#pragma unroll
    for (int i = 0; i < BKV / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = kv0 + i * 8 + tg * 2 + (e & 1);
        if (!key_valid(pb, e < 2 ? r0 : r1, kpos)) s[4 * i + e] = -INFINITY;
      }
  }
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int i = 0; i < BKV / 8; ++i) {
    mx0 = fmaxf(mx0, fmaxf(s[4 * i], s[4 * i + 1]));
    mx1 = fmaxf(mx1, fmaxf(s[4 * i + 2], s[4 * i + 3]));
  }
#pragma unroll
  for (int sh = 1; sh <= 2; sh <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, sh));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, sh));
  }
  // max(s) sl2 == max(s sl2): the multiply by sl2 > 0 keeps the order
  const float mn0 = fmaxf(rs.m0, __fmul_rn(mx0, sl2));
  const float mn1 = fmaxf(rs.m1, __fmul_rn(mx1, sl2));
  const float b0 = mn0 == -INFINITY ? 0.f : mn0;
  const float b1 = mn1 == -INFINITY ? 0.f : mn1;
  c0 = ex2(__fsub_rn(rs.m0, b0));           // exp2(-inf) = 0
  c1 = ex2(__fsub_rn(rs.m1, b1));
  rs.m0 = mn0;
  rs.m1 = mn1;
  float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
  for (int i = 0; i < BKV / 8; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e)                 // masked: exp2(-inf) = 0
      s[4 * i + e] = ex2(fmaf(s[4 * i + e], sl2, -(e < 2 ? b0 : b1)));
    ps0 += s[4 * i] + s[4 * i + 1];
    ps1 += s[4 * i + 2] + s[4 * i + 3];
  }
  rs.l0 = rs.l0 * c0 + ps0;
  rs.l1 = rs.l1 * c1 + ps1;
}

// P's A fragments straight from the S accumulators, p rounded to bf16
template <int BKV>
__device__ __forceinline__ void pack_p(const float (&s)[BKV / 2],
                                       uint32_t (&pa)[BKV / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < BKV / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      pa[kk][r] = ht::pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
}

template <int DHP, int BKV, int NC>
__global__ void __launch_bounds__(Layout<DHP, BKV, NC>::THREADS,
                                  Layout<DHP, BKV, NC>::BLOCKS_PER_SM)
flash_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv,
                  __nv_bfloat16* __restrict__ o, Problem pb) {
  using L = Layout<DHP, BKV, NC>;
  constexpr int BQ = L::BQ;
  constexpr int STAGES = L::STAGES;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((1024 - (ht::smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* qs = base;                              // [NS][BQ][64]
  unsigned char* ks = base + L::Q_BYTES;                 // [STAGES][NS][BKV][64]
  unsigned char* vs = ks + STAGES * L::KV_BYTES;         // [STAGES][NS][BKV][64]
  uint64_t* full = reinterpret_cast<uint64_t*>(base + L::BAR_OFF);
  uint64_t* empty = full + STAGES;
  uint64_t* qbar = empty + STAGES;

  const int bh = blockIdx.x % pb.BH;
  const int q0 = (pb.n_qt - 1 - blockIdx.x / pb.BH) * BQ;
  int j0, j1;
  tile_range<BKV>(pb, q0, min(q0 + BQ, pb.Sq), j0, j1);

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      ht::mbar_init(&full[s], 1);
      ht::mbar_init(&empty[s], 4 * NC);         // each consumer warp
    }
    ht::mbar_init(qbar, 1);
    ht::mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / WG_THREADS;
  if (wg == 0) {
    // -- producer ----------------------------------------------------------
    ht::regs_release<L::PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      ht::tma_prefetch_desc(&tq);
      ht::tma_prefetch_desc(&tk);
      ht::tma_prefetch_desc(&tv);
      ht::mbar_expect_tx(qbar, L::Q_BYTES);
      for (int c = 0; c < L::NS; ++c)
        ht::tma_load(qs + c * L::Q_SLAB, &tq, qbar, c * 64, q0, bh);
      const int kvh = bh / pb.g;
      for (int j = j0, it = 0; j < j1; ++j, ++it) {
        const int st = it % STAGES;
        ht::mbar_wait(&empty[st], ((it / STAGES) & 1) ^ 1);
        ht::mbar_expect_tx(&full[st], 2 * L::KV_BYTES);
        for (int c = 0; c < L::NS; ++c) {
          ht::tma_load(ks + st * L::KV_BYTES + c * L::KV_SLAB, &tk, &full[st],
                       c * 64, j * BKV, kvh);
          ht::tma_load(vs + st * L::KV_BYTES + c * L::KV_SLAB, &tv, &full[st],
                       c * 64, j * BKV, kvh);
        }
      }
    }
    return;
  }

  // -- consumers: 64 query rows each ----------------------------------------
  ht::regs_claim<L::CONSUMER_REGS>();
  const int wc = wg - 1;
  const int warp = (threadIdx.x / 32) & 3, lane = threadIdx.x & 31;
  const int g8 = lane >> 2, tg = lane & 3;
  const int rbase = q0 + wc * 64;
  const int r0 = rbase + warp * 16 + g8, r1 = r0 + 8;   // this lane's rows
  const float sl2 = pb.scale * 1.4426950408889634f;    // scale * log2(e)
  const unsigned char* qw = qs + wc * ht::slab_bytes(64);

  RowState rs{-INFINITY, -INFINITY, 0.f, 0.f};
  float acc[DHP / 2];
#pragma unroll
  for (int i = 0; i < DHP / 2; ++i) acc[i] = 0.f;

  ht::mbar_wait(qbar, 0);
  for (int j = j0, it = 0; j < j1; ++j, ++it) {
    const int st = it % STAGES;
    ht::mbar_wait(&full[st], (it / STAGES) & 1);
    const unsigned char* kt = ks + st * L::KV_BYTES;
    const unsigned char* vt = vs + st * L::KV_BYTES;

    // -- S = Q K^T: 64 rows x BKV keys ---------------------------------------
    float s[BKV / 2];
#pragma unroll
    for (int i = 0; i < BKV / 2; ++i) s[i] = 0.f;
    ht::fence_regs(s);
    ht::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DHP / 16; ++kk)
      mma_ss<BKV>(s, ht::desc_k(qw + (kk / 4) * L::Q_SLAB, kk % 4),
                  ht::desc_k(kt + (kk / 4) * L::KV_SLAB, kk % 4), kk);
    ht::wgmma_commit();
    ht::wgmma_wait<0>();
    ht::fence_regs(s);

    float c0, c1;
    softmax_tile<BKV>(s, pb, j * BKV, rbase, r0, tg, sl2, rs, c0, c1);
    // rescale O where a row's max moved (a factor of 1 changes nothing)
    if (__any_sync(0xffffffffu, c0 != 1.f || c1 != 1.f)) {
#pragma unroll
      for (int i = 0; i < DHP / 8; ++i) {
        acc[4 * i] *= c0;
        acc[4 * i + 1] *= c0;
        acc[4 * i + 2] *= c1;
        acc[4 * i + 3] *= c1;
      }
    }

    // -- O += bf16(P) V ------------------------------------------------------------
    uint32_t pa[BKV / 16][4];
    pack_p<BKV>(s, pa);
    ht::fence_regs(acc);
    ht::fence_regs(pa);
    ht::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk)
      mma_rs<DHP>(acc, pa[kk], ht::desc_mn(vt + kk * 16 * 128, L::KV_SLAB));
    ht::wgmma_commit();
    ht::wgmma_wait<0>();
    ht::fence_regs(acc);
    __syncwarp();
    if (lane == 0) ht::mbar_arrive(&empty[st]);   // K and V of the stage read
  }

  // -- o = acc / max(l, 1e-30) in bf16 ------------------------------------------
  float l0 = rs.l0, l1 = rs.l1;
#pragma unroll
  for (int sh = 1; sh <= 2; sh <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, sh);
    l1 += __shfl_xor_sync(0xffffffffu, l1, sh);
  }
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  const int Sq = pb.Sq, Dh = pb.Dh;
  __nv_bfloat16* og = o + (size_t)bh * Sq * Dh;
#pragma unroll
  for (int i = 0; i < DHP / 8; ++i) {
    const int col = i * 8 + tg * 2;
    if (col >= Dh) continue;
    if (r0 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(og + (size_t)r0 * Dh + col) =
          __floats2bfloat162_rn(acc[4 * i] / d0, acc[4 * i + 1] / d0);
    if (r1 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(og + (size_t)r1 * Dh + col) =
          __floats2bfloat162_rn(acc[4 * i + 2] / d1, acc[4 * i + 3] / d1);
  }
}

// ---------------------------------------------------------------------------
// fp32: CUDA-core FMA
// ---------------------------------------------------------------------------

// 16 bytes from global to shared memory; pred false fills them with zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   ht::smem_u32(dst)),
               "l"(src), "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

constexpr int BQ32 = 64;         // query rows per block
constexpr int BKV32 = 64;        // keys per tile
constexpr int FMA_THREADS = 256;   // 4 threads a query row
constexpr int PS = BKV32 + 1;        // p row stride (floats)

template <int DHP>
__global__ void __launch_bounds__(FMA_THREADS)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 Problem pb) {
  constexpr int ST = DHP + 4;          // row stride (floats): 4 rows' float4 on distinct banks
  constexpr int CH = DHP / 4;          // 16-byte chunks a row
  constexpr int KPT = BKV32 / 4;         // keys a thread scores
  constexpr int OPT = DHP / 16;        // output float4 a thread owns
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);   // [BQ32][ST]
  float* ks = qs + BQ32 * ST;                        // [BKV32][ST]
  float* vs = ks + BKV32 * ST;                       // [BKV32][ST]
  float* ps = vs + BKV32 * ST;                       // [BQ32][PS]

  const int tid = threadIdx.x;
  const int r = tid >> 2, jq = tid & 3;   // the row, and this thread's quarter
  const int Sq = pb.Sq, T = pb.T, Dh = pb.Dh;
  const size_t bh = blockIdx.x % pb.BH;
  const int q0 = (pb.n_qt - 1 - blockIdx.x / pb.BH) * BQ32;
  const float* qg = q + bh * Sq * Dh;
  const float* kg = k + bh / pb.g * T * Dh;
  const float* vg = v + bh / pb.g * T * Dh;
  int j0, j1;
  tile_range<BKV32>(pb, q0, min(q0 + BQ32, Sq), j0, j1);

  for (int c = tid; c < BQ32 * CH; c += FMA_THREADS) {
    const int rr = c / CH, d = (c % CH) * 4;
    const bool ok = q0 + rr < Sq && d < Dh;
    cp_async16(qs + rr * ST + d, ok ? qg + (size_t)(q0 + rr) * Dh + d : qg, ok);
  }
  cp_async_commit();

  const int row = q0 + r;
  float m = -INFINITY, l = 0.f;
  float4 acc[OPT];
#pragma unroll
  for (int i = 0; i < OPT; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int j = j0; j < j1; ++j) {
    for (int c = tid; c < BKV32 * CH; c += FMA_THREADS) {
      const int rr = c / CH, d = (c % CH) * 4, n = j * BKV32 + rr;
      const bool ok = n < T && d < Dh;
      const size_t off = ok ? (size_t)n * Dh + d : 0;
      cp_async16(ks + rr * ST + d, kg + off, ok);
      cp_async16(vs + rr * ST + d, vg + off, ok);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    // keys jq, jq + 4, ..., jq + 60 of the tile
    float s[KPT];
#pragma unroll
    for (int i = 0; i < KPT; ++i) s[i] = 0.f;
    const float* qrow = qs + r * ST;
#pragma unroll 4
    for (int d = 0; d < DHP; d += 4) {
      const float4 qv = *reinterpret_cast<const float4*>(qrow + d);
#pragma unroll
      for (int i = 0; i < KPT; ++i) {
        const float4 kv =
            *reinterpret_cast<const float4*>(ks + (jq + 4 * i) * ST + d);
        s[i] = fmaf(qv.x, kv.x, s[i]);
        s[i] = fmaf(qv.y, kv.y, s[i]);
        s[i] = fmaf(qv.z, kv.z, s[i]);
        s[i] = fmaf(qv.w, kv.w, s[i]);
      }
    }
    const int kv0 = j * BKV32;
    float mx = -INFINITY;
#pragma unroll
    for (int i = 0; i < KPT; ++i) {
      s[i] = key_valid(pb, row, kv0 + jq + 4 * i) ? s[i] * pb.scale : -INFINITY;
      mx = fmaxf(mx, s[i]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float mn = fmaxf(m, mx);
    const float safe = mn == -INFINITY ? 0.f : mn;
    const float corr = m == -INFINITY ? 0.f : expf(m - safe);
    m = mn;
    float psum = 0.f;
#pragma unroll
    for (int i = 0; i < KPT; ++i) {
      const float p = expf(s[i] - safe);
      psum += p;
      ps[r * PS + jq + 4 * i] = p;
    }
    l = l * corr + psum;
    __syncwarp();        // a row's p is written and read by its own 4 lanes

    // output float4 columns jq, jq + 4, ... of the row
#pragma unroll
    for (int i = 0; i < OPT; ++i) {
      acc[i].x *= corr;
      acc[i].y *= corr;
      acc[i].z *= corr;
      acc[i].w *= corr;
    }
    const float* prow = ps + r * PS;
#pragma unroll 4
    for (int t = 0; t < BKV32; ++t) {
      const float p = prow[t];
#pragma unroll
      for (int i = 0; i < OPT; ++i) {
        const float4 vv =
            *reinterpret_cast<const float4*>(vs + t * ST + (jq + 4 * i) * 4);
        acc[i].x = fmaf(p, vv.x, acc[i].x);
        acc[i].y = fmaf(p, vv.y, acc[i].y);
        acc[i].z = fmaf(p, vv.z, acc[i].z);
        acc[i].w = fmaf(p, vv.w, acc[i].w);
      }
    }
    __syncthreads();     // K, V and p are refilled in the next iteration
  }
  cp_async_wait<0>();

  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);
  const float den = fmaxf(l, 1e-30f);
  if (row < Sq) {
    float* orow = o + (bh * Sq + row) * Dh;
#pragma unroll
    for (int i = 0; i < OPT; ++i) {
      const int col = (jq + 4 * i) * 4;
      if (col < Dh)
        *reinterpret_cast<float4*>(orow + col) =
            make_float4(acc[i].x / den, acc[i].y / den, acc[i].z / den,
                        acc[i].w / den);
    }
  }
}

int launch_f32_width(int Dh) {
  return Dh <= 32 ? 32 : Dh <= 64 ? 64 : Dh <= 96 ? 96 : Dh <= 128 ? 128 : 256;
}

template <int DHP, int BKV, int NC>
int launch_bf16(const void* q, const void* k, const void* v, void* o,
                int BHkv, Problem pb, cudaStream_t st) {
  using L = Layout<DHP, BKV, NC>;
  constexpr int BQ = L::BQ;
  CUtensorMap tq, tk, tv;
  const uint64_t row = 2ull * pb.Dh;
  int err = ht::tmap_bf16(&tq, q, 3, pb.Dh, pb.Sq, pb.BH, row, row * pb.Sq,
                          BQ);
  if (!err)
    err = ht::tmap_bf16(&tk, k, 3, pb.Dh, pb.T, BHkv, row, row * pb.T, BKV);
  if (!err)
    err = ht::tmap_bf16(&tv, v, 3, pb.Dh, pb.T, BHkv, row, row * pb.T, BKV);
  if (err) return err;
  cudaError_t e = cudaFuncSetAttribute(
      flash_bf16_kernel<DHP, BKV, NC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  pb.n_qt = (pb.Sq + BQ - 1) / BQ;
  const unsigned grid = static_cast<unsigned>(pb.BH) * pb.n_qt;
  flash_bf16_kernel<DHP, BKV, NC><<<grid, L::THREADS, L::SMEM, st>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), pb);
  return static_cast<int>(cudaGetLastError());
}

template <int DHP>
int launch_f32(const void* q, const void* k, const void* v, void* o,
               Problem pb, cudaStream_t st) {
  const int smem = ((BQ32 + 2 * BKV32) * (DHP + 4) + BQ32 * PS) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      flash_f32_kernel<DHP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  pb.n_qt = (pb.Sq + BQ32 - 1) / BQ32;
  const unsigned grid = static_cast<unsigned>(pb.BH) * pb.n_qt;
  flash_f32_kernel<DHP><<<grid, FMA_THREADS, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), pb);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// is_bf16: 1 for bfloat16 inputs and output, 0 for float32. k and v hold
// BHkv heads, BH % BHkv == 0. Returns a cudaError_t, or 10000 + a CUresult
// when a TMA descriptor cannot be encoded.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int BH,
                                      int BHkv, int Sq, int T, int Dh,
                                      int causal, int window, float scale,
                                      int is_bf16, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const Problem pb{BH, BH / BHkv, Sq, T, Dh, causal, window, 0, scale};
  if (is_bf16) {
    if (Dh <= 64) return launch_bf16<64, 128, 1>(q, k, v, o, BHkv, pb, st);
    if (Dh <= 128) return launch_bf16<128, 128, 2>(q, k, v, o, BHkv, pb, st);
    return launch_bf16<256, 64, 2>(q, k, v, o, BHkv, pb, st);
  }
  switch (launch_f32_width(Dh)) {
    case 32: return launch_f32<32>(q, k, v, o, pb, st);
    case 64: return launch_f32<64>(q, k, v, o, pb, st);
    case 96: return launch_f32<96>(q, k, v, o, pb, st);
    case 128: return launch_f32<128>(q, k, v, o, pb, st);
    default: return launch_f32<256>(q, k, v, o, pb, st);
  }
}
