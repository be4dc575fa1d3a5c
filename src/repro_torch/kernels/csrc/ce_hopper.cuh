// The 3xTF32 score tile shared by ce_softmax_fwd.cu and ce_softmax_bwd.cu,
// so that the forward and both backward kernels compute
// s[v, b] = <W[v], f[b]> from the same operands with the same products in
// the same order, and the backward's p = exp(s scale - m) meets the
// forward's m. (Where registers are short the backward hands the tensor
// cores' sums to the CUDA cores half a slab at a time, the forward a whole
// slab at a time; s then differs in its last bits.)
//
// The tile puts classes on wgmma's M: a consumer warpgroup owns 64 class
// rows of a 128-row W slab and NB batch columns. TF32 wgmma reads its
// operands K-major only, and both W [V, D] and f [B, D] are K-major along
// D, so each k8 step is
//   acc += W_lo f_hi + W_hi f_lo + W_hi f_hi     (3xTF32, lo.lo dropped)
// with W's A fragments loaded from the TMA-written fp32 slab and split into
// hi = tf32(x), lo = tf32(x - hi) in registers (no shared-memory pass),
// and f's hi and lo made once per call by split_rows into two [B, D]
// arrays that TMA streams as the B operands. The split keeps |x - hi - lo|
// <= 2^-22 |x|, and the dropped lo.lo term is below 2^-22 |W f| per
// product: fp32-level accuracy from three products at the TF32 rate.
//
// Blocks are three warpgroups: warpgroup 0 the producer (one thread issues
// TMA into mbarrier rings, the rest idle; it gives up registers), 1 and 2
// the consumers, claiming what the producer frees.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper_tiles.cuh"

namespace ce_hopper {

namespace ht = hopper;

constexpr int WG_THREADS = 128;
constexpr int THREADS = 3 * WG_THREADS;   // producer + 2 consumers
constexpr int CONSUMERS = 2 * WG_THREADS;
constexpr int CONSUMER_WARPS = 8;
constexpr int VT = 128;                   // class rows a tile (64 a consumer)
constexpr int KC = 32;                    // depth of a slab (128 bytes of fp32)
constexpr int W_SLAB = ht::slab_bytes(VT);     // 128 rows x 32 fp32
// registers: ptxas gives every thread the same count under the launch
// bounds (one block an SM); the producer keeps 40, the consumers claim
// what that frees. A claim above it would wait forever in setmaxnreg.
constexpr int LAUNCH_REGS = 65536 / THREADS / 8 * 8;          // 168
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS =
    (LAUNCH_REGS * THREADS - PRODUCER_REGS * WG_THREADS) / CONSUMERS / 8 * 8;
static_assert(CONSUMER_REGS == 232, "the consumers' claim fits the block");
constexpr int BAR_ID = 1;                 // named barrier of the consumers

// the byte of element (row, col) of a 128-byte-swizzled fp32 tile (rows of
// 32 fp32): the 16-byte chunk c of row r is stored at chunk c ^ (r % 8)
__device__ __forceinline__ int swz(int row, int col) {
  return row * 128 + ((((col >> 2) ^ row) & 7) << 4) + ((col & 3) << 2);
}

// the descriptor of a K-major operand `bytes` past the one of `base` (both
// in the same 256 KB of shared memory): its address field counts 16-byte
// units. One base descriptor a slab and immediate offsets keep ptxas from
// holding every product's 64-bit descriptor in registers.
__device__ __forceinline__ uint64_t desc_at(uint64_t base, int bytes) {
  return base + static_cast<uint64_t>(bytes >> 4);
}

__device__ __forceinline__ void consumers_sync() {
  ht::bar_sync(BAR_ID, CONSUMERS);
}

// acc (+)= A B^T in 3xTF32 over 64 columns: the two small products first,
// then hi.hi; accumulate = 0 starts d afresh
__device__ __forceinline__ void mma3(float (&d)[32], const uint32_t (&hi)[4],
                                     const uint32_t (&lo)[4], uint64_t dbh,
                                     uint64_t dbl, int accumulate = 1) {
  ht::wgmma_rs_tf32_n64(d, lo, dbh, accumulate);
  ht::wgmma_rs_tf32_n64(d, hi, dbl, 1);
  ht::wgmma_rs_tf32_n64(d, hi, dbh, 1);
}

// One 32-deep slab of the score tile: acc[v][b] += W[v, k] f[b, k] over
// the slab's depth, for the consumer's 64 class rows (wrow = its row of
// the slab for a[0], t = lane % 4) and the NB rows of f whose hi and lo
// slabs are fh and fl. Returns with the products done.
//
// The tensor cores add each product into their fp32 accumulator with the
// addends' bits below its last place dropped, not rounded: over a long
// sum that error has one sign and grows with the number of additions
// (over D = 512, at scale 16, it moved p = exp(16 s - m) by half of the
// backward's gate).
// So the products of KG k8 steps (3 each) go into a fresh accumulator, 64
// batch columns at a time (32 registers), which is then added into acc by
// the CUDA cores, rounding to nearest. Each such group ends in a wait for
// the tensor cores, and fewer, larger groups run faster: KG is 4 (the
// whole slab) where the registers allow, 2 beside 128 more live ones
// (acc at NB = 256, df's accumulators). (Issuing a group's products
// before waiting for the previous group's, with two parts and two A
// halves live, read slower.)
template <int NB, int KG = 2>
__device__ __forceinline__ void score_slab(float (&acc)[NB / 2],
                                           const unsigned char* wslab,
                                           const unsigned char* fh,
                                           const unsigned char* fl, int wrow,
                                           int t) {
#pragma unroll
  for (int k0 = 0; k0 < 4; k0 += KG) {
    uint32_t hi[KG][4], lo[KG][4];
#pragma unroll
    for (int kk = 0; kk < KG; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float x = *reinterpret_cast<const float*>(wslab + swz(
            wrow + (r & 1) * 8, 8 * (k0 + kk) + t + (r >> 1) * 4));
        ht::split_tf32(x, hi[kk][r], lo[kk][r]);
      }
    const uint64_t dfh = ht::desc_k(fh, 0), dfl = ht::desc_k(fl, 0);
#pragma unroll
    for (int q = 0; q < NB / 64; ++q) {     // f rows 64q .. 64q + 63
      float part[32];       // set by the first product: no zeros held
      ht::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KG; ++kk)
        mma3(part, hi[kk], lo[kk],
             desc_at(dfh, q * 64 * 128 + 32 * (k0 + kk)),
             desc_at(dfl, q * 64 * 128 + 32 * (k0 + kk)), kk > 0);
      ht::wgmma_commit();
      ht::wgmma_wait<0>();
      ht::fence_regs(part);
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[32 * q + i] += part[i];
    }
    ht::fence_regs(hi);     // the products read them until the last wait
    ht::fence_regs(lo);
  }
}

// the consumer's part of a ring stage is read: its warp's arrival
__device__ __forceinline__ void release(uint64_t* empty, int lane) {
  __syncwarp();
  if (lane == 0) ht::mbar_arrive(empty);
}

// ring stage `it` of `stages`: (slot, parity of its phase)
__device__ __forceinline__ int slot(int it, int stages) { return it % stages; }
__device__ __forceinline__ int phase(int it, int stages) {
  return (it / stages) & 1;
}

// The backward's dl for score s of class v and batch column b (its row
// statistics mb, gzb, gcb, yb): (p gz + [v == y] gc) scale, p = exp(s scale
// - m) where v < limit and m is finite, else 0; the one-hot is not masked.
// Columns past B carry m = -inf, gz = gc = 0 and y = -1, so give 0.
__device__ __forceinline__ float dl_of(float s, int v, int lim, float mb,
                                       float gzb, float gcb, int yb,
                                       float scale) {
  const float p = (v < lim && mb != -INFINITY) ? __expf(s * scale - mb) : 0.f;
  return (p * gzb + (v == yb ? gcb : 0.f)) * scale;
}

// f's hi and lo halves for the B operands: hi = tf32(x), lo = tf32(x - hi)
__global__ void split_rows(const float* __restrict__ f, int n,
                           float* __restrict__ hi, float* __restrict__ lo) {
  const int i = blockIdx.x * 256 + threadIdx.x;
  if (i >= n) return;
  uint32_t h, l;
  ht::split_tf32(f[i], h, l);
  hi[i] = __uint_as_float(h);
  lo[i] = __uint_as_float(l);
}

}  // namespace ce_hopper
