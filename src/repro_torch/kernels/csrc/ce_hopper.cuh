// The 3xTF32 score tile shared by the dense CE kernels (ce_softmax_fwd.cu,
// ce_softmax_bwd.cu) and the sparse ones (sparse_ce_fwd.cu,
// sparse_ce_bwd.cu), so that each forward and its backward compute
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
// with W's A fragments loaded from the fp32 slab and split into
// hi = tf32(x), lo = tf32(x - hi) in registers (no shared-memory pass),
// and f's hi and lo made once per call by split_rows into two [B, D]
// arrays that TMA streams as the B operands. The split keeps |x - hi - lo|
// <= 2^-22 |x|, and the dropped lo.lo term is below 2^-22 |W f| per
// product: fp32-level accuracy from three products at the TF32 rate.
//
// Blocks are three warpgroups: warpgroup 0 the producer (it gives up
// registers), 1 and 2 the consumers, claiming what the producer frees.
// The dense kernels' W slabs are TMA boxes, issued by one producer thread.
// The sparse kernels' slabs are rows of W gathered by id, which a TMA box
// cannot do (Hopper has no TMA gather): since W is the register A operand,
// read by the consumers' own shared-memory loads, its slab layout belongs
// to the kernel and not to wgmma, so the producer warpgroup's 128 threads
// fill it with cp.async 16-byte copies, each chunk at the address the
// 128-byte swizzle gives it (gather_slab), and arrive on the stage's full
// barrier when their copies land; only f's halves, read by wgmma through a
// descriptor, stay TMA boxes. (One thread issuing 128 one-row bulk copies
// into an unswizzled slab would need padding against bank conflicts on the
// A loads, and serialise the row addresses on one thread.)
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

// ---------------------------------------------------------------------------
// shared by the forwards and the backwards
// ---------------------------------------------------------------------------

// Fold (m2, z2, a2) into (m, z, a). Ties on the max keep the lower column.
__device__ __forceinline__ void merge_stat(float& m, float& z, int& a,
                                           float m2, float z2, int a2) {
  float mn = fmaxf(m, m2);
  if (mn == -INFINITY) return;             // both empty: z = 0, a = -1 stay
  float s1 = (m == -INFINITY) ? 0.f : expf(m - mn);
  float s2 = (m2 == -INFINITY) ? 0.f : expf(m2 - mn);
  z = z * s1 + z2 * s2;
  if (m2 > m || (m2 == m && a2 < a)) a = a2;
  m = mn;
}

// The backwards' df kernels: 64 batch rows a block, dl's TF32 halves in
// shared memory as [64 b x 32 v] slabs.
constexpr int DF_BT = 64;
constexpr int DL_SLAB = ht::slab_bytes(DF_BT);

// One 64-feature block of df^T += W^T dl^T over a tile's 128 classes (or
// gathered columns): A is W^T, loaded transposed from the stage's two W
// slabs (features 0..31 and 32..63 of the block) and split in registers; B
// is dl's halves (ddh, ddl). The tile's share goes into a fresh
// accumulator that the CUDA cores add into dacc (score_slab says why: the
// tensor cores' sums drop bits, which over a segment's ~30,000 additions
// read 1e-4). The k loop is not unrolled: the kernel's code stays small
// enough for the instruction cache.
__device__ __forceinline__ void df_block(float (&dacc)[32],
                                         const unsigned char* src,
                                         uint64_t ddh, uint64_t ddl,
                                         const int (&aoff)[4]) {
  float part[32];                    // set by the first product
#pragma unroll 1
  for (int k0 = 0; k0 < 16; k0 += 4) {
    uint32_t hi[4][4], lo[4][4];
    const unsigned char* rows = src + 1024 * k0;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float x = *reinterpret_cast<const float*>(rows + aoff[r] +
                                                        1024 * kk);
        ht::split_tf32(x, hi[kk][r], lo[kk][r]);
      }
    ht::fence_regs(part);
    ht::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      mma3(part, hi[kk], lo[kk], desc_at(ddh, (k0 >> 2) * DL_SLAB + 32 * kk),
           desc_at(ddl, (k0 >> 2) * DL_SLAB + 32 * kk), k0 + kk > 0);
    ht::wgmma_commit();
    ht::wgmma_wait<0>();
    ht::fence_regs(part);
    ht::fence_regs(hi);
    ht::fence_regs(lo);
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) dacc[i] += part[i];
}

// df[e] = sum over segments s, in order, of pdf[s][e]: one thread per
// element, 256 a block.
__global__ void __launch_bounds__(256)
sum_segments(const float* __restrict__ pdf, int n_elems, int n_segs,
             float* __restrict__ df) {
  const int e = blockIdx.x * 256 + threadIdx.x;
  if (e >= n_elems) return;
  float s = 0.f;
  for (int q = 0; q < n_segs; ++q) s += pdf[(size_t)q * n_elems + e];
  df[e] = s;
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

// f^T's TF32 halves, [D, Bp] with Bp = B rounded up to 8: position k of an
// 8-column group holds batch row 2k (k < 4) or 2(k - 4) + 1 of the group,
// the order in which dl's accumulators serve as A fragments; rows past B
// are zero
__global__ void split_cols(const float* __restrict__ f, int B, int D, int Bp,
                           float* __restrict__ hi, float* __restrict__ lo) {
  const int i = blockIdx.x * 256 + threadIdx.x;
  if (i >= D * Bp) return;
  const int d = i / Bp, k = i % Bp, o = k & 7;
  const int b = (k & ~7) + (o < 4 ? 2 * o : 2 * (o - 4) + 1);
  uint32_t h, l;
  ht::split_tf32(b < B ? f[(size_t)b * D + d] : 0.f, h, l);
  hi[i] = __uint_as_float(h);
  lo[i] = __uint_as_float(l);
}

// ---------------------------------------------------------------------------
// the sparse kernels: columns are rows of W gathered by id
// ---------------------------------------------------------------------------

// a tile's per-column side data in shared memory: gids, bias, valid [VT]
constexpr int SIDE_BYTES = 3 * VT * 4;
// full barriers of a gathered ring: the 128 producer threads' cp.async
// arrivals and producer thread 0's (with f's TMA bytes, where a stage has
// them)
constexpr int GATHER_ARRIVALS = WG_THREADS + 1;

// named barrier of the producer warpgroup (the consumers' is BAR_ID)
constexpr int PRODUCER_BAR_ID = 2;
// a gathering producer's row tables: two tiles' W row ids, alternately
constexpr int ROW_TABLE_BYTES = 2 * VT * 4;

// The producer warpgroup's table of the W rows of a tile of 128 columns
// from a0 (-1 past the A columns), thread p writing entry p. The table
// alternates between two buffers from tile to tile: a thread writes one
// only after every thread has passed the barrier that follows the other.
// (Row ids kept in registers instead let ptxas hoist eight 64-bit row
// addresses, which spilled at the producer's 40 registers.)
__device__ __forceinline__ void tile_rows(int* rows, const int* ids, int a0,
                                          int A, int p) {
  const int a = a0 + p;
  rows[p] = a < A ? ids[a] : -1;
  ht::bar_sync(PRODUCER_BAR_ID, WG_THREADS);
}

// Producer thread p's copies of one 32-deep W slab of a gathered tile:
// features k0 .. k0 + 31 of the table's rows (zeros past D and for row
// -1), chunk p % 8 of rows p / 8 + 16 i, i < 8, each at its swizzled place
// (swz). Eight neighbouring threads read one 128-byte run of a row.
__device__ __forceinline__ void gather_slab(unsigned char* slab,
                                            const float* w, const int* rows,
                                            int k0, int D, int p) {
  const int c = p & 7, k = k0 + 4 * c;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = (p >> 3) + 16 * i, id = rows[r];
    const bool in = id >= 0 && k < D;
    ht::cp_async_16(slab + r * 128 + (((c ^ r) & 7) << 4),
                    in ? w + (size_t)id * D + k : w, in ? 16 : 0);
  }
}

// Producer thread p's copies of column a0 + p's side data (zeros, so not
// valid, past A).
__device__ __forceinline__ void gather_side(unsigned char* side,
                                            const int* gids, const float* bias,
                                            const int* valid, int a0, int A,
                                            int p) {
  const int a = a0 + p, n = a < A ? 4 : 0, q = a < A ? a : 0;
  ht::cp_async_4(side + 4 * p, gids + q, n);
  ht::cp_async_4(side + 4 * (VT + p), bias + q, n);
  ht::cp_async_4(side + 4 * (2 * VT + p), valid + q, n);
}

struct Col {          // a gathered column's side data
  int gid;
  float bias;
  bool ok;            // valid (and within A)
};

__device__ __forceinline__ Col col_at(const unsigned char* side, int r) {
  const int* s = reinterpret_cast<const int*>(side);
  return {s[r], __int_as_float(s[VT + r]), s[2 * VT + r] != 0};
}

// The score of a gathered column: scale <f, W[ids[j]]> + bias[j], as one
// FMA in the forward and the backward alike.
__device__ __forceinline__ float col_score(float acc, float scale,
                                           const Col& c) {
  return __fmaf_rn(acc, scale, c.bias);
}

// The sparse backward's dl for column j (side data c) and a batch row with
// statistics mb, gzb, gcb, its label yb and first-hit column hb:
// (p gz + [j == hb] gc) scale, p = exp(s - m) where the column is kept
// (valid, and with mask_hits not a hit of the row's label), else 0. The
// caller hands in mb = +inf where m is not finite (so p = 0 there) and yb
// = INT_MIN without mask_hits (no gid matches it): no branch, which keeps
// the unrolled dl loops of the backward inside their registers. Rows past
// B carry gz = gc = 0 and hb = -1, so give 0.
__device__ __forceinline__ float sparse_dl(float acc, int j, const Col& c,
                                           float mb, float gzb, float gcb,
                                           int yb, int hb, float scale) {
  const float e = __expf(col_score(acc, scale, c) - mb);
  const float p = (c.ok && c.gid != yb) ? e : 0.f;
  return (p * gzb + (j == hb ? gcb : 0.f)) * scale;
}

// the consumers' register claim when the producer warpgroup keeps
// `producer` registers (ptxas gives every thread LAUNCH_REGS)
__host__ __device__ constexpr int consumer_regs(int producer) {
  return (LAUNCH_REGS * THREADS - producer * WG_THREADS) / CONSUMERS / 8 * 8;
}

}  // namespace ce_hopper
