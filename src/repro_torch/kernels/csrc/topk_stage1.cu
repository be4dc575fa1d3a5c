// Stage 1 of divide-and-conquer top-k on Hopper (sm_90a): per-chunk top-k
// by radix select, in one pass over the data whatever k is.
//
// Replaces: src/repro/kernels/topk_dc.py, stage1_topk / _stage1_kernel (the
// Pallas TPU kernel). Input x [n_outer, ld] fp32; each outer row is cut into
// nch chunks of `chunk` columns (the last one ragged: columns >= n read as
// -inf, in the kernel, instead of a padded copy). For each chunk it writes k
// (value, in-chunk index) pairs, values descending, ties to the lowest
// index: the TPU kernel's k max-extraction sweeps, where each sweep takes
// the first maximum and overwrites it with -inf. Once a chunk's values
// above -inf run out, every slot of the TPU kernel's row holds -inf, so its
// argmax returns index 0 for each remaining sweep; the kernel writes
// (-inf, 0) there.
//
// Bound on an H100 SXM at the serving shapes (top-5 over [64, 1,020,250]
// logits: 31,936 chunks of 2,048): the logits are read once, 0.26 GB, about
// 78 us at 3.35 TB/s; the selection is a few integer operations an element.
// Bound by bytes, and by nothing that grows with k: DGC's stage 1 asks for
// k = 1,048 of every 2,048-wide chunk, which k sweeps could not afford.
//
// Design. One warp a chunk, in shared memory:
//   - the chunk's 16-byte-aligned body arrives by one 1-D bulk copy (TMA)
//     completing on the warp's mbarrier, and the <= 3 columns before and
//     after it by the lanes, so rows that start off a 16-byte boundary
//     (every odd row of [64, 1,020,250]) need no padded copy;
//   - each value becomes an order-preserving uint32 key in place (-0 ranks
//     with +0, NaN above everything, as argmax takes a NaN first);
//   - for k <= 32 (top-k serving): at least k values reach the k-th
//     largest of the 32 lanes' maxima, and where no more than 64 do
//     (random data: about k), they are the survivors, found by one float
//     comparison a value; otherwise the radix select below runs, as for
//     any k;
//   - radix select finds the k-th largest key, 8 bits a pass from the top:
//     each lane counts its own keys in a counter of its own a bin (no
//     atomics, no two lanes on one counter, so skewed data costs no more
//     than spread data; four keys' counters are read before any is
//     written, a quarter of the read-add-write chains), the warp sums the bins
//     and picks the one where the count from the top reaches k. Integer
//     counts: exact and deterministic. It stops early once the keys above
//     the bin and those in it fit the sort buffer;
//   - the keys above the bin and those in it (after the last pass: the
//     first `kr` of them in column order) are gathered in column order,
//     skipping 128 columns at a time where no lane holds one, and sorted by
//     (key desc, column asc): 64 or fewer in registers, more by a bitonic
//     sort in shared memory;
//   - the values are read back from x at the sorted columns.
// Loops are unrolled 2 to 4 deep and no further: the whole kernel stays
// small enough for the instruction caches of the SM's resident warps.
//
// Requires 1 <= k <= chunk and buffers that fit shared memory
// (topk_stage1_smem, checked by the wrapper): 16 + 4 (chunk + 4) rounded
// up to 16, + max(8 KB (16 KB past 8,160 columns), 8 max(64,
// 2^ceil(log2 min(k, chunk)))) bytes, e.g. 16,416 bytes for chunk 2,048 at
// k = 5 and 24,608 at k = 1,048. Any row stride and alignment.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper_tiles.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr uint32_t KEY_NEG_INF = 0x007fffffu;   // key of -inf
constexpr int MIN_SORT = 64;
constexpr int MAX_SMEM = 232448;                // 227 KB a block

__host__ __device__ inline int keys_bytes(int chunk) {
  return ((chunk + 4) * 4 + 15) & ~15;
}
// one counter a (bin, lane): a byte while a lane has < 256 columns
__host__ __device__ inline int counter_size(int chunk) {
  return (chunk + 31) / 32 < 256 ? 1 : 2;
}
__host__ __device__ inline int sort_cap(int chunk, int k) {
  const int m = k < chunk ? k : chunk;
  int s = MIN_SORT;
  while (s < m) s <<= 1;
  return s;
}
__host__ __device__ inline int region_bytes(int chunk, int k) {
  const int cnt = 256 * 32 * counter_size(chunk);
  const int srt = 8 * sort_cap(chunk, k);
  return 16 + keys_bytes(chunk) + (cnt > srt ? cnt : srt);
}

__device__ __forceinline__ uint32_t key_of(float v) {
  const uint32_t u = v == 0.f ? 0u : __float_as_uint(v);
  const uint32_t key = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return v != v ? 0xffffffffu : key;
}

// counts of bin b: the 32 lanes' counters, 32 (or 64) contiguous bytes
__device__ __forceinline__ uint32_t bin_total(const uint8_t* cnt, int b) {
  const uint4* p = reinterpret_cast<const uint4*>(cnt + b * 32);
  const uint4 v0 = p[0], v1 = p[1];
  uint32_t s = __dp4a(v0.x, 0x01010101u, 0u);
  s = __dp4a(v0.y, 0x01010101u, s);
  s = __dp4a(v0.z, 0x01010101u, s);
  s = __dp4a(v0.w, 0x01010101u, s);
  s = __dp4a(v1.x, 0x01010101u, s);
  s = __dp4a(v1.y, 0x01010101u, s);
  s = __dp4a(v1.z, 0x01010101u, s);
  return __dp4a(v1.w, 0x01010101u, s);
}
__device__ __forceinline__ uint32_t bin_total(const uint16_t* cnt, int b) {
  const uint4* p = reinterpret_cast<const uint4*>(cnt + b * 32);
  uint32_t s = 0;
#pragma unroll
  for (int h = 0; h < 4; ++h) {
    const uint4 v = p[h];
    s += (v.x & 0xffffu) + (v.x >> 16) + (v.y & 0xffffu) + (v.y >> 16) +
         (v.z & 0xffffu) + (v.z >> 16) + (v.w & 0xffffu) + (v.w >> 16);
  }
  return s;
}

// The bin where the count from the top reaches kr: lane l sums bins l +
// 32 j, the warp finds j, then the lane. Returns the bin; kr becomes the
// rank left inside it and in_bin the bin's count.
template <typename CNT>
__device__ __forceinline__ int find_bin(const CNT* cnt, int& kr, int& in_bin,
                                        int lane) {
  uint32_t c[8], g[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) c[j] = bin_total(cnt, lane + 32 * j);
#pragma unroll
  for (int j = 0; j < 8; ++j) g[j] = __reduce_add_sync(FULL, c[j]);
  int above = 0, js = 0;           // above: the count in groups above js
  uint32_t cj = 0;
  bool found = false;
#pragma unroll
  for (int j = 7; j >= 0; --j) {   // from the top bins down
    if (!found) {
      if (above + (int)g[j] >= kr) {
        found = true;
        js = j;
        cj = c[j];
      } else {
        above += (int)g[j];
      }
    }
  }
  uint32_t incl = cj;              // sum over lanes >= lane of group js
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const uint32_t t = __shfl_down_sync(FULL, incl, off);
    if (lane + off < 32) incl += t;
  }
  const int above_me = above + (int)(incl - cj);
  const bool mine = above_me < kr && above_me + (int)cj >= kr;
  const int src = __ffs(__ballot_sync(FULL, mine)) - 1;
  kr = __shfl_sync(FULL, kr - above_me, src);
  in_bin = __shfl_sync(FULL, (int)cj, src);
  return src + 32 * js;
}

template <typename CNT>
__device__ __forceinline__ void clear(CNT* cnt, int lane) {
  uint4* c4 = reinterpret_cast<uint4*>(cnt);
  const int n = 256 * 32 * (int)sizeof(CNT) / 16;
#pragma unroll 4
  for (int i = lane; i < n; i += 32) c4[i] = make_uint4(0, 0, 0, 0);
}

// Count the lane's keys kb[lane + 32 i] whose bits under `mask` are
// `prefix` in its counters of their next 8 bits (mine[32 d]). Four keys at
// a time: their four counters are read before any is written, and a bin
// that several of them share is written once, so a pass is a quarter as
// many read-add-write chains as keys. The keys and the counters do not
// overlap.
template <typename CNT>
__device__ __forceinline__ void count_pass(const uint32_t* __restrict__ kb,
                                           CNT* __restrict__ mine,
                                           int chunk, uint32_t mask,
                                           uint32_t prefix, int shift,
                                           int lane) {
  for (int i = lane; i < chunk; i += 128) {
    int d[4];
    bool a[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = i + 32 * u;
      const uint32_t key = j < chunk ? kb[j] : 0u;
      a[u] = j < chunk && (key & mask) == prefix;
      d[u] = a[u] ? (int)((key >> shift) & 0xffu) * 32 : -1 - u;
    }
    if (!(a[0] | a[1] | a[2] | a[3])) continue;
    CNT c[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) c[u] = a[u] ? mine[d[u]] : 0;
    // inactive keys carry distinct negative bins: they match nothing
    const int n0 = 1 + (d[1] == d[0]) + (d[2] == d[0]) + (d[3] == d[0]);
    const int n1 = 1 + (d[2] == d[1]) + (d[3] == d[1]);
    const int n2 = 1 + (d[3] == d[2]);
    if (a[0]) mine[d[0]] = c[0] + n0;
    if (a[1] && d[1] != d[0]) mine[d[1]] = c[1] + n1;
    if (a[2] && d[2] != d[0] && d[2] != d[1]) mine[d[2]] = c[2] + n2;
    if (a[3] && d[3] != d[0] && d[3] != d[1] && d[3] != d[2])
      mine[d[3]] = c[3] + 1;
  }
}

// Bitonic sort, descending, of 32 entries held one a lane, in registers.
__device__ __forceinline__ void sort32(uint64_t& e, int lane) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const uint64_t o = __shfl_xor_sync(FULL, e, stride);
      const bool keep_max = ((lane & stride) == 0) == ((lane & size) == 0);
      e = keep_max ? (e > o ? e : o) : (e > o ? o : e);
    }
  }
}

// Bitonic sort, descending, of 64 entries held two a lane (entry l in e0
// and l + 32 in e1 of lane l), in registers.
__device__ __forceinline__ void sort64(uint64_t& e0, uint64_t& e1, int lane) {
#pragma unroll
  for (int size = 2; size <= 64; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      if (stride == 32) {            // entries l and l + 32: one lane's pair
        const uint64_t hi = e0 > e1 ? e0 : e1, lo = e0 > e1 ? e1 : e0;
        e0 = hi;                     // size 64: every block descending
        e1 = lo;
        continue;
      }
      const bool lower = (lane & stride) == 0;
      const uint64_t o0 = __shfl_xor_sync(FULL, e0, stride);
      const uint64_t o1 = __shfl_xor_sync(FULL, e1, stride);
      // entry l + 32 r lies in a descending block if its bit `size` is 0
      const bool k0 = lower == ((lane & size) == 0);
      const bool k1 = lower == (((lane + 32) & size) == 0);
      e0 = k0 ? (e0 > o0 ? e0 : o0) : (e0 > o0 ? o0 : e0);
      e1 = k1 ? (e1 > o1 ? e1 : o1) : (e1 > o1 ? o1 : e1);
    }
  }
}

// 64 or fewer survivors (sbuf[0 .. nsel)), sorted in registers (32 or
// fewer: one a lane); lane l writes entries l and l + 32 of the chunk's k,
// (-inf, 0) past keff.
__device__ __forceinline__ void write_sorted(const uint64_t* sbuf, int nsel,
                                             int keff, int k,
                                             const float* src, float* vals,
                                             int* idx, int row, int lane) {
  uint64_t e0 = lane < nsel ? sbuf[lane] : 0;
  uint64_t e1 = lane + 32 < nsel ? sbuf[lane + 32] : 0;
  if (nsel > 32)
    sort64(e0, e1, lane);
  else if (nsel > 1)
    sort32(e0, lane);
  for (int j = lane; j < k; j += 32) {
    const uint64_t e = j < 32 ? e0 : e1;
    const int col = j < keff ? (int)~(uint32_t)e : 0;
    vals[(size_t)row * k + j] = j < keff ? __ldg(src + col) : -INFINITY;
    idx[(size_t)row * k + j] = col;
  }
}

template <typename CNT>
__global__ void __launch_bounds__(64)
topk_stage1(const float* __restrict__ x, int n_outer, int ld, int n,
            int chunk, int nch, int k, float* __restrict__ vals,
            int* __restrict__ idx) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row = blockIdx.x * (blockDim.x >> 5) + warp;
  if (row >= n_outer * nch) return;        // the whole warp leaves together
  const int b = row / nch, c = row - b * nch;
  const float* src = x + (size_t)b * ld + (size_t)c * chunk;
  const int valid = min(chunk, n - c * chunk);
  const unsigned lt = (1u << lane) - 1;
  const int scap = sort_cap(chunk, k);

  unsigned char* base = smem + (size_t)warp * region_bytes(chunk, k);
  uint64_t* bar = reinterpret_cast<uint64_t*>(base);
  uint32_t* buf = reinterpret_cast<uint32_t*>(base + 16);
  CNT* cnt = reinterpret_cast<CNT*>(base + 16 + keys_bytes(chunk));
  CNT* mine = cnt + lane;                  // my counter of bin d: mine[32 d]
  uint64_t* sbuf = reinterpret_cast<uint64_t*>(cnt);   // after the passes

  // -- the chunk: its 16-byte-aligned body by one bulk copy, the rest by
  //    the lanes; column i lands at kb[i], kb + h 16-byte aligned ---------
  const int h = min(valid, (int)(((16u - (reinterpret_cast<uintptr_t>(src) &
                                          15u)) & 15u) >> 2));
  const int body = ((valid - h) >> 2) << 2;
  uint32_t* kb = buf + ((4 - h) & 3);
  if (lane == 0 && body > 0) {
    hopper::mbar_init(bar, 1);
    hopper::mbar_init_fence();
    hopper::mbar_expect_tx(bar, body * 4);
    hopper::bulk_load(kb + h, src + h, body * 4, bar);
  }
  const int tail = h + body;
  if (lane < h) kb[lane] = __float_as_uint(__ldg(src + lane));
  if (lane >= 4 && lane - 4 < valid - tail)
    kb[tail + lane - 4] = __float_as_uint(__ldg(src + tail + lane - 4));
  __syncwarp();
  if (body > 0) hopper::mbar_wait(bar, 0);

  // -- k <= 32 (top-k serving): at least keff values reach the keff-th
  //    largest of the 32 lanes' maxima; if no more than 64 do (random
  //    data: about keff), they are the survivors, found by one comparison
  //    a value, on the floats as they came. Otherwise (ties, the top values
  //    crowded into few lanes, NaNs) the radix select below decides -------
  if (k <= 32) {
    const float* kf = reinterpret_cast<const float*>(kb);
    int nreal = 0;
    float top = -INFINITY;                 // the lane's largest value
    bool nan = false;
#pragma unroll 4
    for (int i = lane; i < valid; i += 32) {
      const float v = kf[i];
      nreal += v > -INFINITY;
      top = fmaxf(top, v);
      nan |= v != v;
    }
    nreal = __reduce_add_sync(FULL, nreal);
    const int keff = min(k, nreal);
    if (keff == 0 && !__any_sync(FULL, nan)) {
      write_sorted(nullptr, 0, 0, k, src, vals, idx, row, lane);
      return;
    }
    if (!__any_sync(FULL, nan)) {
#pragma unroll
      for (int size = 2; size <= 32; size <<= 1) {   // the maxima, sorted
#pragma unroll
        for (int stride = size >> 1; stride > 0; stride >>= 1) {
          const float o = __shfl_xor_sync(FULL, top, stride);
          const bool keep_max =
              ((lane & stride) == 0) == ((lane & size) == 0);
          top = keep_max ? fmaxf(top, o) : fminf(top, o);
        }
      }
      const float t0 = __shfl_sync(FULL, top, keff - 1);
      int nsel = 0;              // survivors go to the counters' first
                                 // 512 bytes, not yet counted into
      for (int i0 = 0; i0 < valid && nsel <= 64; i0 += 128) {
        float v[4];
        bool in[4], any = false;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int i = i0 + 32 * u + lane;
          v[u] = i < valid ? kf[i] : -INFINITY;
          in[u] = v[u] >= t0 && v[u] > -INFINITY;
          any |= in[u];
        }
        if (!__any_sync(FULL, any)) continue;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const unsigned tb = __ballot_sync(FULL, in[u]);
          const int at = nsel + __popc(tb & lt);
          if (in[u] && at < 64)
            sbuf[at] = ((uint64_t)key_of(v[u]) << 32) |
                        (uint32_t)~(uint32_t)(i0 + 32 * u + lane);
          nsel += __popc(tb);
        }
      }
      __syncwarp();
      if (nsel <= 64) {
        write_sorted(sbuf, nsel, keff, k, src, vals, idx, row, lane);
        return;
      }
    }
  }

  // -- keys in place, the count of values above -inf (columns past the
  //    chunk's valid ones hold key 0: below everything) -------------------
  int nreal = 0;
#pragma unroll 4
  for (int i = lane; i < chunk; i += 32) {
    const uint32_t key = i < valid ? key_of(__uint_as_float(kb[i])) : 0u;
    kb[i] = key;
    nreal += key > KEY_NEG_INF;
  }
  nreal = __reduce_add_sync(FULL, nreal);
  const int keff = min(k, nreal);
  __syncwarp();
  clear(cnt, lane);
  __syncwarp();
  count_pass(kb, mine, chunk, 0u, 0u, 24, lane);

  // -- radix select: prefix / mask are the k-th key's bits found so far ----
  uint32_t prefix = 0, mask = 0;
  int kr = keff, limit = 0;
  for (int shift = 24; keff > 0; shift -= 8) {
    if (shift < 24) {
      clear(cnt, lane);
      __syncwarp();
      count_pass(kb, mine, chunk, mask, prefix, shift, lane);
    }
    __syncwarp();
    int in_bin;
    const int bin = find_bin(cnt, kr, in_bin, lane);
    __syncwarp();                  // counters read: free to clear or reuse
    prefix |= (uint32_t)bin << shift;
    mask |= 0xffu << shift;
    if (shift == 0) {              // the k-th key itself: kr of its ties
      limit = kr;
      break;
    }
    if (keff - kr + in_bin <= scap) {   // the whole bin fits: sort it
      limit = in_bin;
      break;
    }
  }

  // -- gather the keys above the bin and `limit` of those in it, in column
  //    order; 128 columns at a time, skipped where no lane holds one ------
  int nsel = 0, run_eq = 0;
  if (keff > 0) {
    for (int i0 = 0; i0 < chunk; i0 += 128) {
      uint32_t key[4];
      bool in[4];
      bool any = false;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + 32 * u + lane;
        key[u] = i < chunk ? kb[i] : 0u;
        in[u] = key[u] != 0u && (key[u] & mask) >= prefix;
        any |= in[u];
      }
      if (!__any_sync(FULL, any)) continue;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const bool eq = in[u] && (key[u] & mask) == prefix;
        const unsigned eb = __ballot_sync(FULL, eq);
        const bool take =
            (in[u] && !eq) || (eq && run_eq + __popc(eb & lt) < limit);
        run_eq += __popc(eb);
        const unsigned tb = __ballot_sync(FULL, take);
        if (take)
          sbuf[nsel + __popc(tb & lt)] =
              ((uint64_t)key[u] << 32) |
              (uint32_t)~(uint32_t)(i0 + 32 * u + lane);
        nsel += __popc(tb);
      }
    }
  }
  __syncwarp();

  if (nsel <= 64) {
    write_sorted(sbuf, nsel, keff, k, src, vals, idx, row, lane);
    return;
  }

  // -- more: bitonic sort in shared memory, descending, 4 independent pairs
  //    a lane at a time ------------------------------------------------------
  int np = 64;
  while (np < nsel) np <<= 1;
  for (int i = nsel + lane; i < np; i += 32) sbuf[i] = 0;
  __syncwarp();
  for (int size = 2; size <= np; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t0 = lane; t0 < np / 2; t0 += 128) {
        uint64_t a[4], bb[4];
        int lo[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int t = t0 + 32 * u;
          lo[u] = 2 * t - (t & (stride - 1));
          if (t < np / 2) {
            a[u] = sbuf[lo[u]];
            bb[u] = sbuf[lo[u] + stride];
          }
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (t0 + 32 * u < np / 2 &&
              (a[u] < bb[u]) == ((lo[u] & size) == 0)) {
            sbuf[lo[u]] = bb[u];
            sbuf[lo[u] + stride] = a[u];
          }
        }
      }
      __syncwarp();
    }
  }
  for (int j = lane; j < k; j += 32) {
    float v = -INFINITY;
    int col = 0;
    if (j < keff) {
      col = (int)~(uint32_t)sbuf[j];
      v = __ldg(src + col);
    }
    vals[(size_t)row * k + j] = v;
    idx[(size_t)row * k + j] = col;
  }
}

template <typename CNT>
int launch(const float* x, int n_outer, int ld, int n, int chunk, int nch,
           int k, float* vals, int* idx, cudaStream_t st) {
  const int region = region_bytes(chunk, k);
  const int warps = 2 * region <= MAX_SMEM ? 2 : 1;
  const int bytes = warps * region;
  cudaError_t e = cudaFuncSetAttribute(
      topk_stage1<CNT>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int rows = n_outer * nch;
  topk_stage1<CNT><<<(rows + warps - 1) / warps, warps * 32, bytes, st>>>(
      x, n_outer, ld, n, chunk, nch, k, vals, idx);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// shared memory a chunk's warp needs (the wrapper's limit on chunk and k)
extern "C" int topk_stage1_smem(int chunk, int k) {
  return region_bytes(chunk, k);
}

extern "C" int topk_stage1_launch(const void* x, int n_outer, int ld, int n,
                                  int chunk, int k, void* vals, void* idx,
                                  void* stream) {
  if (chunk < 1 || k < 1 || k > chunk || n < 1 || n_outer < 1 ||
      region_bytes(chunk, k) > MAX_SMEM)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nch = (n + chunk - 1) / chunk;
  if ((long long)n_outer * nch > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const float* xp = static_cast<const float*>(x);
  float* vp = static_cast<float*>(vals);
  int* ip = static_cast<int*>(idx);
  if (counter_size(chunk) == 1)
    return launch<uint8_t>(xp, n_outer, ld, n, chunk, nch, k, vp, ip, st);
  return launch<uint16_t>(xp, n_outer, ld, n, chunk, nch, k, vp, ip, st);
}
