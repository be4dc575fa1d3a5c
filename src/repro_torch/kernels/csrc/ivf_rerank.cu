// Fused gather + score + top-k over IVF candidate lists, on Hopper (sm_90a):
// the rerank of the IVF serving index.
//
// Replaces: src/repro/kernels/ivf_rerank.py, ivf_rerank / _rerank_kernel (the
// Pallas TPU kernel). For every query row b it scores the candidate rows
// cand[b, a] of the class shard w (a local row id, -1 marks a padding slot;
// ids past the shard are clipped into it, as the TPU kernel's gather is) by
// the fp32 dot product <f[b], w[cand[b, a]]>, and returns the k best as
// (value, row id) in the order (value descending, candidate position a
// ascending): the TPU kernel merges tile after tile into a running top-k,
// each sweep taking the first maximum of [running top-k ++ tile], so equal
// values go to the earlier slot of cand, not to the lower row id. Slots a
// row cannot fill with a real candidate come back as (-inf, -1). Neither the
// gathered [B, A, D] rows nor the [B, A] scores reach device memory.
//
// Bound on an H100 SXM at the serving shapes (B = 64 queries, A = 31 probed
// clusters x 1,263 slots = 39,153 candidates, D = 512, k = 5): 2·B·A·D =
// 2.57 GFLOP, 38 us at 67 TFLOP/s fp32, while the rows gathered query by
// query are 5.1 GB (1.53 ms at 3.35 TB/s) and the union of the rows that
// must be read at least once is most of the 2.09 GB shard. So it is bound
// by bytes, and the design streams whole 2 KB rows with 16-byte loads and
// keeps many rows in flight; reading each row once for all the queries
// that probe its cluster (cluster-major order) is later work.
//
// Design. The TPU kernel walks the candidate tiles of a query in order,
// carrying the top-k in its output block. Here the candidates of a query are
// cut into segments of SEG = 1,024 slots, one block of 8 warps per (segment,
// query), so the B = 64 serving batch gives about 2,500 blocks:
//   - each lane keeps its share of f[b] in registers (float4 j = lane + 32c);
//   - a warp takes R = 4 candidates at a time, loads their rows with
//     16-byte loads (a row is read by the warp as consecutive 512-byte runs),
//     forms each dot product from fmaf in a fixed order and sums it over the
//     lanes with an xor butterfly, which leaves the same bits on every lane;
//   - the warp's running top-k lives in registers, lane j holding slot j,
//     sorted under (value desc, position asc); a score enters only if it
//     comes before slot k-1, its rank is one ballot and the slots below it
//     move down by one shuffle. The order is total, so the result does not
//     depend on the order in which scores arrive;
//   - the block merges its 8 warps' lists in shared memory and writes the
//     segment's k (value, position) pairs to a partial buffer;
//   - a second launch merges each query's segments in segment order and
//     turns positions into row ids. No atomics: two runs give the same bits.
//
// Requires D % 4 == 0, D <= 1024, 16-byte aligned f and w, 1 <= k <= 32,
// B <= 65,535 (checked by the wrapper).

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int NT = 256;              // threads: 8 warps
constexpr int WARPS = NT / 32;
constexpr int SEG = 1024;            // candidate slots per block
constexpr int R = 4;                 // rows a warp has in flight

// (av, ap) comes before (bv, bp): larger value, then earlier position
__device__ __forceinline__ bool before(float av, int ap, float bv, int bp) {
  return av > bv || (av == bv && ap < bp);
}

// Put (v, p) into the warp's sorted slots (lane j holds slot j < k) if it
// comes before the last one. v and p are the same on every lane.
__device__ __forceinline__ bool insert(float& tv, int& tp, float v, int p,
                                       int k, int lane) {
  const float kv = __shfl_sync(FULL, tv, k - 1);
  const int kp = __shfl_sync(FULL, tp, k - 1);
  if (!before(v, p, kv, kp)) return false;
  const int rank =
      __popc(__ballot_sync(FULL, lane < k && before(tv, tp, v, p)));
  const float uv = __shfl_up_sync(FULL, tv, 1);
  const int up = __shfl_up_sync(FULL, tp, 1);
  if (lane == rank) {
    tv = v;
    tp = p;
  } else if (lane > rank && lane < k) {
    tv = uv;
    tp = up;
  }
  return true;
}

// Fold a sorted list of k (value, position) pairs, lane j holding pair j,
// into the warp's slots; stops at the first pair that does not enter.
__device__ __forceinline__ void merge_list(float& tv, int& tp, float v, int p,
                                           int k, int lane) {
  for (int j = 0; j < k; ++j) {
    const float vj = __shfl_sync(FULL, v, j);
    const int pj = __shfl_sync(FULL, p, j);
    if (!insert(tv, tp, vj, pj, k, lane)) break;
  }
}

template <int NCH>
__global__ void __launch_bounds__(NT)
rerank_partial(const float* __restrict__ f, const float* __restrict__ w,
               const int* __restrict__ cand, int V, int D4, int A, int nseg,
               int k, float* __restrict__ part_v, int* __restrict__ part_p) {
  __shared__ float sv[WARPS][32];
  __shared__ int sp[WARPS][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int seg = blockIdx.x, b = blockIdx.y;

  const float4* f4 = reinterpret_cast<const float4*>(f) + (size_t)b * D4;
  float4 fr[NCH];
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
    const int j = lane + 32 * c;
    fr[c] = j < D4 ? f4[j] : make_float4(0.f, 0.f, 0.f, 0.f);
  }

  const int* crow = cand + (size_t)b * A;
  const int a1 = min(A, (seg + 1) * SEG);
  float tv = -INFINITY;
  int tp = INT_MAX;

  for (int base = seg * SEG + warp * R; base < a1; base += WARPS * R) {
    // lanes 0..R-1 read the R ids, every lane gets them by shuffle
    const int mine = (lane < R && base + lane < a1) ? crow[base + lane] : -1;
    int id[R];
#pragma unroll
    for (int r = 0; r < R; ++r) id[r] = __shfl_sync(FULL, mine, r);

    float4 rv[R][NCH];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float4* w4 = reinterpret_cast<const float4*>(w) +
                         (size_t)min(max(id[r], 0), V - 1) * D4;
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        const int j = lane + 32 * c;
        rv[r][c] = (id[r] >= 0 && j < D4) ? __ldg(w4 + j)
                                          : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float s = 0.f;
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        s = fmaf(fr[c].x, rv[r][c].x, s);
        s = fmaf(fr[c].y, rv[r][c].y, s);
        s = fmaf(fr[c].z, rv[r][c].z, s);
        s = fmaf(fr[c].w, rv[r][c].w, s);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        s += __shfl_xor_sync(FULL, s, off);
      if (id[r] >= 0) insert(tv, tp, s, base + r, k, lane);
    }
  }

  // -- the block's 8 lists -> one, written as this segment's partial -------
  sv[warp][lane] = tv;
  sp[warp][lane] = tp;
  __syncthreads();
  if (warp != 0) return;
  for (int w2 = 1; w2 < WARPS; ++w2)
    merge_list(tv, tp, sv[w2][lane], sp[w2][lane], k, lane);
  if (lane < k) {
    const size_t o = ((size_t)b * nseg + seg) * k + lane;
    part_v[o] = tv;
    part_p[o] = tp;
  }
}

// One warp per query: its segments' lists in segment order -> top-k, and
// positions -> row ids (-1 where no real candidate filled the slot).
__global__ void __launch_bounds__(NT)
rerank_merge(const float* __restrict__ part_v, const int* __restrict__ part_p,
             const int* __restrict__ cand, int B, int A, int nseg, int k,
             float* __restrict__ vals, int* __restrict__ ids) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (b >= B) return;                  // the whole warp leaves together
  float tv = -INFINITY;
  int tp = INT_MAX;
  for (int s = 0; s < nseg; ++s) {
    const size_t o = ((size_t)b * nseg + s) * k;
    const float v = lane < k ? part_v[o + lane] : -INFINITY;
    const int p = lane < k ? part_p[o + lane] : INT_MAX;
    merge_list(tv, tp, v, p, k, lane);
  }
  if (lane < k) {
    const bool real = tp != INT_MAX && tv > -INFINITY;
    vals[(size_t)b * k + lane] = tv;
    ids[(size_t)b * k + lane] = real ? cand[(size_t)b * A + tp] : -1;
  }
}

template <int NCH>
void launch_partial(const float* f, const float* w, const int* cand, int B,
                    int V, int D4, int A, int nseg, int k, float* part_v,
                    int* part_p, cudaStream_t st) {
  dim3 grid(nseg, B);
  rerank_partial<NCH><<<grid, NT, 0, st>>>(f, w, cand, V, D4, A, nseg, k,
                                           part_v, part_p);
}

}  // namespace

extern "C" int ivf_rerank_segments(int A) { return (A + SEG - 1) / SEG; }

// part_v / part_p: scratch of B * ivf_rerank_segments(A) * k entries each
extern "C" int ivf_rerank_launch(const void* f, const void* w,
                                 const void* cand, int B, int V, int D, int A,
                                 int k, void* part_v, void* part_p,
                                 void* vals, void* ids, void* stream) {
  if (k < 1 || k > 32 || D % 4 || D < 4 || D > 1024 || B < 1 || B > 65535 ||
      A < 1 || V < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int D4 = D / 4, nseg = (A + SEG - 1) / SEG;
  const int nch = (D4 + 31) / 32;
  const float* fp = static_cast<const float*>(f);
  const float* wp = static_cast<const float*>(w);
  const int* cp = static_cast<const int*>(cand);
  float* pv = static_cast<float*>(part_v);
  int* pp = static_cast<int*>(part_p);
  if (nch <= 1) launch_partial<1>(fp, wp, cp, B, V, D4, A, nseg, k, pv, pp, st);
  else if (nch <= 2) launch_partial<2>(fp, wp, cp, B, V, D4, A, nseg, k, pv, pp, st);
  else if (nch <= 4) launch_partial<4>(fp, wp, cp, B, V, D4, A, nseg, k, pv, pp, st);
  else launch_partial<8>(fp, wp, cp, B, V, D4, A, nseg, k, pv, pp, st);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  rerank_merge<<<(B + WARPS - 1) / WARPS, NT, 0, st>>>(
      pv, pp, cp, B, A, nseg, k, static_cast<float*>(vals),
      static_cast<int*>(ids));
  return static_cast<int>(cudaGetLastError());
}
