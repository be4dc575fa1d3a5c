// Fused gather + score + top-k over IVF candidate lists, on Hopper (sm_90a):
// the rerank of the IVF serving index, cluster-major.
//
// Replaces: src/repro/kernels/ivf_rerank.py, ivf_rerank / _rerank_kernel (the
// Pallas TPU kernel). For every query b it scores the candidate rows of the
// class shard w by the fp32 dot product <f[b], w[id]> and returns the k best
// as (value, row id) in the order (value descending, candidate position
// ascending): the TPU kernel merges tile after tile into a running top-k,
// each sweep taking the first maximum of [running top-k ++ tile], so equal
// values go to the earlier candidate slot, not to the lower row id. A slot
// holds a local row id; -1 (any negative id) marks padding, and ids past
// the shard are clipped into it for the gather, as the TPU kernel's is.
// Slots a query cannot fill with a real candidate come back as (-inf, -1).
// Neither the gathered rows nor the scores reach device memory.
//
// The candidates come as groups: group g's L slots lie at list + g * stride.
// Two entries share this one kernel:
//   - probed (the serving path): list = members [C, cap] of the IVF index,
//     probe [B, P] the clusters each query probes in rank order; query b's
//     candidate position of slot s of its rank-p probe is p * cap + s, the
//     slot's place in members[probe[b]].reshape(-1);
//   - generic (ops.ivf_rerank's cand [B, A]): each query's own row of cand
//     is one group (G = B, P = 1, probe = null), position = slot.
//
// Bound on an H100 SXM at the serving shapes (B = 64 queries, P = 31 probed
// clusters of 1,263 slots, D = 512, k = 5): 2·B·P·cap·D = 2.57 GFLOP, 38 us
// at 67 TFLOP/s fp32, while the rows are bytes: gathered query by query they
// are 5.1 GB (1.53 ms at 3.35 TB/s), but a cluster is probed by 2.3 queries
// on average, and the union of the probed rows is 1.84 GB (0.55 ms). Bound
// by bytes, so the design reads each probed row once for all the queries
// that probe its cluster:
//   - a one-block plan launch (probed entry) lists the clusters any query
//     probes (14% of them go unprobed at the serving shapes) and, for
//     each, the (query, rank) pairs that probe it;
//   - the work is items of (probed cluster, segment of SEG = 128 slots):
//     batch 1's 31 clusters make 310, enough for the 132 SMs. One wave of
//     resident blocks takes them in turn;
//   - a producer warp streams each item's rows into a ring of 4 stages of
//     7 rows x 512 floats with 1-D bulk copies (TMA, one per row and stage,
//     completing on the stage's mbarrier), skipping pads and clipping ids,
//     and runs ahead into the next item; rows wider than 512 floats come in
//     512-float pieces, so wide rows need no more ring;
//   - the cluster's queries wait in shared memory, up to 8 at a time
//     (fewer for wide rows: 2 at D = 4,096, 1 at 8,192, whose one query
//     takes 32 KB beside the ring's 56 KB: two blocks an SM still); a
//     cluster with more (skew: 64 queries on the same clusters, or nprobe
//     = C) streams its segment again for each tile of queries, mostly
//     from L2;
//   - 7 consumer warps take one row of a stage each and score it against
//     every query of the tile in fp32 FMA (no TF32): lane j sums its float4
//     pieces j, j + 32, ... in order, then the lanes' sums of the tile's
//     queries are reduced at once (values halved at each xor step), the
//     xor butterfly's tree for each query: a row's score has the same bits
//     wherever it lies and whichever entry asked for it. Each warp keeps a
//     running top-k a query in shared memory; a score enters only if it
//     comes before the k-th, which the query's lanes hold in registers;
//   - the warps' lists of a query merge into one partial top-k a (query,
//     probe rank, segment), with positions;
//   - a last launch merges each query's partials, one block a query, and
//     turns positions into row ids. Nothing is summed by atomics and every
//     order is fixed: two runs give the same bits.
//
// Requires D % 4 == 0, 4 <= D <= 8,192, 16-byte aligned f and w, 1 <= k <=
// 32, P * L < 2^31 (checked by the wrapper). Probe entries outside [0, G)
// probe nothing.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "hopper_tiles.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int CW = 7;                  // consumer warps = rows a stage
constexpr int NT = (CW + 1) * 32;      // and one producer warp: 256
                                       // threads, 128 registers a thread
                                       // at two blocks an SM
constexpr int STAGES = 4;
constexpr int QMAX = 8;                // queries a tile
constexpr int SEG = 128;               // slots of a group a block takes
constexpr int DCH = 512;               // floats of a row a stage holds
constexpr int MAX_D = 8192;       // one query a tile: 32 KB
constexpr int MERGE_WARPS = 8;
constexpr int PLAN_THREADS = 1024;

struct Params {
  const float* f;      // [B, D]
  const float* w;      // [V, D]
  const int* list;     // group g's slots at list + g * stride
  const int* probe;    // [B, P] group ids, or null: query b's group is b
  int* plan;           // rerank_plan's output (probed launches), or null
  int V, D, G, L, stride, P, BP, nseg, k, qt;
  float* part_v;       // [B, P, nseg, k]
  int* part_p;
};

// shared memory of rerank_partial, the same on host and device
struct Layout {
  int qs, ring, mv, mp, total;
};

__host__ __device__ inline Layout layout(int D, int qt, int k) {
  const int dc = D < DCH ? D : DCH;
  Layout l;
  int o = 128;                               // the ring's mbarriers
  l.qs = o;
  o += qt * D * 4;
  o = (o + 127) & ~127;
  l.ring = o;
  o += STAGES * CW * dc * 4;
  l.mv = o;
  o += CW * qt * k * 4;
  l.mp = o;
  o += CW * qt * k * 4;
  l.total = o;
  return l;
}

// queries a tile: the largest power of two up to 8,192 / D (and QMAX)
__host__ __device__ inline int tile_queries(int D) {
  int q = 1;
  while (2 * q <= QMAX && 2 * q * D <= 8192) q *= 2;
  return q;
}

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

// A consumer warp's share of one item and query tile: the rows s0 + CW grp
// + warp of the ring's stages, each scored against the tile's nq <= NQ
// queries (qs) in fp32 FMA and entered into the warp's running top-k of
// each query, kept sorted in shared memory (mv / mp [warp][query][k]).
template <int NQ>
__device__ __forceinline__ void score_rows(
    uint64_t* full, uint64_t* empty, const float* ring, const float* qs,
    float* mv, int* mp, int& it, const int* glist, int s0, int s1, int D,
    int nq, int qt, int k, int warp, int lane) {
  constexpr int LOG = NQ == 1 ? 0 : NQ == 2 ? 1 : NQ == 4 ? 2 : 3;
  const int dc = min(D, DCH), nch = (D + dc - 1) / dc, D4 = D / 4;
  const int ngrp = (s1 - s0 + CW - 1) / CW;
  for (int q = 0; q < nq; ++q) {
    if (lane < k) {
      mv[(warp * qt + q) * k + lane] = -INFINITY;
      mp[(warp * qt + q) * k + lane] = INT_MAX;
    }
  }
  // after the reduction the 32 >> LOG lanes from 32 q hold query q's
  // score, and the k-th entry of its list
  const int myq = lane >> (5 - LOG);
  float kth_v = -INFINITY;
  int kth_p = INT_MAX;
  for (int grp = 0; grp < ngrp; ++grp) {
    const int slot = s0 + grp * CW + warp;
    const bool real = slot < s1 && __ldg(glist + slot) >= 0;
    float acc[NQ];
#pragma unroll
    for (int q = 0; q < NQ; ++q) acc[q] = 0.f;
    for (int c = 0; c < nch; ++c, ++it) {
      const int st = it % STAGES;
      hopper::mbar_wait(&full[st], (it / STAGES) & 1);
      if (real) {
        const int w4 = min(dc, D - c * dc) / 4;
        const float4* r4 =
            reinterpret_cast<const float4*>(ring + (st * CW + warp) * dc);
        const float4* q4 = reinterpret_cast<const float4*>(qs) + c * dc / 4;
        for (int j = lane; j < w4; j += 32) {
          const float4 rv = r4[j];
#pragma unroll
          for (int q = 0; q < NQ; ++q) {
            const float4 qv = q4[q * D4 + j];
            acc[q] = fmaf(qv.x, rv.x, acc[q]);
            acc[q] = fmaf(qv.y, rv.y, acc[q]);
            acc[q] = fmaf(qv.z, rv.z, acc[q]);
            acc[q] = fmaf(qv.w, rv.w, acc[q]);
          }
        }
      }
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&empty[st]);
    }
    if (!real) continue;
    // the lanes' sums of the NQ queries at once: halve the values at each
    // of the first LOG xor steps (16, 8, ...), then plain xor steps down to
    // 1. Each query's sum is the xor butterfly's tree, so its bits do not
    // depend on where the row lies or how many queries share the tile
#pragma unroll
    for (int i = 0; i < LOG; ++i) {
      const int hh = NQ >> (i + 1), dist = 16 >> i;
      const bool up = lane & dist;
#pragma unroll
      for (int j = 0; j < hh; ++j) {
        const float lo = acc[j], hi = acc[j + hh];
        acc[j] = (up ? hi : lo) + __shfl_xor_sync(FULL, up ? lo : hi, dist);
      }
    }
    float s = acc[0];
#pragma unroll
    for (int dist = 16 >> LOG; dist > 0; dist >>= 1)
      s += __shfl_xor_sync(FULL, s, dist);
    const bool enter = myq < nq && (lane & ((32 >> LOG) - 1)) == 0 &&
                       before(s, slot, kth_v, kth_p);
    for (unsigned m = __ballot_sync(FULL, enter); m; m &= m - 1) {
      // insert (v, slot) into query q's list: lane j holds entry j
      const int src = __ffs(m) - 1, q = src >> (5 - LOG);
      const float v = __shfl_sync(FULL, s, src);
      float* lv = mv + (warp * qt + q) * k;
      int* lp = mp + (warp * qt + q) * k;
      const float tv = lane < k ? lv[lane] : -INFINITY;
      const int tp = lane < k ? lp[lane] : INT_MAX;
      const int rank =
          __popc(__ballot_sync(FULL, lane < k && before(tv, tp, v, slot)));
      const float uv = __shfl_up_sync(FULL, tv, 1);
      const int up = __shfl_up_sync(FULL, tp, 1);
      const float nv = lane == rank ? v : (lane > rank ? uv : tv);
      const int np = lane == rank ? slot : (lane > rank ? up : tp);
      __syncwarp();
      if (lane < k) {
        lv[lane] = nv;
        lp[lane] = np;
      }
      const float kv = __shfl_sync(FULL, nv, k - 1);
      const int kp = __shfl_sync(FULL, np, k - 1);
      if (myq == q) {
        kth_v = kv;
        kth_p = kp;
      }
      __syncwarp();
    }
  }
}

// The plan of a probed launch (one block): which groups any query probes,
// in group order (work), and for each the (query, rank) slots b * P + p
// that probe it (qlist[woff[w] .. woff[w + 1])). Counts are integer atomics;
// the order of the slots inside a group is not fixed, and does not matter:
// a slot's partials depend on its query and the group's rows alone.
__global__ void __launch_bounds__(PLAN_THREADS)
rerank_plan(const Params p) {
  __shared__ int s_a[PLAN_THREADS / 32], s_b[PLAN_THREADS / 32];
  __shared__ int s_base[2];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int* cnt = p.plan;                 // [G]: counts, then fill cursors
  int* work = cnt + p.G;             // [G]
  int* woff = work + p.G;            // [G + 1]
  int* qlist = woff + p.G + 1;       // [B * P]
  int* nwork = qlist + p.BP;         // [1]
  for (int g = tid; g < p.G; g += PLAN_THREADS) cnt[g] = 0;
  if (tid == 0) s_base[0] = s_base[1] = 0;
  __syncthreads();
  for (int i = tid; i < p.BP; i += PLAN_THREADS) {
    const int g = p.probe[i];
    if (g >= 0 && g < p.G) atomicAdd(&cnt[g], 1);
  }
  __syncthreads();
  // probed groups in order, and their offsets: a block-wide scan a tile
  for (int g0 = 0; g0 < p.G; g0 += PLAN_THREADS) {
    const int g = g0 + tid;
    const int c = g < p.G ? cnt[g] : 0;
    const int f = c > 0;
    int sf = f, sc = c;              // inclusive warp scans
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int tf = __shfl_up_sync(FULL, sf, off);
      const int tc = __shfl_up_sync(FULL, sc, off);
      if (lane >= off) {
        sf += tf;
        sc += tc;
      }
    }
    if (lane == 31) {
      s_a[warp] = sf;
      s_b[warp] = sc;
    }
    __syncthreads();
    int bf = s_base[0], bc = s_base[1];
    for (int w = 0; w < warp; ++w) {
      bf += s_a[w];
      bc += s_b[w];
    }
    if (f) {
      work[bf + sf - 1] = g;
      woff[bf + sf - 1] = bc + sc - c;
      cnt[g] = bc + sc - c;          // the group's fill cursor
    }
    __syncthreads();
    if (tid == PLAN_THREADS - 1) {
      s_base[0] = bf + sf;
      s_base[1] = bc + sc;
    }
    __syncthreads();
  }
  if (tid == 0) {
    nwork[0] = s_base[0];
    woff[s_base[0]] = s_base[1];
  }
  for (int i = tid; i < p.BP; i += PLAN_THREADS) {
    const int g = p.probe[i];
    if (g >= 0 && g < p.G) qlist[atomicAdd(&cnt[g], 1)] = i;
  }
}

// Persistent: block j takes the items (work index, segment) j, j + grid,
// ...; the producer runs ahead across items and query tiles, bounded by
// the ring, and only the consumers meet at named barriers.
__global__ void __launch_bounds__(NT, 2)   // two blocks an SM
rerank_partial(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + STAGES;
  const Layout lay = layout(p.D, p.qt, p.k);
  float* qs = reinterpret_cast<float*>(smem + lay.qs);
  float* ring = reinterpret_cast<float*>(smem + lay.ring);
  float* mv = reinterpret_cast<float*>(smem + lay.mv);
  int* mp = reinterpret_cast<int*>(smem + lay.mp);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int dc = min(p.D, DCH), nch = (p.D + dc - 1) / dc, D4 = p.D / 4;
  const int k = p.k;
  const int* work = p.plan ? p.plan + p.G : nullptr;
  const int* woff = p.plan ? p.plan + 2 * p.G : nullptr;
  const int* qlist = p.plan ? p.plan + 3 * p.G + 1 : nullptr;
  const int nwork = p.plan ? p.plan[3 * p.G + 1 + p.BP] : p.G;
  const int nitems = nwork * p.nseg;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], CW);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  int it = 0;   // ring steps so far, the same on every thread
  for (int item = blockIdx.x; item < nitems; item += gridDim.x) {
    const int wi = item / p.nseg, seg = item - wi * p.nseg;
    const int g = work ? work[wi] : wi;
    const int q0 = woff ? woff[wi] : 0, nqa = woff ? woff[wi + 1] - q0 : 1;
    const int s0 = seg * SEG, s1 = min(p.L, s0 + SEG);
    const int* glist = p.list + (size_t)g * p.stride;
    const int ngrp = (s1 - s0 + CW - 1) / CW;   // row groups: one a stage
    for (int t0 = 0; t0 < nqa; t0 += p.qt) {
      const int nq = min(p.qt, nqa - t0);
      if (warp == CW) {
        // -- producer: the segment's rows, CW a stage, piece by piece ----
        for (int grp = 0; grp < ngrp; ++grp) {
          const int slot = s0 + grp * CW + lane;
          const int id = (lane < CW && slot < s1) ? __ldg(glist + slot) : -1;
          const bool real = id >= 0;
          const size_t row = (size_t)min(id, p.V - 1);
          const int nreal = __popc(__ballot_sync(FULL, real));
          for (int c = 0; c < nch; ++c, ++it) {
            const int st = it % STAGES;
            const int width = min(dc, p.D - c * dc);
            if (lane == 0) {
              if (it >= STAGES)
                hopper::mbar_wait(&empty[st], ((it / STAGES) & 1) ^ 1);
              hopper::mbar_expect_tx(&full[st], nreal * width * 4);
            }
            __syncwarp();
            if (real)
              hopper::bulk_load(ring + (st * CW + lane) * dc,
                                p.w + row * p.D + c * dc, width * 4,
                                &full[st]);
          }
        }
        continue;
      }
      // -- consumers: the tile's queries, then one row a stage each -------
      for (int e = tid; e < nq * D4; e += CW * 32) {
        const int q = e / D4, j = e - q * D4;
        const int qslot = qlist ? qlist[q0 + t0 + q] : g;
        reinterpret_cast<float4*>(qs)[e] = __ldg(
            reinterpret_cast<const float4*>(p.f) + (size_t)(qslot / p.P) * D4
            + j);
      }
      hopper::bar_sync(1, CW * 32);

      if (nq == 1)
        score_rows<1>(full, empty, ring, qs, mv, mp, it, glist, s0, s1, p.D,
                      nq, p.qt, k, warp, lane);
      else if (nq == 2)
        score_rows<2>(full, empty, ring, qs, mv, mp, it, glist, s0, s1, p.D,
                      nq, p.qt, k, warp, lane);
      else if (nq <= 4)
        score_rows<4>(full, empty, ring, qs, mv, mp, it, glist, s0, s1, p.D,
                      nq, p.qt, k, warp, lane);
      else
        score_rows<QMAX>(full, empty, ring, qs, mv, mp, it, glist, s0, s1,
                         p.D, nq, p.qt, k, warp, lane);

      // -- the warps' lists of each query -> one partial -------------------
      hopper::bar_sync(1, CW * 32);
      for (int q = warp; q < nq; q += CW) {
        float v = lane < k ? mv[q * k + lane] : -INFINITY;
        int pos = lane < k ? mp[q * k + lane] : INT_MAX;
        for (int w = 1; w < CW; ++w) {
          const int o = (w * p.qt + q) * k + lane;
          merge_list(v, pos, lane < k ? mv[o] : -INFINITY,
                     lane < k ? mp[o] : INT_MAX, k, lane);
        }
        const int qslot = qlist ? qlist[q0 + t0 + q] : g;
        const int base = (qslot % p.P) * p.L;   // the probe rank's offset
        if (lane < k) {
          const size_t o = ((size_t)qslot * p.nseg + seg) * k + lane;
          p.part_v[o] = v;
          p.part_p[o] = pos == INT_MAX ? INT_MAX : base + pos;
        }
      }
    }
  }
}

// One block a query: its P * nseg partials (in any order: the order is
// total and every position is unique) -> top-k, positions -> row ids (-1
// where no real candidate filled the slot).
__global__ void __launch_bounds__(MERGE_WARPS * 32)
rerank_merge(const Params p, float* __restrict__ vals, int* __restrict__ ids) {
  __shared__ float sv[MERGE_WARPS][32];
  __shared__ int sp[MERGE_WARPS][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x, k = p.k;
  const int n = p.P * p.nseg;
  float tv = -INFINITY;
  int tp = INT_MAX;
  for (int j = warp; j < n; j += MERGE_WARPS) {
    if (p.probe) {   // a probe outside the groups wrote no partials
      const int g = __ldg(p.probe + (size_t)b * p.P + j / p.nseg);
      if (g < 0 || g >= p.G) continue;
    }
    const size_t o = ((size_t)b * n + j) * k;
    merge_list(tv, tp, lane < k ? p.part_v[o + lane] : -INFINITY,
               lane < k ? p.part_p[o + lane] : INT_MAX, k, lane);
  }
  sv[warp][lane] = tv;
  sp[warp][lane] = tp;
  __syncthreads();
  if (warp != 0) return;
  for (int w = 1; w < MERGE_WARPS; ++w)
    merge_list(tv, tp, sv[w][lane], sp[w][lane], k, lane);
  if (lane < k) {
    int id = -1;
    if (tp != INT_MAX && tv > -INFINITY) {
      const int pr = tp / p.L, slot = tp - pr * p.L;
      const int g = p.probe ? p.probe[(size_t)b * p.P + pr] : b;
      id = p.list[(size_t)g * p.stride + slot];
    }
    vals[(size_t)b * k + lane] = tv;
    ids[(size_t)b * k + lane] = id;
  }
}

}  // namespace

extern "C" int ivf_rerank_segments(int L) { return (L + SEG - 1) / SEG; }

// int32 scratch of a probed launch's plan
extern "C" long long ivf_rerank_plan_ints(int G, int B, int P) {
  return 3LL * G + 2 + (long long)B * P;
}

// list: G groups of L int32 slots, `stride` apart; probe: [B, P] int32 or
// null (then G == B and P == 1). part_v / part_p: scratch of
// B * P * ivf_rerank_segments(L) * k entries each; plan: scratch of
// ivf_rerank_plan_ints(G, B, P) int32 (probed launches only).
extern "C" int ivf_rerank_launch(const void* f, const void* w,
                                 const void* list, const void* probe,
                                 void* plan, int B, int V, int D, int G,
                                 int L, int stride, int P, int k,
                                 void* part_v, void* part_p, void* vals,
                                 void* ids, void* stream) {
  const int nseg = (L + SEG - 1) / SEG;
  if (k < 1 || k > 32 || D % 4 || D < 4 || D > MAX_D || B < 1 || V < 1 ||
      G < 1 || L < 1 || P < 1 || stride < L ||
      (long long)P * L >= INT_MAX || (long long)G * nseg > INT_MAX ||
      3LL * G + 2 + (long long)B * P > INT_MAX || (!probe != !plan) ||
      (!probe && (G != B || P != 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  Params prm;
  prm.f = static_cast<const float*>(f);
  prm.w = static_cast<const float*>(w);
  prm.list = static_cast<const int*>(list);
  prm.probe = static_cast<const int*>(probe);
  prm.plan = static_cast<int*>(plan);
  prm.V = V;
  prm.D = D;
  prm.G = G;
  prm.L = L;
  prm.stride = stride;
  prm.P = P;
  prm.BP = probe ? B * P : 0;
  prm.nseg = nseg;
  prm.k = k;
  prm.qt = tile_queries(D);
  prm.part_v = static_cast<float*>(part_v);
  prm.part_p = static_cast<int*>(part_p);
  const int bytes = layout(D, prm.qt, k).total;
  cudaError_t e = cudaFuncSetAttribute(
      rerank_partial, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  // one wave of resident blocks, no more than there are items
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess ||
      (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, rerank_partial, NT, bytes)) != cudaSuccess)
    return static_cast<int>(e);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long grid = min((long long)G * nseg, (long long)per_sm * sms);
  if (plan) {
    rerank_plan<<<1, PLAN_THREADS, 0, st>>>(prm);
    if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  }
  rerank_partial<<<(int)grid, NT, bytes, st>>>(prm);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  rerank_merge<<<B, MERGE_WARPS * 32, 0, st>>>(prm, static_cast<float*>(vals),
                                               static_cast<int*>(ids));
  return static_cast<int>(cudaGetLastError());
}
