// Forward flash attention over [BH, S, Dh] with causal, sliding-window and
// kv-padding masks, on Hopper (sm_90a).
//
// Replaces: src/repro/kernels/flash_attention.py, flash_attention /
// _flash_kernel (the Pallas TPU kernel). For each of the BH heads and each
// query row i (position i) it returns
//   o[i] = sum_j p_ij v_j / max(l_i, 1e-30),  p_ij = exp(s_ij - m_i),
//   s_ij = (q_i . k_j) * scale,  l_i = sum_j p_ij (fp32),
// over the keys j < T with j <= i when causal and j > i - window when
// window > 0; positions are top-left aligned (row i is position i, also
// when Sq != T). The softmax runs online in fp32 over key tiles. For bf16
// inputs p is rounded to bf16 before the p . v product (the TPU kernel's
// p.astype(v.dtype)), the products' sums are fp32; l sums the fp32 p. A
// row with no valid key gives 0. The output has q's dtype.
//
// Bound on an H100 SXM at the zoo prefill's shapes (SmolLM-135M: B = 8,
// 9 heads, so BH = 72 after the caller expands the 3 KV heads; S = T =
// 2,000; Dh = 64; bf16; causal): 2 Dh S (S + 1) BH = 36.9 GFLOP of causal
// products, 0.037 ms at the 989 TFLOP/s dense bf16 tensor-core rate,
// against 74 MB of q, k, v and o (0.022 ms at 3.35 TB/s): bound by
// operations, so both products run on the tensor cores.
//
// Design (bf16). One block of 4 warps per (head, 64-row query tile); the
// tiles are issued longest causal row range first. The query tile stays in
// shared memory; 64-key tiles of K and V stream through a 2-stage cp.async
// ring. Each warp owns 16 query rows: S = Q K^T by mma.sync m16n8k16 (A
// and B fragments by ldmatrix), the masks and the online softmax on the
// accumulators in registers (row max across the 4 lanes of a row by two
// shuffles), P re-packed from the S accumulators as bf16 A fragments
// without leaving registers, and O += P V by mma.sync with V's B fragments
// by ldmatrix.trans. The running m, l and O stay in registers. Key tiles
// wholly outside the causal or window band are skipped: they would leave
// m, l and O exactly as they are. Dh is padded up to a template width with
// zeros in shared memory.
//
// Design (fp32, off the serving path). CUDA-core FMA, no TF32: 256 threads,
// four to a query row; each thread scores 16 of the tile's 64 keys, writes
// its p to shared memory, and accumulates a quarter of the row's output
// columns.
//
// No atomics and a fixed order of every sum: two runs are bit-identical.
// Requires 16 <= Dh <= 256 with Dh % 16 == 0, contiguous 16-byte aligned
// inputs, BH <= 65,535 (checked by the wrapper).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_tiles.cuh"

namespace {

using namespace mma_tiles;

constexpr int BQ = 64;         // query rows per block
constexpr int BKV = 64;        // keys per tile

struct Problem {
  int Sq, T, Dh, causal, window;
  float scale;
};

// the key tiles [begin, end) that hold a valid key for rows q0 .. q1-1
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
// bf16: mma.sync
// ---------------------------------------------------------------------------

constexpr int MMA_THREADS = 128;   // 4 warps x 16 query rows

template <int DHP>
__global__ void __launch_bounds__(MMA_THREADS)
flash_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  __nv_bfloat16* __restrict__ o, Problem pb) {
  constexpr int ST = DHP + 8;          // row stride (bf16): conflict-free ldmatrix
  constexpr int CH = DHP / 8;          // 16-byte chunks a row
  constexpr int NT = BKV / 8;          // score n-tiles a warp
  constexpr int ND = DHP / 8;          // output n-tiles a warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [BQ][ST]
  __nv_bfloat16* ks = qs + BQ * ST;                                // [2][BKV][ST]
  __nv_bfloat16* vs = ks + 2 * BKV * ST;                           // [2][BKV][ST]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tg = lane & 3;
  const int Sq = pb.Sq, T = pb.T, Dh = pb.Dh;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const size_t bh = blockIdx.y;
  const __nv_bfloat16* qg = q + bh * Sq * Dh;
  const __nv_bfloat16* kg = k + bh * T * Dh;
  const __nv_bfloat16* vg = v + bh * T * Dh;
  int j0, j1;
  tile_range(pb, q0, min(q0 + BQ, Sq), j0, j1);

  for (int c = tid; c < BQ * CH; c += MMA_THREADS) {
    const int r = c / CH, d = (c % CH) * 8;
    const bool ok = q0 + r < Sq && d < Dh;
    cp_async16(qs + r * ST + d, ok ? qg + (size_t)(q0 + r) * Dh + d : qg, ok);
  }
  auto load_kv = [&](int j, int stage) {
    __nv_bfloat16* kd = ks + stage * BKV * ST;
    __nv_bfloat16* vd = vs + stage * BKV * ST;
    for (int c = tid; c < BKV * CH; c += MMA_THREADS) {
      const int r = c / CH, d = (c % CH) * 8, n = j * BKV + r;
      const bool ok = n < T && d < Dh;
      const size_t off = ok ? (size_t)n * Dh + d : 0;
      cp_async16(kd + r * ST + d, kg + off, ok);
      cp_async16(vd + r * ST + d, vg + off, ok);
    }
  };
  if (j0 < j1) load_kv(j0, 0);
  cp_async_commit();

  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;   // this lane's two rows
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  float acc[ND][4];
#pragma unroll
  for (int i = 0; i < ND; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;

  for (int j = j0; j < j1; ++j) {
    const int stage = (j - j0) & 1;
    if (j + 1 < j1) load_kv(j + 1, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const __nv_bfloat16* kb = ks + stage * BKV * ST;
    const __nv_bfloat16* vb = vs + stage * BKV * ST;

    // -- S = Q K^T for this warp's 16 rows x 64 keys ------------------------
    float s[NT][4];
#pragma unroll
    for (int i = 0; i < NT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DHP; kk += 16) {
      uint32_t a[4];
      ldmatrix_x4(a, qs + (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * ST +
                         kk + (lane >> 4) * 8);
#pragma unroll
      for (int nj = 0; nj < NT / 2; ++nj) {
        uint32_t b[4];
        ldmatrix_x4(b, kb + (nj * 16 + (lane & 7) + (lane >> 4) * 8) * ST + kk +
                           ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * nj], a, b[0], b[1]);
        mma_bf16(s[2 * nj + 1], a, b[2], b[3]);
      }
    }

    // -- masks and the online softmax, in fp32 --------------------------------
    const int kv0 = j * BKV;
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int i = 0; i < NT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = e < 2 ? r0 : r1;
        const int kpos = kv0 + i * 8 + tg * 2 + (e & 1);
        const float x = key_valid(pb, row, kpos) ? s[i][e] * pb.scale : -INFINITY;
        s[i][e] = x;
        if (e < 2) mx0 = fmaxf(mx0, x); else mx1 = fmaxf(mx1, x);
      }
#pragma unroll
    for (int sh = 1; sh <= 2; sh <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, sh));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, sh));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float safe0 = mn0 == -INFINITY ? 0.f : mn0;
    const float safe1 = mn1 == -INFINITY ? 0.f : mn1;
    const float c0 = m0 == -INFINITY ? 0.f : expf(m0 - safe0);
    const float c1 = m1 == -INFINITY ? 0.f : expf(m1 - safe1);
    m0 = mn0;
    m1 = mn1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      s[i][0] = expf(s[i][0] - safe0);   // exp(-inf) = 0 for masked keys
      s[i][1] = expf(s[i][1] - safe0);
      s[i][2] = expf(s[i][2] - safe1);
      s[i][3] = expf(s[i][3] - safe1);
      ps0 += s[i][0] + s[i][1];
      ps1 += s[i][2] + s[i][3];
    }
    l0 = l0 * c0 + ps0;                  // this lane's share of the row sum
    l1 = l1 * c1 + ps1;
#pragma unroll
    for (int i = 0; i < ND; ++i) {
      acc[i][0] *= c0;
      acc[i][1] *= c0;
      acc[i][2] *= c1;
      acc[i][3] *= c1;
    }

    // -- O += bf16(P) V: the S accumulators are P's A fragments ---------------
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dn = 0; dn < DHP / 16; ++dn) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, vb + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                      ST + dn * 16 + (lane >> 4) * 8);
        mma_bf16(acc[2 * dn], a, b[0], b[1]);
        mma_bf16(acc[2 * dn + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();     // the stage is refilled in the next iteration
  }
  cp_async_wait<0>();

  // -- o = acc / max(l, 1e-30) in q's dtype --------------------------------------
#pragma unroll
  for (int sh = 1; sh <= 2; sh <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, sh);
    l1 += __shfl_xor_sync(0xffffffffu, l1, sh);
  }
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  __nv_bfloat16* og = o + bh * Sq * Dh;
#pragma unroll
  for (int i = 0; i < ND; ++i) {
    const int col = i * 8 + tg * 2;
    if (col >= Dh) continue;
    if (r0 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(og + (size_t)r0 * Dh + col) =
          __floats2bfloat162_rn(acc[i][0] / d0, acc[i][1] / d0);
    if (r1 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(og + (size_t)r1 * Dh + col) =
          __floats2bfloat162_rn(acc[i][2] / d1, acc[i][3] / d1);
  }
}

// ---------------------------------------------------------------------------
// fp32: CUDA-core FMA
// ---------------------------------------------------------------------------

constexpr int FMA_THREADS = 256;   // 4 threads a query row
constexpr int PS = BKV + 1;        // p row stride (floats)

template <int DHP>
__global__ void __launch_bounds__(FMA_THREADS)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 Problem pb) {
  constexpr int ST = DHP + 4;          // row stride (floats): 4 rows' float4 on distinct banks
  constexpr int CH = DHP / 4;          // 16-byte chunks a row
  constexpr int KPT = BKV / 4;         // keys a thread scores
  constexpr int OPT = DHP / 16;        // output float4 a thread owns
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);   // [BQ][ST]
  float* ks = qs + BQ * ST;                          // [BKV][ST]
  float* vs = ks + BKV * ST;                         // [BKV][ST]
  float* ps = vs + BKV * ST;                         // [BQ][PS]

  const int tid = threadIdx.x;
  const int r = tid >> 2, jq = tid & 3;   // the row, and this thread's quarter
  const int Sq = pb.Sq, T = pb.T, Dh = pb.Dh;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const size_t bh = blockIdx.y;
  const float* qg = q + bh * Sq * Dh;
  const float* kg = k + bh * T * Dh;
  const float* vg = v + bh * T * Dh;
  int j0, j1;
  tile_range(pb, q0, min(q0 + BQ, Sq), j0, j1);

  for (int c = tid; c < BQ * CH; c += FMA_THREADS) {
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
    for (int c = tid; c < BKV * CH; c += FMA_THREADS) {
      const int rr = c / CH, d = (c % CH) * 4, n = j * BKV + rr;
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
    const int kv0 = j * BKV;
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
    for (int t = 0; t < BKV; ++t) {
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

int padded_width(int Dh) {
  return Dh <= 32 ? 32 : Dh <= 64 ? 64 : Dh <= 96 ? 96 : Dh <= 128 ? 128 : 256;
}

template <int DHP>
int launch_bf16(int BH, const void* q, const void* k, const void* v, void* o,
                const Problem& pb, cudaStream_t st) {
  const int smem = (BQ + 4 * BKV) * (DHP + 8) * 2;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bf16_kernel<DHP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((pb.Sq + BQ - 1) / BQ, BH);
  flash_bf16_kernel<DHP><<<grid, MMA_THREADS, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      pb);
  return static_cast<int>(cudaGetLastError());
}

template <int DHP>
int launch_f32(int BH, const void* q, const void* k, const void* v, void* o,
               const Problem& pb, cudaStream_t st) {
  const int smem = ((BQ + 2 * BKV) * (DHP + 4) + BQ * PS) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      flash_f32_kernel<DHP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((pb.Sq + BQ - 1) / BQ, BH);
  flash_f32_kernel<DHP><<<grid, FMA_THREADS, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), pb);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// is_bf16: 1 for bfloat16 inputs and output, 0 for float32
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int BH, int Sq,
                                      int T, int Dh, int causal, int window,
                                      float scale, int is_bf16, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const Problem pb{Sq, T, Dh, causal, window, scale};
  switch (padded_width(Dh)) {
    case 32:
      return is_bf16 ? launch_bf16<32>(BH, q, k, v, o, pb, st)
                     : launch_f32<32>(BH, q, k, v, o, pb, st);
    case 64:
      return is_bf16 ? launch_bf16<64>(BH, q, k, v, o, pb, st)
                     : launch_f32<64>(BH, q, k, v, o, pb, st);
    case 96:
      return is_bf16 ? launch_bf16<96>(BH, q, k, v, o, pb, st)
                     : launch_f32<96>(BH, q, k, v, o, pb, st);
    case 128:
      return is_bf16 ? launch_bf16<128>(BH, q, k, v, o, pb, st)
                     : launch_f32<128>(BH, q, k, v, o, pb, st);
    default:
      return is_bf16 ? launch_bf16<256>(BH, q, k, v, o, pb, st)
                     : launch_f32<256>(BH, q, k, v, o, pb, st);
  }
}
