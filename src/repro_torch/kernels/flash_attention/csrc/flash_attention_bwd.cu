// Backward of the whole-sequence flash attention (flash_attention.cu) for
// Hopper (sm_90a): causal or full, GQA, query and key positions given per
// token.
//
// Given q [b, sq, hq, d], k/v [b, skv, hkv, d], the forward's output o and
// the natural-log log-sum-exp of each row's scaled scores lse [b, hq, sq]
// (f32, written by the forward), and dO, the gradient of o, it computes by
// the FlashAttention-2 recomputation
//
//   D_i   = sum_c dO[i, c] O[i, c]                        (f32)
//   P_ij  = exp(s_ij - lse_i),  s_ij = q_i . k_j / sqrt(d) (0 where key j is
//           invalid for query i: k_pos[j] < 0, or k_pos[j] > q_pos[i] when
//           causal; the forward's mask)
//   dV_j  = sum_i P_ij dO_i     (P rounded to v's dtype, as the forward
//                                rounds it before PV)
//   dP_ij = dO_i . v_j
//   dS_ij = P_ij (dP_ij - D_i)
//   dK_j  = sum_i dS_ij q_i / sqrt(d),   dQ_i = sum_j dS_ij k_j / sqrt(d)
//
// with dK and dV summed over the g query heads of their KV head, and dq, dk,
// dv written in q's dtype (contiguous). A row with no valid key gets no
// gradient (the forward gives it zeros). All sums are taken in a fixed order
// by one block each, with no atomics: the bits do not depend on scheduling,
// eager equals graph replay, and a row's bits do not depend on b.
//
// Replaces the gradient the reference package takes of its jnp
// `blocked_attention` (src/repro/models/attention.py:150-184) by autodiff,
// whose per-tile checkpointing (attention.py:102-130) is the same
// recomputation; the reference's Pallas `flash_attention`
// (src/repro/kernels/flash_attention/flash_attention.py, pl.pallas_call at
// :98) has no backward.
//
// What bounds it on this card: operations. Five products of 2 * d flops per
// valid (query, key) pair and head (S again, dP, dV, dK, dQ): 2.5 times the
// forward's 4 * d. At a 4096-token causal microbatch of minitron-8b (32 heads
// of 128 over 8 KV heads) that is 343.6 GFLOP, 0.35 ms at 989 TFLOP/s of
// bf16, against 0.05 ms for its 0.17 GB of inputs and outputs at 3.35 TB/s.
// This design does seven (dQ's kernel takes S and dP again): 0.49 ms there.
//
// Three kernels a call:
//   * dot: D = rowsum(dO * O), one warp a row;
//   * dK/dV: one block per (128-key tile, KV head, batch row), heads
//     fastest so that the heaviest causal tiles (the first keys) start
//     first. A producer warp loads the block's K and V tiles once by TMA,
//     then for each item, (query head, 64-query tile) over the g query
//     heads of the KV head and the query tiles that can see one of the
//     block's keys (from the positions), the Q and dO tiles by TMA and the
//     tile's positions, lse (log2 domain) and D by its lanes, into a ring of
//     three stages (full and empty mbarriers). Two consumer warpgroups
//     own 64 keys each and keep their dK and dV (64 x d f32 each) in
//     registers over every item: GQA sums in registers, no atomics.
//   * dQ: one block per (128-query tile, query head, batch row), the
//     heaviest causal tiles (the last queries) first. The producer warp
//     loads Q and dO once, then walks the 64-key tiles in order into the
//     ring, skipping a tile whose keys are all invalid for every query of
//     the block (a vote over its positions), and ends with a tile index of
//     -1. Two consumer warpgroups own 64 queries and their dQ each.
// bf16 route (the model's): every product on wgmma (bf16 in, f32
// accumulate). S^T = K Q^T and dP^T = V dO^T (dQ: S = Q K^T, dP = dO V^T)
// take both operands from shared memory, K-major; P and dS are taken from
// the accumulators under the forward's mask (one FFMA and one ex2 a score),
// rounded to bf16 as register A operands of dV += P^T dO, dK += dS^T Q
// (dQ += dS K), whose B is the streamed tile read MN-major (the transpose
// bit). Tiles are [d / 64][rows][64] with 128-byte rows, TMA's 128-byte
// swizzle matching the descriptors'. The head dim is padded to 64 (d
// 16-64) or 128 (d 80-128) by the maps' zero fill past d, so the route
// takes every d the launcher accepts. setmaxnreg gives the producer
// warpgroup 40 registers and the consumers 232: at d 128 a dK/dV consumer
// holds 192 f32 accumulators (dK, dV, S^T, dP^T), and with 240 the
// producer spills and the kernel runs slower. The consumer warpgroups take
// turns issuing their products (two named barriers), so that one's mask
// and exponentials run under the other's products. dQ is a second kernel,
// not FA3's sum into an f32 workspace inside the dK/dV pass: its order is
// fixed by construction, at two extra products.
// f32 route (for checks against the plain version): one block of 128
// threads per 64-key (dK/dV) or 64-query (dQ) tile, f32 FMAs on the CUDA
// cores (no TF32), two lanes a row, S, P and dS through shared memory.
// Left to later work: the dK/dV kernel's S^T and dP^T read both operands
// from shared memory, whose bandwidth then bounds them as much as the
// tensor cores do (K and V as register fragments need 64 registers more
// than d 128 leaves); at a 2048-token causal prefill its 128 blocks fill
// one wave unevenly (the first key tile sees every query); a TMA store
// epilogue.
//
// C interface (loaded with ctypes): the launcher returns the first CUDA
// error of its three launches, or cudaErrorInvalidValue for an unsupported
// dtype, head dim, grid or tensor map (cudaErrorNotSupported when the driver
// has no cuTensorMapEncodeTiled).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

#include "hopper.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;

// ---------------------------------------------------------------------------
// D = rowsum(dO * O): one warp per (b, i, h) row; out [b, hq, sq]
// ---------------------------------------------------------------------------

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__global__ void __launch_bounds__(256)
dot_kernel(const T* __restrict__ dout, const T* __restrict__ o,
           float* __restrict__ dsum, int64_t rows, int sq, int hq, int d) {
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const T* a = dout + row * d;
  const T* c = o + row * d;
  float acc = 0.f;
  for (int i = lane; i < d; i += 32)
    acc = fmaf(to_f32(a[i]), to_f32(c[i]), acc);
#pragma unroll
  for (int off = 16; off; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    // row = (b * sq + i) * hq + h
    const int h = static_cast<int>(row % hq);
    const int64_t bi = row / hq;
    const int i = static_cast<int>(bi % sq);
    const int64_t b = bi / sq;
    dsum[(b * hq + h) * sq + i] = acc;
  }
}

// The index range [lo, hi] of the entries of pos[0, n) that pass `ok`, by
// every thread of the block (sRed: 2 * warps ints); lo > hi when none does.
template <int kThreads, typename Ok>
__device__ __forceinline__ void index_range(const int* __restrict__ pos, int n,
                                            Ok ok, int* sRed, int& lo,
                                            int& hi) {
  constexpr int kWarps = kThreads / 32;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  lo = INT_MAX;
  hi = -1;
  for (int i = tid; i < n; i += kThreads)
    if (ok(pos[i])) {
      lo = min(lo, i);
      hi = max(hi, i);
    }
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
  __syncthreads();  // sRed may still be read by an earlier call's loop
  if (lane == 0) {
    sRed[warp] = lo;
    sRed[kWarps + warp] = hi;
  }
  __syncthreads();
  for (int w = 0; w < kWarps; ++w) {
    lo = min(lo, sRed[w]);
    hi = max(hi, sRed[kWarps + w]);
  }
}

// ---------------------------------------------------------------------------
// f32 route: CUDA-core FMAs, S, P and dS through shared memory
// ---------------------------------------------------------------------------

namespace f32 {

constexpr int kThreads = 128;       // 64 rows, two lanes a row
constexpr int kRows = 64;           // keys (dK/dV) or queries (dQ) a block
constexpr int kStepQ = 32;          // queries a step of the dK/dV kernel
constexpr int kStepK = 64;          // keys a step of the dQ kernel

template <int D>
struct Pitch {
  static constexpr int kIn = D + 4;  // floats a row of a [row][d] tile
};

// rows [r0, r0 + n_rows) of a [*, D] matrix with row stride `stride`
// (elements) into shared memory at pitch D + 4; rows at or past `n` zero
template <int D>
__device__ __forceinline__ void load_rows(float* dst,
                                          const float* __restrict__ src,
                                          int64_t stride, int r0, int n,
                                          int n_rows) {
  constexpr int CPR = D / 4;
  for (int i = threadIdx.x; i < n_rows * CPR; i += kThreads) {
    const int r = i / CPR, c = (i % CPR) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < n)
      v = *reinterpret_cast<const float4*>(
          src + static_cast<int64_t>(r0 + r) * stride + c);
    *reinterpret_cast<float4*>(dst + r * Pitch<D>::kIn + c) = v;
  }
}

template <int D>
__device__ __forceinline__ float dot_rows(const float* a, const float* b) {
  float acc = 0.f;
#pragma unroll 8
  for (int c = 0; c < D; c += 4) {
    const float4 x = *reinterpret_cast<const float4*>(a + c);
    const float4 y = *reinterpret_cast<const float4*>(b + c);
    acc = fmaf(x.x, y.x, acc);
    acc = fmaf(x.y, y.y, acc);
    acc = fmaf(x.z, y.z, acc);
    acc = fmaf(x.w, y.w, acc);
  }
  return acc;
}

template <int D>
struct DkdvSmem {
  static constexpr int LD = Pitch<D>::kIn;
  static constexpr int LS = kStepQ + 1;
  static constexpr size_t kK = 0;                                  // floats
  static constexpr size_t kV = kK + kRows * LD;
  static constexpr size_t kDK = kV + kRows * LD;
  static constexpr size_t kDV = kDK + kRows * LD;
  static constexpr size_t kQ = kDV + kRows * LD;
  static constexpr size_t kDO = kQ + kStepQ * LD;
  static constexpr size_t kP = kDO + kStepQ * LD;
  static constexpr size_t kDS = kP + kRows * LS;
  static constexpr size_t kLse = kDS + kRows * LS;
  static constexpr size_t kDsum = kLse + kStepQ;
  static constexpr size_t kFloats = kDsum + kStepQ;
  // then ints: key positions, query positions, the range reduction
  static constexpr size_t kBytes =
      4 * kFloats + 4 * (kRows + kStepQ + 2 * (kThreads / 32));
};

template <int D>
__global__ void __launch_bounds__(kThreads)
dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ dsum,
            const int* __restrict__ q_pos, const int* __restrict__ k_pos,
            float* __restrict__ dk, float* __restrict__ dv, int sq, int skv,
            int hq, int hkv, int causal, float scale) {
  using L = DkdvSmem<D>;
  constexpr int LD = L::LD, LS = L::LS;
  extern __shared__ __align__(128) unsigned char smem[];
  float* f = reinterpret_cast<float*>(smem);
  float *sK = f + L::kK, *sV = f + L::kV, *sDK = f + L::kDK,
        *sDV = f + L::kDV, *sQ = f + L::kQ, *sDO = f + L::kDO, *sP = f + L::kP,
        *sDS = f + L::kDS, *sLse = f + L::kLse, *sDsum = f + L::kDsum;
  int* sKPos = reinterpret_cast<int*>(f + L::kFloats);
  int* sQPos = sKPos + kRows;
  int* sRed = sQPos + kStepQ;

  const int tid = threadIdx.x;
  const int row = tid >> 1, half = tid & 1;
  const int k0 = blockIdx.x * kRows;
  const int kh = blockIdx.y, b = blockIdx.z, g = hq / hkv;
  const int64_t kstride = static_cast<int64_t>(hkv) * D;
  const int64_t qstride = static_cast<int64_t>(hq) * D;
  load_rows<D>(sK, k + (static_cast<int64_t>(b) * skv * hkv + kh) * D,
               kstride, k0, skv, kRows);
  load_rows<D>(sV, v + (static_cast<int64_t>(b) * skv * hkv + kh) * D,
               kstride, k0, skv, kRows);
  for (int i = tid; i < kRows * LD; i += kThreads) sDK[i] = sDV[i] = 0.f;
  if (tid < kRows) sKPos[tid] = k0 + tid < skv ? k_pos[k0 + tid] : -1;
  __syncthreads();
  // the least valid key position of the tile, and the queries it can see
  int kmin = INT_MAX;
  for (int r = 0; r < kRows; ++r)
    if (sKPos[r] >= 0) kmin = min(kmin, sKPos[r]);
  int q_lo, q_hi;
  index_range<kThreads>(
      q_pos, kmin == INT_MAX ? 0 : sq,
      [&](int p) { return !causal || p >= kmin; }, sRed, q_lo, q_hi);
  const int kp = sKPos[row];
  const int t_lo = q_hi < 0 ? 0 : q_lo / kStepQ;
  const int t_hi = q_hi < 0 ? 0 : q_hi / kStepQ + 1;

  for (int hh = 0; hh < g; ++hh) {
    const int h = kh * g + hh;
    const int64_t qb = (static_cast<int64_t>(b) * sq * hq + h) * D;
    const int64_t lb = (static_cast<int64_t>(b) * hq + h) * sq;
    for (int t = t_lo; t < t_hi; ++t) {
      const int q0 = t * kStepQ;
      __syncthreads();  // every thread is done with the previous step
      load_rows<D>(sQ, q + qb, qstride, q0, sq, kStepQ);
      load_rows<D>(sDO, dout + qb, qstride, q0, sq, kStepQ);
      if (tid < kStepQ) {
        const bool in = q0 + tid < sq;
        sQPos[tid] = in ? q_pos[q0 + tid] : INT_MIN;
        sLse[tid] = in ? lse[lb + q0 + tid] : 0.f;
        sDsum[tid] = in ? dsum[lb + q0 + tid] : 0.f;
      }
      __syncthreads();
      for (int j = 0; j < kStepQ / 2; ++j) {
        const int c = 2 * j + half;
        const int qp = sQPos[c];
        float p = 0.f, ds = 0.f;
        if (kp >= 0 && qp != INT_MIN && (!causal || kp <= qp)) {
          const float s = dot_rows<D>(sK + row * LD, sQ + c * LD);
          const float dp = dot_rows<D>(sV + row * LD, sDO + c * LD);
          p = expf(s * scale - sLse[c]);
          ds = p * (dp - sDsum[c]);
        }
        sP[row * LS + c] = p;
        sDS[row * LS + c] = ds;
      }
      __syncwarp();
      for (int col = half; col < D; col += 2) {
        float av = sDV[row * LD + col], ak = sDK[row * LD + col];
        for (int c = 0; c < kStepQ; ++c) {
          av = fmaf(sP[row * LS + c], sDO[c * LD + col], av);
          ak = fmaf(sDS[row * LS + c], sQ[c * LD + col], ak);
        }
        sDV[row * LD + col] = av;
        sDK[row * LD + col] = ak;
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < kRows * D; i += kThreads) {
    const int r = i / D, c = i % D;
    if (k0 + r >= skv) continue;
    const int64_t at = ((static_cast<int64_t>(b) * skv + k0 + r) * hkv + kh) *
                           D + c;
    dk[at] = sDK[r * LD + c] * scale;
    dv[at] = sDV[r * LD + c];
  }
}

template <int D>
struct DqSmem {
  static constexpr int LD = Pitch<D>::kIn;
  static constexpr int LS = kStepK + 1;
  static constexpr size_t kQ = 0;                                  // floats
  static constexpr size_t kDO = kQ + kRows * LD;
  static constexpr size_t kDQ = kDO + kRows * LD;
  static constexpr size_t kK = kDQ + kRows * LD;
  static constexpr size_t kV = kK + kStepK * LD;
  static constexpr size_t kDS = kV + kStepK * LD;
  static constexpr size_t kFloats = kDS + kRows * LS;
  static constexpr size_t kBytes =
      4 * kFloats + 4 * (kStepK + 2 * (kThreads / 32));
};

template <int D>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, const float* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ dsum,
          const int* __restrict__ q_pos, const int* __restrict__ k_pos,
          float* __restrict__ dq, int sq, int skv, int hq, int hkv,
          int causal, float scale) {
  using L = DqSmem<D>;
  constexpr int LD = L::LD, LS = L::LS;
  extern __shared__ __align__(128) unsigned char smem[];
  float* f = reinterpret_cast<float*>(smem);
  float *sQ = f + L::kQ, *sDO = f + L::kDO, *sDQ = f + L::kDQ,
        *sK = f + L::kK, *sV = f + L::kV, *sDS = f + L::kDS;
  int* sKPos = reinterpret_cast<int*>(f + L::kFloats);
  int* sRed = sKPos + kStepK;

  const int tid = threadIdx.x;
  const int row = tid >> 1, half = tid & 1;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;
  const int h = blockIdx.y, b = blockIdx.z, g = hq / hkv, kh = h / g;
  const int64_t qstride = static_cast<int64_t>(hq) * D;
  const int64_t kstride = static_cast<int64_t>(hkv) * D;
  const int64_t qb = (static_cast<int64_t>(b) * sq * hq + h) * D;
  const int64_t kb = (static_cast<int64_t>(b) * skv * hkv + kh) * D;
  load_rows<D>(sQ, q + qb, qstride, q0, sq, kRows);
  load_rows<D>(sDO, dout + qb, qstride, q0, sq, kRows);
  for (int i = tid; i < kRows * LD; i += kThreads) sDQ[i] = 0.f;
  const bool in = q0 + row < sq;
  const int qp = in ? q_pos[q0 + row] : INT_MIN;
  const int64_t li = (static_cast<int64_t>(b) * hq + h) * sq + q0 + row;
  const float lse_r = in ? lse[li] : 0.f;
  const float d_r = in ? dsum[li] : 0.f;
  // the largest query position of the block bounds the causal keys
  int qmax = INT_MIN;
  for (int r = 0; r < kRows && q0 + r < sq; ++r)
    qmax = max(qmax, q_pos[q0 + r]);
  int k_lo, k_hi;
  index_range<kThreads>(
      k_pos, skv, [&](int p) { return p >= 0 && (!causal || p <= qmax); },
      sRed, k_lo, k_hi);
  const int t_lo = k_hi < 0 ? 0 : k_lo / kStepK;
  const int t_hi = k_hi < 0 ? 0 : k_hi / kStepK + 1;

  for (int t = t_lo; t < t_hi; ++t) {
    const int k0 = t * kStepK;
    __syncthreads();  // every thread is done with the previous tile
    load_rows<D>(sK, k + kb, kstride, k0, skv, kStepK);
    load_rows<D>(sV, v + kb, kstride, k0, skv, kStepK);
    if (tid < kStepK) sKPos[tid] = k0 + tid < skv ? k_pos[k0 + tid] : -1;
    __syncthreads();
    for (int j = 0; j < kStepK / 2; ++j) {
      const int c = 2 * j + half;
      const int kp = sKPos[c];
      float ds = 0.f;
      if (kp >= 0 && qp != INT_MIN && (!causal || kp <= qp)) {
        const float s = dot_rows<D>(sQ + row * LD, sK + c * LD);
        const float dp = dot_rows<D>(sDO + row * LD, sV + c * LD);
        ds = expf(s * scale - lse_r) * (dp - d_r);
      }
      sDS[row * LS + c] = ds;
    }
    __syncwarp();
    for (int col = half; col < D; col += 2) {
      float acc = sDQ[row * LD + col];
      for (int c = 0; c < kStepK; ++c)
        acc = fmaf(sDS[row * LS + c], sK[c * LD + col], acc);
      sDQ[row * LD + col] = acc;
    }
  }
  __syncthreads();
  for (int i = tid; i < kRows * D; i += kThreads) {
    const int r = i / D, c = i % D;
    if (q0 + r >= sq) continue;
    dq[((static_cast<int64_t>(b) * sq + q0 + r) * hq + h) * D + c] =
        sDQ[r * LD + c] * scale;
  }
}

template <int D>
int launch(int sq, int skv, int b, int hq, int hkv, cudaStream_t st,
           const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* dsum, const void* q_pos,
           const void* k_pos, void* dq, void* dk, void* dv, int causal,
           float scale) {
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        dkdv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(DkdvSmem<D>::kBytes));
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(dq_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(DqSmem<D>::kBytes));
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  const auto* df = static_cast<const float*>(dout);
  const auto* lf = static_cast<const float*>(lse);
  const auto* sf = static_cast<const float*>(dsum);
  const auto* qp = static_cast<const int*>(q_pos);
  const auto* kp = static_cast<const int*>(k_pos);
  dkdv_kernel<D><<<dim3((skv + kRows - 1) / kRows, hkv, b), kThreads,
                   DkdvSmem<D>::kBytes, st>>>(
      qf, kf, vf, df, lf, sf, qp, kp, static_cast<float*>(dk),
      static_cast<float*>(dv), sq, skv, hq, hkv, causal, scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  dq_kernel<D><<<dim3((sq + kRows - 1) / kRows, hq, b), kThreads,
                 DqSmem<D>::kBytes, st>>>(qf, kf, vf, df, lf, sf, qp, kp,
                                          static_cast<float*>(dq), sq, skv, hq,
                                          hkv, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace f32

// ---------------------------------------------------------------------------
// bf16 route: wgmma fed by TMA from a producer warp through an mbarrier ring
// ---------------------------------------------------------------------------

namespace tc {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 384;      // a producer warpgroup, two consumer ones
constexpr int kWgRows = 64;        // rows a consumer warpgroup owns (wgmma M)
constexpr int kBlockRows = 2 * kWgRows;  // resident rows: keys (dK/dV) or
                                         // queries (dQ)
constexpr int kStep = 64;          // streamed rows a stage: queries (dK/dV)
                                   // or keys (dQ)
constexpr int kStages = 3;         // depth of the ring
constexpr int kProducerRegs = 40;  // setmaxnreg: 128 x 40 + 256 x 232 =
constexpr int kConsumerRegs = 232; // 64512 of the SM's 65536

// 2^x on the special-function unit (ftz)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// --- TMA -------------------------------------------------------------------

// one box (64 columns x 64 rows of one head and batch row) of a
// [b, rows, heads, d] map into shared memory at `dst`, completing on `bar`
__device__ __forceinline__ void tma_box(uint32_t dst, const CUtensorMap* map,
                                        int col, int head, int row, int batch,
                                        uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(head), "r"(row),
      "r"(batch), "r"(bar)
      : "memory");
}

// rows [row0, row0 + R) of one head and batch row, all DP columns, as the
// tile [DP / 64][R][64] (128-byte rows, 128-byte swizzle) at `dst`; rows and
// columns past the tensor's edge arrive as zeros. R * DP * 2 bytes.
template <int DP, int R>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map,
                                         int head, int row0, int batch,
                                         uint32_t bar) {
#pragma unroll
  for (int c = 0; c < DP / 64; ++c)
#pragma unroll
    for (int r = 0; r < R / 64; ++r)
      tma_box(dst + (c * R + r * 64) * 128, map, c * 64, head, row0 + r * 64,
              batch, bar);
}

// --- wgmma -----------------------------------------------------------------

// K-major operand: 64 rows from r0, the 16 columns of k step kk, of a
// [DP / 64][R][64] tile (8-row groups 1024 bytes apart)
template <int R>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int r0, int kk) {
  return desc(tile + (kk >> 2) * R * 128 + r0 * 128 + (kk & 3) * 32, 16, 1024);
}
// MN-major (transposed) operand: rows 16 kk .. 16 kk + 15 (the k step) and
// every column of a [DP / 64][64][64] streamed tile (64-column blocks 8 KB
// apart, 8-row groups 1024 bytes apart)
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int kk) {
  return desc(tile + kk * 2048, kStep * 128, 1024);
}

// Named barrier 1 + w is consumer warpgroup w's turn to issue products:
// turn_wait(w) takes it, turn_pass(w) hands the turn to the other one.
__device__ __forceinline__ void turn_wait(int w) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(1 + w) : "memory");
}
__device__ __forceinline__ void turn_pass(int w) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - w) : "memory");
}

// d (m64n64, f32) = A . B^T, or += where `accumulate`: A (64 x 16) and B
// (64 x 16) K-major bf16 in shared memory, 128-byte swizzle
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a,
                                             uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (m64n64, f32) += A . B: A (64 x 16) bf16 fragments in registers, B
// (16 x 64) MN-major bf16 in shared memory (the transpose bit), 128-byte
// swizzle
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (m64n128, f32) += A . B: A (64 x 16) bf16 fragments in registers, B
// (16 x 128) MN-major bf16 in shared memory (the transpose bit), 128-byte
// swizzle
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <int DP>
__device__ __forceinline__ void wgmma_rs(float (&d)[DP / 2],
                                         const uint32_t (&a)[4], uint64_t b) {
  if constexpr (DP == 128)
    wgmma_rs_n128(d, a, b);
  else
    wgmma_rs_n64(d, a, b);
}

// x (m64n64 accumulators) rounded to bf16 as the A fragments of four k16
// steps: the accumulator's n8 tiles 2 kk and 2 kk + 1 are k step kk
__device__ __forceinline__ void to_a(const float (&x)[32],
                                     uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[kk][r] = pack_bf16(x[8 * kk + 2 * r], x[8 * kk + 2 * r + 1]);
}

// A warpgroup's accumulators (64 x DP, this thread's rows `row` and
// row + 8) scaled by `scale`, as bf16 pairs into `out` (row stride `stride`
// elements): rows at or past n and columns at or past d are not written
template <int DP>
__device__ __forceinline__ void store_acc(const float (&acc)[DP / 2],
                                          float scale, bf16* out,
                                          int64_t stride, int row, int n,
                                          int d) {
  const int tg = threadIdx.x & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int rr = row + 8 * r;
    if (rr >= n) continue;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = 8 * j + 2 * tg;
      if (col < d)
        *reinterpret_cast<uint32_t*>(out + rr * stride + col) =
            pack_bf16(acc[4 * j + 2 * r] * scale,
                      acc[4 * j + 2 * r + 1] * scale);
    }
  }
}

// the largest v over the block (sRed: kThreads / 32 ints)
__device__ __forceinline__ int block_max(int v, int* sRed) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o; o >>= 1) v = max(v, __shfl_xor_sync(0xffffffffu, v, o));
  __syncthreads();
  if (lane == 0) sRed[warp] = v;
  __syncthreads();
  v = INT_MIN;
  for (int w = 0; w < kThreads / 32; ++w) v = max(v, sRed[w]);
  return v;
}

// Shared memory of the dK/dV kernel (bytes from a 1024-aligned base): the
// block's K and V tiles, the ring of Q and dO tiles, each stage's query
// positions, lse (log2 domain) and D, the block's key positions, the
// reductions' scratch and the mbarriers (K/V, full[], empty[]).
template <int DP>
struct DkdvSmem {
  static constexpr uint32_t kTile = 2 * kBlockRows * DP;
  static constexpr uint32_t kStage = 2 * 2 * kStep * DP;
  static constexpr uint32_t kK = 0;
  static constexpr uint32_t kV = kK + kTile;
  static constexpr uint32_t kRing = kV + kTile;
  static constexpr uint32_t kMeta = kRing + kStages * kStage;
  static constexpr uint32_t kMetaStage = 3 * 4 * kStep;
  static constexpr uint32_t kKPos = kMeta + kStages * kMetaStage;
  static constexpr uint32_t kRed = kKPos + 4 * kBlockRows;
  static constexpr uint32_t kBar = kRed + 4 * 2 * (kThreads / 32);
  static constexpr uint32_t kBytes = kBar + 8 * (1 + 2 * kStages);
  static constexpr size_t kAlloc = kBytes + 1024;    // room to align
  static_assert(kAlloc <= 232448, "a block's shared memory");
};

// dK, dV of one 128-key tile of one KV head and batch row. The producer
// warp loads K and V once, then for each (query head, 64-query tile) item
// the tiles of Q and dO into the ring; each consumer warpgroup owns 64 keys
// and keeps their dK and dV in registers over every item.
template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                  const __grid_constant__ CUtensorMap tm_k,
                  const __grid_constant__ CUtensorMap tm_v,
                  const __grid_constant__ CUtensorMap tm_do,
                  const float* __restrict__ lse,
                  const float* __restrict__ dsum,
                  const int* __restrict__ q_pos,
                  const int* __restrict__ k_pos, bf16* __restrict__ dk,
                  bf16* __restrict__ dv, int sq, int skv, int hq, int hkv,
                  int d, int causal, float scale_log2, float scale) {
  using L = DkdvSmem<DP>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  int* sKPos = reinterpret_cast<int*>(smem + L::kKPos);
  int* sRed = reinterpret_cast<int*>(smem + L::kRed);
  const uint32_t kv_bar = base + L::kBar;
  const auto full = [&](int s) { return base + L::kBar + 8 * (1 + s); };
  const auto empty = [&](int s) {
    return base + L::kBar + 8 * (1 + kStages + s);
  };
  const auto meta = [&](int s) {            // q_pos, lse (log2), D
    return reinterpret_cast<int*>(smem + L::kMeta + s * L::kMetaStage);
  };

  const int tid = threadIdx.x;
  const int kh = blockIdx.x, k0 = blockIdx.y * kBlockRows, b = blockIdx.z;
  const int g = hq / hkv;
  if (tid == 0) {
    mbar_init(kv_bar, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 32);                // the producer warp's lanes
      mbar_init(empty(s), 2 * 128);          // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = tid; i < kBlockRows; i += kThreads)
    sKPos[i] = k0 + i < skv ? k_pos[k0 + i] : -1;
  __syncthreads();
  // the least valid key position of the tile, and the queries it can see
  int kmin = INT_MAX;
  for (int r = 0; r < kBlockRows; ++r)
    if (sKPos[r] >= 0) kmin = min(kmin, sKPos[r]);
  int q_lo, q_hi;
  index_range<kThreads>(
      q_pos, kmin == INT_MAX ? 0 : sq,
      [&](int p) { return !causal || p >= kmin; }, sRed, q_lo, q_hi);
  const int t_lo = q_hi < 0 ? 0 : q_lo / kStep;
  const int nt = q_hi < 0 ? 0 : q_hi / kStep + 1 - t_lo;
  const int items = g * nt;                  // (query head, query tile)

  if (tid < 128) {
    // ---- producer: one warp issues every copy --------------------------
    regs_dec<kProducerRegs>();
    if (tid < 32) {
      const int lane = tid;
      if (lane == 0) {
        mbar_arrive_tx(kv_bar, 2 * L::kTile);
        tma_tile<DP, kBlockRows>(base + L::kK, &tm_k, kh, k0, b, kv_bar);
        tma_tile<DP, kBlockRows>(base + L::kV, &tm_v, kh, k0, b, kv_bar);
      }
      for (int n = 0; n < items; ++n) {
        const int s = n % kStages;
        mbar_wait(empty(s), ((n / kStages) & 1) ^ 1);
        const int h = kh * g + n / nt;
        const int q0 = (t_lo + n % nt) * kStep;
        const int64_t lb = (static_cast<int64_t>(b) * hq + h) * sq;
        int* qp = meta(s);
        float* l2 = reinterpret_cast<float*>(qp + kStep);
        float* dd = l2 + kStep;
        for (int i = lane; i < kStep; i += 32) {
          const bool in = q0 + i < sq;
          qp[i] = in ? q_pos[q0 + i] : INT_MIN;
          l2[i] = in ? lse[lb + q0 + i] * kLog2e : 0.f;
          dd[i] = in ? dsum[lb + q0 + i] : 0.f;
        }
        if (lane == 0) {
          const uint32_t st = base + L::kRing + s * L::kStage;
          mbar_arrive_tx(full(s), L::kStage);
          tma_tile<DP, kStep>(st, &tm_q, h, q0, b, full(s));
          tma_tile<DP, kStep>(st + L::kStage / 2, &tm_do, h, q0, b, full(s));
        } else {
          mbar_arrive(full(s));
        }
      }
    }
  } else {
    // ---- consumers: 64 keys a warpgroup ---------------------------------
    regs_inc<kConsumerRegs>();
    const int cw = tid / 128 - 1;
    const int lane = tid & 31, wi = (tid >> 5) & 3;
    const int gq = lane >> 2, tg = lane & 3;
    const int row = cw * kWgRows + wi * 16 + gq;   // and row + 8
    const int kp0 = sKPos[row], kp1 = sKPos[row + 8];
    float dka[DP / 2], dva[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) dka[i] = dva[i] = 0.f;
    mbar_wait(kv_bar, 0);
    if (cw == 1) turn_pass(cw);              // warpgroup 0 goes first
    for (int n = 0; n < items; ++n) {
      const int s = n % kStages;
      mbar_wait(full(s), (n / kStages) & 1);
      const uint32_t sQ = base + L::kRing + s * L::kStage;
      const uint32_t sDO = sQ + L::kStage / 2;
      const uint32_t sK = base + L::kK, sV = sK + L::kTile;
      // S^T = K Q^T and dP^T = V dO^T: 64 keys x 64 queries
      float st[32], dpt[32];
      turn_wait(cw);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        wgmma_ss_n64(st, desc_k<kBlockRows>(sK, cw * kWgRows, kk),
                     desc_k<kStep>(sQ, 0, kk), kk > 0);
      wg_commit();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        wgmma_ss_n64(dpt, desc_k<kBlockRows>(sV, cw * kWgRows, kk),
                     desc_k<kStep>(sDO, 0, kk), kk > 0);
      wg_commit();
      turn_pass(cw);
      const int* qp = meta(s);
      const float* l2 = reinterpret_cast<const float*>(qp + kStep);
      const float* dd = l2 + kStep;
      wg_wait<1>();
      keep(st);
      // P^T under the forward's mask: one FFMA and one ex2 a score
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = 8 * j + 2 * tg;
        const int2 qq = *reinterpret_cast<const int2*>(qp + c);
        const float2 ll = *reinterpret_cast<const float2*>(l2 + c);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = e < 2 ? kp0 : kp1;
          const int qc = (e & 1) ? qq.y : qq.x;
          const bool ok = key >= 0 && qc != INT_MIN && (!causal || key <= qc);
          st[4 * j + e] = ok ? exp2_approx(fmaf(st[4 * j + e], scale_log2,
                                                -((e & 1) ? ll.y : ll.x)))
                             : 0.f;
        }
      }
      wg_wait<0>();
      keep(dpt);
      // dS^T = P^T (dP^T - D)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 dj = *reinterpret_cast<const float2*>(dd + 8 * j + 2 * tg);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dpt[4 * j + e] = st[4 * j + e] * (dpt[4 * j + e] -
                                            ((e & 1) ? dj.y : dj.x));
      }
      // dV += P^T dO, dK += dS^T Q: P and dS rounded to bf16 as A
      uint32_t pa[4][4], da[4][4];
      to_a(st, pa);
      to_a(dpt, da);
      turn_wait(cw);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<DP>(dva, pa[kk], desc_mn(sDO, kk));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<DP>(dka, da[kk], desc_mn(sQ, kk));
      wg_commit();
      turn_pass(cw);
      wg_wait<0>();
      keep(dka);
      keep(dva);
      mbar_arrive(empty(s));
    }
    if (cw == 0) turn_wait(cw);              // the last pass of warpgroup 1
    const int64_t kstride = static_cast<int64_t>(hkv) * d;
    const int64_t at = ((static_cast<int64_t>(b) * skv + k0) * hkv + kh) * d;
    store_acc<DP>(dka, scale, dk + at, kstride, row, skv - k0, d);
    store_acc<DP>(dva, 1.f, dv + at, kstride, row, skv - k0, d);
  }
}

// Shared memory of the dQ kernel: the block's Q and dO tiles, the ring of
// K and V tiles, each stage's key positions and key-tile index (-1: no more
// tiles), the reductions' scratch and the mbarriers (Q/dO, full[], empty[]).
template <int DP>
struct DqSmem {
  static constexpr uint32_t kTile = 2 * kBlockRows * DP;
  static constexpr uint32_t kStage = 2 * 2 * kStep * DP;
  static constexpr uint32_t kQ = 0;
  static constexpr uint32_t kDO = kQ + kTile;
  static constexpr uint32_t kRing = kDO + kTile;
  static constexpr uint32_t kMeta = kRing + kStages * kStage;
  static constexpr uint32_t kMetaStage = 4 * kStep + 16;
  static constexpr uint32_t kRed = kMeta + kStages * kMetaStage;
  static constexpr uint32_t kBar = kRed + 4 * 2 * (kThreads / 32);
  static constexpr uint32_t kBytes = kBar + 8 * (1 + 2 * kStages);
  static constexpr size_t kAlloc = kBytes + 1024;
  static_assert(kAlloc <= 232448, "a block's shared memory");
};

// dQ of one 128-query tile of one query head and batch row, the heaviest
// causal tiles first. The producer warp loads Q and dO once, then walks the
// 64-key tiles in order, skipping a tile with no key valid for any query
// of the block (a vote over its positions), and ends the ring with the
// index -1; each consumer warpgroup owns 64 queries and their dQ.
template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
dq_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v,
                const __grid_constant__ CUtensorMap tm_do,
                const float* __restrict__ lse, const float* __restrict__ dsum,
                const int* __restrict__ q_pos, const int* __restrict__ k_pos,
                bf16* __restrict__ dq, int sq, int skv, int hq, int hkv,
                int d, int causal, float scale_log2, float scale) {
  using L = DqSmem<DP>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  int* sRed = reinterpret_cast<int*>(smem + L::kRed);
  const uint32_t q_bar = base + L::kBar;
  const auto full = [&](int s) { return base + L::kBar + 8 * (1 + s); };
  const auto empty = [&](int s) {
    return base + L::kBar + 8 * (1 + kStages + s);
  };
  const auto meta = [&](int s) {            // k_pos[kStep], the tile index
    return reinterpret_cast<int*>(smem + L::kMeta + s * L::kMetaStage);
  };

  const int tid = threadIdx.x;
  const int h = blockIdx.x, b = blockIdx.z;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockRows;
  const int g = hq / hkv, kh = h / g;
  if (tid == 0) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 32);
      mbar_init(empty(s), 2 * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the largest query position of the block bounds the causal keys
  const int qmax = block_max(
      tid < kBlockRows && q0 + tid < sq ? q_pos[q0 + tid] : INT_MIN, sRed);
  int k_lo, k_hi;
  index_range<kThreads>(
      k_pos, skv, [&](int p) { return p >= 0 && (!causal || p <= qmax); },
      sRed, k_lo, k_hi);
  const int t_lo = k_hi < 0 ? 0 : k_lo / kStep;
  const int t_hi = k_hi < 0 ? 0 : k_hi / kStep + 1;

  if (tid < 128) {
    // ---- producer ---------------------------------------------------------
    regs_dec<kProducerRegs>();
    if (tid < 32) {
      const int lane = tid;
      if (lane == 0) {
        mbar_arrive_tx(q_bar, 2 * L::kTile);
        tma_tile<DP, kBlockRows>(base + L::kQ, &tm_q, h, q0, b, q_bar);
        tma_tile<DP, kBlockRows>(base + L::kDO, &tm_do, h, q0, b, q_bar);
      }
      int t = t_lo;
      for (int n = 0;; ++n, ++t) {
        // the next tile >= t with a key valid for some query of the block
        int kp0 = -1, kp1 = -1;
        for (; t < t_hi; ++t) {
          const int j = t * kStep + lane;
          kp0 = j < skv ? k_pos[j] : -1;
          kp1 = j + 32 < skv ? k_pos[j + 32] : -1;
          if (__any_sync(0xffffffffu,
                         (kp0 >= 0 && (!causal || kp0 <= qmax)) ||
                             (kp1 >= 0 && (!causal || kp1 <= qmax))))
            break;
        }
        const int s = n % kStages;
        mbar_wait(empty(s), ((n / kStages) & 1) ^ 1);
        int* kp = meta(s);
        kp[lane] = kp0;
        kp[lane + 32] = kp1;
        if (lane == 0) kp[kStep] = t < t_hi ? t : -1;
        if (t < t_hi && lane == 0) {
          const uint32_t st = base + L::kRing + s * L::kStage;
          mbar_arrive_tx(full(s), L::kStage);
          tma_tile<DP, kStep>(st, &tm_k, kh, t * kStep, b, full(s));
          tma_tile<DP, kStep>(st + L::kStage / 2, &tm_v, kh, t * kStep, b,
                              full(s));
        } else {
          mbar_arrive(full(s));
        }
        if (t >= t_hi) break;
      }
    }
  } else {
    // ---- consumers: 64 queries a warpgroup -------------------------------
    regs_inc<kConsumerRegs>();
    const int cw = tid / 128 - 1;
    const int lane = tid & 31, wi = (tid >> 5) & 3;
    const int gq = lane >> 2, tg = lane & 3;
    const int row = cw * kWgRows + wi * 16 + gq;   // and row + 8
    int qp[2];
    float l2[2], dd[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = q0 + row + 8 * r;
      const int64_t at = (static_cast<int64_t>(b) * hq + h) * sq + i;
      qp[r] = i < sq ? q_pos[i] : INT_MIN;
      l2[r] = i < sq ? lse[at] * kLog2e : 0.f;
      dd[r] = i < sq ? dsum[at] : 0.f;
    }
    float dqa[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) dqa[i] = 0.f;
    mbar_wait(q_bar, 0);
    if (cw == 1) turn_pass(cw);
    for (int n = 0;; ++n) {
      const int s = n % kStages;
      mbar_wait(full(s), (n / kStages) & 1);
      const int* kp = meta(s);
      if (kp[kStep] < 0) break;
      const uint32_t sK = base + L::kRing + s * L::kStage;
      const uint32_t sV = sK + L::kStage / 2;
      // S = Q K^T and dP = dO V^T: 64 queries x 64 keys
      const uint32_t sQ = base + L::kQ, sDO = sQ + L::kTile;
      float sc[32], dp[32];
      turn_wait(cw);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        wgmma_ss_n64(sc, desc_k<kBlockRows>(sQ, cw * kWgRows, kk),
                     desc_k<kStep>(sK, 0, kk), kk > 0);
      wg_commit();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        wgmma_ss_n64(dp, desc_k<kBlockRows>(sDO, cw * kWgRows, kk),
                     desc_k<kStep>(sV, 0, kk), kk > 0);
      wg_commit();
      turn_pass(cw);
      wg_wait<1>();
      keep(sc);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int2 kk2 = *reinterpret_cast<const int2*>(kp + 8 * j + 2 * tg);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const int key = (e & 1) ? kk2.y : kk2.x;
          const bool ok =
              key >= 0 && qp[r] != INT_MIN && (!causal || key <= qp[r]);
          sc[4 * j + e] =
              ok ? exp2_approx(fmaf(sc[4 * j + e], scale_log2, -l2[r])) : 0.f;
        }
      }
      wg_wait<0>();
      keep(dp);
#pragma unroll
      for (int i = 0; i < 32; ++i) dp[i] = sc[i] * (dp[i] - dd[(i >> 1) & 1]);
      // dQ += dS K: dS rounded to bf16 as A, K transposed
      uint32_t da[4][4];
      to_a(dp, da);
      turn_wait(cw);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<DP>(dqa, da[kk], desc_mn(sK, kk));
      wg_commit();
      turn_pass(cw);
      wg_wait<0>();
      keep(dqa);
      mbar_arrive(empty(s));
    }
    if (cw == 0) turn_wait(cw);
    const int64_t qstride = static_cast<int64_t>(hq) * d;
    const int64_t at = ((static_cast<int64_t>(b) * sq + q0) * hq + h) * d;
    store_acc<DP>(dqa, scale, dq + at, qstride, row, sq - q0, d);
  }
}

// the map of a contiguous bf16 [b, rows, heads, d]: boxes of 64 columns x
// 64 rows of one head and batch row, 128-byte swizzle, zeros past the edges
bool make_map(CUtensorMap* map, EncodeTiled encode, const void* ptr, int b,
              int rows, int heads, int d) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(b)};
  const cuuint64_t strides[3] = {2ull * d, 2ull * d * heads,
                                 2ull * d * heads * rows};
  const cuuint32_t box[4] = {64, 1, kStep, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// DP: the head dim padded to the wgmma route's 64 or 128 (the maps fill the
// padding with zeros)
template <int DP>
int launch(int d, int sq, int skv, int b, int hq, int hkv, cudaStream_t st,
           const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* dsum, const void* q_pos,
           const void* k_pos, void* dq, void* dk, void* dv, int causal,
           float scale) {
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        dkdv_wgmma_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(DkdvSmem<DP>::kAlloc));
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(dq_wgmma_kernel<DP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(DqSmem<DP>::kAlloc));
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const int k_tiles = (skv + kBlockRows - 1) / kBlockRows;
  const int q_tiles = (sq + kBlockRows - 1) / kBlockRows;
  if (k_tiles > 65535 || q_tiles > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap mq, mk, mv, mdo;
  if (!make_map(&mq, encode, q, b, sq, hq, d) ||
      !make_map(&mk, encode, k, b, skv, hkv, d) ||
      !make_map(&mv, encode, v, b, skv, hkv, d) ||
      !make_map(&mdo, encode, dout, b, sq, hq, d))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* lf = static_cast<const float*>(lse);
  const auto* sf = static_cast<const float*>(dsum);
  const auto* qp = static_cast<const int*>(q_pos);
  const auto* kp = static_cast<const int*>(k_pos);
  const float scale_log2 = scale * kLog2e;
  // heads fastest: the heaviest causal tiles (the first keys, the last
  // queries) of every head start first
  dkdv_wgmma_kernel<DP><<<dim3(hkv, k_tiles, b), kThreads,
                          DkdvSmem<DP>::kAlloc, st>>>(
      mq, mk, mv, mdo, lf, sf, qp, kp, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), sq, skv, hq, hkv, d, causal, scale_log2, scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  dq_wgmma_kernel<DP><<<dim3(hq, q_tiles, b), kThreads, DqSmem<DP>::kAlloc,
                        st>>>(mq, mk, mv, mdo, lf, sf, qp, kp,
                              static_cast<bf16*>(dq), sq, skv, hq, hkv, d,
                              causal, scale_log2, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

template <typename T>
int launch_dot(cudaStream_t st, const void* dout, const void* o, void* dsum,
               int b, int sq, int hq, int d) {
  const int64_t rows = static_cast<int64_t>(b) * sq * hq;
  dot_kernel<T><<<static_cast<unsigned>((rows + 7) / 8), 256, 0, st>>>(
      static_cast<const T*>(dout), static_cast<const T*>(o),
      static_cast<float*>(dsum), rows, sq, hq, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = bfloat16, 1 = float32. q, o, dout, dq [b, sq, hq, d] and k, v,
// dk, dv [b, skv, hkv, d] contiguous; lse (the forward's) and dsum (a
// workspace the launcher fills with rowsum(dO * O)) [b, hq, sq] f32; q_pos
// [sq] and k_pos [skv] int32. Three launches on `stream`: D, dK/dV, dQ.
extern "C" int flash_attention_bwd_launch(
    int dtype, int d, const void* q, const void* k, const void* v,
    const void* o, const void* lse, const void* dout, const void* q_pos,
    const void* k_pos, void* dq, void* dk, void* dv, void* dsum, int b,
    int sq, int skv, int hq, int hkv, int causal, float scale,
    void* stream) {
  if (b < 1 || b > 65535 || sq < 1 || skv < 1 || hkv < 1 || hq > 65535 ||
      hkv > 65535 || hq % hkv || d < 16 || d > 128 || d % 16 ||
      (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rc =
      dtype == 0
          ? launch_dot<__nv_bfloat16>(st, dout, o, dsum, b, sq, hq, d)
          : launch_dot<float>(st, dout, o, dsum, b, sq, hq, d);
  if (rc != 0) return rc;
#define BWD_ARGS                                                            \
  sq, skv, b, hq, hkv, st, q, k, v, dout, lse, dsum, q_pos, k_pos, dq, dk, \
      dv, causal, scale
  if (dtype == 0)
    return d <= 64 ? tc::launch<64>(d, BWD_ARGS)
                   : tc::launch<128>(d, BWD_ARGS);
  switch (d) {
#define BWD_CASE(DIM) \
  case DIM:           \
    return f32::launch<DIM>(BWD_ARGS);
    BWD_CASE(16)
    BWD_CASE(32)
    BWD_CASE(48)
    BWD_CASE(64)
    BWD_CASE(80)
    BWD_CASE(96)
    BWD_CASE(112)
    BWD_CASE(128)
#undef BWD_CASE
  }
#undef BWD_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}
