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
//
// Three kernels a call, each right and simple first:
//   * dot: D = rowsum(dO * O), one warp a row;
//   * dK/dV: one block of 4 warps per (64-key tile, KV head, batch row); each
//     warp owns 16 keys and keeps their dK and dV accumulators (16 x d f32)
//     in registers for the whole block. The block walks the g query heads of
//     its KV head and, for each, the 32-query tiles that can see one of its
//     keys (from the positions), so GQA sums in registers and needs no
//     atomics. Q, dO and the tile's positions, lse and D come through a
//     two-stage cp.async ring;
//   * dQ: one block of 4 warps per (64-query tile, query head, batch row),
//     16 rows a warp with their dQ (16 x d f32) in registers, over the
//     64-key tiles that hold a key valid for one of its rows (a tile whose
//     keys are all invalid for every row is skipped before its copy), K and
//     V through a two-stage cp.async ring; the heaviest causal tiles first.
// bf16 route (the model's): every product on mma.sync.m16n8k16 (bf16 in, f32
// accumulate) with operands from shared memory by ldmatrix (plain for a
// [row][d] operand, .trans for a [k][n] one), P and dS taken straight from
// the accumulators as the A operand of the next product, rounded to bf16.
// Rows are padded by 16 bytes, so the 8 rows an ldmatrix phase reads fall in
// 8 distinct bank groups. p is one FFMA and one ex2 in the log2 domain.
// f32 route (for checks against the plain version): the same blocks with
// f32 FMAs on the CUDA cores (no TF32), two lanes a row, S, P and dS through
// shared memory.
// Left to later work: wgmma and TMA with a producer warp; dQ accumulated in
// the dK/dV kernel's pass (FA2's atomics, which this design avoids for
// determinism, or a second reduction pass).
//
// C interface (loaded with ctypes): the launcher returns the first CUDA
// error of its three launches, or cudaErrorInvalidValue for an unsupported
// dtype, head dim or grid.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

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
// bf16 route: mma.sync, accumulators in registers, cp.async rings
// ---------------------------------------------------------------------------

namespace tc {

typedef __nv_bfloat16 bf16;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;   // keys (dK/dV) or queries (dQ) a block
constexpr int kStepQ = 32;           // queries a step of the dK/dV kernel
constexpr int kStepK = 64;           // keys a step of the dQ kernel

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, or 16 zero bytes when !valid (src unread)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a (16 x 16, row) . b (16 x 8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma16816(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x on the special-function unit (ftz)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two f32 as one bf16x2 register, x in the low half (the lower column)
__device__ __forceinline__ uint32_t pack_bf16(float x, float y) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// c[NT][4] = A . B^T with A the 16 rows at `a` and B the NT * 8 rows at `b`,
// both [row][d] in shared memory at pitch P (elements); the ldmatrix lane
// offsets a_lane / b_lane select each lane's row and half. c's n8 tile j
// holds B rows j * 8 + 2 tg + {0, 1} of A rows gq (c0, c1), gq + 8 (c2, c3).
template <int D, int NT>
__device__ __forceinline__ void mma_abt(uint32_t a, uint32_t b,
                                        float (&c)[NT][4]) {
  constexpr int P = D + 8;
  const int lane = threadIdx.x & 31, lr = lane & 7, lm = lane >> 3;
  const uint32_t a_lane = 2 * (((lm & 1) * 8 + lr) * P + (lm >> 1) * 8);
  const uint32_t b_lane = 2 * (((lm >> 1) * 8 + lr) * P + (lm & 1) * 8);
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t af[4];
    ldsm_x4(a + a_lane + 2 * kk * 16, af);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t bf[4];
      ldsm_x4(b + b_lane + 2 * (np * 16 * P + kk * 16), bf);
      mma16816(c[2 * np], af, bf[0], bf[1]);
      mma16816(c[2 * np + 1], af, bf[2], bf[3]);
    }
  }
}

// acc[D / 8][4] += X . B with X (16 x NT * 8) the accumulators x rounded to
// bf16 (n8 tiles 2 kk and 2 kk + 1 are the A fragment of k16 step kk) and B
// the NT * 8 rows at `b`, [k][d] in shared memory at pitch P (.trans)
template <int D, int NT>
__device__ __forceinline__ void mma_xb(const float (&x)[NT][4], uint32_t b,
                                       float (&acc)[D / 8][4]) {
  constexpr int P = D + 8;
  const int lane = threadIdx.x & 31, lr = lane & 7, lm = lane >> 3;
  const uint32_t b_lane = 2 * (((lm & 1) * 8 + lr) * P + (lm >> 1) * 8);
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk) {
    const uint32_t pa[4] = {pack_bf16(x[2 * kk][0], x[2 * kk][1]),
                            pack_bf16(x[2 * kk][2], x[2 * kk][3]),
                            pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]),
                            pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3])};
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      uint32_t bf[4];
      ldsm_x4_t(b + b_lane + 2 * (kk * 16 * P + dp * 16), bf);
      mma16816(acc[2 * dp], pa, bf[0], bf[1]);
      mma16816(acc[2 * dp + 1], pa, bf[2], bf[3]);
    }
  }
}

// rows [r0, r0 + n_rows) of a [*, D] bf16 matrix with row stride `stride`
// into shared memory at pitch D + 8 by cp.async, zeros at or past `n`
template <int D>
__device__ __forceinline__ void copy_rows(uint32_t dst,
                                          const bf16* __restrict__ src,
                                          int64_t stride, int r0, int n,
                                          int n_rows) {
  constexpr int CPR = D / 8, P = D + 8;
  for (int i = threadIdx.x; i < n_rows * CPR; i += kThreads) {
    const int r = i / CPR, c = (i % CPR) * 8;
    const bool ok = r0 + r < n;
    cp_async16(dst + 2 * (r * P + c),
               ok ? src + static_cast<int64_t>(r0 + r) * stride + c : src,
               ok);
  }
}

// A warp's accumulators (16 rows x D, C layout) scaled by `scale`, as bf16
// pairs into rows row0 + gq (+ 8) of `out` (row stride `stride` elements);
// rows at or past n are not written.
template <int D>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 8][4],
                                           float scale, bf16* out,
                                           int64_t stride, int row0, int n) {
  const int lane = threadIdx.x & 31, gq = lane >> 2, tg = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + gq + 8 * r;
    if (row >= n) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(out + row * stride + j * 8 + 2 * tg) =
          pack_bf16(acc[j][2 * r] * scale, acc[j][2 * r + 1] * scale);
  }
}

template <int D>
struct DkdvTile {
  static constexpr int P = D + 8;                                  // elements
  static constexpr uint32_t kK = 0;                                // bytes
  static constexpr uint32_t kV = kK + 2 * kRows * P;
  static constexpr uint32_t kRing = kV + 2 * kRows * P;            // Q dO x 2
  static constexpr uint32_t kStage = 2 * 2 * kStepQ * P;
  static constexpr uint32_t kQPos = kRing + 2 * kStage;            // 2 x kStepQ
  static constexpr uint32_t kLse = kQPos + 4 * 2 * kStepQ;
  static constexpr uint32_t kDsum = kLse + 4 * 2 * kStepQ;
  static constexpr uint32_t kKPos = kDsum + 4 * 2 * kStepQ;
  static constexpr uint32_t kRed = kKPos + 4 * kRows;
  static constexpr size_t kBytes = kRed + 4 * 2 * kWarps;
  static_assert(D % 16 == 0 && D <= 128, "k16 steps, pairs of n8 tiles");
  static_assert(kBytes <= 232448, "a block's shared memory");
};

template <int D>
__global__ void __launch_bounds__(kThreads)
dkdv_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const bf16* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ dsum,
               const int* __restrict__ q_pos, const int* __restrict__ k_pos,
               bf16* __restrict__ dk, bf16* __restrict__ dv, int sq, int skv,
               int hq, int hkv, int causal, float scale_log2, float scale) {
  using L = DkdvTile<D>;
  constexpr int NS = kStepQ / 8;             // n8 tiles of S^T a warp
  constexpr int NO = D / 8;                  // n8 tiles of dK, dV
  extern __shared__ __align__(128) unsigned char smem[];
  int* sQPos = reinterpret_cast<int*>(smem + L::kQPos);     // [2][kStepQ]
  float* sLse = reinterpret_cast<float*>(smem + L::kLse);   // log2 domain
  float* sDsum = reinterpret_cast<float*>(smem + L::kDsum);
  int* sKPos = reinterpret_cast<int*>(smem + L::kKPos);
  int* sRed = reinterpret_cast<int*>(smem + L::kRed);
  const uint32_t sbase = smem_addr(smem);
  const auto q_addr = [&](int slot) {
    return sbase + L::kRing + slot * L::kStage;
  };
  const auto do_addr = [&](int slot) {
    return q_addr(slot) + 2 * kStepQ * L::P;
  };

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tg = lane & 3;
  const int k0 = blockIdx.x * kRows;
  const int kh = blockIdx.y, b = blockIdx.z, g = hq / hkv;
  const int64_t kstride = static_cast<int64_t>(hkv) * D;
  const int64_t qstride = static_cast<int64_t>(hq) * D;
  const int64_t kb = (static_cast<int64_t>(b) * skv * hkv + kh) * D;

  // K and V tiles: with the first Q/dO stage, the first cp.async group
  copy_rows<D>(sbase + L::kK, k + kb, kstride, k0, skv, kRows);
  copy_rows<D>(sbase + L::kV, v + kb, kstride, k0, skv, kRows);
  for (int i = tid; i < kRows; i += kThreads)
    sKPos[i] = k0 + i < skv ? k_pos[k0 + i] : -1;
  __syncthreads();
  int kmin = INT_MAX;
  for (int r = 0; r < kRows; ++r)
    if (sKPos[r] >= 0) kmin = min(kmin, sKPos[r]);
  int q_lo, q_hi;
  index_range<kThreads>(
      q_pos, kmin == INT_MAX ? 0 : sq,
      [&](int p) { return !causal || p >= kmin; }, sRed, q_lo, q_hi);
  const int t_lo = q_hi < 0 ? 0 : q_lo / kStepQ;
  const int nt = q_hi < 0 ? 0 : q_hi / kStepQ + 1 - t_lo;
  const int items = g * nt;                  // (query head, query tile)
  // this lane's keys: gq and gq + 8 of the warp's 16
  const int kr0 = warp * 16;
  const int kp[2] = {sKPos[kr0 + gq], sKPos[kr0 + 8 + gq]};

  // Q and dO rows of item n, with their positions, lse and D -> slot
  const auto load_item = [&](int n, int slot) {
    const int h = kh * g + n / nt;
    const int q0 = (t_lo + n % nt) * kStepQ;
    const int64_t qb = (static_cast<int64_t>(b) * sq * hq + h) * D;
    copy_rows<D>(q_addr(slot), q + qb, qstride, q0, sq, kStepQ);
    copy_rows<D>(do_addr(slot), dout + qb, qstride, q0, sq, kStepQ);
    const int64_t lb = (static_cast<int64_t>(b) * hq + h) * sq;
    for (int i = tid; i < kStepQ; i += kThreads) {
      const bool in = q0 + i < sq;
      sQPos[slot * kStepQ + i] = in ? q_pos[q0 + i] : INT_MIN;
      sLse[slot * kStepQ + i] = in ? lse[lb + q0 + i] * kLog2e : 0.f;
      sDsum[slot * kStepQ + i] = in ? dsum[lb + q0 + i] : 0.f;
    }
  };

  float dka[NO][4], dva[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.f;

  if (items > 0) load_item(0, 0);
  cp_commit();
  for (int n = 0; n < items; ++n) {
    const int slot = n & 1;
    cp_wait<0>();                            // item n (and K, V) landed
    __syncthreads();                         // for every thread; and every
    // warp is done with item n - 1, so the other slot takes the next copy
    if (n + 1 < items) load_item(n + 1, slot ^ 1);
    cp_commit();

    // S^T = K Q^T and dP^T = V dO^T: 16 keys x 32 queries a warp
    float s[NS][4], dp[NS][4];
    mma_abt<D, NS>(sbase + L::kK + 2 * kr0 * L::P, q_addr(slot), s);
    mma_abt<D, NS>(sbase + L::kV + 2 * kr0 * L::P, do_addr(slot), dp);
    const int* qpos = sQPos + slot * kStepQ;
    const float* lse2 = sLse + slot * kStepQ;
    const float* dd = sDsum + slot * kStepQ;
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = j * 8 + 2 * tg + (e & 1);
        const int key = kp[e >> 1], qp = qpos[c];
        const bool ok = key >= 0 && qp != INT_MIN && (!causal || key <= qp);
        const float p =
            ok ? exp2_approx(fmaf(s[j][e], scale_log2, -lse2[c])) : 0.f;
        s[j][e] = p;                         // P^T
        dp[j][e] = p * (dp[j][e] - dd[c]);   // dS^T
      }
    // dV += P^T dO, dK += dS^T Q
    mma_xb<D, NS>(s, do_addr(slot), dva);
    mma_xb<D, NS>(dp, q_addr(slot), dka);
  }
  cp_wait<0>();

  bf16* dkb = dk + kb + static_cast<int64_t>(k0) * kstride;
  bf16* dvb = dv + kb + static_cast<int64_t>(k0) * kstride;
  store_rows<D>(dka, scale, dkb, kstride, kr0, skv - k0);
  store_rows<D>(dva, 1.f, dvb, kstride, kr0, skv - k0);
}

template <int D>
struct DqTile {
  static constexpr int P = D + 8;
  static constexpr uint32_t kQ = 0;                                // bytes
  static constexpr uint32_t kDO = kQ + 2 * kRows * P;
  static constexpr uint32_t kRing = kDO + 2 * kRows * P;           // K V x 2
  static constexpr uint32_t kStage = 2 * 2 * kStepK * P;
  static constexpr uint32_t kKPos = kRing + 2 * kStage;            // 2 x kStepK
  static constexpr uint32_t kQPos = kKPos + 4 * 2 * kStepK;
  static constexpr uint32_t kRed = kQPos + 4 * kRows;
  static constexpr size_t kBytes = kRed + 4 * 2 * kWarps;
  static_assert(kBytes <= 232448, "a block's shared memory");
};

template <int D>
__global__ void __launch_bounds__(kThreads)
dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, const bf16* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ dsum,
             const int* __restrict__ q_pos, const int* __restrict__ k_pos,
             bf16* __restrict__ dq, int sq, int skv, int hq, int hkv,
             int causal, float scale_log2, float scale) {
  using L = DqTile<D>;
  constexpr int NS = kStepK / 8;             // n8 tiles of S a warp
  constexpr int NO = D / 8;                  // n8 tiles of dQ
  extern __shared__ __align__(128) unsigned char smem[];
  int* sKPos = reinterpret_cast<int*>(smem + L::kKPos);     // [2][kStepK]
  int* sQPos = reinterpret_cast<int*>(smem + L::kQPos);
  int* sRed = reinterpret_cast<int*>(smem + L::kRed);
  const uint32_t sbase = smem_addr(smem);
  const auto k_addr = [&](int slot) {
    return sbase + L::kRing + slot * L::kStage;
  };
  const auto v_addr = [&](int slot) {
    return k_addr(slot) + 2 * kStepK * L::P;
  };

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tg = lane & 3;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;
  const int h = blockIdx.y, b = blockIdx.z, g = hq / hkv, kh = h / g;
  const int64_t qstride = static_cast<int64_t>(hq) * D;
  const int64_t kstride = static_cast<int64_t>(hkv) * D;
  const int64_t qb = (static_cast<int64_t>(b) * sq * hq + h) * D;
  const int64_t kb = (static_cast<int64_t>(b) * skv * hkv + kh) * D;

  copy_rows<D>(sbase + L::kQ, q + qb, qstride, q0, sq, kRows);
  copy_rows<D>(sbase + L::kDO, dout + qb, qstride, q0, sq, kRows);
  for (int i = tid; i < kRows; i += kThreads)
    sQPos[i] = q0 + i < sq ? q_pos[q0 + i] : INT_MIN;
  __syncthreads();
  int qmax = INT_MIN;
  for (int r = 0; r < kRows; ++r) qmax = max(qmax, sQPos[r]);
  int k_lo, k_hi;
  index_range<kThreads>(
      k_pos, skv, [&](int p) { return p >= 0 && (!causal || p <= qmax); },
      sRed, k_lo, k_hi);
  const int t_lo = k_hi < 0 ? 0 : k_lo / kStepK;
  const int t_hi = k_hi < 0 ? 0 : k_hi / kStepK + 1;
  // this lane's rows: gq and gq + 8 of the warp's
  const int r0 = warp * 16;
  int qp[2];
  float lse2[2], dd[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = q0 + r0 + gq + 8 * r;
    const int64_t at = (static_cast<int64_t>(b) * hq + h) * sq + i;
    qp[r] = sQPos[r0 + gq + 8 * r];
    lse2[r] = i < sq ? lse[at] * kLog2e : 0.f;
    dd[r] = i < sq ? dsum[at] : 0.f;
  }

  // key positions of tile t for this lane: keys lane and lane + 32 (-1 past
  // skv, and for t >= t_hi)
  const auto load_kp = [&](int t, int (&kp)[2]) {
    const int j = t * kStepK + lane;
    kp[0] = t < t_hi && j < skv ? k_pos[j] : -1;
    kp[1] = t < t_hi && j + 32 < skv ? k_pos[j + 32] : -1;
  };
  // the first tile >= t (below t_hi) with a key valid for some row of the
  // block, given kp of tile t; every warp votes alike, so no barrier
  const auto next_live = [&](int t, int (&kp)[2]) {
    while (t < t_hi &&
           !__any_sync(0xffffffffu,
                       (kp[0] >= 0 && (!causal || kp[0] <= qmax)) ||
                           (kp[1] >= 0 && (!causal || kp[1] <= qmax))))
      load_kp(++t, kp);
    return t;
  };
  const auto load_kv = [&](int t, int slot, const int (&kp)[2]) {
    copy_rows<D>(k_addr(slot), k + kb, kstride, t * kStepK, skv, kStepK);
    copy_rows<D>(v_addr(slot), v + kb, kstride, t * kStepK, skv, kStepK);
    if (warp == 0) {
      sKPos[slot * kStepK + lane] = kp[0];
      sKPos[slot * kStepK + lane + 32] = kp[1];
    }
  };

  int kp_cur[2], kp_nxt[2];
  load_kp(t_lo, kp_cur);
  int t = next_live(t_lo, kp_cur);
  if (t < t_hi) load_kv(t, 0, kp_cur);
  cp_commit();
  load_kp(t + 1, kp_nxt);

  float dqa[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[j][e] = 0.f;

  for (int n = 0; t < t_hi; ++n) {
    const int slot = n & 1;
    const int t_next = next_live(t + 1, kp_nxt);
    cp_wait<0>();                            // tile t (and Q, dO) landed
    __syncthreads();
    if (t_next < t_hi) load_kv(t_next, slot ^ 1, kp_nxt);
    cp_commit();
    load_kp(t_next + 1, kp_nxt);

    // S = Q K^T and dP = dO V^T: 16 rows x 64 keys a warp
    float s[NS][4], dp[NS][4];
    mma_abt<D, NS>(sbase + L::kQ + 2 * r0 * L::P, k_addr(slot), s);
    mma_abt<D, NS>(sbase + L::kDO + 2 * r0 * L::P, v_addr(slot), dp);
    const int* kpos = sKPos + slot * kStepK;
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int key = kpos[j * 8 + 2 * tg + (e & 1)];
        const bool ok =
            key >= 0 && qp[r] != INT_MIN && (!causal || key <= qp[r]);
        const float p =
            ok ? exp2_approx(fmaf(s[j][e], scale_log2, -lse2[r])) : 0.f;
        dp[j][e] = p * (dp[j][e] - dd[r]);   // dS
      }
    // dQ += dS K
    mma_xb<D, NS>(dp, k_addr(slot), dqa);
    t = t_next;
  }
  cp_wait<0>();
  store_rows<D>(dqa, scale, dq + qb + static_cast<int64_t>(q0) * qstride,
                qstride, r0, sq - q0);
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
        dkdv_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(DkdvTile<D>::kBytes));
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(dq_tc_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(DqTile<D>::kBytes));
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const auto* qb = static_cast<const bf16*>(q);
  const auto* kb = static_cast<const bf16*>(k);
  const auto* vb = static_cast<const bf16*>(v);
  const auto* db = static_cast<const bf16*>(dout);
  const auto* lf = static_cast<const float*>(lse);
  const auto* sf = static_cast<const float*>(dsum);
  const auto* qp = static_cast<const int*>(q_pos);
  const auto* kp = static_cast<const int*>(k_pos);
  const float scale_log2 = scale * kLog2e;
  dkdv_tc_kernel<D><<<dim3((skv + kRows - 1) / kRows, hkv, b), kThreads,
                      DkdvTile<D>::kBytes, st>>>(
      qb, kb, vb, db, lf, sf, qp, kp, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), sq, skv, hq, hkv, causal, scale_log2, scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  dq_tc_kernel<D><<<dim3((sq + kRows - 1) / kRows, hq, b), kThreads,
                    DqTile<D>::kBytes, st>>>(
      qb, kb, vb, db, lf, sf, qp, kp, static_cast<bf16*>(dq), sq, skv, hq,
      hkv, causal, scale_log2, scale);
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

template <int D>
int launch_d(int dtype, int sq, int skv, int b, int hq, int hkv,
             cudaStream_t st, const void* q, const void* k, const void* v,
             const void* o, const void* lse, const void* dout,
             const void* q_pos, const void* k_pos, void* dq, void* dk,
             void* dv, void* dsum, int causal, float scale) {
  int rc;
  if (dtype == 0)
    rc = launch_dot<__nv_bfloat16>(st, dout, o, dsum, b, sq, hq, D);
  else if (dtype == 1)
    rc = launch_dot<float>(st, dout, o, dsum, b, sq, hq, D);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  if (rc != 0) return rc;
#define BWD_ARGS                                                            \
  sq, skv, b, hq, hkv, st, q, k, v, dout, lse, dsum, q_pos, k_pos, dq, dk, \
      dv, causal, scale
  if (dtype == 0) return tc::launch<D>(BWD_ARGS);
  return f32::launch<D>(BWD_ARGS);
#undef BWD_ARGS
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
      hkv > 65535 || hq % hkv)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define BWD_CASE(DIM)                                                         \
  case DIM:                                                                   \
    return launch_d<DIM>(dtype, sq, skv, b, hq, hkv, st, q, k, v, o, lse,     \
                         dout, q_pos, k_pos, dq, dk, dv, dsum, causal, scale);
  switch (d) {
    BWD_CASE(16)
    BWD_CASE(32)
    BWD_CASE(48)
    BWD_CASE(64)
    BWD_CASE(80)
    BWD_CASE(96)
    BWD_CASE(112)
    BWD_CASE(128)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef BWD_CASE
}
