// Flash attention over a whole sequence for Hopper (sm_90a): causal or full,
// GQA, query and key positions given per token.
//
//   out[b, i, h, :] = sum_j p_ij v[b, j, h / g, :] / sum_j p_ij,
//   p_ij = exp(s_ij - max_j s_ij),
//   s_ij = (q[b, i, h, :] . k[b, j, h / g, :]) / sqrt(d)
//
// over the keys j that are valid for query i: k_pos[j] >= 0 and, when causal,
// k_pos[j] <= q_pos[i]. q [b, sq, hq, d] and k/v [b, skv, hkv, d] are read
// through their strides (unit stride along d); out is [b, sq, hq, d]
// contiguous in q's dtype. Scores and the running max / sum are f32; p is
// rounded to v's dtype before the PV product, which accumulates in f32. A
// row with no valid key gets zeros (the model never reads such a row).
//
// Replaces the Pallas TPU kernel of the reference package:
//   src/repro/kernels/flash_attention/flash_attention.py  flash_attention
//   (pl.pallas_call at :98, kernel body _kernel :28)
// and computes the function of the reference's jnp `blocked_attention`
// (src/repro/models/attention.py:150-184) with window 0 and no softcap, which
// every full-attention prefill, the encoder and the cross attention call.
// With positions 0..s-1 and sq == skv it is the Pallas kernel's function.
//
// What bounds it on this card: operations. A q-tile of 64 rows against a
// kv-tile of 64 keys does 4 * 64 * 64 * d flops on 2 * 64 * d * 2 bytes of
// K/V; at minitron-8b's prefill (2048 tokens, 32 heads of 128, causal) the
// function needs 34.4 GFLOP (4 * hq * d per valid (query, key) pair) against
// 33.6 MB of q, k, v and out: 0.035 ms at 989 TFLOP/s of bf16 against
// 0.010 ms at 3.35 TB/s.
//
// Design (simple and right first; wgmma, TMA and a producer warp are later
// work):
//   * one block of 4 warps per (64-row q-tile, query head, batch row); the
//     heaviest causal q-tiles are started first (blockIdx.x counts down);
//   * the TPU's sequential kv grid axis is a loop inside the block over
//     kv-tiles of 64 keys, staged in shared memory with 16-byte loads; the
//     Q tile stays in shared memory;
//   * the Pallas kernel's causal `pl.when(live)` skip is a loop bound: the
//     block first finds the first and last key valid for any of its rows
//     (from the positions), and a tile inside that range whose 64 keys are
//     all invalid (-1, or after every query) is skipped before its K/V are
//     loaded. At increasing prefill positions this halves the causal work;
//   * bf16: S = Q K^T and O += P V on the tensor cores with nvcuda::wmma
//     bf16 16x16x16 fragments accumulating in f32 (mma.sync underneath). A
//     bf16 x bf16 product is exact in f32, so S is the reference's f32 dot
//     of bf16 inputs up to summation order. Each warp owns 16 rows of S, P
//     and O; the layout of a fragment's elements is unspecified, so the
//     online softmax (mask from the positions, running m and l in f32
//     registers, two lanes per row) and the rescale of O run on S and O in
//     shared memory. P (bf16) is written over its own rows of S;
//   * f32 (for checks against the plain version): the same loop with f32
//     FMAs on the CUDA cores (TF32 would change the rounding);
//   * shared memory at d 128, bf16: Q, K, V 51 KB, S/P 17 KB, O 33 KB —
//     two blocks per SM. K/V loads are not overlapped with the products of
//     the same block; the other block on the SM covers part of that.
//
// C interface (loaded with ctypes): the launcher returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue for an unsupported dtype, head
// dim or grid.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <climits>
#include <type_traits>

namespace {

using namespace nvcuda;

constexpr int kThreads = 128;      // 4 warps, 16 q rows each
constexpr int kWarps = kThreads / 32;
constexpr int kBQ = 64;            // q rows per block
constexpr int kBK = 64;            // keys per kv-tile
constexpr int kLdS = kBK + 4;      // S row stride, floats (P: 2 * kLdS bf16)
constexpr float kNegInf = -1e30f;  // same finite sentinel as the reference

static_assert(kBQ == 16 * kWarps, "each warp owns 16 rows");
static_assert(kBK == 64, "two lanes per row, 32 keys each");

// Shared-memory layout, byte offsets. Rows are padded so that 16-row wmma
// tiles start 32-byte aligned and neighbouring rows fall in other banks.
template <typename T, int D>
struct Smem {
  static constexpr int kLdIn = D + 16 / static_cast<int>(sizeof(T));  // Q/K/V
  static constexpr int kLdO = D + 4;                                  // O
  static constexpr size_t kQ = 0;
  static constexpr size_t kK = kQ + sizeof(T) * kBQ * kLdIn;
  static constexpr size_t kV = kK + sizeof(T) * kBK * kLdIn;
  static constexpr size_t kS = kV + sizeof(T) * kBK * kLdIn;
  static constexpr size_t kO = kS + sizeof(float) * kBQ * kLdS;
  static constexpr size_t kQPos = kO + sizeof(float) * kBQ * kLdO;
  static constexpr size_t kKPos = kQPos + sizeof(int) * kBQ;
  static constexpr size_t kRed = kKPos + sizeof(int) * kBK;
  static constexpr size_t kBytes = kRed + sizeof(int) * 2 * kWarps;
};

// rows [r0, r0 + 64) of a [n, D] matrix with row stride `stride` (elements)
// into shared memory, 16 bytes a thread per load; rows at or past n are zero
template <typename T, int D>
__device__ __forceinline__ void load_tile(T* dst, const T* __restrict__ src,
                                          int64_t stride, int r0, int n) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CPR = D / VEC;                // 16-byte chunks per row
  constexpr int ITERS = (64 * CPR + kThreads - 1) / kThreads;
  uint4 val[ITERS];
#pragma unroll
  for (int it = 0; it < ITERS; ++it) {
    const int i = it * kThreads + threadIdx.x;
    const int r = i / CPR;
    val[it] = make_uint4(0, 0, 0, 0);
    if (i < 64 * CPR && r0 + r < n)
      val[it] = *reinterpret_cast<const uint4*>(
          src + static_cast<int64_t>(r0 + r) * stride + (i % CPR) * VEC);
  }
#pragma unroll
  for (int it = 0; it < ITERS; ++it) {
    const int i = it * kThreads + threadIdx.x;
    if (i < 64 * CPR)
      *reinterpret_cast<uint4*>(dst + (i / CPR) * Smem<T, D>::kLdIn +
                                (i % CPR) * VEC) = val[it];
  }
}

// s[j] = q_row . k_{2j + half} for this lane's row, unscaled.
template <typename T, int D>
__device__ __forceinline__ void scores(const T* sQ, const T* sK, float* sS,
                                       int warp, int row, int half,
                                       float (&s)[32]) {
  constexpr int LD = Smem<T, D>::kLdIn;
  if constexpr (std::is_same<T, float>::value) {
#pragma unroll
    for (int j = 0; j < 32; ++j) s[j] = 0.f;
    for (int d = 0; d < D; d += 4) {
      const float4 qv = *reinterpret_cast<const float4*>(sQ + row * LD + d);
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const float4 kv =
            *reinterpret_cast<const float4*>(sK + (2 * j + half) * LD + d);
        s[j] = fmaf(qv.x, kv.x, s[j]);
        s[j] = fmaf(qv.y, kv.y, s[j]);
        s[j] = fmaf(qv.z, kv.z, s[j]);
        s[j] = fmaf(qv.w, kv.w, s[j]);
      }
    }
  } else {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kBK / 16];
#pragma unroll
    for (int n = 0; n < kBK / 16; ++n) wmma::fill_fragment(acc[n], 0.f);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> a;
      wmma::load_matrix_sync(a, sQ + warp * 16 * LD + kk * 16, LD);
#pragma unroll
      for (int n = 0; n < kBK / 16; ++n) {
        // K^T as a column-major B: element (d, key) at sK[key * LD + d]
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::col_major> b;
        wmma::load_matrix_sync(b, sK + n * 16 * LD + kk * 16, LD);
        wmma::mma_sync(acc[n], a, b, acc[n]);
      }
    }
#pragma unroll
    for (int n = 0; n < kBK / 16; ++n)
      wmma::store_matrix_sync(sS + warp * 16 * kLdS + n * 16, acc[n], kLdS,
                              wmma::mem_row_major);
    __syncwarp();
#pragma unroll
    for (int j = 0; j < 32; ++j) s[j] = sS[row * kLdS + 2 * j + half];
  }
}

// O[rows of this warp] += P V, P in the S buffer (v's dtype).
template <typename T, int D>
__device__ __forceinline__ void accumulate_pv(const float* sS, const T* sV,
                                              float* sO, int warp, int row,
                                              int half) {
  constexpr int LD = Smem<T, D>::kLdIn;
  constexpr int LDO = Smem<T, D>::kLdO;
  if constexpr (std::is_same<T, float>::value) {
    for (int c0 = 0; c0 < D; c0 += 16) {
      float acc[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[j] = sO[row * LDO + c0 + 2 * j + half];
      for (int k = 0; k < kBK; ++k) {
        const float p = sS[row * kLdS + k];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          acc[j] = fmaf(p, sV[k * LD + c0 + 2 * j + half], acc[j]);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) sO[row * LDO + c0 + 2 * j + half] = acc[j];
    }
  } else {
    const __nv_bfloat16* sP = reinterpret_cast<const __nv_bfloat16*>(sS);
    constexpr int LDP = 2 * kLdS;
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>
        a[kBK / 16];
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      wmma::load_matrix_sync(a[kk], sP + warp * 16 * LDP + kk * 16, LDP);
#pragma unroll
    for (int n = 0; n < D / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      float* o = sO + warp * 16 * LDO + n * 16;
      wmma::load_matrix_sync(acc, o, LDO, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> b;
        wmma::load_matrix_sync(b, sV + kk * 16 * LD + n * 16, LD);
        wmma::mma_sync(acc, a[kk], b, acc);
      }
      wmma::store_matrix_sync(o, acc, LDO, wmma::mem_row_major);
    }
  }
}

__device__ __forceinline__ void store_p(float* sS, int row, int c, float p,
                                        float) {
  sS[row * kLdS + c] = p;
}
__device__ __forceinline__ void store_p(float* sS, int row, int c, float p,
                                        __nv_bfloat16) {
  reinterpret_cast<__nv_bfloat16*>(sS)[row * 2 * kLdS + c] =
      __float2bfloat16(p);
}
__device__ __forceinline__ float to_out(float x, float) { return x; }
__device__ __forceinline__ __nv_bfloat16 to_out(float x, __nv_bfloat16) {
  return __float2bfloat16(x);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, int64_t sqb, int64_t sqs, int64_t sqh,
             const T* __restrict__ k, const T* __restrict__ v, int64_t skb,
             int64_t sks, int64_t skh, const int* __restrict__ q_pos,
             const int* __restrict__ k_pos, T* __restrict__ out, int sq,
             int skv, int hq, int g, int causal, float scale) {
  using L = Smem<T, D>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem + L::kQ);
  T* sK = reinterpret_cast<T*>(smem + L::kK);
  T* sV = reinterpret_cast<T*>(smem + L::kV);
  float* sS = reinterpret_cast<float*>(smem + L::kS);
  float* sO = reinterpret_cast<float*>(smem + L::kO);
  int* sQPos = reinterpret_cast<int*>(smem + L::kQPos);
  int* sKPos = reinterpret_cast<int*>(smem + L::kKPos);
  int* sRed = reinterpret_cast<int*>(smem + L::kRed);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int row = warp * 16 + (lane >> 1);   // this lane pair's q row
  const int half = lane & 1;                 // keys 2j + half of a tile
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const T* qb = q + b * sqb + h * sqh;
  const T* kb = k + b * skb + (h / g) * skh;
  const T* vb = v + b * skb + (h / g) * skh;

  // rows past sq see no key under causal
  if (tid < kBQ) sQPos[tid] = q0 + tid < sq ? q_pos[q0 + tid] : INT_MIN;
  load_tile<T, D>(sQ, qb, sqs, q0, sq);
  for (int i = tid; i < kBQ * L::kLdO; i += kThreads) sO[i] = 0.f;
  __syncthreads();

  // the loop bound: first and last key valid for any row of the tile
  int qmax = INT_MIN;
  for (int r = 0; r < kBQ; ++r) qmax = max(qmax, sQPos[r]);
  int lo = INT_MAX, hi = -1;
  for (int base = 0; base < skv; base += 4 * kThreads) {
    int p[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = base + u * kThreads + tid;
      p[u] = i < skv ? k_pos[i] : -1;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = base + u * kThreads + tid;
      if (p[u] >= 0 && (!causal || p[u] <= qmax)) {
        lo = min(lo, i);
        hi = max(hi, i);
      }
    }
  }
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
  if (lane == 0) {
    sRed[warp] = lo;
    sRed[kWarps + warp] = hi;
  }
  __syncthreads();
  for (int w = 0; w < kWarps; ++w) {
    lo = min(lo, sRed[w]);
    hi = max(hi, sRed[kWarps + w]);
  }
  const int t_lo = hi < 0 ? 0 : lo / kBK;
  const int t_hi = hi < 0 ? 0 : hi / kBK + 1;

  const int qp = sQPos[row];
  float m = kNegInf;   // running max and sum of this lane pair's row
  float l = 0.f;
  for (int t = t_lo; t < t_hi; ++t) {
    const int k0 = t * kBK;
    __syncthreads();   // every warp is done with the previous tile
    int kp = -1;
    if (tid < kBK && k0 + tid < skv) kp = k_pos[k0 + tid];
    if (tid < kBK) sKPos[tid] = kp;
    if (!__syncthreads_or(tid < kBK && kp >= 0 && (!causal || kp <= qmax)))
      continue;        // no key of this tile is valid for any row
    load_tile<T, D>(sK, kb, sks, k0, skv);
    load_tile<T, D>(sV, vb, sks, k0, skv);
    __syncthreads();

    float s[32];
    scores<T, D>(sQ, sK, sS, warp, row, half, s);
    uint32_t valid = 0;
    float tmax = kNegInf;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int kpj = sKPos[2 * j + half];
      if (kpj >= 0 && (!causal || kpj <= qp)) {
        valid |= 1u << j;
        s[j] *= scale;
        tmax = fmaxf(tmax, s[j]);
      }
    }
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    const float m_new = fmaxf(m, tmax);
    const float alpha = expf(m - m_new);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      s[j] = (valid >> j) & 1u ? expf(s[j] - m_new) : 0.f;
      sum += s[j];
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    l = l * alpha + sum;
    m = m_new;
    __syncwarp();      // the pair's reads of S are done before P overwrites it
#pragma unroll
    for (int j = 0; j < 32; ++j) store_p(sS, row, 2 * j + half, s[j], T());
    for (int c = half; c < D; c += 2) sO[row * L::kLdO + c] *= alpha;
    __syncwarp();
    accumulate_pv<T, D>(sS, sV, sO, warp, row, half);
  }

  // normalise, then write the tile's rows with 16-byte stores
  const float den = fmaxf(l, 1e-37f);
  __syncwarp();
  for (int c = half; c < D; c += 2) sO[row * L::kLdO + c] /= den;
  __syncthreads();
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CPR = D / VEC;
  for (int i = tid; i < kBQ * CPR; i += kThreads) {
    const int r = i / CPR;
    const int c = (i % CPR) * VEC;
    if (q0 + r >= sq) continue;
    alignas(16) T vals[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      vals[e] = to_out(sO[r * L::kLdO + c + e], T());
    *reinterpret_cast<uint4*>(
        out + ((static_cast<int64_t>(b) * sq + q0 + r) * hq + h) * D + c) =
        *reinterpret_cast<const uint4*>(vals);
  }
}

template <typename T, int D>
int launch(dim3 grid, cudaStream_t st, const void* q, int64_t sqb,
           int64_t sqs, int64_t sqh, const void* k, const void* v,
           int64_t skb, int64_t sks, int64_t skh, const void* q_pos,
           const void* k_pos, void* out, int sq, int skv, int hq, int g,
           int causal, float scale) {
  constexpr size_t bytes = Smem<T, D>::kBytes;
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  flash_kernel<T, D><<<grid, kThreads, bytes, st>>>(
      static_cast<const T*>(q), sqb, sqs, sqh, static_cast<const T*>(k),
      static_cast<const T*>(v), skb, sks, skh, static_cast<const int*>(q_pos),
      static_cast<const int*>(k_pos), static_cast<T*>(out), sq, skv, hq, g,
      causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dtype(int d, dim3 grid, cudaStream_t st, const void* q,
                 int64_t sqb, int64_t sqs, int64_t sqh, const void* k,
                 const void* v, int64_t skb, int64_t sks, int64_t skh,
                 const void* q_pos, const void* k_pos, void* out, int sq,
                 int skv, int hq, int g, int causal, float scale) {
#define FLASH_CASE(DIM)                                                      \
  case DIM:                                                                  \
    return launch<T, DIM>(grid, st, q, sqb, sqs, sqh, k, v, skb, sks, skh,   \
                          q_pos, k_pos, out, sq, skv, hq, g, causal, scale);
  switch (d) {
    FLASH_CASE(16)
    FLASH_CASE(32)
    FLASH_CASE(48)
    FLASH_CASE(64)
    FLASH_CASE(80)
    FLASH_CASE(96)
    FLASH_CASE(112)
    FLASH_CASE(128)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FLASH_CASE
}

}  // namespace

// dtype: 0 = bfloat16, 1 = float32. Strides are in elements; q [b, sq, hq, d]
// by (sqb, sqs, sqh), k and v [b, skv, hkv, d] by (skb, sks, skh); q_pos [sq]
// and k_pos [skv] int32; out [b, sq, hq, d] contiguous.
extern "C" int flash_attention_launch(
    int dtype, int d, const void* q, long long sqb, long long sqs,
    long long sqh, const void* k, const void* v, long long skb,
    long long sks, long long skh, const void* q_pos, const void* k_pos,
    void* out, int b, int sq, int skv, int hq, int hkv, int causal,
    float scale, void* stream) {
  if (b < 1 || b > 65535 || sq < 1 || skv < 1 || hkv < 1 || hq > 65535 ||
      hq % hkv)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((sq + kBQ - 1) / kBQ, hq, b);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_dtype<__nv_bfloat16>(d, grid, st, q, sqb, sqs, sqh, k, v,
                                       skb, sks, skh, q_pos, k_pos, out, sq,
                                       skv, hq, hq / hkv, causal, scale);
  if (dtype == 1)
    return launch_dtype<float>(d, grid, st, q, sqb, sqs, sqh, k, v, skb, sks,
                               skh, q_pos, k_pos, out, sq, skv, hq, hq / hkv,
                               causal, scale);
  return static_cast<int>(cudaErrorInvalidValue);
}
