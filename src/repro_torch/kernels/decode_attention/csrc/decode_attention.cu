// Flash-decode GQA attention for Hopper (sm_90a): one new query token per
// sequence against its KV cache, dense or paged.
//
// Replaces the Pallas TPU kernels of the reference package:
//   src/repro/kernels/decode_attention/decode_attention.py
//     decode_attention        (pl.pallas_call at :88, kernel body _kernel :30)
//     paged_decode_attention  (pl.pallas_call at :205, _paged_kernel :122)
//
// What bounds it on this card: bytes. A decode step reads every valid K/V
// row once and does 4 flops per element read (two dot products of g heads
// against the row, amortised over the g = Hq/Hkv query heads of the group),
// far below the ~295 flops/byte where the tensor cores would be the limit.
// The least time is (valid K/V bytes + q + o) / 3.35 TB/s.
//
// Design (simple first; split-KV, TMA and wgmma come later):
//   * one block per (batch row, KV head): the block's g query heads share
//     every K/V tile, so each tile is read from device memory once for all
//     of them (the point of GQA);
//   * the KV loop walks tiles of kTile rows in logical order; each thread
//     issues all of its 16-byte K and V loads of a tile before using any,
//     so a block keeps 2 * kTile rows in flight;
//   * online softmax with f32 m / l / acc (the shared core `attend` below),
//     l floored at 1e-37 at the end as the TPU kernel does;
//   * K/V are read through the cache's own layout and strides: dense
//     [B, S, Hkv, D] (passed as a [B, Hkv, S, D] view), paged
//     [P, page, Hkv, D] through a per-row block table. No per-step
//     transpose or copy. Rows at or past a row's length are never read, so
//     the paged kernel touches only pages whose start is below the length
//     (unused table entries are 0, the never-read scratch page);
//   * the arithmetic order depends only on the logical row index, so the
//     dense and the paged kernel give bit-identical results for the same
//     logical cache — which keeps dense and paged engines token-identical.
//
// At the serving shape (B = 8 slots, Hkv = 8) the grid has 64 blocks for
// 132 SMs: half the card idles and each SM streams one block's rows with
// the latency of plain loads. Splitting the KV axis across SMs (and a
// combine pass) is the next step for this kernel.
//
// C interface (loaded with ctypes): each launcher returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue for an unsupported dtype/head_dim.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;          // KV rows per tile (two per lane in softmax)
constexpr int kMaxG = 8;           // query heads per KV head
constexpr float kNegInf = -1e30f;  // same finite sentinel as the reference

static_assert(kMaxG <= kWarps, "one warp per query head in the softmax step");
static_assert(kTile == 64, "the softmax step gives each lane two rows");

__device__ __forceinline__ void to_f32(const uint4& raw, float* out, float) {
  out[0] = __uint_as_float(raw.x);
  out[1] = __uint_as_float(raw.y);
  out[2] = __uint_as_float(raw.z);
  out[3] = __uint_as_float(raw.w);
}

__device__ __forceinline__ void to_f32(const uint4& raw, float* out,
                                       __nv_bfloat16) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ float scalar_f32(float x) { return x; }
__device__ __forceinline__ float scalar_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Row addressing: element offset of logical KV row `row` from the
// (batch row, KV head) base pointer.
struct DenseRows {
  int64_t stride_s;
  __device__ __forceinline__ int64_t operator()(int row) const {
    return row * stride_s;
  }
};

struct PagedRows {
  const int* table;  // this batch row's block table
  int page;
  int64_t stride_p, stride_s;
  __device__ __forceinline__ int64_t operator()(int row) const {
    return static_cast<int64_t>(table[row / page]) * stride_p +
           static_cast<int64_t>(row % page) * stride_s;
  }
};

// The online-softmax core both kernels share. One block computes the g
// query heads of one (batch row, KV head) pair over rows [0, length).
template <typename T, int D, typename Rows>
__device__ __forceinline__ void attend(const T* __restrict__ q, int64_t sqh,
                                       const T* __restrict__ kbase,
                                       const T* __restrict__ vbase, Rows rows,
                                       int length, int g, float scale,
                                       T* __restrict__ out) {
  constexpr int VEC = 16 / sizeof(T);   // elements per 16-byte load
  constexpr int LPR = D / VEC;          // lanes that share one row
  constexpr int R = kThreads / LPR;     // rows per pass of the block
  constexpr int P = kTile / R;          // passes per tile
  static_assert(LPR <= 32 && 32 % LPR == 0, "a row fits in one warp");
  static_assert(P >= 1 && kTile % R == 0, "tile is whole passes");

  __shared__ float s_p[kMaxG][kTile];   // scores, then probabilities
  __shared__ float s_alpha[kMaxG];
  __shared__ float s_l[kMaxG];
  __shared__ float s_red[kWarps][D];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int c = tid % LPR;              // which 16-byte chunk of the row
  const int r = tid / LPR;              // which row of a pass

  float qf[kMaxG][VEC];
  float acc[kMaxG][VEC];
#pragma unroll
  for (int h = 0; h < kMaxG; ++h) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      qf[h][e] = h < g ? scalar_f32(q[h * sqh + c * VEC + e]) : 0.f;
      acc[h][e] = 0.f;
    }
  }
  float m = kNegInf;                    // running max / sum of head `warp`
  float l = 0.f;

  for (int t0 = 0; t0 < length; t0 += kTile) {
    uint4 kr[P], vr[P];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int row = t0 + p * R + r;
      if (row < length) {
        const int64_t off = rows(row) + c * VEC;
        kr[p] = *reinterpret_cast<const uint4*>(kbase + off);
        vr[p] = *reinterpret_cast<const uint4*>(vbase + off);
      } else {
        kr[p] = make_uint4(0, 0, 0, 0);
        vr[p] = make_uint4(0, 0, 0, 0);
      }
    }
    // scores s[h][row] = (q_h . k_row) * scale, masked past the length
#pragma unroll
    for (int p = 0; p < P; ++p) {
      float kf[VEC];
      to_f32(kr[p], kf, T());
      const int ri = p * R + r;
      const bool valid = t0 + ri < length;
#pragma unroll
      for (int h = 0; h < kMaxG; ++h) {
        if (h < g) {
          float d = 0.f;
#pragma unroll
          for (int e = 0; e < VEC; ++e) d = fmaf(qf[h][e], kf[e], d);
#pragma unroll
          for (int o = LPR / 2; o > 0; o >>= 1)
            d += __shfl_xor_sync(0xffffffffu, d, o);
          if (c == 0) s_p[h][ri] = valid ? d * scale : kNegInf;
        }
      }
    }
    __syncthreads();
    // online-softmax update: warp h owns head h's running m and l
    if (warp < g) {
      const float s0 = s_p[warp][lane];
      const float s1 = s_p[warp][lane + 32];
      float tmax = fmaxf(s0, s1);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, o));
      const float m_new = fmaxf(m, tmax);
      const float p0 = expf(s0 - m_new);
      const float p1 = expf(s1 - m_new);
      float sum = p0 + p1;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      const float alpha = expf(m - m_new);
      l = l * alpha + sum;
      m = m_new;
      s_p[warp][lane] = p0;
      s_p[warp][lane + 32] = p1;
      if (lane == 0) s_alpha[warp] = alpha;
    }
    __syncthreads();
    // acc[h] = acc[h] * alpha[h] + sum_rows p[h][row] * v_row
#pragma unroll
    for (int h = 0; h < kMaxG; ++h) {
      if (h < g) {
        const float a = s_alpha[h];
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[h][e] *= a;
      }
    }
#pragma unroll
    for (int p = 0; p < P; ++p) {
      float vf[VEC];
      to_f32(vr[p], vf, T());
      const int ri = p * R + r;
#pragma unroll
      for (int h = 0; h < kMaxG; ++h) {
        if (h < g) {
          const float pr = s_p[h][ri];
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[h][e] = fmaf(pr, vf[e], acc[h][e]);
        }
      }
    }
    __syncthreads();                    // s_p is rewritten by the next tile
  }

  if (warp < g && lane == 0) s_l[warp] = l;
  // sum the partial accumulators of the R row slots in a fixed order:
  // first across the lanes of a warp that share a chunk, then across warps
#pragma unroll
  for (int h = 0; h < kMaxG; ++h) {
    if (h < g) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
#pragma unroll
        for (int o = LPR; o < 32; o <<= 1)
          acc[h][e] += __shfl_xor_sync(0xffffffffu, acc[h][e], o);
      }
    }
  }
  for (int h = 0; h < g; ++h) {
    float part[VEC];
#pragma unroll
    for (int hh = 0; hh < kMaxG; ++hh) {
      if (hh == h) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) part[e] = acc[hh][e];
      }
    }
    if (lane < LPR) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) s_red[warp][c * VEC + e] = part[e];
    }
    __syncthreads();
    for (int d = tid; d < D; d += kThreads) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += s_red[w][d];
      store(out + h * D + d, s / fmaxf(s_l[h], 1e-37f));
    }
    __syncthreads();
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    dense_kernel(const T* __restrict__ q, int64_t sqb, int64_t sqh,
                 const T* __restrict__ k, const T* __restrict__ v,
                 int64_t skb, int64_t sks, int64_t skh,
                 const int* __restrict__ lengths, T* __restrict__ out,
                 int Hkv, int g, int S, float scale) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int length = min(max(lengths[b], 0), S);
  const int64_t base = b * skb + h * skh;
  attend<T, D>(q + b * sqb + h * g * sqh, sqh, k + base, v + base,
               DenseRows{sks}, length, g, scale,
               out + (static_cast<int64_t>(b) * Hkv + h) * g * D);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    paged_kernel(const T* __restrict__ q, int64_t sqb, int64_t sqh,
                 const T* __restrict__ kp, const T* __restrict__ vp,
                 int64_t skp, int64_t sks, int64_t skh,
                 const int* __restrict__ lengths,
                 const int* __restrict__ tables, int pps, int page,
                 T* __restrict__ out, int Hkv, int g, float scale) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int length = min(max(lengths[b], 0), pps * page);
  const int64_t base = h * skh;
  attend<T, D>(q + b * sqb + h * g * sqh, sqh, kp + base, vp + base,
               PagedRows{tables + static_cast<int64_t>(b) * pps, page, skp,
                         sks},
               length, g, scale,
               out + (static_cast<int64_t>(b) * Hkv + h) * g * D);
}

template <typename T>
int launch_dense(int head_dim, dim3 grid, cudaStream_t st, const void* q,
                 int64_t sqb, int64_t sqh, const void* k, const void* v,
                 int64_t skb, int64_t sks, int64_t skh, const void* lengths,
                 void* out, int Hkv, int g, int S, float scale) {
  const T* qq = static_cast<const T*>(q);
  const T* kk = static_cast<const T*>(k);
  const T* vv = static_cast<const T*>(v);
  const int* ll = static_cast<const int*>(lengths);
  T* oo = static_cast<T*>(out);
  switch (head_dim) {
    case 32:
      dense_kernel<T, 32><<<grid, kThreads, 0, st>>>(
          qq, sqb, sqh, kk, vv, skb, sks, skh, ll, oo, Hkv, g, S, scale);
      break;
    case 64:
      dense_kernel<T, 64><<<grid, kThreads, 0, st>>>(
          qq, sqb, sqh, kk, vv, skb, sks, skh, ll, oo, Hkv, g, S, scale);
      break;
    case 128:
      dense_kernel<T, 128><<<grid, kThreads, 0, st>>>(
          qq, sqb, sqh, kk, vv, skb, sks, skh, ll, oo, Hkv, g, S, scale);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_paged(int head_dim, dim3 grid, cudaStream_t st, const void* q,
                 int64_t sqb, int64_t sqh, const void* k, const void* v,
                 int64_t skp, int64_t sks, int64_t skh, const void* lengths,
                 const void* tables, int pps, int page, void* out, int Hkv,
                 int g, float scale) {
  const T* qq = static_cast<const T*>(q);
  const T* kk = static_cast<const T*>(k);
  const T* vv = static_cast<const T*>(v);
  const int* ll = static_cast<const int*>(lengths);
  const int* tt = static_cast<const int*>(tables);
  T* oo = static_cast<T*>(out);
  switch (head_dim) {
    case 32:
      paged_kernel<T, 32><<<grid, kThreads, 0, st>>>(
          qq, sqb, sqh, kk, vv, skp, sks, skh, ll, tt, pps, page, oo, Hkv, g,
          scale);
      break;
    case 64:
      paged_kernel<T, 64><<<grid, kThreads, 0, st>>>(
          qq, sqb, sqh, kk, vv, skp, sks, skh, ll, tt, pps, page, oo, Hkv, g,
          scale);
      break;
    case 128:
      paged_kernel<T, 128><<<grid, kThreads, 0, st>>>(
          qq, sqb, sqh, kk, vv, skp, sks, skh, ll, tt, pps, page, oo, Hkv, g,
          scale);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = bfloat16, 1 = float32. Strides are in elements.
extern "C" int decode_attention_launch(
    int dtype, int head_dim, const void* q, long long sqb, long long sqh,
    const void* k, const void* v, long long skb, long long sks,
    long long skh, const void* lengths, void* out, int B, int Hkv, int g,
    int S, float scale, void* stream) {
  if (g < 1 || g > kMaxG) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(Hkv, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_dense<__nv_bfloat16>(head_dim, grid, st, q, sqb, sqh, k, v,
                                       skb, sks, skh, lengths, out, Hkv, g, S,
                                       scale);
  if (dtype == 1)
    return launch_dense<float>(head_dim, grid, st, q, sqb, sqh, k, v, skb,
                               sks, skh, lengths, out, Hkv, g, S, scale);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int paged_decode_attention_launch(
    int dtype, int head_dim, const void* q, long long sqb, long long sqh,
    const void* k_pages, const void* v_pages, long long skp, long long sks,
    long long skh, const void* lengths, const void* tables, int pps,
    int page, void* out, int B, int Hkv, int g, float scale, void* stream) {
  if (g < 1 || g > kMaxG) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(Hkv, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_paged<__nv_bfloat16>(head_dim, grid, st, q, sqb, sqh,
                                       k_pages, v_pages, skp, sks, skh,
                                       lengths, tables, pps, page, out, Hkv,
                                       g, scale);
  if (dtype == 1)
    return launch_paged<float>(head_dim, grid, st, q, sqb, sqh, k_pages,
                               v_pages, skp, sks, skh, lengths, tables, pps,
                               page, out, Hkv, g, scale);
  return static_cast<int>(cudaErrorInvalidValue);
}
