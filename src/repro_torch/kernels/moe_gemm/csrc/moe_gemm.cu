// Grouped expert GEMM and fused SwiGLU for Hopper (sm_90a):
//
//   moe_gemm:       y[e] = x[e] @ w[e]                          [E, C, F]
//   moe_ffn_fused:  y[e] = silu(x[e] @ wg[e]) * (x[e] @ wu[e])  [E, C, F]
//
// x [E, C, D] and w [E, D, F] are both bf16 or both f32; products
// accumulate in f32 and the output is written once in x's dtype (the fused
// epilogue runs in f32 and casts once, as the reference's
// `(silu(gate) * up).astype(h.dtype)` does).
//
// Replaces the Pallas TPU kernels of the reference package:
//   src/repro/kernels/moe_gemm/moe_gemm.py
//     moe_gemm       (pl.pallas_call at :65, kernel body _kernel_plain :40)
//     moe_ffn_fused  (pl.pallas_call at :90, kernel body _kernel_fused :29)
//
// What bounds it on this card: bytes, at the shapes the port runs. MoE
// decode gives C = 8 rows per expert (qwen3-moe: E 128, D 2048, F 768), so
// a launch does 2 flops per weight element it reads (4 fused); even
// prefill's C = 160 stays under the ~295 flops/byte where the tensor cores
// would be the limit. The least time is (x + weights + y) / 3.35 TB/s.
//
// Design (simple and right first; mma.sync / wgmma and TMA come later):
//   * one block per (C-tile, F-tile, expert), C-tile fastest, so the blocks
//     that share a weight tile run together; at decode there is one C-tile,
//     so every weight element is read from device memory once per launch
//     and used for all C rows of its expert;
//   * the D loop walks tiles of kBK rows: each thread loads its slice of the
//     next x and weight tiles into registers (16-byte weight loads where
//     shapes and alignment allow, bounds-checked scalar loads elsewhere)
//     while the block computes on the current tile from shared memory;
//   * bounds checks instead of the reference's pad-and-slice copies: any C,
//     D and F, down to D = 8 or F = 8 (the adapter route's rank);
//   * each output element is one thread's f32 accumulator, updated with one
//     fmaf per d in increasing d. Its summation order therefore depends on
//     D alone: not on its row c, on C, on the tile shape or on the grid.
//     That is what makes an adapter session's tokens independent of which
//     slots share its group, and the dense and paged MoE engines
//     token-identical on the card.
//
// C interface (loaded with ctypes): each launcher returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue for an unsupported dtype.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBF = 64;    // output columns per block
constexpr int kBK = 32;    // depth of one D tile
constexpr int kSeg = 8;    // weight elements one thread loads per tile
static_assert(kBK * kBF == kThreads * kSeg, "one weight segment per thread");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Eight consecutive weight elements as f32: one or two 16-byte loads.
__device__ __forceinline__ void load8(const float* p, float* out) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* out) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// This thread's segment of a [kBK, kBF] weight tile: row kr = tid / 8 of
// the tile, columns (tid % 8) * 8 + [0, 8); zeros outside [D, F).
template <typename T>
__device__ __forceinline__ void load_w(const T* __restrict__ w, int64_t swd,
                                       int k, int col, int D, int F,
                                       bool vec_ok, float* out) {
  if (k < D && vec_ok && col + kSeg <= F) {
    load8(w + k * swd + col, out);
    return;
  }
#pragma unroll
  for (int j = 0; j < kSeg; ++j)
    out[j] = (k < D && col + j < F) ? to_f32(w[k * swd + col + j]) : 0.f;
}

// This thread's slice of the next x tile ([BC, kBK], one element per
// kThreads stride) and of the next weight tiles.
template <typename T, int BC, int N, bool kFused>
__device__ __forceinline__ void fetch(const T* __restrict__ xe, int64_t sxc,
                                      const T* __restrict__ wge,
                                      const T* __restrict__ wue, int64_t swd,
                                      int tid, int c0, int k0, int wk, int wc,
                                      int C, int D, int F, bool vec_ok,
                                      float (&rx)[N], float (&rw0)[kSeg],
                                      float (&rw1)[kSeg]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int idx = tid + i * kThreads;
    const int r = idx / kBK, kk = k0 + idx % kBK;
    rx[i] = (c0 + r < C && kk < D) ? to_f32(xe[(c0 + r) * sxc + kk]) : 0.f;
  }
  load_w(wge, swd, k0 + wk, wc, D, F, vec_ok, rw0);
  if constexpr (kFused) load_w(wue, swd, k0 + wk, wc, D, F, vec_ok, rw1);
}

// BC rows per block; each thread owns TM rows x TN columns of the output
// tile, i.e. TM * TN (x2 fused) f32 accumulators.
template <typename T, int BC, int TM, int TN, bool kFused>
__global__ void __launch_bounds__(kThreads)
grouped_kernel(const T* __restrict__ x, int64_t sxe, int64_t sxc,
               const T* __restrict__ wg, const T* __restrict__ wu,
               int64_t swe, int64_t swd, T* __restrict__ y, int C, int D,
               int F, bool vec_ok) {
  constexpr int kCols = kBF / TN;            // threads along F
  static_assert(kCols * (BC / TM) == kThreads, "thread tile covers block");
  static_assert(TN == 1 || TN == 4, "weight reads are scalars or float4");
  constexpr int kXPer = BC * kBK / kThreads; // x elements per thread
  static_assert(kXPer >= 1 && BC * kBK % kThreads == 0, "x tile split");
  constexpr int kSegs = kBF / kSeg;          // load segments per tile row

  __shared__ float xs[kBK][BC + 1];          // x tile, transposed
  __shared__ __align__(16) float ws0[kBK][kBF];
  __shared__ __align__(16) float ws1[kFused ? kBK : 1][kBF];

  const int tid = threadIdx.x;
  const int c0 = blockIdx.x * BC;
  const int f0 = blockIdx.y * kBF;
  const int64_t e = blockIdx.z;
  const T* xe = x + e * sxe;
  const T* wge = wg + e * swe;
  const T* wue = wu + e * swe;

  // this thread's load slot: tile row wk, columns [ws, ws + kSeg)
  const int wk = tid / kSegs;
  const int ws = (tid % kSegs) * kSeg;
  // this thread's output tile: rows tr * TM + [0, TM), columns tc * TN + ..
  const int tc = tid % kCols;
  const int tr = tid / kCols;

  float acc0[TM][TN], acc1[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc0[i][j] = acc1[i][j] = 0.f;

  float rx[kXPer], rw0[kSeg], rw1[kSeg];
  fetch<T, BC, kXPer, kFused>(xe, sxc, wge, wue, swd, tid, c0, 0, wk,
                              f0 + ws, C, D, F, vec_ok, rx, rw0, rw1);
  for (int k0 = 0; k0 < D; k0 += kBK) {
#pragma unroll
    for (int i = 0; i < kXPer; ++i) {
      const int idx = tid + i * kThreads;
      xs[idx % kBK][idx / kBK] = rx[i];
    }
#pragma unroll
    for (int j = 0; j < kSeg; j += 4) {
      *reinterpret_cast<float4*>(&ws0[wk][ws + j]) =
          make_float4(rw0[j], rw0[j + 1], rw0[j + 2], rw0[j + 3]);
      if constexpr (kFused)
        *reinterpret_cast<float4*>(&ws1[wk][ws + j]) =
            make_float4(rw1[j], rw1[j + 1], rw1[j + 2], rw1[j + 3]);
    }
    __syncthreads();
    if (k0 + kBK < D)                        // in flight during the compute
      fetch<T, BC, kXPer, kFused>(xe, sxc, wge, wue, swd, tid, c0, k0 + kBK,
                                  wk, f0 + ws, C, D, F, vec_ok, rx, rw0,
                                  rw1);
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[TM], b0[TN], b1[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[kk][tr * TM + i];
      if constexpr (TN == 4) {
        const float4 v0 = *reinterpret_cast<const float4*>(&ws0[kk][tc * 4]);
        b0[0] = v0.x; b0[1] = v0.y; b0[2] = v0.z; b0[3] = v0.w;
        if constexpr (kFused) {
          const float4 v1 =
              *reinterpret_cast<const float4*>(&ws1[kk][tc * 4]);
          b1[0] = v1.x; b1[1] = v1.y; b1[2] = v1.z; b1[3] = v1.w;
        }
      } else {
        b0[0] = ws0[kk][tc];
        if constexpr (kFused) b1[0] = ws1[kk][tc];
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          acc0[i][j] = fmaf(a[i], b0[j], acc0[i][j]);
          if constexpr (kFused) acc1[i][j] = fmaf(a[i], b1[j], acc1[i][j]);
        }
    }
    __syncthreads();
  }

  // epilogue: y is a contiguous [E, C, F] tensor
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int c = c0 + tr * TM + i;
    if (c >= C) continue;
    T* yrow = y + (e * C + c) * F;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int f = f0 + tc * TN + j;
      if (f >= F) continue;
      float v = acc0[i][j];
      if constexpr (kFused) v = v / (1.f + expf(-v)) * acc1[i][j];
      store(yrow + f, v);
    }
  }
}

template <typename T, bool kFused>
int launch(const void* x, int64_t sxe, int64_t sxc, const void* wg,
           const void* wu, int64_t swe, int64_t swd, void* y, int E, int C,
           int D, int F, bool vec_ok, cudaStream_t st) {
  const T* xx = static_cast<const T*>(x);
  const T* gg = static_cast<const T*>(wg);
  const T* uu = static_cast<const T*>(wu);
  T* yy = static_cast<T*>(y);
  const int nf = (F + kBF - 1) / kBF;
  if (C <= 8) {          // decode: one C-tile, weights read once
    const dim3 grid(1, nf, E);
    grouped_kernel<T, 8, 2, 1, kFused><<<grid, kThreads, 0, st>>>(
        xx, sxe, sxc, gg, uu, swe, swd, yy, C, D, F, vec_ok);
  } else {
    const dim3 grid((C + 63) / 64, nf, E);
    grouped_kernel<T, 64, 4, 4, kFused><<<grid, kThreads, 0, st>>>(
        xx, sxe, sxc, gg, uu, swe, swd, yy, C, D, F, vec_ok);
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool kFused>
int dispatch(int dtype, const void* x, long long sxe, long long sxc,
             const void* wg, const void* wu, long long swe, long long swd,
             void* y, int E, int C, int D, int F, int vec_ok, void* stream) {
  if (E < 1 || E > 65535 || C < 1 || D < 1 || F < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<__nv_bfloat16, kFused>(x, sxe, sxc, wg, wu, swe, swd, y, E,
                                         C, D, F, vec_ok != 0, st);
  if (dtype == 1)
    return launch<float, kFused>(x, sxe, sxc, wg, wu, swe, swd, y, E, C, D,
                                 F, vec_ok != 0, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = bfloat16, 1 = float32. Strides are in elements; x has unit
// stride along D and w along F; y is a contiguous [E, C, F] output.
// vec_ok: weight rows may be read with 16-byte loads (base pointer 16-byte
// aligned, swe and swd multiples of 8 elements).
extern "C" int moe_gemm_launch(int dtype, const void* x, long long sxe,
                               long long sxc, const void* w, long long swe,
                               long long swd, void* y, int E, int C, int D,
                               int F, int vec_ok, void* stream) {
  return dispatch<false>(dtype, x, sxe, sxc, w, w, swe, swd, y, E, C, D, F,
                         vec_ok, stream);
}

// w_gate and w_up share one stride pair.
extern "C" int moe_ffn_fused_launch(int dtype, const void* x, long long sxe,
                                    long long sxc, const void* w_gate,
                                    const void* w_up, long long swe,
                                    long long swd, void* y, int E, int C,
                                    int D, int F, int vec_ok, void* stream) {
  return dispatch<true>(dtype, x, sxe, sxc, w_gate, w_up, swe, swd, y, E, C,
                        D, F, vec_ok, stream);
}
