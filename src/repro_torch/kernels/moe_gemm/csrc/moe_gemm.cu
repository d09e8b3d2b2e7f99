// Grouped expert GEMM and fused SwiGLU for Hopper (sm_90a):
//
//   moe_gemm:       y[e] = x[e] @ w[e]                          [E, C, F]
//   moe_ffn_fused:  y[e] = silu(x[e] @ wg[e]) * (x[e] @ wu[e])  [E, C, F]
//
// x [E, C, D] and w [E, D, F] are both bf16 or both f32, or x is bf16 and
// w int8 with f32 scales [E, 1, F] (w = as_weight({q, s})); products
// accumulate in f32 and the output is written once in x's dtype (the fused
// epilogue runs in f32 and casts once, as the reference's
// `(silu(gate) * up).astype(h.dtype)` does).
//
// The four variants below replace the Pallas TPU kernels of the
// reference package:
//   src/repro/kernels/moe_gemm/moe_gemm.py
//     moe_gemm       (pl.pallas_call at :65, kernel body _kernel_plain :40)
//     moe_ffn_fused  (pl.pallas_call at :90, kernel body _kernel_fused :29)
// The wrapper (moe_gemm.py, `uses_tensor_cores`, `uses_int8`,
// `uses_narrow`) picks one by dtype, shape, strides and alignment; all are
// hand-written, none is a fallback.
//
// What bounds them on this card: bytes, at every shape the port runs. The
// ridge of bf16 tensor cores over HBM is ~295 flops per byte. qwen3-moe
// (E 128, gate/up D 2048 -> F 768, down D 768 -> F 2048) gives C = 8 rows
// per expert at decode, ~8 flops per byte, and C = 160 at a 2048-token
// prefill: 140 flops per byte fused, 124 for the down product. So the
// least time is the weights streamed once from HBM (0.242 / 0.122 ms at
// C 8, 0.275 / 0.155 ms at C 160 with x and y), and a kernel reaches it
// only if every weight byte is read from HBM once per launch and enough
// bytes stay in flight.
//
// 1. The tensor-core variant (bf16; D and F multiples of 8, 16-byte-aligned
//    bases and strides: every shape of the MoE expert FFN).
//    * Swap A and B: y[e]^T = w[e]^T . x[e]^T with mma.sync.m16n8k16 (bf16
//      in, f32 accumulate). The weight tile, stored [k][f] as w is laid
//      out, is the 16-row A operand through ldmatrix.trans; x, stored
//      [c][k] as x is laid out, is the n8 B operand through plain ldmatrix.
//      C = 8 fills one n8 tile, so decode wastes no product; the gate and
//      up accumulators of one (f, c) sit in the same thread, so the SwiGLU
//      runs in registers.
//    * One block per (F-tile, C-chunk, expert), F-tile fastest: every
//      weight byte is read from HBM once per launch (the C-chunks of one
//      F-tile, where C needs more than one, run in the same wave and share
//      it through L2), and the blocks that re-read one expert's x panel
//      run together and find it in L2. Two
//      block shapes, chosen by C (any C is taken: larger C is cut into
//      equal chunks of whole n8 tiles, one block each):
//        C <= 64 (decode): 8 warps along F, each one m16 tile by every n8
//          tile; F-tile 128, up to 64 rows; two blocks an SM;
//        C > 64 (prefill): 16 warps, 8 along F by 2 along C, each 1 (fused)
//          or 2 m16 tiles by 10 n8 tiles; F-tile 128 (fused) or 256, up to
//          160 rows, so qwen3-moe's C 160 is one chunk and each weight
//          tile is streamed once. 16 warps (not 8 with twice the tiles)
//          because the products wait on shared memory: more warps hide
//          more of it, at <= 128 registers a thread (ptxas: a few spills).
//    * A ring of stages (4 of 32 or 64 rows of D at decode, 3 of 64 at
//      prefill) filled by 16-byte cp.async with zero-fill past D, F and C:
//      all but one stage stay in flight while the warps compute on the
//      oldest, ~96 KB of weights an SM at decode. Rows padded by 16 bytes,
//      so each ldmatrix phase hits 8 distinct bank groups. Dynamic shared
//      memory (88-170 KB) above the 48 KB default.
//    * Fragments run one step ahead of the mma's (the next pair of n8
//      tiles, or the next k16 step's weight fragments), so shared-memory
//      reads overlap the tensor-core work within each warp.
//    * Epilogue: silu(g) * u in f32, one cast, the transposed tile staged
//      through shared memory as [c][f] and written with 16-byte stores.
//    * Invariant: no split-K and no atomics. Each output is one f32
//      accumulator updated by the same chain of k16 mma's in increasing k,
//      whatever C, the chunking or the block shape: a row's bits depend on
//      D alone (checked on the card: rows 0-7 at C 160 equal the C 8
//      output bit for bit). So the dense and paged MoE engines stay
//      token-identical and a run repeats bit for bit.
//
// 2. The CUDA-core template (f32 and bf16 shapes outside the other two
//    rules, e.g. the f32 expert products of the small f32 MoE configs):
//    * one block per (C-tile, F-tile of 64, expert), C-tile fastest; at
//      decode there is one C-tile, so every weight element is read from
//      device memory once per launch;
//    * the D loop walks tiles of kBK rows: each thread loads its slice of the
//      next x and weight tiles into registers (16-byte weight loads where
//      shapes and alignment allow, bounds-checked scalar loads elsewhere)
//      while the block computes on the current tile from shared memory;
//    * bounds checks instead of the reference's pad-and-slice copies: any C,
//      D and F;
//    * each output element is one thread's f32 accumulator, updated with one
//      fmaf per d in increasing d (f32 on the CUDA cores, no TF32), so its
//      summation order depends on D alone.
//
// 3. The narrow variant (f32 moe_gemm whose D or F is rank-sized, <= 16:
//    the adapter runtime's grouped route, h [E, C, d] @ A [E, d, r] and
//    t [E, C, r] @ B [E, r, d] at rank r 4-16). The template spends a block
//    per (C-tile, 64 columns, expert) on them: for h@A (d 4096, r 8) 9
//    blocks on 132 SMs, each walking d in series with 7/8 of its columns
//    empty; for t@B each block fills a quarter of one 32-deep D tile. Both
//    products move ~2.4 MB (0.0007 ms at 3.35 TB/s), so what bounds them is
//    the latency of a few dependent steps, and the design cuts the steps:
//    * narrow F (h@A): D is split into kSplit = 128 rows from d = 0, one
//      warp a (split, chunk of rows of C, expert): 288 warps at d 4096.
//      Each lane takes 4 consecutive rows of D with 16-byte loads of x and
//      of the weight rows, reduces them in registers, and the warp folds its
//      lanes by a fixed butterfly (no shared memory, no barrier); the
//      partials go to a workspace, and a second kernel sums them in split
//      order;
//    * narrow D (t@B): one block per (256 columns, expert); each thread
//      reads its 4 columns of the r weight rows once into registers and
//      computes its rows from x's [C, r] panel staged in shared memory,
//      writing 16-byte stores;
//    * f32 on the CUDA cores, no TF32 (the adapter checks compare f32).
//    * Invariant: each output is summed in an order fixed by D alone: the
//      same fma chain per lane, the same butterfly, the same split order
//      (narrow F), or one fma per d in increasing d (narrow D). Not by its
//      row c, C, E or which rows are live, so an adapter session's tokens
//      do not depend on which slots share its group (checked on the card:
//      the mixed batch equals each session alone).
//
// 4. The int8-weight variant (bf16 x, int8 weights with per-column f32
//    scales: mixtral-8x7b's experts, E 8, D 4096 / 14336, F 14336 / 4096,
//    served from a 47 GB int8 tree). Bound by bytes at decode, where it
//    reads half the bf16 variant's (0.28 / 0.14 ms at C 8), by the
//    products at C 640. The tensor-core variant's kernel with kInt8:
//    * the int8 tiles arrive by cp.async into a ring of 32-row stages,
//      unpadded: 16-byte copies where F and the strides are multiples of
//      16 (every mixtral shape), else 8-byte ones (half the copies for
//      the same bytes: 0.76 -> 0.63 ms at the fused decode shape); the
//      scales of the block's columns sit in shared memory;
//    * while the warps compute on stage kt from one set of bf16 tiles,
//      they dequantise stage kt + 1 into the other: bf16(float(q) * s),
//      as_weight's f32 product and rounding, float(q) exact by a byte
//      permute into the mantissa of 2^23 and one subtraction (the
//      int-to-float unit runs at a quarter of the FP32 rate). One barrier
//      a stage, as in the bf16 variant;
//    * the ldmatrix.trans / mma.sync code then runs unchanged on the bf16
//      tiles, so each output is the same k16 chain as the bf16 variant's
//      on as_weight(w), bit for bit (checked on the card at ragged and
//      mixtral's shapes);
//    * decode (C <= 64) takes 8 warps of 2 n8 tiles (16 rows; C 8 fills
//      one), so the x tile is small and 7 (fused) or 10 (down) stages fit
//      beside two bf16 buffers at two blocks an SM; prefill keeps the bf16
//      variant's 16 warps with 5 stages.
//
// C interface (loaded with ctypes): each launcher returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue for arguments it does not take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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

// ---------------------------------------------------------------------------
// tensor-core variant (bf16)
// ---------------------------------------------------------------------------

namespace tc {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, or 16 zero bytes when !valid (src unread)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0));
}
// 8 bytes global -> shared (int8 weight rows), or 8 zero bytes when !valid
__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 8 : 0));
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

// byte j of w (an int8) as an exact float: the byte with its sign bit
// flipped (q + 128) placed in the mantissa of 2^23, minus 2^23 + 128
template <int J>
__device__ __forceinline__ float q_at(uint32_t w) {
  const uint32_t u = __byte_perm(w ^ 0x80808080u, 0x4B000000u, 0x7540 | J);
  return __uint_as_float(u) - 8388736.f;
}

// two floats rounded to bf16 (nearest even), packed low | high
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// d += a (16 x 16, row) . b (16 x 8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma16816(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Warps: WM along F, each MT m16 tiles; WN along C, each NT n8 tiles, the
// tiles of a chunk dealt round-robin (tile j * WN + wn) so the warps stay
// balanced on a partial chunk. Block tile: BF = WM*MT*16 columns of F by
// BN = WN*NT*8 rows of C; the ring holds S stages of BK rows of D. Every
// bf16 tile row is padded by 16 bytes, so the 8 rows an ldmatrix phase
// reads fall in 8 distinct 16-byte bank groups.
//
// kInt8: a stage holds the x tile and the int8 weight tiles [BK][BF]
// (unpadded bytes). After the ring sit two sets of bf16 weight tiles, the
// ones the fragments read (stage kt's, buffer kt & 1) and the ones stage
// kt + 1 is dequantised into meanwhile, then the block's scales [kW][BF].
template <bool kFused, int WM, int WN, int MT, int NT, int BK, int S,
          bool kInt8 = false>
struct Tile {
  static constexpr int kThreads = WM * WN * 32;
  static constexpr int BF = WM * MT * 16;
  static constexpr int BN = WN * NT * 8;
  static constexpr int kW = kFused ? 2 : 1;        // weight tiles per stage
  static constexpr int kXPitch = BK + 8;            // x tile row, elements
  static constexpr int kWPitch = BF + 8;            // weight row, elements
  static constexpr int kXStage = BN * kXPitch;      // elements
  static constexpr int kWStage = BK * kWPitch;      // elements (bf16)
  static constexpr int kQStage = BK * BF;           // bytes (int8)
  static constexpr size_t kStageBytes =
      sizeof(bf16) * kXStage +
      (kInt8 ? kW * kQStage : sizeof(bf16) * kW * kWStage);
  static constexpr size_t kRingBytes = S * kStageBytes;
  static constexpr size_t kBufBytes = sizeof(bf16) * kW * kWStage;
  static constexpr size_t kSmemBytes =
      kRingBytes + (kInt8 ? 2 * kBufBytes + sizeof(float) * kW * BF : 0);
  static constexpr int kYPitch = BF + 8;            // staged output row
  static_assert(NT % 2 == 0, "x fragments load two n8 tiles at a time");
  static_assert(BK % 16 == 0 && S >= 2, "whole k16 steps; a stage ahead");
  static_assert(sizeof(bf16) * BN * kYPitch <= kSmemBytes,
                "the output tile fits the shared memory");
  static_assert(kSmemBytes <= 232448, "a block's shared memory");
  static_assert(!kInt8 || kThreads % (BF / 8) == 0,
                "a thread dequantises the same 8 columns in every row");
  static_assert(!kInt8 || S >= 3, "stage kt + 1 lands while kt computes");
  static_assert(kStageBytes % 16 == 0 && kBufBytes % 16 == 0,
                "16-byte aligned regions");
};

// Grid: (F-tile + nF * C-chunk, expert). Chunk ch holds rows
// [ch * Cc, min(C, (ch + 1) * Cc)) of its expert, Cc <= BN.
//
// kInt8 (the int8-weight variant): wg / wu are int8 [E, D, F] with f32
// scales sg / su [E, 1, F] (expert stride sse, unit stride along F). Each
// stage's int8 tiles arrive by cp.async, half the bytes of bf16.
// While the warps compute on stage kt, they write stage kt + 1's weights
// as bf16(float(q) * s[f]) -- as_weight's arithmetic and rounding -- into
// the other set of bf16 tiles (float(q) by a byte permute and one add, off
// the slow int-to-float path), one barrier a stage as in the bf16 variant;
// the fragment and mma code below runs unchanged on the bf16 tiles. So the
// output equals the bf16 variant's on as_weight(w), bit for bit.
template <bool kFused, int WM, int WN, int MT, int NT, int BK, int S,
          int kMinBlocks, bool kInt8 = false, int kQV = 16>
__global__ void __launch_bounds__(WM * WN * 32, kMinBlocks)
tc_kernel(const bf16* __restrict__ x, int64_t sxe, int64_t sxc,
          const std::conditional_t<kInt8, int8_t, bf16>* __restrict__ wg,
          const std::conditional_t<kInt8, int8_t, bf16>* __restrict__ wu,
          int64_t swe, int64_t swd, const float* __restrict__ sg,
          const float* __restrict__ su, int64_t sse, bf16* __restrict__ y,
          int C, int D, int F, int nF, int Cc) {
  using L = Tile<kFused, WM, WN, MT, NT, BK, S, kInt8>;
  constexpr int BF = L::BF;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp % WM, wn = warp / WM;
  const int f0 = (blockIdx.x % nF) * BF;
  const int c0 = (blockIdx.x / nF) * Cc;
  const int64_t e = blockIdx.y;
  const int rows = min(Cc, C - c0);
  const int rows8 = (rows + 7) & ~7;
  const bf16* xe = x + e * sxe + c0 * sxc;
  const auto* wge = wg + e * swe;
  const auto* wue = wu + e * swe;
  const int nk = (D + BK - 1) / BK;

  // shared memory is addressed as 32-bit byte offsets from one base
  constexpr uint32_t kEl = sizeof(bf16);
  const uint32_t sbase = smem_addr(smem);
  const auto stage_addr = [&](int kt) {
    return sbase + static_cast<uint32_t>((kt % S) * L::kStageBytes);
  };
  // the bf16 weight tiles the fragments read at step kt: in the stage
  // (bf16), or dequantised buffer kt & 1 after the ring (int8)
  const auto wtile_addr = [&](uint32_t st, int kt) {
    return kInt8 ? sbase + static_cast<uint32_t>(L::kRingBytes +
                                                 (kt & 1) * L::kBufBytes)
                 : st + L::kXStage * kEl;
  };
  // int8: the block's scales (0 past F) after the bf16 buffers; this
  // thread dequantises columns qc .. qc + 7 of every row it takes
  float* ssc = reinterpret_cast<float*>(smem_raw + L::kRingBytes +
                                        2 * L::kBufBytes);
  const int qc = (tid % (BF / 8)) * 8;
  if constexpr (kInt8) {
    for (int i = tid; i < L::kW * BF; i += L::kThreads) {
      const int w = i / BF, f = f0 + i % BF;
      ssc[i] = f < F ? (w ? su : sg)[e * sse + f] : 0.f;
    }
  }

  // one ring stage: x rows [0, rows8) (zeros past C and D; rows past
  // rows8 belong to skipped n8 tiles and are never read into a product)
  // and BK rows of each weight tile (zeros past D and F)
  auto load_stage = [&](int kt) {
    const uint32_t st = stage_addr(kt);
    const int k0 = kt * BK;
    for (int i = tid; i < rows8 * (BK / 8); i += L::kThreads) {
      const int r = i / (BK / 8), kc = (i % (BK / 8)) * 8;
      const bool ok = r < rows && k0 + kc < D;
      cp_async16(st + (r * L::kXPitch + kc) * kEl,
                 ok ? xe + r * sxc + k0 + kc : xe, ok);
    }
    // int8 rows in copies of kQV bytes: 16 (cp.async.cg, L2 only) where
    // F, the strides and the bases allow, else 8 (cp.async.ca).
    constexpr int kV = kInt8 ? kQV : 8;        // weights per copy
#pragma unroll
    for (int i = tid; i < BK * BF / kV; i += L::kThreads) {
      const int r = i / (BF / kV), c = (i % (BF / kV)) * kV;
      const bool ok = k0 + r < D && f0 + c < F;
      const int64_t off = ok ? (k0 + r) * swd + f0 + c : 0;
      if constexpr (kInt8) {
        const uint32_t dst = st + L::kXStage * kEl + r * BF + c;
        if constexpr (kQV == 16) {
          cp_async16(dst, wge + off, ok);
          if constexpr (kFused) cp_async16(dst + L::kQStage, wue + off, ok);
        } else {
          cp_async8(dst, wge + off, ok);
          if constexpr (kFused) cp_async8(dst + L::kQStage, wue + off, ok);
        }
      } else {
        const uint32_t dst = st + (L::kXStage + r * L::kWPitch + c) * kEl;
        cp_async16(dst, wge + off, ok);
        if constexpr (kFused)
          cp_async16(dst + L::kWStage * kEl, wue + off, ok);
      }
    }
  };

  // int8: stage kt's int8 tiles -> bf16 buffer kt & 1, 8 weights a
  // thread a row: one 8-byte and two 16-byte (scales) shared loads, 8
  // exact conversions and products in f32, one 16-byte store
  auto dequant_stage = [&](int kt) {
    const unsigned char* qs = smem_raw + (kt % S) * L::kStageBytes +
                              L::kXStage * kEl;
    bf16* ws = reinterpret_cast<bf16*>(smem_raw + L::kRingBytes +
                                       (kt & 1) * L::kBufBytes);
    for (int r = tid / (BF / 8); r < BK; r += L::kThreads / (BF / 8)) {
#pragma unroll
      for (int w = 0; w < L::kW; ++w) {
        const uint2 q = *reinterpret_cast<const uint2*>(
            qs + w * L::kQStage + r * BF + qc);
        const float4 s0 = *reinterpret_cast<const float4*>(ssc + w * BF + qc);
        const float4 s1 =
            *reinterpret_cast<const float4*>(ssc + w * BF + qc + 4);
        uint4 out;
        out.x = pack_bf16(q_at<0>(q.x) * s0.x, q_at<1>(q.x) * s0.y);
        out.y = pack_bf16(q_at<2>(q.x) * s0.z, q_at<3>(q.x) * s0.w);
        out.z = pack_bf16(q_at<0>(q.y) * s1.x, q_at<1>(q.y) * s1.y);
        out.w = pack_bf16(q_at<2>(q.y) * s1.z, q_at<3>(q.y) * s1.w);
        *reinterpret_cast<uint4*>(ws + w * L::kWStage + r * L::kWPitch +
                                  qc) = out;
      }
    }
  };

  float acc[L::kW][MT][NT][4];
#pragma unroll
  for (int w = 0; w < L::kW; ++w)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[w][mt][j][q] = 0.f;

  // ldmatrix lane roles: lane supplies row (lane & 7) of matrix lane >> 3
  const int lr = lane & 7, lm = lane >> 3;
  // A = w^T for k16 step ks: matrices (f 0-7 | 8-15) x (k 0-7 | 8-15) of
  // the [k][f] weight tile, through ldmatrix.trans
  const uint32_t a_lane = ((lr + (lm >> 1) * 8) * L::kWPitch +
                           wm * MT * 16 + (lm & 1) * 8) * kEl;
  auto load_a = [&](uint32_t wt, int ks, uint32_t (&a)[L::kW][MT][4]) {
#pragma unroll
    for (int w = 0; w < L::kW; ++w)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ldsm_x4_t(wt + a_lane +
                      (w * L::kWStage + ks * 16 * L::kWPitch + mt * 16) * kEl,
                  a[w][mt]);
  };
  // B = x^T for k16 step ks, pair p: n8 tiles 2p and 2p + 1 of this warp
  // (row blocks (2p + i) * WN + wn), each (k 0-7 | 8-15) of the [c][k] x
  // tile; a pair with no row of the chunk is not loaded
  const uint32_t b_lane =
      (((lm >> 1) * WN + wn) * 8 + lr) * L::kXPitch * kEl + (lm & 1) * 16;
  auto load_b = [&](uint32_t st, int ks, int p, uint32_t (&b)[4]) {
    if ((2 * p * WN + wn) * 8 < rows)
      ldsm_x4(st + b_lane + (2 * p * WN * 8 * L::kXPitch + ks * 16) * kEl, b);
  };

#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < nk) load_stage(s);
    cp_commit();
  }
  if constexpr (kInt8) {
    cp_wait<S - 2>();                // stage 0 and the scales are in shared
    __syncthreads();                 // memory (everyone's)
    dequant_stage(0);
  }
  for (int kt = 0; kt < nk; ++kt) {
    if constexpr (kInt8) {
      cp_wait<S - 3>();              // stage kt + 1 has landed (this
      __syncthreads();               // thread's, then everyone's); bf16
      // buffer kt & 1 is full, the other one and ring slot kt - 1 are free
      if (kt + S - 1 < nk) load_stage(kt + S - 1);
      cp_commit();
      if (kt + 1 < nk) dequant_stage(kt + 1);
    } else {
      cp_wait<S - 2>();              // stage kt has landed (this thread's)
      __syncthreads();               // ... everyone's; slot kt-1 is free
      if (kt + S - 1 < nk) load_stage(kt + S - 1);
      cp_commit();
    }
    const uint32_t st = stage_addr(kt);
    const uint32_t wt = wtile_addr(st, kt);
    // Fragments run one step ahead of the products: while the mma's of
    // step (k16 step ks, x pair p) issue, the ldmatrix of the next step is
    // in flight (the next pair of n8 tiles, or at the last pair the next
    // k16 step's weight fragments and its first pair), so shared-memory
    // reads and tensor-core work overlap within each warp.
    uint32_t a[2][L::kW][MT][4];     // weight (A) fragments, by ks parity
    uint32_t b[2][4];                // one x pair (B, 2 n8 tiles), by step
    load_a(wt, 0, a[0]);
    load_b(st, 0, 0, b[0]);
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks)
#pragma unroll
      for (int p = 0; p < NT / 2; ++p) {
        const int step = ks * (NT / 2) + p;
        if (p + 1 < NT / 2) {
          load_b(st, ks, p + 1, b[(step + 1) & 1]);
        } else if (ks + 1 < BK / 16) {
          load_a(wt, ks + 1, a[(ks + 1) & 1]);
          load_b(st, ks + 1, 0, b[(step + 1) & 1]);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int j = 2 * p + h;
          if ((j * WN + wn) * 8 >= rows) continue;
#pragma unroll
          for (int w = 0; w < L::kW; ++w)
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
              mma16816(acc[w][mt][j], a[ks & 1][w][mt], b[step & 1][2 * h],
                       b[step & 1][2 * h + 1]);
        }
      }
  }
  cp_wait<0>();
  __syncthreads();                   // the ring is free for the output tile

  // epilogue: accumulator (f, c) -> ys[c][f] in bf16, then 16-byte rows
  bf16* ys = smem;
  const int g = lane >> 2, tg = lane & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int t = j * WN + wn;
    if (t * 8 >= rows) continue;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int f = (wm * MT + mt) * 16 + g + (q >> 1) * 8;
        const int c = t * 8 + tg * 2 + (q & 1);
        float v = acc[0][mt][j][q];
        if constexpr (kFused) v = v / (1.f + expf(-v)) * acc[1][mt][j][q];
        ys[c * L::kYPitch + f] = __float2bfloat16(v);
      }
  }
  __syncthreads();
  bf16* ye = y + (e * C + c0) * F;
  for (int i = tid; i < rows * (BF / 8); i += L::kThreads) {
    const int r = i / (BF / 8), c = (i % (BF / 8)) * 8;
    if (f0 + c < F)
      *reinterpret_cast<uint4*>(ye + static_cast<int64_t>(r) * F + f0 + c) =
          *reinterpret_cast<const uint4*>(ys + r * L::kYPitch + c);
  }
}

template <bool kFused, int WM, int WN, int MT, int NT, int BK, int S,
          int kMinBlocks, bool kInt8 = false, int kQV = 16, typename WT>
int launch_tc(const bf16* x, int64_t sxe, int64_t sxc, const WT* wg,
              const WT* wu, int64_t swe, int64_t swd, bf16* y, int E, int C,
              int D, int F, cudaStream_t st, const float* sg = nullptr,
              const float* su = nullptr, int64_t sse = 0) {
  using L = Tile<kFused, WM, WN, MT, NT, BK, S, kInt8>;
  auto kern =
      tc_kernel<kFused, WM, WN, MT, NT, BK, S, kMinBlocks, kInt8, kQV>;
  static bool configured = false;    // once per instantiation
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(L::kSmemBytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const int nF = (F + L::BF - 1) / L::BF;
  const int chunks = (C + L::BN - 1) / L::BN;
  const int Cc = ((C + chunks - 1) / chunks + 7) / 8 * 8;   // <= BN
  const dim3 grid(nF * chunks, E);
  kern<<<grid, L::kThreads, L::kSmemBytes, st>>>(
      x, sxe, sxc, wg, wu, swe, swd, sg, su, sse, y, C, D, F, nF, Cc);
  return static_cast<int>(cudaGetLastError());
}

template <bool kFused>
int dispatch(const void* x, long long sxe, long long sxc, const void* wg,
             const void* wu, long long swe, long long swd, void* y, int E,
             int C, int D, int F, void* stream) {
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  if (E < 1 || E > 65535 || C < 1 || D < 8 || F < 8 || D % 8 || F % 8 ||
      sxe % 8 || sxc % 8 || swe % 8 || swd % 8 || !aligned(x) ||
      !aligned(wg) || !aligned(wu) || !aligned(y))
    return static_cast<int>(cudaErrorInvalidValue);
  const bf16* xx = static_cast<const bf16*>(x);
  const bf16* gg = static_cast<const bf16*>(wg);
  const bf16* uu = static_cast<const bf16*>(wu);
  bf16* yy = static_cast<bf16*>(y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // C <= 64 (decode, short prefills): 8 warps along F, each one m16 tile
  // by every n8 tile (BF 128, BN 64); two blocks an SM, 4-stage rings of
  // 16 KB of weights a stage
  if (C <= 64) {
    if constexpr (kFused)
      return launch_tc<true, 8, 1, 1, 8, 32, 4, 2>(
          xx, sxe, sxc, gg, uu, swe, swd, yy, E, C, D, F, st);
    else
      return launch_tc<false, 8, 1, 1, 8, 64, 4, 1>(
          xx, sxe, sxc, gg, uu, swe, swd, yy, E, C, D, F, st);
  }
  // C > 64 (prefill): 16 warps, 8 along F by 2 along C, each 1 (fused) or
  // 2 (down) m16 tiles by 10 n8 tiles: BF 128 / 256, BN 160, so C 160 is
  // one chunk and each weight tile is streamed once; 3-stage rings of 64
  // rows of D
  return launch_tc<kFused, 8, 2, kFused ? 1 : 2, 10, 64, 3, 1>(
      xx, sxe, sxc, gg, uu, swe, swd, yy, E, C, D, F, st);
}

// The int8-weight variant: 32-row stages, deeper rings (an int8 stage is
// half a bf16 one) and the double-buffered bf16 tiles. C <= 64: 8 warps
// along F by 2 n8 tiles (a decode step's 8 rows fill the first; a larger
// C is cut into chunks of 16 rows), 7 (fused) or 10 (down) stages, two
// blocks an SM, 100-115 KB of weights in flight an SM; C > 64: the bf16
// variant's 16 warps, 5 stages. Each output is still the one k16 chain in
// increasing k, so the bits equal the bf16 variant's whatever the shape.
template <bool kFused>
int dispatch_i8(const void* x, long long sxe, long long sxc, const void* qg,
                const void* qu, long long swe, long long swd, const void* sg,
                const void* su, long long sse, void* y, int E, int C, int D,
                int F, void* stream) {
  const auto aligned = [](const void* p, uintptr_t n) {
    return reinterpret_cast<uintptr_t>(p) % n == 0;
  };
  if (E < 1 || E > 65535 || C < 1 || D < 8 || F < 8 || D % 8 || F % 8 ||
      sxe % 8 || sxc % 8 || swe % 8 || swd % 8 || sse < F ||
      !aligned(x, 16) || !aligned(qg, 16) || !aligned(qu, 16) ||
      !aligned(sg, 4) || !aligned(su, 4) || !aligned(y, 16))
    return static_cast<int>(cudaErrorInvalidValue);
  const bf16* xx = static_cast<const bf16*>(x);
  const int8_t* gg = static_cast<const int8_t*>(qg);
  const int8_t* uu = static_cast<const int8_t*>(qu);
  const float* sgg = static_cast<const float*>(sg);
  const float* suu = static_cast<const float*>(su);
  bf16* yy = static_cast<bf16*>(y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // 16-byte int8 copies: whole 16-byte pieces of every row (F, strides
  // and bases multiples of 16, as at every mixtral shape)
  const bool q16 = F % 16 == 0 && swe % 16 == 0 && swd % 16 == 0;
  const auto go = [&](auto kern_q16) {
    constexpr bool kQ16 = decltype(kern_q16)::value;
    constexpr int kQV = kQ16 ? 16 : 8;
    if (C <= 64) {
      if constexpr (kFused)
        return launch_tc<true, 8, 1, 1, 2, 32, 7, 2, true, kQV>(
            xx, sxe, sxc, gg, uu, swe, swd, yy, E, C, D, F, st, sgg, suu,
            sse);
      else
        return launch_tc<false, 8, 1, 1, 2, 32, 10, 2, true, kQV>(
            xx, sxe, sxc, gg, uu, swe, swd, yy, E, C, D, F, st, sgg, suu,
            sse);
    }
    return launch_tc<kFused, 8, 2, kFused ? 1 : 2, 10, 32, 5, 1, true, kQV>(
        xx, sxe, sxc, gg, uu, swe, swd, yy, E, C, D, F, st, sgg, suu, sse);
  };
  return q16 ? go(std::true_type{}) : go(std::false_type{});
}

}  // namespace tc

// ---------------------------------------------------------------------------
// narrow variant (f32 moe_gemm with D or F rank-sized)
// ---------------------------------------------------------------------------

namespace narrow {

constexpr int kNarrow = 16;      // the largest rank-sized D or F
constexpr int kSplit = 128;      // D rows of one split: 32 lanes x 4
constexpr int kVals = 64;        // partial sums a lane carries (rows x kF)
constexpr int kCols = 256;       // narrow D: output columns per block
constexpr int kRows = 64;        // narrow D: rows of x staged at a time
constexpr int kBatch = 32;       // combine: partials loaded at once (d 4096)

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// One butterfly step: the lane keeps the half of its 2N values that its
// bit o selects (upper if set) and adds the partner's copy of that half.
template <int N>
__device__ __forceinline__ void fold(float (&v)[kVals], int lane, int o) {
  const bool up = lane & o;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float send = up ? v[i] : v[i + N];
    const float keep = up ? v[i + N] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
  }
}

// Narrow F (h@A): one warp per (split s of kSplit rows of D, chunk of kR
// rows of C, expert). Lane l takes the 4 rows d = s * kSplit + 4 l .. + 3:
// a 16-byte load of x per row of C, and the weight rows d .. d + 3 whole
// (kF / 4 16-byte loads each; columns past F and rows past D read as
// zeros). Its partial for (c, f) is one fma chain over its 4 rows in
// increasing d. The warp then sums the 32 lanes' partials by a fixed
// butterfly: at the step of offset o every lane hands the half of its
// values that the lane o away keeps, and adds what it gets; after offsets
// 16, 8, 4, 2, 1 lane l holds values 2 l and 2 l + 1, each the same tree
// over the lanes. The split's partials go to ws [nsplit, E, C, F].
template <int kF>
__global__ void __launch_bounds__(32)
split_kernel(const float* __restrict__ x, int64_t sxe, int64_t sxc,
             const float* __restrict__ w, int64_t swe, int64_t swd,
             float* __restrict__ ws, int E, int C, int D, int F) {
  constexpr int kR = kVals / kF;
  const int lane = threadIdx.x;
  const int s = blockIdx.x, c0 = blockIdx.y * kR;
  const int64_t e = blockIdx.z;
  const int d = s * kSplit + 4 * lane;
  const bool dok = d < D;                    // D % 4 == 0: all 4 or none

  float wr[4][kF];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int q = 0; q < kF / 4; ++q) {
      const float4 v = (dok && 4 * q < F)
                           ? ld4(w + e * swe + (d + r) * swd + 4 * q)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
      wr[r][4 * q] = v.x; wr[r][4 * q + 1] = v.y;
      wr[r][4 * q + 2] = v.z; wr[r][4 * q + 3] = v.w;
    }
  float v[kVals];
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int c = c0 + i;
    const float4 xv = (dok && c < C) ? ld4(x + e * sxe + c * sxc + d)
                                     : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int f = 0; f < kF; ++f)
      v[i * kF + f] = fmaf(xv.w, wr[3][f], fmaf(xv.z, wr[2][f],
                           fmaf(xv.y, wr[1][f], xv.x * wr[0][f])));
  }
  fold<kVals / 2>(v, lane, 16);
  fold<kVals / 4>(v, lane, 8);
  fold<kVals / 8>(v, lane, 4);
  fold<kVals / 16>(v, lane, 2);
  fold<kVals / 32>(v, lane, 1);
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int idx = 2 * lane + q, c = c0 + idx / kF, f = idx % kF;
    if (c < C && f < F)
      ws[((static_cast<int64_t>(s) * E + e) * C + c) * F + f] = v[q];
  }
}

// y[i] = the splits' partials of output i summed in split order, from 0.
__global__ void __launch_bounds__(128)
combine_kernel(const float* __restrict__ ws, float* __restrict__ y, int n,
               int nsplit) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float acc = 0.f;
  for (int s0 = 0; s0 < nsplit; s0 += kBatch) {
    float p[kBatch];                         // a batch of loads in flight
#pragma unroll
    for (int q = 0; q < kBatch; ++q)
      p[q] = s0 + q < nsplit ? ws[static_cast<int64_t>(s0 + q) * n + i] : 0.f;
#pragma unroll
    for (int q = 0; q < kBatch; ++q) acc += p[q];
  }
  y[i] = acc;
}

// Narrow D (t@B): one block per (kCols columns of F, expert); thread
// (column group cg, row phase rp) holds w[0 .. D)[f .. f + 4) in registers,
// read once, and computes rows rp, rp + 4, ... of x's staged panel; each
// output is one fma chain over d in increasing d (the template's order),
// stored as 16 bytes.
__global__ void __launch_bounds__(256)
narrow_d_kernel(const float* __restrict__ x, int64_t sxe, int64_t sxc,
                const float* __restrict__ w, int64_t swe, int64_t swd,
                float* __restrict__ y, int C, int D, int F) {
  __shared__ float ts[kRows][kNarrow + 1];
  const int tid = threadIdx.x, cg = tid % (kCols / 4), rp = tid / (kCols / 4);
  const int f = blockIdx.x * kCols + 4 * cg;
  const int64_t e = blockIdx.y;
  const bool fok = f < F;                    // F % 4 == 0: all 4 or none
  float4 wr[kNarrow];
#pragma unroll
  for (int k = 0; k < kNarrow; ++k)
    wr[k] = (fok && k < D) ? ld4(w + e * swe + k * swd + f)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c0 = 0; c0 < C; c0 += kRows) {
    __syncthreads();                         // the previous panel is read
    for (int i = tid; i < kRows * kNarrow; i += 256) {
      const int r = i / kNarrow, k = i % kNarrow;
      ts[r][k] = (c0 + r < C && k < D) ? x[e * sxe + (c0 + r) * sxc + k]
                                       : 0.f;
    }
    __syncthreads();
    if (!fok) continue;
    for (int r = rp; r < kRows && c0 + r < C; r += 256 / (kCols / 4)) {
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int k = 0; k < kNarrow; ++k) {
        if (k < D) {
          const float t = ts[r][k];
          acc.x = fmaf(t, wr[k].x, acc.x); acc.y = fmaf(t, wr[k].y, acc.y);
          acc.z = fmaf(t, wr[k].z, acc.z); acc.w = fmaf(t, wr[k].w, acc.w);
        }
      }
      *reinterpret_cast<float4*>(y + (e * C + c0 + r) * F + f) = acc;
    }
  }
}

template <int kF>
int launch_split(const float* x, int64_t sxe, int64_t sxc, const float* w,
                 int64_t swe, int64_t swd, float* y, float* ws, int E, int C,
                 int D, int F, cudaStream_t st) {
  const int nsplit = (D + kSplit - 1) / kSplit;
  constexpr int kR = kVals / kF;
  if ((C + kR - 1) / kR > 65535) return static_cast<int>(cudaErrorInvalidValue);
  split_kernel<kF><<<dim3(nsplit, (C + kR - 1) / kR, E), 32, 0, st>>>(
      x, sxe, sxc, w, swe, swd, ws, E, C, D, F);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n = E * C * F;
  combine_kernel<<<(n + 127) / 128, 128, 0, st>>>(ws, y, n, nsplit);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(const void* x, long long sxe, long long sxc, const void* w,
             long long swe, long long swd, void* y, void* ws, int E, int C,
             int D, int F, void* stream) {
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  if (E < 1 || E > 65535 || C < 1 || D < 4 || F < 4 || D % 4 || F % 4 ||
      (D > kNarrow && F > kNarrow) || sxe % 4 || sxc % 4 || swe % 4 ||
      swd % 4 || !aligned(x) || !aligned(w) || !aligned(y) ||
      static_cast<long long>(E) * C * F > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* xx = static_cast<const float*>(x);
  const float* ww = static_cast<const float*>(w);
  float* yy = static_cast<float*>(y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D <= kNarrow) {
    if (C > 65535 * kRows) return static_cast<int>(cudaErrorInvalidValue);
    narrow_d_kernel<<<dim3((F + kCols - 1) / kCols, E), 256, 0, st>>>(
        xx, sxe, sxc, ww, swe, swd, yy, C, D, F);
    return static_cast<int>(cudaGetLastError());
  }
  float* wsf = static_cast<float*>(ws);
  if (F <= 4)
    return launch_split<4>(xx, sxe, sxc, ww, swe, swd, yy, wsf, E, C, D, F,
                           st);
  if (F <= 8)
    return launch_split<8>(xx, sxe, sxc, ww, swe, swd, yy, wsf, E, C, D, F,
                           st);
  return launch_split<16>(xx, sxe, sxc, ww, swe, swd, yy, wsf, E, C, D, F,
                          st);
}

}  // namespace narrow

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

// The tensor-core variant: bf16 only; D and F multiples of 8; x, w, y
// 16-byte aligned and every stride a multiple of 8 elements (y is a
// contiguous [E, C, F] output).
extern "C" int moe_gemm_tc_launch(const void* x, long long sxe,
                                  long long sxc, const void* w, long long swe,
                                  long long swd, void* y, int E, int C, int D,
                                  int F, void* stream) {
  return tc::dispatch<false>(x, sxe, sxc, w, w, swe, swd, y, E, C, D, F,
                             stream);
}

extern "C" int moe_ffn_fused_tc_launch(const void* x, long long sxe,
                                       long long sxc, const void* w_gate,
                                       const void* w_up, long long swe,
                                       long long swd, void* y, int E, int C,
                                       int D, int F, void* stream) {
  return tc::dispatch<true>(x, sxe, sxc, w_gate, w_up, swe, swd, y, E, C, D,
                            F, stream);
}

// The int8-weight variant: bf16 x and y, int8 weights q [E, D, F] with f32
// scales s [E, 1, F] (expert stride sse >= F, unit stride along F); the
// tensor-core variant's rules on x, q and y otherwise. The output is the
// tensor-core variant's on the bf16 weights bf16(float(q) * s), bit for bit.
extern "C" int moe_gemm_i8_launch(const void* x, long long sxe,
                                  long long sxc, const void* q, long long swe,
                                  long long swd, const void* s,
                                  long long sse, void* y, int E, int C, int D,
                                  int F, void* stream) {
  return tc::dispatch_i8<false>(x, sxe, sxc, q, q, swe, swd, s, s, sse, y, E,
                                C, D, F, stream);
}

extern "C" int moe_ffn_fused_i8_launch(const void* x, long long sxe,
                                       long long sxc, const void* q_gate,
                                       const void* q_up, long long swe,
                                       long long swd, const void* s_gate,
                                       const void* s_up, long long sse,
                                       void* y, int E, int C, int D, int F,
                                       void* stream) {
  return tc::dispatch_i8<true>(x, sxe, sxc, q_gate, q_up, swe, swd, s_gate,
                               s_up, sse, y, E, C, D, F, stream);
}

// The narrow variant: f32 moe_gemm with D or F at most 16 (D <= 16 takes
// the narrow-D kernel, else the split kernel and its combine), D and F
// multiples of 4, x, w and y 16-byte aligned and every stride a multiple of
// 4 elements (y is a contiguous [E, C, F] output). ws holds
// moe_gemm_narrow_ws_floats(E, C, D, F) floats, written before they are
// read.
extern "C" int moe_gemm_narrow_launch(const void* x, long long sxe,
                                      long long sxc, const void* w,
                                      long long swe, long long swd, void* y,
                                      void* ws, int E, int C, int D, int F,
                                      void* stream) {
  return narrow::dispatch(x, sxe, sxc, w, swe, swd, y, ws, E, C, D, F,
                          stream);
}

extern "C" long long moe_gemm_narrow_ws_floats(int E, int C, int D, int F) {
  if (D <= narrow::kNarrow) return 0;
  return static_cast<long long>((D + narrow::kSplit - 1) / narrow::kSplit) *
         E * C * F;
}
