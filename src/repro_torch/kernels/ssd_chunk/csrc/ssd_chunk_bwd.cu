// The backward of the Mamba-2 SSD chunked scan (ssd_chunk.cu) for Hopper
// (sm_90a), both dtypes of the forward (x, B and C bf16 or f32; dt, A, S0
// and the gradients of y and S_final f32): bf16 on the tensor cores, f32
// on the CUDA cores.
//
// Replaces the gradient JAX takes by autodiff of the reference's
// `_ssd_chunked` (src/repro/models/ssd.py:81-135), whose forward the Pallas
// TPU kernel `ssd_chunk` (src/repro/kernels/ssd_chunk/ssd_chunk.py,
// pl.pallas_call :81) computes; that kernel has no backward of its own.
//
// Per chunk c of Q steps, head h, with cum_i the in-chunk prefix sum of
// dt·A, xdt_j = dt_j x_j, L_ij = exp(cum_i - cum_j) for j <= i, S_in the
// state entering the chunk, dS_out the gradient of the state leaving it:
//
//   dS_in   = exp(cum_Q) dS_out + sum_i exp(cum_i) dy_i^T C_i
//   dxdt_j  = sum_{i>=j} (C_i·B_j) L_ij dy_i + exp(cum_Q - cum_j) dS_out B_j
//   dC_i    = sum_{j<=i} L_ij (dy_i·xdt_j) B_j + exp(cum_i) S_in^T dy_i
//   dB_j    = sum_{i>=j} L_ij (dy_i·xdt_j) C_i + exp(cum_Q - cum_j) dS_out^T xdt_j
//   dx_j    = dt_j dxdt_j,   ddt_j = x_j·dxdt_j + A sum_{i>=j} dcum_i
//   dcum_i  = C_i·dC_i - B_i·dB_i + [i = Q-1] K   (each dot without the
//             diagonal term T_ii = L_ii (C_i·B_i)(dy_i·xdt_i) they share),
//   K       = exp(cum_Q) <dS_out, S_in> + sum_j exp(cum_Q - cum_j) xdt_j·(dS_out B_j)
//   dA      = sum over rows, chunks and steps of dt_j sum_{i>=j} dcum_i
//
// (dC and dB per head; a group's are the sums over its heads.) dcum_i is
// the derivative by cum_i of every exp(...) term: the diagonal's row sums
// (C_i·dC_i's diagonal part), minus its column sums (B_j·dB_j's), the
// carried state's (C_i·dC_i's other part), the state update's (its j
// terms and K). No exp is taken of a positive exponent: only j <= i are
// formed, and every exponent is clamped at 0 (cum is non-increasing in
// exact arithmetic; the clamp keeps a rounding of the prefix sum from
// giving exp(+ulp)). The reference's own gradient takes exp(cum_i -
// cum_j) above the diagonal too and masks after it, which overflows to
// inf there once a chunk's decay passes ~88 and gives NaN (ROADMAP §3).
//
// Three kernels, launched in this order by one call, no floating-point
// atomics (two runs give the same bits; each sum in a fixed order; a batch
// row's bits do not depend on the others). Two routes:
//
// 1. The tensor-core route (x, B and C bf16, hp <= 64: mamba2-1.3b's
//    training, namespace tc). Every product runs on mma.sync.m16n8k16
//    (bf16 in, f32 accumulate). x, B and C are bf16 values, so a product
//    with one of them is exact in it; every f32 operand (dy, the
//    decay-scaled rows e ∘ dy and w ∘ x, the masked decayed score tiles
//    M and W, S_in, dS_out) goes in as hi = bf16(v) plus lo = bf16(v -
//    hi), the products summed in f32: twice against an exact operand,
//    three times (hi hi + lo hi + hi lo) against another split one. One
//    bf16 rounding of dy would break the 1e-4 the f32 gradients are held
//    to. dy·xdt^T is made as (dy·x^T) dt_j, so x stays exact.
//    (a) states_bwd: one block of 8 warps per (64 x 64 tile of [hp, n],
//        head, batch row), one wave at mamba2's shape: it walks the
//        chunks from the last and carries its tile of dS in the mma
//        accumulators, as the forward's ssd_states carries S; the
//        previous chunk's C, dy and dt are copied by cp.async while this
//        one is computed. S_in comes from the forward's workspace (the
//        autograd Function keeps it); without one the wrapper runs the
//        forward's kernels first.
//    (b) chunk_bwd: one block per (chunk, slice of hs heads of one group,
//        batch row), 214.5 KB of the 227 KB of shared memory a block may
//        hold, so one block an SM. The causal half of C·B^T is made once a block, its
//        thirty-six 16 x 16 tiles kept in the registers of the warp that
//        owns each, and so is the slice's W = sum of its heads' W (in head
//        order): C is shared by the group, so dC's diagonal term W B and
//        dB's W^T C are one product a slice, not one a head. Per head:
//        the score tiles, dcum's row and column sums of T = G ∘ W without
//        the diagonal term they share (at a long decay span it is most of
//        each sum), U_i and V_j (dcum's carried-state terms: C_i·(dy_i
//        S_in) as dy_i·(C S_in^T)_i, and xdt_j·(dS_out B_j)), and dxdt,
//        dx, x·dxdt. Then dC and dB of the slice's rows, summed over its
//        heads in order, to a share of the [b, l, nh / hs, n] workspaces.
//        Why mma.sync and not wgmma: the block's eight warps each own a
//        16-row strip of every [Q, *] product, and the causal triangle's
//        16 x 16 tiles are shared round-robin; M's and W's A fragments
//        come from packed tiles by ldmatrix (.trans for M^T and W^T), the
//        scores stay in the warps' accumulators. wgmma's 64-row tiles
//        would need each operand, split halves included, in 128-byte
//        swizzled tiles; no such version was written.
//        Why hs = 8: 256 blocks at mamba2's shape (1.94 waves of 132 at
//        one block an SM), C·B^T made 256 times and the shares' traffic an
//        eighth of a head each's. By replay at the train microbatch, in
//        turns in one call (tools/ssd_bwd_ab.py, H100 SXM at 700 W), the
//        three launches took 0.904-0.905 ms with slices of 8, 0.944-0.961
//        with 4 (512 blocks), 0.970-0.973 with 2 and 1.078-1.092 with 1.
//    (c) ssd_bc_reduce: dB and dC, each element the sum of its group's
//        shares in order, in bf16; dA.
// 2. The CUDA-core route (f32 inputs: the small f32 configs; bf16 with
//    hp > 64), the first design, f32 products in shared memory:
//    (a) ssd_states_bwd: one block per (64 x 64 tile of the [hp, n]
//        state, head, batch row): it walks the chunks from the last,
//        carrying its tile of dS in registers from dS_final, stores
//        dS_out[c] and ends with dS0. This route's forward keeps no S_in,
//        so its block first walks the chunks forward and stores S_in[c]
//        (a recompute of the forward's states: its products are counted
//        in the bound).
//    (b) ssd_chunk_bwd: one block per (chunk, head, batch row), all in
//        parallel: dx, both terms of ddt, per-head dB and dC (f32, to a
//        workspace) and the chunk's share of dA. Its [Q, Q] products go
//        by 64 x 64 sub-blocks of the causal triangle, each made in
//        shared memory and used at once: pass D (rows i: dC), pass E
//        (rows j: dB) and pass X (rows j: dxdt) each start from their
//        carried-state term and add the sub-blocks of their rows; C·B^T
//        and dy·xdt^T are made twice (once for a row of i, once for a
//        column of j) rather than kept: a block holds at most 185 KB of
//        shared memory. dcum's dots C_i·dC_i and B_j·dB_j leave out the
//        diagonal term they share.
//    (c) ssd_bc_reduce, as above, a share a head.
//    Each product is an outer-product loop in shared memory: a thread
//    owns one row r of a 64-row output tile and 4-column groups 4 g + 16 q
//    (+ 0..3) of it; per k it reads A[r][k] (rows at an odd pitch,
//    conflict-free) and one float4 of B[k][...] that the warp shares.
//
// Bound at mamba2-1.3b's training microbatch (b 1, l 4096, nh 64, hp 64,
// n 128, g 1, Q 128; chip_smoke.py computes it from the shapes): the
// function reads x, B, C (bf16), dt, dy (f32) and the states it needs, and
// writes dx, dB, dC, ddt, dA, dS0 (148.9 MB, 0.044 ms at 3.35 TB/s); its
// operations (chip_smoke.ssd_bwd_flops, 34.53 GFLOP) take 0.515 ms at the
// f32 rate, and those the tensor-core route must make with the split
// counted (chip_smoke.ssd_bwd_tc_flops, 79.74 GFLOP) 0.081 ms at the bf16
// rate. So both routes are bound by their operations; the tensor-core
// route's own traffic (the forward's 67 MB of states read, dS_out's 67 MB
// written and read, the shares of dB and dC, each head's dy, x and states
// read twice from L2) lies above the function's bytes.
//
// C interface (loaded with ctypes): the launcher returns cudaGetLastError()
// after the launches, or cudaErrorInvalidValue for a shape or dtype it does
// not take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "mma_sync.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;
constexpr int kQ = 128;          // largest chunk
constexpr int kK = 128;          // largest hp and n
constexpr int kR = 64;           // rows of an output tile / sub-block
constexpr int kAP = kK + 1;      // pitch of an A operand (odd)
constexpr int kTP = kR + 4;      // pitch of a transposed 64-column operand

__device__ __forceinline__ float ldf(const float* p) { return *p; }
__device__ __forceinline__ float ldf(const bf16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void stf(float* p, float v) { *p = v; }
__device__ __forceinline__ void stf(bf16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ float exp0(float v) { return expf(fminf(v, 0.f)); }
__host__ __device__ __forceinline__ int round16(int v) {
  return (v + 15) & ~15;
}

template <typename T>
struct Args {
  const T* x; long long sxb, sxl;     // x[b, l, h, p] at b*sxb + l*sxl + h*hp + p
  const float* dt; const float* A;
  const T* B; long long sbb, sbl;     // B[b, l, g, k] at b*sbb + l*sbl + g*n + k
  const T* C; long long scb, scl;
  const float* S0;                    // [b, nh, hp, n] (the recompute)
  const float* dy;                    // [b, l, nh, hp]
  const float* dSf;                   // [b, nh, hp, n]
  float* S_in;                        // [b, nc, nh, hp, n]
  float* dS_out;                      // [b, nc, nh, hp, n]
  float* dS0;                         // [b, nh, hp, n]
  T* dx;                              // [b, l, nh, hp]
  float* ddt;                         // [b, l, nh]
  float* pdB; float* pdC;             // [b, l, nh / hs, n]: each share
  float* pdA;                         // [b, nc, nh]
  T* dB; T* dC;                       // [b, l, g, n]
  float* dA;                          // [nh]
  int b, L, nh, hp, G, n, Q, nc;
  int hs;                             // heads a share of pdB, pdC sums
  bool vbc, vx, vdy, vs;              // 16-byte rows: B and C, x, dy, states
};

// acc[64 x 16 nq] += A[64][K] (pitch lda) . B[K][16 nq] (pitch ldb, a
// multiple of 4): thread (r = tid % 64, g = tid / 64) owns row r and
// columns 4 g + 16 q + e, q < nq <= NQ.
template <int NQ>
__device__ __forceinline__ void mm(float (&acc)[NQ][4],
                                   const float* __restrict__ a, int lda,
                                   const float* __restrict__ b, int ldb,
                                   int K, int nq) {
  const int r = threadIdx.x & 63, c0 = (threadIdx.x >> 6) * 4;
  const float* ar = a + r * lda;
  for (int k = 0; k < K; ++k) {
    const float av = ar[k];
    const float* bk = b + k * ldb + c0;
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      if (q < nq) {
        const float4 bv = *reinterpret_cast<const float4*>(bk + 16 * q);
        acc[q][0] = fmaf(av, bv.x, acc[q][0]);
        acc[q][1] = fmaf(av, bv.y, acc[q][1]);
        acc[q][2] = fmaf(av, bv.z, acc[q][2]);
        acc[q][3] = fmaf(av, bv.w, acc[q][3]);
      }
    }
  }
}

template <int NQ>
__device__ __forceinline__ void zero(float (&acc)[NQ][4]) {
#pragma unroll
  for (int q = 0; q < NQ; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[q][e] = 0.f;
}

// Rows [0, nr) of a row-major source (row i at src + i * ld, K elements)
// into dst[nr][pitch] as f32, times scale[i] when given; zeros past row
// `rows` of the source and past column K, up to column kp.
template <typename S>
__device__ __forceinline__ void stage_rows(float* dst, int pitch,
                                           const S* __restrict__ src,
                                           long long ld, int nr, int rows,
                                           int K, int kp,
                                           const float* scale) {
  for (int e = threadIdx.x; e < nr * kp; e += kThreads) {
    const int i = e / kp, k = e - i * kp;
    float v = 0.f;
    if (i < rows && k < K) {
      v = ldf(src + i * ld + k);
      if (scale) v *= scale[i];
    }
    dst[i * pitch + k] = v;
  }
}

// Rows [0, 64) transposed: dst[k][i] (pitch kTP), k < kp.
template <typename S>
__device__ __forceinline__ void stage_cols(float* dst,
                                           const S* __restrict__ src,
                                           long long ld, int rows, int K,
                                           int kp, const float* scale) {
  for (int e = threadIdx.x; e < kR * kp; e += kThreads) {
    const int i = e / kp, k = e - i * kp;
    float v = 0.f;
    if (i < rows && k < K) {
      v = ldf(src + i * ld + k);
      if (scale) v *= scale[i];
    }
    dst[k * kTP + i] = v;
  }
}

// dts[kQ] (0 past qlen) and their inclusive prefix sum of dt·A in cum[kQ]
// by one warp, as the forward's bf16 route computes it (4 rows a lane, then
// a shuffle scan). Ends with a barrier.
__device__ __forceinline__ void chunk_cum(const float* __restrict__ dtc,
                                          long long ld, int qlen, float Ah,
                                          float* dts, float* cum) {
  for (int i = threadIdx.x; i < kQ; i += kThreads)
    dts[i] = i < qlen ? dtc[i * ld] : 0.f;
  __syncthreads();
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    float loc[4], run = 0.f;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      run += dts[lane * 4 + r] * Ah;
      loc[r] = run;
    }
    float incl = run;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float v = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += v;
    }
    float excl = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) excl = 0.f;
#pragma unroll
    for (int r = 0; r < 4; ++r) cum[lane * 4 + r] = excl + loc[r];
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// (a) ssd_states_bwd
// ---------------------------------------------------------------------------

struct StatesSmem {
  static constexpr int kA = 0;                    // f32 [64][kAP]
  static constexpr int kB = kA + kR * kAP;        // f32 [kQ][64]
  static constexpr int kDts = kB + kQ * kR;       // f32 [kQ]
  static constexpr int kCum = kDts + kQ;          // f32 [kQ]
  static constexpr int kScale = kCum + kQ;        // f32 [kQ]
  static constexpr int kFloats = kScale + kQ;
};

// Grid (64 x 64 tiles of [hp, n], head, batch row). Thread (r, g) owns row
// p0 + r and columns k0 + 4 g + 16 q + e (q < 4) of the tile. Per chunk:
//   S  <- exp(cum_Q) S  + (w ∘ xdt)^T B,   w_j = exp(cum_Q - cum_j)
//   dS <- exp(cum_Q) dS + (e ∘ dy)^T C,    e_i = exp(cum_i)
// the A operand [p][j] staged transposed (scaled rows), B's or C's tile
// [j][k] as it is.
template <typename T, bool kRecompute>
__global__ void __launch_bounds__(kThreads)
ssd_states_bwd(Args<T> a) {
  extern __shared__ __align__(16) float smem[];
  using S = StatesSmem;
  float* sa = smem + S::kA;
  float* sb = smem + S::kB;
  float* dts = smem + S::kDts;
  float* cum = smem + S::kCum;
  float* scale = smem + S::kScale;
  const int nnt = (a.n + kR - 1) / kR;
  const int p0 = (blockIdx.x / nnt) * kR, k0 = (blockIdx.x % nnt) * kR;
  const int h = blockIdx.y, bb = blockIdx.z;
  const int hpl = min(kR, a.hp - p0), nsl = min(kR, a.n - k0);
  const int grp = h / (a.nh / a.G);
  const int r = threadIdx.x & 63, c0 = (threadIdx.x >> 6) * 4;
  const float Ah = a.A[h];
  const long long hpn = static_cast<long long>(a.hp) * a.n;
  float acc[4][4];

  // the tile of a [hp, n] state at `base`: load (missing elements 0) or
  // store
  const auto tile_io = [&](float* base, bool store) {
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k = c0 + 16 * q + e;
        const bool ok = r < hpl && k < nsl;
        float* at = base + static_cast<long long>(p0 + r) * a.n + k0 + k;
        if (store) {
          if (ok) *at = acc[q][e];
        } else {
          acc[q][e] = ok ? *at : 0.f;
        }
      }
  };
  const auto chunk = [&](int c, bool fwd) {
    const int c0t = c * a.Q, qlen = min(a.Q, a.L - c0t);
    __syncthreads();                  // the previous chunk's readers done
    chunk_cum(a.dt + (static_cast<long long>(bb) * a.L + c0t) * a.nh + h,
              a.nh, qlen, Ah, dts, cum);
    const float clast = cum[kQ - 1];
    for (int i = threadIdx.x; i < kQ; i += kThreads)
      scale[i] = fwd ? exp0(clast - cum[i]) * dts[i] : exp0(cum[i]);
    __syncthreads();
    // A operand [p][j]: x (forward) or dy (backward) rows, scaled
    for (int e = threadIdx.x; e < kR * kQ; e += kThreads) {
      const int j = e / kR, p = e - j * kR;
      float v = 0.f;
      if (j < qlen && p < hpl) {
        const long long t = static_cast<long long>(c0t + j);
        v = fwd ? ldf(a.x + bb * a.sxb + t * a.sxl +
                      static_cast<long long>(h) * a.hp + p0 + p)
                : a.dy[((bb * a.L + t) * a.nh + h) * a.hp + p0 + p];
        v *= scale[j];
      }
      sa[p * kAP + j] = v;
    }
    // B operand [j][k]: B (forward) or C (backward) rows of the tile
    const T* src = fwd ? a.B + bb * a.sbb + c0t * a.sbl
                       : a.C + bb * a.scb + c0t * a.scl;
    const long long ld = fwd ? a.sbl : a.scl;
    for (int e = threadIdx.x; e < kR * kQ; e += kThreads) {
      const int j = e / kR, k = e - j * kR;
      sb[j * kR + k] = (j < qlen && k < nsl)
          ? ldf(src + j * ld + static_cast<long long>(grp) * a.n + k0 + k)
          : 0.f;
    }
    __syncthreads();
    const float el = exp0(clast);
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[q][e] *= el;
    mm<4>(acc, sa, kAP, sb, kR, qlen, 4);
  };

  if (kRecompute) {
    tile_io(const_cast<float*>(a.S0) +
                (static_cast<long long>(bb) * a.nh + h) * hpn, false);
    for (int c = 0; c < a.nc; ++c) {
      tile_io(a.S_in + ((static_cast<long long>(bb) * a.nc + c) * a.nh + h) *
                           hpn, true);
      chunk(c, true);
    }
  }
  tile_io(const_cast<float*>(a.dSf) +
              (static_cast<long long>(bb) * a.nh + h) * hpn, false);
  for (int c = a.nc - 1; c >= 0; --c) {
    tile_io(a.dS_out + ((static_cast<long long>(bb) * a.nc + c) * a.nh + h) *
                           hpn, true);
    chunk(c, false);
  }
  tile_io(a.dS0 + (static_cast<long long>(bb) * a.nh + h) * hpn, true);
}

// ---------------------------------------------------------------------------
// (b) ssd_chunk_bwd
// ---------------------------------------------------------------------------

struct ChunkSmem {
  static constexpr int kA = 0;                     // f32 [64][kAP]
  static constexpr int kB1 = kA + kR * kAP;        // f32 [kK][kK]
  static constexpr int kB2 = kB1 + kK * kK;        // f32 [kK][kTP]
  static constexpr int kSub = kB2 + kK * kTP;      // f32 [64][65]
  static constexpr int kB3 = kSub + kR * (kR + 1); // f32 [64][kK]
  static constexpr int kDts = kB3 + kR * kK;       // f32 [kQ] each:
  static constexpr int kCum = kDts + kQ;
  static constexpr int kEcum = kCum + kQ;          //   exp(cum_i)
  static constexpr int kEdec = kEcum + kQ;         //   exp(cum_Q - cum_i)
  static constexpr int kRow = kEdec + kQ;          //   C_i·dC_i
  static constexpr int kCol = kRow + kQ;           //   B_j·dB_j
  static constexpr int kV = kCol + kQ;             //   the state's j terms
  static constexpr int kDdt = kV + kQ;             //   x_j·dxdt_j
  static constexpr int kRed = kDdt + kQ;           // f32 [4][64]
  static constexpr int kDiag = kRed + 4 * kR;      // f32 [64]
  static constexpr int kK2 = kDiag + kR;           // f32 [kThreads]
  static constexpr int kFloats = kK2 + kThreads;
  static_assert(kB1 % 4 == 0 && kB2 % 4 == 0 && kB3 % 4 == 0,
                "float4 operands stay 16-byte aligned");
};

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
ssd_chunk_bwd(Args<T> a) {
  extern __shared__ __align__(16) float smem[];
  using S = ChunkSmem;
  float* sa = smem + S::kA;
  float* sb1 = smem + S::kB1;
  float* sb2 = smem + S::kB2;
  float* ss = smem + S::kSub;
  float* sb3 = smem + S::kB3;
  float* dts = smem + S::kDts;
  float* cum = smem + S::kCum;
  float* ecum = smem + S::kEcum;
  float* edec = smem + S::kEdec;
  float* rowdot = smem + S::kRow;
  float* coldot = smem + S::kCol;
  float* vv = smem + S::kV;
  float* ddtd = smem + S::kDdt;
  float* red = smem + S::kRed;
  float* dg = smem + S::kDiag;
  float* k2 = smem + S::kK2;

  const int c = blockIdx.x, h = blockIdx.y, bb = blockIdx.z;
  const int c0t = c * a.Q, qlen = min(a.Q, a.L - c0t);
  const int nb = (qlen + kR - 1) / kR;
  const int grp = h / (a.nh / a.G);
  const int r = threadIdx.x & 63, g4 = threadIdx.x >> 6, c0 = g4 * 4;
  const int hp = a.hp, n = a.n, hp16 = round16(hp), n16 = round16(n);
  const float Ah = a.A[h];
  const long long row0 = static_cast<long long>(bb) * a.L + c0t;  // (b, l)
  const long long hpn = static_cast<long long>(hp) * n;
  const long long sidx = ((static_cast<long long>(bb) * a.nc + c) * a.nh + h)
                         * hpn;
  // this chunk's rows of each operand (row i at base + i * ld)
  const float* dyc = a.dy + (row0 * a.nh + h) * hp;
  const long long ldy = static_cast<long long>(a.nh) * hp;
  const T* xc = a.x + bb * a.sxb + c0t * a.sxl +
                static_cast<long long>(h) * hp;
  const T* bc = a.B + bb * a.sbb + c0t * a.sbl +
                static_cast<long long>(grp) * n;
  const T* cc = a.C + bb * a.scb + c0t * a.scl +
                static_cast<long long>(grp) * n;
  const float* sin = a.S_in + sidx;
  const float* dso = a.dS_out + sidx;

  chunk_cum(a.dt + row0 * a.nh + h, a.nh, qlen, Ah, dts, cum);
  const float clast = cum[kQ - 1];
  for (int i = threadIdx.x; i < kQ; i += kThreads) {
    ecum[i] = exp0(cum[i]);
    edec[i] = exp0(clast - cum[i]);
    rowdot[i] = coldot[i] = vv[i] = ddtd[i] = 0.f;
  }
  // K's first term: <dS_out, S_in>, each thread's elements, then in order
  {
    float s = 0.f;
    for (long long e = threadIdx.x; e < hpn; e += kThreads)
      s = fmaf(dso[e], sin[e], s);
    k2[threadIdx.x] = s;
  }

  // the masked, decayed sub-block (its rows from rb, its columns from cb)
  // into ss; `lower`: row index i >= column index j (pass D), else column
  // i >= row j (passes E and X). With `split` (passes D and E) a diagonal
  // sub-block's diagonal goes to dg and is 0 in ss: dC_i's and dB_i's
  // dots for dcum leave out the term T_ii they share (it cancels in
  // dcum, and at a long decay span it is most of each dot), and the
  // epilogue adds it to the outputs after the dot.
  const auto sub_block = [&](const float (&sacc)[4][4], int rb, int cb,
                             bool lower, bool split) {
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = c0 + 16 * q + e;
        const int i = lower ? rb + r : cb + col;
        const int j = lower ? cb + col : rb + r;
        float v = (i < qlen && j <= i) ? sacc[q][e] * exp0(cum[i] - cum[j])
                                       : 0.f;
        if (split && rb == cb && col == r) {
          dg[r] = v;
          v = 0.f;
        }
        ss[r * (kR + 1) + col] = v;
      }
  };
  // sum over the four column groups of each row's partial, in order
  const auto row_sum = [&](float part, float* out, int rb) {
    red[g4 * kR + r] = part;
    __syncthreads();
    if (g4 == 0 && rb + r < qlen)
      out[rb + r] += red[r] + red[kR + r] + red[2 * kR + r] + red[3 * kR + r];
    __syncthreads();
  };

  float acc[8][4], sacc[4][4];
  // ---- pass D: dC_i, rows ib -------------------------------------------
  stage_rows(sb1, n16, sin, n, hp, hp, n, n16, nullptr);       // S_in [p][k]
  for (int ib = 0; ib < nb; ++ib) {
    const int rb = ib * kR;
    __syncthreads();
    stage_rows(sa, kAP, dyc + rb * ldy, ldy, kR, qlen - rb, hp, hp, nullptr);
    __syncthreads();
    zero(acc);
    mm<8>(acc, sa, kAP, sb1, n16, hp, n16 / 16);
#pragma unroll
    for (int q = 0; q < 8; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[q][e] *= ecum[min(rb + r, kQ - 1)];
    for (int jb = 0; jb <= ib; ++jb) {
      const int cb = jb * kR;
      __syncthreads();
      stage_cols(sb2, xc + cb * a.sxl, a.sxl, qlen - cb, hp, hp,
                 dts + cb);                                    // xdt^T
      stage_rows(sb3, n16, bc + cb * a.sbl, a.sbl, kR, qlen - cb, n, n16,
                 nullptr);                                     // B rows
      __syncthreads();
      zero(sacc);
      mm<4>(sacc, sa, kAP, sb2, kTP, hp, 4);                   // dy·xdt^T
      sub_block(sacc, rb, cb, true, true);
      __syncthreads();
      mm<8>(acc, ss, kR + 1, sb3, n16, kR, n16 / 16);
    }
    float part = 0.f;
    const int i = rb + r;
#pragma unroll
    for (int q = 0; q < 8; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k = c0 + 16 * q + e;
        if (i < qlen && k < n) {
          part = fmaf(ldf(cc + i * a.scl + k), acc[q][e], part);
          a.pdC[((row0 + i) * a.nh + h) * n + k] =
              fmaf(dg[r], ldf(bc + i * a.sbl + k), acc[q][e]);
        }
      }
    row_sum(part, rowdot, rb);
  }

  // ---- pass E: dB_j, rows jb -------------------------------------------
  __syncthreads();
  stage_rows(sb1, n16, dso, n, hp, hp, n, n16, nullptr);       // dS_out
  for (int jb = 0; jb < nb; ++jb) {
    const int rb = jb * kR;
    __syncthreads();
    stage_rows(sa, kAP, xc + rb * a.sxl, a.sxl, kR, qlen - rb, hp, hp,
               dts + rb);                                      // xdt rows
    __syncthreads();
    zero(acc);
    mm<8>(acc, sa, kAP, sb1, n16, hp, n16 / 16);
    float part = 0.f;
    const int j = rb + r;
#pragma unroll
    for (int q = 0; q < 8; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k = c0 + 16 * q + e;
        acc[q][e] *= edec[min(j, kQ - 1)];
        if (j < qlen && k < n)
          part = fmaf(ldf(bc + j * a.sbl + k), acc[q][e], part);
      }
    row_sum(part, vv, rb);
    for (int ib = jb; ib < nb; ++ib) {
      const int cb = ib * kR;
      __syncthreads();
      stage_cols(sb2, dyc + cb * ldy, ldy, qlen - cb, hp, hp, nullptr);
      stage_rows(sb3, n16, cc + cb * a.scl, a.scl, kR, qlen - cb, n, n16,
                 nullptr);                                     // C rows
      __syncthreads();
      zero(sacc);
      mm<4>(sacc, sa, kAP, sb2, kTP, hp, 4);                   // xdt·dy^T
      sub_block(sacc, rb, cb, false, true);
      __syncthreads();
      mm<8>(acc, ss, kR + 1, sb3, n16, kR, n16 / 16);
    }
    part = 0.f;
#pragma unroll
    for (int q = 0; q < 8; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k = c0 + 16 * q + e;
        if (j < qlen && k < n) {
          part = fmaf(ldf(bc + j * a.sbl + k), acc[q][e], part);
          a.pdB[((row0 + j) * a.nh + h) * n + k] =
              fmaf(dg[r], ldf(cc + j * a.scl + k), acc[q][e]);
        }
      }
    row_sum(part, coldot, rb);
  }

  // ---- pass X: dxdt_j, rows jb -----------------------------------------
  __syncthreads();
  for (int e = threadIdx.x; e < n16 * hp16; e += kThreads) {   // dS_out^T
    const int p = e / n16, k = e - p * n16;
    sb1[k * hp16 + p] = (p < hp && k < n) ? dso[p * n + k] : 0.f;
  }
  for (int jb = 0; jb < nb; ++jb) {
    const int rb = jb * kR;
    __syncthreads();
    stage_rows(sa, kAP, bc + rb * a.sbl, a.sbl, kR, qlen - rb, n, n, nullptr);
    __syncthreads();
    zero(acc);
    mm<8>(acc, sa, kAP, sb1, hp16, n, hp16 / 16);
    const int j = rb + r;
#pragma unroll
    for (int q = 0; q < 8; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[q][e] *= edec[min(j, kQ - 1)];
    for (int ib = jb; ib < nb; ++ib) {
      const int cb = ib * kR;
      __syncthreads();
      stage_cols(sb2, cc + cb * a.scl, a.scl, qlen - cb, n, n, nullptr);
      stage_rows(sb3, hp16, dyc + cb * ldy, ldy, kR, qlen - cb, hp, hp16,
                 nullptr);                                     // dy rows
      __syncthreads();
      zero(sacc);
      mm<4>(sacc, sa, kAP, sb2, kTP, n, 4);                    // B·C^T
      sub_block(sacc, rb, cb, false, false);
      __syncthreads();
      mm<8>(acc, ss, kR + 1, sb3, hp16, kR, hp16 / 16);
    }
    float part = 0.f;
    const float dj = dts[min(j, kQ - 1)];
#pragma unroll
    for (int q = 0; q < 8; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = c0 + 16 * q + e;
        if (j < qlen && p < hp) {
          stf(a.dx + ((row0 + j) * a.nh + h) * hp + p, dj * acc[q][e]);
          part = fmaf(ldf(xc + j * a.sxl + p), acc[q][e], part);
        }
      }
    row_sum(part, ddtd, rb);
  }

  // ---- dcum, its reverse prefix sum, ddt and the chunk's share of dA ----
  if (threadIdx.x == 0) {
    float kk = 0.f;
    for (int t = 0; t < kThreads; ++t) kk += k2[t];
    kk *= exp0(clast);
    for (int j = 0; j < qlen; ++j) kk += vv[j];
    float run = 0.f, da = 0.f;
    for (int i = kQ - 1; i >= 0; --i) {
      run += (i < qlen ? rowdot[i] - coldot[i] : 0.f) +
             (i == kQ - 1 ? kk : 0.f);
      if (i < qlen) a.ddt[(row0 + i) * a.nh + h] = ddtd[i] + Ah * run;
      da = fmaf(dts[i], run, da);
    }
    a.pdA[(static_cast<long long>(bb) * a.nc + c) * a.nh + h] = da;
  }
}

// ---------------------------------------------------------------------------
// (c) ssd_bc_reduce
// ---------------------------------------------------------------------------

// dB, dC [b, l, g, n]: each element the sum of its group's shares (a head
// each on the f32 route, a slice of hs heads on the bf16 one) in head
// order; dA[h]: the chunks' shares summed over rows, then chunks, in order
// (threads 0 .. nh-1 of the grid).
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_bc_reduce(Args<T> a) {
  const long long tid = static_cast<long long>(blockIdx.x) * kThreads +
                        threadIdx.x;
  const int nsh = a.nh / a.hs, spg = nsh / a.G;   // shares, of a group
  const long long total = static_cast<long long>(a.b) * a.L * a.G * a.n;
  if (tid < total) {
    const int k = static_cast<int>(tid % a.n);
    const long long rest = tid / a.n;
    const int gg = static_cast<int>(rest % a.G);
    const long long bl = rest / a.G;
    const long long at = (bl * nsh + static_cast<long long>(gg) * spg) * a.n
                         + k;
    float sb = 0.f, sc = 0.f;
    for (int j = 0; j < spg; ++j) {
      sb += a.pdB[at + static_cast<long long>(j) * a.n];
      sc += a.pdC[at + static_cast<long long>(j) * a.n];
    }
    stf(a.dB + tid, sb);
    stf(a.dC + tid, sc);
  }
  if (tid < a.nh) {
    float s = 0.f;
    for (int bb = 0; bb < a.b; ++bb)
      for (int c = 0; c < a.nc; ++c)
        s += a.pdA[(static_cast<long long>(bb) * a.nc + c) * a.nh + tid];
    a.dA[tid] = s;
  }
}

template <typename T>
int launch(Args<T> a, bool recompute, cudaStream_t st) {
  static bool configured = false;    // once: the sizes are constants
  const int states_bytes = StatesSmem::kFloats * 4;
  const int chunk_bytes = ChunkSmem::kFloats * 4;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        ssd_states_bwd<T, true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        states_bytes);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(ssd_states_bwd<T, false>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 states_bytes);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(ssd_chunk_bwd<T>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 chunk_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 sgrid(((a.hp + kR - 1) / kR) * ((a.n + kR - 1) / kR), a.nh,
                   a.b);
  if (recompute)
    ssd_states_bwd<T, true><<<sgrid, kThreads, states_bytes, st>>>(a);
  else
    ssd_states_bwd<T, false><<<sgrid, kThreads, states_bytes, st>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_chunk_bwd<T><<<dim3(a.nc, a.nh, a.b), kThreads, chunk_bytes, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long total = static_cast<long long>(a.b) * a.L * a.G * a.n;
  const long long work = total > a.nh ? total : a.nh;
  ssd_bc_reduce<T><<<static_cast<unsigned>((work + kThreads - 1) / kThreads),
                     kThreads, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The bf16 route (x, B, C bf16, hp <= 64): every product on the tensor cores
// ---------------------------------------------------------------------------

namespace tc {

constexpr int kP = 64;             // head width the route takes (hp <= 64)
constexpr int kCP = kK + 8;        // row pitch of C, B and state tiles (bf16)
constexpr int kXP = kP + 8;        // row pitch of x and dy tiles (bf16)
constexpr int kRB = kQ / 16;       // 16-row blocks of a chunk
constexpr int kTiles = kRB * (kRB + 1) / 2;   // 16 x 16 tiles, j <= i: 36
constexpr int kTPW = (kTiles + 7) / 8;        // tiles a warp at most: 5
constexpr int kSliceHeads = 8;     // heads of one group a chunk block takes
constexpr int kMaxHs = 8;          // the most the shared memory holds
constexpr int kSW = 64;            // states_bwd's tile of [hp, n]: 64 x 64
constexpr int kSWP = kSW + 8;      // row pitch of its C and v tiles (bf16)
constexpr int kDYP = kSW + 4;      // row pitch of its dy tile (f32)

__device__ __forceinline__ float2 ld_bf2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
// the sum over the four lanes of a quad (lanes 4 g .. 4 g + 3), the same
// bits in each
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}
__device__ __forceinline__ int tile_id(int ib, int jb) {
  return ib * (ib + 1) / 2 + jb;
}
__device__ __forceinline__ void tile_rc(int t, int& ib, int& jb) {
  ib = 0;
  while ((ib + 1) * (ib + 2) / 2 <= t) ++ib;
  jb = t - ib * (ib + 1) / 2;
}

// Rows [0, rows) x columns [0, W) of a bf16 matrix (row stride ld) into
// shared memory at `pitch`; zeros past (valid_rows, cols). With vec
// (16-byte rows) one cp.async a 16-byte segment, in flight until
// cp_wait_all(); else element by element.
template <int W>
__device__ __forceinline__ void stage(bf16* dst, int pitch,
                                      const bf16* __restrict__ src,
                                      long long ld, int rows, int valid_rows,
                                      int cols, bool vec) {
  if (vec) {
    for (int i = threadIdx.x; i < rows * (W / 8); i += kThreads) {
      const int r = i / (W / 8), c = (i % (W / 8)) * 8;
      const bool ok = r < valid_rows && c < cols;
      cp_async16(dst + r * pitch + c, ok ? src + r * ld + c : src, ok);
    }
  } else {
    for (int i = threadIdx.x; i < rows * W; i += kThreads) {
      const int r = i / W, c = i % W;
      dst[r * pitch + c] = (r < valid_rows && c < cols)
                               ? src[r * ld + c] : __float2bfloat16_rn(0.f);
    }
  }
}

// Rows [0, rows) x columns [0, W) of an f32 or bf16 matrix (row stride ld),
// each element times its row's scale (mode 0: 1; 1: exp0(cum_r); 2:
// exp0(cum_last - cum_r) dt_r), split hi + lo into two bf16 tiles at
// `pitch`; zeros past (valid_rows, cols). 4 columns a step (one float4 with
// vec4). With `pair` (f32, the same shape and stride) the thread also sums
// src·pair over its elements into `dot`, in its order.
template <int W, typename S>
__device__ __forceinline__ void stage_split(
    bf16* hi, bf16* lo, int pitch, const S* __restrict__ src, long long ld,
    int rows, int valid_rows, int cols, bool vec4, int mode,
    const float* cum, const float* dts, const float* __restrict__ pair,
    float& dot) {
  for (int e = threadIdx.x; e < rows * (W / 4); e += kThreads) {
    const int r = e / (W / 4), c = (e % (W / 4)) * 4;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    if (r < valid_rows) {
      const S* row = src + r * ld + c;
      bool done = false;
      if constexpr (sizeof(S) == 4) {
        if (vec4 && c + 4 <= cols) {
          const float4 f = *reinterpret_cast<const float4*>(row);
          v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
          done = true;
        }
      }
      if (!done) {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (c + q < cols) v[q] = ldf(row + q);
      }
      if (pair) {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (c + q < cols) dot = fmaf(v[q], pair[r * ld + c + q], dot);
      }
      const float s = mode == 1 ? exp0(cum[r])
                    : mode == 2 ? exp0(cum[kQ - 1] - cum[r]) * dts[r] : 1.f;
#pragma unroll
      for (int q = 0; q < 4; ++q) v[q] *= s;
    }
    uint32_t h0, l0, h1, l1;
    split2(v[0], v[1], h0, l0);
    split2(v[2], v[3], h1, l1);
    *reinterpret_cast<uint2*>(hi + r * pitch + c) = make_uint2(h0, h1);
    *reinterpret_cast<uint2*>(lo + r * pitch + c) = make_uint2(l0, l1);
  }
}

// The inclusive prefix sum of dt·A over dts[kQ] into cum[kQ], as chunk_cum
// computes it (one warp); dts visible to warp 0 before the call, cum to
// everyone after it.
__device__ __forceinline__ void scan_cum(const float* dts, float* cum,
                                         float Ah) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    float loc[4], run = 0.f;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      run += dts[lane * 4 + r] * Ah;
      loc[r] = run;
    }
    float incl = run;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float v = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += v;
    }
    float excl = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) excl = 0.f;
#pragma unroll
    for (int r = 0; r < 4; ++r) cum[lane * 4 + r] = excl + loc[r];
  }
  __syncthreads();
}

// --- (a) states_bwd ---------------------------------------------------------

// Two buffers of one chunk's operands (C's columns of the tile, dy's hp
// columns of it, dt), so the next chunk's copies land while this one is
// computed; the split v = e ∘ dy and the prefix sum.
struct StatesSmem {
  static constexpr int kCOff = 0;                        // bf16 [kQ][kSWP]
  static constexpr int kDyOff = kCOff + kQ * kSWP * 2;   // f32 [kQ][kDYP]
  static constexpr int kDtOff = kDyOff + kQ * kDYP * 4;  // f32 [kQ]
  static constexpr int kBuf = kDtOff + kQ * 4;
  static constexpr int kVh = 2 * kBuf;                   // bf16 [kQ][kSWP]
  static constexpr int kVl = kVh + kQ * kSWP * 2;        // bf16 [kQ][kSWP]
  static constexpr int kCum = kVl + kQ * kSWP * 2;       // f32 [kQ]
  static constexpr int kBytes = kCum + kQ * 4;
  static_assert(kBuf % 16 == 0, "buffers stay 16-byte aligned");
};

// Grid (64 x 64 tiles of [hp, n], head, batch row), as the forward's
// ssd_states: the block walks the chunks from the last and carries its tile
// of dS in the mma accumulators from dS_final; warp (wm, wn) owns rows p in
// [16 wm, + 16) and columns k in [32 wn, + 32). Per chunk c: dS_out[c] goes
// out, then
//   dS <- exp0(cum_last) dS + v^T C,   v_i = exp0(cum_i) dy_i,
// A = v^T (v split hi + lo) through ldmatrix.trans of v[i][p], B = C[i][k]
// through ldmatrix.trans. The previous chunk's C, dy and dt are copied
// (cp.async) while this one is computed. After chunk 0, dS is dS0.
__global__ void __launch_bounds__(kThreads, 1)
states_bwd(Args<bf16> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  using S = StatesSmem;
  bf16* vh = reinterpret_cast<bf16*>(smem + S::kVh);
  bf16* vl = reinterpret_cast<bf16*>(smem + S::kVl);
  float* cum = reinterpret_cast<float*>(smem + S::kCum);

  const int nnt = (a.n + kSW - 1) / kSW;
  const int p0 = (blockIdx.x / nnt) * kSW, k0 = (blockIdx.x % nnt) * kSW;
  const int h = blockIdx.y, bb = blockIdx.z;
  const int hpl = min(kSW, a.hp - p0), nsl = min(kSW, a.n - k0);
  const int grp = h / (a.nh / a.G);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 3, wn = warp >> 2;
  const bool active = 16 * wm < hpl && 32 * wn < nsl;
  const int g = lane >> 2, tg = lane & 3;
  const float Ah = a.A[h];
  const long long hpn = static_cast<long long>(a.hp) * a.n;
  const long long tile = static_cast<long long>(p0) * a.n + k0;
  const long long ldy = static_cast<long long>(a.nh) * a.hp;
  const bool vec2 = a.n % 2 == 0;

  // this thread's elements of the tile: rows 16 wm + g + 8 r, columns
  // 32 wn + 8 t + 2 tg (+ 1), accumulator acc[t][2 r (+ 1)]
  float acc[4][4];
  const auto state_io = [&](float* base, bool store) {
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int p = 16 * wm + g + 8 * r, k = 32 * wn + 8 * t + 2 * tg;
        float* e = base + tile + static_cast<long long>(p) * a.n + k;
        const bool ok0 = p < hpl && k < nsl, ok1 = p < hpl && k + 1 < nsl;
        if (store) {
          if (ok1 && vec2) {
            *reinterpret_cast<float2*>(e) =
                make_float2(acc[t][2 * r], acc[t][2 * r + 1]);
          } else {
            if (ok0) e[0] = acc[t][2 * r];
            if (ok1) e[1] = acc[t][2 * r + 1];
          }
        } else {
          acc[t][2 * r] = ok0 ? e[0] : 0.f;
          acc[t][2 * r + 1] = ok1 ? e[1] : 0.f;
        }
      }
  };
  state_io(const_cast<float*>(a.dSf) +
           (static_cast<long long>(bb) * a.nh + h) * hpn, false);

  // one chunk's C, dy and dt into buffer buf, all copies in flight
  const auto stage_chunk = [&](int c, int buf) {
    unsigned char* base = smem + buf * S::kBuf;
    const int c0 = c * a.Q, qlen = min(a.Q, a.L - c0);
    const int q16 = (qlen + 15) & ~15;
    stage<kSW>(reinterpret_cast<bf16*>(base + S::kCOff), kSWP,
               a.C + bb * a.scb + c0 * a.scl +
                   static_cast<long long>(grp) * a.n + k0,
               a.scl, q16, qlen, nsl, a.vbc);
    float* dys = reinterpret_cast<float*>(base + S::kDyOff);
    const float* dyc = a.dy + ((static_cast<long long>(bb) * a.L + c0) *
                               a.nh + h) * a.hp + p0;
    for (int i = tid; i < q16 * (kSW / 4); i += kThreads) {
      const int r = i / (kSW / 4), c4 = (i % (kSW / 4)) * 4;
      const float* src = dyc + r * ldy + c4;
      float* dst = dys + r * kDYP + c4;
      if (a.vdy && c4 + 4 <= hpl) {
        cp_async16(dst, r < qlen ? src : dyc, r < qlen);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const bool ok = r < qlen && c4 + q < hpl;
          cp_async4(dst + q, ok ? src + q : dyc, ok);
        }
      }
    }
    float* dts = reinterpret_cast<float*>(base + S::kDtOff);
    const float* dtc = a.dt + (static_cast<long long>(bb) * a.L + c0) *
                                  a.nh + h;
    for (int i = tid; i < kQ; i += kThreads)
      cp_async4(dts + i, i < qlen ? dtc + static_cast<long long>(i) * a.nh
                                  : dtc, i < qlen);
    cp_commit();
  };

  const int lr = lane & 7, lm = lane >> 3;
  const uint32_t a_lane = ((lr + (lm >> 1) * 8) * kSWP + 16 * wm +
                           (lm & 1) * 8) * 2;
  const uint32_t b_lane = ((lr + (lm & 1) * 8) * kSWP + 32 * wn +
                           (lm >> 1) * 8) * 2;
  const uint32_t vh_s = smem_addr(vh), vl_s = smem_addr(vl);
  const int nq = min(2, (nsl - 32 * wn + 15) / 16);   // k16 pairs of n
  stage_chunk(a.nc - 1, 0);
  for (int c = a.nc - 1; c >= 0; --c) {
    const int buf = (a.nc - 1 - c) & 1;
    const unsigned char* base = smem + buf * S::kBuf;
    const float* dys = reinterpret_cast<const float*>(base + S::kDyOff);
    const float* dts = reinterpret_cast<const float*>(base + S::kDtOff);
    const int qlen = min(a.Q, a.L - c * a.Q);
    const int q16 = (qlen + 15) & ~15;
    cp_wait_all();                       // this chunk's copies (the only ones)
    __syncthreads();                     // ... everyone's; buf ^ 1 is free
    if (c > 0) stage_chunk(c - 1, buf ^ 1);          // lands meanwhile
    scan_cum(dts, cum, Ah);
    const float clast = cum[kQ - 1];
    // v = exp0(cum_i) dy_i, split hi + lo, [i][p], 8 columns a thread
    for (int i = tid; i < q16 * (kSW / 8); i += kThreads) {
      const int j = i / (kSW / 8), p = (i % (kSW / 8)) * 8;
      const float4 f0 = *reinterpret_cast<const float4*>(dys + j * kDYP + p);
      const float4 f1 =
          *reinterpret_cast<const float4*>(dys + j * kDYP + p + 4);
      const float e = exp0(cum[j]);
      uint32_t hi[4], lo[4];
      split2(f0.x * e, f0.y * e, hi[0], lo[0]);
      split2(f0.z * e, f0.w * e, hi[1], lo[1]);
      split2(f1.x * e, f1.y * e, hi[2], lo[2]);
      split2(f1.z * e, f1.w * e, hi[3], lo[3]);
      *reinterpret_cast<uint4*>(vh + j * kSWP + p) =
          make_uint4(hi[0], hi[1], hi[2], hi[3]);
      *reinterpret_cast<uint4*>(vl + j * kSWP + p) =
          make_uint4(lo[0], lo[1], lo[2], lo[3]);
    }
    __syncthreads();
    state_io(a.dS_out + ((static_cast<long long>(bb) * a.nc + c) * a.nh +
                         h) * hpn, true);                  // dS_out[c]
    const float dec = exp0(clast);
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[t][q] *= dec;
    const uint32_t cs_s = smem_addr(base + S::kCOff);
    for (int ks = 0; active && ks < q16 / 16; ++ks) {
      uint32_t ah[4], al[4];
      ldsm_x4_t(vh_s + a_lane + ks * 16 * kSWP * 2, ah);
      ldsm_x4_t(vl_s + a_lane + ks * 16 * kSWP * 2, al);
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        if (q >= nq) break;
        uint32_t b[4];
        ldsm_x4_t(cs_s + b_lane + (ks * 16 * kSWP + 16 * q) * 2, b);
        mma16816(acc[2 * q], ah, b[0], b[1]);
        mma16816(acc[2 * q], al, b[0], b[1]);
        mma16816(acc[2 * q + 1], ah, b[2], b[3]);
        mma16816(acc[2 * q + 1], al, b[2], b[3]);
      }
    }
  }
  state_io(a.dS0 + (static_cast<long long>(bb) * a.nh + h) * hpn, true);
}

// --- (b) chunk_bwd ----------------------------------------------------------

struct ChunkSmem {
  static constexpr int kC = 0;                        // bf16 [kQ][kCP]
  static constexpr int kB = kC + kQ * kCP * 2;        // bf16 [kQ][kCP]
  static constexpr int kX = kB + kQ * kCP * 2;        // bf16 [kQ][kXP]
  // dy hi and lo (bf16 [kQ][kXP] each); in the slice's sums e ∘ dy or
  // w ∘ x
  static constexpr int kDh = kX + kQ * kXP * 2;
  static constexpr int kDl = kDh + kQ * kXP * 2;
  // S_in or dS_out hi and lo (bf16 [kP][kCP] each)
  static constexpr int kSh = kDl + kQ * kXP * 2;
  static constexpr int kSl = kSh + kP * kCP * 2;
  // a head's M hi and lo, then the slice's W hi and lo: the causal half's
  // 16 x 16 tiles, each four 8 x 8 bf16 submatrices of 128 bytes
  static constexpr int kMh = kSl + kP * kCP * 2;
  static constexpr int kMl = kMh + kTiles * 512;
  static constexpr int kDts = kMl + kTiles * 512;     // f32 [kMaxHs][kQ]:
  static constexpr int kCum = kDts + kMaxHs * kQ * 4;  //   dt, cum,
  static constexpr int kDcum = kCum + kMaxHs * kQ * 4;  //   dcum (no K),
  static constexpr int kDdt = kDcum + kMaxHs * kQ * 4;  //   x·dxdt
  static constexpr int kU = kDdt + kMaxHs * kQ * 4;   // f32 [kQ]: U_i
  static constexpr int kV = kU + kQ * 4;              // f32 [kQ]: V_j
  static constexpr int kRowP = kV + kQ * 4;           // f32 [kTiles][16]
  static constexpr int kColP = kRowP + kTiles * 64;   // f32 [kTiles][16]
  static constexpr int kRed = kColP + kTiles * 64;    // f32 [kThreads]
  static constexpr int kKh = kRed + kThreads * 4;     // f32 [kMaxHs]: K
  static constexpr int kBytes = kKh + kMaxHs * 4;
  static_assert(kMh % 16 == 0 && kDts % 16 == 0, "16-byte aligned");
};

// Grid (chunk, slice of hs heads of one group, batch row), one block an
// SM; warp w owns the 16-row strip [16 w, 16 w + 16) of each [Q, *]
// product and the causal half's 16 x 16 tiles t = w, w + 8, ... (t = ib
// (ib + 1) / 2 + jb for the tile of rows 16 ib, columns 16 jb, jb <= ib).
//   G  = C B^T, the causal half, once: each warp's tiles in its registers.
//   per head, in head order:
//     U_i   = exp0(cum_i) dy_i · (C S_in^T)_i          (the strip's rows i)
//     dxdt  = exp0(cum_Q - cum_j) B_j dS_out^T         (rows j; V_j from it)
//     per tile: R = dy x^T (dy split), W = R dt_j L, M = G L with L_ij =
//       exp0(cum_i - cum_j) for j <= i, T = G W: T's row and column sums
//       without the diagonal (for dcum), W added to the slice's W in the
//       warp's registers, M split into the packed tiles
//     dxdt += M^T dy (M^T by ldmatrix.trans of the tiles; M and dy split:
//       hi hi + lo hi + hi lo); dx = dt dxdt, x·dxdt for ddt
//     dcum_i = rowsum T - colsum T + U_i - V_i
//   dC (the strip's rows) = W B + sum over heads of (exp0(cum) ∘ dy) S_in
//   dB (the strip's rows) = W^T C + sum over heads of (w ∘ x) dS_out, w_j =
//     exp0(cum_Q - cum_j) dt_j; both to the slice's share of pdC, pdB
//   ddt_j = x_j·dxdt_j + A sum_{i>=j} dcum_i (+ K at the chunk's end), the
//   chunk's share of dA: thread h of the slice walks its head's rows.
__global__ void __launch_bounds__(kThreads, 1)
chunk_bwd(Args<bf16> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  using S = ChunkSmem;
  bf16* cs = reinterpret_cast<bf16*>(smem + S::kC);
  bf16* bs = reinterpret_cast<bf16*>(smem + S::kB);
  bf16* xs = reinterpret_cast<bf16*>(smem + S::kX);
  bf16* dh = reinterpret_cast<bf16*>(smem + S::kDh);
  bf16* dl = reinterpret_cast<bf16*>(smem + S::kDl);
  bf16* sh = reinterpret_cast<bf16*>(smem + S::kSh);
  bf16* sl = reinterpret_cast<bf16*>(smem + S::kSl);
  bf16* mh = reinterpret_cast<bf16*>(smem + S::kMh);
  bf16* ml = reinterpret_cast<bf16*>(smem + S::kMl);
  float* dts_all = reinterpret_cast<float*>(smem + S::kDts);
  float* cum_all = reinterpret_cast<float*>(smem + S::kCum);
  float* dcum_all = reinterpret_cast<float*>(smem + S::kDcum);
  float* ddtd_all = reinterpret_cast<float*>(smem + S::kDdt);
  float* U = reinterpret_cast<float*>(smem + S::kU);
  float* V = reinterpret_cast<float*>(smem + S::kV);
  float* rowp = reinterpret_cast<float*>(smem + S::kRowP);
  float* colp = reinterpret_cast<float*>(smem + S::kColP);
  float* red = reinterpret_cast<float*>(smem + S::kRed);
  float* Kh = reinterpret_cast<float*>(smem + S::kKh);

  const int c = blockIdx.x, slc = blockIdx.y, bb = blockIdx.z;
  const int hpg = a.nh / a.G, h0 = slc * a.hs, grp = h0 / hpg;
  const int nsh = a.nh / a.hs;
  const int c0t = c * a.Q, qlen = min(a.Q, a.L - c0t);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tg = lane & 3, lr = lane & 7, lm = lane >> 3;
  const int hp = a.hp, n = a.n;
  const long long row0 = static_cast<long long>(bb) * a.L + c0t;
  const long long hpn = static_cast<long long>(hp) * n;
  const long long ldy = static_cast<long long>(a.nh) * hp;
  const long long goff = static_cast<long long>(grp) * n;
  const int ia = 16 * warp + g, ib8 = ia + 8;    // this thread's strip rows

  const uint32_t cs_s = smem_addr(cs), bs_s = smem_addr(bs),
                 xs_s = smem_addr(xs), dh_s = smem_addr(dh),
                 dl_s = smem_addr(dl), sh_s = smem_addr(sh),
                 sl_s = smem_addr(sl), mh_s = smem_addr(mh),
                 ml_s = smem_addr(ml);
  // lane addresses (bytes): A rows of a [rows][k] tile from row 16 r; B of
  // a [n][k] tile (plain ldmatrix) or of a [k][n] tile (.trans); A of a
  // packed tile, or of its transpose (.trans)
  const auto arow = [&](int r, int pitch) -> uint32_t {
    return ((16 * r + lr + (lm & 1) * 8) * pitch + (lm >> 1) * 8) * 2;
  };
  const uint32_t ntC = ((lr + (lm >> 1) * 8) * kCP + (lm & 1) * 8) * 2;
  const uint32_t ntX = ((lr + (lm >> 1) * 8) * kXP + (lm & 1) * 8) * 2;
  const uint32_t trC = ((lr + (lm & 1) * 8) * kCP + (lm >> 1) * 8) * 2;
  const uint32_t trX = ((lr + (lm & 1) * 8) * kXP + (lm >> 1) * 8) * 2;
  const uint32_t pkA = (((lm >> 1) | ((lm & 1) << 1)) * 64 + lr * 8) * 2;
  const uint32_t pkT = (lm * 64 + lr * 8) * 2;

  stage<kK>(cs, kCP, a.C + bb * a.scb + c0t * a.scl + goff, a.scl, kQ, qlen,
            n, a.vbc);
  stage<kK>(bs, kCP, a.B + bb * a.sbb + c0t * a.sbl + goff, a.sbl, kQ, qlen,
            n, a.vbc);
  cp_wait_all();
  __syncthreads();

  // G = C B^T on this warp's tiles, once for the slice; W, the slice's sum
  // of each head's W, beside it
  float gt[kTPW][2][4], wsum[kTPW][2][4];
#pragma unroll
  for (int r = 0; r < kTPW; ++r) {
#pragma unroll
    for (int t2 = 0; t2 < 2; ++t2)
#pragma unroll
      for (int q = 0; q < 4; ++q) gt[r][t2][q] = wsum[r][t2][q] = 0.f;
    const int t = warp + 8 * r;
    if (t < kTiles) {
      int ib, jb;
      tile_rc(t, ib, jb);
#pragma unroll
      for (int ks = 0; ks < kK / 16; ++ks) {
        uint32_t af[4], bf[4];
        ldsm_x4(cs_s + arow(ib, kCP) + ks * 32, af);
        ldsm_x4(bs_s + ntC + (16 * jb * kCP + 16 * ks) * 2, bf);
        mma16816(gt[r][0], af, bf[0], bf[1]);
        mma16816(gt[r][1], af, bf[2], bf[3]);
      }
    }
  }

  for (int hh = 0; hh < a.hs; ++hh) {
    const int h = h0 + hh;
    float* dts = dts_all + hh * kQ;
    float* cum = cum_all + hh * kQ;
    const long long sidx = ((static_cast<long long>(bb) * a.nc + c) * a.nh +
                            h) * hpn;
    float kpart = 0.f, unused = 0.f;
    __syncthreads();                   // the previous head's readers done
    stage<kP>(xs, kXP, a.x + bb * a.sxb + c0t * a.sxl +
                           static_cast<long long>(h) * hp,
              a.sxl, kQ, qlen, hp, a.vx);            // in flight from here
    stage_split<kP>(dh, dl, kXP, a.dy + (row0 * a.nh + h) * hp, ldy, kQ,
                    qlen, hp, a.vdy, 0, cum, dts, nullptr, unused);
    stage_split<kK>(sh, sl, kCP, a.S_in + sidx, n, kP, hp, n, a.vs, 0, cum,
                    dts, nullptr, unused);
    cp_wait_all();
    chunk_cum(a.dt + row0 * a.nh + h, a.nh, qlen, a.A[h], dts, cum);
    const float clast = cum[kQ - 1];

    // U_i = exp0(cum_i) dy_i · Z_i, Z = C S_in^T (the strip's rows)
    {
      float z[kP / 8][4];
#pragma unroll
      for (int t = 0; t < kP / 8; ++t)
#pragma unroll
        for (int q = 0; q < 4; ++q) z[t][q] = 0.f;
#pragma unroll
      for (int ks = 0; ks < kK / 16; ++ks) {
        uint32_t af[4];
        ldsm_x4(cs_s + arow(warp, kCP) + ks * 32, af);
#pragma unroll
        for (int q = 0; q < kP / 16; ++q) {
          uint32_t bh[4], bl[4];
          const uint32_t off = (16 * q * kCP + 16 * ks) * 2;
          ldsm_x4(sh_s + ntC + off, bh);
          ldsm_x4(sl_s + ntC + off, bl);
          mma16816(z[2 * q], af, bh[0], bh[1]);
          mma16816(z[2 * q], af, bl[0], bl[1]);
          mma16816(z[2 * q + 1], af, bh[2], bh[3]);
          mma16816(z[2 * q + 1], af, bl[2], bl[3]);
        }
      }
      float ua = 0.f, ub = 0.f;
#pragma unroll
      for (int t = 0; t < kP / 8; ++t) {
        const int p = 8 * t + 2 * tg;
        const float2 ha = ld_bf2(dh + ia * kXP + p),
                     la = ld_bf2(dl + ia * kXP + p),
                     hb = ld_bf2(dh + ib8 * kXP + p),
                     lb = ld_bf2(dl + ib8 * kXP + p);
        ua = fmaf(z[t][0], ha.x + la.x, ua);
        ua = fmaf(z[t][1], ha.y + la.y, ua);
        ub = fmaf(z[t][2], hb.x + lb.x, ub);
        ub = fmaf(z[t][3], hb.y + lb.y, ub);
      }
      ua = quad_sum(ua);
      ub = quad_sum(ub);
      if (tg == 0) {
        U[ia] = exp0(cum[ia]) * ua;
        U[ib8] = exp0(cum[ib8]) * ub;
      }
    }
    __syncthreads();                   // S_in is read: dS_out over it
    stage_split<kK>(sh, sl, kCP, a.dS_out + sidx, n, kP, hp, n, a.vs, 0, cum,
                    dts, a.S_in + sidx, kpart);
    __syncthreads();

    // dxdt's carried-state term (the strip's rows j) and V_j from it
    float dxa[kP / 8][4];
#pragma unroll
    for (int t = 0; t < kP / 8; ++t)
#pragma unroll
      for (int q = 0; q < 4; ++q) dxa[t][q] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kK / 16; ++ks) {
      uint32_t af[4];
      ldsm_x4(bs_s + arow(warp, kCP) + ks * 32, af);
#pragma unroll
      for (int q = 0; q < kP / 16; ++q) {
        uint32_t bh[4], bl[4];
        const uint32_t off = (16 * q * kCP + 16 * ks) * 2;
        ldsm_x4(sh_s + ntC + off, bh);
        ldsm_x4(sl_s + ntC + off, bl);
        mma16816(dxa[2 * q], af, bh[0], bh[1]);
        mma16816(dxa[2 * q], af, bl[0], bl[1]);
        mma16816(dxa[2 * q + 1], af, bh[2], bh[3]);
        mma16816(dxa[2 * q + 1], af, bl[2], bl[3]);
      }
    }
    {
      const float ea = exp0(clast - cum[ia]), eb = exp0(clast - cum[ib8]);
      float va = 0.f, vb = 0.f;
#pragma unroll
      for (int t = 0; t < kP / 8; ++t) {
        const int p = 8 * t + 2 * tg;
        dxa[t][0] *= ea; dxa[t][1] *= ea; dxa[t][2] *= eb; dxa[t][3] *= eb;
        const float2 xa = ld_bf2(xs + ia * kXP + p),
                     xb = ld_bf2(xs + ib8 * kXP + p);
        va = fmaf(xa.x, dxa[t][0], va);
        va = fmaf(xa.y, dxa[t][1], va);
        vb = fmaf(xb.x, dxa[t][2], vb);
        vb = fmaf(xb.y, dxa[t][3], vb);
      }
      va = quad_sum(va);
      vb = quad_sum(vb);
      if (tg == 0) {
        V[ia] = dts[ia] * va;
        V[ib8] = dts[ib8] * vb;
      }
    }

    // the score tiles of this warp
#pragma unroll
    for (int r = 0; r < kTPW; ++r) {
      const int t = warp + 8 * r;
      if (t >= kTiles) continue;
      int ib, jb;
      tile_rc(t, ib, jb);
      float ra[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int ks = 0; ks < kP / 16; ++ks) {
        uint32_t ah[4], al[4], bf[4];
        ldsm_x4(dh_s + arow(ib, kXP) + ks * 32, ah);
        ldsm_x4(dl_s + arow(ib, kXP) + ks * 32, al);
        ldsm_x4(xs_s + ntX + (16 * jb * kXP + 16 * ks) * 2, bf);
        mma16816(ra[0], ah, bf[0], bf[1]);
        mma16816(ra[0], al, bf[0], bf[1]);
        mma16816(ra[1], ah, bf[2], bf[3]);
        mma16816(ra[1], al, bf[2], bf[3]);
      }
      float rp[2] = {0.f, 0.f}, cp[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
      for (int t2 = 0; t2 < 2; ++t2)
#pragma unroll
        for (int rh = 0; rh < 2; ++rh) {
          const int i = 16 * ib + g + 8 * rh;
          const float ci = cum[i];
          float mv[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int q = 2 * rh + e;
            const int j = 16 * jb + 8 * t2 + 2 * tg + e;
            const bool ok = j <= i && i < qlen;
            const float L = ok ? exp0(ci - cum[j]) : 0.f;
            const float w = ra[t2][q] * dts[j] * L;
            const float tt = i == j ? 0.f : gt[r][t2][q] * w;
            mv[e] = gt[r][t2][q] * L;
            rp[rh] += tt;
            cp[t2][e] += tt;
            wsum[r][t2][q] += w;
          }
          uint32_t hi, lo;
          split2(mv[0], mv[1], hi, lo);
          const int off = t * 256 + (2 * rh + t2) * 64 + g * 8 + 2 * tg;
          *reinterpret_cast<uint32_t*>(mh + off) = hi;
          *reinterpret_cast<uint32_t*>(ml + off) = lo;
        }
      rp[0] = quad_sum(rp[0]);
      rp[1] = quad_sum(rp[1]);
#pragma unroll
      for (int t2 = 0; t2 < 2; ++t2)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float v = cp[t2][e];
          v += __shfl_xor_sync(0xffffffffu, v, 4);
          v += __shfl_xor_sync(0xffffffffu, v, 8);
          v += __shfl_xor_sync(0xffffffffu, v, 16);
          cp[t2][e] = v;
        }
      if (tg == 0) {
        rowp[t * 16 + g] = rp[0];
        rowp[t * 16 + g + 8] = rp[1];
      }
      if (g == 0) {
#pragma unroll
        for (int t2 = 0; t2 < 2; ++t2)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            colp[t * 16 + 8 * t2 + 2 * tg + e] = cp[t2][e];
      }
    }
    red[tid] = kpart;
    __syncthreads();                   // M, the partial sums, U, V visible

    // dcum without K (rows i, threads 0-127); K (warp 7)
    if (tid < kQ) {
      const int i = tid, rb = i >> 4, rr = i & 15;
      float rs = 0.f, cs2 = 0.f;
      for (int jb = 0; jb <= rb; ++jb) rs += rowp[tile_id(rb, jb) * 16 + rr];
      for (int i2 = rb; i2 < kRB; ++i2) cs2 += colp[tile_id(i2, rb) * 16 + rr];
      dcum_all[hh * kQ + i] = (rs - cs2) + (U[i] - V[i]);
    } else if (warp == 7) {
      float kd = 0.f, vs = 0.f;
#pragma unroll
      for (int e = 0; e < kThreads / 32; ++e) kd += red[lane * 8 + e];
#pragma unroll
      for (int e = 0; e < kQ / 32; ++e)
        if (lane * 4 + e < qlen) vs += V[lane * 4 + e];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        kd += __shfl_xor_sync(0xffffffffu, kd, o);
        vs += __shfl_xor_sync(0xffffffffu, vs, o);
      }
      if (lane == 0) Kh[hh] = kd * exp0(clast) + vs;
    }

    // dxdt += M^T dy over the tiles (i >= j) of the strip's columns
    for (int ib = warp; ib < kRB; ++ib) {
      const int t = tile_id(ib, warp);
      uint32_t ah[4], al[4];
      ldsm_x4_t(mh_s + t * 512 + pkT, ah);
      ldsm_x4_t(ml_s + t * 512 + pkT, al);
#pragma unroll
      for (int q = 0; q < kP / 16; ++q) {
        uint32_t bh[4], bl[4];
        const uint32_t off = (16 * ib * kXP + 16 * q) * 2;
        ldsm_x4_t(dh_s + trX + off, bh);
        ldsm_x4_t(dl_s + trX + off, bl);
        mma16816(dxa[2 * q], ah, bh[0], bh[1]);
        mma16816(dxa[2 * q], al, bh[0], bh[1]);
        mma16816(dxa[2 * q], ah, bl[0], bl[1]);
        mma16816(dxa[2 * q + 1], ah, bh[2], bh[3]);
        mma16816(dxa[2 * q + 1], al, bh[2], bh[3]);
        mma16816(dxa[2 * q + 1], ah, bl[2], bl[3]);
      }
    }
    // dx = dt dxdt; x·dxdt
    {
      const float dja = dts[ia], djb = dts[ib8];
      bf16* dxo = a.dx + (row0 * a.nh + h) * hp;
      const bool pairs = hp % 2 == 0;
      float pa = 0.f, pb = 0.f;
#pragma unroll
      for (int t = 0; t < kP / 8; ++t) {
        const int p = 8 * t + 2 * tg;
        const float2 xa = ld_bf2(xs + ia * kXP + p),
                     xb = ld_bf2(xs + ib8 * kXP + p);
        pa = fmaf(xa.x, dxa[t][0], pa);
        pa = fmaf(xa.y, dxa[t][1], pa);
        pb = fmaf(xb.x, dxa[t][2], pb);
        pb = fmaf(xb.y, dxa[t][3], pb);
#pragma unroll
        for (int rh = 0; rh < 2; ++rh) {
          const int j = rh ? ib8 : ia;
          if (j >= qlen || p >= hp) continue;
          const float d = rh ? djb : dja;
          bf16* o = dxo + j * ldy + p;
          if (pairs) {
            *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(
                d * dxa[t][2 * rh], d * dxa[t][2 * rh + 1]);
          } else {
            o[0] = __float2bfloat16_rn(d * dxa[t][2 * rh]);
            if (p + 1 < hp) o[1] = __float2bfloat16_rn(d * dxa[t][2 * rh + 1]);
          }
        }
      }
      pa = quad_sum(pa);
      pb = quad_sum(pb);
      if (tg == 0) {
        ddtd_all[hh * kQ + ia] = pa;
        ddtd_all[hh * kQ + ib8] = pb;
      }
    }
  }

  // the slice's W, split hi + lo into the packed tiles
  __syncthreads();                     // the last head's readers done
#pragma unroll
  for (int r = 0; r < kTPW; ++r) {
    const int t = warp + 8 * r;
    if (t >= kTiles) continue;
#pragma unroll
    for (int t2 = 0; t2 < 2; ++t2)
#pragma unroll
      for (int rh = 0; rh < 2; ++rh) {
        uint32_t hi, lo;
        split2(wsum[r][t2][2 * rh], wsum[r][t2][2 * rh + 1], hi, lo);
        const int off = t * 256 + (2 * rh + t2) * 64 + g * 8 + 2 * tg;
        *reinterpret_cast<uint32_t*>(mh + off) = hi;
        *reinterpret_cast<uint32_t*>(ml + off) = lo;
      }
  }

  // dC, then dB: the strip's rows, all n columns, summed over the slice
  float acc[kK / 8][4];
  for (int pass = 0; pass < 2; ++pass) {
    const bool dc = pass == 0;
#pragma unroll
    for (int t = 0; t < kK / 8; ++t)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[t][q] = 0.f;
    for (int hh = 0; hh < a.hs; ++hh) {
      const int h = h0 + hh;
      const long long sidx = ((static_cast<long long>(bb) * a.nc + c) *
                              a.nh + h) * hpn;
      float unused = 0.f;
      __syncthreads();                 // the previous readers done
      if (dc)
        stage_split<kP>(dh, dl, kXP, a.dy + (row0 * a.nh + h) * hp, ldy, kQ,
                        qlen, hp, a.vdy, 1, cum_all + hh * kQ,
                        dts_all + hh * kQ, nullptr, unused);
      else
        stage_split<kP>(dh, dl, kXP, a.x + bb * a.sxb + c0t * a.sxl +
                                         static_cast<long long>(h) * hp,
                        a.sxl, kQ, qlen, hp, false, 2, cum_all + hh * kQ,
                        dts_all + hh * kQ, nullptr, unused);
      stage_split<kK>(sh, sl, kCP, (dc ? a.S_in : a.dS_out) + sidx, n, kP,
                      hp, n, a.vs, 0, nullptr, nullptr, nullptr, unused);
      __syncthreads();
      if (hh == 0) {
        // W B (rows i: tiles jb <= w) or W^T C (rows j: tiles ib >= w)
        const int lo_b = dc ? 0 : warp, hi_b = dc ? warp : kRB - 1;
        for (int kb = lo_b; kb <= hi_b; ++kb) {
          const int t = dc ? tile_id(warp, kb) : tile_id(kb, warp);
          uint32_t ah[4], al[4];
          if (dc) {
            ldsm_x4(mh_s + t * 512 + pkA, ah);
            ldsm_x4(ml_s + t * 512 + pkA, al);
          } else {
            ldsm_x4_t(mh_s + t * 512 + pkT, ah);
            ldsm_x4_t(ml_s + t * 512 + pkT, al);
          }
#pragma unroll
          for (int q = 0; q < kK / 16; ++q) {
            uint32_t b[4];
            ldsm_x4_t((dc ? bs_s : cs_s) + trC + (16 * kb * kCP + 16 * q) * 2,
                      b);
            mma16816(acc[2 * q], ah, b[0], b[1]);
            mma16816(acc[2 * q], al, b[0], b[1]);
            mma16816(acc[2 * q + 1], ah, b[2], b[3]);
            mma16816(acc[2 * q + 1], al, b[2], b[3]);
          }
        }
      }
      // the head's carried-state term: (e ∘ dy) S_in or (w ∘ x) dS_out
#pragma unroll
      for (int ks = 0; ks < kP / 16; ++ks) {
        uint32_t ah[4], al[4];
        ldsm_x4(dh_s + arow(warp, kXP) + ks * 32, ah);
        ldsm_x4(dl_s + arow(warp, kXP) + ks * 32, al);
#pragma unroll
        for (int q = 0; q < kK / 16; ++q) {
          uint32_t bh[4], bl[4];
          const uint32_t off = (16 * ks * kCP + 16 * q) * 2;
          ldsm_x4_t(sh_s + trC + off, bh);
          ldsm_x4_t(sl_s + trC + off, bl);
          mma16816(acc[2 * q], ah, bh[0], bh[1]);
          mma16816(acc[2 * q], al, bh[0], bh[1]);
          mma16816(acc[2 * q], ah, bl[0], bl[1]);
          mma16816(acc[2 * q + 1], ah, bh[2], bh[3]);
          mma16816(acc[2 * q + 1], al, bh[2], bh[3]);
          mma16816(acc[2 * q + 1], ah, bl[2], bl[3]);
        }
      }
    }
    float* out = (dc ? a.pdC : a.pdB) + (row0 * nsh + slc) * n;
    const long long lo_ = static_cast<long long>(nsh) * n;
    const bool pairs = n % 2 == 0;
#pragma unroll
    for (int t = 0; t < kK / 8; ++t) {
      const int k = 8 * t + 2 * tg;
#pragma unroll
      for (int rh = 0; rh < 2; ++rh) {
        const int i = rh ? ib8 : ia;
        if (i >= qlen || k >= n) continue;
        float* o = out + i * lo_ + k;
        if (pairs) {
          *reinterpret_cast<float2*>(o) =
              make_float2(acc[t][2 * rh], acc[t][2 * rh + 1]);
        } else {
          o[0] = acc[t][2 * rh];
          if (k + 1 < n) o[1] = acc[t][2 * rh + 1];
        }
      }
    }
  }

  // each head's reverse sum of dcum (thread hh): ddt and the chunk's dA
  if (tid < a.hs) {
    const int hh = tid, h = h0 + tid;
    const float Ah = a.A[h];
    float run = 0.f, da = 0.f;
    for (int i = kQ - 1; i >= 0; --i) {
      run += (i < qlen ? dcum_all[hh * kQ + i] : 0.f) +
             (i == kQ - 1 ? Kh[hh] : 0.f);
      if (i < qlen)
        a.ddt[(row0 + i) * a.nh + h] = ddtd_all[hh * kQ + i] + Ah * run;
      da = fmaf(dts_all[hh * kQ + i], run, da);
    }
    a.pdA[(static_cast<long long>(bb) * a.nc + c) * a.nh + h] = da;
  }
}

// heads a chunk block of this route takes at (nh, G): the largest power of
// two <= kSliceHeads that divides a group's heads
int slice_heads(int nh, int G) {
  int hs = kSliceHeads;
  while ((nh / G) % hs) hs >>= 1;
  return hs;
}

int launch(Args<bf16> a, cudaStream_t st) {
  static bool configured = false;    // once: the sizes are constants
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        states_bwd, cudaFuncAttributeMaxDynamicSharedMemorySize,
        StatesSmem::kBytes);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(chunk_bwd,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 ChunkSmem::kBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  states_bwd<<<dim3(((a.hp + kSW - 1) / kSW) * ((a.n + kSW - 1) / kSW),
                    a.nh, a.b), kThreads, StatesSmem::kBytes, st>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  chunk_bwd<<<dim3(a.nc, a.nh / a.hs, a.b), kThreads, ChunkSmem::kBytes,
              st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long total = static_cast<long long>(a.b) * a.L * a.G * a.n;
  const long long work = total > a.nh ? total : a.nh;
  ssd_bc_reduce<bf16><<<static_cast<unsigned>((work + kThreads - 1) /
                                              kThreads), kThreads, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Resident blocks an SM of states_bwd (which 0) or chunk_bwd (1), as the
// runtime reports it for their shared memory and registers.
int occupancy(int which) {
  int blocks = 0;
  if (which == 0)
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, states_bwd,
                                                  kThreads,
                                                  StatesSmem::kBytes);
  else
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, chunk_bwd,
                                                  kThreads,
                                                  ChunkSmem::kBytes);
  return blocks;
}

}  // namespace tc

template <typename T>
int launch_typed(const void* x, long long sxb, long long sxl, const void* dt,
                 const void* A, const void* B, long long sbb, long long sbl,
                 const void* C, long long scb, long long scl, const void* S0,
                 const void* dy, const void* dSf, void* S_in, void* dS_out,
                 void* dS0, void* dx, void* ddt, void* pdB, void* pdC,
                 void* pdA, void* dB, void* dC, void* dA, int b, int L,
                 int nh, int hp, int G, int n, int Q, bool recompute,
                 cudaStream_t st) {
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  Args<T> a;
  a.x = static_cast<const T*>(x); a.sxb = sxb; a.sxl = sxl;
  a.dt = static_cast<const float*>(dt); a.A = static_cast<const float*>(A);
  a.B = static_cast<const T*>(B); a.sbb = sbb; a.sbl = sbl;
  a.C = static_cast<const T*>(C); a.scb = scb; a.scl = scl;
  a.S0 = static_cast<const float*>(S0);
  a.dy = static_cast<const float*>(dy);
  a.dSf = static_cast<const float*>(dSf);
  a.S_in = static_cast<float*>(S_in);
  a.dS_out = static_cast<float*>(dS_out);
  a.dS0 = static_cast<float*>(dS0);
  a.dx = static_cast<T*>(dx);
  a.ddt = static_cast<float*>(ddt);
  a.pdB = static_cast<float*>(pdB);
  a.pdC = static_cast<float*>(pdC);
  a.pdA = static_cast<float*>(pdA);
  a.dB = static_cast<T*>(dB);
  a.dC = static_cast<T*>(dC);
  a.dA = static_cast<float*>(dA);
  a.b = b; a.L = L; a.nh = nh; a.hp = hp; a.G = G; a.n = n; a.Q = Q;
  a.nc = (L + Q - 1) / Q;
  a.vbc = aligned(B) && aligned(C) && sbb % 8 == 0 && sbl % 8 == 0 &&
          scb % 8 == 0 && scl % 8 == 0 && n % 8 == 0;
  a.vx = aligned(x) && sxb % 8 == 0 && sxl % 8 == 0 && hp % 8 == 0;
  a.vdy = aligned(dy) && hp % 4 == 0;
  a.vs = aligned(S_in) && aligned(dS_out) && n % 4 == 0;
  a.hs = 1;
  if constexpr (sizeof(T) == 2) {
    if (hp <= tc::kP) {                 // the tensor-core route
      if (recompute) return static_cast<int>(cudaErrorInvalidValue);
      a.hs = tc::slice_heads(nh, G);
      return tc::launch(a, st);
    }
  }
  return launch<T>(a, recompute, st);
}

}  // namespace

// Shares of the dB, dC workspaces (pdB, pdC [b, l, shares, n]) a launch
// with these arguments writes: a head each on the CUDA-core route, a slice
// of heads of one group on the tensor-core route (bf16, hp <= 64).
extern "C" int ssd_chunk_bwd_shares(int dtype, int nh, int hp, int G) {
  if (dtype != 0 || hp > tc::kP || G < 1 || nh % G != 0) return nh;
  return nh / tc::slice_heads(nh, G);
}

// Resident blocks an SM of the tensor-core route's states_bwd (which 0)
// and chunk_bwd (1), after a launch has configured them.
extern "C" int ssd_chunk_bwd_occupancy(int which) {
  return tc::occupancy(which);
}

// dtype: 0 = bfloat16, 1 = float32 (x, B, C, dx, dB, dC). Strides are in
// elements, as for ssd_chunk_launch. dt [b, l, nh], A [nh], S0, dS_final
// and dS0 [b, nh, hp, n], dy [b, l, nh, hp], ddt [b, l, nh], dA [nh] are
// contiguous f32; dx [b, l, nh, hp] and dB, dC [b, l, g, n] contiguous in
// the dtype. Workspaces (f32): S_in and dS_out [b, nc, nh, hp, n] (S_in
// read when recompute is 0: the forward's; written when 1, which the
// tensor-core route does not take), pdB and pdC [b, l, shares, n]
// (ssd_chunk_bwd_shares), pdA [b, nc, nh].
extern "C" int ssd_chunk_bwd_launch(
    int dtype, const void* x, long long sxb, long long sxl, const void* dt,
    const void* A, const void* B, long long sbb, long long sbl, const void* C,
    long long scb, long long scl, const void* S0, const void* dy,
    const void* dSf, void* S_in, void* dS_out, void* dS0, void* dx, void* ddt,
    void* pdB, void* pdC, void* pdA, void* dB, void* dC, void* dA, int b,
    int L, int nh, int hp, int G, int n, int Q, int recompute,
    void* stream) {
  if (b < 1 || b > 65535 || L < 1 || nh < 1 || nh > 65535 || hp < 1 ||
      hp > kK || G < 1 || nh % G != 0 || n < 1 || n > kK || Q < 1 ||
      Q > kQ)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_typed<bf16>(x, sxb, sxl, dt, A, B, sbb, sbl, C, scb, scl,
                              S0, dy, dSf, S_in, dS_out, dS0, dx, ddt, pdB,
                              pdC, pdA, dB, dC, dA, b, L, nh, hp, G, n, Q,
                              recompute != 0, st);
  if (dtype == 1)
    return launch_typed<float>(x, sxb, sxl, dt, A, B, sbb, sbl, C, scb, scl,
                               S0, dy, dSf, S_in, dS_out, dS0, dx, ddt, pdB,
                               pdC, pdA, dB, dC, dA, b, L, nh, hp, G, n, Q,
                               recompute != 0, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
