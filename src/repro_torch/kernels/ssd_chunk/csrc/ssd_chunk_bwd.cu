// The backward of the Mamba-2 SSD chunked scan (ssd_chunk.cu) for Hopper
// (sm_90a), f32 on the CUDA cores, both dtypes of the forward (x, B and C
// bf16 or f32; dt, A, S0 and the gradients of y and S_final f32).
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
// atomics (two runs give the same bits; each sum in a fixed order):
//
// (a) ssd_states_bwd: one block per (64 x 64 tile of the [hp, n] state,
//     head, batch row), as the forward's ssd_states: it walks the chunks
//     from the last, carrying its tile of dS in registers from dS_final,
//     stores dS_out[c] and ends with dS0. The f32 route's forward keeps no
//     S_in, so that route's block first walks the chunks forward and
//     stores S_in[c] (a recompute of the forward's states: its products
//     are counted in the bound); the bf16 route reads the forward's
//     workspace, which the autograd Function keeps.
// (b) ssd_chunk_bwd: one block per (chunk, head, batch row), all in
//     parallel: dx, both terms of ddt, per-head dB and dC (f32, to a
//     workspace) and the chunk's share of dA. Its [Q, Q] products go by
//     64 x 64 sub-blocks of the causal triangle, each made in shared
//     memory and used at once: pass D (rows i: dC), pass E (rows j: dB)
//     and pass X (rows j: dxdt) each start from their carried-state term
//     and add the sub-blocks of their rows; C·B^T and dy·xdt^T are made
//     twice (once for a row of i, once for a column of j) rather than
//     kept: a block holds at most 185 KB of shared memory.
// (c) ssd_bc_reduce: dB and dC, each element the sum over its group's
//     heads in head order, in the input's dtype; dA[h], the sum of the
//     chunks' shares over rows and chunks in order.
//
// Why the per-head workspace (f32 [b, l, nh, n] twice, 134 MB each at
// mamba2-1.3b's training microbatch): mamba2 has one group for its 64
// heads, so a block owning a group would leave 32 blocks for the card at
// that shape. The workspace's write and read (537 MB) are the design's
// cost over the function's bytes.
//
// Bound at mamba2-1.3b's training microbatch (b 1, l 4096, nh 64, hp 64,
// n 128, g 1, Q 128; chip_smoke.py computes it from the shapes): the
// function reads x, B, C (bf16), dt, dy (f32) and the states it needs, and
// writes dx, dB, dC, ddt, dA, dS0; its operations are counted in
// chip_smoke.ssd_bwd_flops. Both bytes and operations are stated there.
//
// Each product is an outer-product loop in shared memory: a thread owns
// one row r of a 64-row output tile and 4-column groups 4 g + 16 q (+ 0..3)
// of it; per k it reads A[r][k] (rows at an odd pitch, conflict-free) and
// one float4 of B[k][...] that the warp shares (a broadcast).
//
// C interface (loaded with ctypes): the launcher returns cudaGetLastError()
// after the launches, or cudaErrorInvalidValue for a shape or dtype it does
// not take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
  float* pdB; float* pdC;             // [b, l, nh, n]: each head's share
  float* pdA;                         // [b, nc, nh]
  T* dB; T* dC;                       // [b, l, g, n]
  float* dA;                          // [nh]
  int b, L, nh, hp, G, n, Q, nc;
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

// dB, dC [b, l, g, n]: each element the sum of its group's heads' shares in
// head order; dA[h]: the chunks' shares summed over rows, then chunks, in
// order (threads 0 .. nh-1 of the grid).
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_bc_reduce(Args<T> a) {
  const long long tid = static_cast<long long>(blockIdx.x) * kThreads +
                        threadIdx.x;
  const int hpg = a.nh / a.G;
  const long long total = static_cast<long long>(a.b) * a.L * a.G * a.n;
  if (tid < total) {
    const int k = static_cast<int>(tid % a.n);
    const long long rest = tid / a.n;
    const int gg = static_cast<int>(rest % a.G);
    const long long bl = rest / a.G;
    const long long at = (bl * a.nh + static_cast<long long>(gg) * hpg) * a.n
                         + k;
    float sb = 0.f, sc = 0.f;
    for (int j = 0; j < hpg; ++j) {
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

template <typename T>
int launch_typed(const void* x, long long sxb, long long sxl, const void* dt,
                 const void* A, const void* B, long long sbb, long long sbl,
                 const void* C, long long scb, long long scl, const void* S0,
                 const void* dy, const void* dSf, void* S_in, void* dS_out,
                 void* dS0, void* dx, void* ddt, void* pdB, void* pdC,
                 void* pdA, void* dB, void* dC, void* dA, int b, int L,
                 int nh, int hp, int G, int n, int Q, bool recompute,
                 cudaStream_t st) {
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
  return launch<T>(a, recompute, st);
}

}  // namespace

// Shared memory of the chunk kernel (b), in bytes: the largest block.
extern "C" int ssd_chunk_bwd_smem_bytes() { return ChunkSmem::kFloats * 4; }

// dtype: 0 = bfloat16, 1 = float32 (x, B, C, dx, dB, dC). Strides are in
// elements, as for ssd_chunk_launch. dt [b, l, nh], A [nh], S0, dS_final
// and dS0 [b, nh, hp, n], dy [b, l, nh, hp], ddt [b, l, nh], dA [nh] are
// contiguous f32; dx [b, l, nh, hp] and dB, dC [b, l, g, n] contiguous in
// the dtype. Workspaces (f32): S_in and dS_out [b, nc, nh, hp, n] (S_in
// read when recompute is 0: the forward's; written when 1), pdB and pdC
// [b, l, nh, n], pdA [b, nc, nh].
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
