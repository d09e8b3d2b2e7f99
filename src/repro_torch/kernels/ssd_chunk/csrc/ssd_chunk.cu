// Mamba-2 SSD chunked scan for Hopper (sm_90a): the function of the
// reference's `_ssd_chunked` (src/repro/models/ssd.py:81-135),
//
//   S_t = exp(dt_t A) S_{t-1} + dt_t x_t B_t^T,   y_t = S_t C_t,
//
// computed chunk by chunk in the SSD decomposition (arXiv:2405.21060 §6).
// Per chunk c of Q steps, with cum_i the in-chunk prefix sum of dt·A:
//
//   y_i   = sum_{j<=i} (C_i·B_j) exp(cum_i - cum_j) dt_j x_j   (diagonal)
//         + exp(cum_i) S_in[c] C_i                             (carried state)
//   S_in[c+1] = exp(cum_last) S_in[c] + dS_c,
//   dS_c  = sum_j exp(cum_last - cum_j) dt_j x_j B_j^T.
//
// Layouts are `_ssd_chunked`'s: x [b, l, nh, hp] and B, C [b, l, g, n] in
// the model dtype (bf16 or f32; head h reads group h / (nh / g), B and C are
// never expanded to heads), dt [b, l, nh] f32 (already softplus'd; 0 on
// padded steps), A [nh] f32, S0 [b, nh, hp, n] f32 -> y [b, l, nh, hp] f32
// and S_final [b, nh, hp, n] f32. Q = min(chunk, l); the ragged last chunk
// is masked here (its missing rows read as zeros, which is what the
// reference's zero padding gives), not padded by a copy.
//
// Replaces the Pallas TPU kernel of the reference package:
//   src/repro/kernels/ssd_chunk/ssd_chunk.py  ssd_chunk (pl.pallas_call :81)
// which starts from a zero state, takes B and C expanded to heads and
// returns no state; these kernels take S0 and return S_final, as the model
// needs.
//
// What bounds the function on this card. At mamba2-1.3b's prefill shape
// (b 1, l 2048, nh 64, hp 64, n 128, Q 128, g 1) its inputs and outputs
// are ~56 MB (0.017 ms at 3.35 TB/s); its arithmetic (the causal half of
// C·B^T once per group and chunk; per head and chunk the causal half of
// the diagonal product, the carried-state product and the state update) is
// ~5.4 GFLOP: 0.081 ms at 67 TFLOP/s of f32 FMA, 0.006 ms at 989 TFLOP/s
// of bf16 tensor cores. So in f32 on the CUDA cores the operations bound
// it, and with the products on the tensor cores the bytes do.
//
// 1. The bf16 route (x, B, C bf16: the served models): two kernels, both
//    launched by one call.
//    * ssd_states: one block of 8 warps per (64 x 64 tile of the [hp, n]
//      state, head, batch row): it walks the chunks in order and carries
//      its tile in the mma accumulators. Per chunk it stores S_in[c] (the
//      state entering chunk c) to a workspace, then S <- exp(cum_last) S +
//      (x ∘ w)^T B with w_j = exp(cum_last - cum_j) dt_j and cum the
//      in-chunk prefix sum of dt·A (one warp's shuffle scan); the next
//      chunk's B, x and dt are copied (cp.async, double-buffered) while
//      this one is computed. The last state is S_final.
//    * ssd_outputs: one block of 8 warps per (64-wide hp tile, chunk, head,
//      batch row), all in parallel, two blocks an SM; warp w owns rows i
//      in [16 w, 16 w + 16): y = exp(cum_i) (C S_in^T) first, then for
//      each 16-column block of j up to the diagonal the score tile
//      G = C B^T, masked and weighted to M = G exp(cum_i - cum_j) dt_j in
//      the accumulators, and y += M x with M's fragments taken straight
//      from G's (no shared memory); y leaves through shared memory as
//      whole rows of 16-byte stores.
//    ssd_outputs has b · nc · nh · ceil(hp / 64) independent blocks (1,024
//    at the prefill shape, where the first design had 128 blocks walking
//    the 16 chunks in series). Every product runs on mma.sync.m16n8k16
//    (bf16 in, f32 accumulate). x, B and C are bf16 values, so C·B^T and
//    every product with x or C as one operand is exact in that operand;
//    the other operand is f32 (x·w, M, S_in) and is split into hi =
//    bf16(v) and lo = bf16(v - hi), the two products summed in f32: a
//    relative error of ~2^-17 an operand, where one bf16 rounding (~2^-9)
//    could break the 1e-3 the model's checks hold it to. The operands are
//    staged in shared memory as bf16 (rows padded by 16 bytes so each
//    ldmatrix phase hits 8 bank groups) and read by ldmatrix, .trans where
//    the stored layout is the transpose of the fragment's. Staging is
//    issued before anything waits on it: the bf16 tiles as cp.async (16
//    bytes each, zero-filled past the chunk, the state and the head width)
//    and each thread's f32 loads as one batch, so the prefix sum and the
//    hi + lo split run while the copies land.
//    Why not three kernels (chunk states in parallel, then an elementwise
//    pass carrying the state across chunks): that was built and measured
//    first (0.142 ms at the prefill shape by CUDA-graph replay on an H100
//    SXM at 700 W, against 0.137 for these two on the same card); the
//    pass, fast as it was at the HBM rate, read and rewrote the whole
//    workspace once more (67 MB). Carrying the state in the accumulators
//    writes each S_in[c] once. ssd_states is then a serial walk of the
//    chunks for each tile: its products (per chunk a chain of 16
//    dependent mma.sync on each accumulator) take about a third of its
//    time, and neither the tile shape (16, 32 or 64 hp rows) nor one or
//    two blocks an SM moves it by more than 5% (tools/ssd_ablate.py and
//    chip_smoke.py on an H100 SXM at 700 W).
//    The workspace [b, nc, nh, hp, n] f32 (33.5 MB at the prefill shape,
//    written once and read once, ~150 MB of traffic in all with x, y and
//    the L2 re-reads of B and C) is the design's own floor, ~0.04 ms,
//    against the function's 0.017. The split's extra products, C·B^T
//    recomputed per head (not per group) and the carried-state product
//    over the whole chunk are the kernels' cost, not the function's.
//
// 2. The f32 route (the small f32 configs): the first design, f32 products
//    on the CUDA cores, as the reference's f32 einsums compute them.
//    * one block of 256 threads per (32-wide hp tile, head, batch row)
//      walks the chunks in order and carries its [32, n] slice of S in
//      registers (thread (k, half) owns S[16 p][k]) and in shared memory for
//      the y pass;
//    * per chunk, C and B are staged transposed in shared memory as f32
//      ([n][Q], row strides Q+4 and Q+1), x·dt as [Q][32], the decays as
//      vectors; the in-chunk prefix sum is one warp's shuffle scan;
//    * every product is an outer-product loop in which the warp's 32 lanes
//      walk 32 consecutive rows of one operand (conflict-free shared loads,
//      thanks to the odd row strides) while the other operand is a 16-byte
//      load that every lane of the warp shares (a broadcast);
//    * the [Q, Q] decay-masked score tile is built 64 rows at a time, with
//      blocks above the diagonal skipped; 201 KB of dynamic shared memory
//      at Q = n = 128.
//
// C interface (loaded with ctypes): the launcher returns cudaGetLastError()
// after the launches, or cudaErrorInvalidValue for a shape or dtype it does
// not take. Each kernel's dynamic shared-memory attribute is set once, at
// its largest size.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "mma_sync.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPT = 32;        // hp columns per block
constexpr int kMaxQ = 128;
constexpr int kMaxN = 128;
constexpr int kGR = 64;        // score-tile rows built at a time

__host__ __device__ __forceinline__ int round4(int v) { return (v + 3) & ~3; }

// Padded chunk length: 32 for Q <= 32, else a multiple of the 64-row
// score-tile height, so the tile loop divides it.
__host__ __device__ __forceinline__ int padded_q(int Q) {
  return Q <= 32 ? 32 : (Q + kGR - 1) / kGR * kGR;
}

struct Smem {
  float *ct, *bt, *g, *xs, *st, *dts, *cum, *ecum, *wdec;
  int ldc, ldb, ldg;
};

__host__ __device__ inline int smem_floats(int QP, int n, Smem* s,
                                           float* base) {
  const int gr = QP < kGR ? QP : kGR;
  const int ldc = QP + 4, ldb = QP + 1, ldg = QP + 1;
  int off = 0;
  float* p[9];
  const int sizes[9] = {round4(n * ldc), round4(n * ldb), round4(gr * ldg),
                        QP * kPT, n * kPT, QP, QP, QP, QP};
  for (int i = 0; i < 9; ++i) {
    p[i] = base ? base + off : nullptr;
    off += round4(sizes[i]);
  }
  if (s) {
    s->ct = p[0]; s->bt = p[1]; s->g = p[2]; s->xs = p[3]; s->st = p[4];
    s->dts = p[5]; s->cum = p[6]; s->ecum = p[7]; s->wdec = p[8];
    s->ldc = ldc; s->ldb = ldb; s->ldg = ldg;
  }
  return off;
}

__global__ void __launch_bounds__(kThreads)
ssd_chunk_kernel(const float* __restrict__ x, long long sxb, long long sxl,
                 const float* __restrict__ dt, const float* __restrict__ A,
                 const float* __restrict__ Bm, long long sbb, long long sbl,
                 const float* __restrict__ Cm, long long scb, long long scl,
                 const float* __restrict__ S0, float* __restrict__ y,
                 float* __restrict__ Sf, int L, int nh, int hp, int G, int n,
                 int Q) {
  extern __shared__ __align__(16) float smem[];
  const int QP = padded_q(Q);
  Smem s;
  smem_floats(QP, n, &s, smem);
  const int gr = QP < kGR ? QP : kGR;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int p0 = blockIdx.x * kPT, h = blockIdx.y, bb = blockIdx.z;
  const int grp = h / (nh / G);
  const float Ah = A[h];

  // the state slice: thread (sk, sph) owns S[p0 + 16 sph + r][sk], r < 16
  const int sk = tid & 127, sph = tid >> 7;
  float sreg[16];
  const long long sbase = (static_cast<long long>(bb) * nh + h) * hp * n;
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const int p = p0 + 16 * sph + r;
    sreg[r] = (sk < n && p < hp) ? S0[sbase + static_cast<long long>(p) * n + sk]
                                 : 0.f;
    if (sk < n) s.st[sk * kPT + 16 * sph + r] = sreg[r];
  }

  const int nc = (L + Q - 1) / Q;
  for (int c = 0; c < nc; ++c) {
    const int c0 = c * Q;
    const int qlen = min(Q, L - c0);
    __syncthreads();               // the previous chunk's readers are done

    // ---- stage the chunk: dt, x·dt, C^T, B^T (rows past qlen are zero) --
    const float* dtc = dt + (static_cast<long long>(bb) * L + c0) * nh + h;
    for (int i = tid; i < QP; i += kThreads)
      s.dts[i] = i < qlen ? dtc[static_cast<long long>(i) * nh] : 0.f;
    const float* xc = x + bb * sxb + c0 * sxl + static_cast<long long>(h) * hp;
    for (int e = tid; e < QP * kPT; e += kThreads) {
      const int j = e >> 5, p = e & 31;
      float v = 0.f;
      if (j < qlen && p0 + p < hp)
        v = xc[j * sxl + p0 + p] * dtc[static_cast<long long>(j) * nh];
      s.xs[e] = v;
    }
    const long long goff = static_cast<long long>(grp) * n;
    const float* cc = Cm + bb * scb + c0 * scl + goff;
    const float* bc = Bm + bb * sbb + c0 * sbl + goff;
    for (int e = tid; e < QP * n; e += kThreads) {
      const int i = e / n, k = e - i * n;
      float cv = 0.f, bv = 0.f;
      if (i < qlen) {
        cv = cc[i * scl + k];
        bv = bc[i * sbl + k];
      }
      s.ct[k * s.ldc + i] = cv;
      s.bt[k * s.ldb + i] = bv;
    }
    __syncthreads();

    // ---- in-chunk inclusive prefix sum of dt·A (one warp) --------------
    if (warp == 0) {
      const int R = QP / 32;       // <= 4 rows per lane
      float loc[4];
      float run = 0.f;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        if (r < R) {
          run += s.dts[lane * R + r] * Ah;
          loc[r] = run;
        }
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
      for (int r = 0; r < 4; ++r)
        if (r < R) s.cum[lane * R + r] = excl + loc[r];
    }
    __syncthreads();
    const float clast = s.cum[QP - 1];
    for (int i = tid; i < QP; i += kThreads) {
      s.ecum[i] = expf(s.cum[i]);
      s.wdec[i] = expf(clast - s.cum[i]);
    }
    __syncthreads();

    for (int ib = 0; ib < QP; ib += gr) {
      // ---- (a) score tile rows [ib, ib + gr): G[i][j] = C_i·B_j decay ---
      // warp task = (32-column group jg, 16-row block); lanes walk j
      const int nblk = gr / 16, njg = (ib + gr) / 32;
      for (int task = warp; task < njg * nblk; task += kThreads / 32) {
        const int jg = task / nblk;
        const int i0 = ib + (task - jg * nblk) * 16;
        if (i0 + 15 < jg * 32) continue;       // wholly above the diagonal
        const int j = jg * 32 + lane;
        float acc[16];
#pragma unroll
        for (int r = 0; r < 16; ++r) acc[r] = 0.f;
        for (int k = 0; k < n; ++k) {
          const float bv = s.bt[k * s.ldb + j];
          const float4* cp =
              reinterpret_cast<const float4*>(s.ct + k * s.ldc + i0);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float4 c4 = cp[q];
            acc[4 * q + 0] = fmaf(c4.x, bv, acc[4 * q + 0]);
            acc[4 * q + 1] = fmaf(c4.y, bv, acc[4 * q + 1]);
            acc[4 * q + 2] = fmaf(c4.z, bv, acc[4 * q + 2]);
            acc[4 * q + 3] = fmaf(c4.w, bv, acc[4 * q + 3]);
          }
        }
        const float cj = s.cum[j];
#pragma unroll
        for (int r = 0; r < 16; ++r) {
          const int i = i0 + r;
          s.g[(i - ib) * s.ldg + j] =
              j <= i ? acc[r] * expf(s.cum[i] - cj) : 0.f;
        }
      }
      __syncthreads();

      // ---- (b) y rows [ib, ib + gr): thread (row il, 8 columns pq) ------
      {
        const int il = tid & 63, pq = tid >> 6;
        const int i = ib + il;
        const int jend = min(QP, ib + (warp & 1) * 32 + 32);  // warp-uniform
        if (il < gr) {
          float acc[8], off[8];
#pragma unroll
          for (int r = 0; r < 8; ++r) acc[r] = off[r] = 0.f;
          for (int j = 0; j < jend; ++j) {
            const float g = j <= i ? s.g[il * s.ldg + j] : 0.f;
            const float4* xp =
                reinterpret_cast<const float4*>(s.xs + j * kPT + pq * 8);
            const float4 x0 = xp[0], x1 = xp[1];
            acc[0] = fmaf(g, x0.x, acc[0]); acc[1] = fmaf(g, x0.y, acc[1]);
            acc[2] = fmaf(g, x0.z, acc[2]); acc[3] = fmaf(g, x0.w, acc[3]);
            acc[4] = fmaf(g, x1.x, acc[4]); acc[5] = fmaf(g, x1.y, acc[5]);
            acc[6] = fmaf(g, x1.z, acc[6]); acc[7] = fmaf(g, x1.w, acc[7]);
          }
          for (int k = 0; k < n; ++k) {
            const float cv = s.ct[k * s.ldc + i];
            const float4* sp =
                reinterpret_cast<const float4*>(s.st + k * kPT + pq * 8);
            const float4 s0 = sp[0], s1 = sp[1];
            off[0] = fmaf(cv, s0.x, off[0]); off[1] = fmaf(cv, s0.y, off[1]);
            off[2] = fmaf(cv, s0.z, off[2]); off[3] = fmaf(cv, s0.w, off[3]);
            off[4] = fmaf(cv, s1.x, off[4]); off[5] = fmaf(cv, s1.y, off[5]);
            off[6] = fmaf(cv, s1.z, off[6]); off[7] = fmaf(cv, s1.w, off[7]);
          }
          if (i < qlen) {
            const float e = s.ecum[i];
            float* yo = y + ((static_cast<long long>(bb) * L + c0 + i) * nh + h)
                                * hp + p0 + pq * 8;
#pragma unroll
            for (int r = 0; r < 8; ++r)
              if (p0 + pq * 8 + r < hp) yo[r] = acc[r] + e * off[r];
          }
        }
      }
      __syncthreads();
    }

    // ---- (c) state update: S = exp(cum_last) S + sum_j w_j B_j (x dt)_j --
    if (sk < n) {
      const float el = expf(clast);
      float acc[16];
#pragma unroll
      for (int r = 0; r < 16; ++r) acc[r] = 0.f;
      for (int j = 0; j < QP; ++j) {
        const float bw = s.bt[sk * s.ldb + j] * s.wdec[j];
        const float4* xp =
            reinterpret_cast<const float4*>(s.xs + j * kPT + sph * 16);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float4 x4 = xp[q];
          acc[4 * q + 0] = fmaf(bw, x4.x, acc[4 * q + 0]);
          acc[4 * q + 1] = fmaf(bw, x4.y, acc[4 * q + 1]);
          acc[4 * q + 2] = fmaf(bw, x4.z, acc[4 * q + 2]);
          acc[4 * q + 3] = fmaf(bw, x4.w, acc[4 * q + 3]);
        }
      }
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        sreg[r] = fmaf(el, sreg[r], acc[r]);
        s.st[sk * kPT + 16 * sph + r] = sreg[r];   // read after the next sync
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const int p = p0 + 16 * sph + r;
    if (sk < n && p < hp)
      Sf[sbase + static_cast<long long>(p) * n + sk] = sreg[r];
  }
}

int launch(const void* x, long long sxb, long long sxl, const float* dt,
           const float* A, const void* B, long long sbb, long long sbl,
           const void* C, long long scb, long long scl, const float* S0,
           float* y, float* Sf, int b, int L, int nh, int hp, int G, int n,
           int Q, cudaStream_t st) {
  static bool configured = false;    // once, at the largest size
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_floats(padded_q(kMaxQ), kMaxN, nullptr, nullptr) *
            static_cast<int>(sizeof(float)));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const int smem = smem_floats(padded_q(Q), n, nullptr, nullptr) *
                   static_cast<int>(sizeof(float));
  const dim3 grid((hp + kPT - 1) / kPT, nh, b);
  ssd_chunk_kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const float*>(x), sxb, sxl, dt, A,
      static_cast<const float*>(B), sbb, sbl, static_cast<const float*>(C),
      scb, scl, S0, y, Sf, L, nh, hp, G, n, Q);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bf16 route: chunk states, state passing, chunk outputs
// ---------------------------------------------------------------------------

namespace tc {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;
constexpr int kQ = 128;             // chunk rows a block holds (Q <= 128)
constexpr int kN = 128;             // state width a block holds (n <= 128)
constexpr int kP = 64;              // hp columns per block
constexpr int kQP = kN + 8;         // row pitch of C, B, S tiles (elements)
constexpr int kXP = kP + 8;         // row pitch of x tiles (elements)
constexpr int kPS = 64;             // state rows (hp) per ssd_states block
constexpr int kNS = 64;             // state columns per ssd_states block
constexpr int kSXP = kPS + 8;       // row pitch of ssd_states' x, v tiles
constexpr int kNSP = kNS + 8;       // row pitch of ssd_states' B tile

struct Args {
  const bf16* x; long long sxb, sxl;
  const float* dt; const float* A;
  const bf16* B; long long sbb, sbl;
  const bf16* C; long long scb, scl;
  const float* S0; float* y; float* Sf;
  float* ws;         // [b, nc, nh, hp, n]: S_in[c], the state entering c
  int L, nh, hp, G, n, Q, nc, hpt;
  bool vec;          // x, B and C rows are whole 16-byte segments
};

// Rows [0, rows) x columns [0, W) of a bf16 matrix (row stride ld) into
// shared memory with row pitch `pitch`; zeros past (valid_rows, cols).
// With vec (cols % 8 == 0, 16-byte rows) every segment is one cp.async,
// all in flight until cp_wait_all(); else element by element.
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

// The inclusive prefix sum of dt·A over the chunk's dts[kQ] into cum[kQ]
// (one warp: 4 rows a lane, then a shuffle scan); dts visible to warp 0
// before the call (a barrier), cum to everyone after it.
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

// ssd_states' shared memory: two buffers of one chunk's operands (B's
// columns of the tile, x's hp rows of it, dt), so the next chunk's copies
// land while this chunk is computed, and the split x ∘ w and the prefix
// sum.
struct StatesSmem {
  static constexpr int kBOff = 0;                     // bf16 [kQ][kNSP]
  static constexpr int kXOff = kBOff + kQ * kNSP * 2;  // bf16 [kQ][kSXP]
  static constexpr int kDtOff = kXOff + kQ * kSXP * 2;  // f32 [kQ]
  static constexpr int kBuf = kDtOff + kQ * 4;
  static constexpr int kVh = 2 * kBuf;                // bf16 [kQ][kSXP]
  static constexpr int kVl = kVh + kQ * kSXP * 2;     // bf16 [kQ][kSXP]
  static constexpr int kCum = kVl + kQ * kSXP * 2;    // f32 [kQ]
  static constexpr int kBytes = kCum + kQ * 4;
  static_assert(kBuf % 16 == 0, "buffers stay 16-byte aligned");
};

// Grid (64 hp rows x 64 state columns of the state, head, batch row), two
// blocks an SM: the block walks the chunks in order and carries its
// [64, 64] tile of the state in the mma accumulators; warp (wm, wn) owns
// rows p in [16 wm, + 16) and columns k in [32 wn, + 32) of it. Per chunk
// c: S_in[c] goes to ws[b, c, h], then
//   S <- exp(cum_last) S + (x ∘ w)^T B,   w_j = exp(cum_last - cum_j) dt_j,
// the product accumulated onto the scaled state: A = v^T (v = x ∘ w split
// hi + lo) through ldmatrix.trans of v[j][p], B through ldmatrix.trans of
// B[j][k]. The next chunk's B, x and dt are copied (cp.async) while this
// chunk is computed. After the last chunk, S is S_final. Every block of a
// chunk re-reads that chunk's B tile from L2: 64 x 64 state tiles keep
// that to 4 reads of each B row per head (35.6 MB at the prefill shape).
__global__ void __launch_bounds__(kThreads, 2)
ssd_states(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  using S = StatesSmem;
  bf16* vh = reinterpret_cast<bf16*>(smem + S::kVh);
  bf16* vl = reinterpret_cast<bf16*>(smem + S::kVl);
  float* cum = reinterpret_cast<float*>(smem + S::kCum);

  const int nnt = (a.n + kNS - 1) / kNS;
  const int pt = blockIdx.x / nnt, k0 = (blockIdx.x % nnt) * kNS;
  const int h = blockIdx.y, bb = blockIdx.z;
  const int p0 = pt * kPS, hpl = min(kPS, a.hp - p0);
  const int nsl = min(kNS, a.n - k0);
  const int grp = h / (a.nh / a.G);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 3, wn = warp >> 2;
  const bool active = 16 * wm < hpl && 32 * wn < nsl;
  const int g = lane >> 2, tg = lane & 3;
  const float Ah = a.A[h];
  const long long hpn = static_cast<long long>(a.hp) * a.n;
  const long long tile = static_cast<long long>(p0) * a.n + k0;
  const bool vec2 = a.n % 2 == 0;                 // float2 rows of the state

  // this thread's elements of the state tile: rows 16 wm + g + 8 r,
  // columns 32 wn + 8 t + 2 tg (+ 1), accumulator acc[t][2 r (+ 1)]
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
  state_io(const_cast<float*>(a.S0) + (static_cast<long long>(bb) * a.nh +
                                       h) * hpn, false);

  // one chunk's B, x and dt into buffer buf, all copies in flight
  const auto stage_chunk = [&](int c, int buf) {
    unsigned char* base = smem + buf * S::kBuf;
    const int c0 = c * a.Q, qlen = min(a.Q, a.L - c0);
    const int q16 = (qlen + 15) & ~15;
    stage<kNS>(reinterpret_cast<bf16*>(base + S::kBOff), kNSP,
               a.B + bb * a.sbb + c0 * a.sbl +
                   static_cast<long long>(grp) * a.n + k0,
               a.sbl, q16, qlen, nsl, a.vec);
    stage<kPS>(reinterpret_cast<bf16*>(base + S::kXOff), kSXP,
               a.x + bb * a.sxb + c0 * a.sxl +
                   static_cast<long long>(h) * a.hp + p0,
               a.sxl, q16, qlen, hpl, a.vec);
    float* dts = reinterpret_cast<float*>(base + S::kDtOff);
    const float* dtc = a.dt + (static_cast<long long>(bb) * a.L + c0) *
                                  a.nh + h;
    for (int i = tid; i < kQ; i += kThreads)
      cp_async4(dts + i, i < qlen ? dtc + static_cast<long long>(i) * a.nh
                                  : dtc, i < qlen);
    cp_commit();
  };

  const int lr = lane & 7, lm = lane >> 3;
  const uint32_t a_lane = ((lr + (lm >> 1) * 8) * kSXP + 16 * wm +
                           (lm & 1) * 8) * 2;
  const uint32_t b_lane = ((lr + (lm & 1) * 8) * kNSP + 32 * wn +
                           (lm >> 1) * 8) * 2;
  const uint32_t vh_s = smem_addr(vh), vl_s = smem_addr(vl);
  const int nq = min(2, (nsl - 32 * wn + 15) / 16);   // k16 pairs of n
  stage_chunk(0, 0);
  for (int c = 0; c < a.nc; ++c) {
    const int buf = c & 1;
    const unsigned char* base = smem + buf * S::kBuf;
    const bf16* xs = reinterpret_cast<const bf16*>(base + S::kXOff);
    const float* dts = reinterpret_cast<const float*>(base + S::kDtOff);
    const int c0 = c * a.Q, qlen = min(a.Q, a.L - c0);
    const int q16 = (qlen + 15) & ~15;
    cp_wait_all();                       // this chunk's copies (the only ones)
    __syncthreads();                     // ... everyone's; buf ^ 1 is free
    if (c + 1 < a.nc) stage_chunk(c + 1, buf ^ 1);   // lands meanwhile
    scan_cum(dts, cum, Ah);
    const float clast = cum[kQ - 1];
    // v = x ∘ w, w_j = exp(cum_last - cum_j) dt_j (0 past qlen: dt 0),
    // split hi + lo, [j][p], 8 columns a thread
    for (int i = tid; i < q16 * (kPS / 8); i += kThreads) {
      const int j = i / (kPS / 8), p = (i % (kPS / 8)) * 8;
      const uint4 raw = *reinterpret_cast<const uint4*>(xs + j * kSXP + p);
      const __nv_bfloat162* x2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
      const float wj = dts[j] * expf(clast - cum[j]);
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float2 f = __bfloat1622float2(x2[q]);
        split2(f.x * wj, f.y * wj, hi[q], lo[q]);
      }
      *reinterpret_cast<uint4*>(vh + j * kSXP + p) =
          make_uint4(hi[0], hi[1], hi[2], hi[3]);
      *reinterpret_cast<uint4*>(vl + j * kSXP + p) =
          make_uint4(lo[0], lo[1], lo[2], lo[3]);
    }
    __syncthreads();
    state_io(a.ws + ((static_cast<long long>(bb) * a.nc + c) * a.nh + h) *
                        hpn, true);              // S_in[c]
    const float dec = expf(clast);
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[t][q] *= dec;
    const uint32_t bs_s = smem_addr(base + S::kBOff);
    for (int ks = 0; active && ks < q16 / 16; ++ks) {
      uint32_t ah[4], al[4];
      ldsm_x4_t(vh_s + a_lane + ks * 16 * kSXP * 2, ah);
      ldsm_x4_t(vl_s + a_lane + ks * 16 * kSXP * 2, al);
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        if (q >= nq) break;
        uint32_t b[4];
        ldsm_x4_t(bs_s + b_lane + (ks * 16 * kNSP + 16 * q) * 2, b);
        mma16816(acc[2 * q], ah, b[0], b[1]);
        mma16816(acc[2 * q], al, b[0], b[1]);
        mma16816(acc[2 * q + 1], ah, b[2], b[3]);
        mma16816(acc[2 * q + 1], al, b[2], b[3]);
      }
    }
  }
  state_io(a.Sf + (static_cast<long long>(bb) * a.nh + h) * hpn, true);
}

struct OutputsSmem {
  static constexpr int kC = 0;                        // bf16 [kQ][kQP]
  static constexpr int kX = kC + kQ * kQP * 2;        // bf16 [kQ][kXP]
  // S_in hi and lo (bf16 [kP][kQP] each) for the carried-state product,
  // then B (bf16 [kQ][kQP], the same bytes) for the score tiles
  static constexpr int kSB = kX + kQ * kXP * 2;
  static constexpr int kSl = kSB + kP * kQP * 2;
  static constexpr int kDt = kSB + kQ * kQP * 2;      // f32 [kQ]
  static constexpr int kCum = kDt + kQ * 4;           // f32 [kQ]
  static constexpr int kBytes = kCum + kQ * 4;
  static_assert(2 * kP == kQ, "S_in hi + lo take B's bytes");
  // the output tile f32 [kQ][kYP] over C and x at the end
  static constexpr int kYP = kP + 8;
  static_assert(kQ * kYP * 4 <= kSB, "y fits over C and x");
};

// Grid (hp tile + hpt * chunk, head, batch row); two blocks an SM. Warp w
// owns rows i in [16 w, 16 w + 16) of the chunk and all hpl columns of y:
//   acc  = C S_in^T          (A: C by ldmatrix; B: S_in hi and lo, [p][k])
//   acc *= exp(cum_i)
//   B is staged over S_in, then for each 16 columns of j up to the
//   diagonal:
//     G    = C B^T            (B: B[j][k] by ldmatrix)
//     M    = G exp(cum_i - cum_j) dt_j, 0 above the diagonal, split hi + lo
//     acc += M x              (A: M's fragments from G's accumulators;
//                              B: x[j][p] by ldmatrix.trans)
//   y goes out through shared memory as whole rows of 16-byte stores.
__global__ void __launch_bounds__(kThreads, 2)
ssd_outputs(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  using S = OutputsSmem;
  bf16* cs = reinterpret_cast<bf16*>(smem + S::kC);
  bf16* xs = reinterpret_cast<bf16*>(smem + S::kX);
  bf16* sh = reinterpret_cast<bf16*>(smem + S::kSB);
  bf16* sl = reinterpret_cast<bf16*>(smem + S::kSl);
  bf16* bs = reinterpret_cast<bf16*>(smem + S::kSB);
  float* dts = reinterpret_cast<float*>(smem + S::kDt);
  float* cum = reinterpret_cast<float*>(smem + S::kCum);
  float* ys = reinterpret_cast<float*>(smem);

  const int pt = blockIdx.x % a.hpt, c = blockIdx.x / a.hpt;
  const int h = blockIdx.y, bb = blockIdx.z;
  const int p0 = pt * kP, hpl = min(kP, a.hp - p0);
  const int c0 = c * a.Q, qlen = min(a.Q, a.L - c0);
  const int q16 = (qlen + 15) & ~15;
  const int grp = h / (a.nh / a.G);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  const long long goff = static_cast<long long>(grp) * a.n;
  stage<kN>(cs, kQP, a.C + bb * a.scb + c0 * a.scl + goff, a.scl, q16, qlen,
            a.n, a.vec);
  stage<kP>(xs, kXP, a.x + bb * a.sxb + c0 * a.sxl +
                         static_cast<long long>(h) * a.hp + p0,
            a.sxl, q16, qlen, hpl, a.vec);      // in flight from here
  // S_in[c] rows [p0, p0 + hpl), 4 columns a segment: all loads first
  constexpr int kSegs = kP * (kN / 4) / kThreads;
  const float* sc = a.ws + (((static_cast<long long>(bb) * a.nc + c) * a.nh +
                             h) * a.hp + p0) * a.n;
  float4 sv[kSegs];
#pragma unroll
  for (int it = 0; it < kSegs; ++it) {
    const int i = tid + it * kThreads;
    const int p = i / (kN / 4), k = (i % (kN / 4)) * 4;
    const float* row = sc + static_cast<long long>(p) * a.n;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (p < hpl && a.n % 4 == 0) {             // rows of 16-byte segments
      if (k < a.n) v = *reinterpret_cast<const float4*>(row + k);
    } else if (p < hpl) {
      if (k < a.n) v.x = row[k];
      if (k + 1 < a.n) v.y = row[k + 1];
      if (k + 2 < a.n) v.z = row[k + 2];
      if (k + 3 < a.n) v.w = row[k + 3];
    }
    sv[it] = v;
  }
  const float* dtc = a.dt + (static_cast<long long>(bb) * a.L + c0) * a.nh +
                     h;
  for (int i = tid; i < kQ; i += kThreads)
    dts[i] = i < qlen ? dtc[static_cast<long long>(i) * a.nh] : 0.f;
  __syncthreads();
  scan_cum(dts, cum, a.A[h]);
  // ... split hi + lo into [p][k]
#pragma unroll
  for (int it = 0; it < kSegs; ++it) {
    const int i = tid + it * kThreads;
    const int p = i / (kN / 4), k = (i % (kN / 4)) * 4;
    uint32_t hi[2], lo[2];
    split2(sv[it].x, sv[it].y, hi[0], lo[0]);
    split2(sv[it].z, sv[it].w, hi[1], lo[1]);
    *reinterpret_cast<uint2*>(sh + p * kQP + k) = make_uint2(hi[0], hi[1]);
    *reinterpret_cast<uint2*>(sl + p * kQP + k) = make_uint2(lo[0], lo[1]);
  }
  cp_wait_all();
  __syncthreads();

  const int i0 = 16 * warp;
  const bool active = i0 < qlen;               // rows past the chunk idle
  const int lr = lane & 7, lm = lane >> 3;
  const int g = lane >> 2, tg = lane & 3;
  const int nkn = (a.n + 15) / 16;             // k16 steps over the state
  const int npq = (hpl + 15) / 16;             // pairs of n8 tiles over p
  const uint32_t cs_s = smem_addr(cs), bs_s = smem_addr(bs),
                 xs_s = smem_addr(xs), sh_s = smem_addr(sh),
                 sl_s = smem_addr(sl);
  const int ia = i0 + g, ib = i0 + g + 8;      // this thread's two rows
  const float cum_a = cum[ia], cum_b = cum[ib];

  // C fragments of this warp's 16 rows, every k16 step of the state
  uint32_t cf[kN / 16][4];
  const uint32_t c_lane = ((i0 + lr + (lm & 1) * 8) * kQP + (lm >> 1) * 8) * 2;
#pragma unroll
  for (int ks = 0; ks < kN / 16; ++ks)
    if (active && ks < nkn) ldsm_x4(cs_s + c_lane + ks * 32, cf[ks]);

  float acc[kP / 8][4];
#pragma unroll
  for (int t = 0; t < kP / 8; ++t)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[t][q] = 0.f;

  // carried state: acc = C S_in^T, B operand rows [p][k] (plain ldmatrix);
  // the B operand of the score tiles, B[j][k], has the same lane address
  const uint32_t b_lane = ((lr + (lm >> 1) * 8) * kQP + (lm & 1) * 8) * 2;
  if (active) {
#pragma unroll
    for (int ks = 0; ks < kN / 16; ++ks) {
      if (ks >= nkn) break;
#pragma unroll
      for (int q = 0; q < kP / 16; ++q) {
        if (q >= npq) break;
        uint32_t bh[4], bl[4];
        const uint32_t off = (16 * q * kQP + 16 * ks) * 2;
        ldsm_x4(sh_s + b_lane + off, bh);
        ldsm_x4(sl_s + b_lane + off, bl);
        mma16816(acc[2 * q], cf[ks], bh[0], bh[1]);
        mma16816(acc[2 * q], cf[ks], bl[0], bl[1]);
        mma16816(acc[2 * q + 1], cf[ks], bh[2], bh[3]);
        mma16816(acc[2 * q + 1], cf[ks], bl[2], bl[3]);
      }
    }
    const float ea = expf(cum_a), eb = expf(cum_b);
#pragma unroll
    for (int t = 0; t < kP / 8; ++t) {
      acc[t][0] *= ea; acc[t][1] *= ea;
      acc[t][2] *= eb; acc[t][3] *= eb;
    }
  }
  __syncthreads();                             // S_in is read: B over it
  stage<kN>(bs, kQP, a.B + bb * a.sbb + c0 * a.sbl + goff, a.sbl, q16, qlen,
            a.n, a.vec);
  cp_wait_all();
  __syncthreads();

  // diagonal: 16 columns of j at a time, up to this warp's last row
  const uint32_t x_lane = ((lr + (lm & 1) * 8) * kXP + (lm >> 1) * 8) * 2;
  const int njp = active ? min(warp + 1, q16 / 16) : 0;
  for (int jp = 0; jp < njp; ++jp) {
    float gacc[2][4];
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int q = 0; q < 4; ++q) gacc[t][q] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kN / 16; ++ks) {
      if (ks >= nkn) break;
      uint32_t b[4];
      ldsm_x4(bs_s + b_lane + (16 * jp * kQP + 16 * ks) * 2, b);
      mma16816(gacc[0], cf[ks], b[0], b[1]);
      mma16816(gacc[1], cf[ks], b[2], b[3]);
    }
    // M = G exp(cum_i - cum_j) dt_j for j <= i, as hi + lo A fragments:
    // register 2 t + r holds row r (ia or ib), columns j, j + 1 of tile t
    uint32_t ah[4], al[4];
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int j = 16 * jp + 8 * t + 2 * tg;
      const float2 cj = *reinterpret_cast<const float2*>(cum + j);
      const float2 dj = *reinterpret_cast<const float2*>(dts + j);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = r ? ib : ia;
        const float ci = r ? cum_b : cum_a;
        const float m0 = j <= i
            ? gacc[t][2 * r] * __expf(ci - cj.x) * dj.x : 0.f;
        const float m1 = j + 1 <= i
            ? gacc[t][2 * r + 1] * __expf(ci - cj.y) * dj.y : 0.f;
        split2(m0, m1, ah[2 * t + r], al[2 * t + r]);
      }
    }
#pragma unroll
    for (int q = 0; q < kP / 16; ++q) {
      if (q >= npq) break;
      uint32_t b[4];
      ldsm_x4_t(xs_s + x_lane + (16 * jp * kXP + 16 * q) * 2, b);
      mma16816(acc[2 * q], ah, b[0], b[1]);
      mma16816(acc[2 * q], al, b[0], b[1]);
      mma16816(acc[2 * q + 1], ah, b[2], b[3]);
      mma16816(acc[2 * q + 1], al, b[2], b[3]);
    }
  }

  // y through shared memory [i][p] (pitch kYP: the 8-byte writes of a
  // half-warp fall in 16 distinct bank pairs), then rows of 16-byte stores
  __syncthreads();                             // C and x are read
  if (active) {
#pragma unroll
    for (int t = 0; t < kP / 8; ++t) {
      const int p = 8 * t + 2 * tg;
      *reinterpret_cast<float2*>(ys + ia * S::kYP + p) =
          make_float2(acc[t][0], acc[t][1]);
      *reinterpret_cast<float2*>(ys + ib * S::kYP + p) =
          make_float2(acc[t][2], acc[t][3]);
    }
  }
  __syncthreads();
  float* yb = a.y + ((static_cast<long long>(bb) * a.L + c0) * a.nh + h) *
                        a.hp + p0;
  const long long sy = static_cast<long long>(a.nh) * a.hp;
  const bool vec_y = a.hp % 4 == 0;            // rows of 16-byte segments
  for (int e = tid; e < qlen * (kP / 4); e += kThreads) {
    const int i = e / (kP / 4), p = (e % (kP / 4)) * 4;
    if (p >= hpl) continue;
    const float* src = ys + i * S::kYP + p;
    float* dst = yb + i * sy + p;
    if (vec_y) {
      *reinterpret_cast<float4*>(dst) =
          *reinterpret_cast<const float4*>(src);
    } else {
      for (int q = 0; q < 4 && p + q < hpl; ++q) dst[q] = src[q];
    }
  }
}

// Resident blocks an SM of ssd_states (which 0) or ssd_outputs (1), as
// the CUDA runtime reports it for their shared memory and registers.
int occupancy(int which) {
  int blocks = 0;
  if (which == 0)
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, ssd_states,
                                                  kThreads,
                                                  StatesSmem::kBytes);
  else
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, ssd_outputs,
                                                  kThreads,
                                                  OutputsSmem::kBytes);
  return blocks;
}

int launch(const void* x, long long sxb, long long sxl, const float* dt,
           const float* A, const void* B, long long sbb, long long sbl,
           const void* C, long long scb, long long scl, const float* S0,
           float* y, float* Sf, float* ws, int b, int L, int nh, int hp,
           int G, int n, int Q, cudaStream_t st) {
  static bool configured = false;    // once: the sizes are constants
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        ssd_states, cudaFuncAttributeMaxDynamicSharedMemorySize,
        StatesSmem::kBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaFuncSetAttribute(ssd_outputs,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               OutputsSmem::kBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  Args a;
  a.x = static_cast<const bf16*>(x); a.sxb = sxb; a.sxl = sxl;
  a.dt = dt; a.A = A;
  a.B = static_cast<const bf16*>(B); a.sbb = sbb; a.sbl = sbl;
  a.C = static_cast<const bf16*>(C); a.scb = scb; a.scl = scl;
  a.S0 = S0; a.y = y; a.Sf = Sf;
  a.L = L; a.nh = nh; a.hp = hp; a.G = G; a.n = n; a.Q = Q;
  a.nc = (L + Q - 1) / Q;
  a.hpt = (hp + kP - 1) / kP;
  a.ws = ws;
  a.vec = aligned(x) && aligned(B) && aligned(C) && sxb % 8 == 0 &&
          sxl % 8 == 0 && sbb % 8 == 0 && sbl % 8 == 0 && scb % 8 == 0 &&
          scl % 8 == 0 && hp % 8 == 0 && n % 8 == 0;
  if (static_cast<long long>(a.hpt) * a.nc > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  ssd_states<<<dim3(((hp + kPS - 1) / kPS) * ((n + kNS - 1) / kNS), nh, b),
               kThreads, StatesSmem::kBytes, st>>>(a);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(a.hpt * a.nc, nh, b);
  ssd_outputs<<<grid, kThreads, OutputsSmem::kBytes, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

}  // namespace

// Resident blocks an SM of the bf16 route's ssd_states (0) and
// ssd_outputs (1), after a launch has configured them.
extern "C" int ssd_chunk_occupancy(int which) { return tc::occupancy(which); }

// f32 floats of the workspace a launch needs: for bf16 (dtype 0) the
// states entering each chunk, [b, nc, nh, hp, n]; none for f32.
extern "C" long long ssd_chunk_ws_floats(int dtype, int b, int L, int nh,
                                         int hp, int n, int Q) {
  if (dtype != 0 || Q < 1) return 0;
  const long long nc = (L + Q - 1) / Q;
  return static_cast<long long>(b) * nc * nh * hp * n;
}

// dtype: 0 = bfloat16, 1 = float32 (x, B and C). Strides are in elements:
// x[b, l, h, p] at x + b*sxb + l*sxl + h*hp + p; B[b, l, g, k] at
// B + b*sbb + l*sbl + g*n + k (C likewise). dt [b, l, nh], A [nh], S0 and
// S_final [b, nh, hp, n] and y [b, l, nh, hp] are contiguous f32; ws holds
// ssd_chunk_ws_floats(...) f32, written before it is read.
extern "C" int ssd_chunk_launch(int dtype, const void* x, long long sxb,
                                long long sxl, const void* dt, const void* A,
                                const void* B, long long sbb, long long sbl,
                                const void* C, long long scb, long long scl,
                                const void* S0, void* y, void* Sf, void* ws,
                                int b, int L, int nh, int hp, int G, int n,
                                int Q, void* stream) {
  if (b < 1 || b > 65535 || L < 1 || nh < 1 || nh > 65535 || hp < 1 ||
      G < 1 || nh % G != 0 || n < 1 || n > kMaxN || Q < 1 || Q > kMaxQ)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  const float* S0f = static_cast<const float*>(S0);
  float* yf = static_cast<float*>(y);
  float* Sff = static_cast<float*>(Sf);
  if (dtype == 0)
    return tc::launch(x, sxb, sxl, dtf, Af, B, sbb, sbl, C, scb, scl, S0f,
                      yf, Sff, static_cast<float*>(ws), b, L, nh, hp, G, n,
                      Q, st);
  if (dtype == 1)
    return launch(x, sxb, sxl, dtf, Af, B, sbb, sbl, C, scb, scl, S0f, yf,
                  Sff, b, L, nh, hp, G, n, Q, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
