// Mamba-2 SSD chunked scan for Hopper (sm_90a): the function of the
// reference's `_ssd_chunked` (src/repro/models/ssd.py:81-135),
//
//   S_t = exp(dt_t A) S_{t-1} + dt_t x_t B_t^T,   y_t = S_t C_t,
//
// computed chunk by chunk in the SSD decomposition (arXiv:2405.21060 §6).
// Per chunk of Q steps, with cum_i the in-chunk prefix sum of dt·A:
//
//   y_i   = sum_{j<=i} (C_i·B_j) exp(cum_i - cum_j) dt_j x_j   (diagonal)
//         + exp(cum_i) S C_i                                   (carried state)
//   S_new = exp(cum_last) S + sum_j exp(cum_last - cum_j) dt_j x_j B_j^T
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
// returns no state; this kernel takes S0 and returns S_final, as the model
// needs.
//
// What bounds it on this card: operations. At mamba2-1.3b's prefill shape
// (b 1, l 2048, nh 64, hp 64, n 128, Q 128, g 1) the inputs and outputs are
// ~56 MB (0.017 ms at 3.35 TB/s), while the f32 arithmetic the function
// needs (the causal half of C·B^T once per group and chunk; per head and
// chunk the causal half of the diagonal product, the carried-state product
// and the state update) is ~5.4 GFLOP, 0.081 ms at 67 TFLOP/s of f32 FMA.
// Every product runs in f32 on the CUDA cores, which is what the
// reference's f32 einsums compute; TF32 tensor cores would be 8x the rate
// but round the operands, a later question.
//
// Design (simple and right first):
//   * one block of 256 threads per (32-wide hp tile, head, batch row) walks
//     the chunks in order and carries its [32, n] slice of S in registers
//     (thread (k, half) owns S[16 p][k]) and in shared memory for the y pass;
//   * per chunk, C and B are staged transposed in shared memory as f32
//     ([n][Q], row strides Q+4 and Q+1), x·dt as [Q][32], the decays as
//     vectors; the in-chunk prefix sum is one warp's shuffle scan;
//   * every product is an outer-product loop in which the warp's 32 lanes
//     walk 32 consecutive rows of one operand (conflict-free shared loads,
//     thanks to the odd row strides) while the other operand is a 16-byte
//     load that every lane of the warp shares (a broadcast): 16 FMAs per
//     thread for 5 shared-memory wavefronts per warp;
//   * the [Q, Q] decay-masked score tile is built 64 rows at a time (64 KB
//     at Q 128 would not fit beside B and C in f32), with blocks above the
//     diagonal skipped; 201 KB of dynamic shared memory at Q = n = 128.
// At the prefill shape the grid is 2 x 64 = 128 blocks, one wave on the
// card's 132 SMs at one block each. Its known costs: C·B^T is recomputed by
// each head and hp tile (64 x 2 times for g = 1), and nothing runs on the
// tensor cores; a wgmma tile is the first item of work on this kernel.
//
// C interface (loaded with ctypes): the launcher returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue for a shape or dtype it does
// not take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPT = 32;        // hp columns per block
constexpr int kMaxQ = 128;
constexpr int kMaxN = 128;
constexpr int kGR = 64;        // score-tile rows built at a time

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_chunk_kernel(const T* __restrict__ x, long long sxb, long long sxl,
                 const float* __restrict__ dt, const float* __restrict__ A,
                 const T* __restrict__ Bm, long long sbb, long long sbl,
                 const T* __restrict__ Cm, long long scb, long long scl,
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
    const T* xc = x + bb * sxb + c0 * sxl + static_cast<long long>(h) * hp;
    for (int e = tid; e < QP * kPT; e += kThreads) {
      const int j = e >> 5, p = e & 31;
      float v = 0.f;
      if (j < qlen && p0 + p < hp)
        v = to_f32(xc[j * sxl + p0 + p]) * dtc[static_cast<long long>(j) * nh];
      s.xs[e] = v;
    }
    const T* cc = Cm + bb * scb + c0 * scl + static_cast<long long>(grp) * n;
    const T* bc = Bm + bb * sbb + c0 * sbl + static_cast<long long>(grp) * n;
    for (int e = tid; e < QP * n; e += kThreads) {
      const int i = e / n, k = e - i * n;
      float cv = 0.f, bv = 0.f;
      if (i < qlen) {
        cv = to_f32(cc[i * scl + k]);
        bv = to_f32(bc[i * sbl + k]);
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

template <typename T>
int launch(const void* x, long long sxb, long long sxl, const float* dt,
           const float* A, const void* B, long long sbb, long long sbl,
           const void* C, long long scb, long long scl, const float* S0,
           float* y, float* Sf, int b, int L, int nh, int hp, int G, int n,
           int Q, cudaStream_t st) {
  const int smem = smem_floats(padded_q(Q), n, nullptr, nullptr) *
                   static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((hp + kPT - 1) / kPT, nh, b);
  ssd_chunk_kernel<T><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(x), sxb, sxl, dt, A, static_cast<const T*>(B),
      sbb, sbl, static_cast<const T*>(C), scb, scl, S0, y, Sf, L, nh, hp, G,
      n, Q);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = bfloat16, 1 = float32 (x, B and C). Strides are in elements:
// x[b, l, h, p] at x + b*sxb + l*sxl + h*hp + p; B[b, l, g, k] at
// B + b*sbb + l*sbl + g*n + k (C likewise). dt [b, l, nh], A [nh], S0 and
// S_final [b, nh, hp, n] and y [b, l, nh, hp] are contiguous f32.
extern "C" int ssd_chunk_launch(int dtype, const void* x, long long sxb,
                                long long sxl, const void* dt, const void* A,
                                const void* B, long long sbb, long long sbl,
                                const void* C, long long scb, long long scl,
                                const void* S0, void* y, void* Sf, int b,
                                int L, int nh, int hp, int G, int n, int Q,
                                void* stream) {
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
    return launch<__nv_bfloat16>(x, sxb, sxl, dtf, Af, B, sbb, sbl, C, scb,
                                 scl, S0f, yf, Sff, b, L, nh, hp, G, n, Q, st);
  if (dtype == 1)
    return launch<float>(x, sxb, sxl, dtf, Af, B, sbb, sbl, C, scb, scl, S0f,
                         yf, Sff, b, L, nh, hp, G, n, Q, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
