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
// What bounds it on this card: operations. At minitron-8b's prefill (2048
// tokens, 32 heads of 128, causal) the function needs 34.4 GFLOP (4 * hq * d
// per valid (query, key) pair) against 33.6 MB of q, k, v and out: 0.035 ms
// at 989 TFLOP/s of bf16 against 0.010 ms at 3.35 TB/s. So the tensor cores
// have to be kept fed, and every byte of S, P and O that goes through shared
// memory instead of staying in registers is time they wait.
//
// bf16 route (the model's), register-resident on mma.sync:
//   * one block of 4 warps per (64-row q-tile, query head, batch row), 16
//     rows a warp; the heaviest causal q-tiles start first (blockIdx.x
//     counts down). The TPU's sequential kv grid axis is a loop over
//     kv-tiles of 64 keys inside the block;
//   * Q is copied to shared memory once (cp.async) and each warp keeps its
//     16 rows as mma A fragments (ldmatrix.x4) for the whole loop;
//   * S = Q K^T on mma.sync.m16n8k16 (bf16 in, f32 accumulate): K is staged
//     [key][d], which is the "col" B operand, so plain ldmatrix gives its
//     fragments. A warp's 16 x 64 S tile is 32 f32 registers a lane;
//   * the online softmax runs on those registers: a lane holds rows g and
//     g + 8 of its quad, and the row max and sum are two __shfl_xor_sync
//     across the quad (the sum once, at the end, since alpha is uniform in
//     a row). The max is taken on the raw scores; p = 2^(s * log2(e) /
//     sqrt(d) - m) is one FFMA and one ex2. The running max keeps the
//     reference's finite -1e30 sentinel, and a masked entry gets p = 0
//     explicitly (not exp of the sentinel, which is exp(0) = 1 while a row
//     has seen no valid key). A warp whose rows see all 64 keys of a tile
//     runs a softmax without the mask;
//   * O += P V with P taken straight from the S accumulators, rounded to
//     bf16: two adjacent n8 C tiles are one k16 A fragment. V is staged
//     [key][d] and its B fragments come from ldmatrix.trans. O (16 x d f32
//     a warp) stays in registers and is rescaled by alpha there, unless no
//     row's max moved;
//   * K and V fragments are loaded one step ahead of their mma's, so each
//     ldmatrix is in flight while the previous products issue;
//   * K/V tiles come through a two-stage cp.async ring: the copy of the
//     next live tile is issued right after the one barrier of each tile
//     (which also frees its slot) and is in flight while the warps compute
//     on the current one. Rows are padded by 16 bytes, so the 8 rows an
//     ldmatrix phase reads fall in 8 distinct bank groups;
//   * the Pallas kernel's causal `pl.when(live)` skip is a loop bound: the
//     block first finds the first and last key valid for any of its rows
//     (from the positions), and a tile inside that range whose 64 keys are
//     all invalid for every row is skipped before its copy is issued. The
//     test runs one tile ahead of the compute, on key positions read a
//     tile earlier still: every warp reads the same 64 positions and
//     votes, so all reach the same tile without a barrier. At increasing
//     prefill positions this halves the causal work;
//   * epilogue: divide by max(l, 1e-37), round to bf16, stage the warp's
//     rows in its own rows of the Q buffer and store 16 bytes a thread;
//   * shared memory at d 128: Q 17 KB + 2 x (K 17 KB + V 17 KB) = 87 KB;
//     204 registers a thread: two blocks (8 warps) an SM.
// A 128-row q-tile (8 warps of 16 rows, or 4 warps of 32 rows with Q read
// again from shared memory each tile) was measured beside this block shape
// and was not faster at the main path's shapes (PERF.md).
// What holds it at ~18% of the bf16 peak: latency. Each warp's S, softmax
// and PV run one after the other on one tile, and 8 warps an SM (the
// registers allow no more) do not hide the mma.sync and shuffle latencies.
// Left to later work: wgmma (asynchronous products on operands read by the
// tensor cores from shared memory, so one warpgroup's softmax overlaps
// another's products) fed by TMA with a producer warp, which is what the
// card's full bf16 rate needs; sharing a K/V tile between the g query
// heads of one KV head (each is read g times, from L2 at best).
//
// f32 route (for checks against the plain version): one block of 4 warps per
// 64-row q-tile with f32 FMAs on the CUDA cores (TF32 would change the
// rounding), S, P and O in shared memory, two lanes per row.
//
// C interface (loaded with ctypes): the launcher returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue for an unsupported dtype, head
// dim or grid.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

namespace {

constexpr int kBK = 64;            // keys per kv-tile
constexpr float kNegInf = -1e30f;  // same finite sentinel as the reference

// The first and last kv-tile that can hold a key valid for some row of the
// block: every thread reads its share of k_pos. sQPos holds the block's
// kBQ query positions (INT_MIN past sq); sRed 2 * (threads / 32) ints.
// Returns qmax (the largest query position of the block).
template <int kThreads, int kBQ>
__device__ __forceinline__ int kv_range(const int* sQPos,
                                        const int* __restrict__ k_pos,
                                        int skv, int causal, int* sRed,
                                        int& t_lo, int& t_hi) {
  constexpr int kWarps = kThreads / 32;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
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
  t_lo = hi < 0 ? 0 : lo / kBK;
  t_hi = hi < 0 ? 0 : hi / kBK + 1;
  return qmax;
}

// ---------------------------------------------------------------------------
// f32 route: CUDA-core FMAs, S, P and O in shared memory
// ---------------------------------------------------------------------------

namespace f32 {

constexpr int kThreads = 128;      // 4 warps, 16 q rows each
constexpr int kWarps = kThreads / 32;
constexpr int kBQ = 64;            // q rows per block
constexpr int kLdS = kBK + 4;      // S row stride, floats

static_assert(kBQ == 16 * kWarps, "each warp owns 16 rows");
static_assert(kBK == 64, "two lanes per row, 32 keys each");

// Shared-memory layout, byte offsets. Rows are padded so that neighbouring
// rows fall in other banks.
template <int D>
struct Smem {
  static constexpr int kLdIn = D + 4;  // Q/K/V
  static constexpr int kLdO = D + 4;   // O
  static constexpr size_t kQ = 0;
  static constexpr size_t kK = kQ + sizeof(float) * kBQ * kLdIn;
  static constexpr size_t kV = kK + sizeof(float) * kBK * kLdIn;
  static constexpr size_t kS = kV + sizeof(float) * kBK * kLdIn;
  static constexpr size_t kO = kS + sizeof(float) * kBQ * kLdS;
  static constexpr size_t kQPos = kO + sizeof(float) * kBQ * kLdO;
  static constexpr size_t kKPos = kQPos + sizeof(int) * kBQ;
  static constexpr size_t kRed = kKPos + sizeof(int) * kBK;
  static constexpr size_t kBytes = kRed + sizeof(int) * 2 * kWarps;
};

// rows [r0, r0 + 64) of a [n, D] matrix with row stride `stride` (elements)
// into shared memory, 16 bytes a thread per load; rows at or past n are zero
template <int D>
__device__ __forceinline__ void load_tile(float* dst,
                                          const float* __restrict__ src,
                                          int64_t stride, int r0, int n) {
  constexpr int VEC = 4;
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
      *reinterpret_cast<uint4*>(dst + (i / CPR) * Smem<D>::kLdIn +
                                (i % CPR) * VEC) = val[it];
  }
}

// s[j] = q_row . k_{2j + half} for this lane's row, unscaled.
template <int D>
__device__ __forceinline__ void scores(const float* sQ, const float* sK,
                                       int row, int half, float (&s)[32]) {
  constexpr int LD = Smem<D>::kLdIn;
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
}

// O[this lane pair's row] += P V, P in the S buffer.
template <int D>
__device__ __forceinline__ void accumulate_pv(const float* sS,
                                              const float* sV, float* sO,
                                              int row, int half) {
  constexpr int LD = Smem<D>::kLdIn;
  constexpr int LDO = Smem<D>::kLdO;
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
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const float* __restrict__ q, int64_t sqb, int64_t sqs,
             int64_t sqh, const float* __restrict__ k,
             const float* __restrict__ v, int64_t skb, int64_t sks,
             int64_t skh, const int* __restrict__ q_pos,
             const int* __restrict__ k_pos, float* __restrict__ out,
             float* __restrict__ lse, int sq, int skv, int hq, int g,
             int causal, float scale) {
  using L = Smem<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem + L::kQ);
  float* sK = reinterpret_cast<float*>(smem + L::kK);
  float* sV = reinterpret_cast<float*>(smem + L::kV);
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
  const float* qb = q + b * sqb + h * sqh;
  const float* kb = k + b * skb + (h / g) * skh;
  const float* vb = v + b * skb + (h / g) * skh;

  // rows past sq see no key under causal
  if (tid < kBQ) sQPos[tid] = q0 + tid < sq ? q_pos[q0 + tid] : INT_MIN;
  load_tile<D>(sQ, qb, sqs, q0, sq);
  for (int i = tid; i < kBQ * L::kLdO; i += kThreads) sO[i] = 0.f;
  __syncthreads();

  int t_lo, t_hi;
  const int qmax =
      kv_range<kThreads, kBQ>(sQPos, k_pos, skv, causal, sRed, t_lo, t_hi);

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
    load_tile<D>(sK, kb, sks, k0, skv);
    load_tile<D>(sV, vb, sks, k0, skv);
    __syncthreads();

    float s[32];
    scores<D>(sQ, sK, row, half, s);
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
#pragma unroll
    for (int j = 0; j < 32; ++j) sS[row * kLdS + 2 * j + half] = s[j];
    for (int c = half; c < D; c += 2) sO[row * L::kLdO + c] *= alpha;
    __syncwarp();
    accumulate_pv<D>(sS, sV, sO, row, half);
  }

  // normalise, then write the tile's rows with 16-byte stores
  const float den = fmaxf(l, 1e-37f);
  if (lse != nullptr && half == 0 && q0 + row < sq)
    lse[(static_cast<int64_t>(b) * hq + h) * sq + q0 + row] = m + logf(den);
  __syncwarp();
  for (int c = half; c < D; c += 2) sO[row * L::kLdO + c] /= den;
  __syncthreads();
  constexpr int VEC = 4;
  constexpr int CPR = D / VEC;
  for (int i = tid; i < kBQ * CPR; i += kThreads) {
    const int r = i / CPR;
    const int c = (i % CPR) * VEC;
    if (q0 + r >= sq) continue;
    *reinterpret_cast<float4*>(
        out + ((static_cast<int64_t>(b) * sq + q0 + r) * hq + h) * D + c) =
        *reinterpret_cast<const float4*>(sO + r * L::kLdO + c);
  }
}

template <int D>
int launch(int sq, int skv, int b, int hq, int g, cudaStream_t st,
           const void* q, int64_t sqb, int64_t sqs, int64_t sqh,
           const void* k, const void* v, int64_t skb, int64_t sks,
           int64_t skh, const void* q_pos, const void* k_pos, void* out,
           void* lse, int causal, float scale) {
  constexpr size_t bytes = Smem<D>::kBytes;
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const dim3 grid((sq + kBQ - 1) / kBQ, hq, b);
  flash_kernel<D><<<grid, kThreads, bytes, st>>>(
      static_cast<const float*>(q), sqb, sqs, sqh,
      static_cast<const float*>(k), static_cast<const float*>(v), skb, sks,
      skh, static_cast<const int*>(q_pos), static_cast<const int*>(k_pos),
      static_cast<float*>(out), static_cast<float*>(lse), sq, skv, hq, g,
      causal, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace f32

// ---------------------------------------------------------------------------
// bf16 route: mma.sync with S, P and O in registers, a cp.async K/V ring
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

// d += a (16 x 16, row) . b (16 x 8, col), bf16 in, f32 accumulate. Not
// volatile: a register-only op the compiler may schedule among the loads.
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

// 2^x on the special-function unit (inputs <= 0 here; ftz: a result below
// 2^-126 is 0, where the reference's f32 exp gives a denormal)
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

// The online softmax of one kv-tile on a warp's S registers: s (unscaled
// scores) becomes p, m (the running max, log2 domain) and l (this lane's
// share of the row sum) move on, and alpha is each row's rescale of O.
// Row r of the lane is gq + 8 r of its warp's rows (qp[r] its position).
// kMask: an entry whose key is invalid for its row (kpos[key] < 0, or
// after the row's position when causal) has no say in the max and gets
// p = 0 explicitly; a tile wholly valid for the warp's rows skips the test.
// The max is taken on the unscaled scores (scale > 0) and p is one FFMA
// and one ex2.
template <bool kMask>
__device__ __forceinline__ void softmax_tile(float (&s)[kBK / 8][4],
                                             const int* kpos,
                                             const int (&qp)[2], int causal,
                                             float scale_log2, float (&m)[2],
                                             float (&l)[2],
                                             float (&alpha)[2]) {
  constexpr int NS = kBK / 8;
  // n8 tile j holds keys j * 8 + 2 tg + {0, 1}
  int2 kp[kMask ? NS : 1];
  if constexpr (kMask) {
    const int tg = threadIdx.x & 3;
#pragma unroll
    for (int j = 0; j < NS; ++j)
      kp[j] = *reinterpret_cast<const int2*>(kpos + j * 8 + 2 * tg);
  }
  const auto ok = [&](int j, int e) {
    if constexpr (kMask) {
      const int k = e & 1 ? kp[j].y : kp[j].x;
      return k >= 0 && (!causal || k <= qp[e >> 1]);
    } else {
      return true;
    }
  };
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int j = 0; j < NS; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (ok(j, e)) mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new =
        fmaxf(m[r], mx[r] == kNegInf ? kNegInf : mx[r] * scale_log2);
    alpha[r] = exp2_approx(m[r] - m_new);
    m[r] = m_new;
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int j = 0; j < NS; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1;
      const float p =
          ok(j, e) ? exp2_approx(fmaf(s[j][e], scale_log2, -m[r])) : 0.f;
      s[j][e] = p;
      l[r] += p;
    }
}

// Block of 4 warps, 16 q rows each; the ring holds 2 stages of a K and a V
// tile. Every row of Q, K and V is padded by 16 bytes (kPitch elements),
// so the 8 rows an ldmatrix phase reads fall in 8 distinct bank groups.
template <int D>
struct Tile {
  static constexpr int kWarps = 4;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kBQ = 16 * kWarps;
  static constexpr int kPitch = D + 8;                       // elements
  static constexpr uint32_t kQ = 0;                          // byte offsets
  static constexpr uint32_t kKV = kQ + 2 * kBQ * kPitch;     // K0 V0 K1 V1
  static constexpr uint32_t kTileBytes = 2 * kBK * kPitch;   // one K or V
  static constexpr uint32_t kKPos = kKV + 4 * kTileBytes;    // 2 x kBK ints
  static constexpr uint32_t kQPos = kKPos + 4 * 2 * kBK;
  static constexpr uint32_t kRed = kQPos + 4 * kBQ;
  static constexpr size_t kBytes = kRed + 4 * 2 * kWarps;
  static_assert(D % 16 == 0 && D <= 128, "k16 steps, pairs of n8 tiles");
  static_assert(kBytes <= 232448, "a block's shared memory");
};

template <int D>
__global__ void __launch_bounds__(Tile<D>::kThreads, 2)
flash_tc_kernel(const bf16* __restrict__ q, int64_t sqb, int64_t sqs,
                int64_t sqh, const bf16* __restrict__ k,
                const bf16* __restrict__ v, int64_t skb, int64_t sks,
                int64_t skh, const int* __restrict__ q_pos,
                const int* __restrict__ k_pos, bf16* __restrict__ out,
                float* __restrict__ lse, int sq, int skv, int hq, int g,
                int causal, float scale_log2) {
  using L = Tile<D>;
  constexpr int kThreads = L::kThreads, kBQ = L::kBQ, P = L::kPitch;
  constexpr int CPR = D / 8;                 // 16-byte chunks per row
  constexpr int NS = kBK / 8;                // n8 tiles of S
  constexpr int NO = D / 8;                  // n8 tiles of O
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem + L::kQ);
  int* sKPos = reinterpret_cast<int*>(smem + L::kKPos);     // [2][kBK]
  int* sQPos = reinterpret_cast<int*>(smem + L::kQPos);
  int* sRed = reinterpret_cast<int*>(smem + L::kRed);
  const uint32_t sbase = smem_addr(smem);
  const auto k_addr = [&](int slot) {
    return sbase + L::kKV + (2 * slot) * L::kTileBytes;
  };
  const auto v_addr = [&](int slot) {
    return sbase + L::kKV + (2 * slot + 1) * L::kTileBytes;
  };

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tg = lane & 3;   // mma groupID, thread in group
  const int lr = lane & 7, lm = lane >> 3;   // ldmatrix row, matrix
  const int row0 = warp * 16;                // the warp's first row
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const bf16* qb = q + b * sqb + h * sqh;
  const bf16* kb = k + b * skb + (h / g) * skh;
  const bf16* vb = v + b * skb + (h / g) * skh;

  // Q tile -> shared memory (zeros past sq): the first cp.async group
#pragma unroll
  for (int i = tid; i < kBQ * CPR; i += kThreads) {
    const int r = i / CPR, c = (i % CPR) * 8;
    const bool ok = q0 + r < sq;
    cp_async16(sbase + L::kQ + 2 * (r * P + c),
               ok ? qb + (q0 + r) * sqs + c : qb, ok);
  }
  cp_commit();
  // rows past sq see no key under causal
  for (int i = tid; i < kBQ; i += kThreads)
    sQPos[i] = q0 + i < sq ? q_pos[q0 + i] : INT_MIN;
  __syncthreads();
  int t_lo, t_hi;
  const int qmax =
      kv_range<kThreads, kBQ>(sQPos, k_pos, skv, causal, sRed, t_lo, t_hi);
  // this lane's rows: gq and gq + 8 of the warp's, as qp[0] and qp[1]
  const int qp[2] = {sQPos[row0 + gq], sQPos[row0 + 8 + gq]};
  int wq_min = min(qp[0], qp[1]);            // the warp's least q position
#pragma unroll
  for (int o = 16; o; o >>= 1)
    wq_min = min(wq_min, __shfl_xor_sync(0xffffffffu, wq_min, o));

  // Key positions of tile t for this lane: keys lane and lane + 32 (-1
  // past skv, and for t >= t_hi).
  const auto load_kp = [&](int t, int (&kp)[2]) {
    const int k0 = t * kBK + lane;
    kp[0] = t < t_hi && k0 < skv ? k_pos[k0] : -1;
    kp[1] = t < t_hi && k0 + 32 < skv ? k_pos[k0 + 32] : -1;
  };
  // The first tile >= t (below t_hi) with a key valid for some row of the
  // block, given kp of tile t; kp ends as that tile's. Every warp reads the
  // same positions and votes, so all reach the same tile without a
  // barrier; a skipped tile costs one more read.
  const auto next_live = [&](int t, int (&kp)[2]) {
    while (t < t_hi &&
           !__any_sync(0xffffffffu,
                       (kp[0] >= 0 && (!causal || kp[0] <= qmax)) ||
                           (kp[1] >= 0 && (!causal || kp[1] <= qmax))))
      load_kp(++t, kp);
    return t;
  };
  // K and V rows [t * kBK, + kBK) -> ring slot `slot`, zeros past skv
  const auto load_kv = [&](int t, int slot) {
    const int k0 = t * kBK;
#pragma unroll
    for (int i = tid; i < kBK * CPR; i += kThreads) {
      const int r = i / CPR, c = (i % CPR) * 8;
      const bool ok = k0 + r < skv;
      const int64_t off = ok ? (k0 + r) * sks + c : 0;
      const uint32_t dst = 2 * (r * P + c);
      cp_async16(k_addr(slot) + dst, kb + off, ok);
      cp_async16(v_addr(slot) + dst, vb + off, ok);
    }
  };

  // the key positions of the tile computed (cur) and of the candidate
  // after it (nxt), read one iteration ahead of their vote
  int kp_cur[2], kp_nxt[2];
  load_kp(t_lo, kp_cur);
  int t = next_live(t_lo, kp_cur);
  if (t < t_hi) {
    load_kv(t, 0);
    if (warp == 0) {
      sKPos[lane] = kp_cur[0];
      sKPos[lane + 32] = kp_cur[1];
    }
  }
  cp_commit();
  load_kp(t + 1, kp_nxt);
  cp_wait<1>();                              // Q has landed (this thread's)
  __syncthreads();                           // ... everyone's

  // Q's A fragments, one a k16 step, kept for the whole loop: matrices
  // (rows 0-7 | 8-15) x (d 0-7 | 8-15)
  const uint32_t q_lane =
      sbase + L::kQ + 2 * ((row0 + (lm & 1) * 8 + lr) * P + (lm >> 1) * 8);
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) ldsm_x4(q_lane + 2 * kk * 16, qf[kk]);
  // K as B (plain): matrices (keys 0-7 | 8-15 of an n8 pair) x (d 0-7 |
  // 8-15); V as B (.trans): (keys 0-7 | 8-15 of a k16 step) x (d 0-7 |
  // 8-15 of an n8 pair)
  const uint32_t k_lane = 2 * (((lm >> 1) * 8 + lr) * P + (lm & 1) * 8);
  const uint32_t v_lane = 2 * (((lm & 1) * 8 + lr) * P + (lm >> 1) * 8);

  float o[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  // running max (log2 domain) and this lane's share of the sum, rows gq
  // and gq + 8
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  for (int n = 0; t < t_hi; ++n) {
    const int slot = n & 1;
    const int t_next = next_live(t + 1, kp_nxt);
    cp_wait<0>();                            // tile t has landed
    __syncthreads();                         // for every thread; and every
    // warp is done with tile t - 1, so the other slot takes the next copy
    if (t_next < t_hi) {
      load_kv(t_next, slot ^ 1);
      if (warp == 0) {
        sKPos[(slot ^ 1) * kBK + lane] = kp_nxt[0];
        sKPos[(slot ^ 1) * kBK + lane + 32] = kp_nxt[1];
      }
    }
    cp_commit();
    // a warp whose rows see all 64 keys of the tile skips the mask
    const bool full = __all_sync(
        0xffffffffu, min(kp_cur[0], kp_cur[1]) >= 0 &&
                         (!causal || max(kp_cur[0], kp_cur[1]) <= wq_min));
    kp_cur[0] = kp_nxt[0];
    kp_cur[1] = kp_nxt[1];
    load_kp(t_next + 1, kp_nxt);             // voted on after this tile

    // S = Q K^T: n8 tile j holds keys j * 8 + 2 tg + {0, 1} of rows gq
    // (c0, c1) and gq + 8 (c2, c3)
    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    // K fragments run one step ahead of the products: the ldmatrix of
    // step st + 1 is in flight while the mma's of step st issue. A step is
    // one K fragment pair (k16 step kk, n8 pair np).
    constexpr int SK = NS / 2;               // n8 pairs of S a k16 step
    const auto k_frag = [&](int st, uint32_t (&bk)[4]) {
      ldsm_x4(k_addr(slot) + k_lane +
                  2 * ((st % SK) * 16 * P + (st / SK) * 16),
              bk);
    };
    uint32_t bk[2][4];
    k_frag(0, bk[0]);
#pragma unroll
    for (int st = 0; st < (D / 16) * SK; ++st) {
      const int kk = st / SK, np = st % SK;
      if (st + 1 < (D / 16) * SK) k_frag(st + 1, bk[(st + 1) & 1]);
      mma16816(s[2 * np], qf[kk], bk[st & 1][0], bk[st & 1][1]);
      mma16816(s[2 * np + 1], qf[kk], bk[st & 1][2], bk[st & 1][3]);
    }

    // V's first fragments load under the softmax
    constexpr int SV = NO / 2;               // n8 pairs of O a k16 step
    const auto v_frag = [&](int st, uint32_t (&bv)[4]) {
      ldsm_x4_t(v_addr(slot) + v_lane +
                    2 * ((st / SV) * 16 * P + (st % SV) * 16),
                bv);
    };
    uint32_t bv[2][4];
    v_frag(0, bv[0]);

    // online softmax in registers, then O rescaled by alpha unless no
    // row's max moved (multiplying by 1 changes nothing)
    float alpha[2];
    if (full)
      softmax_tile<false>(s, nullptr, qp, causal, scale_log2, m, l, alpha);
    else
      softmax_tile<true>(s, sKPos + slot * kBK, qp, causal, scale_log2, m, l,
                         alpha);
    if (!__all_sync(0xffffffffu, alpha[0] == 1.f && alpha[1] == 1.f)) {
#pragma unroll
      for (int j = 0; j < NO; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[j][e] *= alpha[e >> 1];
    }

    // O += P V: n8 tiles 2 kk and 2 kk + 1 of P are the A fragment of k16
    // step kk, rounded to bf16; V's fragments one step ahead
    uint32_t pa[4];
#pragma unroll
    for (int st = 0; st < (NS / 2) * SV; ++st) {
      const int kk = st / SV, dp = st % SV;
      if (st + 1 < (NS / 2) * SV) v_frag(st + 1, bv[(st + 1) & 1]);
      if (dp == 0) {
        pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
        pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
        pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      }
      mma16816(o[2 * dp], pa, bv[st & 1][0], bv[st & 1][1]);
      mma16816(o[2 * dp + 1], pa, bv[st & 1][2], bv[st & 1][3]);
    }
    t = t_next;
  }
  cp_wait<0>();

  // epilogue: the row sums across the quad, O / l in bf16 into the warp's
  // own rows of the Q buffer (only this warp reads them), then 16 bytes a
  // lane to out
  __syncwarp();                              // the warp's Q reads are done
  uint32_t* sO = reinterpret_cast<uint32_t*>(sQ);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const float den = fmaxf(l[r], 1e-37f);
    const float inv = 1.f / den;
#pragma unroll
    for (int j = 0; j < NO; ++j)
      sO[((row0 + 8 * r + gq) * P + j * 8 + 2 * tg) / 2] =
          pack_bf16(o[j][2 * r] * inv, o[j][2 * r + 1] * inv);
    // natural-log lse of the row, from the log2-domain max and the sum
    const int qr = q0 + row0 + 8 * r + gq;
    if (lse != nullptr && tg == 0 && qr < sq)
      lse[(static_cast<int64_t>(b) * hq + h) * sq + qr] =
          (m[r] + log2f(den)) * 0.6931471805599453f;
  }
  __syncwarp();
  for (int i = lane; i < 16 * CPR; i += 32) {
    const int r = row0 + i / CPR, c = (i % CPR) * 8;
    if (q0 + r >= sq) continue;
    *reinterpret_cast<uint4*>(
        out + ((static_cast<int64_t>(b) * sq + q0 + r) * hq + h) * D + c) =
        *reinterpret_cast<const uint4*>(sQ + r * P + c);
  }
}

template <int D>
int launch(int sq, int skv, int b, int hq, int g, cudaStream_t st,
           const void* q, int64_t sqb, int64_t sqs, int64_t sqh,
           const void* k, const void* v, int64_t skb, int64_t sks,
           int64_t skh, const void* q_pos, const void* k_pos, void* out,
           void* lse, int causal, float scale) {
  using L = Tile<D>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(L::kBytes));
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const dim3 grid((sq + L::kBQ - 1) / L::kBQ, hq, b);
  flash_tc_kernel<D><<<grid, L::kThreads, L::kBytes, st>>>(
      static_cast<const bf16*>(q), sqb, sqs, sqh, static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), skb, sks, skh,
      static_cast<const int*>(q_pos), static_cast<const int*>(k_pos),
      static_cast<bf16*>(out), static_cast<float*>(lse), sq, skv, hq, g,
      causal, scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

template <int D>
int launch_d(int dtype, int sq, int skv, int b, int hq, int g,
             cudaStream_t st, const void* q, int64_t sqb, int64_t sqs,
             int64_t sqh, const void* k, const void* v, int64_t skb,
             int64_t sks, int64_t skh, const void* q_pos, const void* k_pos,
             void* out, void* lse, int causal, float scale) {
#define FLASH_ARGS                                                          \
  sq, skv, b, hq, g, st, q, sqb, sqs, sqh, k, v, skb, sks, skh, q_pos,      \
      k_pos, out, lse, causal, scale
  if (dtype == 0) return tc::launch<D>(FLASH_ARGS);
  if (dtype == 1) return f32::launch<D>(FLASH_ARGS);
#undef FLASH_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = bfloat16, 1 = float32. Strides are in elements; q [b, sq, hq, d]
// by (sqb, sqs, sqh), k and v [b, skv, hkv, d] by (skb, sks, skh); q_pos [sq]
// and k_pos [skv] int32; out [b, sq, hq, d] contiguous; lse, when not null,
// [b, hq, sq] f32 contiguous: each row's natural-log log-sum-exp of its
// scaled scores, m + log(max(l, 1e-37)), which the backward reads (a null lse
// leaves the launch as it was without one, bit for bit).
extern "C" int flash_attention_launch(
    int dtype, int d, const void* q, long long sqb, long long sqs,
    long long sqh, const void* k, const void* v, long long skb,
    long long sks, long long skh, const void* q_pos, const void* k_pos,
    void* out, void* lse, int b, int sq, int skv, int hq, int hkv,
    int causal, float scale, void* stream) {
  if (b < 1 || b > 65535 || sq < 1 || skv < 1 || hkv < 1 || hq > 65535 ||
      hq % hkv)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FLASH_CASE(DIM)                                                      \
  case DIM:                                                                  \
    return launch_d<DIM>(dtype, sq, skv, b, hq, hq / hkv, st, q, sqb, sqs,  \
                         sqh, k, v, skb, sks, skh, q_pos, k_pos, out, lse,   \
                         causal, scale);
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
