// Flash-decode GQA attention for Hopper (sm_90a): one new query token per
// sequence against its KV cache, dense or paged.
//
//   out[b, h * g + i, :] = sum_r p_r v[b, h, r, :] / max(sum_r p_r, 1e-37),
//   p_r = exp(s_r - max_r s_r),  s_r = (q[b, h * g + i, :] . k[b, h, r, :])
//                                      / sqrt(D)
// over the rows r < lengths[b] (masked scores take the reference's finite
// -1e30 sentinel); m, l and acc are f32. A row with length 0 gives zeros,
// as the Pallas kernel does (its _compute never runs).
//
// Replaces the Pallas TPU kernels of the reference package:
//   src/repro/kernels/decode_attention/decode_attention.py
//     decode_attention        (pl.pallas_call at :88, kernel body _kernel :30)
//     paged_decode_attention  (pl.pallas_call at :205, _paged_kernel :122)
//
// What bounds it on this card: bytes, once the math is cheap enough. A
// decode step reads every valid K/V row once for 4 flops an element (the g
// query heads of a KV head share each row). The least time is (valid K/V
// bytes + q + o) / 3.35 TB/s: 9 us at minitron-8b's decode shape (8 slots
// of up to 2048 rows, 8 KV heads of 128). On the CUDA cores the math was
// not cheap: a bf16 tile of 16 rows cost ~900 instructions a warp (bf16
// unpacking, q read from shared memory four floats at a time, one FMA an
// element and head, heads past g predicated off), and with the loads
// skipped the split kernel still took 22 us at that shape. So the bf16
// route runs the products on the tensor cores (~80 instructions a tile),
// not for their rate but for their instruction count; f32 stays on the
// CUDA cores (no f32 tensor-core product without TF32's rounding).
//
// Design: split-KV flash-decode, one core for both layouts.
//   * Split the KV axis across the SMs. Split j of a (batch row, KV head)
//     covers logical rows [j * kChunk, (j + 1) * kChunk); the grid is
//     (Hkv, B, ceil(S / kChunk)) and a block whose split starts at or past
//     its row's length returns at once (lengths stay on the card). kChunk
//     is a constant: it does not depend on S, the page size or the layout,
//     so splits fall on the same logical rows in both kernels. (One block a
//     (row, KV head), as before, gave 64 blocks for 132 SMs at 8 slots and
//     8 KV heads, and its 2048-row blocks walked 32 tiles in a row.)
//   * Inside a split, each of the block's kWarps warps is an independent
//     flash-decode stream: warp w takes the split's tiles of kRows rows
//     w, w + kWarps, ... through its own two-stage cp.async ring in shared
//     memory (16 bytes a copy, zero-filled past the length); the first two
//     tiles are in flight before q is read, and tile t + 2 is issued as
//     soon as tile t is consumed. A warp's ring is its own: the loop has no
//     block barrier, only __syncwarp.
//   * bf16 (TcCore): S^T = K Q^T on mma.sync m16n8k16 with the 16 rows as M
//     and the g <= 8 heads as N, Q^T's fragments in registers, K by
//     ldmatrix; the online softmax on the C fragments; p rounded to bf16
//     (as the Pallas kernel casts p to v's dtype) and turned into P^T's B
//     fragments by movmatrix.trans; O^T += V^T P^T with V by
//     ldmatrix.trans. f32 (FmaCore): scores on two lanes a row, PV on one
//     16-byte chunk of D a lane.
//   * The block merges its warps' (m, l, acc) in warp order and writes the
//     split's partial in f32 to a workspace [B, Hkv, nsplit,
//     slot_floats(g, D)] that the wrapper allocates. A second kernel,
//     launched from the same C entry point, reduces the splits
//     j < ceil(length / kChunk) of each (b, h) in split order:
//     m* = max m_j, l = sum l_j e^(m_j - m*),
//     o = sum acc_j e^(m_j - m*) / max(l, 1e-37). Slots of splits past the
//     length are never read.
//   * K/V are read through the cache's own layout and strides: dense
//     [B, S, Hkv, D] (passed as a [B, Hkv, S, D] view), paged
//     [P, page, Hkv, D] through the row's block table. Rows at or past the
//     length are never read (unused table entries are 0, the never-read
//     scratch page).
//   * The order of the arithmetic depends only on logical row indices and
//     the length, so the dense and the paged kernel give bit-identical
//     results for the same logical cache whatever S or the page size —
//     which keeps dense and paged engines token-identical.
// Shared memory at D 128 bf16: the four rings, 4 x 2 x 8.5 KB = 68 KB,
// three blocks (12 warps) an SM.
// What holds it above the bound: the split kernel is latency-bound on its
// loads (as long with the math skipped); each warp has four tiles, two in
// flight, so a split is about two load round trips under full load, plus
// the block's start (the length) and end (the merge), and the combine
// kernel after it (PERF.md).
//   * On request (a non-null lse, the dense launcher only) the combine also
//     writes each row's log-sum-exp of its scaled scores, m + log(l) from
//     the max and the sum it forms anyway, -inf at length 0: what a caller
//     needs to merge partial results over a sequence-sharded cache. The
//     output's bits do not depend on it.
//
// C interface (loaded with ctypes): decode_attention_ws_floats sizes the
// workspace; each launcher returns the first error of its two launches
// (cudaGetLastError() after each), or cudaErrorInvalidValue for an
// unsupported dtype, head_dim or group size, or a workspace too small.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;          // independent streams of a split
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16;          // KV rows a warp takes a step
constexpr int kChunk = 256;        // KV rows a split
constexpr int kMaxG = 8;           // query heads per KV head
constexpr float kNegInf = -1e30f;  // same finite sentinel as the reference

static_assert(kChunk % (kWarps * kRows) == 0, "a split is whole tiles");
static_assert(kRows == 16, "scores: two lanes a row, 16 rows a warp");

__device__ __forceinline__ void to_f32(const uint4& raw, float* out) {
  out[0] = __uint_as_float(raw.x);
  out[1] = __uint_as_float(raw.y);
  out[2] = __uint_as_float(raw.z);
  out[3] = __uint_as_float(raw.w);
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

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

struct Params {
  const void* q;
  int64_t sqb, sqh;           // q strides: batch row, head
  const void* k;
  const void* v;
  int64_t s0, sks, skh;       // k/v strides: batch row (dense) or page
                              // (paged), row, KV head
  const int* lengths;         // [B]
  const int* tables;          // [B, pps] (paged)
  int pps, page;
  int S;                      // rows a batch row can hold
  int Hkv, g, nsplit;
  float scale;
  float* ws;                  // [B, Hkv, nsplit, slot_floats(g, D)]
  void* out;                  // [B, Hkv * g, D]
  float* lse;                 // [B, Hkv * g] or null: m + log(l) a row
};

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

// the 8 x 8 bf16 matrix whose row T / 4, columns 2 (T % 4) + {0, 1} lane T
// holds, transposed into the same layout
__device__ __forceinline__ uint32_t movmatrix_t(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n"
               : "=r"(y)
               : "r"(x));
  return y;
}

// two f32 as one bf16x2 register, x in the low half
__device__ __forceinline__ uint32_t pack_bf16(float x, float y) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Workspace floats of one split's partial: acc [g][D], then m [g] and l [g],
// padded to 16 bytes so the combine reads acc as float4.
__host__ __device__ __forceinline__ int slot_floats(int g, int D) {
  return g * D + ((2 * g + 3) & ~3);
}

// Shared-memory layout of a split block (bytes).
template <typename T, int D>
struct Smem {
  static constexpr int kRowBytes = D * sizeof(T) + 16;  // padded: 8 rows
  // read at one column (ldmatrix phases, the f32 score lanes) fall in 8
  // distinct bank groups
  static constexpr int kQ = 0;        // f32 [kMaxG][D], the f32 route's q
  static constexpr int kRing = kQ + (sizeof(T) == 4 ? kMaxG * D * 4 : 0);
  static constexpr int kSlot = 2 * kRows * kRowBytes;   // K then V
  static constexpr int kWarpRing = 2 * kSlot;           // two stages
  static constexpr int kBytes = kRing + kWarps * kWarpRing;
  static_assert(kRing % 16 == 0, "16-byte aligned ring");
  static_assert(kWarpRing >= (kMaxG * D + 2 * kMaxG) * 4,
                "a warp's ring holds its final (acc, m, l)");
};

// The f32 route, on the CUDA cores: one warp's online softmax over its
// tiles. Scores: two lanes a row (lane & 15 the row, lane >> 4 which
// alternate 16-byte chunks of it) against q in shared memory, one shuffle
// to add the halves; the tile's max and sum over its 16 rows are
// butterflies, so every lane holds the same m and l. PV: a lane owns one
// 16-byte chunk of D for every head (acc in registers) and takes the
// tile's rows 32 / (D / 4) at a time, p shuffled from the score lanes; the
// row groups are summed once, at the end.
template <int D>
struct FmaCore {
  static constexpr int VEC = 4;        // floats a 16-byte chunk
  static constexpr int CPR = D / VEC;  // chunks a row
  static constexpr int RP = 32 / CPR;  // rows a PV step covers
  static constexpr int RB = Smem<float, D>::kRowBytes;
  static_assert(CPR >= 8 && CPR <= 32 && 32 % CPR == 0, "row in a warp");

  const float* sQ;
  int g, lane;
  float acc[kMaxG][VEC];
  float m[kMaxG], l[kMaxG];

  // q of the group's heads -> shared memory (the block syncs after)
  __device__ void stage_q(const float* qb, int64_t sqh, float* sq, int tid) {
    for (int i = tid; i < g * D; i += kThreads)
      sq[i] = qb[(i / D) * sqh + i % D];
    sQ = sq;
  }

  __device__ void init() {
#pragma unroll
    for (int hh = 0; hh < kMaxG; ++hh) {
      m[hh] = kNegInf;
      l[hh] = 0.f;
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[hh][e] = 0.f;
    }
  }

  // one tile: rows [0, nvalid) of the kRows staged at Ks / Vs are valid
  __device__ void tile(const unsigned char* Ks, const unsigned char* Vs,
                       int nvalid, float scale) {
    const int sr = lane & 15, sh = lane >> 4;     // score lane: row, half
    const int pc = lane % CPR, pr = lane / CPR;   // PV lane: chunk, rows
    float s[kMaxG];
#pragma unroll
    for (int hh = 0; hh < kMaxG; ++hh) s[hh] = 0.f;
#pragma unroll
    for (int u = 0; u < CPR / 2; ++u) {
      const int c = 2 * u + sh;
      float kf[VEC];
      to_f32(*reinterpret_cast<const uint4*>(Ks + sr * RB + c * 16), kf);
#pragma unroll
      for (int hh = 0; hh < kMaxG; ++hh) {
        if (hh < g) {
          const float* qq = sQ + hh * D + c * VEC;
#pragma unroll
          for (int e = 0; e < VEC; ++e) s[hh] = fmaf(qq[e], kf[e], s[hh]);
        }
      }
    }
    float alpha[kMaxG], pe[kMaxG];
#pragma unroll
    for (int hh = 0; hh < kMaxG; ++hh) {
      alpha[hh] = 1.f;
      pe[hh] = 0.f;
      if (hh < g) {
        float x = s[hh] + __shfl_xor_sync(0xffffffffu, s[hh], 16);
        x = sr < nvalid ? x * scale : kNegInf;
        float mt = x;
#pragma unroll
        for (int o = 8; o > 0; o >>= 1)
          mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, o));
        const float m_new = fmaxf(m[hh], mt);
        pe[hh] = expf(x - m_new);
        float st = pe[hh];
#pragma unroll
        for (int o = 8; o > 0; o >>= 1)
          st += __shfl_xor_sync(0xffffffffu, st, o);
        alpha[hh] = expf(m[hh] - m_new);
        l[hh] = fmaf(l[hh], alpha[hh], st);
        m[hh] = m_new;
      }
    }
#pragma unroll
    for (int hh = 0; hh < kMaxG; ++hh) {
      if (hh < g) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[hh][e] *= alpha[hh];
      }
    }
#pragma unroll
    for (int u = 0; u < kRows / RP; ++u) {
      const int r = pr + RP * u;
      float vf[VEC];
      to_f32(*reinterpret_cast<const uint4*>(Vs + r * RB + pc * 16), vf);
#pragma unroll
      for (int hh = 0; hh < kMaxG; ++hh) {
        if (hh < g) {
          const float w = __shfl_sync(0xffffffffu, pe[hh], r);
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            acc[hh][e] = fmaf(w, vf[e], acc[hh][e]);
        }
      }
    }
  }

  // the warp's (acc [kMaxG][D], m [kMaxG], l [kMaxG]) -> wst
  __device__ void park(float* wst) {
    const int pc = lane % CPR, pr = lane / CPR;
#pragma unroll
    for (int hh = 0; hh < kMaxG; ++hh) {
      if (hh < g) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
#pragma unroll
          for (int o = CPR; o < 32; o <<= 1)
            acc[hh][e] += __shfl_xor_sync(0xffffffffu, acc[hh][e], o);
          if (pr == 0) wst[hh * D + pc * VEC + e] = acc[hh][e];
        }
        if (lane == 0) {
          wst[kMaxG * D + hh] = m[hh];
          wst[kMaxG * D + kMaxG + hh] = l[hh];
        }
      }
    }
  }
};

// The bf16 route, on the tensor cores (mma.sync m16n8k16, f32 accumulate):
// a tile is S^T = K Q^T with the 16 rows as M and the g <= 8 heads as N
// (heads past g are zero columns), then O^T += V^T P^T with D as M and the
// 16 rows as K. Q^T's B fragments stay in registers for the whole loop;
// K comes by ldmatrix, V by ldmatrix.trans. A lane holds S^T of rows gq
// and gq + 8 for heads 2 tg and 2 tg + 1, so a head's max and sum over
// the tile are three shuffles across gq. p is rounded to bf16 for the PV
// product (as the Pallas kernel casts p to v's dtype; l sums the f32 p),
// and two movmatrix.trans turn its C fragments into P^T's B fragments.
template <int D>
struct TcCore {
  typedef __nv_bfloat16 bf16;
  static constexpr int KS = D / 16;    // k16 steps of S, m16 tiles of O^T
  static constexpr int RB = Smem<bf16, D>::kRowBytes;

  int g, lane;
  uint32_t qf[KS][2];                  // Q^T: d 16 kk + 2 tg (+ 8), head gq
  float o[KS][4];                      // O^T: d 16 t + gq (+ 8), heads 2 tg
  float m[2], l[2];                    // heads 2 tg and 2 tg + 1

  // Q^T's B fragments straight from q (zero columns past g)
  __device__ void stage_q(const bf16* qb, int64_t sqh, float*, int) {
    const int gq = lane >> 2, tg = lane & 3;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const bf16* e = qb + gq * sqh + kk * 16 + hf * 8 + 2 * tg;
        qf[kk][hf] = gq < g ? pack_bf16(__bfloat162float(e[0]),
                                        __bfloat162float(e[1]))
                            : 0u;
      }
    }
  }

  __device__ void init() {
#pragma unroll
    for (int t = 0; t < KS; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[t][e] = 0.f;
    m[0] = m[1] = kNegInf;
    l[0] = l[1] = 0.f;
  }

  __device__ void tile(const unsigned char* Ks, const unsigned char* Vs,
                       int nvalid, float scale) {
    const int gq = lane >> 2, lr = lane & 7, lm = lane >> 3;
    // S^T: K as A (plain): matrices (rows 0-7 | 8-15) x (d 0-7 | 8-15)
    const uint32_t k_lane = smem_addr(Ks) + ((lm & 1) * 8 + lr) * RB +
                            (lm >> 1) * 16;
    float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t a[4];
      ldsm_x4(k_lane + kk * 32, a);
      mma16816(s, a, qf[kk][0], qf[kk][1]);
    }
    // online softmax: s[e] is row gq + 8 (e >> 1), head 2 tg + (e & 1)
    float alpha[2];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      s[e] = gq + 8 * (e >> 1) < nvalid ? s[e] * scale : kNegInf;
#pragma unroll
    for (int hc = 0; hc < 2; ++hc) {
      float mt = fmaxf(s[hc], s[2 + hc]);
#pragma unroll
      for (int o_ = 4; o_ < 32; o_ <<= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, o_));
      const float m_new = fmaxf(m[hc], mt);
      s[hc] = expf(s[hc] - m_new);
      s[2 + hc] = expf(s[2 + hc] - m_new);
      float st = s[hc] + s[2 + hc];
#pragma unroll
      for (int o_ = 4; o_ < 32; o_ <<= 1)
        st += __shfl_xor_sync(0xffffffffu, st, o_);
      alpha[hc] = expf(m[hc] - m_new);
      l[hc] = fmaf(l[hc], alpha[hc], st);
      m[hc] = m_new;
    }
    // P^T as B: rows 2 tg (+ 1) (+ 8) of head gq
    const uint32_t b0 = movmatrix_t(pack_bf16(s[0], s[1]));
    const uint32_t b1 = movmatrix_t(pack_bf16(s[2], s[3]));
    // O^T: V as A (.trans): matrices (rows 0-7 | 8-15) x (d 0-7 | 8-15) in
    // the order (d 0-7, rows 0-7), (d 8-15, rows 0-7), (d 0-7, rows 8-15),
    // (d 8-15, rows 8-15)
    const uint32_t v_lane = smem_addr(Vs) + ((lm >> 1) * 8 + lr) * RB +
                            (lm & 1) * 16;
#pragma unroll
    for (int t = 0; t < KS; ++t) {
      uint32_t a[4];
      ldsm_x4_t(v_lane + t * 32, a);
#pragma unroll
      for (int e = 0; e < 4; ++e) o[t][e] *= alpha[e & 1];
      mma16816(o[t], a, b0, b1);
    }
  }

  __device__ void park(float* wst) {
    const int gq = lane >> 2, tg = lane & 3;
#pragma unroll
    for (int t = 0; t < KS; ++t) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hh = 2 * tg + (e & 1);
        if (hh < g) wst[hh * D + 16 * t + gq + 8 * (e >> 1)] = o[t][e];
      }
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int hh = 2 * tg + e;
      if (gq == 0 && hh < g) {
        wst[kMaxG * D + hh] = m[e];
        wst[kMaxG * D + kMaxG + hh] = l[e];
      }
    }
  }
};

template <typename T, int D>
struct CoreOf {
  typedef FmaCore<D> type;
};
template <int D>
struct CoreOf<__nv_bfloat16, D> {
  typedef TcCore<D> type;
};

// One split of one (batch row, KV head): the online softmax over rows
// [j * kChunk, min((j + 1) * kChunk, length)), written to the workspace.
template <typename T, int D, bool kPaged>
__global__ void __launch_bounds__(kThreads, 3)
    decode_attn_split(const Params p) {
  using L = Smem<T, D>;
  constexpr int VEC = 16 / sizeof(T);  // elements per 16-byte chunk
  constexpr int CPR = D / VEC;         // chunks a row
  constexpr int CPL = kRows * CPR / 32;  // K (and V) chunks a lane copies
  static_assert(CPL >= 1 && kRows * CPR % 32 == 0, "tile in whole copies");

  const int h = blockIdx.x, b = blockIdx.y, j = blockIdx.z;
  const int length = min(max(p.lengths[b], 0), p.S);
  const int c0 = j * kChunk;
  if (c0 >= length) return;
  const int c1 = min(c0 + kChunk, length);
  const int g = p.g;

  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  const T* kb = static_cast<const T*>(p.k) + (kPaged ? 0 : b * p.s0) +
                h * p.skh;
  const T* vb = static_cast<const T*>(p.v) + (kPaged ? 0 : b * p.s0) +
                h * p.skh;
  const int* table = p.tables + static_cast<int64_t>(b) * p.pps;
  // element offset of logical row `row` (< length) from kb / vb
  const auto row_off = [&](int row) -> int64_t {
    if (kPaged)
      return static_cast<int64_t>(__ldg(table + row / p.page)) * p.s0 +
             static_cast<int64_t>(row % p.page) * p.sks;
    return static_cast<int64_t>(row) * p.sks;
  };

  unsigned char* ring = smem + L::kRing + warp * L::kWarpRing;
  const uint32_t ring_s = smem_addr(ring);
  // this warp's tiles of the split: the i-th starts at row
  // c0 + (warp + kWarps i) kRows
  const int n_tiles = (c1 - c0 + kRows - 1) / kRows;
  const int n_mine = n_tiles > warp ? (n_tiles - warp + kWarps - 1) / kWarps
                                    : 0;
  const auto tile_row = [&](int i) {
    return c0 + (warp + kWarps * i) * kRows;
  };
  // tile i -> ring slot i & 1 (one commit group; empty past the last tile)
  const auto load_tile = [&](int i) {
    if (i < n_mine) {
      const int r0 = tile_row(i);
      const uint32_t base = ring_s + (i & 1) * L::kSlot;
#pragma unroll
      for (int u = 0; u < CPL; ++u) {
        const int e = lane + 32 * u;
        const int r = e / CPR, c = e % CPR;
        const bool ok = r0 + r < c1;
        const int64_t off = ok ? row_off(r0 + r) + c * VEC : 0;
        const uint32_t dst = base + r * L::kRowBytes + c * 16;
        cp_async16(dst, kb + off, ok);
        cp_async16(dst + kRows * L::kRowBytes, vb + off, ok);
      }
    }
    cp_commit();
  };
  // the first two tiles are in flight before q is staged
  load_tile(0);
  load_tile(1);

  typename CoreOf<T, D>::type core;
  core.g = g;
  core.lane = lane;
  core.stage_q(static_cast<const T*>(p.q) + b * p.sqb + h * g * p.sqh, p.sqh,
               reinterpret_cast<float*>(smem + L::kQ), tid);
  core.init();
  __syncthreads();

  for (int i = 0; i < n_mine; ++i) {
    cp_wait<1>();                       // tile i has landed (this lane's)
    __syncwarp();                       // ... and every lane's
    const unsigned char* Ks = ring + (i & 1) * L::kSlot;
    core.tile(Ks, Ks + kRows * L::kRowBytes, c1 - tile_row(i), p.scale);
    __syncwarp();                       // every lane is done with slot i & 1
    load_tile(i + 2);
  }
  cp_wait<0>();
  core.park(reinterpret_cast<float*>(ring));   // the warp's own ring
  __syncthreads();

  // merge the warps in warp order into the split's partial
  const float* w0 = reinterpret_cast<const float*>(smem + L::kRing);
  constexpr int kWF = L::kWarpRing / 4;          // floats between warps
  float* slot = p.ws + ((static_cast<int64_t>(b) * p.Hkv + h) * p.nsplit + j) *
                           slot_floats(g, D);
  for (int i = tid; i < g * D; i += kThreads) {
    const int hh = i / D, d = i % D;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      mx = fmaxf(mx, w0[w * kWF + kMaxG * D + hh]);
    float o = 0.f, lsum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float* st = w0 + w * kWF;
      const float e = expf(st[kMaxG * D + hh] - mx);
      o = fmaf(st[hh * D + d], e, o);
      lsum = fmaf(st[kMaxG * D + kMaxG + hh], e, lsum);
    }
    slot[hh * D + d] = o;
    if (d == 0) {
      slot[g * D + hh] = mx;
      slot[g * D + g + hh] = lsum;
    }
  }
}

// The splits of one (batch row, KV head), reduced in split order. A thread
// takes 4 consecutive d of one head; the first kBatch splits' partials are
// loaded together, before the max over them is known.
constexpr int kBatch = 8;

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    decode_attn_combine(const Params p) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int g = p.g;
  const int length = min(max(p.lengths[b], 0), p.S);
  const int n = (length + kChunk - 1) / kChunk;
  const int per = slot_floats(g, D);
  const float* ws = p.ws + (static_cast<int64_t>(b) * p.Hkv + h) * p.nsplit *
                               per;
  T* out = static_cast<T*>(p.out) + (static_cast<int64_t>(b) * p.Hkv + h) *
                                        g * D;
  for (int i = threadIdx.x; i < g * D / 4; i += kThreads) {
    const int hh = (4 * i) / D, d = (4 * i) % D;
    float4 a[kBatch];
    float mj[kBatch], lj[kBatch];
#pragma unroll
    for (int jj = 0; jj < kBatch; ++jj) {
      if (jj < n) {
        const float* st = ws + jj * per;
        a[jj] = *reinterpret_cast<const float4*>(st + hh * D + d);
        mj[jj] = st[g * D + hh];
        lj[jj] = st[g * D + g + hh];
      }
    }
    float mx = kNegInf;
#pragma unroll
    for (int jj = 0; jj < kBatch; ++jj)
      if (jj < n) mx = fmaxf(mx, mj[jj]);
    for (int jj = kBatch; jj < n; ++jj)
      mx = fmaxf(mx, ws[jj * per + g * D + hh]);
    float o[4] = {0.f, 0.f, 0.f, 0.f};
    float lsum = 0.f;
    const auto add = [&](const float4& x, float m_j, float l_j) {
      const float e = expf(m_j - mx);
      o[0] = fmaf(x.x, e, o[0]);
      o[1] = fmaf(x.y, e, o[1]);
      o[2] = fmaf(x.z, e, o[2]);
      o[3] = fmaf(x.w, e, o[3]);
      lsum = fmaf(l_j, e, lsum);
    };
#pragma unroll
    for (int jj = 0; jj < kBatch; ++jj)
      if (jj < n) add(a[jj], mj[jj], lj[jj]);
    for (int jj = kBatch; jj < n; ++jj) {
      const float* st = ws + jj * per;
      add(*reinterpret_cast<const float4*>(st + hh * D + d), st[g * D + hh],
          st[g * D + g + hh]);
    }
    const float lc = fmaxf(lsum, 1e-37f);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      store(out + hh * D + d + e, n ? o[e] / lc : 0.f);
    // the row's log-sum-exp of its scaled scores, when asked: the max and
    // the sum this combine already formed (a row of length 0 has none)
    if (p.lse != nullptr && d == 0)
      p.lse[(static_cast<int64_t>(b) * p.Hkv + h) * g + hh] =
          n ? mx + logf(lsum) : __int_as_float(0xff800000);  // -inf
  }
}

template <typename T, int D, bool kPaged>
int launch(const Params& p, int B, cudaStream_t st) {
  constexpr int bytes = Smem<T, D>::kBytes;
  static bool configured = false;  // once per instantiation
  cudaError_t err;
  if (!configured) {
    err = cudaFuncSetAttribute(decode_attn_split<T, D, kPaged>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  if (p.nsplit > 0) {
    decode_attn_split<T, D, kPaged>
        <<<dim3(p.Hkv, B, p.nsplit), kThreads, bytes, st>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  decode_attn_combine<T, D><<<dim3(p.Hkv, B), kThreads, 0, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// Workspace floats for B rows of Hkv KV heads over S rows: every split's
// slot.
long long ws_floats_for(int B, int Hkv, int g, int D, int S) {
  return static_cast<long long>(B) * Hkv * ((S + kChunk - 1) / kChunk) *
         slot_floats(g, D);
}

template <bool kPaged>
int dispatch(int dtype, int head_dim, Params& p, int B, long long ws_floats,
             void* stream) {
  if (p.g < 1 || p.g > kMaxG) return static_cast<int>(cudaErrorInvalidValue);
  p.nsplit = (p.S + kChunk - 1) / kChunk;
  if (ws_floats < ws_floats_for(B, p.Hkv, p.g, head_dim, p.S))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    typedef __nv_bfloat16 T;
    if (head_dim == 32) return launch<T, 32, kPaged>(p, B, st);
    if (head_dim == 64) return launch<T, 64, kPaged>(p, B, st);
    if (head_dim == 128) return launch<T, 128, kPaged>(p, B, st);
  } else if (dtype == 1) {
    if (head_dim == 32) return launch<float, 32, kPaged>(p, B, st);
    if (head_dim == 64) return launch<float, 64, kPaged>(p, B, st);
    if (head_dim == 128) return launch<float, 128, kPaged>(p, B, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// f32 workspace floats a launch over B rows of Hkv KV heads, group size g,
// head_dim D and S rows (dense: the cache's S; paged: pps * page) needs:
// B * Hkv * ceil(S / kChunk) * slot_floats(g, D).
extern "C" long long decode_attention_ws_floats(int B, int Hkv, int g, int D,
                                                int S) {
  return ws_floats_for(B, Hkv, g, D, S);
}

// dtype: 0 = bfloat16, 1 = float32. Strides are in elements. ws: an f32
// workspace of at least decode_attention_ws_floats(B, Hkv, g, head_dim, S)
// floats. lse: null, or f32 [B, Hkv * g] for each row's log-sum-exp
// (-inf at length 0).
extern "C" int decode_attention_launch(
    int dtype, int head_dim, const void* q, long long sqb, long long sqh,
    const void* k, const void* v, long long skb, long long sks,
    long long skh, const void* lengths, void* out, void* lse, int B,
    int Hkv, int g, int S, float scale, void* ws, long long ws_floats,
    void* stream) {
  Params p{q, sqb, sqh, k, v, skb, sks, skh,
           static_cast<const int*>(lengths), nullptr, 0, 1, S, Hkv, g, 0,
           scale, static_cast<float*>(ws), out, static_cast<float*>(lse)};
  return dispatch<false>(dtype, head_dim, p, B, ws_floats, stream);
}

extern "C" int paged_decode_attention_launch(
    int dtype, int head_dim, const void* q, long long sqb, long long sqh,
    const void* k_pages, const void* v_pages, long long skp, long long sks,
    long long skh, const void* lengths, const void* tables, int pps,
    int page, void* out, int B, int Hkv, int g, float scale, void* ws,
    long long ws_floats, void* stream) {
  if (pps < 1 || page < 1) return static_cast<int>(cudaErrorInvalidValue);
  Params p{q, sqb, sqh, k_pages, v_pages, skp, sks, skh,
           static_cast<const int*>(lengths),
           static_cast<const int*>(tables), pps, page, pps * page, Hkv, g, 0,
           scale, static_cast<float*>(ws), out, nullptr};
  return dispatch<true>(dtype, head_dim, p, B, ws_floats, stream);
}
