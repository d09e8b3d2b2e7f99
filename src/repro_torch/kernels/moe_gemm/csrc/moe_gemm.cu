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
// reference package (and 5. adds their backward):
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
//    served from a 47 GB int8 tree; namespace i8). Bound by bytes at
//    decode, where it reads half the bf16 variant's (0.28 / 0.14 ms at
//    C 8), by the products at C 640 (1.22 / 0.61 ms). The earlier design
//    (the tensor-core kernel with int8 tiles dequantised into shared
//    memory by the same warps) paid ~1.4 us of cp.async waits and block
//    barriers a 32-row stage at decode, and re-read and dequantised each
//    weight tile for each of four 160-row C-chunks at C 640. This one:
//    * warp-specialised blocks of 384 threads: a producer warpgroup
//      (setmaxnreg 40) whose one thread issues TMA copies
//      (cp.async.bulk.tensor, zero fill past C, D and F) into an mbarrier
//      ring of full and empty barriers, and two consumer warpgroups
//      (setmaxnreg 232); the k loop has no block barrier;
//    * operands swapped, as in the bf16 variant: a weight tile of 64 F
//      columns is wgmma's A (M 64), x's rows are B (N 8 at decode, so C 8
//      wastes no product; up to 160), products bf16 in, f32 accumulate;
//    * dequantisation is as_weight's arithmetic, bf16(float(q) * s), with
//      float(q) exact by a byte permute into the mantissa of 2^23 and one
//      subtraction (the int-to-float unit runs at a quarter of the FP32
//      rate), straight into the registers of wgmma's A fragment: a
//      thread's two rows are adjacent F columns, so it reads 2 bytes of
//      each int8 row from a 64-byte-swizzled tile (conflict-free) and
//      holds 2 scales a tile; a consumer builds stage kt + 1's fragments
//      while stage kt's products run (a bf16 tile in shared memory that
//      wgmma reads by descriptor instead was slower at all four mixtral
//      shapes: tools/moe_i8_ab.py applies it as a patch and times it);
//    * C <= 64: stages of 16 KB of int8 (64 rows of D for the fused
//      kernel's four tiles, 128 for w's two), a ring of 6 (C <= 8), 80 KB
//      in flight an SM; each consumer 64 columns of (gate and up | w), 128
//      columns a block. w_down (F 4096): 32 F-tiles x 8 experts = 256
//      blocks, one block an SM: 1.94 waves on 132 SMs, whose last is 124
//      of 132 full (with 80 KB in flight an SM, 124 SMs still draw the
//      card's byte rate);
//    * C > 64: a ring of 4 stages of 64 rows (48 KB: the x tile's 320 rows
//      and the int8 tiles); each consumer holds two sets of N 160 (320
//      rows, 160 f32 accumulators a thread); the fused kernel's two
//      consumers take gate and up of the same 64 columns (the SwiGLU
//      meets through shared memory in the epilogue), w's two 64 columns
//      each. So each weight tile is read and dequantised twice at C 640,
//      once for each of two 320-row chunks;
//    * invariant: no split-K and no atomics; each output is one f32
//      accumulator updated by one wgmma k16 step after another in
//      increasing k, whatever C or the block shape. wgmma rounds each k16
//      step as mma.sync.m16n8k16 does (the bit probe, wgrad::probe:
//      chip_smoke.py runs it), so the output equals the bf16 variant's on
//      as_weight(w) bit for bit, and a row's bits depend on D alone.
//
// 5. The backward (no Pallas kernel of the reference has one: it takes
//    the gradient by autodiff of _expert_ffn, src/repro/models/moe.py:
//    60-69, which these kernels compute). Three kernels:
//      K1 moe_ffn_fused_bwd: dg, du [E, C, F] from x, w_gate, w_up and
//         dout, the gradient of silu(g) * u;
//      K2 moe_gemm_dx: dx = sum_j dy_j . w_j^T for one pair (w_down) or
//         two ((dg, w_gate), (du, w_up));
//      K3 moe_gemm_dw: dw_j = a^T . dy_j, reduced over C, for one output
//         (w_down: a = act) or two sharing a (w_gate, w_up: a = x).
//    Where they round: where the reference's jax.vjp of _expert_ffn does
//    (its jaxpr in bf16). A cotangent enters each transposed product in
//    f32 against the bf16 operand, the product accumulates in f32 and is
//    cast once to the operand's dtype (dx, each dw); dx of gate/up is two
//    such products, each cast, then added (add_any of two bf16 values: in
//    f32, cast again), so K2 keeps the pairs in two accumulator sets. One
//    cast more than the reference: dg and du, f32 there, are stored in
//    x's dtype, since the tensor cores take bf16 operands (K1 writes them
//    so, K2 and K3 read them). The SwiGLU's backward runs in f32 in the
//    jaxpr's order: s = logistic(g), w = dout * u; dg = w * s + (g * w) *
//    (s * (1 - s)); du = (g * s) * dout.
//    What bounds them: bytes at qwen3-moe's training shapes (E 128, C 160,
//    D 2048, F 768), each a ~130 flops a byte: every one reads or writes
//    one or two 402.7 MB expert weights (0.12 ms each at 3.35 TB/s), so
//    K1 0.294 ms (x, both weights, dout, dg, du), K2 0.155 / 0.284 ms
//    (one / two pairs), K3 0.155 / 0.284 ms (one / two outputs); their
//    products 64.4 GFLOP each, 0.065 ms at 989 TFLOP/s.
//    * K1, K2 and K3 (namespace wgrad) in i8's shape: blocks of 384
//      threads, a producer thread issuing TMA loads (zero fill past every
//      edge) into mbarrier rings, two consumer warpgroups on wgmma
//      (setmaxnreg 40 / 232), no block barrier in the k loop. No operand is
//      transposed in memory: each is loaded in place, 128-byte rows in the
//      128-byte swizzle, and read K-major or MN-major (the transpose bits).
//      K2 and K3: one block a unit (the hardware hands the units to the
//      SMs as they free up; a persistent grid of one block an SM walking
//      units b, b + 132, ... measured as fast or slower:
//      tools/moe_grad_ab.py). Each consumer casts its 64 rows once to
//      bf16 into its own output tile and one thread stores it by TMA
//      (cp.async.bulk.tensor), which runs on while the next tile's loads
//      and products go, so the output (805 MB of two-output dw) streams
//      out under the short k loops; the tile is written again after that
//      store has read it (cp.async.bulk.wait_group.read).
//      K1: M = F from the weight tiles (A MN-major), N = C (x's rows, B
//      K-major, 160 a chunk), K = D. A unit is (64 columns of F, chunk,
//      expert), F-tiles fastest, so each weight tile is read once a
//      launch; its consumer holds gate and up of the 64 columns (two
//      m64n160 sets, 160 f32 a thread), so the SwiGLU's backward needs no
//      exchange. K1's epilogue (swiglu_bwd on 160 f32 a thread, two
//      stores) is long against its k loop, so a block runs two pipelines,
//      each a producer thread, a ring of 2 stages of 64 rows of D (x 20
//      KB, the two weight tiles 16 KB) and a consumer warpgroup, on
//      neighbouring units, one block an SM walking pairs of units; the
//      second pipeline starts half a unit late, so each consumer's
//      epilogue runs under the other's loads (tools/moe_grad_ab.py times
//      each choice undone). A stage's slot goes back as soon as its
//      products are done. The producer loads the unit's dout tile (20 KB)
//      by TMA once the ring's first stages are issued, so it lands under
//      the k loop; the consumer writes dg over it and du into a tile of
//      its own, and one thread stores both by TMA. At the train shape it
//      loads the weights once (805 MB), x 12 times (mostly from L2, 1 GB)
//      and dout once, and stores dg and du (63 MB); 1536 units, 11.6 a
//      block on 132 SMs.
//      K2: M = D from the weight rows (A K-major), N = C (dy's rows, B
//      K-major, 160 a chunk: qwen3-moe's C 160 is one), K = F. A unit is
//      (128 rows of D, chunk, expert), D-tiles fastest, so each weight
//      tile is read once a launch and the blocks that re-read one
//      expert's dy run together; it streams one pair's stages of 64 rows
//      of F (36 KB) through a ring of 5, pair 0's and then pair 1's. Two
//      pairs are two accumulator sets (160 f32 a thread), each rounded to
//      bf16, added in f32 and rounded again; the output written
//      transposed ([c][d]). At the train shapes it loads the weights once
//      (402.7 / 805.3 MB, one / two pairs) and dy 6 / 16 times, mostly
//      from L2 (503 / 1007 MB); 768 / 2048 units, 5.8 / 15.5 a block on
//      132 SMs.
//      K3: M = D (a's columns, A MN-major), N = F (dy_j's columns, B
//      MN-major, 256 a unit: one output of 256 or two of 128, 128 f32 a
//      thread), K = C in chunks of 32 rows. A unit is (columns, expert)
//      and its items its D-tiles of 128 rows: the unit's dy chunks stay
//      in 5 slots (C <= 160) while a's chunks stream through a ring of 5
//      past them. At the train shapes: dy read once (63 / 84 MB, two / one
//      outputs), a 6 / 8 times (503 / 252 MB) where the mma.sync design
//      loaded ~1.5 / ~1.0 GB; 768 / 1024 units, 5.8 / 7.8 a block.
//      Invariant of the three: no split-K and no atomics; each output is
//      one f32 accumulator updated by one wgmma k16 step after another in
//      increasing k (K3: over C in increasing c), cast once. The probe
//      (wgrad::probe) holds every wgmma shape and layout used here to
//      mma.sync.m16n8k16's bits, so the outputs are the first design's
//      (mma.sync, the same k order) bit for bit, K1's g and u are the fused
//      forward's accumulators (its check output y equals moe_ffn_fused's),
//      and a row's (K1, K2) or an expert's (K3) bits do not depend on C or
//      E.
//    * f32, and bf16 shapes off that rule, run K1 on the CUDA-core
//      template and K2 / K3 on a strided CUDA-core kernel (namespace cc:
//      64 x 64 outputs a block, one fmaf per k in increasing k).
//
// C interface (loaded with ctypes): each launcher returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue for arguments it does not take.
// Every variant sits in the anonymous namespace. A function-local static
// of a template with external linkage is one object across every library
// loaded into a process (g++ binds it STB_GNU_UNIQUE, even under
// RTLD_LOCAL). So a second copy of this library would find a launcher's
// once-only flag already set, skip cudaFuncSetAttribute for its own
// kernel, and its launch above 48 KB of shared memory would fail with
// cudaErrorInvalidValue.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

#include "hopper.cuh"

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

// The operands of K1's epilogue on the CUDA cores (moe_ffn_fused_bwd off
// the tensor-core rule: the fused template's tile loop with its epilogue
// replaced, kBwd): dout [E, C, F] in, dg and du [E, C, F] out, contiguous,
// in x's dtype. The forward passes none.
struct Bwd {
  const void* dout = nullptr;
  void* dg = nullptr;
  void* du = nullptr;
};

// The SwiGLU's backward at one (c, f) from g = (x @ w_gate)[c, f],
// u = (x @ w_up)[c, f] and d = dout[c, f], in f32 and in the order of the
// reference's jaxpr (jax.vjp of _expert_ffn): s = logistic(g),
// w = d * u; dg = w * s + (g * w) * (s * (1 - s)); du = (g * s) * d.
__device__ __forceinline__ void swiglu_bwd(float g, float u, float d,
                                           float& dg, float& du) {
  const float s = 1.f / (1.f + expf(-g));
  const float w = d * u;
  dg = w * s + (g * w) * (s * (1.f - s));
  du = (g * s) * d;
}

// A value rounded to T and read back as f32.
__device__ __forceinline__ float round_to(float x, const float*) { return x; }
__device__ __forceinline__ float round_to(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(x));
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
// kBwd (K1): dg and du into bw from the same accumulators; y, when not
// null, also gets the forward's output (a check of the recompute).
template <typename T, int BC, int TM, int TN, bool kFused,
          bool kBwd = false>
__global__ void __launch_bounds__(kThreads)
grouped_kernel(const T* __restrict__ x, int64_t sxe, int64_t sxc,
               const T* __restrict__ wg, const T* __restrict__ wu,
               int64_t swe, int64_t swd, T* __restrict__ y, int C, int D,
               int F, bool vec_ok, Bwd bw) {
  static_assert(!kBwd || kFused, "K1 recomputes gate and up");
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

  // epilogue: y (and dout, dg, du) are contiguous [E, C, F] tensors
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int c = c0 + tr * TM + i;
    if (c >= C) continue;
    const int64_t row = (e * C + c) * F;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int f = f0 + tc * TN + j;
      if (f >= F) continue;
      float v = acc0[i][j];
      if constexpr (kBwd) {
        float dg, du;
        swiglu_bwd(v, acc1[i][j],
                   to_f32(static_cast<const T*>(bw.dout)[row + f]), dg, du);
        store(static_cast<T*>(bw.dg) + row + f, dg);
        store(static_cast<T*>(bw.du) + row + f, du);
        if (y == nullptr) continue;
      }
      if constexpr (kFused) v = v / (1.f + expf(-v)) * acc1[i][j];
      store(y + row + f, v);
    }
  }
}

template <typename T, bool kFused, bool kBwd = false>
int launch(const void* x, int64_t sxe, int64_t sxc, const void* wg,
           const void* wu, int64_t swe, int64_t swd, void* y, int E, int C,
           int D, int F, bool vec_ok, cudaStream_t st, Bwd bw = {}) {
  const T* xx = static_cast<const T*>(x);
  const T* gg = static_cast<const T*>(wg);
  const T* uu = static_cast<const T*>(wu);
  T* yy = static_cast<T*>(y);
  const int nf = (F + kBF - 1) / kBF;
  if (C <= 8) {          // decode: one C-tile, weights read once
    const dim3 grid(1, nf, E);
    grouped_kernel<T, 8, 2, 1, kFused, kBwd><<<grid, kThreads, 0, st>>>(
        xx, sxe, sxc, gg, uu, swe, swd, yy, C, D, F, vec_ok, bw);
  } else {
    const dim3 grid((C + 63) / 64, nf, E);
    grouped_kernel<T, 64, 4, 4, kFused, kBwd><<<grid, kThreads, 0, st>>>(
        xx, sxe, sxc, gg, uu, swe, swd, yy, C, D, F, vec_ok, bw);
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool kFused, bool kBwd = false>
int dispatch(int dtype, const void* x, long long sxe, long long sxc,
             const void* wg, const void* wu, long long swe, long long swd,
             void* y, int E, int C, int D, int F, int vec_ok, void* stream,
             Bwd bw = {}) {
  if (E < 1 || E > 65535 || C < 1 || D < 1 || F < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<__nv_bfloat16, kFused, kBwd>(x, sxe, sxc, wg, wu, swe, swd,
                                               y, E, C, D, F, vec_ok != 0, st,
                                               bw);
  if (dtype == 1)
    return launch<float, kFused, kBwd>(x, sxe, sxc, wg, wu, swe, swd, y, E, C,
                                       D, F, vec_ok != 0, st, bw);
  return static_cast<int>(cudaErrorInvalidValue);
}

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
template <bool kFused, int WM, int WN, int MT, int NT, int BK, int S>
struct Tile {
  static constexpr int kThreads = WM * WN * 32;
  static constexpr int BF = WM * MT * 16;
  static constexpr int BN = WN * NT * 8;
  static constexpr int kW = kFused ? 2 : 1;        // weight tiles per stage
  static constexpr int kXPitch = BK + 8;            // x tile row, elements
  static constexpr int kWPitch = BF + 8;            // weight row, elements
  static constexpr int kXStage = BN * kXPitch;      // elements
  static constexpr int kWStage = BK * kWPitch;      // elements
  static constexpr size_t kStageBytes =
      sizeof(bf16) * (kXStage + kW * kWStage);
  static constexpr size_t kSmemBytes = S * kStageBytes;
  static constexpr int kYPitch = BF + 8;            // staged output row
  static_assert(NT % 2 == 0, "x fragments load two n8 tiles at a time");
  static_assert(BK % 16 == 0 && S >= 2, "whole k16 steps; a stage ahead");
  static_assert(sizeof(bf16) * BN * kYPitch <= kSmemBytes,
                "the output tile fits the shared memory");
  static_assert(kSmemBytes <= 232448, "a block's shared memory");
  static_assert(kStageBytes % 16 == 0, "16-byte aligned stages");
};

// Grid: (F-tile + nF * C-chunk, expert). Chunk ch holds rows
// [ch * Cc, min(C, (ch + 1) * Cc)) of its expert, Cc <= BN.
template <bool kFused, int WM, int WN, int MT, int NT, int BK, int S,
          int kMinBlocks>
__global__ void __launch_bounds__(WM * WN * 32, kMinBlocks)
tc_kernel(const bf16* __restrict__ x, int64_t sxe, int64_t sxc,
          const bf16* __restrict__ wg, const bf16* __restrict__ wu,
          int64_t swe, int64_t swd, bf16* __restrict__ y, int C, int D,
          int F, int nF, int Cc) {
  using L = Tile<kFused, WM, WN, MT, NT, BK, S>;
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
  const bf16* wge = wg + e * swe;
  const bf16* wue = wu + e * swe;
  const int nk = (D + BK - 1) / BK;

  // shared memory is addressed as 32-bit byte offsets from one base
  constexpr uint32_t kEl = sizeof(bf16);
  const uint32_t sbase = smem_addr(smem);
  const auto stage_addr = [&](int kt) {
    return sbase + static_cast<uint32_t>((kt % S) * L::kStageBytes);
  };

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
#pragma unroll
    for (int i = tid; i < BK * BF / 8; i += L::kThreads) {
      const int r = i / (BF / 8), c = (i % (BF / 8)) * 8;
      const bool ok = k0 + r < D && f0 + c < F;
      const int64_t off = ok ? (k0 + r) * swd + f0 + c : 0;
      const uint32_t dst = st + (L::kXStage + r * L::kWPitch + c) * kEl;
      cp_async16(dst, wge + off, ok);
      if constexpr (kFused) cp_async16(dst + L::kWStage * kEl, wue + off, ok);
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
  for (int kt = 0; kt < nk; ++kt) {
    cp_wait<S - 2>();                // stage kt has landed (this thread's)
    __syncthreads();                 // ... everyone's; slot kt-1 is free
    if (kt + S - 1 < nk) load_stage(kt + S - 1);
    cp_commit();
    const uint32_t st = stage_addr(kt);
    const uint32_t wt = st + L::kXStage * kEl;
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
          int kMinBlocks>
int launch_tc(const bf16* x, int64_t sxe, int64_t sxc, const bf16* wg,
              const bf16* wu, int64_t swe, int64_t swd, bf16* y, int E, int C,
              int D, int F, cudaStream_t st) {
  using L = Tile<kFused, WM, WN, MT, NT, BK, S>;
  auto kern = tc_kernel<kFused, WM, WN, MT, NT, BK, S, kMinBlocks>;
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
  kern<<<grid, L::kThreads, L::kSmemBytes, st>>>(x, sxe, sxc, wg, wu, swe,
                                                 swd, y, C, D, F, nF, Cc);
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

}  // namespace tc

// ---------------------------------------------------------------------------
// int8-weight variant (bf16 x, int8 weights with per-column f32 scales)
// ---------------------------------------------------------------------------

namespace i8 {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 384;      // a producer warpgroup, two consumer ones
constexpr int kCols = 64;          // F columns of one weight tile (wgmma M)
constexpr int kProducerRegs = 40;  // setmaxnreg: 128 x 40 + 256 x 232 =
constexpr int kConsumerRegs = 232; // 64512 of the SM's 65536

// The kept design; tools/moe_i8_ab.py times each choice undone. C <= 64
// takes the decode shape, C > 64 the prefill one (below).
constexpr int kDecodeStages = 6;      // ring depth at C <= 8
constexpr int kPrefillStages = 4;     // ring depth at C > 64 (192 KB)
constexpr int kFusedDecodeRows = 64;  // D rows a stage: 16 KB of int8
constexpr int kDownDecodeRows = 128;  // (both kernels)

// byte j of w (an int8) as an exact float: the byte with its sign bit
// flipped (q + 128) placed in the mantissa of 2^23, minus 2^23 + 128
template <int J>
__device__ __forceinline__ float q_at(uint32_t w) {
  const uint32_t u = __byte_perm(w ^ 0x80808080u, 0x4B000000u, 0x7540 | J);
  return __uint_as_float(u) - 8388736.f;
}

// --- wgmma -----------------------------------------------------------------

// B: rows r0 .. r0 + N - 1 of an x tile [BK / 64][R][64] (128-byte rows),
// the 16 columns of k16 step ks
template <int R>
__device__ __forceinline__ uint64_t desc_x(uint32_t tile, int r0, int ks) {
  return desc(tile + (ks >> 2) * R * 128 + r0 * 128 + (ks & 3) * 32, 16,
              1024);
}
// A, MN-major: rows 16 ks .. 16 ks + 15 of a bf16 tile [BK][64] (128-byte
// rows: one 64-column block, 8-row groups 1024 bytes apart)
__device__ __forceinline__ uint64_t desc_a(uint32_t tile, int ks) {
  return desc(tile + ks * 2048, 8192, 1024);
}

// d (m64n8, f32) += A . B: A (64 x 16) MN-major and B (16 x 8) K-major,
// bf16 in shared memory, 128-byte swizzle
__device__ __forceinline__ void wgmma_ss(float (&d)[4], uint64_t a,
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, "
      "%4, %5, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(a), "l"(b), "r"(1));
}

// d (m64n64, f32) += A . B: A (64 x 16) MN-major and B (16 x 64) K-major,
// bf16 in shared memory, 128-byte swizzle
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a,
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

// d (m64n8, f32) += A . B: A (64 x 16) bf16 fragments in registers, B
// (16 x 8) K-major bf16 in shared memory, 128-byte swizzle
__device__ __forceinline__ void wgmma_rs(float (&d)[4],
                                         const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (m64n64, f32) += A . B: A (64 x 16) bf16 fragments in registers, B
// (16 x 64) K-major bf16 in shared memory, 128-byte swizzle
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (m64n160, f32) += A . B: A (64 x 16) bf16 fragments in registers, B
// (16 x 160) K-major bf16 in shared memory, 128-byte swizzle
__device__ __forceinline__ void wgmma_rs(float (&d)[80],
                                         const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %85, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71,"
      " %72, %73, %74, %75, %76, %77, %78, %79}, "
      "{%80, %81, %82, %83}, %84, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// --- the kernel --------------------------------------------------------------

// Shared memory of one block (bytes from a 1024-aligned base): the ring of
// S stages, each an x tile [BK / 64][R][64] bf16 (128-byte rows, 128-byte
// swizzle) and the int8 weight tiles [BK][64] (64-byte rows, 64-byte
// swizzle); the mbarriers (full[], empty[]).
// After the k loop the ring holds the output tile [R][BF] (and, for the
// split fused kernel, the up product [R][64] in f32 before it).
template <bool kFused, int kWpw, int N, int NS, int BK, int S>
struct Smem {
  static constexpr int kTiles = 2 * kWpw;                 // int8 tiles a stage
  static constexpr int BF = kCols * (kFused ? kWpw : 2);  // F columns
  static constexpr int R = N * NS;                        // x rows a stage
  static constexpr bool kSplit = kFused && kWpw == 1;     // gate | up
  static constexpr uint32_t kXBytes = (BK / 64) * R * 128;
  static constexpr uint32_t kQBytes = BK * kCols;
  static constexpr uint32_t kStage = kXBytes + kTiles * kQBytes;
  static constexpr uint32_t kBuf = S * kStage;
  static constexpr uint32_t kBar = kBuf;
  static constexpr uint32_t kBytes = kBar + 8 * 2 * S;
  static constexpr size_t kAlloc = kBytes + 1024;         // room to align
  static constexpr int kYPitch = BF + 8;                  // bf16 elements
  static constexpr int kUPitch = kCols + 4;               // f32 elements
  static constexpr uint32_t kY = kSplit ? R * kUPitch * 4 : 0;
  static_assert(BK % 64 == 0 && N % 8 == 0 && N <= 256, "tile shape");
  static_assert(kStage % 1024 == 0, "swizzled tiles 1024-byte aligned");
  static_assert(kY + R * kYPitch * 2 <= kBuf, "the output tile fits");
  static_assert(kAlloc <= 232448, "a block's shared memory");
};

// Grid: (F-tile + nF * C-chunk, expert), chunk ch holding rows
// [ch * Cc, min(C, (ch + 1) * Cc)) of its expert, Cc <= R. Weight tile b
// of a stage (b < 2 kWpw) is matrix b & 1 (gate, up) of the fused kernel
// at the block's F columns 64 (b >> 1), or columns 64 b of w; consumer
// warpgroup cw takes tiles cw kWpw .. cw kWpw + kWpw - 1, each for all
// its NS sets of N rows.
template <bool kFused, int kWpw, int N, int NS, int BK, int S>
__global__ void __launch_bounds__(kThreads, 1)
kernel(const __grid_constant__ CUtensorMap tm_x,
       const __grid_constant__ CUtensorMap tm_g,
       const __grid_constant__ CUtensorMap tm_u,
       const float* __restrict__ sg, const float* __restrict__ su,
       int64_t sse, bf16* __restrict__ y, int C, int D, int F, int nF,
       int Cc) {
  using L = Smem<kFused, kWpw, N, NS, BK, S>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const auto full = [&](int s) { return base + L::kBar + 8 * s; };
  const auto empty = [&](int s) { return base + L::kBar + 8 * (S + s); };
  const auto matrix = [](int b) { return kFused ? b & 1 : 0; };
  const auto column = [](int b) { return kCols * (kFused ? b >> 1 : b); };

  const int tid = threadIdx.x;
  const int f0 = (blockIdx.x % nF) * L::BF;
  const int c0 = (blockIdx.x / nF) * Cc;
  const int e = blockIdx.y;
  const int rows = min(Cc, C - c0);
  const int nk = (D + BK - 1) / BK;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full(s), 1);                 // the producer's expect_tx
      mbar_init(empty(s), 256);              // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid < 128) {
    // ---- producer: one thread issues every copy ---------------------------
    regs_dec<kProducerRegs>();
    if (tid == 0) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % S;
        mbar_wait(empty(s), ((kt / S) & 1) ^ 1);
        const uint32_t st = base + s * L::kStage;
        mbar_arrive_tx(full(s), L::kStage);
#pragma unroll
        for (int c = 0; c < BK / 64; ++c)
#pragma unroll
          for (int j = 0; j < NS; ++j)
            tma_3d(st + (c * L::R + j * N) * 128, &tm_x, kt * BK + 64 * c,
                   c0 + j * N, e, full(s));
#pragma unroll
        for (int b = 0; b < L::kTiles; ++b)
          tma_3d(st + L::kXBytes + b * L::kQBytes, matrix(b) ? &tm_u : &tm_g,
                 f0 + column(b), kt * BK, e, full(s));
      }
    }
    return;
  }

  // ---- consumers: 64 F columns of kWpw weight tiles, N x NS rows ---------
  regs_inc<kConsumerRegs>();
  const int cw = tid / 128 - 1, t = tid & 127;
  const int wi = t >> 5, g = (t & 31) >> 2, tg = t & 3;
  // the F column (in the tile) of accumulator row m = 16 wi + g + 8 h:
  // the thread's two rows are adjacent columns fa + h, so it reads 2 bytes
  // of int8 a k row (below) and holds those two columns' scales (0 past F)
  const int fa = 16 * wi + 2 * g;
  float sc[kWpw][2];
#pragma unroll
  for (int w = 0; w < kWpw; ++w) {
    const int b = cw * kWpw + w;
    const float* s = matrix(b) ? su : sg;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int f = f0 + column(b) + fa + i;
      sc[w][i] = f < F ? s[static_cast<int64_t>(e) * sse + f] : 0.f;
    }
  }

  float acc[kWpw][NS][N / 2];
#pragma unroll
  for (int w = 0; w < kWpw; ++w)
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int i = 0; i < N / 2; ++i) acc[w][j][i] = 0.f;

  // A fragments of each k16 step: rows k0, k0 + 1 (a[0], a[1]) and
  // k0 + 8, k0 + 9 (a[2], a[3]), k0 = 16 ks + 2 tg, of columns fa (row
  // m) and fa + 1 (row m + 8); in the 64-byte swizzle every such row's
  // 16-byte piece wi sits at wi ^ tg
  typedef uint32_t Frags[BK / 16][kWpw][4];
  const auto frags = [&](int kt, Frags& a) {
    const int s = kt % S;
    mbar_wait(full(s), (kt / S) & 1);
    const unsigned char* qt =
        smem + s * L::kStage + L::kXBytes + cw * kWpw * L::kQBytes;
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks)
#pragma unroll
      for (int w = 0; w < kWpw; ++w) {
        const unsigned char* q = qt + w * L::kQBytes +
                                 (16 * ks + 2 * tg) * 64 + ((wi ^ tg) << 4) +
                                 2 * g;
        const auto u16 = [&](int k) {
          return static_cast<uint32_t>(
              *reinterpret_cast<const uint16_t*>(q + k * 64));
        };
        const uint32_t w01 = u16(0) | u16(1) << 16;
        const uint32_t w89 = u16(8) | u16(9) << 16;
        const float s0 = sc[w][0], s1 = sc[w][1];
        a[ks][w][0] = pack_bf16(q_at<0>(w01) * s0, q_at<2>(w01) * s0);
        a[ks][w][1] = pack_bf16(q_at<1>(w01) * s1, q_at<3>(w01) * s1);
        a[ks][w][2] = pack_bf16(q_at<0>(w89) * s0, q_at<2>(w89) * s0);
        a[ks][w][3] = pack_bf16(q_at<1>(w89) * s1, q_at<3>(w89) * s1);
        keep(a[ks][w]);
      }
  };
  // stage kt's products from fragments a; stage kt + 1's fragments are
  // built into `next` while they run, then the slot goes back
  const auto step = [&](int kt, Frags& a, Frags& next) {
    const uint32_t xt = base + (kt % S) * L::kStage;
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks)
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        if (j * N >= rows) continue;
#pragma unroll
        for (int w = 0; w < kWpw; ++w)
          wgmma_rs(acc[w][j], a[ks][w], desc_x<L::R>(xt, j * N, ks));
      }
    wg_commit();
    if (kt + 1 < nk) frags(kt + 1, next);
    wg_wait<0>();
    mbar_arrive(empty(kt % S));
  };
  Frags a0, a1;
  frags(0, a0);
  for (int kt = 0; kt < nk; kt += 2) {
    step(kt, a0, a1);
    if (kt + 1 < nk) step(kt + 1, a1, a0);
  }
  wg_wait<0>();
#pragma unroll
  for (int w = 0; w < kWpw; ++w)
#pragma unroll
    for (int j = 0; j < NS; ++j) keep(acc[w][j]);

  // epilogue: accumulator (column, row c) -> ys[c][column] in bf16 (the
  // split fused kernel: up through us in f32 first), then 16-byte rows
  bar_sync(3, 256);                        // both consumers are off the ring
  bf16* ys = reinterpret_cast<bf16*>(smem + L::kY);
  float* us = reinterpret_cast<float*>(smem);
  // visit(fn): fn(set j, accumulator i, column in the tile, row c) for
  // every live accumulator of this thread
  const auto visit = [&](auto fn) {
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int i = 0; i < N / 2; ++i) {
        const int c = j * N + 8 * (i >> 2) + 2 * tg + (i & 1);
        if (c < rows) fn(j, i, fa + ((i >> 1) & 1), c);
      }
  };
  if constexpr (L::kSplit) {
    if (cw == 1)
      visit([&](int j, int i, int f, int c) {
        us[c * L::kUPitch + f] = acc[0][j][i];
      });
    bar_sync(3, 256);
    if (cw == 0)
      visit([&](int j, int i, int f, int c) {
        const float v = acc[0][j][i];
        ys[c * L::kYPitch + f] =
            __float2bfloat16(v / (1.f + expf(-v)) * us[c * L::kUPitch + f]);
      });
  } else {
    visit([&](int j, int i, int f, int c) {
      float v = acc[0][j][i];
      if constexpr (kFused) v = v / (1.f + expf(-v)) * acc[kWpw - 1][j][i];
      ys[c * L::kYPitch + kCols * cw + f] = __float2bfloat16(v);
    });
  }
  bar_sync(3, 256);
  bf16* ye = y + (static_cast<int64_t>(e) * C + c0) * F;
  for (int i = tid - 128; i < rows * (L::BF / 8); i += 256) {
    const int r = i / (L::BF / 8), c = (i % (L::BF / 8)) * 8;
    if (f0 + c < F)
      *reinterpret_cast<uint4*>(ye + static_cast<int64_t>(r) * F + f0 + c) =
          *reinterpret_cast<const uint4*>(ys + r * L::kYPitch + c);
  }
}

// the map of a [n2][n1][n0] tensor with unit stride along n0 and byte
// strides s1, s2: boxes of b0 x b1 x 1, zeros past the edges
bool make_map(CUtensorMap* map, EncodeTiled encode, CUtensorMapDataType type,
              const void* ptr, int64_t n0, int64_t n1, int64_t n2,
              int64_t s1, int64_t s2, int b0, int b1,
              CUtensorMapSwizzle swizzle) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(n0),
                              static_cast<cuuint64_t>(n1),
                              static_cast<cuuint64_t>(n2)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(s1),
                                 static_cast<cuuint64_t>(s2)};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(b0),
                             static_cast<cuuint32_t>(b1), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, type, 3, const_cast<void*>(ptr), dims, strides, box,
                unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

struct Args {
  const void *x, *qg, *qu, *sg, *su;
  long long sxe, sxc, swe, swd, sse;
  void* y;
  int E, C, D, F;
  cudaStream_t st;
};

template <bool kFused, int kWpw, int N, int NS, int BK, int S>
int launch(const Args& a) {
  using L = Smem<kFused, kWpw, N, NS, BK, S>;
  auto kern = kernel<kFused, kWpw, N, NS, BK, S>;
  static bool configured = false;    // once per instantiation
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(L::kAlloc));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap mx, mg, mu;
  if (!make_map(&mx, encode, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, a.x, a.D, a.C,
                a.E, 2 * a.sxc, 2 * a.sxe, 64, N,
                CU_TENSOR_MAP_SWIZZLE_128B) ||
      !make_map(&mg, encode, CU_TENSOR_MAP_DATA_TYPE_UINT8, a.qg, a.F, a.D,
                a.E, a.swd, a.swe, kCols, BK, CU_TENSOR_MAP_SWIZZLE_64B) ||
      !make_map(&mu, encode, CU_TENSOR_MAP_DATA_TYPE_UINT8, a.qu, a.F, a.D,
                a.E, a.swd, a.swe, kCols, BK, CU_TENSOR_MAP_SWIZZLE_64B))
    return static_cast<int>(cudaErrorInvalidValue);
  const int nF = (a.F + L::BF - 1) / L::BF;
  const int chunks = (a.C + L::R - 1) / L::R;
  const int Cc = ((a.C + chunks - 1) / chunks + 7) / 8 * 8;   // <= R
  kern<<<dim3(nF * chunks, a.E), kThreads, L::kAlloc, a.st>>>(
      mx, mg, mu, static_cast<const float*>(a.sg),
      static_cast<const float*>(a.su), a.sse, static_cast<bf16*>(a.y), a.C,
      a.D, a.F, nF, Cc);
  return static_cast<int>(cudaGetLastError());
}

// C <= 8 (decode): N 8; 8 < C <= 64: N 64 (a shorter ring: a bigger x
// tile); two consumers of 64 columns, the fused kernel's each gate and up
// (128 columns a block). C > 64: two sets of N 160 a consumer, 320 rows a
// block; the fused kernel's consumers gate and up of the same 64 columns,
// w's two of 64.
template <bool kFused>
int dispatch(const Args& a) {
  const auto aligned = [](const void* p, uintptr_t n) {
    return reinterpret_cast<uintptr_t>(p) % n == 0;
  };
  if (a.E < 1 || a.E > 65535 || a.C < 1 || a.D < 8 || a.F < 16 ||
      a.D % 8 || a.F % 16 || a.sxe % 8 || a.sxc % 8 || a.swe % 16 ||
      a.swd % 16 || a.sse < a.F || !aligned(a.x, 16) || !aligned(a.qg, 16) ||
      !aligned(a.qu, 16) || !aligned(a.sg, 4) || !aligned(a.su, 4) ||
      !aligned(a.y, 16))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int kW = kFused ? 2 : 1;
  constexpr int kRows = kFused ? kFusedDecodeRows : kDownDecodeRows;
  if (a.C <= 8) return launch<kFused, kW, 8, 1, kRows, kDecodeStages>(a);
  if (a.C <= 64) return launch<kFused, kW, 64, 1, kRows, 4>(a);
  return launch<kFused, 1, 160, 2, 64, kPrefillStages>(a);
}

}  // namespace i8

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

// ---------------------------------------------------------------------------
// the backward's products, K2 (moe_gemm_dx) and K3 (moe_gemm_dw), on the
// tensor cores (bf16): wgmma fed by TMA, outputs stored by TMA
// ---------------------------------------------------------------------------

namespace wgrad {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 384;      // a producer warpgroup, two consumer ones
constexpr int kProducerRegs = 40;  // setmaxnreg: 128 x 40 + 256 x 232 =
constexpr int kConsumerRegs = 232; // 64512 of the SM's 65536
constexpr int kBM = 128;           // M rows of an item: 64 a consumer

// The kept design; tools/moe_grad_ab.py times each choice undone.
constexpr int kDwDepth = 32;        // K3: rows of C a chunk
constexpr int kDwRing = 5;          // K3: chunks of a in the ring
constexpr int kDwSlots = 5;         // K3: chunks of dy held (C <= 160 stays)
constexpr int kDxDepth = 64;        // K2: rows of F a stage
constexpr int kDxRing = 5;          // K2: stages in the ring
constexpr int kGuDepth = 64;        // K1: rows of D a stage
constexpr int kGuRing = 2;          // K1: stages in each pipeline's ring

// d (m64n160, f32) += A . B: A (64 x 16) and B (16 x 160) K-major bf16 in
// shared memory, 128-byte swizzle (K2)
__device__ __forceinline__ void wgmma_kk(float (&d)[80], uint64_t a,
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %82, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71,"
      " %72, %73, %74, %75, %76, %77, %78, %79}, "
      "%80, %81, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
      : "l"(a), "l"(b), "r"(1));
}

// d (m64n160, f32) += A . B: A (64 x 16) MN-major (the transpose bit) and
// B (16 x 160) K-major, bf16 in shared memory, 128-byte swizzle (K1)
__device__ __forceinline__ void wgmma_tk(float (&d)[80], uint64_t a,
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %82, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71,"
      " %72, %73, %74, %75, %76, %77, %78, %79}, "
      "%80, %81, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
      : "l"(a), "l"(b), "r"(1));
}

// d (m64n128, f32) += A . B: A (64 x 16) and B (16 x 128) MN-major bf16
// in shared memory (both transpose bits), 128-byte swizzle (K3, two outputs)
__device__ __forceinline__ void wgmma_tt(float (&d)[64], uint64_t a,
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

// d (m64n256, f32) += A . B: A (64 x 16) and B (16 x 256) MN-major bf16
// in shared memory (both transpose bits), 128-byte swizzle (K3, one output)
__device__ __forceinline__ void wgmma_tt(float (&d)[128], uint64_t a,
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71,"
      " %72, %73, %74, %75, %76, %77, %78, %79,"
      " %80, %81, %82, %83, %84, %85, %86, %87,"
      " %88, %89, %90, %91, %92, %93, %94, %95,"
      " %96, %97, %98, %99, %100, %101, %102, %103,"
      " %104, %105, %106, %107, %108, %109, %110, %111,"
      " %112, %113, %114, %115, %116, %117, %118, %119,"
      " %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "r"(1));
}

// byte offset of element (row r, column c) of a tile of 128-byte rows (64
// bf16) in the 128-byte swizzle, from a 1024-aligned base
__device__ __forceinline__ uint32_t sw128(int r, int c) {
  return r * 128 + ((((c >> 3) ^ r) & 7) << 4) + (c & 7) * 2;
}

// The tensor-core rule of K2 and K3: D and F multiples of 8, every stride
// a multiple of 8 elements (TMA's 16-byte strides), every base 16-byte
// aligned.
bool takes(int E, int C, int D, int F,
           std::initializer_list<long long> strides,
           std::initializer_list<const void*> ptrs) {
  if (E < 1 || E > 65535 || C < 1 || D < 8 || F < 8 || D % 8 || F % 8)
    return false;
  for (long long s : strides)
    if (s % 8) return false;
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  return true;
}

// the bf16 map of a [E][n1][n0] tensor (element strides s1, s2, unit along
// n0): boxes of b0 x b1 x 1, 128-byte swizzle, zeros past the edges
bool map_bf16(CUtensorMap* map, EncodeTiled encode, const void* p,
              int64_t n0, int64_t n1, int E, int64_t s1, int64_t s2, int b0,
              int b1) {
  return i8::make_map(map, encode, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, p, n0,
                      n1, E, 2 * s1, 2 * s2, b0, b1,
                      CU_TENSOR_MAP_SWIZZLE_128B);
}

// --- K3 --------------------------------------------------------------------

// dw_j [E, M, N] = a [E, K, M]^T . dy_j [E, K, N] (M = D, N = F, K = C) for
// NO outputs that share a. A unit is (BN columns of every output, expert);
// its items are its M-tiles of 128 rows, in order.
// Shared memory (from a 1024-aligned base): the A ring of SA chunks
// [2][BK][64] (BK rows of K by the item's 128 columns of M: A MN-major);
// the B slots, SB chunks [NT / 64][BK][64] (BK rows of K by the unit's BN
// columns of each output: B MN-major); the two consumers' output tiles
// [NT / 64][64][64] (64 rows of M by the unit's columns); the mbarriers.
// Every tile has 128-byte rows in the 128-byte swizzle, as TMA writes and
// reads them.
template <int NO, int BN, int BK, int SA, int SB>
struct DwSmem {
  static constexpr int NT = NO * BN;                     // B columns
  static constexpr uint32_t kA = 2 * BK * 128;           // an A chunk
  static constexpr uint32_t kB = (NT / 64) * BK * 128;   // a B chunk
  static constexpr uint32_t kOut = (NT / 64) * 8192;     // a consumer's
  static constexpr uint32_t kBOff = SA * kA;
  static constexpr uint32_t kOutOff = kBOff + SB * kB;
  static constexpr uint32_t kBar = kOutOff + 2 * kOut;
  static constexpr size_t kAlloc = kBar + 16 * (SA + SB) + 1024;
  static_assert(BK % 16 == 0 && BN % 64 == 0 && NT <= 256, "tile shape");
  static_assert(kAlloc <= 232448, "a block's shared memory");
};

// Block b walks units b, b + gridDim.x, ... (one, as launched; unit u:
// columns (u % nN) BN, expert u / nN). The producer thread loads each
// item's A chunks into the ring and, for the unit's first item, its B
// chunks into the slots, which then stay for every item of the unit
// (while the K chunks fit the SB slots; past that B streams through them
// like A, item by item). Consumer
// cw computes rows 64 cw .. 64 cw + 63 of the item by every column: one
// m64nBNk16 wgmma an output a k16 step, in increasing k. A chunk's slots go
// back once the next chunk's products are issued and its own have
// completed; the unit's B slots after its last item's. The epilogue casts
// the accumulators once to bf16 into the consumer's output tile and one
// thread stores it by TMA, which runs on while the next item's products
// go; the tile is written again only after that store has read it.
template <int NO, int BN, int BK, int SA, int SB>
__global__ void __launch_bounds__(kThreads, 1)
dw_kernel(const __grid_constant__ CUtensorMap tm_a,
          const __grid_constant__ CUtensorMap tm_b0,
          const __grid_constant__ CUtensorMap tm_b1,
          const __grid_constant__ CUtensorMap tm_o0,
          const __grid_constant__ CUtensorMap tm_o1, int K, int M, int N,
          int nM, int nN, int units) {
  using L = DwSmem<NO, BN, BK, SA, SB>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t bars = base + L::kBar;
  const auto full_a = [&](int s) { return bars + 8 * s; };
  const auto empty_a = [&](int s) { return bars + 8 * (SA + s); };
  const auto full_b = [&](int s) { return bars + 8 * (2 * SA + s); };
  const auto empty_b = [&](int s) { return bars + 8 * (2 * SA + SB + s); };

  const int tid = threadIdx.x;
  const int nk = (K + BK - 1) / BK;
  const bool resident = nk <= SB;
  if (tid == 0) {
    for (int s = 0; s < SA; ++s) {
      mbar_init(full_a(s), 1);               // the producer's expect_tx
      mbar_init(empty_a(s), 256);            // every consumer thread
    }
    for (int s = 0; s < SB; ++s) {
      mbar_init(full_b(s), 1);
      mbar_init(empty_b(s), 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid < 128) {
    // ---- producer: one thread issues every copy ---------------------------
    regs_dec<kProducerRegs>();
    if (tid == 0) {
      int ia = 0, ib = 0;                    // A and B chunks issued
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        const int n0 = (u % nN) * BN, e = u / nN;
        for (int i = 0; i < nM; ++i)
          for (int kt = 0; kt < nk; ++kt, ++ia) {
            const int sa = ia % SA;
            mbar_wait(empty_a(sa), ((ia / SA) & 1) ^ 1);
            const uint32_t at = base + sa * L::kA;
            mbar_arrive_tx(full_a(sa), L::kA);
            tma_3d(at, &tm_a, i * kBM, kt * BK, e, full_a(sa));
            tma_3d(at + BK * 128, &tm_a, i * kBM + 64, kt * BK, e,
                   full_a(sa));
            if (resident && i > 0) continue;
            const int sb = ib % SB;
            mbar_wait(empty_b(sb), ((ib / SB) & 1) ^ 1);
            const uint32_t bt = base + L::kBOff + sb * L::kB;
            mbar_arrive_tx(full_b(sb), L::kB);
#pragma unroll
            for (int c = 0; c < L::NT / 64; ++c)
              tma_3d(bt + c * BK * 128, c < BN / 64 ? &tm_b0 : &tm_b1,
                     n0 + 64 * (c % (BN / 64)), kt * BK, e, full_b(sb));
            ++ib;
          }
      }
    }
    return;
  }

  // ---- consumers -----------------------------------------------------------
  regs_inc<kConsumerRegs>();
  const int cw = tid / 128 - 1, t = tid & 127;
  const int wi = t >> 5, g = (t & 31) >> 2, tg = t & 3;
  const uint32_t ot = base + L::kOutOff + cw * L::kOut;
  unsigned char* os = smem + L::kOutOff + cw * L::kOut;
  const auto release = [&](int sa, int sb) {
    mbar_arrive(empty_a(sa));
    if (sb >= 0) mbar_arrive(empty_b(sb));
  };
  float acc[NO][BN / 2];
  int ia = 0, ib = 0;                        // A and B chunks consumed
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const int n0 = (u % nN) * BN, e = u / nN;
    for (int i = 0; i < nM; ++i) {
#pragma unroll
      for (int j = 0; j < NO; ++j)
#pragma unroll
        for (int q = 0; q < BN / 2; ++q) acc[j][q] = 0.f;
      int last_a = -1, last_b = -1;          // the previous chunk's slots
      for (int kt = 0; kt < nk; ++kt, ++ia) {
        const int jb = ib + (resident ? kt : i * nk + kt);
        const int sa = ia % SA, sb = jb % SB;
        mbar_wait(full_a(sa), (ia / SA) & 1);
        mbar_wait(full_b(sb), (jb / SB) & 1);
        const uint32_t at = base + sa * L::kA + cw * BK * 128;
        const uint32_t bt = base + L::kBOff + sb * L::kB;
        wg_fence();
#pragma unroll
        for (int ks = 0; ks < BK / 16; ++ks)
#pragma unroll
          for (int j = 0; j < NO; ++j)
            wgmma_tt(acc[j], desc(at + ks * 2048, BK * 128, 1024),
                     desc(bt + j * (BN / 64) * BK * 128 + ks * 2048,
                          BK * 128, 1024));
        wg_commit();
        if (last_a >= 0) {
          wg_wait<1>();
          release(last_a, last_b);
        }
        last_a = sa;
        last_b = !resident || i == nM - 1 ? sb : -1;
      }
      wg_wait<0>();
#pragma unroll
      for (int j = 0; j < NO; ++j) keep(acc[j]);
      release(last_a, last_b);

      // epilogue: accumulator (row 16 wi + g + 8 h, column c) -> bf16 at
      // (r, c) of the output tile, then one TMA store a 64-column box
      const int m0 = i * kBM + 64 * cw;
      if (t == 0) bulk_wait_read<0>();       // the last store has read it
      bar_sync(1 + cw, 128);
#pragma unroll
      for (int j = 0; j < NO; ++j)
#pragma unroll
        for (int q = 0; q < BN / 2; q += 2) {
          const int r = 16 * wi + g + 8 * ((q >> 1) & 1);
          const int c = j * BN + 8 * (q >> 2) + 2 * tg;
          *reinterpret_cast<uint32_t*>(os + (c >> 6) * 8192 + sw128(r, c)) =
              pack_bf16(acc[j][q], acc[j][q + 1]);
        }
      fence_async();
      bar_sync(1 + cw, 128);
      if (t == 0 && m0 < M) {
#pragma unroll
        for (int c = 0; c < L::NT / 64; ++c) {
          const int n = n0 + 64 * (c % (BN / 64));
          if (n < N)
            tma_store_3d(c < BN / 64 ? &tm_o0 : &tm_o1, ot + c * 8192, n, m0,
                         e);
        }
        bulk_commit();
      }
    }
    ib += resident ? nk : nM * nk;
  }
  if (t == 0) bulk_wait<0>();
}

// --- K2 --------------------------------------------------------------------

// dx [E, N, M] = sum_j dy_j [E, N, K] . w_j [E, M, K]^T (M = D, N = C,
// K = F) for NP pairs, the output written transposed. A unit is (128 rows
// of M, a chunk of Cc <= NR rows of N, expert), M-tiles fastest.
// Shared memory: the ring of S stages, each one pair's weight tile
// [BK / 64][128][64] (rows of M, 64 columns of K a block: A K-major) and
// dy tile [BK / 64][NR][64] (B K-major); the two consumers' output tiles
// [NR][64] (rows of N by the consumer's 64 columns of M); the mbarriers.
template <int NR, int BK, int S>
struct DxSmem {
  static constexpr uint32_t kW = (BK / 64) * kBM * 128;  // a weight tile
  static constexpr uint32_t kY = (BK / 64) * NR * 128;   // a dy tile
  static constexpr uint32_t kStage = kW + kY;
  static constexpr uint32_t kOut = NR * 128;             // a consumer's
  static constexpr uint32_t kOutOff = S * kStage;
  static constexpr uint32_t kBar = kOutOff + 2 * kOut;
  static constexpr size_t kAlloc = kBar + 16 * S + 1024;
  static_assert(BK % 64 == 0 && NR % 8 == 0 && NR <= 256, "tile shape");
  static_assert(kAlloc <= 232448, "a block's shared memory");
};

// Block b walks units b, b + gridDim.x, ... (one, as launched; unit u:
// rows (u % nM) 128 of M, chunk (u / nM) % chunks of N, expert
// u / (nM chunks)). The producer
// thread streams each unit's stages through the ring, pair 0's BK rows of
// K at a time and then pair 1's, on into the next unit's while the
// consumers finish. Consumer cw computes rows 64 cw .. 64 cw + 63 of M by
// NR of N: one m64nNRk16 wgmma a k16 step, in increasing k, each pair in
// its own accumulators. The
// epilogue rounds each pair's sum to bf16, adds them in f32 and rounds
// again, writes the tile transposed ([n][m]) and one thread stores it by
// TMA (Cc rows).
template <int NP, int NR, int BK, int S>
__global__ void __launch_bounds__(kThreads, 1)
dx_kernel(const __grid_constant__ CUtensorMap tm_w0,
          const __grid_constant__ CUtensorMap tm_w1,
          const __grid_constant__ CUtensorMap tm_y0,
          const __grid_constant__ CUtensorMap tm_y1,
          const __grid_constant__ CUtensorMap tm_o, int K, int M, int nM,
          int chunks, int Cc, int units) {
  using L = DxSmem<NR, BK, S>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const auto full = [&](int s) { return base + L::kBar + 8 * s; };
  const auto empty = [&](int s) { return base + L::kBar + 8 * (S + s); };
  const auto unit = [&](int u, int& m0, int& c0, int& e) {
    m0 = (u % nM) * kBM;
    c0 = (u / nM % chunks) * Cc;
    e = u / nM / chunks;
  };

  const int tid = threadIdx.x;
  const int nk = (K + BK - 1) / BK;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid < 128) {
    // ---- producer ----------------------------------------------------------
    regs_dec<kProducerRegs>();
    if (tid == 0) {
      int it = 0;                            // stages issued
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        int m0, c0, e;
        unit(u, m0, c0, e);
        for (int j = 0; j < NP; ++j)
          for (int kt = 0; kt < nk; ++kt, ++it) {
            const int s = it % S;
            mbar_wait(empty(s), ((it / S) & 1) ^ 1);
            const uint32_t st = base + s * L::kStage;
            mbar_arrive_tx(full(s), L::kStage);
#pragma unroll
            for (int b = 0; b < BK / 64; ++b) {
              const int k = kt * BK + 64 * b;
              tma_3d(st + b * kBM * 128, j ? &tm_w1 : &tm_w0, k, m0, e,
                     full(s));
              tma_3d(st + L::kW + b * NR * 128, j ? &tm_y1 : &tm_y0, k, c0,
                     e, full(s));
            }
          }
      }
    }
    return;
  }

  // ---- consumers -----------------------------------------------------------
  regs_inc<kConsumerRegs>();
  const int cw = tid / 128 - 1, t = tid & 127;
  const int wi = t >> 5, g = (t & 31) >> 2, tg = t & 3;
  const uint32_t ot = base + L::kOutOff + cw * L::kOut;
  unsigned char* os = smem + L::kOutOff + cw * L::kOut;
  const bf16* os_type = nullptr;             // picks round_to's overload
  float acc[NP][NR / 2];
  int it = 0;                                // stages consumed
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    int m0, c0, e;
    unit(u, m0, c0, e);
#pragma unroll
    for (int j = 0; j < NP; ++j) {
#pragma unroll
      for (int q = 0; q < NR / 2; ++q) acc[j][q] = 0.f;
      keep(acc[j]);   // zeroed here, not between pair 0's wgmma and its wait
    }
    int last = -1;                           // the previous stage
#pragma unroll
    for (int j = 0; j < NP; ++j)
      for (int kt = 0; kt < nk; ++kt, ++it) {
        const int s = it % S;
        mbar_wait(full(s), (it / S) & 1);
        const uint32_t st = base + s * L::kStage;
        wg_fence();
#pragma unroll
        for (int ks = 0; ks < BK / 16; ++ks)
          wgmma_kk(acc[j],
                   desc(st + (ks >> 2) * kBM * 128 + cw * 64 * 128 +
                            (ks & 3) * 32,
                        16, 1024),
                   desc(st + L::kW + (ks >> 2) * NR * 128 + (ks & 3) * 32,
                        16, 1024));
        wg_commit();
        if (last >= 0) {
          wg_wait<1>();
          mbar_arrive(empty(last));
        }
        last = s;
      }
    wg_wait<0>();
#pragma unroll
    for (int j = 0; j < NP; ++j) keep(acc[j]);
    mbar_arrive(empty(last));

    // epilogue: accumulator (column 16 wi + g + 8 h of the consumer's M,
    // row n of N) -> bf16 at (n, that column) of the output tile, then one
    // TMA store of Cc rows
    if (t == 0) bulk_wait_read<0>();         // the last store has read it
    bar_sync(1 + cw, 128);
#pragma unroll
    for (int q = 0; q < NR / 2; ++q) {
      const int m = 16 * wi + g + 8 * ((q >> 1) & 1);
      const int n = 8 * (q >> 2) + 2 * tg + (q & 1);
      float v = acc[0][q];
      if constexpr (NP == 2)
        v = round_to(acc[0][q], os_type) + round_to(acc[1][q], os_type);
      *reinterpret_cast<bf16*>(os + sw128(n, m)) = __float2bfloat16(v);
    }
    fence_async();
    bar_sync(1 + cw, 128);
    if (t == 0 && m0 + 64 * cw < M) {
      tma_store_3d(&tm_o, ot, m0 + 64 * cw, c0, e);
      bulk_commit();
    }
  }
  if (t == 0) bulk_wait<0>();
}

// --- K1 --------------------------------------------------------------------

// dg, du [E, C, F] = swiglu_bwd(g, u, dout) of the recomputed products
// g = x [E, C, D] . w_gate [E, D, F] and u = x . w_up (M = F, N = C,
// K = D), and y = silu(g) u when asked (the forward's epilogue of the same
// accumulators: a check of the recompute). A unit is (64 columns of F, a
// chunk of Cc <= NR rows of C, expert), F-tiles fastest.
// A block runs two pipelines p = 0, 1, each a producer thread, a ring and a
// consumer warpgroup. Shared memory of pipeline p: its ring of S stages,
// each x's chunk [BK / 64][NR][64] (rows of C, 64 columns of D a block:
// B K-major) and the unit's gate and up tiles [BK][64] (rows of D by 64
// columns of F: A MN-major); its two output tiles [NR][64] (rows of C by
// the unit's columns): dout's, which then stages dg (and last y), and
// du's; then the mbarriers of both (full, empty, dout's full and empty,
// and pipeline 0's half-way mark).
template <int NR, int BK, int S>
struct GuSmem {
  static constexpr uint32_t kX = NR * BK * 2;            // x's chunk
  static constexpr uint32_t kW = BK * 128;               // a weight tile
  static constexpr uint32_t kStage = kX + 2 * kW;
  static constexpr uint32_t kOut = NR * 128;             // an output tile
  static constexpr uint32_t kPipe = S * kStage + 2 * kOut;
  static constexpr uint32_t kBar = 2 * kPipe;
  static constexpr uint32_t kBars = 2 * S + 3;           // a pipeline's
  static constexpr size_t kAlloc = kBar + 16 * kBars + 1024;
  static_assert(BK % 64 == 0 && NR % 8 == 0 && NR <= 256, "tile shape");
  static_assert(kStage % 1024 == 0, "swizzled tiles 1024-byte aligned");
  static_assert(kAlloc <= 232448, "a block's shared memory");
};

// Pipeline p of block b walks units 2 v + p for v = b, b + gridDim.x, ...
// (unit u: columns (u % nF) 64 of F, chunk (u / nF) % chunks of C, expert
// u / (nF chunks)), so the two take neighbouring F-tiles of one x chunk.
// Its producer thread (thread 32 p) streams each unit's stages through its
// ring and, once the first S are issued, the unit's dout tile, which lands
// under the k loop. Its consumer computes the unit's gate and up, one
// m64nNRk16 wgmma each a k16 step, in increasing k; a stage's slot goes
// back as soon as its products are done. The epilogue applies swiglu_bwd
// to each (g, u) and dout's element, writes dg over dout and du into the
// du tile, and one thread stores both by TMA (Cc rows); y, when asked,
// goes into dout's tile once that store has read it. The tiles take the
// next unit's once the last stores have read them (the consumer's first
// warp says so at its next unit's first stage). Pipeline 1 starts once
// pipeline 0's consumer is half through its first unit, so each
// consumer's epilogue runs while the other's loads and products go on.
template <int NR, int BK, int S>
__global__ void __launch_bounds__(kThreads, 1)
dgu_kernel(const __grid_constant__ CUtensorMap tm_x,
           const __grid_constant__ CUtensorMap tm_g,
           const __grid_constant__ CUtensorMap tm_u,
           const __grid_constant__ CUtensorMap tm_d,
           const __grid_constant__ CUtensorMap tm_dg,
           const __grid_constant__ CUtensorMap tm_du,
           const __grid_constant__ CUtensorMap tm_y, int C, int D, int F,
           int nF, int chunks, int Cc, int units, int with_y) {
  using L = GuSmem<NR, BK, S>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const int tid = threadIdx.x;
  // this thread's pipeline: its shared memory and mbarriers
  const int p = tid < 128 ? (tid >> 5) & 1 : tid / 128 - 1;
  const uint32_t pipe = base + p * L::kPipe;
  const uint32_t bars = base + L::kBar + 8 * L::kBars * p;
  const auto full = [&](int s) { return bars + 8 * s; };
  const auto empty = [&](int s) { return bars + 8 * (S + s); };
  const uint32_t dout_full = bars + 8 * 2 * S;
  const uint32_t dout_empty = dout_full + 8;
  const uint32_t half = base + L::kBar + 8 * (L::kBars - 1);  // p 0's
  const auto unit = [&](int v, int& f0, int& c0, int& e) {
    const int u = 2 * v + p;
    f0 = (u % nF) * 64;
    c0 = (u / nF % chunks) * Cc;
    e = u / nF / chunks;
  };
  const int pairs = (units + 1) / 2;
  const int nk = (D + BK - 1) / BK;
  if (tid == 0) {
    for (int q = 0; q < 2; ++q) {
      const uint32_t b = base + L::kBar + 8 * L::kBars * q;
      for (int s = 0; s < S; ++s) {
        mbar_init(b + 8 * s, 1);             // the producer's expect_tx
        mbar_init(b + 8 * (S + s), 128);     // every consumer thread
      }
      mbar_init(b + 8 * 2 * S, 1);
      mbar_init(b + 8 * (2 * S + 1), 32);    // the consumer's first warp
    }
    mbar_init(half, 32);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid < 128) {
    // ---- producers: threads 0 and 32 issue every copy of their pipeline --
    regs_dec<kProducerRegs>();
    if ((tid & 31) == 0 && tid < 64) {
      if (p == 1) mbar_wait(half, 0);
      int it = 0, nd = 0;                    // stages and units issued
      for (int v = blockIdx.x; v < pairs; v += gridDim.x, ++nd) {
        if (2 * v + p >= units) break;
        int f0, c0, e;
        unit(v, f0, c0, e);
        for (int kt = 0; kt < nk; ++kt, ++it) {
          const int s = it % S;
          mbar_wait(empty(s), ((it / S) & 1) ^ 1);
          const uint32_t st = pipe + s * L::kStage;
          mbar_arrive_tx(full(s), L::kStage);
#pragma unroll
          for (int b = 0; b < BK / 64; ++b)
            tma_3d(st + b * NR * 128, &tm_x, kt * BK + 64 * b, c0, e,
                   full(s));
          tma_3d(st + L::kX, &tm_g, f0, kt * BK, e, full(s));
          tma_3d(st + L::kX + L::kW, &tm_u, f0, kt * BK, e, full(s));
          if (kt == min(S, nk) - 1) {        // dout, under the k loop
            mbar_wait(dout_empty, (nd & 1) ^ 1);
            mbar_arrive_tx(dout_full, Cc * 128);
            tma_3d(pipe + S * L::kStage, &tm_d, f0, c0, e, dout_full);
          }
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup 1 + p ----------------------------------------
  regs_inc<kConsumerRegs>();
  const int t = tid & 127;
  const int wi = t >> 5, g = (t & 31) >> 2, tg = t & 3;
  const uint32_t ot = pipe + S * L::kStage;  // dout's tile, then du's
  unsigned char* os = smem + (ot - base);
  unsigned char* us = os + L::kOut;
  float ga[NR / 2], ua[NR / 2];
  int it = 0, nd = 0;                        // stages and units consumed
  for (int v = blockIdx.x; v < pairs; v += gridDim.x, ++nd) {
    if (2 * v + p >= units) break;
    int f0, c0, e;
    unit(v, f0, c0, e);
#pragma unroll
    for (int q = 0; q < NR / 2; ++q) ga[q] = ua[q] = 0.f;
    keep(ga);     // zeroed here, not between a wgmma and its wait
    keep(ua);
    for (int kt = 0; kt < nk; ++kt, ++it) {
      const int s = it % S;
      mbar_wait(full(s), (it / S) & 1);
      const uint32_t st = pipe + s * L::kStage;
      wg_fence();
#pragma unroll
      for (int ks = 0; ks < BK / 16; ++ks) {
        const uint64_t b =
            desc(st + (ks >> 2) * NR * 128 + (ks & 3) * 32, 16, 1024);
        wgmma_tk(ga, desc(st + L::kX + ks * 2048, 8192, 1024), b);
        wgmma_tk(ua, desc(st + L::kX + L::kW + ks * 2048, 8192, 1024), b);
      }
      wg_commit();
      wg_wait<0>();                          // the slot goes back
      mbar_arrive(empty(s));
      if (kt == 0 && nd > 0 && wi == 0) {    // the last unit's stores have
        bulk_wait_read<0>();                 // read the tiles: they may take
        mbar_arrive(dout_empty);             // this unit's
      }
      if (p == 0 && nd == 0 && kt == nk / 2 && wi == 0) mbar_arrive(half);
    }
    keep(ga);
    keep(ua);

    // epilogue: accumulator (column 16 wi + g + 8 h of the unit, row n of
    // C) with dout's element at (n, that column) of the tile
    const int rows = min(Cc, C - c0);
    const auto store = [&](const CUtensorMap* map, uint32_t tile) {
      if (t == 0) tma_store_3d(map, tile, f0, c0, e);
    };
    mbar_wait(dout_full, nd & 1);
#pragma unroll
    for (int q = 0; q < NR / 2; ++q) {
      const int m = 16 * wi + g + 8 * ((q >> 1) & 1);
      const int n = 8 * (q >> 2) + 2 * tg + (q & 1);
      if (n >= rows) continue;
      bf16* d = reinterpret_cast<bf16*>(os + sw128(n, m));
      float dg, du;
      swiglu_bwd(ga[q], ua[q], __bfloat162float(*d), dg, du);
      *d = __float2bfloat16(dg);
      *reinterpret_cast<bf16*>(us + sw128(n, m)) = __float2bfloat16(du);
      if (with_y) ga[q] = ga[q] / (1.f + expf(-ga[q])) * ua[q];
    }
    fence_async();
    bar_sync(1 + p, 128);
    store(&tm_dg, ot);
    store(&tm_du, ot + L::kOut);
    if (t == 0) bulk_commit();
    if (with_y) {                            // y over dg once it is read
      if (t == 0) bulk_wait_read<0>();
      bar_sync(1 + p, 128);
#pragma unroll
      for (int q = 0; q < NR / 2; ++q) {
        const int m = 16 * wi + g + 8 * ((q >> 1) & 1);
        const int n = 8 * (q >> 2) + 2 * tg + (q & 1);
        if (n < rows)
          *reinterpret_cast<bf16*>(os + sw128(n, m)) = __float2bfloat16(ga[q]);
      }
      fence_async();
      bar_sync(1 + p, 128);
      store(&tm_y, ot);
      if (t == 0) bulk_commit();
    }
  }
  if (t == 0) bulk_wait_read<0>();           // the stores have read the tiles
}

// --- launchers -------------------------------------------------------------

template <typename Kernel>
cudaError_t configure(Kernel kern, size_t bytes, bool& done) {
  if (done) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  done = err == cudaSuccess;
  return err;
}

template <int NO, int BN, int BK, int SA, int SB>
int dw_launch(const void* a, long long sae, long long sac, const void* dy0,
              const void* dy1, long long sdye, long long sdyc, void* dw0,
              void* dw1, int E, int C, int D, int F, cudaStream_t st) {
  using L = DwSmem<NO, BN, BK, SA, SB>;
  auto kern = dw_kernel<NO, BN, BK, SA, SB>;
  static bool configured = false;            // once per instantiation
  cudaError_t err = configure(kern, L::kAlloc, configured);
  if (err != cudaSuccess) return static_cast<int>(err);
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const long long out = static_cast<long long>(D) * F;
  CUtensorMap ma, mb0, mb1, mo0, mo1;
  if (!map_bf16(&ma, encode, a, D, C, E, sac, sae, 64, BK) ||
      !map_bf16(&mb0, encode, dy0, F, C, E, sdyc, sdye, 64, BK) ||
      !map_bf16(&mb1, encode, dy1, F, C, E, sdyc, sdye, 64, BK) ||
      !map_bf16(&mo0, encode, dw0, F, D, E, F, out, 64, 64) ||
      !map_bf16(&mo1, encode, dw1, F, D, E, F, out, 64, 64))
    return static_cast<int>(cudaErrorInvalidValue);
  const int nM = (D + kBM - 1) / kBM, nN = (F + BN - 1) / BN;
  const int units = E * nN;
  kern<<<units, kThreads, L::kAlloc, st>>>(ma, mb0, mb1, mo0, mo1, C, D, F,
                                          nM, nN, units);
  return static_cast<int>(cudaGetLastError());
}

template <int NP, int NR, int BK, int S>
int dx_launch(const void* dy0, const void* dy1, long long sdye,
              long long sdyc, const void* w0, const void* w1, long long swe,
              long long swd, void* dx, int E, int C, int D, int F,
              cudaStream_t st) {
  using L = DxSmem<NR, BK, S>;
  auto kern = dx_kernel<NP, NR, BK, S>;
  static bool configured = false;            // once per instantiation
  cudaError_t err = configure(kern, L::kAlloc, configured);
  if (err != cudaSuccess) return static_cast<int>(err);
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const int chunks = (C + NR - 1) / NR;
  const int Cc = ((C + chunks - 1) / chunks + 7) / 8 * 8;   // <= NR
  CUtensorMap mw0, mw1, my0, my1, mo;
  if (!map_bf16(&mw0, encode, w0, F, D, E, swd, swe, 64, kBM) ||
      !map_bf16(&mw1, encode, w1, F, D, E, swd, swe, 64, kBM) ||
      !map_bf16(&my0, encode, dy0, F, C, E, sdyc, sdye, 64, NR) ||
      !map_bf16(&my1, encode, dy1, F, C, E, sdyc, sdye, 64, NR) ||
      !map_bf16(&mo, encode, dx, D, C, E, D, static_cast<long long>(C) * D,
                64, Cc))
    return static_cast<int>(cudaErrorInvalidValue);
  const int nM = (D + kBM - 1) / kBM;
  const int units = E * chunks * nM;
  kern<<<units, kThreads, L::kAlloc, st>>>(mw0, mw1, my0, my1, mo, F, D, nM,
                                          chunks, Cc, units);
  return static_cast<int>(cudaGetLastError());
}

template <int NR, int BK, int S>
int gu_launch(const void* x, long long sxe, long long sxc, const void* wg,
              const void* wu, long long swe, long long swd, const void* dout,
              void* dg, void* du, void* y, int E, int C, int D, int F,
              cudaStream_t st) {
  using L = GuSmem<NR, BK, S>;
  auto kern = dgu_kernel<NR, BK, S>;
  static bool configured = false;            // once per instantiation
  cudaError_t err = configure(kern, L::kAlloc, configured);
  if (err != cudaSuccess) return static_cast<int>(err);
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const int chunks = (C + NR - 1) / NR;
  const int Cc = ((C + chunks - 1) / chunks + 7) / 8 * 8;   // <= NR
  const long long out = static_cast<long long>(C) * F;
  CUtensorMap mx, mg, mu, md, mdg, mdu, my;
  if (!map_bf16(&mx, encode, x, D, C, E, sxc, sxe, 64, NR) ||
      !map_bf16(&mg, encode, wg, F, D, E, swd, swe, 64, BK) ||
      !map_bf16(&mu, encode, wu, F, D, E, swd, swe, 64, BK) ||
      !map_bf16(&md, encode, dout, F, C, E, F, out, 64, Cc) ||
      !map_bf16(&mdg, encode, dg, F, C, E, F, out, 64, Cc) ||
      !map_bf16(&mdu, encode, du, F, C, E, F, out, 64, Cc) ||
      !map_bf16(&my, encode, y != nullptr ? y : du, F, C, E, F, out, 64, Cc))
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nF = (F + 63) / 64;
  const int units = E * chunks * nF, pairs = (units + 1) / 2;
  kern<<<pairs < sms ? pairs : sms, kThreads, L::kAlloc, st>>>(
      mx, mg, mu, md, mdg, mdu, my, C, D, F, nF, chunks, Cc, units,
      y != nullptr);
  return static_cast<int>(cudaGetLastError());
}

// K1: NR 160 rows of C (qwen3-moe's C 160 is one chunk), so each weight
// tile is read once a launch; two pipelines a block, each a ring of 2
// stages of 64 rows of D (36 KB each) and two output tiles (40 KB).
int gu_dispatch(const void* x, long long sxe, long long sxc, const void* wg,
                const void* wu, long long swe, long long swd,
                const void* dout, void* dg, void* du, void* y, int E, int C,
                int D, int F, cudaStream_t st) {
  if (!takes(E, C, D, F, {sxe, sxc, swe, swd},
             {x, wg, wu, dout, dg, du, y != nullptr ? y : du}))
    return static_cast<int>(cudaErrorInvalidValue);
  return gu_launch<160, kGuDepth, kGuRing>(x, sxe, sxc, wg, wu, swe, swd,
                                           dout, dg, du, y, E, C, D, F, st);
}

// K2: NR 160 rows of C (qwen3-moe's C 160 is one chunk), so each weight
// tile is read once a launch; a ring of 5 stages of 64 rows of F (36 KB
// each).
int dx_dispatch(int pairs, const void* dy0, const void* dy1, long long sdye,
                long long sdyc, const void* w0, const void* w1,
                long long swe, long long swd, void* dx, int E, int C, int D,
                int F, cudaStream_t st) {
  if ((pairs != 1 && pairs != 2) ||
      !takes(E, C, D, F, {sdye, sdyc, swe, swd}, {dy0, dy1, w0, w1, dx}))
    return static_cast<int>(cudaErrorInvalidValue);
  if (pairs == 1)
    return dx_launch<1, 160, kDxDepth, kDxRing>(
        dy0, dy1, sdye, sdyc, w0, w1, swe, swd, dx, E, C, D, F, st);
  return dx_launch<2, 160, kDxDepth, kDxRing>(
      dy0, dy1, sdye, sdyc, w0, w1, swe, swd, dx, E, C, D, F, st);
}

// K3: 256 columns of B a unit (one output of 256, or two of 128: the
// consumers hold 128 f32 accumulators a thread either way); chunks of 32
// rows of C, a ring of 10 for a and 5 slots for dy (230 KB).
int dw_dispatch(int outs, const void* a, long long sae, long long sac,
                const void* dy0, const void* dy1, long long sdye,
                long long sdyc, void* dw0, void* dw1, int E, int C, int D,
                int F, cudaStream_t st) {
  if ((outs != 1 && outs != 2) ||
      !takes(E, C, D, F, {sae, sac, sdye, sdyc}, {a, dy0, dy1, dw0, dw1}))
    return static_cast<int>(cudaErrorInvalidValue);
  if (outs == 1)
    return dw_launch<1, 256, kDwDepth, kDwRing, kDwSlots>(
        a, sae, sac, dy0, dy1, sdye, sdyc, dw0, dw1, E, C, D, F, st);
  return dw_launch<2, 128, kDwDepth, kDwRing, kDwSlots>(
      a, sae, sac, dy0, dy1, sdye, sdyc, dw0, dw1, E, C, D, F, st);
}

// --- the bit probe ---------------------------------------------------------

// One chain of `steps` k16 products in increasing k, a [steps][64][16] (row
// m, column k of each step) by b [steps][256][16] (row n, column k), bf16,
// one way per kernel into out [way][64][256] f32 ([m][n]; the way's N
// columns written). Way 0, probe_mma: mma.sync.m16n8k16 over 32 n8 tiles,
// the mma.sync kernels' instruction. Ways 1-7, probe_kernel<V>, one
// warpgroup on wgmma, operands in shared memory in the 128-byte swizzle:
//   1 m64n8k16, A in registers (the int8 variant's), B K-major;
//   2 m64n8k16, A MN-major, B K-major;
//   3 m64n64k16, A MN-major, B K-major;
//   4 m64n160k16, A and B K-major (K2's);
//   5 m64n128k16, A and B MN-major (K3's at two outputs);
//   6 m64n256k16, A and B MN-major (K3's at one output);
//   7 m64n160k16, A MN-major, B K-major (K1's).
constexpr int kProbeWays = 8;

__device__ __forceinline__ uint32_t pair_at(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__global__ void __launch_bounds__(128)
probe_mma(const bf16* __restrict__ a, const bf16* __restrict__ b,
          float* __restrict__ out, int steps) {
  const int t = threadIdx.x, wi = t >> 5, g = (t & 31) >> 2, tg = t & 3;
  float d[32][4] = {};
  for (int st = 0; st < steps; ++st) {
    const bf16* as = a + static_cast<int64_t>(st) * 64 * 16;
    const bf16* bs = b + static_cast<int64_t>(st) * 256 * 16;
    const int m = 16 * wi + g;
    const uint32_t af[4] = {pair_at(as + m * 16 + 2 * tg),
                            pair_at(as + (m + 8) * 16 + 2 * tg),
                            pair_at(as + m * 16 + 2 * tg + 8),
                            pair_at(as + (m + 8) * 16 + 2 * tg + 8)};
#pragma unroll
    for (int jn = 0; jn < 32; ++jn) {
      const bf16* bn = bs + (8 * jn + g) * 16 + 2 * tg;
      tc::mma16816(d[jn], af, pair_at(bn), pair_at(bn + 8));
    }
  }
#pragma unroll
  for (int jn = 0; jn < 32; ++jn)
#pragma unroll
    for (int q = 0; q < 4; ++q)
      out[(16 * wi + g + 8 * (q >> 1)) * 256 + 8 * jn + 2 * tg + (q & 1)] =
          d[jn][q];
}

template <int V>
__global__ void __launch_bounds__(128)
probe_kernel(const bf16* __restrict__ a, const bf16* __restrict__ b,
             float* __restrict__ out, int steps) {
  constexpr int N = V <= 2   ? 8
                  : V == 3 ? 64
                  : V == 5 ? 128
                  : V == 6 ? 256
                           : 160;
  constexpr bool kAK = V == 4, kBMN = V == 5 || V == 6;  // A K-, B MN-major
  __shared__ __align__(1024) unsigned char sa[64 * 128];
  __shared__ __align__(1024) unsigned char sb[256 * 128];
  const int t = threadIdx.x, wi = t >> 5, g = (t & 31) >> 2, tg = t & 3;
  const uint32_t sa_addr = smem_addr(sa), sb_addr = smem_addr(sb);
  float d[N / 2];
#pragma unroll
  for (int q = 0; q < N / 2; ++q) d[q] = 0.f;
  for (int st = 0; st < steps; ++st) {
    const bf16* as = a + static_cast<int64_t>(st) * 64 * 16;
    const bf16* bs = b + static_cast<int64_t>(st) * 256 * 16;
    for (int i = t; i < 64 * 16; i += 128) {   // A (m r, k): [m][k] or [k][m]
      const int r = i >> 4, k = i & 15;
      *reinterpret_cast<bf16*>(sa + (kAK ? sw128(r, k) : sw128(k, r))) =
          as[i];
    }
    for (int i = t; i < N * 16; i += 128) {    // B (n r, k)
      const int r = i >> 4, k = i & 15;
      *reinterpret_cast<bf16*>(
          sb + (kBMN ? (r >> 6) * 2048 + sw128(k, r & 63) : sw128(r, k))) =
          bs[i];
    }
    fence_async();
    __syncthreads();
    wg_fence();
    if constexpr (V == 1) {
      const int m = 16 * wi + g;
      uint32_t af[4] = {pair_at(as + m * 16 + 2 * tg),
                        pair_at(as + (m + 8) * 16 + 2 * tg),
                        pair_at(as + m * 16 + 2 * tg + 8),
                        pair_at(as + (m + 8) * 16 + 2 * tg + 8)};
      i8::wgmma_rs(d, af, i8::desc_x<64>(sb_addr, 0, 0));
    } else if constexpr (V <= 3) {
      i8::wgmma_ss(d, i8::desc_a(sa_addr, 0), i8::desc_x<64>(sb_addr, 0, 0));
    } else if constexpr (V == 4) {
      wgmma_kk(d, desc(sa_addr, 16, 1024), desc(sb_addr, 16, 1024));
    } else if constexpr (V == 7) {
      wgmma_tk(d, i8::desc_a(sa_addr, 0), desc(sb_addr, 16, 1024));
    } else {
      wgmma_tt(d, desc(sa_addr, 2048, 1024), desc(sb_addr, 2048, 1024));
    }
    wg_commit();
    wg_wait<0>();
    keep(d);
    __syncthreads();
  }
#pragma unroll
  for (int q = 0; q < N / 2; ++q)
    out[(16 * wi + g + 8 * ((q >> 1) & 1)) * 256 + 8 * (q >> 2) + 2 * tg +
        (q & 1)] = d[q];
}

int probe(const bf16* a, const bf16* b, float* out, int steps,
          cudaStream_t st) {
  constexpr int kWay = 64 * 256;
  probe_mma<<<1, 128, 0, st>>>(a, b, out, steps);
  probe_kernel<1><<<1, 128, 0, st>>>(a, b, out + kWay, steps);
  probe_kernel<2><<<1, 128, 0, st>>>(a, b, out + 2 * kWay, steps);
  probe_kernel<3><<<1, 128, 0, st>>>(a, b, out + 3 * kWay, steps);
  probe_kernel<4><<<1, 128, 0, st>>>(a, b, out + 4 * kWay, steps);
  probe_kernel<5><<<1, 128, 0, st>>>(a, b, out + 5 * kWay, steps);
  probe_kernel<6><<<1, 128, 0, st>>>(a, b, out + 6 * kWay, steps);
  probe_kernel<7><<<1, 128, 0, st>>>(a, b, out + 7 * kWay, steps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wgrad

// ---------------------------------------------------------------------------
// the backward's products on the CUDA cores (f32, and bf16 shapes outside
// the tensor-core rule)
// ---------------------------------------------------------------------------

namespace cc {

// out_j[e](m, n) = sum over k of A_j[e](m, k) . B_j[e](k, n) for j < NP,
// every operand read through element strides (A_j at a + e*sae + m*sam +
// k*sak, B_j at b + e*sbe + k*sbk + n*sbn, out_j at out + e*soe + m*som +
// n*son), bounds-checked scalar loads. kSum: one output, the NP = 2 sets
// each rounded to T, added in f32 and rounded again (K2's pairs).
struct Args {
  const void* a[2];
  const void* b[2];
  void* out[2];
  long long sae, sam, sak, sbe, sbk, sbn, soe, som, son;
  int M, N, K;
};

constexpr int kTile = 64;   // outputs of a block along M and along N
constexpr int kDepth = 16;  // K of one shared tile

// One block per (64 rows of M, 64 of N, expert), 256 threads of 4 x 4
// outputs (rows ty + 16 i, columns tx + 16 c); each output is one thread's
// f32 accumulator, updated with one fmaf per k in increasing k (no TF32),
// so its summation order depends on K alone.
template <typename T, int NP, bool kSum>
__global__ void __launch_bounds__(256) gemm_kernel(const Args g) {
  __shared__ float as[NP][kDepth][kTile + 1];
  __shared__ float bs[NP][kDepth][kTile + 1];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.x * kTile, n0 = blockIdx.y * kTile;
  const int64_t e = blockIdx.z;
  float acc[NP][4][4];
#pragma unroll
  for (int j = 0; j < NP; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[j][i][c] = 0.f;

  for (int k0 = 0; k0 < g.K; k0 += kDepth) {
#pragma unroll
    for (int j = 0; j < NP; ++j) {
      const T* a = static_cast<const T*>(g.a[j]) + e * g.sae;
      const T* b = static_cast<const T*>(g.b[j]) + e * g.sbe;
#pragma unroll
      for (int i = 0; i < kTile * kDepth / 256; ++i) {
        const int idx = tid + i * 256;
        const int r = idx % kTile, k = idx / kTile;
        as[j][k][r] = m0 + r < g.M && k0 + k < g.K
                          ? to_f32(a[(m0 + r) * g.sam + (k0 + k) * g.sak])
                          : 0.f;
        bs[j][k][r] = n0 + r < g.N && k0 + k < g.K
                          ? to_f32(b[(k0 + k) * g.sbk + (n0 + r) * g.sbn])
                          : 0.f;
      }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kDepth; ++k)
#pragma unroll
      for (int j = 0; j < NP; ++j) {
        float av[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          av[i] = as[j][k][ty + 16 * i];
          bv[i] = bs[j][k][tx + 16 * i];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            acc[j][i][c] = fmaf(av[i], bv[c], acc[j][i][c]);
      }
    __syncthreads();
  }

  const T* kind = nullptr;           // picks round_to's overload
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int m = m0 + ty + 16 * i, n = n0 + tx + 16 * c;
      if (m >= g.M || n >= g.N) continue;
      const int64_t o = e * g.soe + m * g.som + n * g.son;
      if constexpr (kSum) {
        store(static_cast<T*>(g.out[0]) + o,
              round_to(acc[0][i][c], kind) + round_to(acc[1][i][c], kind));
      } else {
#pragma unroll
        for (int j = 0; j < NP; ++j)
          store(static_cast<T*>(g.out[j]) + o, acc[j][i][c]);
      }
    }
}

template <typename T>
int launch(const Args& g, int np, bool sum, int E, cudaStream_t st) {
  const dim3 grid((g.M + kTile - 1) / kTile, (g.N + kTile - 1) / kTile, E);
  if (np == 1)
    gemm_kernel<T, 1, false><<<grid, 256, 0, st>>>(g);
  else if (sum)
    gemm_kernel<T, 2, true><<<grid, 256, 0, st>>>(g);
  else
    gemm_kernel<T, 2, false><<<grid, 256, 0, st>>>(g);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(int dtype, const Args& g, int np, bool sum, int E,
             cudaStream_t st) {
  if ((np != 1 && np != 2) || E < 1 || E > 65535 || g.M < 1 || g.N < 1 ||
      g.K < 1 || (g.N + kTile - 1) / kTile > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) return launch<__nv_bfloat16>(g, np, sum, E, st);
  if (dtype == 1) return launch<float>(g, np, sum, E, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace cc

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
// scales s [E, 1, F] (expert stride sse >= F, unit stride along F); D a
// multiple of 8, F and q's strides multiples of 16 (TMA's 16-byte global
// strides), x's strides multiples of 8, x, q and y 16-byte aligned (y is a
// contiguous [E, C, F] output). The output is the tensor-core variant's on
// the bf16 weights bf16(float(q) * s).
extern "C" int moe_gemm_i8_launch(const void* x, long long sxe,
                                  long long sxc, const void* q, long long swe,
                                  long long swd, const void* s,
                                  long long sse, void* y, int E, int C, int D,
                                  int F, void* stream) {
  return i8::dispatch<false>({x, q, q, s, s, sxe, sxc, swe, swd, sse, y, E,
                              C, D, F, static_cast<cudaStream_t>(stream)});
}

extern "C" int moe_ffn_fused_i8_launch(const void* x, long long sxe,
                                       long long sxc, const void* q_gate,
                                       const void* q_up, long long swe,
                                       long long swd, const void* s_gate,
                                       const void* s_up, long long sse,
                                       void* y, int E, int C, int D, int F,
                                       void* stream) {
  return i8::dispatch<true>({x, q_gate, q_up, s_gate, s_up, sxe, sxc, swe,
                             swd, sse, y, E, C, D, F,
                             static_cast<cudaStream_t>(stream)});
}

// The bit probe (wgrad::probe): a [steps][64][16] and b [steps][256][16]
// bf16, out [8][64][256] f32, one way each (mma.sync, then seven wgmma
// shapes and operand layouts); one warpgroup, one block a way.
extern "C" int moe_gemm_i8_probe(const void* a, const void* b, void* out,
                                 int steps, void* stream) {
  return wgrad::probe(static_cast<const __nv_bfloat16*>(a),
                      static_cast<const __nv_bfloat16*>(b),
                      static_cast<float*>(out), steps,
                      static_cast<cudaStream_t>(stream));
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

// K1 (moe_ffn_fused's backward): g = x @ w_gate and u = x @ w_up
// recomputed (the same k-chain as the forward, so its accumulators bit for
// bit) and dg and du [E, C, F] written in x's dtype from dout [E, C, F]
// (all three contiguous). y, when not null, also receives the forward's
// output from those accumulators (a check of the recompute, not the
// training path). tc 1: wgrad::dgu_kernel (bf16, the forward's layout
// rule, dout, dg, du and y 16-byte aligned); tc 0: the CUDA-core template
// (dtype 0 bf16, 1 f32).
extern "C" int moe_ffn_fused_bwd_launch(int dtype, int tc, const void* x,
                                        long long sxe, long long sxc,
                                        const void* w_gate, const void* w_up,
                                        long long swe, long long swd,
                                        const void* dout, void* dg, void* du,
                                        void* y, int E, int C, int D, int F,
                                        int vec_ok, void* stream) {
  if (tc)
    return wgrad::gu_dispatch(x, sxe, sxc, w_gate, w_up, swe, swd, dout, dg,
                              du, y, E, C, D, F,
                              static_cast<cudaStream_t>(stream));
  Bwd bw;
  bw.dout = dout, bw.dg = dg, bw.du = du;
  return dispatch<true, true>(dtype, x, sxe, sxc, w_gate, w_up, swe, swd, y,
                              E, C, D, F, vec_ok, stream, bw);
}

// K2: dx [E, C, D] (contiguous) = sum over j < pairs of dy_j [E, C, F] .
// w_j [E, D, F]^T, each pair's f32 product rounded to x's dtype, the two
// added in f32 and rounded again. dy_0 and dy_1 share strides, w_0 and w_1
// too; unit stride along F. tc 1: bf16 on the tensor cores (D, F and every
// stride multiples of 8, 16-byte bases); tc 0: the CUDA-core kernel.
extern "C" int moe_gemm_dx_launch(int dtype, int tc, int pairs,
                                  const void* dy0, const void* dy1,
                                  long long sdye, long long sdyc,
                                  const void* w0, const void* w1,
                                  long long swe, long long swd, void* dx,
                                  int E, int C, int D, int F, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tc)
    return wgrad::dx_dispatch(pairs, dy0, dy1, sdye, sdyc, w0, w1, swe, swd,
                              dx, E, C, D, F, st);
  cc::Args g{};
  g.a[0] = dy0, g.a[1] = dy1, g.b[0] = w0, g.b[1] = w1;
  g.out[0] = g.out[1] = dx;
  g.sae = sdye, g.sam = sdyc, g.sak = 1;
  g.sbe = swe, g.sbk = 1, g.sbn = swd;
  g.soe = static_cast<long long>(C) * D, g.som = D, g.son = 1;
  g.M = C, g.N = D, g.K = F;
  return cc::dispatch(dtype, g, pairs, pairs == 2, E, st);
}

// K3: dw_j [E, D, F] (contiguous, x's dtype) = a [E, C, D]^T . dy_j
// [E, C, F] for j < outs, summed over C in increasing c. dy_0 and dy_1
// share strides; unit stride along D and F. tc as for K2.
extern "C" int moe_gemm_dw_launch(int dtype, int tc, int outs, const void* a,
                                  long long sae, long long sac,
                                  const void* dy0, const void* dy1,
                                  long long sdye, long long sdyc, void* dw0,
                                  void* dw1, int E, int C, int D, int F,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tc)
    return wgrad::dw_dispatch(outs, a, sae, sac, dy0, dy1, sdye, sdyc, dw0,
                              dw1, E, C, D, F, st);
  cc::Args g{};
  g.a[0] = g.a[1] = a, g.b[0] = dy0, g.b[1] = dy1;
  g.out[0] = dw0, g.out[1] = dw1;
  g.sae = sae, g.sam = 1, g.sak = sac;
  g.sbe = sdye, g.sbk = sdyc, g.sbn = 1;
  g.soe = static_cast<long long>(D) * F, g.som = F, g.son = 1;
  g.M = D, g.N = F, g.K = C;
  return cc::dispatch(dtype, g, outs, false, E, st);
}
