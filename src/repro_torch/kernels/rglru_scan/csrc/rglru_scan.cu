// RG-LRU linear recurrence for Hopper (sm_90a):
//
//   h[b, t, w] = a[b, t, w] * h[b, t-1, w] + b[b, t, w],   h[b, -1, w] = h0[b, w]
//
// a, b [B, T, W] f32, h0 [B, W] f32 -> h [B, T, W] f32 (contiguous). h[:, -1]
// is the carried state. Padded steps of a right-padded prefill bucket arrive
// as a = 1, b = 0, the identity, so they need no special case here.
//
// Replaces the Pallas TPU kernel of the reference package:
//   src/repro/kernels/rglru_scan/rglru_scan.py  rglru_scan (pl.pallas_call :57)
// and computes the function of the reference's `_scan_lru`
// (src/repro/models/rglru.py:100-127), which the model calls: unlike the
// Pallas kernel it starts from h0 and its last row is the final state.
//
// What bounds it on this card: bytes. It does one multiply-add per element
// and moves 12 bytes for it (read a and b, write h): at recurrentgemma-2b's
// prefill shape (B 1, T 2048, W 2560) 62.9 MB, at least 0.0188 ms at
// 3.35 TB/s. To come near that the loads must keep some 3 MB in flight
// across the card (3.35 TB/s times about 1 us of latency), so T itself has
// to be split across the SMs: one thread walking T per channel gives only
// W / 128 = 20 blocks at that shape.
//
// Design: one pass, chunk-parallel over T, in a fixed composition order.
//
// 1. Tiles. A block owns one tile: one batch row, kTile = 128 channels (32
//    lanes x one float4: neighbouring lanes on neighbouring channels, every
//    load and store 16 bytes a lane) and a chunk of kChunk = 64 steps,
//    scan warp w the kSteps = 8 consecutive steps from w * kSteps; a ninth
//    warp computes the tile's carry-in. B x ceil(T / kChunk) x
//    ceil(W / kTile) blocks: 640 at the prefill shape, two resident an SM
//    (96 registers). A W off a multiple of 4, or a row not 16-byte
//    aligned, takes the scalar edge path (kVec = false), which puts the
//    same values in the same registers; channels past W and steps past T
//    hold the identity (a 1, b 0).
// 2. Local scan. A lane issues all its kSteps loads of a and b before it
//    uses one (2 x kSteps x 16 bytes in flight a lane), then scans them
//    from zero: P (the product of the a's so far) and H (the scan from
//    h = 0), kept in registers for each step it owns. Each scan warp puts
//    its local aggregate (P, H at its last step) in shared memory; warp w
//    composes the aggregates of warps 0 .. w-1 in warp order and applies
//    them to its steps, so every step holds the chunk's (P_t, H_t) from
//    the chunk's start. The last step's pair is the chunk aggregate
//    (P_c, H_c), which the last scan warp publishes to the workspace for
//    its 128 channels, then sets the chunk's bit in its column's done
//    words (threadfence, then atomicOr).
// 3. Carry across chunks, in a fixed order. The carry warp starts from h0
//    and folds in the aggregates of chunks 0 .. c-1 in chunk order,
//    carry = fma(P_j, carry, H_j). It polls the done words with an acquire
//    load (one load a poll for up to 64 chunks) and folds each run of
//    chunks as soon as their bits are set, their aggregates staged in
//    shared memory by cp.async, kStage at a time (one round trip to L2 for
//    up to 32 chunks). It runs while the scan warps load and scan, so the
//    wait for earlier chunks overlaps the tile's own loads. It never reads
//    another tile's carry-in or output: whether those are ready depends on
//    scheduling, and they would make the result's bits depend on it. A
//    tile takes its (chunk, row, channel tile) from an atomic ticket,
//    chunk-major, in the order the blocks start, so it only ever waits on
//    tiles that are already running, and every wait ends.
// 4. Output. After the block's barrier, h_t = fma(P_t, carry, H_t), stored
//    once. The carry into chunk c is the same expression, evaluated in the
//    same order, as h at the last step of chunk c-1, and a warp's composed
//    prefix the same as the pair at the previous warp's last step, so the
//    two have the same bits: identity steps reproduce the state exactly.
//
// Traffic: a and b are read once and h written once, the function's own
// 12 bytes an element, all three evict-first (.cs) so the L2 keeps the
// aggregates and done words; the fold reads c x 1 KB of aggregates from
// L2. No division (P underflows to 0 over long spans, harmless in the fma
// form). Every output's bits depend on (kChunk, kSteps) alone: not on
// scheduling, on B, or on the row's batch position.
//
// Measured (tools/rglru_ablate.py, H100 SXM at 700 W, the prefill shape):
// 0.026-0.027 ms a call on the device, 0.029 by CUDA-graph replay with the
// memset, against 0.0188 for the bytes and 0.022 for torch.mul on the same
// bytes. Cut out, the carry warp's waits save 0.002 ms, its waits and fold
// 0.004: a tile's predecessors load while it does, and it holds its SM
// slot until the last of them has published. Its first design (one thread
// walking T per channel, 20 blocks) took 0.27 ms.
//
// Built and measured on the way to this one (chip_smoke.py's device time
// a call, same card): the last scan warp folding after it published, one
// flag a tile polled by a lane each, 0.031 ms; the fold in its own warp,
// overlapping the loads, with a, b and h evict-first, 0.030; one done bit
// a tile in 64-bit words in place of the flags, 0.028; the fold staged
// through shared memory, 0.027. Other tiles (4 warps x 16 or x 8 steps)
// and three blocks an SM (72 registers, spilling) were slower.
//
// Workspace (the wrapper allocates it, `rglru_scan_ws_bytes`): aggregates
// P and H [B, nc, ntw, kTile] f32, then the done words [B, ntw,
// ceil(nc / 64)] u64 and the ticket, which the launcher zeroes with one
// cudaMemsetAsync on the stream before the kernel (about 1 us on the
// device). The memset is part of every call, so the call stays right under
// CUDA-graph replay (it is a node of the graph).
//
// The backward (rglru_scan_bwd_launch) is the same kernel run in reverse
// (template flag kRev): with g_t the gradient reaching h_t,
//
//   g_t = dh_t + a_{t+1} g_{t+1},  g_T = 0;  db_t = g_t,
//   da_t = g_t h_{t-1} (h_{-1} = h0),  dh0 = a_0 g_0,
//
// the forward's recurrence on virtual step u = T - 1 - t with a shifted by
// one step (a_{t+1}; 1 at the last step, where the carry is 0), dh in b's
// place and a carry that starts from 0. Tiles, chunk aggregates, done bits
// and tickets are the forward's on virtual steps, so the tickets are
// issued from the last real chunk and a tile folds the chunks after it in
// a fixed order: the bits depend on (kChunk, kSteps) alone, as the
// forward's do. The epilogue loads h_{t-1} (h0 at t = 0) and writes db and
// da; the tile holding t = 0 also reads a_0 and writes dh0. The carry
// into a virtual chunk is computed as in the forward, which keeps the
// same-bits property of identity steps (a 1, dh 0).
// Its bound at a training microbatch of recurrentgemma-2b (B 1, T 4096, W
// 2560): it reads a, h and dh and writes da and db, 5 x 41.9 MB = 210 MB,
// at least 0.063 ms at 3.35 TB/s. Flipping the tensors by copy and calling
// the forward would triple those bytes.
//
// C interface (loaded with ctypes): the launcher returns the CUDA error of
// the memset or of the launch (cudaGetLastError()), or
// cudaErrorInvalidValue for a bad shape or a workspace that is too small.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;                 // scan warps a block
constexpr int kSteps = 8;                 // consecutive steps a scan warp
constexpr int kChunk = kWarps * kSteps;   // steps a tile
constexpr int kTile = 128;                // channels a tile: 32 lanes x 4
constexpr int kThreads = 32 * (kWarps + 1);   // and the carry warp
constexpr int kStage = 32;                // aggregates a fold stage holds

struct Args {
  const float* a;
  const float* b;      // the reverse scan: dh
  const float* h0;
  float* h;            // the reverse scan: db (= g)
  const float* hf;     // the reverse scan: the forward's h
  float* da;           // the reverse scan
  float* dh0;          // the reverse scan
  float4* agg_p;       // [B, nc, ntw, 32] float4
  float4* agg_h;
  unsigned long long* done;   // [B, ntw, nm]: bit c % 64 of word c / 64
  unsigned* ticket;
  int B, T, W, nc, ntw, nm;
};

__device__ __forceinline__ float4 fma4(float4 x, float4 y, float4 z) {
  return make_float4(fmaf(x.x, y.x, z.x), fmaf(x.y, y.y, z.y),
                     fmaf(x.z, y.z, z.z), fmaf(x.w, y.w, z.w));
}

__device__ __forceinline__ float4 mul4(float4 x, float4 y) {
  return make_float4(x.x * y.x, x.y * y.y, x.z * y.z, x.w * y.w);
}

__device__ __forceinline__ unsigned long long ld_acquire(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];\n"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

// The lane's four channels w .. w+3 of one row; `fill` past W. a and b are
// read once: `stream` loads them evict-first (.cs), as h is stored.
__device__ __forceinline__ float ld1(const float* p, bool stream) {
  return stream ? __ldcs(p) : __ldg(p);
}

template <bool kVec>
__device__ __forceinline__ float4 load4(const float* row, int w, int W,
                                        float fill, bool stream) {
  float4 v = make_float4(fill, fill, fill, fill);
  if (kVec) {
    const float4* p = reinterpret_cast<const float4*>(row + w);
    if (w < W) v = stream ? __ldcs(p) : __ldg(p);
  } else {
    if (w < W) v.x = ld1(row + w, stream);
    if (w + 1 < W) v.y = ld1(row + w + 1, stream);
    if (w + 2 < W) v.z = ld1(row + w + 2, stream);
    if (w + 3 < W) v.w = ld1(row + w + 3, stream);
  }
  return v;
}

template <bool kVec>
__device__ __forceinline__ void store4(float* row, int w, int W, float4 v) {
  if (kVec) {
    if (w < W) __stcs(reinterpret_cast<float4*>(row + w), v);
  } else {
    if (w < W) __stcs(row + w, v.x);
    if (w + 1 < W) __stcs(row + w + 1, v.y);
    if (w + 2 < W) __stcs(row + w + 2, v.z);
    if (w + 3 < W) __stcs(row + w + 3, v.w);
  }
}

// 16 bytes global -> shared, through L2 (cp.async.cg), and the wait for
// this thread's copies.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// The scan warps' barrier (named barrier 1); the carry warp is not in it.
__device__ __forceinline__ void scan_warps_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"r"(kWarps * 32) : "memory");
}

// kRev: the reverse scan of the backward (see the header's last part).
// Its chunk c, warp and step s name virtual step u = c * kChunk + warp *
// kSteps + s, real step t = T - 1 - u; everything else is the forward's.
template <bool kVec, bool kRev>
__global__ void __launch_bounds__(kThreads, 2)
rglru_scan_kernel(Args g) {
  __shared__ float4 s_p[kWarps][32], s_h[kWarps][32];   // warps' aggregates
  __shared__ float4 s_carry[32];
  __shared__ float4 s_agg[kStage][2][32];   // the carry warp's P_j, H_j
  __shared__ unsigned s_ticket;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) s_ticket = atomicAdd(g.ticket, 1u);
  __syncthreads();
  const int tk = static_cast<int>(s_ticket);
  const int per_chunk = g.B * g.ntw;
  const int c = tk / per_chunk, bb = tk % per_chunk / g.ntw,
            wt = tk % g.ntw;
  const int w = wt * kTile + 4 * lane;
  const int t0 = c * kChunk + warp * kSteps;
  const long long row0 = static_cast<long long>(bb) * g.T * g.W;
  float4 P[kSteps], H[kSteps];

  if (warp == kWarps) {
    // (3) the carry warp: h0 with chunks 0 .. c-1 folded in, in chunk order,
    // once their done bits are set, while the scan warps load and scan
    const int first = bb * g.nc * g.ntw + wt;       // chunk 0 of this tile
    float4 carry = make_float4(0.f, 0.f, 0.f, 0.f);   // g_T = 0
    if (!kRev)
      carry = load4<kVec>(g.h0 + static_cast<long long>(bb) * g.W, w, g.W,
                          0.f, false);
    const unsigned long long* done =
        g.done + static_cast<long long>(bb * g.ntw + wt) * g.nm;
    for (int j = 0; j < c;) {
      // chunks j .. j+ready-1 are published: the set bits from bit j % 64
      // of word j / 64 (an acquire load, one for the warp)
      const unsigned long long clear =
          ~(ld_acquire(done + j / 64) >> (j % 64));
      const int ready = min(clear ? __ffsll(clear) - 1 : 64, c - j);
      if (ready == 0) {
        __nanosleep(100);
        continue;
      }
      // their aggregates through shared memory, up to kStage at a time:
      // one round trip to L2 for each kStage chunks
      for (const int end = j + ready; j < end;) {
        const int n = min(kStage, end - j);
        for (int k = 0; k < n; ++k) {
          const long long at =
              static_cast<long long>(first + (j + k) * g.ntw) * 32 + lane;
          cp_async16(&s_agg[k][0][lane], g.agg_p + at);
          cp_async16(&s_agg[k][1][lane], g.agg_h + at);
        }
        cp_async_wait_all();
        for (int k = 0; k < n; ++k)
          carry = fma4(s_agg[k][0][lane], carry, s_agg[k][1][lane]);
        j += n;
      }
    }
    s_carry[lane] = carry;
  } else {
    // (1) every load of the warp's steps first: P <- a, H <- b (the
    // reverse scan: P <- a_{t+1}, 1 past the last step, H <- dh_t)
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      if (t0 + s < g.T) {
        const int t = kRev ? g.T - 1 - (t0 + s) : t0 + s;
        const long long off = row0 + static_cast<long long>(t) * g.W;
        if (!kRev)
          P[s] = load4<kVec>(g.a + off, w, g.W, 1.f, true);
        else if (t + 1 < g.T)
          P[s] = load4<kVec>(g.a + off + g.W, w, g.W, 1.f, true);
        else
          P[s] = make_float4(1.f, 1.f, 1.f, 1.f);
        H[s] = load4<kVec>(g.b + off, w, g.W, 0.f, true);
      } else {
        P[s] = make_float4(1.f, 1.f, 1.f, 1.f);
        H[s] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
    // (2) the warp's scan from zero, then the earlier warps' prefix
#pragma unroll
    for (int s = 1; s < kSteps; ++s) {
      H[s] = fma4(P[s], H[s - 1], H[s]);
      P[s] = mul4(P[s], P[s - 1]);
    }
    s_p[warp][lane] = P[kSteps - 1];
    s_h[warp][lane] = H[kSteps - 1];
    scan_warps_sync();
    if (warp > 0) {
      float4 pw = s_p[0][lane], hw = s_h[0][lane];
      for (int j = 1; j < warp; ++j) {
        hw = fma4(s_p[j][lane], hw, s_h[j][lane]);
        pw = mul4(s_p[j][lane], pw);
      }
#pragma unroll
      for (int s = 0; s < kSteps; ++s) {
        H[s] = fma4(P[s], hw, H[s]);
        P[s] = mul4(P[s], pw);
      }
    }
    // the last scan warp publishes the chunk aggregate, then its bit
    if (warp == kWarps - 1 && c + 1 < g.nc) {
      const long long mine = (bb * g.nc + c) * g.ntw + wt;
      g.agg_p[mine * 32 + lane] = P[kSteps - 1];
      g.agg_h[mine * 32 + lane] = H[kSteps - 1];
      __threadfence();
      __syncwarp();
      if (lane == 0)
        atomicOr(g.done + static_cast<long long>(bb * g.ntw + wt) * g.nm +
                     c / 64,
                 1ull << (c % 64));
    }
  }
  __syncthreads();
  // (4) every output once
  if (warp < kWarps && !kRev) {
    const float4 carry = s_carry[lane];
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      if (t0 + s < g.T)
        store4<kVec>(g.h + row0 + static_cast<long long>(t0 + s) * g.W, w,
                     g.W, fma4(P[s], carry, H[s]));
    }
  } else if (warp < kWarps) {
    // (5) the reverse scan's epilogue: g_t, then h_{t-1} (h0 at t = 0),
    // all loads first: db_t = g_t, da_t = g_t h_{t-1}; dh0 = a_0 g_0
    const float4 carry = s_carry[lane];
    float4 hp[kSteps];
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      H[s] = fma4(P[s], carry, H[s]);
      const int t = g.T - 1 - (t0 + s);
      if (t0 + s < g.T)
        hp[s] = t > 0 ? load4<kVec>(g.hf + row0 + static_cast<long long>(
                                                   t - 1) * g.W,
                                    w, g.W, 0.f, true)
                      : load4<kVec>(g.h0 + static_cast<long long>(bb) * g.W,
                                    w, g.W, 0.f, false);
    }
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      const int t = g.T - 1 - (t0 + s);
      if (t0 + s >= g.T) continue;
      const long long off = row0 + static_cast<long long>(t) * g.W;
      store4<kVec>(g.h + off, w, g.W, H[s]);
      store4<kVec>(g.da + off, w, g.W, mul4(H[s], hp[s]));
      if (t == 0)
        store4<kVec>(g.dh0 + static_cast<long long>(bb) * g.W, w, g.W,
                     mul4(load4<kVec>(g.a + row0, w, g.W, 0.f, false),
                          H[s]));
    }
  }
}

long long tiles(int B, int T, int W) {
  return static_cast<long long>(B) * ((T + kChunk - 1) / kChunk) *
         ((W + kTile - 1) / kTile);
}

// 64-bit words of the done bits: one run of ceil(nc / 64) per column.
long long done_words(int B, int T, int W) {
  return static_cast<long long>(B) * ((W + kTile - 1) / kTile) *
         ((T + 64 * kChunk - 1) / (64 * kChunk));
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

long long ws_bytes_of(int B, int T, int W) {
  return tiles(B, T, W) * 2 * kTile * sizeof(float) +
         (done_words(B, T, W) + 1) * sizeof(unsigned long long);
}

// Both launchers: the shape and workspace checks, the workspace carved and
// its done words and ticket zeroed, then the kernel (float4 path where
// every row is whole 16-byte segments).
template <bool kRev>
int launch(Args g, void* ws, long long ws_bytes, int B, int T, int W,
           const void* const* ptrs, int nptrs, cudaStream_t st) {
  if (B < 1 || T < 1 || W < 1 || tiles(B, T, W) > INT_MAX ||
      ws_bytes < ws_bytes_of(B, T, W) || !aligned16(ws))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n = static_cast<int>(tiles(B, T, W));
  g.agg_p = static_cast<float4*>(ws);
  g.agg_h = g.agg_p + static_cast<long long>(n) * 32;
  g.done = reinterpret_cast<unsigned long long*>(
      g.agg_h + static_cast<long long>(n) * 32);
  const long long words = done_words(B, T, W);
  g.ticket = reinterpret_cast<unsigned*>(g.done + words);
  g.B = B;
  g.T = T;
  g.W = W;
  g.nc = (T + kChunk - 1) / kChunk;
  g.ntw = (W + kTile - 1) / kTile;
  g.nm = (g.nc + 63) / 64;
  cudaError_t err = cudaMemsetAsync(
      g.done, 0, (words + 1) * sizeof(unsigned long long), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  bool vec = W % 4 == 0;
  for (int i = 0; i < nptrs; ++i) vec = vec && aligned16(ptrs[i]);
  if (vec)
    rglru_scan_kernel<true, kRev><<<n, kThreads, 0, st>>>(g);
  else
    rglru_scan_kernel<false, kRev><<<n, kThreads, 0, st>>>(g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Bytes of the workspace `rglru_scan_launch` and `rglru_scan_bwd_launch`
// need for this shape.
extern "C" long long rglru_scan_ws_bytes(int B, int T, int W) {
  return ws_bytes_of(B, T, W);
}

// a, b, h: contiguous [B, T, W] f32; h0: contiguous [B, W] f32; ws: at
// least rglru_scan_ws_bytes(B, T, W) bytes, 16-byte aligned.
extern "C" int rglru_scan_launch(const void* a, const void* b, const void* h0,
                                 void* h, void* ws, long long ws_bytes, int B,
                                 int T, int W, void* stream) {
  Args g = {};
  g.a = static_cast<const float*>(a);
  g.b = static_cast<const float*>(b);
  g.h0 = static_cast<const float*>(h0);
  g.h = static_cast<float*>(h);
  const void* ptrs[] = {a, b, h0, h};
  return launch<false>(g, ws, ws_bytes, B, T, W, ptrs, 4,
                       static_cast<cudaStream_t>(stream));
}

// The backward's reverse scan: from a, the forward's h, h0 and dh (the
// gradient of h; its last row carries the final state's) -> da, db [B, T,
// W] and dh0 [B, W], all contiguous f32; ws as for rglru_scan_launch.
extern "C" int rglru_scan_bwd_launch(const void* a, const void* h,
                                     const void* h0, const void* dh, void* da,
                                     void* db, void* dh0, void* ws,
                                     long long ws_bytes, int B, int T, int W,
                                     void* stream) {
  Args g = {};
  g.a = static_cast<const float*>(a);
  g.b = static_cast<const float*>(dh);
  g.h0 = static_cast<const float*>(h0);
  g.h = static_cast<float*>(db);
  g.hf = static_cast<const float*>(h);
  g.da = static_cast<float*>(da);
  g.dh0 = static_cast<float*>(dh0);
  const void* ptrs[] = {a, h, h0, dh, da, db, dh0};
  return launch<true>(g, ws, ws_bytes, B, T, W, ptrs, 7,
                      static_cast<cudaStream_t>(stream));
}
