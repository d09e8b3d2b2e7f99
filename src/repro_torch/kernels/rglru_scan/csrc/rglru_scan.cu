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
// 3.35 TB/s.
//
// Design (simple and right first): one thread per (b, w) channel walks T in
// order, neighbouring threads on neighbouring w so every load and store of
// a warp is one coalesced 128-byte line; each thread loads kDepth steps of a
// and b into registers before it folds them in, so kDepth loads are in
// flight per thread. Its weakness: at B 1 and W 2560 the grid is only 20
// blocks of 128 threads on 132 SMs, so the card's memory system sees a
// fraction of the loads it could keep in flight and the kernel is latency-
// bound, far from its bound. The fix, a chunk-parallel two-pass scan over T
// (each block scans one T-chunk from zero, then the chunk carries are
// composed and applied), is the first item of work on this kernel.
//
// C interface (loaded with ctypes): the launcher returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue for a bad shape.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kDepth = 16;     // steps of a and b loaded ahead per thread

__global__ void __launch_bounds__(kThreads)
rglru_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  const float* __restrict__ h0, float* __restrict__ h, int T,
                  int W) {
  const int w = blockIdx.x * kThreads + threadIdx.x;
  if (w >= W) return;
  const long long row = static_cast<long long>(blockIdx.y) * T * W + w;
  float hv = h0[static_cast<long long>(blockIdx.y) * W + w];
  for (int t0 = 0; t0 < T; t0 += kDepth) {
    float av[kDepth], bv[kDepth];
#pragma unroll
    for (int d = 0; d < kDepth; ++d) {
      if (t0 + d < T) {
        const long long off = row + static_cast<long long>(t0 + d) * W;
        av[d] = a[off];
        bv[d] = b[off];
      }
    }
#pragma unroll
    for (int d = 0; d < kDepth; ++d) {
      if (t0 + d < T) {
        hv = fmaf(av[d], hv, bv[d]);
        h[row + static_cast<long long>(t0 + d) * W] = hv;
      }
    }
  }
}

}  // namespace

// a, b, h: contiguous [B, T, W] f32; h0: contiguous [B, W] f32.
extern "C" int rglru_scan_launch(const void* a, const void* b, const void* h0,
                                 void* h, int B, int T, int W, void* stream) {
  if (B < 1 || B > 65535 || T < 1 || W < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((W + kThreads - 1) / kThreads, B);
  rglru_scan_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(h0), static_cast<float*>(h), T, W);
  return static_cast<int>(cudaGetLastError());
}
