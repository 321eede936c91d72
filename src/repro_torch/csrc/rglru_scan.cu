// RG-LRU linear-recurrence scan h_t = a_t * h_{t-1} + b_t, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_rglru_kernel` in
// src/repro/kernels/rglru_scan/kernel.py (launched by `rglru_scan_pallas`).
//
// Interface (plain C, loaded with ctypes; see kernels/rglru_scan/kernel.py):
//   rglru_scan_fwd(a, a strides (b, t), b, b strides (b, t), h0, h0 stride (b),
//                  hs, h_last, B, T, L, stream)
//     a, b f32 [B, T, L] with unit stride on L (any batch and time strides);
//     h0 f32 [B, L] with unit stride on L, or null for zeros; hs a fresh
//     contiguous f32 [B, T, L], h_last a fresh contiguous f32 [B, L].
//
// Bound: memory.  Each element of a and b is read once and each h_t written
// once: 12 bytes and 2 FLOP per (b, t, channel).  At the serving prefill
// shape [4, 128, 4096] that is 25 MB, 7.5 us at 3.35 TB/s.
//
// Design, simple first: one thread per (batch row, channel) holds h in a
// register and walks T in order; neighbouring threads own neighbouring
// channels, so every load of a[b, t, :] and b[b, t, :] and every store of
// hs[b, t, :] is coalesced.  The loads of a step do not depend on h, so the
// unrolled loop keeps several steps' loads in flight.  The channel blocks
// are independent (the reference's TPU grid over 128-lane stripes); the last
// block is bounds-checked, so L needs no padding.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
rglru_scan_kernel(const float* __restrict__ a, long long asb, long long ast,
                  const float* __restrict__ bx, long long bsb, long long bst,
                  const float* __restrict__ h0, long long hsb, float* __restrict__ hs,
                  float* __restrict__ h_last, int T, int L) {
  const int l = blockIdx.x * kThreads + threadIdx.x;
  const int b = blockIdx.y;
  if (l >= L) return;
  const float* ap = a + b * asb + l;
  const float* bp = bx + b * bsb + l;
  float* op = hs + (long long)b * T * L + l;
  float h = h0 ? h0[b * hsb + l] : 0.f;
#pragma unroll 8
  for (int t = 0; t < T; ++t) {
    h = ap[t * ast] * h + bp[t * bst];
    op[(long long)t * L] = h;
  }
  h_last[(long long)b * L + l] = h;
}

}  // namespace

extern "C" int rglru_scan_fwd(const float* a, long long asb, long long ast, const float* b,
                              long long bsb, long long bst, const float* h0, long long hsb,
                              float* hs, float* h_last, int B, int T, int L, void* stream) {
  if (B <= 0 || T <= 0 || L <= 0 || B > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((L + kThreads - 1) / kThreads, B);
  rglru_scan_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a, asb, ast, b, bsb, bst, h0, hsb, hs, h_last, T, L);
  return (int)cudaGetLastError();
}
