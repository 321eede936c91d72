// RG-LRU linear-recurrence scan h_t = a_t * h_{t-1} + b_t, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_rglru_kernel` in
// src/repro/kernels/rglru_scan/kernel.py (launched by `rglru_scan_pallas`).
//
// Interface (plain C, loaded with ctypes; see kernels/rglru_scan/kernel.py):
//   rglru_scan_fwd(a, a strides (b, t), b, b strides (b, t), h0, h0 stride (b),
//                  hs, h_last, B, T, L, P, S, V, stream)
//     a, b f32 [B, T, L] with unit stride on L (any batch and time strides);
//     h0 f32 [B, L] with unit stride on L, or null for zeros; hs a fresh
//     contiguous f32 [B, T, L], h_last a fresh contiguous f32 [B, L].
//     P segments of S steps and V channels a thread, as `plan` and
//     `vector_width` in kernels/rglru_scan/kernel.py choose them.
//
// Bound: memory.  Each element of a and b is read once and each h_t written
// once: 12 bytes and 2 FLOP per (b, t, channel).  At the serving prefill
// shape [4, 128, 4096] that is 25 MB, 7.5 us at 3.35 TB/s.
//
// Design, T > 1: a time-segmented two-level scan in one launch.  A block
// owns a stripe of 128 channels of one batch row (V = 4, one float4 a
// thread, where L and the strides allow; else 1 and, with P > 1, a stripe
// of 32) and splits a tile of P S steps into P segments, one warp each; thread
// (p, lane) owns segment p of its channels.  Each thread issues all of its
// segment's loads of a and b at once, into registers (S <= 16 steps),
// computes the segment's pair (A = prod a, H = the scan from 0), and writes
// it to shared memory.  After one barrier, each thread folds the pairs of the segments before its own,
// in order, from the carried h (h0 or 0): h_in = A h + H.  It replays its
// segment from h_in and stores h_t, coalesced over channels.  The last
// segment's final h is the carry into the next tile (T > P S loops over
// tiles) and, at the end, h_last.  So a and b are read once and hs written
// once, with every load of a segment in flight together.
//
// T = 1 (decode, the plan's P = 1, S = 1): one step of one channel a thread
// in blocks of 128, the shape before the redesign, as its own kernel: it is
// at the launch floor, and the segmented kernel with P = 1 (one float4 or
// one channel a thread) measured slower there on the H100.
//
// The fold reassociates h = A h_in + H across segments, so h_in rounds
// differently from the step-by-step loop (within the 1e-5 tolerance); the
// steps inside a segment are replayed one by one.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kStripe = 128;      // channels a block (at most)
constexpr int kMaxSegments = 8;   // MAX_SEGMENTS in kernels/rglru_scan/kernel.py
constexpr int kSegmentSteps = 16; // SEGMENT_STEPS there: the register depth

template <int V>
__device__ __forceinline__ void load(float (&x)[V], const float* p) {
  if constexpr (V == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    x[0] = q.x, x[1] = q.y, x[2] = q.z, x[3] = q.w;
  } else {
    x[0] = *p;
  }
}

template <int V>
__device__ __forceinline__ void store(float* p, const float (&x)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  } else {
    *p = x[0];
  }
}

__global__ void __launch_bounds__(kStripe)
rglru_step_kernel(const float* __restrict__ a, long long asb, const float* __restrict__ bx,
                  long long bsb, const float* __restrict__ h0, long long hsb,
                  float* __restrict__ hs, float* __restrict__ h_last, int L) {
  const int l = blockIdx.x * kStripe + threadIdx.x;
  const int b = blockIdx.y;
  if (l >= L) return;
  const float h = h0 ? h0[b * hsb + l] : 0.f;
  const float out = a[b * asb + l] * h + bx[b * bsb + l];
  hs[(long long)b * L + l] = out;
  h_last[(long long)b * L + l] = out;
}

template <int V>
__global__ void __launch_bounds__(32 * kMaxSegments)
rglru_scan_kernel(const float* __restrict__ a, long long asb, long long ast,
                  const float* __restrict__ bx, long long bsb, long long bst,
                  const float* __restrict__ h0, long long hsb, float* __restrict__ hs,
                  float* __restrict__ h_last, int T, int L, int S) {
  __shared__ float pair_a[kMaxSegments][kStripe];
  __shared__ float pair_h[kMaxSegments][kStripe];
  __shared__ float carry_sm[kStripe];
  const int lane = threadIdx.x, p = threadIdx.y, P = blockDim.y;
  const int l = (blockIdx.x * blockDim.x + lane) * V;  // first channel of this thread
  const int b = blockIdx.y;
  const int cl = lane * V;                         // its slot in the pair arrays
  const bool live = l < L;                         // V = 4 only when L % 4 == 0
  const float* ap = a + b * asb + l;
  const float* bp = bx + b * bsb + l;

  float h[V];
  if (h0 && live) {
    load<V>(h, h0 + b * hsb + l);
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v) h[v] = 0.f;
  }

  for (int t0 = 0; t0 < T; t0 += P * S) {
    const int ts = t0 + p * S;
    const int n = max(0, min(S, T - ts));
    float xa[kSegmentSteps][V], xb[kSegmentSteps][V];
#pragma unroll
    for (int i = 0; i < kSegmentSteps; ++i) {
      if (i < n && live) {
        load<V>(xa[i], ap + (ts + i) * ast);
        load<V>(xb[i], bp + (ts + i) * bst);
      }
    }
    if (P > 1) {
      float A[V], H[V];
#pragma unroll
      for (int v = 0; v < V; ++v) A[v] = 1.f, H[v] = 0.f;
#pragma unroll
      for (int i = 0; i < kSegmentSteps; ++i) {
        if (i < n) {
#pragma unroll
          for (int v = 0; v < V; ++v) {
            A[v] *= xa[i][v];
            H[v] = fmaf(xa[i][v], H[v], xb[i][v]);
          }
        }
      }
#pragma unroll
      for (int v = 0; v < V; ++v) pair_a[p][cl + v] = A[v], pair_h[p][cl + v] = H[v];
      __syncthreads();
      for (int q = 0; q < p; ++q) {
#pragma unroll
        for (int v = 0; v < V; ++v) h[v] = fmaf(pair_a[q][cl + v], h[v], pair_h[q][cl + v]);
      }
    }
    float* op = hs + ((long long)b * T + ts) * L + l;
#pragma unroll
    for (int i = 0; i < kSegmentSteps; ++i) {
      if (i < n) {
#pragma unroll
        for (int v = 0; v < V; ++v) h[v] = fmaf(xa[i][v], h[v], xb[i][v]);
        if (live) store<V>(op + (long long)i * L, h);
      }
    }
    if (P > 1) {  // the last nonempty segment's h carries into the next tile
      const int last = min(P, (T - t0 + S - 1) / S) - 1;
      if (p == last) {
#pragma unroll
        for (int v = 0; v < V; ++v) carry_sm[cl + v] = h[v];
      }
      __syncthreads();
#pragma unroll
      for (int v = 0; v < V; ++v) h[v] = carry_sm[cl + v];
    }
  }
  if (p == 0 && live) store<V>(h_last + (long long)b * L + l, h);
}

template <int V>
int launch(const float* a, long long asb, long long ast, const float* b, long long bsb,
           long long bst, const float* h0, long long hsb, float* hs, float* h_last, int B,
           int T, int L, int P, int S, cudaStream_t stream) {
  // a stripe of 128 channels, but of 32 lanes when a tile has segments
  const int lanes = P == 1 ? kStripe / V : 32;
  const dim3 grid((L + lanes * V - 1) / (lanes * V), B), block(lanes, P);
  rglru_scan_kernel<V><<<grid, block, 0, stream>>>(a, asb, ast, b, bsb, bst, h0, hsb, hs, h_last,
                                                 T, L, S);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

extern "C" int rglru_scan_fwd(const float* a, long long asb, long long ast, const float* b,
                              long long bsb, long long bst, const float* h0, long long hsb,
                              float* hs, float* h_last, int B, int T, int L, int P, int S,
                              int V, void* stream) {
  if (B <= 0 || T <= 0 || L <= 0 || B > 65535 || P < 1 || P > kMaxSegments || S < 1 ||
      S > kSegmentSteps || (V != 1 && V != 4))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (T == 1) {
    rglru_step_kernel<<<dim3((L + kStripe - 1) / kStripe, B), kStripe, 0, st>>>(
        a, asb, b, bsb, h0, hsb, hs, h_last, L);
    return (int)cudaGetLastError();
  }
  if (V == 1) return launch<1>(a, asb, ast, b, bsb, bst, h0, hsb, hs, h_last, B, T, L, P, S, st);
  const bool whole = L % 4 == 0 && aligned16(a) && aligned16(b) && asb % 4 == 0 &&
                     ast % 4 == 0 && bsb % 4 == 0 && bst % 4 == 0 &&
                     (!h0 || (aligned16(h0) && hsb % 4 == 0));
  if (!whole) return (int)cudaErrorInvalidValue;
  return launch<4>(a, asb, ast, b, bsb, bst, h0, hsb, hs, h_last, B, T, L, P, S, st);
}
