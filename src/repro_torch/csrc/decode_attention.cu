// One-token GQA decode attention over a ring / linear cache or a paged KV
// pool, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_dec_kernel` in
// src/repro/kernels/decode_attention/kernel.py (launched by
// `decode_attention_pallas`), and fuses the XLA page gather of
// `paged_decode_attention` (src/repro/kernels/decode_attention/ops.py) into
// the kernel: the paged entry walks the block table itself.
//
// Interface (plain C, loaded with ctypes; see kernels/decode_attention/kernel.py):
//   decode_attention_fwd(q, q strides (b, h), k, k strides (b, kvh, s), v, v strides,
//                        pos, o, B, H, KV, S, hd, window, scale, stream)
//     caches [B, KV, S, hd] (ring buffers: slot i holds absolute position
//     last - ((last - i) mod S), last = pos[b] - 1);
//   paged_decode_attention_fwd(q, q strides (b, h), k_pool, v_pool, tables,
//                              table row stride, T_blk, NB, BS, pos, o,
//                              B, H, KV, hd, window, scale, stream)
//     pools [NB, BS, KV, hd] contiguous; tables i32[B, T_blk] of page ids
//     (page 0 is the null page); row b's linear slot i lives at page
//     tables[b][i / BS], offset i % BS.  Out-of-range page ids are clamped,
//     as XLA's gather clamps them.
//   q [B, H, 1, hd] f32 with unit stride on hd, pos i32[B] (tokens written,
//   current one included), o a fresh contiguous [B, H, 1, hd] f32.  A key is
//   valid when 0 <= k_pos <= pos - 1 (and pos - 1 - k_pos < window when
//   window >= 0); a row with no valid key (pos = 0) outputs exactly 0.
//
// Bound: memory.  At the serving decode shape (q [8, 32, 1, 128], pools
// [65, 16, 8, 128], 8 pages per row) a launch reads at most 8.4 MB of K/V
// (2.5 us at 3.35 TB/s) and does 4 FLOP per key element, far below the
// compute roof.  Only valid keys are read, so dead rows (pos = 0) cost
// nothing but their zero output.
//
// Design, simple first: one block of 128 threads per (head, batch row).
// Pass 1: each warp takes every 4th key; its lanes split hd, and a butterfly
// of shuffles sums the dot.  Scores sit in shared memory.  Pass 2: block max
// (clamped at -0.5e30) and the denominator.  Pass 3: each thread owns output
// columns and accumulates p * v over the valid keys in key order.  The
// contiguous and the paged entries share this one device function and differ
// only in how a key row is addressed, so paged equals gather-plus-contiguous
// bitwise on the card; every product-sum is an explicit fmaf so the compiler
// cannot contract the two instantiations differently.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;
constexpr float kMaxFloor = -0.5e30f;

struct DenseRows {
  const float* k;
  const float* v;
  long long ksb, ksh, kss, vsb, vsh, vss;
  __device__ const float* krow(int b, int kvh, int i) const {
    return k + b * ksb + kvh * ksh + i * kss;
  }
  __device__ const float* vrow(int b, int kvh, int i) const {
    return v + b * vsb + kvh * vsh + i * vss;
  }
};

struct PagedRows {
  const float* k;
  const float* v;
  const int* tables;
  long long tsb;
  int NB, BS, KV, hd;
  __device__ long long offset(int b, int kvh, int i) const {
    int page = tables[b * tsb + i / BS];
    page = min(max(page, 0), NB - 1);
    return (((long long)page * BS + i % BS) * KV + kvh) * hd;
  }
  __device__ const float* krow(int b, int kvh, int i) const { return k + offset(b, kvh, i); }
  __device__ const float* vrow(int b, int kvh, int i) const { return v + offset(b, kvh, i); }
};

__device__ __forceinline__ bool key_valid(int i, int last, int S, int window) {
  const int wrapped = ((last - i) % S + S) % S;  // floor mod, as jnp.mod
  const int kp = last - wrapped;
  return kp >= 0 && kp <= last && (window < 0 || last - kp < window);
}

template <typename Rows>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const float* __restrict__ q, long long qsb, long long qsh, Rows rows,
              const int* __restrict__ pos, float* __restrict__ o, int H, int group, int S,
              int hd, int window, float scale) {
  extern __shared__ float smem[];
  float* sq = smem;       // [hd]
  float* ss = smem + hd;  // [S] scores, then probabilities
  __shared__ float red[kWarps];

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int kvh = h / group;
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int last = pos[b] - 1;

  const float* qrow = q + b * qsb + h * qsh;
  for (int d = tid; d < hd; d += kThreads) sq[d] = qrow[d] * scale;
  __syncthreads();

  // pass 1: scores
  for (int i = warp; i < S; i += kWarps) {
    float s = kNegInf;
    if (key_valid(i, last, S, window)) {
      const float* kr = rows.krow(b, kvh, i);
      float part = 0.f;
      for (int d = lane; d < hd; d += 32) part = __fmaf_rn(sq[d], kr[d], part);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
      s = part;
    }
    if (lane == 0) ss[i] = s;
  }
  __syncthreads();

  // pass 2: max (clamped), probabilities, denominator
  float mx = kNegInf;
  for (int i = tid; i < S; i += kThreads) mx = fmaxf(mx, ss[i]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  if (lane == 0) red[warp] = mx;
  __syncthreads();
  mx = kMaxFloor;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, red[w]);
  __syncthreads();  // red is reused below

  float sum = 0.f;
  for (int i = tid; i < S; i += kThreads) {
    const float p = expf(ss[i] - mx);
    ss[i] = p;
    sum += p;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (lane == 0) red[warp] = sum;
  __syncthreads();
  float l = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) l += red[w];
  const float denom = fmaxf(l, 1e-30f);

  // pass 3: p @ v over the valid keys, in key order
  float* orow = o + ((long long)b * H + h) * hd;
  for (int d = tid; d < hd; d += kThreads) {
    float acc = 0.f;
    for (int i = 0; i < S; ++i) {
      if (key_valid(i, last, S, window)) acc = __fmaf_rn(ss[i], rows.vrow(b, kvh, i)[d], acc);
    }
    orow[d] = acc / denom;
  }
}

bool bad_shape(int B, int H, int KV, int S, int hd) {
  return B <= 0 || H <= 0 || KV <= 0 || S <= 0 || hd <= 0 || H % KV || B > 65535 ||
         (size_t)(S + hd) * sizeof(float) > 48 * 1024;
}

}  // namespace

extern "C" int decode_attention_fwd(const float* q, long long qsb, long long qsh, const float* k,
                                    long long ksb, long long ksh, long long kss, const float* v,
                                    long long vsb, long long vsh, long long vss, const int* pos,
                                    float* o, int B, int H, int KV, int S, int hd, int window,
                                    float scale, void* stream) {
  if (bad_shape(B, H, KV, S, hd)) return (int)cudaErrorInvalidValue;
  const DenseRows rows{k, v, ksb, ksh, kss, vsb, vsh, vss};
  const size_t smem = (size_t)(S + hd) * sizeof(float);
  decode_kernel<DenseRows><<<dim3(H, B), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      q, qsb, qsh, rows, pos, o, H, H / KV, S, hd, window, scale);
  return (int)cudaGetLastError();
}

extern "C" int paged_decode_attention_fwd(const float* q, long long qsb, long long qsh,
                                          const float* k_pool, const float* v_pool,
                                          const int* tables, long long tsb, int T_blk, int NB,
                                          int BS, const int* pos, float* o, int B, int H, int KV,
                                          int hd, int window, float scale, void* stream) {
  if (T_blk <= 0 || NB <= 0 || BS <= 0) return (int)cudaErrorInvalidValue;
  const int S = T_blk * BS;
  if (bad_shape(B, H, KV, S, hd)) return (int)cudaErrorInvalidValue;
  const PagedRows rows{k_pool, v_pool, tables, tsb, NB, BS, KV, hd};
  const size_t smem = (size_t)(S + hd) * sizeof(float);
  decode_kernel<PagedRows><<<dim3(H, B), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      q, qsb, qsh, rows, pos, o, H, H / KV, S, hd, window, scale);
  return (int)cudaGetLastError();
}
