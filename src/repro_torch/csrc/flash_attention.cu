// Causal / windowed GQA flash attention (forward) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_fa_kernel` in
// src/repro/kernels/flash_attention/kernel.py (launched by
// `flash_attention_pallas`): the prefill attention of the attention-LM
// serving path, one C-wide query segment against the K/V cache filled so far.
//
// Interface (plain C, loaded with ctypes; see kernels/flash_attention/kernel.py):
//   flash_attention_fwd(q, q strides (b, h, t), k, k strides (b, kvh, s),
//                       v, v strides (b, kvh, s), o, B, H, KV, T, S, hd,
//                       q_offset, causal, window, scale, bf16, stream)
//   q [B, H, T, hd], k/v [B, KV, S, hd] with any element strides on the first
//   three dims and unit stride on hd; o is a fresh contiguous [B, H, T, hd].
//   q_offset is the absolute position of query row 0 (a runtime int, never a
//   compile-time constant); window < 0 means no sliding window.  The launch
//   goes on the caller's stream and the function returns cudaGetLastError().
//
// Bound: at the serving prefill shape (q [4, 32, 16, 128], k/v [4, 8, 128,
// 128], f32) one launch moves about 6.3 MB (1.9 us at 3.35 TB/s) and does
// at most 134 MFLOP (2.0 us at 67 TFLOP/s f32): both bounds are close, and
// the causal mask removes up to 7/8 of the work on early segments.
//
// Design, simple first: one block of 128 threads per (query tile of 16 rows,
// head, batch); GQA reads kv head h / (H / KV).  Key/value tiles of 32 rows
// go through shared memory as f32; every query row is owned by 8 threads,
// which keep the running max, denominator and a 16-wide slice of the f32
// accumulator in registers (online softmax).  Tiles wholly past the causal
// limit or before the window are skipped: every key in them is masked for
// every row of the block, so they would add exactly 0.  No tensor cores yet
// (`wgmma`/TMA are later work).
//
// Numerics follow the Pallas kernel: q is scaled before the dot, masked
// scores are -1e30, the running max is clamped at -0.5e30 and the
// denominator floored at 1e-30, so a fully masked row outputs exactly 0.
// bf16 inputs are widened to f32 and the output is rounded to nearest.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 16;              // query rows per block
constexpr int kBK = 32;              // keys per shared-memory tile
constexpr int kMaxHd = 128;
constexpr int kThreads = 128;
constexpr int kTPR = kThreads / kBQ;  // threads per query row (8, one warp quarter)
constexpr float kNegInf = -1e30f;
constexpr float kMaxFloor = -0.5e30f;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void narrow(float* p, float x) { *p = x; }
__device__ __forceinline__ void narrow(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, long long qsb, long long qsh, long long qst,
                 const T* __restrict__ k, long long ksb, long long ksh, long long kss,
                 const T* __restrict__ v, long long vsb, long long vsh, long long vss,
                 T* __restrict__ o, int H, int group, int T_len, int S, int hd,
                 int q_offset, int causal, int window, float scale) {
  // +1 columns keep the q.k loop free of shared-memory bank conflicts
  __shared__ float sq[kBQ][kMaxHd + 1];
  __shared__ float sk[kBK][kMaxHd + 1];
  __shared__ float sv[kBK][kMaxHd];
  __shared__ float sp[kBQ][kBK + 1];

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / group;
  const int tid = threadIdx.x;
  const int r = tid / kTPR;  // this thread's query row in the tile
  const int c = tid % kTPR;  // its lane within the row's 8 threads

  const T* qb = q + b * qsb + h * qsh;
  const T* kb = k + b * ksb + kvh * ksh;
  const T* vb = v + b * vsb + kvh * vsh;

  for (int i = tid; i < kBQ * hd; i += kThreads) {
    const int rr = i / hd, d = i % hd;
    sq[rr][d] = (q0 + rr < T_len) ? widen(qb[(long long)(q0 + rr) * qst + d]) * scale : 0.f;
  }

  // keys any row of this block can see
  const int rows = min(kBQ, T_len - q0);
  const int qpos_lo = q_offset + q0;
  const int qpos_hi = q_offset + q0 + rows - 1;
  const int k_hi = causal ? min(S, qpos_hi + 1) : S;
  const int k_lo = window >= 0 ? max(0, qpos_lo - window + 1) : 0;

  const int qp = q_offset + q0 + r;
  float m = kNegInf, l = 0.f;
  float acc[kMaxHd / kTPR];
#pragma unroll
  for (int j = 0; j < kMaxHd / kTPR; ++j) acc[j] = 0.f;

  for (int kt = (k_lo / kBK) * kBK; kt < k_hi; kt += kBK) {
    __syncthreads();  // the previous tile is fully consumed (and sq is written)
    for (int i = tid; i < kBK * hd; i += kThreads) {
      const int kk = i / hd, d = i % hd, s = kt + kk;
      float kx = 0.f, vx = 0.f;
      if (s < S) {
        kx = widen(kb[(long long)s * kss + d]);
        vx = widen(vb[(long long)s * vss + d]);
      }
      sk[kk][d] = kx;
      sv[kk][d] = vx;
    }
    __syncthreads();

    // the thread's 4 keys advance together over d: 4 independent chains
    float sc[kBK / kTPR];
#pragma unroll
    for (int jj = 0; jj < kBK / kTPR; ++jj) sc[jj] = 0.f;
    for (int d = 0; d < hd; ++d) {
      const float qd = sq[r][d];
#pragma unroll
      for (int jj = 0; jj < kBK / kTPR; ++jj)
        sc[jj] = __fmaf_rn(qd, sk[c + kTPR * jj][d], sc[jj]);
    }
    float rmax = kNegInf;
#pragma unroll
    for (int jj = 0; jj < kBK / kTPR; ++jj) {
      const int kp = kt + c + kTPR * jj;
      bool ok = kp < S;
      if (causal) ok = ok && kp <= qp;
      if (window >= 0) ok = ok && qp - kp < window;
      sc[jj] = ok ? sc[jj] : kNegInf;
      rmax = fmaxf(rmax, sc[jj]);
    }
    // the row's 8 threads are 8 neighbouring lanes of one warp
#pragma unroll
    for (int off = kTPR / 2; off > 0; off >>= 1)
      rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, off));
    const float m_new = fmaxf(fmaxf(m, rmax), kMaxFloor);
    float psum = 0.f;
#pragma unroll
    for (int jj = 0; jj < kBK / kTPR; ++jj) {
      const float p = expf(sc[jj] - m_new);
      sp[r][c + kTPR * jj] = p;
      psum += p;
    }
#pragma unroll
    for (int off = kTPR / 2; off > 0; off >>= 1)
      psum += __shfl_xor_sync(0xffffffffu, psum, off);
    const float alpha = expf(m - m_new);
    l = l * alpha + psum;
    m = m_new;
    __syncwarp();  // sp[r][*] was written by lanes of this warp only

#pragma unroll
    for (int j = 0; j < kMaxHd / kTPR; ++j) acc[j] *= alpha;
    for (int kk = 0; kk < kBK; ++kk) {
      const float p = sp[r][kk];
#pragma unroll
      for (int j = 0; j < kMaxHd / kTPR; ++j) {
        const int d = c + kTPR * j;
        if (d < hd) acc[j] = __fmaf_rn(p, sv[kk][d], acc[j]);
      }
    }
  }

  if (q0 + r < T_len) {
    T* ob = o + (((long long)b * H + h) * T_len + q0 + r) * hd;
    const float denom = fmaxf(l, 1e-30f);
#pragma unroll
    for (int j = 0; j < kMaxHd / kTPR; ++j) {
      const int d = c + kTPR * j;
      if (d < hd) narrow(ob + d, acc[j] / denom);
    }
  }
}

}  // namespace

extern "C" int flash_attention_fwd(const void* q, long long qsb, long long qsh, long long qst,
                                   const void* k, long long ksb, long long ksh, long long kss,
                                   const void* v, long long vsb, long long vsh, long long vss,
                                   void* o, int B, int H, int KV, int T, int S, int hd,
                                   int q_offset, int causal, int window, float scale, int bf16,
                                   void* stream) {
  if (B <= 0 || H <= 0 || KV <= 0 || T <= 0 || S <= 0 || hd <= 0 || hd > kMaxHd || H % KV)
    return (int)cudaErrorInvalidValue;
  if (B > 65535 || H > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((T + kBQ - 1) / kBQ, H, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    flash_fwd_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(q), qsb, qsh, qst,
        static_cast<const __nv_bfloat16*>(k), ksb, ksh, kss,
        static_cast<const __nv_bfloat16*>(v), vsb, vsh, vss,
        static_cast<__nv_bfloat16*>(o), H, H / KV, T, S, hd, q_offset, causal, window, scale);
  } else {
    flash_fwd_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(q), qsb, qsh, qst, static_cast<const float*>(k), ksb, ksh, kss,
        static_cast<const float*>(v), vsb, vsh, vss, static_cast<float*>(o), H, H / KV, T, S, hd,
        q_offset, causal, window, scale);
  }
  return (int)cudaGetLastError();
}
