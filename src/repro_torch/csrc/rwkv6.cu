// RWKV-6 time-mix recurrence, for Hopper (sm_90a).  Per (batch row, head):
//     o_t = r_t . (S + (u * k_t) v_t^T)
//     S   = diag(w_t) S + k_t v_t^T,      w_t = exp(logw_t)
//
// Replaces the Pallas TPU kernel `_rwkv_kernel` in
// src/repro/kernels/rwkv6/kernel.py (launched by `rwkv6_pallas`).  It computes
// what that kernel computes; the reference wrapper's transposes to [B,H,T,hd]
// are TPU layout and are not carried over: the inputs are read in place by
// their strides.
//
// Interface (plain C, loaded with ctypes; see kernels/rwkv6/kernel.py):
//   rwkv6_fwd(r, k, v, logw, each with strides (b, t, h), u, u stride (h),
//             s0, s0 strides (b, h, i), o, s_last, B, T, H, hd, stream)
//     r, k, v, logw f32 [B, T, H, hd] with unit stride on hd; u f32 [H, hd]
//     with unit stride on hd; s0 f32 [B, H, hd, hd] with unit stride on the
//     last dim, or null for zeros; o a fresh contiguous f32 [B, T, H, hd],
//     s_last a fresh contiguous f32 [B, H, hd, hd].  hd <= 64.
//
// Bound: memory at the serving shapes.  Prefill [4, 128, 32, 64]: r, k, v,
// logw read once and o written once (21 MB), s_last written (2.1 MB): 6.9 us
// at 3.35 TB/s, against 5 FLOP per state element per step (readout FMA,
// decay-and-add), 5.0 us at 67 TFLOP/s f32.  Decode (T = 1) reads and writes
// the 2.1 MB state: 1.3 us.
//
// Design, simple first: one block per (head, batch row), one thread per value
// column j of the state, which thread j keeps in registers (HD floats, HD a
// compile-time cap of 16, 32 or 64; columns and rows past hd stay 0).  Each
// step, thread j stages (r_j, k_j, w_j, u_j k_j) as one float4 in shared
// memory, double-buffered so one barrier per step suffices, and issues the
// next step's loads before the barrier so their latency hides behind this
// step's arithmetic.  Then o_j = sum_i r_i (S_ij + u_i k_i v_j) over four
// partial sums (the order differs from the reference's; the tests allow
// 1e-4), and S_ij <- w_i S_ij + k_i v_j.

#include <cuda_runtime.h>

namespace {

struct Seq {  // one [B, T, H, hd] input read in place
  const float* p;
  long long sb, st, sh;
};

template <int HD>
__global__ void __launch_bounds__(HD)
rwkv6_kernel(Seq r, Seq k, Seq v, Seq lw, const float* __restrict__ u, long long ush,
             const float* __restrict__ s0, long long s0b, long long s0h, long long s0i,
             float* __restrict__ o, float* __restrict__ s_last, int T, int H, int hd) {
  __shared__ float4 stage[2][HD];  // (r_i, k_i, w_i, u_i k_i)
  const int j = threadIdx.x;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const bool live = j < hd;

  float s[HD];  // column j of the state: s[i] = S[i][j]
  const float* s0p = s0 ? s0 + b * s0b + h * s0h + j : nullptr;
#pragma unroll
  for (int i = 0; i < HD; ++i) s[i] = (s0p && live && i < hd) ? s0p[i * s0i] : 0.f;
  const float uj = live ? u[h * ush + j] : 0.f;

  const long long rb = b * r.sb + h * r.sh + j, kb = b * k.sb + h * k.sh + j;
  const long long vb = b * v.sb + h * v.sh + j, wb = b * lw.sb + h * lw.sh + j;
  float rn = 0.f, kn = 0.f, vn = 0.f, lwn = 0.f;
  if (live) {
    rn = r.p[rb];
    kn = k.p[kb];
    vn = v.p[vb];
    lwn = lw.p[wb];
  }
  float* op = o + ((long long)b * T * H + h) * hd + j;
  const long long o_step = (long long)H * hd;

  for (int t = 0; t < T; ++t) {
    float4* buf = stage[t & 1];
    const float vj = vn;
    buf[j] = make_float4(rn, kn, live ? expf(lwn) : 0.f, uj * kn);
    if (live && t + 1 < T) {
      rn = r.p[rb + (t + 1) * r.st];
      kn = k.p[kb + (t + 1) * k.st];
      vn = v.p[vb + (t + 1) * v.st];
      lwn = lw.p[wb + (t + 1) * lw.st];
    }
    __syncthreads();
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int i = 0; i < HD; ++i) {
      const float4 c = buf[i];
      acc[i & 3] = fmaf(c.x, fmaf(c.w, vj, s[i]), acc[i & 3]);
      s[i] = fmaf(c.z, s[i], c.y * vj);
    }
    if (live) op[t * o_step] = (acc[0] + acc[1]) + (acc[2] + acc[3]);
  }

  float* sp = s_last + ((long long)b * H + h) * hd * hd + j;
#pragma unroll
  for (int i = 0; i < HD; ++i) {
    if (live && i < hd) sp[(long long)i * hd] = s[i];
  }
}

template <int HD>
int launch(const Seq& r, const Seq& k, const Seq& v, const Seq& lw, const float* u, long long ush,
           const float* s0, long long s0b, long long s0h, long long s0i, float* o,
           float* s_last, int B, int T, int H, int hd, cudaStream_t stream) {
  rwkv6_kernel<HD><<<dim3(H, B), HD, 0, stream>>>(r, k, v, lw, u, ush, s0, s0b, s0h, s0i, o,
                                                  s_last, T, H, hd);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int rwkv6_fwd(const float* r, long long rsb, long long rst, long long rsh,
                         const float* k, long long ksb, long long kst, long long ksh,
                         const float* v, long long vsb, long long vst, long long vsh,
                         const float* lw, long long wsb, long long wst, long long wsh,
                         const float* u, long long ush, const float* s0, long long s0b,
                         long long s0h, long long s0i, float* o, float* s_last, int B, int T,
                         int H, int hd, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || hd <= 0 || hd > 64 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const Seq rs{r, rsb, rst, rsh}, ks{k, ksb, kst, ksh}, vs{v, vsb, vst, vsh},
      ws{lw, wsb, wst, wsh};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd <= 16) return launch<16>(rs, ks, vs, ws, u, ush, s0, s0b, s0h, s0i, o, s_last, B, T, H, hd, st);
  if (hd <= 32) return launch<32>(rs, ks, vs, ws, u, ush, s0, s0b, s0h, s0i, o, s_last, B, T, H, hd, st);
  return launch<64>(rs, ks, vs, ws, u, ush, s0, s0b, s0h, s0i, o, s_last, B, T, H, hd, st);
}
