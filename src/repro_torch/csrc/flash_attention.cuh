// B2's device code, shared by the flash-attention kernel
// (flash_attention.cu) and M4, the persistent attention-LM prefill
// (attn_lm.cu).  flash_attention.cu carries the design note.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash_attn {

constexpr int kRows = 16;  // query rows per block: one m16 tile
constexpr int kKT = 128;   // keys per pass
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxHd = 128;
constexpr int kSP = kKT + 4;  // score row pitch (floats)
constexpr float kNegInf = -1e30f;
constexpr float kMaxFloor = -0.5e30f;
constexpr float kDenomFloor = 1e-30f;
constexpr unsigned kFull = 0xffffffffu;
constexpr size_t kMaxSmem = 232448;

// Bytes of a staged row: 16-byte aligned for cp.async, room for the head
// dim rounded up to a k-step of 8, then `skew` bytes past a multiple of 128.
__host__ __device__ constexpr int row_pitch(int hd, int esize, int skew) {
  return ((hd + 7) / 8 * 8 * esize + 127) / 128 * 128 + skew;
}
__host__ __device__ constexpr int k_pitch(int hd, int esize) { return row_pitch(hd, esize, 16); }
__host__ __device__ constexpr int v_pitch(int hd, int esize) { return row_pitch(hd, esize, 32); }

inline size_t smem_bytes(int hd, int esize) {
  return (size_t)kKT * (k_pitch(hd, esize) + v_pitch(hd, esize)) +
         (size_t)kRows * k_pitch(hd, esize) + (size_t)kRows * kSP * 4 + 2 * kRows * 4;
}

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void narrow(float* p, float x) { *p = x; }
__device__ __forceinline__ void narrow(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }
// two neighbouring outputs (an even offset into a row of even length)
__device__ __forceinline__ void narrow2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void narrow2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// x = hi + lo: hi keeps x's sign, exponent and top 10 mantissa bits (a
// TF32 value), lo = x - hi exactly; the tensor cores read lo's top 10
// mantissa bits.  Two instructions, where rounding both halves takes ten.
struct Split {
  uint32_t hi, lo;
};
__device__ __forceinline__ Split split(float x) {
  const uint32_t hi = __float_as_uint(x) & 0xffffe000u;
  return {hi, __float_as_uint(x - __uint_as_float(hi))};
}

// d += a b on one m16n8k8 tile in TF32.  Not volatile: the compiler may
// schedule the products, and those into one d stay in program order
// through d itself (M4's projections, csrc/attn_lm.cu, share it)
__device__ __forceinline__ void mma(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                    uint32_t a3, uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// d += a b on one m16n8k8 tile, three TF32 products (small terms first)
__device__ __forceinline__ void mma3(float (&d)[4], const Split (&a)[4], const Split (&b)[2]) {
  mma(d, a[0].lo, a[1].lo, a[2].lo, a[3].lo, b[0].hi, b[1].hi);
  mma(d, a[0].hi, a[1].hi, a[2].hi, a[3].hi, b[0].lo, b[1].lo);
  mma(d, a[0].hi, a[1].hi, a[2].hi, a[3].hi, b[0].hi, b[1].hi);
}

template <typename T>
struct Args {
  const T* q;
  long long qsb, qsh, qst;
  const T* k;
  long long ksb, ksh, kss;
  const T* v;
  long long vsb, vsh, vss;
  T* o;
  long long osb, osh, ost;  // o's strides (b, h, t); unit stride on hd, even
  int H, group, T_len, S, hd, q_offset, causal, window, hpb;
  float scale;
  bool kv_vec, q_vec;
};

// Staging rows [r_begin, r_end) into shared rows `pitch` bytes apart.  Row
// r holds position p = first + (r >> shift) of head r & (2^shift - 1):
// src + head inner + p outer, when p lies in [lo, hi); otherwise it is
// zeroed (plain stores, no memory traffic) when `fill`, or left as it is.
struct Rows {
  int r_begin, r_end, shift, first, lo, hi;
  long long inner, outer;
  bool fill;
};

// 16-byte cp.async: thread (r0, u) copies 16-byte unit u of rows r_begin +
// r0, + rstep, ... (the lane map is fixed per thread: no division here)
struct Lanes {
  int u, r0, rstep;
};

// (by value: the asm's memory clobber would reload a referenced struct on
// every row)
template <typename T>
__device__ __forceinline__ void copy_vec(char* dst, int pitch, const T* src, const Rows w,
                                         const Lanes ln) {
  constexpr int kPer = 16 / sizeof(T);
#pragma unroll 1
  for (int r = w.r_begin + ln.r0; r < w.r_end; r += ln.rstep) {
    const int p = w.first + (r >> w.shift);
    char* to = dst + r * pitch + 16 * ln.u;
    if (p >= w.lo && p < w.hi)
      cp_async16(to, src + (r & ((1 << w.shift) - 1)) * w.inner + p * w.outer + ln.u * kPer);
    else if (w.fill)
      *reinterpret_cast<uint4*>(to) = make_uint4(0u, 0u, 0u, 0u);
  }
}

// element by element, for rows that are not 16-byte aligned (not inlined:
// it stays out of the aligned path's instructions)
template <typename T>
__device__ __noinline__ void copy_scalar(char* dst, int pitch, int hd, const T* src,
                                         const Rows w) {
#pragma unroll 1
  for (int i = threadIdx.x; i < (w.r_end - w.r_begin) * hd; i += kThreads) {
    const int r = w.r_begin + i / hd, d = i % hd, p = w.first + (r >> w.shift);
    const bool ok = p >= w.lo && p < w.hi;
    if (ok || w.fill)
      reinterpret_cast<T*>(dst + r * pitch)[d] =
          ok ? src[(r & ((1 << w.shift) - 1)) * w.inner + p * w.outer + d] : T(0.f);
  }
}

// The dynamic shared memory: a pass's K and V rows, q's rows, then the
// score tile and two floats a row.
struct Smem {
  char* base;
  int kp, vp;  // K and V row pitches (bytes)
  __device__ char* k() const { return base; }
  __device__ char* v() const { return base + kKT * kp; }
  __device__ char* q() const { return v() + kKT * vp; }
  __device__ float* s() const { return reinterpret_cast<float*>(q() + kRows * kp); }
};

template <typename T>
__device__ __forceinline__ float at(const char* row, int d) {
  return widen(reinterpret_cast<const T*>(row)[d]);
}

// One block's work: 16 query rows of batch row bz, KV head of head tile by,
// position tile bx, in `smem` (smem_bytes(hd, sizeof(T)) bytes).  The
// kernel calls it once with its block index; M4 (attn_lm.cu) calls it for
// each tile its block takes, with a barrier between two calls.
template <typename T>
__device__ __forceinline__ void flash_block(const Args<T>& a, char* smem, int bx, int by,
                                            int bz) {
  const Smem sm{smem, k_pitch(a.hd, sizeof(T)), v_pitch(a.hd, sizeof(T))};
  float* ss = sm.s();            // [kRows][kSP] scores, then probabilities
  float* sa = ss + kRows * kSP;  // alpha per row
  float* sl = sa + kRows;        // l per row

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c = lane & 3;  // the fragments' row group and column
  const int rows_t = kRows / a.hpb;       // positions per block
  const int t0 = bx * rows_t;
  const int h0 = by * a.hpb;
  const int kvh = h0 / a.group;
  const int b = bz;
  auto out_row = [&](int r) -> T* {  // nullptr past T
    const int t = t0 + r / a.hpb;
    return t < a.T_len ? a.o + b * a.osb + (h0 + r % a.hpb) * a.osh + t * a.ost : nullptr;
  };

  // keys any row of the block can see: [kbeg, kend)
  const int t_last = min(a.T_len, t0 + rows_t) - 1;
  const int qpos_lo = a.q_offset + t0, qpos_hi = a.q_offset + t_last;
  const int kend = a.causal ? min(a.S, qpos_hi + 1) : a.S;
  const int kbeg = a.window >= 0 ? max(0, qpos_lo - a.window + 1) : 0;
  const int pass0 = kbeg / kKT;
  const int npass = kend > kbeg ? (kend + kKT - 1) / kKT - pass0 : 0;
  if (npass == 0) {  // no row sees a key: the output is 0 (l floored)
    for (int i = tid; i < kRows * a.hd; i += kThreads) {
      T* o = out_row(i / a.hd);
      if (o) narrow(o + i % a.hd, 0.f);
    }
    return;
  }

  const T* kb = a.k + b * a.ksb + kvh * a.ksh;
  const T* vb = a.v + b * a.vsb + kvh * a.vsh;
  const int hd8 = (a.hd + 7) & ~7;
  if (hd8 != a.hd) {  // zero the columns up to the next k-step, never copied
    const int pad = hd8 - a.hd;
    for (int i = tid; i < (2 * kKT + kRows) * pad; i += kThreads) {
      const int r = i / pad, d = a.hd + i % pad;
      char* row = r < kKT       ? sm.k() + r * sm.kp
                  : r < 2 * kKT ? sm.v() + (r - kKT) * sm.vp
                                : sm.q() + (r - 2 * kKT) * sm.kp;
      reinterpret_cast<T*>(row)[d] = T(0.f);
    }
  }

  // q rows (zero for positions past T), a copy group of their own
  const int units = a.hd * (int)sizeof(T) / 16;  // 16-byte units of a row (vec paths)
  constexpr int kIdle = 1 << 30;                  // idle threads: a first row past any range
  const Lanes ln = units > 0 ? Lanes{tid % units, tid / units < kThreads / units ? tid / units
                                                                                 : kIdle,
                                     kThreads / units}
                             : Lanes{0, kIdle, 1};
  const Rows qrows{0, kRows, __ffs(a.hpb) - 1, t0, 0, a.T_len, a.qsh, a.qst, true};
  const T* qsrc = a.q + b * a.qsb + h0 * a.qsh;
  if (a.q_vec)
    copy_vec<T>(sm.q(), sm.kp, qsrc, qrows, ln);
  else
    copy_scalar<T>(sm.q(), sm.kp, a.hd, qsrc, qrows);
  cp_async_commit();
  Split qf[kMaxHd / 8][4];  // q's A fragments, filled while the first pass lands

  // softmax state of row tid / 16 (the same in its 16 threads)
  float m = kNegInf, l = 0.f;
  // this warp's output dims 16 warp + 8 n + 2 c (+1), rows g and g + 8,
  // in two sets (even and odd key steps: two chains in flight an n-tile)
  float acc[2][2][4] = {};

  // Pass j: K rows, then V rows, each a copy group; the scores wait for K
  // only.  Keys outside [kbeg, kend) are masked for every row of the block:
  // their K rows are not loaded, and the V rows that share a key step of 8
  // with a visible key are zeroed (their probabilities are exactly 0, and
  // 0 x V must be 0).
#pragma unroll 1
  for (int j = 0; j < npass; ++j) {
    const int key0 = (pass0 + j) * kKT;
    if (j > 0) __syncthreads();  // pass j - 1 is consumed
    // K: the visible rows; V: those and the rest of their key steps of 8
    const int lo = max(kbeg - key0, 0), hi = min(kend - key0, kKT);  // visible keys
    const Rows kr{lo, hi, 0, key0, kbeg, kend, 0, a.kss, false};
    const Rows vr{lo & ~7, min((hi + 7) & ~7, kKT), 0, key0, kbeg, kend, 0, a.vss, true};
    if (a.kv_vec) {
      copy_vec<T>(sm.k(), sm.kp, kb, kr, ln);
      cp_async_commit();
      copy_vec<T>(sm.v(), sm.vp, vb, vr, ln);
    } else {
      copy_scalar<T>(sm.k(), sm.kp, a.hd, kb, kr);
      cp_async_commit();
      copy_scalar<T>(sm.v(), sm.vp, a.hd, vb, vr);
    }
    cp_async_commit();
    if (j == 0) {  // q's A fragments: rows g and g + 8, columns c and c + 4 of each k-step
      cp_async_wait<2>();
      __syncthreads();
      const char* q0 = sm.q() + g * sm.kp;
      const char* q1 = sm.q() + (g + 8) * sm.kp;
#pragma unroll
      for (int ks = 0; ks < kMaxHd / 8; ++ks) {
        // k-steps past the head dim read column c (in range) and weigh 0
        const bool in = 8 * ks < a.hd;
        const int col = in ? 8 * ks + c : c;
        const float w = in ? a.scale : 0.f;
        qf[ks][0] = split(at<T>(q0, col) * w);
        qf[ks][1] = split(at<T>(q1, col) * w);
        qf[ks][2] = split(at<T>(q0, col + 4) * w);
        qf[ks][3] = split(at<T>(q1, col + 4) * w);
      }
    }
    cp_async_wait<1>();
    __syncthreads();  // K of pass j has landed

    const char* kt = sm.k();
    const char* vt = sm.v();

    // scores of keys 16 warp + 8 n + (0..7), n = 0, 1, for all 16 rows
    const int k16 = 16 * warp;
    float sc[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = kNegInf;
    if (k16 < hi && k16 + 16 > lo) {  // warp-uniform
      // two accumulator sets an n-tile (k-step parity): 4 chains in flight
      float d[2][2][4] = {};
#pragma unroll
      for (int ks = 0; ks < kMaxHd / 8; ++ks) {
        const int col = 8 * ks < a.hd ? 8 * ks + c : c;  // past the head dim q weighs 0
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const char* krow = kt + (k16 + 8 * n + g) * sm.kp;  // B: key g, columns c, c + 4
          const Split bf[2] = {split(at<T>(krow, col)), split(at<T>(krow, col + 4))};
          mma3(d[n][ks & 1], qf[ks], bf);
        }
      }
      // d[n]: rows g (0, 1) and g + 8 (2, 3), keys k16 + 8 n + 2 c (+1)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = g + (e >> 1) * 8, key = k16 + 8 * n + 2 * c + (e & 1), kp = key0 + key;
          const int qp = a.q_offset + t0 + r / a.hpb;
          bool ok = key >= lo && key < hi;
          if (a.causal) ok = ok && kp <= qp;
          if (a.window >= 0) ok = ok && qp - kp < a.window;
          sc[n][e] = ok ? d[n][0][e] + d[n][1][e] : kNegInf;
        }
    }
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      float* s0 = ss + g * kSP + k16 + 8 * n + 2 * c;
      *reinterpret_cast<float2*>(s0) = make_float2(sc[n][0], sc[n][1]);
      *reinterpret_cast<float2*>(s0 + 8 * kSP) = make_float2(sc[n][2], sc[n][3]);
    }
    __syncthreads();

    // online softmax, 16 threads a row, keys 4 i + (0..3) and 64 + 4 i + (0..3)
    {
      const int r = tid >> 4, c4 = 4 * (tid & 15);
      float4 s0 = *reinterpret_cast<const float4*>(ss + r * kSP + c4);
      float4 s1 = *reinterpret_cast<const float4*>(ss + r * kSP + 64 + c4);
      float mx = fmaxf(fmaxf(fmaxf(s0.x, s0.y), fmaxf(s0.z, s0.w)),
                       fmaxf(fmaxf(s1.x, s1.y), fmaxf(s1.z, s1.w)));
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
      const float m_new = fmaxf(fmaxf(m, mx), kMaxFloor);
      s0 = make_float4(expf(s0.x - m_new), expf(s0.y - m_new), expf(s0.z - m_new),
                       expf(s0.w - m_new));
      s1 = make_float4(expf(s1.x - m_new), expf(s1.y - m_new), expf(s1.z - m_new),
                       expf(s1.w - m_new));
      float ps = ((s0.x + s0.y) + (s0.z + s0.w)) + ((s1.x + s1.y) + (s1.z + s1.w));
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) ps += __shfl_xor_sync(kFull, ps, off);
      const float alpha = expf(m - m_new);
      l = l * alpha + ps;
      m = m_new;
      *reinterpret_cast<float4*>(ss + r * kSP + c4) = s0;
      *reinterpret_cast<float4*>(ss + r * kSP + 64 + c4) = s1;
      if ((tid & 15) == 0) {
        sa[r] = alpha;
        sl[r] = l;
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // P, alpha and V of pass j are in place

    // P.V into dims 16 warp..16 warp + 15, key steps of 8 that a row sees
    const int n0 = 16 * warp;
    if (n0 < a.hd) {  // warp-uniform
      const float al0 = sa[g], al1 = sa[g + 8];
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          acc[n][h][0] *= al0;
          acc[n][h][1] *= al0;
          acc[n][h][2] *= al1;
          acc[n][h][3] *= al1;
        }
      // key steps of 8 in pairs, one accumulator set each
      for (int k0 = lo & ~7; k0 < hi; k0 += 16) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int k1 = k0 + 8 * h;
          if (k1 < hi) {  // block-uniform
            // A fragment: P rows g, g + 8, keys k1 + c, k1 + c + 4
            const Split pf[4] = {split(ss[g * kSP + k1 + c]), split(ss[(g + 8) * kSP + k1 + c]),
                                 split(ss[g * kSP + k1 + c + 4]),
                                 split(ss[(g + 8) * kSP + k1 + c + 4])};
            const char* v0 = vt + (k1 + c) * sm.vp;
            const char* v1 = vt + (k1 + c + 4) * sm.vp;
#pragma unroll
            for (int n = 0; n < 2; ++n) {
              // B fragment: keys c, c + 4, dim g (dims past hd8 read dim g, never stored)
              const int dn = n0 + 8 * n < a.hd ? n0 + 8 * n + g : g;
              const Split bf[2] = {split(at<T>(v0, dn)), split(at<T>(v1, dn))};
              mma3(acc[n][h], pf, bf);
            }
          }
        }
      }
    }
  }
  // the last pass's barrier made sl visible
#pragma unroll
  for (int i = 0; i < 2; ++i) {  // rows g and g + 8
    T* o = out_row(g + 8 * i);
    if (!o) continue;
    const float den = fmaxf(sl[g + 8 * i], kDenomFloor);
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      const int d = 16 * warp + 8 * n + 2 * c;
      const float x = (acc[n][0][2 * i] + acc[n][1][2 * i]) / den;
      const float y = (acc[n][0][2 * i + 1] + acc[n][1][2 * i + 1]) / den;
      if (d + 1 < a.hd && !(a.hd & 1)) {
        narrow2(o + d, x, y);
      } else {
        if (d < a.hd) narrow(o + d, x);
        if (d + 1 < a.hd) narrow(o + d + 1, y);
      }
    }
  }
}

inline bool aligned(const void* p, long long s0, long long s1, long long s2, int bytes, int esize) {
  const long long n = bytes / esize;
  return reinterpret_cast<unsigned long long>(p) % bytes == 0 && s0 % n == 0 && s1 % n == 0 &&
         s2 % n == 0;
}

}  // namespace flash_attn
